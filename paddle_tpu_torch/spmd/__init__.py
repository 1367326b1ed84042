"""paddle_tpu_torch.spmd — the plan-driven SPMD trainer.

Counterpart of paddle_tpu/spmd:

  * `plan`       — rule-driven partition planning: regex partition
                   rules layered over the `sharding.param_spec`
                   heuristics, producing a serializable plan artifact
                   (`shard_cli plan`) whose fingerprint equals the JAX
                   plan's.
  * `trainer`    — `SpmdTrainer`: the plan's layout over the mesh
                   step, with zero1 optimizer-state sharding, or the
                   bucketed ring-allreduce dp step.
  * `overlap`    — the explicit data-parallel step: forward and
                   backward per rank on its batch shard inside
                   `shard_map_norep`, gradients ring-reduced in buckets
                   at the reduction seam.
  * `checkpoint` — sharded per-rank checkpoints (each rank's shard
                   files + manifests, the JAX package's format) that
                   restore WITHOUT densifying, composing with the
                   resilience supervisor for preempt/auto-resume.
  * `bench`      — the multi-card measurement legs: img/s + MFU over
                   mesh shapes, comm measurements, per-host fleet
                   telemetry (`python -m paddle_tpu_torch.spmd.bench`).
"""

from .plan import (PartitionPlan, build_partition_plan,
                   match_partition_rules, load_rules)
from .trainer import SpmdTrainer, attach_supervisor
from .checkpoint import (SpmdCheckpointSaver, save_sharded,
                         restore_sharded, latest_sharded_checkpoint,
                         StaleGenerationError,
                         measure_densify_restore)
from .overlap import make_overlapped_dp_step, overlap_supported

__all__ = [
    "PartitionPlan", "build_partition_plan", "match_partition_rules",
    "load_rules", "SpmdTrainer", "attach_supervisor",
    "SpmdCheckpointSaver", "save_sharded", "restore_sharded",
    "latest_sharded_checkpoint", "StaleGenerationError",
    "measure_densify_restore", "make_overlapped_dp_step",
    "overlap_supported",
]

