"""paddle_tpu_torch.spmd — the plan-driven SPMD trainer.

Counterpart of paddle_tpu/spmd, its first part:

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

The JAX package's `checkpoint` (sharded per-host checkpoints) and
`bench` (the multi-card measurement legs) come with ROADMAP A9's slice
22: their names raise NotImplementedError naming it.
"""

from .plan import (PartitionPlan, build_partition_plan,
                   match_partition_rules, load_rules)
from .trainer import SpmdTrainer, attach_supervisor
from .overlap import make_overlapped_dp_step, overlap_supported

__all__ = [
    "PartitionPlan", "build_partition_plan", "match_partition_rules",
    "load_rules", "SpmdTrainer", "attach_supervisor",
    "SpmdCheckpointSaver", "save_sharded", "restore_sharded",
    "latest_sharded_checkpoint", "StaleGenerationError",
    "measure_densify_restore", "make_overlapped_dp_step",
    "overlap_supported",
]


def _waiting(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            "spmd.%s needs spmd/checkpoint.py, which the port does not "
            "have yet (ROADMAP A9, second part, slice 22)" % name)

    fn.__name__ = name
    return fn


SpmdCheckpointSaver = _waiting("SpmdCheckpointSaver")
save_sharded = _waiting("save_sharded")
restore_sharded = _waiting("restore_sharded")
latest_sharded_checkpoint = _waiting("latest_sharded_checkpoint")
measure_densify_restore = _waiting("measure_densify_restore")


class StaleGenerationError(RuntimeError):
    """A restore refused a manifest from a newer elastic generation
    (raised by spmd/checkpoint.py, slice 22)."""
