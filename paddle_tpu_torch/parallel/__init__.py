"""Multi-GPU parallel training over a torch.distributed DeviceMesh.

Counterpart of paddle_tpu/parallel, which lays a program over a
`jax.sharding.Mesh` with named axes ("dp" data parallel, "mp"
model/tensor parallel, "sp" sequence, "pp" pipeline, "ep" expert) and
lets XLA's GSPMD insert the collectives.  Here the mesh is a
`DeviceMesh` over the ranks of a process group (one CUDA device per
rank over NCCL; CPU ranks over gloo when the caller asks for the CPU),
program state and feeds are DTensors laid out by the same specs, and
the executor runs each op on them (`trainer.py`).  Ring and Ulysses
attention, GPipe and Switch MoE are per-rank code with explicit
collectives (`collectives.py`) under `sharding.shard_map_norep`.
"""

from .mesh import make_mesh, MeshConfig, parse_mesh_spec
from .sharding import (param_spec, param_spec_reason, batch_spec,
                       shard_state, shard_feeds, replicated, zero1_spec,
                       zero1_spec_reason)
from .trainer import ParallelTrainer, make_parallel_step, verify_sharding
from .ring import (ring_attention, ulysses_attention, sp_shard_map,
                   sp_axis_info)
from .pipeline import (gpipe_spmd, pipeline_apply, split_microbatches,
                       stack_stage_params, pipeline_schedule_info)
from .moe import (switch_moe, moe_shard_map, init_moe_params,
                  expert_capacity, moe_axis_info)
from .program_api import (lower_program_fn, PipelineProgramTrainer,
                          MoEProgramLayer)
from .optim import PytreeOptimizer

__all__ = [
    "make_mesh", "MeshConfig", "parse_mesh_spec", "param_spec",
    "param_spec_reason", "batch_spec", "shard_state", "shard_feeds",
    "replicated", "zero1_spec", "zero1_spec_reason", "ParallelTrainer",
    "make_parallel_step", "verify_sharding",
    "ring_attention", "ulysses_attention", "sp_shard_map",
    "sp_axis_info", "gpipe_spmd", "pipeline_apply",
    "split_microbatches", "stack_stage_params",
    "pipeline_schedule_info", "switch_moe", "moe_shard_map",
    "init_moe_params", "expert_capacity", "moe_axis_info",
    "lower_program_fn", "PipelineProgramTrainer", "MoEProgramLayer",
    "PytreeOptimizer",
]
