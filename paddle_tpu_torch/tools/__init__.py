"""Operational tools: the cluster launcher (`cluster_launch`), the
inference server (`serve_cli`), the paddle_trainer-style trainer
(`trainer_cli`), the observability dump and selftest (`obs_dump`), the
chaos harness (`chaos_cli`: supervised training under injected
faults), the perf CLI (`perf_cli`: bottleneck classification, perf
history and its regression gate), the load generator (`load_cli`: open
and closed loop, access-log replay) and the program linter
(`lint_cli`).  The JAX package's other CLIs wait with ROADMAP A2
(`pcache_cli`, `mem_cli`) and A9 (`shard_cli`, `comm_cli`, `fleet_cli`,
`elastic_cli`, `tune_cli`).

The CLIs run on the card, as the reference's `paddle` CLIs do with
`--use_gpu=1`; `--use_gpu=0` runs them on the CPU."""


def use_gpu_arg(value):
    """argparse type of `--use_gpu`: 1/0, true/false, yes/no, on/off."""
    text = str(value).strip().lower()
    if text in ("1", "true", "yes", "on"):
        return True
    if text in ("0", "false", "no", "off"):
        return False
    raise ValueError("--use_gpu takes 1 or 0, got %r" % (value,))


def cli_place(use_gpu):
    """CUDAPlace(0) (which raises without a CUDA device when used) or,
    with use_gpu False, CPUPlace()."""
    from ..fluid import CPUPlace, CUDAPlace

    return CUDAPlace(0) if use_gpu else CPUPlace()
