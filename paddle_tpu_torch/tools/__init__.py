"""Operational tools: the cluster launcher (`cluster_launch`), the
inference server (`serve_cli`), the paddle_trainer-style trainer
(`trainer_cli`) and the observability dump and selftest (`obs_dump`).
The JAX package's other CLIs wait with ROADMAP A9 and A10.

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
