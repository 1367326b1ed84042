"""Process flags: the few the port reads, each with the JAX package's
name, default and `FLAGS_<name>` environment bootstrap.

Counterpart of paddle_tpu/utils/flags.py, holding only what the port
consults: the eager NaN/Inf scan (`check_nan_inf`: fluid/executor.py),
the AMP policy (`amp_bf16`, `amp_bf16_act`), the batch-norm statistics
form (`bn_shifted_stats`), and the optimizer's update fusion
(`fuse_optimizer`, `fuse_optimizer_max_numel`: fluid/fusion.py).
Kernels read a flag when they run, so a flag set around `Executor.run`
(`fluid.amp.bf16_guard()`) governs that run; the optimizer reads the
fusion flags when it builds the updates.
"""

import os

__all__ = ["get_flag", "set_flag", "all_flags", "parse_flags_from_env"]

_DEFAULTS = {
    # scan every top-level op's float outputs for NaN/Inf, raising
    # NonfiniteError (reference: executor.cc:29); one read back per output
    "check_nan_inf": False,
    # cast mul/conv operands to bfloat16, f32 master weights (fluid.amp)
    "amp_bf16": False,
    # under amp_bf16, keep activations bfloat16 between ops
    "amp_bf16_act": True,
    # batch-norm statistics in the shifted one-pass form (ops/norm.py)
    "bn_shifted_stats": False,
    # stack same-recipe update ops into fused_update ops (fluid/fusion.py)
    "fuse_optimizer": False,
    # only parameters of at most this many elements join a stack; 0: all
    "fuse_optimizer_max_numel": 1 << 18,
}

_FLAGS = dict(_DEFAULTS)


def _coerce(value, default):
    if isinstance(default, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    return int(value)


def get_flag(name):
    return _FLAGS[name]


def set_flag(name, value):
    if name not in _FLAGS:
        raise KeyError("unknown flag %r" % name)
    _FLAGS[name] = _coerce(value, _DEFAULTS[name])


def all_flags():
    return dict(_FLAGS)


def parse_flags_from_env(names=None):
    """Set each flag of `names` (default: all) from `FLAGS_<name>` where
    the environment has it."""
    for name in names if names is not None else _DEFAULTS:
        if "FLAGS_" + name in os.environ:
            set_flag(name, os.environ["FLAGS_" + name])


parse_flags_from_env()
