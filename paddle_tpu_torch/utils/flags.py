"""Process flags: the few the port reads, each with the JAX package's
name, default and `FLAGS_<name>` environment bootstrap.

Counterpart of paddle_tpu/utils/flags.py, holding only what the port's
kernels consult: the AMP policy (`amp_bf16`, `amp_bf16_act`) and the
batch-norm statistics form (`bn_shifted_stats`).  Kernels read a flag
when they run, so a flag set around `Executor.run` (`fluid.amp.
bf16_guard()`) governs that run.
"""

import os

__all__ = ["get_flag", "set_flag", "all_flags"]

_DEFAULTS = {
    # cast mul/conv operands to bfloat16, f32 master weights (fluid.amp)
    "amp_bf16": False,
    # under amp_bf16, keep activations bfloat16 between ops
    "amp_bf16_act": True,
    # batch-norm statistics in the shifted one-pass form (ops/norm.py)
    "bn_shifted_stats": False,
}

_FLAGS = dict(_DEFAULTS)


def _coerce(value):
    if isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    return bool(value)


def get_flag(name):
    return _FLAGS[name]


def set_flag(name, value):
    if name not in _FLAGS:
        raise KeyError("unknown flag %r" % name)
    _FLAGS[name] = _coerce(value)


def all_flags():
    return dict(_FLAGS)


for _name in _DEFAULTS:
    if "FLAGS_" + _name in os.environ:
        set_flag(_name, os.environ["FLAGS_" + _name])
