"""Automatic mixed precision: bf16 compute, f32 master weights.

Counterpart of paddle_tpu/fluid/amp.py (`enable_bf16`, `disable_bf16`,
`bf16_enabled`, `bf16_guard`).  While `amp_bf16` is on, `mul` and
`conv2d` run their products in bf16 (tensor cores on the card) and,
with `amp_bf16_act` (the default), their results and the elementwise,
relu, pool and batch-norm chains after them stay bf16; parameters,
optimizer state, batch statistics and losses stay f32 (ops/amp_util.py).
The flag is read as the kernels run: a program built in f32 trains in
bf16 when its `Executor.run` calls are made under `bf16_guard()`.
"""

import contextlib

from ..utils import flags

__all__ = ["enable_bf16", "disable_bf16", "bf16_enabled", "bf16_guard"]


def enable_bf16():
    flags.set_flag("amp_bf16", True)


def disable_bf16():
    flags.set_flag("amp_bf16", False)


def bf16_enabled():
    return flags.get_flag("amp_bf16")


@contextlib.contextmanager
def bf16_guard():
    prev = bf16_enabled()
    flags.set_flag("amp_bf16", True)
    try:
        yield
    finally:
        flags.set_flag("amp_bf16", prev)
