"""Random init op kernels: `uniform_random` and `gaussian_random`.

Counterpart of paddle_tpu/ops/random.py (reference:
uniform_random_op.cc, gaussian_random_op.cc).  An op with a non-zero
`seed` attr draws from a generator of its own seeded with it; the
others draw from the executor's stream (`ExecContext.next_rng`).  The
values differ from the JAX package's (its PRNG is not torch's); the
distribution is the same.  Shape inference reads the `shape` and
`dtype` attrs, since a generator cannot live on the meta device.
"""

import torch

from ..core.types import torch_dtype
from .registry import META, register_op


def _generator(ctx, attrs):
    seed = int(attrs.get("seed", 0) or 0)
    if seed:
        return torch.Generator(device=ctx.device).manual_seed(seed)
    return ctx.next_rng()


def _shape(attrs):
    return tuple(int(s) for s in attrs["shape"])


def _out_dtype(attrs):
    return torch_dtype(attrs.get("dtype", "float32"))


def _infer_from_attrs(ins, attrs):
    return {"Out": [torch.empty(_shape(attrs), dtype=_out_dtype(attrs),
                                device=META)]}


@register_op("uniform_random", uses_rng=True, stop_gradient_op=True,
             infer_shape=_infer_from_attrs)
def uniform_random(ctx, ins, attrs):
    """U[min, max) of `shape`, drawn in f32 and cast to `dtype`."""
    lo = attrs.get("min", -1.0)
    hi = attrs.get("max", 1.0)
    u = torch.rand(_shape(attrs), generator=_generator(ctx, attrs),
                   dtype=torch.float32, device=ctx.device)
    return {"Out": [(u * (hi - lo) + lo).to(_out_dtype(attrs))]}


@register_op("gaussian_random", uses_rng=True, stop_gradient_op=True,
             infer_shape=_infer_from_attrs)
def gaussian_random(ctx, ins, attrs):
    """mean + std * N(0, 1) of `shape`, drawn in f32 and cast to
    `dtype`."""
    z = torch.randn(_shape(attrs), generator=_generator(ctx, attrs),
                    dtype=torch.float32, device=ctx.device)
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z
    return {"Out": [out.to(_out_dtype(attrs))]}
