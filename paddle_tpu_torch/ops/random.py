"""Random init op kernels: `uniform_random`.

Counterpart of paddle_tpu/ops/random.py (reference:
uniform_random_op.cc).  An op with a non-zero `seed` attr draws from a
generator of its own seeded with it; the others draw from the
executor's stream (`ExecContext.next_rng`).  The values differ from the
JAX package's (its PRNG is not torch's); the distribution is the same.
"""

import torch

from ..core.types import torch_dtype
from .registry import register_op


def _generator(ctx, attrs):
    seed = int(attrs.get("seed", 0) or 0)
    if seed:
        return torch.Generator(device=ctx.device).manual_seed(seed)
    return ctx.next_rng()


@register_op("uniform_random", uses_rng=True, stop_gradient_op=True)
def uniform_random(ctx, ins, attrs):
    """U[min, max) of `shape`, drawn in f32 and cast to `dtype`."""
    shape = tuple(int(s) for s in attrs["shape"])
    lo = attrs.get("min", -1.0)
    hi = attrs.get("max", 1.0)
    u = torch.rand(shape, generator=_generator(ctx, attrs),
                   dtype=torch.float32, device=ctx.device)
    out = u * (hi - lo) + lo
    return {"Out": [out.to(torch_dtype(attrs.get("dtype", "float32")))]}
