"""Random op kernels: `uniform_random`, `gaussian_random` and
`dropout` with its grad.

Counterpart of paddle_tpu/ops/random.py (reference:
uniform_random_op.cc, gaussian_random_op.cc, dropout_op.cc).  An op
with a non-zero `seed` attr (dropout: `fix_seed`) draws from a
generator of its own seeded with it; the others draw from the
executor's stream (`ExecContext.next_rng`, seeded from the program's
`random_seed`).  The values differ from the JAX package's (its PRNG is
not torch's); the distribution is the same.  Shape inference reads the
attrs, or takes the input's shape, since a generator cannot live on the
meta device.
"""

import torch

from ..core.types import torch_dtype
from ..core.ragged import RaggedTensor
from .registry import (META, dense, like, register_grad_kernel, register_op,
                       values_of)


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


def _like_x(ins, attrs):
    x = ins["X"][0]
    xv = values_of(x)
    return {"Out": [like(x, torch.empty_like(xv))],
            "Mask": [torch.empty_like(xv)]}


@register_op("dropout", uses_rng=True, infer_shape=_like_x)
def dropout(ctx, ins, attrs):
    """Out = X * Mask, Mask = (U[0, 1) >= dropout_prob) in X's dtype,
    drawn in f32 from the executor's stream or, with `fix_seed`, from a
    generator seeded with `seed`; `is_test` scales X by (1 - p) with a
    mask of ones (reference dropout_op.h).  A ragged X drops from its
    values and keeps its splits; the Mask is over its values."""
    xr = ins["X"][0]
    x = xr.values if isinstance(xr, RaggedTensor) else dense(xr, "dropout")
    prob = attrs.get("dropout_prob", 0.5)
    if attrs.get("is_test", False):
        return {"Out": [like(xr, x * (1.0 - prob))],
                "Mask": [torch.ones_like(x)]}
    if attrs.get("fix_seed", False):
        gen = torch.Generator(device=x.device).manual_seed(
            int(attrs.get("seed", 0)))
    else:
        gen = ctx.next_rng()
    u = torch.rand(x.shape, generator=gen, dtype=torch.float32,
                   device=x.device)
    mask = (u >= prob).to(x.dtype)
    return {"Out": [like(xr, x * mask)], "Mask": [mask]}


@register_grad_kernel("dropout")
def dropout_grad(ctx, ins, attrs):
    """dX from the forward's saved Mask (the stream is not replayed;
    reference dropout_op.h DropoutGradKernel); ragged over a ragged
    Out@GRAD's splits."""
    ogr = ins["OG@Out"][0]
    og = ogr.values if isinstance(ogr, RaggedTensor) \
        else dense(ogr, "dropout_grad")
    if attrs.get("is_test", False):
        g = og * (1.0 - attrs.get("dropout_prob", 0.5))
    else:
        g = og * ins["O@Mask"][0]
    return {"X@GRAD": [like(ogr, g)]}
