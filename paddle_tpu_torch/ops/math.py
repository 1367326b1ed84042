"""Math op kernels: `mul`, `elementwise_add` and `mean`.

Counterparts of paddle_tpu/ops/math.py (reference: mul_op.cc,
elementwise_op_function.h, mean_op.cc).  Products go to torch.matmul;
with TF32 off (see the package docstring) a float32 product runs in full
float32 on the card, as on the JAX side.
"""

import torch

from .registry import register_op


def _flatten2d(x, num_col_dims):
    """Collapse dims [:num_col_dims] into rows, the rest into columns
    (reference: flatten_to_2d used by mul_op)."""
    lead = 1
    for d in x.shape[:num_col_dims]:
        lead *= d
    return x.reshape(lead, -1)


@register_op("mul")
def mul(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    xn = int(attrs.get("x_num_col_dims", 1))
    yn = int(attrs.get("y_num_col_dims", 1))
    out = torch.matmul(_flatten2d(x, xn), _flatten2d(y, yn))
    return {"Out": [out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))]}


def _bcast_y(x, y, axis):
    """Y broadcasts into X starting at `axis` (default -1: trailing
    alignment), reference elementwise_op_function.h."""
    if x.shape == y.shape or axis is None or axis == -1:
        return y
    axis = int(axis)
    pad_after = x.dim() - axis - y.dim()
    return y.reshape((1,) * axis + tuple(y.shape) + (1,) * pad_after)


@register_op("elementwise_add")
def elementwise_add(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": [x + _bcast_y(x, y, attrs.get("axis", -1))]}


@register_op("mean")
def mean(ctx, ins, attrs):
    """The mean of all of X as a shape-(1,) tensor (reference
    mean_op.cc InferShape -> {1}); a bf16 input accumulates in f32."""
    x = ins["X"][0]
    if x.dtype == torch.bfloat16:
        x = x.float()
    return {"Out": [x.mean().reshape(1)]}
