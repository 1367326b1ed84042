"""Math op kernels: `mul`, the `elementwise_*` family and `mean`.

Counterparts of paddle_tpu/ops/math.py (reference: mul_op.cc,
elementwise_op_function.h, mean_op.cc).  Products go to torch.matmul;
with TF32 off (see the package docstring) a float32 product runs in full
float32 on the card, as on the JAX side.  Under the bf16 policy
(ops/amp_util.py) `mul` runs its product in bf16 and the elementwise
ops keep a bf16 activation bf16.
"""

import torch

from .amp_util import amp_harmonize, amp_result, mxu_operands
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
    dtype = torch.promote_types(x.dtype, y.dtype)
    x2, y2 = mxu_operands(_flatten2d(x, xn), _flatten2d(y, yn))
    out = amp_result(torch.matmul(x2, y2), dtype)
    return {"Out": [out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))]}


def _bcast_y(x, y, axis):
    """Y broadcasts into X starting at `axis` (default -1: trailing
    alignment), reference elementwise_op_function.h."""
    if x.shape == y.shape or axis is None or axis == -1:
        return y
    axis = int(axis)
    pad_after = x.dim() - axis - y.dim()
    return y.reshape((1,) * axis + tuple(y.shape) + (1,) * pad_after)


def _elementwise(name, fn):
    @register_op(name)
    def kernel(ctx, ins, attrs):
        x, y = amp_harmonize(ins["X"][0], ins["Y"][0])
        return {"Out": [fn(x, _bcast_y(x, y, attrs.get("axis", -1)))]}

    kernel.__name__ = name
    return kernel


_elementwise("elementwise_add", torch.add)
_elementwise("elementwise_sub", torch.sub)
_elementwise("elementwise_mul", torch.mul)
_elementwise("elementwise_div", torch.div)
_elementwise("elementwise_max", torch.maximum)
_elementwise("elementwise_min", torch.minimum)
_elementwise("elementwise_pow", torch.pow)


@register_op("mean")
def mean(ctx, ins, attrs):
    """The mean of all of X as a shape-(1,) tensor (reference
    mean_op.cc InferShape -> {1}); a bf16 input accumulates in f32."""
    x = ins["X"][0]
    if x.dtype == torch.bfloat16:
        x = x.float()
    return {"Out": [x.mean().reshape(1)]}
