"""Math op kernels: `mul`, the `elementwise_*` family, `mean` and the
dense `reduce_*` family.

Counterparts of paddle_tpu/ops/math.py (reference: mul_op.cc,
elementwise_op_function.h, mean_op.cc, reduce_op.cc).  Products go to torch.matmul;
with TF32 off (see the package docstring) a float32 product runs in full
float32 on the card, as on the JAX side.  Under the bf16 policy
(ops/amp_util.py) `mul` runs its product in bf16 and the elementwise
ops keep a bf16 activation bf16.
"""

import torch

from .amp_util import amp_harmonize, amp_result, mxu_operands
from .registry import dense, register_op


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


def _sum(x, dim, keep):
    # jnp sums integers in the default int (int32 with x64 off)
    dtype = x.dtype if x.is_floating_point() else torch.int32
    return x.sum(dtype=dtype) if dim is None \
        else x.sum(dim, keepdim=keep, dtype=dtype)


def _mean(x, dim, keep):
    x = x if x.is_floating_point() else x.float()
    return x.mean() if dim is None else x.mean(dim, keepdim=keep)


def _max(x, dim, keep):
    return x.max() if dim is None else x.amax(dim, keepdim=keep)


def _min(x, dim, keep):
    return x.min() if dim is None else x.amin(dim, keepdim=keep)


def _reduce(name, fn, acc_f32=False):
    """The reduction over `dim` (negative counts from the end), kept as
    a size-1 dim with `keep_dim`; with `reduce_all`, over everything, as
    shape (1,) or, with `keep_dim`, (1,) * ndim.  Sum and mean
    accumulate a bf16 input in f32 and return f32 (bf16's 8 mantissa
    bits saturate after a few hundred addends); max and min are exact in
    any dtype.  Ragged inputs (their row masks) come with ROADMAP A7."""

    @register_op(name)
    def kernel(ctx, ins, attrs):
        x = dense(ins["X"][0], name)
        if acc_f32 and x.dtype == torch.bfloat16:
            x = x.float()
        keep = bool(attrs.get("keep_dim", False))
        if attrs.get("reduce_all", False):
            out = fn(x, None, False)
            return {"Out": [out.reshape((1,) * x.dim() if keep else (1,))]}
        dim = int(attrs.get("dim", 0))
        if dim < 0:
            dim += x.dim()
        return {"Out": [fn(x, dim, keep)]}

    kernel.__name__ = name
    return kernel


_reduce("reduce_sum", _sum, acc_f32=True)
_reduce("reduce_mean", _mean, acc_f32=True)
_reduce("reduce_max", _max)
_reduce("reduce_min", _min)
