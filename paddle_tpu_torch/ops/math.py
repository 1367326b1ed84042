"""Math op kernels: `mul`, the `elementwise_*` family, `mean`, the
`reduce_*` family, `cos_sim`, and the comparison and logical ops
(`less_than` ... `not_equal`, `logical_and`, `_or`, `_xor`, `_not`).

Counterparts of paddle_tpu/ops/math.py (reference: mul_op.cc,
elementwise_op_function.h, mean_op.cc, reduce_op.cc, cos_sim_op.cc,
compare_op.cc, logical_op.cc).
Products go to torch.matmul; with TF32 off (see the package docstring) a float32 product runs in full
float32 on the card, as on the JAX side.  Under the bf16 policy
(ops/amp_util.py) `mul` runs its product in bf16 and the elementwise
ops keep a bf16 activation bf16.  `mul` and the elementwise ops over a
ragged X work on its rows and give X's structure to the result;
`mean` of a ragged X covers its valid rows only, as do the reductions
across a ragged X's rows.
"""

import numpy as np
import torch

from ..core.ragged import RaggedTensor
from .amp_util import amp_harmonize, amp_result, mxu_operands
from .registry import dense, like, register_op, values_of


def _flatten2d(x, num_col_dims):
    """Collapse dims [:num_col_dims] into rows, the rest into columns
    (reference: flatten_to_2d used by mul_op)."""
    lead = 1
    for d in x.shape[:num_col_dims]:
        lead *= d
    return x.reshape(lead, -1)


@register_op("mul")
def mul(ctx, ins, attrs):
    x, y = values_of(ins["X"][0]), values_of(ins["Y"][0])
    xn = int(attrs.get("x_num_col_dims", 1))
    yn = int(attrs.get("y_num_col_dims", 1))
    dtype = torch.promote_types(x.dtype, y.dtype)
    x2, y2 = mxu_operands(_flatten2d(x, xn), _flatten2d(y, yn))
    out = amp_result(torch.matmul(x2, y2), dtype)
    out = out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))
    return {"Out": [like(ins["X"][0], out)]}


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
        x, y = amp_harmonize(values_of(ins["X"][0]),
                             values_of(ins["Y"][0]))
        out = fn(x, _bcast_y(x, y, attrs.get("axis", -1)))
        return {"Out": [like(ins["X"][0], out)]}

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
    mean_op.cc InferShape -> {1}); a bf16 input accumulates in f32.  A
    ragged X's mean covers its valid rows: the rows that pad it to a
    bucket do not count."""
    xr = ins["X"][0]
    x = values_of(xr)
    if x.dtype == torch.bfloat16:
        x = x.float()
    if isinstance(xr, RaggedTensor):
        rows = x.reshape(x.shape[0], -1)
        mask = xr.valid_mask().to(rows.dtype)
        total = (rows * mask[:, None]).sum()
        denom = xr.nvalid.to(rows.dtype) * rows.shape[1]
        return {"Out": [(total / denom.clamp(min=1)).reshape(1)]}
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
    any dtype.  A ragged X reduced across its rows (`dim` 0 or
    `reduce_all`) leaves out the rows past `nvalid`: a sum adds 0 there,
    a max or min takes the dtype's least or largest value, and a mean
    divides by the valid rows; reduced over a feature dim with
    `keep_dim`, it stays ragged over X's splits, as on the JAX side."""

    @register_op(name)
    def kernel(ctx, ins, attrs):
        xr = ins["X"][0]
        ragged = isinstance(xr, RaggedTensor)
        x = xr.values if ragged else dense(xr, name)
        if acc_f32 and x.dtype == torch.bfloat16:
            x = x.float()
        keep = bool(attrs.get("keep_dim", False))
        reduce_all = bool(attrs.get("reduce_all", False))
        dim = int(attrs.get("dim", 0))
        if dim < 0:
            dim += x.dim()
        if ragged and (reduce_all or dim == 0):
            mask = xr.valid_mask().reshape((-1,) + (1,) * (x.dim() - 1))
            if name == "reduce_mean":
                x = x if x.is_floating_point() else x.float()
                zero = torch.zeros((), dtype=x.dtype, device=x.device)
                kept = torch.where(mask, x, zero)
                total = kept.sum() if reduce_all else kept.sum(0)
                denom = xr.nvalid.clamp(min=1).to(total.dtype)
                if reduce_all:
                    feat = max(1, int(np.prod(x.shape[1:])))
                    out = total / (denom * feat)
                    return {"Out": [out.reshape((1,) * x.dim() if keep
                                                else (1,))]}
                out = total / denom
                return {"Out": [out.unsqueeze(0) if keep else out]}
            if name == "reduce_sum":
                neutral = 0
            else:
                info = (torch.finfo if x.is_floating_point()
                        else torch.iinfo)(x.dtype)
                neutral = info.min if name == "reduce_max" else info.max
            x = torch.where(mask, x, torch.full((), neutral, dtype=x.dtype,
                                                device=x.device))
        if reduce_all:
            out = fn(x, None, False)
            return {"Out": [out.reshape((1,) * x.dim() if keep else (1,))]}
        out = fn(x, dim, keep)
        if ragged and dim != 0 and keep:
            return {"Out": [like(xr, out)]}
        return {"Out": [out]}

    kernel.__name__ = name
    return kernel


_reduce("reduce_sum", _sum, acc_f32=True)
_reduce("reduce_mean", _mean, acc_f32=True)
_reduce("reduce_max", _max)
_reduce("reduce_min", _min)


@register_op("cos_sim")
def cos_sim(ctx, ins, attrs):
    """Cosine similarity of X's and Y's rows (reference: cos_sim_op.cc):
    Out = <x, y> / (|x| |y| + 1e-12), [N, 1], with the norms XNorm and
    YNorm; a Y of one row broadcasts.  The 1e-12 is added to the product
    of the norms, as on the JAX side; `F.cosine_similarity` clamps each
    norm instead, which gives other numbers."""
    x, y = values_of(ins["X"][0]), values_of(ins["Y"][0])
    xnorm = torch.sqrt(torch.sum(torch.square(x), -1, keepdim=True))
    ynorm = torch.sqrt(torch.sum(torch.square(y), -1, keepdim=True))
    prod = torch.sum(x * y, -1, keepdim=True)
    return {"Out": [prod / (xnorm * ynorm + 1e-12)], "XNorm": [xnorm],
            "YNorm": [ynorm]}


# -- comparison and logical ops (compare_op.cc, logical_op.cc) --------------

def _compare(name, fn):
    """A bool op of X and Y (broadcast, the promoted dtype), no grad; a
    ragged operand gives its values, as on the JAX side."""

    @register_op(name, stop_gradient_op=True, nondiff_inputs=("X", "Y"))
    def kernel(ctx, ins, attrs):
        return {"Out": [fn(values_of(ins["X"][0]),
                           values_of(ins["Y"][0]))]}

    kernel.__name__ = name
    return kernel


_compare("less_than", torch.lt)
_compare("less_equal", torch.le)
_compare("greater_than", torch.gt)
_compare("greater_equal", torch.ge)
_compare("equal", torch.eq)
_compare("not_equal", torch.ne)
_compare("logical_and", torch.logical_and)
_compare("logical_or", torch.logical_or)
_compare("logical_xor", torch.logical_xor)


@register_op("logical_not", stop_gradient_op=True, nondiff_inputs=("X",))
def logical_not(ctx, ins, attrs):
    return {"Out": [torch.logical_not(values_of(ins["X"][0]))]}
