"""Math op kernels: `mul`, `matmul`, the `elementwise_*` family, `minus`,
`mean`, the `reduce_*` family, the norms and distances
(`squared_l2_norm`, `l1_norm`, `squared_l2_distance`, `cos_sim`), and
the comparison and logical ops (`less_than` ... `not_equal`,
`logical_and`, `_or`, `_xor`, `_not`), the finiteness checks
`isfinite` and `count_nonfinite`, and `fused_elemwise_chain`, the op
the `fuse` rewrite pass emits.

Counterparts of paddle_tpu/ops/math.py (reference: mul_op.cc,
matmul_op.cc, elementwise_op_function.h, minus_op.cc, mean_op.cc,
reduce_op.cc, squared_l2_norm_op.cc, l1_norm_op.cc,
squared_l2_distance_op.cc, cos_sim_op.cc, compare_op.cc,
logical_op.cc).
Products go to torch.matmul; with TF32 off (see the package docstring) a float32 product runs in full
float32 on the card, as on the JAX side.  Under the bf16 policy
(ops/amp_util.py) `mul` and `matmul` run their product in bf16 and the
elementwise ops keep a bf16 activation bf16.  `mul` and the elementwise ops over a
ragged X work on its rows and give X's structure to the result;
`mean` of a ragged X covers its valid rows only, as do the reductions
across a ragged X's rows.
"""

import json

import numpy as np
import torch

from ..core.ragged import RaggedTensor
from ..core.types import FUSED_ELEMWISE_OP
from .activation import jnp_abs
from .amp_util import amp_harmonize, amp_result, mxu_operands
from .registry import dense, get_op_info, like, register_op, values_of


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


@register_op("matmul")
def matmul(ctx, ins, attrs):
    """X @ Y (torch.matmul's rules: batched, broadcast, 1-D operands),
    each operand's last two dims swapped first under `transpose_X` or
    `transpose_Y` (a 1-D operand as it is)."""
    x, y = values_of(ins["X"][0]), values_of(ins["Y"][0])
    if attrs.get("transpose_X") and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y") and y.dim() > 1:
        y = y.transpose(-1, -2)
    dtype = torch.promote_types(x.dtype, y.dtype)
    xm, ym = mxu_operands(x, y)
    return {"Out": [amp_result(torch.matmul(xm, ym), dtype)]}


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


@register_op(FUSED_ELEMWISE_OP)
def fused_elemwise_chain(ctx, ins, attrs):
    """One op standing for a chain of elementwise, activation and bias
    stages (built by `fluid.fusion.fuse_elemwise_chains`, run from the
    `fuse` rewrite pass).

    The `stages` attr is a JSON list, in chain order:
      {"op": <registered type>, "attrs": {...},
       "in": "X"|"Y"            the slot the chain value feeds,
       "side": <SideIns index>} the other operand of a binary stage.
    Each stage applies the registered kernel of its op type with its
    attrs, so the result is the unfused op sequence's, bit for bit.
    The stages run as the ATen calls of their kernels, one after the
    other; the grad is the generic vjp through them, as on the JAX
    side."""
    val = ins["X"][0]
    side_vals = ins.get("SideIns", [])
    for st in json.loads(attrs["stages"]):
        main_slot = st.get("in", "X")
        sins = {main_slot: [val]}
        side = st.get("side")
        if side is not None:
            sins["Y" if main_slot == "X" else "X"] = [side_vals[side]]
        kernel = get_op_info(st["op"]).kernel
        val = kernel(ctx, sins, st.get("attrs") or {})["Out"][0]
    return {"Out": [val]}


@register_op("minus")
def minus(ctx, ins, attrs):
    """X - Y, broadcast."""
    return {"Out": [values_of(ins["X"][0]) - values_of(ins["Y"][0])]}


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


@register_op("squared_l2_norm")
def squared_l2_norm(ctx, ins, attrs):
    """The sum of X's squares, a 0-d tensor (the JAX side's `jnp.sum`)."""
    return {"Out": [torch.sum(torch.square(values_of(ins["X"][0])))]}


@register_op("l1_norm")
def l1_norm(ctx, ins, attrs):
    """The sum of |X|, a 0-d tensor; its grad at 0 is 1, as `jnp.abs`'s."""
    return {"Out": [torch.sum(jnp_abs(values_of(ins["X"][0])))]}


@register_op("isfinite", stop_gradient_op=True, nondiff_inputs=("X",))
def isfinite(ctx, ins, attrs):
    """[1] bool: X (a ragged X's values) holds only finite values
    (reference: the CheckTensorNANOrInf scan, executor.cc:66-77, as an
    op)."""
    x = values_of(ins["X"][0])
    return {"Out": [torch.isfinite(x).all().reshape(1)]}


@register_op("count_nonfinite", stop_gradient_op=True,
             nondiff_inputs=("X",))
def count_nonfinite(ctx, ins, attrs):
    """[1] int32: the NaN and Inf elements of X (a ragged X's values),
    the reduction behind `numerics_nonfinite_total` (obs/health.py).  It
    stays on the device: nothing is read back until it is fetched."""
    x = values_of(ins["X"][0])
    bad = torch.logical_not(torch.isfinite(x))
    return {"Out": [bad.sum(dtype=torch.int32).reshape(1)]}


@register_op("squared_l2_distance")
def squared_l2_distance(ctx, ins, attrs):
    """sub_result = X - Y (a Y of one row broadcasts) and Out [N, 1], the
    sum of its squares over every dim but the first."""
    x, y = values_of(ins["X"][0]), values_of(ins["Y"][0])
    sub = x - y
    out = torch.sum(torch.square(sub), dim=tuple(range(1, sub.dim())),
                    keepdim=True)
    return {"sub_result": [sub], "Out": [out.reshape(x.shape[0], 1)]}


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
