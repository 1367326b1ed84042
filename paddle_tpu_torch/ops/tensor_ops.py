"""Tensor op kernels: `fill_constant`, `fill_constant_batch_size_like`,
`cast`, `scale`, `split`, `concat`, `reshape`, `transpose`, `sum`,
`increment` and `top_k`.

Counterpart of paddle_tpu/ops/tensor_ops.py (reference:
fill_constant_op.cc, fill_constant_batch_size_like_op.cc, cast_op.cc,
scale_op.cc, split_op.cc, concat_op.cc, reshape_op.cc, transpose_op.cc,
sum_op.cc, increment_op.cc, top_k_op.cc).
`sum` takes ragged (LoD) and SelectedRows inputs, and `top_k` a
ragged X; ragged inputs to the others wait with ROADMAP A7.
"""

import numpy as np
import torch

from ..core.ragged import SelectedRows
from ..core.types import torch_dtype
from .registry import dense, like, register_op, values_of


@register_op("fill_constant", stop_gradient_op=True)
def fill_constant(ctx, ins, attrs):
    """`value` in a tensor of `shape` and `dtype` on the executor's
    device."""
    shape = tuple(int(s) for s in attrs["shape"])
    return {"Out": [torch.full(shape, attrs.get("value", 0.0),
                               dtype=torch_dtype(attrs.get("dtype",
                                                           "float32")),
                               device=ctx.device)]}


@register_op("fill_constant_batch_size_like", stop_gradient_op=True)
def fill_constant_batch_size_like(ctx, ins, attrs):
    """`value` in a tensor of `shape`, whose dim `output_dim_idx` is dim
    `input_dim_idx` of Input (of its values when ragged)."""
    ref = values_of(ins["Input"][0])
    shape = [int(s) for s in attrs["shape"]]
    shape[int(attrs.get("output_dim_idx", 0))] = \
        ref.shape[int(attrs.get("input_dim_idx", 0))]
    return {"Out": [torch.full(shape, attrs.get("value", 0.0),
                               dtype=torch_dtype(attrs.get("dtype",
                                                           "float32")),
                               device=ctx.device)]}


@register_op("cast")
def cast(ctx, ins, attrs):
    """X in `out_dtype` (or `dtype`), as it executes (int64 as int32)."""
    dtype = attrs["out_dtype"] if "out_dtype" in attrs else attrs["dtype"]
    return {"Out": [ins["X"][0].to(torch_dtype(dtype))]}


@register_op("scale")
def scale(ctx, ins, attrs):
    return {"Out": [ins["X"][0] * attrs.get("scale", 1.0)]}


@register_op("split")
def split(ctx, ins, attrs):
    """By `sections` (sizes along `axis`) when the list is non-empty,
    else into `num` equal parts — the JAX side's rule, so a desc
    carrying `sections: []` and `num: 3` splits by num."""
    x = ins["X"][0]
    axis = int(attrs.get("axis", 0))
    sections = attrs.get("sections")
    if sections:
        idx = np.cumsum(sections[:-1]).tolist()
        parts = torch.tensor_split(x, idx, dim=axis)
    else:
        num = int(attrs.get("num", 0))
        if num <= 0 or x.shape[axis] % num:
            raise ValueError("split: dim %d of size %d does not divide "
                             "into %d equal parts"
                             % (axis, x.shape[axis], num))
        parts = torch.split(x, x.shape[axis] // num, dim=axis)
    return {"Out": list(parts)}


@register_op("concat")
def concat(ctx, ins, attrs):
    """The X inputs joined along `axis`."""
    xs = [dense(x, "concat") for x in ins["X"]]
    return {"Out": [torch.cat(xs, int(attrs.get("axis", 0)))]}


@register_op("reshape")
def reshape(ctx, ins, attrs):
    """reference reshape_op.cc: a 0 copies the input dim at its
    position, one -1 is inferred from the rest."""
    x = ins["X"][0]
    shape = [x.shape[i] if int(s) == 0 else int(s)
             for i, s in enumerate(attrs["shape"])]
    return {"Out": [x.reshape(shape)]}


@register_op("transpose")
def transpose(ctx, ins, attrs):
    """X with its dims permuted by `axis` (a view)."""
    x = dense(ins["X"][0], "transpose")
    return {"Out": [x.permute(*[int(a) for a in attrs["axis"]])]}


@register_op("sum")
def sum_op(ctx, ins, attrs):
    """The sum of the X inputs, added in order (the backward's grad
    accumulation); ragged over the first input's splits when it is
    ragged (fc over several sequence inputs).  When every input is a
    SelectedRows (a table looked up more than once), a SelectedRows of
    all their rows and values, concatenated in order, with the first's
    height; SelectedRows among dense inputs are densified first."""
    xs = ins["X"]
    if all(isinstance(x, SelectedRows) for x in xs):
        return {"Out": [SelectedRows(torch.cat([x.rows for x in xs]),
                                     torch.cat([x.values for x in xs]),
                                     xs[0].height)]}
    acc = None
    for x in xs:
        d = x.to_dense() if isinstance(x, SelectedRows) else values_of(x)
        acc = d if acc is None else acc + d
    return {"Out": [like(xs[0], acc)]}


@register_op("increment")
def increment(ctx, ins, attrs):
    """X + `step`, with `step` in X's own dtype (as the JAX side's
    `jnp.asarray(step, x.dtype)`): an int32 position stays int32."""
    x = dense(ins["X"][0], "increment")
    # rounded through the dtype on the host: a device tensor made from a
    # host scalar would cost a copy, and a sync, per decode step
    step = torch.tensor(attrs.get("step", 1.0), dtype=x.dtype).item()
    return {"Out": [x + step]}


def stable_top_k(x, k):
    """(values, indices) of the k largest along the last dim, largest
    first and equal values lower index first, as `lax.top_k` orders
    them (torch.topk leaves the order of ties unspecified)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@register_op("top_k", nondiff_inputs=("X",))
def top_k(ctx, ins, attrs):
    """The `k` largest of X's last dim and their int32 indices; the top
    k of each step of a ragged X is ragged over its splits (the greedy
    CTC decode's argmax)."""
    x = ins["X"][0]
    values, indices = stable_top_k(values_of(x), int(attrs["k"]))
    return {"Out": [like(x, values)],
            "Indices": [like(x, indices.to(torch.int32))]}
