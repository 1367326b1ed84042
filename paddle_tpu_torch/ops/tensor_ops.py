"""Tensor op kernels: `fill_constant`, `fill_constant_batch_size_like`,
`fill_zeros_like`, `fill`, `assign`, `assign_value`, `cast`, `scale`,
`split`, `concat`, `reshape`, `transpose`, `expand`, `sum`,
`increment`, `sign`, `clip`, `clip_by_norm`, `top_k`, `gather`,
`scatter`, `pad`, `crop`, `multiplex`, `is_empty`, `shape` and
`recompute_barrier`.

Counterpart of paddle_tpu/ops/tensor_ops.py (reference:
fill_constant_op.cc, fill_constant_batch_size_like_op.cc,
fill_zeros_like_op.cc, fill_op.cc, assign_op.cc, assign_value_op.cc,
cast_op.cc, scale_op.cc, split_op.cc, concat_op.cc, reshape_op.cc,
transpose_op.cc, expand_op.cc, sum_op.cc, increment_op.cc, sign_op.cc,
clip_op.cc, clip_by_norm_op.cc, top_k_op.cc, gather_op.cc,
scatter_op.cc, pad_op.cc, crop_op.cc, multiplex_op.cc,
is_empty_op.cc, shape_op.cc).
`sum` takes ragged (LoD) and SelectedRows inputs; `split` and
`concat` along a feature axis, `fill_zeros_like`, `increment`, `sign`
and `top_k` keep a ragged input's splits.  `gather` and `scatter`
index as the JAX side's `jnp.take` and `.at[].set` do, and both repeat
bit for bit on the card: `gather`'s grad sums the rows of a repeated
index in a fixed order (`core.ragged.add_rows_`), and `scatter` lets
the last of a repeated index win by a max over positions, not by the
order of the card's writes.  `recompute_barrier`, which
`fluid/recompute.py` puts before each recomputed segment, is an identity
here (its docstring says why).
"""

import functools

import numpy as np
import torch

from ..core.ragged import RaggedTensor, SelectedRows, add_rows_, row_index
from ..core.types import exec_dtype, np_dtype, torch_dtype
from .activation import jnp_clip
from .registry import (dense, device_constant, like, register_grad_kernel,
                       register_op, values_of)


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


@register_op("fill_zeros_like", stop_gradient_op=True)
def fill_zeros_like(ctx, ins, attrs):
    """Zeros of X's shape and dtype (ragged over X's splits)."""
    x = ins["X"][0]
    return {"Out": [like(x, torch.zeros_like(values_of(x)))]}


def _attr_values(attrs, key):
    """Attr `key` (a flat list) as a tensor of `shape` and `dtype` on the
    host, as it executes (int64 as int32, float64 as float32), as the
    JAX side's `jnp.asarray` of the numpy array makes it."""
    shape = tuple(int(s) for s in attrs["shape"])
    dtype = attrs.get("dtype", "float32")
    values = np.asarray(attrs[key], np_dtype(dtype)).reshape(shape)
    return torch.from_numpy(values.astype(np_dtype(exec_dtype(dtype))))


@register_op("fill", stop_gradient_op=True)
def fill(ctx, ins, attrs):
    """Attr `data` as a tensor of `shape` and `dtype` (reference
    fill_op.cc; its run-once and force_cpu attrs are placement details
    the port leaves to the executor's device)."""
    return {"Out": [_attr_values(attrs, "data").to(ctx.device)]}


@register_op("assign")
def assign(ctx, ins, attrs):
    """X itself."""
    return {"Out": [ins["X"][0]]}


@register_op("assign_value", stop_gradient_op=True)
def assign_value(ctx, ins, attrs):
    """Attr `values` as a tensor of `shape` and `dtype`."""
    return {"Out": [_attr_values(attrs, "values").to(ctx.device)]}


@register_op("cast")
def cast(ctx, ins, attrs):
    """X in `out_dtype` (or `dtype`), as it executes (int64 as int32)."""
    dtype = attrs["out_dtype"] if "out_dtype" in attrs else attrs["dtype"]
    return {"Out": [ins["X"][0].to(torch_dtype(dtype))]}


@register_op("recompute_barrier", stop_gradient_op=True)
def recompute_barrier(ctx, ins, attrs):
    """Out is X itself, no copy; the Trigger operand (an incoming
    backward gradient) is read and dropped.  The JAX op puts X and
    Trigger behind `lax.optimization_barrier`, so that XLA neither merges
    a recomputed clone (fluid/recompute.py) into the original forward
    nor hoists it next to it.  In the port the program's order is the
    order it runs in and nothing merges duplicate ops, so the clone runs
    where the rewrite put it and the barrier has nothing to do."""
    return {"Out": list(ins["X"])}


@register_op("scale")
def scale(ctx, ins, attrs):
    """X times `scale`; a ragged X keeps its splits."""
    x = ins["X"][0]
    return {"Out": [like(x, values_of(x) * attrs.get("scale", 1.0))]}


@register_op("split")
def split(ctx, ins, attrs):
    """By `sections` (sizes along `axis`) when the list is non-empty,
    else into `num` equal parts — the JAX side's rule, so a desc
    carrying `sections: []` and `num: 3` splits by num.  A ragged X
    splits its values; split along a feature axis (not 0), each part
    keeps X's splits, as on the JAX side."""
    xr = ins["X"][0]
    x = values_of(xr)
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
    if isinstance(xr, RaggedTensor) and axis != 0:
        parts = [like(xr, p) for p in parts]
    return {"Out": list(parts)}


@register_op("concat")
def concat(ctx, ins, attrs):
    """The X inputs joined along `axis`.  Ragged inputs join their rows'
    values; along a feature axis (not 0) the rows line up step for step,
    so the result keeps the first ragged input's splits, as on the JAX
    side (axis 0 across sequences is `sequence_concat`)."""
    axis = int(attrs.get("axis", 0))
    ragged = next((x for x in ins["X"] if isinstance(x, RaggedTensor)),
                  None)
    xs = [x.values if isinstance(x, RaggedTensor) else dense(x, "concat")
          for x in ins["X"]]
    out = torch.cat(xs, axis)
    if ragged is not None and axis != 0:
        return {"Out": [like(ragged, out)]}
    return {"Out": [out]}


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


@register_op("expand")
def expand(ctx, ins, attrs):
    """X tiled `expand_times` along each dim (`jnp.tile`: fewer times
    than dims tile the last dims, more add leading dims)."""
    x = dense(ins["X"][0], "expand")
    times = [int(t) for t in attrs["expand_times"]]
    times = [1] * (x.dim() - len(times)) + times
    return {"Out": [x.repeat(*times)]}


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
    `jnp.asarray(step, x.dtype)`): an int32 position stays int32.  A
    ragged X adds to its values and keeps its splits (the JAX kernel's
    `x + step` raises a TypeError on one: ROADMAP C)."""
    xr = ins["X"][0]
    x = xr.values if isinstance(xr, RaggedTensor) else dense(xr, "increment")
    return {"Out": [like(xr, x + _step_in(attrs.get("step", 1.0),
                                          x.dtype))]}


@functools.lru_cache(maxsize=None)
def _step_in(step, dtype):
    """`step` rounded through `dtype` on the host, once per pair: a
    device tensor made from a host scalar would cost a copy, and a sync,
    per decode step, and a captured segment may make neither."""
    return torch.tensor(step, dtype=dtype).item()


@register_op("sign")
def sign(ctx, ins, attrs):
    """-1, 0 or 1 by the sign of each element (reference sign_op.cc;
    the L1 regularizer's term); a ragged X keeps its splits."""
    x = ins["X"][0]
    return {"Out": [like(x, torch.sign(values_of(x)))]}


@register_op("clip")
def clip(ctx, ins, attrs):
    """X clipped into [min, max], with `jnp.clip`'s grad: half at a
    bound (the global-norm clip's denominator meets its bound when the
    norm equals `clip_norm`)."""
    x = ins["X"][0]
    return {"Out": [jnp_clip(dense(x, "clip"), attrs["min"], attrs["max"])]}


@register_op("clip_by_norm")
def clip_by_norm(ctx, ins, attrs):
    """X scaled by max_norm / ||X|| where its L2 norm exceeds
    `max_norm`, else X."""
    x = dense(ins["X"][0], "clip_by_norm")
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones((), dtype=norm.dtype,
                                   device=norm.device)).to(x.dtype)
    return {"Out": [x * scale]}


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


@register_op("gather")
def gather(ctx, ins, attrs):
    """The rows of X at Index (flattened), as `jnp.take(x, index,
    axis=0)`: a negative id counts from the end, one outside [-n, n)
    gives a NaN row (the `lookup_table` convention)."""
    x = dense(ins["X"][0], "gather")
    # jnp.take's reading: a negative id wraps, one outside [-n, n) is
    # invalid (clamped into range here, masked below)
    index, valid = row_index(ins["Index"][0].reshape(-1).long(), x.shape[0])
    out = x.index_select(0, index)
    mask = valid.reshape((-1,) + (1,) * (x.dim() - 1))
    return {"Out": [torch.where(mask, out, torch.full(
        (), float("nan"), dtype=x.dtype, device=x.device))]}


@register_grad_kernel("gather")
def gather_grad(ctx, ins, attrs):
    """X@GRAD: OG@Out's rows added into zeros at their ids, those of
    invalid ids dropped (as the JAX side's scatter drops them), the rows
    of a repeated id summed in a fixed order (`core.ragged.add_rows_`),
    so the grad repeats bit for bit on the card, where `index_select`'s
    own backward adds atomically."""
    x = ins["X"][0]
    og = ins["OG@Out"][0]
    if og is None:
        return {"X@GRAD": [torch.zeros_like(x)]}
    return {"X@GRAD": [add_rows_(torch.zeros_like(x),
                                 ins["Index"][0].reshape(-1),
                                 og.reshape((-1,) + tuple(x.shape[1:])))]}


@register_op("scatter")
def scatter(ctx, ins, attrs):
    """Ref with its rows at Index set to Updates' rows, as `ref.at[index]
    .set(updates)`: a negative id counts from the end, one outside
    [-n, n) is dropped, and of a repeated id the last update wins (the
    JAX side's result on the CPU).  The winner of each row is the largest
    position that names it (`scatter_reduce` "amax", which no order of
    the card's writes changes), so the result repeats bit for bit; its
    generic grad gives the winners alone their rows' grad, as JAX's
    scatter transpose does."""
    ref = dense(ins["Ref"][0], "scatter")
    updates = ins["Updates"][0]
    n = ref.shape[0]
    index, valid = row_index(ins["Index"][0].reshape(-1).long(), n)
    pos = torch.arange(index.shape[0], device=ref.device)
    winner = torch.full((n,), -1, dtype=torch.long, device=ref.device)
    winner = winner.scatter_reduce(
        0, index, torch.where(valid, pos, torch.full_like(pos, -1)),
        "amax")
    taken = (winner >= 0).reshape((-1,) + (1,) * (ref.dim() - 1))
    rows = updates.reshape((-1,) + tuple(ref.shape[1:])).index_select(
        0, winner.clamp(min=0))
    return {"Out": [torch.where(taken, rows.to(ref.dtype), ref)]}


@register_op("pad")
def pad(ctx, ins, attrs):
    """X padded with `pad_value` by `paddings`, the flat [before0,
    after0, before1, after1, ...] of every dim."""
    x = dense(ins["X"][0], "pad")
    p = [int(v) for v in attrs["paddings"]]
    # F.pad lists the last dim first
    flat = [v for i in reversed(range(x.dim()))
            for v in (p[2 * i], p[2 * i + 1])]
    return {"Out": [torch.nn.functional.pad(
        x, flat, value=float(attrs.get("pad_value", 0.0)))]}


@register_op("crop")
def crop(ctx, ins, attrs):
    """The block of X at `offsets` of extent `shape`."""
    x = dense(ins["X"][0], "crop")
    slices = tuple(slice(int(o), int(o) + int(s))
                   for o, s in zip(attrs["offsets"], attrs["shape"]))
    return {"Out": [x[slices]]}


@register_op("multiplex", nondiff_inputs=("Ids",))
def multiplex(ctx, ins, attrs):
    """Row i of the Ids[i]-th X, as `stacked[ids, rows]` indexes on the
    JAX side: a negative id counts from the end once, then an id still
    outside [0, n) reads the nearest input, but its row takes no grad
    (XLA's gather clamps, the scatter that transposes it drops)."""
    stacked = torch.stack([values_of(v) for v in ins["X"]], 0)
    index, valid = row_index(ins["Ids"][0].reshape(-1).long(),
                             stacked.shape[0])
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    out = stacked[index, rows]
    mask = valid.reshape((-1,) + (1,) * (out.dim() - 1))
    return {"Out": [torch.where(mask, out, out.detach())]}


@register_op("is_empty", stop_gradient_op=True)
def is_empty(ctx, ins, attrs):
    """A 0-d bool: whether X has no elements."""
    x = values_of(ins["X"][0])
    return {"Out": [torch.full((), x.numel() == 0, dtype=torch.bool,
                               device=x.device)]}


@register_op("shape", stop_gradient_op=True)
def shape_op(ctx, ins, attrs):
    """Input's shape as an int32 vector."""
    x = values_of(ins["Input"][0])
    return {"Out": [device_constant(tuple(x.shape), torch.int32,
                                    x.device).clone()]}
