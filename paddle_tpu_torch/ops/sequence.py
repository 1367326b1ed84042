"""Sequence op kernels over RaggedTensors: `sequence_pool`,
`sequence_softmax`, `sequence_conv`, `row_conv`, `sequence_expand`,
`sequence_concat`, `sequence_reshape`, `sequence_slice`,
`sequence_reverse`, `lod_reset`, the recurrences `lstm`, `gru` and
`gru_unit`, `sequence_to_dense`/`dense_to_sequence`, and the
nested-sequence ops `seq_unnest`, `seq_outer_expand` and `seq_renest`.

Counterpart of paddle_tpu/ops/sequence.py (reference:
sequence_pool_op.cc, sequence_conv_op.cc + math/context_project.h,
sequence_expand_op.cc, sequence_concat_op.cc, sequence_reshape_op.cc,
sequence_slice_op.cc, sequence_softmax_op.cc, lod_reset_op.cc,
row_conv_op.cc, lstm_op.cc + math/lstm_compute, gru_op.cc +
math/gru_compute).  A sum over each sequence's rows is one segment
reduction over its splits (`_segment_sum`), which adds in row order, so
it repeats bit for bit on the card; the max is `scatter_reduce`, whose
grad splits evenly among tied maxima, as the JAX side's `segment_max`
does.  Rows move between sequences by indexed gathers, whose grads on
the card sum repeated rows in a fixed order.  A recurrence densifies
the ragged rows into [B, maxT] by a masked gather, runs a Python loop
over time on the executor's device and gathers the steps back into
rows.  The loop's extent is `max_seqlen`, a host int, so no step waits
on the device to learn it.  `sequence_to_dense` and `dense_to_sequence`
are the DynamicRNN's bridge between ragged values and the time-major
padded tensors of the `recurrent` engine (ops/control_flow.py).  Every
grad is the generic vjp (ops/registry.py).  The nested-sequence ops
flatten a lod-level-2 sequence's outer level into the batch and put it
back, so a nested DynamicRNN is two ordinary ones.
"""

import torch

from ..core.ragged import RaggedTensor
from .amp_util import amp_result, mxu_operands
from .registry import register_op, values_of

__all__ = ["ragged_to_padded", "padded_to_ragged"]


def _amp_dot(a, b):
    """The recurrent product under the bf16 policy: bf16 operands under
    `amp_bf16` (cuBLAS accumulates them in f32), the result in the
    operands' promoted dtype or, under `amp_bf16_act`, bf16."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    am, bm = mxu_operands(a, b)
    return amp_result(torch.matmul(am, bm), dtype)


def _seg_pos(rt, level=-1):
    """(segment ids [T], position in the sequence [T], valid mask [T]),
    int64 ids; a padding row's segment is clipped into range and its
    mask is False."""
    rs = rt.row_splits[level]
    nseq = rs.shape[0] - 1
    pos = torch.arange(rt.values.shape[0], dtype=torch.int32,
                       device=rs.device)
    seg = torch.searchsorted(rs, pos, right=True) - 1
    seg = seg.clamp(0, nseq - 1)
    inseq = pos - rs[:-1][seg]
    return seg, inseq, pos < rt.nvalid


def _padded_time(rt):
    """The static time extent of `rt` densified: its `max_seqlen` hint
    (feeds from DataFeeder and from_sequences carry one), else all T
    rows."""
    T = rt.values.shape[0]
    if rt.max_seqlen is not None:
        return min(T, int(rt.max_seqlen))
    return T


def _lead_mask(mask, like):
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def ragged_to_padded(rt, fill=0.0):
    """[T, ...] ragged -> ([B, maxT, ...] padded, lengths [B]).

    Step t of sequence b is row `starts[b] + t` where t is below the
    sequence's length and the row below `nvalid`, else `fill`: a gather
    through masked indices, so the rows past `nvalid` and steps past the
    extent are dropped, as the JAX side's scatter with mode="drop" drops
    them, and no position is written twice."""
    rs = rt.last_splits()
    B, Tp = rt.nseq(), _padded_time(rt)
    lens = rs[1:] - rs[:-1]
    t = torch.arange(Tp, dtype=torch.int32, device=rs.device)
    rows = rs[:-1, None] + t[None, :]
    keep = (t[None, :] < lens[:, None]) & (rows < rt.nvalid)
    vals = rt.values[rows.clamp(0, max(rt.values.shape[0] - 1, 0)).long()]
    fill = torch.full((), fill, dtype=vals.dtype, device=vals.device)
    return torch.where(_lead_mask(keep, vals), vals, fill), lens


def padded_to_ragged(padded, rt_like):
    """The inverse of ragged_to_padded over rt_like's splits: each valid
    row takes its (sequence, step) of `padded`, a padding row 0."""
    seg, inseq, valid = _seg_pos(rt_like)
    Tp = padded.shape[1]
    vals = padded[seg, inseq.clamp(0, Tp - 1).long()]
    vals = torch.where(_lead_mask(valid, vals), vals,
                       torch.zeros((), dtype=vals.dtype,
                                   device=vals.device))
    return RaggedTensor(vals, rt_like.row_splits, rt_like.nvalid,
                        max_seqlen=rt_like.max_seqlen)


def _segment_sum(x, values=None):
    """[B, ...]: each sequence's valid rows of `values` (X's own by
    default) summed in row order by one segment reduction over X's
    splits (the rows already lie in sequence order), so the sums repeat
    bit for bit on the card, as an atomic `index_add` would not.
    Sequence b covers rows [splits[b], splits[b + 1]) cut at `nvalid`
    (a row between the last split and `nvalid` counts in the last
    sequence, as the JAX side's clipped segment ids count it); one more
    segment takes the rows past `nvalid` and is dropped.  An empty
    sequence sums to 0."""
    v = x.values if values is None else values
    rs = x.last_splits().long()
    nvalid = x.nvalid.long().reshape(1)
    offsets = torch.cat([torch.minimum(rs[:-1], nvalid), nvalid,
                         torch.full((1,), v.shape[0], dtype=torch.long,
                                    device=rs.device)])
    return torch.segment_reduce(v, "sum", offsets=offsets, axis=0,
                                unsafe=True)[:-1]


@register_op("sequence_pool")
def sequence_pool(ctx, ins, attrs):
    """reference: sequence_pool_op.cc.  SUM, AVERAGE, SQRT, MAX, LAST or
    FIRST over each sequence of X's last level: a dense [B, ...].
    AVERAGE and SQRT divide by max(length, 1); MAX of an empty sequence
    is 0; padding rows take no part.  MaxIndex is each sequence's row
    for LAST and FIRST, else zeros."""
    x = ins["X"][0]
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    seg, _, valid = _seg_pos(x)
    B = x.nseq()
    v = x.values
    vmask = _lead_mask(valid, v)
    seg_s = torch.where(valid, seg, B)  # padding -> the dropped segment
    zeros_idx = torch.zeros((B,), dtype=torch.int32, device=v.device)
    if ptype in ("SUM", "AVERAGE", "SQRT"):
        s = _segment_sum(x)
        if ptype != "SUM":
            lens = x.seq_lengths().clamp(min=1).to(s.dtype)
            if ptype == "SQRT":
                lens = torch.sqrt(lens)
            s = s / _lead_mask(lens, s)
        return {"Out": [s], "MaxIndex": [zeros_idx]}
    if ptype == "MAX":
        neg = torch.where(vmask, v, torch.full((), float("-inf"),
                                               dtype=v.dtype,
                                               device=v.device))
        idx = _lead_mask(seg_s, v).expand(v.shape)
        s = torch.full((B + 1,) + tuple(v.shape[1:]), float("-inf"),
                       dtype=v.dtype, device=v.device).scatter_reduce(
            0, idx, neg, reduce="amax", include_self=False)[:B]
        s = torch.where(torch.isfinite(s), s,
                        torch.zeros((), dtype=s.dtype, device=s.device))
        return {"Out": [s], "MaxIndex": [zeros_idx]}
    if ptype in ("LAST", "FIRST"):
        rs = x.last_splits()
        idx = (rs[1:] - 1 if ptype == "LAST" else rs[:-1]).clamp(
            0, v.shape[0] - 1)
        return {"Out": [v[idx.long()]], "MaxIndex": [idx.to(torch.int32)]}
    raise ValueError("unknown pooltype %r" % ptype)


_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}


def _reverse_in_length(padded, lens):
    """Each sequence of [B, T, ...] reversed within its length (steps
    past it take a clipped copy, which the masks ignore).  An indexed
    gather, whose grad on the card sums repeated positions in a fixed
    order (an index put with accumulation sorts its indices)."""
    B, T = padded.shape[0], padded.shape[1]
    t = torch.arange(T, dtype=lens.dtype, device=lens.device)
    rev = (lens[:, None] - 1 - t[None, :]).clamp(0, T - 1).long()
    rows = torch.arange(B, device=lens.device)[:, None]
    return padded[rows, rev]


@register_op("lstm")
def lstm(ctx, ins, attrs):
    """Dynamic LSTM over a ragged batch (reference: lstm_op.cc +
    math/lstm_compute.h; gate order i, f, c, o).  Input is the ragged
    [T, 4D] projection, Weight [D, 4D], Bias [1, 4D] or, with
    peepholes, [1, 7D] whose [4D:7D] holds the peepholes of the input,
    forget and output gates.  Under the bf16 policy the h and c carries
    stay f32 (the cell state accumulates over every step) and the
    ragged outputs drop back to the input's dtype.  A step past a
    sequence's length keeps its carry (m*h + (1-m)*h_prev, as the JAX
    side writes it, so the grads match).  BatchGate is the input and
    BatchCellPreAct the cell, as on the JAX side."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    b = ins["Bias"][0] if ins.get("Bias") else None
    use_peepholes = attrs.get("use_peepholes", True)
    act_g = _ACTS[attrs.get("gate_activation", "sigmoid")]
    act_c = _ACTS[attrs.get("cell_activation", "tanh")]
    act_h = _ACTS[attrs.get("candidate_activation", "tanh")]
    is_reverse = attrs.get("is_reverse", False)

    D = w.shape[0]
    padded, lens = ragged_to_padded(x)      # [B, T, 4D]
    B, T = padded.shape[0], padded.shape[1]
    if is_reverse:
        padded = _reverse_in_length(padded, lens)

    bias_g = peep = None
    if b is not None:
        bflat = b.reshape(-1)
        bias_g = bflat[:4 * D]
        if use_peepholes and bflat.shape[0] >= 7 * D:
            peep = (bflat[4 * D:5 * D], bflat[5 * D:6 * D],
                    bflat[6 * D:7 * D])  # Wic, Wif, Woc

    state_dtype = torch.float32 if padded.dtype == torch.bfloat16 \
        else padded.dtype
    h = (ins["H0"][0] if ins.get("H0") else torch.zeros(
        (B, D), device=padded.device)).to(state_dtype)
    c = (ins["C0"][0] if ins.get("C0") else torch.zeros(
        (B, D), device=padded.device)).to(state_dtype)
    t = torch.arange(T, dtype=lens.dtype, device=lens.device)
    mask = (t[:, None] < lens[None, :]).to(state_dtype)[..., None]

    hs, cs = [], []
    for step in range(T):
        gates = padded[:, step] + _amp_dot(h, w)
        if bias_g is not None:
            gates = gates + bias_g[None, :]
        gi, gf, gc, go = gates.split(D, dim=1)
        if peep is not None:
            gi = gi + peep[0][None, :] * c
            gf = gf + peep[1][None, :] * c
        c_new = act_g(gf) * c + act_g(gi) * act_c(gc)
        if peep is not None:
            go = go + peep[2][None, :] * c_new
        h_new = act_g(go) * act_h(c_new)
        m = mask[step]
        h = m * h_new + (1 - m) * h
        c = m * c_new + (1 - m) * c
        hs.append(h)
        cs.append(c)
    hs = torch.stack(hs, 1)                # [B, T, D]
    cs = torch.stack(cs, 1)
    if is_reverse:
        hs = _reverse_in_length(hs, lens)
        cs = _reverse_in_length(cs, lens)

    hidden = padded_to_ragged(hs.to(x.values.dtype), x)
    cell = padded_to_ragged(cs.to(x.values.dtype), x)
    return {"Hidden": [hidden], "Cell": [cell],
            "BatchGate": [x], "BatchCellPreAct": [cell]}


def _sequence_to_dense_infer(block, op_desc):
    """Out [-1, -1, ...X's row], Mask float32 [-1, -1]: the padded time
    extent is dynamic (the JAX side's `_sequence_to_dense_infer`)."""
    from ..fluid.framework import _find_var_desc

    xv = _find_var_desc(block, op_desc.input("X")[0])
    out = _find_var_desc(block, op_desc.output("Out")[0])
    mask = _find_var_desc(block, op_desc.output("Mask")[0])
    out.shape = (-1, -1) + tuple(xv.shape[1:] if xv.shape else ())
    out.dtype, out.lod_level = xv.dtype, 0
    mask.shape, mask.dtype, mask.lod_level = (-1, -1), "float32", 0


@register_op("sequence_to_dense", infer_desc=_sequence_to_dense_infer)
def sequence_to_dense(ctx, ins, attrs):
    """Ragged [T, ...] -> padded [B, maxT, ...] and its float32 validity
    Mask [B, maxT], maxT the `max_seqlen` hint (`ragged_to_padded`);
    rows past `nvalid` stay out."""
    padded, lens = ragged_to_padded(ins["X"][0])
    t = torch.arange(padded.shape[1], dtype=lens.dtype, device=lens.device)
    mask = (t[None, :] < lens[:, None]).to(torch.float32)
    return {"Out": [padded], "Mask": [mask]}


def _dense_to_sequence_infer(block, op_desc):
    """Out [-1, ...X's dims past the time axis] with Like's lod level
    (the JAX side's `_dense_to_sequence_infer`)."""
    from ..fluid.framework import _find_var_desc

    xv = _find_var_desc(block, op_desc.input("X")[0])
    like = _find_var_desc(block, op_desc.input("Like")[0])
    out = _find_var_desc(block, op_desc.output("Out")[0])
    out.shape = (-1,) + tuple(xv.shape[2:] if xv.shape else ())
    out.dtype, out.lod_level = xv.dtype, like.lod_level


@register_op("dense_to_sequence", infer_desc=_dense_to_sequence_infer)
def dense_to_sequence(ctx, ins, attrs):
    """Padded [B, maxT, ...] -> ragged over Like's splits
    (`padded_to_ragged`): each valid row takes its (sequence, step), a
    row past `nvalid` 0.  Like's values are not read."""
    return {"Out": [padded_to_ragged(ins["X"][0], ins["Like"][0])]}


@register_op("sequence_softmax")
def sequence_softmax(ctx, ins, attrs):
    """Softmax within each sequence of X [T, 1] (reference:
    sequence_softmax_op.cc): the max by segment (`scatter_reduce`, whose
    grad splits evenly among tied maxima as `segment_max`'s does), the
    denominators by `_segment_sum`, at least 1e-12; rows past `nvalid`
    give 0."""
    x = ins["X"][0]
    seg, _, valid = _seg_pos(x)
    B = x.nseq()
    v = x.values.reshape(-1)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    v = torch.where(valid, v, torch.full((), float("-inf"), dtype=v.dtype,
                                         device=v.device))
    seg_s = torch.where(valid, seg, B).long()
    mx = torch.full((B + 1,), float("-inf"), dtype=v.dtype,
                    device=v.device).scatter_reduce(
        0, seg_s, v, reduce="amax", include_self=False)
    mx = torch.where(torch.isfinite(mx), mx, zero)
    e = torch.where(valid, torch.exp(v - mx[seg]), zero)
    denom = _segment_sum(x, e)
    out = e / torch.clamp(denom[seg], min=1e-12)
    out = torch.where(valid, out, zero)
    return {"Out": [x.with_values(out.reshape(x.values.shape))]}


@register_op("sequence_conv")
def sequence_conv(ctx, ins, attrs):
    """Context-window convolution along each sequence (reference:
    sequence_conv_op.cc + math/context_project.h): row i of a sequence
    takes the rows at offsets contextStart .. contextStart +
    contextLength - 1 from it (zeros outside the sequence or past
    `nvalid`), side by side [T, contextLength * D], times Filter
    [contextLength * D, M].  contextStride is not read, as on the JAX
    side.  The rows are gathered by indexing, whose grad on the card
    sums repeated rows in a fixed order."""
    x = ins["X"][0]
    filt = ins["Filter"][0]
    ctx_start = int(attrs.get("contextStart", -1))
    ctx_len = int(attrs.get("contextLength", 3))
    seg, inseq, valid = _seg_pos(x)
    T = x.values.shape[0]
    lens = x.seq_lengths()[seg]
    pos = torch.arange(T, dtype=torch.int32, device=seg.device)
    zero = torch.zeros((), dtype=x.values.dtype, device=x.values.device)
    cols = []
    for j in range(ctx_len):
        off = ctx_start + j
        src = (pos + off).clamp(0, max(T - 1, 0)).long()
        ok = (inseq + off >= 0) & (inseq + off < lens) & valid
        cols.append(torch.where(ok[:, None], x.values[src], zero))
    ctx_mat = torch.cat(cols, dim=1)
    dtype = torch.promote_types(ctx_mat.dtype, filt.dtype)
    out = torch.matmul(ctx_mat.to(dtype), filt.to(dtype))
    return {"Out": [x.with_values(out)]}


@register_op("row_conv")
def row_conv(ctx, ins, attrs):
    """Lookahead row convolution (reference: row_conv_op.cc): row i of a
    sequence is the sum over j < k of Filter[j] times row i + j, where
    that row lies in the sequence (Filter [k, D])."""
    x = ins["X"][0]
    filt = ins["Filter"][0]
    seg, inseq, valid = _seg_pos(x)
    T = x.values.shape[0]
    lens = x.seq_lengths()[seg]
    pos = torch.arange(T, dtype=torch.int32, device=seg.device)
    zero = torch.zeros((), dtype=x.values.dtype, device=x.values.device)
    out = torch.zeros_like(x.values)
    for j in range(filt.shape[0]):
        src = (pos + j).clamp(0, max(T - 1, 0)).long()
        ok = (inseq + j < lens) & valid
        out = out + torch.where(ok[:, None], x.values[src] * filt[j][None],
                                zero)
    return {"Out": [x.with_values(out)]}


@register_op("sequence_expand")
def sequence_expand(ctx, ins, attrs):
    """X tiled over Y's lod (reference: sequence_expand_op.cc): a dense
    X's row i fills Y's i-th sequence (level 0); a ragged X's sequence i
    is laid over it row by row.  The result has Y's splits and `nvalid`
    (no length hint, as on the JAX side); rows past `nvalid` are 0."""
    x, y = ins["X"][0], ins["Y"][0]
    seg, inseq, valid = _seg_pos(y, level=0)
    xv = values_of(x)
    if isinstance(x, RaggedTensor):
        src = (x.last_splits()[seg] + inseq).clamp(0, xv.shape[0] - 1)
        out = xv[src.long()]
    else:
        out = xv[seg.long()]
    out = torch.where(_lead_mask(valid, out), out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    return {"Out": [RaggedTensor(out, y.row_splits, y.nvalid)]}


def _concat_time_pair(a, b):
    """out[i] = a[i] ++ b[i] for two lod-level-1 RaggedTensors, by one
    indexed gather over their stacked rows (the JAX side's
    `_concat_time_pair`, padding rows included: the flat length is the
    sum of both, and `nvalid` the sum of theirs)."""
    rs_a, rs_b = a.row_splits[-1], b.row_splits[-1]
    nseq = rs_a.shape[0] - 1
    la, lb = rs_a[1:] - rs_a[:-1], rs_b[1:] - rs_b[:-1]
    out_splits = torch.cat([torch.zeros(1, dtype=torch.int32,
                                        device=rs_a.device),
                            torch.cumsum(la + lb, 0, dtype=torch.int32)])
    ta = a.values.shape[0]
    n_out = ta + b.values.shape[0]
    pos = torch.arange(n_out, dtype=torch.int32, device=rs_a.device)
    seg = (torch.searchsorted(out_splits, pos, right=True) - 1).clamp(
        0, nseq - 1)
    off = pos - out_splits[seg]
    src = torch.where(off < la[seg], rs_a[seg] + off,
                      ta + rs_b[seg] + (off - la[seg]))
    vals = torch.cat([a.values, b.values], 0)[
        src.clamp(0, n_out - 1).long()]
    return RaggedTensor(vals, [out_splits], nvalid=a.nvalid + b.nvalid)


@register_op("sequence_concat")
def sequence_concat(ctx, ins, attrs):
    """Concatenation along time (axis 0: each sequence of the first
    input, then the same sequence of the next) or along the features
    (axis 1) (reference: sequence_concat_op.cc)."""
    xs = ins["X"]
    if int(attrs.get("axis", 0)) == 1:
        return {"Out": [xs[0].with_values(
            torch.cat([x.values for x in xs], dim=1))]}
    out = xs[0]
    for x in xs[1:]:
        out = _concat_time_pair(out, x)
    return {"Out": [out]}


def _sequence_reshape_infer(block, op_desc):
    """Out [-1, new_dim] at lod level at least 1 (the JAX side's
    `_sequence_reshape_infer`: a meta run's row count need not divide
    by new_dim)."""
    from ..fluid.framework import _find_var_desc

    xv = _find_var_desc(block, op_desc.input("X")[0])
    out = _find_var_desc(block, op_desc.output("Out")[0])
    out.shape = (-1, int(op_desc.attrs["new_dim"]))
    out.dtype = xv.dtype
    out.lod_level = max(xv.lod_level or 0, 1)


@register_op("sequence_reshape", infer_desc=_sequence_reshape_infer)
def sequence_reshape(ctx, ins, attrs):
    """Rows of width D regrouped into rows of `new_dim` (reference:
    sequence_reshape_op.cc): every split and `nvalid` scaled by D /
    new_dim in float32, then truncated, as the JAX side computes
    them."""
    x = ins["X"][0]
    new_dim = int(attrs["new_dim"])
    factor = torch.tensor(x.values.shape[1] / new_dim, dtype=torch.float32,
                          device=x.values.device)
    rs = [(r.to(torch.float32) * factor).to(torch.int32)
          for r in x.row_splits]
    nvalid = (x.nvalid.to(torch.float32) * factor).to(torch.int32)
    return {"Out": [RaggedTensor(x.values.reshape(-1, new_dim), rs,
                                 nvalid)]}


@register_op("sequence_slice")
def sequence_slice(ctx, ins, attrs):
    """Rows [Offset[i], Offset[i] + Length[i]) of each sequence i
    (reference: sequence_slice_op.cc).  The flat buffer keeps its size:
    the sliced rows lead it, and the rows past the new `nvalid` are
    0."""
    x = ins["X"][0]
    offset = ins["Offset"][0].reshape(-1).to(torch.int32)
    length = ins["Length"][0].reshape(-1).to(torch.int32)
    T = x.values.shape[0]
    dev = x.values.device
    new_splits = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                            torch.cumsum(length, 0, dtype=torch.int32)])
    pos = torch.arange(T, dtype=torch.int32, device=dev)
    new_seg = (torch.searchsorted(new_splits, pos, right=True) - 1).clamp(
        0, x.nseq() - 1)
    new_in = pos - new_splits[new_seg]
    src = (x.last_splits()[new_seg] + offset[new_seg] + new_in).clamp(
        0, max(T - 1, 0))
    vals = x.values[src.long()]
    nvalid = new_splits[-1]
    vals = torch.where(_lead_mask(pos < nvalid, vals), vals,
                       torch.zeros((), dtype=vals.dtype, device=dev))
    return {"Out": [RaggedTensor(vals, [new_splits], nvalid)]}


@register_op("sequence_reverse")
def sequence_reverse(ctx, ins, attrs):
    """The rows of each sequence in reverse order, the same splits out
    (reference: RecurrentLayerGroup's reversed inlinks): a gather
    through the mirrored position in the sequence; rows past `nvalid`
    are 0."""
    x = ins["X"][0]
    seg, inseq, valid = _seg_pos(x)
    rs = x.last_splits()
    lengths = rs[1:] - rs[:-1]
    src = (rs[seg] + lengths[seg] - 1 - inseq).clamp(
        0, x.values.shape[0] - 1)
    vals = torch.where(_lead_mask(valid, x.values), x.values[src.long()],
                       torch.zeros((), dtype=x.values.dtype,
                                   device=x.values.device))
    return {"Y": [RaggedTensor(vals, x.row_splits, x.nvalid)]}


@register_op("lod_reset")
def lod_reset(ctx, ins, attrs):
    """X's rows under a new lod level 1: TargetLoD's offsets when it is
    given, else the `target_lod` attr (reference: lod_reset_op.cc)."""
    xv = values_of(ins["X"][0])
    if ins.get("TargetLoD"):
        target = ins["TargetLoD"][0].reshape(-1).to(torch.int32)
    else:
        target = torch.tensor([int(v) for v in attrs["target_lod"]],
                              dtype=torch.int32, device=xv.device)
    return {"Out": [RaggedTensor(xv, [target])]}


@register_op("gru")
def gru(ctx, ins, attrs):
    """Dynamic GRU over a ragged batch (reference: gru_op.cc +
    math/gru_compute; gates [update u, reset r, candidate c]).  Input is
    the ragged [T, 3D] projection, with the Bias [1, 3D] added to it;
    Weight [D, 3D] holds the u and r weights [D, 2D], then the
    candidate's [D, D].  A step: u, r = act_g(x_ur + h W_ur), c =
    act(x_c + (r h) W_c), h = u h + (1 - u) c, where r multiplies h
    before the candidate's product.  This is not cuDNN's GRU, whose
    reset gate multiplies after it.  Under the bf16 policy the state
    stays f32 and Hidden drops back to the input's dtype.  `is_reverse`
    runs each sequence backwards within its length.  The workspace
    outputs name the input and Hidden, as on the JAX side."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    b = ins["Bias"][0] if ins.get("Bias") else None
    act_g = _ACTS[attrs.get("gate_activation", "sigmoid")]
    act_c = _ACTS[attrs.get("activation", "tanh")]
    D = w.shape[0]
    w_ur, w_c = w[:, :2 * D], w[:, 2 * D:]
    padded, lens = ragged_to_padded(x)
    B, T = padded.shape[0], padded.shape[1]
    if attrs.get("is_reverse", False):
        padded = _reverse_in_length(padded, lens)
    if b is not None:
        padded = padded + b.reshape(1, 1, -1)
    state_dtype = torch.float32 if x.values.dtype == torch.bfloat16 \
        else x.values.dtype
    h = (ins["H0"][0] if ins.get("H0") else torch.zeros(
        (B, D), device=padded.device)).to(state_dtype)
    t = torch.arange(T, dtype=lens.dtype, device=lens.device)
    mask = (t[:, None] < lens[None, :]).to(state_dtype)[..., None]
    hs = []
    for step in range(T):
        x_t = padded[:, step]
        ur = act_g(x_t[:, :2 * D].to(state_dtype) + _amp_dot(h, w_ur))
        u, r = ur[:, :D], ur[:, D:]
        c = act_c(x_t[:, 2 * D:].to(state_dtype) + _amp_dot(r * h, w_c))
        h_new = u * h + (1 - u) * c
        m = mask[step]
        h = m * h_new + (1 - m) * h
        hs.append(h)
    hs = torch.stack(hs, 1)
    if attrs.get("is_reverse", False):
        hs = _reverse_in_length(hs, lens)
    hidden = padded_to_ragged(hs.to(x.values.dtype), x)
    return {"Hidden": [hidden], "BatchGate": [x],
            "BatchResetHiddenPrev": [hidden], "BatchHidden": [hidden]}


@register_op("gru_unit")
def gru_unit(ctx, ins, attrs):
    """One GRU step on dense tensors (reference: gru_unit_op.cc): Input
    [N, 3D] plus the Bias, HiddenPrev [N, D]; Gate is [u, r, c] and
    ResetHiddenPrev r * h_prev."""
    x = ins["Input"][0]
    h_prev = ins["HiddenPrev"][0]
    w = ins["Weight"][0]
    act_g = _ACTS[attrs.get("gate_activation", "sigmoid")]
    act_c = _ACTS[attrs.get("activation", "tanh")]
    D = h_prev.shape[1]
    if ins.get("Bias"):
        x = x + ins["Bias"][0].reshape(1, -1)
    ur = act_g(x[:, :2 * D] + _amp_dot(h_prev, w[:, :2 * D]))
    u, r = ur[:, :D], ur[:, D:]
    c = act_c(x[:, 2 * D:] + _amp_dot(r * h_prev, w[:, 2 * D:]))
    h = u * h_prev + (1 - u) * c
    return {"Gate": [torch.cat([u, r, c], dim=1)],
            "ResetHiddenPrev": [r * h_prev], "Hidden": [h]}


# -- nested (lod-level-2) sequences --------------------------------------------
# The nested mode of the reference's RecurrentGradientMachine (layers.py
# SubsequenceInput) runs flattened, as on the JAX side: the outer loop over
# subsequences becomes the batch (each inner sequence an independent lod-1
# sequence), the step runs once over all of them, and the outer splits are
# put back after.  The three ops move splits; their values pass through.

@register_op("seq_unnest")
def seq_unnest(ctx, ins, attrs):
    """A lod-level-2 X -> (Inner: the lod-1 batch of its inner sequences,
    OuterRef: [n_inner, 1] zeros ragged over X's outer splits, which
    carries them to `seq_outer_expand` and `seq_renest`)."""
    x = ins["X"][0]
    if not isinstance(x, RaggedTensor) or x.lod_level < 2:
        raise ValueError("seq_unnest needs a lod_level-2 input")
    outer, inner = x.row_splits[0], x.row_splits[-1]
    n_inner = inner.shape[0] - 1
    inner_batch = RaggedTensor(x.values, [inner], x.nvalid,
                               max_seqlen=x.max_seqlen)
    outer_ref = RaggedTensor(
        torch.zeros((n_inner, 1), dtype=torch.float32, device=outer.device),
        [outer], n_inner)
    return {"Inner": [inner_batch], "OuterRef": [outer_ref]}


@register_op("seq_outer_expand", nondiff_inputs=("OuterRef",))
def seq_outer_expand(ctx, ins, attrs):
    """Out[s] = X[the sample of inner sequence s]: a per-sample row
    tiled over that sample's subsequences (a StaticInput entering every
    outer step, flattened); an indexed gather, whose grad sums the
    repeated rows in a fixed order."""
    x, ref = ins["X"][0], ins["OuterRef"][0]
    seg = ref.segment_ids(level=-1)
    return {"Out": [values_of(x)[seg.long()]]}


@register_op("seq_renest", nondiff_inputs=("OuterRef",))
def seq_renest(ctx, ins, attrs):
    """The outer splits of OuterRef put back over a flattened result:
    dense [n_inner, D] rows become a lod-1 sequence over the samples; a
    lod-1 X (steps of each inner sequence) becomes the lod-2 nested
    sequence.  Off the meta device the outer splits must cover X's rows
    or sequences, checked on the host (one read of the last offset), as
    the JAX side checks eagerly."""
    x, ref = ins["X"][0], ins["OuterRef"][0]
    outer = ref.row_splits[0]
    rows = (x.last_splits().shape[0] - 1 if isinstance(x, RaggedTensor)
            else x.shape[0])
    if outer.device.type != "meta":
        expected = int(outer[-1])
        if expected != rows:
            raise ValueError(
                "seq_renest: step output has %d %s but the outer splits "
                "cover %d inner sequences — the nested step must produce "
                "one row (or one sequence) per subsequence"
                % (rows, "sequences" if isinstance(x, RaggedTensor)
                   else "rows", expected))
    if isinstance(x, RaggedTensor):
        return {"Out": [RaggedTensor(x.values, [outer, x.last_splits()],
                                     x.nvalid, max_seqlen=x.max_seqlen)]}
    return {"Out": [RaggedTensor(x, [outer])]}
