"""Sequence op kernels over RaggedTensors: `sequence_pool`, `lstm`,
and `sequence_to_dense`/`dense_to_sequence`.

Counterpart of paddle_tpu/ops/sequence.py (reference:
sequence_pool_op.cc, lstm_op.cc + math/lstm_compute), the two sequence
ops of bench.py's stacked-LSTM classifier.  Pooling reduces each
sequence's rows by segment (`index_add` and `scatter_reduce`, whose max
splits a gradient evenly among tied maxima, as the JAX side's
`segment_max` does).  The recurrence densifies the ragged rows into
[B, maxT] by a masked gather, runs a Python loop over time on the
executor's device and gathers the steps back into rows.  The loop's
extent is `max_seqlen`, a host int, so no step waits on the device to
learn it.  `sequence_to_dense` and `dense_to_sequence` are the
DynamicRNN's bridge between ragged values and the time-major padded
tensors of the `recurrent` engine (ops/control_flow.py).  Every grad is
the generic vjp (ops/registry.py).  The other sequence ops and gru wait
with ROADMAP A7.
"""

import torch

from ..core.ragged import RaggedTensor
from .amp_util import amp_result, mxu_operands
from .registry import register_op

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
        s = torch.zeros((B + 1,) + tuple(v.shape[1:]), dtype=v.dtype,
                        device=v.device).index_add(
            0, seg_s, torch.where(vmask, v, torch.zeros((), dtype=v.dtype,
                                                        device=v.device)))
        s = s[:B]
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
    past it take a clipped copy, which the masks ignore)."""
    T = padded.shape[1]
    t = torch.arange(T, dtype=lens.dtype, device=lens.device)
    rev = (lens[:, None] - 1 - t[None, :]).clamp(0, T - 1).long()
    return torch.gather(padded, 1, _lead_mask(rev, padded).expand(
        padded.shape))


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
