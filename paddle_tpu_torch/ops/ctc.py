"""CTC op kernels: `warpctc`, `ctc_align` (the greedy decode),
`edit_distance` and `sequence_erase`.

Counterpart of paddle_tpu/ops/ctc.py (reference: warpctc_op.cc over
libwarpctc, ctc_align_op.cc, edit_distance_op.cc, sequence_erase_op.cc).

`warpctc` is the JAX side's log-space alpha recursion over the extended
labels (blank, l1, blank, l2, ..., blank): a masked loop of the padded
time extent (`max_seqlen`, a host int) on the executor's device, each
step a `logaddexp` of the three predecessors where a step inside a
sequence's length updates alpha and a step past it keeps it.  The
log-probability of each extended label at each step is one batched
product of the log-softmax with the one-hot of the extended labels, in
which the blank repeats: its grad is a product too, which sums the
blank's columns in a fixed order, where a `torch.gather` over the
repeated index would scatter its grad with atomic adds on the card and a
step would not repeat bit for bit.  One-hot products are exact in f32
with TF32 off (the package sets it off).  The grad is the generic vjp,
as `jax.vjp` on the JAX side; `WarpCTCGrad` is zeros there and here.
`F.ctc_loss` computes the same loss and is never called here.

`ctc_align`, `edit_distance` and `sequence_erase` give outputs whose
sizes depend on the data: each reads its input to the host once and
runs the JAX side's loops there (they are eval and data-path ops, never
in a training step), giving its outputs on the input's device.
"""

import numpy as np
import torch

from ..core.ragged import RaggedTensor
from .registry import keep_declared, register_op
from .sequence import ragged_to_padded

NEG_INF = -1e30


def _shift(a, k):
    """a[:, s - k] along dim 1, NEG_INF where s < k."""
    pad = torch.full((a.shape[0], k), NEG_INF, dtype=a.dtype,
                     device=a.device)
    return torch.cat([pad, a[:, :-k]], 1)


@register_op("warpctc", nondiff_inputs=("Label",))
def warpctc(ctx, ins, attrs):
    """Loss [B, 1]: -log p(label | logits) per sequence, divided by its
    length with `norm_by_times`.  Logits: ragged [T, C]; Label: ragged
    [L, 1] ints in [0, C) other than `blank`."""
    logits, label = ins["Logits"][0], ins["Label"][0]
    blank = int(attrs.get("blank", 0))
    lg_pad, t_lens = ragged_to_padded(logits)             # [B, Tp, C]
    lb = label.with_values(label.values.reshape(-1, 1).to(torch.int64))
    lb_pad, l_lens = ragged_to_padded(lb)                 # [B, Lp, 1]
    lb_pad = lb_pad[:, :, 0]
    B, Tp, C = lg_pad.shape
    Lp = lb_pad.shape[1]
    S = 2 * Lp + 1
    dev = lg_pad.device
    logp = torch.log_softmax(lg_pad, dim=-1)

    s_idx = torch.arange(S, device=dev)
    is_lbl = (s_idx % 2) == 1
    ext = torch.where(is_lbl[None, :],
                      lb_pad[:, (s_idx // 2).clamp(max=max(Lp - 1, 0))]
                      if Lp else torch.full((B, S), blank, device=dev),
                      torch.full((), blank, dtype=torch.int64, device=dev))
    s_valid = s_idx[None, :] < (2 * l_lens[:, None] + 1)
    ext_m2 = torch.cat([torch.full((B, 2), -1, dtype=ext.dtype, device=dev),
                        ext[:, :-2]], 1)
    can_skip = is_lbl[None, :] & (ext != ext_m2)
    # [B, Tp, S]: logp of each extended label at each step
    onehot = (ext[:, :, None] == torch.arange(C, device=dev)).to(logp.dtype)
    lp_ext = torch.bmm(logp, onehot.transpose(1, 2))
    neg = torch.full((), NEG_INF, dtype=logp.dtype, device=dev)

    first = torch.where(s_idx[None, :] == 0, lp_ext[:, 0], neg)
    first = torch.where((s_idx[None, :] == 1) & (l_lens[:, None] > 0),
                        lp_ext[:, 0], first)
    alpha = torch.where(s_valid, first, neg)
    active = torch.arange(Tp, device=dev)[:, None] < t_lens[None, :]
    for t in range(1, Tp):
        merged = torch.logaddexp(
            torch.logaddexp(alpha, _shift(alpha, 1)),
            torch.where(can_skip, _shift(alpha, 2), neg))
        new = torch.where(s_valid, merged + lp_ext[:, t], neg)
        alpha = torch.where(active[t][:, None], new, alpha)

    # the last blank (2L) and the last label (2L - 1)
    ends = torch.stack([2 * l_lens, (2 * l_lens - 1).clamp(min=0)], 1)
    a_end = torch.gather(alpha, 1, ends.to(torch.int64))
    a_end2 = torch.where(l_lens > 0, a_end[:, 1], neg)
    loss = -torch.logaddexp(a_end[:, 0], a_end2)
    if attrs.get("norm_by_times", False):
        loss = loss / t_lens.clamp(min=1).to(loss.dtype)
    return {"Loss": [loss.reshape(-1, 1)],
            "WarpCTCGrad": [logits.with_values(
                torch.zeros_like(logits.values))]}


def _host_sequences(x):
    """The sequences of a ragged value's last level, as host lists."""
    splits = x.last_splits().cpu().tolist()
    vals = x.values.reshape(-1).cpu().tolist()
    return [vals[splits[i]:splits[i + 1]] for i in range(len(splits) - 1)]


def _ragged_ids(seqs, dtype, device):
    """A lod-level-1 [N, 1] ragged value of the host sequences `seqs`."""
    flat = [t for s in seqs for t in s]
    splits = np.cumsum([0] + [len(s) for s in seqs])
    return RaggedTensor(
        torch.tensor(flat, dtype=dtype, device=device).reshape(-1, 1),
        [torch.tensor(splits, dtype=torch.int32, device=device)])


@register_op("ctc_align", jittable=False, stop_gradient_op=True,
             nondiff_inputs=("Input",), infer_desc=keep_declared)
def ctc_align(ctx, ins, attrs):
    """The greedy CTC decode of each sequence of ids: repeats merged
    (with `merge_repeated`), then blanks dropped; int32."""
    x = ins["Input"][0]
    blank = int(attrs.get("blank", 0))
    merge = bool(attrs.get("merge_repeated", True))
    out = []
    for seq in _host_sequences(x):
        if merge:
            seq = [t for k, t in enumerate(seq) if k == 0 or t != seq[k - 1]]
        out.append([t for t in seq if t != blank])
    return {"Output": [_ragged_ids(out, torch.int32, x.values.device)]}


def _levenshtein(hyp, ref):
    m, n = len(hyp), len(ref)
    if m == 0 or n == 0:
        return max(m, n)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cost = 0 if hyp[i - 1] == ref[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[n]


@register_op("edit_distance", jittable=False, stop_gradient_op=True,
             nondiff_inputs=("Hyps", "Refs"), infer_desc=keep_declared)
def edit_distance(ctx, ins, attrs):
    """Out [B, 1] f32: the Levenshtein distance of each hypothesis to its
    reference, the `ignored_tokens` dropped first, over the reference's
    length with `normalized`; SequenceNum [1] int32: B."""
    hyps, refs = ins["Hyps"][0], ins["Refs"][0]
    ignored = set(attrs.get("ignored_tokens") or [])
    dists = []
    for h, r in zip(_host_sequences(hyps), _host_sequences(refs)):
        h = [t for t in h if t not in ignored]
        r = [t for t in r if t not in ignored]
        d = _levenshtein(h, r)
        dists.append(d / max(len(r), 1) if attrs.get("normalized", False)
                     else d)
    dev = hyps.values.device
    return {"Out": [torch.tensor(dists, dtype=torch.float32,
                                 device=dev).reshape(-1, 1)],
            "SequenceNum": [torch.tensor([len(dists)], dtype=torch.int32,
                                         device=dev)]}


@register_op("sequence_erase", jittable=False, stop_gradient_op=True,
             nondiff_inputs=("X",), infer_desc=keep_declared)
def sequence_erase(ctx, ins, attrs):
    """Each sequence with the `tokens` removed, in X's dtype."""
    x = ins["X"][0]
    tokens = set(attrs.get("tokens") or [])
    out = [[t for t in s if t not in tokens] for s in _host_sequences(x)]
    return {"Out": [_ragged_ids(out, x.values.dtype, x.values.device)]}
