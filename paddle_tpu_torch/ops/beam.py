"""The beam-search ops of a generation program: `beam_search` and
`beam_search_decode`.

Counterpart of paddle_tpu/ops/beam.py (reference: beam_search_op.cc —
per-source top-k over candidate (prefix, token) pairs with end-id
pruning; beam_search_decode_op.cc — the per-step selections traced back
into hypotheses).  Both are host bookkeeping, as in the reference (CPU
kernels only) and on the JAX side: each reads its inputs back to the
host, builds its outputs with numpy in the JAX op's order, and hands
them to the inputs' device.  The fast beam decode over a dense
[batch, beam] state is models/decode.py; the v2 API's generation loop
keeps its top-k on the card (v2/recurrent.py).

Splits (reference beam_search_op.h:46-63): the selected ids and scores
are [M, 1] with two levels: level 0 the sources over beam rows, level 1
one segment per input beam row (its surviving items).
"""

import numpy as np
import torch

from ..core.ragged import RaggedTensor
from .registry import register_op, values_of


def _host(v):
    return values_of(v).detach().cpu().numpy()


def _splits(rt, level):
    return rt.row_splits[level].cpu().numpy().astype(np.int64)


def _ragged(arr, splits, dtype, device):
    return RaggedTensor(torch.from_numpy(arr.astype(dtype)).to(device),
                        [torch.from_numpy(s.astype(np.int32)).to(device)
                         for s in splits])


@register_op("beam_search", stop_gradient_op=True,
             nondiff_inputs=("pre_ids", "ids", "scores"))
def beam_search(ctx, ins, attrs):
    """The `beam_size` best (row, candidate) items of each source by
    score (ties in the order the items are listed), less the rows whose
    prefix already ended in `end_id`; each row's survivors by id."""
    pre_ids_t, ids_t, scores_t = (ins[k][0] for k in ("pre_ids", "ids",
                                                      "scores"))
    level = int(attrs.get("level", 0))
    beam_size = int(attrs["beam_size"])
    end_id = int(attrs.get("end_id", 0))
    device = values_of(scores_t).device

    scores = _host(scores_t)
    n_rows = scores.shape[0]
    scores = scores.reshape(n_rows, -1)
    ids = _host(ids_t).reshape(n_rows, -1).astype(np.int64)
    pre_ids = _host(pre_ids_t).reshape(-1).astype(np.int64)
    if isinstance(scores_t, RaggedTensor):
        high = _splits(scores_t, level)
    elif isinstance(ids_t, RaggedTensor):
        high = _splits(ids_t, level)
    else:
        high = np.asarray([0, n_rows], np.int64)  # one source
    selected_per_row = [[] for _ in range(n_rows)]
    for s in range(len(high) - 1):
        items = [(r, int(ids[r, j]), float(scores[r, j]))
                 for r in range(int(high[s]), int(high[s + 1]))
                 for j in range(ids.shape[1])]
        items.sort(key=lambda it: -it[2])
        for r, tok, sc in items[:beam_size]:
            selected_per_row[r].append((tok, sc))
    for r in range(min(n_rows, len(pre_ids))):
        if pre_ids[r] == end_id:
            selected_per_row[r] = []

    out_ids, out_scores, low = [], [], [0]
    for r in range(n_rows):
        for tok, sc in sorted(selected_per_row[r], key=lambda it: it[0]):
            out_ids.append(tok)
            out_scores.append(sc)
        low.append(len(out_ids))
    splits = [high, np.asarray(low, np.int64)]
    sel_ids = np.asarray(out_ids, np.int64).reshape(-1, 1)
    sel_scores = np.asarray(out_scores, np.float32).reshape(-1, 1)
    return {"selected_ids": [_ragged(sel_ids, splits, np.int32, device)],
            "selected_scores": [_ragged(sel_scores, splits, np.float32,
                                        device)]}


@register_op("beam_search_decode", stop_gradient_op=True,
             nondiff_inputs=("Ids", "Scores"))
def beam_search_decode(ctx, ins, attrs):
    """Ids and Scores: the per-step selected ids and scores (lists of
    the RaggedTensors `beam_search` gives, or one list in a slot).  Each
    item no later step descends from ends a hypothesis, traced back to
    its root; SentenceIds and SentenceScores are [Ntok, 1] with the
    splits source -> hypothesis -> tokens (reference
    beam_search_decode_op.h PackAllSteps)."""
    steps_ids, steps_scores = ins["Ids"], ins["Scores"]
    if len(steps_ids) == 1 and isinstance(steps_ids[0], (list, tuple)):
        steps_ids, steps_scores = list(steps_ids[0]), list(steps_scores[0])
    n_steps = len(steps_ids)
    if n_steps == 0:
        raise ValueError("beam_search_decode needs at least one step")
    device = values_of(steps_ids[0]).device
    ids_np = [_host(t).reshape(-1) for t in steps_ids]
    scores_np = [_host(t).reshape(-1) for t in steps_scores]
    lod0 = [_splits(t, 0) for t in steps_ids]
    lod1 = [_splits(t, 1) for t in steps_ids]
    n_src = len(lod0[0]) - 1

    # the parent of item m at step t is the level-1 segment holding it,
    # which is its item's index at step t - 1
    parents = [np.searchsorted(lod1[t], np.arange(len(ids_np[t])),
                               side="right") - 1 for t in range(n_steps)]
    sentences = [[] for _ in range(n_src)]
    for t in range(n_steps):
        has_kid = np.zeros(len(ids_np[t]), bool)
        if t + 1 < n_steps:
            kids = parents[t + 1]
            has_kid[kids[kids < len(has_kid)]] = True
        for m in range(len(ids_np[t])):
            if has_kid[m]:
                continue
            toks, scs = [], []
            tt, mm = t, m
            while tt >= 0:
                toks.append(int(ids_np[tt][mm]))
                scs.append(float(scores_np[tt][mm]))
                mm = int(parents[tt][mm])
                tt -= 1
            src = int(np.searchsorted(lod0[t], parents[t][m],
                                      side="right") - 1)
            sentences[src].append((toks[::-1], scs[::-1]))

    out_ids, out_scores, l0, l1 = [], [], [0], [0]
    for s in range(n_src):
        for toks, scs in sentences[s]:
            out_ids.extend(toks)
            out_scores.extend(scs)
            l1.append(len(out_ids))
        l0.append(len(l1) - 1)
    splits = [np.asarray(l0, np.int64), np.asarray(l1, np.int64)]
    sent_ids = np.asarray(out_ids, np.int64).reshape(-1, 1)
    sent_scores = np.asarray(out_scores, np.float32).reshape(-1, 1)
    return {"SentenceIds": [_ragged(sent_ids, splits, np.int32, device)],
            "SentenceScores": [_ragged(sent_scores, splits, np.float32,
                                       device)]}
