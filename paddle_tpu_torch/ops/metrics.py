"""Metric op kernels: `accuracy`, `auc`, `precision_recall` and
`positive_negative_pair`.

Counterpart of paddle_tpu/ops/metrics.py (reference: accuracy_op.cc,
auc_op.cc, precision_recall_op.cc, positive_negative_pair_op.h).
Ragged (LoD) inputs to `accuracy` count their valid rows only, as on
the JAX side; the others read a ragged input's values.  `auc`
thresholds at the f32 values `jnp.linspace` gives (`auc_thresholds`),
so a score equal to a threshold counts as it does on the JAX side.
"""

import numpy as np
import torch

from ..core.ragged import RaggedTensor
from .registry import dense, keep_declared, register_op


@register_op("accuracy", stop_gradient_op=True,
             nondiff_inputs=("Out", "Indices", "Label"))
def accuracy(ctx, ins, attrs):
    """The share of rows whose label is among their top-k `Indices`
    ([N, k]; Label [N, 1]): Accuracy f32 [1], Correct and Total int32
    [1] (reference accuracy_op.h AccuracyKernel).  Where Indices or
    Label is ragged, the rows past its `nvalid` (padding to a bucket)
    count neither as hits nor in the total."""
    ind_in, lab_in = ins["Indices"][0], ins["Label"][0]
    indices, label = [
        (v.values if isinstance(v, RaggedTensor)
         else dense(v, "accuracy")).to(torch.int32) for v in (ind_in, lab_in)]
    hit = (indices == label.reshape(-1, 1)).any(dim=1)
    ragged = next((v for v in (ind_in, lab_in)
                   if isinstance(v, RaggedTensor)), None)
    if ragged is not None:
        hit = hit & ragged.valid_mask()
        num = ragged.nvalid.to(torch.int32).reshape(1)
        correct = hit.sum(dtype=torch.int32).reshape(1)
        acc = correct.to(torch.float32) / num.clamp(min=1).to(torch.float32)
        return {"Accuracy": [acc], "Correct": [correct], "Total": [num]}
    correct = hit.sum(dtype=torch.int32).reshape(1)
    total = indices.shape[0]
    acc = correct.to(torch.float32) / float(max(total, 1))
    return {"Accuracy": [acc],
            "Correct": [correct],
            "Total": [torch.full((1,), total, dtype=torch.int32,
                                 device=indices.device)]}


def _flat(v, op_type, dtype=None):
    x = v.values if isinstance(v, RaggedTensor) else dense(v, op_type)
    return x if dtype is None else x.to(dtype)


def auc_thresholds(n):
    """The f32 thresholds jnp.linspace(0, 1, n) gives on the JAX side:
    i times the f32 reciprocal of n - 1 (XLA turns the division by a
    constant into that product, which differs from i / (n - 1) in the
    last place for some i), then 1 exactly."""
    if n < 2:
        return np.zeros((max(n, 0),), np.float32)
    steps = np.arange(n - 1, dtype=np.float32) \
        * (np.float32(1.0) / np.float32(n - 1))
    return np.concatenate([steps, np.ones(1, np.float32)])


@register_op("auc", stop_gradient_op=True,
             nondiff_inputs=("Out", "Indices", "Label"))
def auc(ctx, ins, attrs):
    """The area under the ROC curve at `num_thresholds` thresholds
    (reference: auc_op.h): a score counts as positive where it is
    strictly above a threshold; the trapezoids over the decreasing false
    positive rate summed in f32.  The score is column 1 of a 2-column
    (or wider) Out, else Out flattened."""
    preds = _flat(ins["Out"][0], "auc")
    label = _flat(ins["Label"][0], "auc", torch.int32).reshape(-1)
    score = preds[:, 1] if preds.dim() == 2 and preds.shape[1] >= 2 \
        else preds.reshape(-1)
    ths = torch.as_tensor(auc_thresholds(int(attrs.get("num_thresholds",
                                                        200))),
                          device=score.device)
    pred_pos = score[None, :] > ths[:, None]          # [T, N]
    pos = (label == 1)[None, :]
    tp = (pred_pos & pos).sum(1).to(torch.float32)
    fp = (pred_pos & ~pos).sum(1).to(torch.float32)
    npos = pos.sum().clamp(min=1).to(torch.float32)
    nneg = (~pos).sum().clamp(min=1).to(torch.float32)
    tpr, fpr = tp / npos, fp / nneg
    val = ((tpr[:-1] + tpr[1:]) * (fpr[:-1] - fpr[1:]) / 2.0).sum()
    return {"AUC": [val.reshape(1)]}


@register_op("precision_recall", stop_gradient_op=True,
             nondiff_inputs=("MaxProbs", "Indices", "Labels", "Weights",
                             "StatesInfo"))
def precision_recall(ctx, ins, attrs):
    """Macro and micro precision, recall and F1 over `class_number`
    classes (reference: precision_recall_op.h): BatchMetrics and
    AccumMetrics [6], AccumStatesInfo [C, 4] (tp, fp, fn, 0 per class,
    plus StatesInfo where given)."""
    cls = int(attrs["class_number"])
    idx = _flat(ins["Indices"][0], "precision_recall",
                torch.int64).reshape(-1)
    labels = _flat(ins["Labels"][0], "precision_recall",
                   torch.int64).reshape(-1)
    eye = torch.eye(cls, dtype=torch.float32, device=idx.device)
    onehot_pred, onehot_lab = eye[idx], eye[labels]
    tp = (onehot_pred * onehot_lab).sum(0)
    fp = (onehot_pred * (1 - onehot_lab)).sum(0)
    fn = ((1 - onehot_pred) * onehot_lab).sum(0)
    states = torch.stack([tp, fp, fn, torch.zeros_like(tp)], dim=1)
    if ins.get("StatesInfo"):
        states = states + _flat(ins["StatesInfo"][0], "precision_recall",
                                torch.float32)
        tp, fp, fn = states[:, 0], states[:, 1], states[:, 2]
    prec = tp / (tp + fp).clamp(min=1e-6)
    rec = tp / (tp + fn).clamp(min=1e-6)
    f1 = 2 * prec * rec / (prec + rec).clamp(min=1e-6)
    macro = torch.stack([prec.mean(), rec.mean(), f1.mean()])
    tps, fps, fns = tp.sum(), fp.sum(), fn.sum()
    mprec = tps / (tps + fps).clamp(min=1e-6)
    mrec = tps / (tps + fns).clamp(min=1e-6)
    mf1 = 2 * mprec * mrec / (mprec + mrec).clamp(min=1e-6)
    metrics = torch.cat([macro, torch.stack([mprec, mrec, mf1])])
    return {"BatchMetrics": [metrics], "AccumMetrics": [metrics.clone()],
            "AccumStatesInfo": [states]}


@register_op("positive_negative_pair", stop_gradient_op=True,
             nondiff_inputs=("Score", "Label", "QueryID", "Weight",
                             "AccumulatePositivePair",
                             "AccumulateNegativePair",
                             "AccumulateNeutralPair"),
             infer_desc=keep_declared)
def positive_negative_pair(ctx, ins, attrs):
    """Per-query ranking pair statistics (reference:
    positive_negative_pair_op.h), counted on the host as on the JAX
    side: over each query's pairs of unequal labels, the weight (the
    mean of the two rows' Weight, else 1) goes to PositivePair where the
    scores order them as the labels do, to NegativePair where they order
    them the other way, and to NeutralPair where the scores tie; the
    Accumulate* inputs are added.  Each output is f32 [1] on the
    scores' device."""
    score_t = _flat(ins["Score"][0], "positive_negative_pair")
    score = score_t.detach().cpu().numpy()
    label = _flat(ins["Label"][0], "positive_negative_pair") \
        .cpu().numpy().reshape(-1)
    query = _flat(ins["QueryID"][0], "positive_negative_pair") \
        .cpu().numpy().reshape(-1)
    weight = None
    if ins.get("Weight") and ins["Weight"][0] is not None:
        weight = _flat(ins["Weight"][0], "positive_negative_pair") \
            .cpu().numpy().reshape(-1)
    column = int(attrs.get("column", 0))
    if column < 0:
        column += score.shape[1]
    s = score[:, column]
    pos = neg = neu = 0.0
    for q in np.unique(query):
        idx = np.where(query == q)[0]
        for a in range(len(idx)):
            for b in range(a + 1, len(idx)):
                i, j = idx[a], idx[b]
                if label[i] == label[j]:
                    continue
                w = ((weight[i] + weight[j]) / 2.0
                     if weight is not None else 1.0)
                if s[i] == s[j]:
                    neu += w
                elif (s[i] > s[j]) == (label[i] > label[j]):
                    pos += w
                else:
                    neg += w

    def acc(slot):
        v = ins.get(slot)
        if v and v[0] is not None:
            return float(v[0].reshape(-1)[0])
        return 0.0

    pos += acc("AccumulatePositivePair")
    neg += acc("AccumulateNegativePair")
    neu += acc("AccumulateNeutralPair")

    def out(v):
        return torch.as_tensor(np.asarray([v], np.float32),
                               device=score_t.device)

    return {"PositivePair": [out(pos)], "NegativePair": [out(neg)],
            "NeutralPair": [out(neu)]}
