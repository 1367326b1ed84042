"""v2 evaluator DSL (reference: trainer_config_helpers/evaluators.py —
17 `*_evaluator` functions attaching metrics/printers to the topology,
over gserver/evaluators/Evaluator.cpp, CTCErrorEvaluator.cpp,
DetectionMAPEvaluator.cpp).

The port's counterpart of paddle_tpu/v2/evaluator.py.  Each function
appends the metric ops to the default program and returns the metric
Variable(s); fetch them alongside the cost (the reference prints them
per batch/pass from inside the trainer — here they are fetchable
outputs, and the printer evaluators wrap the print op).  The evaluator
whose op the port does not register yet (`detection_map`) raises
NotImplementedError naming ROADMAP A10."""

from ..fluid import layers as fl
from ..fluid.layer_helper import LayerHelper
from .recurrent import register_layer_output

__all__ = [
    "classification_error_evaluator", "auc_evaluator",
    "precision_recall_evaluator", "chunk_evaluator",
    "ctc_error_evaluator", "detection_map_evaluator",
    "pnpair_evaluator", "sum_evaluator", "column_sum_evaluator",
    "value_printer_evaluator", "gradient_printer_evaluator",
    "maxid_printer_evaluator", "maxframe_printer_evaluator",
    "seqtext_printer_evaluator", "classification_error_printer_evaluator",
]


# the metric ops the port does not register yet (ROADMAP A10)
_WAITING_OPS = ("detection_map",)


def _metric_op(op_type, inputs, attrs, out_slots, dtypes=None,
               lod_levels=None, name=None):
    if op_type in _WAITING_OPS:
        raise NotImplementedError(
            "the %s evaluator needs the op type %s, which the port does "
            "not register yet (ROADMAP A10)" % (op_type, op_type))
    helper = LayerHelper(op_type)
    outs = []
    for i, slot in enumerate(out_slots):
        outs.append(helper.create_tmp_variable(
            (dtypes or ["float32"] * len(out_slots))[i],
            stop_gradient=True,
            lod_level=(lod_levels or [0] * len(out_slots))[i]))
    helper.append_op(type=op_type, inputs=inputs,
                     outputs={s: [o] for s, o in zip(out_slots, outs)},
                     attrs=attrs or {})
    if name:
        register_layer_output(name, outs[0])
    return outs[0] if len(outs) == 1 else outs


def classification_error_evaluator(input, label, name=None, top_k=1,
                                   **kw):
    """Error rate = 1 - accuracy (reference: evaluators.py
    classification_error_evaluator over ClassificationErrorEvaluator)."""
    acc = fl.accuracy(input=input, label=label, k=top_k)
    one = fl.fill_constant(shape=[1], dtype="float32", value=1.0)
    return register_layer_output(name, fl.elementwise_sub(x=one, y=acc))


def auc_evaluator(input, label, name=None, **kw):
    return _metric_op("auc", {"Out": [input], "Indices": [input],
                              "Label": [label]}, {}, ["AUC"], name=name)


def precision_recall_evaluator(input, label, positive_label=None,
                               name=None, **kw):
    """[macro P, R, F1, micro P, R, F1]; with `positive_label`, the
    binary [P, R, F1] for that class (reference: evaluators.py
    precision_recall_evaluator over PrecisionRecallEvaluator)."""
    cls = int(input.shape[-1])
    _, idx = fl.topk(input=input, k=1)
    if positive_label is not None:
        # binary stats for one class: tp / predicted-pos / actual-pos
        pos = fl.fill_constant(shape=[1], dtype="int64",
                               value=int(positive_label))
        pred_pos = fl.cast(fl.equal(x=idx, y=pos), dtype="float32")
        lab_pos = fl.cast(fl.equal(x=label, y=pos), dtype="float32")
        tp = fl.reduce_sum(input=fl.elementwise_mul(x=pred_pos,
                                                    y=lab_pos),
                           dim=None, keep_dim=False)
        eps = fl.fill_constant(shape=[1], dtype="float32", value=1e-6)
        npred = fl.elementwise_max(
            x=fl.reduce_sum(input=pred_pos, dim=None, keep_dim=False),
            y=eps)
        nlab = fl.elementwise_max(
            x=fl.reduce_sum(input=lab_pos, dim=None, keep_dim=False),
            y=eps)
        precision = fl.elementwise_div(x=tp, y=npred)
        recall = fl.elementwise_div(x=tp, y=nlab)
        two_pr = fl.scale(x=fl.elementwise_mul(x=precision, y=recall),
                          scale=2.0)
        f1 = fl.elementwise_div(
            x=two_pr,
            y=fl.elementwise_max(x=fl.elementwise_add(x=precision,
                                                      y=recall), y=eps))
        out = fl.concat(input=[precision, recall, f1], axis=0)
        return register_layer_output(name, out)
    outs = _metric_op(
        "precision_recall",
        {"MaxProbs": [input], "Indices": [idx], "Labels": [label]},
        {"class_number": cls},
        ["BatchMetrics", "AccumMetrics", "AccumStatesInfo"])
    return register_layer_output(name, outs[0])


def chunk_evaluator(input, label, chunk_scheme="IOB", num_chunk_types=1,
                    excluded_chunk_types=None, name=None, **kw):
    precision, recall, f1, _, _, _ = fl.chunk_eval(
        input=input, label=label, chunk_scheme=chunk_scheme,
        num_chunk_types=num_chunk_types,
        excluded_chunk_types=excluded_chunk_types)
    register_layer_output(name, f1)
    return precision, recall, f1


def ctc_error_evaluator(input, label, name=None, **kw):
    """Per-sequence edit distance of CTC decodes vs references
    (reference: evaluators.py ctc_error_evaluator over
    CTCErrorEvaluator.cpp)."""
    dist, _ = fl.edit_distance(input=input, label=label)
    return register_layer_output(name, fl.mean(x=dist))


def detection_map_evaluator(input, label, overlap_threshold=0.5,
                            background_id=0, ap_type="11point",
                            evaluate_difficult=False, name=None, **kw):
    """Batch mAP of detection output vs ground truth (reference:
    evaluators.py detection_map_evaluator over
    DetectionMAPEvaluator.cpp)."""
    return _metric_op(
        "detection_map", {"DetectRes": [input], "Label": [label]},
        {"overlap_threshold": float(overlap_threshold),
         "background_label_id": int(background_id),
         "ap_type": ap_type,
         "evaluate_difficult": bool(evaluate_difficult)},
        ["MAP"], name=name)


def pnpair_evaluator(input, label, query_id, weight=None, name=None,
                     **kw):
    """Positive-negative pair ratio per query (reference: evaluators.py
    pnpair_evaluator over PnpairEvaluator)."""
    inputs = {"Score": [input], "Label": [label], "QueryID": [query_id]}
    if weight is not None:
        inputs["Weight"] = [weight]
    return _metric_op("positive_negative_pair", inputs, {},
                      ["PositivePair", "NegativePair", "NeutralPair"],
                      name=name)


def sum_evaluator(input, name=None, **kw):
    return register_layer_output(
        name, fl.reduce_sum(input=input, dim=None, keep_dim=False))


def column_sum_evaluator(input, name=None, **kw):
    return register_layer_output(
        name, fl.reduce_sum(input=input, dim=0, keep_dim=False))


# -- printer evaluators (reference: the *_printer_evaluator family all
#    reduce to "print this tensor during execution") --------------------

def value_printer_evaluator(input, name=None, **kw):
    return fl.Print(input, message=name or "value")


def gradient_printer_evaluator(input, name=None, **kw):
    return fl.Print(input, message=name or "gradient",
                    print_phase="backward")


def maxid_printer_evaluator(input, name=None, **kw):
    _, idx = fl.topk(input=input, k=1)
    return fl.Print(idx, message=name or "maxid")


def maxframe_printer_evaluator(input, name=None, **kw):
    mx = fl.reduce_max(input=input, dim=-1, keep_dim=True)
    return fl.Print(mx, message=name or "maxframe")


def seqtext_printer_evaluator(input, result_file=None, name=None, **kw):
    return fl.Print(input, message=name or "seqtext")


def classification_error_printer_evaluator(input, label, name=None, **kw):
    err = classification_error_evaluator(input, label)
    return fl.Print(err, message=name or "classification_error")
