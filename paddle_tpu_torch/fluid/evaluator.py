"""Streaming metrics over the batches of a run: `Accuracy`,
`ChunkEvaluator` and `EditDistance`.

Counterpart of paddle_tpu/fluid/evaluator.py (reference:
python/paddle/v2/fluid/evaluator.py; gserver/evaluators' CTC error
evaluator).  Each metric owns persistable counters that the main
program adds each batch's counts into, on the executor's device, as
part of the step (one `sum` op a counter); `reset()` and `eval()` work
on the scope from the host: zeroing a counter is a store, and the
metric is a few scalar divisions of the counters read back.  The
programs equal the JAX package's through `to_dict()`.  `DetectionMAP`
needs the `detection_map` op, which waits with ROADMAP A10.
"""

import numpy as np
import torch

from . import layers
from ..core.scope import global_scope
from ..core.types import torch_dtype
from .framework import unique_name
from .initializer import Constant
from .layer_helper import LayerHelper

__all__ = ["Accuracy", "ChunkEvaluator", "EditDistance", "DetectionMAP",
           "Evaluator"]


class Evaluator:
    """The counters a metric accumulates into; a subclass appends its
    per-batch ops when it is made and maps the counters to the metric
    in `_combine`."""

    def __init__(self, prefix, **kwargs):
        self.helper = LayerHelper(prefix, **kwargs)
        if self.helper.main_program.current_block().idx != 0:
            raise ValueError(
                "streaming metrics accumulate into top-level counters; "
                "construct the evaluator outside any sub-block")
        self.metrics = []   # per-batch metric Variables (fetchable)
        self.states = []    # accumulator Variables (persistable)

    def _counter(self, tag, dtype="int32", shape=(1,)):
        """A persistable accumulator, 0 from the startup program."""
        var = self.helper.create_variable(
            name=unique_name("%s.%s" % (self.helper.name, tag)),
            persistable=True, dtype=dtype, shape=list(shape))
        self.helper.set_variable_initializer(var, Constant(0.0))
        self.states.append(var)
        return var

    def _accumulate(self, counter, amount):
        """counter += amount, in the main program."""
        if amount.dtype != counter.dtype:
            amount = layers.cast(amount, dtype=counter.dtype)
        self.helper.append_op(type="sum", inputs={"X": [counter, amount]},
                              outputs={"Out": [counter]})

    def reset(self, executor, reset_program=None):
        """Zero every counter of the global scope, where it lives (on
        `executor`'s device if the scope has none yet); no program runs,
        `reset_program` is taken for the reference's signature."""
        scope = global_scope()
        for var in self.states:
            old = scope.get(var.name)
            device = old.device if old is not None else executor.device
            scope.set(var.name, torch.zeros(
                [int(d) for d in var.shape] or [1],
                dtype=torch_dtype(var.dtype), device=device))

    def eval(self, executor, eval_program=None):
        """The metric of the counters in the global scope."""
        scope = global_scope()
        return self._combine([scope.get(v.name).cpu().numpy()
                              for v in self.states])

    def _combine(self, reads):
        raise NotImplementedError(type(self).__name__)

    def create_state(self, suffix, dtype, shape):
        """The reference's name for a counter."""
        return self._counter(suffix, dtype=dtype, shape=shape)


def _ratio(num, den):
    return float(num) / float(den) if den else 0.0


class Accuracy(Evaluator):
    """Top-k accuracy, correct over total since the last reset."""

    def __init__(self, input, label, k=1, **kwargs):
        super().__init__("accuracy", **kwargs)
        self.correct = self._counter("correct")
        self.total = self._counter("total")
        batch_correct = self.helper.create_tmp_variable(
            dtype="int32", stop_gradient=True)
        batch_total = self.helper.create_tmp_variable(
            dtype="int32", stop_gradient=True)
        batch_acc = layers.accuracy(input=input, label=label, k=k,
                                    correct=batch_correct,
                                    total=batch_total)
        self._accumulate(self.correct, batch_correct)
        self._accumulate(self.total, batch_total)
        self.metrics.append(batch_acc)

    def _combine(self, reads):
        correct, total = (r.sum() for r in reads)
        return np.array([_ratio(correct, total)], np.float32)


class ChunkEvaluator(Evaluator):
    """Chunk-level precision, recall and F1 over `chunk_eval`'s counts."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None, **kwargs):
        super().__init__("chunk_eval", **kwargs)
        self.num_infer = self._counter("infer_chunks")
        self.num_label = self._counter("label_chunks")
        self.num_correct = self._counter("correct_chunks")
        (precision, recall, f1,
         batch_infer, batch_label, batch_correct) = layers.chunk_eval(
            input=input, label=label, chunk_scheme=chunk_scheme,
            num_chunk_types=num_chunk_types,
            excluded_chunk_types=excluded_chunk_types)
        self._accumulate(self.num_infer, batch_infer)
        self._accumulate(self.num_label, batch_label)
        self._accumulate(self.num_correct, batch_correct)
        self.metrics.extend([precision, recall, f1])

    def _combine(self, reads):
        infer, label, correct = (r.sum() for r in reads)
        precision = _ratio(correct, infer)
        recall = _ratio(correct, label)
        f1 = (2 * precision * recall / (precision + recall)
              if correct else 0.0)
        return (np.array([precision]), np.array([recall]),
                np.array([f1]))


class EditDistance(Evaluator):
    """The mean edit distance of hypotheses `input` to references
    `label` and the share of sequences that differ (reference:
    CTCErrorEvaluator.cpp)."""

    def __init__(self, input, label, ignored_tokens=None, **kwargs):
        super().__init__("edit_distance", **kwargs)
        self.total_distance = self._counter("total_distance", "float32")
        self.seq_num = self._counter("seq_num")
        self.wrong_seqs = self._counter("wrong_seqs")
        dist, batch_seqs = layers.edit_distance(
            input=input, label=label, ignored_tokens=ignored_tokens)
        batch_dist = layers.reduce_sum(input=dist, dim=0, keep_dim=False)
        # distances are >= 0, so sign(d) flags each wrong sequence
        batch_wrong = layers.reduce_sum(
            input=layers.sign(dist), dim=0, keep_dim=False)
        self._accumulate(self.total_distance, batch_dist)
        self._accumulate(self.seq_num, batch_seqs)
        self._accumulate(self.wrong_seqs, batch_wrong)
        self.metrics.append(dist)

    def _combine(self, reads):
        total, n, wrong = (r.sum() for r in reads)
        return (np.array([_ratio(total, n)]),
                np.array([_ratio(wrong, n)]))


class DetectionMAP(Evaluator):
    """Detection mean average precision: its `detection_map` op is not
    ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "fluid.evaluator.DetectionMAP needs the op type detection_map, "
            "which the port does not register yet (ROADMAP A10)")
