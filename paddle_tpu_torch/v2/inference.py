"""v2 inference (reference: python/paddle/v2/inference.py — infer() runs
the topology forward over input samples; for a beam_search output layer
it runs RecurrentGradientMachine-style sequence generation).

The port's counterpart of paddle_tpu/v2/inference.py, on the v2 place:
the forward runs through the port's `serving.InferenceEngine` over the
program pruned to the output layers; generation runs the pruned program
for the memories' boots and the static inputs, then `run_beam_search`
(v2/recurrent.py) on the same place."""

import numpy as np

from .. import fluid
from ..fluid import framework
from . import layer as v2_layer
from .config import _place

__all__ = ["infer", "Inference"]


class Inference:
    def __init__(self, output_layer, parameters=None,
                 batch_buckets=None):
        self._outputs = (output_layer if isinstance(output_layer,
                                                    (list, tuple))
                         else [output_layer])
        self._beam_spec = getattr(self._outputs[0], "_v2_beam_spec", None)
        from ..fluid import io as fluid_io

        self._source = framework.default_main_program()
        self._place = _place()
        if self._beam_spec is not None:
            # prerequisites of the decode loop: memory boots + statics
            spec = self._beam_spec
            self._pre_fetch = [m["boot"] for m in spec.mems
                               if m["boot"] is not None]
            self._pre_fetch += list(spec.statics)
            self._program = fluid_io.prune_program(
                self._source, self._pre_fetch) if self._pre_fetch \
                else None
        else:
            self._program = fluid_io.prune_program(self._source,
                                                   self._outputs)

        # feed slots the pruned program actually consumes
        used = set()
        if self._program is not None:
            for op in self._program.global_block().desc.ops:
                for ns in op.inputs.values():
                    used.update(ns)
        self._used_inputs = used
        self._exe = fluid.Executor(self._place)
        # the non-beam forward path runs through the serving engine
        # (one code path for offline infer() and the online server);
        # batch_buckets=None keeps exact-shape offline semantics,
        # passing buckets pads batches to them
        self._batch_buckets = batch_buckets
        self._engines = {}  # frozenset(feed names) -> InferenceEngine
        # the last generation's loop: {"steps": steps run}
        self.last_stats = {}

    def _engine_for(self, feeds):
        """Lazily wrap the pruned program in a serving engine keyed on
        the actual feed slots (known only once `feeding` arrives).
        One engine per feed-name set."""
        from ..serving.engine import InferenceEngine, EngineConfig

        key = frozenset(feeds)
        engine = self._engines.get(key)
        if engine is None:
            engine = self._engines[key] = InferenceEngine(
                self._program, sorted(feeds),
                [o.name for o in self._outputs], place=self._place,
                config=EngineConfig(batch_buckets=self._batch_buckets))
        return engine

    def _feed(self, input, feeding):
        data_layers = [
            d for d in v2_layer.data_layers_for_feeding(
                feeding, self._source)
            if d.name in self._used_inputs]
        width = len(input[0])
        if len(data_layers) != width:
            raise ValueError(
                "inference needs %d feed slots (%s) but input tuples "
                "have %d fields"
                % (len(data_layers), [d.name for d in data_layers],
                   width))
        feeder = fluid.DataFeeder(feed_list=data_layers, place=self._place)
        return feeder.feed(input)

    def iter_infer_field(self, input, feeding=None, batch_size=None,
                         field="value"):
        if self._beam_spec is not None:
            return self._run_generation(input, feeding, field)
        feeds = self._feed(input, feeding)
        outs = self._engine_for(feeds).run(feeds)
        arrays = [np.asarray(getattr(o, "values", o)) for o in outs]
        fields = field if isinstance(field, (list, tuple)) else [field]
        for f in fields:
            if f not in ("value", "prob", "id"):
                raise ValueError("unknown field %r" % f)
            if f == "id" and not all(
                    np.issubdtype(a.dtype, np.integer) for a in arrays):
                raise ValueError(
                    "field='id' needs an id-producing output layer "
                    "(e.g. maxid_layer); got float outputs")
        return arrays

    def _run_generation(self, input, feeding, field):
        from .recurrent import run_beam_search

        spec = self._beam_spec
        B = len(input)
        values = {}
        if self._pre_fetch:
            outs = self._exe.run(
                self._program, feed=self._feed(input, feeding),
                fetch_list=list(self._pre_fetch), return_numpy=False)
            values = dict(zip(self._pre_fetch, outs))
        boot_values = {m["var"].name: values[m["boot"]]
                       for m in spec.mems if m["boot"] is not None}
        static_values = {n: values[n] for n in spec.statics}
        probs, ids = run_beam_search(spec, boot_values, static_values, B,
                                     self._place, stats=self.last_stats)

        fields = field if isinstance(field, (list, tuple)) else [field]
        out = []
        for f in fields:
            if f in ("prob", "value"):
                out.append(probs)
            elif f == "id":
                out.append(ids)
            else:
                raise ValueError("unknown field %r" % f)
        return out


def infer(output_layer, parameters=None, input=None, feeding=None,
          field="value", batch_buckets=None):
    results = Inference(
        output_layer, parameters,
        batch_buckets=batch_buckets).iter_infer_field(
        input, feeding=feeding, field=field)
    if isinstance(field, (list, tuple)):
        return results
    if not isinstance(output_layer, (list, tuple)):
        return results[0]
    return results
