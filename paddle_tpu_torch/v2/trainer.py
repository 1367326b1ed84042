"""v2 SGD trainer: the event-driven train loop over the port's executor
(reference: python/paddle/v2/trainer.py — SGD:37, train:137-215; there
it drives a GradientMachine through SWIG, here a fluid Program run op
by op on the v2 place).

The port's counterpart of paddle_tpu/v2/trainer.py.  Each step reports
through the port's `obs` copies: a `v2/step` span, the step time and
examples/s (`obs.telemetry.step`) and the `trainer_last_loss` gauge.
The JAX trainer's numerics monitor (`obs/health.py`) and crash flight
recorder (`obs/flight.py`) wait with ROADMAP A8, so this trainer has no
hook for them yet.
"""

import os

import numpy as np

from .. import fluid
from ..fluid import framework
from ..obs import telemetry as obs_tele
from . import event as v2_event
from . import layer as v2_layer
from .config import _place

__all__ = ["SGD"]


def _cost_of(outs):
    return float(np.asarray(outs[0]).reshape(-1)[0])


class SGD:
    """reference: v2/trainer.py SGD — cost topology + parameters +
    update_equation."""

    def __init__(self, cost, parameters, update_equation,
                 extra_layers=None, is_local=True):
        self._cost = cost
        self._parameters = parameters
        self._extra = extra_layers or []
        self._main_program = framework.default_main_program()

        opt = update_equation
        if hasattr(opt, "to_fluid"):
            opt = opt.to_fluid()
        self._optimizer = opt
        self._optimize_ops, self._params_grads = opt.minimize(cost)
        self._exe = fluid.Executor(_place())
        self._run_startup_for_missing(self._exe)

    @staticmethod
    def _run_startup_for_missing(exe):
        """Run only the startup ops whose outputs have no value yet, so
        weights loaded through Parameters before the trainer was made
        survive (minimize() adds optimizer state that still needs its
        init)."""
        from ..core import scope as scope_mod

        startup = framework.default_startup_program()
        scope = scope_mod.global_scope()
        pending = framework.Program()
        dst = pending.global_block()
        src = startup.global_block()
        needed = False
        for op in src.desc.ops:
            out_names = [n for ns in op.outputs.values() for n in ns]
            if all(scope.get(n) is not None for n in out_names):
                continue
            for name in out_names:
                if name not in dst.vars and name in src.vars:
                    v = src.vars[name]
                    dst.create_var(
                        name=v.name, shape=v.shape, dtype=v.dtype,
                        type=v.type, persistable=v.persistable,
                        lod_level=v.lod_level)
            dst.append_op(type=op.type, inputs=dict(op.inputs),
                          outputs=dict(op.outputs),
                          attrs=dict(op.attrs), infer_shape=False)
            needed = True
        if needed:
            exe.run(pending)

    def _feeder(self, feeding):
        return fluid.DataFeeder(
            feed_list=v2_layer.data_layers_for_feeding(
                feeding, self._main_program),
            place=_place())

    def _run_step(self, feeder, data, fetch, **span_args):
        """One forward, backward and update on `data`: the fetched
        values, the step timed and reported as `v2`."""
        feed = feeder.feed(data)
        with obs_tele.step("v2", examples=len(data), **span_args):
            outs = self._exe.run(self._main_program, feed=feed,
                                 fetch_list=fetch)
        obs_tele.set_gauge("trainer_last_loss", _cost_of(outs),
                           trainer="v2")
        return outs

    def step_runner(self, feeding=None):
        """Return `step(data) -> float cost`: one forward/backward/
        update through the executor, with the same telemetry as
        `train()` (the entry of a supervisor that owns batching and
        epochs)."""
        feeder = self._feeder(feeding)
        fetch = [self._cost] + list(self._extra)
        counter = [0]

        def step(data):
            outs = self._run_step(feeder, data, fetch, batch_id=counter[0])
            counter[0] += 1
            return _cost_of(outs)

        return step

    def train(self, reader, num_passes=1, event_handler=None,
              feeding=None, save_dir=None):
        """save_dir: when set, parameters are written to
        `save_dir/pass_NNNNN.tar` after every pass — the paddle_trainer
        `--save_dir` behavior (reference: trainer/ParamUtil.h
        saveParameters per pass), on top of the event_handler hook."""
        if event_handler is None:
            event_handler = lambda e: None  # noqa: E731
        feeder = self._feeder(feeding)
        fetch = [self._cost] + list(self._extra)
        for pass_id in range(num_passes):
            event_handler(v2_event.BeginPass(pass_id))
            for batch_id, data in enumerate(reader()):
                event_handler(v2_event.BeginIteration(pass_id, batch_id))
                outs = self._run_step(feeder, data, fetch, pass_id=pass_id,
                                      batch_id=batch_id)
                event_handler(v2_event.EndForwardBackward(pass_id,
                                                          batch_id))
                event_handler(v2_event.EndIteration(pass_id, batch_id,
                                                    _cost_of(outs)))
            if save_dir is not None:
                os.makedirs(save_dir, exist_ok=True)
                path = os.path.join(save_dir, "pass_%05d.tar" % pass_id)
                # tmp + rename: a crash mid-write must not leave a
                # truncated tar at the final name
                with open(path + ".tmp", "wb") as f:
                    self._parameters.to_tar(f)
                os.replace(path + ".tmp", path)
            event_handler(v2_event.EndPass(pass_id))

    def test(self, reader, feeding=None):
        """The cost over a reader without updating parameters
        (reference: v2/trainer.py test): the program pruned to the cost,
        so no backward or update op runs."""
        from ..fluid import io as fluid_io

        test_program = fluid_io.prune_program(self._main_program,
                                              [self._cost])
        feeder = self._feeder(feeding)
        total, n = 0.0, 0
        for data in reader():
            outs = self._exe.run(test_program, feed=feeder.feed(data),
                                 fetch_list=[self._cost])
            total += _cost_of(outs) * len(data)
            n += len(data)
        return v2_event.TestResult(cost=total / max(n, 1))
