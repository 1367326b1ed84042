"""Step-level training telemetry on top of obs.trace + obs.registry.

A copy of paddle_tpu/obs/telemetry.py's trainer half: per-step wall
time, examples/sec, steps and last loss in one labeled metric family
(the `trainer` label; the v2 SGD loop reports as "v2"), a
`<trainer>/step` span on the trace, an optional step observer, and
gauges through `set_gauge`; `snapshot`/`snapshot_delta` are what the
flight recorder's step records carry.  Of the JAX module's executor
hooks the port keeps `on_executor_run` (the `executor_runs_total`
counter); jit traces and transfer bytes have no counterpart in the
port's eager executor.

Everything funnels into the default registry (`obs.registry`).  All
helpers are cheap enough to call unconditionally: a counter inc is one
dict lookup + locked add.
"""

import time

from . import registry as registry_mod
from . import trace as trace_mod

__all__ = ["on_executor_run", "step", "set_gauge", "install_step_observer",
           "step_observer", "snapshot", "snapshot_delta",
           "snapshot_and_delta"]

# histogram bounds for step wall time: sub-ms tiny CPU steps up to
# multi-second first steps
STEP_SECONDS_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                        0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _reg():
    return registry_mod.get_registry()


def on_executor_run():
    """One Executor.run() dispatch (any program)."""
    _reg().counter("executor_runs_total",
                   "Executor.run() invocations").inc()


# ---------------------------------------------------------------------------
# trainer-side hooks
# ---------------------------------------------------------------------------

# single step observer slot (obs.perf.StepProfiler): begin_step() at
# step entry, end_step() at exit.  One None check per step when empty.
_step_observer = None


def install_step_observer(observer):
    """Register `observer` (needs begin_step(trainer) /
    end_step(trainer, dt, examples, failed=...)) on every
    `telemetry.step(...)` boundary; pass None to remove.  Returns the
    previous observer so callers can restore it."""
    global _step_observer
    prev = _step_observer
    _step_observer = observer
    return prev


def step_observer():
    return _step_observer


class _StepTimer:
    """Times one training step; on exit feeds the trainer metric
    family and leaves a `<trainer>/step` span on the trace."""

    __slots__ = ("trainer", "examples", "args", "_t0", "_obs")

    def __init__(self, trainer, examples, args):
        self.trainer = trainer
        self.examples = examples
        self.args = args

    def __enter__(self):
        # pin the observer for the step: an install/uninstall mid-step
        # must not end a step that was never begun (or vice versa)
        self._obs = _step_observer
        if self._obs is not None:
            self._obs.begin_step(self.trainer)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t0 = self._t0
        dt = time.perf_counter() - t0
        trace_mod.emit_span(self.trainer + "/step", t0, dt,
                            cat="trainer", args=self.args)
        if self._obs is not None:
            self._obs.end_step(self.trainer, dt, self.examples,
                               failed=exc_type is not None)
        if exc_type is not None:
            return False
        reg = _reg()
        reg.counter("trainer_steps_total", "completed train steps",
                    labelnames=("trainer",)) \
           .labels(trainer=self.trainer).inc()
        reg.histogram("trainer_step_seconds", STEP_SECONDS_BUCKETS,
                      "train step wall time",
                      labelnames=("trainer",)) \
           .labels(trainer=self.trainer).observe(dt)
        if self.examples:
            reg.counter("trainer_examples_total",
                        "examples consumed by train steps",
                        labelnames=("trainer",)) \
               .labels(trainer=self.trainer).inc(self.examples)
            if dt > 0:
                reg.gauge("trainer_examples_per_sec",
                          "throughput of the most recent step",
                          labelnames=("trainer",)) \
                   .labels(trainer=self.trainer) \
                   .set(self.examples / dt)
        return False


def step(trainer, examples=None, **args):
    """`with telemetry.step("v2", examples=len(batch)): run_step()` —
    times the step, feeds the trainer metrics, emits a span."""
    return _StepTimer(trainer, examples, args or None)


def set_gauge(name, value, **labels):
    """Set a named gauge (loss, loss scale, grad norm, ...).  Labeled
    when label kwargs are given."""
    reg = _reg()
    if labels:
        g = reg.gauge(name, labelnames=tuple(sorted(labels)))
        g.labels(**labels).set(value)
    else:
        reg.gauge(name).set(value)


def _flat_samples():
    """One (key, sample) pair per registry sample, with the
    `name{k=v,...}` key convention shared by snapshot/snapshot_delta
    (kept in ONE place so the two views can't drift apart)."""
    for s in _reg().to_dict()["metrics"]:
        key = s["name"]
        labels = s.get("labels")
        if labels:
            key += "{%s}" % ",".join(
                "%s=%s" % (k, v) for k, v in sorted(labels.items()))
        yield key, s


def snapshot():
    """Flat {metric_name or name{labels}: value} view of the default
    registry (histograms contribute _count/_sum) — for embedding
    registry state into artifacts or asserting on it in tests."""
    return snapshot_and_delta({})[0]


def snapshot_and_delta(before):
    """(snapshot(), snapshot_delta(before)) from ONE registry walk —
    for per-step callers that need both the new baseline and the
    movement and shouldn't serialize the registry twice per step."""
    snap, delta = {}, {}
    for key, s in _flat_samples():
        if s["type"] == "histogram":
            cnt, tot = s["count"], round(s["sum"], 6)
            snap[key + "_count"] = cnt
            snap[key + "_sum"] = tot
            if cnt != before.get(key + "_count", 0):
                delta[key + "_count"] = cnt - before.get(key + "_count",
                                                         0)
                delta[key + "_sum"] = round(
                    tot - before.get(key + "_sum", 0), 6)
        elif s["type"] == "counter":
            snap[key] = s["value"]
            if s["value"] != before.get(key, 0):
                delta[key] = s["value"] - before.get(key, 0)
        else:
            snap[key] = s["value"]
            if s["value"] != before.get(key):
                delta[key] = s["value"]
    return snap, delta


def snapshot_delta(before):
    """The registry's movement since `before` (a `snapshot()` result):
    counters and histogram _count/_sum report the INCREMENT over the
    window, gauges their current value; keys that didn't move are
    dropped.  This is the honest per-window attribution — a cumulative
    snapshot stamped onto one window would claim every previous
    window's counters as its own."""
    return snapshot_and_delta(before)[1]
