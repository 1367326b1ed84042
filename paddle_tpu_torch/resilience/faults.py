"""Seeded, deterministic fault injection behind named points.

Counterpart of paddle_tpu/resilience/faults.py, with two of its fault
kinds:

    io_error   raise `InjectedIOError` (an IOError, so retry policies
               treat it as transient)
    latency    sleep `latency_s`, then continue

The JAX side's `preempt`, `nonfinite` and `lease_expiry` kinds and its
seeded probabilities wait with their points (ROADMAP A10).  A plan is
an ordered list of `FaultSpec`s, each bound to one named point and
firing on exact call counts (`after`, `times`).  Instrumented code
calls `faults.check("point")`, one None check when no plan is enabled.
Every fired fault counts into `faults_injected_total{point,kind}`,
emits a `fault_injected` trace instant and, while a flight recorder is
installed, leaves a note in its bundle.  Points in the port:

    checkpoint/write     fluid/checkpoint.py  snapshot write attempt
    checkpoint/manifest  fluid/checkpoint.py  after a snapshot's files,
                         before its manifest (a fault here tears it)
    reader/pump          reader/prefetch.py  one pumped item
    dataset/download     dataset/common.py  one download attempt
    coordinator/register distributed/coordinator.py  register RPC
    coordinator/heartbeat  ..  one keep-alive RPC
    coordinator/discover   ..  one list_prefix RPC
    serving/run          serving/engine.py  one engine request
"""

import threading
import time

from ..obs import registry as registry_mod
from ..obs import trace as trace_mod

__all__ = ["FaultSpec", "FaultPlan", "InjectedIOError", "enable",
           "disable", "inject", "check", "fired_counts"]

KINDS = ("io_error", "latency")


class InjectedIOError(IOError):
    """A deliberately injected transient I/O failure."""


class FaultSpec:
    """One planned fault at one point: skip the first `after` matching
    calls, then fire at most `times` times (None: unbounded); a
    `latency` fault sleeps `latency_s` seconds."""

    def __init__(self, point, kind="io_error", after=0, times=1,
                 latency_s=0.05):
        if kind not in KINDS:
            raise ValueError("unknown fault kind %r (the port injects %s)"
                             % (kind, " and ".join(KINDS)))
        self.point = str(point)
        self.kind = kind
        self.after = int(after)
        self.times = None if times is None else int(times)
        self.latency_s = float(latency_s)
        self.calls = 0   # matching calls seen
        self.fired = 0   # times actually fired

    def _should_fire(self):
        self.calls += 1
        if self.times is not None and self.fired >= self.times:
            return False
        return self.calls > self.after

    def __repr__(self):
        return ("FaultSpec(point=%r, kind=%r, after=%d, times=%r, "
                "fired=%d)" % (self.point, self.kind, self.after,
                               self.times, self.fired))


class FaultPlan:
    """FaultSpecs evaluated under one lock, so a plan replays identically
    per point whatever the threads' interleaving.  `seed` is kept for
    the JAX side's signature; the port's plans draw nothing."""

    def __init__(self, seed=0):
        self.seed = seed
        self._specs = []
        self._lock = threading.Lock()

    def inject(self, point, kind="io_error", **kw):
        """Add a FaultSpec; returns it (its `.fired` count is live)."""
        spec = FaultSpec(point, kind, **kw)
        with self._lock:
            self._specs.append(spec)
        return spec

    def fired_counts(self):
        """{(point, kind): fired} over the whole plan."""
        out = {}
        with self._lock:
            for s in self._specs:
                out[(s.point, s.kind)] = out.get((s.point, s.kind), 0) \
                    + s.fired
        return out

    def check(self, point, **context):
        """Evaluate `point` against the plan: raise InjectedIOError for
        an io_error, sleep for a latency fault; returns the fired spec
        or None.  `context` names what the point was doing."""
        fired = None
        with self._lock:
            for spec in self._specs:
                if spec.point == point and spec._should_fire():
                    spec.fired += 1
                    fired = spec
                    break
        if fired is None:
            return None
        self._record(fired, context)
        if fired.kind == "io_error":
            raise InjectedIOError("injected io_error fault at %r" % point)
        time.sleep(fired.latency_s)
        return fired

    @staticmethod
    def _record(spec, context):
        registry_mod.get_registry().counter(
            "faults_injected_total",
            "deliberately injected faults, by point and kind",
            labelnames=("point", "kind")) \
            .labels(point=spec.point, kind=spec.kind).inc()
        trace_mod.instant("fault_injected", cat="fault",
                          point=spec.point, kind=spec.kind,
                          **{k: str(v) for k, v in context.items()})
        from ..obs import flight as flight_mod

        rec = flight_mod.get_recorder()
        if rec is not None:
            rec.note("faults", point=spec.point, kind=spec.kind,
                     fired=spec.fired)


_plan = None


def enable(seed=0):
    """Activate a fresh process-wide FaultPlan; returns it."""
    global _plan
    _plan = FaultPlan(seed=seed)
    return _plan


def disable():
    """Deactivate fault injection; returns the old plan (or None)."""
    global _plan
    plan, _plan = _plan, None
    return plan


def inject(point, kind="io_error", **kw):
    """Add a fault to the active plan (enable() first)."""
    if _plan is None:
        raise RuntimeError("no fault plan active; call faults.enable()")
    return _plan.inject(point, kind, **kw)


def check(point, **context):
    """The instrumentation hook: one None check when no plan is active,
    else the active plan evaluated at `point`."""
    plan = _plan
    if plan is None:
        return None
    return plan.check(point, **context)


def fired_counts():
    """{(point, kind): fired} for the active plan ({} when off)."""
    plan = _plan
    return plan.fired_counts() if plan is not None else {}
