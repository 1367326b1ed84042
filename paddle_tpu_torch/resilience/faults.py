"""Seeded, deterministic fault injection behind named points.

Counterpart of paddle_tpu/resilience/faults.py, with its five fault
kinds:

    io_error      raise `InjectedIOError` (an IOError, so retry policies
                  treat it as transient)
    latency       sleep `latency_s`, then continue
    preempt       deliver a real signal (SIGTERM by default) to the
                  process: the supervisor's preemption hook sees what a
                  preemptible pool's reclaim sends
    nonfinite     no effect here; `check` returns the fired spec and the
                  caller simulates the blowup (the supervisor takes the
                  step's loss as NaN)
    lease_expiry  no effect here either; the coordinator's heartbeat
                  sees the fired spec and stalls past the lease's TTL,
                  so the master really reclaims the slot

A plan is an ordered list of `FaultSpec`s, each bound to one named
point, firing on exact call counts (`after`, `times`) or, with
`probability`, on the draws of the plan's seeded `random.Random`: one
seed fires the same calls as the JAX package's plan.  Instrumented code
calls `faults.check("point")`, one None check when no plan is enabled.
Every fired fault counts into `faults_injected_total{point,kind}`,
emits a `fault_injected` trace instant and, while a flight recorder is
installed, leaves a note in its bundle.  Points in the port:

    executor/run         fluid/executor.py  Executor.run dispatch
    checkpoint/write     fluid/checkpoint.py  snapshot write attempt
    checkpoint/manifest  fluid/checkpoint.py  after a snapshot's files,
                         before its manifest (a fault here tears it)
    reader/pump          reader/prefetch.py  one pumped item
    dataset/download     dataset/common.py  one download attempt
    coordinator/register distributed/coordinator.py  register RPC
    coordinator/heartbeat  ..  one keep-alive RPC
    coordinator/discover   ..  one list_prefix RPC
    serving/run          serving/engine.py  one engine request
    supervisor/step      resilience/supervisor.py  one supervised step
"""

import random
import signal as signal_mod
import threading
import time

from ..obs import registry as registry_mod
from ..obs import trace as trace_mod

__all__ = ["FaultSpec", "FaultPlan", "InjectedIOError", "enable",
           "disable", "active", "get_plan", "inject", "check",
           "fired_counts"]

KINDS = ("io_error", "latency", "preempt", "nonfinite",
         "lease_expiry")


class InjectedIOError(IOError):
    """A deliberately injected transient I/O failure."""


class FaultSpec:
    """One planned fault at one point.

    after:       skip the first `after` matching calls (0: eligible at
                 once).
    times:       fire at most this many times (None: unbounded).
    probability: when set, each eligible call fires with this
                 probability, drawn from the plan's seeded stream,
                 instead of firing deterministically.
    latency_s:   the sleep of a `latency` fault.
    signum:      the signal a `preempt` fault delivers.
    """

    def __init__(self, point, kind="io_error", after=0, times=1,
                 probability=None, latency_s=0.05,
                 signum=signal_mod.SIGTERM, message=None):
        if kind not in KINDS:
            raise ValueError("unknown fault kind %r (one of %s)"
                             % (kind, ", ".join(KINDS)))
        self.point = str(point)
        self.kind = kind
        self.after = int(after)
        self.times = None if times is None else int(times)
        self.probability = probability
        self.latency_s = float(latency_s)
        self.signum = signum
        self.message = message or (
            "injected %s fault at %r" % (kind, point))
        self.calls = 0   # matching calls seen
        self.fired = 0   # times actually fired

    def _should_fire(self, rng):
        self.calls += 1
        if self.times is not None and self.fired >= self.times:
            return False
        if self.calls <= self.after:
            return False
        if self.probability is not None:
            return rng.random() < self.probability
        return True

    def __repr__(self):
        return ("FaultSpec(point=%r, kind=%r, after=%d, times=%r, "
                "fired=%d)" % (self.point, self.kind, self.after,
                               self.times, self.fired))


class FaultPlan:
    """FaultSpecs sharing one seeded random stream, evaluated under one
    lock, so a plan replays identically per point whatever the threads'
    interleaving."""

    def __init__(self, seed=0):
        self.seed = seed
        self._rng = random.Random(seed)
        self._specs = []
        self._lock = threading.Lock()

    def inject(self, point, kind="io_error", **kw):
        """Add a FaultSpec; returns it (its `.fired` count is live)."""
        spec = FaultSpec(point, kind, **kw)
        with self._lock:
            self._specs.append(spec)
        return spec

    def specs(self, point=None):
        """The plan's specs (at `point`, when given)."""
        with self._lock:
            return [s for s in self._specs
                    if point is None or s.point == point]

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
        an io_error, sleep for a latency fault, deliver the signal of a
        preempt fault; returns the fired spec (the kinds that do not
        raise) or None.  `context` names what the point was doing."""
        fired = None
        with self._lock:
            for spec in self._specs:
                if spec.point == point and spec._should_fire(self._rng):
                    spec.fired += 1
                    fired = spec
                    break
        if fired is None:
            return None
        self._record(fired, context)
        if fired.kind == "io_error":
            raise InjectedIOError(fired.message)
        if fired.kind == "latency":
            time.sleep(fired.latency_s)
        elif fired.kind == "preempt":
            # a real signal, as a preemptible pool's reclaim sends: the
            # Python-level handler (the supervisor's hook) runs in the
            # main thread at the next bytecode boundary
            signal_mod.raise_signal(fired.signum)
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


def active():
    return _plan is not None


def get_plan():
    return _plan


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
