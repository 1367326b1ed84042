"""Seeded, deterministic fault injection behind named points.

Counterpart of paddle_tpu/resilience/faults.py, with the one fault kind
the port's points use, `io_error`, which raises `InjectedIOError` (an
IOError, so retry policies treat it as transient); the JAX side's other
kinds, seeded probabilities, metrics and trace hooks have no caller in
the port.  A plan is an ordered list of `FaultSpec`s, each bound to one
named point and firing on exact call counts (`after`, `times`).
Instrumented code calls `faults.check("point")`, one None check when no
plan is enabled.  Points in the port:

    checkpoint/write     fluid/checkpoint.py  snapshot write attempt
    checkpoint/manifest  fluid/checkpoint.py  after a snapshot's files,
                         before its manifest (a fault here tears it)
    reader/pump          reader/prefetch.py  one pumped item
    dataset/download     dataset/common.py  one download attempt
"""

import threading

__all__ = ["FaultSpec", "FaultPlan", "InjectedIOError", "enable",
           "disable", "inject", "check"]


class InjectedIOError(IOError):
    """A deliberately injected transient I/O failure."""


class FaultSpec:
    """One planned io_error at one point: skip the first `after`
    matching calls, then fire at most `times` times (None: unbounded)."""

    def __init__(self, point, kind="io_error", after=0, times=1):
        if kind != "io_error":
            raise ValueError("unknown fault kind %r (the port injects "
                             "io_error)" % (kind,))
        self.point = str(point)
        self.kind = kind
        self.after = int(after)
        self.times = None if times is None else int(times)
        self.calls = 0   # matching calls seen
        self.fired = 0   # times actually fired

    def _should_fire(self):
        self.calls += 1
        if self.times is not None and self.fired >= self.times:
            return False
        return self.calls > self.after

    def __repr__(self):
        return ("FaultSpec(point=%r, after=%d, times=%r, fired=%d)"
                % (self.point, self.after, self.times, self.fired))


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

    def check(self, point, **context):
        """Raise InjectedIOError when a spec of `point` fires; `context`
        names what the point was doing."""
        with self._lock:
            for spec in self._specs:
                if spec.point == point and spec._should_fire():
                    spec.fired += 1
                    raise InjectedIOError("injected io_error fault at %r"
                                          % point)


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
    if plan is not None:
        plan.check(point, **context)
