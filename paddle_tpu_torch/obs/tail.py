"""Tail-latency capture: keep the FULL span tree, but only for the
requests worth keeping (a copy of paddle_tpu/obs/tail.py).

Medians are cheap to observe and useless to debug; the requests an
operator actually gets paged about are the p99s and the 5xxs.  Tracing
every request at production rates would blow the span buffer in
seconds, so this module keeps a bounded ring of *whole request span
trees* — admission → queue wait → batch assembly → pad → execute →
split — admitted only when the request was slow (`latency_ms >=
slow_ms`) or errored (status >= 500 / an exception), the sibling
policy to `obs.flight`'s crash ring.

    rec = tail.install(capacity=64, slow_ms=100.0)
    ...
    tail.offer(ctx, latency_ms, status)   # server does this per reply
    rec.dump("tail.json")

The serving server owns one recorder per instance (`/debug/tail`
serves its ring); the module-level install()/offer() mirror
`obs.flight` for standalone use.  Every capture increments
`tail_captured_total{reason=slow|error}` so /metrics says how hot the
tail is even between dumps.
"""

import collections
import json
import os
import threading
import time

from . import registry as registry_mod

__all__ = ["TailRecorder", "install", "uninstall", "get_recorder",
           "offer", "DUMP_KIND", "DUMP_VERSION"]

DUMP_KIND = "paddle_tpu.tail"
DUMP_VERSION = 1


class TailRecorder:
    """Bounded ring of captured request records.

    capacity: ring bound — oldest captured request evicted first.
    slow_ms:  latency threshold; None disables the slow criterion
              (only errors capture)."""

    def __init__(self, capacity=64, slow_ms=None):
        self.capacity = int(capacity)
        self.slow_ms = None if slow_ms is None else float(slow_ms)
        self._ring = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._total = 0
        self._counter = registry_mod.get_registry().counter(
            "tail_captured_total",
            "requests whose full span tree the tail recorder kept",
            labelnames=("reason",))

    def classify(self, latency_ms, status=None, error=None):
        """The capture reason for one finished request, or None (not
        tail-worthy).  Errors outrank slowness: a 500 that was also
        slow files under 'error'."""
        if error is not None or (status is not None
                                 and int(status) >= 500):
            return "error"
        if self.slow_ms is not None and latency_ms >= self.slow_ms:
            return "slow"
        return None

    def offer(self, ctx, latency_ms, status=None, error=None, **extra):
        """Capture the request's span tree if it qualifies; returns
        the capture reason or None.  `ctx` is the request's
        TraceContext — without one there is no tree to keep."""
        if ctx is None:
            return None
        reason = self.classify(latency_ms, status=status, error=error)
        if reason is None:
            return None
        rec = {"t": round(time.time(), 3),
               "reason": reason,
               "latency_ms": round(float(latency_ms), 3),
               "status": status,
               "trace_id": ctx.trace_id,
               "request_id": ctx.request_id,
               "spans": ctx.span_tree()}
        if error is not None:
            rec["error"] = "%s: %s" % (type(error).__name__, error) \
                if isinstance(error, BaseException) else str(error)
        if ctx.dropped_spans:
            rec["dropped_spans"] = ctx.dropped_spans
        if extra:
            rec["extra"] = extra
        with self._lock:
            self._ring.append(rec)
            self._total += 1
        self._counter.labels(reason=reason).inc()
        return reason

    def records(self):
        """Newest-last snapshot of the ring."""
        with self._lock:
            return list(self._ring)

    def to_dict(self):
        with self._lock:
            records = list(self._ring)
            total = self._total
        return {"kind": DUMP_KIND, "version": DUMP_VERSION,
                "created_at": time.time(), "slow_ms": self.slow_ms,
                "capacity": self.capacity, "total_captured": total,
                "evicted": max(0, total - len(records)),
                "requests": records}

    def dump(self, path):
        """Write the ring as a JSON document (atomic tmp+rename); the
        JAX package's `obs_dump --tail <path>` renders it (the same
        kind and keys).  Returns the path."""
        doc = self.to_dict()
        tmp = str(path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, str(path))
        return str(path)


# ---------------------------------------------------------------------------
# module-level default recorder (obs.flight-style)
# ---------------------------------------------------------------------------

_recorder = None


def install(capacity=64, slow_ms=None):
    """Activate a process-wide recorder (replacing any previous one);
    returns it."""
    global _recorder
    _recorder = TailRecorder(capacity=capacity, slow_ms=slow_ms)
    return _recorder


def uninstall():
    global _recorder
    rec = _recorder
    _recorder = None
    return rec


def get_recorder():
    return _recorder


def offer(ctx, latency_ms, status=None, error=None, **extra):
    """Offer to the default recorder; no-op (one None check) when none
    is installed."""
    rec = _recorder
    if rec is None:
        return None
    return rec.offer(ctx, latency_ms, status=status, error=error,
                     **extra)
