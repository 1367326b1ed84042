"""Span tracer (a copy of paddle_tpu/obs/trace.py): nested, thread-safe, exportable as Chrome trace-event
JSON (the `{"traceEvents": [...]}` format Perfetto and chrome://tracing
load directly).

Spans are recorded as complete ("X") events — begin timestamp plus
duration — which Perfetto nests by containment per thread track, so
plain `with span(...)` nesting in python shows up as a flame graph
without begin/end pairing bookkeeping.  Instant ("i") events mark
moments rather than ranges.

Concurrency model: one global event list behind a lock, appended to
only at span *exit* (one append per span), with per-thread track ids
and thread-name metadata emitted lazily.  The disabled path is one
module-level flag check returning a shared null context manager, so
leaving tracing off costs nothing measurable on the executor hot path.

The buffer is bounded (`max_events`); once full, new events are
dropped and counted (`dropped_events()`), never silently swallowed:
the export embeds the drop count as process metadata.
"""

import json
import threading
import time

__all__ = ["enable", "disable", "is_enabled", "reset", "tracing",
           "span", "instant", "emit_span", "events", "event_count",
           "events_since", "truncate_to", "epoch", "dropped_events",
           "export_chrome_trace", "to_chrome_trace"]

_lock = threading.Lock()
_enabled = False
_events = []            # raw event dicts (chrome trace-event shape)
_dropped = 0
_max_events = 1_000_000
_epoch = time.perf_counter()   # ts are µs relative to this
_tls = threading.local()
_thread_meta_done = set()      # tids that already emitted thread_name
_PID = 1                       # single-process trace; constant pid


def _now_us():
    return (time.perf_counter() - _epoch) * 1e6


def _tid():
    tid = getattr(_tls, "tid", None)
    if tid is None:
        tid = _tls.tid = threading.get_ident() & 0x7FFFFFFF
    return tid


def _append(ev):
    """Append one raw event under the lock; emit the thread-name
    metadata row the first time a thread shows up."""
    global _dropped
    tid = ev["tid"]
    with _lock:
        if not _enabled:
            return
        if len(_events) >= _max_events:
            _dropped += 1
            return
        if tid not in _thread_meta_done:
            _thread_meta_done.add(tid)
            _events.append({
                "name": "thread_name", "ph": "M", "pid": _PID,
                "tid": tid,
                "args": {"name": threading.current_thread().name}})
        _events.append(ev)


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def enable(max_events=None, clear=True):
    """Turn span collection on (optionally bounding/clearing the
    buffer).  Safe to call when already enabled."""
    global _enabled, _max_events, _dropped, _epoch
    with _lock:
        if max_events is not None:
            _max_events = int(max_events)
        if clear:
            del _events[:]
            _thread_meta_done.clear()
            _dropped = 0
            _epoch = time.perf_counter()
        _enabled = True


def disable():
    global _enabled
    with _lock:
        _enabled = False


def is_enabled():
    return _enabled


def reset():
    """Drop every collected event (keeps the enabled state)."""
    global _dropped, _epoch
    with _lock:
        del _events[:]
        _thread_meta_done.clear()
        _dropped = 0
        _epoch = time.perf_counter()


class _TracingGuard:
    def __init__(self, max_events):
        self._max_events = max_events
        self._prev_max = None

    def __enter__(self):
        # scoped API: a guard-local bound must not leak into every
        # later enable() of the process (which would silently drop
        # their events once the small buffer fills)
        self._prev_max = _max_events
        enable(max_events=self._max_events, clear=True)
        return self

    def __exit__(self, *exc):
        global _max_events
        with _lock:
            _max_events = self._prev_max
        disable()
        return False


def tracing(max_events=None):
    """`with tracing(): ...` — collect spans for the body, then stop
    (events stay buffered for export)."""
    return _TracingGuard(max_events)


def events():
    """Snapshot of the raw event list (copies the list, not the
    dicts)."""
    with _lock:
        return list(_events)


def epoch():
    """The perf_counter() origin of event timestamps (re-based by
    enable(clear=True)/reset) — lets sibling exporters (obs.perf) put
    their tracks on the same timeline."""
    return _epoch


def event_count():
    """Current buffer length — a cheap bookmark for `events_since`
    (the step profiler takes one per step instead of copying the whole
    buffer)."""
    with _lock:
        return len(_events)


def events_since(index):
    """Copy of the events appended after bookmark `index` (an earlier
    `event_count()` result).  A reset/clear since the bookmark leaves
    the buffer shorter than the bookmark, so the slice is empty — the
    window's events are gone and the caller's sample is lost (the
    step profiler records such a step without a time split)."""
    with _lock:
        return list(_events[index:])


def truncate_to(index):
    """Drop events at positions >= bookmark `index` — how obs.perf
    removes its owned sampling windows after copying them out, WITHOUT
    touching events buffered before the window or re-basing the epoch
    (a full reset() would destroy spans a user recorded earlier and
    kept for a later export)."""
    with _lock:
        del _events[index:]


def dropped_events():
    with _lock:
        return _dropped


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class _NullSpan:
    """Shared no-op context manager returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        return self


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "_t0")

    def __init__(self, name, cat, args):
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **args):
        """Attach/extend args after entry (e.g. a compile-hit flag
        only known at the end of the span)."""
        if self.args is None:
            self.args = args
        else:
            self.args.update(args)
        return self

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t0 = self._t0
        dur = time.perf_counter() - t0
        ev = {"name": self.name, "cat": self.cat, "ph": "X",
              "ts": (t0 - _epoch) * 1e6, "dur": dur * 1e6,
              "pid": _PID, "tid": _tid()}
        if self.args:
            ev["args"] = self.args
        _append(ev)
        return False


def span(name, cat="paddle_tpu_torch", **args):
    """Context manager timing one nested region.  Cheap no-op while
    tracing is disabled."""
    if not _enabled:
        return _NULL
    return _Span(name, cat, args or None)


def emit_span(name, t0_perf, dur_s, cat="paddle_tpu_torch", args=None):
    """Record an already-measured region (t0 from time.perf_counter(),
    duration in seconds) — for callers that time once and feed both
    the tracer and an aggregate table (fluid.profiler.record_event)."""
    if not _enabled:
        return
    ev = {"name": name, "cat": cat, "ph": "X",
          "ts": (t0_perf - _epoch) * 1e6, "dur": dur_s * 1e6,
          "pid": _PID, "tid": _tid()}
    if args:
        ev["args"] = dict(args)
    _append(ev)


def instant(name, cat="paddle_tpu_torch", **args):
    """Mark a moment (thread-scoped instant event): a drain signal, a
    retry, ..."""
    if not _enabled:
        return
    ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
          "ts": _now_us(), "pid": _PID, "tid": _tid()}
    if args:
        ev["args"] = args
    _append(ev)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def to_chrome_trace():
    """The trace as a Chrome trace-event dict:
    `{"traceEvents": [...], "otherData": {...}}`."""
    with _lock:
        evs = list(_events)
        dropped = _dropped
    meta = [{"name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
             "args": {"name": "paddle_tpu_torch"}}]
    return {
        "traceEvents": meta + evs,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "paddle_tpu_torch.obs.trace",
                      "dropped_events": dropped},
    }


def export_chrome_trace(path=None):
    """Serialize the trace; writes `path` (atomic tmp+rename) when
    given, returns the dict either way."""
    doc = to_chrome_trace()
    if path:
        tmp = str(path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        import os

        os.replace(tmp, str(path))
    return doc
