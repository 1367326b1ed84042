"""Crash flight recorder: a bounded ring buffer of structured step
records that turns into a JSON post-mortem bundle when a run dies
(a copy of paddle_tpu/obs/flight.py; `describe_feeds` reads torch
tensors too).

When a training or serving run crashes, the stack trace says WHERE it
died but not what the last N steps looked like — step times, losses,
feed shapes, the metric deltas leading up to the failure.  The
recorder keeps exactly that, cheaply, in memory:

  * `record_step(trainer, step, feeds=..., loss=...)` — one bounded
    deque entry per step: wall-clock, feed shapes/dtypes, last loss,
    and the registry's movement since the previous record
    (`telemetry.snapshot_delta`: counter/histogram INCREMENTS and
    current gauge values; unmoved metrics are dropped).
  * `install()` — activates a process-wide recorder and chains
    `sys.excepthook`; the executor, the v2 trainer and the serving
    engine/server additionally call `on_crash(exc, ...)` from their
    exception paths, so a crashing run writes a flight bundle even
    when something above catches the exception.  Bundles are written
    once per exception object (layered hooks don't triple-write).
  * `dump()` — the JSON bundle: reason, exception + traceback, the
    step ring, exception-path notes, a full registry snapshot, and the
    tail of the span trace (when tracing was on).  Atomic tmp+rename
    write; the bundle has the JAX package's kind and keys, so its
    `tools/obs_dump.py --flight bundle.json` pretty-prints one.

Off by default and free when off: every hook starts with one
module-global None check.
"""

import collections
import json
import os
import sys
import threading
import time
import traceback as traceback_mod

from ..core.ragged import RaggedTensor, SelectedRows
from . import context as context_mod
from . import telemetry as telemetry_mod
from . import trace as trace_mod

__all__ = ["FlightRecorder", "install", "uninstall", "get_recorder",
           "active", "record_step", "on_crash", "suppressed",
           "describe_feeds", "set_host_context", "clear_host_context",
           "host_context"]

BUNDLE_KIND = "paddle_tpu.flight"
BUNDLE_VERSION = 1

# which host/process this bundle came from: on a multi-host job the
# bundles from every worker land in a shared bucket, and a post-mortem
# that can't say "host3, process_index 3" is a guessing game.  Runs
# call set_host_context themselves.  Module-global (not per-recorder)
# so install() cycles don't lose it.
_host_context = {}


def set_host_context(**kv):
    """Merge identity fields (host, process_index, mesh_axes,
    plan_fingerprint, ...) into every future bundle; None values
    delete the key."""
    for key, value in kv.items():
        if value is None:
            _host_context.pop(key, None)
        else:
            _host_context[key] = value
    return dict(_host_context)


def clear_host_context():
    _host_context.clear()


def host_context():
    return dict(_host_context)


def _dtype_name(dtype):
    """`float32` for torch.float32 as for numpy's float32."""
    return str(dtype).replace("torch.", "")


def describe_feeds(feed):
    """Shape/dtype summary of a feed dict — never the data itself
    (bundles must stay small and shareable).  Reads only a tensor's
    (or a RaggedTensor's values') metadata: no copy to the host, no
    synchronization with the card."""
    out = {}
    for name, val in (feed or {}).items():
        if isinstance(val, (list, tuple)):
            out[name] = "list[%d]" % len(val)
            continue
        arr = val.values if isinstance(val, (RaggedTensor, SelectedRows)) \
            else val
        shape = getattr(arr, "shape", None)
        dtype = getattr(arr, "dtype", None)
        if shape is None:
            out[name] = type(val).__name__
        else:
            out[name] = "%s%s" % (_dtype_name(dtype), list(shape))
    return out


class FlightRecorder:
    """Bounded in-memory recorder; one per `install()`.

    Crash-path writes are bounded two ways: `min_dump_interval_s`
    rate-limits `dump_once` (an error storm — a serving model failing
    every request — must not turn the recorder into a per-request
    disk writer), and `max_bundles` ROTATES the recorder's bundle
    files (oldest deleted) rather than refusing new ones — a
    long-lived process that slowly accumulates handled errors must
    still get a bundle for the genuine crash at the end.  Explicit
    `dump()` calls skip the rate limit but still rotate."""

    def __init__(self, out_dir=".", capacity=256, span_tail=120,
                 note_capacity=16, max_bundles=16,
                 min_dump_interval_s=5.0):
        self.out_dir = str(out_dir)
        self.capacity = int(capacity)
        self.span_tail = int(span_tail)
        self.max_bundles = int(max_bundles)
        self.min_dump_interval_s = float(min_dump_interval_s)
        self._steps = collections.deque(maxlen=self.capacity)
        self._notes = collections.deque(maxlen=int(note_capacity))
        self._lock = threading.Lock()
        self._last_snapshot = {}
        self._total_steps = 0
        self._seq = 0
        self._last_dump_t = 0.0
        self._bundles = []            # this recorder's files, oldest first
        self.suppressed_dumps = 0
        self.last_bundle_path = None

    # -- recording -----------------------------------------------------------
    def record_step(self, trainer, step, feeds=None, loss=None,
                    **extra):
        """Append one step record.  `telemetry_delta` holds the
        registry's movement since the previous record
        (telemetry.snapshot_delta semantics: counter/histogram
        INCREMENTS, current gauge values, unmoved keys dropped)."""
        rec = {"t": round(time.time(), 3), "trainer": trainer,
               "step": step}
        if loss is not None:
            try:
                rec["loss"] = float(loss)
            except (TypeError, ValueError):
                pass
        if feeds:
            # pass pre-described {name: "dtype[shape]"} dicts through
            if all(isinstance(v, str) for v in feeds.values()):
                rec["feeds"] = dict(feeds)
            else:
                rec["feeds"] = describe_feeds(feeds)
        if extra:
            rec["extra"] = extra
        with self._lock:
            snap, delta = telemetry_mod.snapshot_and_delta(
                self._last_snapshot)
            rec["telemetry_delta"] = delta
            self._last_snapshot = snap
            self._steps.append(rec)
            self._total_steps += 1
        return rec

    def note(self, origin, **context):
        """Remember an exception-path context line (executor feed
        shapes, request ids, ...) for the next bundle."""
        entry = {"t": round(time.time(), 3), "origin": origin}
        entry.update(context)
        with self._lock:
            self._notes.append(entry)
        return entry

    # -- bundles -------------------------------------------------------------
    def _recent_spans(self):
        evs = trace_mod.events()
        tail = []
        for ev in evs[-self.span_tail:]:
            if ev.get("ph") not in ("X", "i"):
                continue
            item = {"name": ev.get("name"), "cat": ev.get("cat"),
                    "ph": ev["ph"], "ts_us": round(ev.get("ts", 0), 1)}
            if "dur" in ev:
                item["dur_us"] = round(ev["dur"], 1)
            tail.append(item)
        return tail

    def dump(self, reason="manual", exc=None, path=None):
        """Write the flight bundle; returns its path."""
        with self._lock:
            steps = list(self._steps)
            notes = list(self._notes)
            dropped = max(0, self._total_steps - self.capacity)
            self._seq += 1
            seq = self._seq
        doc = {
            "kind": BUNDLE_KIND,
            "version": BUNDLE_VERSION,
            "created_at": time.time(),
            "reason": reason,
            "exception": None,
            "notes": notes,
            "steps": steps,
            "dropped_steps": dropped,
            "suppressed_dumps": self.suppressed_dumps,
            "registry": telemetry_mod.snapshot(),
            "recent_spans": self._recent_spans(),
        }
        if _host_context:
            doc["host_context"] = dict(_host_context)
        # the request this thread was serving when it crashed: dump()
        # runs on the crashing thread (excepthook / exception-path
        # hooks), so the thread-local binding IS the dying request —
        # the post-mortem names it instead of "some request"
        ctx = context_mod.current()
        if ctx is not None:
            doc["trace_context"] = ctx.ids()
        if exc is not None:
            doc["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc),
                "traceback": "".join(traceback_mod.format_exception(
                    type(exc), exc, exc.__traceback__)),
            }
        if path is None:
            os.makedirs(self.out_dir, exist_ok=True)
            path = os.path.join(
                self.out_dir,
                "flight_%d_%03d.json" % (os.getpid(), seq))
        tmp = str(path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, str(path))
        self.last_bundle_path = str(path)
        with self._lock:
            self._bundles.append(str(path))
            stale = (self._bundles[:-self.max_bundles]
                     if self.max_bundles > 0 else [])
            self._bundles = self._bundles[len(stale):]
        for old in stale:
            try:
                os.remove(old)
            except OSError:
                pass  # caller moved/deleted it: rotation is advisory
        return str(path)

    # dedup marker set ON the exception object: an id()-keyed dict
    # would mis-match when a freed exception's address is reused by a
    # later, different crash, silently losing that crash's bundle
    _BUNDLE_ATTR = "_paddle_tpu_flight_bundle"

    def dump_once(self, exc, reason):
        """Dump at most one bundle per exception object — the layered
        hooks (executor, trainer, excepthook) all funnel here — and at
        most one per min_dump_interval_s overall, so an error storm
        can't write per-request from the crash path (rotation in
        dump() separately bounds total disk)."""
        existing = getattr(exc, self._BUNDLE_ATTR, None)
        if existing is not None:
            return existing
        with self._lock:
            now = time.monotonic()
            limited = (self._last_dump_t
                       and now - self._last_dump_t
                       < self.min_dump_interval_s)
            if limited:
                self.suppressed_dumps += 1
            else:
                self._last_dump_t = now
        if limited:
            return self.last_bundle_path
        path = self.dump(reason=reason, exc=exc)
        try:
            setattr(exc, self._BUNDLE_ATTR, path)
        except Exception:
            pass  # __slots__ exception: may double-write, never lose
        return path


# ---------------------------------------------------------------------------
# process-wide recorder + hooks
# ---------------------------------------------------------------------------

_recorder = None
_prev_excepthook = None
_suppress = threading.local()


def install(out_dir=".", capacity=256, span_tail=120, **recorder_kw):
    """Activate a process-wide recorder (replacing any previous one)
    and chain sys.excepthook so an uncaught exception writes a bundle
    automatically.  Returns the recorder."""
    global _recorder, _prev_excepthook
    rec = FlightRecorder(out_dir=out_dir, capacity=capacity,
                         span_tail=span_tail, **recorder_kw)
    if _recorder is None and _prev_excepthook is None \
            and sys.excepthook is not _excepthook:
        _prev_excepthook = sys.excepthook
        sys.excepthook = _excepthook
    # else our hook is already live — directly, or still inside a
    # foreign wrapper chain from a prior install/uninstall cycle; it
    # reads the module global, so the new recorder is served either
    # way and the saved original hook is never overwritten
    _recorder = rec
    return rec


def uninstall():
    """Deactivate; unchain the excepthook only if it is still ours —
    another library may have wrapped our hook since install(), and
    restoring over its wrapper would silently disable it.  Returns the
    old recorder (or None)."""
    global _recorder, _prev_excepthook
    rec = _recorder
    _recorder = None
    if _prev_excepthook is not None and sys.excepthook is _excepthook:
        sys.excepthook = _prev_excepthook
        _prev_excepthook = None
    # else: a foreign wrapper chained over our hook — leave the chain
    # intact (our hook is a no-op with _recorder cleared) and keep
    # _prev_excepthook so it still forwards to the original
    return rec


def get_recorder():
    return _recorder


def active():
    return _recorder is not None


class _Suppressed:
    def __enter__(self):
        self._prev = getattr(_suppress, "flag", False)
        _suppress.flag = True
        return self

    def __exit__(self, *exc):
        _suppress.flag = self._prev
        return False


def suppressed():
    """`with flight.suppressed(): ...` — exception-path hooks become
    no-ops for the body (used by health.locate_nonfinite: a diagnostic
    replay is not a crash)."""
    return _Suppressed()


def record_step(trainer, step, feeds=None, loss=None, **extra):
    """Module-level convenience: record when a recorder is installed,
    no-op (one None check) otherwise."""
    rec = _recorder
    if rec is None:
        return None
    return rec.record_step(trainer, step, feeds=feeds, loss=loss,
                           **extra)


def on_crash(exc, origin="unknown", **context):
    """Exception-path hook: note the context and write (at most one)
    bundle for this exception.  Returns the bundle path or None."""
    rec = _recorder
    if rec is None or getattr(_suppress, "flag", False):
        return None
    try:
        rec.note(origin, exception=type(exc).__name__, **context)
        return rec.dump_once(exc, reason=origin)
    except Exception:
        # the recorder must never turn a crash into a different crash
        return None


def _excepthook(tp, value, tb):
    # re-entrancy guard: after install/uninstall cycles under foreign
    # wrappers the chain can route through this function twice; break
    # the loop at the interpreter default
    if getattr(_suppress, "in_hook", False):
        sys.__excepthook__(tp, value, tb)
        return
    _suppress.in_hook = True
    try:
        try:
            on_crash(value, origin="sys.excepthook")
        finally:
            hook = _prev_excepthook or sys.__excepthook__
            hook(tp, value, tb)
    finally:
        _suppress.in_hook = False
