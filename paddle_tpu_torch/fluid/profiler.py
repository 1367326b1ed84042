"""Profiler: the per-op timing table, and a torch.profiler trace.

Counterpart of paddle_tpu/fluid/profiler.py (reference:
paddle/platform/profiler.h:27-146 RecordEvent around every op,
ParseEvents table; python/paddle/v2/fluid/profiler.py).  The port's
executor runs every op eagerly, so the table has a row per op type, as
the JAX package's eager mode does.

`record_event` is span-backed: it feeds the table while `profiler()`
is on and the obs trace timeline while tracing is on (either alone
works), and every `record()` also feeds the unified metrics registry
(`profiler_event_seconds_total` / `profiler_event_calls_total` labeled
by event), so the table and `/metrics` never disagree.  The executor
asks `active()` once a run and opens no `record_event` while both are
off.  A row's time is the host's: the op's kernels are enqueued, not
waited for.

`profiler(trace_dir=...)` also records a torch.profiler session (the
host and, on the card, CUDA activity) and writes it as a Chrome trace,
`trace.json` in `trace_dir`, where the JAX package starts
`jax.profiler.start_trace`; the executor's per-op ranges
(ops/registry.py `span`) name the ops on its timeline.
"""

import contextlib
import os
import time
from collections import defaultdict

from ..obs import registry as obs_registry
from ..obs import trace as obs_trace

__all__ = ["profiler", "reset_profiler", "get_profile_records",
           "cuda_profiler", "tpu_profiler"]

TRACE_FILE = "trace.json"

_records = defaultdict(lambda: {"calls": 0, "total": 0.0,
                                "min": float("inf"), "max": 0.0})
_enabled = [False]


def is_enabled():
    return _enabled[0]


def active():
    """Whether a `record_event` would record anything: the table is on
    or the obs trace is."""
    return _enabled[0] or obs_trace.is_enabled()


# cached (registry, seconds_family, calls_family): record() runs on
# the serving request path, so resolve the families once per registry
# instead of two locked get-or-creates per observation
_fam_cache = [None, None, None]


def _registry_families():
    reg = obs_registry.get_registry()
    if _fam_cache[0] is not reg:  # registry swapped (reset_registry)
        _fam_cache[1] = reg.counter(
            "profiler_event_seconds_total",
            "accumulated seconds per profiler event",
            labelnames=("event",))
        _fam_cache[2] = reg.counter(
            "profiler_event_calls_total",
            "call count per profiler event",
            labelnames=("event",))
        _fam_cache[0] = reg
    return _fam_cache[1], _fam_cache[2]


def record(name, seconds):
    r = _records[name]
    r["calls"] += 1
    r["total"] += seconds
    r["min"] = min(r["min"], seconds)
    r["max"] = max(r["max"], seconds)
    seconds_fam, calls_fam = _registry_families()
    seconds_fam.labels(event=name).inc(seconds)
    calls_fam.labels(event=name).inc()


@contextlib.contextmanager
def record_event(name):
    """Span-backed RecordEvent: feeds the per-op table when the
    profiler is enabled AND the obs trace timeline when tracing is on
    (either alone works)."""
    tracing = obs_trace.is_enabled()
    if not (_enabled[0] or tracing):
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if tracing:
            obs_trace.emit_span(name, t0, dt, cat="op")
        if _enabled[0]:
            record(name, dt)


def reset_profiler():
    _records.clear()


def get_profile_records():
    out = {}
    for k, v in _records.items():
        v = dict(v)
        if not v["calls"]:
            # a zero-call entry must not leak the `inf` sentinel
            v["min"] = 0.0
        out[k] = v
    return out


def _print_table(sorted_key=None):
    rows = []
    for name, r in _records.items():
        rows.append((name, r["calls"], r["total"],
                     r["min"] if r["calls"] else 0.0, r["max"],
                     r["total"] / max(r["calls"], 1)))
    key_idx = {"calls": 1, "total": 2, "min": 3, "max": 4, "ave": 5}.get(
        sorted_key, 2)
    rows.sort(key=lambda x: -x[key_idx])
    print("%-40s %8s %12s %12s %12s %12s" % (
        "Event", "Calls", "Total(s)", "Min(s)", "Max(s)", "Ave(s)"))
    for row in rows:
        print("%-40s %8d %12.6f %12.6f %12.6f %12.6f" % row)


def _start_trace():
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, trace_dir=None):
    """reference: fluid/profiler.py profiler context manager.  With
    `trace_dir`, a torch.profiler session over the body is written to
    `trace_dir/trace.json` (Chrome trace-event JSON)."""
    _enabled[0] = True
    reset_profiler()
    prof = _start_trace() if trace_dir else None
    try:
        yield
    finally:
        _enabled[0] = False
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
        _print_table(sorted_key)


@contextlib.contextmanager
def cuda_profiler(output_file=None, output_mode=None, config=None):
    """Kept for API parity (reference: fluid/profiler.py:33): the
    per-op table, as `profiler()`."""
    with profiler(trace_dir=None):
        yield


# the JAX package's name for the same entry point
tpu_profiler = cuda_profiler
