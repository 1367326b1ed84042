"""Collective/communication observability, in one process: per-bucket
comm spans, per-bucket ring timing against the analytic floor, the
overlap split of the data-parallel step, and the calibration blob.

Counterpart of paddle_tpu/obs/comm.py, its in-process half.  The SPMD
trainer predicts communication cost (the PartitionPlan's ring floor)
and schedules it (the bucketed ring-allreduce in `parallel/ring.py` and
`spmd/overlap.py`); this module watches it happen:

  * **Schedule spans** — `bucketed_allreduce` records every schedule it
    runs (`record_schedule` / `bucket_span`): a parent
    `comm/bucketed_allreduce` span nesting one `comm/bucket` span per
    bucket (bytes, member count, reduce order) plus launch/complete
    instants, and `last_schedule()` keeps the structure for joins.  The
    JAX package records them once per jit trace, the schedule's shape;
    the port runs the schedule eagerly, so they are recorded on every
    call, and each bucket span covers that bucket's ring as the host
    issues it (on the card, the launches; on gloo ranks, the transfers
    themselves).
  * **Per-bucket timing** — `measure_bucket_times` runs each bucket's
    ring chain alone under `shard_map_norep` and times it (CUDA events
    on the card, the host clock on CPU ranks), observing
    `comm_collective_seconds{collective,bucket}` and
    `comm_bytes_total{collective}`, and pairs every bucket's measured
    time with its analytic ring floor
    (`analysis.costmodel.collective_wire_bytes` over the port's link
    rate, `costmodel.DEFAULT_ICI_GBPS`).
  * **The overlap split** — `overlap_report` times the real overlapped
    step against a reduction-elided compute-only twin
    (`make_overlapped_dp_step(skip_reduce=True)`); the difference is
    the EXPOSED comm time the schedule failed to hide behind backward
    compute.  `comm_exposed_seconds` and `overlap_efficiency` gauges
    publish the split.  The port's step runs the buckets in order after
    the backward, so it hides nothing yet: the split measures that.
    `calibration_blob` distills the per-bucket measured/predicted drift
    into the blob the autotuner's fit reads.

A mesh axis of size 1 moves nothing: `measure_bucket_times` and
`measure_trainer_comm` return None there, as on the JAX side.

The cross-host half, over the native master's lease store:

  * **Span windows** — `span_window_payload` is this process's recent
    trace events (`obs.trace`) with the wall-clock time of the trace
    epoch; `push_span_window` registers it under `/obsspan/<host>` (the
    FleetReporter does so beside its snapshot with `span_window` > 0)
    and `collect_span_windows` pulls every live one.
  * **Clock offsets** — a `ClockResponder` thread answers
    `/obsclock/ping/<host>/<nonce>` probes with a pong carrying its
    receive and send wall times; `estimate_clock_offsets` runs the
    NTP-style four-timestamp exchange over the store.
  * **The merged trace** — `merge_windows` puts every host's window on
    one wall-clock timebase (corrected by the offsets), a process track
    per host, as one Chrome/Perfetto trace (`comm_cli merge`).
"""

import json
import math
import os
import threading
import time

from . import registry as registry_mod
from . import trace as trace_mod

__all__ = ["record_schedule", "bucket_span", "schedule_span",
           "last_schedule", "reset", "measure_bucket_times",
           "measure_trainer_comm", "overlap_report", "drift_report",
           "calibration_blob", "save_calibration",
           "span_window_payload", "push_span_window",
           "collect_span_windows", "merge_windows", "ClockResponder",
           "estimate_clock_offsets", "COMM_CALIBRATION_KIND",
           "SPAN_PREFIX", "CLOCK_PING_PREFIX", "CLOCK_PONG_PREFIX"]

COMM_CALIBRATION_KIND = "paddle_tpu.comm_calibration"

# lease-store key prefixes of the cross-host half, the JAX package's,
# so either package's collector reads either package's pushes
SPAN_PREFIX = "/obsspan/"
CLOCK_PING_PREFIX = "/obsclock/ping/"
CLOCK_PONG_PREFIX = "/obsclock/pong/"

_lock = threading.Lock()
_last_schedule = None
_nonce_counter = [0]


def _reg():
    return registry_mod.get_registry()


def reset():
    """Drop the captured schedule (test isolation)."""
    global _last_schedule
    with _lock:
        _last_schedule = None


# ---------------------------------------------------------------------------
# schedule instrumentation (called by parallel/ring.py)
# ---------------------------------------------------------------------------

def record_schedule(collective, axis_name, buckets, mean=True):
    """Capture one bucketed-collective schedule.

    `buckets` is `[{"bucket": i, "names": [...], "bytes": int}, ...]`
    in REDUCE order (the caller passes last-produced grads first — the
    DDP discipline).  Stores the schedule for `last_schedule()` joins,
    bumps `comm_bucket_schedules_total{collective}`, and marks the
    moment in the trace.  Returns the schedule dict."""
    global _last_schedule
    sched = {
        "collective": str(collective),
        "axis": str(axis_name),
        "mean": bool(mean),
        "n_buckets": len(buckets),
        "total_bytes": int(sum(b.get("bytes", 0) for b in buckets)),
        "buckets": [dict(b) for b in buckets],
    }
    with _lock:
        _last_schedule = sched
    _reg().counter(
        "comm_bucket_schedules_total",
        "bucketed collective schedules run (one per call: the port "
        "runs the schedule eagerly, where a compiled step replays it)",
        labelnames=("collective",)).labels(
            collective=sched["collective"]).inc()
    trace_mod.instant("comm/schedule", cat="comm",
                      collective=sched["collective"],
                      axis=sched["axis"],
                      n_buckets=sched["n_buckets"],
                      total_bytes=sched["total_bytes"])
    return sched


def last_schedule():
    """The most recently recorded bucket schedule (None before any
    `bucketed_allreduce` call)."""
    with _lock:
        return _last_schedule


def schedule_span(sched):
    """Parent span wrapping a whole bucketed collective — the
    `comm/bucket` child spans nest inside it by containment."""
    return trace_mod.span("comm/bucketed_allreduce", cat="comm",
                          collective=sched["collective"],
                          axis=sched["axis"],
                          n_buckets=sched["n_buckets"],
                          total_bytes=sched["total_bytes"])


class _BucketSpan:
    """One bucket's span bracketed by launch/complete instants (the
    instants survive span-dropping buffers and give Perfetto markers to
    align against)."""

    __slots__ = ("_sched", "_i", "_span")

    def __init__(self, sched, i):
        self._sched = sched
        self._i = i

    def __enter__(self):
        b = self._sched["buckets"][self._i]
        trace_mod.instant("comm/bucket_launch", cat="comm",
                          bucket=self._i, bytes=b.get("bytes", 0))
        self._span = trace_mod.span(
            "comm/bucket", cat="comm", bucket=self._i,
            collective=self._sched["collective"],
            axis=self._sched["axis"], bytes=b.get("bytes", 0),
            names=len(b.get("names", ())),
            first=(b.get("names") or [None])[0])
        self._span.__enter__()
        return self._span

    def __exit__(self, *exc):
        out = self._span.__exit__(*exc)
        trace_mod.instant("comm/bucket_complete", cat="comm",
                          bucket=self._i)
        return out


def bucket_span(sched, i):
    """Context manager for bucket `i` of a `record_schedule` result."""
    return _BucketSpan(sched, i)


# ---------------------------------------------------------------------------
# per-bucket timing
# ---------------------------------------------------------------------------

def _ring_pred(payload_bytes, n, ici_gbps):
    from ..analysis.costmodel import collective_wire_bytes

    wire = collective_wire_bytes("allreduce", int(payload_bytes),
                                 int(n))
    return wire, wire / (float(ici_gbps) * 1e9)


def _timed(fn, on_card):
    """Seconds one call of `fn()` takes: CUDA events around it on the
    card, the host clock on the CPU (a gloo ring returns when its
    transfers are done)."""
    import torch

    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def measure_bucket_times(mesh, grads, bucket_bytes, axis_name="dp",
                         reps=3, ici_gbps=None, order=None):
    """Time each bucket's ring-allreduce chain separately.

    `grads` is a {name: array} gradient-shaped dict (numpy arrays or
    tensors; only shapes are read); the bucket layout is exactly what
    `bucketed_allreduce` would build for it (`grad_buckets` over the
    same sized names in the same order).  Each bucket's chain runs on
    its own under `shard_map_norep` on zeros on the mesh's device,
    once to warm up and then `reps` times, each timed.  Observes
    `comm_collective_seconds{collective,bucket}` per rep and
    `comm_bytes_total{collective}` per timed wire byte, and emits one
    `comm/bucket_timed` span per bucket at the measured median.

    Every rank of the mesh must make the same call.  Returns
    {"collective", "axis", "n", "bucket_bytes", "measured_s", "pred_s",
    "wire_bytes", "buckets": [{bucket, names, bytes, wire_bytes,
    pred_s, measured_s, ratio}]} or None when the axis moves nothing
    (width <= 1) or `grads` is empty."""
    import numpy as np
    import torch

    from ..analysis.costmodel import DEFAULT_ICI_GBPS
    from ..parallel import sharding as psharding
    from ..parallel.mesh import mesh_shape
    from ..parallel.ring import bucketed_allreduce, grad_buckets

    if not grads:
        return None
    p = int(mesh_shape(mesh).get(axis_name, 1))
    if p <= 1:
        return None
    ici_gbps = float(ici_gbps or DEFAULT_ICI_GBPS)
    names = list(order) if order is not None \
        else list(reversed(list(grads)))
    sized = [(n, int(np.prod(tuple(grads[n].shape), dtype=np.int64)) * 4)
             for n in names]
    buckets = grad_buckets(sized, int(bucket_bytes))
    on_card = mesh.device_type == "cuda"
    device = torch.device("cuda", torch.cuda.current_device()) \
        if on_card else torch.device("cpu")

    hist = _reg().histogram(
        "comm_collective_seconds",
        help_text="measured wall seconds per collective replay, "
                  "labeled by bucket index",
        labelnames=("collective", "bucket"))
    bytes_total = _reg().counter(
        "comm_bytes_total",
        "wire bytes moved by timed collective replays",
        labelnames=("collective",))

    rows = []
    for i, bucket in enumerate(buckets):
        members = sorted(bucket)
        sub = {n: torch.zeros(tuple(grads[n].shape), dtype=torch.float32,
                              device=device) for n in members}
        payload = sum(dict(sized)[n] for n in bucket)
        wire, pred_s = _ring_pred(payload, p, ici_gbps)
        specs = {n: psharding.P() for n in sub}

        def reduce_bucket(g, _payload=payload, _members=members):
            # one bucket == one ring chain: a bucket_bytes cap above the
            # payload keeps grad_buckets from re-splitting it
            out = bucketed_allreduce(g, _payload + 1,
                                     axis_name=axis_name, mean=True)
            return tuple(out[n] for n in _members)

        fn = psharding.shard_map_norep(
            reduce_bucket, mesh, in_specs=(specs,),
            out_specs=tuple(psharding.P() for _ in members))
        with torch.no_grad():
            _timed(lambda: fn(sub), on_card)         # warm
            times = []
            for _ in range(int(reps)):
                dt = _timed(lambda: fn(sub), on_card)
                times.append(dt)
                hist.labels(collective="allreduce",
                            bucket=str(i)).observe(dt)
                bytes_total.labels(collective="allreduce").inc(wire)
        measured = float(np.median(times))
        trace_mod.emit_span(
            "comm/bucket_timed", time.perf_counter() - measured,
            measured, cat="comm",
            args={"bucket": i, "bytes": int(payload),
                  "wire_bytes": int(wire), "names": len(bucket),
                  "pred_s": pred_s})
        rows.append({"bucket": i, "names": list(bucket),
                     "bytes": int(payload), "wire_bytes": int(wire),
                     "pred_s": float(pred_s),
                     "measured_s": measured,
                     "ratio": (measured / pred_s) if pred_s > 0
                     else None})
    return {
        "collective": "allreduce",
        "axis": axis_name,
        "n": p,
        "bucket_bytes": int(bucket_bytes),
        "measured_s": float(sum(r["measured_s"] for r in rows)),
        "pred_s": float(sum(r["pred_s"] for r in rows)),
        "wire_bytes": int(sum(r["wire_bytes"] for r in rows)),
        "buckets": rows,
    }


def measure_trainer_comm(trainer, reps=3, bucket_bytes=None):
    """`measure_bucket_times` over a trainer's gradient volume (the
    plan-priced trainable parameters: gradient volume == parameter
    volume).  None when the dp axis moves nothing."""
    import numpy as np

    from ..spmd.overlap import DEFAULT_BUCKET_BYTES

    params = set(trainer.plan.param_reasons) if trainer.plan \
        else set(trainer.state)
    params = params or set(trainer.state)
    grads = {
        n: np.zeros(tuple(v.shape), dtype=np.float32)
        for n, v in trainer.state.items()
        if n in params and len(v.shape) > 0
    }
    return measure_bucket_times(
        trainer.mesh, grads,
        bucket_bytes or trainer.bucket_bytes or DEFAULT_BUCKET_BYTES,
        axis_name=trainer.dp_axis, reps=reps)


# ---------------------------------------------------------------------------
# the overlap split
# ---------------------------------------------------------------------------

def _median(vals):
    vals = sorted(vals)
    n = len(vals)
    if not n:
        return None
    if n % 2:
        return vals[n // 2]
    return (vals[n // 2 - 1] + vals[n // 2]) / 2.0


def _span_window(events):
    """Compress a trace-event window into joinable rows (the report's
    evidence of what ran inside the timed steps)."""
    rows = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        rows.append({"name": ev.get("name"), "cat": ev.get("cat"),
                     "dur_us": round(ev.get("dur", 0.0), 1)})
    return rows[-64:]


def overlap_report(trainer, feeds, reps=3, bucket_report=None):
    """Exposed-vs-hidden comm split for an overlapped SPMD trainer.

    Times the real overlapped step (`trainer.step`, which waits for the
    card), a reduction-elided compute-only twin
    (`make_overlapped_dp_step(skip_reduce=True)` — same program, same
    per-rank map, no ring), and the standalone per-bucket rings
    (`measure_trainer_comm`).  Then:

        exposed_s = max(0, step_s - compute_s)   # comm the schedule
        hidden_s  = comm_s - exposed_s            # failed to hide
        overlap_efficiency = hidden_s / comm_s    # clamped to [0, 1]

    Publishes `comm_exposed_seconds` and `overlap_efficiency` gauges
    and returns the full report (per-bucket times, the span window
    captured during the timed steps).  Trainers not in overlap-dp mode
    get `{"supported": False, "overlap_fallback_reason": ...}` —
    fallback runs must never masquerade as overlap measurements.  Every
    rank of the mesh must make the same call."""
    import torch

    report = {
        "supported": trainer.step_mode == "overlap-dp",
        "step_mode": trainer.step_mode,
        "overlap_fallback_reason": trainer.overlap_fallback_reason,
        "plan_fingerprint": (trainer.plan.fingerprint()
                             if trainer.plan is not None else None),
        "bucket_bytes": int(trainer.bucket_bytes or 0),
    }
    if not report["supported"]:
        return report

    if bucket_report is None:
        bucket_report = measure_trainer_comm(trainer, reps=reps)
    comm_s = float(bucket_report["measured_s"]) if bucket_report \
        else 0.0

    on_card = trainer.mesh.device_type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # the real overlapped step (trainer.step waits for the card)
    trainer.step(feeds)                          # warm
    bookmark = trace_mod.event_count()
    step_times = []
    for _ in range(int(reps)):
        t0 = time.perf_counter()
        trainer.step(feeds)
        step_times.append(time.perf_counter() - t0)
    step_s = float(_median(step_times))
    window = _span_window(trace_mod.events_since(bookmark))

    # the compute-only twin: the same step with the ring elided, over
    # the trainer's state (which it reads and never writes)
    from ..spmd.overlap import make_overlapped_dp_step

    twin, _shardings = make_overlapped_dp_step(
        trainer.main_program, trainer.feed_names, trainer._fetch_all,
        trainer.mesh, trainer._state_template,
        dp_axis=trainer.dp_axis, bucket_bytes=trainer.bucket_bytes,
        donate_state=False, feed_specs=trainer.feed_specs,
        skip_reduce=True)

    def rng():
        return torch.Generator(device=trainer.place.device()).manual_seed(
            trainer.seed * 1000003)

    twin(trainer.state, feeds, rng())
    sync()
    compute_times = []
    for _ in range(int(reps)):
        t0 = time.perf_counter()
        twin(trainer.state, feeds, rng())
        sync()
        compute_times.append(time.perf_counter() - t0)
    compute_s = float(_median(compute_times))

    exposed_s = max(0.0, step_s - compute_s)
    if comm_s > 0:
        eff = max(0.0, min(1.0, 1.0 - exposed_s / comm_s))
        hidden_s = max(0.0, comm_s - exposed_s)
    else:
        eff, hidden_s = None, 0.0
    reg = _reg()
    reg.gauge("comm_exposed_seconds",
              "comm time the overlapped step failed to hide behind "
              "backward compute (step wall minus compute-only twin)") \
        .set(round(exposed_s, 6))
    if eff is not None:
        reg.gauge("overlap_efficiency",
                  "fraction of standalone comm time hidden by the "
                  "overlapped schedule (1.0 = fully hidden)") \
            .set(round(eff, 4))
    report.update({
        "step_s": step_s,
        "compute_s": compute_s,
        "comm_s": comm_s,
        "exposed_s": exposed_s,
        "hidden_s": hidden_s,
        "overlap_efficiency": eff,
        "reps": int(reps),
        "buckets": (bucket_report or {}).get("buckets", []),
        "spans": window,
    })
    return report


# ---------------------------------------------------------------------------
# analytic-floor drift -> calibration blob
# ---------------------------------------------------------------------------

def drift_report(bucket_report):
    """measured/predicted drift per bucket off the ring-cost floor.
    Publishes `comm_estimate_ratio{bucket=}` per joined row; returns
    {"kind", "rows", "median_ratio", "n"}."""
    rows = []
    gauge = _reg().gauge(
        "comm_estimate_ratio",
        "measured ring time / analytic link floor per bucket (1.0 = "
        "the cost model is exact)", labelnames=("bucket",))
    for r in (bucket_report or {}).get("buckets", []):
        if not r.get("ratio"):
            continue
        rows.append({"bucket": r["bucket"], "bytes": r["bytes"],
                     "wire_bytes": r["wire_bytes"],
                     "pred_s": r["pred_s"],
                     "measured_s": r["measured_s"],
                     "ratio": round(r["ratio"], 6)})
        gauge.labels(bucket=str(r["bucket"])).set(round(r["ratio"], 6))
    ratios = [r["ratio"] for r in rows]
    return {"kind": "paddle_tpu.comm_drift", "version": 1,
            "rows": rows, "n": len(rows),
            "median_ratio": _median(ratios)}


def _platform_class(mesh=None):
    """The platform class of the measurement: the mesh's device
    ("gpu" for a CUDA mesh, else "cpu") and its rank count; without a
    mesh, the process group's world (one process without one), on the
    card when there is one."""
    import torch

    from . import perf as obs_perf

    if mesh is not None:
        platform = "gpu" if mesh.device_type == "cuda" else "cpu"
        n = int(mesh.size())
    else:
        import torch.distributed as dist

        platform = "gpu" if torch.cuda.is_available() else "cpu"
        n = dist.get_world_size() if dist.is_initialized() else 1
    return obs_perf.platform_class({"platform": platform,
                                    "n_devices": n})


def calibration_blob(bucket_report, platform_class=None, model=None,
                     leg="pcomm"):
    """The per-bucket drift distilled into the blob the autotuner's fit
    consumes: one measured/predicted pair per bucket, each stamped with
    its platform class so the fit's same-class filter keeps CPU rings
    out of a card's calibration.  None when nothing was measured."""
    buckets = (bucket_report or {}).get("buckets") or []
    pairs = []
    cls = platform_class or _platform_class()
    for r in buckets:
        if not r.get("measured_s") or not r.get("pred_s") \
                or r["pred_s"] <= 0:
            continue
        pairs.append({"leg": "%s:bucket%d" % (leg, r["bucket"]),
                      "measured_s": float(r["measured_s"]),
                      "pred_s": float(r["pred_s"]),
                      "wire_bytes": int(r["wire_bytes"]),
                      "platform_class": cls})
    if not pairs:
        return None
    ratios = [p["measured_s"] / p["pred_s"] for p in pairs]
    return {"kind": COMM_CALIBRATION_KIND, "version": 1,
            "comm_ratio": _median(ratios), "n": len(pairs),
            "platform_class": cls, "model": model, "pairs": pairs}


def save_calibration(blob, path):
    tmp = str(path) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(blob, f, indent=1, sort_keys=True)
    os.replace(tmp, str(path))
    return str(path)


# ---------------------------------------------------------------------------
# cross-host span windows + clock-offset exchange + merge
# ---------------------------------------------------------------------------

def span_window_payload(host=None, limit=512):
    """This process's recent trace events as one bounded JSON-able
    push.  `epoch_wall` is the wall-clock time of the trace epoch
    (event `ts` values are microseconds after it), so a merger can
    re-base hosts with different process start times onto one
    timeline; residual wall-clock skew is what the clock-offset
    exchange corrects."""
    from . import fleet as fleet_mod

    now_wall = time.time()
    epoch_wall = now_wall - (time.perf_counter() - trace_mod.epoch())
    events = []
    for ev in trace_mod.events()[-int(limit):]:
        if ev.get("ph") not in ("X", "i"):
            continue
        row = {"name": ev.get("name"), "cat": ev.get("cat"),
               "ph": ev["ph"], "ts": round(ev.get("ts", 0.0), 1),
               "tid": ev.get("tid", 0)}
        if "dur" in ev:
            row["dur"] = round(ev["dur"], 1)
        if ev.get("args"):
            row["args"] = ev["args"]
        if ev.get("ph") == "i":
            row["s"] = ev.get("s", "t")
        events.append(row)
    return {"host": host or fleet_mod.host_id(),
            "ts": round(now_wall, 3),
            "epoch_wall": epoch_wall,
            "dropped": trace_mod.dropped_events(),
            "events": events}


def push_span_window(master, host=None, limit=512, ttl_ms=30000,
                     lease_prev=None):
    """Register this process's span window under `/obsspan/<host>`
    (unregistering `lease_prev` first — the lease value is immutable,
    so an update IS unregister + register, the FleetReporter
    discipline).  Returns the new lease or None on failure."""
    from .. import native

    payload = span_window_payload(host=host, limit=limit)
    value = json.dumps(payload, sort_keys=True)
    mhost, mport = str(master).rsplit(":", 1)
    try:
        client = native.MasterClient(mhost, int(mport))
    except (ConnectionError, OSError):
        return None
    try:
        if lease_prev is not None:
            try:
                client.unregister(lease_prev)
            except (ConnectionError, OSError):
                pass
        return client.register(SPAN_PREFIX + payload["host"], value,
                               int(ttl_ms))
    except (ConnectionError, OSError):
        return None
    finally:
        client.close()


def collect_span_windows(master):
    """{host: span-window payload} for every live `/obsspan/*` lease
    (corrupt pushes skipped — one bad host must not blind the
    merge)."""
    from .. import native

    mhost, mport = str(master).rsplit(":", 1)
    client = native.MasterClient(mhost, int(mport))
    try:
        entries = client.list_prefix(SPAN_PREFIX)
    finally:
        client.close()
    out = {}
    for key, value in entries.items():
        try:
            payload = json.loads(value)
        except (ValueError, TypeError):
            continue
        if not isinstance(payload, dict) \
                or not isinstance(payload.get("events"), list):
            continue
        payload.setdefault("host", key[len(SPAN_PREFIX):])
        out[payload["host"]] = payload
    return out


class ClockResponder:
    """Worker-side half of the heartbeat clock-offset exchange: a
    daemon thread that answers `/obsclock/ping/<host>/<nonce>` probes
    with a pong carrying this host's receive and send wall times.
    The estimator's accuracy is bounded by `poll_s` (the worker sees
    a ping at most one poll late), so the responder polls fast and
    exists only while an exchange is expected — it is not a
    steady-state load on the store.

    `skew_s` offsets this host's reported clock — a test hook that
    lets a single-process selftest prove the estimator recovers a
    known skew."""

    def __init__(self, master, host=None, poll_s=0.05, skew_s=0.0,
                 ttl_ms=10000):
        from . import fleet as fleet_mod

        mhost, mport = str(master).rsplit(":", 1)
        self._master = (mhost, int(mport))
        self.host = host or fleet_mod.host_id()
        self.poll_s = float(poll_s)
        self.skew_s = float(skew_s)
        self.ttl_ms = int(ttl_ms)
        self._stop = threading.Event()
        self._thread = None
        self._answered = set()

    def _now(self):
        return time.time() + self.skew_s

    def _poll_once(self, client):
        prefix = CLOCK_PING_PREFIX + self.host + "/"
        entries = client.list_prefix(prefix)
        for key in entries:
            nonce = key[len(prefix):]
            if not nonce or nonce in self._answered:
                continue
            t_recv = self._now()
            if len(self._answered) > 4096:
                self._answered.clear()
            self._answered.add(nonce)
            pong = {"nonce": nonce, "t_recv": t_recv,
                    "t_send": self._now(), "host": self.host}
            client.register(
                CLOCK_PONG_PREFIX + self.host + "/" + nonce,
                json.dumps(pong, sort_keys=True), self.ttl_ms)

    def _loop(self):
        from .. import native

        client = None
        while not self._stop.wait(self.poll_s):
            try:
                if client is None:
                    client = native.MasterClient(*self._master)
                self._poll_once(client)
            except (ConnectionError, OSError):
                if client is not None:
                    try:
                        client.close()
                    except Exception:  # noqa: BLE001
                        pass
                client = None
        if client is not None:
            try:
                client.close()
            except Exception:  # noqa: BLE001
                pass

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="comm-clock-responder",
                daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def estimate_clock_offsets(master, hosts, reps=3, timeout_s=3.0,
                           poll_s=0.02):
    """NTP-style clock-offset estimation over the lease store.

    For each host and rep: register a ping at t0 (this process's
    clock), wait for the host's `ClockResponder` pong carrying
    (t_recv, t_send) on ITS clock, note t3 on arrival; the offset
    estimate is the standard four-timestamp form

        offset = ((t_recv - t0) + (t_send - t3)) / 2

    whose error is the PATH ASYMMETRY (store hop + responder poll
    latency), not the full round trip.  Returns {host: median offset
    seconds or None (no pong within timeout)} — positive offset means
    the host's clock runs ahead of this process's."""
    from .. import native

    mhost, mport = str(master).rsplit(":", 1)
    client = native.MasterClient(mhost, int(mport))
    out = {}
    try:
        for host in hosts:
            samples = []
            for _ in range(int(reps)):
                with _lock:
                    _nonce_counter[0] += 1
                    nonce = "%d-%d" % (os.getpid(),
                                       _nonce_counter[0])
                ping_key = CLOCK_PING_PREFIX + host + "/" + nonce
                pong_key = CLOCK_PONG_PREFIX + host + "/" + nonce
                t0 = time.time()
                lease = client.register(
                    ping_key, json.dumps({"t0": t0}),
                    int(timeout_s * 1000) + 2000)
                pong = None
                deadline = time.monotonic() + float(timeout_s)
                while time.monotonic() < deadline:
                    entries = client.list_prefix(pong_key)
                    if pong_key in entries:
                        t3 = time.time()
                        try:
                            pong = json.loads(entries[pong_key])
                        except (ValueError, TypeError):
                            pong = None
                        break
                    time.sleep(poll_s)
                if lease is not None:
                    try:
                        client.unregister(lease)
                    except (ConnectionError, OSError):
                        pass
                if not pong:
                    continue
                try:
                    t_recv = float(pong["t_recv"])
                    t_send = float(pong["t_send"])
                except (KeyError, TypeError, ValueError):
                    continue
                off = ((t_recv - t0) + (t_send - t3)) / 2.0
                if math.isfinite(off):
                    samples.append(off)
            out[host] = _median(samples)
    finally:
        client.close()
    return out


def merge_windows(windows, offsets=None):
    """Merge per-host span windows into ONE Chrome/Perfetto trace with
    a process track per host on a common wall-clock timebase.

    Each window's events are microseconds after its own trace epoch;
    `epoch_wall` anchors that epoch to the host's wall clock, and
    `offsets` (an `estimate_clock_offsets` result; positive = host
    clock ahead) corrects residual skew.  The earliest corrected
    event anchor becomes t=0 of the merged trace."""
    if isinstance(windows, dict):
        windows = [windows[h] for h in sorted(windows)]
    offsets = offsets or {}
    anchored = []
    for w in windows:
        host = w.get("host") or "host?"
        off = offsets.get(host)
        base_wall = float(w.get("epoch_wall", 0.0)) \
            - float(off if off is not None else 0.0)
        anchored.append((host, base_wall, w))
    if not anchored:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "otherData": {"producer": "paddle_tpu.obs.comm",
                              "hosts": []}}
    t_zero = min(base for _, base, _ in anchored)
    events = []
    for idx, (host, base_wall, w) in enumerate(anchored):
        pid = idx + 1
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": host}})
        events.append({"name": "process_sort_index", "ph": "M",
                       "pid": pid, "tid": 0, "args": {"sort_index":
                                                      idx}})
        shift_us = (base_wall - t_zero) * 1e6
        for ev in w.get("events", []):
            row = {"name": ev.get("name", "?"),
                   "cat": ev.get("cat", "paddle_tpu"),
                   "ph": ev.get("ph", "X"),
                   "ts": round(float(ev.get("ts", 0.0)) + shift_us, 1),
                   "pid": pid, "tid": ev.get("tid", 0)}
            if row["ph"] == "X":
                row["dur"] = float(ev.get("dur", 0.0))
            if row["ph"] == "i":
                row["s"] = ev.get("s", "t")
            if ev.get("args"):
                row["args"] = ev["args"]
            events.append(row)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "paddle_tpu.obs.comm",
            "hosts": [h for h, _, _ in anchored],
            "clock_offsets": {h: offsets.get(h)
                              for h, _, _ in anchored},
            "epoch_wall": t_zero,
        },
    }
