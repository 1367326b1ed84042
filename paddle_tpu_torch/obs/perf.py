"""Continuous perf observability: step profiler, bottleneck
attribution, and the perf-history regression gate.

Counterpart of paddle_tpu/obs/perf.py, with the same record schema,
history format, verdicts and defaults, so that a history file written
by either package loads and gates in the other with the same verdict.
Three layers on top of the obs substrate (spans, registry):

  * `StepProfiler` — a continuous, sampling step profiler.  Installed
    as the `telemetry.step(...)` observer it sees every v2 trainer step
    (and any loop that wraps its steps in `telemetry.step`), records a
    structured per-step record into a bounded ring (wall time,
    h2d-input time, transfer bytes, and the JAX record's retrace and
    compile-cache counts: `retraces` counts the executor's CUDA graph
    captures in the step, `pcache_hits` and `pcache_misses` the
    persistent plan cache's loads, compile/pcache.py), and every
    `sample_every`-th step
    additionally records the card's kernels to split the step into
    device / input / host time.  Records export as JSONL or a Chrome trace-event file.
  * the bottleneck classifier — folds a time split plus the
    `fluid/analysis.py` roofline into ONE verdict per step/leg:
    `compute_bound | hbm_bound | input_bound | host_bound`, with the
    dominant op named.  The verdicts, keys and reason strings are the
    JAX package's ("MXU floor" names the compute floor: the card's
    tensor or f32 cores).
  * the perf history store + regression gate — runs append normalized
    records to `perf_history.jsonl`; `gate_history()` compares the
    newest run per metric against a rolling median-of-N baseline with
    per-metric tolerances, and hard-fails stale or fallback platforms
    (a re-emitted record must never gate as a fresh measurement).
    `tools/perf_cli.py gate` wires the exit code into CI.

**What `device_s` means.**  The JAX profiler sums its executor's
jit-segment spans, which block per compiled segment.  The port's
executor is eager: the card's queue stays open across the host's launch
gaps, so a span from a run's first launch to its last completion would
cover nearly the whole wall.  Here `device_s` is the card's BUSY time
in the sampled step: the summed durations of the kernels and copies
that one torch.profiler session with CUDA activity records over the
step (what `chip_smoke.profile_step` reads as busy time).  The profiler
starts the session before the step's clock starts, and waits for the
card, stops it and parses it after the step's wall is taken.  Where
nothing ran on the card (`CPUPlace`), `device_s` is the wall of the
step's executor runs, as the JAX package's CPU segments carry theirs.
Each sampled step leaves one `perf/device[<n> runs]` span on the trace.

Records name their platform from the place that ran them (`"gpu"` on
the card, `"cpu"` on the CPU; `platform_of`), never from a probe that
could fall back.

Import-cheap by design: fluid (for the roofline) is imported lazily
inside functions, same contract as obs.health.
"""

import json
import os
import threading
import time
from collections import deque

from . import registry as registry_mod
from . import telemetry as telemetry_mod
from . import trace as trace_mod

__all__ = ["StepProfiler", "install", "uninstall", "get_profiler",
           "classify_split", "roofline_floors", "leg_perf_blob",
           "VERDICTS", "normalize_record", "append_history",
           "load_history", "prune_stale_history", "gate_history",
           "format_gate", "GateResult", "attribution_floors",
           "is_stale_platform", "platform_class", "platform_of",
           "default_peak_tflops",
           "DEFAULT_TOLERANCE", "DEFAULT_BASELINE_N",
           "HISTORY_BASENAME"]

VERDICTS = ("compute_bound", "hbm_bound", "input_bound", "host_bound")

# a leg is input/host-bound when that share of the step wall clock
# exceeds these (and beats the other shares); below them the device is
# the story and the roofline decides compute vs HBM
DEFAULT_INPUT_SHARE = 0.30
DEFAULT_HOST_SHARE = 0.30

HISTORY_BASENAME = "perf_history.jsonl"
DEFAULT_TOLERANCE = 0.05
DEFAULT_BASELINE_N = 5


def _reg():
    return registry_mod.get_registry()


# ---------------------------------------------------------------------------
# step profiler
# ---------------------------------------------------------------------------

def _start_busy_session():
    """A started torch.profiler session with CUDA activity that records
    the card's kernels and copies until `_stop_busy_session`; None
    without a CUDA device, False while a caller's session records (two
    cannot run at once)."""
    import torch

    if not torch.cuda.is_available():
        return None
    if torch.autograd._profiler_enabled():
        return False
    from torch.profiler import ProfilerActivity, profile

    session = profile(activities=[ProfilerActivity.CUDA])
    session.start()
    return session


def _stop_busy_session(session):
    """Wait for the cards, stop `session` and return the card's busy
    seconds in it: the summed durations of its CUDA-device events
    (kernels, copies, memsets), user annotations left out."""
    import torch

    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    session.stop()
    cuda = torch.autograd.DeviceType.CUDA
    ns = 0
    for ev in session.profiler.kineto_results.events():
        if ev.device_type() == cuda and not (
                hasattr(ev, "is_user_annotation")
                and ev.is_user_annotation()):
            ns += ev.duration_ns()
    return ns / 1e9


class StepProfiler:
    """Bounded ring of structured per-step perf records.

    Install as the telemetry step observer (`profiler.install()` or
    module-level `perf.install()`): the v2 trainer already wraps every
    step in `telemetry.step(...)`, so no trainer changes are needed.
    Unsampled steps cost one registry snapshot + delta (the flight
    recorder pays the same per step); sampled steps additionally turn
    span tracing on and record the card's kernels under torch.profiler
    for the step's duration — a busy time measured on the card at the
    price of the profiler's recording for that ONE step (its stop, a
    synchronize and the parse come after the wall is taken).
    `sample_every=0` never samples (counters-only records).
    """

    def __init__(self, capacity=512, sample_every=16):
        self.capacity = int(capacity)
        self.sample_every = int(sample_every)
        self._ring = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._steps = 0
        self._dropped = 0
        # per-step state between begin/end (trainer-loop thread only;
        # concurrent trainers would interleave begin/end — the profiler
        # tracks the installing loop, same contract as the tracer ring)
        self._snap_before = None
        self._sampling = False
        self._trace_owned = False
        self._ev_mark = 0
        self._session = None
        self._t0 = None

    # -- observer protocol ---------------------------------------------------
    def install(self):
        """Become THE telemetry step observer.  Returns self."""
        telemetry_mod.install_step_observer(self)
        return self

    def uninstall(self):
        if telemetry_mod.step_observer() is self:
            telemetry_mod.install_step_observer(None)

    def begin_step(self, trainer):
        self._sampling = (self.sample_every > 0
                          and self._steps % self.sample_every == 0)
        if self._sampling:
            if not trace_mod.is_enabled():
                # sample window only: keep whatever the process had
                trace_mod.enable(clear=False)
                self._trace_owned = True
            self._ev_mark = trace_mod.event_count()
            self._session = _start_busy_session()
        self._snap_before = telemetry_mod.snapshot()
        self._t0 = time.perf_counter()

    def end_step(self, trainer, dt, examples, failed=False):
        snap_before, self._snap_before = self._snap_before, None
        sampling, self._sampling = self._sampling, False
        if snap_before is None:
            return  # end without begin (installed mid-step)
        delta = telemetry_mod.snapshot_delta(snap_before)
        device_s = None
        segments = None
        if sampling:
            # after the step's wall time was taken: the session's stop
            # and parse stay out of it
            device_s, segments = self._device_split()
            if self._trace_owned:
                # the window's spans are copied out above: splice just
                # this window back out of the shared buffer, so owned
                # sampling can never fill it (a full buffer silently
                # stops yielding splits) while events a user buffered
                # BEFORE the window — and the tracer epoch — stay
                # untouched.  An externally enabled tracer is not ours
                # to clear at all.
                trace_mod.disable()
                trace_mod.truncate_to(self._ev_mark)
                self._trace_owned = False
        input_s = delta.get("executor_feed_seconds_total", 0.0)
        rec = {
            "step": self._steps,
            "trainer": trainer,
            "t0_s": round(self._t0 - _EPOCH, 6),
            "wall_s": round(dt, 6),
            "examples": examples,
            "failed": bool(failed),
            "sampled": bool(sampling),
            "retraces": delta.get("executor_jit_traces_total", 0),
            "pcache_hits": delta.get("compile_cache_hits_total", 0),
            "pcache_misses": delta.get("compile_cache_misses_total", 0),
            "h2d_bytes": delta.get(
                "executor_transfer_bytes_total{direction=h2d}", 0),
            "d2h_bytes": delta.get(
                "executor_transfer_bytes_total{direction=d2h}", 0),
            "input_s": round(input_s, 6),
            "device_s": (None if device_s is None
                         else round(device_s, 6)),
            "host_s": (None if device_s is None
                       else round(max(0.0, dt - device_s - input_s), 6)),
        }
        if segments:
            rec["segments"] = segments
        with self._lock:
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(rec)
            self._steps += 1
        reg = _reg()
        reg.counter("perf_steps_profiled_total",
                    "steps recorded by the continuous step profiler",
                    labelnames=("trainer",)).labels(trainer=trainer).inc()
        if sampling and device_s is not None:
            for part, val in (("device", device_s), ("input", input_s),
                              ("host", rec["host_s"])):
                reg.gauge("perf_step_seconds",
                          "time split of the most recent SAMPLED step",
                          labelnames=("part",)) \
                   .labels(part=part).set(round(val, 6))

    def _device_split(self):
        """(device_s, segments) of the sampled step that just ended,
        and its `perf/device` span on the trace: the card's busy time
        from the step's session, or, where nothing ran on the card, the
        wall of the step's executor runs.  `segments` describes those
        runs (the port has no compiled segments), the slowest by wall.
        device_s is None while a caller's torch.profiler session kept
        the step's own from starting."""
        session, self._session = self._session, None
        busy = stop_s = None
        if session:
            t_stop = time.perf_counter()
            busy = _stop_busy_session(session)
            stop_s = time.perf_counter() - t_stop
        runs = [ev for ev in trace_mod.events_since(self._ev_mark)
                if ev.get("ph") == "X" and ev["name"] == "executor/run"]
        segments = None
        if runs:
            top = max(runs, key=lambda ev: ev.get("dur", 0))
            segments = {"count": len(runs), "slowest": top["name"],
                        "slowest_ms": round(top["dur"] / 1e3, 3)}
        if session is False:
            return None, segments
        if busy:
            device_s, what = busy, "cuda kernels"
        elif runs:
            device_s = sum(ev.get("dur", 0) for ev in runs) / 1e6
            what = "wall"
        else:
            return None, segments
        trace_mod.emit_span("perf/device[%d runs]" % len(runs), self._t0,
                            device_s, cat="perf",
                            args={"busy": what,
                                  "profiler_stop_s": (
                                      None if stop_s is None
                                      else round(stop_s, 6))})
        return device_s, segments

    # -- access / export -----------------------------------------------------
    def records(self):
        with self._lock:
            return list(self._ring)

    def dropped(self):
        with self._lock:
            return self._dropped

    def summary(self):
        """Aggregate over the ring: step counts, median/p90 wall, total
        retraces, and the mean time split over sampled steps.  Steps
        that retraced are excluded from the split mean, as in the JAX
        package, where step 0's segment spans include the XLA compile;
        here a step that captured CUDA graphs (on the card, a
        signature's second run) is left out the same way."""
        recs = self.records()
        if not recs:
            return {"steps": 0}
        walls = sorted(r["wall_s"] for r in recs)
        sampled = [r for r in recs if r["sampled"]
                   and r["device_s"] is not None
                   and not r["retraces"]]
        out = {
            "steps": len(recs),
            "dropped": self.dropped(),
            "wall_ms_p50": round(walls[len(walls) // 2] * 1e3, 3),
            "wall_ms_p90": round(walls[(len(walls) * 9) // 10] * 1e3, 3),
            "retraces": sum(r["retraces"] for r in recs),
            "pcache_hits": sum(r["pcache_hits"] for r in recs),
            "h2d_bytes": sum(r["h2d_bytes"] for r in recs),
            "sampled_steps": len(sampled),
        }
        if sampled:
            n = len(sampled)
            out["split_ms"] = {
                "device": round(
                    sum(r["device_s"] for r in sampled) / n * 1e3, 3),
                "input": round(
                    sum(r["input_s"] for r in sampled) / n * 1e3, 3),
                "host": round(
                    sum(r["host_s"] for r in sampled) / n * 1e3, 3),
            }
        return out

    def classify(self, t_mxu_s=None, t_hbm_s=None, dominant=None,
                 **thresholds):
        """Verdict over the ring's mean sampled split (see
        `classify_split`); roofline floors come from the caller (or
        from `roofline_floors`)."""
        s = self.summary()
        if not s.get("sampled_steps"):
            return None
        split = s["split_ms"]
        wall = s["wall_ms_p50"] / 1e3
        return classify_split(
            wall, device_s=split["device"] / 1e3,
            input_s=split["input"] / 1e3, host_s=split["host"] / 1e3,
            t_mxu_s=t_mxu_s, t_hbm_s=t_hbm_s, dominant=dominant,
            **thresholds)

    def export_jsonl(self, path=None):
        """One JSON object per step record; writes `path` atomically
        when given, returns the serialized text either way."""
        text = "\n".join(json.dumps(r, sort_keys=True)
                         for r in self.records()) + "\n"
        if path:
            tmp = str(path) + ".tmp"
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, str(path))
        return text

    def export_chrome_trace(self, path=None):
        """The ring as a Chrome trace-event document: one "X" span per
        step (args = the full record) on a dedicated perf track, with
        retrace counter events.  Timestamps are re-based onto the main
        tracer's CURRENT epoch so the two exports align when loaded
        together in Perfetto (records spanning a tracer reset keep
        their relative spacing but shift as a block)."""
        rebase = _EPOCH - trace_mod.epoch()
        evs = []
        for r in self.records():
            ev = {"name": "%s/step[%d]" % (r["trainer"], r["step"]),
                  "cat": "perf", "ph": "X", "pid": 2, "tid": 1,
                  "ts": (r["t0_s"] + rebase) * 1e6,
                  "dur": r["wall_s"] * 1e6,
                  "args": r}
            evs.append(ev)
            if r["retraces"]:
                evs.append({"name": "retraces", "cat": "perf",
                            "ph": "C", "pid": 2, "tid": 1,
                            "ts": (r["t0_s"] + rebase) * 1e6,
                            "args": {"retraces": r["retraces"]}})
        doc = {
            "traceEvents": [{"name": "process_name", "ph": "M",
                             "pid": 2, "tid": 0,
                             "args": {"name":
                                      "paddle_tpu_torch.obs.perf"}}]
            + evs,
            "displayTimeUnit": "ms",
            "otherData": {"producer": "paddle_tpu_torch.obs.perf",
                          "dropped_steps": self.dropped()},
        }
        if path:
            tmp = str(path) + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, str(path))
        return doc


_EPOCH = time.perf_counter()
_profiler = None


def install(capacity=512, sample_every=16):
    """Create + install a process-wide StepProfiler (replacing any
    previous one); returns it."""
    global _profiler
    _profiler = StepProfiler(capacity=capacity,
                             sample_every=sample_every).install()
    return _profiler


def uninstall():
    global _profiler
    if _profiler is not None:
        _profiler.uninstall()
        _profiler = None


def get_profiler():
    return _profiler


# ---------------------------------------------------------------------------
# bottleneck classifier
# ---------------------------------------------------------------------------

def classify_split(wall_s, device_s=None, input_s=0.0, host_s=None,
                   t_mxu_s=None, t_hbm_s=None, dominant=None,
                   input_share=DEFAULT_INPUT_SHARE,
                   host_share=DEFAULT_HOST_SHARE):
    """Fold one step/leg's time split (+ optional roofline floors)
    into a verdict dict:

        {"verdict": compute_bound|hbm_bound|input_bound|host_bound,
         "dominant": <segment/op name or time-split part>,
         "shares": {"input": f, "host": f|None, "device": f|None},
         "reason": <one sentence naming the evidence>}

    Order of the argument evidence: a step spending > `input_share`
    of its wall on feed preparation is input-bound no matter what the
    device does; then host python; otherwise the device is the story
    and `t_mxu_s` vs `t_hbm_s` (roofline or XLA-attribution floors)
    decides compute vs HBM.  `dominant` names the largest
    segment/op-type contributor when the caller knows it.
    """
    if wall_s <= 0:
        return {"verdict": None, "dominant": dominant, "shares": {},
                "reason": "no wall time"}
    in_share = min(1.0, input_s / wall_s)
    if host_s is None and device_s is not None:
        host_s = max(0.0, wall_s - device_s - input_s)
    h_share = None if host_s is None else min(1.0, host_s / wall_s)
    d_share = None if device_s is None else min(1.0, device_s / wall_s)
    shares = {"input": round(in_share, 4),
              "host": None if h_share is None else round(h_share, 4),
              "device": None if d_share is None else round(d_share, 4)}
    if in_share >= input_share and in_share >= (h_share or 0.0):
        return {"verdict": "input_bound", "dominant": "feed/h2d",
                "shares": shares,
                "reason": "input prep is %.0f%% of the step wall"
                          % (in_share * 100)}
    if h_share is not None and h_share >= host_share \
            and h_share > (d_share or 0.0):
        return {"verdict": "host_bound", "dominant": "host-python",
                "shares": shares,
                "reason": "host time between segments is %.0f%% of "
                          "the step wall" % (h_share * 100)}
    # device-bound: the roofline decides which wall it leans on
    if t_mxu_s is not None or t_hbm_s is not None:
        mxu = t_mxu_s or 0.0
        hbm = t_hbm_s or 0.0
        if mxu >= hbm:
            return {"verdict": "compute_bound", "dominant": dominant,
                    "shares": shares,
                    "reason": "MXU floor %.3fms >= HBM floor %.3fms"
                              % (mxu * 1e3, hbm * 1e3)}
        return {"verdict": "hbm_bound", "dominant": dominant,
                "shares": shares,
                "reason": "HBM floor %.3fms > MXU floor %.3fms"
                          % (hbm * 1e3, mxu * 1e3)}
    return {"verdict": "compute_bound", "dominant": dominant,
            "shares": shares,
            "reason": "device-dominated; no roofline/attribution "
                      "data to split compute vs HBM"}


def default_peak_tflops(bf16_act):
    """The card's peak for a program's products: 989 TFLOP/s (the bf16
    tensor cores) under bf16 activations, else 67 (the f32 cores: the
    port runs f32 products with TF32 off).  The JAX package takes half
    its bf16 peak for f32, which is the TPU's ratio, not the card's."""
    from ..utils.device_peaks import BF16_FLOPS, F32_CORE_FLOPS

    return (BF16_FLOPS if bf16_act else F32_CORE_FLOPS) / 1e12


def roofline_floors(program, bf16_act=False, peak_tflops=None,
                    hbm_gbps=None, topk=3, tpu_tiling=False):
    """The classifier's roofline inputs for one Program, via
    fluid/analysis.py: `t_mxu_s`/`t_hbm_s` (total-FLOPs and
    unique-bytes floors), serial/ideal step floors, and the dominant
    op types by time floor.  The peak defaults to
    `default_peak_tflops(bf16_act)`, the bandwidth to the card's 3,350
    GB/s.  `tpu_tiling=True` switches the byte accounting to the TPU's
    tile-padded bytes (what the `layout` pass's cost gate compares
    layouts with).  Lazy fluid import (obs stays import-cheap)."""
    from ..fluid import analysis

    peak = peak_tflops or default_peak_tflops(bf16_act)
    bw = hbm_gbps or analysis.DEFAULT_HBM_GBPS
    rep = analysis.roofline_report(program, peak_tflops=peak,
                                   hbm_gbps=bw, bf16_act=bf16_act,
                                   tpu_tiling=tpu_tiling)
    per = sorted(rep["per_type"].items(), key=lambda kv: -kv[1]["t_ms"])
    return {
        "t_mxu_s": rep["total_gflops"] / (peak * 1e3),
        "t_hbm_s": rep["unique_gbytes"] / bw,
        "floor_ms_serial": rep["floor_ms_serial"],
        "floor_ms_ideal": rep["floor_ms_ideal"],
        "top_ops": [(k, round(v["t_ms"], 3)) for k, v in per[:topk]],
        "peak_tflops": peak,
        "hbm_gbps": bw,
    }


def attribution_floors(peak_tflops, hbm_gbps, registry=None,
                       segment_prefix="jit_segment"):
    """Roofline floors from the cost-attribution gauges
    (`xla_flops`/`xla_bytes_accessed{segment=}`), summed across
    segments, with the dominant segment named.  None when attribution
    never ran — always in the port, whose captures publish their
    seconds and pool bytes instead (`obs.health.publish_compile_stats`)
    and no XLA analysis; a caller that sets them itself gets the
    JAX package's sums.  Only segments matching `segment_prefix`
    are summed (per-segment labels): a whole-step gauge covering the
    same work would double-count; pass a different prefix (or "") to
    target other publishers.  Gauges are last-written-wins per label — in a
    process that attributed several programs, restrict the prefix or
    reset the registry between them."""
    reg = registry or _reg()
    flops_fam = reg.gauge("xla_flops",
                          "XLA-estimated FLOPs per compiled segment",
                          labelnames=("segment",))
    bytes_fam = reg.gauge("xla_bytes_accessed",
                          "XLA-estimated bytes accessed per compiled "
                          "segment", labelnames=("segment",))
    def _samples(fam):
        return {tuple(s.get("labels", {}).items()): s["value"]
                for s in fam.samples()
                if s.get("labels", {}).get("segment", "")
                .startswith(segment_prefix)}

    flops = _samples(flops_fam)
    nbytes = _samples(bytes_fam)
    if not flops and not nbytes:
        return None
    t_by_seg = {}
    for key in set(flops) | set(nbytes):
        t_by_seg[key] = max(
            flops.get(key, 0.0) / (peak_tflops * 1e12),
            nbytes.get(key, 0.0) / (hbm_gbps * 1e9))
    dominant = max(t_by_seg, key=t_by_seg.get) if t_by_seg else None
    return {
        "t_mxu_s": sum(flops.values()) / (peak_tflops * 1e12),
        "t_hbm_s": sum(nbytes.values()) / (hbm_gbps * 1e9),
        "dominant": dict(dominant).get("segment") if dominant else None,
        "peak_tflops": peak_tflops,
        "hbm_gbps": hbm_gbps,
    }


def leg_perf_blob(program, step_s, bf16_act=False, peak_tflops=None,
                  hbm_gbps=None, input_s=0.0, host_s=None,
                  xla_flops=None, xla_bytes=None):
    """The "perf" blob of one measured leg: the measured step against
    its roofline, a time split, and the bottleneck verdict.  Takes
    whole-step `xla_flops`/`xla_bytes` over the IR estimate when a
    caller gives them (nothing in the port publishes them); the IR
    roofline still names the dominant op types.
    Never raises — a program the analyzer can't cost returns a
    floor-less verdict."""
    try:
        floors = roofline_floors(program, bf16_act=bf16_act,
                                 peak_tflops=peak_tflops,
                                 hbm_gbps=hbm_gbps)
    except Exception:
        floors = None
    t_mxu = floors["t_mxu_s"] if floors else None
    t_hbm = floors["t_hbm_s"] if floors else None
    xla = None
    if xla_flops or xla_bytes:
        peak = (floors or {}).get("peak_tflops") or peak_tflops or 1.0
        bw = (floors or {}).get("hbm_gbps") or hbm_gbps or 1.0
        xla = {"flops": xla_flops, "bytes_accessed": xla_bytes}
        if xla_flops:
            t_mxu = xla_flops / (peak * 1e12)
        if xla_bytes:
            t_hbm = xla_bytes / (bw * 1e9)
    dominant = floors["top_ops"][0][0] if floors and floors["top_ops"] \
        else None
    # a timed loop that feeds from device-resident buffers: absent an
    # explicit input_s the whole wall is device time
    device_s = max(0.0, step_s - input_s - (host_s or 0.0))
    verdict = classify_split(step_s, device_s=device_s, input_s=input_s,
                             host_s=host_s, t_mxu_s=t_mxu,
                             t_hbm_s=t_hbm, dominant=dominant)
    blob = {
        "step_ms": round(step_s * 1e3, 3),
        "verdict": verdict["verdict"],
        "dominant": verdict["dominant"],
        "reason": verdict["reason"],
        "time_split_ms": {
            "device": round(device_s * 1e3, 3),
            "input": round(input_s * 1e3, 3),
            "host": round((host_s or 0.0) * 1e3, 3),
        },
    }
    if floors:
        blob["floors_ms"] = {
            "mxu": round(floors["t_mxu_s"] * 1e3, 3),
            "hbm": round(floors["t_hbm_s"] * 1e3, 3),
            "serial": round(floors["floor_ms_serial"], 3),
            "ideal": round(floors["floor_ms_ideal"], 3),
        }
        blob["top_ops"] = floors["top_ops"]
        blob["peak_tflops"] = floors["peak_tflops"]
        blob["hbm_gbps"] = floors["hbm_gbps"]
        blob["bf16_act"] = bool(bf16_act)
    if xla:
        blob["xla"] = xla
    return blob


# ---------------------------------------------------------------------------
# perf history + regression gate
# ---------------------------------------------------------------------------

def normalize_record(record, leg=None, ts=None):
    """Distill a measured record into the perf-history schema (None
    for skip markers — they carry no measurement).  The perf blob is
    kept down to its verdict fields so history lines stay one-screen
    greppable."""
    if record.get("value") is None:
        return None
    perf = record.get("perf") or {}
    norm = {
        "ts": time.time() if ts is None else float(ts),
        "metric": record["metric"],
        "leg": leg,
        "value": record["value"],
        "unit": record.get("unit"),
        "step_ms": record.get("step_ms"),
        "mfu": record.get("mfu"),
        "amp_bf16": record.get("amp_bf16"),
        "platform": record.get("platform"),
    }
    if record.get("platform_class"):
        norm["platform_class"] = record["platform_class"]
    if record.get("n_devices"):
        norm["n_devices"] = int(record["n_devices"])
    if record.get("mesh"):
        norm["mesh"] = dict(record["mesh"])
    if perf:
        norm["verdict"] = perf.get("verdict")
        norm["dominant"] = perf.get("dominant")
    cc = record.get("compile_cache")
    if cc:
        norm["compile_cache"] = cc
    mem = record.get("memory")
    if mem:
        # the memory story, kept to the joinable numbers (the JAX
        # package's keys, and the port's graph pool bytes): static
        # peak, the compiled or captured footprint, the device
        # watermark, and the estimate ratio — `gate --mem-tolerance`
        # regresses on these like it does on step_ms
        norm["memory"] = {
            k: mem[k] for k in
            ("static_peak_bytes", "xla_total_bytes", "pool_bytes",
             "device_peak_bytes", "estimate_ratio")
            if mem.get(k) is not None}
    cfg = record.get("config")
    if cfg:
        # the configuration this record measured (model, knobs)
        norm["config"] = cfg
    comm = record.get("comm")
    if comm:
        # a multi-device comm measurement (the JAX package's keys, as
        # obs/comm.py reports them): the analytic ring
        # floor vs the timed grad-allreduce, the overlap split and the
        # mode stamps that keep fallback runs out of the overlap
        # baseline.  Per-bucket detail stays OUT of history lines.
        norm["comm"] = {
            k: comm[k] for k in
            ("wire_bytes", "pred_s", "measured_s", "bucket_bytes",
             "n_buckets", "comm_ratio", "exposed_s", "hidden_s",
             "overlap_efficiency", "step_mode",
             "overlap_fallback_reason", "plan_fingerprint")
            if comm.get(k) is not None}
    latency = record.get("latency")
    if latency:
        # serving-tail measurement (obs/load.py latency_blob): the
        # open/closed-loop percentiles + SLO attainment the load
        # harness distilled from a run — `perf_cli gate
        # --latency-tolerance` regresses on the percentile keys.
        # Raw per-request samples and the worst-K joins stay OUT of
        # history lines; `load_cli --report` writes those.
        norm["latency"] = {
            k: latency[k] for k in
            ("mode", "n", "p50_ms", "p90_ms", "p99_ms", "p99_9_ms",
             "offered_rps", "achieved_rps", "slo_ms",
             "slo_attainment")
            if latency.get(k) is not None}
    return norm


def append_history(record, path, leg=None, ts=None):
    """Append one normalized record (a JSON line) to the history file;
    returns the normalized dict, or None for records with nothing to
    gate (skip markers)."""
    norm = normalize_record(record, leg=leg, ts=ts)
    if norm is None:
        return None
    with open(path, "a") as f:
        f.write(json.dumps(norm, sort_keys=True) + "\n")
    return norm


def load_history(path):
    """History lines in file order; unparsable lines are skipped (a
    torn append must not wedge the gate)."""
    records = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        return []
    return records


def _median(values):
    vals = sorted(values)
    n = len(vals)
    if n == 0:
        return None
    if n % 2:
        return vals[n // 2]
    return (vals[n // 2 - 1] + vals[n // 2]) / 2.0


class GateResult:
    """Outcome of one gate run: `failures` (each a dict naming metric,
    kind, and the bottleneck verdict), `checked` pass lines, and
    `skipped` metrics with no usable baseline."""

    def __init__(self):
        self.failures = []
        self.checked = []
        self.skipped = []

    @property
    def ok(self):
        return not self.failures

    @property
    def exit_code(self):
        return 0 if self.ok else 1

    def to_dict(self):
        return {"ok": self.ok, "failures": self.failures,
                "checked": self.checked, "skipped": self.skipped}


def platform_of(place):
    """The platform a record names for a run at `place`: "gpu" for a
    CUDAPlace, "cpu" for the CPU — read from the place that ran, never
    from a probe that could fall back."""
    from ..fluid.executor import CUDAPlace

    return "gpu" if isinstance(place, CUDAPlace) else "cpu"


def is_stale_platform(platform):
    """True when a record's platform string marks a stale/degraded
    re-emit (`*-stale`, `*-fallback`, or empty) — the class the gate
    hard-fails.  Public so emitters can warn at EMIT time instead of
    leaving the discovery to gate time."""
    p = str(platform or "")
    return p.endswith("-stale") or p.endswith("-fallback") or p == ""


# internal alias (pre-existing callers)
_is_stale_platform = is_stale_platform


def platform_class(record):
    """The measurement-comparability class of a history record:
    platform + device count + mesh shape, e.g. ``cpu:d1``,
    ``gpu:d1``, ``cpu:d8:dp=8``.

    An 8-way CPU-simulated run and a one-card run must never gate
    against each other — same metric name, different physics.  Records that
    predate the tag (no `platform_class`, `n_devices`, or `mesh`
    field) derive ``<platform>:d1``, so a single-device history keeps
    its whole baseline across the schema change."""
    explicit = record.get("platform_class")
    if explicit:
        return str(explicit)
    plat = str(record.get("platform") or "")
    n = record.get("n_devices")
    mesh = record.get("mesh")
    cls = "%s:d%d" % (plat, int(n) if n else 1)
    if mesh:
        cls += ":" + ",".join("%s=%d" % (a, int(s))
                              for a, s in sorted(dict(mesh).items()))
    return cls


def prune_stale_history(path, apply=False):
    """Drop stale/fallback-platform records from a history file: the
    gate hard-fails them, so once diagnosed they are pure noise.
    Unparsable lines are preserved as-is (same conservatism as
    `load_history`'s torn-append tolerance).

    Dry-run by default: returns (kept_count, dropped_records) without
    touching the file; `apply=True` rewrites it atomically
    (tmp + rename).  `perf_cli history --prune-stale [--yes]` is the
    operator surface."""
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return 0, []
    kept, dropped = [], []
    for line in lines:
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            kept.append(line)
            continue
        if isinstance(rec, dict) and \
                is_stale_platform(rec.get("platform")):
            dropped.append(rec)
        else:
            kept.append(line)
    if apply and dropped:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write("".join(l + "\n" for l in kept))
        os.replace(tmp, path)
    return len(kept), dropped


# peak-memory keys the gate may compare, best first (the JAX package's
# keys, with the port's captured footprint beside the compiled one):
# the compiled whole-step footprint, the graph pool bytes of the step's
# captures, the static estimate, the device watermark.  The gate only ever compares a candidate against
# baseline values of the SAME key — the keys legitimately differ by the
# static-vs-actual factor, so a static estimate never gates against a
# compiled-footprint baseline.
_MEM_KEYS = ("xla_total_bytes", "pool_bytes", "static_peak_bytes",
             "device_peak_bytes")


def _mem_peak(rec, key):
    v = (rec.get("memory") or {}).get(key)
    return float(v) if v else None


# comm-time keys the gate may compare, best first: the EXPOSED comm
# time (step wall minus compute-only twin — what overlap actually
# failed to hide; only real overlapped runs carry it, so fallback
# records can never pollute that baseline) then the standalone timed
# ring.  Same-key discipline as _MEM_KEYS: exposed-vs-standalone is
# apples-to-oranges by construction.
_COMM_KEYS = ("exposed_s", "measured_s")


def _comm_val(rec, key):
    v = (rec.get("comm") or {}).get(key)
    return float(v) if v else None


# tail-latency keys the gate may compare, best (deepest tail) first:
# p99.9 when the run was large enough to resolve it, else p99, p90,
# p50.  Same-key discipline as _MEM_KEYS/_COMM_KEYS — a short run's
# p50 must never gate against a long run's p99.9 baseline.  Records
# additionally only compare within the same generator mode (open vs
# closed loop): closed-loop percentiles are coordinated-omission-
# blind by construction, so an open-loop candidate against a
# closed-loop baseline would fail on the measurement discipline, not
# the server.
_LATENCY_KEYS = ("p99_9_ms", "p99_ms", "p90_ms", "p50_ms")


def _latency_val(rec, key):
    v = (rec.get("latency") or {}).get(key)
    return float(v) if v else None


def _latency_mode(rec):
    return (rec.get("latency") or {}).get("mode")


def gate_history(records, baseline_n=DEFAULT_BASELINE_N,
                 tolerance=DEFAULT_TOLERANCE, metric_tolerance=None,
                 step_tolerance=None, allow_stale=False, metrics=None,
                 mem_tolerance=None, comm_tolerance=None,
                 latency_tolerance=None):
    """Noise-aware regression gate over history records.

    Per metric: the NEWEST record is the candidate; the baseline is
    the median of the up-to-`baseline_n` most recent PRIOR records on
    the same platform.  Checks, in order:

      * platform integrity (hard fail): a candidate whose platform is
        `*-stale` / `*-fallback` is a re-emit or degraded run
        masquerading as a measurement — it must never gate as fresh
        (`allow_stale=True` downgrades this to a skip).  A candidate
        on a different platform than its entire baseline is a
        mismatch, not a regression.
      * throughput: candidate value below baseline * (1 - tol) fails,
        naming the drop, the leg, and the candidate's bottleneck
        verdict.  tol is `metric_tolerance[metric]` when given, else
        `tolerance` — median-of-N absorbs run-to-run noise, the
        tolerance absorbs residual jitter.
      * step time: candidate step_ms above baseline * (1 + step tol)
        fails even when throughput squeaked by (batch-size changes can
        mask a per-step regression).
      * peak memory (OPT-IN via `mem_tolerance`): candidate peak
        bytes (`_mem_peak` off the record's "memory" blob) above
        baseline * (1 + mem tol) fails — an HBM regression that
        doesn't yet cost step time still eats the headroom the next
        batch-size bump needs.  Records without memory blobs are
        never failed on memory.
      * comm time (OPT-IN via `comm_tolerance`): candidate exposed
        comm seconds (`_COMM_KEYS` off the record's "comm" blob —
        exposed_s when the run was really overlapped, else the
        standalone timed ring) above baseline * (1 + comm tol) fails
        — an overlap regression that throughput noise still hides
        fails CI the way a memory one does.  Only records carrying
        the SAME comm key compare (fallback/gspmd runs never carry
        `exposed_s`, so they cannot pollute the overlap baseline);
        records without comm blobs are never failed on comm.
      * tail latency (OPT-IN via `latency_tolerance`): candidate
        serving tail percentile (`_LATENCY_KEYS` off the record's
        "latency" blob — p99.9 when resolved, else p99/p90/p50) above
        baseline * (1 + latency tol) fails, naming the percentile —
        a p99 regression that the mean-throughput check can't see is
        exactly the capacity signal (obs/load.py).  Same-key AND
        same-generator-mode discipline: open-loop and closed-loop
        percentiles measure different things (coordinated omission)
        and never compare; records without latency blobs are never
        failed on latency.

    `metrics`, when given, restricts gating to those metric names.
    """
    metric_tolerance = metric_tolerance or {}
    by_metric = {}
    for rec in records:
        if not isinstance(rec, dict) or "metric" not in rec:
            continue
        by_metric.setdefault(rec["metric"], []).append(rec)
    result = GateResult()
    for metric in by_metric:
        if metrics is not None and metric not in metrics:
            continue
        hist = by_metric[metric]
        cand = hist[-1]
        prior = hist[:-1]
        tol = float(metric_tolerance.get(metric, tolerance))
        base_info = {"metric": metric, "leg": cand.get("leg"),
                     "verdict": cand.get("verdict"),
                     "dominant": cand.get("dominant"),
                     "platform": cand.get("platform"),
                     "platform_class": platform_class(cand)}
        if _is_stale_platform(cand.get("platform")):
            if allow_stale:
                result.skipped.append(dict(
                    base_info, why="stale platform %r (allowed)"
                    % cand.get("platform")))
            else:
                result.failures.append(dict(
                    base_info, kind="platform",
                    why="platform %r is a stale/degraded re-emit — "
                        "not a fresh measurement"
                        % cand.get("platform")))
            continue
        cand_cls = platform_class(cand)
        matching = [r for r in prior
                    if platform_class(r) == cand_cls]
        if not matching:
            if prior:
                plats = sorted({platform_class(r) for r in prior})
                result.failures.append(dict(
                    base_info, kind="platform",
                    why="platform class mismatch: candidate %r has "
                        "no baseline (history is %s)"
                        % (cand_cls, ",".join(plats))))
            else:
                result.skipped.append(dict(base_info,
                                           why="no baseline yet"))
            continue
        window = matching[-int(baseline_n):]
        base_val = _median([r["value"] for r in window
                            if r.get("value") is not None])
        if base_val is None:
            result.skipped.append(dict(base_info,
                                       why="baseline has no values"))
            continue
        failed = False
        if cand.get("value") is not None and base_val > 0 \
                and cand["value"] < base_val * (1.0 - tol):
            drop = 1.0 - cand["value"] / base_val
            result.failures.append(dict(
                base_info, kind="throughput", value=cand["value"],
                baseline=round(base_val, 2), n=len(window),
                why="%.4g %s vs baseline median %.4g (-%.1f%% > "
                    "%.1f%% tol)" % (cand["value"],
                                     cand.get("unit") or "",
                                     base_val, drop * 100,
                                     tol * 100)))
            failed = True
        base_step = _median([r["step_ms"] for r in window
                             if r.get("step_ms") is not None])
        st_tol = tolerance if step_tolerance is None \
            else float(step_tolerance)
        if not failed and cand.get("step_ms") is not None \
                and base_step and cand["step_ms"] \
                > base_step * (1.0 + st_tol):
            rise = cand["step_ms"] / base_step - 1.0
            result.failures.append(dict(
                base_info, kind="step_ms", value=cand["step_ms"],
                baseline=round(base_step, 2), n=len(window),
                why="step %.4gms vs baseline median %.4gms (+%.1f%% "
                    "> %.1f%% tol)" % (cand["step_ms"], base_step,
                                       rise * 100, st_tol * 100)))
            failed = True
        if not failed and mem_tolerance is not None:
            # gate on the best key present in BOTH the candidate and
            # at least one baseline record — one consistent quantity,
            # never static-vs-XLA apples-to-oranges
            for key in _MEM_KEYS:
                cand_mem = _mem_peak(cand, key)
                if cand_mem is None:
                    continue
                base_vals = [m for m in
                             (_mem_peak(r, key) for r in window)
                             if m is not None]
                if not base_vals:
                    continue
                base_mem = _median(base_vals)
                if cand_mem > base_mem * (1.0 + float(mem_tolerance)):
                    rise = cand_mem / base_mem - 1.0
                    result.failures.append(dict(
                        base_info, kind="memory", value=cand_mem,
                        baseline=round(base_mem, 0),
                        n=len(base_vals),
                        why="peak memory (%s) %.1f MiB vs baseline "
                            "median %.1f MiB (+%.1f%% > %.1f%% tol)"
                            % (key, cand_mem / 2**20,
                               base_mem / 2**20, rise * 100,
                               float(mem_tolerance) * 100)))
                    failed = True
                break
        if not failed and comm_tolerance is not None:
            # same-key discipline as the memory gate: exposed_s only
            # exists on genuinely overlapped runs, so a fallback run
            # (no exposed_s) compares on measured_s instead and can
            # never drag the overlap baseline down
            for key in _COMM_KEYS:
                cand_comm = _comm_val(cand, key)
                if cand_comm is None:
                    continue
                base_vals = [c for c in
                             (_comm_val(r, key) for r in window)
                             if c is not None]
                if not base_vals:
                    continue
                base_comm = _median(base_vals)
                if cand_comm > base_comm * (1.0 +
                                            float(comm_tolerance)):
                    rise = cand_comm / base_comm - 1.0
                    result.failures.append(dict(
                        base_info, kind="comm", value=cand_comm,
                        baseline=round(base_comm, 6),
                        n=len(base_vals),
                        why="comm time (%s) %.3f ms vs baseline "
                            "median %.3f ms (+%.1f%% > %.1f%% tol)"
                            % (key, cand_comm * 1e3,
                               base_comm * 1e3, rise * 100,
                               float(comm_tolerance) * 100)))
                    failed = True
                break
        if not failed and latency_tolerance is not None:
            # same-key discipline again, plus generator-mode
            # separation: an open-loop candidate only baselines
            # against open-loop history (closed-loop percentiles are
            # omission-blind and systematically lower)
            cand_mode = _latency_mode(cand)
            mode_window = [r for r in window
                           if _latency_mode(r) == cand_mode]
            for key in _LATENCY_KEYS:
                cand_lat = _latency_val(cand, key)
                if cand_lat is None:
                    continue
                base_vals = [v for v in
                             (_latency_val(r, key)
                              for r in mode_window)
                             if v is not None]
                if not base_vals:
                    continue
                base_lat = _median(base_vals)
                if cand_lat > base_lat * (1.0 +
                                          float(latency_tolerance)):
                    rise = cand_lat / base_lat - 1.0
                    result.failures.append(dict(
                        base_info, kind="latency", value=cand_lat,
                        baseline=round(base_lat, 3),
                        n=len(base_vals),
                        why="tail latency (%s, %s loop) %.3f ms vs "
                            "baseline median %.3f ms (+%.1f%% > "
                            "%.1f%% tol)"
                            % (key, cand_mode, cand_lat, base_lat,
                               rise * 100,
                               float(latency_tolerance) * 100)))
                    failed = True
                break
        if not failed:
            result.checked.append(dict(
                base_info, value=cand.get("value"),
                baseline=round(base_val, 2), n=len(window)))
    return result


def format_gate(result):
    """Human-readable gate report (the `perf_cli gate` stdout)."""
    lines = ["[pperf] gate: %d checked, %d failure(s), %d skipped"
             % (len(result.checked), len(result.failures),
                len(result.skipped))]
    for f in result.failures:
        verdict = f.get("verdict")
        tail = "" if not verdict else "  — bottleneck: %s%s" % (
            verdict, " (%s)" % f["dominant"] if f.get("dominant")
            else "")
        lines.append("FAIL %-44s [%s] %s%s"
                     % (f["metric"], f.get("kind"), f["why"], tail))
    for c in result.checked:
        lines.append(" ok  %-44s %.4g within tol of median %.4g (n=%d)"
                     % (c["metric"], c["value"] or 0.0, c["baseline"],
                        c["n"]))
    for s in result.skipped:
        lines.append(" --  %-44s skipped: %s" % (s["metric"], s["why"]))
    return "\n".join(lines)
