"""Memory observability: the static liveness timeline against what the
card holds, the buffer-donation audit, the OOM pre-flight and
post-mortem, and the drift calibration for `paddle_tpu_torch.tune`.

Counterpart of paddle_tpu/obs/mem.py, with the same names.  The JAX
module joins its static estimate with each compiled executable's
`memory_analysis()`; the port's actual side is what the card holds for
a captured program: the bytes its CUDA graph pool grew by at each
capture (fluid/graphs.py `graph_capture`).  Five layers:

  * **static timeline**: `program_timeline(program, fetches)` runs the
    one shared liveness walk (`analysis.dataflow.liveness_timeline`,
    the accounting S005 and auto_remat use) and returns the per-op
    live-activation-bytes series with the top-N buffers resident at
    the peak, each blamed to its defining op.  `render_timeline` draws
    it, `timeline_chrome_trace` exports a Chrome-trace counter track
    ("ph": "C"; a synthetic timebase of one µs per op index).
  * **actuals**: the executor registers each captured segment's static
    peak, and its program's, at plan time (`register_segment_static`),
    and `obs.health.publish_compile_stats` forwards each capture's pool
    growth here (`on_compile_captured`).  Both land in
    `mem_*{segment=}` gauges, with the card's allocator watermarks
    (`mem_device_*{device=}`, from `torch.cuda.memory_stats`; the CPU
    reports none, as the JAX CPU backend reports none).
  * **drift report**: `drift_report()` joins static peak and pool bytes
    and publishes `mem_estimate_ratio{segment=}`.  The segments of a
    program share one pool, so a later segment's capture may reuse
    what an earlier one freed: a segment's growth is the pool's growth
    at its capture, and its ratio means something only for the first
    capture into a pool.  The report therefore has "program" rows (the
    program's static activation peak against the sum of its captures'
    growth) and "segment" rows (each marked `first` or not);
    `median_ratio`, which `calibration_blob` hands to
    `tune.fit.load_hbm_calibration`, is the median over the program
    rows (`basis` says which rows it used).
  * **donation audit**: `audit_donation(program)` prices the port's
    donation plan (`analysis/alias.py`): the state buffers the executor
    donates and the dead-after-use ones it does not, with their bytes.
  * **OOM pre-flight and post-mortem**: `FLAGS_mem_budget_gb` makes the
    executor refuse a program whose static peak exceeds the budget
    before its first eager run or capture (`preflight` raises
    `MemoryBudgetError`), and `oom_context(exc, program)` attaches the
    timeline's top blamed buffers and the last `mem_*` gauges to the
    flight bundle, for the pre-flight error and for a real CUDA out of
    memory alike (`obs_dump --flight` renders the blame table).

Import-cheap by design: fluid and analysis are imported lazily inside
functions, as in obs.health.  `tools/mem_cli.py` is the operator
surface.
"""

import json
import os
import threading
import time

from . import registry as registry_mod
from . import telemetry as telemetry_mod

__all__ = ["program_timeline", "segment_static_peak",
           "render_timeline", "timeline_chrome_trace",
           "register_segment_static", "on_compile_captured",
           "retire_segments", "segments", "xla_program_bytes_total",
           "device_watermarks", "publish_device_watermarks",
           "record_bucket_bytes", "health_memory_section",
           "drift_report", "render_drift", "calibration_blob",
           "save_calibration", "dump_store", "load_store",
           "audit_donation", "render_audit",
           "MemoryBudgetError", "preflight", "is_oom", "oom_context",
           "bench_memory_blob", "MEM_CALIBRATION_KIND"]

MEM_CALIBRATION_KIND = "paddle_tpu.mem_calibration"
GiB = float(1 << 30)
MiB = float(1 << 20)

# the label prefix of a whole program's row in the store
PROGRAM_PREFIX = "program["

_lock = threading.Lock()
# label -> {"static_peak_bytes", "static_peak_op", "top_buffers",
#   "pool_bytes", "first"}: the drift join's two sides, keyed like the
# executor's graph_* gauges (a program's row under "program[...]")
_segments = {}
# serving engine label -> {bucket: graph pool bytes its warmup
# captures added}
_bucket_bytes = {}


def _reg():
    return registry_mod.get_registry()


def _seg_gauge(name, help_text):
    return _reg().gauge(name, help_text, labelnames=("segment",))


# ---------------------------------------------------------------------------
# static timeline
# ---------------------------------------------------------------------------

def _bf16_act_now():
    from ..utils import flags

    return bool(flags.get_flag("amp_bf16")
                and flags.get_flag("amp_bf16_act"))


def _byte_policies(bd, bf16_act=None):
    """(activation_bytes, persistable_bytes) name->bytes policies over
    one block's VarDescs: activations at AMP element sizes (dynamic
    dims count 1, a floor, as in S005), persistables at full storage
    size (masters stay f32)."""
    from ..fluid import analysis as fluid_analysis

    if bf16_act is None:
        bf16_act = _bf16_act_now()

    def act_bytes(name):
        vd = bd.vars.get(name)
        if vd is None or vd.persistable or vd.shape is None:
            return 0
        return fluid_analysis._numel(vd.shape) * \
            fluid_analysis._elem_bytes(str(vd.dtype), False, bf16_act)

    def persist_bytes(name):
        vd = bd.vars.get(name)
        if vd is None or not vd.persistable or vd.shape is None:
            return 0
        return fluid_analysis._numel(vd.shape) * \
            fluid_analysis._elem_bytes(str(vd.dtype), True, bf16_act)

    return act_bytes, persist_bytes


def program_timeline(program, fetches=None, top_n=8, bf16_act=None):
    """The static memory timeline of a Program's block 0: per-op live
    activation bytes (the liveness series), the constant params+state
    floor, and the top-N buffers resident at the peak blamed to their
    defining ops.  A walk of the IR; no device is touched."""
    from ..analysis.dataflow import liveness_timeline

    desc = getattr(program, "desc", program)
    bd = desc.block(0)
    act_bytes, persist_bytes = _byte_policies(bd, bf16_act)
    final_live = {n for n, vd in bd.vars.items() if vd.persistable}
    final_live |= set(fetches or ())
    tl = liveness_timeline(bd.ops, act_bytes, final_live, top_n=top_n)
    params = sum(persist_bytes(n) for n in bd.vars)
    peak_op = tl["peak_op"]
    return {
        "kind": "paddle_tpu.mem_timeline",
        "version": 1,
        "ops": len(bd.ops),
        "op_types": [od.type for od in bd.ops],
        "series": tl["series"],
        "peak_bytes": int(tl["peak_bytes"]),
        "peak_op": peak_op,
        "peak_op_type": (bd.ops[peak_op].type
                         if peak_op is not None else None),
        "params_bytes": int(params),
        "total_peak_bytes": int(params + tl["peak_bytes"]),
        "top_buffers": tl["top_buffers"],
    }


def segment_static_peak(op_descs, outputs, block_desc, top_n=5,
                        bf16_act=None):
    """Static live-activation peak over one executor segment's ops, with
    the segment's outputs as the final live set: the comparand of the
    pool bytes its capture adds (its inputs live outside the walk, as
    feeds do)."""
    from ..analysis.dataflow import liveness_timeline

    act_bytes, _ = _byte_policies(block_desc, bf16_act)
    return liveness_timeline(op_descs, act_bytes, set(outputs or ()),
                             top_n=top_n)


def render_timeline(tl, width=48, max_rows=64):
    """ASCII render of a timeline: one bar per op (downsampled past
    `max_rows`), the peak row marked, then the blamed top buffers."""
    lines = ["memory timeline: %d op(s), params+state %.1f MiB, "
             "activation peak %.1f MiB at op %s (%s), total peak "
             "%.1f MiB"
             % (tl["ops"], tl["params_bytes"] / MiB,
                tl["peak_bytes"] / MiB, tl["peak_op"],
                tl["peak_op_type"], tl["total_peak_bytes"] / MiB)]
    series = tl["series"]
    if series:
        peak = max(max(series), 1)
        n = len(series)
        stride = max(1, -(-n // int(max_rows)))
        for start in range(0, n, stride):
            chunk = series[start:start + stride]
            val = max(chunk)
            bar = "#" * max(1, int(round(val / peak * width))) \
                if val else ""
            marker = " <- peak" if (tl["peak_op"] is not None
                                    and start <= tl["peak_op"]
                                    < start + stride) else ""
            label = ("op %d" % start if stride == 1
                     else "op %d-%d" % (start, start + len(chunk) - 1))
            lines.append("  %-12s %8.1f MiB |%-*s|%s"
                         % (label, val / MiB, width, bar, marker))
    if tl["top_buffers"]:
        lines.append("top buffers live at the peak:")
        for b in tl["top_buffers"]:
            lines.append("  %-44s %10.2f MiB  def op %-4s %s"
                         % (b["name"], b["bytes"] / MiB,
                            b["def_op"], b["def_op_type"] or "-"))
    return "\n".join(lines)


def timeline_chrome_trace(tl, path=None, name="mem_live_bytes"):
    """The timeline as a Chrome trace-event counter track ("ph": "C")
    plus one span per op, co-loadable with the obs.trace and obs.perf
    exports in Perfetto.  The timebase is synthetic: one µs per op
    index (a static walk has no clock)."""
    evs = [{"name": "process_name", "ph": "M", "pid": 3, "tid": 0,
            "args": {"name": "paddle_tpu_torch.obs.mem (static, "
                             "1us/op)"}}]
    for i, val in enumerate(tl["series"]):
        evs.append({"name": name, "cat": "mem", "ph": "C", "pid": 3,
                    "tid": 1, "ts": float(i),
                    "args": {"live_bytes": int(val)}})
        evs.append({"name": tl["op_types"][i], "cat": "mem", "ph": "X",
                    "pid": 3, "tid": 1, "ts": float(i), "dur": 1.0,
                    "args": {"op_index": i, "live_bytes": int(val)}})
    doc = {"traceEvents": evs, "displayTimeUnit": "ms",
           "otherData": {"producer": "paddle_tpu_torch.obs.mem",
                         "peak_bytes": int(tl["peak_bytes"]),
                         "peak_op": tl["peak_op"],
                         "params_bytes": int(tl["params_bytes"])}}
    if path:
        tmp = str(path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, str(path))
    return doc


# ---------------------------------------------------------------------------
# actuals (executor wiring)
# ---------------------------------------------------------------------------

def register_segment_static(segment, op_descs, outputs, block_desc):
    """Executor hook at plan time: record a captured segment's (or,
    under a "program[...]" label, a whole program's) static activation
    peak and blamed buffers, and publish
    `mem_static_peak_bytes{segment=}`.  The `on_compile_captured` calls
    for the same label complete the drift join."""
    tl = segment_static_peak(op_descs, outputs, block_desc)
    entry = {"static_peak_bytes": int(tl["peak_bytes"]),
             "static_peak_op": tl["peak_op"],
             "top_buffers": tl["top_buffers"],
             "captured_at": time.time()}
    with _lock:
        _segments.setdefault(segment, {}).update(entry)
    _seg_gauge("mem_static_peak_bytes",
               "static liveness activation-peak bytes per captured "
               "segment and program (obs.mem)") \
        .labels(segment=segment).set(entry["static_peak_bytes"])
    return entry


def on_compile_captured(segment, published, first=None):
    """obs.health hook: `published` is publish_compile_stats' dict for
    one capture (or the executor's sum over a program's captures).
    Stores its `graph_pool_bytes` as the actual side of the drift join,
    publishes `mem_pool_bytes{segment=}` and, when the static side is
    registered, `mem_estimate_ratio{segment=}` (actual / static).
    `first`: whether this capture was the first into its pool.  Nothing
    is stored when no pool bytes were published (a capture on the CPU
    holds no pool)."""
    pool = (published or {}).get("graph_pool_bytes")
    if pool is None:
        return None
    pool = int(pool)
    with _lock:
        entry = _segments.setdefault(segment, {})
        entry["pool_bytes"] = pool
        if first is not None:
            entry["first"] = bool(first)
        entry["captured_at"] = time.time()
        static = entry.get("static_peak_bytes")
    _seg_gauge("mem_pool_bytes",
               "CUDA graph pool bytes each captured segment's capture "
               "added (a program's row: the sum over its captures)") \
        .labels(segment=segment).set(pool)
    if static:
        _seg_gauge("mem_estimate_ratio",
                   "pool bytes / static liveness-peak estimate per "
                   "segment and program (1.0 = the static model is "
                   "exact)") \
            .labels(segment=segment).set(round(pool / static, 6))
    publish_device_watermarks()
    return pool


_SEG_GAUGES = ("mem_static_peak_bytes", "mem_pool_bytes",
               "mem_estimate_ratio")


def retire_segments(labels):
    """Drop the per-segment mem_* gauge children and store entries of
    retired labels (the executor's program-cache eviction): a
    long-lived serving process must not accumulate dead labels."""
    reg = _reg()
    with _lock:
        for label in labels:
            _segments.pop(label, None)
    for name in _SEG_GAUGES:
        fam = reg.gauge(name, labelnames=("segment",))
        for label in labels:
            fam.remove(segment=label)


def segments():
    """Snapshot of the store (static and actual sides)."""
    with _lock:
        return {k: dict(v) for k, v in _segments.items()}


def xla_program_bytes_total():
    """The pool bytes of every captured segment in the store (the JAX
    name, whose store holds XLA temp+output bytes): the serving
    warmup's per-bucket base."""
    with _lock:
        return sum(int(v.get("pool_bytes", 0))
                   for k, v in _segments.items()
                   if not k.startswith(PROGRAM_PREFIX))


def reset():
    """Clear the store (test isolation; gauges reset with the
    registry)."""
    with _lock:
        _segments.clear()
        _bucket_bytes.clear()


def device_watermarks():
    """{device: {"bytes_in_use", "peak_bytes_in_use", "bytes_limit",
    "reserved_bytes"}} of every CUDA device this process has touched,
    from `torch.cuda.memory_stats`.  None on the CPU, as the JAX CPU
    backend reports none."""
    out = {}
    try:
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return {}
        for idx in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(idx)
            if not stats:
                continue
            out["cuda:%d" % idx] = {
                "bytes_in_use": int(stats.get(
                    "allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(
                    torch.cuda.max_memory_allocated(idx)),
                "reserved_bytes": int(stats.get(
                    "reserved_bytes.all.current", 0)),
                "bytes_limit": int(
                    torch.cuda.get_device_properties(idx).total_memory),
            }
    except Exception:
        return {}
    return out


def publish_device_watermarks():
    """Publish the watermarks as `mem_device_*{device=}` gauges; returns
    the dict (empty on the CPU)."""
    marks = device_watermarks()
    if not marks:
        return marks
    reg = _reg()
    for dev, stats in marks.items():
        reg.gauge("mem_device_bytes_in_use",
                  "device allocator live bytes",
                  labelnames=("device",)) \
            .labels(device=dev).set(stats["bytes_in_use"])
        reg.gauge("mem_device_peak_bytes",
                  "device allocator peak live bytes (high watermark)",
                  labelnames=("device",)) \
            .labels(device=dev).set(stats["peak_bytes_in_use"])
    return marks


def record_bucket_bytes(bucket, nbytes, engine=""):
    """Serving warmup hook: the graph pool bytes one batch bucket's
    warmup captures added, as `mem_bucket_pool_bytes{engine=,bucket=}`
    (the /healthz "memory" section of `engine`'s server reads them
    back).  Each engine has its own rows (`InferenceEngine.mem_label`),
    so two engines in one process never overwrite each other's.  A
    bucket whose captures fit in memory its engine's graph pool already
    held reads 0."""
    nbytes = max(0, int(nbytes))
    engine = str(engine)
    with _lock:
        _bucket_bytes.setdefault(engine, {})[str(bucket)] = nbytes
    _reg().gauge("mem_bucket_pool_bytes",
                 "CUDA graph pool bytes each serving batch bucket's "
                 "warmup captures added",
                 labelnames=("engine", "bucket")) \
        .labels(engine=engine, bucket=bucket).set(nbytes)
    return nbytes


def health_memory_section(engine=""):
    """The serving /healthz "memory" block: `engine`'s per-bucket pool
    bytes and the device watermarks.  None when neither exists (nothing
    captured, the CPU), so the section stays absent."""
    with _lock:
        buckets = dict(_bucket_bytes.get(str(engine), {}))
    marks = device_watermarks()
    if not buckets and not marks:
        return None
    section = {}
    if buckets:
        section["bucket_pool_bytes"] = buckets
    if marks:
        section["device"] = marks
    return section


# ---------------------------------------------------------------------------
# drift report + calibration feed
# ---------------------------------------------------------------------------

def _median(vals):
    vals = sorted(vals)
    n = len(vals)
    if not n:
        return None
    if n % 2:
        return vals[n // 2]
    return (vals[n // 2 - 1] + vals[n // 2]) / 2.0


def drift_report(store=None):
    """Join static peak and pool bytes per label.  `store` defaults to
    this process's capture (`segments()`); pass a `load_store` dict for
    offline joins.  Labels with only one side are listed under
    "unjoined".  Publishes `mem_estimate_ratio{segment=}` for every
    joined row.  `median_ratio` is over the program rows when there are
    any, else over the segment rows (`basis`);
    `first_segment_median_ratio` is over the segments whose capture
    was the first into their pool."""
    store = segments() if store is None else store
    rows, unjoined = [], []
    for segment in sorted(store):
        e = store[segment]
        static = e.get("static_peak_bytes")
        actual = e.get("pool_bytes")
        scope = "program" if segment.startswith(PROGRAM_PREFIX) \
            else "segment"
        if static and actual is not None:
            ratio = round(actual / static, 6)
            rows.append({"segment": segment, "scope": scope,
                         "first": bool(e.get("first")),
                         "static_peak_bytes": int(static),
                         "pool_bytes": int(actual),
                         "ratio": ratio,
                         "top_buffers": e.get("top_buffers", [])})
            _seg_gauge("mem_estimate_ratio",
                       "pool bytes / static liveness-peak estimate per "
                       "segment and program (1.0 = the static model is "
                       "exact)") \
                .labels(segment=segment).set(ratio)
        else:
            unjoined.append({"segment": segment,
                             "has_static": bool(static),
                             "has_actual": actual is not None})
    program = [r["ratio"] for r in rows
               if r["scope"] == "program" and r["ratio"]]
    segment = [r["ratio"] for r in rows
               if r["scope"] == "segment" and r["ratio"]]
    first = [r["ratio"] for r in rows
             if r["scope"] == "segment" and r["first"] and r["ratio"]]
    basis = "program" if program else "segment"
    ratios = program or segment
    return {"kind": "paddle_tpu.mem_drift", "version": 1,
            "segments": rows, "unjoined": unjoined,
            "n": len(ratios), "median_ratio": _median(ratios),
            "basis": basis,
            "first_segment_median_ratio": _median(first),
            "device": device_watermarks() or None}


def render_drift(report):
    lines = ["memory drift: %d joined row(s), %d unjoined, median "
             "pool/static ratio %s over the %s rows"
             % (len(report["segments"]), len(report["unjoined"]),
                ("%.3f" % report["median_ratio"])
                if report["median_ratio"] else "n/a",
                report.get("basis", "segment"))]
    lines.append("  %-44s %12s %12s %8s"
                 % ("segment", "static MiB", "pool MiB", "ratio"))
    for r in report["segments"]:
        lines.append("  %-44s %12.2f %12.2f %8s%s"
                     % (r["segment"],
                        r["static_peak_bytes"] / MiB,
                        r["pool_bytes"] / MiB,
                        ("%.3f" % r["ratio"]) if r["ratio"] else "-",
                        " first" if r.get("first") else ""))
    for u in report["unjoined"]:
        side = "static only" if u["has_static"] else "actual only"
        lines.append("  %-44s (%s: no join)" % (u["segment"], side))
    if report.get("device"):
        for dev, stats in sorted(report["device"].items()):
            lines.append("  device %s: %.1f MiB in use, peak %.1f MiB"
                         % (dev,
                            stats.get("bytes_in_use", 0) / MiB,
                            stats.get("peak_bytes_in_use", 0) / MiB))
    return "\n".join(lines)


def calibration_blob(report, model=None):
    """The drift report distilled into the blob the tuner consumes
    (`tune.fit.load_hbm_calibration` -> `rank(..., hbm_ratio=)`): the
    median measured pool/static ratio (over the report's `basis` rows)
    scales the static peak before the S005 budget check.  None when
    nothing joined."""
    if not report.get("n"):
        return None
    basis = report.get("basis", "segment")
    return {"kind": MEM_CALIBRATION_KIND, "version": 1,
            "hbm_ratio": report["median_ratio"], "n": report["n"],
            "basis": basis, "model": model,
            "segments": {r["segment"]: r["ratio"]
                         for r in report["segments"]
                         if r["ratio"] and r.get("scope", "segment")
                         == basis}}


def save_calibration(blob, path):
    tmp = str(path) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(blob, f, indent=1, sort_keys=True)
    os.replace(tmp, str(path))
    return str(path)


def dump_store(path):
    """Persist this process's store for an offline `mem_cli drift
    --store` join (atomic write)."""
    doc = {"kind": "paddle_tpu.mem_store", "version": 1,
           "segments": segments(),
           "device": device_watermarks() or None,
           "created_at": time.time()}
    tmp = str(path) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, str(path))
    return str(path)


def load_store(path):
    with open(path) as f:
        doc = json.load(f)
    if doc.get("kind") != "paddle_tpu.mem_store":
        raise ValueError("%s is not a mem_cli store dump (kind=%r)"
                         % (path, doc.get("kind")))
    return doc["segments"]


# ---------------------------------------------------------------------------
# donation audit
# ---------------------------------------------------------------------------

def _full_bytes_of(bd, bf16_act):
    from ..fluid import analysis as fluid_analysis

    def full_bytes(name):
        vd = bd.vars.get(name)
        if vd is None or vd.shape is None:
            return 0
        return fluid_analysis._numel(vd.shape) * \
            fluid_analysis._elem_bytes(str(vd.dtype), True, bf16_act)

    return full_bytes


def audit_donation(program, fetches=(), mode=None):
    """Price the donation plan (`analysis/alias.py`): which parameter and
    optimizer-state buffers the executor's captured segments donate
    under the requested FLAGS_donation mode, and which dead-after-use
    buffers they do not, each cross-linked to the A-code explaining the
    refusal (A001 forked or absent in-place slot, A004 update stranded
    in a host segment; no code under mode=off, where the flag itself is
    the refusal).

    mode: "auto" | "conservative" | "off"; None reads FLAGS_donation.
    Returns {"donated": [...], "reclaimable": [...]} entries with
    name, bytes and op identity; `reclaimable_bytes` is the headline."""
    from ..analysis.alias import analyze_donation

    desc = getattr(program, "desc", program)
    bd = desc.block(0)
    # a static audit: backend_safe None skips the A005 consultation
    plan = analyze_donation(program, fetches=fetches, mode=mode)
    full_bytes = _full_bytes_of(bd, _bf16_act_now())

    def kind_of(name, slot):
        vd = bd.vars.get(name)
        if vd is not None and vd.is_parameter:
            return "param"
        if slot == "ParamOut":
            return "param"
        if vd is not None and vd.persistable:
            return "optimizer_state"
        return "activation"

    donated, reclaimable = [], []
    for e in plan.entries:
        if e["status"] not in ("donated", "reclaimable"):
            continue
        item = {"name": e["name"], "bytes": int(full_bytes(e["name"])),
                "op_index": e["op_index"], "op_type": e["op_type"],
                "slot": e["slot"],
                "kind": kind_of(e["name"], e["slot"])}
        if e["status"] == "donated":
            donated.append(item)
        else:
            item["reason"] = e["reason"]
            if e["code"]:
                item["code"] = e["code"]
            reclaimable.append(item)
    return {
        "kind": "paddle_tpu.mem_donation_audit", "version": 2,
        "ops": len(bd.ops), "jit_segments": sum(
            1 for s in plan.segments if s["jit"]),
        "mode": plan.mode,
        "effective_mode": plan.effective_mode,
        "widened": sorted(n for s in plan.segments
                          for n in s["widened"]),
        "donated": donated,
        "donated_bytes": sum(d["bytes"] for d in donated),
        "reclaimable": reclaimable,
        "reclaimable_bytes": sum(r["bytes"] for r in reclaimable),
    }


def render_audit(audit):
    lines = ["donation audit: %d op(s) in %d captured segment(s); "
             "%d buffer(s) donated (%.1f MiB), %d reclaimable "
             "(%.1f MiB)"
             % (audit["ops"], audit["jit_segments"],
                len(audit["donated"]), audit["donated_bytes"] / MiB,
                len(audit["reclaimable"]),
                audit["reclaimable_bytes"] / MiB)]
    for r in audit["reclaimable"]:
        lines.append("  RECLAIM %-36s %10.2f MiB  [%s] op %d %s/%s"
                     % (r["name"], r["bytes"] / MiB, r["kind"],
                        r["op_index"], r["op_type"], r["slot"]))
        lines.append("          %s%s"
                     % (("%s: " % r["code"]) if r.get("code") else "",
                        r["reason"]))
    if not audit["reclaimable"]:
        lines.append("  every dead-after-use param/state buffer is "
                     "donated - nothing to reclaim")
    return "\n".join(lines)


def bench_donation_blob(program, fetches=()):
    """A bench record's `donation` blob: the plan's verdict in bytes:
    planned (everything provably donatable), donated (what the
    effective mode donates, widened buffers included) and declined
    (refusals, by A-code)."""
    from ..analysis.alias import analyze_donation

    desc = getattr(program, "desc", program)
    bd = desc.block(0)
    plan = analyze_donation(program, fetches=fetches)
    full_bytes = _full_bytes_of(bd, _bf16_act_now())

    donated = declined = 0
    declined_by_code = {}
    for e in plan.entries:
        if e["status"] == "donated":
            donated += full_bytes(e["name"])
        elif e["status"] == "reclaimable":
            b = full_bytes(e["name"])
            declined += b
            code = e["code"] or "off"
            declined_by_code[code] = declined_by_code.get(code, 0) + b
    for s in plan.segments:
        for n in s["widened"]:
            b = full_bytes(n)
            if plan.effective_mode == "auto":
                donated += b
            else:
                declined += b
                declined_by_code[plan.effective_mode] = \
                    declined_by_code.get(plan.effective_mode, 0) + b
        for d in s["declined"]:
            b = full_bytes(d["name"])
            declined += b
            declined_by_code[d["code"]] = \
                declined_by_code.get(d["code"], 0) + b
    return {
        "mode": plan.mode,
        "effective_mode": plan.effective_mode,
        "fingerprint": plan.fingerprint(),
        "planned_bytes": int(donated + declined),
        "donated_bytes": int(donated),
        "declined_bytes": int(declined),
        "declined_by_code": {k: int(v) for k, v in
                             sorted(declined_by_code.items())},
    }


# ---------------------------------------------------------------------------
# OOM pre-flight + post-mortem
# ---------------------------------------------------------------------------

class MemoryBudgetError(MemoryError):
    """Raised by the pre-flight check (`FLAGS_mem_budget_gb`) before a
    program's first eager run or capture.  Carries `.timeline`, so the
    flight-bundle context never recomputes the walk."""

    def __init__(self, message, timeline=None, budget_gb=None):
        super().__init__(message)
        self.timeline = timeline
        self.budget_gb = budget_gb


def preflight(program, fetches, budget_gb):
    """Refuse a program whose static total peak (params, optimizer
    state and the liveness activation peak) exceeds `budget_gb` GiB.
    The message names the top blamed buffers, the table a real OOM's
    flight bundle carries."""
    tl = program_timeline(program, fetches=fetches, top_n=8)
    total = tl["total_peak_bytes"]
    budget = float(budget_gb) * GiB
    if total <= budget:
        return tl
    top = "; ".join("%s %.1f MiB (op %s %s)"
                    % (b["name"], b["bytes"] / MiB, b["def_op"],
                       b["def_op_type"])
                    for b in tl["top_buffers"][:3])
    raise MemoryBudgetError(
        "RESOURCE_EXHAUSTED (pre-flight): static peak memory %.3f GiB "
        "(params+state %.3f + activation peak %.3f at op %s %s) "
        "exceeds FLAGS_mem_budget_gb=%.3g%s"
        % (total / GiB, tl["params_bytes"] / GiB,
           tl["peak_bytes"] / GiB, tl["peak_op"], tl["peak_op_type"],
           float(budget_gb),
           "" if not top else "; top resident: " + top),
        timeline=tl, budget_gb=float(budget_gb))


def is_oom(exc):
    """True for the card's out-of-memory errors
    (`torch.cuda.OutOfMemoryError`, "CUDA out of memory"), any
    MemoryError (the pre-flight's MemoryBudgetError among them) and the
    JAX package's RESOURCE_EXHAUSTED: the class whose flight bundles
    carry the blamed-buffer table."""
    if isinstance(exc, MemoryError):
        return True
    try:
        import torch

        oom_type = getattr(torch.cuda, "OutOfMemoryError", None)
        if oom_type is not None and isinstance(exc, oom_type):
            return True
    except Exception:
        pass
    text = str(exc)
    return "RESOURCE_EXHAUSTED" in text or "CUDA out of memory" in text


def oom_context(exc, program=None, fetches=None):
    """Flight-bundle context for an OOM-class exception, `{}` for
    anything else (the executor splats it into `on_crash`).  The "oom"
    note carries the static timeline's top blamed buffers, the last
    mem_* and graph_* gauges and the device watermarks."""
    if not is_oom(exc):
        return {}
    tl = getattr(exc, "timeline", None)
    # the executor marks a device OOM with the program that ran (the
    # pass-rewritten clone), so the blame table matches what ran
    program = getattr(exc, "_mem_program", None) or program
    if tl is None and program is not None:
        try:
            tl = program_timeline(program, fetches=fetches, top_n=8)
        except Exception:
            tl = None
    gauges = {k: v for k, v in telemetry_mod.snapshot().items()
              if k.startswith(("mem_", "graph_"))}
    oom = {"reason": "resource_exhausted"}
    if tl is not None:
        oom.update({
            "static_peak_bytes": tl["peak_bytes"],
            "params_bytes": tl["params_bytes"],
            "total_peak_bytes": tl["total_peak_bytes"],
            "peak_op": tl["peak_op"],
            "peak_op_type": tl["peak_op_type"],
            "top_buffers": tl["top_buffers"],
        })
    if gauges:
        oom["mem_gauges"] = gauges
    marks = device_watermarks()
    if marks:
        oom["device"] = marks
    return {"oom": oom}


# ---------------------------------------------------------------------------
# bench blob
# ---------------------------------------------------------------------------

def bench_memory_blob(program, fetches=(), pool_stats=None):
    """A bench record's "memory" blob for one leg: the static peak, the
    graph pool bytes the leg's captures added (`pool_stats`
    {"pool_bytes"}), the device watermark, and the estimate ratio: pool
    bytes / static activation peak (the pool holds activations and
    outputs, the scope the parameters), the actual/static direction of
    `mem_estimate_ratio` and the calibration blob."""
    tl = program_timeline(program, fetches=fetches, top_n=3)
    blob = {
        "static_peak_bytes": tl["total_peak_bytes"],
        "activation_peak_bytes": tl["peak_bytes"],
        "params_bytes": tl["params_bytes"],
        "top_buffers": tl["top_buffers"],
    }
    pool = (pool_stats or {}).get("pool_bytes")
    if pool:
        blob["pool_bytes"] = int(pool)
        if blob["activation_peak_bytes"]:
            blob["estimate_ratio"] = round(
                int(pool) / blob["activation_peak_bytes"], 4)
    marks = device_watermarks()
    if marks:
        blob["device_peak_bytes"] = max(
            s.get("peak_bytes_in_use", 0) for s in marks.values())
    return blob
