"""Load generation & traffic replay for the serving stack.

Counterpart of paddle_tpu/obs/load.py: it drives an `InferenceServer`
with a controlled arrival process and turns the observability the
serving layer already emits (slo_burn_rate, per-bucket exemplars,
/debug/tail span trees, JSONL access logs) into a pass/fail latency
verdict.  The schedules come from Python's `random.Random(seed)` as in
the JAX module, so one seed gives the same schedule in both packages,
and an access log written by either package's server replays in the
other.

Two generator disciplines, because they answer different questions:

  * **open loop** — requests fire on a precomputed schedule
    (Poisson or deterministic inter-arrivals) REGARDLESS of how many
    are still in flight, and latency is measured from each request's
    *scheduled* send time.  When the server stalls, the backlog of
    scheduled-but-unanswered requests keeps accruing latency, so the
    stall lands in the percentiles.  This is the coordinated-omission
    -safe discipline: it models independent users who do not politely
    wait for each other.
  * **closed loop** — N workers issue, wait, think, repeat.  During a
    server stall the workers are themselves blocked, so the generator
    silently stops offering load and only the in-flight requests
    observe the stall: the classic coordinated-omission trap.  Closed
    loop is still the right model for batch clients and for measuring
    sustainable throughput — the harness offers both precisely so the
    gap between their p99s is visible instead of implicit.

Traffic is a declarative mix (weighted shape buckets + burst phases +
ramp) or a **replay** of a server access-log JSONL
(`ServerConfig.access_log` lines) with original inter-arrival gaps and
a speed multiplier.  Every request carries a freshly minted W3C
traceparent, so the report can join its worst requests to the
server's `/debug/tail` span trees and `/metrics` exemplars by
request_id / trace_id — one command from "p99 is bad" to the span
tree that explains it.

`latency_blob(report)` distills a run into the `latency` blob
`perf.normalize_record` passes into perf_history.jsonl, where
`gate_history(latency_tolerance=)` / `pperf gate --latency-tolerance`
turns tail-latency regressions into CI failures (same-key discipline
as the mem/comm gates).

`python -m paddle_tpu_torch.tools.load_cli --selftest` certifies the
whole loop, including the omission-safety claim itself: an injected
engine stall must inflate the open-loop p99 while the closed-loop p99
hides it.

`build_tiny_engine` and `run_serving_bench` build on the card unless
given `place=CPUPlace()`; the bench record names its platform from the
engine's place (`perf.platform_of`).
"""

import json
import math
import random
import re
import threading
import time

from . import context as obs_context
from . import registry as obs_registry

__all__ = [
    "TrafficMix", "parse_phases", "rate_at", "build_schedule",
    "load_access_log", "replay_schedule", "HttpTarget",
    "LoopbackTarget", "vector_payload", "run_open_loop",
    "run_closed_loop", "build_report", "percentile", "latency_blob",
    "join_tail", "parse_exemplars", "join_exemplars", "format_report",
    "build_tiny_engine", "run_serving_bench",
]

# client-side failure pseudo-status (connection refused/reset/timeout):
# kept numeric so it aggregates next to real HTTP statuses
CLIENT_ERROR_STATUS = 599


# ---------------------------------------------------------------------------
# traffic mix
# ---------------------------------------------------------------------------

class TrafficMix:
    """A weighted batch-size (shape-bucket) distribution.

    `weights` maps batch size -> relative weight.  The spec syntax is
    `"1:6,4:3,8:1"`; bare sizes (`"1,4,8"`) weigh equally."""

    def __init__(self, weights):
        if not weights:
            raise ValueError("traffic mix needs at least one bucket")
        self.weights = {}
        for batch, w in sorted(dict(weights).items()):
            batch, w = int(batch), float(w)
            if batch <= 0 or w <= 0:
                raise ValueError(
                    "mix entries need positive batch and weight; got "
                    "%r:%r" % (batch, w))
            self.weights[batch] = w
        self._batches = list(self.weights)
        self._cum = []
        total = 0.0
        for b in self._batches:
            total += self.weights[b]
            self._cum.append(total)
        self._total = total

    @classmethod
    def parse(cls, spec):
        weights = {}
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            if ":" in part:
                batch, w = part.split(":", 1)
            else:
                batch, w = part, 1.0
            weights[int(batch)] = float(w)
        return cls(weights)

    def sample(self, rng):
        x = rng.random() * self._total
        for batch, cum in zip(self._batches, self._cum):
            if x <= cum:
                return batch
        return self._batches[-1]

    def fractions(self):
        return {b: w / self._total for b, w in self.weights.items()}


# ---------------------------------------------------------------------------
# arrival schedules (open loop + replay)
# ---------------------------------------------------------------------------

def parse_phases(spec):
    """`"5:400,6:100"` -> [(5.0, 400.0), (6.0, 100.0)]: from t=5s the
    offered rate becomes 400 req/s, from t=6s it drops to 100 (burst
    phases for the declarative profile)."""
    if not spec:
        return []
    phases = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        t, rate = part.split(":", 1)
        phases.append((float(t), float(rate)))
    return sorted(phases)


def rate_at(t, rate, phases=(), ramp_s=0.0):
    """The offered rate at offset `t`: the base `rate` overridden by
    the newest phase whose start <= t, scaled by the initial linear
    ramp (a ramp must never zero the rate: it floors at 5%)."""
    r = float(rate)
    for start, phase_rate in phases or ():
        if t >= start:
            r = float(phase_rate)
    if ramp_s and t < ramp_s:
        r *= max(0.05, t / float(ramp_s))
    return r


def build_schedule(rate, n=None, duration_s=None, arrival="poisson",
                   mix=None, seed=0, phases=(), ramp_s=0.0):
    """The open-loop arrival schedule: a list of `(offset_s, batch)`
    pairs, fixed BEFORE the run starts — the schedule never reacts to
    the server, which is the whole point.  `arrival="poisson"` draws
    exponential gaps from the (phase/ramp-modulated) rate;
    `"uniform"` spaces deterministically at 1/rate.  Deterministic
    under `seed`."""
    if n is None and duration_s is None:
        raise ValueError("build_schedule needs n or duration_s")
    if arrival not in ("poisson", "uniform"):
        raise ValueError("arrival must be poisson or uniform; got %r"
                         % (arrival,))
    rng = random.Random(seed)
    mix = mix or TrafficMix({1: 1.0})
    schedule = []
    t = 0.0
    while True:
        if n is not None and len(schedule) >= int(n):
            break
        if duration_s is not None and t > float(duration_s):
            break
        schedule.append((t, mix.sample(rng)))
        r = rate_at(t, rate, phases=phases, ramp_s=ramp_s)
        if r <= 0:
            raise ValueError("offered rate fell to %r at t=%.3fs" % (r, t))
        gap = rng.expovariate(r) if arrival == "poisson" else 1.0 / r
        t += gap
    return schedule


def load_access_log(path):
    """Parse a server access-log JSONL (ServerConfig.access_log lines:
    t / request_id / trace_id / status / latency_ms / batch / bucket).
    Unparsable or t-less lines are skipped — a torn append must not
    wedge a replay."""
    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict) or rec.get("t") is None:
                continue
            entries.append(rec)
    entries.sort(key=lambda r: r["t"])
    return entries


def replay_schedule(entries, speed=1.0):
    """Access-log entries -> an open-loop schedule preserving the
    original inter-arrival gaps, compressed/stretched by `speed`
    (speed=2 plays the trace twice as fast)."""
    if not entries:
        return []
    if speed <= 0:
        raise ValueError("speed must be > 0; got %r" % (speed,))
    t0 = float(entries[0]["t"])
    return [((float(e["t"]) - t0) / float(speed),
             max(1, int(e.get("batch") or 1))) for e in entries]


# ---------------------------------------------------------------------------
# targets + payloads
# ---------------------------------------------------------------------------

def vector_payload(feed, dim, timeout_ms=None, fill=0.5):
    """Payload builder for a flat dense feed: batch -> the /v1/infer
    body `{"inputs": {feed: [[fill]*dim]*batch}}`."""
    def build(batch):
        payload = {"inputs": {feed: [[fill] * int(dim)] * int(batch)}}
        if timeout_ms is not None:
            payload["timeout_ms"] = timeout_ms
        return payload
    return build


class HttpTarget:
    """POSTs to a live server, one keep-alive connection per harness
    thread.  Transport failures answer CLIENT_ERROR_STATUS instead of
    raising — a dead server is a measurement, not a crash."""

    def __init__(self, url, path="/v1/infer", timeout_s=30.0):
        from urllib.parse import urlsplit

        parts = urlsplit(url if "//" in url else "http://" + url)
        self.host = parts.hostname or "127.0.0.1"
        self.port = parts.port or 80
        self.path = parts.path if parts.path not in ("", "/") else path
        self.timeout_s = float(timeout_s)
        self._tls = threading.local()

    def _conn(self):
        import http.client

        conn = getattr(self._tls, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout_s)
            self._tls.conn = conn
        return conn

    def _drop_conn(self):
        conn = getattr(self._tls, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
            self._tls.conn = None

    def get(self, path):
        """GET a JSON endpoint (/debug/tail, /healthz) or text
        (/metrics) on the same host — the report-join side channel."""
        conn = self._conn()
        try:
            headers = {}
            if path == "/metrics":
                # exemplars render only under OpenMetrics negotiation
                headers["Accept"] = "application/openmetrics-text"
            conn.request("GET", path, headers=headers)
            resp = conn.getresponse()
            data = resp.read().decode("utf-8", "replace")
        except OSError:
            self._drop_conn()
            raise
        try:
            return json.loads(data)
        except ValueError:
            return data

    def infer(self, payload, ctx, timeout_s=None):
        import http.client

        body = json.dumps(payload)
        headers = {"Content-Type": "application/json",
                   "traceparent": ctx.traceparent()}
        # one retry on a FRESH connection: a kept-alive connection the
        # server already closed fails the first reuse, which is a
        # client artifact, not a server measurement
        for attempt in (0, 1):
            conn = self._conn()
            try:
                conn.request("POST", self.path, body, headers)
                resp = conn.getresponse()
                data = resp.read()
                reply_headers = dict(resp.getheaders())
                break
            except (OSError, http.client.HTTPException) as exc:
                self._drop_conn()
                if attempt:
                    return CLIENT_ERROR_STATUS, {"error": repr(exc)}, {}
        try:
            parsed = json.loads(data)
        except ValueError:
            parsed = {"error": data[:200].decode("utf-8", "replace")}
        return resp.status, parsed, reply_headers


class LoopbackTarget:
    """Drives an in-process `InferenceServer` through the same
    `handle_infer` the HTTP handler calls — no sockets, same
    measurement path (tests + the bench leg)."""

    def __init__(self, server):
        self.server = server

    def get(self, path):
        if path == "/debug/tail":
            return self.server.tail.to_dict()
        if path == "/healthz":
            return self.server.health_signals()
        if path == "/metrics":
            return self.server.metrics.render_text(exemplars=True)
        raise ValueError("unknown loopback path %r" % (path,))

    def infer(self, payload, ctx, timeout_s=None):
        status, body = self.server.handle_infer(payload, ctx=ctx)
        headers = {}
        if status == 429:
            headers["Retry-After"] = "%d" % max(
                1, int(math.ceil(self.server.config.retry_after_s)))
        return status, body, headers


# ---------------------------------------------------------------------------
# registry instruments
# ---------------------------------------------------------------------------

class _Instruments:
    """The harness's own registry metrics — same registry surface the
    server exposes, so a scrape of the load box tells the same story
    as the report."""

    def __init__(self, registry=None):
        reg = registry or obs_registry.get_registry()
        self.latency = reg.histogram(
            "load_latency_seconds",
            help_text="harness-observed request latency (open loop: "
                      "from the scheduled send time)",
            labelnames=("bucket", "status"))
        self.inflight = reg.gauge(
            "load_inflight", "requests the harness has in flight")
        self.offered = reg.gauge(
            "load_offered_rps",
            "offered arrival rate of the last run (open loop)")
        self.achieved = reg.gauge(
            "load_achieved_rps", "achieved completion rate of the "
                                 "last run")
        self._inflight_lock = threading.Lock()
        self._inflight_n = 0

    def enter(self):
        with self._inflight_lock:
            self._inflight_n += 1
            self.inflight.set(self._inflight_n)

    def leave(self):
        with self._inflight_lock:
            self._inflight_n -= 1
            self.inflight.set(self._inflight_n)


def _fire(target, payload_fn, batch, instruments, scheduled_at=None,
          timeout_s=None):
    """One request: mint a context, send, measure.  `scheduled_at`
    (a perf_counter stamp) switches latency accounting to open-loop
    semantics — measured from when the request SHOULD have left, so
    generator/server backlog counts against the percentiles."""
    ctx = obs_context.TraceContext()
    payload = payload_fn(batch)
    instruments.enter()
    sent = time.perf_counter()
    try:
        status, body, headers = target.infer(payload, ctx,
                                             timeout_s=timeout_s)
    finally:
        instruments.leave()
    done = time.perf_counter()
    origin = sent if scheduled_at is None else scheduled_at
    latency_ms = (done - origin) * 1e3
    service_ms = (done - sent) * 1e3
    bucket = "b%d" % batch
    instruments.latency.labels(bucket=bucket, status=str(status)) \
        .observe((done - origin), exemplar={"trace_id": ctx.trace_id})
    sample = {
        "batch": batch,
        "bucket": bucket,
        "status": int(status),
        "latency_ms": round(latency_ms, 3),
        "service_ms": round(service_ms, 3),
        "trace_id": ctx.trace_id,
        "request_id": (body or {}).get("request_id") or ctx.request_id,
    }
    retry_after = (headers or {}).get("Retry-After")
    if retry_after is not None:
        sample["retry_after"] = retry_after
    return sample


# ---------------------------------------------------------------------------
# the two loops
# ---------------------------------------------------------------------------

def run_open_loop(target, schedule, payload_fn, slo_ms=None,
                  max_inflight=32, registry=None, timeout_s=None):
    """Fire the precomputed `schedule` (build_schedule /
    replay_schedule output).  A pool of `max_inflight` senders pulls
    arrivals in order and sleeps until each one's offset; latency is
    measured from the scheduled offset, so a stalled server (or an
    exhausted sender pool) inflates the recorded tail instead of
    silently throttling the generator."""
    if not schedule:
        raise ValueError("empty schedule")
    instruments = _Instruments(registry)
    samples = [None] * len(schedule)
    cursor = {"i": 0}
    lock = threading.Lock()
    t0 = time.perf_counter()

    def sender():
        while True:
            with lock:
                i = cursor["i"]
                if i >= len(schedule):
                    return
                cursor["i"] = i + 1
            offset, batch = schedule[i]
            delay = t0 + offset - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            samples[i] = _fire(target, payload_fn, batch, instruments,
                               scheduled_at=t0 + offset,
                               timeout_s=timeout_s)

    n_threads = max(1, min(int(max_inflight), len(schedule)))
    threads = [threading.Thread(target=sender, name="pload-open-%d" % i,
                                daemon=True) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    span = schedule[-1][0]
    offered = len(schedule) / span if span > 0 else len(schedule) / wall_s
    instruments.offered.set(round(offered, 3))
    report = build_report(samples, mode="open", wall_s=wall_s,
                          slo_ms=slo_ms, offered_rps=offered)
    instruments.achieved.set(report["achieved_rps"])
    return report


def run_closed_loop(target, payload_fn, workers=4, n=None,
                    duration_s=None, think_ms=0.0, mix=None, seed=0,
                    slo_ms=None, honor_retry_after=True, registry=None,
                    timeout_s=None):
    """N workers in issue -> wait -> think loops.  Latency is measured
    from the actual send (there IS no schedule), which is exactly the
    coordinated-omission-prone discipline — kept on purpose, for
    comparison against the open loop and for sustainable-throughput
    measurements.  A 429 whose reply carries `Retry-After` backs the
    worker off for that long (capped at 5 s) before its next issue."""
    if n is None and duration_s is None:
        raise ValueError("run_closed_loop needs n or duration_s")
    instruments = _Instruments(registry)
    mix = mix or TrafficMix({1: 1.0})
    samples = []
    issued = {"n": 0}
    lock = threading.Lock()
    t0 = time.perf_counter()

    def worker(w):
        rng = random.Random((seed + 1) * 7919 + w)
        while True:
            if duration_s is not None and \
                    time.perf_counter() - t0 >= float(duration_s):
                return
            with lock:
                if n is not None and issued["n"] >= int(n):
                    return
                issued["n"] += 1
            sample = _fire(target, payload_fn, mix.sample(rng),
                           instruments, timeout_s=timeout_s)
            with lock:
                samples.append(sample)
            if honor_retry_after and sample["status"] == 429 \
                    and sample.get("retry_after"):
                try:
                    backoff = min(5.0, float(sample["retry_after"]))
                except ValueError:
                    backoff = 1.0
                time.sleep(backoff)
            elif think_ms:
                time.sleep(float(think_ms) / 1e3)

    threads = [threading.Thread(target=worker, args=(w,),
                                name="pload-closed-%d" % w, daemon=True)
               for w in range(int(workers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    report = build_report(samples, mode="closed", wall_s=wall_s,
                          slo_ms=slo_ms)
    instruments.achieved.set(report["achieved_rps"])
    return report


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def percentile(sorted_vals, p):
    """Nearest-rank percentile over an ASCENDING-sorted list (p in
    (0, 100]); None when empty."""
    if not sorted_vals:
        return None
    rank = max(1, int(math.ceil(p / 100.0 * len(sorted_vals))))
    return sorted_vals[rank - 1]


_PCTS = (("p50_ms", 50.0), ("p90_ms", 90.0), ("p99_ms", 99.0),
         ("p99_9_ms", 99.9))


def _pct_block(lats_sorted):
    return {name: round(percentile(lats_sorted, p), 3)
            for name, p in _PCTS}


def build_report(samples, mode, wall_s, slo_ms=None, offered_rps=None,
                 worst_k=5):
    """Aggregate raw per-request samples into the run report:
    percentiles computed EXACTLY from the raw latencies (not from
    histogram buckets), per-bucket/per-status splits, SLO attainment,
    and the worst-K requests with their trace identities (the join
    keys for /debug/tail and /metrics exemplars)."""
    samples = [s for s in samples if s is not None]
    if not samples:
        raise ValueError("no samples completed")
    lats = sorted(s["latency_ms"] for s in samples)
    by_status = {}
    by_bucket = {}
    for s in samples:
        by_status[s["status"]] = by_status.get(s["status"], 0) + 1
        by_bucket.setdefault(s["bucket"], []).append(s["latency_ms"])
    bucket_stats = {}
    for bucket, vals in sorted(by_bucket.items()):
        vals.sort()
        bucket_stats[bucket] = {
            "n": len(vals),
            "frac": round(len(vals) / len(samples), 4),
            "p50_ms": round(percentile(vals, 50.0), 3),
            "p99_ms": round(percentile(vals, 99.0), 3),
            "max_ms": round(vals[-1], 3),
        }
    worst = sorted(samples, key=lambda s: s["latency_ms"],
                   reverse=True)[:int(worst_k)]
    report = {
        "mode": mode,
        "n": len(samples),
        "wall_s": round(wall_s, 3),
        "offered_rps": (None if offered_rps is None
                        else round(offered_rps, 3)),
        "achieved_rps": round(len(samples) / wall_s, 3)
        if wall_s > 0 else None,
        "percentiles_ms": _pct_block(lats),
        "max_ms": round(lats[-1], 3),
        "by_status": {str(k): v for k, v in sorted(by_status.items())},
        "by_bucket": bucket_stats,
        "worst": [dict(s) for s in worst],
    }
    if slo_ms is not None:
        good = sum(1 for v in lats if v <= float(slo_ms))
        report["slo"] = {
            "slo_ms": float(slo_ms),
            "attainment": round(good / len(lats), 5),
            "violations": len(lats) - good,
        }
    return report


def latency_blob(report):
    """The `latency` blob a bench record carries into
    perf_history.jsonl (perf.normalize_record passes these keys
    through; `gate_history(latency_tolerance=)` regresses on the
    percentile keys with the same-key discipline of the mem/comm
    gates)."""
    blob = {"mode": report["mode"], "n": report["n"]}
    blob.update(report["percentiles_ms"])
    if report.get("offered_rps") is not None:
        blob["offered_rps"] = report["offered_rps"]
    if report.get("achieved_rps") is not None:
        blob["achieved_rps"] = report["achieved_rps"]
    slo = report.get("slo")
    if slo:
        blob["slo_ms"] = slo["slo_ms"]
        blob["slo_attainment"] = slo["attainment"]
    return blob


# ---------------------------------------------------------------------------
# joins: /debug/tail + /metrics exemplars
# ---------------------------------------------------------------------------

def join_tail(report, tail_doc):
    """Attach the server's captured span trees to the report's worst
    requests, matched by request_id (primary) or trace_id.  Returns
    the number of worst requests that resolved — the "p99 is bad ->
    here is the span tree" join."""
    requests = (tail_doc or {}).get("requests") or []
    by_request = {r.get("request_id"): r for r in requests}
    by_trace = {r.get("trace_id"): r for r in requests}
    joined = 0
    for w in report.get("worst", []):
        rec = by_request.get(w.get("request_id")) \
            or by_trace.get(w.get("trace_id"))
        if rec is None:
            continue
        w["tail"] = {"reason": rec.get("reason"),
                     "server_latency_ms": rec.get("latency_ms"),
                     "status": rec.get("status"),
                     "spans": rec.get("spans")}
        joined += 1
    report["tail_joined"] = joined
    return joined


_EXEMPLAR_RE = re.compile(
    r"^(?P<name>[A-Za-z_:][\w:]*)_bucket\{(?P<labels>[^}]*)\}\s+\S+"
    r"\s+#\s+\{(?P<ex>[^}]*)\}\s+(?P<value>\S+)")
_LABEL_RE = re.compile(r'([A-Za-z_][\w]*)="((?:[^"\\]|\\.)*)"')


def parse_exemplars(metrics_text):
    """OpenMetrics exemplars from an exposition: trace_id -> list of
    `{metric, le, value}` — which latency bucket(s) each captured
    trace landed in."""
    out = {}
    for line in str(metrics_text).splitlines():
        m = _EXEMPLAR_RE.match(line.strip())
        if not m:
            continue
        labels = dict(_LABEL_RE.findall(m.group("labels")))
        ex_labels = dict(_LABEL_RE.findall(m.group("ex")))
        tid = ex_labels.get("trace_id")
        if not tid:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        out.setdefault(tid, []).append({
            "metric": m.group("name"),
            "le": labels.get("le"),
            "value": value,
        })
    return out


def join_exemplars(report, metrics_text):
    """Attach /metrics exemplar hits (by trace_id) to the report's
    worst requests; returns how many resolved."""
    exemplars = parse_exemplars(metrics_text)
    joined = 0
    for w in report.get("worst", []):
        hits = exemplars.get(w.get("trace_id"))
        if hits:
            w["exemplars"] = hits
            joined += 1
    report["exemplars_joined"] = joined
    return joined


def format_report(report):
    """Human-readable run summary (the pload stdout)."""
    pct = report["percentiles_ms"]
    lines = [
        "[pload] %s loop: %d requests in %.2fs (offered %s rps, "
        "achieved %s rps)"
        % (report["mode"], report["n"], report["wall_s"],
           ("%.1f" % report["offered_rps"])
           if report.get("offered_rps") else "-",
           ("%.1f" % report["achieved_rps"])
           if report.get("achieved_rps") else "-"),
        "  latency ms: p50 %.2f  p90 %.2f  p99 %.2f  p99.9 %.2f  "
        "max %.2f" % (pct["p50_ms"], pct["p90_ms"], pct["p99_ms"],
                      pct["p99_9_ms"], report["max_ms"]),
        "  status: " + "  ".join("%s=%d" % kv for kv in
                                 sorted(report["by_status"].items())),
    ]
    slo = report.get("slo")
    if slo:
        lines.append("  slo: %.5f attainment at %gms (%d violations)"
                     % (slo["attainment"], slo["slo_ms"],
                        slo["violations"]))
    for bucket, st in report["by_bucket"].items():
        lines.append("  %-6s n=%-5d frac=%.2f  p50 %.2f  p99 %.2f  "
                     "max %.2f ms" % (bucket, st["n"], st["frac"],
                                      st["p50_ms"], st["p99_ms"],
                                      st["max_ms"]))
    for w in report.get("worst", []):
        tail = w.get("tail")
        lines.append(
            "  worst %.2fms status=%d %s req=%s%s"
            % (w["latency_ms"], w["status"], w["bucket"],
               w["request_id"],
               "  -> tail span tree (%s, server %.2fms)"
               % (tail["reason"], tail["server_latency_ms"])
               if tail else ""))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the serving-slo leg
# ---------------------------------------------------------------------------

def build_tiny_engine(dim=16, classes=4, buckets=(1, 2, 4, 8),
                      place=None):
    """A startup-initialized fc classifier engine, built in-process
    (no export round-trip): the loopback model for the serving leg and
    the load_cli selftest.  `place` defaults to CUDAPlace(0), which
    raises without a CUDA device; the JAX module builds on its CPU."""
    from .. import fluid
    from ..fluid import io as fluid_io
    from ..serving import EngineConfig, InferenceEngine

    place = place if place is not None else fluid.CUDAPlace(0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[dim],
                                dtype="float32")
        hidden = fluid.layers.fc(input=img, size=8, act="tanh")
        probs = fluid.layers.fc(input=hidden, size=classes,
                                act="softmax")
    scope = fluid.Scope()
    fluid.Executor(place).run(startup, scope=scope)
    program = fluid_io.prune_program(main, [probs])
    return InferenceEngine(
        program, ["img"], [probs], place=place, scope=scope,
        config=EngineConfig(batch_buckets=list(buckets)))


def run_serving_bench(place=None):
    """The `serving-slo` leg: a loopback server + an open-loop Poisson
    run over a mixed-bucket profile, distilled into a record whose
    `latency` blob lands in perf_history.jsonl for `perf_cli gate
    --latency-tolerance`.  The engine runs at `place` (default
    CUDAPlace(0)); the record's platform is that place's.

    Env knobs: BENCH_SERVING_RATE (req/s, 80), BENCH_SERVING_N
    (requests, 400), BENCH_SERVING_MIX ("1:2,2:1,4:1"),
    BENCH_SERVING_SLO_MS (50), BENCH_SERVING_SEED (0)."""
    import os

    from ..serving import InferenceServer, ServerConfig
    from .perf import platform_of

    rate = float(os.environ.get("BENCH_SERVING_RATE", "80"))
    n = int(os.environ.get("BENCH_SERVING_N", "400"))
    mix = TrafficMix.parse(
        os.environ.get("BENCH_SERVING_MIX", "1:2,2:1,4:1"))
    slo_ms = float(os.environ.get("BENCH_SERVING_SLO_MS", "50"))
    seed = int(os.environ.get("BENCH_SERVING_SEED", "0"))

    engine = build_tiny_engine(place=place)
    server = InferenceServer(engine, ServerConfig(
        port=0, max_batch=8, max_wait_ms=1.0, queue_size=128,
        slo_ms=slo_ms, model_name="tiny-fc",
        tail_slow_ms=slo_ms)).start()
    try:
        host, port = server.address
        target = HttpTarget("http://%s:%d" % (host, port))
        schedule = build_schedule(rate, n=n, arrival="poisson",
                                  mix=mix, seed=seed)
        report = run_open_loop(target, schedule,
                               vector_payload("img", 16),
                               slo_ms=slo_ms)
        join_tail(report, target.get("/debug/tail"))
    finally:
        server.shutdown()

    platform = platform_of(engine.place)
    mix_tag = ",".join("%d:%g" % (b, w)
                       for b, w in mix.weights.items())
    return {
        "metric": "serving_slo_openloop_rps",
        "value": report["achieved_rps"],
        "unit": "req/s",
        "step_ms": None,
        "mfu": None,
        "amp_bf16": False,
        "platform": platform,
        "latency": latency_blob(report),
        "config": {"model": "tiny-fc", "mode": "serving",
                   "rate": rate, "n": n, "mix": mix_tag,
                   "slo_ms": slo_ms},
    }
