"""Load CLI: load generation + traffic replay over
`paddle_tpu_torch.obs.load`, with coordinated-omission-safe latency
truth and the serving tail-latency gate hookup.

    # the certification run, on the card (--use_gpu=0: on the CPU):
    python -m paddle_tpu_torch.tools.load_cli --selftest

    # open-loop Poisson load against a live server (the honest tail):
    python -m paddle_tpu_torch.tools.load_cli run \
        --url http://127.0.0.1:8500 --rate 200 --n 2000 \
        --mix 1:6,4:3,8:1 --slo-ms 50

    # closed-loop capacity probe (N workers, think time):
    ... run --url ... --mode closed --workers 16 --think-ms 5 --n 2000

    # replay a recorded access log at 4x speed, original gaps:
    ... replay --url ... --log access.jsonl --speed 4

    # land the run in perf history for `perf_cli gate
    # --latency-tolerance` (the record names the platform the server's
    # /healthz reports for its engine's place):
    ... run --url ... --rate 100 --n 1000 --slo-ms 50 \
        --history perf_history.jsonl

Counterpart of paddle_tpu/tools/load_cli.py.  `--selftest` certifies
the harness end to end on a loopback server whose engine runs at the
place `--use_gpu` names:

  1. **coordinated omission, demonstrated** — an injected engine stall
     must inflate the OPEN-loop p99 (requests measured from their
     scheduled send time keep accruing latency through the stall) ...
  2. ... while the same stall stays HIDDEN from the closed-loop p99
     (the single worker is itself blocked, so only one request
     observes it): the open/closed gap IS the omission error;
  3. **tail join** — the slowest open-loop request's request_id must
     resolve to a span tree in the server's /debug/tail ring, and the
     /metrics exemplars must parse (the "p99 is bad -> why" loop);
  4. **replay fidelity** — replaying the run's own access-log JSONL
     must reproduce its request count and bucket mix exactly;
  5. **gate round-trip** — a `latency` blob must flow through
     perf_history.jsonl into `perf_cli gate --latency-tolerance`: an
     injected p99 regression fails the gate naming the percentile,
     and the same history passes with the flag omitted (opt-in).
"""

import argparse
import json
import os
import sys
import tempfile
import threading
import time

from . import cli_place, use_gpu_arg


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="load_cli")
    p.add_argument("cmd", nargs="?", choices=["run", "replay"],
                   help="operator command (or use --selftest)")
    p.add_argument("--selftest", action="store_true",
                   help="loopback open-vs-closed omission proof, tail "
                        "join, replay fidelity, latency gate")
    p.add_argument("--url", default="http://127.0.0.1:8500",
                   help="server base URL (POST <url>/v1/infer)")
    p.add_argument("--mode", choices=["open", "closed"], default="open",
                   help="arrival discipline: open = scheduled "
                        "arrivals, latency from the schedule "
                        "(omission-safe); closed = N looping workers")
    p.add_argument("--arrival", choices=["poisson", "uniform"],
                   default="poisson", help="open-loop gap law")
    p.add_argument("--rate", type=float, default=100.0,
                   help="open-loop offered req/s (base rate before "
                        "--phases/--ramp-s)")
    p.add_argument("--n", type=int, default=None,
                   help="total requests (or bound by --duration)")
    p.add_argument("--duration", type=float, default=None,
                   help="run length in seconds")
    p.add_argument("--workers", type=int, default=4,
                   help="closed-loop concurrent workers")
    p.add_argument("--think-ms", type=float, default=0.0,
                   help="closed-loop pause between a worker's requests")
    p.add_argument("--mix", default="1",
                   help="weighted batch-size mix, e.g. 1:6,4:3,8:1 "
                        "(bare sizes weigh equally)")
    p.add_argument("--phases", default=None,
                   help="burst phases t:rate,..., e.g. 5:400,6:100 — "
                        "from t=5s offer 400 req/s, from 6s 100")
    p.add_argument("--ramp-s", type=float, default=0.0,
                   help="linear rate ramp-in over the first N seconds")
    p.add_argument("--slo-ms", type=float, default=None,
                   help="latency objective; report carries attainment")
    p.add_argument("--speed", type=float, default=1.0,
                   help="replay: time-compression multiplier over the "
                        "log's original inter-arrival gaps")
    p.add_argument("--log", default=None,
                   help="replay: server access-log JSONL "
                        "(ServerConfig.access_log output)")
    p.add_argument("--timeout-ms", type=float, default=None,
                   help="per-request timeout_ms field (server-side "
                        "deadline -> 504)")
    p.add_argument("--seed", type=int, default=0,
                   help="schedule/mix RNG seed (schedules are "
                        "deterministic under it)")
    p.add_argument("--max-inflight", type=int, default=32,
                   help="open-loop sender pool: above this many "
                        "unanswered requests, further arrivals queue "
                        "(and keep accruing scheduled-time latency)")
    p.add_argument("--feed", default="img",
                   help="feed tensor name for the generated payload")
    p.add_argument("--dim", type=int, default=16,
                   help="per-sample feature width of the feed")
    p.add_argument("--worst", type=int, default=5,
                   help="worst-K requests to report and tail-join")
    p.add_argument("--no-join", action="store_true",
                   help="skip the /debug/tail + /metrics joins")
    p.add_argument("--report", default=None,
                   help="write the full JSON report here")
    p.add_argument("--history", default=None,
                   help="append a latency-blob record to this perf "
                        "history (perf_cli gate --latency-tolerance)")
    p.add_argument("--json", action="store_true",
                   help="print the report as JSON instead of text")
    p.add_argument("--use_gpu", type=use_gpu_arg, default=True,
                   help="1: the selftest's engines run on the card "
                        "(the default); 0: the CPU")
    return p.parse_args(argv)


def _run_report(args, target, schedule):
    from ..obs import load as obs_load

    payload_fn = obs_load.vector_payload(args.feed, args.dim,
                                         timeout_ms=args.timeout_ms)
    if args.mode == "open":
        report = obs_load.run_open_loop(
            target, schedule, payload_fn, slo_ms=args.slo_ms,
            max_inflight=args.max_inflight)
    else:
        report = obs_load.run_closed_loop(
            target, payload_fn, workers=args.workers, n=args.n,
            duration_s=args.duration, think_ms=args.think_ms,
            mix=obs_load.TrafficMix.parse(args.mix), seed=args.seed,
            slo_ms=args.slo_ms)
    if not args.no_join:
        try:
            obs_load.join_tail(report, target.get("/debug/tail"))
            obs_load.join_exemplars(report, target.get("/metrics"))
        except (OSError, ValueError):
            pass  # a server without debug endpoints still measures
    return report


def _server_platform(target):
    """The platform the measured server names in its /healthz ("gpu" or
    "cpu", from its engine's place); a server that names none cannot
    enter a history."""
    try:
        health = target.get("/healthz")
    except (OSError, ValueError) as exc:
        raise SystemExit("--history: /healthz unreadable (%s)" % exc)
    platform = health.get("platform") if isinstance(health, dict) else None
    if not platform:
        raise SystemExit("--history: the server's /healthz names no "
                         "platform, so its latencies cannot be gated "
                         "against a platform's history")
    return platform


def _emit(args, platform, report):
    from ..obs import load as obs_load
    from ..obs import perf as obs_perf

    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, sort_keys=True, indent=1)
    if args.history:
        blob = obs_load.latency_blob(report)
        record = {
            "metric": "pload_%s_rps" % report["mode"],
            "value": report["achieved_rps"],
            "unit": "req/s",
            "platform": platform,
            "latency": blob,
        }
        obs_perf.append_history(record, args.history, leg="pload")
    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        print(obs_load.format_report(report))
    slo = report.get("slo")
    if slo is not None and slo["violations"] and \
            slo["attainment"] < 0.99:
        return 1
    return 0


def cmd_run(args):
    from ..obs import load as obs_load

    target = obs_load.HttpTarget(args.url)
    schedule = None
    if args.mode == "open":
        schedule = obs_load.build_schedule(
            args.rate, n=args.n, duration_s=args.duration,
            arrival=args.arrival,
            mix=obs_load.TrafficMix.parse(args.mix), seed=args.seed,
            phases=obs_load.parse_phases(args.phases),
            ramp_s=args.ramp_s)
    platform = _server_platform(target) if args.history else None
    return _emit(args, platform, _run_report(args, target, schedule))


def cmd_replay(args):
    from ..obs import load as obs_load

    if not args.log:
        raise SystemExit("replay needs --log <access log JSONL>")
    entries = obs_load.load_access_log(args.log)
    if not entries:
        raise SystemExit("no replayable entries in %s" % args.log)
    schedule = obs_load.replay_schedule(entries, speed=args.speed)
    target = obs_load.HttpTarget(args.url)
    args.mode = "open"  # replay is open-loop by definition
    platform = _server_platform(target) if args.history else None
    return _emit(args, platform, _run_report(args, target, schedule))


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------

class _StallEngine:
    """Delegating engine wrapper with a one-shot armable stall: the
    Nth `run()` call after `arm()` sleeps `stall_s` first.  One-shot
    on purpose — a periodic stall would hit enough closed-loop
    requests to surface in that p99 too, and the whole point of the
    selftest is the asymmetry."""

    def __init__(self, inner):
        self._inner = inner
        self._lock = threading.Lock()
        self._remaining = None
        self._stall_s = 0.0

    def arm(self, after_calls, stall_s):
        with self._lock:
            self._remaining = int(after_calls)
            self._stall_s = float(stall_s)

    def run(self, feeds, timings=None):
        stall = 0.0
        with self._lock:
            if self._remaining is not None:
                self._remaining -= 1
                if self._remaining <= 0:
                    stall = self._stall_s
                    self._remaining = None
        if stall:
            time.sleep(stall)
        return self._inner.run(feeds, timings=timings)

    # everything the batcher/server touches delegates
    def warmup(self):
        return self._inner.warmup()

    def batch_size(self, feeds):
        return self._inner.batch_size(feeds)

    @property
    def place(self):
        return self._inner.place

    @property
    def feed_names(self):
        return self._inner.feed_names

    @property
    def fetch_names(self):
        return self._inner.fetch_names

    @property
    def _feed_meta(self):
        return self._inner._feed_meta

    @property
    def config(self):
        return self._inner.config

    @property
    def metrics(self):
        return self._inner.metrics

    @metrics.setter
    def metrics(self, value):
        self._inner.metrics = value


def _selftest_omission(workdir, place):
    """Legs 1-3: the same injected stall must be LOUD in the open-loop
    p99 and QUIET in the closed-loop p99, and the slowest open-loop
    request must join to a /debug/tail span tree."""
    from ..obs import load as obs_load
    from ..serving import InferenceServer, ServerConfig

    access_log = os.path.join(workdir, "access.jsonl")
    engine = _StallEngine(obs_load.build_tiny_engine(
        dim=8, classes=3, buckets=(1, 2, 4, 8), place=place))
    # Warm every bucket first: on a CUDA device a bucket's first run
    # loads the math libraries, and the backlog that leaves behind
    # (up to a second) would stand in for the injected stall.  The
    # tail ring holds every request of legs 1 and 2, so that a host
    # that falls behind (each request over tail_slow_ms) cannot evict
    # the slowest ones before leg 3 joins them.
    server = InferenceServer(engine, ServerConfig(
        port=0, max_batch=8, max_wait_ms=1.0, queue_size=64,
        warmup=True, slo_ms=100.0, model_name="pload-selftest",
        tail_slow_ms=100.0, tail_capacity=512,
        access_log=access_log)).start()
    stall_s = 0.3
    try:
        host, port = server.address
        target = obs_load.HttpTarget("http://%s:%d" % (host, port))
        payload_fn = obs_load.vector_payload("img", 8)
        mix = obs_load.TrafficMix.parse("1:2,2:1,4:1")

        # leg 1: open loop, 200 req @ 100/s.  ~30 arrivals are
        # scheduled inside the 300ms stall; each is measured from its
        # schedule slot, so the stall floods the upper percentiles.
        engine.arm(after_calls=10, stall_s=stall_s)
        schedule = obs_load.build_schedule(
            100.0, n=200, arrival="poisson", mix=mix, seed=7)
        open_report = obs_load.run_open_loop(
            target, schedule, payload_fn, slo_ms=100.0,
            max_inflight=64)
        open_p99 = open_report["percentiles_ms"]["p99_ms"]
        assert open_p99 >= 100.0, \
            "open-loop p99 %.2fms did not surface a %dms stall" \
            % (open_p99, stall_s * 1e3)

        # leg 2: closed loop, 1 worker, same stall re-armed.  The
        # worker is blocked DURING the stall, so exactly one request
        # observes it; the p99 (2nd-worst of 200) stays clean — the
        # coordinated-omission trap, reproduced on demand.
        engine.arm(after_calls=10, stall_s=stall_s)
        closed_report = obs_load.run_closed_loop(
            target, payload_fn, workers=1, n=200, mix=mix, seed=7,
            slo_ms=100.0)
        closed_p99 = closed_report["percentiles_ms"]["p99_ms"]
        assert closed_report["max_ms"] >= stall_s * 1e3 * 0.8, \
            "closed-loop run never hit the armed stall (max %.2fms)" \
            % closed_report["max_ms"]
        assert closed_p99 < 100.0 and closed_p99 < open_p99 / 2.0, \
            "closed-loop p99 %.2fms did not hide the stall open-loop " \
            "p99 %.2fms exposed" % (closed_p99, open_p99)

        # leg 3: the debugging loop — worst request -> span tree
        joined = obs_load.join_tail(open_report,
                                    target.get("/debug/tail"))
        assert joined >= 1, "no worst request resolved in /debug/tail"
        worst = open_report["worst"][0]
        assert worst.get("tail") and worst["tail"].get("spans"), \
            "slowest request %s carried no span tree" \
            % worst["request_id"]
        metrics_text = target.get("/metrics")
        assert obs_load.parse_exemplars(metrics_text), \
            "/metrics exposed no parsable exemplars"
        obs_load.join_exemplars(open_report, metrics_text)
        # satellite check: the stall backlog must have left a nonzero
        # queue-depth high-watermark for the scrape to carry out
        peak = [l for l in metrics_text.splitlines()
                if l.startswith("serving_queue_depth_peak")]
        assert peak and float(peak[0].split()[-1]) > 0, \
            "queue_depth_peak watermark missing/zero: %r" % peak
    finally:
        server.shutdown()
    return open_report, closed_report, open_p99, closed_p99, access_log


def _selftest_replay(workdir, access_log, place):
    """Leg 4: replaying the recorded access log must reproduce its
    request count and bucket mix exactly (batch sizes come from the
    log lines, not from a sampled mix)."""
    from ..obs import load as obs_load
    from ..serving import InferenceServer, ServerConfig

    entries = obs_load.load_access_log(access_log)
    assert entries, "server wrote no access log"
    want_buckets = {}
    for e in entries:
        b = "b%d" % max(1, int(e.get("batch") or 1))
        want_buckets[b] = want_buckets.get(b, 0) + 1

    engine = obs_load.build_tiny_engine(dim=8, classes=3,
                                        buckets=(1, 2, 4, 8), place=place)
    server = InferenceServer(engine, ServerConfig(
        port=0, max_batch=8, max_wait_ms=1.0, queue_size=256,
        warmup=True, model_name="pload-replay")).start()
    try:
        host, port = server.address
        target = obs_load.HttpTarget("http://%s:%d" % (host, port))
        schedule = obs_load.replay_schedule(entries, speed=20.0)
        report = obs_load.run_open_loop(
            target, schedule, obs_load.vector_payload("img", 8),
            max_inflight=64)
    finally:
        server.shutdown()
    assert report["n"] == len(entries), \
        "replay answered %d of %d logged requests" \
        % (report["n"], len(entries))
    got_buckets = {b: st["n"] for b, st in report["by_bucket"].items()}
    assert got_buckets == want_buckets, \
        "replay bucket mix %r != recorded %r" % (got_buckets,
                                                 want_buckets)
    statuses = set(report["by_status"])
    assert statuses == {"200"}, \
        "replay saw non-200s: %r" % report["by_status"]
    return report


def _selftest_gate(workdir, open_report, platform):
    """Leg 5: the latency blob's CI story — baseline history + a
    tripled-tail candidate must FAIL `perf_cli gate
    --latency-tolerance` naming the percentile, and PASS with the flag
    omitted."""
    from ..obs import load as obs_load
    from ..obs import perf as obs_perf
    from . import perf_cli

    path = os.path.join(workdir, "perf_history.jsonl")
    blob = obs_load.latency_blob(open_report)

    def record(latency):
        return {"metric": "serving_slo_openloop_rps",
                "value": open_report["achieved_rps"],
                "unit": "req/s", "platform": platform,
                "latency": latency}

    ts = 1_700_000_000.0
    for i in range(5):
        norm = obs_perf.append_history(record(dict(blob)), path,
                                       leg="serving-slo", ts=ts + i)
        assert norm and norm["latency"].get("p99_ms") == \
            blob["p99_ms"], "latency blob did not survive " \
            "normalize_record: %r" % (norm,)
    regressed = dict(blob)
    for key in ("p50_ms", "p90_ms", "p99_ms", "p99_9_ms"):
        regressed[key] = round(blob[key] * 3.0, 3)
    obs_perf.append_history(record(regressed), path, leg="serving-slo",
                            ts=ts + 5)

    res = obs_perf.gate_history(obs_perf.load_history(path),
                                latency_tolerance=0.25)
    assert not res.ok and res.failures[0]["kind"] == "latency", \
        res.to_dict()
    assert "p99" in res.failures[0]["why"], res.to_dict()
    rc = perf_cli.main(["gate", "--history", path,
                        "--latency-tolerance", "0.25"])
    assert rc == 1, "perf_cli gate exit %r for a 3x tail regression" % rc
    # opt-in: the same history passes when latency is not gated
    rc = perf_cli.main(["gate", "--history", path])
    assert rc == 0, "latency gate fired without --latency-tolerance"
    return res.failures[0]["why"]


def selftest(args):
    import shutil

    from ..obs import perf as obs_perf

    place = cli_place(args.use_gpu)
    place.device()  # a CUDAPlace without a CUDA device raises here
    workdir = tempfile.mkdtemp(prefix="paddle_pload_")
    try:
        (open_report, closed_report, open_p99, closed_p99,
         access_log) = _selftest_omission(workdir, place)
        replay_report = _selftest_replay(workdir, access_log, place)
        gate_why = _selftest_gate(workdir, open_report,
                                  obs_perf.platform_of(place))
    finally:
        # a CI step runs this every time: don't stack /tmp dirs
        shutil.rmtree(workdir, ignore_errors=True)

    print("[pload] selftest green: injected stall -> open-loop p99 "
          "%.1fms vs closed-loop p99 %.1fms (the coordinated-omission "
          "gap), worst request joined to its /debug/tail span tree, "
          "replay reproduced %d requests + bucket mix, latency gate: "
          "%s" % (open_p99, closed_p99, replay_report["n"], gate_why),
          flush=True)
    return 0


def main(argv=None):
    args = parse_args(argv)
    if args.selftest:
        return selftest(args)
    if args.cmd == "run":
        return cmd_run(args)
    if args.cmd == "replay":
        return cmd_replay(args)
    raise SystemExit("nothing to do: pass a command (run | replay) or "
                     "--selftest")


if __name__ == "__main__":
    sys.exit(main())
