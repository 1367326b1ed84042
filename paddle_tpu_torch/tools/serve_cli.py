"""Online inference server CLI.

    python -m paddle_tpu_torch.tools.serve_cli --model_dir=./inference_model \
        --port=8500 --max_batch=32 --max_wait_ms=5 --queue_size=64 \
        --batch_buckets=1,2,4,8,16 [--use_gpu=1]

Counterpart of paddle_tpu/tools/serve_cli.py, with the same flags: it
serves a `fluid.io.save_inference_model` export (from either package)
over HTTP.  `--use_gpu` (default 1) serves it on CUDAPlace(0), which
raises without a CUDA device; `--use_gpu=0` serves it on the CPU.
SIGINT / SIGTERM drain gracefully: admission stops, queued requests are
answered, then the listener closes and `main` returns 0.

`--selftest` builds a tiny classifier in-process, starts the server on
an ephemeral port at the place `--use_gpu` names, round-trips one
request, scrapes /metrics and drains.
"""

import argparse
import json
import signal
import sys
import threading

from . import cli_place, use_gpu_arg


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="paddle_serve")
    p.add_argument("--model_dir", default=None,
                   help="save_inference_model export directory")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500,
                   help="0 picks an ephemeral port")
    p.add_argument("--max_batch", type=int, default=32,
                   help="sample-row budget per device launch")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="micro-batch assembly window")
    p.add_argument("--queue_size", type=int, default=64,
                   help="admission-queue bound (full => 429)")
    p.add_argument("--timeout_ms", type=float, default=None,
                   help="default per-request deadline")
    p.add_argument("--batch_buckets", default=None,
                   help="comma list of batch buckets to pad to "
                        "(default: export hints, else 1,2,4,...,64)")
    p.add_argument("--token_bucket", type=int, default=None,
                   help="flat token-length multiple for ragged feeds")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip running each bucket once at startup")
    p.add_argument("--slo_ms", type=float, default=None,
                   help="latency objective: publish slo_burn_rate in "
                        "/metrics and /healthz")
    p.add_argument("--slo_target", type=float, default=0.99,
                   help="fraction of requests that must answer "
                        "within --slo_ms")
    p.add_argument("--model_name", default="default",
                   help="model label on the slo_burn_rate gauge")
    p.add_argument("--tail_slow_ms", type=float, default=None,
                   help="keep the full span tree of requests slower "
                        "than this (default: --slo_ms) or answered "
                        ">=500 — GET /debug/tail, obs_dump --tail")
    p.add_argument("--tail_capacity", type=int, default=64,
                   help="tail-capture ring bound")
    p.add_argument("--access_log", default=None,
                   help="opt-in JSONL access log path (request_id, "
                        "trace_id, status, latency_ms, batch, bucket)")
    p.add_argument("--use_gpu", type=use_gpu_arg, default=True,
                   help="1 (default): serve on CUDAPlace(0); 0: on the "
                        "CPU")
    p.add_argument("--selftest", action="store_true",
                   help="serve a built-in tiny model, fire one "
                        "request, scrape /metrics, drain, exit")
    return p.parse_args(argv)


def _engine_config(args):
    from ..serving import EngineConfig

    if args.batch_buckets is None and args.token_bucket is None:
        return None  # defer to export hints / defaults
    kw = {}
    if args.batch_buckets is not None:
        kw["batch_buckets"] = [int(b) for b in
                               args.batch_buckets.split(",")]
    if args.token_bucket is not None:
        kw["token_bucket"] = args.token_bucket
    return EngineConfig(**kw)


def _serve(engine, args):
    from ..serving import InferenceServer, ServerConfig

    server = InferenceServer(engine, ServerConfig(
        host=args.host, port=args.port, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, queue_size=args.queue_size,
        default_timeout_ms=args.timeout_ms,
        warmup=not args.no_warmup, slo_ms=args.slo_ms,
        slo_target=args.slo_target, model_name=args.model_name,
        tail_slow_ms=args.tail_slow_ms,
        tail_capacity=args.tail_capacity,
        access_log=args.access_log))
    server.start()
    host, port = server.address
    print("[serve] listening on http://%s:%d (place=%r feeds=%s "
          "fetches=%s buckets=%s)" % (host, port, engine.place,
                                      engine.feed_names, engine.fetch_names,
                                      engine.config.batch_buckets),
          flush=True)
    return server


def _install_drain_handlers(server, done):
    """SIGINT and SIGTERM start a drain on a thread of its own (a signal
    handler runs on the main thread, between its bytecodes); returns
    the handlers they replace."""
    def drain(signum, frame):
        print("[serve] signal %d: draining ..." % signum, flush=True)
        threading.Thread(target=lambda: (server.shutdown(),
                                         done.set()),
                         daemon=True).start()

    return {s: signal.signal(s, drain)
            for s in (signal.SIGINT, signal.SIGTERM)}


def _selftest_model(tmpdir):
    """Export a tiny startup-initialized classifier (built and
    initialised on the CPU): deterministic enough for a round-trip
    check, cheap enough for CI."""
    from .. import fluid
    from ..fluid import io as fluid_io

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[16], dtype="float32")
        hidden = fluid.layers.fc(input=img, size=8, act="tanh")
        probs = fluid.layers.fc(input=hidden, size=4, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid_io.save_inference_model(
            tmpdir, ["img"], [probs], exe, main_program=main,
            bucket_hints={"batch_buckets": [1, 2, 4]})
    return tmpdir


def _selftest(args):
    import http.client
    import shutil
    import tempfile

    from ..serving import InferenceEngine

    tmpdir = tempfile.mkdtemp(prefix="paddle_serve_selftest_")
    try:
        _selftest_model(tmpdir)
        engine = InferenceEngine.from_saved_model(
            tmpdir, place=cli_place(args.use_gpu))
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    args.port = 0
    server = _serve(engine, args)
    host, port = server.address
    try:
        conn = http.client.HTTPConnection(host, port, timeout=30)
        body = json.dumps({"inputs": {"img": [[0.1] * 16, [0.9] * 16]}})
        conn.request("POST", "/v1/infer", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        payload = json.loads(resp.read())
        assert resp.status == 200, (resp.status, payload)
        probs = payload["outputs"][engine.fetch_names[0]]
        assert len(probs) == 2 and len(probs[0]) == 4, probs
        assert all(abs(sum(row) - 1.0) < 1e-3 for row in probs), probs
        conn.request("GET", "/metrics", headers={})
        metrics_text = conn.getresponse().read().decode()
        assert "serving_responses_total 1" in metrics_text, metrics_text
        assert "serving_compile_cache_hit_total" in metrics_text
        conn.close()
    finally:
        server.shutdown()
    print("[serve] selftest green: 1 request served on %r, metrics "
          "scraped, drained cleanly" % (engine.place,), flush=True)
    return 0


def main(argv=None):
    args = parse_args(argv)
    if args.selftest:
        return _selftest(args)
    if not args.model_dir:
        raise SystemExit("--model_dir is required (or --selftest)")

    from ..serving import InferenceEngine

    engine = InferenceEngine.from_saved_model(
        args.model_dir, place=cli_place(args.use_gpu),
        config=_engine_config(args))
    server = _serve(engine, args)
    done = threading.Event()
    previous = _install_drain_handlers(server, done)
    try:
        done.wait()
    finally:
        for signum, handler in previous.items():
            signal.signal(signum, handler)
    print("[serve] drained, bye", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
