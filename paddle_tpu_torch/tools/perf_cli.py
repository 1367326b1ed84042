"""Perf CLI: bottleneck classification, perf-history inspection, and
the noise-aware regression gate over `paddle_tpu_torch.obs.perf`.

    # the certification run, on the card (--use_gpu=0: on the CPU):
    python -m paddle_tpu_torch.tools.perf_cli --selftest

    # roofline + bottleneck verdict for a bench model (pass --step-ms,
    # a step time measured on the card, to classify it against its
    # floors; --f32 prices the products at the f32 cores' 67 TFLOP/s,
    # the default bf16 at the tensor cores' 989):
    python -m paddle_tpu_torch.tools.perf_cli classify --model resnet50 \
        --batch 128 --f32 --step-ms <measured ms>

    # the regression gate (exit 1 on regression):
    python -m paddle_tpu_torch.tools.perf_cli gate \
        --history perf_history.jsonl

    # the trajectory, one line per run:
    python -m paddle_tpu_torch.tools.perf_cli history --metric resnet50

Counterpart of paddle_tpu/tools/perf_cli.py.  `classify` builds the
bench model through a private copy of the repo root's bench-model
builder (`_build_model`, the program `chip_smoke.build_model` builds)
and prices no program on a device; `gate` and `history` read history
files written by either package.  `--selftest` certifies the perf
subsystem end to end at the place `--use_gpu` names:

  1. **gate discrimination** — a seeded synthetic history (median 1000
     img/s, ±1.5% noise) must PASS the gate; the same history with an
     injected 20% regression must FAIL it (non-zero exit, output
     naming the metric, leg and bottleneck verdict); a `gpu-stale`
     re-emit must HARD-fail the platform check;
  2. **step profiler** — a real v2 SGD run with the profiler installed
     must produce ring records with wall/time-split fields (and the
     JAX record's retrace count, 0 in the port) and valid Chrome-trace
     + JSONL exports, and the classifier must return a verdict;
  3. **SLO burn on a loopback engine** — requests through a real
     serving engine + server (in-process), /healthz must carry
     `slo_burn_rate`: ~0 under a generous objective, > 1 under an
     impossible one.

The JAX selftest's fourth leg, the warm persistent-compile-cache blob,
waits with the cache (ROADMAP A2); the port's selftest prints a line
saying so.
"""

import argparse
import json
import os
import sys
import tempfile

from . import cli_place, use_gpu_arg


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="perf_cli")
    p.add_argument("cmd", nargs="?",
                   choices=["classify", "gate", "history"],
                   help="operator command (or use --selftest)")
    p.add_argument("--selftest", action="store_true",
                   help="profiler + classifier + gate + SLO burn "
                        "certification")
    # classify
    p.add_argument("--model", default="resnet50")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--class-dim", type=int, default=1000)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--f32", dest="bf16", action="store_false")
    p.add_argument("--peak-tflops", type=float, default=None,
                   help="compute peak (default: the card's, 989 TFLOP/s "
                        "under --bf16, 67 with --f32: "
                        "obs.perf.default_peak_tflops)")
    p.add_argument("--hbm-gbps", type=float, default=None)
    p.add_argument("--topk", type=int, default=12)
    p.add_argument("--step-ms", type=float, default=None,
                   help="classify: a measured step time to fold into "
                        "the verdict (floors only when absent)")
    # gate / history
    p.add_argument("--history", default="perf_history.jsonl",
                   help="perf history path (load_cli --history and "
                        "obs.perf.append_history append here)")
    p.add_argument("--metric", action="append", default=None,
                   help="restrict gate/history to metric name(s); "
                        "history treats it as a substring")
    p.add_argument("--baseline-n", type=int, default=None,
                   help="gate: rolling-median window (default 5)")
    p.add_argument("--tolerance", type=float, default=None,
                   help="gate: relative throughput tolerance "
                        "(default 0.05)")
    p.add_argument("--step-tolerance", type=float, default=None,
                   help="gate: relative step_ms tolerance (defaults "
                        "to --tolerance)")
    p.add_argument("--mem-tolerance", type=float, default=None,
                   help="gate: OPT-IN relative peak-memory tolerance "
                        "over the records' \"memory\" blobs — a memory "
                        "regression fails CI like a step-time one; "
                        "omitted = memory is not gated")
    p.add_argument("--comm-tolerance", type=float, default=None,
                   help="gate: OPT-IN relative comm-time tolerance "
                        "over the records' \"comm\" blobs (exposed_s "
                        "for overlapped runs, else measured_s) — an "
                        "overlap regression fails CI even while "
                        "throughput noise hides it; omitted = comm is "
                        "not gated")
    p.add_argument("--latency-tolerance", type=float, default=None,
                   help="gate: OPT-IN relative tail-latency tolerance "
                        "over the records' \"latency\" blobs (load_cli "
                        "runs; best percentile present, p99.9 first; "
                        "obs/load.py) — a serving p99 regression "
                        "fails CI even while throughput holds; "
                        "omitted = latency is not gated")
    p.add_argument("--allow-stale", action="store_true",
                   help="gate: downgrade stale-platform hard fails "
                        "to skips")
    p.add_argument("--prune-stale", action="store_true",
                   help="history: drop *-stale/*-fallback platform "
                        "records from the history file (dry-run "
                        "unless --yes)")
    p.add_argument("--yes", action="store_true",
                   help="history --prune-stale: actually rewrite the "
                        "file (atomically)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    p.add_argument("--use_gpu", type=use_gpu_arg, default=True,
                   help="--selftest's runs: 1 on the card (the default), "
                        "0 on the CPU")
    return p.parse_args(argv)


# ---------------------------------------------------------------------------
# classify
# ---------------------------------------------------------------------------

def _build_model(model_fn, batch, image_size, class_dim, with_loss,
                 channels=3):
    """The repo root's bench-model builder (`__graft_entry__.
    _build_model`), kept here because the port imports nothing of the
    JAX package: (main, startup, logits, avg_loss or None) of
    `model_fn` over a [batch, channels, size, size] image, with a
    softmax cross-entropy loss and Momentum (lr 0.01, momentum 0.9)."""
    from .. import fluid

    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        image = fluid.layers.data(
            name="image", shape=[batch, channels, image_size,
                                 image_size],
            dtype="float32", append_batch_size=False)
        logits = model_fn(image, class_dim=class_dim)
        if with_loss:
            label = fluid.layers.data(name="label", shape=[batch, 1],
                                      dtype="int64",
                                      append_batch_size=False)
            loss = fluid.layers.softmax_with_cross_entropy(logits, label)
            avg_loss = fluid.layers.mean(loss)
            opt = fluid.optimizer.MomentumOptimizer(learning_rate=0.01,
                                                    momentum=0.9)
            opt.minimize(avg_loss)
            return main, startup, logits, avg_loss
    return main, startup, logits, None


def cmd_classify(args):
    from .. import fluid, models
    from ..fluid import analysis
    from ..obs import perf as obs_perf

    fn = {"resnet50": models.resnet50, "alexnet": models.alexnet,
          "vgg16": models.vgg16, "vgg19": models.vgg19,
          "googlenet": models.googlenet,
          "smallnet": models.smallnet_mnist_cifar}[args.model]
    # the program is built under the AMP policy --bf16 names, and the
    # policy is restored afterwards (an in-process caller keeps its own)
    was = fluid.amp.bf16_enabled()
    if args.bf16:
        fluid.amp.enable_bf16()
    try:
        main_prog, _, _, _ = _build_model(fn, args.batch,
                                          args.image_size,
                                          args.class_dim, with_loss=True)
    finally:
        if not was:
            fluid.amp.disable_bf16()
    peak = args.peak_tflops or obs_perf.default_peak_tflops(args.bf16)
    bw = args.hbm_gbps or analysis.DEFAULT_HBM_GBPS
    rep = analysis.roofline_report(main_prog, peak_tflops=peak,
                                   hbm_gbps=bw, bf16_act=args.bf16)
    if args.step_ms is not None:
        blob = obs_perf.leg_perf_blob(
            main_prog, args.step_ms / 1e3, bf16_act=args.bf16,
            peak_tflops=peak, hbm_gbps=bw)
        if args.json:
            print(json.dumps(blob, sort_keys=True))
            return 0
        print(analysis.format_report(rep, topk=args.topk))
        print("\nmeasured %.2f ms -> %s (dominant: %s)  [%s]"
              % (args.step_ms, blob["verdict"], blob["dominant"],
                 blob["reason"]))
        return 0
    if args.json:
        floors = obs_perf.roofline_floors(main_prog,
                                          bf16_act=args.bf16,
                                          peak_tflops=peak,
                                          hbm_gbps=bw,
                                          topk=args.topk)
        print(json.dumps(floors, sort_keys=True))
        return 0
    print(analysis.format_report(rep, topk=args.topk))
    print("\n(no --step-ms given: floors only; pass the measured step "
          "to get a bottleneck verdict)")
    return 0


# ---------------------------------------------------------------------------
# history / gate
# ---------------------------------------------------------------------------

def _prune_stale(args):
    from ..obs import perf as obs_perf

    kept, dropped = obs_perf.prune_stale_history(args.history,
                                                 apply=args.yes)
    if not dropped:
        print("[pperf] no stale-platform records in %s (%d kept)"
              % (args.history, kept))
        return 0
    verb = "dropped" if args.yes else "would drop"
    print("[pperf] %s %d stale-platform record(s) from %s (%d kept):"
          % (verb, len(dropped), args.history, kept))
    for rec in dropped:
        print("  %-52s %-12s %s" % (rec.get("metric", "?"),
                                    rec.get("platform", "?"),
                                    rec.get("leg") or ""))
    if not args.yes:
        print("[pperf] dry run — pass --yes to rewrite the file")
    return 0


def cmd_history(args):
    from ..obs import perf as obs_perf

    if args.prune_stale:
        return _prune_stale(args)
    records = obs_perf.load_history(args.history)
    if not records:
        print("[pperf] no history at %s" % args.history)
        return 2
    wanted = args.metric
    shown = 0
    for r in records:
        metric = r.get("metric", "?")
        if wanted and not any(w in metric for w in wanted):
            continue
        shown += 1
        if args.json:
            print(json.dumps(r, sort_keys=True))
            continue
        print("%-52s %10.4g %-9s step %8s ms  %-12s %s%s"
              % (metric, r.get("value") or 0.0, r.get("unit") or "",
                 ("%.2f" % r["step_ms"]) if r.get("step_ms") else "?",
                 r.get("platform") or "?",
                 r.get("verdict") or "-",
                 (" (%s)" % r["leg"]) if r.get("leg") else ""))
    if not shown:
        print("[pperf] no history rows match %s" % wanted)
        return 2
    return 0


def cmd_gate(args):
    from ..obs import perf as obs_perf

    records = obs_perf.load_history(args.history)
    if not records:
        print("[pperf] gate: no usable history at %s — nothing to "
              "gate" % args.history)
        return 2
    result = obs_perf.gate_history(
        records,
        baseline_n=args.baseline_n or obs_perf.DEFAULT_BASELINE_N,
        tolerance=(obs_perf.DEFAULT_TOLERANCE
                   if args.tolerance is None else args.tolerance),
        step_tolerance=args.step_tolerance,
        allow_stale=args.allow_stale,
        metrics=set(args.metric) if args.metric else None,
        mem_tolerance=args.mem_tolerance,
        comm_tolerance=args.comm_tolerance,
        latency_tolerance=args.latency_tolerance)
    if args.json:
        print(json.dumps(result.to_dict(), sort_keys=True))
    else:
        print(obs_perf.format_gate(result))
    return result.exit_code


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------

def _synthetic_history(path, regress=False, stale=False):
    """Two metrics x 6 rounds of synthetic one-card records (made-up
    round numbers, no measurement) with ±1.5% deterministic noise;
    optionally a 20% regression or a gpu-stale re-emit as the newest
    resnet50 round."""
    from ..obs import perf as obs_perf

    noise = [1.0, 0.988, 1.012, 0.994, 1.009, 0.991]
    legs = {
        "resnet50_train_imgs_per_sec_batch128":
            dict(base=1000.0, unit="img/s", step=128.0,
                 leg="default-b128", verdict="hbm_bound",
                 dominant="conv2d_grad"),
        "vgg16_train_imgs_per_sec_batch128":
            dict(base=500.0, unit="img/s", step=256.0, leg="vgg16",
                 verdict="compute_bound", dominant="conv2d"),
    }
    if os.path.exists(path):
        os.remove(path)
    ts = 1_700_000_000.0
    for i, n in enumerate(noise):
        for metric, spec in legs.items():
            last = i == len(noise) - 1
            value = spec["base"] * n
            platform = "gpu"
            if last and metric.startswith("resnet50"):
                if regress:
                    value = spec["base"] * 0.80
                if stale:
                    platform = "gpu-stale"
            obs_perf.append_history(
                {"metric": metric, "value": round(value, 2),
                 "unit": spec["unit"],
                 "step_ms": round(spec["step"] / n, 2),
                 "mfu": 0.29, "amp_bf16": True, "platform": platform,
                 "perf": {"verdict": spec["verdict"],
                          "dominant": spec["dominant"]}},
                path, leg=spec["leg"], ts=ts + i)
    return path


def _selftest_gate(workdir):
    from ..obs import perf as obs_perf

    # clean trajectory: within-noise movement must pass
    path = _synthetic_history(os.path.join(workdir, "hist_ok.jsonl"))
    res = obs_perf.gate_history(obs_perf.load_history(path))
    assert res.ok, "noise-only history failed the gate:\n%s" \
        % obs_perf.format_gate(res)
    assert len(res.checked) == 2, res.to_dict()

    # injected 20% regression: must fail, naming metric + leg + verdict
    path = _synthetic_history(os.path.join(workdir, "hist_bad.jsonl"),
                              regress=True)
    res = obs_perf.gate_history(obs_perf.load_history(path))
    assert not res.ok, "20%% regression passed the gate"
    text = obs_perf.format_gate(res)
    f = res.failures[0]
    assert f["metric"].startswith("resnet50"), res.failures
    assert f["kind"] == "throughput", res.failures
    assert "resnet50" in text and "hbm_bound" in text \
        and "default-b128" in str(res.failures[0]["leg"]), text
    # CLI exit-code contract, end to end
    rc = main(["gate", "--history", path])
    assert rc == 1, "perf_cli gate exit code %r for a regression" % rc

    # gpu-stale newest record: hard platform fail, skip when allowed
    path = _synthetic_history(os.path.join(workdir, "hist_stale.jsonl"),
                              stale=True)
    res = obs_perf.gate_history(obs_perf.load_history(path))
    assert not res.ok and res.failures[0]["kind"] == "platform", \
        res.to_dict()
    res = obs_perf.gate_history(obs_perf.load_history(path),
                                allow_stale=True)
    assert res.ok and res.skipped, res.to_dict()
    return text


def _selftest_profiler(workdir, use_gpu):
    from ..obs import perf as obs_perf
    from .obs_dump import _train_tiny_v2, validate_chrome_trace

    profiler = obs_perf.install(capacity=64, sample_every=1)
    try:
        _train_tiny_v2(use_gpu)
    finally:
        obs_perf.uninstall()
    recs = profiler.records()
    assert recs, "profiler saw no steps"
    for r in recs:
        assert r["wall_s"] > 0 and "retraces" in r \
            and "pcache_hits" in r, r
    assert any(r["sampled"] and r["device_s"] is not None
               for r in recs), "no sampled step captured a time split"
    for r in recs:
        # the JAX selftest asserts its first step's jit builds; the
        # port's eager executor compiles nothing (ROADMAP A2)
        assert r["retraces"] == 0 and r["pcache_hits"] == 0, r
        assert r["device_s"] is None or r["device_s"] <= r["wall_s"], r
    summary = profiler.summary()
    assert summary["steps"] == len(recs) and "split_ms" in summary, \
        summary
    verdict = profiler.classify()
    assert verdict and verdict["verdict"] in obs_perf.VERDICTS, verdict
    # exports: Chrome trace loads, JSONL parses line by line
    trace_path = os.path.join(workdir, "perf_trace.json")
    profiler.export_chrome_trace(trace_path)
    events = validate_chrome_trace(trace_path)
    assert any(ev.get("cat") == "perf" and ev["ph"] == "X"
               for ev in events), "no per-step spans in export"
    for line in profiler.export_jsonl().strip().splitlines():
        json.loads(line)
    return len(recs), verdict["verdict"]


def _selftest_slo(place):
    import numpy as np

    from .. import fluid
    from ..fluid import io as fluid_io
    from ..serving import (EngineConfig, InferenceEngine,
                           InferenceServer, ServerConfig)

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[8], dtype="float32")
        probs = fluid.layers.fc(input=img, size=3, act="softmax")
    scope = fluid.Scope()
    fluid.Executor(place).run(startup, scope=scope)
    program = fluid_io.prune_program(main, [probs])
    engine = InferenceEngine(program, ["img"], [probs], place=place,
                             scope=scope,
                             config=EngineConfig(batch_buckets=[2, 4]))
    # loopback: batcher running, no HTTP listener — handle_infer and
    # health_signals are exactly what the HTTP handlers call
    server = InferenceServer(
        engine, ServerConfig(warmup=False, slo_ms=0.0001,
                             slo_target=0.99, model_name="tiny-fc"))
    server.batcher.start()
    try:
        for _ in range(4):
            status, body = server.handle_infer(
                {"inputs": {"img": np.zeros((2, 8)).tolist()}})
            assert status == 200, (status, body)
        health = server.health_signals()
    finally:
        server.batcher.close()
    assert "slo_burn_rate" in health, health
    assert health["slo"]["model"] == "tiny-fc", health
    # a 0.1µs objective is unmeetable: the whole window violates, so
    # burn = 1 / (1 - target) = 100x budget
    assert health["slo_burn_rate"] > 1, health
    # generous objective on the same histogram: burn ~ 0
    from ..serving.metrics import SLOTracker

    relaxed = SLOTracker(server.metrics, objective_ms=20_000,
                         target=0.99, model="tiny-fc-relaxed")
    assert relaxed.update() == 0.0
    # an objective beyond the histogram's largest finite bucket is
    # unmeasurable and must be rejected at construction
    try:
        SLOTracker(server.metrics, objective_ms=60_000)
    except ValueError:
        pass
    else:
        raise AssertionError("out-of-range slo_ms was accepted")
    return health["slo_burn_rate"]


def selftest(args):
    import shutil

    place = cli_place(args.use_gpu)
    place.device()  # a CUDAPlace without a CUDA device raises here
    workdir = tempfile.mkdtemp(prefix="paddle_pperf_")

    try:
        gate_text = _selftest_gate(workdir)
        steps, verdict = _selftest_profiler(workdir, args.use_gpu)
        burn = _selftest_slo(place)
    finally:
        # a CI step runs this every time: don't stack /tmp dirs
        shutil.rmtree(workdir, ignore_errors=True)

    print("[pperf] selftest green: gate discriminates (sample fail "
          "line below), %d profiled steps (verdict %s), loopback "
          "slo_burn_rate %.1f\n%s"
          % (steps, verdict, burn,
             gate_text.splitlines()[1] if len(gate_text.splitlines())
             > 1 else gate_text), flush=True)
    print("[pperf] the warm compile-cache leg waits with the persistent "
          "executable cache (ROADMAP A2)", flush=True)
    return 0


def main(argv=None):
    args = parse_args(argv)
    if args.selftest:
        return selftest(args)
    if args.cmd == "classify":
        return cmd_classify(args)
    if args.cmd == "gate":
        return cmd_gate(args)
    if args.cmd == "history":
        return cmd_history(args)
    raise SystemExit("nothing to do: pass a command (classify | gate "
                     "| history) or --selftest")


if __name__ == "__main__":
    sys.exit(main())
