"""Persistent plan cache CLI: stats / prewarm / gc / selftest for
`paddle_tpu_torch.compile`.

    # the certification run, on the card (--use_gpu=0: on the CPU):
    python -m paddle_tpu_torch.tools.pcache_cli --selftest

    # operator surface:
    python -m paddle_tpu_torch.tools.pcache_cli stats   --cache-dir DIR
    python -m paddle_tpu_torch.tools.pcache_cli gc      --cache-dir DIR \
        --max-bytes 1073741824
    python -m paddle_tpu_torch.tools.pcache_cli prewarm --cache-dir DIR \
        --model-dir EXPORT

Counterpart of paddle_tpu/tools/pcache_cli.py.  A port entry holds a
program's plan (the pass-rewritten clone, its segment plan, its
donation plan, the verifier's verdict), not an executable: a CUDA graph
cannot be saved, so a restarted process reloads its plans and captures
its graphs again (compile/pcache.py).  `prewarm` plans a saved
inference model's program through the serving engine's warmup, every
batch bucket, so the next process (the real deploy) starts with its
plans on disk.

`--selftest` certifies the cache end to end at the place `--use_gpu`
names, with the JAX selftest's legs:

  1. **a cold run fills the cache**: a lenet5 forward runs three times
     with the cache on (a warm-up, a capture, a replay); its program's
     plan and each capture's stub land on disk;
  2. **a simulated restart hits every plan**: fresh Programs, a fresh
     Executor and Scope and `pcache.reset()` (everything a process
     restart clears) run the same content: every plan is a hit, the
     pass pipeline runs 0 times, and the outputs equal the cold run's
     bit for bit.  The JAX leg asserts zero XLA compiles; the port's
     restart captures its graphs again, and those captures are
     counted apart;
  3. **corruption quarantines, never crashes**: a byte of the plan entry
     is flipped on disk; the next run finds it (CRC), moves it to the
     quarantine, plans anew and still gives the cold run's bits;
  4. **the rewrite passes keep semantics**: pass-optimized and plain
     lenet5 forwards give the same bits with the verifier green around
     every pass, a crafted program shows each pass (dce, fold, cse,
     dve) rewrites, and a pass config changes the fingerprint; the
     cost-model-guided pipeline (`compile/opt_passes.py`) keys apart
     from `default`, per knob, and reloads from the cache.

The green line prints the cold and warm plan seconds and the captures
of each run; on the CPU a capture is the plan path's plain version.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from . import cli_place, use_gpu_arg


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="pcache_cli")
    p.add_argument("cmd", nargs="?",
                   choices=["stats", "prewarm", "gc"],
                   help="operator command (or use --selftest)")
    p.add_argument("--selftest", action="store_true",
                   help="plan-cache and rewrite-pass certification")
    p.add_argument("--cache-dir", default=None,
                   help="cache root (default: FLAGS_compile_cache_dir)")
    p.add_argument("--model-dir", default=None,
                   help="prewarm: a save_inference_model export to plan "
                        "through the serving engine")
    p.add_argument("--max-bytes", type=int, default=None,
                   help="gc: override the LRU size cap")
    p.add_argument("--keep-quarantine", action="store_true",
                   help="gc: do not clear the quarantine directory")
    p.add_argument("--passes", default="default",
                   help="prewarm/selftest rewrite pipeline spec")
    p.add_argument("--explain", action="store_true",
                   help="selftest: print the per-pass rewrite diff")
    p.add_argument("--json", action="store_true",
                   help="stats/gc: machine-readable output")
    p.add_argument("--use_gpu", type=use_gpu_arg, default=True,
                   help="prewarm and the selftest: on the card (1, the "
                        "default) or on the CPU (0)")
    return p.parse_args(argv)


def _root(args):
    from paddle_tpu_torch.utils import flags

    root = args.cache_dir or flags.get_flag("compile_cache_dir")
    if not root:
        raise SystemExit("no cache dir: pass --cache-dir or set "
                         "FLAGS_compile_cache_dir")
    return root


def cmd_stats(args):
    from paddle_tpu_torch.compile import pcache

    stats = pcache.PersistentCache(_root(args)).stats()
    if args.json:
        print(json.dumps(stats, indent=1, sort_keys=True))
    else:
        print("[pcache] %(root)s: %(entries)d entries (%(stubs)d capture "
              "stubs), %(bytes)d bytes (cap %(max_bytes)d), "
              "%(quarantined)d quarantined" % stats)
    return 0


def cmd_gc(args):
    from paddle_tpu_torch.compile import pcache

    summary = pcache.PersistentCache(_root(args)).gc(
        max_bytes=args.max_bytes,
        clear_quarantine=not args.keep_quarantine)
    if args.json:
        print(json.dumps(summary, indent=1, sort_keys=True))
    else:
        print("[pcache] gc: evicted %(evicted)d, cleared %(quarantine_"
              "cleared)d quarantined; now %(entries)d entries / "
              "%(bytes)d bytes" % summary)
    return 0


def cmd_prewarm(args):
    """Plan a saved inference model into the cache through the serving
    engine's warmup (every batch bucket), so the next process starts
    with its plans on disk."""
    from paddle_tpu_torch.compile import pcache
    from paddle_tpu_torch.obs import telemetry as obs_tele
    from paddle_tpu_torch.serving.engine import InferenceEngine
    from paddle_tpu_torch.utils import flags

    if not args.model_dir:
        raise SystemExit("prewarm needs --model-dir (a "
                         "save_inference_model export)")
    flags.set_flag("compile_cache_dir", _root(args))
    if args.passes:
        flags.set_flag("compile_passes", args.passes)
    t0 = time.perf_counter()
    snap = obs_tele.snapshot()
    engine = InferenceEngine.from_saved_model(
        args.model_dir, place=cli_place(args.use_gpu))
    warmed = engine.warmup()
    dt = time.perf_counter() - t0
    delta = obs_tele.snapshot_delta(snap)
    stats = pcache.get_cache().stats()
    print("[pcache] prewarmed %d bucket(s) in %.1fs (%d plan(s) made, "
          "%d loaded, %d capture(s)); cache now %d entries / %d bytes"
          % (warmed, dt, delta.get("compile_cache_misses_total", 0),
             delta.get("compile_cache_hits_total", 0),
             engine.last_warmup_stats["captures"], stats["entries"],
             stats["bytes"]))
    return 0


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------

def _fresh_workspace():
    from paddle_tpu_torch.core import scope as scope_mod
    from paddle_tpu_torch.fluid import framework

    framework.switch_main_program(framework.Program())
    framework.switch_startup_program(framework.Program())
    scope_mod._global_scope = scope_mod.Scope()


def _build_lenet5_forward():
    """A lenet5 forward in a fresh Program pair, built identically on
    every call (deterministic names): the restart's property the
    fingerprint relies on."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models.image import lenet5

    framework.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 28, 28],
                                dtype="float32")
        probs = lenet5(img, class_dim=10)
    return main, startup, probs.name


def _run_forward(place, main, startup, probs_name, img, runs=3):
    """(the last run's output, the executor): startup seeded alike, then
    `runs` runs of the forward (a warm-up, a capture, replays)."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    out = None
    for _ in range(runs):
        out = exe.run(main, feed={"img": img}, fetch_list=[probs_name],
                      scope=scope)[0]
    return np.asarray(out), exe


def _plan_seconds(exe):
    """The planning host seconds of every program the executor ran."""
    return sum(v for _d, _v, c in exe._cache.values()
               for k, v in c.seconds.items()
               if k in ("verify", "passes", "plan", "donation", "load"))


def _entry_files(cache_dir):
    root = os.path.join(cache_dir, "entries")
    for sub in sorted(os.listdir(root)):
        for f in sorted(os.listdir(os.path.join(root, sub))):
            yield os.path.join(root, sub, f)


def _selftest_cache(place, workdir, report):
    import numpy as np

    from paddle_tpu_torch.compile import pcache
    from paddle_tpu_torch.obs import telemetry as obs_tele
    from paddle_tpu_torch.utils import flags

    cache_dir = os.path.join(workdir, "cache")
    flags.set_flag("compile_cache_dir", cache_dir)
    flags.set_flag("compile_passes", "default")
    pcache.reset()
    img = np.random.RandomState(0).rand(4, 1, 28, 28).astype(np.float32)
    try:
        # 1. a cold run fills the cache
        _fresh_workspace()
        main, startup, probs = _build_lenet5_forward()
        snap = obs_tele.snapshot()
        out_cold, exe = _run_forward(place, main, startup, probs, img)
        cold = obs_tele.snapshot_delta(snap)
        stats = pcache.get_cache().stats()
        assert cold.get("compile_cache_misses_total", 0) > 0, cold
        assert stats["entries"] > stats["stubs"] > 0, stats
        cold_plan_s, cold_captures = _plan_seconds(exe), exe.captures
        assert exe.pipeline_runs > 0, "the cold run ran no pipeline"

        # 2. a simulated restart: every plan a hit, no pipeline run
        _fresh_workspace()
        pcache.reset()
        main, startup, probs = _build_lenet5_forward()
        snap = obs_tele.snapshot()
        out_warm, exe = _run_forward(place, main, startup, probs, img)
        warm = obs_tele.snapshot_delta(snap)
        assert warm.get("compile_cache_hits_total", 0) >= 2 \
            and not warm.get("compile_cache_misses_total", 0), warm
        assert exe.pipeline_runs == 0, \
            "the warm restart ran the pass pipeline %d time(s)" \
            % exe.pipeline_runs
        assert all(c.acquired == "hit" for _d, _v, c in
                   exe._cache.values())
        assert exe.captures == cold_captures, (exe.captures,
                                               cold_captures)
        assert np.array_equal(out_cold, out_warm), \
            "the warm restart's outputs differ from the cold run's"
        assert pcache.get_cache().stats()["entries"] == stats["entries"]
        warm_plan_s, warm_captures = _plan_seconds(exe), exe.captures

        # 3. a flipped byte in the main program's plan is quarantined
        entry = max((f for f in _entry_files(cache_dir)),
                    key=os.path.getsize)
        blob = bytearray(open(entry, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        with open(entry, "wb") as f:
            f.write(bytes(blob))
        _fresh_workspace()
        pcache.reset()
        snap = obs_tele.snapshot()
        main, startup, probs = _build_lenet5_forward()
        out_fixed, exe = _run_forward(place, main, startup, probs, img)
        delta = obs_tele.snapshot_delta(snap)
        assert np.array_equal(out_cold, out_fixed)
        assert delta.get("compile_cache_errors_total{kind=corrupt}",
                         0) == 1, delta
        assert pcache.get_cache().stats()["quarantined"] == 1
    finally:
        flags.set_flag("compile_cache_dir", "")
        flags.set_flag("compile_passes", "")
        pcache.reset()
    report.update(cold_plan_s=cold_plan_s, warm_plan_s=warm_plan_s,
                  cold_captures=cold_captures, warm_captures=warm_captures,
                  entries=stats["entries"])
    print("[pcache] cache leg green: cold run planned in %.4fs with %d "
          "capture(s) -> restart reloaded every plan in %.4fs (0 pipeline "
          "runs, %d capture(s) of its own), bit-identical outputs; "
          "corrupt entry quarantined"
          % (cold_plan_s, cold_captures, warm_plan_s, warm_captures),
          flush=True)


def _selftest_passes(place, args, report):
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.compile import fingerprint, passes

    # 4a. lenet5 forward: optimized and plain give the same bits; the
    #     PassManager verifies around every pass
    img = np.random.RandomState(0).rand(4, 1, 28, 28).astype(np.float32)
    _fresh_workspace()
    main, startup, probs = _build_lenet5_forward()
    pm = passes.PassManager(args.passes, verify_level="full",
                            explain=args.explain)
    optimized = pm.run(main, fetches=[probs])
    out_plain, _ = _run_forward(place, main, startup, probs, img, runs=1)
    out_opt, _ = _run_forward(place, optimized, startup, probs, img,
                              runs=1)
    assert np.array_equal(out_plain, out_opt)
    if args.explain:
        print(pm.explain_text(), flush=True)

    # 4b. every pass rewrites the crafted program
    _fresh_workspace()
    m2, s2 = fluid.Program(), fluid.Program()
    with fluid.program_guard(m2, s2):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32",
                              append_batch_size=False)
        y = fluid.layers.scale(x=x, scale=2.0)
        fluid.layers.scale(x=x, scale=9.0)          # dead (dce)
        y2 = fluid.layers.scale(x=x, scale=2.0)     # duplicate (cse)
        z = fluid.layers.elementwise_add(x=y, y=y2)
        blk = m2.global_block()
        sv = blk.create_var(name="shp_vec", dtype="int32", shape=[1])
        blk.append_op(type="shape", inputs={"Input": [y.name]},
                      outputs={"Out": [sv.name]},
                      infer_shape=False)             # foldable
        shp = fluid.layers.cast(x=sv, dtype="float32")
        fin = fluid.layers.elementwise_add(
            x=z, y=fluid.layers.reduce_sum(shp))
    pm2 = passes.PassManager("default", verify_level="full",
                             explain=True)
    o2 = pm2.run(m2, fetches=[fin.name])
    changed = {r["pass"]: r["changed"] for r in pm2.records}
    assert all(changed.values()), \
        "some pass rewrote nothing on the crafted program: %s" % changed
    xv = np.arange(4, dtype=np.float32)

    def run_feed_x(prog):
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        exe.run(s2, scope=scope)
        return np.asarray(exe.run(prog, feed={"x": xv},
                                  fetch_list=[fin.name], scope=scope)[0])

    assert np.array_equal(run_feed_x(m2), run_feed_x(o2))

    # 4c. the pipeline id feeds the fingerprint: entries never alias
    #     across pass configs
    fp_plain = fingerprint.program_fingerprint(main, pipeline_id="")
    fp_piped = fingerprint.program_fingerprint(
        main, pipeline_id=pm.pipeline_id)
    assert fp_plain != fp_piped, "pipeline id did not change the key"
    report["passes"] = {r["pass"]: "%d->%d" % (r["ops_before"],
                                               r["ops_after"])
                        for r in pm2.records}
    print("[pcache] passes leg green: lenet5 forward bit-identical "
          "under %s (verifier green around every pass); crafted "
          "program rewritten by every pass (%s); pass config changes "
          "the cache key" % (pm.pipeline_id, report["passes"]),
          flush=True)


def _selftest_opt_passes(place, workdir, report):
    """The cost-model-guided pipeline with the cache: a layout+fuse
    pipeline keys apart from `default` (knobs included), and the
    optimized program reloads its plan from disk (0 pipeline runs)
    while giving the plain forward's bits."""
    import numpy as np

    from paddle_tpu_torch.compile import pcache
    from paddle_tpu_torch.compile import passes as passes_mod
    from paddle_tpu_torch.utils import flags

    spec = "default+layout:force=1+fuse"
    ids = {passes_mod.pipeline_id("default"),
           passes_mod.pipeline_id(spec),
           passes_mod.pipeline_id(spec + ":cap=2")}
    assert len(ids) == 3, \
        "pipeline ids alias across pass/knob configs: %s" % ids
    img = np.random.RandomState(0).rand(4, 1, 28, 28).astype(np.float32)
    try:
        _fresh_workspace()
        main, startup, probs = _build_lenet5_forward()
        out_plain, _ = _run_forward(place, main, startup, probs, img,
                                    runs=1)
        flags.set_flag("compile_cache_dir",
                       os.path.join(workdir, "optcache"))
        flags.set_flag("compile_passes", spec)
        pcache.reset()
        _fresh_workspace()
        main, startup, probs = _build_lenet5_forward()
        out_cold, exe = _run_forward(place, main, startup, probs, img,
                                     runs=1)
        assert exe.pipeline_runs > 0
        _fresh_workspace()
        pcache.reset()
        main, startup, probs = _build_lenet5_forward()
        out_warm, exe = _run_forward(place, main, startup, probs, img,
                                     runs=1)
        assert exe.pipeline_runs == 0, \
            "the optimized warm reload ran the pipeline %d time(s)" \
            % exe.pipeline_runs
        # the layout pass transposes: the forward agrees to rounding
        np.testing.assert_allclose(out_plain, out_cold, rtol=1e-5,
                                   atol=1e-6)
        assert np.array_equal(out_cold, out_warm)
    finally:
        flags.set_flag("compile_cache_dir", "")
        flags.set_flag("compile_passes", "")
        pcache.reset()
    report["opt_pipeline"] = passes_mod.pipeline_id(spec)
    print("[pcache] opt-passes leg green: %s keys apart from default "
          "(and per knob), its plan reloaded from disk with 0 pipeline "
          "runs and the cold run's bits" % report["opt_pipeline"],
          flush=True)


def selftest(args):
    place = cli_place(args.use_gpu)
    place.device()  # a CUDAPlace without a CUDA device raises here
    workdir = tempfile.mkdtemp(prefix="paddle_pcache_")
    report = {}
    try:
        _selftest_cache(place, workdir, report)
        _selftest_passes(place, args, report)
        _selftest_opt_passes(place, workdir, report)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print("[pcache] selftest green: cold plan %.4fs -> warm %.4fs, %d "
          "capture(s) a run (cold) and %d (warm), %d entries; quarantine "
          "and rewrite contracts hold"
          % (report["cold_plan_s"], report["warm_plan_s"],
             report["cold_captures"], report["warm_captures"],
             report["entries"]), flush=True)
    return 0


def main(argv=None):
    args = parse_args(argv)
    if args.selftest:
        return selftest(args)
    if args.cmd == "stats":
        return cmd_stats(args)
    if args.cmd == "gc":
        return cmd_gc(args)
    if args.cmd == "prewarm":
        return cmd_prewarm(args)
    parse_args(["--help"])
    return 2


if __name__ == "__main__":
    sys.exit(main())
