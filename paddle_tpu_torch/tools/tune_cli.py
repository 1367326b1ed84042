"""Autotuner CLI ("ptune"): offline launch-config search over
`paddle_tpu_torch.tune` — rank the whole space with zero devices,
measure only the top-K, learn from what was measured.

    # the certification run, its measurement legs on the card
    # (--use_gpu=0: on the CPU)
    python -m paddle_tpu_torch.tools.tune_cli --selftest

    # "what config do I launch lenet5 with on 8 cards of 80 GB": a
    # ranked, priced table + a reproducible launch plan JSON — needs
    # no card
    python -m paddle_tpu_torch.tools.tune_cli plan --model lenet5 \
        --chips 8 --hbm-gb 80 --out plan.json

    # measure only the top-3 survivors, each on one card (records land
    # in perf_history.jsonl with leg ptune:<tag> + a "config" blob):
    python -m paddle_tpu_torch.tools.tune_cli measure --plan plan.json \
        --topk 3

    # fit the per-term correction from everything measured so far and
    # save it; the next `plan --calibration` ranks with it:
    python -m paddle_tpu_torch.tools.tune_cli fit --plan plan.json \
        --calibration ptune_cal.json
    python -m paddle_tpu_torch.tools.tune_cli plan --model lenet5 \
        --chips 8 --hbm-gb 80 --calibration ptune_cal.json

Counterpart of paddle_tpu/tools/tune_cli.py.  `plan`, `fit` and
`report` touch no device.  `measure` and `--selftest` run each
measurement leg (`tune/leg.py`, a child process) on the card, or on the
CPU with `--use_gpu=0`; without a CUDA device they raise unless asked
for the CPU.  `--selftest` certifies the loop end to end on lenet5
against a static 8-device mesh:

  1. **deterministic ranking** — two fresh `ptune plan --json`
     processes must emit byte-identical plans;
  2. **static rejection** — an injected S002-invalid mesh (batch not
     divisible by dp) and an S005 over-budget plan are rejected at
     rank time with their exact codes, and the S002 candidate
     provably never reaches measurement;
  3. **measured top-K** — the top-2 candidates run through the
     measurement leg; their records land in the history file with
     `"config"` blobs and `ptune:` legs;
  4. **calibration** — `fit` over those records reports a model error
     that does not rise after ingesting the measurements, and a
     re-rank with the fitted calibration changes the predictions.

Its plan budget is the card's memory (`--hbm-gb 80`).
"""

import argparse
import json
import os
import sys
import tempfile
import time

from . import cli_place, use_gpu_arg


def _csv(text):
    return [t.strip() for t in str(text).split(",") if t.strip()]


def _csv_int(text):
    return [int(t) for t in _csv(text)]


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="ptune")
    p.add_argument("cmd", nargs="?",
                   choices=["plan", "measure", "fit", "report"],
                   help="operator command (or use --selftest)")
    p.add_argument("--selftest", action="store_true",
                   help="full plan->rank->measure->fit loop on lenet5 "
                        "with a static 8-device mesh")
    # plan: the model + target
    p.add_argument("--model", default="lenet5",
                   help="model to tune (tune/models.py zoo)")
    p.add_argument("--chips", type=int, default=8,
                   help="device count the plan targets")
    p.add_argument("--hbm-gb", type=float, default=None,
                   help="per-device memory budget in GiB (enables the "
                        "S005 rejection)")
    # plan: the space
    p.add_argument("--meshes", default=None,
                   help="comma list of mesh specs (dp=4,mp=2 style "
                        "uses '=' and axis names, so separate CANDIDATE "
                        "meshes with ';'), default: every factorization "
                        "of --chips over --axes")
    p.add_argument("--axes", default="dp,mp",
                   help="axes to enumerate meshes over (default dp,mp)")
    p.add_argument("--batches", default="64,128,256",
                   help="global batch sizes (comma list)")
    p.add_argument("--micro-batches", default="1,2,4",
                   help="micro-batch splits (comma list)")
    p.add_argument("--pipelines", default="none,default",
                   help="pass pipelines (comma list of 'none', "
                        "'default', or +-joined pass names like "
                        "dce+fold or default+layout+fuse+auto_remat; "
                        "pass knobs attach with ':' — fuse:cap=8)")
    p.add_argument("--fusion-caps", default="0",
                   help="fuse:cap= settings crossed with pipelines "
                        "containing a bare fuse pass (comma ints; 0 = "
                        "pipeline default)")
    p.add_argument("--remat-strides", default="0",
                   help="auto_remat:stride= settings crossed with "
                        "pipelines containing a bare auto_remat pass "
                        "(comma ints; 0 = pipeline default)")
    # plan: the cost model
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--class-dim", type=int, default=None)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--f32", dest="bf16", action="store_false")
    p.add_argument("--peak-tflops", type=float, default=None)
    p.add_argument("--hbm-gbps", type=float, default=None)
    p.add_argument("--calibration", default=None,
                   help="plan: rank with this fitted calibration; "
                        "fit: save the fitted calibration here")
    p.add_argument("--hbm-calibration", default=None,
                   help="plan: a `pmem drift --calibration-out` blob; "
                        "its measured actual/static ratio scales the "
                        "static memory peak before the S005 budget "
                        "check (tune.fit.load_hbm_calibration)")
    p.add_argument("--comm-calibration", default=None,
                   help="fit: a `pcomm report --calibration-out` "
                        "blob; its measured/predicted ring pairs "
                        "price the comm coefficient alongside any "
                        "multichip history records "
                        "(tune.fit.load_comm_calibration)")
    p.add_argument("--out", default=None,
                   help="plan: write the launch plan JSON here")
    p.add_argument("--topk", type=int, default=None,
                   help="plan: table rows; measure: candidates to run "
                        "(default 3)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    # measure / fit / report
    p.add_argument("--plan", dest="plan_path", default=None,
                   help="launch plan JSON from `ptune plan --out`")
    p.add_argument("--history", default="perf_history.jsonl",
                   help="perf history path (the measurement leg "
                        "appends here)")
    p.add_argument("--iters", type=int, default=2)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--cache-dir", default=None,
                   help="measure: FLAGS_compile_cache_dir for the "
                        "legs (the persistent plan cache)")
    p.add_argument("--timeout", type=float, default=900,
                   help="measure: per-candidate wall-clock bound")
    p.add_argument("--use_gpu", type=use_gpu_arg, default=True,
                   help="measure and the selftest: the legs on the card "
                        "(1, the default) or on the CPU (0)")
    return p.parse_args(argv)


def _pipelines(arg):
    # '+' joins pass names on the command line because ',' separates
    # pipeline candidates: "none,default,dce+fold"
    return [p.replace("+", ",") for p in _csv(arg)]


def _build_space(args):
    from ..tune.space import SearchSpace

    meshes = None
    if args.meshes:
        meshes = [m.strip() for m in args.meshes.split(";")
                  if m.strip()]
    return SearchSpace(
        args.chips, meshes=meshes,
        pipelines=_pipelines(args.pipelines),
        batches=_csv_int(args.batches),
        micro_batches=_csv_int(args.micro_batches),
        axes=tuple(_csv(args.axes)),
        fusion_caps=_csv_int(args.fusion_caps),
        remat_strides=_csv_int(args.remat_strides))


def _rank_plan(args, extra_candidates=(), hbm_gb="arg"):
    from ..fluid import amp
    from ..tune import models as tune_models
    from ..tune import rank as tune_rank
    from ..utils import flags

    space = _build_space(args)
    candidates = space.points() + list(extra_candidates)
    calibration = None
    if args.calibration and os.path.exists(args.calibration):
        calibration = tune_rank.Calibration.load(args.calibration)
    hbm_ratio = None
    if getattr(args, "hbm_calibration", None):
        from ..tune.fit import load_hbm_calibration

        hbm_ratio = load_hbm_calibration(args.hbm_calibration)
    builder = tune_models.builder(args.model, image_size=args.image_size,
                                  class_dim=args.class_dim)
    # the EFFECTIVE builder knobs (CLI override or model default) ride
    # in the plan context so `ptune measure` replays the same program
    # the ranking priced
    spec = tune_models.MODELS[args.model]
    extra_context = {
        "image_size": int(args.image_size or spec["image_size"]),
        "class_dim": int(args.class_dim or spec["class_dim"]),
    }
    # the programs are built under the plan's AMP mode, as the JAX CLI
    # builds them; the process's flag is restored after
    saved = flags.get_flag("amp_bf16")
    if args.bf16:
        amp.enable_bf16()
    else:
        amp.disable_bf16()
    try:
        return tune_rank.rank(
            builder, candidates, args.chips, model=args.model,
            hbm_gb=args.hbm_gb if hbm_gb == "arg" else hbm_gb,
            calibration=calibration, bf16_act=args.bf16,
            peak_tflops=args.peak_tflops, hbm_gbps=args.hbm_gbps,
            space_dict=space.to_dict(), skipped=space.skipped,
            extra_context=extra_context, hbm_ratio=hbm_ratio)
    finally:
        flags.set_flag("amp_bf16", saved)


def cmd_plan(args):
    plan = _rank_plan(args)
    if args.out:
        plan.save(args.out)
    if args.json:
        print(plan.to_json())
    else:
        print(plan.format_table(topk=args.topk))
        if args.out:
            print("[ptune] launch plan written to %s" % args.out)
    if not plan.ranked:
        print("[ptune] every candidate was rejected — see the plan's "
              "rejected list", file=sys.stderr)
        return 1
    return 0


def _load_plan(args):
    if not args.plan_path:
        raise SystemExit("--plan <plan.json> is required (make one "
                         "with `ptune plan --out plan.json`)")
    with open(args.plan_path) as f:
        return json.load(f)


def _leg_env(use_gpu):
    """The legs' device: the card (a CUDAPlace, which raises here
    without a CUDA device) or, asked, the CPU."""
    cli_place(use_gpu).device()
    return None if use_gpu else {"BENCH_USE_GPU": "0"}


def cmd_measure(args):
    from ..tune import measure as tune_measure

    plan = _load_plan(args)
    results = tune_measure.measure_plan(
        plan, topk=args.topk or 3, history=args.history,
        iters=args.iters, warmup=args.warmup,
        image_size=args.image_size, cache_dir=args.cache_dir,
        extra_env=_leg_env(args.use_gpu), timeout=args.timeout,
        echo=lambda msg: print(msg, flush=True))
    ok = 0
    for r in results:
        if r["ok"]:
            ok += 1
            rec = r["record"]
            print("[ptune] %-44s %10.4g %-9s step %.2f ms (%s)"
                  % (r["tag"], rec.get("value") or 0.0,
                     rec.get("unit") or "", rec.get("step_ms") or 0.0,
                     rec.get("platform")))
        else:
            print("[ptune] %-44s FAILED: %s" % (r["tag"], r["error"]),
                  file=sys.stderr)
    print("[ptune] measured %d/%d candidate(s); history: %s"
          % (ok, len(results), args.history))
    return 0 if ok == len(results) and results else 1


def _join(args, plan):
    from ..obs import perf as obs_perf
    from ..tune import fit as tune_fit

    records = obs_perf.load_history(args.history)
    return tune_fit.join_history(plan, records)


def cmd_fit(args):
    from ..obs import perf as obs_perf
    from ..tune import fit as tune_fit

    plan = _load_plan(args)
    pairs = _join(args, plan)
    if not pairs:
        print("[ptune] no ptune-tagged measurements in %s for this "
              "plan — run `ptune measure` first" % args.history)
        return 2
    # multi-card comm measurements (spmd/bench.py legs) price the comm
    # coefficient when the history has any from the training class
    comm_pairs = tune_fit.join_comm_history(
        obs_perf.load_history(args.history))
    if getattr(args, "comm_calibration", None):
        comm_pairs = comm_pairs + tune_fit.load_comm_calibration(
            args.comm_calibration)
    cal = tune_fit.fit_calibration(pairs, model=plan.get("model"),
                                   comm_pairs=comm_pairs)
    if args.json:
        print(json.dumps({"calibration": cal.to_dict(),
                          "pairs": len(pairs),
                          "comm_pairs": len(comm_pairs)},
                         sort_keys=True))
    else:
        print(tune_fit.format_fit_report(cal, pairs))
    if args.calibration:
        cal.save(args.calibration)
        if not args.json:
            print("[ptune] calibration saved to %s (rank with "
                  "`ptune plan --calibration %s`)"
                  % (args.calibration, args.calibration))
    return 0


def cmd_report(args):
    """Like fit, but read-only: show the current calibration's error
    against the measured history without refitting or saving."""
    from ..tune import fit as tune_fit
    from ..tune.rank import Calibration

    plan = _load_plan(args)
    pairs = _join(args, plan)
    if not pairs:
        print("[ptune] no ptune-tagged measurements in %s for this "
              "plan" % args.history)
        return 2
    cal = Calibration.identity()
    if args.calibration and os.path.exists(args.calibration):
        cal = Calibration.load(args.calibration)
    err = tune_fit._rel_error(pairs, cal.coef["compute"],
                              cal.coef["overhead"], cal.bias_s)
    if args.json:
        print(json.dumps({"calibration": cal.to_dict(),
                          "pairs": len(pairs),
                          "median_rel_error": round(err, 6)},
                         sort_keys=True))
    else:
        print(tune_fit.format_fit_report(cal, pairs))
        print("[ptune] current median relative error: %.1f%% over %d "
              "measurement(s)" % (err * 100, len(pairs)))
    return 0


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------

# the JAX selftest's space but for two knobs: the card's memory as the
# budget, and the `none` pipeline alone.  With `default` beside it the
# top-2 are one lenet5 program twice (`default` changes none of its ops,
# and both are priced alike), which leaves the fit two copies of one
# point; without it they are batch 32 and 64, two programs whose terms
# differ
_SELFTEST_PLAN_ARGS = [
    "plan", "--model", "lenet5", "--chips", "8", "--hbm-gb", "80",
    "--batches", "32,64", "--micro-batches", "1,2",
    "--pipelines", "none", "--json",
]


def _selftest_determinism(meanwhile):
    """Two FRESH processes must emit byte-identical plan JSON;
    `meanwhile()` runs in this process while they do, and its result is
    returned."""
    import subprocess

    from ..tune.measure import repo_root

    root = repo_root()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    # the two processes run at once: neither sees the other
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.tools.tune_cli"]
        + _SELFTEST_PLAN_ARGS, cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = []
    try:
        result = meanwhile()
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, \
                "plan subprocess failed:\n%s" % stderr[-2000:]
            outs.append(stdout)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert outs[0] == outs[1], \
        "two fresh `ptune plan` processes disagreed — ranking is " \
        "nondeterministic"
    plan = json.loads(outs[0])
    assert plan["ranked"], "selftest space ranked nothing"
    for e in plan["ranked"]:
        assert e["predicted_step_ms"] > 0, e
        assert "comm_wire_bytes" in e and "peak_hbm_bytes" in e, e
    assert not plan["rejected"], \
        "clean lenet5 space rejected candidates: %r" % plan["rejected"]
    return result


def _selftest_rejections(args):
    """Injected invalid candidates must be rejected with their exact
    codes and stay out of the ranked (measurable) list."""
    from ..tune.space import Candidate

    # batch 36 % dp=8 != 0: the sharding analyzer's S002 at the
    # concrete trainer boundary
    bad = Candidate("dp=8,mp=1", "", batch=36, micro_batches=1)
    plan = _rank_plan(args, extra_candidates=[bad])
    tags = [e.candidate.tag() for e in plan.ranked]
    assert bad.tag() not in tags, "S002-invalid mesh was ranked"
    rej = {r.candidate.tag(): r for r in plan.rejected}
    assert bad.tag() in rej, "S002-invalid mesh was not rejected"
    assert rej[bad.tag()].code == "S002", rej[bad.tag()]

    # an absurd budget: everything must reject S005 citing bytes
    tiny = _rank_plan(args, hbm_gb=1e-6)
    assert not tiny.ranked and tiny.rejected, \
        "1e-6 GiB budget ranked candidates"
    for r in tiny.rejected:
        assert r.code == "S005" and r.peak_hbm_bytes > 0, r
        assert "GiB" in r.message and "budget" in r.message, r
    return plan, bad


def _selftest_measure_fit(args, plan, bad, workdir, use_gpu):
    from ..obs import perf as obs_perf
    from ..tune import fit as tune_fit
    from ..tune import measure as tune_measure
    from ..tune.rank import Calibration

    history = os.path.join(workdir, "ptune_history.jsonl")
    # 2 untimed steps: on the card the executor captures a step on its
    # second run, so the timed steps replay
    results = tune_measure.measure_plan(
        plan, topk=2, history=history, iters=3, warmup=2,
        cache_dir=os.path.join(workdir, "pcache"),
        extra_env=_leg_env(use_gpu), timeout=600)
    assert len(results) == 2, results
    for r in results:
        assert r["ok"], "measurement failed: %r" % (r,)
        assert r["record"]["config"]["mesh"], r["record"]

    # the history file carries the join keys: ptune legs + config
    records = obs_perf.load_history(history)
    assert len(records) == 2, records
    for rec in records:
        assert rec.get("leg", "").startswith(tune_fit.LEG_PREFIX), rec
        assert rec.get("config", {}).get("mesh"), \
            "history line has no config blob: %r" % rec
    # the rejected candidate never reached measurement
    assert not any(r.get("leg") == tune_fit.LEG_PREFIX + bad.tag()
                   for r in records), \
        "S002-rejected candidate was measured"

    # calibration: the error must not rise after the measurements
    pairs = tune_fit.join_history(plan, records)
    assert len(pairs) == 2, pairs
    cal = tune_fit.fit_calibration(pairs, model="lenet5")
    assert cal.n == 2, cal.to_dict()
    assert cal.error_before is not None \
        and cal.error_after <= cal.error_before, \
        "calibration did not improve: %r" % cal.to_dict()
    # roundtrip + a calibrated re-rank changes the prediction
    cal_path = os.path.join(workdir, "cal.json")
    cal.save(cal_path)
    loaded = Calibration.load(cal_path)
    assert loaded.to_dict() == cal.to_dict()
    args.calibration = cal_path
    plan2 = _rank_plan(args)
    tag = plan.ranked[0].candidate.tag()
    before = plan.entry(tag).predicted_step_s
    after = plan2.entry(tag).predicted_step_s
    assert after != before, \
        "fitted calibration left predictions unchanged"
    return len(records), cal, results


def selftest(args):
    import shutil

    from ..tune import measure as tune_measure

    use_gpu = args.use_gpu
    _leg_env(use_gpu)  # the card's absence raises before any work
    # the selftest space is pinned (not the user's --batches etc.) so
    # it stays self-contained under any CLI invocation
    args = parse_args(_SELFTEST_PLAN_ARGS)
    workdir = tempfile.mkdtemp(prefix="paddle_ptune_")
    seconds = [time.perf_counter()]
    try:
        # legs 1 and 2 at once: the plan processes and the rejections
        plan, bad = _selftest_determinism(
            lambda: _selftest_rejections(args))
        seconds.append(time.perf_counter())
        measured, cal, results = _selftest_measure_fit(
            args, plan, bad, workdir, use_gpu)
        seconds.append(time.perf_counter())
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    records = [r["record"] for r in results]
    launches = tune_measure.leg_launches(results)

    print("[ptune] selftest green: deterministic plan (%d candidates "
          "ranked), S002 + S005 rejected before measurement, %d "
          "top-K records measured into history with config blobs on "
          "%s (step ms %s), calibration error %.1f%% -> %.1f%% "
          "(legs 1-2 and 3-4: %s s); the legs' kernel launches=%s"
          % (len(plan.ranked), measured,
             records[0]["platform_class"],
             ", ".join("%.4f" % r["step_ms"] for r in records),
             cal.error_before * 100, cal.error_after * 100,
             ", ".join("%.1f" % (b - a)
                       for a, b in zip(seconds, seconds[1:])),
             json.dumps(launches, sort_keys=True, separators=(",", ":"))),
          flush=True)
    return 0


def main(argv=None):
    args = parse_args(argv)
    if args.selftest:
        return selftest(args)
    if args.cmd == "plan":
        return cmd_plan(args)
    if args.cmd == "measure":
        return cmd_measure(args)
    if args.cmd == "fit":
        return cmd_fit(args)
    if args.cmd == "report":
        return cmd_report(args)
    raise SystemExit("nothing to do: pass a command (plan | measure "
                     "| fit | report) or --selftest")


if __name__ == "__main__":
    sys.exit(main())
