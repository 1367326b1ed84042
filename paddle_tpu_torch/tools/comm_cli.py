"""pcomm — collective/communication observability CLI
(paddle_tpu_torch.obs.comm).  Counterpart of
paddle_tpu/tools/comm_cli.py.

    # per-bucket comm truth + the overlap-efficiency split over the
    # process group's ranks (a launcher's world; a world of one rank on
    # the card when none is up, where the overlapped step falls back
    # and the report says why)
    python -m paddle_tpu_torch.tools.comm_cli report [--bucket-kb 24] \\
        [--reps 3] [--trace-out comm_trace.json] \\
        [--calibration-out comm_cal.json] [--json] [--use_gpu=0]

    # cross-host merge: pull every live /obsspan/* window from the
    # master's lease store (workers push them via
    # FleetReporter(span_window=N)), estimate per-host clock offsets
    # over the same store, emit ONE Perfetto trace with a process
    # track per host on a common timebase
    python -m paddle_tpu_torch.tools.comm_cli merge --master host:port \\
        --out merged_trace.json
    python -m paddle_tpu_torch.tools.comm_cli merge \\
        --windows w1.json w2.json --out merged_trace.json

    python -m paddle_tpu_torch.tools.comm_cli --selftest [--use_gpu=0]

`--selftest` proves the loop.  The overlapped step needs a dp axis of
at least 2 ranks, and one card takes one rank, so legs 1-2 run on 4
gloo CPU ranks that the selftest spawns (unless a group of 2 or more
ranks is up: then on it): the traced bucket schedule nests one
`comm/bucket` span per bucket in last-produced-first order with byte
labels; `overlap_report` splits step wall into exposed-vs-hidden comm
against the reduction-elided twin, and a gspmd-fallback trainer
(dp 2 x mp 2) is refused WITHOUT an exposed_s.  The same trainer at the
place `--use_gpu` names (the card by default), on a world of one,
falls back with its reason and measures no comm.  A real master lease
store carries span windows + the NTP-style clock exchange (a
ClockResponder with 0.5s injected skew is recovered and the merged
trace re-bases by it, validating as a Chrome trace); the drift
calibration blob is written, read back through `tune.fit` and fitted
into the comm coefficient (same platform class only; a wrong-kind blob
refused); and `perf_cli gate --comm-tolerance` passes ±2% exposed-comm
noise while failing an injected 20% regression.
"""

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile

from . import use_gpu_arg


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="pcomm")
    p.add_argument("cmd", nargs="?", choices=["report", "merge"],
                   help="operator command (or use --selftest)")
    p.add_argument("--selftest", action="store_true",
                   help="spans + overlap split + cross-host merge + "
                        "calibration blob + comm gate certification")
    # report
    p.add_argument("--dp", type=int, default=None,
                   help="report: data-parallel mesh width (default: "
                        "every rank of the process group)")
    p.add_argument("--bucket-kb", type=int, default=24,
                   help="report: ring-allreduce bucket size in KiB "
                        "(small enough that the probe MLP fills "
                        "several buckets)")
    p.add_argument("--reps", type=int, default=3,
                   help="report: timed repetitions per measurement")
    p.add_argument("--trace-out", default=None,
                   help="report: write this process's span trace "
                        "here (Chrome trace JSON)")
    p.add_argument("--calibration-out", default=None,
                   help="report: write the measured/predicted ring "
                        "blob the autotuner's fit reads")
    # merge
    p.add_argument("--master", default=None,
                   help="merge: master host:port whose /obsspan/* "
                        "windows to pull")
    p.add_argument("--windows", nargs="*", default=None,
                   help="merge: span-window JSON files (offline "
                        "merge; skips the clock exchange)")
    p.add_argument("--out", default=None,
                   help="merge: merged trace path (default "
                        "comm_merged_trace.json)")
    p.add_argument("--no-clock-sync", action="store_true",
                   help="merge: skip the clock-offset exchange (rely "
                        "on host wall clocks)")
    p.add_argument("--clock-reps", type=int, default=3,
                   help="merge: ping/pong exchanges per host")
    p.add_argument("--clock-timeout", type=float, default=3.0,
                   help="merge: seconds to wait for each pong")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    p.add_argument("--use_gpu", type=use_gpu_arg, default=True,
                   help="report and the selftest's own-place leg: 1 on "
                        "the card (the default), 0 on the CPU")
    return p.parse_args(argv)


# ---------------------------------------------------------------------------
# probe model (the test_spmd MLP recipe: big first layer, small head,
# so a KB-scale bucket cap yields several buckets in reduce order)
# ---------------------------------------------------------------------------

BATCH, DIM, HIDDEN, CLASSES = 16, 8, 1024, 4


def _build_mlp():
    from .. import fluid

    fluid.framework.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[BATCH, DIM],
                              dtype="float32",
                              append_batch_size=False)
        label = fluid.layers.data(name="label", shape=[BATCH, 1],
                                  dtype="int64",
                                  append_batch_size=False)
        h = fluid.layers.fc(input=x, size=HIDDEN, act="relu")
        logits = fluid.layers.fc(input=h, size=CLASSES, act=None)
        loss = fluid.layers.softmax_with_cross_entropy(logits, label)
        avg = fluid.layers.mean(loss)
        fluid.optimizer.MomentumOptimizer(
            learning_rate=0.1, momentum=0.9).minimize(avg)
    return main, startup, avg


def _feeds(step=0):
    import numpy as np

    rs = np.random.RandomState(100 + step)
    return {
        "x": rs.rand(BATCH, DIM).astype(np.float32),
        "label": rs.randint(0, CLASSES,
                            size=(BATCH, 1)).astype(np.int64),
    }


def _make_trainer(mesh, bucket_bytes):
    from ..spmd import SpmdTrainer

    main, startup, avg = _build_mlp()
    return SpmdTrainer(main, startup, feed_names=["x", "label"],
                       fetch_names=[avg.name], mesh=mesh,
                       bucket_bytes=bucket_bytes,
                       use_pcache=False).init()


@contextlib.contextmanager
def _group(device):
    """The process group for the caller's mesh: the one that is up, or
    a world of one started here and destroyed after."""
    import torch.distributed as dist

    from ..parallel.mesh import ensure_world

    started = not dist.is_initialized()
    ensure_world(device)
    try:
        yield dist.get_rank()
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def _render_report(rep, bucket_report, drift):
    lines = []
    if not rep["supported"]:
        lines.append("overlap NOT measured: step_mode=%s (%s)"
                     % (rep["step_mode"],
                        rep["overlap_fallback_reason"]))
        return "\n".join(lines)
    lines.append("per-bucket ring truth (allreduce over %s, %d-way):"
                 % (bucket_report["axis"], bucket_report["n"]))
    lines.append("  %-7s %10s %10s %9s %9s %7s"
                 % ("bucket", "bytes", "wire", "pred ms",
                    "meas ms", "ratio"))
    for r in bucket_report["buckets"]:
        lines.append("  %-7d %10d %10d %9.3f %9.3f %7s"
                     % (r["bucket"], r["bytes"], r["wire_bytes"],
                        r["pred_s"] * 1e3, r["measured_s"] * 1e3,
                        "%.2f" % r["ratio"] if r["ratio"] else "-"))
    lines.append("overlap split over %d rep(s):" % rep["reps"])
    lines.append("  step %.3f ms = compute %.3f ms + exposed comm "
                 "%.3f ms" % (rep["step_s"] * 1e3,
                              rep["compute_s"] * 1e3,
                              rep["exposed_s"] * 1e3))
    eff = rep["overlap_efficiency"]
    lines.append("  standalone comm %.3f ms -> hidden %.3f ms "
                 "(overlap efficiency %s)"
                 % (rep["comm_s"] * 1e3, rep["hidden_s"] * 1e3,
                    "%.1f%%" % (eff * 100) if eff is not None
                    else "n/a"))
    if drift["median_ratio"]:
        lines.append("analytic-floor drift: median measured/pred "
                     "%.2f over %d bucket(s)"
                     % (drift["median_ratio"], drift["n"]))
    return "\n".join(lines)


def cmd_report(args):
    from ..obs import comm as obs_comm
    from ..obs import trace as obs_trace
    from ..parallel import make_mesh

    device = "cuda" if args.use_gpu else "cpu"
    obs_trace.enable()
    with _group(device) as rank:
        mesh = make_mesh(n_devices=args.dp, device=device)
        dp = mesh.size()
        trainer = _make_trainer(mesh, args.bucket_kb << 10)
        feeds = _feeds(0)
        trainer.step(feeds)                 # run the bucket schedule
        bucket_report = obs_comm.measure_trainer_comm(trainer,
                                                      reps=args.reps)
        rep = obs_comm.overlap_report(trainer, feeds, reps=args.reps,
                                      bucket_report=bucket_report)
    drift = obs_comm.drift_report(bucket_report)
    out = sys.stdout if rank == 0 else io.StringIO()
    if args.json:
        blob = dict(rep)
        blob.pop("spans", None)
        print(json.dumps({"overlap": blob, "drift": drift},
                         sort_keys=True), file=out)
    else:
        print("[pcomm] mlp probe, dp=%d, bucket %d KiB:"
              % (dp, args.bucket_kb), file=out)
        print(_render_report(rep, bucket_report, drift), file=out)
    if args.calibration_out and rank == 0:
        blob = obs_comm.calibration_blob(bucket_report,
                                         model="pcomm-mlp")
        if blob is None:
            print("[pcomm] nothing measured — no calibration "
                  "written", file=sys.stderr)
            return 2
        obs_comm.save_calibration(blob, args.calibration_out)
        if not args.json:
            print("[pcomm] calibration written: %s (comm_ratio %.3f "
                  "over %d bucket(s))"
                  % (args.calibration_out, blob["comm_ratio"],
                     blob["n"]))
    if args.trace_out and rank == 0:
        obs_trace.export_chrome_trace(args.trace_out)
        if not args.json:
            print("[pcomm] span trace written: %s" % args.trace_out)
    return 0 if rep["supported"] else 2


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------

def cmd_merge(args):
    from ..obs import comm as obs_comm

    offsets = {}
    if args.windows:
        windows = {}
        for path in args.windows:
            with open(path) as f:
                payload = json.load(f)
            windows[payload.get("host") or path] = payload
    elif args.master:
        windows = obs_comm.collect_span_windows(args.master)
        if windows and not args.no_clock_sync:
            offsets = obs_comm.estimate_clock_offsets(
                args.master, sorted(windows), reps=args.clock_reps,
                timeout_s=args.clock_timeout)
    else:
        raise SystemExit("merge needs --master or --windows")
    merged = obs_comm.merge_windows(windows, offsets)
    out = args.out or "comm_merged_trace.json"
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(merged, f, sort_keys=True)
    os.replace(tmp, out)
    hosts = merged["otherData"]["hosts"]
    if args.json:
        print(json.dumps({"out": out, "hosts": hosts,
                          "events": len(merged["traceEvents"]),
                          "clock_offsets":
                              merged["otherData"]["clock_offsets"]},
                         sort_keys=True))
    else:
        print("[pcomm] merged %d host track(s) (%s) into %s (%d "
              "events); clock offsets: %s"
              % (len(hosts), ", ".join(hosts) or "none", out,
                 len(merged["traceEvents"]),
                 {h: ("%.3fs" % o if o is not None else "?")
                  for h, o in
                  merged["otherData"]["clock_offsets"].items()}
                 or "skipped"))
    return 0 if hosts else 2


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------

def _overlap_leg(rank, workdir):
    """Legs 1-2 in every rank of a group of 4: traced schedule shape +
    the overlap-efficiency split (and the fallback trainer refused
    without an exposed_s).  Returns (report, bucket report) on rank 0."""
    import torch.distributed as dist

    from ..obs import comm as obs_comm
    from ..obs import flight as obs_flight
    from ..obs import trace as obs_trace
    from ..parallel import make_mesh
    from ..spmd import overlap as spmd_overlap

    obs_trace.enable()
    mesh = make_mesh(device="cpu")
    n = mesh.size()
    trainer = _make_trainer(mesh, 24 << 10)
    feeds = _feeds(0)
    trainer.step(feeds)
    assert trainer.step_mode == "overlap-dp", trainer.step_mode

    # schedule shape: >= 2 buckets, flattened names in EXACTLY the
    # last-produced-first (DDP) order the program's seam defines
    sched = obs_comm.last_schedule()
    assert sched and sched["collective"] == "allreduce", sched
    assert sched["n_buckets"] >= 2, sched
    _split, grad_order = spmd_overlap._split_point(
        list(trainer.main_program.desc.block(0).ops))
    flat = [nm for b in sched["buckets"] for nm in b["names"]]
    want = [g for g in reversed(grad_order) if g in set(flat)]
    assert flat == want, (flat, want)

    # trace nesting: one parent, one comm/bucket span per bucket with
    # byte labels, bracketed by launch/complete instants, plus the
    # reduce seam marker from the overlap schedule
    evs = obs_trace.events()
    parents = [e for e in evs
               if e.get("name") == "comm/bucketed_allreduce"]
    assert parents and parents[0]["args"]["n_buckets"] \
        == sched["n_buckets"], parents
    bspans = [e for e in evs if e.get("name") == "comm/bucket"]
    assert len(bspans) == sched["n_buckets"], evs
    for e in bspans:
        assert e["args"]["bytes"] > 0 and e["args"]["names"] >= 1, e
    assert [e["args"]["first"] for e in bspans] \
        == [b["names"][0] for b in sched["buckets"]]
    launches = [e for e in evs if e.get("name") == "comm/bucket_launch"]
    completes = [e for e in evs
                 if e.get("name") == "comm/bucket_complete"]
    assert len(launches) == len(completes) == sched["n_buckets"]
    assert any(e.get("name") == "comm/reduce_seam" for e in evs)

    # overlap truth: the split is internally consistent and published
    bucket_report = obs_comm.measure_trainer_comm(trainer, reps=2)
    assert bucket_report and len(bucket_report["buckets"]) >= 2
    for r in bucket_report["buckets"]:
        assert r["measured_s"] > 0 and r["pred_s"] > 0, r
    rep = obs_comm.overlap_report(trainer, feeds, reps=2,
                                  bucket_report=bucket_report)
    assert rep["supported"] and rep["step_s"] > 0 \
        and rep["compute_s"] > 0 and rep["comm_s"] > 0, rep
    assert rep["exposed_s"] >= 0 \
        and 0.0 <= rep["overlap_efficiency"] <= 1.0, rep
    assert abs(rep["exposed_s"] + rep["hidden_s"] - rep["comm_s"]) \
        < 1e-9 or rep["exposed_s"] >= rep["comm_s"], rep

    # the trainer stamped this worker's identity for any future flight
    # bundle; a dump carries it
    ctx = obs_flight.host_context()
    assert ctx.get("process_index") == dist.get_rank() \
        and ctx.get("mesh_axes", {}).get("dp") == n \
        and ctx.get("plan_fingerprint") \
        == trainer.plan.fingerprint(), ctx
    recorder = obs_flight.install(
        out_dir=os.path.join(workdir, "flight%d" % rank), capacity=8)
    try:
        bundle = recorder.dump(reason="pcomm-selftest")
    finally:
        obs_flight.uninstall()
    with open(bundle) as f:
        doc = json.load(f)
    assert doc["host_context"]["plan_fingerprint"] \
        == trainer.plan.fingerprint(), doc.get("host_context")

    # fallback trainer (dp x mp mesh): overlap refused, and the report
    # carries NO exposed_s — it can never enter the overlap baseline
    mesh2 = make_mesh(mp=2, device="cpu")
    trainer2 = _make_trainer(mesh2, 24 << 10)
    trainer2.step(feeds)
    assert trainer2.step_mode == "gspmd" \
        and trainer2.overlap_fallback_reason
    rep2 = obs_comm.overlap_report(trainer2, feeds, reps=2)
    assert not rep2["supported"] and "exposed_s" not in rep2 \
        and rep2["overlap_fallback_reason"], rep2
    rep.pop("spans", None)
    # the ring's platform class (its ranks', not the spawning process's)
    bucket_report["platform_class"] = obs_comm._platform_class(mesh)
    return rep, bucket_report, n


def _selftest_spans_and_overlap(workdir):
    """Legs 1-2 over the process group when it has 2 or more ranks,
    else over 4 gloo CPU ranks spawned here."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() >= 2:
        return _overlap_leg(dist.get_rank(), workdir)
    from ..distributed.ranks import run_local_ranks

    return run_local_ranks(_overlap_leg, 4, workdir, workdir)


def _selftest_own_place(device):
    """The probe trainer at the caller's place on a world of one: the
    overlapped step falls back with its reason, and a ring of one
    measures no comm (as the JAX trainer at dp 1)."""
    from ..obs import comm as obs_comm
    from ..parallel import make_mesh

    with _group(device):
        mesh = make_mesh(n_devices=1, device=device)
        trainer = _make_trainer(mesh, 24 << 10)
        loss = float(trainer.step(_feeds(0))[0].reshape(-1)[0])
        assert trainer.step_mode == "gspmd" \
            and trainer.overlap_fallback_reason \
            == "mesh has no dp axis wider than 1", trainer.step_mode
        assert obs_comm.measure_trainer_comm(trainer, reps=1) is None
        rep = obs_comm.overlap_report(trainer, _feeds(0), reps=1)
        assert not rep["supported"] and "exposed_s" not in rep, rep
        return loss, trainer.overlap_fallback_reason


def _selftest_calibration(workdir, bucket_report):
    """Leg 3: drift blob -> tune.fit comm coefficient, same-class
    only."""
    from ..obs import comm as obs_comm
    from ..tune import fit as tune_fit

    blob = obs_comm.calibration_blob(
        bucket_report, platform_class=bucket_report["platform_class"],
        model="pcomm-mlp")
    assert blob and blob["n"] >= 2 and blob["comm_ratio"] > 0, blob
    assert all(p["platform_class"] == blob["platform_class"]
               for p in blob["pairs"]), blob
    cal_path = os.path.join(workdir, "comm_cal.json")
    obs_comm.save_calibration(blob, cal_path)
    pairs = tune_fit.load_comm_calibration(cal_path)
    assert len(pairs) == blob["n"] \
        and pairs[0]["platform_class"] == blob["platform_class"]
    cal = tune_fit.fit_calibration([], comm_pairs=pairs)
    assert abs(cal.coef["comm"] - blob["comm_ratio"]) < 1e-9, \
        (cal.coef, blob["comm_ratio"])
    # same-platform-class discipline: training on a DIFFERENT class
    # keeps the analytic prior instead of ingesting these pairs
    foreign = [{"leg": "ptune:x", "measured_s": 0.1,
                "meas_compute_s": 0.08, "overhead_s": 0.01,
                "platform_class": "tpu:d8:dp=8"}]
    cal2 = tune_fit.fit_calibration(foreign, comm_pairs=pairs)
    assert cal2.coef["comm"] == 1.0, cal2.coef
    assert "kept analytic" in cal2.note, cal2.note
    # a wrong-kind blob must be refused, not silently skipped
    bad_path = os.path.join(workdir, "not_comm.json")
    with open(bad_path, "w") as f:
        json.dump({"kind": tune_fit.MEM_CALIBRATION_KIND,
                   "pairs": []}, f)
    try:
        tune_fit.load_comm_calibration(bad_path)
        raise AssertionError("wrong-kind blob loaded")
    except ValueError:
        pass
    print("[pcomm] calibration -> tune.fit comm coefficient %.6g (the "
          "blob's comm_ratio %.6g over %d pair(s), %s); a foreign class "
          "keeps the analytic prior; a wrong-kind blob is refused"
          % (cal.coef["comm"], blob["comm_ratio"], blob["n"],
             blob["platform_class"]), flush=True)
    return blob, cal


def _selftest_merge(workdir):
    """Leg 4: span windows + clock exchange + merged trace over a
    REAL master lease store."""
    from .. import native
    from ..obs import comm as obs_comm
    from ..obs import fleet as obs_fleet
    from ..obs import registry as obs_registry
    from ..obs import trace as obs_trace
    from .obs_dump import validate_chrome_trace

    obs_trace.enable()
    sched = obs_comm.record_schedule(
        "allreduce", "dp", [{"bucket": 0, "names": ["a@GRAD"],
                             "bytes": 64}])
    with obs_comm.schedule_span(sched):
        with obs_comm.bucket_span(sched, 0):
            pass
    master = native.Master()
    addr = "127.0.0.1:%d" % master.port
    responder = None
    reporter = None
    try:
        # hostA rides the FleetReporter (snapshot + span window in one
        # push); hostB is a bare push with a skewed clock responder
        reporter = obs_fleet.FleetReporter(addr, host="hostA",
                                           interval_s=60.0,
                                           span_window=256)
        assert reporter.push_once() \
            and reporter._span_lease is not None
        assert obs_comm.push_span_window(addr, host="hostB",
                                         limit=256) is not None
        responder = obs_comm.ClockResponder(addr, host="hostB",
                                            poll_s=0.02,
                                            skew_s=0.5).start()
        offsets = obs_comm.estimate_clock_offsets(
            addr, ["hostB"], reps=3, timeout_s=5.0)
        off = offsets["hostB"]
        assert off is not None and abs(off - 0.5) < 0.2, offsets

        windows = obs_comm.collect_span_windows(addr)
        assert {"hostA", "hostB"} <= set(windows), sorted(windows)
        for w in windows.values():
            assert w["events"] and w["epoch_wall"] > 0, w["host"]
        merged = obs_comm.merge_windows(windows, offsets)
        events = validate_chrome_trace(merged)
        names = {e["args"]["name"] for e in events
                 if e.get("name") == "process_name"}
        assert {"hostA", "hostB"} <= names, names
        assert merged["otherData"]["clock_offsets"]["hostB"] == off
        # the offset actually re-bases: hostA's events shift by ~the
        # recovered skew relative to an uncorrected merge
        plain = obs_comm.merge_windows(windows, None)
        pick = [e for e in merged["traceEvents"]
                if e["pid"] == 1 and e["ph"] == "X"][0]
        pick0 = [e for e in plain["traceEvents"]
                 if e["pid"] == 1 and e["ph"] == "X"][0]
        shift_s = (pick["ts"] - pick0["ts"]) / 1e6
        assert abs(shift_s - off) < 0.05, (shift_s, off)

        # the aggregator publishes per-host snapshot age and retires
        # it when the host's lease dies
        agg = obs_fleet.FleetAggregator()
        assert agg.collect(addr) >= 1
        agg.stragglers()
        age = obs_registry.get_registry().gauge(
            "fleet_snapshot_age_seconds", labelnames=("host",))
        ages = {s["labels"]["host"]: s["value"]
                for s in age.samples()}
        assert "hostA" in ages and ages["hostA"] >= 0, ages
        reporter.stop(unregister=True)
        reporter = None
        agg.collect(addr)
        agg.stragglers()
        assert not any(s["labels"]["host"] == "hostA"
                       for s in age.samples()), age.samples()
        assert "hostA" not in obs_comm.collect_span_windows(addr)
        return len(windows), off, len(events)
    finally:
        if responder is not None:
            responder.stop()
        if reporter is not None:
            reporter.stop(unregister=True)
        master.stop()
        obs_trace.disable()


def _comm_history(path, regress=False):
    """Six rounds of multichip records with ±2% exposed-comm noise
    (and one gspmd-fallback record that carries no exposed_s — it
    must not drag the overlap baseline); optionally a 20% exposed
    regression as the candidate."""
    from ..obs import perf as obs_perf

    noise = [1.0, 0.99, 1.012, 0.994, 1.009, 0.98]
    base_v, base_e = 512.0, 0.004
    if os.path.exists(path):
        os.remove(path)
    ts = 1_700_000_000.0
    for i, n in enumerate(noise):
        e = base_e * (1.2 if (regress and i == len(noise) - 1) else n)
        obs_perf.append_history(
            {"metric": "mlp_multichip_imgs_per_sec",
             "value": round(base_v * n, 2), "unit": "img/s",
             "step_ms": 31.0, "platform": "cpu",
             "comm": {"measured_s": 0.005,
                      "exposed_s": round(e, 6),
                      "overlap_efficiency": 0.8,
                      "step_mode": "overlap-dp",
                      "plan_fingerprint": "fp0"}},
            path, leg="dp=8", ts=ts + i)
        if i == 2:
            # the fallback run: huge standalone ring, NO exposed_s
            obs_perf.append_history(
                {"metric": "mlp_multichip_imgs_per_sec",
                 "value": round(base_v, 2), "unit": "img/s",
                 "step_ms": 31.0, "platform": "cpu",
                 "comm": {"measured_s": 10.0, "step_mode": "gspmd",
                          "overlap_fallback_reason": "mesh is not "
                          "pure data-parallel"}},
                path, leg="dp=8", ts=ts + i + 0.5)
    return path


def _selftest_gate(workdir):
    """Leg 5: the comm gate discriminates — noise passes, an injected
    exposed-comm regression fails, fallback records don't pollute."""
    from ..obs import perf as obs_perf
    from . import perf_cli

    path = _comm_history(os.path.join(workdir, "comm_hist.jsonl"))
    res = obs_perf.gate_history(obs_perf.load_history(path),
                                comm_tolerance=0.1)
    assert res.ok, obs_perf.format_gate(res)
    rc = perf_cli.main(["gate", "--history", path,
                        "--comm-tolerance", "0.1"])
    assert rc == 0, rc

    bad = _comm_history(os.path.join(workdir, "comm_bad.jsonl"),
                        regress=True)
    res = obs_perf.gate_history(obs_perf.load_history(bad),
                                comm_tolerance=0.1)
    assert not res.ok and res.failures[0]["kind"] == "comm", \
        res.to_dict()
    assert "exposed_s" in res.failures[0]["why"], res.failures
    # without the opt-in flag the same history passes (throughput
    # noise hides the regression — exactly why the gate exists)
    assert obs_perf.gate_history(obs_perf.load_history(bad)).ok
    rc = perf_cli.main(["gate", "--history", bad,
                        "--comm-tolerance", "0.1"])
    assert rc == 1, rc
    return res.failures[0]["why"]


def selftest(args):
    import shutil

    workdir = tempfile.mkdtemp(prefix="paddle_pcomm_")
    try:
        rep, bucket_report, n = _selftest_spans_and_overlap(workdir)
        loss, reason = _selftest_own_place(
            "cuda" if args.use_gpu else "cpu")
        blob, cal = _selftest_calibration(workdir, bucket_report)
        n_hosts, off, n_events = _selftest_merge(workdir)
        gate_why = _selftest_gate(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    print("[pcomm] selftest green: %d bucket(s) traced in reduce "
          "order on %d gloo ranks, overlap split step %.2fms = compute "
          "%.2fms + exposed %.2fms (efficiency %.0f%%); at the %s a "
          "world of one trains (loss %.4f) and falls back (%s); "
          "calibration %d pair(s) fitted to comm coef %.4g; %d host "
          "window(s) merged on "
          "a common timebase (%d events, recovered skew %.3fs); comm "
          "gate discriminates: %s"
          % (len(bucket_report["buckets"]), n, rep["step_s"] * 1e3,
             rep["compute_s"] * 1e3, rep["exposed_s"] * 1e3,
             rep["overlap_efficiency"] * 100,
             "card" if args.use_gpu else "CPU", loss, reason, blob["n"],
             cal.coef["comm"], n_hosts, n_events, off, gate_why),
          flush=True)
    return 0


def main(argv=None):
    args = parse_args(argv)
    if args.selftest:
        return selftest(args)
    if args.cmd == "report":
        return cmd_report(args)
    if args.cmd == "merge":
        return cmd_merge(args)
    raise SystemExit("nothing to do: pass report|merge or --selftest")


if __name__ == "__main__":
    sys.exit(main())
