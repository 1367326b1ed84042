"""pmem: the memory observability CLI (paddle_tpu_torch.obs.mem).

    # the static memory timeline of a model's training program: per-op
    # live bytes, the peak op, the top resident buffers blamed to their
    # defining ops (and a Chrome-trace counter track)
    python -m paddle_tpu_torch.tools.mem_cli timeline --model lenet5 \
        --batch 128 [--trace-out mem.json]

    # static against actual: run training steps on the card (or join a
    # saved --store dump), report pool/static per captured segment and
    # per program, and write the calibration blob the tuner reads
    python -m paddle_tpu_torch.tools.mem_cli drift --model lenet5 \
        [--calibration-out mem_cal.json] [--store-out store.json]
    python -m paddle_tpu_torch.tools.mem_cli drift --store store.json

    # the buffer-donation audit: parameter and optimizer-state buffers
    # that are dead after use but not donated, with the bytes
    python -m paddle_tpu_torch.tools.mem_cli audit --model lenet5

    # the certification run, on the card (--use_gpu=0: on the CPU)
    python -m paddle_tpu_torch.tools.mem_cli --selftest

Counterpart of paddle_tpu/tools/mem_cli.py.  The JAX drift joins each
segment's static peak with XLA's `memory_analysis()`; the port's joins
it with the bytes each CUDA graph capture added to its program's pool.
`drift` therefore runs its steps where captures hold a pool: on the
card.

`--selftest` runs the JAX selftest's loop: a timeline render and a
valid Chrome counter track; a real lenet5 training step whose drift
yields a usable calibration blob; a donation audit that finds a
deliberately forked Adam moment (and nothing on the clean program); a
forced tiny budget whose flight bundle names the timeline's top
buffer.  On the card the drift joins real pool bytes.  On the CPU
nothing holds a pool and the step joins nothing, so the selftest checks
the join with injected pool bytes and says so in its line.
"""

import argparse
import json
import os
import sys
import tempfile

from . import cli_place, use_gpu_arg


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="pmem")
    p.add_argument("cmd", nargs="?",
                   choices=["timeline", "drift", "audit"],
                   help="operator command (or use --selftest)")
    p.add_argument("--selftest", action="store_true",
                   help="timeline + drift join + donation audit + OOM "
                        "flight-bundle certification")
    p.add_argument("--model", default="lenet5",
                   help="model name (paddle_tpu_torch.tune.models)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--class-dim", type=int, default=None)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--f32", dest="bf16", action="store_false")
    p.add_argument("--top", type=int, default=8,
                   help="timeline: blamed buffers to list")
    p.add_argument("--trace-out", default=None,
                   help="timeline: write the Chrome-trace counter track "
                        "here (co-loadable with obs exports)")
    p.add_argument("--store", default=None,
                   help="drift: join a saved obs.mem store dump instead "
                        "of running steps in-process")
    p.add_argument("--store-out", default=None,
                   help="drift: also dump this process's store for later "
                        "offline joins")
    p.add_argument("--calibration-out", default=None,
                   help="drift: write the hbm_ratio calibration blob "
                        "`tune_cli plan --hbm-calibration` reads")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    p.add_argument("--use_gpu", type=use_gpu_arg, default=True,
                   help="drift and the selftest: on the card (1, the "
                        "default) or on the CPU (0)")
    return p.parse_args(argv)


def _build_train(model, batch, image_size=None, class_dim=None):
    """(main, startup, loss name): the tune.models training recipe with
    its startup program."""
    from paddle_tpu_torch.tune.models import MODELS, builder

    if model not in MODELS:
        raise SystemExit("unknown model %r; pmem knows %s"
                         % (model, ", ".join(sorted(MODELS))))
    return builder(model, image_size=image_size, class_dim=class_dim,
                   with_startup=True)(batch)


def _feeds(model, batch, image_size=None, class_dim=None):
    import numpy as np

    from paddle_tpu_torch.tune.models import MODELS

    spec = MODELS[model]
    size = int(image_size or spec["image_size"])
    classes = int(class_dim or spec["class_dim"])
    rs = np.random.RandomState(0)
    return {
        "image": rs.rand(batch, spec["channels"], size,
                         size).astype("float32"),
        "label": rs.randint(0, classes, (batch, 1)).astype("int64"),
    }


def _amp(bf16):
    import paddle_tpu_torch.fluid as fluid

    if bf16:
        fluid.amp.enable_bf16()
    else:
        fluid.amp.disable_bf16()


# ---------------------------------------------------------------------------
# commands
# ---------------------------------------------------------------------------

def cmd_timeline(args):
    from paddle_tpu_torch.obs import mem as obs_mem

    _amp(args.bf16)
    main, _startup, loss = _build_train(args.model, args.batch,
                                        args.image_size, args.class_dim)
    tl = obs_mem.program_timeline(main, fetches=[loss], top_n=args.top)
    if args.trace_out:
        obs_mem.timeline_chrome_trace(tl, path=args.trace_out)
    if args.json:
        print(json.dumps(tl, sort_keys=True))
    else:
        print("[pmem] %s batch %d (%s):"
              % (args.model, args.batch,
                 "bf16-act" if args.bf16 else "f32"))
        print(obs_mem.render_timeline(tl))
        if args.trace_out:
            print("[pmem] counter track written: %s (load next to an "
                  "obs_dump trace in Perfetto)" % args.trace_out)
    return 0


def cmd_audit(args):
    from paddle_tpu_torch.obs import mem as obs_mem

    _amp(args.bf16)
    main, _startup, loss = _build_train(args.model, args.batch,
                                        args.image_size, args.class_dim)
    audit = obs_mem.audit_donation(main, fetches=[loss])
    if args.json:
        print(json.dumps(audit, sort_keys=True))
    else:
        print("[pmem] %s batch %d:" % (args.model, args.batch))
        print(obs_mem.render_audit(audit))
    return audit["reclaimable_bytes"] > 0 and 1 or 0


def _captured_steps(place, main, startup, loss, feeds, steps=3):
    """Train `steps` steps under attribution, so the executor registers
    the static side and each capture on the card publishes its pool
    bytes (a warm-up, a capture, a replay).  Returns the losses."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.obs import health as obs_health

    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    with obs_health.force_attribution():
        return [exe.run(main, feed=feeds, fetch_list=[loss],
                        scope=scope)[0] for _ in range(steps)]


def cmd_drift(args):
    from paddle_tpu_torch.obs import mem as obs_mem

    if args.store:
        store = obs_mem.load_store(args.store)
    else:
        _amp(args.bf16)
        main, startup, loss = _build_train(args.model, args.batch,
                                           args.image_size,
                                           args.class_dim)
        _captured_steps(cli_place(args.use_gpu), main, startup, loss,
                        _feeds(args.model, args.batch, args.image_size,
                               args.class_dim))
        store = None  # this process's capture
    rep = obs_mem.drift_report(store)
    if args.store_out and not args.store:
        obs_mem.dump_store(args.store_out)
    if args.json:
        print(json.dumps(rep, sort_keys=True))
    else:
        print("[pmem] " + ("store %s" % args.store if args.store
                           else "%s batch %d, captured steps"
                           % (args.model, args.batch)))
        print(obs_mem.render_drift(rep))
    if args.calibration_out:
        blob = obs_mem.calibration_blob(rep, model=None if args.store
                                        else args.model)
        if blob is None:
            print("[pmem] no joined rows: no calibration written",
                  file=sys.stderr)
            return 2
        obs_mem.save_calibration(blob, args.calibration_out)
        if not args.json:
            print("[pmem] calibration written: %s (hbm_ratio %.3f over "
                  "%d %s row(s))" % (args.calibration_out,
                                     blob["hbm_ratio"], blob["n"],
                                     blob["basis"]))
    return 0 if rep["n"] else 2


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------

def selftest(args):
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.obs import flight as obs_flight
    from paddle_tpu_torch.obs import mem as obs_mem
    from paddle_tpu_torch.tools import obs_dump
    from paddle_tpu_torch.tools.lint_cli import (_build_adam_toy,
                                                 _fork_adam_slot)
    from paddle_tpu_torch.tune.fit import load_hbm_calibration
    from paddle_tpu_torch.utils import flags as pt_flags

    place = cli_place(args.use_gpu)
    on_card = place.device().type == "cuda"  # raises without a card
    workdir = tempfile.mkdtemp(prefix="paddle_pmem_")

    # --- leg 1: static timeline + counter-track export ---------------------
    main, startup, loss = _build_train("lenet5", 8)
    tl = obs_mem.program_timeline(main, fetches=[loss], top_n=5)
    assert len(tl["series"]) == tl["ops"] and tl["ops"] > 0, tl
    assert tl["peak_bytes"] > 0 and tl["peak_op"] is not None, tl
    assert tl["top_buffers"], "no blamed buffers at the peak"
    assert tl["top_buffers"][0]["def_op_type"], tl["top_buffers"][0]
    rendered = obs_mem.render_timeline(tl)
    assert "<- peak" in rendered and "top buffers" in rendered
    trace_path = os.path.join(workdir, "mem_trace.json")
    obs_mem.timeline_chrome_trace(tl, path=trace_path)
    events = obs_dump.validate_chrome_trace(trace_path)
    assert any(ev["ph"] == "C" for ev in events), \
        "no counter events in the mem trace"

    # --- leg 2: drift join on a real lenet5 step + calibration -------------
    feeds = _feeds("lenet5", 8)
    losses = _captured_steps(place, main, startup, loss, feeds)
    assert all(np.isfinite(v).all() for v in losses), losses
    if on_card:
        how = "pool bytes of the card's captures"
    else:
        # nothing holds a pool on the CPU: inject each registered row's
        # actual side (its static peak x 1.5) to check the join
        assert not obs_mem.drift_report()["n"], \
            "the CPU joined pool bytes it cannot have"
        for label, e in obs_mem.segments().items():
            obs_mem.on_compile_captured(
                label, {"graph_pool_bytes": e["static_peak_bytes"] * 1.5})
        how = "injected pool bytes (the CPU holds no pool)"
    rep = obs_mem.drift_report()
    joined = [r for r in rep["segments"] if r["ratio"]]
    assert joined and rep["basis"] == "program", \
        "no static-vs-pool joined program row:\n%s" \
        % obs_mem.render_drift(rep)
    assert rep["median_ratio"] and rep["median_ratio"] > 0
    cal_path = os.path.join(workdir, "mem_cal.json")
    obs_mem.save_calibration(
        obs_mem.calibration_blob(rep, model="lenet5"), cal_path)
    ratio = load_hbm_calibration(cal_path)
    assert ratio == rep["median_ratio"], (ratio, rep["median_ratio"])
    store_path = os.path.join(workdir, "mem_store.json")
    obs_mem.dump_store(store_path)
    offline = obs_mem.drift_report(obs_mem.load_store(store_path))
    assert offline["n"] == rep["n"], "offline store join drifted"

    # --- leg 3: donation audit: the clean program, then a forked slot ------
    adam_main, _adam_startup, adam_cost = _build_adam_toy()
    clean = obs_mem.audit_donation(adam_main, fetches=[adam_cost.name])
    assert clean["donated"] and not clean["reclaimable"], \
        obs_mem.render_audit(clean)
    forked_name = _fork_adam_slot(adam_main)
    broken = obs_mem.audit_donation(adam_main, fetches=[adam_cost.name])
    hits = [r for r in broken["reclaimable"] if r["name"] == forked_name]
    assert hits and hits[0]["bytes"] > 0 \
        and hits[0]["kind"] == "optimizer_state", \
        obs_mem.render_audit(broken)
    # the refusal is explained, not just priced: the forked slot carries
    # its A-code (analysis/alias.py) in entry and rendering
    assert hits[0].get("code") == "A001", hits[0]
    assert "A001" in obs_mem.render_audit(broken)
    # flag off: every donated buffer moves to reclaimable
    off = obs_mem.audit_donation(adam_main, fetches=[adam_cost.name],
                                 mode="off")
    assert not off["donated"], obs_mem.render_audit(off)
    assert off["reclaimable_bytes"] == (broken["reclaimable_bytes"]
                                        + broken["donated_bytes"])

    # --- leg 4: a forced tiny budget -> flight bundle with blame -----------
    recorder = obs_flight.install(out_dir=workdir, capacity=8)
    oom_scope = fluid.Scope()
    oom_exe = fluid.Executor(place)
    budget_prev = pt_flags.get_flag("mem_budget_gb")
    try:
        oom_exe.run(startup, scope=oom_scope)
        pt_flags.set_flag("mem_budget_gb", 1e-6)
        try:
            oom_exe.run(main, feed=feeds, fetch_list=[loss],
                        scope=oom_scope, use_program_cache=False)
            raise AssertionError("tiny mem budget did not trip the "
                                 "pre-flight")
        except obs_mem.MemoryBudgetError as exc:
            assert "RESOURCE_EXHAUSTED" in str(exc), exc
        assert oom_exe.captures == 0, "the refused program captured"
    finally:
        pt_flags.set_flag("mem_budget_gb", budget_prev)
        obs_flight.uninstall()
    bundle = recorder.last_bundle_path
    assert bundle and os.path.exists(bundle), "no OOM flight bundle"
    with open(bundle) as f:
        doc = json.load(f)
    oom_notes = [n["oom"] for n in doc.get("notes", []) if n.get("oom")]
    assert oom_notes, "flight bundle carries no oom note"
    top = oom_notes[0]["top_buffers"]
    assert top and top[0]["name"] == tl["top_buffers"][0]["name"], \
        "bundle's top blamed buffer %r != static timeline's %r" \
        % (top and top[0]["name"], tl["top_buffers"][0]["name"])
    assert "OOM post-mortem" in obs_dump.render_flight(bundle)

    print("[pmem] selftest green: timeline %d op(s) peak %.2f MiB at op %s "
          "(%s), counter track %d event(s); drift joined %d %s row(s) "
          "over %s, median ratio %.3f -> calibration %s; donation audit: "
          "clean program donates %d buffer(s), forked Adam slot %r "
          "flagged A001 with %.1f KiB reclaimable and FLAGS_donation=off "
          "surrenders the full delta; OOM bundle %s blames %r"
          % (tl["ops"], tl["peak_bytes"] / 2**20, tl["peak_op"],
             tl["peak_op_type"], len(events), rep["n"], rep["basis"], how,
             rep["median_ratio"], cal_path, len(clean["donated"]),
             forked_name, hits[0]["bytes"] / 1024.0, bundle,
             top[0]["name"]), flush=True)
    return 0


def main(argv=None):
    args = parse_args(argv)
    if args.selftest:
        return selftest(args)
    if args.cmd == "timeline":
        return cmd_timeline(args)
    if args.cmd == "drift":
        return cmd_drift(args)
    if args.cmd == "audit":
        return cmd_audit(args)
    raise SystemExit("nothing to do: pass timeline|drift|audit or "
                     "--selftest")


if __name__ == "__main__":
    sys.exit(main())
