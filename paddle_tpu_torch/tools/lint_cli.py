"""The static-analysis CLI over Program IR.

    # lint a save_inference_model export (the __model__ JSON, written
    # by either package):
    python -m paddle_tpu_torch.tools.lint_cli path/to/model_dir

    # additionally run the static SPMD/sharding analyzer against a
    # mesh description (no card needed; S0xx codes):
    python -m paddle_tpu_torch.tools.lint_cli path/to/model_dir \
        --mesh dp=4,mp=2 --hbm-gb 16 [--zero 1]

    # lint the checked-in golden program fixtures
    # (tests/fixtures/golden), optionally after a rewrite pipeline:
    python -m paddle_tpu_torch.tools.lint_cli --golden --passes default

    # additionally run the A0xx donation-safety analysis
    # (analysis/alias.py): which buffers each captured segment can
    # donate, and why the rest are refused:
    python -m paddle_tpu_torch.tools.lint_cli path/to/model_dir --donation

    # the certification run, its executor leg on the card (--use_gpu=0:
    # on the CPU):
    python -m paddle_tpu_torch.tools.lint_cli --selftest

Counterpart of paddle_tpu/tools/lint_cli.py over the port's
`analysis` and `compile.passes`.  Exit status: 0 when no
error-severity finding survives suppression, 1 otherwise (`--strict`
also fails on warnings).  `--json` emits the structured report instead
of text; the codes, severities and suppression syntax are the JAX
package's.

`--mesh` (with `--hbm-gb` and `--zero`) runs the sharding analyzer
(analysis/shard.py) against a mesh description and merges its S0xx
findings into the report; the text output adds the comm totals and the
per-device peak-memory estimate, `--json` a `sharding` section.
`--donation` runs the donation-safety analysis (analysis/alias.py) and
merges its A0xx findings; the text output adds a line with the plan's
mode, donated and refused buffers and fingerprint, `--json` a
`donation` section.

`--selftest` builds a REAL training program, asserts it verifies with
zero error-severity diagnostics, then seeds seven deliberate
corruptions — unknown op, use-before-def, dtype mismatch, dangling
BlockRef, write-write race, in-place alias read hazard, dead op — and
asserts each is reported under its stable diagnostic code; it checks
that a suppression filters, drives the executor's FLAGS_verify_program
gate end to end at the place `--use_gpu` names (the corrupted program
must fail BEFORE any op runs, with an error naming the op index and
variable), and finds the finding counters in the registry.  Its
sharding leg then analyzes a clean lenet5 training program and every
golden fixture over the four dryrun mesh shapes (dp/mp, dp/mp/sp,
pp/dp, dp/ep) asserting zero errors, seeds one corruption per S0xx code
(unmatched rule, non-divisible batch, conflicting layouts, schedule
mismatch, memory budget) asserting each exact code, and finds the comm
bytes in the registry.  The donation leg does the same for the A0xx
family: an Adam toy, lenet5 and the golden fixtures plan clean, then
one seeded corruption per code (a forked Adam slot A001, a plan
replayed over a program with a late reader A002, a fetched donatable
intermediate A003, an in-place update in a host segment A004, an
unsafe backend A005), each asserting its exact code, and the three
modes' ladder.
"""

import argparse
import json
import os
import sys

from . import cli_place, use_gpu_arg


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="lint_cli")
    p.add_argument("model_dir", nargs="?", default=None,
                   help="a save_inference_model directory to lint")
    p.add_argument("--model-filename", default="__model__")
    p.add_argument("--golden", nargs="?", const="", default=None,
                   metavar="DIR",
                   help="lint golden ProgramDesc fixtures (default "
                        "dir: tests/fixtures/golden)")
    p.add_argument("--level", choices=("structural", "full"),
                   default="full",
                   help="structural: desc walking only; full: also "
                        "re-derive output metas via the registry")
    p.add_argument("--fetch", default=None,
                   help="comma-separated runtime fetch names (enables "
                        "dead-op detection)")
    p.add_argument("--mesh", default=None, metavar="SPEC",
                   help="axis=size mesh description, e.g. dp=4,mp=2 — "
                        "also run the static SPMD/sharding analyzer "
                        "(S0xx codes) against it; no card needed")
    p.add_argument("--hbm-gb", type=float, default=None,
                   help="per-device memory budget in GiB for the S005 "
                        "peak-memory check (needs --mesh)")
    p.add_argument("--zero", type=int, default=0, metavar="STAGE",
                   help="ZeRO stage for the sharding analysis "
                        "(1 = dp-shard optimizer state)")
    p.add_argument("--passes", default=None, metavar="SPEC",
                   help="optimize each target through this rewrite "
                        "pipeline (compile/passes.py spec, e.g. "
                        "default+layout+fuse) BEFORE linting — proves a "
                        "pass can never emit a program the linter would "
                        "reject")
    p.add_argument("--donation", action="store_true",
                   help="also run the A0xx donation-safety analysis "
                        "(analysis/alias.py): which buffers each "
                        "captured segment can donate, and why the "
                        "rest are refused")
    p.add_argument("--suppress", default=None,
                   help="comma-separated suppressions, e.g. "
                        "H002,L003@dropout,D002@var:tmp_0")
    p.add_argument("--strict", action="store_true",
                   help="fail (exit 1) on warnings too")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="don't print info-severity findings (they "
                        "still count in the summary)")
    p.add_argument("--json", action="store_true",
                   help="emit the structured report as JSON")
    p.add_argument("--selftest", action="store_true")
    p.add_argument("--use_gpu", type=use_gpu_arg, default=True,
                   help="the selftest's executor leg: 1 on the card (the "
                        "default), 0 on the CPU")
    return p.parse_args(argv)


def _split(csv):
    return [s for s in (csv or "").split(",") if s]


def _shard_analyze(desc, args, report, fetches=None):
    """Run the SPMD analyzer against --mesh, merging S0xx findings
    into `report`; returns the ShardingPlan (None without --mesh)."""
    if not args.mesh:
        return None
    from .. import analysis
    from ..parallel.mesh import parse_mesh_spec

    before = len(report.diagnostics)
    plan = analysis.analyze_sharding(
        desc, parse_mesh_spec(args.mesh), fetches=fetches,
        zero_stage=args.zero, hbm_gb=args.hbm_gb, report=report,
        publish=False)
    # `report` was already published by check_program: count ONLY the
    # findings this analysis added (re-publishing the merged report
    # would double-count every V/D/H/L finding), plus the comm and
    # memory side the plan carries
    analysis.Report(report.diagnostics[before:]).publish(
        origin="lint_cli_mesh")
    plan.publish(diagnostics=False)
    return plan


def _donation_analyze(desc, args, report, fetches=None):
    """Run the donation-safety analysis under --donation, merging A0xx
    findings into `report`; returns the DonationPlan (None without
    --donation)."""
    if not args.donation:
        return None
    from .. import analysis

    before = len(report.diagnostics)
    plan = analysis.analyze_donation(desc, fetches=fetches or (),
                                     report=report, publish=False)
    # as in _shard_analyze: count only the findings this analysis added
    analysis.Report(report.diagnostics[before:]).publish(
        origin="lint_cli_donation")
    return plan


def _report_exit(name, report, args, plan=None, donation=None):
    if args.json:
        doc = report.to_dict()
        doc["target"] = name
        if plan is not None:
            doc["sharding"] = plan.to_dict()
        if donation is not None:
            doc["donation"] = donation.to_dict()
        print(json.dumps(doc, indent=1, sort_keys=True))
    else:
        shown = report.sorted()
        if args.quiet:
            shown = [d for d in shown if d.severity != "info"]
        for d in shown:
            print(d.format())
        if plan is not None:
            comm = plan.comm.totals()
            print("[lint] %s: mesh=%s comm=%s peak_hbm=%.3fGiB"
                  % (name, dict(plan.mesh_axes),
                     {k: int(v) for k, v in comm.items()} or "none",
                     (plan.peak_hbm_bytes or 0) / 2**30))
        if donation is not None:
            donate = sum(len(donation.donate(i))
                         for i in range(len(donation.segments)))
            refused = sum(1 for e in donation.entries
                          if e["status"] == "reclaimable") \
                + sum(len(s["declined"]) for s in donation.segments)
            print("[lint] %s: donation mode=%s(effective %s) "
                  "donates %d buffer(s)/step, %d refused, plan %s"
                  % (name, donation.mode, donation.effective_mode,
                     donate, refused, donation.fingerprint()))
        print("[lint] %s: %d error(s), %d warning(s), %d info, "
              "%d suppressed"
              % (name, len(report.errors), len(report.warnings),
                 len(report.by_severity("info")),
                 len(report.suppressed)))
    failed = bool(report.errors) or (args.strict
                                     and bool(report.warnings))
    return 1 if failed else 0


def lint_model_dir(args):
    from .. import analysis
    from ..core.desc import ProgramDesc

    path = os.path.join(args.model_dir, args.model_filename)
    with open(path) as f:
        meta = json.load(f)
    desc = ProgramDesc.from_dict(meta["program"])
    fetches = _split(args.fetch) or meta.get("fetch_names")
    report = analysis.check_program(
        desc, level=args.level, fetches=fetches,
        bucket_hints=meta.get("bucket_hints"),
        suppress=_split(args.suppress), origin="lint_cli")
    plan = _shard_analyze(desc, args, report, fetches=fetches)
    dplan = _donation_analyze(desc, args, report, fetches=fetches)
    return _report_exit(args.model_dir, report, args, plan=plan,
                        donation=dplan)


def lint_golden(args):
    """Lint every checked-in golden ProgramDesc fixture (a red fixture
    means the pinned IR itself is broken, not just changed).  With
    --mesh the pinned IR must also shard clean against that mesh
    description."""
    from .. import analysis

    results = []  # (name, report, sharding plan, donation plan)
    for name, desc in _golden_descs(args.golden):
        if args.passes:
            # lint the POST-PASS program: the optimized IR is what
            # compiles, so it must satisfy the same linter contract as
            # the pinned fixture (no fetch set here — passes needing
            # one, dce/fuse, decline by contract)
            from ..compile.passes import optimize_program

            desc, _pm = optimize_program(desc, args.passes,
                                         fetches=_split(args.fetch))
            name = "%s [%s]" % (name, _pm.pipeline_id)
        report = analysis.check_program(
            desc, level=args.level, suppress=_split(args.suppress),
            origin="lint_golden")
        plan = _shard_analyze(desc, args, report)
        dplan = _donation_analyze(desc, args, report)
        results.append((name, report, plan, dplan))
    if not results:
        print("[lint] no golden ProgramDesc fixtures found")
        return 1
    if args.json:
        # ONE parseable document for the whole fixture set, not one
        # json.dumps per fixture
        docs = []
        rc = 0
        for name, report, plan, dplan in results:
            d = report.to_dict()
            d["target"] = name
            if plan is not None:
                d["sharding"] = plan.to_dict()
            if dplan is not None:
                d["donation"] = dplan.to_dict()
            docs.append(d)
            if report.errors or (args.strict and report.warnings):
                rc = 1
        print(json.dumps(docs, indent=1, sort_keys=True))
        return rc
    rc = 0
    for name, report, plan, dplan in results:
        rc |= _report_exit(name, report, args, plan=plan,
                           donation=dplan)
    return rc


def _golden_descs(golden_dir=None):
    """[(name, ProgramDesc)] for every checked-in golden fixture."""
    from ..core.desc import ProgramDesc

    golden_dir = golden_dir or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "tests", "fixtures", "golden")
    out = []
    for fname in sorted(os.listdir(golden_dir)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(golden_dir, fname)) as f:
            doc = json.load(f)
        if "blocks" in doc:
            out.append((fname, ProgramDesc.from_dict(doc)))
        elif "trainer" in doc:  # transpiled_pair: trainer program + table
            out.append((fname + ":trainer",
                        ProgramDesc.from_dict(doc["trainer"])))
    return out


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------

def _build_train_program():
    """A fresh fit-a-line-style training program (fc -> mse -> SGD) in
    its own Program pair; returns (main, startup, loss_name,
    param_name)."""
    from .. import fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    param = [v.name for v in main.global_block().vars.values()
             if getattr(v.desc, "is_parameter", False)][0]
    return main, startup, loss.name, param


def _corruptions(main, loss_name, param_name):
    """[(corruption label, expected code, mutator(program))] — each
    mutator receives a FRESH clone of the clean program."""
    from ..core.desc import BlockRef, OpDesc, VarDesc

    def unknown_op(p):
        p.desc.block(0).ops[1].type = "definitely_not_an_op"

    def use_before_def(p):
        ops = p.desc.block(0).ops
        # hoist the loss-producing op above its producers
        idx = next(i for i, od in enumerate(ops)
                   if loss_name in od.output_names())
        ops.insert(0, ops.pop(idx))

    def dtype_mismatch(p):
        bd = p.desc.block(0)
        # the fc matmul output: recorded int32 vs re-derived float32
        out = next(od.output_names()[0] for od in bd.ops
                   if od.type == "mul")
        bd.vars[out].dtype = "int32"

    def dangling_block_ref(p):
        p.desc.block(0).ops[0].attrs["sub_block"] = BlockRef(7)

    def write_write(p):
        bd = p.desc.block(0)
        i = next(i for i, od in enumerate(bd.ops) if od.type == "mul")
        od = bd.ops[i]
        bd.ops.insert(i + 1, OpDesc(od.type, dict(od.inputs),
                                    dict(od.outputs), dict(od.attrs)))

    def alias_race(p):
        bd = p.desc.block(0)
        bd.vars["__shadow__"] = VarDesc("__shadow__", dtype="float32",
                                        shape=(13, 1))
        # an unordered reader of the in-place-updated parameter
        bd.ops.insert(0, OpDesc("scale", {"X": [param_name]},
                                {"Out": ["__shadow__"]}, {"scale": 2.0}))

    def dead_op(p):
        bd = p.desc.block(0)
        bd.vars["__unused__"] = VarDesc("__unused__", dtype="float32",
                                        shape=(1,))
        bd.ops.append(OpDesc("scale", {"X": [loss_name]},
                             {"Out": ["__unused__"]}, {"scale": 1.0}))

    return [
        ("unknown op", "V001", unknown_op),
        ("use-before-def", "V003", use_before_def),
        ("dtype mismatch", "V005", dtype_mismatch),
        ("dangling BlockRef", "V004", dangling_block_ref),
        ("write-write race", "H001", write_write),
        ("in-place alias read hazard", "H002", alias_race),
        ("dead op", "D001", dead_op),
    ]


# the four multichip dryrun mesh shapes: the sharding selftest proves
# every clean program analyzes green on ALL of them
DRYRUN_MESHES = [
    ("dp/mp", "dp=4,mp=2"),
    ("dp/mp/sp", "dp=2,mp=2,sp=2"),
    ("pp/dp", "pp=4,dp=2"),
    ("dp/ep", "dp=2,ep=4"),
]


def _build_lenet5_train():
    """lenet5 -> cross-entropy -> Momentum in a fresh Program pair (the
    flagship small-model topology: conv/pool/fc/softmax, real backward
    and update ops)."""
    from .. import fluid
    from ..models.image import lenet5

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 28, 28],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1],
                                  dtype="int64")
        probs = lenet5(img, class_dim=10)
        loss = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=probs, label=label))
        fluid.optimizer.MomentumOptimizer(
            learning_rate=0.01, momentum=0.9).minimize(loss)
    return main, loss.name


def _shard_corruptions():
    """[(label, expected S-code, run(analysis, mesh) -> Report)] — one
    seeded sharding corruption per stable S0xx code, each run against a
    mesh parsed from a dryrun shape."""
    from .. import fluid
    from ..parallel.mesh import parse_mesh_spec

    def _mlp(batch=None):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            kw = {} if batch is None else \
                {"append_batch_size": False}
            shp = [1024] if batch is None else [batch, 1024]
            x = fluid.layers.data(name="x", shape=shp,
                                  dtype="float32", **kw)
            h = fluid.layers.fc(input=x, size=1024, act="relu")
            loss = fluid.layers.mean(x=h)
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return main, loss.name

    def s001_unmatched_rule(analysis, mesh):
        main, loss = _mlp()
        return analysis.analyze_sharding(
            main, mesh, fetches=[loss], publish=False,
            rules=[("^matches_nothing$", ())]).report

    def s002_non_divisible_batch(analysis, mesh):
        main, loss = _mlp(batch=6)  # 6 % dp=4 != 0
        # concrete_feeds: the trainer boundary, where the static
        # batch IS the runtime batch
        return analysis.analyze_sharding(
            main, mesh, fetches=[loss], publish=False,
            concrete_feeds=True).report

    def s003_conflicting_layouts(analysis, mesh):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            a = fluid.layers.data(name="a", shape=[8, 16],
                                  dtype="float32",
                                  append_batch_size=False)
            b = fluid.layers.data(name="b", shape=[8, 16],
                                  dtype="float32",
                                  append_batch_size=False)
            fluid.layers.elementwise_add(x=a, y=b)
        # a shards dim0 over dp (the default), b demands mp there
        return analysis.analyze_sharding(
            main, mesh, feed_specs={"b": ("mp",)},
            publish=False).report

    def s004_schedule_mismatch(analysis, mesh):
        # 3 stacked stages on a pp=4 ring: the ppermute misroutes
        return analysis.check_pipeline(
            parse_mesh_spec("pp=4,dp=2"), n_stages=3,
            n_microbatches=8)

    def s005_hbm_budget(analysis, mesh):
        main, loss = _mlp()
        return analysis.analyze_sharding(
            main, mesh, fetches=[loss], hbm_gb=1e-6,
            publish=False).report

    return [
        ("param matched no partition rule", "S001",
         s001_unmatched_rule),
        ("batch not divisible by dp", "S002",
         s002_non_divisible_batch),
        ("conflicting input layouts", "S003",
         s003_conflicting_layouts),
        ("pipeline stage/mesh mismatch", "S004",
         s004_schedule_mismatch),
        ("peak HBM over budget", "S005", s005_hbm_budget),
    ]


def _build_two_segment():
    """fc -> print -> mean: the host print op splits block 0 into two
    captured segments, so the fc output crosses a segment boundary and
    the tail segment can (provably) donate it.  Returns (main, startup,
    intermediate name, loss name)."""
    from .. import fluid
    from ..core.desc import OpDesc

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        h = fluid.layers.fc(input=x, size=8)
        loss = fluid.layers.mean(x=h)
    bd = main.desc.block(0)
    i = next(i for i, od in enumerate(bd.ops) if od.type == "mean")
    bd.ops.insert(i, OpDesc("print", {"X": [h.name]},
                            {"Out": [h.name]},
                            {"message": "seg-split", "summarize": 1}))
    return main, startup, h.name, loss.name


def _build_adam_toy():
    """fc -> mean -> Adam in a fresh Program pair (the JAX package's
    mem_cli toy)."""
    from .. import fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[64], dtype="float32")
        h = fluid.layers.fc(input=x, size=32)
        cost = fluid.layers.mean(x=h)
        fluid.optimizer.AdamOptimizer(learning_rate=0.01).minimize(cost)
    return main, startup, cost


def _fork_adam_slot(program):
    """Break one Adam update's Moment1Out alias on purpose (the H003
    fork class); returns the stranded moment's name."""
    from ..core.desc import VarDesc

    bd = program.desc.block(0)
    for od in bd.ops:
        if od.type == "adam":
            m1 = od.input("Moment1")[0]
            fork = m1 + "__fork"
            src = bd.vars[m1]
            bd.vars[fork] = VarDesc(fork, src.type, src.dtype,
                                    src.shape, persistable=True)
            od.outputs["Moment1Out"] = [fork]
            return m1
    raise AssertionError("no adam op to fork")


def _donation_corruptions():
    """[(label, expected A-code, run(analysis) -> Report)]: one seeded
    donation-safety corruption per stable A0xx code."""
    from ..core.desc import OpDesc

    def a001_forked_slot(analysis):
        main, _startup, cost = _build_adam_toy()
        _fork_adam_slot(main)
        return analysis.analyze_donation(
            main, fetches=[cost.name], publish=False).report

    def a002_late_reader(analysis):
        # plan first, then the program grows a reader of the donated
        # intermediate: replaying the stale plan must be an ERROR
        main, _startup, hname, lname = _build_two_segment()
        plan = analysis.analyze_donation(main, fetches=[lname],
                                         feeds=["x"], publish=False)
        assert any(hname in s["widened"] for s in plan.segments), \
            "two-segment seed did not widen %r: %r" \
            % (hname, [s["widened"] for s in plan.segments])
        main.desc.block(0).ops.append(
            OpDesc("scale", {"X": [hname]}, {"Out": ["__late__"]},
                   {"scale": 2.0}))
        return plan.verify(main, fetches=[lname, "__late__"])

    def a003_fetched_candidate(analysis):
        main, _startup, hname, lname = _build_two_segment()
        return analysis.analyze_donation(
            main, fetches=[hname, lname], feeds=["x"],
            publish=False).report

    def a004_non_captured_update(analysis):
        # dist_send declares ParamOut in place but is a host op: the
        # declared reuse strands in its eager segment
        main, _startup, cost = _build_adam_toy()
        bd = main.desc.block(0)
        pname = next(n for n, vd in bd.vars.items() if vd.is_parameter)
        bd.ops.append(OpDesc("dist_send",
                             {"Param": [pname], "Grad": [pname]},
                             {"ParamOut": [pname]},
                             {"param_name": pname, "blocks": []}))
        return analysis.analyze_donation(
            main, fetches=[cost.name], publish=False).report

    def a005_unsafe_backend(analysis):
        main, _startup, cost = _build_adam_toy()
        return analysis.analyze_donation(
            main, fetches=[cost.name], mode="auto",
            backend_safe=False, publish=False).report

    return [
        ("forked in-place slot", "A001", a001_forked_slot),
        ("read-after-donation hazard", "A002", a002_late_reader),
        ("fetch aliases donatable buffer", "A003",
         a003_fetched_candidate),
        ("in-place update stranded in a host segment", "A004",
         a004_non_captured_update),
        ("donation-unsafe backend", "A005", a005_unsafe_backend),
    ]


def _selftest_donation(args):
    """The donation-safety analyzer leg of --selftest."""
    from .. import analysis

    # 1. clean targets plan with zero A-code findings: the adam toy
    #    (donates its conservative set), lenet5, every golden fixture
    main, _startup, cost = _build_adam_toy()
    plan = analysis.analyze_donation(main, fetches=[cost.name],
                                     publish=False)
    assert plan.report.ok() and not plan.report.codes(), \
        "clean adam toy reported:\n%s" % plan.report.format()
    assert any(plan.donate(i) for i in range(len(plan.segments))), \
        "clean adam toy donates nothing"
    lenet_main, lenet_loss = _build_lenet5_train()
    targets = [("lenet5", lenet_main, [lenet_loss])]
    targets += [(name, desc, None) for name, desc in _golden_descs()]
    for name, prog, fetches in targets:
        p = analysis.analyze_donation(prog, fetches=fetches,
                                      publish=False)
        assert p.report.ok(), "%s donation plan has errors:\n%s" \
            % (name, p.report.format())

    # 2. every seeded corruption reports its exact A-code
    for label, code, run in _donation_corruptions():
        report = run(analysis)
        assert report.has(code), \
            "%s: expected %s, got codes %s\n%s" \
            % (label, code, report.codes(), report.format())

    # 3. the mode ladder is ordered: off donates nothing,
    #    conservative a subset of auto, and the fingerprints differ
    plans = {m: analysis.analyze_donation(main, fetches=[cost.name],
                                          mode=m, publish=False)
             for m in ("off", "conservative", "auto")}
    for i in range(len(plans["auto"].segments)):
        assert plans["off"].donate(i) == ()
        assert set(plans["conservative"].donate(i)) <= \
            set(plans["auto"].donate(i))
    assert plans["off"].fingerprint() != plans["auto"].fingerprint()
    return len(_donation_corruptions())


def _selftest_sharding(args):
    """The sharding analyzer leg of --selftest."""
    from .. import analysis
    from ..obs import registry as obs_registry
    from ..parallel.mesh import parse_mesh_spec

    # 1. the clean lenet5 training program and every golden fixture
    #    analyze with ZERO errors on all four dryrun mesh shapes
    lenet_main, lenet_loss = _build_lenet5_train()
    targets = [("lenet5", lenet_main, [lenet_loss])]
    targets += [(name, desc, None) for name, desc in _golden_descs()]
    for mesh_label, mesh_spec in DRYRUN_MESHES:
        mesh = parse_mesh_spec(mesh_spec)
        for name, prog, fetches in targets:
            plan = analysis.analyze_sharding(prog, mesh,
                                             fetches=fetches,
                                             publish=False)
            assert plan.report.ok(), \
                "%s on %s mesh reported errors:\n%s" \
                % (name, mesh_label, plan.report.format())

    # 2. every seeded sharding corruption reports its exact S-code.
    # The seeds are tuned to this mesh (batch 6 % dp=4, an mp axis to
    # conflict with) — pinned, NOT args.mesh, so any legal --mesh
    # value leaves the selftest self-contained
    default_mesh = parse_mesh_spec("dp=4,mp=2")
    for label, code, run in _shard_corruptions():
        report = run(analysis, default_mesh)
        assert report.has(code), \
            "%s: expected %s, got codes %s\n%s" \
            % (label, code, report.codes(), report.format())
        assert any(d.code == code and d.severity in
                   ("error", "warning") for d in report.diagnostics), \
            "%s: %s only reported as info" % (label, code)

    # 3. the comm cost model prices the dp gradient sync and lands in
    #    the registry as shard_comm_bytes_total{collective}
    plan = analysis.analyze_sharding(lenet_main, default_mesh,
                                     fetches=[lenet_loss],
                                     publish=True,
                                     origin="lint_selftest")
    totals = plan.comm.totals()
    assert totals.get("allreduce", 0) > 0, \
        "no gradient all-reduce priced: %s" % totals
    assert plan.peak_hbm_bytes and plan.peak_hbm_bytes > 0
    snap = {s["name"] for s in
            obs_registry.get_registry().to_dict()["metrics"]}
    assert "shard_comm_bytes_total" in snap, \
        "shard_comm_bytes_total missing from the registry"
    return len(_shard_corruptions())


def selftest(args):
    import numpy as np

    from .. import analysis, fluid
    from ..obs import registry as obs_registry
    from ..utils import flags

    place = cli_place(args.use_gpu)
    place.device()  # a CUDAPlace without a CUDA device raises here

    main, startup, loss_name, param_name = _build_train_program()

    # 1. the clean program: zero error-severity diagnostics
    clean = analysis.check_program(main, level="full",
                                   fetches=[loss_name],
                                   origin="lint_selftest")
    assert clean.ok(), \
        "clean program reported errors:\n%s" % clean.format()

    # 2. every seeded corruption reports its stable code
    for label, code, mutate in _corruptions(main, loss_name,
                                            param_name):
        prog = main.clone()
        mutate(prog)
        report = analysis.check_program(prog, level="full",
                                        fetches=[loss_name],
                                        publish=False)
        assert report.has(code), \
            "%s: expected %s, got codes %s\n%s" \
            % (label, code, report.codes(), report.format())

    # 3. suppression: the same corruption vanishes when suppressed
    prog = main.clone()
    _corruptions(main, loss_name, param_name)[0][2](prog)
    sup = analysis.check_program(prog, level="full", suppress=("V001",),
                                 publish=False)
    assert not sup.has("V001") and sup.suppressed, "suppression broken"

    # 4. the executor gate: corruption fails BEFORE any op runs,
    #    naming op index + var
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    with fluid.scope_guard(scope):
        exe.run(startup)
        prev = flags.get_flag("verify_program")
        flags.set_flag("verify_program", True)
        try:
            feed = {"x": np.zeros((2, 13), np.float32),
                    "y": np.zeros((2, 1), np.float32)}
            out, = exe.run(main, feed=feed, fetch_list=[loss_name])
            assert np.isfinite(out).all()
            bad = main.clone()
            bad.desc.block(0).ops[2].type = "definitely_not_an_op"
            try:
                exe.run(bad, feed=feed, fetch_list=[loss_name])
                raise AssertionError(
                    "corrupted program ran under FLAGS_verify_program")
            except analysis.ProgramVerificationError as err:
                first = err.report.errors[0]
                assert first.op_index is not None, first
                assert "op 2" in str(err), err
        finally:
            flags.set_flag("verify_program", prev)

    # 5. finding counters landed in the obs registry
    snap = {s["name"]: s for s in
            obs_registry.get_registry().to_dict()["metrics"]}
    assert "analysis_diagnostics_total" in snap or any(
        k.startswith("analysis_") for k in snap), \
        "no analysis_* metrics in the registry"

    # 6. the SPMD/sharding analyzer: clean programs green on all four
    #    dryrun mesh shapes, seeded S0xx corruptions each caught,
    #    comm cost model in the registry
    n_shard = _selftest_sharding(args)

    # 7. the donation-safety analyzer: clean programs plan green,
    #    seeded A0xx corruptions each caught
    n_donation = _selftest_donation(args)

    print("[lint] selftest green: clean program verified (0 errors), "
          "%d seeded corruptions each reported their code, "
          "suppression filters, executor FLAGS_verify_program gate "
          "on %s rejects before any op runs with op identity, finding "
          "counters in the registry; sharding: lenet5 + golden "
          "fixtures clean on %d dryrun mesh shapes, %d seeded S-code "
          "corruptions each caught, comm bytes published; donation: "
          "clean targets plan green, %d seeded A-code corruptions "
          "each caught"
          % (len(_corruptions(main, loss_name, param_name)), place,
             len(DRYRUN_MESHES), n_shard, n_donation), flush=True)
    return 0


def main(argv=None):
    args = parse_args(argv)
    if args.selftest:
        return selftest(args)
    if args.golden is not None:
        return lint_golden(args)
    if args.model_dir:
        return lint_model_dir(args)
    raise SystemExit("nothing to do: pass a model dir, --golden, or "
                     "--selftest")


if __name__ == "__main__":
    sys.exit(main())
