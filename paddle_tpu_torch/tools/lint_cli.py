"""The static-analysis CLI over Program IR.

    # lint a save_inference_model export (the __model__ JSON, written
    # by either package):
    python -m paddle_tpu_torch.tools.lint_cli path/to/model_dir

    # lint the checked-in golden program fixtures
    # (tests/fixtures/golden), optionally after a rewrite pipeline:
    python -m paddle_tpu_torch.tools.lint_cli --golden --passes default

    # the certification run, its executor leg on the card (--use_gpu=0:
    # on the CPU):
    python -m paddle_tpu_torch.tools.lint_cli --selftest

Counterpart of paddle_tpu/tools/lint_cli.py over the port's
`analysis` and `compile.passes`.  Exit status: 0 when no
error-severity finding survives suppression, 1 otherwise (`--strict`
also fails on warnings).  `--json` emits the structured report instead
of text; the codes, severities and suppression syntax are the JAX
package's.

`--mesh`, `--hbm-gb` and `--zero` need the sharding analyzer and the
mesh (ROADMAP A9); `--donation` needs the donation-safety analysis
(A2).  Each raises SystemExit naming its item.

`--selftest` builds a REAL training program, asserts it verifies with
zero error-severity diagnostics, then seeds seven deliberate
corruptions — unknown op, use-before-def, dtype mismatch, dangling
BlockRef, write-write race, in-place alias read hazard, dead op — and
asserts each is reported under its stable diagnostic code; it checks
that a suppression filters, drives the executor's FLAGS_verify_program
gate end to end at the place `--use_gpu` names (the corrupted program
must fail BEFORE any op runs, with an error naming the op index and
variable), and finds the finding counters in the registry.  The JAX
selftest's sharding and donation legs wait on A9 and A2; the port's
prints a line saying so.
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
                   help="the static sharding analyzer against a mesh "
                        "description: waits with the mesh (ROADMAP A9)")
    p.add_argument("--hbm-gb", type=float, default=None,
                   help="the sharding analyzer's per-device memory "
                        "budget: waits with the mesh (ROADMAP A9)")
    p.add_argument("--zero", type=int, default=0, metavar="STAGE",
                   help="ZeRO stage for the sharding analysis: waits "
                        "with the mesh (ROADMAP A9)")
    p.add_argument("--passes", default=None, metavar="SPEC",
                   help="optimize each target through this rewrite "
                        "pipeline (compile/passes.py spec, e.g. "
                        "default+layout+fuse) BEFORE linting — proves a "
                        "pass can never emit a program the linter would "
                        "reject")
    p.add_argument("--donation", action="store_true",
                   help="the donation-safety analysis: waits with "
                        "buffer donation (ROADMAP A2)")
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


def _refuse_waiting(args):
    """The options whose analyses have no port yet raise SystemExit
    naming their ROADMAP item."""
    if args.mesh or args.hbm_gb is not None or args.zero:
        raise SystemExit(
            "lint_cli: --mesh, --hbm-gb and --zero need the sharding "
            "analyzer (analysis/shard.py) and the mesh (parallel.mesh), "
            "which the port does not have yet (ROADMAP A9)")
    if args.donation:
        raise SystemExit(
            "lint_cli: --donation needs the donation-safety analysis "
            "(analysis/alias.py) and buffer donation, which the port "
            "does not have yet (ROADMAP A2)")


def _report_exit(name, report, args):
    if args.json:
        doc = report.to_dict()
        doc["target"] = name
        print(json.dumps(doc, indent=1, sort_keys=True))
    else:
        shown = report.sorted()
        if args.quiet:
            shown = [d for d in shown if d.severity != "info"]
        for d in shown:
            print(d.format())
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
    return _report_exit(args.model_dir, report, args)


def lint_golden(args):
    """Lint every checked-in golden ProgramDesc fixture (a red fixture
    means the pinned IR itself is broken, not just changed)."""
    from .. import analysis

    results = []  # (name, report)
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
        results.append((name, report))
    if not results:
        print("[lint] no golden ProgramDesc fixtures found")
        return 1
    if args.json:
        # ONE parseable document for the whole fixture set, not one
        # json.dumps per fixture
        docs = []
        rc = 0
        for name, report in results:
            d = report.to_dict()
            d["target"] = name
            docs.append(d)
            if report.errors or (args.strict and report.warnings):
                rc = 1
        print(json.dumps(docs, indent=1, sort_keys=True))
        return rc
    rc = 0
    for name, report in results:
        rc |= _report_exit(name, report, args)
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

    print("[lint] selftest green: clean program verified (0 errors), "
          "%d seeded corruptions each reported their code, "
          "suppression filters, executor FLAGS_verify_program gate "
          "on %s rejects before any op runs with op identity, finding "
          "counters in the registry"
          % (len(_corruptions(main, loss_name, param_name)), place),
          flush=True)
    print("[lint] the sharding leg waits with the mesh (ROADMAP A9), "
          "the donation leg with buffer donation (ROADMAP A2)",
          flush=True)
    return 0


def main(argv=None):
    args = parse_args(argv)
    _refuse_waiting(args)
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
