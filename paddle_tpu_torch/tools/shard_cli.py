"""pshard — the SPMD partition-plan CLI (paddle_tpu_torch.spmd).

    # build the partition-plan artifact for a model x mesh: run the
    # static sharding analyzer (rules layered over the param_spec
    # heuristics), print the layout summary, save the JSON document
    # the trainer and CI consume
    python -m paddle_tpu_torch.tools.shard_cli plan --model lenet5 \\
        --mesh dp=4,mp=2 --batch 64 [--rules rules.json] \\
        [--zero-stage 1] [--out plan.json]

    # render a saved plan artifact (layout, comm floor, diagnostics)
    python -m paddle_tpu_torch.tools.shard_cli show --plan plan.json

    # the certification run, its training leg on the card (--use_gpu=0:
    # on the CPU)
    python -m paddle_tpu_torch.tools.shard_cli --selftest

Counterpart of paddle_tpu/tools/shard_cli.py.  `plan` needs no card:
the analyzer works on a static MeshConfig, so a laptop can pre-compute
and review the layout a large job will launch with; a plan built here
has the JAX CLI's fingerprint.  `--selftest` proves the loop on the
process group's ranks (one without a launcher): rule matching
precedence, a plan build whose rules change the layout, save/load
round-trip with a stable fingerprint, a REAL SpmdTrainer step driven
by the plan at the place `--use_gpu` names, and a sharded checkpoint
save -> restore into a fresh trainer with nothing densified.

The models are the autotuner's image models, built through
`tune.models` (the port's one copy of the builder).
"""

import argparse
import os
import sys
import tempfile

from . import cli_place, use_gpu_arg
from ..tune.models import MODELS, builder


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="shard_cli")
    p.add_argument("cmd", nargs="?", choices=["plan", "show"],
                   help="plan: build + save the partition plan; "
                        "show: render a saved plan")
    p.add_argument("--model", default="lenet5",
                   help="image model name (default lenet5; one of %s)"
                        % ", ".join(sorted(MODELS)))
    p.add_argument("--mesh", default="dp=8",
                   help="mesh spec, e.g. dp=4,mp=2 (default dp=8)")
    p.add_argument("--batch", type=int, default=64,
                   help="global batch the plan is built for")
    p.add_argument("--rules", default=None,
                   help="partition-rules JSON path "
                        "(spmd.plan.load_rules format)")
    p.add_argument("--zero-stage", type=int, default=0,
                   choices=[0, 1],
                   help="zero1 optimizer-state sharding")
    p.add_argument("--out", default=None,
                   help="write the plan JSON here")
    p.add_argument("--plan", default=None,
                   help="saved plan path (for `show`)")
    p.add_argument("--selftest", action="store_true",
                   help="prove the plan->train->checkpoint loop")
    p.add_argument("--use_gpu", type=use_gpu_arg, default=True,
                   help="the selftest's training leg: 1 on the card (the "
                        "default), 0 on the CPU")
    return p.parse_args(argv)


def cmd_plan(args):
    from ..parallel.mesh import parse_mesh_spec
    from ..spmd.plan import build_partition_plan, load_rules

    main, _startup, loss_name = builder(
        args.model, with_startup=True)(args.batch)
    mesh = parse_mesh_spec(args.mesh)
    rules = load_rules(args.rules) if args.rules else None
    # print the findings instead of raising: the CLI is the review
    # surface, a human reads the S0xx lines and fixes the layout
    plan = build_partition_plan(
        main, mesh, ["image", "label"], [loss_name], rules=rules,
        zero_stage=args.zero_stage, model=args.model,
        raise_on_error=False)
    print(plan.summary())
    if args.out:
        plan.save(args.out)
        print("plan written to %s (fingerprint %s)"
              % (args.out, plan.fingerprint()))
    errors = [d for d in plan.diagnostics
              if d.get("severity") == "error"]
    return 1 if errors else 0


def cmd_show(args):
    from ..spmd.plan import PartitionPlan

    if not args.plan:
        raise SystemExit("shard_cli show needs --plan <path>")
    plan = PartitionPlan.load(args.plan)
    print(plan.summary())
    print("fingerprint: %s" % plan.fingerprint())
    return 0


def selftest(args):
    import numpy as np
    import torch.distributed as dist

    from ..parallel.mesh import make_mesh, parse_mesh_spec
    from ..spmd.plan import (PartitionPlan, build_partition_plan,
                             load_rules, match_partition_rules)
    from ..spmd.trainer import SpmdTrainer

    place = cli_place(args.use_gpu)
    place.device()  # a CUDAPlace without a CUDA device raises here
    failures = []

    def check(name, ok, detail=""):
        print("  %-44s %s%s" % (name, "PASS" if ok else "FAIL",
                                (" " + detail if detail else "")))
        if not ok:
            failures.append(name)

    print("pshard selftest:")

    # 1. rule matching: first match wins, full-name anchoring
    rules = load_rules([[r"fc_.*\.w_0", ["mp", None]],
                        [r".*\.w_0", [None, "mp"]]])
    check("rule precedence (first match wins)",
          match_partition_rules(rules, "fc_1.w_0")[0] == ("mp", None)
          and match_partition_rules(rules, "conv0.w_0")[0]
          == (None, "mp")
          and match_partition_rules(rules, "fc_1.b_0")
          == (None, None))

    # 2. plan build on a static mesh (no card), rules change layout
    main, startup, loss_name = builder("lenet5", with_startup=True)(32)
    mesh = parse_mesh_spec("dp=2,mp=2")
    base = build_partition_plan(main, mesh, ["image", "label"],
                                [loss_name], model="lenet5")
    ruled = build_partition_plan(
        main, mesh, ["image", "label"], [loss_name],
        rules=load_rules([[r"fc_.*\.w_0", ["mp", None]]]),
        model="lenet5")
    moved = [n for n in ruled.sharded_params()
             if n.startswith("fc_") and n.endswith(".w_0")
             and tuple(ruled.var_specs[n])[0] == "mp"]
    check("rules reshape the layout", bool(moved),
          "fc w_0 -> %s" % (moved and
                            list(ruled.var_specs[moved[0]])))
    check("plan fingerprints differ under rules",
          base.fingerprint() != ruled.fingerprint())

    # 3. save/load round-trip, fingerprint stable
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "plan.json")
        ruled.save(path)
        loaded = PartitionPlan.load(path)
        check("save/load round-trip keeps the fingerprint",
              loaded.fingerprint() == ruled.fingerprint())
        check("round-trip keeps every var spec",
              loaded.var_specs == ruled.var_specs)

    # 4. a REAL plan-driven training step on the process group's ranks
    # (a world of one, started here and stopped after, when no group
    # is up)
    started = not dist.is_initialized()
    try:
        mesh = make_mesh(device="cuda" if args.use_gpu else "cpu")
        n = mesh.size()
        batch = 4 * n
        main, startup, loss_name = builder("lenet5",
                                                   with_startup=True)(batch)
        trainer = SpmdTrainer(main, startup, ["image", "label"],
                              [loss_name], mesh, model="lenet5",
                              use_pcache=False)
        trainer.init()
        rs = np.random.RandomState(7)
        feeds = {"image": rs.rand(batch, 1, 28, 28).astype(np.float32),
                 "label": rs.randint(0, 10, size=(batch, 1))
                 .astype(np.int64)}
        (loss0,) = trainer.step(feeds)
        (loss1,) = trainer.step(feeds)
        loss0 = float(loss0.reshape(-1)[0])
        loss1 = float(loss1.reshape(-1)[0])
        check("plan-driven step trains (%d device(s))" % n,
              np.isfinite(loss0) and loss1 < loss0,
              "loss %.4f -> %.4f" % (loss0, loss1))

        with tempfile.TemporaryDirectory() as tmp:
            trainer.save_checkpoint(tmp, step=2)
            fresh = SpmdTrainer(main, startup, ["image", "label"],
                                [loss_name], mesh, model="lenet5",
                                use_pcache=False)
            fresh.init()
            info = fresh.restore_checkpoint(tmp)
            same = all(
                np.allclose(fresh.fetch_state(k), trainer.fetch_state(k))
                for k in trainer.state)
            check("sharded checkpoint round-trip, nothing densified",
                  info["step"] == 2 and not info["densified"] and same)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()

    if failures:
        print("pshard selftest: FAIL (%s)" % ", ".join(failures))
        return 1
    print("pshard selftest: green")
    return 0


def main(argv=None):
    args = parse_args(argv)
    if args.selftest:
        return selftest(args)
    if args.cmd == "plan":
        return cmd_plan(args)
    if args.cmd == "show":
        return cmd_show(args)
    raise SystemExit("nothing to do: pass plan|show or --selftest")


if __name__ == "__main__":
    sys.exit(main())
