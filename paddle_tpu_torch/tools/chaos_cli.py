"""Chaos harness CLI: supervised training under injected failure.

    # the certification run, on the card (--use_gpu=0: on the CPU):
    python -m paddle_tpu_torch.tools.chaos_cli --selftest

    # a custom chaos run (fault spec: point:kind[:after[:times]]):
    python -m paddle_tpu_torch.tools.chaos_cli --epochs 3 --seed 11 \
        --faults reader/pump:io_error:5,supervisor/step:preempt:9

Counterpart of paddle_tpu/tools/chaos_cli.py.  `--selftest` drives the
resilience contract end to end: an MNIST-scale MLP classifier trains
twice on the same seed through the v2 API, once fault-free and once
under chaos (one transient reader IOError, one real SIGTERM preemption,
one forced-nonfinite step) with the `TrainingSupervisor` driving
checkpoint and resume.  It asserts that

  * the supervised run completes despite all three faults,
  * its final parameters equal the fault-free run's bit for bit (the
    urgent checkpoint, the batch-skip resume and the nonfinite rollback
    rebuild the exact trajectory),
  * the per-step loss trajectory matches step for step, and
  * `faults_injected_total{point,kind}` and `supervisor_restarts_total`
    show that the faults fired and that recovery ran, and
  * a run preempted by a real SIGTERM with the persistent plan cache on
    (FLAGS_compile_cache_dir), then restarted (fresh programs, executor
    and scope: everything a process restart clears), resumes and
    finishes with every program it plans served from the cache.

The JAX selftest's warm-cache leg asserts zero fresh XLA compiles.  A
CUDA graph cannot be reloaded, so the port's restart still captures its
segments: its assertion reads plan hits (`compile_cache_hits_total`
above zero, no miss) instead of zero captures.
"""

import argparse
import os
import sys
import tempfile

from . import cli_place, use_gpu_arg


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="paddle_chaos")
    p.add_argument("--selftest", action="store_true",
                   help="chaos certification: supervised run with "
                        "injected faults must match a fault-free run")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--steps", type=int, default=8,
                   help="batches per epoch")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seed", type=int, default=7,
                   help="data/fault-plan seed")
    p.add_argument("--ckpt-every", type=int, default=1,
                   help="supervisor steps_per_checkpoint")
    p.add_argument("--max-restarts", type=int, default=5)
    p.add_argument("--faults", default=None,
                   help="comma list of point:kind[:after[:times]] "
                        "(default: the selftest trio)")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory (default: a tmpdir)")
    p.add_argument("--use_gpu", type=use_gpu_arg, default=True,
                   help="1: train on the card (the default); 0: on the "
                        "CPU")
    return p.parse_args(argv)


def _fresh_workspace():
    """Fresh default programs and scope, so two runs in one process
    share no state."""
    from paddle_tpu_torch.core import scope as scope_mod
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.v2 import layer as v2_layer

    framework.switch_main_program(framework.Program())
    framework.switch_startup_program(framework.Program())
    scope_mod._global_scope = scope_mod.Scope()
    v2_layer._reset_data_layers()


def _build_mnist_mlp(use_gpu):
    """MNIST-scale classifier on the v2 API: 64-dim class-templated
    synthetic images -> tanh MLP -> softmax over 10 digits."""
    import paddle_tpu_torch.v2 as paddle

    paddle.init(use_gpu=use_gpu)
    img = paddle.layer.data(name="img",
                            type=paddle.data_type.dense_vector(64))
    label = paddle.layer.data(name="label",
                              type=paddle.data_type.integer_value(10))
    hidden = paddle.layer.fc(input=img, size=32,
                             act=paddle.activation.Tanh())
    pred = paddle.layer.fc(input=hidden, size=10,
                           act=paddle.activation.Softmax())
    cost = paddle.layer.classification_cost(input=pred, label=label)
    params = paddle.parameters.create(cost)
    sgd = paddle.trainer.SGD(
        cost=cost, parameters=params,
        update_equation=paddle.optimizer.Momentum(momentum=0.9,
                                                  learning_rate=0.05))
    return sgd


def _make_batches(args):
    from paddle_tpu_torch.dataset.common import synthetic_images

    imgs, labels = synthetic_images(args.steps * args.batch, (64,), 10,
                                    seed=args.seed)
    return [
        [(imgs[i], int(labels[i]))
         for i in range(b * args.batch, (b + 1) * args.batch)]
        for b in range(args.steps)
    ]


def _final_params(sgd):
    from paddle_tpu_torch.core.scope import global_scope
    from paddle_tpu_torch.fluid.io import is_persistable

    out = {}
    for v in sgd._main_program.list_vars():
        if not is_persistable(v):
            continue
        val = global_scope().get(v.name)
        if val is not None:
            out[v.name] = val.detach().cpu().numpy()
    return out


def _parse_fault_specs(text):
    specs = []
    for item in text.split(","):
        parts = item.strip().split(":")
        if len(parts) < 2:
            raise SystemExit("bad fault spec %r (want "
                             "point:kind[:after[:times]])" % item)
        point, kind = parts[0], parts[1]
        after = int(parts[2]) if len(parts) > 2 else 0
        times = int(parts[3]) if len(parts) > 3 else 1
        specs.append((point, kind, after, times))
    return specs


def _default_fault_specs(args):
    # one of each: a transient reader I/O error, a real SIGTERM
    # preemption, a forced-nonfinite step, placed inside epochs 0 and 1
    # so every recovery path runs before the final checkpoint
    mid = max(2, args.steps // 2)
    return [
        ("supervisor/step", "preempt", mid, 1),
        ("supervisor/step", "nonfinite", mid + 2, 1),
        ("reader/pump", "io_error", args.steps + 2, 1),
    ]


def _supervised_run(args, chaos, ckpt_dir):
    """One full training run; returns (summary, losses by step, final
    parameters, fired fault counts)."""
    from paddle_tpu_torch.reader import host_prefetch
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.resilience.supervisor import TrainingSupervisor

    _fresh_workspace()
    sgd = _build_mnist_mlp(args.use_gpu)
    batches = _make_batches(args)

    def reader():
        for b in batches:
            yield b

    if chaos:
        faults.enable(seed=args.seed)
        specs = (_parse_fault_specs(args.faults) if args.faults
                 else _default_fault_specs(args))
        for point, kind, after, times in specs:
            faults.inject(point, kind, after=after, times=times)
    try:
        sup = TrainingSupervisor(
            ckpt_dir, program=sgd._main_program,
            steps_per_checkpoint=args.ckpt_every,
            max_restarts=args.max_restarts,
            place=cli_place(args.use_gpu))
        losses = {}
        summary = sup.run(
            sgd.step_runner(feeding={"img": 0, "label": 1}),
            host_prefetch(reader, depth=2), num_epochs=args.epochs,
            on_step=lambda step, loss: losses.__setitem__(step, loss))
        fired = faults.fired_counts()
    finally:
        faults.disable()
    return summary, losses, _final_params(sgd), fired


def _warm_cache_resume_leg(args, workdir):
    """A supervised run preempted by a real SIGTERM with the persistent
    plan cache on, then restarted: the restart must resume, finish, and
    take every plan it needs from the cache (hits, no miss).  Returns
    (summary, the restart's plan hits, its captures)."""
    from paddle_tpu_torch.compile import pcache
    from paddle_tpu_torch.obs import telemetry as obs_tele
    from paddle_tpu_torch.reader import host_prefetch
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.resilience.supervisor import (Preempted,
                                                        TrainingSupervisor)
    from paddle_tpu_torch.utils import flags

    ckpt_dir = os.path.join(workdir, "warm")
    flags.set_flag("compile_cache_dir", os.path.join(workdir, "pcache"))
    pcache.reset()
    batches = _make_batches(args)

    def reader():
        for b in batches:
            yield b

    def supervise(sgd, **kw):
        return TrainingSupervisor(
            ckpt_dir, program=sgd._main_program,
            steps_per_checkpoint=args.ckpt_every,
            max_restarts=args.max_restarts,
            place=cli_place(args.use_gpu), **kw).run(
            sgd.step_runner(feeding={"img": 0, "label": 1}),
            host_prefetch(reader, depth=2), num_epochs=args.epochs)

    try:
        # the cold run, ended by a real SIGTERM mid-epoch
        # (on_preempt="raise": the process exits on the urgent
        # checkpoint and is rescheduled)
        _fresh_workspace()
        faults.enable(seed=args.seed)
        faults.inject("supervisor/step", "preempt",
                      after=max(2, args.steps // 2), times=1)
        try:
            supervise(_build_mnist_mlp(args.use_gpu), on_preempt="raise")
        except Preempted:
            pass
        else:
            raise SystemExit("chaos selftest: the preemption fault never "
                             "fired")
        finally:
            faults.disable()
        # the restart: only the checkpoints and the cache survive
        _fresh_workspace()
        pcache.reset()
        sgd = _build_mnist_mlp(args.use_gpu)
        snap = obs_tele.snapshot()
        summary = supervise(sgd)
        delta = obs_tele.snapshot_delta(snap)
        hits = delta.get("compile_cache_hits_total", 0)
        misses = delta.get("compile_cache_misses_total", 0)
        if not hits or misses:
            raise SystemExit("chaos selftest: the restart planned %d "
                             "program(s) anew and loaded %d from the "
                             "persistent cache" % (misses, hits))
        return summary, hits, delta.get("executor_jit_traces_total", 0)
    finally:
        flags.set_flag("compile_cache_dir", "")
        pcache.reset()


def selftest(args):
    import numpy as np

    from paddle_tpu_torch.obs import telemetry as obs_tele

    workdir = tempfile.mkdtemp(prefix="paddle_chaos_")
    clean_sum, clean_loss, clean_params, _ = _supervised_run(
        args, chaos=False, ckpt_dir=os.path.join(workdir, "clean"))
    chaos_sum, chaos_loss, chaos_params, fired = _supervised_run(
        args, chaos=True, ckpt_dir=os.path.join(workdir, "chaos"))

    # every planned fault fired (a chaos run that injects nothing
    # certifies nothing)
    for point, kind, _, times in _default_fault_specs(args) \
            if not args.faults else _parse_fault_specs(args.faults):
        if fired.get((point, kind), 0) < 1:
            raise SystemExit("chaos selftest: fault %s:%s never fired: %s"
                             % (point, kind, fired))

    # the registry agrees: injections counted, restarts counted
    snap = obs_tele.snapshot()
    injected = sum(v for k, v in snap.items()
                   if k.startswith("faults_injected_total{"))
    restarts = sum(v for k, v in snap.items()
                   if k.startswith("supervisor_restarts_total"))
    if injected < 3:
        raise SystemExit("chaos selftest: faults_injected_total says %d "
                         "(<3):\n%s" % (injected, snap))
    if restarts < 2 or chaos_sum["restarts"] < 2:
        raise SystemExit("chaos selftest: expected >=2 supervisor "
                         "restarts, got %s / registry %s"
                         % (chaos_sum, restarts))

    # the supervised chaos run rebuilt the exact trajectory
    if clean_sum["steps"] != chaos_sum["steps"] \
            or sorted(clean_loss) != sorted(chaos_loss):
        raise SystemExit("chaos selftest: steps differ: %s vs %s"
                         % (clean_sum, chaos_sum))
    for step in clean_loss:
        if clean_loss[step] != chaos_loss[step]:
            raise SystemExit("chaos selftest: loss diverged at step %d: "
                             "%.9g vs %.9g"
                             % (step, clean_loss[step], chaos_loss[step]))
    # the two builds name their vars alike (fresh programs); compare in
    # sorted order all the same: same architecture, same count
    ka, kb = sorted(clean_params), sorted(chaos_params)
    if len(ka) != len(kb):
        raise SystemExit("chaos selftest: %s vs %s" % (ka, kb))
    for a, b in zip(ka, kb):
        if not np.array_equal(clean_params[a], chaos_params[b]):
            raise SystemExit("chaos selftest: final params diverged: %s "
                             "vs %s" % (a, b))

    # the warm-cache resume: a preempted run restarted from disk takes
    # its plans from the persistent cache
    warm_sum, warm_hits, warm_captures = _warm_cache_resume_leg(args,
                                                                workdir)
    if warm_sum["steps"] != clean_sum["steps"]:
        raise SystemExit("chaos selftest: the warm restart ran %s, the "
                         "clean run %s" % (warm_sum, clean_sum))

    print("[chaos] selftest green: %d faults fired %s, %d supervisor "
          "restart(s), final params and %d-step loss trajectory "
          "IDENTICAL to the fault-free run; post-SIGTERM warm-cache "
          "restart resumed with %d plan hit(s), no plan made anew, and "
          "%d capture(s) of its own (ckpts under %s)"
          % (injected,
             sorted("%s:%s=%d" % (p, k, n)
                    for (p, k), n in fired.items()),
             chaos_sum["restarts"], len(clean_loss), warm_hits,
             warm_captures, workdir),
          flush=True)
    return 0


def main(argv=None):
    args = parse_args(argv)
    if args.selftest:
        return selftest(args)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="paddle_chaos_")
    summary, losses, _, fired = _supervised_run(
        args, chaos=True, ckpt_dir=ckpt_dir)
    print("[chaos] run complete: %s; faults fired: %s; final loss "
          "%.6g; checkpoints under %s"
          % (summary,
             sorted("%s:%s=%d" % (p, k, n)
                    for (p, k), n in fired.items()) or "none",
             losses[max(losses)] if losses else float("nan"),
             ckpt_dir), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
