"""The rank-side cases of the sharded-checkpoint tests.

Each function here runs in every gloo rank that `torch_ranks.run_cases`
spawns, as `fn(rank, *args)`, and returns plain data (rank 0's comes
back to the test).  This module imports the port only, never jax: the
tests write and read the JAX package's snapshots in their own process
and pass initial states in as numpy arrays.  The trainer is
`torch_spmd_cases.trainer` over the probe MLP with ZeRO-1 on a CPU mesh
of the world's 4 ranks ({"dp": 4, "mp": 1}, the JAX `make_mesh(
n_devices=4)`).
"""

import json
import os
import signal
import time

import numpy as np
import torch.distributed as dist

from paddle_tpu_torch import spmd
from paddle_tpu_torch.parallel import make_mesh
from paddle_tpu_torch.spmd import SpmdTrainer
from paddle_tpu_torch.spmd.checkpoint import HOST_MANIFEST, SPMD_MANIFEST

from torch_parallel_cases import build_mlp, mlp_feeds
from torch_spmd_cases import trainer


def _full(tr):
    return {n: tr.fetch_state(n) for n in sorted(tr.state)}


def _steps(tr, first, n):
    return [float(tr.step(mlp_feeds(i))[0].reshape(-1)[0])
            for i in range(first, first + n)]


def _manifests(snap):
    """The global manifest and the host manifests of a snapshot."""
    with open(os.path.join(snap, SPMD_MANIFEST)) as f:
        man = json.load(f)
    hosts = {}
    for h in man["hosts"]:
        with open(os.path.join(snap, h, HOST_MANIFEST)) as f:
            hosts[h] = json.load(f)
    return man, hosts


def restore_jax_snapshot(rank, root):
    """A fresh ZeRO-1 trainer at dp 4 restores the JAX package's
    snapshot under `root`: (info, the full state)."""
    tr = trainer({}, None, 0, zero_stage=1)
    info = tr.restore_checkpoint(root)
    return info, _full(tr)


def save_for_jax(rank, root, init, steps):
    """`steps` steps from `init` at dp 4, then a snapshot under `root`
    for the JAX package to restore: (snapshot, losses, full state, the
    global manifest, the host manifests)."""
    tr = trainer({}, init, 0, zero_stage=1)
    losses = _steps(tr, 0, steps)
    snap = tr.save_checkpoint(root, steps)
    state = _full(tr)
    man, hosts = _manifests(snap)
    return snap, losses, state, man, hosts


def resume_and_supervise(rank, root, sup_root, init, rules):
    """tests/test_spmd.py's checkpoint cases at dp 4: 2 steps, a save, a
    fresh trainer restored from it, 2 more steps on it, against 4
    uninterrupted steps; then `attach_supervisor` over a rules-driven
    trainer and a relaunched one resuming through the saver protocol."""
    tr = trainer({}, init, 0, zero_stage=1)
    first = _steps(tr, 0, 2)
    saved = _full(tr)
    tr.save_checkpoint(root, step=2)
    fresh = trainer({}, None, 0, zero_stage=1)
    info = fresh.restore_checkpoint(root)
    restored = _full(fresh)
    resumed = first + _steps(fresh, 2, 2)
    ref = trainer({}, init, 0, zero_stage=1)
    straight = _steps(ref, 0, 4)
    out = {"info": info, "manifest": _manifests(info["snap"])[0],
           "saved": saved, "restored": restored, "resumed": resumed,
           "resumed_state": _full(fresh), "straight": straight,
           "straight_state": _full(ref)}

    sup_tr = trainer({}, init, 0, zero_stage=1, rules=rules)
    _steps(sup_tr, 0, 3)
    sup = spmd.attach_supervisor(sup_tr, sup_root, interval_secs=0.0)
    sup._saver.save(3)
    sup._saver.wait()
    relaunched = trainer({}, None, 0, zero_stage=1, rules=rules)
    sup2 = spmd.attach_supervisor(relaunched, sup_root,
                                  interval_secs=0.0)
    out["sup_latest"] = sup2._latest_snapshot()
    out["sup_step"] = sup2._restore_latest()
    out["sup_spec"] = list(relaunched.plan.var_specs["fc_1.w_0"])
    out["sup_state"] = _full(sup_tr)
    out["sup_restored"] = _full(relaunched)
    return out


def densify_4_to_2(rank, root, init):
    """A dp 4 snapshot restored onto a dp 2 mesh over ranks 0 and 1 (the
    elastic shrink's path): (info, dp 4 state, dp 2 state on the ranks of
    the dp 2 mesh, the blob of `measure_densify_restore` from 4 shards
    to 2)."""
    tr = trainer({}, init, 0, zero_stage=1)
    _steps(tr, 0, 2)
    tr.save_checkpoint(root, step=2)
    full4 = _full(tr)
    mesh2 = make_mesh(n_devices=2, dp=2, devices=[0, 1], device="cpu")
    main, startup, avg = build_mlp()
    tr2 = SpmdTrainer(main, startup, ["x", "label"], [avg.name], mesh2,
                      zero_stage=1, use_pcache=False).init()
    info = tr2.restore_checkpoint(root)
    full2 = _full(tr2) if rank < 2 else None
    blob = spmd.measure_densify_restore(
        os.path.join(root, "bench"), from_dp=4, to_dp=2, n_vars=2,
        rows=512, cols=64)
    return info, full4, full2, blob


def bench_leg(rank, history):
    """`spmd.bench.run_leg` at dp 4 (lenet5, batch 16): the record and
    the history lines rank 0 appended."""
    from paddle_tpu_torch.obs import perf as obs_perf
    from paddle_tpu_torch.spmd import bench

    rec = bench.run_leg(model="lenet5", mesh_spec="dp=4", batch=16,
                        iters=2, warmup=1, history=history, device="cpu")
    lines = obs_perf.load_history(history) if rank == 0 else None
    return rec, lines


def straight_run(rank, init, n_steps):
    """`n_steps` steps of the trainer from `init`, unsupervised: (the
    losses, the final state)."""
    tr = trainer({}, init, 0, zero_stage=1)
    return _steps(tr, 0, n_steps), _full(tr)


def _supervised(rank, root, init, n_steps, after_step, reader=None,
                **sup_kw):
    """`attach_supervisor(...).run` over `n_steps` batches from `init`
    (`reader`, default `range(n_steps)`), `after_step(rank, i)` called
    after each step of batch i: (every rank's snapshots as [(step,
    kind), ...], gathered; the run's summary; each step's loss, the
    last run of a step replayed after a restore; the final state)."""
    tr = trainer({}, init, 0, zero_stage=1)
    sup = spmd.attach_supervisor(tr, root, max_to_keep=0, **sup_kw)
    made, losses = [], {}
    checkpoint = sup._checkpoint

    def recorded(kind):
        made.append((sup._step, kind))
        return checkpoint(kind)

    sup._checkpoint = recorded

    def step(i):
        loss = float(tr.step(mlp_feeds(i))[0].reshape(-1)[0])
        after_step(rank, i)
        return loss

    summary = sup.run(step, reader or (lambda: iter(range(n_steps))),
                      on_step=losses.__setitem__)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, made)
    return everyone, summary, [losses[s] for s in sorted(losses)], \
        _full(tr)


def _rank0_lags(rank, i):
    if rank == 0:
        time.sleep(0.3)


def supervised_clock_skew(rank, root, init, n_steps):
    """A supervised run whose wall-clock interval (1 s) comes due on
    rank 0 a step before the others: rank 0 reaches every step
    boundary 0.3 s after them, so each rank's own clock would save at
    another step."""
    return _supervised(rank, root, init, n_steps, _rank0_lags,
                       interval_secs=1.0)


def _sigterm_rank2(rank, i):
    if rank == 2 and i == 3:
        os.kill(os.getpid(), signal.SIGTERM)


def supervised_sigterm(rank, root, init, n_steps):
    """A supervised run in which rank 2 alone gets SIGTERM during the
    step of batch 3 (the preemption notice of one host): every rank must
    take the urgent snapshot at step 4, resume from it and finish."""
    return _supervised(rank, root, init, n_steps, _sigterm_rank2,
                       interval_secs=3600.0)


def _no_lag(rank, i):
    pass


def supervised_step_fault(rank, root, init, n_steps, kind, fault_rank,
                          at):
    """A supervised run (a snapshot every 2 steps) in which the
    `supervisor/step` fault point fires `kind` ("io_error" or
    "nonfinite") on `fault_rank` alone, at step `at`: every rank must
    restore the same snapshot and replay from it."""
    from paddle_tpu_torch.resilience import faults

    if rank == fault_rank:
        faults.enable(seed=0)
        faults.inject("supervisor/step", kind, after=at, times=1)
    try:
        return _supervised(rank, root, init, n_steps, _no_lag,
                           interval_secs=3600.0, steps_per_checkpoint=2)
    finally:
        faults.disable()


def supervised_reader_fault(rank, root, init, n_steps, fault_rank, at):
    """A supervised run (a snapshot every 2 steps) whose reader raises an
    IOError on `fault_rank` alone, once, in place of batch `at`."""
    failed = []

    def reader():
        for i in range(n_steps):
            if rank == fault_rank and i == at and not failed:
                failed.append(i)
                raise IOError("reader fault on rank %d" % rank)
            yield i

    return _supervised(rank, root, init, n_steps, _no_lag, reader=reader,
                       interval_secs=3600.0, steps_per_checkpoint=2)
