"""Explicit data-parallel step with bucketed ring-allreduce gradients.

Counterpart of paddle_tpu/spmd/overlap.py.  The mesh path
(`parallel.make_parallel_step`) runs every op on DTensors, whose
sharding rules place the collectives: the reduction of each gradient
happens where DTensor meets it.  This module builds the classic DDP
schedule instead: forward and backward run on each rank's local batch
shard inside `shard_map_norep`, the gradients ring-reduce in BUCKETS
(last-produced grads first), and the optimizer segment applies the
reduced means identically on every rank.  Each bucket is one
`ring.ring_allreduce` chain over the mesh's dp process group.

`_split_point` is the reduction seam: every gradient the optimizer
consumes exists there, and no parameter has been updated yet.  The
grads come out of the backward in reverse production order, and that is
where an eager executor could start a bucket's ring while the backward
still computes the next bucket's members.  This port does not yet: it
runs the buckets in order at the seam, after the backward, so nothing
overlaps (`obs.comm.overlap_report` measures exactly that).  The JAX
step leaves the overlap to XLA's scheduler inside one jit.

Semantics: the per-rank loss is the LOCAL batch mean; with equal shards
the mean of local means equals the global mean, and dividing the
ring-summed gradients by dp yields the mesh path's gradients.  The mode
is restricted to layouts where that equivalence is exact: a pure-dp
mesh, replicated parameters (no zero1), and no train-mode batch_norm
(its cross-batch statistics would silently become per-shard
statistics).  `overlap_supported` is the gate, its reasons the JAX
module's word for word; `SpmdTrainer` falls back to the mesh path when
it says no.

The step is captured as the mesh step is (parallel/captured.py): the
block runs on each rank's local tensors through the executor's captured
segments, the bucketed reduction as a seam before the first optimizer
op (inside the capture), and with donation each rank's replicated state
is updated in its own storage.  `capture=False` runs the block op by op
inside `shard_map_norep`: the reference the captured step is held to,
bit for bit.
"""

import torch

from ..fluid.executor import ExecContext, _local, apply_op, prepare_feed
from ..jit import FunctionalProgram
from ..obs import trace as obs_trace
from ..ops.registry import span
from ..parallel import collectives as C
from ..parallel import sharding as psharding
from ..parallel.captured import ProgramStep
from ..parallel.mesh import mesh_shape
from ..parallel.ring import bucketed_allreduce
from ..parallel.trainer import place_of

__all__ = ["make_overlapped_dp_step", "overlap_supported",
           "DEFAULT_BUCKET_BYTES"]

# 4 MiB buckets: large enough to amortize ring latency per hop, small
# enough that several buckets exist to overlap (the DDP default class)
DEFAULT_BUCKET_BYTES = 4 << 20


def _split_point(ops):
    """(first optimizer-op index, grad names in production order).

    The split is where every gradient the optimizer consumes exists
    but no parameter has been updated yet — the reduction seam."""
    split = None
    grads = set()
    for i, od in enumerate(ops):
        if od.type in psharding._OPTIMIZER_OPS:
            if split is None:
                split = i
            grads.update(n for n in od.input("Grad") if n)
    if split is None:
        return None, []
    order = []
    seen = set()
    for od in ops[:split]:
        for n in od.output_names():
            if n in grads and n not in seen:
                seen.add(n)
                order.append(n)
    return split, order


def overlap_supported(program, mesh, dp_axis="dp", zero_stage=0):
    """(ok, reason) — whether the explicit bucketed dp schedule is
    exactly equivalent to the mesh path's step for this program/mesh
    (a DeviceMesh, a MeshConfig or an {axis: size} mapping)."""
    axes = dict(mesh_shape(mesh))
    if int(axes.get(dp_axis, 1)) <= 1:
        return False, "mesh has no %s axis wider than 1" % dp_axis
    others = [a for a, s in axes.items()
              if a != dp_axis and int(s) > 1]
    if others:
        return False, ("mesh is not pure data-parallel (axes %s also "
                       "shard)" % ",".join(sorted(others)))
    if zero_stage >= 1:
        return False, ("zero%d shards optimizer state over dp — the "
                       "GSPMD reduce-scatter path owns that layout"
                       % zero_stage)
    ops = list(getattr(program, "desc", program).block(0).ops)
    split, grad_order = _split_point(ops)
    if split is None:
        return False, "program has no optimizer op (no reduction seam)"
    if not grad_order:
        return False, "optimizer ops consume no gradients"
    for od in ops[:split]:
        if od.type == "batch_norm" and not od.attr("is_test", False):
            return False, ("train-mode batch_norm computes cross-batch "
                           "statistics; per-shard execution would "
                           "change them")
    return True, None


def make_overlapped_dp_step(program, feed_names, fetch_names, mesh,
                            state_template, dp_axis="dp",
                            bucket_bytes=DEFAULT_BUCKET_BYTES,
                            donate_state=None, feed_specs=None,
                            skip_reduce=False, capture=True):
    """The program as the explicit bucketed dp step.

    Returns (step, state_shardings) with the `make_parallel_step`
    contract: step(state, feeds, rng) -> (fetches, new_state), the
    state replicated DTensors (pure dp), the feeds (arrays or tensors,
    the global batch) sharded on their batch dim, rng a torch.Generator
    on the mesh's device (or None), scalar fetches returned as the
    cross-shard mean (== the global-batch value), every fetch a full
    tensor.  Every rank runs the same call.  Callers gate on
    `overlap_supported` first.

    With capture (the default) the step is captured (`step.captured` is
    its `ProgramStep`), and with donate_state (None:
    `analysis.alias.state_donation()`) each rank's state is updated in
    its own storage and the step returns the same DTensors; without it,
    or with capture=False, the step returns new state tensors.

    skip_reduce=True elides the bucketed ring entirely — the optimizer
    applies LOCAL gradients, so the result is numerically WRONG across
    shards.  It exists for one purpose: the compute-only twin
    `obs.comm.overlap_report` times against the real step, so
    `step_wall - compute_only_wall` isolates the EXPOSED comm time.
    """
    ok, reason = overlap_supported(program, mesh, dp_axis=dp_axis)
    if not ok:
        raise ValueError("overlapped dp step unsupported: %s" % reason)
    place = place_of(mesh)
    fp = FunctionalProgram(program, feed_names, fetch_names, place=place)
    ops = fp.ops
    split, grad_order = _split_point(ops)
    reduce_order = list(reversed(grad_order))
    feed_specs = feed_specs or {}
    block = fp.desc.block(fp.block_idx)
    names = sorted(state_template)
    n_fetch = len(fp.fetch_names)

    def reduce_seam(env):
        grads = {g: env[g] for g in grad_order if g in env}
        obs_trace.instant("comm/reduce_seam", cat="comm",
                          n_grads=len(grads),
                          bucket_bytes=int(bucket_bytes),
                          skip_reduce=bool(skip_reduce))
        if not skip_reduce:
            env.update(bucketed_allreduce(
                grads, bucket_bytes, axis_name=dp_axis, mean=True,
                order=[g for g in reduce_order if g in grads]))

    def local_step(state, feeds, rng):
        env = dict(state)
        env.update(feeds)
        ctx = ExecContext(fp.desc, fp.block_idx, env, place=fp.place,
                          device=fp.device, rng=rng)
        for i, od in enumerate(ops):
            if i == split:
                reduce_seam(env)
            with span(od.type):
                apply_op(ctx, od)
        new_state = dict(state)
        for n in fp.state_out_names:
            if n in env:
                new_state[n] = env[n]
        fetches = []
        for n in fp.fetch_names:
            v = env[n]
            # scalar losses/metrics: local-batch mean -> global mean
            if v.numel() == 1:
                v = C.pmean(v, dp_axis)
            fetches.append(v)
        return tuple(fetches) + tuple(new_state[n] for n in names)

    state_specs = {n: psharding.P() for n in names}
    state_shardings = {n: psharding.NamedSharding(mesh, psharding.P())
                       for n in names}
    out_specs = tuple(psharding.P() for _ in range(n_fetch + len(names)))

    def feed_spec(n, v):
        return feed_specs.get(n, psharding.batch_spec(
            tuple(getattr(v, "shape", ())), mesh, dp_axis))

    if not capture:
        def step(state, feeds, rng):
            local = {n: prepare_feed(block, n, feeds[n], fp.device)
                     for n in sorted(feeds)}
            sharded = psharding.shard_map_norep(
                local_step, mesh,
                in_specs=(state_specs,
                          {n: feed_spec(n, v) for n, v in local.items()},
                          psharding.P()),
                out_specs=out_specs)
            with torch.no_grad():
                outs = sharded({n: state[n] for n in names}, local, rng)
            fetches = [psharding.to_full(f) for f in outs[:n_fetch]]
            return fetches, dict(zip(names, outs[n_fetch:]))

        return step, state_shardings

    core = ProgramStep(fp, "overlap_dp_step", donate=donate_state,
                       seams={split: reduce_seam})
    replicate = psharding.placements(mesh, psharding.P())

    def step(state, feeds, rng):
        local = {}
        for n in sorted(feeds):
            v = prepare_feed(block, n, feeds[n], fp.device)
            if isinstance(v, torch.Tensor):
                v = psharding._lift(v, mesh).redistribute(
                    mesh, psharding.placements(mesh, feed_spec(n, v))) \
                    .to_local()
            local[n] = v
        local_state = {n: _local(psharding._lift(state[n], mesh))
                       for n in names}
        with torch.no_grad(), C.axis_env(mesh):
            fetches, new_local, owned = core.run(local_state, local, rng)
            out = []
            for n, v in zip(fp.fetch_names, fetches):
                if n in owned or n in local_state:
                    v = v.clone()
                # scalar losses/metrics: local-batch mean -> global mean
                out.append(C.pmean(v, dp_axis) if v.numel() == 1 else v)
        new_state = {}
        for n in names:
            v = new_local[n]
            new_state[n] = state[n] if v is local_state[n] else \
                psharding._dtensor().from_local(v, mesh, replicate,
                                                run_check=False)
        return out, new_state

    step.captured = core
    return step, state_shardings
