"""Pipeline parallelism: GPipe-style microbatch streaming over a "pp"
mesh axis.

Counterpart of paddle_tpu/parallel/pipeline.py.  Every rank runs the
same schedule (`gpipe_spmd`, through `sharding.shard_map_norep`); stage
parameters are stacked on a leading axis sharded over "pp" (rank i
holds stage i), and microbatch activations hop from stage to stage with
`collectives.ppermute`.  The schedule is a loop of M + S - 1 ticks;
autograd differentiates straight through it, and the hop's gradient,
the reverse permutation, is the backward pipeline.

Composes with the other axes: batch ("dp") sharding applies to the
microbatch dimension.  `remat=True` recomputes each stage in the
backward (`torch.utils.checkpoint`).
"""

import functools

import torch
import torch.utils._pytree as pytree
import torch.utils.checkpoint

from ..obs import trace as obs_trace
from ..ops.registry import span
from . import collectives as C
from .mesh import mesh_shape
from .sharding import P, shard_map_norep

__all__ = ["gpipe_spmd", "pipeline_apply", "split_microbatches",
           "stack_stage_params", "pipeline_schedule_info"]


def pipeline_schedule_info(mesh, n_microbatches, axis_name="pp",
                           batch_size=None):
    """Static introspection of a GPipe schedule over `mesh` (or any
    axis->size mapping): stage count, tick count, bubble fraction."""
    shape = dict(mesh_shape(mesh))
    s = int(shape.get(axis_name, 0))
    m = int(n_microbatches)
    info = {"axis": axis_name, "stages": s, "microbatches": m,
            "ticks": (m + s - 1) if s else None,
            "bubble_fraction": (float(s - 1) / (m + s - 1)
                                if s and (m + s - 1) else None)}
    if batch_size is not None:
        info["microbatch_size"] = (batch_size // m
                                   if m and batch_size % m == 0
                                   else None)
    return info


def split_microbatches(x, n_microbatches):
    """[B, ...] -> [M, B/M, ...] microbatch stream."""
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError("batch %d not divisible into %d microbatches"
                         % (b, n_microbatches))
    return x.reshape((n_microbatches, b // n_microbatches)
                     + tuple(x.shape[1:]))


def stack_stage_params(per_stage_params):
    """List of S stage param dicts of one structure -> one dict whose
    tensors have a leading stage axis [S, ...] (shard it over "pp")."""
    leaves, spec = zip(*(pytree.tree_flatten(p) for p in per_stage_params))
    return pytree.tree_unflatten([torch.stack(ts) for ts in zip(*leaves)],
                                 spec[0])


def gpipe_spmd(stage_fn, stacked_params, x_mb, axis_name="pp"):
    """The per-rank pipeline schedule; call inside shard_map_norep.

    stage_fn(params, x) -> y must preserve the activation shape.
    stacked_params: tensors [1, ...] locally (the "pp"-sharded stage
    axis); x_mb: [M, mb, ...] microbatches (the same on every pp rank).
    Returns [M, mb, ...] last-stage outputs, the same on every pp rank.
    """
    s = C.axis_size(axis_name)
    idx = C.axis_index(axis_name)
    local = pytree.tree_map(lambda p: p[0], stacked_params)
    m = x_mb.shape[0]
    fwd = [(i, i + 1) for i in range(s - 1)]

    # every rank runs the same ops, the rank's role chosen by `where`
    # as on the JAX side: autograd runs only the backward of what the
    # loss reaches, so a hop's backward (the grad arriving from the next
    # stage) runs on every rank, in the same order, only when every
    # rank's outputs depend on every hop
    def flag(b):
        return torch.tensor(bool(b), device=x_mb.device)

    first, last = flag(idx == 0), flag(idx == s - 1)
    state = torch.zeros_like(x_mb[0])
    outs = [torch.zeros_like(x_mb[0]) for _ in range(m)]
    for t in range(m + s - 1):
        # stage 0 ingests microbatch t (clamped; invalid ticks never
        # reach `outs`), later stages eat what the predecessor sent
        cur = torch.where(first, x_mb[min(t, m - 1)], state)
        with span("pp_stage"):
            y = stage_fn(local, cur)
        # the last stage finishes microbatch t - (s - 1) at tick t
        if t >= s - 1:
            o = t - (s - 1)
            outs[o] = torch.where(last, y, outs[o])
        if t < m + s - 2:
            state = C.ppermute(y, axis_name, fwd)
    # only the last rank holds real outputs; sum over pp so the loss
    # runs the same on every pp rank
    out = torch.stack(outs)
    return C.psum(torch.where(last, out, torch.zeros_like(out)),
                  axis_name)


def _checkpointed(stage_fn):
    def fn(params, x):
        keys = sorted(params)
        return torch.utils.checkpoint.checkpoint(
            lambda x, *vals: stage_fn(dict(zip(keys, vals)), x), x,
            *[params[k] for k in keys], use_reentrant=False)

    return fn


def pipeline_apply(mesh, stage_fn, stacked_params, x, n_microbatches,
                   axis_name="pp", batch_axis="dp", remat=False):
    """Run `x` through the pipelined stack of stages over `mesh`.

    stacked_params: a dict of tensors (DTensors on `mesh`, or plain
    tensors holding the same value on every rank) with a leading stage
    axis [S, ...]; S must equal the mesh's `axis_name` size.  x: the
    [B, ...] global batch; with a "dp" axis in the mesh the microbatch
    dimension is dp-sharded too.  Returns the [B, ...] outputs of the
    final stage, a DTensor on `mesh`.  With FLAGS_verify_sharding on,
    the schedule's layout is checked first (`analysis.check_pipeline`),
    and an S0xx error raises ProgramVerificationError."""
    from ..utils import flags as _flags

    if _flags.get_flag("verify_sharding"):
        from ..analysis import shard as _shard

        _shard.check_pipeline(
            mesh, n_stages=pytree.tree_leaves(stacked_params)[0].shape[0],
            n_microbatches=n_microbatches, axis_name=axis_name,
            batch_size=int(x.shape[0])).raise_on_error()
    axes = mesh_shape(mesh)
    s = axes[axis_name]
    n_stages = pytree.tree_leaves(stacked_params)[0].shape[0]
    if n_stages != s:
        raise ValueError("stacked_params has %d stages but mesh axis "
                         "%r has size %d" % (n_stages, axis_name, s))
    fn = _checkpointed(stage_fn) if remat else stage_fn
    db = batch_axis if batch_axis in axes else None
    x_spec = P(None, db)  # [M, mb, ...]: microbatch dim dp-sharded

    mapped = shard_map_norep(
        functools.partial(gpipe_spmd, fn, axis_name=axis_name),
        mesh, in_specs=(P(axis_name), x_spec), out_specs=x_spec)

    with obs_trace.span("parallel/pipeline_apply", cat="parallel",
                        stages=int(s), microbatches=int(n_microbatches)):
        x_mb = split_microbatches(x, n_microbatches)
        out_mb = mapped(stacked_params, x_mb)
    return out_mb.reshape((-1,) + tuple(out_mb.shape[2:]))
