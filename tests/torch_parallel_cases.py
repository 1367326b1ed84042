"""The rank-side cases of the parallel package's parity tests.

Each function here runs in every gloo rank that `torch_ranks.run_cases`
spawns, as `fn(rank, *args)`, and returns numpy data (rank 0's comes
back to the test).  This module imports the port only, never jax: the
tests compute the JAX side in their own process and pass initial
states in as numpy arrays (programs are built by the port itself from
the same layer calls, whose descs equal the JAX package's).
"""

import types

import numpy as np
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.parallel import (ParallelTrainer, make_mesh,
                                       moe as tmoe, pipeline as tpipe,
                                       ring as tring)
from paddle_tpu_torch.parallel.sharding import P, distribute, to_full


def _np(t):
    return to_full(t).detach().cpu().numpy()


# -- the trainer -------------------------------------------------------------

MLP = dict(BATCH=16, DIM=8, HIDDEN=1024, CLASSES=4)


def build_mlp(fl=fluid):
    """tests/test_parallel_trainer.py's `_build_mlp` (either package's
    fluid)."""
    B, D, Hd, C = (MLP[k] for k in ("BATCH", "DIM", "HIDDEN", "CLASSES"))
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[B, D], dtype="float32",
                           append_batch_size=False)
        label = fl.layers.data(name="label", shape=[B, 1], dtype="int64",
                               append_batch_size=False)
        h = fl.layers.fc(input=x, size=Hd, act="relu")
        logits = fl.layers.fc(input=h, size=C, act=None)
        loss = fl.layers.softmax_with_cross_entropy(logits, label)
        avg = fl.layers.mean(loss)
        fl.optimizer.MomentumOptimizer(
            learning_rate=0.1, momentum=0.9).minimize(avg)
    return main, startup, avg


def mlp_feeds(step):
    rs = np.random.RandomState(100 + step)
    return {"x": rs.rand(MLP["BATCH"], MLP["DIM"]).astype(np.float32),
            "label": rs.randint(0, MLP["CLASSES"],
                                size=(MLP["BATCH"], 1)).astype(np.int64)}


def build_conv_bn(fl=fluid):
    """A small conv + batch_norm classifier: its step's statistics are
    the whole batch's only under global semantics."""
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        img = fl.layers.data(name="img", shape=[8, 3, 8, 8],
                             dtype="float32", append_batch_size=False)
        label = fl.layers.data(name="label", shape=[8, 1], dtype="int64",
                               append_batch_size=False)
        c = fl.layers.conv2d(img, num_filters=4, filter_size=3, padding=1)
        b = fl.layers.batch_norm(c, act="relu")
        logits = fl.layers.fc(input=b, size=5)
        avg = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits,
                                                                  label))
        fl.optimizer.MomentumOptimizer(learning_rate=0.1,
                                       momentum=0.9).minimize(avg)
    return main, startup, avg


def conv_bn_feeds(step):
    rs = np.random.RandomState(200 + step)
    # channel means far from 0: per-shard statistics would differ
    img = rs.randn(8, 3, 8, 8).astype(np.float32)
    img += np.arange(8, dtype=np.float32)[:, None, None, None]
    return {"img": img,
            "label": rs.randint(0, 5, size=(8, 1)).astype(np.int64)}


def _mesh(kw):
    return make_mesh(device="cpu", **kw)


def train(rank, build, feeds_fn, feed_names, mesh_kw, init, steps,
          zero_stage=0, feed_specs=None, build_args=()):
    """ParallelTrainer on the mesh of `mesh_kw` from the state `init`
    ({name: array}, None for the port's own startup): (losses, final
    state, each state tensor's placements)."""
    main, startup, loss = build(*build_args)
    loss_name = loss if isinstance(loss, str) else loss.name
    tr = ParallelTrainer(main, startup, feed_names, [loss_name],
                         _mesh(mesh_kw), zero_stage=zero_stage,
                         feed_specs=feed_specs).init()
    if init is not None:
        scope = fluid.Scope()
        tio.params_from_numpy(scope, init, "cpu")
        tr.load_state_from(scope)
    losses = [float(tr.step(feeds_fn(i))[0].reshape(-1)[0])
              for i in range(steps)]
    state = {n: tr.fetch_state(n) for n in sorted(tr.state)}
    placements = {n: [repr(p) for p in tr.state[n].placements]
                  for n in sorted(tr.state)}
    return losses, state, placements


def _local_ptr(v):
    return (v.to_local() if hasattr(v, "to_local") else v).data_ptr()


def capture_pair(rank, build, feeds_fn, feed_names, mesh_kw, init, steps,
                 zero_stage=0):
    """ParallelTrainer from `init` on the mesh of `mesh_kw`: captured,
    uncaptured, and captured under FLAGS_donation=off.  {tag: (losses,
    final state, the state names whose local storage moved, (captures,
    replays) or None)}."""
    from paddle_tpu_torch.utils import flags

    out = {}
    for tag in ("captured", "uncaptured", "off"):
        prev = flags.get_flag("donation")
        if tag == "off":
            flags.set_flag("donation", "off")
        try:
            main, startup, loss = build()
            tr = ParallelTrainer(main, startup, feed_names, [loss.name],
                                 _mesh(mesh_kw), zero_stage=zero_stage,
                                 capture=tag != "uncaptured").init()
            scope = fluid.Scope()
            tio.params_from_numpy(scope, init, "cpu")
            tr.load_state_from(scope)
            ptrs = {n: _local_ptr(v) for n, v in tr.state.items()}
            losses = [float(tr.step(feeds_fn(i))[0].reshape(-1)[0])
                      for i in range(steps)]
            moved = sorted(n for n, v in tr.state.items()
                           if _local_ptr(v) != ptrs[n])
            state = {n: tr.fetch_state(n) for n in sorted(tr.state)}
            core = tr.captured
            out[tag] = (losses, state, moved, core and (core.captures,
                                                        core.replays))
        finally:
            flags.set_flag("donation", prev)
    return out


def build_transformer(sp_axis, sp_mode, B=4, T=16, V=64):
    """tests/test_flash_attention_op.py's `_train_transformer` program:
    (main, startup, loss name)."""
    from paddle_tpu_torch.models.transformer_program import \
        build_transformer_program

    main, startup, loss, _ = build_transformer_program(
        B, T, V, n_layer=1, n_head=4, d_model=32, sp_axis=sp_axis,
        sp_mode=sp_mode)
    fluid.MomentumOptimizer(0.05, 0.9).minimize(loss, main, startup)
    return main, startup, loss


def transformer_feeds_at(step, B=4, T=16, V=64):
    """The program's feeds at every step (the JAX test feeds one batch
    again and again)."""
    from paddle_tpu_torch.models.transformer_program import \
        transformer_feeds as feeds

    return feeds(B, T, V, seed=1, targets=True)


def place_count(rank, mesh_kw):
    """The get_places op's output under the mesh of `mesh_kw`."""
    from paddle_tpu_torch.parallel.mesh import mesh_scope

    mesh = _mesh(mesh_kw)
    main, startup = fluid.Program(), fluid.Program()
    with mesh_scope(mesh):
        with fluid.program_guard(main, startup):
            places = fluid.layers.get_places()
        out, = fluid.Executor(fluid.CPUPlace()).run(
            main, fetch_list=[places])
    return out


# -- ring and Ulysses --------------------------------------------------------

def qkv(B=2, H=4, T=64, D=16, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, H, T, D).astype(np.float32) for _ in range(3)]


def sp_attention(rank, impl, causal, mesh_kw):
    """ring or ulysses attention over the mesh's sp axis: the output,
    and the grads of sum(sin(out)) for q, k, v."""
    mesh = _mesh(mesh_kw)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in qkv())
    if impl == "ring":
        fn = tring.sp_shard_map(lambda q, k, v: tring.ring_attention(
            q, k, v, "sp", None, causal), mesh)
    else:
        fn = tring.sp_shard_map(lambda q, k, v: tring.ulysses_attention(
            q, k, v, "sp", None, causal), mesh)
    out = fn(q, k, v).full_tensor()
    torch.sin(out).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (q, k, v)]


def ring_allreduce_case(rank, mean):
    """ring_allreduce over dp=4 of each rank's row of a [4, 37] array."""
    from paddle_tpu_torch.parallel.sharding import shard_map_norep

    mesh = _mesh({"axes": ("dp",)})
    x = torch.from_numpy(np.random.RandomState(3).randn(4, 37)
                         .astype(np.float32))
    fn = shard_map_norep(lambda x: tring.ring_allreduce(x, "dp", mean),
                         mesh, in_specs=(P("dp"),), out_specs=P("dp"))
    return _np(fn(x))


def _transformer_params(arrays, meta):
    from paddle_tpu_torch.models.transformer import \
        transformer_params_from_numpy

    return transformer_params_from_numpy(
        dict(arrays, _meta=types.SimpleNamespace(
            n_layer=meta[0], n_head=meta[1], d_model=meta[2])), "cpu")


def transformer_forwards(rank, arrays, meta, tokens, mesh_kw):
    """models/transformer.py's forwards from the same params: dense and
    flash without a mesh, ring and Ulysses over the mesh."""
    from paddle_tpu_torch.models.transformer import transformer_forward

    params = _transformer_params(arrays, meta)
    tok = torch.from_numpy(tokens)
    mesh = _mesh(mesh_kw)
    out = {impl: _np(transformer_forward(params, tok, attn_impl=impl))
           for impl in ("dense", "flash")}
    for impl in ("ring", "ulysses"):
        out[impl] = _np(transformer_forward(params, tok, attn_impl=impl,
                                            mesh=mesh))
    return out


def transformer_sgd(rank, arrays, meta, tokens, targets, mesh_kw, steps):
    """Sharded SGD steps (lr 0.1) of transformer_loss with ring attention,
    the params laid out by transformer_param_specs: the losses, and
    whether each param's layout is its spec's."""
    from paddle_tpu_torch.models.transformer import (
        transformer_loss, transformer_param_specs)

    mesh = _mesh(mesh_kw)
    params = _transformer_params(arrays, meta)
    meta_v = params.pop("_meta")
    specs = transformer_param_specs(params)
    sharded = {n: distribute(v, mesh, specs[n]) for n, v in
               sorted(params.items())}
    tok, tgt = torch.from_numpy(tokens), torch.from_numpy(targets)
    losses = []
    for _ in range(steps):
        leaves = {n: v.detach().requires_grad_(True)
                  for n, v in sharded.items()}
        loss = transformer_loss(dict(leaves, _meta=meta_v), tok, tgt,
                                attn_impl="ring", mesh=mesh)
        names = sorted(leaves)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        losses.append(float(to_full(loss)))
        with torch.no_grad():
            sharded = {n: distribute(leaves[n] - 0.1 * g, mesh, specs[n])
                       for n, g in zip(names, grads)}
    from paddle_tpu_torch.parallel.sharding import placements

    laid = all(list(v.placements) == placements(mesh, specs[n])
               for n, v in sharded.items())
    return losses, laid


# -- GPipe and MoE -----------------------------------------------------------

def _stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def pipeline_case(rank, stacked, x, tgt, n_microbatches, mesh_kw,
                  remat=False):
    """pipeline_apply's output and the grads of mean((out - tgt)^2) for
    the stacked stage params."""
    mesh = _mesh(mesh_kw)
    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in stacked.items()}
    out = tpipe.pipeline_apply(mesh, _stage_fn, params,
                               torch.from_numpy(x), n_microbatches,
                               remat=remat)
    loss = torch.mean((out.full_tensor() - torch.from_numpy(tgt)) ** 2)
    loss.backward()
    return (out.full_tensor().detach().numpy(), float(loss),
            {k: p.grad.numpy() for k, p in params.items()})


def moe_case(rank, params, x, mesh_kw, capacity_factor):
    """switch_moe's output and aux, and the grads of
    mean(y^2) + 0.01 aux for its params."""
    mesh = _mesh(mesh_kw)
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in params.items()}
    fn = tmoe.moe_shard_map(mesh, capacity_factor=capacity_factor)
    y, aux = fn(p, torch.from_numpy(x))
    y, aux = y.full_tensor(), aux.full_tensor()
    (torch.mean(y ** 2) + 0.01 * aux).backward()
    return (y.detach().numpy(), float(aux),
            {k: t.grad.numpy() for k, t in p.items()})


def _fc_stage(D):
    def build(i=None):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            h = fluid.layers.data(name="h", shape=[D], dtype="float32")
            out = fluid.layers.fc(input=h, size=D, act="tanh")
        return main, startup, "h", out.name

    return build


def pipeline_program_case(rank, D, stacked, x, tgt, steps):
    """PipelineProgramTrainer at pp 2 x dp 2 (Momentum 0.2, 0.9) from the
    stacked stage params `stacked`: losses, final params, velocities."""
    from paddle_tpu_torch.parallel import PipelineProgramTrainer

    mesh = _mesh({"pp": 2})
    tr = PipelineProgramTrainer(
        _fc_stage(D), mesh, n_microbatches=4,
        optimizer=fluid.optimizer.Momentum(learning_rate=0.2,
                                           momentum=0.9))
    assert sorted(tr.stacked) == sorted(stacked)
    tr.stacked = {k: distribute(torch.from_numpy(v), mesh, P("pp"))
                  for k, v in sorted(stacked.items())}
    losses = [tr.step(x, tgt) for _ in range(steps)]
    return (losses, {k: _np(v) for k, v in tr.stacked.items()},
            {k: _np(v) for k, v in
             tr.opt_state["slots"]["velocity"].items()})


def moe_program_case(rank, D, E, params, x, steps):
    """MoEProgramLayer at dp 2 x ep 2 (capacity factor E) from `params`:
    SGD (lr 0.2) on mean((y - x)^2) + 0.01 aux; losses and final
    params."""
    from paddle_tpu_torch.parallel import MoEProgramLayer

    mesh = _mesh({"ep": 2})
    layer = MoEProgramLayer(_fc_stage(D), n_experts=E, d_model=D,
                            mesh=mesh, capacity_factor=float(E))
    assert sorted(layer.params["experts"]) == sorted(params["experts"])
    p = {"gate_w": torch.from_numpy(params["gate_w"]),
         "experts": {k: torch.from_numpy(v)
                     for k, v in params["experts"].items()}}
    xt = torch.from_numpy(x)
    losses = []
    for _ in range(steps):
        leaves = {"gate_w": p["gate_w"].requires_grad_(True),
                  "experts": {k: v.requires_grad_(True)
                              for k, v in p["experts"].items()}}
        y, aux = layer(leaves, xt)
        loss = (torch.mean((y.full_tensor() - xt) ** 2)
                + 0.01 * aux.full_tensor())
        keys = sorted(leaves["experts"])
        grads = torch.autograd.grad(
            loss, [leaves["gate_w"]] + [leaves["experts"][k] for k in keys])
        losses.append(float(loss))
        with torch.no_grad():
            p = {"gate_w": (leaves["gate_w"] - 0.2 * grads[0]).detach(),
                 "experts": {k: (leaves["experts"][k] - 0.2 * g).detach()
                             for k, g in zip(keys, grads[1:])}}
    return losses, {"gate_w": p["gate_w"].numpy(),
                    "experts": {k: v.numpy()
                                for k, v in p["experts"].items()}}
