"""Sequence parallelism in the port at 4 gloo ranks against the JAX
package on a 4-device mesh: ring and Ulysses attention, the Fluid
transformer with a sequence-parallel axis under ParallelTrainer, and
models/transformer.py.

The JAX side runs here over the virtual CPU devices; the port's in 4
ranks spawned once for the file (`torch_ranks`), the inputs and
initial states passed in as numpy arrays.

- `ring_attention` and `ulysses_attention` (the hand-written kernel's
  plain version on the CPU inside Ulysses, as the JAX side's runs the
  Pallas kernel in interpret mode) at sp 4 and at dp 2 x sp 2, causal
  and not: outputs within 1e-5 of the JAX functions', and the grads of
  sum(sin(out)) within 1e-4 of `jax.grad`'s.
- The Fluid transformer program (`sequence_parallel_axis="sp"`, 1
  layer, 4 heads, d_model 32) under ParallelTrainer at mp 2 x sp 2, the
  feeds laid over sp, 2 Momentum steps in ring mode and in Ulysses
  mode: losses and state at `tests/test_parallel_trainer.py`'s
  tolerances against the JAX trainer on the same mesh shape.
- models/transformer.py from the JAX model's numpy params
  (`transformer_params_from_numpy`): the dense and flash forwards, and
  ring and Ulysses over dp 2 x sp 2, within 1e-4 of the JAX model's
  logits; 2 sharded SGD steps with `transformer_param_specs` at mp 2 x
  sp 2 in ring mode against the JAX step's losses (rtol 1e-5), the
  params still laid out by their specs.
- `ring_allreduce` over dp 4 against a plain sum (and mean).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import transformer as jtf
from paddle_tpu.models.transformer_program import (
    build_transformer_program as jbuild, transformer_program_feeds)
from paddle_tpu.parallel import ParallelTrainer as JTrainer
from paddle_tpu.parallel.ring import (ring_attention, sp_shard_map,
                                      ulysses_attention)

from paddle_tpu_torch.parallel.sharding import P

import torch_parallel_cases as cases
from torch_ranks import CaseFailed, run_cases

torch.set_num_threads(1)

ATTN_CASES = [(impl, causal, mesh) for impl in ("ring", "ulysses")
              for causal in (False, True) for mesh in ("sp4", "dp2_sp2")]
MESH_KW = {"sp4": {"sp": 4, "axes": ("sp",)}, "dp2_sp2": {"sp": 2}}
JMESH = {"sp4": ((4,), ("sp",)), "dp2_sp2": ((2, 2), ("dp", "sp"))}
TF_STEPS = 2
SGD_STEPS = 2
FWD = dict(vocab=97, n_layer=2, n_head=4, d_model=64, max_len=128,
           batch=4, seq=64)
SGD = dict(vocab=64, n_layer=1, n_head=4, d_model=32, max_len=64,
           batch=4, seq=32)


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _jax_attention(impl, causal, mesh_name):
    mesh = _jmesh(*JMESH[mesh_name])
    q, k, v = (jnp.asarray(a) for a in cases.qkv())
    if impl == "ring":
        fn = sp_shard_map(lambda q, k, v: ring_attention(
            q, k, v, "sp", None, causal), mesh)
    else:
        fn = sp_shard_map(lambda q, k, v: ulysses_attention(
            q, k, v, "sp", None, causal), mesh)
    fn = jax.jit(fn)
    out = fn(q, k, v)
    grads = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(fn(q, k, v))),
                     argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


FEED_SPECS = {"tokens": ("sp",), "positions": ("sp",),
              "targets": ("sp", None)}


def _jax_transformer_train(mode):
    """(initial state, losses, final state) of the JAX trainer on the
    Fluid transformer at mp 2 x sp 2."""
    main, startup, avg, _ = jbuild(4, 16, 64, n_layer=1, n_head=4,
                                   d_model=32, sp_axis="sp", sp_mode=mode)
    with jfluid.program_guard(main, startup):
        jfluid.optimizer.Momentum(learning_rate=0.05,
                                  momentum=0.9).minimize(avg)
    mesh = _jmesh((2, 2), ("mp", "sp"))
    specs = {n: JP(None, *s) for n, s in FEED_SPECS.items()}
    tr = JTrainer(main, startup, ["tokens", "positions", "targets"],
                  [avg.name], mesh, feed_specs=specs, seed=0).init()
    init = {n: np.array(v) for n, v in tr.state.items()}
    feeds = transformer_program_feeds(4, 16, 64, seed=1)
    losses = [float(np.asarray(tr.step(feeds)[0]).reshape(-1)[0])
              for _ in range(TF_STEPS)]
    return init, losses, {n: np.asarray(v) for n, v in tr.state.items()}


def _tokens(cfg, seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, cfg["vocab"], size=(cfg["batch"], cfg["seq"])) \
        .astype(np.int32)


def _jax_params(cfg):
    params = jtf.init_transformer(0, vocab_size=cfg["vocab"],
                                  n_layer=cfg["n_layer"],
                                  n_head=cfg["n_head"],
                                  d_model=cfg["d_model"],
                                  max_len=cfg["max_len"])
    arrays = {n: v for n, v in params.items() if n != "_meta"}
    return params, arrays, (cfg["n_layer"], cfg["n_head"], cfg["d_model"])


def _jax_forwards():
    params, _, _ = _jax_params(FWD)
    tokens = jnp.asarray(_tokens(FWD, 1))
    out = {impl: np.asarray(jtf.transformer_forward(params, tokens,
                                                    attn_impl=impl))
           for impl in ("dense", "flash")}
    mesh = _jmesh((2, 2), ("dp", "sp"))
    for impl in ("ring", "ulysses"):
        with mesh:
            out[impl] = np.asarray(jax.jit(
                lambda p, t, impl=impl: jtf.transformer_forward(
                    p, t, attn_impl=impl, mesh=mesh))(params, tokens))
    return out


def _jax_sgd():
    params, _, _ = _jax_params(SGD)
    mesh = _jmesh((2, 2), ("mp", "sp"))
    meta = params.pop("_meta")
    specs = jtf.transformer_param_specs(dict(params, _meta=meta))
    sharded = {n: jax.device_put(v, NamedSharding(mesh, specs[n]))
               for n, v in params.items()}
    tok = jnp.asarray(_tokens(SGD, 2))
    tgt = jnp.asarray(_tokens(SGD, 3))

    def step(arrs):
        def loss_fn(arrs):
            return jtf.transformer_loss(dict(arrs, _meta=meta), tok, tgt,
                                        attn_impl="ring", mesh=mesh)

        loss, grads = jax.value_and_grad(loss_fn)(arrs)
        return loss, {n: v - 0.1 * grads[n] for n, v in arrs.items()}

    losses = []
    with mesh:
        jstep = jax.jit(step)
        for _ in range(SGD_STEPS):
            loss, sharded = jstep(sharded)
            losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def jax_side():
    return {
        "attention": {c: _jax_attention(*c) for c in ATTN_CASES},
        "train": {m: _jax_transformer_train(m) for m in ("ring", "ulysses")},
        "forwards": _jax_forwards(),
        "sgd": _jax_sgd(),
    }


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    todo = {}
    for impl, causal, mesh in ATTN_CASES:
        todo["attn_%s_%s_%s" % (impl, causal, mesh)] = (
            cases.sp_attention, (impl, causal, MESH_KW[mesh]))
    feed_specs = {n: P(None, *s) for n, s in FEED_SPECS.items()}
    for mode in ("ring", "ulysses"):
        todo["train_" + mode] = (cases.train, (
            cases.build_transformer, cases.transformer_feeds_at,
            ["tokens", "positions", "targets"],
            {"mp": 2, "sp": 2, "axes": ("mp", "sp")},
            jax_side["train"][mode][0], TF_STEPS, 0, feed_specs,
            ("sp", mode)))
    _, arrays, meta = _jax_params(FWD)
    todo["forwards"] = (cases.transformer_forwards, (
        arrays, meta, _tokens(FWD, 1).astype(np.int64), {"sp": 2}))
    _, arrays, meta = _jax_params(SGD)
    todo["sgd"] = (cases.transformer_sgd, (
        arrays, meta, _tokens(SGD, 2).astype(np.int64),
        _tokens(SGD, 3).astype(np.int64),
        {"mp": 2, "sp": 2, "axes": ("mp", "sp")}, SGD_STEPS))
    todo["allreduce_sum"] = (cases.ring_allreduce_case, (False,))
    todo["allreduce_mean"] = (cases.ring_allreduce_case, (True,))
    return run_cases(todo, 4, tmp_path_factory.mktemp("ranks"))


def _result(ranks, name):
    got = ranks[name]
    if isinstance(got, CaseFailed):
        pytest.fail("rank-side case %s raised:\n%s" % (name, got))
    return got


@pytest.mark.parametrize("impl,causal,mesh", ATTN_CASES)
def test_sequence_parallel_attention_matches_jax(impl, causal, mesh, ranks,
                                                 jax_side):
    out, grads = _result(ranks, "attn_%s_%s_%s" % (impl, causal, mesh))
    jout, jgrads = jax_side["attention"][(impl, causal, mesh)]
    np.testing.assert_allclose(out, jout, rtol=0, atol=1e-5)
    for g, jg, name in zip(grads, jgrads, "qkv"):
        np.testing.assert_allclose(g, jg, rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_fluid_transformer_sp_training_matches_jax(mode, ranks, jax_side):
    losses, state, placements = _result(ranks, "train_" + mode)
    _, jlosses, jstate = jax_side["train"][mode]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5, atol=1e-6)
    assert state.keys() == jstate.keys()
    for n in state:
        np.testing.assert_allclose(state[n], jstate[n], rtol=2e-4,
                                   atol=1e-5, err_msg=n)
    vel = [n for n in state if "velocity" in n]
    assert vel and any(np.abs(state[n]).max() > 0 for n in vel)


@pytest.mark.parametrize("impl", ["dense", "flash", "ring", "ulysses"])
def test_transformer_forward_matches_jax(impl, ranks, jax_side):
    out = _result(ranks, "forwards")[impl]
    np.testing.assert_allclose(out, jax_side["forwards"][impl], rtol=0,
                               atol=1e-4)


def test_transformer_sharded_sgd_matches_jax(ranks, jax_side):
    losses, laid = _result(ranks, "sgd")
    jlosses = jax_side["sgd"]
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert laid


@pytest.mark.parametrize("mean", [False, True])
def test_ring_allreduce_is_a_sum(mean, ranks):
    out = _result(ranks, "allreduce_%s" % ("mean" if mean else "sum"))
    x = np.random.RandomState(3).randn(4, 37).astype(np.float32)
    want = x.sum(0) / (4 if mean else 1)
    np.testing.assert_allclose(out, np.broadcast_to(want, (4, 37)),
                               rtol=1e-6, atol=1e-6)


def test_transformer_params_cross_from_the_jax_model():
    """The JAX model's params dict (numpy arrays and its TransformerMeta)
    as the port's, forward equal."""
    from paddle_tpu_torch.models import transformer as ttf

    cfg = dict(SGD, batch=2, seq=16)
    params, _, _ = _jax_params(cfg)
    tparams = ttf.transformer_params_from_numpy(params, "cpu")
    assert tparams["_meta"] == ttf.TransformerMeta(1, 4, 32)
    tokens = _tokens(cfg, 5)
    want = np.asarray(jtf.transformer_forward(params, jnp.asarray(tokens),
                                              attn_impl="dense"))
    got = ttf.transformer_forward(tparams, torch.from_numpy(tokens).long(),
                                  attn_impl="dense").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the port's init draws the JAX init's numbers from the same seed
    own = ttf.init_transformer(0, vocab_size=cfg["vocab"], n_layer=1,
                               n_head=4, d_model=32, max_len=cfg["max_len"])
    for n, v in params.items():
        if n != "_meta":
            np.testing.assert_array_equal(own[n], v, err_msg=n)
