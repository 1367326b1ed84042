"""GPipe and Switch MoE in the port at 4 gloo ranks against the JAX
package on a 4-device mesh.

The JAX side runs here over the virtual CPU devices; the port's in 4
ranks spawned once for the file (`torch_ranks`), parameters and inputs
passed in as numpy arrays.

- `pipeline_apply` with more microbatches than stages: at pp 4 (6
  microbatches), pp 2 x dp 2 (4) and pp 2 beside an mp axis the
  schedule leaves out (8, with `remat`): outputs, the loss
  mean((out - tgt)^2) and its grads for the stacked stage params
  against the JAX function's (outputs and loss at rtol 2e-5 and atol
  2e-6, grads at rtol 5e-4 and atol 1e-6, the JAX tests' tolerances).
- The JAX errors of `split_microbatches` and a stage-count mismatch.
- `switch_moe` (through `moe_shard_map`) at ep 4 and at dp 2 x ep 2, at
  capacity factor 8 (nothing dropped) and 0.5: outputs, aux, the count
  of dropped tokens, and the grads of mean(y^2) + 0.01 aux, within
  1e-5.
- `PipelineProgramTrainer` (fc stages built through the layers,
  Momentum 0.2 / 0.9) at pp 2 x dp 2 and `MoEProgramLayer` (fc experts,
  SGD 0.2) at dp 2 x ep 2 against the JAX classes for 2 steps, from
  the JAX classes' initial params.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import paddle_tpu.fluid as jfluid
from paddle_tpu.parallel import MoEProgramLayer as JMoELayer
from paddle_tpu.parallel import PipelineProgramTrainer as JPipeTrainer
from paddle_tpu.parallel.moe import init_moe_params, moe_shard_map
from paddle_tpu.parallel.pipeline import (pipeline_apply,
                                          split_microbatches,
                                          stack_stage_params)

from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.parallel import pipeline as tpipe

import torch_parallel_cases as cases
from torch_ranks import CaseFailed, run_cases

torch.set_num_threads(1)

D = 16
# (stages, batch, microbatches, JAX mesh, port mesh, remat)
PIPES = {
    "pp4": (4, 24, 6, ((4,), ("pp",)), {"pp": 4, "axes": ("pp",)}, False),
    "pp2_dp2": (2, 16, 4, ((2, 2), ("pp", "dp")), {"pp": 2}, False),
    "pp2_mp2": (2, 32, 8, ((2, 2), ("mp", "pp")),
                {"pp": 2, "mp": 2, "axes": ("mp", "pp")}, True),
}
MOE_D, MOE_H, MOE_E = 8, 16, 8
MOES = {"ep4": (((4,), ("ep",)), {"ep": 4, "axes": ("ep",)}),
        "dp2_ep2": (((2, 2), ("dp", "ep")), {"ep": 2})}
CAPACITIES = (float(MOE_E), 0.5)
PROGRAM_STEPS = 2


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _stage_params(rng, n_stages):
    return [{"w": (rng.randn(D, D) * 0.3).astype(np.float32),
             "b": (rng.randn(D) * 0.1).astype(np.float32)}
            for _ in range(n_stages)]


def _jstage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _pipe_inputs(name):
    stages, batch = PIPES[name][:2]
    rng = np.random.RandomState(len(name) + stages)
    stacked = {k: np.stack([p[k] for p in _stage_params(rng, stages)])
               for k in ("w", "b")}
    x = rng.randn(batch, D).astype(np.float32)
    tgt = rng.randn(batch, D).astype(np.float32)
    return stacked, x, tgt


def _jax_pipe(name):
    _, _, m, jmesh_args, _, remat = PIPES[name]
    stacked, x, tgt = _pipe_inputs(name)
    mesh = _jmesh(*jmesh_args)
    params = {k: jnp.asarray(v) for k, v in stacked.items()}

    def loss(params):
        out = pipeline_apply(mesh, _jstage, params, jnp.asarray(x),
                             n_microbatches=m, remat=remat)
        return jnp.mean((out - tgt) ** 2), out

    (l, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    return (np.asarray(out), float(l),
            {k: np.asarray(g) for k, g in grads.items()})


def _moe_inputs(name):
    seed = 3 if name == "ep4" else 4
    params = {k: np.asarray(v) for k, v in
              init_moe_params(seed, MOE_D, MOE_H, MOE_E).items()}
    x = np.random.RandomState(seed).randn(64, MOE_D).astype(np.float32)
    return params, x


def _jax_moe(name, cf):
    params, x = _moe_inputs(name)
    fn = moe_shard_map(_jmesh(*MOES[name][0]), capacity_factor=cf)
    p = {k: jnp.asarray(v) for k, v in params.items()}

    def loss(p):
        y, aux = fn(p, jnp.asarray(x))
        return jnp.mean(y ** 2) + 0.01 * aux, (y, aux)

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(loss,
                                                      has_aux=True))(p)
    return (np.asarray(y), float(aux),
            {k: np.asarray(g) for k, g in grads.items()})


def _build_stage(i=None):
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        h = jfluid.layers.data(name="h", shape=[D], dtype="float32")
        out = jfluid.layers.fc(input=h, size=D, act="tanh")
    return main, startup, "h", out.name


def _program_data():
    rs = np.random.RandomState(0)
    x = rs.randn(16, D).astype(np.float32)
    tgt = np.tanh(x @ (np.eye(D, dtype=np.float32) * 0.5))
    return x, tgt


def _jax_pipeline_program():
    trainer = JPipeTrainer(
        _build_stage, _jmesh((2, 2), ("pp", "dp")), n_microbatches=4,
        optimizer=jfluid.optimizer.Momentum(learning_rate=0.2,
                                            momentum=0.9))
    init = {k: np.asarray(v) for k, v in trainer.stacked.items()}
    x, tgt = _program_data()
    losses = [trainer.step(x, tgt) for _ in range(PROGRAM_STEPS)]
    return (init, losses,
            {k: np.asarray(v) for k, v in trainer.stacked.items()},
            {k: np.asarray(v) for k, v in
             trainer.opt_state["slots"]["velocity"].items()})


def _moe_program_x():
    return np.random.RandomState(0).randn(64, 8).astype(np.float32)


def _jax_moe_program():
    def build_expert():
        main, startup = jfluid.Program(), jfluid.Program()
        with jfluid.program_guard(main, startup):
            h = jfluid.layers.data(name="h", shape=[8], dtype="float32")
            out = jfluid.layers.fc(input=h, size=8, act="tanh")
        return main, startup, "h", out.name

    layer = JMoELayer(build_expert, n_experts=MOE_E, d_model=8,
                      mesh=_jmesh((2, 2), ("dp", "ep")),
                      capacity_factor=float(MOE_E))
    init = jax.tree_util.tree_map(np.asarray, layer.params)
    x = jnp.asarray(_moe_program_x())

    def loss_fn(params):
        y, aux = layer(params, x)
        return jnp.mean((y - x) ** 2) + 0.01 * aux

    params, losses = layer.params, []
    step = jax.jit(jax.value_and_grad(loss_fn))
    for _ in range(PROGRAM_STEPS):
        loss, grads = step(params)
        params = jax.tree_util.tree_map(lambda p, g: p - 0.2 * g, params,
                                        grads)
        losses.append(float(loss))
    return init, losses, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_side():
    return {
        "pipes": {n: _jax_pipe(n) for n in PIPES},
        "moes": {(n, cf): _jax_moe(n, cf) for n in MOES for cf in CAPACITIES},
        "pipeline_program": _jax_pipeline_program(),
        "moe_program": _jax_moe_program(),
    }


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    todo = {}
    for name, (_, _, m, _, mesh_kw, remat) in PIPES.items():
        stacked, x, tgt = _pipe_inputs(name)
        todo["pipe_" + name] = (cases.pipeline_case,
                                (stacked, x, tgt, m, mesh_kw, remat))
    for name, (_, mesh_kw) in MOES.items():
        params, x = _moe_inputs(name)
        for cf in CAPACITIES:
            todo["moe_%s_%s" % (name, cf)] = (cases.moe_case,
                                              (params, x, mesh_kw, cf))
    x, tgt = _program_data()
    todo["pipeline_program"] = (cases.pipeline_program_case, (
        D, jax_side["pipeline_program"][0], x, tgt, PROGRAM_STEPS))
    todo["moe_program"] = (cases.moe_program_case, (
        8, MOE_E, jax_side["moe_program"][0], _moe_program_x(),
        PROGRAM_STEPS))
    return run_cases(todo, 4, tmp_path_factory.mktemp("ranks"))


def _result(ranks, name):
    got = ranks[name]
    if isinstance(got, CaseFailed):
        pytest.fail("rank-side case %s raised:\n%s" % (name, got))
    return got


@pytest.mark.parametrize("name", sorted(PIPES))
def test_pipeline_matches_jax(name, ranks, jax_side):
    out, loss, grads = _result(ranks, "pipe_" + name)
    jout, jloss, jgrads = jax_side["pipes"][name]
    np.testing.assert_allclose(out, jout, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(grads[k], jgrads[k], rtol=5e-4,
                                   atol=1e-6, err_msg=k)


def _error(fn, *args, **kwargs):
    with pytest.raises(Exception) as info:
        fn(*args, **kwargs)
    return type(info.value).__name__, str(info.value)


def test_pipeline_errors_equal_jax():
    assert _error(tpipe.split_microbatches, torch.zeros(10, 3), 4) == \
        _error(split_microbatches, jnp.zeros((10, 3)), 4)
    assert tuple(tpipe.split_microbatches(torch.zeros(12, 3), 4).shape) \
        == split_microbatches(jnp.zeros((12, 3)), 4).shape
    rng = np.random.RandomState(3)
    per = _stage_params(rng, 2)
    jstacked = stack_stage_params([{k: jnp.asarray(v) for k, v in p.items()}
                                   for p in per])
    tstacked = tpipe.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in p.items()} for p in per])
    for k in ("w", "b"):
        np.testing.assert_array_equal(tstacked[k].numpy(),
                                      np.asarray(jstacked[k]))
    assert _error(tpipe.pipeline_apply, tmesh.parse_mesh_spec("pp=4"),
                  None, tstacked, torch.zeros(8, D), 2) == \
        _error(pipeline_apply, _jmesh((4,), ("pp",)), _jstage, jstacked,
               jnp.zeros((8, D)), n_microbatches=2)


@pytest.mark.parametrize("name", sorted(MOES))
@pytest.mark.parametrize("cf", CAPACITIES)
def test_switch_moe_matches_jax(name, cf, ranks, jax_side):
    y, aux, grads = _result(ranks, "moe_%s_%s" % (name, cf))
    jy, jaux, jgrads = jax_side["moes"][(name, cf)]
    np.testing.assert_allclose(y, jy, rtol=0, atol=1e-5)
    np.testing.assert_allclose(aux, jaux, rtol=1e-5)
    dropped = int((np.abs(y).sum(1) == 0).sum())
    assert dropped == int((np.abs(jy).sum(1) == 0).sum())
    if cf < 1:
        assert dropped > 0   # congestion really dropped tokens
    else:
        assert dropped == 0
    assert grads.keys() == jgrads.keys()
    for k in grads:
        np.testing.assert_allclose(grads[k], jgrads[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_pipeline_program_trainer_matches_jax(ranks, jax_side):
    losses, stacked, vel = _result(ranks, "pipeline_program")
    _, jlosses, jstacked, jvel = jax_side["pipeline_program"]
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5, atol=1e-6)
    assert sorted(stacked) == sorted(jstacked)
    for k in stacked:
        np.testing.assert_allclose(stacked[k], jstacked[k], rtol=2e-4,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(vel[k], jvel[k], rtol=2e-4, atol=1e-5,
                                   err_msg=k)
        assert np.abs(vel[k]).max() > 0


def test_moe_program_layer_matches_jax(ranks, jax_side):
    losses, params = _result(ranks, "moe_program")
    _, jlosses, jparams = jax_side["moe_program"]
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(params["gate_w"], jparams["gate_w"],
                               rtol=2e-4, atol=1e-5)
    for k in params["experts"]:
        np.testing.assert_allclose(params["experts"][k],
                                   jparams["experts"][k], rtol=2e-4,
                                   atol=1e-5, err_msg=k)
