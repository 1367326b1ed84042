"""Three faults of the port against the JAX package, each repaired:

- The flash kernel's routes: head dims up to 256 in float32, bfloat16
  and float16 (129..256 on routes of their own), a clear error above
  256 or for another dtype; and the plain version at head dims 192 and
  256 against the Pallas kernel in interpret mode (float32 at atol 2e-5,
  as tests/test_torch_flash_attention.py holds the smaller ones).
- `save_inference_model` takes the executor, as the JAX package's
  does, reading the global scope; a Scope in that slot still works;
  `model_filename` comes before `bucket_hints`.
- `Program.random_seed` seeds the scope's random stream: startup
  programs with seeds 1 and 2 give different fc weights, the same seed
  equal ones, and `clone` keeps the seed.
"""

import importlib
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401 — registers the JAX kernels
from paddle_tpu.core.scope import Scope as JScope
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import io as tio

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
tfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")

DTYPES = {"float32": "f32", "bfloat16": "bf16", "float16": "f16"}


# -- flash attention: routes by head dim and dtype ------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D", [64, 128, 192, 256])
def test_flash_routes(D, dtype):
    tdt = getattr(torch, dtype)
    want = DTYPES[dtype] + ("" if D <= 128 else "_d256")
    assert tfa.kernel_route(tdt, D) == want
    assert want in tfa.ROUTES
    # the split op's views of a [B, T, 3*H*D] fc output pass the check
    x = torch.zeros(2, 24, 3 * 2 * D, dtype=tdt)
    q, k, v = (t.unflatten(-1, (2, D)) for t in x.split(2 * D, dim=-1))
    o = torch.empty(2, 24, 2 * D, dtype=tdt).unflatten(-1, (2, D))
    strides = tfa.check_kernel_args(q, k, v, o)
    assert strides[:3] == [24 * 6 * D, 6 * D, D]


@pytest.mark.parametrize("D", [257, 512])
def test_flash_head_dim_above_256_raises(D):
    with pytest.raises(ValueError, match="head dim %d; the kernel takes "
                                         "1..256" % D):
        tfa.kernel_route(torch.float32, D)
    q = torch.zeros(1, 8, 1, D)
    with pytest.raises(ValueError, match="1..256"):
        tfa.check_kernel_args(q, q, q, torch.empty(q.shape))


def test_flash_other_dtype_raises():
    with pytest.raises(TypeError, match="float16, float32 or bfloat16"):
        tfa.kernel_route(torch.float64, 64)


def test_flash_launches_counted_by_route():
    assert set(tfa.flash_attention_fwd.route_launches) == set(tfa.ROUTES)
    assert len(tfa.ROUTES) == 6


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [192, 256])
def test_plain_matches_pallas_at_wide_heads(D, causal):
    rs = np.random.RandomState(D)
    arrs = [rs.randn(1, 2, 16, D).astype(np.float32) for _ in range(3)]
    scale = D ** -0.5
    jo, jm, jl = jfa._fwd(*[jnp.asarray(a) for a in arrs], scale, causal,
                          128, 128, 0)
    to, tm, tl = tfa.flash_attention_plain(
        *[torch.from_numpy(a) for a in arrs], scale, causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5)


# -- save_inference_model with the executor -----------------------------------

def _fc_program(fluid, seed=0):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[5], dtype="float32")
        y = fluid.layers.fc(input=x, size=3, act="relu")
    return main, startup, y


def test_save_inference_model_takes_the_executor(tmp_path):
    main, startup, y = _fc_program(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        # the JAX package's call, positionally
        tio.save_inference_model(str(tmp_path / "a"), ["x"], [y], exe, main)
        tio.save_inference_model(str(tmp_path / "b"), ["x"], [y], exe,
                                 main, "model.json", {"batch_buckets": [2]})
    tio.save_inference_model(str(tmp_path / "c"), ["x"], [y], scope, main)
    meta = json.load(open(str(tmp_path / "b" / "model.json")))
    assert meta["bucket_hints"] == {"batch_buckets": [2]}
    xs = np.random.RandomState(0).randn(2, 5).astype(np.float32)
    outs = []
    for d, fname in (("a", "__model__"), ("b", "model.json"),
                     ("c", "__model__")):
        load_scope = tfluid.Scope()
        with tfluid.scope_guard(load_scope):
            prog, feeds, fetches = tio.load_inference_model(
                str(tmp_path / d), exe, model_filename=fname)
            outs.append(exe.run(prog, feed={"x": xs}, fetch_list=fetches)[0])
    want = exe.run(main, feed={"x": xs}, fetch_list=[y], scope=scope)[0]
    for got in outs:
        np.testing.assert_array_equal(got, want)
    # and the JAX package reads the port's export
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(JScope()):
        prog, feeds, fetches = jfluid.io.load_inference_model(
            str(tmp_path / "a"), jexe)
        jout = jexe.run(prog, feed={"x": xs}, fetch_list=fetches)[0]
    np.testing.assert_allclose(np.asarray(jout), want, atol=1e-6, rtol=0)


# -- Program.random_seed --------------------------------------------------------

def _weights(fluid, seed, scope_cls, exe_place):
    _, startup, _ = _fc_program(fluid, seed)
    exe = fluid.Executor(exe_place)
    scope = scope_cls()
    with fluid.scope_guard(scope):
        exe.run(startup)
    return np.array(scope.get("fc_0.w_0"))


def test_random_seed_seeds_the_stream():
    def port(seed):
        return _weights(tfluid, seed, tfluid.Scope, tfluid.CPUPlace())

    def jax(seed):
        return _weights(jfluid, seed, JScope, jfluid.CPUPlace())

    for weights in (port, jax):
        w1, w1b, w2 = weights(1), weights(1), weights(2)
        assert np.array_equal(w1, w1b)
        assert not np.array_equal(w1, w2)
        assert w1.shape == (5, 3)


def test_random_seed_survives_clone_and_stream_advances():
    main, startup, _ = _fc_program(tfluid, seed=5)
    assert startup.clone().random_seed == 5
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    first = scope.get("fc_0.w_0").clone()
    # a second run in the same scope draws on from the scope's stream
    exe.run(startup, scope=scope)
    assert not torch.equal(scope.get("fc_0.w_0"), first)
    # an executor given a seed keeps a stream of its own
    a, b = tfluid.Scope(), tfluid.Scope()
    seeded = tfluid.Executor(tfluid.CPUPlace(), seed=5)
    seeded.run(startup, scope=a)
    seeded.run(startup, scope=b)
    assert not torch.equal(a.get("fc_0.w_0"), b.get("fc_0.w_0"))
