"""The port's flash-attention forward (paddle_tpu_torch.kernels.
flash_attention) against the JAX package's Pallas kernel, which runs in
interpret mode on the CPU.

The same numpy inputs, made from a seed, go through both.  Tolerances:
float32 at atol 2e-5 (the same f32 arithmetic, summed in other orders);
bfloat16 inputs compared in f32 at atol 2e-2 (an ulp of bf16 at the
outputs' magnitude, where p and O round at other points).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

# the modules, not the functions of the same name their packages export
jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
tfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(T, D, dtype, B=2, H=2, seed=0):
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(B, H, T, D).astype(np.float32) for _ in range(3)]
    jx = [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [8, 16])
@pytest.mark.parametrize("T", [16, 24, 200])
@pytest.mark.parametrize("q_offset", [0, 5])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_pallas_fwd(causal, q_offset, T, D, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(T, D, dtype)
    scale = D ** -0.5
    jo, jm, jl = jfa._fwd(jq, jk, jv, scale, causal, 128, 128, q_offset)
    to, tm, tl = tfa.flash_attention_plain(tq, tk, tv, scale, causal, 128,
                                           128, q_offset)
    assert to.dtype == tq.dtype and tuple(to.shape) == tuple(tq.shape)
    atol = ATOL[dtype]
    np.testing.assert_allclose(_f32(to), _f32(jo), atol=atol, rtol=0)
    np.testing.assert_allclose(_f32(tm), _f32(jm), atol=atol, rtol=0)
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=atol,
                               rtol=1e-5 if dtype == "float32" else 1e-3)


@pytest.mark.parametrize("q_offset", [0, 5])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_attention_matches_jax(dtype, causal, q_offset):
    (jq, jk, jv), (tq, tk, tv) = _inputs(24, 16, dtype)
    jo = jfa.reference_attention(jq, jk, jv, None, causal, q_offset)
    to = tfa.reference_attention(tq, tk, tv, None, causal, q_offset)
    np.testing.assert_allclose(_f32(to), _f32(jo), atol=ATOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("T", [16, 200])
@pytest.mark.parametrize("causal", [False, True])
def test_public_flash_attention_matches_jax(causal, T):
    (jq, jk, jv), (tq, tk, tv) = _inputs(T, 16, "float32")
    jo = jfa.flash_attention(jq, jk, jv, None, causal, 16, 16, 0)
    to = tfa.flash_attention(tq, tk, tv, None, causal, 16, 16, 0)
    np.testing.assert_allclose(_f32(to), _f32(jo), atol=2e-5, rtol=0)
    dense = tfa.reference_attention(tq, tk, tv, None, causal)
    np.testing.assert_allclose(_f32(to), _f32(dense), atol=2e-5, rtol=0)


def test_cpu_tensor_takes_plain_version_and_launches_nothing():
    _, (tq, tk, tv) = _inputs(24, 8, "float32")
    before = tfa.flash_attention_fwd.launches
    o, m, l = tfa.flash_attention_fwd(tq, tk, tv, None, True)
    po, pm, pl = tfa.flash_attention_plain(tq, tk, tv, 8 ** -0.5, True)
    assert tfa.flash_attention_fwd.launches == before == 0
    assert torch.equal(o, po) and torch.equal(m, pm) and torch.equal(l, pl)


def test_fully_masked_rows_match_jax():
    # a negative q_offset leaves the first rows with every key masked:
    # the finite -1e30 mask makes them the mean of v with l = Tk, as on
    # the JAX side
    (jq, jk, jv), (tq, tk, tv) = _inputs(16, 8, "float32")
    jo, jm, jl = jfa._fwd(jq, jk, jv, 8 ** -0.5, True, 8, 8, -4)
    to, tm, tl = tfa.flash_attention_plain(tq, tk, tv, 8 ** -0.5, True, 8,
                                           8, -4)
    np.testing.assert_allclose(_f32(to), _f32(jo), atol=2e-5, rtol=0)
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-6)
    assert float(tl[0, 0, 0]) == 16.0


def test_kernel_wrapper_rejects_cpu_tensors():
    _, (tq, tk, tv) = _inputs(16, 8, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        tfa._launch(tq, tk, tv, 0.5, True, 0)
    assert tfa.flash_attention_fwd.launches == 0
