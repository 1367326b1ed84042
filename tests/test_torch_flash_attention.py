"""The port's flash attention (paddle_tpu_torch.kernels.
flash_attention) against the JAX package's: the forward against the
Pallas kernel, which runs in interpret mode on the CPU, and the gradient
(`FlashAttentionFunction` under torch.func.vjp, and
`flash_attention_bwd`) against `jax.vjp` of the JAX `flash_attention`
and its `_flash_bwd_rule`.

The same numpy inputs, made from a seed, go through both.  Tolerances:
float32 at atol 2e-5 (the same f32 arithmetic, summed in other orders);
bfloat16 inputs compared in f32 at atol 2e-2 (an ulp of bf16 at the
outputs' magnitude, where p and O round at other points).
"""

import importlib

import jax

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401 — registers the JAX kernels
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import registry as treg

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


def _split_views(B, T, H, D, dtype=torch.float32, seed=0):
    """q, k, v as [B, T, H, D] views of one [B, T, 3*H*D] tensor, as the
    split op leaves an fc output."""
    x = torch.from_numpy(np.random.RandomState(seed).randn(
        B, T, 3 * H * D).astype(np.float32)).to(dtype)
    return [t.unflatten(-1, (H, D)) for t in x.split(H * D, dim=-1)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_on_strided_views_equals_contiguous(dtype, causal):
    q, k, v = (t.transpose(1, 2)
               for t in _split_views(2, 40, 3, 16, getattr(torch, dtype)))
    assert not q.is_contiguous()
    got = tfa.flash_attention_plain(q, k, v, 0.25, causal, 16, 16, 3)
    want = tfa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                     v.contiguous(), 0.25, causal, 16, 16, 3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_bthd_writes_into_out_and_matches_bhtd():
    q, k, v = _split_views(2, 24, 2, 8)
    out = torch.empty(2, 24, 16)
    o, m, l = tfa.flash_attention_bthd(q, k, v, None, True,
                                       out=out.unflatten(-1, (2, 8)))
    assert o.data_ptr() == out.data_ptr()
    wo, wm, wl = tfa.flash_attention_fwd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), None, True)
    assert torch.equal(out.unflatten(-1, (2, 8)).transpose(1, 2), wo)
    assert torch.equal(m, wm) and torch.equal(l, wl)


@pytest.mark.parametrize("case", ["split views", "contiguous bthd",
                                  "transposed bhtd", "bf16 split views"])
def test_check_kernel_args_accepts_aligned_views(case):
    if case == "split views":
        q, k, v = _split_views(2, 24, 4, 32)
    elif case == "bf16 split views":
        q, k, v = _split_views(2, 24, 4, 64, torch.bfloat16)
    elif case == "contiguous bthd":
        q, k, v = (torch.zeros(2, 24, 4, 8) for _ in range(3))
    else:
        q, k, v = (torch.zeros(2, 4, 24, 8).transpose(1, 2)
                   for _ in range(3))
    o = torch.empty(q.shape[0], q.shape[1], q.shape[2] * q.shape[3],
                    dtype=q.dtype).unflatten(-1, q.shape[2:])
    tfa.check_kernel_args(q, k, v, o)


def _bad_args(what):
    q, k, v = _split_views(2, 24, 2, 32)
    o = torch.empty(2, 24, 64).unflatten(-1, (2, 32))
    if what == "last stride":
        q = torch.zeros(2, 24, 2, 64)[..., ::2]
    elif what == "base":
        q = torch.zeros(2, 24, 2 * 32 + 1)[..., 1:].unflatten(-1, (2, 32))
    elif what == "row stride":
        q = torch.zeros(2, 24, 2 * 32 + 1)[..., :64].unflatten(-1, (2, 32))
    elif what == "dtype":
        q, k, v, o = (t.to(torch.float64) for t in (q, k, v, o))
    elif what == "head dim":
        q, k, v, o = (torch.zeros(1, 8, 1, 264) for _ in range(4))
    return q, k, v, o


@pytest.mark.parametrize("what,exc,msg", [
    ("last stride", ValueError, "unit stride"),
    ("base", ValueError, "base pointer is not 16-byte aligned"),
    ("row stride", ValueError, "row stride of 260 bytes"),
    ("dtype", TypeError, "float32 or bfloat16"),
    ("head dim", ValueError, "head dim 264"),
])
def test_check_kernel_args_rejects(what, exc, msg):
    with pytest.raises(exc, match=msg):
        tfa.check_kernel_args(*_bad_args(what))


def test_padded_copies_align_the_head_dim():
    q, k, v = (torch.from_numpy(np.random.RandomState(i).randn(
        1, 5, 2, 3).astype(np.float32)) for i in range(3))
    with pytest.raises(ValueError, match="batch stride of 120 bytes"):
        tfa.check_kernel_args(q, k, v, torch.empty(q.shape))
    pq, pk, pv = tfa._padded(q, k, v)
    assert pq.shape == (1, 5, 2, 4) and pq.is_contiguous()
    assert torch.equal(pq[..., :3], q) and not pq[..., 3:].any()
    strides = tfa.check_kernel_args(pq, pk, pv, torch.empty(pq.shape))
    assert strides == [40, 8, 4] * 4


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("num_heads,dim,seq", [(4, 32, 16), (2, 16, 24),
                                               (1, 8, 20)])
def test_op_on_split_outputs_matches_jax(causal, num_heads, dim, seq):
    x = np.random.RandomState(0).randn(2, seq, 3 * dim).astype(np.float32)
    split = {"axis": 2, "num": 3}
    jq, jk, jv = jreg.get_op_info("split").kernel(
        None, {"X": [jnp.asarray(x)]}, split)["Out"]
    tq, tk, tv = treg.get_op_info("split").kernel(
        None, {"X": [torch.from_numpy(x)]}, split)["Out"]
    assert not tq.is_contiguous()
    attrs = {"num_heads": num_heads, "causal": causal, "sm_scale": 0.0,
             "block_size": 8}
    jo = jreg.get_op_info("flash_attention").kernel(
        None, {"Q": [jq], "K": [jk], "V": [jv]}, attrs)["Out"][0]
    to = treg.get_op_info("flash_attention").kernel(
        None, {"Q": [tq], "K": [tk], "V": [tv]}, attrs)["Out"][0]
    assert to.is_contiguous() and tuple(to.shape) == (2, seq, dim)
    np.testing.assert_allclose(to.numpy(), _f32(jo), atol=2e-5, rtol=0)


def _vjp_port(tq, tk, tv, tdo, scale, causal, q_offset):
    """(o, dq, dk, dv) of FlashAttentionFunction under torch.func.vjp,
    in [B, H, T, D] layout (the Function takes [B, T, H, D] views)."""
    def f(q, k, v):
        return tfa.FlashAttentionFunction.apply(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale,
            causal, q_offset, 128, 128)[0].transpose(1, 2)

    o, vjp_fn = torch.func.vjp(f, tq, tk, tv)
    return (o,) + vjp_fn(tdo)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,D", [(16, 8), (200, 16), (256, 8)])
@pytest.mark.parametrize("q_offset", [0, 3])
def test_gradient_matches_jax_vjp(causal, T, D, q_offset):
    # T = 200: the 128-key block halves to 8 until it divides Tk
    (jq, jk, jv), (tq, tk, tv) = _inputs(T, D, "float32")
    do = np.random.RandomState(7).randn(*tq.shape).astype(np.float32)
    scale = D ** -0.5
    jo, jvjp = jax.vjp(lambda q, k, v: jfa.flash_attention(
        q, k, v, scale, causal, 128, 128, q_offset), jq, jk, jv)
    jgrads = jvjp(jnp.asarray(do))
    tgot = _vjp_port(tq, tk, tv, torch.from_numpy(do), scale, causal,
                     q_offset)
    for name, t, j in zip(("o", "dq", "dk", "dv"), tgot, (jo,) + jgrads):
        assert tuple(t.shape) == tuple(j.shape), name
        np.testing.assert_allclose(_f32(t), _f32(j), atol=2e-5, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_k", [128, 8])
def test_bwd_matches_flash_bwd_rule(causal, block_k):
    # the transcription against the rule itself, fed the same residuals
    (jq, jk, jv), (tq, tk, tv) = _inputs(24, 8, "float32")
    rs = np.random.RandomState(3)
    do = rs.randn(*tq.shape).astype(np.float32)
    scale = 0.3
    jo, jm, jl = jfa._fwd(jq, jk, jv, scale, causal, 128, block_k, 0)
    want = jfa._flash_bwd_rule(scale, causal, 128, block_k, 0,
                               (jq, jk, jv, jo, jm, jl), jnp.asarray(do))
    got = tfa.flash_attention_bwd(
        tq, tk, tv, torch.from_numpy(np.array(jo)),
        torch.from_numpy(np.array(jm)), torch.from_numpy(np.array(jl)),
        torch.from_numpy(do), scale, causal, block_k)
    for name, t, j in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_f32(t), _f32(j), atol=2e-5, rtol=0,
                                   err_msg=name)


def test_function_reaches_the_kernel_with_plain_tensors(monkeypatch):
    # The CUDA wrapper reads q.data_ptr() for its ctypes launch, which a
    # torch.func-wrapped tensor refuses.  A stub in the wrapper's place
    # reads the pointers of q, k, v and O and then computes the plain
    # version: called directly under vjp it fails; reached through the
    # op's FlashAttentionFunction under the generic grad it runs, on the
    # same views the split op makes.
    real = tfa.flash_attention_bthd
    pointers = []

    def stub(q, k, v, *args, out=None, **kwargs):
        pointers.extend(t.data_ptr() for t in (q, k, v, out))
        return real(q, k, v, *args, out=out, **kwargs)

    x = torch.from_numpy(np.random.RandomState(0).randn(2, 16, 24)
                         .astype(np.float32))
    q, k, v = x.split(8, dim=-1)
    heads = [t.unflatten(-1, (2, 4)) for t in (q, k, v)]
    with pytest.raises(RuntimeError, match="data pointer"):
        torch.func.vjp(lambda q: stub(q, heads[1], heads[2], None, True,
                                      out=torch.empty(2, 16, 2, 4))[0],
                       heads[0])
    pointers.clear()
    monkeypatch.setattr(tfa, "flash_attention_bthd", stub)
    do = torch.ones(2, 16, 8)
    grads = treg.run_generic_grad(
        None, "flash_attention",
        {"Q": [q], "K": [k], "V": [v], "O@Out": [None], "OG@Out": [do]},
        {"num_heads": 2, "causal": True})
    # the pointers are the split views' own
    assert pointers[:3] == [t.data_ptr() for t in (q, k, v)]
    monkeypatch.setattr(tfa, "flash_attention_bthd", real)
    want = treg.run_generic_grad(
        None, "flash_attention",
        {"Q": [q], "K": [k], "V": [v], "O@Out": [None], "OG@Out": [do]},
        {"num_heads": 2, "causal": True})
    for slot in ("Q@GRAD", "K@GRAD", "V@GRAD"):
        assert torch.equal(grads[slot][0], want[slot][0])
