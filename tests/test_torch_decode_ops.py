"""The generation slice's ops, step programs and Adam: the port against
the JAX package, on the CPU.

- Ops (`concat`, `increment`, `reduce_*`, `cached_attention`), the same
  numpy inputs through the JAX kernel and the port's.  Tolerance: exact
  for integer results and for concat, max and min (no arithmetic);
  1e-6 relative for f32 sums and means (the same sums in other orders),
  the bf16 input's own sums in f32 at 1e-6; `cached_attention` at atol
  1e-6 (f32 scores, softmax and p.v over at most 9 keys).
- Descs: both step programs, and the transformer's training program
  after `Adam(...).minimize` (main and startup), equal the JAX
  package's through `to_dict()`, exactly.
- Adam: 6 steps of the transformer at tests/test_cached_decode.py's size
  from the JAX startup's state; losses, both moments and the beta powers
  at atol 1e-5 (f32 on both sides, sums in other orders through 2
  layers).  Parameters at atol 1e-5 plus, for each step, lr times the
  share of epsilon in that step's denominator sqrt(m2) + eps (the JAX
  side's m2 after the step): where sqrt(m2)
  is not large against eps the update loses its sign normalisation and
  follows the grad's rounding.  The K projection's bias has an
  identically zero gradient (softmax ignores a shift common to every
  key), so its grads are rounding noise of about 1e-10 in both packages,
  which Adam turns into steps of up to lr (2.6e-4 apart after 6 steps);
  one weight whose grad is near 3e-7 ends 1.7e-5 apart.  Every other
  entry agrees within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.kernels.flash_attention import reference_attention
from paddle_tpu.models import transformer_program as jtp
from paddle_tpu.ops.registry import get_op_info as jget
from paddle_tpu_torch.core.ragged import RaggedTensor
from paddle_tpu_torch.fluid import (Adam, CPUPlace, Executor, Scope, io)
from paddle_tpu_torch.models import transformer_program as ptp
from paddle_tpu_torch.ops.registry import get_op_info as pget

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

B, T, V, L, H, D = 4, 16, 32, 2, 2, 16
LR = 5e-3
ADAM_STEPS = 6


def _both(op, ins, attrs):
    """(JAX outputs, port outputs) of op `op` on numpy `ins`, each
    {slot: [ndarray]}."""
    jout = jget(op).kernel(None, {k: [jnp.asarray(v) for v in vs]
                                  for k, vs in ins.items()}, attrs)
    pout = pget(op).kernel(None, {k: [torch.from_numpy(np.array(v))
                                      for v in vs]
                                  for k, vs in ins.items()}, attrs)
    return ({k: [np.asarray(v) for v in vs] for k, vs in jout.items()},
            {k: [v.float().numpy() if v.dtype == torch.bfloat16
                 else v.numpy() for v in vs] for k, vs in pout.items()})


# -- ops ---------------------------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_concat_matches_jax(axis, dtype):
    rs = np.random.RandomState(0)
    xs = [(rs.randn(3, 4, 5) * 10).astype(dtype),
          (rs.randn(3, 4, 5) * 10).astype(dtype)]
    if axis == 1:
        xs[1] = xs[1][:, :2]
    j, p = _both("concat", {"X": xs}, {"axis": axis})
    assert p["Out"][0].dtype == j["Out"][0].dtype
    np.testing.assert_array_equal(p["Out"][0], j["Out"][0])


@pytest.mark.parametrize("dtype,step", [(np.int32, 1.0), (np.int32, 3.0),
                                        (np.float32, 0.5)])
def test_increment_keeps_the_dtype(dtype, step):
    x = np.array([0, 5, 7], dtype)
    j, p = _both("increment", {"X": [x]}, {"step": step})
    assert p["Out"][0].dtype == j["Out"][0].dtype == dtype
    np.testing.assert_array_equal(p["Out"][0], j["Out"][0])
    np.testing.assert_array_equal(p["Out"][0], x + dtype(step))


REDUCE_CASES = [  # dim, keep_dim, reduce_all
    (1, False, False), (-1, False, False), (0, True, False),
    (-2, True, False), (0, False, True), (0, True, True)]


@pytest.mark.parametrize("op", ["reduce_sum", "reduce_mean", "reduce_max",
                                "reduce_min"])
@pytest.mark.parametrize("dim,keep_dim,reduce_all", REDUCE_CASES)
def test_reduce_matches_jax(op, dim, keep_dim, reduce_all):
    x = np.random.RandomState(1).randn(3, 4, 5).astype(np.float32)
    attrs = {"dim": dim, "keep_dim": keep_dim, "reduce_all": reduce_all}
    j, p = _both(op, {"X": [x]}, attrs)
    assert p["Out"][0].shape == j["Out"][0].shape
    assert p["Out"][0].dtype == j["Out"][0].dtype
    np.testing.assert_allclose(p["Out"][0], j["Out"][0], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("op", ["reduce_sum", "reduce_mean", "reduce_max"])
def test_reduce_of_bf16(op):
    """Sum and mean accumulate bf16 in f32 and return f32, max stays
    bf16: 512 addends of about 1.0 would saturate a bf16 sum."""
    x = (1.0 + np.random.RandomState(2).rand(4, 512)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    attrs = {"dim": 1, "keep_dim": False, "reduce_all": False}
    jout = np.asarray(jget(op).kernel(None, {"X": [jx]}, attrs)["Out"][0])
    pout = pget(op).kernel(None, {"X": [torch.from_numpy(x).bfloat16()]},
                           attrs)["Out"][0]
    want_dtype = torch.bfloat16 if op == "reduce_max" else torch.float32
    assert pout.dtype == want_dtype
    assert str(jout.dtype) == str(want_dtype).replace("torch.", "")
    np.testing.assert_allclose(pout.float().numpy(),
                               jout.astype(np.float32), rtol=1e-6)


def test_reduce_of_int_positions_stays_int():
    """The cached step's reduce_max over its int positions."""
    pos = np.array([7, 7, 7], np.int32)
    attrs = {"dim": 0, "keep_dim": False, "reduce_all": True}
    j, p = _both("reduce_max", {"X": [pos]}, attrs)
    assert p["Out"][0].dtype == j["Out"][0].dtype == np.int32
    np.testing.assert_array_equal(p["Out"][0], [7])
    j, p = _both("reduce_sum", {"X": [pos]}, attrs)
    assert p["Out"][0].dtype == j["Out"][0].dtype
    np.testing.assert_array_equal(p["Out"][0], j["Out"][0])


@pytest.mark.parametrize("op", ["concat", "increment", "reduce_sum"])
def test_ragged_inputs_wait_for_a5(op):
    """Ragged inputs to these ops, which the port takes since the
    nested-sequence slice: one sequence of 2 rows, one of 1, and a row
    that pads the values past `nvalid`.  concat along axis 0 gives the
    values dense and reduce_sum over the rows adds the valid rows only,
    both exactly as the JAX kernels do; increment adds to the values and
    keeps the splits, where the JAX kernel raises a TypeError on a
    RaggedTensor (ROADMAP C)."""
    from paddle_tpu.core.ragged import RaggedTensor as JRagged

    vals = np.array([1.0, 2.0, 3.0, 9.0], np.float32)
    splits = np.array([0, 2, 3], np.int32)
    ragged = RaggedTensor(torch.from_numpy(vals), [torch.from_numpy(splits)])
    jragged = JRagged(jnp.asarray(vals), [splits])
    attrs = {"axis": 0, "dim": 0, "step": 1.0}
    out = pget(op).kernel(None, {"X": [ragged]}, attrs)["Out"][0]
    if op == "increment":
        with pytest.raises(TypeError):
            jget(op).kernel(None, {"X": [jragged]}, attrs)
        assert isinstance(out, RaggedTensor) and out.lod() == [[0, 2, 3]]
        np.testing.assert_array_equal(out.values.numpy(), vals + 1.0)
        return
    jout = np.asarray(jget(op).kernel(None, {"X": [jragged]},
                                      attrs)["Out"][0])
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy(), jout)
    if op == "reduce_sum":
        assert jout.tolist() == 6.0


def _attention_inputs(rs, b, h, t, dh):
    d = h * dh
    q, k, v = (rs.randn(b, 1, d).astype(np.float32) for _ in range(3))
    kc, vc = (rs.randn(b, h, t, dh).astype(np.float32) for _ in range(2))
    return q, k, v, kc, vc


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("pos", [0, 3, 8, 9, 12])
def test_cached_attention_step_matches_jax(per_row, pos):
    """One step from filled caches at each position, with Position [1]
    or [batch]; 9 is past the cache (T 9): the write clamps to the last
    slot, as dynamic_update_slice clamps, and every key attends."""
    rs = np.random.RandomState(pos)
    b, h, t, dh = 3, 2, 9, 4
    q, k, v, kc, vc = _attention_inputs(rs, b, h, t, dh)
    position = np.full((b,) if per_row else (1,), pos, np.int32)
    ins = {"Q": [q], "KNew": [k], "VNew": [v], "KCache": [kc],
           "VCache": [vc], "Position": [position]}
    fed = {n: x.copy() for n, x in (("kc", kc), ("vc", vc))}
    torch_ins = {n: [torch.from_numpy(x[0].copy())] for n, x in ins.items()}
    pout = pget("cached_attention").kernel(None, torch_ins,
                                           {"num_heads": h})
    jout = jget("cached_attention").kernel(
        None, {n: [jnp.asarray(x[0])] for n, x in ins.items()},
        {"num_heads": h})
    for slot in ("Out", "KCacheOut", "VCacheOut"):
        got, want = pout[slot][0].numpy(), np.asarray(jout[slot][0])
        assert got.shape == want.shape and got.dtype == want.dtype, slot
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=slot)
    # the fed caches are not written
    np.testing.assert_array_equal(torch_ins["KCache"][0].numpy(), fed["kc"])
    np.testing.assert_array_equal(torch_ins["VCache"][0].numpy(), fed["vc"])


def test_cached_attention_run_t_times_equals_dense_causal():
    """Mirrors tests/test_cached_decode.py: the cache step run T times
    from zero caches equals dense causal attention over the sequence."""
    rs = np.random.RandomState(0)
    b, h, t, dh = 2, 2, 6, 4
    d = h * dh
    q, k, v = (rs.randn(b, t, d).astype(np.float32) for _ in range(3))
    kernel = pget("cached_attention").kernel
    kc = torch.zeros(b, h, t, dh)
    vc = torch.zeros(b, h, t, dh)
    outs = []
    for pos in range(t):
        r = kernel(None, {
            "Q": [torch.from_numpy(q[:, pos:pos + 1])],
            "KNew": [torch.from_numpy(k[:, pos:pos + 1])],
            "VNew": [torch.from_numpy(v[:, pos:pos + 1])],
            "KCache": [kc], "VCache": [vc],
            "Position": [torch.tensor([pos], dtype=torch.int32)]},
            {"num_heads": h})
        kc, vc = r["KCacheOut"][0], r["VCacheOut"][0]
        outs.append(r["Out"][0].numpy())
    got = np.concatenate(outs, axis=1)

    def heads(x):
        return jnp.asarray(x.reshape(b, t, h, dh).transpose(0, 2, 1, 3))

    ref = np.asarray(reference_attention(heads(q), heads(k), heads(v),
                                         None, True))
    ref = ref.transpose(0, 2, 1, 3).reshape(b, t, d)
    np.testing.assert_allclose(got, ref, atol=2e-5)


# -- descs -------------------------------------------------------------------

def _step_programs(tp):
    window = tp.build_transformer_step_program(3, 8, V, n_layer=L,
                                               n_head=H, d_model=D)
    cached = tp.build_transformer_cached_step_program(3, T, V, n_layer=L,
                                                      n_head=H, d_model=D)
    return {"window": window, "cached": cached}


@pytest.mark.parametrize("which", ["window", "cached"])
def test_step_programs_equal_jax(which):
    j = _step_programs(jtp)[which]
    p = _step_programs(ptp)[which]
    assert p[0].desc.to_dict() == j[0].desc.to_dict()
    assert p[1].desc.to_dict() == j[1].desc.to_dict()
    assert p[2].name == j[2].name
    if which == "window":
        assert p[3].name == j[3].name
    else:
        assert p[3] == j[3]


@pytest.mark.parametrize("which", ["window", "cached"])
def test_step_program_parameters_are_the_training_programs(which):
    main, _, _, _ = ptp.build_transformer_program(B, T, V, n_layer=L,
                                                  n_head=H, d_model=D)
    step = _step_programs(ptp)[which][0]
    params = {n for n, v in main.block(0).vars.items() if v.is_parameter}
    step_params = {n for n, v in step.desc.block(0).vars.items()
                   if v.is_parameter}
    assert step_params == params


def _adam_programs(tp, fluid):
    main, startup, loss, _ = tp.build_transformer_program(
        B, T, V, n_layer=L, n_head=H, d_model=D)
    if tp is jtp:
        with fluid.program_guard(main, startup):
            fluid.optimizer.Adam(learning_rate=LR).minimize(loss)
        return main, startup, loss.name
    Adam(learning_rate=LR).minimize(loss, main, startup)
    return main, startup, loss


def test_adam_program_equals_jax():
    jmain, jstartup, _ = _adam_programs(jtp, jfluid)
    pmain, pstartup, _ = _adam_programs(ptp, None)
    assert pmain.to_dict() == jmain.desc.to_dict()
    assert pstartup.to_dict() == jstartup.desc.to_dict()
    types = [op.type for op in pmain.block(0).ops]
    assert types.count("adam") == sum(
        1 for v in pmain.block(0).vars.values() if v.is_parameter)
    assert types[-2:] == ["scale", "scale"]


# -- Adam --------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_adam():
    """(initial state, per-step losses, final state, feeds, the sum over
    the steps of eps / (eps + sqrt(m2)) per parameter) of 6 JAX Adam
    steps."""
    main, startup, loss_name = _adam_programs(jtp, jfluid)
    persist = [n for n, v in main.desc.block(0).vars.items()
               if v.persistable]
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = JScope()
    feeds = [jtp.transformer_program_feeds(B, T, V, seed=s)
             for s in range(ADAM_STEPS)]
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.array(scope.get(n)) for n in persist}
        moments2 = [n for n in persist if n.endswith("_moment2_0")]
        eps_share = {n[:-len("_moment2_0")]: 0.0 for n in moments2}
        losses = []
        for f in feeds:
            out = exe.run(main, feed=f, fetch_list=[loss_name])[0]
            losses.append(float(np.asarray(out).reshape(-1)[0]))
            for n in moments2:
                eps_share[n[:-len("_moment2_0")]] += 1e-8 / (
                    1e-8 + np.sqrt(np.array(scope.get(n))))
        final = {n: np.array(scope.get(n)) for n in persist}
    return init, losses, final, feeds, eps_share


def test_six_adam_steps_match_jax(jax_adam):
    init, jlosses, jfinal, feeds, eps_share = jax_adam
    main, _, loss = _adam_programs(ptp, None)
    persist = {n for n, v in main.block(0).vars.items() if v.persistable}
    assert persist == set(init)
    assert {"beta1_pow_acc_0", "beta2_pow_acc_0"} <= persist
    exe = Executor(CPUPlace())
    scope = Scope()
    io.params_from_numpy(scope, init, "cpu")
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0][0]) for f in feeds]
    np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=0)
    for name, want in jfinal.items():
        got = scope.get(name).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        atol = 1e-5 + LR * eps_share.get(name, 0.0)
        assert np.all(np.abs(got - want) <= atol), \
            (name, float(np.abs(got - want).max()))
    np.testing.assert_allclose(scope.get("beta1_pow_acc_0").numpy(),
                               [0.9 ** (ADAM_STEPS + 1)], rtol=1e-6)
