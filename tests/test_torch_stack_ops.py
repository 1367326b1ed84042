"""The op types of the optimizer and layer stack's slice, `nets.glu`,
`nets.scaled_dot_product_attention` and the v2 layers they let in: the
port against the JAX package, on the CPU, on inputs made from a numpy
seed.

- Every case of `chip_smoke.stack_op_cases()` (which phase 15a also runs
  on the card): each op through both executors' `apply_op`, and its
  grad (the port's generic vjp, or `gather`'s own kernel, against the
  JAX generic vjp) with the same output grads.  The activations run over
  `chip_smoke.STACK_TIES`, the points where `jnp.clip`, `jnp.maximum`,
  `jnp.where` and `jnp.abs` have ties; `gather`, `scatter` and
  `multiplex` take negative, repeated and out-of-range ids; `one_hot`
  out-of-range, negative and ragged ones.  Outputs that only move or
  make values equal the JAX package's exactly (NaN for NaN, the same
  dtype); the rest and every grad within F32_ATOL of the larger of 1
  and the reference's magnitude (the same f32 arithmetic in other
  orders and other libm).
- The ties by hand: `clip`'s grad is half at a bound, `abs`' grad 1 at
  0 (a fault of the port's `abs` before this slice: `torch.abs`'
  grad there is 0), `scatter` lets the last of a repeated id win and
  gives it alone the grad, `gather`'s grad repeats bit for bit.
- `fused_update` against the unfused ops over the same stack, SGD,
  Momentum and Adam, dense and with a SelectedRows grad: the same bits.
- tests/test_nets_attention.py's three cases through the port, and
  `glu`; their descs equal the JAX package's.
- The v2 layers that this slice lets in (`trans_full_matrix_projection`,
  `slice_projection`, `row_l2_norm`, `clip`, `factorization_machine`,
  `cross_channel_norm`, `pad`, and `l2_distance`, `crop`, `prelu`,
  `multiplex`, `smooth_l1_cost`): descs equal and the output equal to
  the JAX package's from one state.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401 — registers the JAX kernels
import paddle_tpu.v2 as jv2
from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.ragged import RaggedTensor as JRagged
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.fluid import executor as jexec
from paddle_tpu.fluid import nets as jnets
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.v2 as tv2
from paddle_tpu_torch.core.desc import OpDesc
from paddle_tpu_torch.core.ragged import RaggedTensor
from paddle_tpu_torch.fluid import executor as texec
from paddle_tpu_torch.fluid import nets as tnets
from paddle_tpu_torch.ops.registry import registered_ops

import chip_smoke
from test_nets_attention import _np_attention

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
EMPTY = "@EMPTY@"
F32_ATOL = 1e-5

CASES = chip_smoke.stack_op_cases()

NEW_OPS = [
    "matmul", "squared_l2_norm", "l1_norm", "minus", "squared_l2_distance",
    "assign", "assign_value", "fill", "fill_zeros_like", "clip",
    "clip_by_norm", "expand", "gather", "scatter", "pad", "crop",
    "multiplex", "is_empty", "shape", "brelu", "ceil", "elu", "floor",
    "hard_shrink", "hard_sigmoid", "leaky_relu", "logsigmoid", "pow",
    "reciprocal", "relu6", "round", "soft_relu", "softplus", "softshrink",
    "softsign", "stanh", "swish", "tanh_shrink", "thresholded_relu",
    "prelu", "one_hot", "norm", "smooth_l1_loss", "fused_update"]


def _jax_value(v):
    if isinstance(v, RaggedTensor):
        return JRagged(jnp.asarray(v.values.numpy()),
                       [s.numpy() for s in v.row_splits],
                       nvalid=int(v.nvalid), max_seqlen=v.max_seqlen)
    return jnp.asarray(v.numpy())


def _run(op_type, ins, outs, attrs):
    """{output name: (JAX value, port value)} of op `op_type` through
    both executors' apply_op; ins {slot: [(name, CPU value or None)]}."""
    names = {s: [n if v is not None else EMPTY for n, v in vals]
             for s, vals in ins.items()}
    env = {n: v for vals in ins.values() for n, v in vals if v is not None}
    jctx = jexec.ExecContext(None, None, 0,
                             {n: _jax_value(v) for n, v in env.items()})
    jexec.apply_op(jctx, JOpDesc(op_type, names, outs, attrs))
    tctx = texec.ExecContext(None, 0, dict(env), device=torch.device("cpu"))
    texec.apply_op(tctx, OpDesc(op_type, names, outs, attrs))
    return {n: (jctx.env[n], tctx.env[n])
            for ns in outs.values() for n in ns}


def _host(v):
    lod = None
    if isinstance(v, (JRagged, RaggedTensor)):
        lod = v.lod()
        v = v.values
    return (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)), lod


def _compare(pairs, exact):
    for n, (j, t) in pairs.items():
        (jv, jlod), (tv, tlod) = _host(j), _host(t)
        assert tlod == jlod, n
        assert tv.shape == jv.shape, (n, tv.shape, jv.shape)
        assert tv.dtype == jv.dtype, (n, tv.dtype, jv.dtype)
        if exact or not np.issubdtype(jv.dtype, np.floating):
            np.testing.assert_array_equal(tv, jv, err_msg=n)
            continue
        finite = np.abs(jv[np.isfinite(jv)])
        scale = max(1.0, float(finite.max()) if finite.size else 1.0)
        np.testing.assert_allclose(tv, jv, atol=F32_ATOL * scale, rtol=0,
                                   err_msg=n)


def _grad_pairs(case):
    """The grad op's outputs of one case through both packages."""
    _, op, ins, outs, attrs, diff, out_grads, _ = case
    ref = _run(op, ins, outs, attrs)
    gins = dict(ins)
    for slot, names in outs.items():
        gins["O@" + slot] = [(n, None) for n in names]
        gins["OG@" + slot] = [
            (n + "@GRAD", out_grads[slot] if slot in out_grads
             else torch.zeros(ref[n][1].shape, dtype=torch.float32))
            for n in names]
    gouts = {s + "@GRAD": ["%s@GRAD" % n for n, _ in ins[s]] for s in diff}
    return _run(op + "_grad", gins, gouts, attrs)


def test_the_port_registers_the_new_op_types():
    # 161 since the observability slice's isfinite and count_nonfinite,
    # 163 since the parameter-server slice's split_selected_rows and
    # dist_send, 178 since the entry-point slice's ops/nn.py (5 types),
    # conv2d_transpose, 6 losses and 3 metrics, 210 since A10's last op
    # groups (ops/conv.py's other 10, ops/v2_extra.py's 12,
    # ops/detection.py's 6, feed, fetch, save and load), 211 since the
    # program analysis slice's fused_elemwise_chain, 212 since the mesh
    # slice's get_places, 213 (all of the JAX registry's) since the
    # recompute slice's recompute_barrier
    assert len(NEW_OPS) == 44
    ops = set(registered_ops())
    assert set(NEW_OPS) <= ops and len(ops) == 213
    assert {c[1] for c in CASES} >= set(NEW_OPS) - {"fused_update"}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    _, op, ins, outs, attrs, _, _, exact = case
    _compare(_run(op, ins, outs, attrs), exact)


GRAD_CASES = [c for c in CASES if c[5]]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_grad_matches_jax(case):
    _compare(_grad_pairs(case), False)


# -- the ties and repeated ids by hand ----------------------------------------

def _grad_of(op, x, attrs, slot="X"):
    case = (op, op, {slot: [("x", torch.tensor(x))]}, {"Out": ["o"]}, attrs,
            [slot], {"Out": torch.ones(len(x))}, False)
    pairs = _grad_pairs(case)
    (j, t), = pairs.values()
    return np.asarray(j), t.numpy()


def test_clip_grad_is_half_at_a_bound():
    """jnp.clip's grad at [0, 1, 6, -1] into [0, 6]: [0.5, 1, 0.5, 0]
    (torch.clamp's would be [1, 1, 1, 0])."""
    j, t = _grad_of("clip", [0.0, 1.0, 6.0, -1.0], {"min": 0.0, "max": 6.0})
    np.testing.assert_array_equal(j, [0.5, 1.0, 0.5, 0.0])
    np.testing.assert_array_equal(t, j)
    for op, attrs, x, want in (
            ("relu6", {}, [0.0, 6.0, 3.0], [0.5, 0.5, 1.0]),
            ("brelu", {"t_min": 0.0, "t_max": 24.0}, [0.0, 24.0],
             [0.5, 0.5]),
            ("hard_sigmoid", {}, [-2.5, 2.5, 0.0], [0.1, 0.1, 0.2])):
        j, t = _grad_of(op, x, attrs)
        np.testing.assert_allclose(j, want, rtol=1e-6)
        np.testing.assert_array_equal(t, j)


def test_abs_grad_at_zero_is_one():
    """`jnp.abs`' grad at 0 and -0.0 is 1; `torch.abs`' is 0, which the
    port's `abs` gave before this slice.  The value at -0.0 stays +0.0."""
    j, t = _grad_of("abs", [0.0, -0.0, 2.0, -2.0], {})
    np.testing.assert_array_equal(j, [1.0, 1.0, 1.0, -1.0])
    np.testing.assert_array_equal(t, j)
    (_, out), = _run("abs", {"X": [("x", torch.tensor([-0.0]))]},
                     {"Out": ["o"]}, {}).values()
    assert not torch.signbit(out).any()
    (j, t), = _run("sigmoid_cross_entropy_with_logits_grad", {
        "X": [("x", torch.tensor([0.0, 1.0]))],
        "Label": [("l", torch.tensor([1.0, 0.0]))],
        "O@Out": [("o", None)],
        "OG@Out": [("o@GRAD", torch.ones(2))]},
        {"X@GRAD": ["x@GRAD"]}, {}).values()
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-7)


def test_scatter_last_update_wins_and_takes_the_grad():
    """Rows [1, 1, 2] set from [a, b, c] leave b in row 1 (the JAX
    package's result on the CPU); the grad goes to b alone."""
    ref, upd = torch.zeros(4, 2), torch.arange(6.0).reshape(3, 2)
    ins = {"Ref": [("r", ref)], "Index": [("i", torch.tensor([1, 1, 2]))],
           "Updates": [("u", upd)]}
    (j, t), = _run("scatter", ins, {"Out": ["o"]}, {}).values()
    np.testing.assert_array_equal(t.numpy(), [[0, 0], [2, 3], [4, 5],
                                              [0, 0]])
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    case = ("s", "scatter", ins, {"Out": ["o"]}, {}, ["Ref", "Updates"],
            {"Out": torch.arange(8.0).reshape(4, 2)}, True)
    pairs = _grad_pairs(case)
    _compare(pairs, True)
    np.testing.assert_array_equal(pairs["u@GRAD"][1].numpy(),
                                  [[0, 0], [2, 3], [4, 5]])


def test_gather_out_of_range_row_is_nan_and_its_grad_repeats():
    """An id outside [-n, n) gives a NaN row and adds nothing to the
    grad; the grad of a repeated id sums its rows in a fixed order, so
    two runs give the same bits."""
    case = next(c for c in CASES if c[0] == "gather")
    (j, t), = _run(*case[1:5]).values()
    assert np.isnan(t.numpy()[[3, 4]]).all()
    assert np.isfinite(t.numpy()[[0, 1, 2, 5, 6, 7]]).all()
    a, b = (_grad_pairs(case)["x@GRAD"][1] for _ in range(2))
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# -- fused_update --------------------------------------------------------------

@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("op", sorted(chip_smoke.STACK_FUSED))
def test_fused_update_gives_the_unfused_bits(op, sparse):
    """`fused_update` over a stack of 3 parameters of different shapes
    (phase 15a's check, here on the CPU) against the unfused op run per
    parameter: every output bit for bit; with a SelectedRows grad, the
    recipe per parameter."""
    differ, n = chip_smoke.stack_fused_differ(op, sparse,
                                              torch.device("cpu"))
    assert n >= 3 and differ == []


# -- nets ------------------------------------------------------------------------

def _attention_prog(fluid, nets, b, tq, tk, d, heads, use_flash=False,
                    dynamic=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        if dynamic:
            q = k = v = fluid.layers.data(name="x", shape=[tq, d],
                                          dtype="float32")
        else:
            q, k, v = (fluid.layers.data(name=n, shape=[b, t, d],
                                         dtype="float32",
                                         append_batch_size=False)
                       for n, t in (("q", tq), ("k", tk), ("v", tk)))
        ctx = nets.scaled_dot_product_attention(q, k, v, num_heads=heads,
                                                use_flash=use_flash)
    return main, startup, ctx


def _run_port(main, startup, feed, fetch):
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    return exe.run(main, feed=feed, fetch_list=fetch, scope=scope)


def test_scaled_dot_product_attention_matches_numpy():
    """tests/test_nets_attention.py:30 through the port, at 1 and 2
    heads; the descs equal the JAX package's."""
    b, tq, tk, d = 2, 3, 5, 8
    rs = np.random.RandomState(0)
    feed = {n: rs.randn(b, t, d).astype(np.float32)
            for n, t in (("q", tq), ("k", tk), ("v", tk))}
    for heads in (1, 2):
        j = _attention_prog(jfluid, jnets, b, tq, tk, d, heads)
        t = _attention_prog(tfluid, tnets, b, tq, tk, d, heads)
        assert t[0].desc.to_dict() == j[0].desc.to_dict()
        out, = _run_port(t[0], t[1], feed, [t[2]])
        np.testing.assert_allclose(
            out, _np_attention(feed["q"], feed["k"], feed["v"], heads),
            rtol=2e-5, atol=2e-6)


def test_scaled_dot_product_attention_dynamic_batch():
    """tests/test_nets_attention.py:56: a -1 batch dim."""
    tq, d, heads = 3, 8, 2
    xn = np.random.RandomState(1).randn(4, tq, d).astype(np.float32)
    j = _attention_prog(jfluid, jnets, None, tq, tq, d, heads, dynamic=True)
    t = _attention_prog(tfluid, tnets, None, tq, tq, d, heads, dynamic=True)
    assert t[0].desc.to_dict() == j[0].desc.to_dict()
    out, = _run_port(t[0], t[1], {"x": xn}, [t[2]])
    np.testing.assert_allclose(out, _np_attention(xn, xn, xn, heads),
                               rtol=2e-5, atol=2e-6)


def test_scaled_dot_product_attention_flash_path():
    """tests/test_nets_attention.py:74: use_flash=True is one
    flash_attention op and agrees with the dense route (cross-attention
    shapes, 1 and 2 heads); it refuses dropout."""
    b, tq, tk, d = 2, 4, 6, 8
    rs = np.random.RandomState(3)
    feed = {n: rs.randn(b, t, d).astype(np.float32)
            for n, t in (("q", tq), ("k", tk), ("v", tk))}
    for heads in (1, 2):
        dense = _attention_prog(tfluid, tnets, b, tq, tk, d, heads)
        flash = _attention_prog(tfluid, tnets, b, tq, tk, d, heads,
                                use_flash=True)
        jflash = _attention_prog(jfluid, jnets, b, tq, tk, d, heads,
                                 use_flash=True)
        assert flash[0].desc.to_dict() == jflash[0].desc.to_dict()
        assert [op.type for op in flash[0].desc.block(0).ops] == \
            ["flash_attention"]
        a, = _run_port(dense[0], dense[1], feed, [dense[2]])
        f, = _run_port(flash[0], flash[1], feed, [flash[2]])
        np.testing.assert_allclose(a, f, rtol=2e-5, atol=2e-6)
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        q = tfluid.layers.data(name="q", shape=[b, tq, d], dtype="float32",
                               append_batch_size=False)
        with pytest.raises(ValueError, match="dropout"):
            tnets.scaled_dot_product_attention(q, q, q, num_heads=2,
                                               dropout_rate=0.1,
                                               use_flash=True)


def test_glu_matches_jax():
    """glu: split in two along the last dim, the first half times the
    sigmoid of the second; desc and value equal the JAX package's."""
    xn = np.random.RandomState(4).randn(3, 8).astype(np.float32)

    def build(fluid, nets):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            out = nets.glu(x)
        return main, startup, out

    j, t = build(jfluid, jnets), build(tfluid, tnets)
    assert t[0].desc.to_dict() == j[0].desc.to_dict()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jout, = jexe.run(j[0], feed={"x": xn}, fetch_list=[j[2]],
                     scope=JScope())
    tout, = _run_port(t[0], t[1], {"x": xn}, [t[2]])
    np.testing.assert_allclose(tout, np.asarray(jout), atol=1e-6)
    np.testing.assert_allclose(
        tout, xn[:, :4] / (1 + np.exp(-xn[:, 4:])), rtol=1e-5)


# -- the v2 layers --------------------------------------------------------------

def _v2_layer(v2, fluid, name):
    """One topology of layer `name` over dense inputs (an image [B, 2, 3,
    3] for the image layers); (output, feed)."""
    L, dt = v2.layer, v2.data_type
    rs = np.random.RandomState(6)
    x = L.data(name="x", type=dt.dense_vector(6))
    feed = {"x": rs.randn(4, 6).astype(np.float32)}
    if name == "trans_full_matrix_projection":
        out = L.mixed(size=3, input=[L.trans_full_matrix_projection(x, 3)])
    elif name == "slice_projection":
        out = L.mixed(size=4, input=[L.slice_projection(x, [(0, 2),
                                                            (3, 5)])])
    elif name == "row_l2_norm":
        out = L.row_l2_norm(x)
    elif name == "clip":
        out = L.clip(x, min=-0.5, max=0.5)
    elif name == "factorization_machine":
        out = L.factorization_machine(x, factor_size=3)
    elif name in ("cross_channel_norm", "pad", "crop"):
        img = L.data(name="img", type=dt.dense_vector(2 * 3 * 3))
        img4 = fluid.layers.reshape(x=img, shape=[-1, 2, 3, 3])
        feed = {"img": rs.randn(4, 18).astype(np.float32)}
        out = {"cross_channel_norm": lambda: L.cross_channel_norm(img4),
               "pad": lambda: L.pad(img4, pad_c=[1, 0], pad_h=[0, 2]),
               "crop": lambda: L.crop(img4, shape=[4, 1, 2, 2],
                                      offsets=[0, 1, 1, 0])}[name]()
    elif name == "l2_distance":
        y = L.data(name="y", type=dt.dense_vector(6))
        feed["y"] = rs.randn(4, 6).astype(np.float32)
        out = L.l2_distance(x, y)
    elif name == "prelu":
        out = L.prelu(x)
    elif name == "multiplex":
        y = L.data(name="y", type=dt.dense_vector(6))
        i = L.data(name="i", type=dt.integer_value(2))
        feed["y"] = rs.randn(4, 6).astype(np.float32)
        feed["i"] = np.array([[0], [1], [1], [0]], np.int64)
        out = L.multiplex([i, x, y])
    elif name == "smooth_l1_cost":
        y = L.data(name="y", type=dt.dense_vector(6))
        feed["y"] = rs.randn(4, 6).astype(np.float32)
        out = L.smooth_l1_cost(x, y)
    return out, feed


V2_NAMES = ["trans_full_matrix_projection", "slice_projection",
            "row_l2_norm", "clip", "factorization_machine",
            "cross_channel_norm", "pad", "l2_distance", "crop", "prelu",
            "multiplex", "smooth_l1_cost"]


def _v2_build(v2, fluid, name):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        out, feed = _v2_layer(v2, fluid, name)
    return main, startup, out, feed


@pytest.mark.parametrize("name", V2_NAMES)
def test_v2_layer_matches_jax(name):
    """The layer builds (it no longer raises naming ROADMAP A5 or A10),
    its desc equals the JAX package's, and its output from the JAX
    startup's state equals the JAX package's."""
    jmain, jstart, jout, feed = _v2_build(jv2, jfluid, name)
    tmain, tstart, tout, _ = _v2_build(tv2, tfluid, name)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    assert tstart.desc.to_dict() == jstart.desc.to_dict()
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    state = {n: np.asarray(jscope.get(n))
             for n, vd in tstart.desc.block(0).vars.items()
             if vd.persistable}
    j, = jexe.run(jmain, feed=feed, fetch_list=[jout], scope=jscope)
    tscope = tfluid.Scope()
    tfluid.io.params_from_numpy(tscope, state, "cpu")
    t, = tfluid.Executor(CPU).run(tmain, feed=feed, fetch_list=[tout],
                                  scope=tscope)
    assert t.shape == np.asarray(j).shape
    np.testing.assert_allclose(t, np.asarray(j), atol=1e-5, rtol=1e-5)


def test_factorization_machine_builds_and_trains():
    """factorization_machine (its matmul's layer waited with ROADMAP A5)
    builds, runs and takes an SGD step through the port."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        out, feed = _v2_layer(tv2, tfluid, "factorization_machine")
        loss = tfluid.layers.mean(x=tfluid.layers.square(out))
        tfluid.optimizer.SGD(learning_rate=1e-3).minimize(loss)
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    first, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    second, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert out.shape == (-1, 1) and np.isfinite(first).all()
    assert float(second[0]) < float(first[0])
