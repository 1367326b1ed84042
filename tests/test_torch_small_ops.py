"""The small ops this slice adds, each against the JAX package's kernel
on the same numpy inputs made from a seed, run through each package's
executor `apply_op`: the unary activations, the `elementwise_*` family
(with Y broadcast from an axis), `softmax` (f32 and bf16),
`cross_entropy` (hard labels, negative and out-of-range ids, soft
labels), `cast`, `scale`, `sgd` and `momentum` (a bf16 parameter updated
to f32 on both sides); and the tensor layers built through both
packages' `fluid.layers`, whose descs are equal and whose values the
port computes.

Tolerance: float32 at atol 1e-5 (the same f32 arithmetic in other
orders); results of bf16 inputs at 2^-7 relative (about one bf16 ulp:
XLA may keep a fused bf16 intermediate in f32, torch rounds each op's
result); NaN where both sides give NaN.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401 — registers the JAX kernels
from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.fluid import executor as jexec
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.desc import OpDesc
from paddle_tpu_torch.fluid import executor as texec
from paddle_tpu_torch.ops.activation import UNARY

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

ATOL = 1e-5


def _f32(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _run_both(op_type, ins, outs, attrs, bf16=()):
    """{out name: (jax f32 ndarray, torch f32 ndarray, dtype name)} of op
    `op_type` run through both executors; ins {slot: [(name, ndarray)]},
    inputs named in `bf16` as bfloat16."""
    def jval(n, a):
        return jnp.asarray(a, jnp.bfloat16) if n in bf16 else jnp.asarray(a)

    def tval(n, a):
        t = torch.from_numpy(np.array(a))
        return t.to(torch.bfloat16) if n in bf16 else t

    names = {s: [n for n, _ in v] for s, v in ins.items()}
    values = {n: a for v in ins.values() for n, a in v}
    jctx = jexec.ExecContext(None, None, 0,
                             {n: jval(n, a) for n, a in values.items()})
    jexec.apply_op(jctx, JOpDesc(op_type, names, outs, attrs))
    tctx = texec.ExecContext(None, 0,
                             {n: tval(n, a) for n, a in values.items()},
                             device=torch.device("cpu"))
    texec.apply_op(tctx, OpDesc(op_type, names, outs, attrs))
    out = {}
    for n in (n for ns in outs.values() for n in ns):
        j, t = jctx.env[n], tctx.env[n]
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), n
        out[n] = (np.asarray(j, np.float32), t.float().numpy(), str(j.dtype))
    return out


def _check(op_type, ins, outs, attrs, bf16=()):
    for n, (j, t, dtype) in _run_both(op_type, ins, outs, attrs,
                                      bf16).items():
        assert t.shape == j.shape, n
        if dtype == "bfloat16":
            np.testing.assert_allclose(t, j, rtol=2.0 ** -7, atol=2.0 ** -7,
                                       err_msg=n)
        else:
            np.testing.assert_allclose(t, j, atol=ATOL, rtol=0, err_msg=n)


@pytest.mark.parametrize("op_type", sorted(UNARY))
def test_unary_activation(op_type):
    x = _f32(3, 7, seed=1)
    if op_type in ("sqrt", "log"):
        x = np.abs(x) + 0.1
    _check(op_type, {"X": [("x", x)]}, {"Out": ["y"]}, {})


@pytest.mark.parametrize("op_type", [
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow"])
@pytest.mark.parametrize("y_shape,axis", [((2, 3, 4), -1), ((4,), -1),
                                          ((3,), 1), ((2, 3), 0)])
def test_elementwise(op_type, y_shape, axis):
    x, y = _f32(2, 3, 4, seed=2), _f32(*y_shape, seed=3)
    if op_type == "elementwise_pow":
        x, y = np.abs(x) + 0.5, np.clip(y, -2, 2)
    if op_type == "elementwise_div":
        y = np.where(np.abs(y) < 0.2, 0.5, y).astype(np.float32)
    _check(op_type, {"X": [("x", x)], "Y": [("y", y)]}, {"Out": ["o"]},
           {"axis": axis})


@pytest.mark.parametrize("bf16", [False, True])
def test_softmax(bf16):
    _check("softmax", {"X": [("x", 3.0 * _f32(4, 9, seed=4))]},
           {"Out": ["y"]}, {}, bf16=("x",) if bf16 else ())


def test_cross_entropy_hard_labels():
    p = np.abs(_f32(5, 6, seed=5)) + 0.05
    p /= p.sum(axis=1, keepdims=True)
    label = np.array([[0], [5], [-1], [6], [-7]], np.int32)
    got = _run_both("cross_entropy", {"X": [("p", p)], "Label": [
        ("l", label)]}, {"Y": ["y"]}, {"soft_label": False})["y"]
    j, t, _ = got
    assert t.shape == (5, 1)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    assert np.isnan(t[3:]).all() and np.isfinite(t[:3]).all()
    np.testing.assert_allclose(t[:3], j[:3], atol=ATOL, rtol=0)


def test_cross_entropy_soft_labels():
    p = np.abs(_f32(4, 6, seed=6)) + 0.05
    p /= p.sum(axis=1, keepdims=True)
    q = np.abs(_f32(4, 6, seed=7))
    q /= q.sum(axis=1, keepdims=True)
    _check("cross_entropy", {"X": [("p", p)], "Label": [("q", q)]},
           {"Y": ["y"]}, {"soft_label": True})


@pytest.mark.parametrize("out_dtype", ["float32", "int32", "int64",
                                       "bfloat16"])
def test_cast(out_dtype):
    x = 3.0 * _f32(4, 5, seed=8)
    _check("cast", {"X": [("x", x)]}, {"Out": ["y"]},
           {"in_dtype": "float32", "out_dtype": out_dtype})


def test_scale():
    _check("scale", {"X": [("x", _f32(4, 5, seed=9))]}, {"Out": ["y"]},
           {"scale": -0.75})


@pytest.mark.parametrize("bf16", [False, True])
def test_sgd_and_momentum(bf16):
    p, g, v = _f32(6, 3, seed=10), _f32(6, 3, seed=11), _f32(6, 3, seed=12)
    lr = np.array([0.1], np.float32)
    low = ("p", "v") if bf16 else ()
    _check("sgd", {"Param": [("p", p)], "Grad": [("g", g)],
                   "LearningRate": [("lr", lr)]}, {"ParamOut": ["p2"]}, {},
           bf16=low)
    for nesterov in (False, True):
        out = _run_both("momentum", {
            "Param": [("p", p)], "Grad": [("g", g)], "Velocity": [("v", v)],
            "LearningRate": [("lr", lr)]},
            {"ParamOut": ["p2"], "VelocityOut": ["v2"]},
            {"mu": 0.9, "use_nesterov": nesterov}, bf16=low)
        # a bf16 parameter updates to f32, as the JAX side promotes.  From
        # bf16 state the results agree to a bf16 ulp (2^-8 relative), not
        # f32's: XLA keeps the bf16 product mu * v in f32 inside its fused
        # update (excess precision), the port rounds it to bf16 as each
        # torch op does
        assert out["p2"][2] == "float32"
        for j, t, _ in out.values():
            if bf16:
                np.testing.assert_allclose(t, j, rtol=2.0 ** -7,
                                           atol=2.0 ** -7)
            else:
                np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


def _tensor_layers(fluid):
    x = fluid.layers.data(name="x", shape=[3], dtype="float32")
    g = fluid.layers.create_global_var([3], 0.5, "float32",
                                       persistable=True, name="g")
    one = fluid.layers.ones([1], "float32")
    zero = fluid.layers.zeros([1], "float32")
    s = fluid.layers.sums([x, fluid.layers.elementwise_add(x, g)])
    s = fluid.layers.elementwise_add(s, fluid.layers.elementwise_sub(
        one, zero))
    i = fluid.layers.cast(fluid.layers.scale(s, scale=2.0), "int32")
    y = fluid.layers.reshape(fluid.layers.cast(i, "float32"), [-1],
                             act="relu")
    return fluid.layers.mean(y.astype("float32") ** 2.0)


def test_tensor_layers_equal_jax_and_run():
    progs = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            out = _tensor_layers(fluid)
        progs.append((main, startup, out))
    (jmain, jstartup, _), (tmain, tstartup, tout) = progs
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    assert tstartup.desc.to_dict() == jstartup.desc.to_dict()
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(tstartup, scope=scope)
    x = np.array([[1.0, -2.0, 0.25], [0.0, 3.0, -0.5]], np.float32)
    got = exe.run(tmain, feed={"x": x}, fetch_list=[tout], scope=scope)[0]
    want = np.mean(np.maximum(np.trunc((2 * x + 0.5 + 1.0) * 2.0), 0) ** 2)
    np.testing.assert_allclose(got, [want], rtol=1e-6)


def test_grad_op_appended_through_the_builder_mirrors_its_vars():
    """A grad op appended with `append_op` takes X@GRAD's meta from X, as
    the JAX side's `_grad_op_infer_shape` does."""
    prog = tfluid.Program()
    block = prog.global_block()
    x = block.create_var(name="x", shape=[-1, 4], dtype="float32")
    w = block.create_var(name="w", shape=[4, 2], dtype="float32")
    gx = block.create_var(name="x@GRAD")
    gw = block.create_var(name="w@GRAD", dtype="int32")
    block.append_op(type="mul_grad", inputs={"X": [x], "Y": [w]},
                    outputs={"X@GRAD": [gx], "Y@GRAD": [gw]})
    assert (gx.shape, gx.dtype) == ((-1, 4), "float32")
    assert (gw.shape, gw.dtype) == ((4, 2), "float32")
