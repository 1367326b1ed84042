"""The ResNet op set in the port against the JAX package's kernels, on
the same numpy inputs made from a seed, each op run through its
package's executor `apply_op`: `conv2d` (groups, strides, padding,
dilation, NHWC) and its generic grad, `pool2d` (max and average,
exclusive counts, global pooling, padding beyond half the window) and
its generic grad with tied maxima, `batch_norm` (train and test, f32
and bf16, NCHW and NHWC, shifted statistics) and the closed-form
`batch_norm_grad` (every output slot, the statistic cotangents), and the
bf16 policy of `mul`, `conv2d` and the elementwise ops.

Tolerances: float32 at atol 2e-5 (the same f32 arithmetic in other
orders: oneDNN against XLA's CPU convolution, sums of up to 200
products of magnitude 1); bfloat16 at 2 ulps of the output's magnitude
(rtol 2^-7 and atol 2^-7 times the largest entry: the two packages
round products and sums to bf16 at the same points but accumulate in
other orders, and a difference of 1 ulp in a rounded input moves the
output by about 1 ulp); the max-pool grad exactly (each window's grad
goes to its first largest element on both sides).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401 — registers the JAX kernels
from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.fluid import amp as jamp
from paddle_tpu.fluid import executor as jexec
from paddle_tpu.utils import flags as jflags
from paddle_tpu_torch.core.desc import OpDesc
from paddle_tpu_torch.fluid import amp as tamp
from paddle_tpu_torch.fluid import executor as texec
from paddle_tpu_torch.utils import flags as tflags

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

ATOL = 2e-5
EMPTY = "@EMPTY@"


def _f32(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _to_jax(a, bf16):
    return jnp.asarray(a, jnp.bfloat16) if bf16 else jnp.asarray(a)


def _to_torch(a, bf16):
    t = torch.from_numpy(np.array(a))
    return t.to(torch.bfloat16) if bf16 else t


def _apply_both(op_type, ins, outs, attrs, bf16=()):
    """Run op `op_type` through both executors' apply_op.  ins: {slot:
    [(name, ndarray or None)]}, None for an `@EMPTY@` input; outs: {slot:
    [name]}; inputs named in `bf16` go in as bfloat16.  Returns {slot:
    [(jax f32 ndarray, torch f32 ndarray, torch dtype)]}."""
    names = {s: [n if a is not None else EMPTY for n, a in v]
             for s, v in ins.items()}
    values = {n: a for v in ins.values() for n, a in v if a is not None}
    jctx = jexec.ExecContext(None, None, 0, {
        n: _to_jax(a, n in bf16) for n, a in values.items()})
    jexec.apply_op(jctx, JOpDesc(op_type, names, outs, attrs))
    tctx = texec.ExecContext(
        None, 0, {n: _to_torch(a, n in bf16) for n, a in values.items()},
        device=torch.device("cpu"))
    texec.apply_op(tctx, OpDesc(op_type, names, outs, attrs))
    pairs = {}
    for slot, out_names in outs.items():
        pairs[slot] = []
        for n in out_names:
            j, t = jctx.env[n], tctx.env[n]
            assert str(t.dtype).replace("torch.", "") == str(j.dtype), \
                (n, t.dtype, j.dtype)
            pairs[slot].append((np.asarray(j, np.float32),
                                t.float().numpy(), t.dtype))
    return pairs


def _check(op_type, ins, outs, attrs, bf16=(), atol=ATOL):
    pairs = _apply_both(op_type, ins, outs, attrs, bf16)
    for slot, ps in pairs.items():
        for j, t, dtype in ps:
            assert t.shape == j.shape, (slot, t.shape, j.shape)
            if dtype == torch.bfloat16:
                scale = 2.0 ** -7
                np.testing.assert_allclose(
                    t, j, rtol=scale, atol=scale * np.abs(j).max(),
                    err_msg=slot)
            else:
                np.testing.assert_allclose(t, j, atol=atol, rtol=0,
                                           err_msg=slot)
    return pairs


# -- conv2d ------------------------------------------------------------------

CONV_CASES = [  # (N, C, H, W), O, k, stride, pad, dilation, groups, layout
    ((2, 4, 9, 9), 6, 3, 1, 0, 1, 1, "NCHW"),
    ((2, 4, 9, 9), 6, 3, 2, 1, 1, 2, "NCHW"),
    ((2, 4, 10, 10), 4, 3, 1, 2, 2, 1, "NCHW"),
    ((2, 3, 16, 16), 8, 7, 2, 3, 1, 1, "NCHW"),
    ((2, 4, 9, 9), 6, 5, 2, 2, 1, 1, "NHWC"),
    ((2, 3, 8, 8), 6, 1, 2, 0, 1, 3, "NHWC"),
]


def _conv_inputs(shape, o, k, groups, layout):
    x = _f32(*shape, seed=1)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = _f32(o, shape[1] // groups, k, k, seed=2) * 0.2
    return x, w


def _conv_attrs(stride, pad, dilation, groups, layout):
    return {"strides": [stride, stride], "paddings": [pad, pad],
            "dilations": [dilation, dilation], "groups": groups,
            "data_layout": layout}


@pytest.mark.parametrize("shape,o,k,stride,pad,dilation,groups,layout",
                         CONV_CASES)
def test_conv2d(shape, o, k, stride, pad, dilation, groups, layout):
    x, w = _conv_inputs(shape, o, k, groups, layout)
    _check("conv2d", {"Input": [("x", x)], "Filter": [("w", w)]},
           {"Output": ["y"]},
           _conv_attrs(stride, pad, dilation, groups, layout))


@pytest.mark.parametrize("shape,o,k,stride,pad,dilation,groups,layout",
                         CONV_CASES[1:5])
def test_conv2d_grad(shape, o, k, stride, pad, dilation, groups, layout):
    x, w = _conv_inputs(shape, o, k, groups, layout)
    attrs = _conv_attrs(stride, pad, dilation, groups, layout)
    y = _apply_both("conv2d", {"Input": [("x", x)], "Filter": [("w", w)]},
                    {"Output": ["y"]}, attrs)["Output"][0][0]
    dy = _f32(*y.shape, seed=3)
    _check("conv2d_grad",
           {"Input": [("x", x)], "Filter": [("w", w)],
            "O@Output": [("y", y)], "OG@Output": [("dy", dy)]},
           {"Input@GRAD": ["dx"], "Filter@GRAD": ["dw"]}, attrs,
           atol=1e-4)


def test_conv2d_empty_output_raises_on_both_sides():
    x, w = _f32(1, 2, 3, 3), _f32(4, 2, 5, 5)
    for apply_op, ctx, desc in (
            (jexec.apply_op,
             jexec.ExecContext(None, None, 0, {"x": jnp.asarray(x),
                                               "w": jnp.asarray(w)}),
             JOpDesc),
            (texec.apply_op,
             texec.ExecContext(None, 0, {"x": torch.from_numpy(x),
                                         "w": torch.from_numpy(w)}),
             OpDesc)):
        with pytest.raises((ValueError, RuntimeError)):
            apply_op(ctx, desc("conv2d", {"Input": ["x"], "Filter": ["w"]},
                               {"Output": ["y"]}, {}))


# -- pool2d ------------------------------------------------------------------

POOL_CASES = [  # type, (N, C, H, W), k, stride, pad, exclusive, global, layout
    ("max", (2, 3, 9, 9), 3, 2, 1, True, False, "NCHW"),
    ("max", (2, 3, 8, 8), 2, 2, 0, True, False, "NCHW"),
    ("max", (2, 3, 9, 9), 3, 1, 2, True, False, "NCHW"),
    ("max", (2, 3, 9, 7), 3, 2, 1, True, False, "NHWC"),
    ("avg", (2, 3, 9, 9), 3, 2, 1, True, False, "NCHW"),
    ("avg", (2, 3, 9, 9), 3, 2, 1, False, False, "NCHW"),
    ("avg", (2, 3, 9, 9), 3, 1, 2, True, False, "NCHW"),
    ("avg", (2, 3, 8, 8), 2, 2, 0, True, False, "NHWC"),
    ("avg", (2, 5, 7, 7), 7, 1, 0, True, True, "NCHW"),
    ("avg", (2, 7, 5, 5), 2, 3, 1, True, True, "NHWC"),
    ("max", (2, 5, 7, 7), 3, 1, 0, True, True, "NCHW"),
]


def _pool_attrs(ptype, k, stride, pad, exclusive, global_pooling, layout):
    return {"pooling_type": ptype, "ksize": [k, k],
            "strides": [stride, stride], "paddings": [pad, pad],
            "exclusive": exclusive, "global_pooling": global_pooling,
            "ceil_mode": False, "data_layout": layout}


@pytest.mark.parametrize("ptype,shape,k,stride,pad,exclusive,gp,layout",
                         POOL_CASES)
def test_pool2d(ptype, shape, k, stride, pad, exclusive, gp, layout):
    _check("pool2d", {"X": [("x", _f32(*shape, seed=4))]}, {"Out": ["y"]},
           _pool_attrs(ptype, k, stride, pad, exclusive, gp, layout))


@pytest.mark.parametrize("ptype,shape,k,stride,pad,exclusive,gp,layout",
                         POOL_CASES)
def test_pool2d_bf16(ptype, shape, k, stride, pad, exclusive, gp, layout):
    _check("pool2d", {"X": [("x", _f32(*shape, seed=4))]}, {"Out": ["y"]},
           _pool_attrs(ptype, k, stride, pad, exclusive, gp, layout),
           bf16=("x",))


def _relu_with_ties(shape, seed):
    """A relu's output: about half the entries 0, so whole windows tie
    at 0, and some positive entries repeated so positive maxima tie
    too."""
    x = np.maximum(_f32(*shape, seed=seed), 0.0)
    x[..., ::3, 1::4] = 0.5
    x[0, 0, :4, :4] = 0.0
    return x


@pytest.mark.parametrize("k,stride,pad", [(3, 2, 1), (2, 2, 0), (3, 1, 1),
                                          (3, 1, 2)])
def test_max_pool_grad_with_tied_maxima(k, stride, pad):
    x = _relu_with_ties((2, 3, 10, 10), seed=5)
    attrs = _pool_attrs("max", k, stride, pad, True, False, "NCHW")
    y = _apply_both("pool2d", {"X": [("x", x)]}, {"Out": ["y"]},
                    attrs)["Out"][0][0]
    dy = _f32(*y.shape, seed=6)
    (j, t, _), = _apply_both(
        "pool2d_grad", {"X": [("x", x)], "O@Out": [("y", y)],
                        "OG@Out": [("dy", dy)]},
        {"X@GRAD": ["dx"]}, attrs)["X@GRAD"]
    np.testing.assert_array_equal(t, j)
    assert (x == 0).mean() > 0.3


@pytest.mark.parametrize("ptype,exclusive", [("avg", True), ("avg", False)])
def test_avg_pool_grad(ptype, exclusive):
    x = _f32(2, 3, 9, 9, seed=7)
    attrs = _pool_attrs(ptype, 3, 2, 1, exclusive, False, "NCHW")
    y = _apply_both("pool2d", {"X": [("x", x)]}, {"Out": ["y"]},
                    attrs)["Out"][0][0]
    _check("pool2d_grad", {"X": [("x", x)], "O@Out": [("y", y)],
                           "OG@Out": [("dy", _f32(*y.shape, seed=8))]},
           {"X@GRAD": ["dx"]}, attrs)


# -- batch_norm --------------------------------------------------------------

def _bn_inputs(shape, layout, seed=9):
    c = shape[1] if layout == "NCHW" else shape[-1]
    x = _f32(*shape, seed=seed) * 2.0 + 0.5
    return {"X": [("x", x)],
            "Scale": [("scale", 1.0 + 0.1 * _f32(c, seed=seed + 1))],
            "Bias": [("bias", 0.1 * _f32(c, seed=seed + 2))],
            "Mean": [("mean", 0.1 * _f32(c, seed=seed + 3))],
            "Variance": [("var", 1.0 + 0.1 * np.abs(_f32(c, seed=seed + 4)))]}


BN_OUTS = {"Y": ["y"], "MeanOut": ["mean_out"], "VarianceOut": ["var_out"],
           "SavedMean": ["saved_mean"], "SavedVariance": ["saved_var"]}

BN_CASES = [  # shape, layout, is_test, bf16
    ((4, 3, 5, 5), "NCHW", False, False),
    ((4, 5, 5, 3), "NHWC", False, False),
    ((4, 3, 5, 5), "NCHW", True, False),
    ((6, 8), "NCHW", False, False),
    ((4, 3, 5, 5), "NCHW", False, True),
    ((4, 3, 5, 5), "NCHW", True, True),
]


@pytest.mark.parametrize("shape,layout,is_test,bf16", BN_CASES)
def test_batch_norm(shape, layout, is_test, bf16):
    _check("batch_norm", _bn_inputs(shape, layout), BN_OUTS,
           {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test,
            "data_layout": layout}, bf16=("x",) if bf16 else ())


@pytest.mark.parametrize("shifted", [False, True])
def test_batch_norm_statistics_forms(shifted):
    """Inputs far from 0 (mean 100, std 1): the one-pass form and, under
    `bn_shifted_stats`, the shifted form, the same on both sides."""
    ins = _bn_inputs((4, 3, 5, 5), "NCHW")
    ins["X"] = [("x", _f32(4, 3, 5, 5, seed=10) + 100.0)]
    jflags.set_flag("bn_shifted_stats", shifted)
    tflags.set_flag("bn_shifted_stats", shifted)
    try:
        # E[x^2] - E[x]^2 at 1e4 loses the last 1e-3 of the variance in f32
        _check("batch_norm", ins, BN_OUTS, {"momentum": 0.9},
               atol=2e-5 if shifted else 1e-2)
    finally:
        jflags.set_flag("bn_shifted_stats", False)
        tflags.set_flag("bn_shifted_stats", False)


def _bn_grad_case(shape, layout, is_test, bf16, stat_grads, saved):
    ins = _bn_inputs(shape, layout)
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test,
             "data_layout": layout}
    fwd = _apply_both("batch_norm", ins, BN_OUTS, attrs,
                      bf16=("x",) if bf16 else ())
    grad_ins = dict(ins)
    for slot, (name,) in BN_OUTS.items():
        if saved or not slot.startswith("Saved"):
            grad_ins["O@" + slot] = [(name, fwd[slot][0][0])]
    y = fwd["Y"][0][0]
    grad_ins["OG@Y"] = [("dy", _f32(*y.shape, seed=11))]
    for i, slot in enumerate(("SavedMean", "SavedVariance", "MeanOut",
                              "VarianceOut")):
        c = fwd[slot][0][0].shape
        grad_ins["OG@" + slot] = [("d_" + slot,
                                   _f32(*c, seed=12 + i)
                                   if slot in stat_grads else None)]
    return grad_ins, attrs


@pytest.mark.parametrize("shape,layout,is_test,bf16,stat_grads,saved", [
    ((4, 3, 5, 5), "NCHW", False, False, (), True),
    ((4, 3, 5, 5), "NCHW", False, False, (), False),
    ((4, 3, 5, 5), "NCHW", False, False,
     ("SavedMean", "SavedVariance", "MeanOut", "VarianceOut"), True),
    ((4, 3, 5, 5), "NCHW", False, False, ("MeanOut",), True),
    ((4, 5, 5, 3), "NHWC", False, False, ("SavedVariance",), True),
    ((4, 3, 5, 5), "NCHW", True, False, (), True),
    ((6, 8), "NCHW", False, False, (), True),
    ((4, 3, 5, 5), "NCHW", False, True, (), True),
    ((4, 3, 5, 5), "NCHW", True, True, (), True),
])
def test_batch_norm_grad(shape, layout, is_test, bf16, stat_grads, saved):
    ins, attrs = _bn_grad_case(shape, layout, is_test, bf16, stat_grads,
                               saved)
    bf16_names = ("x", "dy") if bf16 else ()
    outs = {"X@GRAD": ["dx"], "Scale@GRAD": ["dscale"],
            "Bias@GRAD": ["dbias"]}
    pairs = _check("batch_norm_grad", ins, outs, attrs, bf16=bf16_names,
                   atol=1e-4)
    assert all(np.abs(t).max() > 0 for ps in pairs.values()
               for _, t, _ in ps)


# -- the bf16 policy ---------------------------------------------------------

@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("op_type,ins,outs,attrs", [
    ("mul", {"X": [("x", _f32(4, 6))], "Y": [("w", _f32(6, 5))]},
     {"Out": ["y"]}, {}),
    ("conv2d", {"Input": [("x", _f32(2, 3, 8, 8))],
                "Filter": [("w", _f32(4, 3, 3, 3))]},
     {"Output": ["y"]}, {"paddings": [1, 1]}),
    ("elementwise_add", {"X": [("x", _f32(2, 4, 3, 3))],
                         "Y": [("b", _f32(4))]},
     {"Out": ["y"]}, {"axis": 1}),
], ids=["mul", "conv2d", "elementwise_add"])
def test_amp_policy(act, op_type, ins, outs, attrs):
    """Under each package's `bf16_guard`: f32 operands of a product cast
    to bf16, its result bf16 under `amp_bf16_act` (else f32); a bf16
    activation plus an f32 bias computed in bf16 under `amp_bf16_act`
    (else promoted to f32).  The f32 results at atol 2e-2: products of
    magnitude up to 5 rounded to bf16 once more in the port, whose CPU
    product gives a bf16 result."""
    bf16 = ("x",) if op_type == "elementwise_add" else ()
    jflags.set_flag("amp_bf16_act", act)
    tflags.set_flag("amp_bf16_act", act)
    try:
        with jamp.bf16_guard(), tamp.bf16_guard():
            pairs = _check(op_type, ins, outs, attrs, bf16=bf16,
                           atol=2e-2)
    finally:
        jflags.set_flag("amp_bf16_act", True)
        tflags.set_flag("amp_bf16_act", True)
    (_, _, dtype), = next(iter(pairs.values()))
    assert dtype == (torch.bfloat16 if act else torch.float32)
    assert not tamp.bf16_enabled()
