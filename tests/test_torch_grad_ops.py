"""The training slice's op kernels in the port against the JAX
package's, on the same numpy inputs made from a seed: the forward
kernels the training step adds (fill_constant, reshape, sum, mean,
softmax_with_cross_entropy, momentum), and every grad path of the
transformer's step, each run through its package's executor `apply_op`
from a grad OpDesc laid out as the backward builder lays it out.  The
generic grads (`torch.func.vjp` of the forward kernel against
`jax.vjp` of it) cover mul, elementwise_add (axis broadcast), split,
relu, reshape, mean, softmax_with_cross_entropy and flash_attention;
the explicit kernels layer_norm_grad and lookup_table_grad.

Tolerance: float32 at atol 1e-5 (the same f32 arithmetic, summed in
other orders); integer and exact outputs must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401 — registers the JAX kernels
from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.fluid import executor as jexec
from paddle_tpu_torch.core.desc import OpDesc
from paddle_tpu_torch.fluid import executor as texec

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

ATOL = 1e-5
EMPTY = "@EMPTY@"


def _f32(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _apply_both(op_type, ins, outs, attrs):
    """Run op `op_type` through both executors' apply_op.  ins: {slot:
    [(name, ndarray or None)]}, None for an `@EMPTY@` input; outs: {slot:
    [name]}.  Returns {slot: [(jax ndarray, torch ndarray)]}, None pairs
    for outputs neither package wrote."""
    names = {s: [n if a is not None else EMPTY for n, a in v]
             for s, v in ins.items()}
    values = {n: a for v in ins.values() for n, a in v if a is not None}
    jctx = jexec.ExecContext(None, None, 0,
                             {n: jnp.asarray(a) for n, a in values.items()})
    jexec.apply_op(jctx, JOpDesc(op_type, names, outs, attrs))
    tctx = texec.ExecContext(
        None, 0, {n: torch.from_numpy(np.array(a)) for n, a in values.items()},
        device=torch.device("cpu"),
        rng=torch.Generator().manual_seed(0))
    texec.apply_op(tctx, OpDesc(op_type, names, outs, attrs))
    pairs = {}
    for slot, out_names in outs.items():
        pairs[slot] = []
        for n in out_names:
            if n in jctx.env or n in tctx.env:
                assert n in jctx.env and n in tctx.env, n
                pairs[slot].append((np.asarray(jctx.env[n]),
                                    tctx.env[n].numpy()))
            else:
                pairs[slot].append(None)
    return pairs


def _check(op_type, ins, outs, attrs, atol=ATOL):
    pairs = _apply_both(op_type, ins, outs, attrs)
    for slot, ps in pairs.items():
        for p in ps:
            assert p is not None, slot
            j, t = p
            assert t.shape == j.shape, (slot, t.shape, j.shape)
            assert t.dtype == j.dtype, (slot, t.dtype, j.dtype)
            np.testing.assert_allclose(t, j, atol=atol, rtol=0,
                                       err_msg=slot)
    return pairs


def _grad_op(fwd_type, fwd_ins, fwd_outs, og, attrs, grad_slots):
    """Check `<fwd_type>_grad` as the backward builder emits it: the
    forward inputs, O@ the forward outputs (computed here by the JAX
    kernel), OG@ the given output grads (None for @EMPTY@); outputs
    `<slot>@GRAD` for `grad_slots`."""
    fwd = _apply_both(fwd_type, fwd_ins,
                      {s: ["o_%s_%d" % (s, i) for i in range(n)]
                       for s, n in fwd_outs.items()}, attrs)
    ins = dict(fwd_ins)
    for slot, ps in fwd.items():
        ins["O@" + slot] = [("o_%s_%d" % (slot, i), j)
                            for i, (j, _) in enumerate(ps)]
    for slot, gs in og.items():
        ins["OG@" + slot] = [("og_%s_%d" % (slot, i), g)
                             for i, g in enumerate(gs)]
    outs = {s + "@GRAD": ["%s_%d@GRAD" % (s, i)
                          for i in range(len(fwd_ins[s]))]
            for s in grad_slots}
    return _check(fwd_type + "_grad", ins, outs, attrs)


# -- forward kernels of the training step ----------------------------------

@pytest.mark.parametrize("shape,dtype,value", [
    ([1], "float32", 1.0), ([2, 3], "float32", 0.01), ([4], "int64", 7),
    ([2, 2], "int32", -3)])
def test_fill_constant(shape, dtype, value):
    _check("fill_constant", {}, {"Out": ["out"]},
           {"shape": shape, "dtype": dtype, "value": value})


@pytest.mark.parametrize("shape,new", [
    ((2, 3, 4), [-1, 4]), ((2, 3, 4), [0, -1]), ((4, 6, 1), [-1, 1]),
    ((2, 3, 4), [2, 0, -1])])
def test_reshape(shape, new):
    _check("reshape", {"X": [("x", _f32(*shape))]}, {"Out": ["out"]},
           {"shape": new})


def test_reshape_of_int_targets():
    x = np.random.RandomState(0).randint(0, 9, (2, 3, 1)).astype(np.int32)
    _check("reshape", {"X": [("x", x)]}, {"Out": ["out"]}, {"shape": [-1, 1]})


@pytest.mark.parametrize("n", [1, 2, 3])
def test_sum(n):
    _check("sum", {"X": [("x%d" % i, _f32(2, 5, seed=i))
                         for i in range(n)]}, {"Out": ["out"]}, {})


@pytest.mark.parametrize("shape", [(7, 1), (2, 3, 4), (1,)])
def test_mean(shape):
    pairs = _check("mean", {"X": [("x", _f32(*shape))]}, {"Out": ["out"]},
                   {})
    assert pairs["Out"][0][1].shape == (1,)


def _labels(n, c, seed=0, lo=0):
    return np.random.RandomState(seed).randint(lo, c, (n, 1)) \
        .astype(np.int32)


@pytest.mark.parametrize("label_shape", [(6, 1), (6,)])
def test_softmax_with_cross_entropy(label_shape):
    label = _labels(6, 5).reshape(label_shape)
    _check("softmax_with_cross_entropy",
           {"Logits": [("x", _f32(6, 5) * 3)], "Label": [("y", label)]},
           {"Softmax": ["sm"], "Loss": ["loss"]}, {"soft_label": False})


def test_softmax_with_cross_entropy_soft_label_is_refused():
    ctx = texec.ExecContext(None, 0, {"x": torch.zeros(2, 3),
                                      "y": torch.full((2, 3), 1 / 3)})
    op = OpDesc("softmax_with_cross_entropy", {"Logits": ["x"],
                                               "Label": ["y"]},
                {"Softmax": ["sm"], "Loss": ["loss"]}, {"soft_label": True})
    with pytest.raises(NotImplementedError, match="hard labels"):
        texec.apply_op(ctx, op)


def test_softmax_with_cross_entropy_label_index_rule():
    # negative ids count from the end; ids outside [-C, C) give NaN, as
    # jnp.take_along_axis does
    label = np.array([[0], [-1], [7], [-6], [4]], np.int32)
    pairs = _apply_both("softmax_with_cross_entropy",
                        {"Logits": [("x", _f32(5, 5))],
                         "Label": [("y", label)]},
                        {"Softmax": ["sm"], "Loss": ["loss"]}, {})
    j, t = pairs["Loss"][0]
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum(nesterov):
    p, g, v = _f32(4, 3), _f32(4, 3, seed=1), _f32(4, 3, seed=2)
    _check("momentum",
           {"Param": [("p", p)], "Grad": [("g", g)],
            "LearningRate": [("lr", np.array([0.01], np.float32))],
            "Velocity": [("v", v)]},
           {"ParamOut": ["p"], "VelocityOut": ["v"]},
           {"mu": 0.9, "use_nesterov": nesterov})


# -- generic grads (torch.func.vjp against jax.vjp) -------------------------

@pytest.mark.parametrize("x_shape,y_shape,xn,yn", [
    ((2, 3, 4), (4, 5), 2, 1), ((6, 4), (4, 3), 1, 1),
    ((2, 3, 4), (12, 5), 1, 1)])
def test_mul_grad(x_shape, y_shape, xn, yn):
    out = (int(np.prod(x_shape[:xn])), int(np.prod(y_shape[yn:])))
    _grad_op("mul", {"X": [("x", _f32(*x_shape))],
                     "Y": [("y", _f32(*y_shape, seed=1))]},
             {"Out": 1}, {"Out": [_f32(*out, seed=2)]},
             {"x_num_col_dims": xn, "y_num_col_dims": yn}, ["X", "Y"])


@pytest.mark.parametrize("x_shape,y_shape,axis", [
    ((2, 3, 4), (4,), 2), ((2, 3, 4), (4,), -1), ((2, 3, 4), (3,), 1),
    ((2, 3, 4), (2, 3, 4), -1), ((2, 3, 4), (3, 4), 1)])
def test_elementwise_add_grad(x_shape, y_shape, axis):
    _grad_op("elementwise_add", {"X": [("x", _f32(*x_shape))],
                                 "Y": [("y", _f32(*y_shape, seed=1))]},
             {"Out": 1}, {"Out": [_f32(*x_shape, seed=2)]},
             {"axis": axis}, ["X", "Y"])


@pytest.mark.parametrize("attrs,present", [
    ({"axis": 2, "sections": [], "num": 3}, [True, True, True]),
    ({"axis": 2, "sections": [], "num": 3}, [True, False, True]),
    ({"axis": 2, "sections": [2, 4]}, [True, True])])
def test_split_grad(attrs, present):
    x = _f32(2, 3, 6)
    widths = attrs["sections"] or [6 // attrs["num"]] * attrs["num"]
    og = [_f32(2, 3, w, seed=i + 1) if p else None
          for i, (w, p) in enumerate(zip(widths, present))]
    _grad_op("split", {"X": [("x", x)]}, {"Out": len(widths)}, {"Out": og},
             attrs, ["X"])


def test_relu_grad():
    x = _f32(3, 7)
    _grad_op("relu", {"X": [("x", x)]}, {"Out": 1},
             {"Out": [_f32(3, 7, seed=1)]}, {}, ["X"])


@pytest.mark.parametrize("shape,new", [((2, 3, 4), [-1, 4]),
                                       ((2, 3, 4), [0, -1])])
def test_reshape_grad(shape, new):
    out = np.empty(shape).reshape([shape[i] if s == 0 else s
                                   for i, s in enumerate(new)]).shape
    _grad_op("reshape", {"X": [("x", _f32(*shape))]}, {"Out": 1},
             {"Out": [_f32(*out, seed=1)]}, {"shape": new}, ["X"])


def test_mean_grad():
    _grad_op("mean", {"X": [("x", _f32(8, 1))]}, {"Out": 1},
             {"Out": [np.ones(1, np.float32)]}, {}, ["X"])


@pytest.mark.parametrize("softmax_grad", [False, True])
def test_softmax_with_cross_entropy_grad(softmax_grad):
    # in the loss the Softmax output's grad is absent (@EMPTY@)
    _grad_op("softmax_with_cross_entropy",
             {"Logits": [("x", _f32(6, 5) * 3)],
              "Label": [("y", _labels(6, 5))]},
             {"Softmax": 1, "Loss": 1},
             {"Softmax": [_f32(6, 5, seed=3) if softmax_grad else None],
              "Loss": [_f32(6, 1, seed=2)]},
             {"soft_label": False}, ["Logits"])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("num_heads,dim,seq", [(4, 32, 16), (2, 16, 200)])
def test_flash_attention_grad(causal, num_heads, dim, seq):
    # q, k, v as the split op leaves them: strided views of the fc output
    attrs = {"num_heads": num_heads, "causal": causal, "sm_scale": 0.0,
             "sequence_parallel_axis": "", "sequence_parallel_mode": "ring",
             "block_size": 128}
    qkv = _f32(2, seq, 3 * dim)
    ins = {"Q": [("q", qkv[..., :dim])], "K": [("k", qkv[..., dim:2 * dim])],
           "V": [("v", qkv[..., 2 * dim:])]}
    _grad_op("flash_attention", ins, {"Out": 1},
             {"Out": [_f32(2, seq, dim, seed=3)]}, attrs, ["Q", "K", "V"])


# -- explicit grad kernels ---------------------------------------------------

@pytest.mark.parametrize("saved", [True, False])
@pytest.mark.parametrize("stats_grads", [False, True])
@pytest.mark.parametrize("begin", [2, 1])
def test_layer_norm_grad(saved, stats_grads, begin):
    x = _f32(2, 3, 8) * 3 + 1
    n = int(np.prod(x.shape[begin:]))
    lead = int(np.prod(x.shape[:begin]))
    attrs = {"epsilon": 1e-5, "begin_norm_axis": begin}
    fwd_ins = {"X": [("x", x)], "Scale": [("s", _f32(n, seed=1))],
               "Bias": [("b", _f32(n, seed=2))]}
    fwd = _apply_both("layer_norm", fwd_ins,
                      {"Y": ["y"], "Mean": ["m"], "Variance": ["v"]}, attrs)
    ins = dict(fwd_ins)
    ins["O@Y"] = [("y", fwd["Y"][0][0])]
    ins["O@Mean"] = [("m", fwd["Mean"][0][0] if saved else None)]
    ins["O@Variance"] = [("v", fwd["Variance"][0][0] if saved else None)]
    ins["OG@Y"] = [("gy", _f32(*x.shape, seed=3))]
    ins["OG@Mean"] = [("gm", _f32(lead, seed=4) if stats_grads else None)]
    ins["OG@Variance"] = [("gv",
                           _f32(lead, seed=5) if stats_grads else None)]
    _check("layer_norm_grad", ins,
           {"X@GRAD": ["x@GRAD"], "Scale@GRAD": ["s@GRAD"],
            "Bias@GRAD": ["b@GRAD"]}, attrs)


@pytest.mark.parametrize("ids_shape,padding_idx", [
    ((2, 3), -1), ((2, 3), 3), ((2, 3, 1), -1), ((2, 3, 1), 5)])
def test_lookup_table_grad(ids_shape, padding_idx):
    rs = np.random.RandomState(0)
    # ids repeat, so rows sum several contributions
    ids = rs.randint(0, 6, ids_shape).astype(np.int32)
    lead = ids_shape[:-1] if ids_shape[-1] == 1 else ids_shape
    attrs = {"is_sparse": False, "padding_idx": padding_idx}
    _check("lookup_table_grad",
           {"Ids": [("ids", ids)], "W": [("w", _f32(10, 4))],
            "O@Out": [("o", None)],
            "OG@Out": [("g", _f32(*(lead + (4,)), seed=1))]},
           {"W@GRAD": ["w@GRAD"]}, attrs)


def test_lookup_table_grad_negative_and_out_of_range_ids():
    # negative ids count from the end; ids outside [-vocab, vocab) add
    # nothing, as the JAX side's scatter drops them
    ids = np.array([[0, -1, 12], [-11, 3, -10]], np.int32)
    _check("lookup_table_grad",
           {"Ids": [("ids", ids)], "W": [("w", _f32(10, 4))],
            "OG@Out": [("g", _f32(2, 3, 4, seed=1))]},
           {"W@GRAD": ["w@GRAD"]}, {"padding_idx": -1})


def test_lookup_table_grad_sparse_is_refused():
    ctx = texec.ExecContext(None, 0, {"ids": torch.zeros(2, dtype=torch.int32),
                                      "w": torch.zeros(4, 2),
                                      "g": torch.zeros(2, 2)})
    op = OpDesc("lookup_table_grad",
                {"Ids": ["ids"], "W": ["w"], "OG@Out": ["g"]},
                {"W@GRAD": ["w@GRAD"]}, {"is_sparse": True})
    with pytest.raises(NotImplementedError, match="A7"):
        texec.apply_op(ctx, op)
    assert "w@GRAD" not in ctx.env


def test_grad_op_of_unregistered_op_raises():
    ctx = texec.ExecContext(None, 0, {})
    with pytest.raises(KeyError, match="conv3d_grad"):
        texec.apply_op(ctx, OpDesc("conv3d_grad", {}, {}, {}))
