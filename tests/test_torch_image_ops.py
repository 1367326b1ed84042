"""The ops and layers of the image slice against the JAX package's, on
the same numpy inputs made from a seed, run through each package's
executor `apply_op`: `dropout` and its grad, `lrn` and its generic grad,
`top_k` (ties lower index first, as `lax.top_k`) and `accuracy`; and the
`dropout`, `lrn` and `accuracy` layers, whose descs are equal.

Tolerance: float32 at atol 1e-6 (the same f32 arithmetic, sums in the
same order; `lrn`'s fractional power rounds through another libm: its
outputs and grads differ by a few ulps of values up to 3, so lrn is
held at atol 1e-6 times the largest magnitude, measured below 2e-7);
integer outputs equal.  Dropout's masks come from torch's generator,
not JAX's PRNG: its forward in training is held to its statistics (the
keep rate and the mean of the output within 5 standard errors), its
test-mode forward and its grad given a mask exactly.
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
from paddle_tpu_torch.core.ragged import RaggedTensor
from paddle_tpu_torch.fluid import executor as texec

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

ATOL = 1e-6


def _f32(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _tctx(env, seed=0):
    return texec.ExecContext(None, 0, env, device=torch.device("cpu"),
                             rng=torch.Generator().manual_seed(seed))


def _apply_both(op_type, ins, outs, attrs):
    """{out name: (jax ndarray, torch ndarray)} of op `op_type` run
    through both executors; ins {slot: [(name, ndarray)]}."""
    names = {s: [n for n, _ in v] for s, v in ins.items()}
    values = {n: a for v in ins.values() for n, a in v}
    jctx = jexec.ExecContext(None, None, 0,
                             {n: jnp.asarray(a) for n, a in values.items()})
    jexec.apply_op(jctx, JOpDesc(op_type, names, outs, attrs))
    tctx = _tctx({n: torch.from_numpy(np.array(a))
                  for n, a in values.items()})
    texec.apply_op(tctx, OpDesc(op_type, names, outs, attrs))
    out = {}
    for n in (n for ns in outs.values() for n in ns):
        j, t = np.asarray(jctx.env[n]), tctx.env[n].numpy()
        assert t.shape == j.shape and t.dtype == j.dtype, \
            (n, t.shape, j.shape, t.dtype, j.dtype)
        out[n] = (j, t)
    return out


def _check(op_type, ins, outs, attrs, atol=ATOL):
    for n, (j, t) in _apply_both(op_type, ins, outs, attrs).items():
        if np.issubdtype(j.dtype, np.floating):
            np.testing.assert_allclose(t, j, atol=atol, rtol=0, err_msg=n)
        else:
            np.testing.assert_array_equal(t, j, err_msg=n)


# -- dropout ------------------------------------------------------------------

@pytest.mark.parametrize("prob", [0.0, 0.3, 0.5])
def test_dropout_is_test_matches_jax(prob):
    _check("dropout", {"X": [("x", _f32(4, 6))]},
           {"Out": ["out"], "Mask": ["mask"]},
           {"dropout_prob": prob, "is_test": True})


@pytest.mark.parametrize("prob", [0.1, 0.5, 0.9])
def test_dropout_keep_rate_and_mean(prob):
    x = torch.full((256, 256), 2.0)
    ctx = _tctx({"x": x}, seed=3)
    texec.apply_op(ctx, OpDesc("dropout", {"X": ["x"]},
                               {"Out": ["out"], "Mask": ["mask"]},
                               {"dropout_prob": prob}))
    out, mask = ctx.env["out"], ctx.env["mask"]
    n = x.numel()
    keep = 1.0 - prob
    se = (keep * prob / n) ** 0.5
    assert set(torch.unique(mask).tolist()) <= {0.0, 1.0}
    assert abs(float(mask.mean()) - keep) < 5 * se
    # E[out] = keep * x, out = x * mask exactly
    assert abs(float(out.mean()) - 2.0 * keep) < 5 * 2.0 * se
    assert torch.equal(out, x * mask)


def test_dropout_streams():
    x = torch.ones(64, 64)

    def masks(attrs, seed):
        ctx = _tctx({"x": x}, seed=seed)
        got = []
        for _ in range(2):
            texec.apply_op(ctx, OpDesc("dropout", {"X": ["x"]},
                                       {"Out": ["out"], "Mask": ["mask"]},
                                       attrs))
            got.append(ctx.env["mask"].clone())
        return got

    # the executor's stream advances from op to op and repeats with its
    # seed; a fixed seed gives the same mask every time
    a0, a1 = masks({"dropout_prob": 0.5}, 0)
    b0, b1 = masks({"dropout_prob": 0.5}, 0)
    assert torch.equal(a0, b0) and torch.equal(a1, b1)
    assert not torch.equal(a0, a1)
    c0, c1 = masks({"dropout_prob": 0.5, "fix_seed": True, "seed": 7}, 1)
    d0, _ = masks({"dropout_prob": 0.5, "fix_seed": True, "seed": 7}, 2)
    assert torch.equal(c0, c1) and torch.equal(c0, d0)


@pytest.mark.parametrize("is_test", [False, True])
def test_dropout_grad_matches_jax(is_test):
    rs = np.random.RandomState(1)
    mask = (rs.rand(5, 7) >= 0.4).astype(np.float32)
    x = _f32(5, 7, seed=2)
    _check("dropout_grad",
           {"X": [("x", x)], "O@Out": [("o", x * mask)],
            "O@Mask": [("m", mask)], "OG@Out": [("g", _f32(5, 7, seed=3))]},
           {"X@GRAD": ["gx"]},
           {"dropout_prob": 0.4, "is_test": is_test})


@pytest.mark.parametrize("op_type,ins,outs", [
    ("dropout", {"X": ["x"]}, {"Out": ["o"], "Mask": ["m"]}),
    ("top_k", {"X": ["x"]}, {"Out": ["o"], "Indices": ["i"]}),
    ("accuracy", {"Out": ["x"], "Indices": ["x"], "Label": ["l"]},
     {"Accuracy": ["a"], "Correct": ["c"], "Total": ["t"]}),
])
def test_ragged_inputs_raise(op_type, ins, outs):
    """Ragged inputs to dropout, top_k and accuracy, with a row that pads
    the values past `nvalid`.  dropout and top_k keep the input's splits
    (top_k is the greedy CTC decode's argmax of each step;
    tests/test_torch_ctc.py holds it against the JAX package's); dropout's
    Mask is over the values.  accuracy counts the valid rows only: the
    padding row's hit counts neither as a hit nor in the total, as on the
    JAX side (tests/test_torch_nested_beam.py holds all three against
    the JAX package's)."""
    ragged = RaggedTensor(torch.ones(4, 3), [torch.tensor([0, 2, 3])])
    label = torch.tensor([[0], [0], [0], [1]], dtype=torch.int32)
    ctx = _tctx({"x": ragged, "l": label})
    op = OpDesc(op_type, ins, outs, {"dropout_prob": 0.5, "k": 1})
    out = texec.apply_op(ctx, op)
    if op_type == "accuracy":
        assert [int(out[k][0]) for k in ("Correct", "Total")] == [0, 3]
        assert float(out["Accuracy"][0]) == 0.0
        return
    first, second = (("Out", "Indices") if op_type == "top_k"
                     else ("Out", "Mask"))
    assert isinstance(out[first][0], RaggedTensor)
    assert out[first][0].lod() == [[0, 2, 3]]
    assert int(out[first][0].nvalid) == 3
    if op_type == "top_k":
        assert out[second][0].lod() == [[0, 2, 3]]
    else:
        assert tuple(out[second][0].shape) == (4, 3)
        np.testing.assert_array_equal(out[first][0].values.numpy(),
                                      out[second][0].numpy())


# -- lrn ------------------------------------------------------------------------

LRN_CASES = [  # shape, n, k, alpha, beta
    ((2, 6, 5, 5), 5, 1.0, 1e-4, 0.75),   # alexnet's layer
    ((2, 7, 4, 3), 3, 2.0, 0.5, 0.75),    # large alpha: the power matters
    ((1, 4, 3, 3), 5, 1.0, 0.1, 0.5),     # window wider than the channels
]


@pytest.mark.parametrize("shape,n,k,alpha,beta", LRN_CASES)
def test_lrn_matches_jax(shape, n, k, alpha, beta):
    x = 2.0 * _f32(*shape)
    res = _apply_both("lrn", {"X": [("x", x)]},
                      {"Out": ["out"], "MidOut": ["mid"]},
                      {"n": n, "k": k, "alpha": alpha, "beta": beta})
    for name, (j, t) in res.items():
        np.testing.assert_allclose(
            t, j, atol=ATOL * max(1.0, float(np.abs(j).max())), rtol=0,
            err_msg=name)


@pytest.mark.parametrize("shape,n,k,alpha,beta", LRN_CASES)
def test_lrn_grad_matches_jax(shape, n, k, alpha, beta):
    x = 2.0 * _f32(*shape)
    attrs = {"n": n, "k": k, "alpha": alpha, "beta": beta}
    fwd = _apply_both("lrn", {"X": [("x", x)]},
                      {"Out": ["out"], "MidOut": ["mid"]}, attrs)
    res = _apply_both(
        "lrn_grad",
        {"X": [("x", x)], "O@Out": [("o", fwd["out"][0])],
         "O@MidOut": [("m", fwd["mid"][0])],
         "OG@Out": [("g", _f32(*shape, seed=5))], "OG@MidOut": []},
        {"X@GRAD": ["gx"]}, attrs)
    j, t = res["gx"]
    np.testing.assert_allclose(
        t, j, atol=ATOL * max(1.0, float(np.abs(j).max())), rtol=0)


# -- top_k and accuracy -------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 10])
def test_top_k_matches_jax(k):
    _check("top_k", {"X": [("x", _f32(6, 10))]},
           {"Out": ["vals"], "Indices": ["idx"]}, {"k": k})


def test_top_k_ties_lower_index_first():
    # integer scores with many ties: the order of equal values is the
    # point, so both packages must give the same indices
    x = np.random.RandomState(4).randint(0, 3, (8, 12)).astype(np.float32)
    res = _apply_both("top_k", {"X": [("x", x)]},
                      {"Out": ["vals"], "Indices": ["idx"]}, {"k": 5})
    j, t = res["idx"]
    assert t.dtype == np.int32
    np.testing.assert_array_equal(t, j)
    for row, idx in zip(x, t):
        for a, b in zip(idx[:-1], idx[1:]):
            assert row[a] > row[b] or (row[a] == row[b] and a < b)


@pytest.mark.parametrize("k", [1, 3])
def test_accuracy_matches_jax(k):
    rs = np.random.RandomState(6)
    scores = rs.randn(16, 5).astype(np.float32)
    top = _apply_both("top_k", {"X": [("x", scores)]},
                      {"Out": ["vals"], "Indices": ["idx"]}, {"k": k})
    vals, idx = top["vals"][0], top["idx"][0]
    label = rs.randint(0, 5, (16, 1)).astype(np.int32)
    res = _apply_both(
        "accuracy", {"Out": [("vals", vals)], "Indices": [("idx", idx)],
                     "Label": [("label", label)]},
        {"Accuracy": ["acc"], "Correct": ["correct"], "Total": ["total"]},
        {})
    for name, (j, t) in res.items():
        assert t.shape == (1,), name
        np.testing.assert_array_equal(t, j, err_msg=name)
    assert res["correct"][1].dtype == np.int32
    assert res["total"][1][0] == 16
    want = np.mean([lab in row for lab, row in zip(label[:, 0], idx)])
    np.testing.assert_allclose(res["acc"][1], [want], atol=ATOL)


# -- the layers -----------------------------------------------------------------

def _layers_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6, 5, 5], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        t = fluid.layers.lrn(input=x, n=5, alpha=1e-4, beta=0.75)
        t = fluid.layers.dropout(x=t, dropout_prob=0.3)
        t = fluid.layers.dropout(x=t, dropout_prob=0.2, seed=11)
        logits = fluid.layers.fc(input=t, size=4)
        fluid.layers.accuracy(input=logits, label=label, k=2)
    return main, startup


def test_layers_descs_equal_jax():
    jmain, jstartup = _layers_program(jfluid)
    tmain, tstartup = _layers_program(tfluid)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    assert tstartup.desc.to_dict() == jstartup.desc.to_dict()
    test = tmain.clone(for_test=True)
    assert [op.attrs["is_test"] for op in test.desc.block(0).ops
            if op.type == "dropout"] == [True, True]
