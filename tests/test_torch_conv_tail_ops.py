"""The 10 op types of ops/conv.py that A10's last op groups add — conv3d,
conv3d_transpose, pool3d, max_pool2d_with_index, max_pool3d_with_index,
unpool, maxout, spp, roi_pool and conv2d_dynamic_filter: the port
against the JAX package, on the CPU, on inputs made from a numpy seed.

- Every case of `chip_smoke.conv_tail_op_cases()` (which phase 19c also
  runs on the card): each op through both executors' `apply_op`, and its
  grad (the port's generic vjp, or the own kernels of unpool, roi_pool
  and the 3-D pools, against the JAX generic vjp) with the same output
  grads.  Outputs and grads within F32_ATOL of the larger of 1 and the
  reference's magnitude (the same f32 arithmetic in other orders); the
  pools' indices and roi_pool's Argmax exactly.  The cases hold ties (integer-valued
  inputs), NaN, -inf, windows wholly in the padding, overlapping unpool
  windows and out-of-range unpool ids, empty roi bins and ragged ROIs.
- By hand: the index where F.max_pool2d(return_indices=True) differs
  (NaN, an all -inf window), unpool summing repeated indices where
  F.max_unpool2d does not, maxout's and roi_pool's grads split evenly
  among ties, the grads of unpool, roi_pool and the 3-D pools (their own
  kernels) twice to the same bits, the cuDNN ops registered for
  deterministic algorithms.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401 — registers the JAX kernels
from paddle_tpu.ops.registry import get_op_info as j_op
from paddle_tpu_torch.ops.registry import get_op_info as t_op

import chip_smoke
from test_torch_stack_ops import _compare, _grad_pairs, _run

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

CASES = chip_smoke.conv_tail_op_cases()
GRAD_CASES = [c for c in CASES if c[5]]

NEW_OPS = ["conv3d", "conv3d_transpose", "pool3d", "max_pool2d_with_index",
           "max_pool3d_with_index", "unpool", "maxout", "spp", "roi_pool",
           "conv2d_dynamic_filter"]


def test_the_cases_cover_every_new_op_type():
    assert {c[1] for c in CASES} == set(NEW_OPS)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    _, op, ins, outs, attrs, _, _, exact = case
    _compare(_run(op, ins, outs, attrs), exact)


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_grad_matches_jax(case):
    _compare(_grad_pairs(case), False)


def _case(name):
    return next(c for c in CASES if c[0] == name)


def _port(op, ins, attrs):
    return t_op(op).kernel(None, {s: [v for _, v in vals]
                                  for s, vals in ins.items()}, attrs)


def test_pool_index_where_torch_differs():
    """NaN never wins a window and a window with nothing above -inf
    gives index 0, as the JAX reduction keeps them; F.max_pool2d's own
    indices pick NaN and the window's first element."""
    for name in ("max_pool2d_with_index_nan",
                 "max_pool2d_with_index_neg_inf"):
        _, op, ins, outs, attrs, _, _, _ = _case(name)
        x = ins["X"][0][1]
        mask = _port(op, ins, attrs)["Mask"][0]
        _, ref = F.max_pool2d(x, attrs["ksize"], attrs["strides"],
                              return_indices=True)
        pairs = _run(op, ins, outs, attrs)
        np.testing.assert_array_equal(mask.numpy(),
                                      np.asarray(pairs["m"][0]))
        assert not torch.equal(mask, ref.to(torch.int32)), name
    # the padding case: windows wholly in the padding give -inf and 0
    _, op, ins, _, attrs, _, _, _ = _case(
        "max_pool2d_with_index_k2_s2_pad2_all_padding")
    out = _port(op, ins, attrs)
    assert torch.isinf(out["Out"][0][0, 0, 0, 0])
    assert int(out["Mask"][0][0, 0, 0, 0]) == 0


def test_unpool_sums_repeated_indices():
    """Two values at one index add (`.at[i].add`); F.max_unpool2d keeps
    one of them."""
    x = torch.tensor([[[[1.0, 2.0], [3.0, 4.0]]]])
    idx = torch.tensor([[[[5, 5], [0, 15]]]], dtype=torch.int32)
    out = _port("unpool", {"X": [("x", x)], "Indices": [("i", idx)]},
                {"unpooling_size": [2, 2]})["Out"][0]
    assert float(out[0, 0, 1, 1]) == 3.0
    assert float(out.sum()) == 10.0
    lib = F.max_unpool2d(x, idx.to(torch.int64), 2)
    assert float(lib[0, 0, 1, 1]) in (1.0, 2.0)


def test_max_grads_split_ties_evenly():
    """maxout's and roi_pool's grads split a bin's grad evenly among its
    tied maxima, as jnp.max's vjp does."""
    x = torch.tensor([[[[2.0]], [[2.0]], [[1.0]], [[2.0]]]])
    ins = {"X": [("x", x)]}
    attrs = {"groups": 4}
    pairs = _grad_pairs(("t", "maxout", ins, {"Out": ["o"]}, attrs, ["X"],
                         {"Out": torch.ones(1, 1, 1, 1)}, False))
    (j, t), = pairs.values()
    np.testing.assert_allclose(t.numpy().reshape(-1),
                               [1 / 3, 1 / 3, 0, 1 / 3], rtol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    img = torch.zeros(1, 1, 4, 4)
    img[0, 0, 0, 0] = img[0, 0, 1, 1] = img[0, 0, 0, 3] = 5.0
    rois = torch.tensor([[0.0, 0.0, 0.0, 3.0, 3.0]])
    case = ("t", "roi_pool", {"X": [("x", img)], "ROIs": [("r", rois)]},
            {"Out": ["o"], "Argmax": ["a"]},
            {"pooled_height": 1, "pooled_width": 1, "spatial_scale": 1.0},
            ["X"], {"Out": torch.full((1, 1, 1, 1), 3.0)}, False)
    (j, t), = _grad_pairs(case).values()
    assert sorted(t.numpy().reshape(-1))[-3:] == [1.0, 1.0, 1.0]
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


@pytest.mark.parametrize("name", ["unpool_overlapping",
                                  "roi_pool_ties_scale_half",
                                  "conv2d_dynamic_filter_pad1",
                                  "pool3d_max_k3_pad1_ties",
                                  "pool3d_avg_pad1",
                                  "max_pool3d_with_index_k3_s2_pad1_ties"])
def test_grads_repeat_bit_for_bit(name):
    case = _case(name)
    a, b = (_grad_pairs(case) for _ in range(2))
    for n in a:
        assert chip_smoke.same_bits(a[n][1], b[n][1]), n


def test_roi_pool_argmax_is_zeros_and_rounds_half_to_even():
    """A corner at 2.5 after scaling rounds to 2, as jnp.round does."""
    x = torch.arange(2 * 8 * 8, dtype=torch.float32).reshape(1, 2, 8, 8)
    rois = torch.tensor([[0.0, 5.0, 5.0, 9.0, 9.0]])
    attrs = {"pooled_height": 1, "pooled_width": 1, "spatial_scale": 0.5}
    out = _port("roi_pool", {"X": [("x", x)], "ROIs": [("r", rois)]},
                attrs)
    assert not out["Argmax"][0].any()
    assert out["Argmax"][0].dtype == torch.int32
    # rows/cols 2..4 (5 * 0.5 = 2.5 -> 2, 9 * 0.5 = 4.5 -> 4)
    assert float(out["Out"][0][0, 0, 0, 0]) == float(x[0, 0, 4, 4])
    j = j_op("roi_pool").kernel(None, {"X": [jnp.asarray(x.numpy())],
                                       "ROIs": [jnp.asarray(rois.numpy())]},
                                attrs)
    np.testing.assert_array_equal(out["Out"][0].numpy(),
                                  np.asarray(j["Out"][0]))


def test_cudnn_ops_ask_for_deterministic_algorithms():
    for op in ("conv3d", "conv3d_transpose", "conv2d_dynamic_filter"):
        assert t_op(op).deterministic, op


def test_conv3d_under_bf16_policy():
    """conv3d under fluid.amp.bf16_guard(): bf16 operands, an output
    within bf16 rounding of the JAX package's under its guard."""
    import paddle_tpu.fluid as jfluid
    import paddle_tpu_torch.fluid as tfluid

    _, op, ins, _, attrs, _, _, _ = _case("conv3d_pad1")
    x, w = ins["Input"][0][1], ins["Filter"][0][1]
    with tfluid.amp.bf16_guard():
        t = _port(op, ins, attrs)["Output"][0]
    with jfluid.amp.bf16_guard():
        j = j_op(op).kernel(None, {"Input": [jnp.asarray(x.numpy())],
                                   "Filter": [jnp.asarray(w.numpy())]},
                            attrs)["Output"][0]
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    ref = np.asarray(j.astype(jnp.float32))
    np.testing.assert_allclose(t.float().numpy(), ref, rtol=0,
                               atol=2 ** -7 * float(np.abs(ref).max()))
    assert jax.devices()[0].platform == "cpu"
