"""Each op kernel of the served transformer's program in the port
(paddle_tpu_torch.ops) against the JAX registry's kernel of the same op
type, on the same numpy inputs made from a seed.

Tolerance: float32 outputs at atol 1e-5 (the same f32 arithmetic, summed
in other orders); integer and exact outputs must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401 — registers the JAX kernels
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import registry as treg

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

ATOL = 1e-5


def _run_both(op_type, ins, attrs):
    """ins: {slot: [ndarray]}; returns {slot: [(jax_np, torch_np)]}."""
    jouts = jreg.get_op_info(op_type).kernel(
        None, {k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
        attrs)
    touts = treg.get_op_info(op_type).kernel(
        None, {k: [torch.from_numpy(np.array(a)) for a in v]
               for k, v in ins.items()}, attrs)
    assert set(touts) == set(jouts)
    pairs = {}
    for slot in jouts:
        assert len(touts[slot]) == len(jouts[slot])
        pairs[slot] = [(np.asarray(j), t.numpy())
                       for j, t in zip(jouts[slot], touts[slot])]
    return pairs


def _check(op_type, ins, attrs):
    for slot, pairs in _run_both(op_type, ins, attrs).items():
        for j, t in pairs:
            assert t.shape == j.shape, (slot, t.shape, j.shape)
            np.testing.assert_allclose(t, j, atol=ATOL, rtol=0,
                                       err_msg=slot)


def _rs(seed=0):
    return np.random.RandomState(seed)


def _f32(*shape, seed=0):
    return _rs(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("ids_shape,padding_idx", [
    ((2, 3), -1), ((2, 3), 3), ((2, 3, 1), -1), ((2, 3, 1), 5),
    ((6,), 0)])
def test_lookup_table(ids_shape, padding_idx):
    w = _f32(10, 4)
    ids = _rs(1).randint(0, 10, size=ids_shape).astype(np.int32)
    ids.flat[0] = max(padding_idx, 0)
    _check("lookup_table", {"W": [w], "Ids": [ids]},
           {"is_sparse": False, "padding_idx": padding_idx})


def test_lookup_table_out_of_range_ids_match_take():
    # negative ids count from the end; ids outside [-vocab, vocab) give
    # NaN rows, as jnp.take's default fill mode does
    w = _f32(10, 4)
    ids = np.array([[0, 9, -1], [10, -11, 3]], np.int32)
    _check("lookup_table", {"W": [w], "Ids": [ids]}, {"padding_idx": -1})


@pytest.mark.parametrize("x_shape,y_shape,axis", [
    ((2, 3, 5), (2, 3, 5), -1), ((2, 3, 5), (5,), -1),
    ((2, 3, 5), (5,), 2), ((2, 3, 5), (3,), 1), ((2, 3, 5), (3, 5), 1),
    ((2, 3, 5), (2,), 0)])
def test_elementwise_add(x_shape, y_shape, axis):
    _check("elementwise_add",
           {"X": [_f32(*x_shape)], "Y": [_f32(*y_shape, seed=1)]},
           {"axis": axis})


@pytest.mark.parametrize("x_shape,y_shape,xn,yn", [
    ((2, 3, 4), (4, 5), 2, 1), ((2, 3, 4), (12, 5), 1, 1),
    ((6, 4), (4, 7), 1, 1), ((2, 3, 4), (2, 2, 5), 2, 2)])
def test_mul(x_shape, y_shape, xn, yn):
    _check("mul", {"X": [_f32(*x_shape)], "Y": [_f32(*y_shape, seed=1)]},
           {"x_num_col_dims": xn, "y_num_col_dims": yn})


@pytest.mark.parametrize("begin,affine,eps", [
    (2, True, 1e-5), (1, True, 1e-5), (2, False, 1e-3), (1, False, 1e-5)])
def test_layer_norm(begin, affine, eps):
    x = _f32(2, 3, 8) * 3 + 1
    ins = {"X": [x]}
    n = int(np.prod(x.shape[begin:]))
    if affine:
        ins["Scale"] = [_f32(n, seed=1)]
        ins["Bias"] = [_f32(n, seed=2)]
    pairs = _run_both("layer_norm", ins,
                      {"epsilon": eps, "begin_norm_axis": begin})
    lead = int(np.prod(x.shape[:begin]))
    assert pairs["Mean"][0][1].shape == (lead,)
    assert pairs["Variance"][0][1].shape == (lead,)
    for slot, ps in pairs.items():
        for j, t in ps:
            np.testing.assert_allclose(t, j, atol=ATOL, rtol=0,
                                       err_msg=slot)


@pytest.mark.parametrize("shape,attrs", [
    ((2, 3, 12), {"axis": 2, "sections": [], "num": 3}),
    ((2, 3, 12), {"axis": -1, "num": 2}),
    ((6, 4), {"axis": 0, "sections": [1, 2, 3]}),
    ((2, 8), {"axis": 1, "sections": [2, 3]}),
    ((2, 3, 12), {"axis": 2, "sections": [4, 4, 4], "num": 0})])
def test_split(shape, attrs):
    pairs = _run_both("split", {"X": [_f32(*shape)]}, attrs)
    for j, t in pairs["Out"]:
        np.testing.assert_array_equal(t, j)


def test_split_rejects_uneven_num():
    x = torch.zeros(2, 7)
    with pytest.raises(ValueError, match="equal parts"):
        treg.get_op_info("split").kernel(None, {"X": [x]},
                                         {"axis": 1, "num": 3})


@pytest.mark.parametrize("shape", [(7,), (2, 3, 5)])
def test_relu(shape):
    pairs = _run_both("relu", {"X": [_f32(*shape)]}, {})
    for j, t in pairs["Out"]:
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("num_heads,dim,seq", [(4, 32, 16), (2, 16, 24),
                                               (1, 8, 20)])
def test_flash_attention_op(causal, num_heads, dim, seq):
    ins = {"Q": [_f32(2, seq, dim)], "K": [_f32(2, seq, dim, seed=1)],
           "V": [_f32(2, seq, dim, seed=2)]}
    _check("flash_attention", ins,
           {"num_heads": num_heads, "causal": causal, "sm_scale": 0.0,
            "sequence_parallel_axis": "", "sequence_parallel_mode": "ring",
            "block_size": 8})


def test_flash_attention_op_explicit_scale():
    ins = {"Q": [_f32(2, 16, 16)], "K": [_f32(2, 16, 16, seed=1)],
           "V": [_f32(2, 16, 16, seed=2)]}
    _check("flash_attention", ins,
           {"num_heads": 2, "causal": True, "sm_scale": 0.3})


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_flash_attention_op_sequence_parallel_without_mesh(mode):
    # with no device mesh naming the axis, both packages run the local
    # kernel (the mode is read only under a mesh)
    ins = {"Q": [_f32(1, 16, 8)], "K": [_f32(1, 16, 8, seed=1)],
           "V": [_f32(1, 16, 8, seed=2)]}
    pairs = _run_both("flash_attention", ins,
                      {"num_heads": 2, "causal": True,
                       "sequence_parallel_axis": "sp",
                       "sequence_parallel_mode": mode, "block_size": 8})
    (j, t), = pairs["Out"]
    assert t.shape == j.shape == (1, 16, 8)
    np.testing.assert_allclose(t, j, atol=2e-5, rtol=0)


def test_registry_holds_the_slice_op_set():
    assert set(treg.registered_ops()) == {
        "elementwise_add", "mul", "layer_norm", "split", "flash_attention",
        "relu", "lookup_table", "fill_constant", "reshape", "sum", "mean",
        "softmax_with_cross_entropy", "momentum", "uniform_random",
        # the ResNet-50 op set, the golden programs' ops, AMP
        "conv2d", "pool2d", "batch_norm", "gaussian_random", "softmax",
        "cross_entropy", "square", "sgd", "cast", "scale",
        "elementwise_sub", "elementwise_mul", "elementwise_div",
        "elementwise_max", "elementwise_min", "elementwise_pow",
        "sigmoid", "tanh", "exp", "sqrt", "abs", "log",
        # generation and Adam
        "cached_attention", "concat", "increment", "reduce_sum",
        "reduce_mean", "reduce_max", "reduce_min", "adam",
        # the image models and the example's accuracy
        "dropout", "lrn", "top_k", "accuracy",
        # the stacked-LSTM classifier's sequence ops
        "sequence_pool", "lstm",
        # sparse updates: the CTR model's loss and every update op
        "sigmoid_cross_entropy_with_logits", "adagrad", "adamax",
        "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "proximal_gd",
        "proximal_adagrad",
        # sub-blocks: the DynamicRNN engine and its bridges
        "recurrent", "sequence_to_dense", "dense_to_sequence", "transpose",
        "fill_constant_batch_size_like",
        # the rest of the sequence ops, the CRF and the book's cos_sim
        "cos_sim", "sequence_conv", "linear_chain_crf", "crf_decoding",
        "chunk_eval", "sequence_softmax", "row_conv", "sequence_expand",
        "sequence_concat", "sequence_reshape", "sequence_slice",
        "sequence_reverse", "lod_reset", "gru", "gru_unit",
        # loops, conditionals, tensor arrays, rank tables and CTC
        "less_than", "less_equal", "greater_than", "greater_equal",
        "equal", "not_equal", "logical_and", "logical_or", "logical_xor",
        "logical_not", "while", "conditional_block", "cond",
        "split_lod_tensor", "merge_lod_tensor", "write_to_array",
        "read_from_array", "lod_array_length", "max_sequence_len",
        "lod_rank_table", "reorder_lod_tensor_by_rank",
        "lod_tensor_to_array", "array_to_lod_tensor", "shrink_rnn_memory",
        "warpctc", "ctc_align", "edit_distance", "sequence_erase",
        "im2sequence",
        # nested sequences, print, the beam ops and the L1 decay's sign
        "seq_unnest", "seq_outer_expand", "seq_renest", "print",
        "beam_search", "beam_search_decode", "sign",
        # the rest of the optimizer and layer stack: matmul, the norms
        # and distances, the tensor ops, the activations, one_hot, norm,
        # smooth_l1_loss and fused_update
        "matmul", "squared_l2_norm", "l1_norm", "minus",
        "squared_l2_distance", "assign", "assign_value", "fill",
        "fill_zeros_like", "clip", "clip_by_norm", "expand", "gather",
        "scatter", "pad", "crop", "multiplex", "is_empty", "shape",
        "brelu", "ceil", "elu", "floor", "hard_shrink", "hard_sigmoid",
        "leaky_relu", "logsigmoid", "pow", "reciprocal", "relu6", "round",
        "soft_relu", "softplus", "softshrink", "softsign", "stanh",
        "swish", "tanh_shrink", "thresholded_relu", "prelu", "one_hot",
        "norm", "smooth_l1_loss", "fused_update",
        # the numerics health's finiteness checks
        "isfinite", "count_nonfinite",
        # the parameter-server path: the sparse grad's row shards and
        # the trainer's round trip
        "split_selected_rows", "dist_send",
        # the entry-point slice: ops/nn.py, the transposed convolution,
        # the six losses and the three metrics (ROADMAP A10 groups 1-2)
        "lstm_unit", "nce", "bilinear_tensor_product", "conv_shift",
        "cast_embedding_ids", "conv2d_transpose", "hinge_loss",
        "huber_loss", "log_loss", "rank_loss", "margin_rank_loss",
        "modified_huber_loss", "auc", "precision_recall",
        "positive_negative_pair"}
    with pytest.raises(KeyError):
        treg.get_op_info("conv3d")
