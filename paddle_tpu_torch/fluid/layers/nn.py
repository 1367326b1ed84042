"""Neural-network layers: the subset of the JAX package's fluid.layers
that the port's models build with.

Counterpart of paddle_tpu/fluid/layers/nn.py (reference:
python/paddle/v2/fluid/layers/nn.py — fc:69, embedding:190,
conv2d:912, pool2d, batch_norm:1250, dropout, lrn, accuracy, the
sequence layers, the CRF, matmul, one_hot, clip, conv2d_transpose,
lstm_unit, nce ...).  Each function
appends ops to the current block with the JAX package's op types,
slots, attrs, names and initializers; nothing runs here.  The other
layers wait (ROADMAP A).
"""

import numpy as np

from ..initializer import Constant, Normal
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = [
    "fc", "embedding", "cross_entropy", "square_error_cost", "softmax",
    "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
    "conv2d", "pool2d", "batch_norm",
    "layer_norm", "split", "flash_attention", "cached_attention",
    "reduce_sum", "reduce_mean", "reduce_max", "reduce_min", "dropout",
    "lrn", "accuracy", "dynamic_lstm", "sequence_pool",
    "sequence_first_step", "sequence_last_step", "transpose", "cos_sim",
    "dynamic_gru", "gru_unit", "sequence_softmax", "sequence_concat",
    "sequence_slice", "lod_reset", "sequence_conv", "sequence_reverse",
    "sequence_expand", "sequence_reshape", "row_conv", "linear_chain_crf",
    "crf_decoding", "chunk_eval", "topk", "im2sequence", "warpctc",
    "ctc_greedy_decoder", "edit_distance", "sequence_unnest",
    "sequence_renest", "beam_search", "beam_search_decode", "matmul",
    "l2_normalize", "one_hot", "clip", "clip_by_norm", "multiplex",
    "smooth_l1", "conv2d_transpose", "lstm_unit", "nce",
]


def _prod(dims):
    r = 1
    for d in dims:
        r *= int(d)
    return r


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def flash_attention(queries, keys, values, num_heads=1, causal=False,
                    sm_scale=None, sequence_parallel_axis="",
                    sequence_parallel_mode="ring", block_size=128,
                    name=None):
    """Multi-head attention over dense [batch, seq, dim] tensors as one
    `flash_attention` op: the hand-written CUDA forward on the card
    (ops/attention.py)."""
    helper = LayerHelper("flash_attention", name=name)
    out = helper.create_tmp_variable(queries.dtype)
    helper.append_op(
        type="flash_attention",
        inputs={"Q": [queries], "K": [keys], "V": [values]},
        outputs={"Out": [out]},
        attrs={"num_heads": int(num_heads), "causal": bool(causal),
               "sm_scale": float(sm_scale or 0.0),
               "sequence_parallel_axis": sequence_parallel_axis,
               "sequence_parallel_mode": sequence_parallel_mode,
               "block_size": int(block_size)})
    return out


def cached_attention(query, key, value, k_cache, v_cache, position,
                     num_heads=1, sm_scale=None, name=None):
    """One KV-cached decode step (ops/attention.py cached_attention):
    query/key/value [batch, 1, dim], caches [batch, heads, max_len,
    head_dim], position int [1] or [batch].  Returns (out, k_cache_out,
    v_cache_out); thread the cache outputs back as decode state
    (`fluid.ProgramDecoder` state pairs)."""
    helper = LayerHelper("cached_attention", name=name)
    out = helper.create_tmp_variable(query.dtype)
    kc_out = helper.create_tmp_variable(k_cache.dtype)
    vc_out = helper.create_tmp_variable(v_cache.dtype)
    helper.append_op(
        type="cached_attention",
        inputs={"Q": [query], "KNew": [key], "VNew": [value],
                "KCache": [k_cache], "VCache": [v_cache],
                "Position": [position]},
        outputs={"Out": [out], "KCacheOut": [kc_out],
                 "VCacheOut": [vc_out]},
        attrs={"num_heads": int(num_heads),
               "sm_scale": float(sm_scale or 0.0)})
    return out, kc_out, vc_out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None, **kwargs):
    """Fully connected (reference: layers/nn.py:69): a `mul` per input,
    a `sum` of several, the bias and the activation."""
    helper = LayerHelper("fc", input=input, size=size, act=act,
                         param_attr=param_attr, bias_attr=bias_attr,
                         name=name, **kwargs)
    dtype = helper.input_dtype
    mul_results = []
    for input_var, p_attr in helper.iter_inputs_and_params():
        w = helper.create_parameter(
            p_attr, shape=[_prod(input_var.shape[num_flatten_dims:]), size],
            dtype=dtype)
        tmp = helper.create_tmp_variable(dtype,
                                         lod_level=input_var.lod_level)
        helper.append_op(type="mul", inputs={"X": [input_var], "Y": [w]},
                         outputs={"Out": [tmp]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_tmp_variable(dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32", **kwargs):
    """Lookup table (reference: layers/nn.py:190)."""
    helper = LayerHelper("embedding", param_attr=param_attr, **kwargs)
    w = helper.create_parameter(helper.param_attr, shape=size, dtype=dtype,
                                is_bias=False)
    tmp = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    helper.append_op(
        type="lookup_table", inputs={"Ids": [input], "W": [w]},
        outputs={"Out": [tmp]},
        attrs={"is_sparse": is_sparse,
               "padding_idx": -1 if padding_idx is None else padding_idx})
    return tmp


def cross_entropy(input, label, soft_label=False, **kwargs):
    helper = LayerHelper("cross_entropy", **kwargs)
    out = helper.create_tmp_variable(input.dtype, lod_level=input.lod_level)
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]}, attrs={"soft_label": soft_label})
    return out


def square_error_cost(input, label, **kwargs):
    """(input - label)^2: `elementwise_sub` then `square`."""
    helper = LayerHelper("square_error_cost", **kwargs)
    minus_out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="elementwise_sub",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [minus_out]})
    square_out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="square", inputs={"X": [minus_out]},
                     outputs={"Out": [square_out]})
    return square_out


def softmax(input, **kwargs):
    helper = LayerHelper("softmax", **kwargs)
    out = helper.create_tmp_variable(input.dtype, lod_level=input.lod_level)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False, **kwargs):
    helper = LayerHelper("softmax_with_cross_entropy", **kwargs)
    softmax_v = helper.create_tmp_variable(logits.dtype)
    loss = helper.create_tmp_variable(logits.dtype)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [softmax_v], "Loss": [loss]},
                     attrs={"soft_label": soft_label})
    return loss


def sigmoid_cross_entropy_with_logits(x, label, **kwargs):
    """The elementwise logistic loss of logits `x` against labels in
    [0, 1] (reference: layers/nn.py sigmoid_cross_entropy_with_logits)."""
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(
        type="sigmoid_cross_entropy_with_logits",
        inputs={"X": [x], "Label": [label]}, outputs={"Out": [out]})
    return out


def conv2d(input, num_filters, filter_size, stride=None, padding=None,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, **kwargs):
    """2-D convolution, NCHW (reference: layers/nn.py:912): cuDNN on the
    card.  The filter starts N(0, sqrt(2 / (kh kw C))), seed 0."""
    helper = LayerHelper("conv2d", input=input, act=act,
                         param_attr=param_attr, bias_attr=bias_attr,
                         name=name, **kwargs)
    dtype = input.dtype
    num_channels = input.shape[1]
    groups = groups or 1
    if num_channels % groups != 0:
        raise ValueError("num_channels must be divisible by groups")
    filter_size = _pair(filter_size)
    stride = _pair(stride or 1)
    padding = _pair(padding or 0)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    std = (2.0 / (filter_size[0] * filter_size[1] * num_channels)) ** 0.5
    filter_param = helper.create_parameter(
        helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=Normal(0.0, std, 0))
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="conv2d", inputs={"Input": [input], "Filter": [filter_param]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": list(stride), "paddings": list(padding),
               "groups": groups, "dilations": [1, 1]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size, pool_type="max", pool_stride=None,
           pool_padding=None, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, **kwargs):
    """Max or average pooling (reference: layers/nn.py pool2d)."""
    if pool_type not in ("max", "avg"):
        raise ValueError("pool_type must be max|avg")
    helper = LayerHelper("pool2d", **kwargs)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(
        type="pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": _pair(pool_size),
               "global_pooling": global_pooling,
               "strides": _pair(pool_stride or 1),
               "paddings": _pair(pool_padding or 0),
               "ceil_mode": ceil_mode})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None,
               **kwargs):
    """Batch normalisation (reference: layers/nn.py:1250): scale (ones)
    and bias (zeros) parameters, the running mean (zeros) and variance
    (ones) as persistable state the op updates."""
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name, **kwargs)
    dtype = input.dtype
    if data_layout == "NCHW":
        channel_num = input.shape[1]
    elif data_layout == "NHWC":
        channel_num = input.shape[-1]
    else:
        raise ValueError("unsupported data_layout %r" % data_layout)
    param_shape = [channel_num]
    scale = helper.create_parameter(
        helper.param_attr or ParamAttr(), shape=param_shape, dtype=dtype,
        default_initializer=Constant(1.0))
    bias = helper.create_parameter(
        helper.bias_attr or ParamAttr(), shape=param_shape, dtype=dtype,
        is_bias=True)
    mean = helper.create_global_variable(
        name=moving_mean_name, dtype=dtype, shape=param_shape,
        persistable=True)
    helper.set_variable_initializer(mean, Constant(0.0))
    variance = helper.create_global_variable(
        name=moving_variance_name, dtype=dtype, shape=param_shape,
        persistable=True)
    helper.set_variable_initializer(variance, Constant(1.0))
    saved_mean = helper.create_tmp_variable(dtype, stop_gradient=True)
    saved_variance = helper.create_tmp_variable(dtype, stop_gradient=True)
    out = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean],
                 "SavedVariance": [saved_variance]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "data_layout": data_layout})
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               **kwargs):
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, **kwargs)
    dtype = input.dtype
    param_shape = [_prod(input.shape[begin_norm_axis:])]
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(
            helper.param_attr or ParamAttr(), shape=param_shape,
            dtype=dtype, default_initializer=Constant(1.0))]
    if shift:
        inputs["Bias"] = [helper.create_parameter(
            helper.bias_attr or ParamAttr(), shape=param_shape,
            dtype=dtype, is_bias=True)]
    out = helper.create_tmp_variable(dtype)
    mean_out = helper.create_tmp_variable(dtype, stop_gradient=True)
    var_out = helper.create_tmp_variable(dtype, stop_gradient=True)
    helper.append_op(
        type="layer_norm", inputs=inputs,
        outputs={"Y": [out], "Mean": [mean_out], "Variance": [var_out]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def split(input, num_or_sections, dim=-1, **kwargs):
    helper = LayerHelper("split", **kwargs)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        num, sections = num_or_sections, []
    else:
        num, sections = len(num_or_sections), list(num_or_sections)
    outs = [helper.create_tmp_variable(
        input.dtype, lod_level=input.lod_level if dim != 0 else 0)
        for _ in range(num)]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs},
                     attrs={"axis": dim, "sections": sections,
                            "num": 0 if sections else num})
    return outs


def _reduce_layer(op_type):
    def layer(input, dim=None, keep_dim=False, name=None, **kwargs):
        helper = LayerHelper(op_type, name=name, **kwargs)
        out = helper.create_tmp_variable(input.dtype)
        attrs = {"keep_dim": keep_dim,
                 "reduce_all": dim is None,
                 "dim": 0 if dim is None else dim}
        helper.append_op(type=op_type, inputs={"X": [input]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    layer.__name__ = op_type
    return layer


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")


def dropout(x, dropout_prob, is_test=False, seed=None, **kwargs):
    """Zero each element with probability `dropout_prob` (reference:
    layers/nn.py dropout); `seed` fixes the op's own stream."""
    helper = LayerHelper("dropout", **kwargs)
    out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
    mask = helper.create_tmp_variable(x.dtype, stop_gradient=True)
    helper.append_op(
        type="dropout", inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "fix_seed": seed is not None, "seed": seed or 0})
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, **kwargs):
    """Local response normalisation across channels (reference:
    layers/nn.py lrn)."""
    helper = LayerHelper("lrn", **kwargs)
    out = helper.create_tmp_variable(input.dtype)
    mid = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    helper.append_op(type="lrn", inputs={"X": [input]},
                     outputs={"Out": [out], "MidOut": [mid]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def transpose(x, perm, **kwargs):
    """x with its dims permuted by `perm` (reference: layers/nn.py
    transpose)."""
    helper = LayerHelper("transpose", **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="transpose", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": list(perm)})
    return out


def accuracy(input, label, k=1, correct=None, total=None, **kwargs):
    """Top-k accuracy: a `top_k` op, then an `accuracy` op (reference:
    layers/nn.py accuracy)."""
    helper = LayerHelper("accuracy", **kwargs)
    topk_out = helper.create_tmp_variable(dtype=input.dtype)
    topk_indices = helper.create_tmp_variable(dtype="int32",
                                              stop_gradient=True)
    helper.append_op(
        type="top_k", inputs={"X": [input]},
        outputs={"Out": [topk_out], "Indices": [topk_indices]},
        attrs={"k": k})
    acc_out = helper.create_tmp_variable(dtype="float32",
                                         stop_gradient=True)
    if correct is None:
        correct = helper.create_tmp_variable(dtype="int32",
                                             stop_gradient=True)
    if total is None:
        total = helper.create_tmp_variable(dtype="int32",
                                           stop_gradient=True)
    helper.append_op(
        type="accuracy",
        inputs={"Out": [topk_out], "Indices": [topk_indices],
                "Label": [label]},
        outputs={"Accuracy": [acc_out], "Correct": [correct],
                 "Total": [total]})
    return acc_out


def dynamic_lstm(input, size, param_attr=None, bias_attr=None,
                 use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", **kwargs):
    """Dynamic-length LSTM over ragged input (reference: layers/nn.py:249
    dynamic_lstm, lstm_op.cc).  `input` is the 4*hidden projection (from
    fc); this layer adds the recurrent weight [hidden, 4*hidden], the
    bias [1, 4*hidden] (with peepholes [1, 7*hidden]) and the `lstm`
    op.  Returns (hidden, cell), ragged as the input."""
    helper = LayerHelper("lstm", param_attr=param_attr,
                         bias_attr=bias_attr, **kwargs)
    size = size // 4
    weight = helper.create_parameter(
        helper.param_attr, shape=[size, 4 * size], dtype=dtype)
    bias_size = [1, 7 * size] if use_peepholes else [1, 4 * size]
    bias = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                   shape=bias_size, dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    cell = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    batch_gate = helper.create_tmp_variable(dtype, stop_gradient=True,
                                            lod_level=input.lod_level)
    batch_cell_pre_act = helper.create_tmp_variable(
        dtype, stop_gradient=True, lod_level=input.lod_level)
    helper.append_op(
        type="lstm",
        inputs={"Input": [input], "Weight": [weight], "Bias": [bias]},
        outputs={"Hidden": [hidden], "Cell": [cell],
                 "BatchGate": [batch_gate],
                 "BatchCellPreAct": [batch_cell_pre_act]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation})
    return hidden, cell


def sequence_pool(input, pool_type, **kwargs):
    """One row per sequence of a ragged input (reference:
    sequence_pool_op.cc): `pool_type` sum, average, sqrt, max, last or
    first."""
    helper = LayerHelper("sequence_pool", input=input, **kwargs)
    out = helper.create_tmp_variable(input.dtype)
    max_index = helper.create_tmp_variable(dtype="int32",
                                           stop_gradient=True)
    helper.append_op(
        type="sequence_pool", inputs={"X": [input]},
        outputs={"Out": [out], "MaxIndex": [max_index]},
        attrs={"pooltype": pool_type.upper()})
    return out


def sequence_first_step(input, **kwargs):
    return sequence_pool(input, "first", **kwargs)


def sequence_last_step(input, **kwargs):
    return sequence_pool(input, "last", **kwargs)


def cos_sim(X, Y, **kwargs):
    """Cosine similarity of X's and Y's rows, [N, 1] (reference:
    layers/nn.py cos_sim, cos_sim_op.cc)."""
    helper = LayerHelper("cos_sim", **kwargs)
    out = helper.create_tmp_variable(X.dtype)
    xnorm = helper.create_tmp_variable(X.dtype)
    ynorm = helper.create_tmp_variable(X.dtype)
    helper.append_op(type="cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [out], "XNorm": [xnorm],
                              "YNorm": [ynorm]})
    return out


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, dtype="float32",
                **kwargs):
    """Dynamic GRU over ragged input (reference: layers/nn.py
    dynamic_gru, gru_op.cc): `input` is the 3 * size projection; this
    layer adds the weight [size, 3 * size], the bias [1, 3 * size] and
    the `gru` op.  Returns the ragged hidden state."""
    helper = LayerHelper("gru", param_attr=param_attr,
                         bias_attr=bias_attr, **kwargs)
    weight = helper.create_parameter(
        helper.param_attr, shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                   shape=[1, 3 * size], dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    batch_gate = helper.create_tmp_variable(dtype, stop_gradient=True)
    batch_reset = helper.create_tmp_variable(dtype, stop_gradient=True)
    batch_hidden = helper.create_tmp_variable(dtype, stop_gradient=True)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op(
        type="gru", inputs=inputs,
        outputs={"Hidden": [hidden], "BatchGate": [batch_gate],
                 "BatchResetHiddenPrev": [batch_reset],
                 "BatchHidden": [batch_hidden]},
        attrs={"is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "activation": candidate_activation})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid", **kwargs):
    """One GRU step on dense tensors (reference: layers/nn.py gru_unit,
    gru_unit_op.cc); `size` is 3 * the hidden width.  Returns (hidden,
    reset hidden prev, gate)."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr, **kwargs)
    dtype = input.dtype
    size = size // 3
    weight = helper.create_parameter(
        helper.param_attr, shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                   shape=[1, 3 * size], dtype=dtype,
                                   is_bias=True)
    gate = helper.create_tmp_variable(dtype)
    reset_hidden_pre = helper.create_tmp_variable(dtype)
    updated_hidden = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="gru_unit",
        inputs={"Input": [input], "HiddenPrev": [hidden],
                "Weight": [weight], "Bias": [bias]},
        outputs={"Gate": [gate], "ResetHiddenPrev": [reset_hidden_pre],
                 "Hidden": [updated_hidden]},
        attrs={"activation": activation,
               "gate_activation": gate_activation})
    return updated_hidden, reset_hidden_pre, gate


def sequence_softmax(x=None, input=None, **kwargs):
    """Softmax within each sequence of a ragged [T, 1] input."""
    x = x if x is not None else input
    helper = LayerHelper("sequence_softmax", **kwargs)
    out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
    helper.append_op(type="sequence_softmax", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def sequence_concat(input, axis=0, **kwargs):
    """Ragged inputs joined per example along time (axis 0) or the
    features (axis 1) (reference: sequence_concat_op.cc)."""
    helper = LayerHelper("sequence_concat", input=input, **kwargs)
    inputs = helper.multiple_input()
    out = helper.create_tmp_variable(dtype=inputs[0].dtype,
                                     lod_level=inputs[0].lod_level)
    helper.append_op(type="sequence_concat", inputs={"X": inputs},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def sequence_slice(input, offset, length, **kwargs):
    """Rows [offset, offset + length) of each sequence."""
    helper = LayerHelper("sequence_slice", **kwargs)
    out = helper.create_tmp_variable(input.dtype, lod_level=1)
    helper.append_op(type="sequence_slice",
                     inputs={"X": [input], "Offset": [offset],
                             "Length": [length]},
                     outputs={"Out": [out]})
    return out


def lod_reset(x, y=None, target_lod=None, **kwargs):
    """x's rows under y's offsets, or under `target_lod`."""
    helper = LayerHelper("lod_reset", **kwargs)
    out = helper.create_tmp_variable(x.dtype, lod_level=1)
    if y is not None:
        helper.append_op(type="lod_reset",
                         inputs={"X": [x], "TargetLoD": [y]},
                         outputs={"Out": [out]})
    else:
        helper.append_op(type="lod_reset", inputs={"X": [x]},
                         outputs={"Out": [out]},
                         attrs={"target_lod": list(target_lod)})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  **kwargs):
    """Context-window convolution along each sequence (reference:
    layers/nn.py sequence_conv, sequence_conv_op.cc): the filter
    [filter_size * D, num_filters], the window starting at
    -(filter_size // 2), then the bias and the activation."""
    helper = LayerHelper("sequence_conv", input=input, act=act,
                         param_attr=param_attr, bias_attr=bias_attr,
                         **kwargs)
    dtype = input.dtype
    filter_param = helper.create_parameter(
        helper.param_attr, shape=[filter_size * input.shape[1],
                                  num_filters], dtype=dtype)
    pre_bias = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    helper.append_op(
        type="sequence_conv",
        inputs={"X": [input], "Filter": [filter_param]},
        outputs={"Out": [pre_bias]},
        attrs={"contextStride": filter_stride,
               "contextStart": -int(filter_size // 2),
               "contextLength": filter_size})
    pre_act = helper.append_bias_op(pre_bias)
    return helper.append_activation(pre_act)


def sequence_reverse(x, **kwargs):
    """Each sequence's rows in reverse order."""
    helper = LayerHelper("sequence_reverse", input=x, **kwargs)
    out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
    helper.append_op(type="sequence_reverse", inputs={"X": [x]},
                     outputs={"Y": [out]})
    return out


def sequence_expand(x, y, **kwargs):
    """x's rows (or sequences) tiled over y's sequences."""
    helper = LayerHelper("sequence_expand", input=x, **kwargs)
    out = helper.create_tmp_variable(x.dtype, lod_level=y.lod_level)
    helper.append_op(type="sequence_expand",
                     inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]})
    return out


def sequence_unnest(x, **kwargs):
    """A nested (lod-level-2) sequence's outer level flattened into the
    batch: (inner, outer_ref), `inner` the lod-1 batch of every
    subsequence and `outer_ref` the outer splits, for `sequence_renest`
    (the flattened form of the reference's nested-sequence mode)."""
    helper = LayerHelper("sequence_unnest", input=x, **kwargs)
    inner = helper.create_tmp_variable(x.dtype, lod_level=1)
    outer_ref = helper.create_tmp_variable("float32", lod_level=1)
    helper.append_op(type="seq_unnest", inputs={"X": [x]},
                     outputs={"Inner": [inner], "OuterRef": [outer_ref]})
    return inner, outer_ref


def sequence_renest(x, outer_ref, **kwargs):
    """The outer splits `sequence_unnest` dropped, put back: dense rows,
    one per subsequence, become a lod-1 sequence over the samples; a
    lod-1 x becomes the lod-2 nested sequence."""
    helper = LayerHelper("sequence_renest", input=x, **kwargs)
    out = helper.create_tmp_variable(x.dtype,
                                     lod_level=2 if x.lod_level else 1)
    helper.append_op(type="seq_renest",
                     inputs={"X": [x], "OuterRef": [outer_ref]},
                     outputs={"Out": [out]})
    return out


def beam_search(pre_ids, ids, scores, beam_size, end_id, level=0,
                **kwargs):
    """One beam step: each source's `beam_size` best candidates
    (reference: layers/nn.py beam_search over beam_search_op.cc)."""
    helper = LayerHelper("beam_search", **kwargs)
    selected_ids = helper.create_tmp_variable(dtype="int64",
                                              stop_gradient=True,
                                              lod_level=2)
    selected_scores = helper.create_tmp_variable(dtype="float32",
                                                 stop_gradient=True,
                                                 lod_level=2)
    helper.append_op(
        type="beam_search",
        inputs={"pre_ids": [pre_ids], "ids": [ids], "scores": [scores]},
        outputs={"selected_ids": [selected_ids],
                 "selected_scores": [selected_scores]},
        attrs={"beam_size": beam_size, "end_id": end_id, "level": level},
        infer_shape=False)
    return selected_ids, selected_scores


def beam_search_decode(ids, scores, **kwargs):
    """The per-step beam selections traced back into hypotheses
    (reference: beam_search_decode_op.cc); ids and scores are the
    per-step selections' vars (or one var each holding their list)."""
    helper = LayerHelper("beam_search_decode", **kwargs)
    sentence_ids = helper.create_tmp_variable(dtype="int64",
                                              stop_gradient=True,
                                              lod_level=2)
    sentence_scores = helper.create_tmp_variable(dtype="float32",
                                                 stop_gradient=True,
                                                 lod_level=2)
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": list(ids) if isinstance(ids, (list, tuple))
                else [ids],
                "Scores": list(scores) if isinstance(scores, (list, tuple))
                else [scores]},
        outputs={"SentenceIds": [sentence_ids],
                 "SentenceScores": [sentence_scores]},
        infer_shape=False)
    return sentence_ids, sentence_scores


def sequence_reshape(input, new_dim, **kwargs):
    """The rows regrouped to width `new_dim`, the splits scaled."""
    helper = LayerHelper("sequence_reshape", **kwargs)
    out = helper.create_tmp_variable(input.dtype, lod_level=1)
    helper.append_op(type="sequence_reshape", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"new_dim": new_dim})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None,
             **kwargs):
    """Lookahead row convolution over future_context_size + 1 rows."""
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act,
                         **kwargs)
    dtype = input.dtype
    filter_param = helper.create_parameter(
        helper.param_attr, shape=[future_context_size + 1, input.shape[1]],
        dtype=dtype)
    out = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    helper.append_op(type="row_conv",
                     inputs={"X": [input], "Filter": [filter_param]},
                     outputs={"Out": [out]})
    return helper.append_activation(out)


def linear_chain_crf(input, label, param_attr=None, **kwargs):
    """The CRF's negative log-likelihood per sequence, [B, 1] (reference:
    linear_chain_crf_op.cc), with its Transition parameter [D + 2, D]."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr,
                         **kwargs)
    size = input.shape[1]
    transition = helper.create_parameter(
        helper.param_attr, shape=[size + 2, size], dtype=input.dtype)
    alpha = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    emission_exps = helper.create_tmp_variable(input.dtype,
                                               stop_gradient=True)
    transition_exps = helper.create_tmp_variable(input.dtype,
                                                 stop_gradient=True)
    log_likelihood = helper.create_tmp_variable(input.dtype)
    helper.append_op(
        type="linear_chain_crf",
        inputs={"Emission": [input], "Transition": [transition],
                "Label": [label]},
        outputs={"Alpha": [alpha], "EmissionExps": [emission_exps],
                 "TransitionExps": [transition_exps],
                 "LogLikelihood": [log_likelihood]})
    return log_likelihood


def crf_decoding(input, param_attr, label=None, **kwargs):
    """The Viterbi path under the Transition named by `param_attr`, or,
    with `label`, the mask of the tags that equal it."""
    helper = LayerHelper("crf_decoding", **kwargs)
    transition = helper.main_program.global_block().var(
        ParamAttr.to_attr(param_attr).name)
    viterbi_path = helper.create_tmp_variable(dtype="int32",
                                              stop_gradient=True)
    inputs = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        inputs["Label"] = [label]
    helper.append_op(type="crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [viterbi_path]})
    return viterbi_path


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, **kwargs):
    """Chunk precision, recall and F1 with the chunk counts (reference:
    chunk_eval_op.cc)."""
    helper = LayerHelper("chunk_eval", **kwargs)
    outs = [helper.create_tmp_variable(dtype=dtype, stop_gradient=True)
            for dtype in ("float32",) * 3 + ("int32",) * 3]
    precision, recall, f1, num_infer, num_label, num_correct = outs
    helper.append_op(
        type="chunk_eval", inputs={"Inference": [input], "Label": [label]},
        outputs={"Precision": [precision], "Recall": [recall],
                 "F1-Score": [f1], "NumInferChunks": [num_infer],
                 "NumLabelChunks": [num_label],
                 "NumCorrectChunks": [num_correct]},
        attrs={"chunk_scheme": chunk_scheme,
               "num_chunk_types": num_chunk_types,
               "excluded_chunk_types": excluded_chunk_types or []})
    return tuple(outs)


def topk(input, k, **kwargs):
    """The k largest of the last dim and their int32 indices (ragged
    over a ragged input's splits)."""
    helper = LayerHelper("top_k", **kwargs)
    values = helper.create_tmp_variable(dtype=input.dtype)
    indices = helper.create_tmp_variable(dtype="int32", stop_gradient=True)
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    return values, indices


def im2sequence(input, filter_size=1, stride=1, padding=0, **kwargs):
    """Each image's patches as a sequence (reference:
    im2sequence_op.cc)."""
    helper = LayerHelper("im2sequence", **kwargs)
    out = helper.create_tmp_variable(input.dtype, lod_level=1)
    helper.append_op(
        type="im2sequence", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"kernels": _pair(filter_size), "strides": _pair(stride),
               "paddings": _pair(padding) + _pair(padding)})
    return out


def warpctc(input, label, blank=0, norm_by_times=False, **kwargs):
    """The CTC loss of ragged logits against ragged labels (reference:
    warpctc_op.cc), [B, 1]."""
    helper = LayerHelper("warpctc", **kwargs)
    loss_out = helper.create_tmp_variable(input.dtype)
    grad_out = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    helper.append_op(
        type="warpctc", inputs={"Logits": [input], "Label": [label]},
        outputs={"WarpCTCGrad": [grad_out], "Loss": [loss_out]},
        attrs={"blank": blank, "norm_by_times": norm_by_times})
    return loss_out


def ctc_greedy_decoder(input, blank, **kwargs):
    """The greedy CTC decode of ragged per-step scores: the argmax of
    each step (`top_k`), repeats merged and blanks dropped
    (`ctc_align`); an int input is taken as ids already."""
    helper = LayerHelper("ctc_align", **kwargs)
    ids = input
    if not np.issubdtype(np.dtype(str(input.dtype)), np.integer):
        _, ids = topk(input, 1)
    out = helper.create_tmp_variable(dtype="int32", stop_gradient=True)
    helper.append_op(type="ctc_align", inputs={"Input": [ids]},
                     outputs={"Output": [out]},
                     attrs={"blank": blank, "merge_repeated": True})
    return out


def edit_distance(input, label, normalized=False, ignored_tokens=None,
                  **kwargs):
    """(distance [B, 1], sequence count [1]) of ragged hypotheses to
    ragged references (reference: edit_distance_op.cc)."""
    helper = LayerHelper("edit_distance", **kwargs)
    out = helper.create_tmp_variable(dtype="float32", stop_gradient=True,
                                     shape=[-1, 1])
    seq_num = helper.create_tmp_variable(dtype="int32", stop_gradient=True,
                                         shape=[1])
    helper.append_op(
        type="edit_distance", inputs={"Hyps": [input], "Refs": [label]},
        outputs={"Out": [out], "SequenceNum": [seq_num]},
        attrs={"normalized": normalized,
               "ignored_tokens": ignored_tokens or []})
    return out, seq_num


def matmul(x, y, transpose_x=False, transpose_y=False, name=None, **kwargs):
    helper = LayerHelper("matmul", **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(
        type="matmul", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y})
    return out


def clip(x, min, max, **kwargs):
    helper = LayerHelper("clip", **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": min, "max": max})
    return out


def clip_by_norm(x, max_norm, **kwargs):
    helper = LayerHelper("clip_by_norm", **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"max_norm": max_norm})
    return out


def l2_normalize(x, axis, epsilon=1e-12, **kwargs):
    """x over its L2 norm along `axis` (the `norm` op)."""
    helper = LayerHelper("l2_normalize", **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="norm", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def one_hot(input, depth, **kwargs):
    helper = LayerHelper("one_hot", **kwargs)
    out = helper.create_tmp_variable(dtype="float32")
    helper.append_op(type="one_hot", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    return out


def multiplex(inputs, index, **kwargs):
    helper = LayerHelper("multiplex", **kwargs)
    out = helper.create_tmp_variable(inputs[0].dtype)
    helper.append_op(type="multiplex",
                     inputs={"X": inputs, "Ids": [index]},
                     outputs={"Out": [out]})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None,
              **kwargs):
    """The per-row smooth L1 loss [N, 1] (the `smooth_l1_loss` op)."""
    helper = LayerHelper("smooth_l1_loss", **kwargs)
    diff = helper.create_tmp_variable(x.dtype, stop_gradient=True)
    loss = helper.create_tmp_variable(x.dtype)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op(type="smooth_l1_loss", inputs=inputs,
                     outputs={"Diff": [diff], "Out": [loss]},
                     attrs={"sigma": sigma or 1.0})
    return loss


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=None, stride=None, dilation=None,
                     param_attr=None, use_cudnn=True, name=None, **kwargs):
    """The transposed convolution (reference: conv2d_transpose_op.cc),
    its filter [in_c, num_filters, kh, kw]; without `filter_size`, the
    one that maps the input to `output_size`."""
    helper = LayerHelper("conv2d_transpose", input=input,
                         param_attr=param_attr, name=name, **kwargs)
    dtype = input.dtype
    num_channels = input.shape[1]
    stride = _pair(stride or 1)
    padding = _pair(padding or 0)
    dilation = _pair(dilation or 1)
    if filter_size is None:
        if output_size is None:
            raise ValueError("need filter_size or output_size")
        output_size = _pair(output_size)
        h_in, w_in = input.shape[2], input.shape[3]
        filter_size = [
            (output_size[0] - (h_in - 1) * stride[0] + 2 * padding[0] - 1)
            // dilation[0] + 1,
            (output_size[1] - (w_in - 1) * stride[1] + 2 * padding[1] - 1)
            // dilation[1] + 1]
    else:
        filter_size = _pair(filter_size)
    img_filter = helper.create_parameter(
        helper.param_attr,
        shape=[num_channels, num_filters] + list(filter_size), dtype=dtype)
    out = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="conv2d_transpose",
        inputs={"Input": [input], "Filter": [img_filter]},
        outputs={"Output": [out]},
        attrs={"strides": stride, "paddings": padding,
               "dilations": dilation})
    return out


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, **kwargs):
    """One LSTM step on dense tensors (reference: layers/nn.py lstm_unit,
    lstm_unit_op.cc): an fc of [x_t, hidden_t_prev] to the four gates,
    then the `lstm_unit` op; returns (hidden, cell)."""
    helper = LayerHelper("lstm_unit", param_attr=param_attr,
                         bias_attr=bias_attr, **kwargs)
    size = cell_t_prev.shape[1]
    gates = fc(input=[x_t, hidden_t_prev], size=4 * size,
               param_attr=param_attr, bias_attr=bias_attr, act=None)
    c = helper.create_tmp_variable(x_t.dtype)
    h = helper.create_tmp_variable(x_t.dtype)
    helper.append_op(
        type="lstm_unit",
        inputs={"X": [gates], "C_prev": [cell_t_prev]},
        outputs={"C": [c], "H": [h]},
        attrs={"forget_bias": forget_bias})
    return h, c


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=None, **kwargs):
    """Noise-contrastive estimation (reference: nce_op.cc): the cost
    [N, 1] of each row's labels against `num_neg_samples` (default 10)
    classes drawn uniformly."""
    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr,
                         **kwargs)
    dim = input.shape[1]
    w = helper.create_parameter(helper.param_attr,
                                shape=[num_total_classes, dim],
                                dtype=input.dtype)
    inputs = {"Input": [input], "Label": [label], "Weight": [w]}
    if helper.bias_attr is not None:
        b = helper.create_parameter(helper.bias_attr,
                                    shape=[num_total_classes, 1],
                                    dtype=input.dtype, is_bias=True)
        inputs["Bias"] = [b]
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight]
    cost = helper.create_tmp_variable(input.dtype)
    sample_logits = helper.create_tmp_variable(input.dtype,
                                               stop_gradient=True)
    sample_labels = helper.create_tmp_variable(dtype="int32",
                                               stop_gradient=True)
    helper.append_op(
        type="nce", inputs=inputs,
        outputs={"Cost": [cost], "SampleLogits": [sample_logits],
                 "SampleLabels": [sample_labels]},
        attrs={"num_total_classes": num_total_classes,
               "num_neg_samples": num_neg_samples or 10})
    return cost
