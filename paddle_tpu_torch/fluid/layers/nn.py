"""Neural-network layers: the subset of the JAX package's fluid.layers
that the port's models build with.

Counterpart of paddle_tpu/fluid/layers/nn.py (reference:
python/paddle/v2/fluid/layers/nn.py — fc:69, embedding:190,
conv2d:912, pool2d, batch_norm:1250, dropout, lrn, accuracy ...).  Each function appends ops to
the current block with the JAX package's op types, slots, attrs, names
and initializers; nothing runs here.  The other layers wait (ROADMAP A).
"""

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
    "sequence_first_step", "sequence_last_step", "transpose",
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
