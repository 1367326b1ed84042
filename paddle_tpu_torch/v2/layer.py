"""v2 layer builders (reference: python/paddle/v2/layer.py auto-wrapping
trainer_config_helpers/layers.py).

The port's counterpart of paddle_tpu/v2/layer.py, with the same
`__all__`.  Each function appends fluid ops to the default Program
through the port's `fluid.layers` and returns the fluid Variable;
``data`` additionally records declaration order so the trainer can map
reader tuple slots without an explicit ``feeding``.  Every name builds
its ops (`_WAITING`, the names whose op the port lacks, is empty);
`detection_output` gives its op the slot and attrs the op reads, where
the JAX package's layer does not (its program cannot run).
"""

from ..fluid import layers as fl
from .recurrent import (StaticInput, SubsequenceInput, GeneratedInput,
                        memory, recurrent_group, beam_search,
                        get_output_layer, eos_layer, maxid_layer,
                        register_layer_output)

__all__ = [
    "data", "fc", "embedding", "img_conv", "img_pool", "batch_norm",
    "lstmemory", "grumemory", "pool", "first_seq", "last_seq", "concat",
    "dropout", "addto", "classification_cost", "cross_entropy_cost",
    "square_error_cost", "regression_cost", "mse_cost", "crf",
    "crf_decoding", "max_id", "seq_concat", "expand", "cos_sim",
    "scaling", "slope_intercept", "sum_cost", "trans", "mixed",
    # projections / operators (mixed-layer family)
    "full_matrix_projection", "identity_projection", "table_projection",
    "dotmul_projection", "context_projection",
    "trans_full_matrix_projection", "scaling_projection",
    "slice_projection", "conv_projection", "dotmul_operator",
    "conv_operator",
    # recurrent surface
    "StaticInput", "SubsequenceInput", "GeneratedInput", "memory",
    "recurrent_group", "beam_search", "get_output_layer", "eos_layer",
    "maxid_layer", "gru_step_layer", "gru_step_naive_layer",
    "lstm_step_layer", "recurrent",
    # extended zoo
    "repeat", "seq_reshape", "interpolation", "power",
    "sum_to_one_norm", "row_l2_norm", "dot_prod", "l2_distance",
    "clip", "resize", "switch_order", "scale_shift", "sub_seq",
    "seq_slice", "kmax_seq_score", "sub_nested_seq",
    "factorization_machine", "gated_unit", "tensor", "selective_fc",
    "maxout", "spp", "img_cmrnorm", "cross_channel_norm", "img_pool3d",
    "img_conv3d", "block_expand", "bilinear_interp", "rotate",
    "out_prod", "linear_comb", "convex_comb", "conv_shift", "pad",
    "crop", "scale_sub_region", "prelu", "multiplex", "row_conv",
    "dropout_layer", "sampling_id", "printer",
    # costs
    "hsigmoid", "nce", "ctc", "warp_ctc", "rank_cost", "lambda_cost",
    "cross_entropy_with_selfnorm", "multi_binary_label_cross_entropy",
    "huber_regression_cost", "huber_classification_cost",
    "smooth_l1_cost",
    # detection
    "priorbox", "roi_pool", "detection_output", "multibox_loss",
]

def _act_name(act):
    if act is None:
        return None
    if isinstance(act, type):
        act = act()
    return act.name


def _program_data_layers(program=None):
    """Data layers in declaration order, tracked per Program so a second
    topology in the same process doesn't inherit stale feed slots."""
    from ..fluid import framework

    if program is None:
        program = framework.default_main_program()
    if not hasattr(program, "_v2_data_layers"):
        program._v2_data_layers = []
    return program._v2_data_layers


def data(name, type, **kw):
    """reference: trainer_config_helpers data_layer; `type` is a
    v2 data_type.InputType."""
    v = fl.data(name=name, shape=list(type.shape), dtype=type.dtype,
                lod_level=type.seq_level)
    v._v2_input_type = type
    registry = _program_data_layers()
    if all(d.name != name for d in registry):
        registry.append(v)
    return v


def data_layers_for_feeding(feeding, program=None):
    """Resolve reader tuple order: declaration order by default,
    reordered by an explicit {name: index} feeding map."""
    layers = list(_program_data_layers(program))
    if feeding is not None:
        by_name = {d.name: d for d in layers}
        layers = [by_name[name]
                  for name, _ in sorted(feeding.items(),
                                        key=lambda kv: kv[1])]
    return layers


def _reset_data_layers(program=None):
    del _program_data_layers(program)[:]


def fc(input, size, act=None, param_attr=None, bias_attr=None, name=None,
       **kw):
    out = fl.fc(input=input, size=size, act=_act_name(act),
                param_attr=param_attr, bias_attr=bias_attr)
    return register_layer_output(name, out)


def embedding(input, size, param_attr=None, name=None, **kw):
    dim = input._v2_input_type.dim if hasattr(input, "_v2_input_type") \
        else kw.pop("vocab_size")
    return register_layer_output(
        name, fl.embedding(input=input, size=[dim, size],
                           param_attr=param_attr))


def img_conv(input, filter_size, num_filters, num_channels=None, stride=1,
             padding=None, act=None, param_attr=None, bias_attr=None,
             name=None, **kw):
    if padding is None:
        padding = (filter_size - 1) // 2
    return register_layer_output(name, fl.conv2d(
        input=input, num_filters=num_filters,
        filter_size=filter_size, stride=stride,
        padding=padding, act=_act_name(act),
        param_attr=param_attr, bias_attr=bias_attr))


def img_pool(input, pool_size, pool_type=None, stride=None, padding=0,
             name=None, **kw):
    from . import pooling

    if pool_type is None:
        pool_type = pooling.Max
    pt = pool_type.name if not isinstance(pool_type, str) else pool_type
    pt = {"average": "avg"}.get(pt, pt)
    return register_layer_output(name, fl.pool2d(
        input=input, pool_size=pool_size, pool_type=pt,
        pool_stride=stride or pool_size, pool_padding=padding))


def batch_norm(input, act=None, name=None, **kw):
    return register_layer_output(
        name, fl.batch_norm(input=input, act=_act_name(act)))


def lstmemory(input, size=None, reverse=False, act=None, **kw):
    """v2 lstmemory: `size` is the hidden width and `input` the 4*size
    projection (reference: trainer_config_helpers lstmemory — hidden
    size, matching grumemory; fluid dynamic_lstm instead takes 4h)."""
    if size is None:
        size = input.shape[-1] // 4
    hidden, _ = fl.dynamic_lstm(
        input=input, size=size * 4, is_reverse=reverse,
        candidate_activation=_act_name(act) or "tanh")
    return register_layer_output(kw.get("name"), hidden)


def grumemory(input, size=None, reverse=False, act=None, **kw):
    if size is None:
        size = input.shape[-1] // 3
    return register_layer_output(kw.get("name"), fl.dynamic_gru(
        input=input, size=size, is_reverse=reverse,
        candidate_activation=_act_name(act) or "tanh"))


def pool(input, pooling_type=None, name=None, **kw):
    from . import pooling

    if pooling_type is None:
        pooling_type = pooling.Max
    pt = pooling_type.name if not isinstance(pooling_type, str) \
        else pooling_type
    return register_layer_output(
        name, fl.sequence_pool(input=input, pool_type=pt))


def first_seq(input, name=None, **kw):
    return register_layer_output(name,
                                 fl.sequence_first_step(input=input))


def last_seq(input, name=None, **kw):
    return register_layer_output(name,
                                 fl.sequence_last_step(input=input))


def concat(input, act=None, name=None, **kw):
    out = fl.concat(input=input, axis=-1)
    act_n = _act_name(act)
    if act_n:
        out = getattr(fl, act_n)(out)
    return register_layer_output(name, out)


def seq_concat(a, b, name=None, **kw):
    return register_layer_output(name, fl.sequence_concat(input=[a, b]))


def dropout(input, dropout_rate, name=None, **kw):
    return register_layer_output(
        name, fl.dropout(x=input, dropout_prob=dropout_rate))


def addto(input, act=None, bias_attr=None, name=None, **kw):
    if not isinstance(input, (list, tuple)):
        input = [input]
    out = fl.sums(input=list(input))
    act_n = _act_name(act)
    if act_n:
        out = getattr(fl, act_n)(out)
    return register_layer_output(name, out)


def classification_cost(input, label, **kw):
    """softmax-prob input + int label -> mean cross-entropy (reference:
    trainer_config_helpers classification_cost)."""
    cost = fl.cross_entropy(input=input, label=label)
    return fl.mean(x=cost)


def cross_entropy_cost(input, label, **kw):
    return classification_cost(input, label)


def square_error_cost(input, label, **kw):
    cost = fl.square_error_cost(input=input, label=label)
    return fl.mean(x=cost)


regression_cost = square_error_cost
mse_cost = square_error_cost


def sum_cost(input, **kw):
    return fl.mean(x=input)


def crf(size, input, label, param_attr=None, **kw):
    ll = fl.linear_chain_crf(input=input, label=label,
                             param_attr=param_attr)
    return fl.mean(x=ll)


def crf_decoding(size, input, param_attr=None, label=None, **kw):
    return fl.crf_decoding(input=input, param_attr=param_attr,
                           label=label)


def max_id(input, **kw):
    _, idx = fl.topk(input=input, k=1)
    return idx


def expand(input, expand_as, **kw):
    return fl.sequence_expand(x=input, y=expand_as)


def cos_sim(a, b, scale=1.0, **kw):
    out = fl.cos_sim(X=a, Y=b)
    if scale != 1.0:
        out = fl.scale(x=out, scale=float(scale))
    return out


def scaling(input, weight, **kw):
    return fl.elementwise_mul(x=input, y=weight)


def slope_intercept(input, slope=1.0, intercept=0.0, **kw):
    out = fl.scale(x=input, scale=float(slope))
    if intercept:
        out = out + float(intercept)
    return out


def trans(input, **kw):
    return fl.transpose(x=input, perm=[1, 0])


# ---------------------------------------------------------------------------
# mixed layer + projections (reference: trainer_config_helpers
# mixed_layer + FullMatrixProjection/TableProjection/... — a mixed layer
# sums its projections; here each projection is a deferred builder)
# ---------------------------------------------------------------------------

class _Projection:
    def __init__(self, build):
        self.build = build


def full_matrix_projection(input, size, param_attr=None):
    return _Projection(lambda: fl.fc(input=input, size=size,
                                     bias_attr=False,
                                     param_attr=param_attr))


def identity_projection(input, offset=None):
    if offset:
        raise NotImplementedError("identity_projection offset")
    return _Projection(lambda: input)


def table_projection(input, size, param_attr=None):
    dim = input._v2_input_type.dim
    return _Projection(lambda: fl.embedding(input=input, size=[dim, size],
                                            param_attr=param_attr))


def dotmul_projection(input, param_attr=None):
    def build():
        from ..fluid.layer_helper import LayerHelper

        helper = LayerHelper("dotmul_projection",
                             param_attr=param_attr)
        w = helper.create_parameter(helper.param_attr,
                                    shape=[input.shape[-1]],
                                    dtype=input.dtype)
        return fl.elementwise_mul(x=input, y=w)

    return _Projection(build)


def context_projection(input, context_len, context_start=None):
    return _Projection(lambda: fl.sequence_conv(
        input=input, num_filters=input.shape[-1],
        filter_size=context_len, bias_attr=False))


def trans_full_matrix_projection(input, size, param_attr=None):
    """out = x W^T with W [size, in] (reference: layers.py
    trans_full_matrix_projection), so a weight can be tied to an
    ordinary projection's."""

    def build():
        from ..fluid.layer_helper import LayerHelper

        helper = LayerHelper("trans_fm_projection", param_attr=param_attr)
        w = helper.create_parameter(helper.param_attr,
                                    shape=[size, input.shape[-1]],
                                    dtype=input.dtype)
        return fl.matmul(x=input, y=w, transpose_y=True)

    return _Projection(build)


def scaling_projection(input, param_attr=None):
    """out = w * x with one learned scalar w (reference: layers.py
    scaling_projection over ScalingProjection.cpp)."""

    def build():
        from ..fluid.layer_helper import LayerHelper

        helper = LayerHelper("scaling_projection", param_attr=param_attr)
        w = helper.create_parameter(helper.param_attr, shape=[1],
                                    dtype=input.dtype)
        return fl.elementwise_mul(x=input, y=w)

    return _Projection(build)


def slice_projection(input, slices):
    """The input's column ranges [(start, end), ...] side by side
    (reference: layers.py slice_projection): a transpose, one `gather`
    of the chosen columns (their ids an `assign_value`), a transpose
    back."""
    for s, e in slices:
        if not (0 <= s < e <= input.shape[-1]):
            raise ValueError("bad slice (%d, %d) for width %d"
                             % (s, e, input.shape[-1]))

    def build():
        from ..fluid.layer_helper import LayerHelper

        cols = [c for s, e in slices for c in range(s, e)]
        helper = LayerHelper("slice_projection")
        idx = helper.create_tmp_variable("int32")
        idx.stop_gradient = True
        helper.append_op(type="assign_value", inputs={},
                         outputs={"Out": [idx]},
                         attrs={"shape": [len(cols)], "dtype": "int32",
                                "values": cols})
        t = fl.transpose(x=input, perm=[1, 0])
        picked = helper.create_tmp_variable(input.dtype)
        helper.append_op(type="gather", inputs={"X": [t], "Index": [idx]},
                         outputs={"Out": [picked]})
        return fl.transpose(x=picked, perm=[1, 0])

    return _Projection(build)


def conv_projection(input, filter_size, num_filters, num_channels=None,
                    stride=1, padding=0, param_attr=None):
    """Learned-filter conv feature map for a mixed layer (reference:
    layers.py conv_projection; bias/activation belong to the mixed)."""

    def build():
        from ..fluid.layer_helper import LayerHelper

        helper = LayerHelper("conv_projection", param_attr=param_attr)
        cin = num_channels or input.shape[1]
        k = filter_size if isinstance(filter_size, (list, tuple)) \
            else [filter_size] * 2
        s = stride if isinstance(stride, (list, tuple)) else [stride] * 2
        p = padding if isinstance(padding, (list, tuple)) \
            else [padding] * 2
        w = helper.create_parameter(helper.param_attr,
                                    shape=[num_filters, cin] + list(k),
                                    dtype=input.dtype)
        out = helper.create_tmp_variable(input.dtype)
        helper.append_op(type="conv2d",
                         inputs={"Input": [input], "Filter": [w]},
                         outputs={"Output": [out]},
                         attrs={"strides": list(s), "paddings": list(p),
                                "dilations": [1, 1], "groups": 1})
        return out

    return _Projection(build)


def dotmul_operator(a, b, scale=1.0):
    """Elementwise a .* b operator for a mixed layer (reference:
    layers.py dotmul_operator over DotMulOperator.cpp)."""

    def build():
        out = fl.elementwise_mul(x=a, y=b)
        if scale != 1.0:
            out = fl.scale(x=out, scale=float(scale))
        return out

    return _Projection(build)


def mixed(size=None, input=None, act=None, bias_attr=None, name=None,
          **kw):
    outs = [p.build() if isinstance(p, _Projection) else p
            for p in (input if isinstance(input, (list, tuple))
                      else [input])]
    out = outs[0] if len(outs) == 1 else fl.sums(input=outs)
    if bias_attr not in (None, False):
        from ..fluid.layer_helper import LayerHelper

        helper = LayerHelper("mixed_bias", bias_attr=bias_attr)
        out = helper.append_bias_op(out)
    act_n = _act_name(act)
    if act_n:
        out = getattr(fl, act_n)(out)
    return register_layer_output(name, out)


def gru_step_layer(input, output_mem, size=None, act=None,
                   gate_act=None, name=None, param_attr=None,
                   bias_attr=None, **kw):
    """One GRU step: input is the [B, 3*size] projection, output_mem the
    previous hidden state (reference: layers.py gru_step_layer over
    GruStepLayer.cpp)."""
    if size is None:
        size = output_mem.shape[-1]
    hidden, _, _ = fl.gru_unit(
        input=input, hidden=output_mem, size=size * 3,
        param_attr=param_attr, bias_attr=bias_attr,
        activation=_act_name(act) or "tanh",
        gate_activation=_act_name(gate_act) or "sigmoid")
    return register_layer_output(name, hidden)


gru_step_naive_layer = gru_step_layer


def lstm_step_layer(input, state, size=None, act=None, gate_act=None,
                    state_act=None, name=None, bias_attr=None, **kw):
    """One LSTM step: input is the [B, 4*size] gate projection, state
    the previous cell (reference: layers.py lstm_step_layer over
    LstmStepLayer.cpp: c' = sigma(f)*c + sigma(i)*act(z);
    h = sigma(o)*state_act(c')).  The returned layer is the hidden
    output; the new cell is reachable via
    get_output_layer(..., arg_name='state')."""
    from ..fluid.layer_helper import LayerHelper

    if size is None:
        size = state.shape[-1]
    act_n = _act_name(act) or "tanh"
    gate_n = _act_name(gate_act) or "sigmoid"
    state_n = _act_name(state_act) or "tanh"

    gates = input
    if bias_attr not in (None, False):
        helper = LayerHelper("lstm_step_bias", bias_attr=bias_attr)
        gates = helper.append_bias_op(gates)
    z, i, f, o = fl.split(gates, num_or_sections=4, dim=-1)
    new_c = fl.elementwise_add(
        x=fl.elementwise_mul(x=getattr(fl, gate_n)(f), y=state),
        y=fl.elementwise_mul(x=getattr(fl, gate_n)(i),
                             y=getattr(fl, act_n)(z)))
    h = fl.elementwise_mul(x=getattr(fl, gate_n)(o),
                           y=getattr(fl, state_n)(new_c))
    h._v2_extra_outputs = {"state": new_c}
    return register_layer_output(name, h)


def recurrent(input, act=None, bias_attr=None, param_attr=None,
              reverse=False, name=None, **kw):
    """Simple fully-connected recurrence: out_t = act(in_t + W out_{t-1}
    + b) — the input enters unprojected, one [size, size] recurrent
    weight (reference: layers.py recurrent_layer over
    RecurrentLayer.cpp)."""
    size = input.shape[-1]

    act_name = "tanh" if act is None else _act_name(act)

    def _step(y):
        mem = memory(name=None, size=size)
        proj = fl.fc(input=mem, size=size, act=None,
                     param_attr=param_attr, bias_attr=bias_attr)
        out = fl.sums(input=[y, proj])
        if act_name:
            out = getattr(fl, act_name)(out)
        mem.set_input(out)
        return out

    out = recurrent_group(_step, input, reverse=reverse)
    return register_layer_output(name, out)


# ---------------------------------------------------------------------------
# extended layer zoo (reference: trainer_config_helpers/layers.py — the
# remaining *_layer functions, mapped onto the one TPU-native op set)
# ---------------------------------------------------------------------------

def repeat(input, num_repeats, as_row_vector=True, act=None, name=None,
           **kw):
    """reference: repeat_layer — tile features num_repeats times
    (as_row_vector: [a b] -> [a b a b]; else [a a b b])."""
    if as_row_vector:
        out = fl.concat(input=[input] * num_repeats, axis=-1)
    else:
        d = input.shape[-1]
        r = fl.reshape(x=input, shape=[-1, d, 1])
        r = fl.concat(input=[r] * num_repeats, axis=-1)
        out = fl.reshape(x=r, shape=[-1, d * num_repeats])
    act_n = _act_name(act)
    if act_n:
        out = getattr(fl, act_n)(out)
    return register_layer_output(name, out)


def seq_reshape(input, reshape_size, name=None, **kw):
    return register_layer_output(
        name, fl.sequence_reshape(input=input, new_dim=reshape_size))


def interpolation(input, weight, name=None, **kw):
    """out = w*x + (1-w)*y (reference: interpolation_layer over
    InterpolationLayer.cpp); weight is [B, 1]."""
    x, y = input
    wx = fl.elementwise_mul(x=x, y=weight)
    one_minus = fl.scale(x=weight, scale=-1.0) + 1.0
    wy = fl.elementwise_mul(x=y, y=one_minus)
    return register_layer_output(name, fl.elementwise_add(x=wx, y=wy))


def power(input, weight, name=None, **kw):
    """out = x ** w, per-sample scalar exponent (reference:
    power_layer)."""
    return register_layer_output(
        name, fl.elementwise_pow(x=input, y=weight))


def sum_to_one_norm(input, name=None, **kw):
    s = fl.reduce_sum(input=input, dim=1, keep_dim=True)
    return register_layer_output(name, fl.elementwise_div(x=input, y=s))


def row_l2_norm(input, name=None, **kw):
    return register_layer_output(name, fl.l2_normalize(x=input, axis=1))


def dot_prod(a, b, name=None, **kw):
    prod = fl.elementwise_mul(x=a, y=b)
    return register_layer_output(
        name, fl.reduce_sum(input=prod, dim=1, keep_dim=True))


def l2_distance(a, b, name=None, **kw):
    """The L2 distance of a's and b's rows, [N, 1]."""
    sq = _helper_op("squared_l2_distance", {"X": [a], "Y": [b]})
    return register_layer_output(name, fl.sqrt(sq))


def clip(input, min, max, name=None, **kw):
    return register_layer_output(
        name, fl.clip(x=input, min=float(min), max=float(max)))


def resize(input, size, name=None, **kw):
    return register_layer_output(name, fl.reshape(x=input,
                                                  shape=[-1, size]))


def switch_order(input, reshape_from="NCHW", reshape_to="NHWC",
                 name=None, **kw):
    perm = [reshape_from.index(ax) for ax in reshape_to]
    return register_layer_output(name, fl.transpose(x=input, perm=perm))


def scale_shift(input, param_attr=None, bias_attr=None, name=None, **kw):
    """out = w * x + b with scalar learned w, b (reference:
    ScaleShiftLayer.cpp)."""
    from ..fluid.layer_helper import LayerHelper
    from ..fluid.param_attr import ParamAttr

    helper = LayerHelper("scale_shift", param_attr=param_attr,
                         bias_attr=bias_attr)
    w = helper.create_parameter(helper.param_attr, shape=[1],
                                dtype=input.dtype)
    out = fl.elementwise_mul(x=input, y=w)
    if bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                    shape=[1], dtype=input.dtype,
                                    is_bias=True)
        out = fl.elementwise_add(x=out, y=b)
    return register_layer_output(name, out)


def sub_seq(input, offsets, sizes, name=None, **kw):
    return register_layer_output(
        name, fl.sequence_slice(input=input, offset=offsets,
                                length=sizes))


seq_slice = sub_seq


def factorization_machine(input, factor_size, param_attr=None,
                          act=None, name=None, **kw):
    """0.5 * sum((x V)^2 - x^2 V^2) over the factors, [N, 1] (reference:
    FactorizationMachineLayer.cpp)."""
    from ..fluid.layer_helper import LayerHelper

    helper = LayerHelper("factorization_machine", param_attr=param_attr)
    v = helper.create_parameter(helper.param_attr,
                                shape=[input.shape[-1], factor_size],
                                dtype=input.dtype)
    xv = fl.matmul(x=input, y=v)
    x2v2 = fl.matmul(x=fl.square(input), y=fl.square(v))
    diff = fl.elementwise_sub(x=fl.square(xv), y=x2v2)
    out = fl.scale(x=fl.reduce_sum(input=diff, dim=1, keep_dim=True),
                   scale=0.5)
    act_n = _act_name(act)
    if act_n:
        out = getattr(fl, act_n)(out)
    return register_layer_output(name, out)


def _helper_op(op_type, inputs, attrs=None, name=None, dtype="float32",
               lod_level=0, n_outs=1, out_slots=("Out",),
               stop_gradient=False):
    """One op of `op_type` writing `n_outs` outputs of `lod_level` to
    `out_slots` (an op's other outputs go unwritten), marked
    `stop_gradient` when asked.  One output is registered under `name`
    and returned; several are returned as a list."""
    from ..fluid.layer_helper import LayerHelper

    helper = LayerHelper(op_type)
    outs = [helper.create_tmp_variable(dtype, lod_level=lod_level)
            for _ in range(n_outs)]
    if stop_gradient:
        for o in outs:
            o.stop_gradient = True
    helper.append_op(type=op_type, inputs=inputs,
                     outputs={s: [o] for s, o in zip(out_slots, outs)},
                     attrs=attrs or {})
    if n_outs == 1:
        return register_layer_output(name, outs[0])
    return outs


def tensor(a, b, size, act=None, param_attr=None, name=None, **kw):
    """Bilinear tensor product a W_k b (reference: tensor_layer over
    TensorLayer.cpp)."""
    from ..fluid.layer_helper import LayerHelper

    helper = LayerHelper("tensor_layer", param_attr=param_attr)
    w = helper.create_parameter(
        helper.param_attr, shape=[size, a.shape[-1], b.shape[-1]],
        dtype=a.dtype)
    out = _helper_op("bilinear_tensor_product",
                     {"X": [a], "Y": [b], "Weight": [w]})
    act_n = _act_name(act)
    if act_n:
        out = getattr(fl, act_n)(out)
    return register_layer_output(name, out)


def conv_shift(a, b, name=None, **kw):
    """Circular correlation of a with b (reference: conv_shift_layer)."""
    return _helper_op("conv_shift", {"X": [a], "Y": [b]}, name=name,
                      dtype=a.dtype)


def gated_unit(input, size, act=None, name=None, gate_attr=None,
               gate_param_attr=None, inproj_attr=None,
               inproj_param_attr=None, **kw):
    """act(fc(x)) * sigmoid(fc(x)) (reference: gated_unit_layer)."""
    proj = fl.fc(input=input, size=size, act=_act_name(act),
                 param_attr=inproj_param_attr)
    gate = fl.fc(input=input, size=size, act="sigmoid",
                 param_attr=gate_param_attr)
    return register_layer_output(name,
                                 fl.elementwise_mul(x=proj, y=gate))


def selective_fc(input, size, select=None, act=None, param_attr=None,
                 bias_attr=None, name=None, **kw):
    """Full fc; when `select` (0/1 mask) is given the unselected
    outputs are zeroed (reference: selective_fc_layer — the reference
    computes only selected columns; numerically identical result)."""
    out = fl.fc(input=input, size=size, act=_act_name(act),
                param_attr=param_attr, bias_attr=bias_attr)
    if select is not None:
        out = fl.elementwise_mul(x=out, y=select)
    return register_layer_output(name, out)


def img_cmrnorm(input, size, scale=0.0128, power=0.75, name=None, **kw):
    """Cross-map response norm = LRN (reference: img_cmrnorm_layer over
    CMRProjectionNormLayer)."""
    return register_layer_output(
        name, fl.lrn(input=input, n=size, alpha=scale, beta=power))


def cross_channel_norm(input, param_attr=None, name=None, **kw):
    """The L2 norm across the channels of [B, C, H, W], times a learned
    per-channel scale (reference: cross_channel_norm_layer)."""
    from ..fluid.layer_helper import LayerHelper

    helper = LayerHelper("cross_channel_norm", param_attr=param_attr)
    scale = helper.create_parameter(helper.param_attr,
                                    shape=[1, input.shape[1], 1, 1],
                                    dtype=input.dtype)
    normed = _helper_op("norm", {"X": [input]}, {"axis": 1})
    return register_layer_output(
        name, fl.elementwise_mul(x=normed, y=scale))


def pad(input, pad_c=None, pad_h=None, pad_w=None, name=None, **kw):
    """Zero-pad [B, C, H, W] by (before, after) per dim (reference:
    pad_layer)."""
    paddings = []
    for p in ((0, 0), tuple(pad_c or (0, 0)), tuple(pad_h or (0, 0)),
              tuple(pad_w or (0, 0))):
        paddings.extend(p)
    return _helper_op("pad", {"X": [input]}, {"paddings": paddings},
                      name=name, dtype=input.dtype)


def crop(input, shape=None, offsets=None, axis=0, name=None, **kw):
    return _helper_op("crop", {"X": [input]},
                      {"shape": list(shape),
                       "offsets": list(offsets or [0] * 4)},
                      name=name, dtype=input.dtype)


def prelu(input, param_attr=None, name=None, **kw):
    """x where x >= 0, else x times a learned slope per feature."""
    from ..fluid.layer_helper import LayerHelper

    helper = LayerHelper("prelu", param_attr=param_attr)
    alpha = helper.create_parameter(helper.param_attr,
                                    shape=[input.shape[-1]],
                                    dtype=input.dtype)
    return _helper_op("prelu", {"X": [input], "Alpha": [alpha]},
                      name=name, dtype=input.dtype)


def multiplex(input, index=None, name=None, **kw):
    """Row i of the index[i]-th input; without `index`, the first of
    `input` is the index."""
    if index is None:
        index, input = input[0], input[1:]
    return register_layer_output(
        name, fl.multiplex(inputs=list(input), index=index))


def block_expand(input, block_x, block_y, stride_x=1, stride_y=1,
                 padding_x=0, padding_y=0, num_channels=None, name=None,
                 **kw):
    """Image to sequence of blocks (reference: block_expand_layer over
    BlockExpandLayer.cpp -> im2sequence)."""
    return register_layer_output(
        name, fl.im2sequence(input=input,
                             filter_size=[block_y, block_x],
                             stride=[stride_y, stride_x],
                             padding=[padding_y, padding_x]))


def row_conv(input, context_len, act=None, param_attr=None, name=None,
             **kw):
    return register_layer_output(
        name, fl.row_conv(input=input,
                          future_context_size=context_len - 1,
                          param_attr=param_attr, act=_act_name(act)))


def dropout_layer(input, dropout_rate, name=None, **kw):
    return dropout(input, dropout_rate, name=name)


def printer(input, format=None, name=None, **kw):
    outs = input if isinstance(input, (list, tuple)) else [input]
    return [fl.Print(o) for o in outs][0]


# -- costs -------------------------------------------------------------------

def smooth_l1_cost(input, label, name=None, **kw):
    return register_layer_output(
        name, fl.mean(x=fl.smooth_l1(x=input, y=label)))


def nce(input, label, num_classes, param_attr=None, bias_attr=None,
        num_neg_samples=10, name=None, **kw):
    """Noise-contrastive estimation cost, averaged (reference: nce_layer
    over NCELayer.cpp)."""
    out = fl.nce(input=input, label=label,
                 num_total_classes=num_classes, param_attr=param_attr,
                 bias_attr=bias_attr, num_neg_samples=num_neg_samples)
    return register_layer_output(name, fl.mean(x=out))


def rank_cost(left, right, label, weight=None, name=None, **kw):
    """Pairwise ranking cost (reference: rank_cost over RankingCost.cpp
    -> rank_loss_op)."""
    out = _helper_op("rank_loss",
                     {"Left": [left], "Right": [right], "Label": [label]})
    if weight is not None:
        out = fl.elementwise_mul(x=out, y=weight)
    return register_layer_output(name, fl.mean(x=out))


def huber_regression_cost(input, label, delta=1.0, name=None, **kw):
    out = _helper_op("huber_loss", {"X": [input], "Y": [label]},
                     {"delta": float(delta)}, n_outs=2,
                     out_slots=("Out", "Residual"))
    return register_layer_output(name, fl.mean(x=out[0]))


def huber_classification_cost(input, label, name=None, **kw):
    out = _helper_op("modified_huber_loss",
                     {"X": [input], "Y": [label]}, n_outs=2,
                     out_slots=("Out", "IntermediateVal"))
    return register_layer_output(name, fl.mean(x=out[0]))


def ctc(input, label, size=None, norm_by_times=False, name=None, **kw):
    """CTC cost (reference: ctc_layer over CTCLayer.cpp; lowered to the
    same native CTC as warp_ctc)."""
    cost = fl.warpctc(input=input, label=label,
                      norm_by_times=norm_by_times)
    return register_layer_output(name, fl.mean(x=cost))


def warp_ctc(input, label, size=None, blank=0, norm_by_times=False,
             name=None, **kw):
    cost = fl.warpctc(input=input, label=label, blank=blank,
                      norm_by_times=norm_by_times)
    return register_layer_output(name, fl.mean(x=cost))


# -- the layers over A10's last op groups ------------------------------------

def conv_operator(img, filter, filter_size, num_filters,
                  num_channels=None, stride=1, padding=0,
                  filter_size_y=None, stride_y=None, padding_y=None):
    """Each sample of `img` convolved with its own filters, a row of
    another layer's output (reference: layers.py conv_operator over
    ConvOperator.cpp), for a mixed layer."""

    def build():
        from ..fluid.layer_helper import LayerHelper

        helper = LayerHelper("conv_operator")
        kx = filter_size
        ky = filter_size if filter_size_y is None else filter_size_y
        s = [stride if stride_y is None else stride_y, stride]
        p = [padding if padding_y is None else padding_y, padding]
        out = helper.create_tmp_variable(img.dtype)
        helper.append_op(type="conv2d_dynamic_filter",
                         inputs={"Input": [img], "Filter": [filter]},
                         outputs={"Output": [out]},
                         attrs={"strides": s, "paddings": p,
                                "num_filters": int(num_filters),
                                "ksize": [ky, kx]})
        return out

    return _Projection(build)


def kmax_seq_score(input, beam_size=1, name=None, **kw):
    return _helper_op("kmax_seq_score", {"X": [input]},
                      {"beam_size": int(beam_size)}, name=name,
                      dtype="int32", lod_level=1, stop_gradient=True)


def sub_nested_seq(input, selected_indices, name=None, **kw):
    return _helper_op("sub_nested_seq",
                      {"X": [input], "S": [selected_indices]},
                      name=name, dtype=input.dtype, lod_level=1)


def maxout(input, groups, num_channels=None, name=None, **kw):
    return _helper_op("maxout", {"X": [input]}, {"groups": int(groups)},
                      name=name, dtype=input.dtype)


def _pool_type_name(pool_type):
    from . import pooling

    if pool_type is None:
        pool_type = pooling.Max
    pt = pool_type.name if not isinstance(pool_type, str) else pool_type
    return {"average": "avg"}.get(pt, pt)


def spp(input, pyramid_height=3, pool_type=None, name=None, **kw):
    return _helper_op("spp", {"X": [input]},
                      {"pyramid_height": int(pyramid_height),
                       "pooling_type": _pool_type_name(pool_type)},
                      name=name, dtype=input.dtype)


def _triple(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 3


def img_pool3d(input, pool_size, pool_type=None, stride=None,
               padding=0, name=None, **kw):
    s = stride if isinstance(stride, (list, tuple)) \
        else [stride or pool_size] * 3
    return _helper_op("pool3d", {"X": [input]},
                      {"pooling_type": _pool_type_name(pool_type),
                       "ksize": _triple(pool_size), "strides": list(s),
                       "paddings": _triple(padding)},
                      name=name, dtype=input.dtype)


def img_conv3d(input, filter_size, num_filters, num_channels=None,
               stride=1, padding=0, act=None, param_attr=None,
               bias_attr=None, name=None, **kw):
    from ..fluid.layer_helper import LayerHelper

    helper = LayerHelper("conv3d", param_attr=param_attr,
                         bias_attr=bias_attr)
    cin = num_channels or input.shape[1]
    w = helper.create_parameter(helper.param_attr,
                                shape=[num_filters, cin]
                                + _triple(filter_size),
                                dtype=input.dtype)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="conv3d",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": _triple(stride),
                            "paddings": _triple(padding),
                            "dilations": [1, 1, 1], "groups": 1})
    out = helper.append_bias_op(out, dim_start=1, dim_end=2) \
        if bias_attr is not False else out
    act_n = _act_name(act)
    if act_n:
        out = getattr(fl, act_n)(out)
    return register_layer_output(name, out)


def bilinear_interp(input, out_size_x, out_size_y, name=None, **kw):
    return _helper_op("bilinear_interp", {"X": [input]},
                      {"out_h": int(out_size_y), "out_w": int(out_size_x)},
                      name=name, dtype=input.dtype)


def rotate(input, height, width, name=None, **kw):
    c = input.shape[-1] // (height * width)
    return _helper_op("rotate", {"X": [input]},
                      {"channels": int(c), "height": int(height),
                       "width": int(width)}, name=name,
                      dtype=input.dtype)


def out_prod(a, b, name=None, **kw):
    return _helper_op("out_prod", {"X": [a], "Y": [b]}, name=name,
                      dtype=a.dtype)


def linear_comb(weights, vectors, size, name=None, **kw):
    return _helper_op("linear_comb",
                      {"X": [vectors], "W": [weights]},
                      {"size": int(size)}, name=name,
                      dtype=vectors.dtype)


convex_comb = linear_comb


def scale_sub_region(input, indices, value=1.0, name=None, **kw):
    return _helper_op("scale_sub_region",
                      {"X": [input], "Indices": [indices]},
                      {"value": float(value)}, name=name,
                      dtype=input.dtype)


def sampling_id(input, name=None, **kw):
    return _helper_op("sampling_id", {"X": [input]}, name=name,
                      dtype="int64", stop_gradient=True)


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, **kw):
    """Hierarchical sigmoid cost (reference: hsigmoid over
    HierarchicalSigmoidLayer.cpp), its mean."""
    from ..fluid.layer_helper import LayerHelper
    from ..fluid.param_attr import ParamAttr

    helper = LayerHelper("hsigmoid", param_attr=param_attr,
                         bias_attr=bias_attr)
    w = helper.create_parameter(helper.param_attr,
                                shape=[num_classes - 1, input.shape[-1]],
                                dtype=input.dtype)
    inputs = {"X": [input], "W": [w], "Label": [label]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            helper.bias_attr or ParamAttr(), shape=[1, num_classes - 1],
            dtype=input.dtype, is_bias=True)]
    out = _helper_op("hsigmoid", inputs, {"num_classes": int(num_classes)})
    return register_layer_output(name, fl.mean(x=out))


def lambda_cost(input, score, NDCG_num=5, max_sort_size=-1, name=None,
                **kw):
    out = _helper_op("lambda_cost",
                     {"Score": [input], "Label": [score]},
                     {"NDCG_num": int(NDCG_num)}, lod_level=1)
    return register_layer_output(name, fl.mean(x=out))


def cross_entropy_with_selfnorm(input, label, softmax_selfnorm_alpha=0.1,
                                name=None, **kw):
    out = _helper_op("cross_entropy_selfnorm",
                     {"X": [input], "Label": [label]},
                     {"softmax_selfnorm_alpha":
                      float(softmax_selfnorm_alpha)},
                     lod_level=getattr(input, "lod_level", 0))
    return register_layer_output(name, fl.mean(x=out))


def multi_binary_label_cross_entropy(input, label, name=None, **kw):
    out = _helper_op("multi_binary_label_cross_entropy",
                     {"X": [input], "Label": [label]},
                     lod_level=getattr(input, "lod_level", 0))
    return register_layer_output(name, fl.mean(x=out))


def priorbox(input, image, min_size, max_size=(), aspect_ratio=(),
             variance=(0.1, 0.1, 0.2, 0.2), name=None, **kw):
    """[Boxes, Variances] of `prior_box`: [H, W, priors, 4] each."""
    return _helper_op(
        "prior_box", {"Input": [input], "Image": [image]},
        {"min_sizes": list(min_size) if isinstance(
            min_size, (list, tuple)) else [min_size],
         "max_sizes": list(max_size), "aspect_ratios":
         list(aspect_ratio) or [1.0], "variances": list(variance)},
        n_outs=2, out_slots=("Boxes", "Variances"), stop_gradient=True)


def roi_pool(input, rois, pooled_width, pooled_height, spatial_scale,
             name=None, **kw):
    out = _helper_op("roi_pool", {"X": [input], "ROIs": [rois]},
                     {"pooled_height": int(pooled_height),
                      "pooled_width": int(pooled_width),
                      "spatial_scale": float(spatial_scale)},
                     n_outs=2, out_slots=("Out", "Argmax"))
    return register_layer_output(name, out[0])


def detection_output(input_loc, input_conf, priorbox, num_classes,
                     nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
                     confidence_threshold=0.01, background_id=0,
                     name=None, **kw):
    """SSD's detections, [M, 7] rows (image, label, score, box).  The op
    gets the slot and attrs it reads (`Conf`, `num_classes`, `top_k`,
    `confidence_threshold`, `background_label_id`); the JAX package's
    layer passes `Scores`, `keep_top_k`, `score_threshold` and
    `background_label` and no `num_classes`, which its op cannot run."""
    return _helper_op(
        "detection_output",
        {"Loc": [input_loc], "Conf": [input_conf], "PriorBox": [priorbox]},
        {"num_classes": int(num_classes),
         "nms_threshold": float(nms_threshold),
         "nms_top_k": int(nms_top_k), "top_k": int(keep_top_k),
         "confidence_threshold": float(confidence_threshold),
         "background_label_id": int(background_id)},
        name=name, lod_level=1, stop_gradient=True)


def multibox_loss(input_loc, input_conf, priorbox, label, gt_box,
                  num_classes, overlap_threshold=0.5,
                  neg_pos_ratio=3.0, background_id=0, name=None, **kw):
    """SSD's training cost (reference: layers.py multibox_loss_layer over
    MultiBoxLossLayer.cpp), the mean per-image loss; `gt_box` is the
    ragged [G, 4] ground-truth boxes and `label` their ragged [G, 1]
    classes, two data layers where the reference packs one blob."""
    out = _helper_op(
        "multibox_loss",
        {"Loc": [input_loc], "Conf": [input_conf],
         "PriorBox": [priorbox], "GtBox": [gt_box], "GtLabel": [label]},
        {"num_classes": int(num_classes),
         "overlap_threshold": float(overlap_threshold),
         "neg_pos_ratio": float(neg_pos_ratio),
         "background_label_id": int(background_id)},
        out_slots=("Loss",))
    return register_layer_output(name, fl.mean(x=out))


# the names that wait for an op type the port does not register: none
# since A10's last op groups
_WAITING = {}

