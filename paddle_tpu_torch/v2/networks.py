"""v2 network composites (reference: python/paddle/v2/networks.py over
trainer_config_helpers/networks.py — img/vgg composites :336-630,
lstmemory_unit/group :717-940, gru_unit/group :940-1226,
bidirectional_gru :1226, simple_attention :1400, dot_product_attention
:1498, multi_head_attention :1580).  The port's counterpart of
paddle_tpu/v2/networks.py: each composite is restated on the v2 DSL
primitives; the recurrent units hang off the recurrent_group/memory
machinery in v2/recurrent.py (one DynamicRNN), and the attention heads
are sequence ops over the static encoder sequence inside the decoder's
step."""

from ..fluid import layers as fl
from ..fluid import nets as fluid_nets
from ..fluid.framework import unique_name
from . import layer as v2_layer
from . import activation as act_mod
from .recurrent import memory, recurrent_group, get_output_layer

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "simple_lstm", "bidirectional_lstm", "simple_gru",
           "simple_gru2", "lstmemory_unit", "lstmemory_group",
           "gru_unit", "gru_group", "bidirectional_gru",
           "simple_attention", "dot_product_attention",
           "multi_head_attention", "small_vgg", "vgg_16_network"]


def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         pool_stride, act=None, **kw):
    return fluid_nets.simple_img_conv_pool(
        input=input, num_filters=num_filters, filter_size=filter_size,
        pool_size=pool_size, pool_stride=pool_stride,
        act=v2_layer._act_name(act))


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False,
                   conv_batchnorm_drop_rate=0.0, pool_stride=1,
                   pool_type=None, **kw):
    if pool_type is not None and not isinstance(pool_type, str):
        pool_type = pool_type.name
    return fluid_nets.img_conv_group(
        input=input, conv_num_filter=conv_num_filter,
        pool_size=pool_size, conv_padding=conv_padding,
        conv_filter_size=conv_filter_size,
        conv_act=v2_layer._act_name(conv_act),
        conv_with_batchnorm=conv_with_batchnorm,
        conv_batchnorm_drop_rate=conv_batchnorm_drop_rate,
        pool_stride=pool_stride, pool_type=pool_type or "max")


def sequence_conv_pool(input, context_len, hidden_size, **kw):
    return fluid_nets.sequence_conv_pool(
        input=input, num_filters=hidden_size, filter_size=context_len)


def simple_lstm(input, size, reverse=False, **kw):
    proj = v2_layer.fc(input=input, size=size * 4)
    return v2_layer.lstmemory(input=proj, size=size, reverse=reverse)


def bidirectional_lstm(input, size, return_unpooled=False, **kw):
    fwd = simple_lstm(input, size)
    bwd = simple_lstm(input, size, reverse=True)
    if return_unpooled:
        return fwd, bwd
    from . import pooling

    f = v2_layer.pool(fwd, pooling_type=pooling.Max)
    b = v2_layer.pool(bwd, pooling_type=pooling.Max)
    return v2_layer.concat(input=[f, b])


def simple_gru(input, size, reverse=False, **kw):
    proj = v2_layer.fc(input=input, size=size * 3)
    return v2_layer.grumemory(input=proj, size=size, reverse=reverse)


# ---------------------------------------------------------------------------
# step-level recurrent units (for use inside recurrent_group)
# ---------------------------------------------------------------------------

def lstmemory_unit(input, out_memory=None, name=None, size=None,
                   param_attr=None, act=None, gate_act=None,
                   state_act=None, lstm_bias_attr=None, **kw):
    """One LSTM time step for use inside a recurrent_group step function
    (reference: networks.py lstmemory_unit:717) — this is the
    attention-friendly spelling where the hidden/cell states are plain
    step tensors.  `input` is the 4*size input projection; the hidden
    recurrence adds W_h·h_{t-1} and the step kernel does the gate math.
    The new cell is registered under "<name>_state" so the cell memory
    links by name."""
    if size is None:
        size = int(input.shape[-1]) // 4
    if name is None:
        name = unique_name("lstmemory_unit")
    prev_h = out_memory if out_memory is not None \
        else memory(name=name, size=size)
    prev_c = memory(name="%s_state" % name, size=size)

    gates = v2_layer.mixed(
        size=size * 4,
        input=[v2_layer.identity_projection(input),
               v2_layer.full_matrix_projection(prev_h, size * 4,
                                               param_attr=param_attr)])
    out = v2_layer.lstm_step_layer(
        input=gates, state=prev_c, size=size, act=act,
        gate_act=gate_act, state_act=state_act,
        bias_attr=lstm_bias_attr, name=name)
    get_output_layer(out, "state", name="%s_state" % name)
    return out


def lstmemory_group(input, size=None, name=None, out_memory=None,
                    reverse=False, param_attr=None, act=None,
                    gate_act=None, state_act=None, lstm_bias_attr=None,
                    **kw):
    """recurrent_group spelling of an LSTM layer (reference:
    networks.py lstmemory_group:836): same math as lstmemory, but every
    step's states are user-visible — the building block for attention
    decoders.  `input` must already be the 4*size projection."""
    if name is None:
        name = unique_name("lstm_group")

    def lstm_step(ipt):
        return lstmemory_unit(
            input=ipt, name=name, size=size, out_memory=out_memory,
            param_attr=param_attr, act=act, gate_act=gate_act,
            state_act=state_act, lstm_bias_attr=lstm_bias_attr)

    return recurrent_group(step=lstm_step, input=input, reverse=reverse,
                           name="%s_recurrent_group" % name)


def gru_unit(input, memory_boot=None, size=None, name=None,
             gru_bias_attr=None, gru_param_attr=None, act=None,
             gate_act=None, naive=False, **kw):
    """One GRU time step for use inside a recurrent_group step function
    (reference: networks.py gru_unit:940).  `input` is the 3*size
    projection."""
    if size is None:
        size = int(input.shape[-1]) // 3
    if name is None:
        name = unique_name("gru_unit")
    prev = memory(name=name, size=size, boot_layer=memory_boot)
    return v2_layer.gru_step_layer(
        input=input, output_mem=prev, size=size, act=act,
        gate_act=gate_act, param_attr=gru_param_attr,
        bias_attr=gru_bias_attr, name=name)


def gru_group(input, memory_boot=None, size=None, name=None,
              reverse=False, gru_bias_attr=None, gru_param_attr=None,
              act=None, gate_act=None, naive=False, **kw):
    """recurrent_group spelling of a GRU layer (reference:
    networks.py gru_group:1002); per-step hidden states stay visible."""
    if name is None:
        name = unique_name("gru_group")

    def gru_step(ipt):
        return gru_unit(
            input=ipt, memory_boot=memory_boot, name=name, size=size,
            gru_bias_attr=gru_bias_attr, gru_param_attr=gru_param_attr,
            act=act, gate_act=gate_act, naive=naive)

    return recurrent_group(step=gru_step, input=input, reverse=reverse,
                           name="%s_recurrent_group" % name)


def simple_gru2(input, size, name=None, reverse=False,
                mixed_param_attr=None, mixed_bias_attr=None,
                gru_param_attr=None, gru_bias_attr=None, act=None,
                gate_act=None, **kw):
    """fc projection + gru_group (reference: networks.py simple_gru2 —
    the group form of simple_gru, used by bidirectional_gru)."""
    proj = v2_layer.fc(input=input, size=size * 3,
                       param_attr=mixed_param_attr,
                       bias_attr=mixed_bias_attr)
    return gru_group(input=proj, size=size, name=name, reverse=reverse,
                     gru_param_attr=gru_param_attr,
                     gru_bias_attr=gru_bias_attr, act=act,
                     gate_act=gate_act)


def bidirectional_gru(input, size, name=None, return_seq=False, **kw):
    """Forward + backward GRU over the sequence (reference:
    networks.py bidirectional_gru:1226).  return_seq=False concatenates
    the forward's last step with the backward's first step (each is the
    full-context summary for its direction); return_seq=True
    concatenates the two step-aligned output sequences."""
    if name is None:
        name = unique_name("bidirectional_gru")
    fwd_kw = {k[len("fwd_"):]: v for k, v in kw.items()
              if k.startswith("fwd_")}
    bwd_kw = {k[len("bwd_"):]: v for k, v in kw.items()
              if k.startswith("bwd_")}
    fw = simple_gru2(input=input, size=size, name="%s_fw" % name,
                     **fwd_kw)
    bw = simple_gru2(input=input, size=size, name="%s_bw" % name,
                     reverse=True, **bwd_kw)
    if return_seq:
        return v2_layer.concat(input=[fw, bw], name=name)
    return v2_layer.concat(
        input=[v2_layer.last_seq(input=fw), v2_layer.first_seq(input=bw)],
        name=name)


# ---------------------------------------------------------------------------
# attention heads (for use inside a decoder's recurrent_group step)
# ---------------------------------------------------------------------------

def _sequence_attention_pool(scores, values, name):
    """Normalize per-sequence scores and sum-pool the weighted values:
    softmax over each sequence's steps, scale, sum."""
    weights = fl.sequence_softmax(x=scores)
    scaled = v2_layer.scaling(input=values, weight=weights)
    return v2_layer.pool(input=scaled, pooling_type="sum",
                         name="%s_pooling" % name)


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     transform_param_attr=None, softmax_param_attr=None,
                     weight_act=None, name=None):
    """Additive (Bahdanau) attention context (reference:
    networks.py simple_attention:1400): score each encoder step by
    v·f(W·s_{t-1} + U·h_j) with f=tanh, softmax within the sequence,
    and return the weighted sum of encoded_sequence.  encoded_proj is
    the precomputed U·h_j (computed once outside the decoder loop —
    only the decoder-state projection runs per step)."""
    if name is None:
        name = unique_name("attention")
    proj_size = int(encoded_proj.shape[-1])
    state_proj = v2_layer.fc(input=decoder_state, size=proj_size,
                             bias_attr=False,
                             param_attr=transform_param_attr,
                             name="%s_transform" % name)
    expanded = v2_layer.expand(input=state_proj,
                               expand_as=encoded_sequence)
    combined = v2_layer.addto(input=[expanded, encoded_proj],
                              act=weight_act or act_mod.Tanh(),
                              name="%s_combine" % name)
    scores = v2_layer.fc(input=combined, size=1, bias_attr=False,
                         param_attr=softmax_param_attr,
                         name="%s_score" % name)
    return _sequence_attention_pool(scores, encoded_sequence, name)


def dot_product_attention(encoded_sequence, attended_sequence,
                          transformed_state, softmax_param_attr=None,
                          name=None):
    """Dot-product attention context (reference:
    networks.py dot_product_attention:1498): score h_j by
    s_{t-1}ᵀ·h_j against encoded_sequence, softmax within the
    sequence, return the weighted sum of attended_sequence (scored and
    pooled sequences may differ)."""
    if name is None:
        name = unique_name("dot_product_attention")
    expanded = v2_layer.expand(input=transformed_state,
                               expand_as=encoded_sequence)
    scores = v2_layer.dot_prod(a=expanded, b=encoded_sequence,
                               name="%s_score" % name)
    return _sequence_attention_pool(scores, attended_sequence, name)


def multi_head_attention(query, key, value, key_proj_size,
                         value_proj_size, head_num, attention_type,
                         softmax_param_attr=None, name=None):
    """Multi-head attention context (reference:
    networks.py multi_head_attention:1580): project query/key/value
    once to head_num*proj_size, split per head, score each head by
    scaled dot-product or additive attention, pool each head's value
    slice, concat the per-head contexts."""
    if attention_type not in ("dot-product attention",
                              "additive attention"):
        raise ValueError("unknown attention_type %r" % attention_type)
    if name is None:
        name = unique_name("multi_head_attention")
    q = v2_layer.fc(input=query, size=key_proj_size * head_num,
                    bias_attr=False, name="%s_query_proj" % name)
    q = v2_layer.expand(input=q, expand_as=key)
    k = v2_layer.fc(input=key, size=key_proj_size * head_num,
                    bias_attr=False, name="%s_key_proj" % name)
    v = v2_layer.fc(input=value, size=value_proj_size * head_num,
                    bias_attr=False, name="%s_value_proj" % name)

    q_heads = fl.split(q, num_or_sections=head_num, dim=-1)
    k_heads = fl.split(k, num_or_sections=head_num, dim=-1)
    v_heads = fl.split(v, num_or_sections=head_num, dim=-1)

    contexts = []
    for i in range(head_num):
        if attention_type == "dot-product attention":
            scores = v2_layer.dot_prod(a=q_heads[i], b=k_heads[i])
            scores = v2_layer.slope_intercept(
                input=scores, slope=key_proj_size ** -0.5)
        else:
            combined = v2_layer.addto(input=[q_heads[i], k_heads[i]],
                                      act=act_mod.Tanh())
            scores = v2_layer.fc(input=combined, size=1,
                                 bias_attr=False,
                                 param_attr=softmax_param_attr)
        contexts.append(_sequence_attention_pool(
            scores, v_heads[i], "%s_head%d" % (name, i)))
    return v2_layer.concat(input=contexts, name=name)


# ---------------------------------------------------------------------------
# VGG image composites
# ---------------------------------------------------------------------------

def _vgg_block(x, num_filter, times, dropouts):
    return img_conv_group(
        input=x, conv_num_filter=[num_filter] * times,
        conv_filter_size=3, conv_padding=1,
        conv_act=act_mod.Relu(), conv_with_batchnorm=True,
        conv_batchnorm_drop_rate=dropouts,
        pool_size=2, pool_stride=2, pool_type="max")


def small_vgg(input_image, num_channels, num_classes):
    """CIFAR-sized VGG (reference: networks.py small_vgg:517): four
    BN'd conv blocks (64x2, 128x2, 256x3, 512x3) with in-block dropout,
    a final pool+dropout, one 512 fc with BN, softmax head."""
    x = input_image
    for width, times, drops in ((64, 2, [0.3, 0.0]),
                                (128, 2, [0.4, 0.0]),
                                (256, 3, [0.4, 0.4, 0.0]),
                                (512, 3, [0.4, 0.4, 0.0])):
        x = _vgg_block(x, width, times, drops)
    x = v2_layer.img_pool(input=x, pool_size=2, stride=2)
    x = v2_layer.dropout(input=x, dropout_rate=0.5)
    x = v2_layer.fc(input=x, size=512)
    x = v2_layer.batch_norm(input=x, act=act_mod.Relu())
    x = v2_layer.dropout(input=x, dropout_rate=0.5)
    return v2_layer.fc(input=x, size=num_classes,
                       act=act_mod.Softmax())


def vgg_16_network(input_image, num_channels, num_classes=1000):
    """The 16-layer VGG-D configuration (reference:
    networks.py vgg_16_network:547): five plain conv blocks
    (64x2, 128x2, 256x3, 512x3, 512x3), two dropout'd 4096 fcs,
    softmax head."""
    x = input_image
    for width, times in ((64, 2), (128, 2), (256, 3), (512, 3),
                         (512, 3)):
        x = img_conv_group(
            input=x, conv_num_filter=[width] * times,
            conv_filter_size=3, conv_padding=1,
            conv_act=act_mod.Relu(),
            pool_size=2, pool_stride=2, pool_type="max")
    for _ in range(2):
        x = v2_layer.fc(input=x, size=4096, act=act_mod.Relu())
        x = v2_layer.dropout(input=x, dropout_rate=0.5)
    return v2_layer.fc(input=x, size=num_classes,
                       act=act_mod.Softmax())
