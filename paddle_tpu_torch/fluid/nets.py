"""Composite networks built from the port's layers.

Counterpart of paddle_tpu/fluid/nets.py (reference:
python/paddle/v2/fluid/nets.py): `simple_img_conv_pool`,
`img_conv_group` and `sequence_conv_pool` over conv2d, batch_norm,
dropout, pool2d, sequence_conv and sequence_pool; `glu`; and
`scaled_dot_product_attention`, whose dense route runs `matmul` and
`softmax` over heads folded into the batch and whose `use_flash` route
is one `flash_attention` op (the hand-written kernel on the card).
Each appends the same ops as the JAX package's.
"""

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention"]


def _per_stage(value, n_stages):
    """One entry per conv stage: a scalar is repeated, a sized value
    (anything with a length but a string) must have `n_stages`."""
    if hasattr(value, "__len__") and not isinstance(value, str):
        if len(value) != n_stages:
            raise ValueError("per-stage setting has %d entries for %d "
                             "stages" % (len(value), n_stages))
        return list(value)
    return [value] * n_stages


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, param_attr=None,
                         pool_type="max"):
    """One conv with its activation, then one pool (LeNet's block)."""
    conv = layers.conv2d(input=input, num_filters=num_filters,
                         filter_size=filter_size, param_attr=param_attr,
                         act=act)
    return layers.pool2d(input=conv, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max"):
    """VGG's block: len(conv_num_filter) convs, each with its activation
    or, with batch norm, followed by a batch norm carrying the activation
    and a dropout where its rate is non-zero; then one pool."""
    n = len(conv_num_filter)
    stages = zip(conv_num_filter,
                 _per_stage(conv_filter_size, n),
                 _per_stage(conv_padding, n),
                 _per_stage(param_attr, n),
                 _per_stage(conv_with_batchnorm, n),
                 _per_stage(conv_batchnorm_drop_rate, n))
    x = input
    for filters, fsize, pad, pattr, with_bn, drop in stages:
        x = layers.conv2d(input=x, num_filters=filters, filter_size=fsize,
                          padding=pad, param_attr=pattr,
                          act=None if with_bn else conv_act)
        if with_bn:
            x = layers.batch_norm(input=x, act=conv_act)
            if drop:
                x = layers.dropout(x=x, dropout_prob=drop)
    return layers.pool2d(input=x, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    """A sequence_conv with its activation, then a sequence_pool: one
    row per sequence."""
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    """The gated linear unit: the first half of `input` along `dim` times
    the sigmoid of the second."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(x=a, y=layers.sigmoid(x=b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0, use_flash=False):
    """Multi-head scaled dot-product attention over dense [batch, seq,
    dim] tensors: the heads folded into the batch ([b, t, d] -> [b*h, t,
    d/h]), softmax(q k^T / sqrt(d/h)) v by two batched `matmul`s, and the
    heads unfolded.  `use_flash` appends one `flash_attention` op
    instead (no [t, t] matrix in memory: the same function to rounding);
    it takes no dropout and one hidden size for queries, keys and
    values."""
    if len(queries.shape) != 3 or len(keys.shape) != 3 \
            or len(values.shape) != 3:
        raise ValueError("inputs must be 3-D [batch, seq, dim]")
    d = queries.shape[-1]
    tq = queries.shape[1]
    if d != keys.shape[-1]:
        raise ValueError("queries and keys hidden dims must match")
    if keys.shape[1] != values.shape[1]:
        raise ValueError("keys and values seq lens must match")
    if d % num_heads:
        raise ValueError("hidden size must divide num_heads")
    if values.shape[-1] % num_heads:
        raise ValueError("values hidden size must divide num_heads")
    head = d // num_heads
    dv_head = values.shape[-1] // num_heads

    if use_flash:
        if dropout_rate:
            raise ValueError(
                "use_flash has no probability matrix to apply dropout "
                "to; set dropout_rate=0")
        if values.shape[-1] != d:
            raise ValueError(
                "use_flash requires matching q/k/v hidden sizes")
        return layers.flash_attention(queries, keys, values,
                                      num_heads=num_heads)

    def fold(x, per_head):
        # [b, t, d] -> [b*h, t, d/h]; one -1 per reshape, so a dynamic
        # batch dim infers
        t = x.shape[1]
        x = layers.reshape(x=x, shape=[-1, t, num_heads, per_head])
        x = layers.transpose(x=x, perm=[0, 2, 1, 3])
        return layers.reshape(x=x, shape=[-1, t, per_head])

    scores = layers.matmul(
        x=layers.scale(x=fold(queries, head), scale=head ** -0.5),
        y=fold(keys, head), transpose_y=True)     # [b*h, tq, tk]
    attn = layers.softmax(scores)
    if dropout_rate:
        attn = layers.dropout(attn, dropout_prob=dropout_rate,
                              is_test=False)
    ctx = layers.matmul(attn, fold(values, dv_head))  # [b*h, tq, dv/h]
    ctx = layers.reshape(x=ctx, shape=[-1, num_heads, tq, dv_head])
    ctx = layers.transpose(x=ctx, perm=[0, 2, 1, 3])
    return layers.reshape(x=ctx, shape=[-1, tq, num_heads * dv_head])
