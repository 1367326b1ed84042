"""Composite image networks built from the port's layers.

Counterpart of paddle_tpu/fluid/nets.py `simple_img_conv_pool` and
`img_conv_group` (reference: python/paddle/v2/fluid/nets.py): graph
builders over conv2d, batch_norm, dropout and pool2d, appending the same
ops as the JAX package's.  The sequence nets wait for ragged inputs
(ROADMAP A7).
"""

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group"]


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
