"""Image models built through the port's fluid layers: the ResNets.

Counterpart of paddle_tpu/models/image.py:142-218 (reference:
benchmark/paddle/image/resnet.py, tests/book/
test_image_classification_train.py resnet_cifar10).  Each builder takes
an NCHW `image` Variable and returns the logits.  Convolutions have no
bias and are each followed by a batch norm; the ImageNet ResNets start
with a 7x7/2 conv and a 3x3/2 max pool and end with a global average
pool and an fc.  `bench.py`'s default model is `resnet50`.  The other
image models of the JAX package wait (ROADMAP A).
"""

from ..fluid import layers

__all__ = ["resnet", "resnet50", "resnet_cifar10"]


def _conv_bn(input, ch_out, filter_size, stride, padding, act="relu"):
    conv = layers.conv2d(input=input, num_filters=ch_out,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act)


def _shortcut(input, ch_out, stride):
    if input.shape[1] != ch_out or stride != 1:
        return _conv_bn(input, ch_out, 1, stride, 0, act=None)
    return input


def _basic_block(input, ch_out, stride):
    short = _shortcut(input, ch_out, stride)
    conv1 = _conv_bn(input, ch_out, 3, stride, 1)
    conv2 = _conv_bn(conv1, ch_out, 3, 1, 1, act=None)
    return layers.elementwise_add(x=short, y=conv2, act="relu")


def _bottleneck_block(input, ch_out, stride):
    short = _shortcut(input, ch_out * 4, stride)
    conv1 = _conv_bn(input, ch_out, 1, stride, 0)
    conv2 = _conv_bn(conv1, ch_out, 3, 1, 1)
    conv3 = _conv_bn(conv2, ch_out * 4, 1, 1, 0, act=None)
    return layers.elementwise_add(x=short, y=conv3, act="relu")


def _layer_group(block_fn, input, ch_out, count, stride):
    t = block_fn(input, ch_out, stride)
    for _ in range(count - 1):
        t = block_fn(t, ch_out, 1)
    return t


def resnet(image, class_dim=1000, depth=50):
    """ImageNet ResNet of `depth` 18, 34, 50, 101 or 152."""
    block_fn, counts = {
        18: (_basic_block, [2, 2, 2, 2]),
        34: (_basic_block, [3, 4, 6, 3]),
        50: (_bottleneck_block, [3, 4, 6, 3]),
        101: (_bottleneck_block, [3, 4, 23, 3]),
        152: (_bottleneck_block, [3, 8, 36, 3]),
    }[depth]
    t = _conv_bn(image, 64, 7, 2, 3)
    t = layers.pool2d(input=t, pool_size=3, pool_stride=2, pool_padding=1)
    for i, (ch, count) in enumerate(zip([64, 128, 256, 512], counts)):
        t = _layer_group(block_fn, t, ch, count, 1 if i == 0 else 2)
    t = layers.pool2d(input=t, pool_size=7, pool_type="avg",
                      global_pooling=True)
    return layers.fc(input=t, size=class_dim, act=None)


def resnet50(image, class_dim=1000):
    return resnet(image, class_dim, depth=50)


def resnet_cifar10(image, class_dim=10, depth=32):
    """CIFAR ResNet: depth 6n + 2, basic blocks at 16, 32, 64 channels."""
    if (depth - 2) % 6:
        raise ValueError("resnet_cifar10 depth must be 6n + 2, got %d"
                         % depth)
    n = (depth - 2) // 6
    t = _conv_bn(image, 16, 3, 1, 1)
    t = _layer_group(_basic_block, t, 16, n, 1)
    t = _layer_group(_basic_block, t, 32, n, 2)
    t = _layer_group(_basic_block, t, 64, n, 2)
    t = layers.pool2d(input=t, pool_size=8, pool_type="avg",
                      global_pooling=True)
    return layers.fc(input=t, size=class_dim, act=None)
