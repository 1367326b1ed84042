"""Image models built through the port's fluid layers: the small nets,
AlexNet, VGG, the ResNets and GoogLeNet.

Counterpart of paddle_tpu/models/image.py (reference:
benchmark/paddle/image/{alexnet,vgg,resnet,googlenet,
smallnet_mnist_cifar}.py, tests/book/test_recognize_digits.py,
tests/book/test_image_classification_train.py).  Each builder takes an
NCHW `image` Variable and returns the logits, appending the same ops,
in the same order, as the JAX package's builder of the same name.
`bench.py`'s default model is `resnet50`; it names `alexnet`, `vgg16`,
`vgg19`, `googlenet` and `smallnet` (`smallnet_mnist_cifar`) too.
"""

from ..fluid import layers, nets

__all__ = ["mlp", "lenet5", "smallnet_mnist_cifar", "alexnet", "vgg",
           "vgg16", "vgg19", "resnet", "resnet50", "resnet_cifar10",
           "googlenet"]


def mlp(image, class_dim=10, hidden_sizes=(128, 64), act="relu"):
    """The MNIST book test's MLP: fc layers of `hidden_sizes`, then the
    class fc."""
    hidden = image
    for size in hidden_sizes:
        hidden = layers.fc(input=hidden, size=size, act=act)
    return layers.fc(input=hidden, size=class_dim, act=None)


def lenet5(image, class_dim=10):
    """The MNIST book test's conv net: two 5x5 conv + 2x2/2 max-pool
    blocks (20 and 50 filters), then the class fc."""
    conv1 = nets.simple_img_conv_pool(
        input=image, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    conv2 = nets.simple_img_conv_pool(
        input=conv1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    return layers.fc(input=conv2, size=class_dim, act=None)


def smallnet_mnist_cifar(image, class_dim=10):
    """The CIFAR-quick 'SmallNet': conv5(pad 2) + maxpool3/2, conv5 +
    avgpool3/2, conv3(pad 1) + avgpool3/2 (pools padded 1, so 32x32
    inputs survive), fc64, the class fc."""
    t = layers.conv2d(input=image, num_filters=32, filter_size=5,
                      padding=2, act="relu")
    t = layers.pool2d(input=t, pool_size=3, pool_stride=2,
                      pool_padding=1, pool_type="max")
    t = layers.conv2d(input=t, num_filters=32, filter_size=5,
                      padding=2, act="relu")
    t = layers.pool2d(input=t, pool_size=3, pool_stride=2,
                      pool_padding=1, pool_type="avg")
    t = layers.conv2d(input=t, num_filters=64, filter_size=3,
                      padding=1, act="relu")
    t = layers.pool2d(input=t, pool_size=3, pool_stride=2,
                      pool_padding=1, pool_type="avg")
    hidden = layers.fc(input=t, size=64, act="relu")
    return layers.fc(input=hidden, size=class_dim, act=None)


def alexnet(image, class_dim=1000, use_lrn=True):
    """AlexNet: 11x11/4, 5x5 (2 groups), three 3x3 convs (two grouped),
    lrn after the first two, 3x3/2 max pools, two fc 4096 with dropout
    0.5, the class fc."""
    t = layers.conv2d(input=image, num_filters=96, filter_size=11,
                      stride=4, padding=1, act="relu")
    if use_lrn:
        t = layers.lrn(input=t, n=5, alpha=0.0001, beta=0.75)
    t = layers.pool2d(input=t, pool_size=3, pool_stride=2)
    t = layers.conv2d(input=t, num_filters=256, filter_size=5, padding=2,
                      groups=2, act="relu")
    if use_lrn:
        t = layers.lrn(input=t, n=5, alpha=0.0001, beta=0.75)
    t = layers.pool2d(input=t, pool_size=3, pool_stride=2)
    t = layers.conv2d(input=t, num_filters=384, filter_size=3, padding=1,
                      act="relu")
    t = layers.conv2d(input=t, num_filters=384, filter_size=3, padding=1,
                      groups=2, act="relu")
    t = layers.conv2d(input=t, num_filters=256, filter_size=3, padding=1,
                      groups=2, act="relu")
    t = layers.pool2d(input=t, pool_size=3, pool_stride=2)
    t = layers.fc(input=t, size=4096, act="relu")
    t = layers.dropout(x=t, dropout_prob=0.5)
    t = layers.fc(input=t, size=4096, act="relu")
    t = layers.dropout(x=t, dropout_prob=0.5)
    return layers.fc(input=t, size=class_dim, act=None)


def vgg(image, class_dim=1000, depth=16, with_bn=False, drop_rate=0.0,
        fc_size=4096):
    """VGG of `depth` 11, 13, 16 or 19: five `img_conv_group` blocks of
    3x3 convs at 64..512 channels with 2x2/2 max pools, two fc of
    `fc_size` (dropout after each when `drop_rate`), the class fc."""
    cfg = {
        11: [1, 1, 2, 2, 2],
        13: [2, 2, 2, 2, 2],
        16: [2, 2, 3, 3, 3],
        19: [2, 2, 4, 4, 4],
    }[depth]
    t = image
    for n_convs, ch in zip(cfg, [64, 128, 256, 512, 512]):
        t = nets.img_conv_group(
            input=t, conv_num_filter=[ch] * n_convs, pool_size=2,
            pool_stride=2, conv_filter_size=3, conv_act="relu",
            conv_with_batchnorm=with_bn,
            conv_batchnorm_drop_rate=drop_rate)
    t = layers.fc(input=t, size=fc_size, act="relu")
    if drop_rate:
        t = layers.dropout(x=t, dropout_prob=drop_rate)
    t = layers.fc(input=t, size=fc_size, act="relu")
    if drop_rate:
        t = layers.dropout(x=t, dropout_prob=drop_rate)
    return layers.fc(input=t, size=class_dim, act=None)


def vgg16(image, class_dim=1000, **kw):
    return vgg(image, class_dim, depth=16, **kw)


def vgg19(image, class_dim=1000, **kw):
    return vgg(image, class_dim, depth=19, **kw)


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


def resnet101(image, class_dim=1000):
    return resnet(image, class_dim, depth=101)


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


def _inception(input, ch1, ch3r, ch3, ch5r, ch5, proj):
    b1 = layers.conv2d(input=input, num_filters=ch1, filter_size=1,
                       act="relu")
    b2 = layers.conv2d(input=input, num_filters=ch3r, filter_size=1,
                       act="relu")
    b2 = layers.conv2d(input=b2, num_filters=ch3, filter_size=3, padding=1,
                       act="relu")
    b3 = layers.conv2d(input=input, num_filters=ch5r, filter_size=1,
                       act="relu")
    b3 = layers.conv2d(input=b3, num_filters=ch5, filter_size=5, padding=2,
                       act="relu")
    b4 = layers.pool2d(input=input, pool_size=3, pool_stride=1,
                       pool_padding=1)
    b4 = layers.conv2d(input=b4, num_filters=proj, filter_size=1,
                       act="relu")
    return layers.concat(input=[b1, b2, b3, b4], axis=1)


def googlenet(image, class_dim=1000):
    """GoogLeNet v1: the 7x7/2 stem, nine inception blocks (3a-5b) with
    3x3/2 max pools between stages, a global average pool, dropout 0.4,
    the class fc."""
    t = layers.conv2d(input=image, num_filters=64, filter_size=7, stride=2,
                      padding=3, act="relu")
    t = layers.pool2d(input=t, pool_size=3, pool_stride=2)
    t = layers.conv2d(input=t, num_filters=64, filter_size=1, act="relu")
    t = layers.conv2d(input=t, num_filters=192, filter_size=3, padding=1,
                      act="relu")
    t = layers.pool2d(input=t, pool_size=3, pool_stride=2)
    t = _inception(t, 64, 96, 128, 16, 32, 32)       # 3a
    t = _inception(t, 128, 128, 192, 32, 96, 64)     # 3b
    t = layers.pool2d(input=t, pool_size=3, pool_stride=2)
    t = _inception(t, 192, 96, 208, 16, 48, 64)      # 4a
    t = _inception(t, 160, 112, 224, 24, 64, 64)     # 4b
    t = _inception(t, 128, 128, 256, 24, 64, 64)     # 4c
    t = _inception(t, 112, 144, 288, 32, 64, 64)     # 4d
    t = _inception(t, 256, 160, 320, 32, 128, 128)   # 4e
    t = layers.pool2d(input=t, pool_size=3, pool_stride=2)
    t = _inception(t, 256, 160, 320, 32, 128, 128)   # 5a
    t = _inception(t, 384, 192, 384, 48, 128, 128)   # 5b
    t = layers.pool2d(input=t, pool_size=7, pool_type="avg",
                      global_pooling=True)
    t = layers.dropout(x=t, dropout_prob=0.4)
    return layers.fc(input=t, size=class_dim, act=None)
