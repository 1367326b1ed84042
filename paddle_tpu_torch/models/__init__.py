"""Model programs built through the port's fluid layers.  The image
builders are exported here under the JAX package's names."""

from .image import (alexnet, googlenet, lenet5, mlp, resnet, resnet50,
                    resnet_cifar10, smallnet_mnist_cifar, vgg, vgg16,
                    vgg19)

__all__ = ["alexnet", "googlenet", "lenet5", "mlp", "resnet", "resnet50",
           "resnet_cifar10", "smallnet_mnist_cifar", "vgg", "vgg16",
           "vgg19"]
