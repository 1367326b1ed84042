"""Model programs built through the port's fluid layers.  The image
builders, the stacked-LSTM text classifier, the seq2seq translation
model and the DeepFM CTR model are exported here under the JAX
package's names."""

from .ctr import deepfm, deepfm_ctr
from .image import (alexnet, googlenet, lenet5, mlp, resnet, resnet50,
                    resnet_cifar10, smallnet_mnist_cifar, vgg, vgg16,
                    vgg19)
from .text import seq2seq, stacked_lstm_text_classifier

__all__ = ["deepfm", "deepfm_ctr", "alexnet", "googlenet", "lenet5", "mlp",
           "resnet", "resnet50",
           "resnet_cifar10", "smallnet_mnist_cifar", "vgg", "vgg16",
           "vgg19", "stacked_lstm_text_classifier", "seq2seq"]
