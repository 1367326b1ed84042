"""Model programs built through the port's fluid layers.  The image
builders, the stacked-LSTM and convolution text classifiers, the
seq2seq translation model, the word2vec N-gram model and the DeepFM CTR
model are exported here under the JAX package's names."""

from .ctr import deepfm, deepfm_ctr
from .image import (alexnet, googlenet, lenet5, mlp, resnet, resnet50,
                    resnet101, resnet_cifar10, smallnet_mnist_cifar, vgg, vgg16,
                    vgg19)
from .text import (conv_text_classifier, seq2seq,
                   stacked_lstm_text_classifier, word2vec_ngram)

__all__ = ["deepfm", "deepfm_ctr", "alexnet", "googlenet", "lenet5", "mlp",
           "resnet", "resnet50", "resnet101",
           "resnet_cifar10", "smallnet_mnist_cifar", "vgg", "vgg16",
           "vgg19", "stacked_lstm_text_classifier", "conv_text_classifier",
           "seq2seq", "word2vec_ngram"]
