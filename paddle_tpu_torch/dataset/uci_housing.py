"""UCI housing stand-in (reference: python/paddle/v2/dataset/
uci_housing.py, 13 features and a scalar target).

Counterpart of paddle_tpu/dataset/uci_housing.py: the same linear data
from `common.synthetic_linear` (404 train and 102 test rows), so it
gives the JAX package's samples.
"""

from .common import synthetic_linear

__all__ = ["train", "test", "feature_num"]

feature_num = 13
_TRAIN_N = 404
_TEST_N = 102


def train():
    x, y = synthetic_linear(_TRAIN_N, feature_num, w_seed=1000, x_seed=1)

    def reader():
        for i in range(x.shape[0]):
            yield x[i], y[i]

    return reader


def test():
    x, y = synthetic_linear(_TEST_N, feature_num, w_seed=1000, x_seed=7)

    def reader():
        for i in range(x.shape[0]):
            yield x[i], y[i]

    return reader
