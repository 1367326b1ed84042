"""Oxford-102 flowers stand-in (reference: python/paddle/v2/dataset/
flowers.py — 3x224x224 float images, 102 classes).

Counterpart of paddle_tpu/dataset/flowers.py: the same synthetic reader
from `common.rng(seed)`, so it gives the JAX package's samples.
"""

from .common import rng

__all__ = ["train", "test", "valid"]

_CLASSES = 102


def _reader(n, seed, size=224):
    r = rng(seed)

    def reader():
        for _ in range(n):
            label = int(r.randint(0, _CLASSES))
            im = r.rand(3, size, size).astype("float32")
            im[0] += label / float(_CLASSES)  # learnable signal
            yield im, label

    return reader


def train(mapper=None, buffered_size=1024, use_xmap=False):
    return _reader(256, 91)


def test(mapper=None, buffered_size=1024, use_xmap=False):
    return _reader(64, 92)


def valid(mapper=None, buffered_size=1024, use_xmap=False):
    return _reader(64, 93)
