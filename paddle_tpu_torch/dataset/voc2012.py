"""Pascal VOC2012 segmentation stand-in (reference: python/paddle/v2/
dataset/voc2012.py — image + per-pixel class-label map pairs).

Counterpart of paddle_tpu/dataset/voc2012.py: the same synthetic reader
from `common.rng(seed)`, so it gives the JAX package's samples.
"""

from .common import rng

__all__ = ["train", "test", "val", "CLASS_NUM"]

CLASS_NUM = 21


def _reader(n, seed, size=64):
    r = rng(seed)

    def reader():
        for _ in range(n):
            im = r.rand(3, size, size).astype("float32")
            # blocky label map correlated with channel 0
            lab = (im[0] * CLASS_NUM).astype("int64") % CLASS_NUM
            yield im, lab

    return reader


def train():
    return _reader(128, 95)


def test():
    return _reader(32, 96)


def val():
    return _reader(32, 97)
