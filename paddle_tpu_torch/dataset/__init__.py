"""Datasets with the reference's reader API (reference:
python/paddle/v2/dataset/): `mnist` and `cifar`, the counterparts of
paddle_tpu/dataset/mnist.py and cifar.py, read local files, or
download them only when PADDLE_TPU_ALLOW_DOWNLOAD=1 is set, and fall
back to a deterministic synthetic stand-in otherwise (common.py);
`wmt14` is the JAX package's synthetic translation stand-in."""

from . import cifar, common, mnist, wmt14

__all__ = ["cifar", "common", "mnist", "wmt14"]
