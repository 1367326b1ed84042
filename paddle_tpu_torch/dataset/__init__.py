"""Datasets with the reference's reader API (reference:
python/paddle/v2/dataset/): `mnist` and `cifar`, the counterparts of
paddle_tpu/dataset/mnist.py and cifar.py.  Each reads local files, or
downloads them only when PADDLE_TPU_ALLOW_DOWNLOAD=1 is set, and falls
back to a deterministic synthetic stand-in otherwise (common.py)."""

from . import cifar, common, mnist

__all__ = ["cifar", "common", "mnist"]
