"""Datasets with the reference's reader API (reference:
python/paddle/v2/dataset/): `mnist`, `cifar`, `imdb` and `conll05`,
the counterparts of the JAX package's modules of those names, read
local files, or download them only when PADDLE_TPU_ALLOW_DOWNLOAD=1 is
set, and fall back to a deterministic synthetic stand-in otherwise
(common.py); `wmt14`, `imikolov`, `movielens` and `uci_housing` are the
JAX package's synthetic stand-ins.  Every synthetic reader gives the
JAX package's samples."""

from . import (cifar, common, conll05, imdb, imikolov, mnist, movielens,
               uci_housing, wmt14)

__all__ = ["cifar", "common", "conll05", "imdb", "imikolov", "mnist",
           "movielens", "uci_housing", "wmt14"]
