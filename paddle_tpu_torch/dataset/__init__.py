"""Datasets with the reference's reader API (reference:
python/paddle/v2/dataset/): `mnist`, `cifar`, `imdb` and `conll05`,
the counterparts of the JAX package's modules of those names, read
local files, or download them only when PADDLE_TPU_ALLOW_DOWNLOAD=1 is
set, and fall back to a deterministic synthetic stand-in otherwise
(common.py); `wmt14`, `wmt16`, `imikolov`, `movielens`, `uci_housing`,
`flowers`, `mq2007`, `sentiment` and `voc2012` are the JAX package's
synthetic stand-ins.  Every synthetic reader gives the
JAX package's samples."""

from . import (cifar, common, conll05, flowers, imdb, imikolov, mnist,
               movielens, mq2007, sentiment, uci_housing, voc2012, wmt14,
               wmt16)

__all__ = ["cifar", "common", "conll05", "flowers", "imdb", "imikolov",
           "mnist", "movielens", "mq2007", "sentiment", "uci_housing",
           "voc2012", "wmt14", "wmt16"]
