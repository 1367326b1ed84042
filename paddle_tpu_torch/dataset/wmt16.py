"""WMT16 translation stand-in (reference: python/paddle/v2/dataset/
wmt16.py — same (src, trg_in, trg_next) triples as wmt14 with a
configurable vocab).

Counterpart of paddle_tpu/dataset/wmt16.py: the same synthetic reader
from `common.rng(seed)`, so it gives the JAX package's samples.
"""

from . import wmt14

__all__ = ["train", "test", "get_dict"]


def get_dict(lang, dict_size):
    return {("%s%d" % (lang, i)): i for i in range(dict_size)}


def train(src_dict_size=10000, trg_dict_size=10000, src_lang="en"):
    return wmt14._reader(1024, min(src_dict_size, trg_dict_size), 61)


def test(src_dict_size=10000, trg_dict_size=10000, src_lang="en"):
    return wmt14._reader(128, min(src_dict_size, trg_dict_size), 62)
