"""WMT14 translation stand-in (reference: python/paddle/v2/dataset/
wmt14.py): (src_ids, trg_ids, trg_ids_next) samples with <s>, <e> and
<unk> marks.

Counterpart of paddle_tpu/dataset/wmt14.py: the same synthetic reader
from `common.rng(seed)`, so it gives the JAX package's samples for the
same `dict_size`.  Sources have 3-19 ids; each target is the reversed
source offset by 17 (a learnable mapping), behind <s> for the decoder's
input and ahead of <e> for its next-word labels.
"""

from .common import rng

__all__ = ["train", "test", "ID_MARK_START", "ID_MARK_END", "ID_MARK_UNK"]

ID_MARK_START = 0
ID_MARK_END = 1
ID_MARK_UNK = 2

_DICT = 30000


def _reader(n, dict_size, seed):
    r = rng(seed)

    def reader():
        for _ in range(n):
            src_len = int(r.randint(3, 20))
            src = r.randint(3, dict_size, size=src_len).tolist()
            trg = [max(3, (t + 17) % dict_size) for t in reversed(src)]
            yield src, [ID_MARK_START] + trg, trg + [ID_MARK_END]

    return reader


def train(dict_size=_DICT):
    return _reader(1024, dict_size, 55)


def test(dict_size=_DICT):
    return _reader(128, dict_size, 56)
