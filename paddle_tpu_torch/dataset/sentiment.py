"""NLTK movie-review sentiment stand-in (reference:
python/paddle/v2/dataset/sentiment.py — word-id sequences + 0/1 polarity
labels over a 2-class corpus).

Counterpart of paddle_tpu/dataset/sentiment.py: the same synthetic reader
from `common.rng(seed)`, so it gives the JAX package's samples.
"""

from .common import rng

__all__ = ["train", "test", "get_word_dict", "NUM_TRAINING_INSTANCES",
           "NUM_TOTAL_INSTANCES"]

_VOCAB = 5147
NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000


def get_word_dict():
    return {("w%d" % i): i for i in range(_VOCAB)}


def _reader(n, seed):
    r = rng(seed)

    def reader():
        for _ in range(n):
            length = int(r.randint(8, 60))
            # polarity-correlated token distribution: class k draws
            # more tokens from its half of the vocab
            label = int(r.randint(0, 2))
            lo = 0 if label == 0 else _VOCAB // 2
            words = (lo + r.randint(0, _VOCAB // 2,
                                    size=length)).tolist()
            yield words, label

    return reader


def train():
    return _reader(NUM_TRAINING_INSTANCES, 71)


def test():
    return _reader(NUM_TOTAL_INSTANCES - NUM_TRAINING_INSTANCES, 72)
