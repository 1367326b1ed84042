"""PTB/imikolov word2vec stand-in (reference: python/paddle/v2/dataset/
imikolov.py, N-gram tuples over a word vocabulary).

Counterpart of paddle_tpu/dataset/imikolov.py: the same synthetic
N-grams from `common.rng(seed)` over 2,073 words, whose next word is a
function of the context, so it gives the JAX package's samples.
"""

from .common import rng

__all__ = ["train", "test", "build_dict"]

_VOCAB = 2073
_TRAIN_N = 2048
_TEST_N = 256


def build_dict(min_word_freq=50):
    return {("w%d" % i): i for i in range(_VOCAB)}


def _reader(n, gram_n, seed):
    r = rng(seed)
    # markov-ish structure: next word correlates with sum of context
    def reader():
        for _ in range(n):
            ctx = r.randint(0, _VOCAB, size=gram_n - 1)
            nxt = int((ctx.sum() * 31 + 7) % _VOCAB)
            yield tuple(int(c) for c in ctx) + (nxt,)

    return reader


def train(word_idx=None, n=5):
    return _reader(_TRAIN_N, n, 11)


def test(word_idx=None, n=5):
    return _reader(_TEST_N, n, 12)
