"""MQ2007 learning-to-rank stand-in (reference: python/paddle/v2/
dataset/mq2007.py — query groups of 46-dim feature vectors with
relevance labels; pairwise/listwise reader modes).

Counterpart of paddle_tpu/dataset/mq2007.py: the same synthetic reader
from `common.rng(seed)`, so it gives the JAX package's samples.
"""

from .common import rng

__all__ = ["train", "test", "FEATURE_DIM"]

FEATURE_DIM = 46


def _reader(n_queries, seed, format="pairwise"):
    r = rng(seed)

    def reader():
        for _ in range(n_queries):
            docs = int(r.randint(5, 20))
            feats = r.uniform(-1, 1,
                              size=(docs, FEATURE_DIM)).astype("float32")
            # relevance correlates with feature sum
            rel = (feats.sum(1) > 0).astype("int64") + \
                (feats.sum(1) > 1).astype("int64")
            if format == "listwise":
                yield feats, rel
                continue
            for i in range(docs):
                for j in range(docs):
                    if rel[i] > rel[j]:
                        yield 1.0, feats[i], feats[j]

    return reader


def train(format="pairwise"):
    return _reader(64, 81, format)


def test(format="pairwise"):
    return _reader(16, 82, format)
