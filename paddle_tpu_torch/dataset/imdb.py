"""IMDB sentiment (reference: python/paddle/v2/dataset/imdb.py): the
aclImdb tarball tokenized (punctuation stripped, lowercased), a
frequency-ranked dictionary above a cutoff (ties alphabetical, '<unk>'
last), readers of (word-id list, 0 = pos / 1 = neg).

Counterpart of paddle_tpu/dataset/imdb.py: the same parser, used only
where the tarball is already on the machine (or given by path), and
the same synthetic fallback from `common.synthetic_sequences`, so it
gives the JAX package's samples: a dictionary of 5,147 words (the size
of the cutoff-150 dictionary), 512 train and 128 test sequences of
8-60 ids.
"""

import os
import re
import string
import tarfile
from collections import Counter

from .common import fetch_or_none, synthetic_sequences

__all__ = ["train", "test", "word_dict", "tokenize", "build_dict"]

URL = "http://ai.stanford.edu/%7Eamaas/data/sentiment/aclImdb_v1.tar.gz"
MD5 = "7c2ac02c03563afcf9b574c7e56c153a"

TRAIN_POS_PATTERN = re.compile(r"aclImdb/train/pos/.*\.txt$")
TRAIN_NEG_PATTERN = re.compile(r"aclImdb/train/neg/.*\.txt$")
TEST_POS_PATTERN = re.compile(r"aclImdb/test/pos/.*\.txt$")
TEST_NEG_PATTERN = re.compile(r"aclImdb/test/neg/.*\.txt$")

_PUNCT_TABLE = str.maketrans("", "", string.punctuation)

_SYNTH_VOCAB = 5147
_SYNTH_TRAIN_N = 512
_SYNTH_TEST_N = 128


def tokenize(tar_path, name_pattern):
    """Yield one token list per tar member matching `name_pattern`."""
    with tarfile.open(tar_path) as tf:
        # sequential walk (tf is its own iterator) — random-access
        # extractfile per member would thrash the archive
        for member in tf:
            if not name_pattern.match(member.name):
                continue
            text = tf.extractfile(member).read().decode(
                "utf-8", errors="ignore")
            yield text.rstrip("\n\r").translate(_PUNCT_TABLE) \
                .lower().split()


def build_dict(tar_path, name_pattern, cutoff=1):
    """Frequency-ranked word ids over matching members; words at or
    below `cutoff` occurrences are dropped; '<unk>' gets the last id."""
    freq = Counter()
    for doc in tokenize(tar_path, name_pattern):
        freq.update(doc)
    kept = sorted(((w, c) for w, c in freq.items() if c > cutoff),
                  key=lambda wc: (-wc[1], wc[0]))
    word_idx = {w: i for i, (w, _) in enumerate(kept)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def _tar_reader(tar_path, pos_pattern, neg_pattern, word_idx):
    unk = word_idx["<unk>"]

    def reader():
        for pattern, label in ((pos_pattern, 0), (neg_pattern, 1)):
            for doc in tokenize(tar_path, pattern):
                yield [word_idx.get(w, unk) for w in doc], label

    return reader


def _synthetic_reader(n, seed):
    data = synthetic_sequences(n, _SYNTH_VOCAB, 2, seed, min_len=8,
                               max_len=60)

    def reader():
        for seq, label in data:
            yield seq, label

    return reader


def _tar_or_none(tar_path):
    if tar_path is not None:
        if not os.path.exists(tar_path):
            raise FileNotFoundError("imdb: %r does not exist" % tar_path)
        return tar_path
    tar_path = fetch_or_none(URL, "imdb", MD5)
    if tar_path and os.path.exists(tar_path):
        return tar_path
    return None


# full-corpus dict builds are a sequential scan of the whole tarball;
# memoize per (path, mtime) so train()+test() share one scan
_dict_cache = {}


def word_dict(tar_path=None, cutoff=150):
    """reference: imdb.py word_dict() — dict over the whole corpus."""
    tar_path = _tar_or_none(tar_path)
    if tar_path:
        key = (tar_path, os.path.getmtime(tar_path), cutoff)
        if key not in _dict_cache:
            _dict_cache[key] = build_dict(
                tar_path, re.compile(r"aclImdb/((train)|(test))/"
                                     r"((pos)|(neg))/.*\.txt$"), cutoff)
        return _dict_cache[key]
    return {("w%d" % i): i for i in range(_SYNTH_VOCAB)}


def train(word_idx=None, tar_path=None):
    tar_path = _tar_or_none(tar_path)
    if tar_path:
        if word_idx is None:
            word_idx = word_dict(tar_path)
        return _tar_reader(tar_path, TRAIN_POS_PATTERN,
                           TRAIN_NEG_PATTERN, word_idx)
    return _synthetic_reader(_SYNTH_TRAIN_N, 7)


def test(word_idx=None, tar_path=None):
    tar_path = _tar_or_none(tar_path)
    if tar_path:
        if word_idx is None:
            word_idx = word_dict(tar_path)
        return _tar_reader(tar_path, TEST_POS_PATTERN,
                           TEST_NEG_PATTERN, word_idx)
    return _synthetic_reader(_SYNTH_TEST_N, 8)
