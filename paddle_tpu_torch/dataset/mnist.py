"""MNIST dataset (counterpart of paddle_tpu/dataset/mnist.py, the same
code): real idx-format parsing with synthetic fallback.

reference: python/paddle/v2/dataset/mnist.py:37 (reader_creator over
the gzip idx3/idx1 pair; images scaled to [-1, 1], int labels 0-9).
The reference shells out to zcat; here the gzip module + one
numpy.frombuffer per file does the same decode without subprocesses.
"""

import gzip
import os
import struct

import numpy as np

from .common import fetch_or_none, synthetic_images

__all__ = ["train", "test", "parse_idx_images", "parse_idx_labels"]

URL_PREFIX = "http://yann.lecun.com/exdb/mnist/"
TRAIN_IMAGE_URL = URL_PREFIX + "train-images-idx3-ubyte.gz"
TRAIN_IMAGE_MD5 = "f68b3c2dcbeaaa9fbdd348bbdeb94873"
TRAIN_LABEL_URL = URL_PREFIX + "train-labels-idx1-ubyte.gz"
TRAIN_LABEL_MD5 = "d53e105ee54ea40749a09fcbcd1e9432"
TEST_IMAGE_URL = URL_PREFIX + "t10k-images-idx3-ubyte.gz"
TEST_IMAGE_MD5 = "9fb629c4189551a2d022fa330f9573f3"
TEST_LABEL_URL = URL_PREFIX + "t10k-labels-idx1-ubyte.gz"
TEST_LABEL_MD5 = "ec29112dd5afa0611ce80d1b7f02629c"

_IDX_IMAGE_MAGIC = 2051
_IDX_LABEL_MAGIC = 2049

_SYNTH_TRAIN_N = 2048
_SYNTH_TEST_N = 512


def _open_maybe_gz(path):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def parse_idx_images(path):
    """idx3-ubyte -> float32 [n, rows*cols] scaled to [-1, 1]."""
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != _IDX_IMAGE_MAGIC:
            raise ValueError("%s: bad idx3 magic %d" % (path, magic))
        raw = np.frombuffer(f.read(n * rows * cols), np.uint8)
    images = raw.reshape(n, rows * cols).astype(np.float32)
    return images / 255.0 * 2.0 - 1.0


def parse_idx_labels(path):
    """idx1-ubyte -> int64 [n]."""
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != _IDX_LABEL_MAGIC:
            raise ValueError("%s: bad idx1 magic %d" % (path, magic))
        raw = np.frombuffer(f.read(n), np.uint8)
    return raw.astype(np.int64)


def reader_creator(image_path, label_path):
    def reader():
        images = parse_idx_images(image_path)
        labels = parse_idx_labels(label_path)
        if images.shape[0] != labels.shape[0]:
            raise ValueError("mnist: %d images vs %d labels"
                             % (images.shape[0], labels.shape[0]))
        for i in range(images.shape[0]):
            yield images[i], int(labels[i])

    return reader


def _synthetic_reader(n, seed):
    imgs, labels = synthetic_images(n, (784,), 10, seed)

    def reader():
        for i in range(imgs.shape[0]):
            yield imgs[i], int(labels[i])

    return reader


def _make(image_url, image_md5, label_url, label_md5, synth_n, seed,
          image_path=None, label_path=None):
    explicit = image_path is not None or label_path is not None
    if image_path is None:
        image_path = fetch_or_none(image_url, "mnist", image_md5)
    if label_path is None:
        label_path = fetch_or_none(label_url, "mnist", label_md5)
    if explicit:
        # explicit paths must both resolve — never silently swap a
        # user-supplied file for synthetic data
        for p in (image_path, label_path):
            if not p or not os.path.exists(p):
                raise FileNotFoundError(
                    "mnist: %r does not exist (explicit paths require "
                    "both image and label files)" % (p,))
        return reader_creator(image_path, label_path)
    if image_path and label_path and os.path.exists(image_path) \
            and os.path.exists(label_path):
        return reader_creator(image_path, label_path)
    return _synthetic_reader(synth_n, seed)


def train(image_path=None, label_path=None):
    """Real idx files when available (downloaded or passed explicitly);
    deterministic synthetic digits otherwise."""
    return _make(TRAIN_IMAGE_URL, TRAIN_IMAGE_MD5, TRAIN_LABEL_URL,
                 TRAIN_LABEL_MD5, _SYNTH_TRAIN_N, 42,
                 image_path, label_path)


def test(image_path=None, label_path=None):
    return _make(TEST_IMAGE_URL, TEST_IMAGE_MD5, TEST_LABEL_URL,
                 TEST_LABEL_MD5, _SYNTH_TEST_N, 43,
                 image_path, label_path)
