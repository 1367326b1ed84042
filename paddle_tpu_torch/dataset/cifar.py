"""CIFAR-10/100 (counterpart of paddle_tpu/dataset/cifar.py, the same
code): real pickled-batch tarball parsing with synthetic
fallback.

reference: python/paddle/v2/dataset/cifar.py reader_creator — walk the
tar members whose name contains the split marker, unpickle each batch
dict, yield (pixels/255 as float32 [3072], int label); CIFAR-100 labels
come from 'fine_labels'.
"""

import os
import pickle
import tarfile

import numpy as np

from .common import fetch_or_none, synthetic_images

__all__ = ["train10", "test10", "train100", "test100",
           "reader_creator"]

URL_PREFIX = "https://www.cs.toronto.edu/~kriz/"
CIFAR10_URL = URL_PREFIX + "cifar-10-python.tar.gz"
CIFAR10_MD5 = "c58f30108f718f92721af3b95e74349a"
CIFAR100_URL = URL_PREFIX + "cifar-100-python.tar.gz"
CIFAR100_MD5 = "eb9058c3a382ffc7106e4002c42a8d85"

_SYNTH_TRAIN_N = 1024
_SYNTH_TEST_N = 256


def _batch_samples(batch):
    data = batch[b"data"] if b"data" in batch else batch["data"]
    labels = None
    for key in (b"labels", "labels", b"fine_labels", "fine_labels"):
        if key in batch:
            labels = batch[key]
            break
    if labels is None:
        raise ValueError("cifar batch has no labels/fine_labels")
    data = np.asarray(data, np.float32) / 255.0
    for row, label in zip(data, labels):
        yield row, int(label)


def reader_creator(tar_path, split_marker):
    """Yield samples from every member whose name contains
    `split_marker` ('data_batch'/'test_batch' for CIFAR-10,
    'train'/'test' for CIFAR-100)."""

    def reader():
        with tarfile.open(tar_path, mode="r") as tf:
            for member in tf:
                if split_marker not in member.name or member.isdir():
                    continue
                batch = pickle.load(tf.extractfile(member),
                                    encoding="bytes")
                yield from _batch_samples(batch)

    return reader


def _synthetic_reader(n, classes, seed):
    imgs, labels = synthetic_images(n, (3072,), classes, seed)

    def reader():
        for i in range(imgs.shape[0]):
            yield imgs[i], int(labels[i])

    return reader


def _make(url, md5, marker, classes, synth_n, seed, tar_path=None):
    if tar_path is not None:
        # an explicit path must exist — silently training on synthetic
        # data because of a typo would be worse than failing
        if not os.path.exists(tar_path):
            raise FileNotFoundError("cifar: %r does not exist" % tar_path)
        return reader_creator(tar_path, marker)
    tar_path = fetch_or_none(url, "cifar", md5)
    if tar_path and os.path.exists(tar_path):
        return reader_creator(tar_path, marker)
    return _synthetic_reader(synth_n, classes, seed)


def train10(tar_path=None):
    return _make(CIFAR10_URL, CIFAR10_MD5, "data_batch", 10,
                 _SYNTH_TRAIN_N, 100, tar_path)


def test10(tar_path=None):
    return _make(CIFAR10_URL, CIFAR10_MD5, "test_batch", 10,
                 _SYNTH_TEST_N, 101, tar_path)


def train100(tar_path=None):
    return _make(CIFAR100_URL, CIFAR100_MD5, "train", 100,
                 _SYNTH_TRAIN_N, 102, tar_path)


def test100(tar_path=None):
    return _make(CIFAR100_URL, CIFAR100_MD5, "test", 100,
                 _SYNTH_TEST_N, 103, tar_path)
