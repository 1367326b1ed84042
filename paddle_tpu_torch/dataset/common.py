"""Shared dataset machinery: the local cache, checksums, opt-in
downloads and the seeded synthetic fallbacks.

Counterpart of paddle_tpu/dataset/common.py (reference:
python/paddle/v2/dataset/common.py), the same code and the same seeded
generators, so a synthetic reader gives the JAX package's samples.  Files are read from
DATA_HOME (`PADDLE_TPU_DATA_HOME`, else ~/.cache/paddle_tpu/dataset);
a fetch from the network happens only with PADDLE_TPU_ALLOW_DOWNLOAD=1
(and PADDLE_TPU_OFFLINE unset).  Otherwise each dataset falls back to a
deterministic synthetic stand-in with the real data's shapes, dtypes
and reader API.
"""

import hashlib
import os

import numpy as np

from ..resilience import faults as _faults
from ..resilience.retry import RetryPolicy

__all__ = ["DATA_HOME", "md5file", "download", "fetch_or_none",
           "rng", "synthetic_linear", "synthetic_images",
           "synthetic_sequences"]

DATA_HOME = os.environ.get(
    "PADDLE_TPU_DATA_HOME",
    os.path.expanduser("~/.cache/paddle_tpu/dataset"))


def md5file(path):
    digest = hashlib.md5()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 16), b""):
            digest.update(block)
    return digest.hexdigest()


def _fetch_once(url, tmp, filename, md5sum):
    """One download attempt: url -> tmp -> rename.  The partial tmp is
    ALWAYS removed on failure (a stale .part from a died attempt must
    not shadow-corrupt the next one)."""
    _faults.check("dataset/download", url=url)
    from urllib.request import urlopen

    try:
        with urlopen(url, timeout=30) as resp, open(tmp, "wb") as out:
            for block in iter(lambda: resp.read(1 << 16), b""):
                out.write(block)
        if md5sum is not None and md5file(tmp) != md5sum:
            # retryable: a truncated/corrupt transfer re-downloads
            raise IOError("md5 mismatch for %s" % url)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    os.replace(tmp, filename)


def download(url, module_name, md5sum=None):
    """Fetch `url` into DATA_HOME/<module>/ once; verify md5 when given.

    Transient failures (network errors, md5 mismatches from truncated
    transfers) retry with exponential backoff and full jitter, 3
    attempts (`resilience.RetryPolicy`); the last error is raised.  Use
    :func:`fetch_or_none` for the path with the synthetic fallback."""
    cache_dir = os.path.join(DATA_HOME, module_name)
    os.makedirs(cache_dir, exist_ok=True)
    filename = os.path.join(cache_dir, url.rstrip("/").split("/")[-1])
    if not (os.path.exists(filename)
            and (md5sum is None or md5file(filename) == md5sum)):
        RetryPolicy(max_attempts=3, base_delay=0.25, max_delay=5.0).call(
            _fetch_once, url, filename + ".part", filename, md5sum)
    return filename


def fetch_or_none(url, module_name, md5sum=None):
    """Cached file if present, else None — the caller then uses its
    synthetic fallback.  Network fetches are OPT-IN via
    PADDLE_TPU_ALLOW_DOWNLOAD=1: a dataset call must never surprise a
    unit test with an 80MB download (or a resolver hang in a
    blackholed-egress environment; getaddrinfo ignores urlopen's
    timeout)."""
    allow_net = os.environ.get("PADDLE_TPU_ALLOW_DOWNLOAD") == "1" \
        and not os.environ.get("PADDLE_TPU_OFFLINE")
    if not allow_net:
        cached = os.path.join(DATA_HOME, module_name,
                              url.rstrip("/").split("/")[-1])
        return cached if os.path.exists(cached) else None
    try:
        return download(url, module_name, md5sum)
    except Exception:
        return None


def rng(seed):
    return np.random.RandomState(seed)


def synthetic_linear(n, dim, w_seed=1234, x_seed=1, noise=0.1):
    """Linear-regression data with a fixed ground-truth weight vector: a
    faithful stand-in for uci_housing's learnable structure."""
    r = rng(w_seed)
    w = r.uniform(-1, 1, size=(dim,)).astype("float32")
    b = 0.5
    x = rng(w_seed + x_seed).uniform(-1, 1, size=(n, dim)).astype("float32")
    y = (x @ w + b + noise *
         rng(w_seed + x_seed + 1).randn(n).astype("float32")) \
        .astype("float32")
    return x, y.reshape(-1, 1)


def synthetic_images(n, shape, num_classes, seed):
    """Class-dependent image patterns: each class has a fixed template plus
    noise, so real learning happens (loss falls, accuracy rises)."""
    r = rng(seed)
    templates = r.uniform(-1, 1, size=(num_classes,) + shape) \
        .astype("float32")
    labels = rng(seed + 1).randint(0, num_classes, size=n)
    noise = rng(seed + 2).randn(n, *shape).astype("float32") * 0.6
    imgs = templates[labels] + noise
    return imgs.astype("float32"), labels.astype("int64")


def synthetic_sequences(n, vocab_size, num_classes, seed, min_len=4,
                        max_len=30):
    """Sequences whose class correlates with token distribution."""
    r = rng(seed)
    class_bias = rng(seed + 1).randint(0, vocab_size,
                                       size=(num_classes, 8))
    out = []
    for i in range(n):
        label = int(r.randint(0, num_classes))
        length = int(r.randint(min_len, max_len + 1))
        base = r.randint(0, vocab_size, size=length)
        # sprinkle class-marker tokens
        marker_positions = r.randint(0, length, size=max(1, length // 3))
        base[marker_positions] = class_bias[label][
            r.randint(0, class_bias.shape[1], size=marker_positions.size)]
        out.append((base.astype("int64").tolist(), label))
    return out
