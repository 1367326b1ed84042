"""Feeding a training run through the port against the JAX package, on
the CPU: `DataFeeder` (dense slots) against the JAX package's on the
same samples, the reader decorators and creators against the JAX
package's outputs on the same readers (shuffle under the same
`random.seed`), the prefetching readers, and the CIFAR-10 and MNIST
readers (the seeded synthetic fallback, and a local CIFAR tarball)
against the JAX package's.  Values must be equal: the same numpy code
on the same samples.
"""

import io
import os
import pickle
import random
import tarfile
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.fluid as jfluid
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.reader import device_prefetch, host_prefetch
from paddle_tpu_torch.resilience import faults

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

CPU = tfluid.CPUPlace()


def _feed_vars(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        image = fluid.layers.data(name="image", shape=[3, 4, 4],
                                  dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        fixed = fluid.layers.data(name="fixed", shape=[2, 5],
                                  dtype="float32", append_batch_size=False)
    return main, [image, label, fixed]


def _samples(n=6, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.rand(48).astype(np.float32), int(rs.randint(0, 10)),
             rs.rand(5).astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("by_name", [False, True])
def test_data_feeder_matches_jax(by_name):
    jmain, jvars = _feed_vars(jfluid)
    tmain, tvars = _feed_vars(tfluid)
    samples = _samples(2)
    jfeed = jfluid.DataFeeder(
        feed_list=[v.name for v in jvars] if by_name else jvars,
        place=jfluid.CPUPlace(), program=jmain).feed(samples)
    tfeed = tfluid.DataFeeder(
        feed_list=[v.name for v in tvars] if by_name else tvars,
        place=CPU, program=tmain).feed(samples)
    assert set(tfeed) == set(jfeed) == {"image", "label", "fixed"}
    for name, j in jfeed.items():
        t = tfeed[name]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        j = np.asarray(j)
        assert t.shape == j.shape, name
        assert t.numpy().dtype == j.dtype, name   # int64 runs as int32
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    assert tfeed["image"].shape == (2, 3, 4, 4)
    assert tfeed["label"].dtype == torch.int32


def test_data_feeder_rejects():
    main, (image, label, _) = _feed_vars(tfluid)
    feeder = tfluid.DataFeeder([image, label], CPU, main)
    with pytest.raises(ValueError, match="1 slots, feed_list expects 2"):
        feeder.feed([(np.zeros(48, np.float32),)])
    with pytest.raises(OverflowError, match="int32 range"):
        feeder.feed([(np.zeros(48, np.float32), 2 ** 40)])
    with pytest.raises(TypeError, match="Variables"):
        tfluid.DataFeeder([object()], CPU, main)
    with tfluid.program_guard(main, tfluid.Program()):
        words = tfluid.layers.data(name="words", shape=[1], dtype="int64",
                                   lod_level=1)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        tfluid.DataFeeder([words], CPU, main)


# -- decorators -------------------------------------------------------------------

def _counting(n):
    return lambda: iter(range(n))


def _pairs():
    for i in range(5):
        yield (i, i * 10)


DECORATED = {
    "shuffle": lambda r: r.shuffle(_counting(23), buf_size=7),
    "batch": lambda r: r.batch(_counting(10), batch_size=3),
    "batch keep last": lambda r: r.batch(_counting(10), batch_size=3,
                                         drop_last=False),
    "map_readers": lambda r: r.map_readers(lambda a, b: a * b,
                                           _counting(5), _counting(5)),
    "chain": lambda r: r.chain(_counting(2), _counting(3)),
    "compose": lambda r: r.compose(_counting(5), _pairs),
    "compose unchecked": lambda r: r.compose(_counting(3), _pairs,
                                             check_alignment=False),
    "buffered": lambda r: r.buffered(_counting(20), size=3),
    "firstn": lambda r: r.firstn(_counting(10), 4),
    "cache": lambda r: r.cache(_counting(6)),
    "xmap ordered": lambda r: r.xmap_readers(lambda x: x * x,
                                             _counting(30), 4, 8,
                                             order=True),
    "batch of shuffle": lambda r: r.batch(r.shuffle(_counting(40),
                                                    buf_size=16), 8),
}


@pytest.mark.parametrize("name", sorted(DECORATED))
def test_decorators_match_jax(name):
    outs = []
    for r in (jpaddle.reader, tpaddle.reader):
        random.seed(11)
        reader = DECORATED[name](r)
        outs.append([list(reader()), list(reader())])
    assert outs[1] == outs[0]
    assert outs[1][0]


def test_xmap_unordered_and_failures():
    got = sorted(tpaddle.reader.xmap_readers(lambda x: x + 1,
                                             _counting(50), 3, 4)())
    assert got == list(range(1, 51))

    def bad(x):
        if x == 7:
            raise KeyError("sample 7")
        return x

    with pytest.raises(KeyError, match="sample 7"):
        list(tpaddle.reader.xmap_readers(bad, _counting(20), 2, 4)())
    with pytest.raises(tpaddle.reader.decorator.ComposeNotAligned):
        list(tpaddle.reader.compose(_counting(3), _pairs)())


def test_creators_match_jax(tmp_path):
    path = str(tmp_path / "lines.txt")
    with open(path, "w") as f:
        f.write("a b\nc\n\nd\n")
    x = np.arange(12).reshape(4, 3)
    for make in (lambda c: c.text_file(path), lambda c: c.np_array(x)):
        j = [np.asarray(v).tolist() for v in make(jpaddle.reader.creator)()]
        t = [np.asarray(v).tolist() for v in make(tpaddle.reader.creator)()]
        assert t == j and t


# -- prefetching ----------------------------------------------------------------

def test_host_prefetch_order_errors_and_abandon():
    assert list(host_prefetch(_counting(20), depth=3)()) == list(range(20))

    def failing():
        yield 1
        raise IOError("disk gone")

    with pytest.raises(IOError, match="disk gone"):
        list(host_prefetch(failing)())
    started = threading.active_count()
    it = host_prefetch(_counting(10 ** 6), depth=2)()
    assert next(it) == 0
    it.close()   # abandons the generator: the worker stops
    assert threading.active_count() <= started


def test_pump_fault_reaches_the_consumer():
    faults.enable(seed=0)
    try:
        faults.inject("reader/pump", "io_error", after=2, times=1)
        it = host_prefetch(_counting(10))()
        assert [next(it), next(it)] == [0, 1]
        with pytest.raises(faults.InjectedIOError):
            next(it)
    finally:
        faults.disable()


def test_device_prefetch_on_the_cpu():
    def batches():
        for i in range(3):
            yield {"x": np.full((2, 3), i, np.float32),
                   "ids": np.array([[i], [2 ** 40]], np.int64),
                   "t": torch.ones(2)}

    got = list(device_prefetch(batches, place=CPU)())
    assert len(got) == 3
    for i, b in enumerate(got):
        assert isinstance(b["x"], torch.Tensor)
        assert torch.equal(b["x"], torch.full((2, 3), float(i)))
        # int64 stays on the host for the executor's overflow check
        assert isinstance(b["ids"], np.ndarray) and b["ids"].dtype == np.int64
        assert torch.equal(b["t"], torch.ones(2))
    tuples = list(device_prefetch(
        lambda: iter([(np.zeros(2, np.float32), "tag")]), place=CPU)())
    assert isinstance(tuples[0][0], torch.Tensor) and tuples[0][1] == "tag"


# -- datasets ---------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda p: p.dataset.cifar.train10(), lambda p: p.dataset.cifar.test10(),
    lambda p: p.dataset.cifar.train100(), lambda p: p.dataset.mnist.train(),
    lambda p: p.dataset.mnist.test()])
def test_synthetic_datasets_match_jax(make, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_ALLOW_DOWNLOAD", raising=False)
    j = list(make(jpaddle)())
    t = list(make(tpaddle)())
    assert len(t) == len(j) >= 256
    for (ji, jl), (ti, tl) in zip(j, t):
        assert tl == jl and ti.dtype == ji.dtype == np.float32
        np.testing.assert_array_equal(ti, ji)


def test_cifar_tarball_matches_jax(tmp_path):
    rs = np.random.RandomState(3)
    path = str(tmp_path / "cifar-10-python.tar.gz")
    with tarfile.open(path, "w:gz") as tf:
        for name in ("cifar-10-batches-py/data_batch_1",
                     "cifar-10-batches-py/test_batch"):
            blob = pickle.dumps({b"data": rs.randint(0, 256, (4, 3072),
                                                     dtype=np.uint8),
                                 b"labels": list(rs.randint(0, 10, 4))})
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    for split in ("train10", "test10"):
        j = list(getattr(jpaddle.dataset.cifar, split)(tar_path=path)())
        t = list(getattr(tpaddle.dataset.cifar, split)(tar_path=path)())
        assert len(t) == len(j) == 4
        for (ji, jl), (ti, tl) in zip(j, t):
            assert tl == jl
            np.testing.assert_array_equal(ti, ji)
    with pytest.raises(FileNotFoundError):
        tpaddle.dataset.cifar.train10(tar_path=os.path.join(
            str(tmp_path), "missing.tar.gz"))
