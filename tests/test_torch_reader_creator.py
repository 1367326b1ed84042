"""The port's reader creators over its native runtime against the JAX
package's: `recordio` and `recordio_writer` round trips (a chunk
written by either package read by the other), and `cloud_reader`
leasing chunk tasks from a master, exactly once per pass; the master
binds port 0 and stops in a `finally`."""

import numpy as np
import pytest

from paddle_tpu.reader import creator as jcreator
from paddle_tpu_torch import native
from paddle_tpu_torch.reader import creator

SAMPLES = [([1, 2, 3], 0), ([4, 5], 1), (np.arange(6).reshape(2, 3), 2)]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x[0]), np.asarray(y[0]))
        assert x[1] == y[1]


def test_np_array_and_text_file(tmp_path):
    arr = np.arange(6).reshape(3, 2)
    assert [r.tolist() for r in creator.np_array(arr)()] == \
        [[0, 1], [2, 3], [4, 5]]
    p = tmp_path / "t.txt"
    p.write_text("a\nb\nc\n")
    assert list(creator.text_file(str(p))()) == ["a", "b", "c"]


@pytest.mark.parametrize("writer,reader", [
    ("port", "port"), ("jax", "port"), ("port", "jax")])
def test_recordio_roundtrip_across_the_packages(tmp_path, writer, reader):
    paths = []
    for i in range(2):
        path = str(tmp_path / ("chunk%d.rio" % i))
        (creator if writer == "port" else jcreator).recordio_writer(
            path, SAMPLES[i:])
        paths.append(path)
    read = (creator if reader == "port" else jcreator).recordio
    _same(list(read(",".join(paths))()), SAMPLES + SAMPLES[1:])
    _same(list(read(paths[0])()), SAMPLES)


def test_cloud_reader_via_master(tmp_path):
    """Samples flow chunk files -> master task lease -> reader, exactly
    once per pass, and a second pass serves them again."""
    chunks, all_samples = [], []
    for i in range(4):
        path = str(tmp_path / ("c%d.rio" % i))
        samples = [(i, j) for j in range(3)]
        creator.recordio_writer(path, samples)
        chunks.append(path)
        all_samples.extend(samples)
    m = native.Master(timeout_ms=10000, failure_max=3)
    try:
        boot = native.MasterClient("127.0.0.1", m.port)
        boot.set_dataset(chunks, chunks_per_task=2)
        boot.close()
        endpoint = "127.0.0.1:%d" % m.port
        assert sorted(creator.cloud_reader(endpoint)()) == \
            sorted(all_samples)
        assert sorted(creator.cloud_reader(endpoint)()) == \
            sorted(all_samples)
        # the JAX package's reader against the port's master, and two
        # passes in one reader
        assert sorted(jcreator.cloud_reader(endpoint)()) == \
            sorted(all_samples)
        assert sorted(creator.cloud_reader(endpoint, pass_num=2)()) == \
            sorted(all_samples * 2)
    finally:
        m.stop()


def test_cloud_reader_reports_a_corrupt_chunk(tmp_path):
    """A chunk that fails its CRC raises in the reader, which reports
    the task failed: the master hands it out again."""
    good = str(tmp_path / "good.rio")
    bad = str(tmp_path / "bad.rio")
    creator.recordio_writer(good, [(0, 0)])
    creator.recordio_writer(bad, [(1, 1)] * 4)
    with open(bad, "r+b") as f:
        f.seek(10)
        f.write(b"\xff")
    m = native.Master(timeout_ms=10000, failure_max=3)
    try:
        boot = native.MasterClient("127.0.0.1", m.port)
        boot.set_dataset([bad], chunks_per_task=1)
        with pytest.raises(IOError):
            list(creator.cloud_reader("127.0.0.1:%d" % m.port)())
        tid, again = boot.get_task()
        assert tid >= 0 and again == [bad]
        boot.close()
    finally:
        m.stop()
