"""The port's native runtime (paddle_tpu_torch/native.py over its own
copy of the C++ sources), in-process on loopback: the 16 cases of
tests/test_native_runtime.py against the port's bindings, the wire
protocol across the packages (a JAX client trains against the port's
server and a port client against the JAX server, bit for bit alike),
and the build: its own library under build/paddle_tpu_torch/native/,
built once by several processes at once, sources byte for byte the JAX
package's.  Servers bind port 0 and stop in a `finally`; every thread
join has its timeout."""

import filecmp
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu import native as jnative
from paddle_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_pserver_dense_sgd_roundtrip():
    s = native.ParameterServer(num_trainers=1, sync=True)
    try:
        c = native.PServerClient("127.0.0.1", s.port)
        w0 = np.arange(8, dtype=np.float32)
        c.init_param("w", w0, opt_kind=native.OPT_SGD, lr=0.1)
        updated = c.send_grad("w", np.ones(8, np.float32))
        np.testing.assert_allclose(updated, w0 - 0.1, rtol=1e-6)
        np.testing.assert_allclose(c.get_param("w", 8), updated)
        assert s.num_updates() == 1
        c.close()
    finally:
        s.stop()


def test_pserver_sync_barrier_two_trainers():
    """Two trainers' gradients are averaged then applied once."""
    s = native.ParameterServer(num_trainers=2, sync=True)
    try:
        results = {}

        def trainer(tid, gval):
            c = native.PServerClient("127.0.0.1", s.port)
            c.init_param("w", np.zeros(4, np.float32),
                         opt_kind=native.OPT_SGD, lr=1.0)
            results[tid] = c.send_grad("w", np.full(4, gval, np.float32))
            c.close()

        threads = [threading.Thread(target=trainer, args=a)
                   for a in ((1, 1.0), (2, 3.0))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        np.testing.assert_allclose(results[1], -2.0)
        np.testing.assert_allclose(results[2], -2.0)
        assert s.num_updates() == 1
    finally:
        s.stop()


def test_pserver_async_mode():
    s = native.ParameterServer(num_trainers=2, sync=False)
    try:
        c = native.PServerClient("127.0.0.1", s.port)
        c.init_param("w", np.zeros(2, np.float32), opt_kind=native.OPT_SGD,
                     lr=1.0)
        c.send_grad("w", np.ones(2, np.float32))
        np.testing.assert_allclose(c.send_grad("w", np.ones(2, np.float32)),
                                   -2.0)
        assert s.num_updates() == 2
        c.close()
    finally:
        s.stop()


def test_pserver_async_staleness_bound():
    s = native.ParameterServer(num_trainers=2, sync=False,
                               async_lagged_threshold=2)
    try:
        fast = native.PServerClient("127.0.0.1", s.port)
        slow = native.PServerClient("127.0.0.1", s.port)
        fast.init_param("w", np.zeros(2, np.float32),
                        opt_kind=native.OPT_SGD, lr=1.0)
        slow.get_param("w", 2)
        for _ in range(3):
            fast.send_grad("w", np.ones(2, np.float32))
            assert fast.last_grad_applied
        out = slow.send_grad("w", np.full(2, 100.0, np.float32))
        assert not slow.last_grad_applied
        np.testing.assert_allclose(out, -3.0)
        assert s.num_lagged() == 1 and s.num_updates() == 3
        out = slow.send_grad("w", np.ones(2, np.float32))
        assert slow.last_grad_applied
        np.testing.assert_allclose(out, -4.0)
        assert s.num_updates() == 4
        fast.close()
        slow.close()
    finally:
        s.stop()


def test_pserver_momentum_and_adam_match_numpy():
    s = native.ParameterServer(num_trainers=1, sync=True)
    try:
        c = native.PServerClient("127.0.0.1", s.port)
        c.init_param("wm", np.zeros(3, np.float32),
                     opt_kind=native.OPT_MOMENTUM, lr=0.1, hp1=0.9)
        g = np.array([1., 2., 3.], np.float32)
        v = np.zeros(3)
        w = np.zeros(3)
        for _ in range(3):
            got = c.send_grad("wm", g)
            v = 0.9 * v + g
            w = w - 0.1 * v
        np.testing.assert_allclose(got, w, rtol=1e-5)
        c.init_param("wa", np.zeros(3, np.float32),
                     opt_kind=native.OPT_ADAM, lr=0.01, hp1=0.9, hp2=0.999,
                     hp3=1e-8)
        m = np.zeros(3)
        vv = np.zeros(3)
        wa = np.zeros(3)
        for t in range(1, 4):
            got = c.send_grad("wa", g)
            m = 0.9 * m + 0.1 * g
            vv = 0.999 * vv + 0.001 * g * g
            alpha = 0.01 * np.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t)
            wa = wa - alpha * m / (np.sqrt(vv) + 1e-8)
        np.testing.assert_allclose(got, wa, rtol=1e-4)
        c.close()
    finally:
        s.stop()


def test_pserver_sparse_rows():
    s = native.ParameterServer(num_trainers=1, sync=True)
    try:
        c = native.PServerClient("127.0.0.1", s.port)
        c.init_param("emb", np.zeros((10, 4), np.float32),
                     opt_kind=native.OPT_SGD, lr=1.0)
        c.send_sparse_grad("emb", np.array([2, 7], np.int32),
                           np.ones((2, 4), np.float32))
        got = c.get_rows("emb", np.array([2, 7, 0], np.int32), 4)
        np.testing.assert_allclose(got[0], -1.0)
        np.testing.assert_allclose(got[1], -1.0)
        np.testing.assert_allclose(got[2], 0.0)
        assert s.num_sparse_rows() == 2
        with pytest.raises(ValueError):
            c.send_sparse_grad("emb", np.array([1], np.int32),
                               np.ones((2, 4), np.float32))
        c.close()
    finally:
        s.stop()


def test_pserver_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "ckpt.bin")
    s = native.ParameterServer(num_trainers=1, sync=True)
    c = native.PServerClient("127.0.0.1", s.port)
    try:
        c.init_param("w", np.arange(6, dtype=np.float32),
                     opt_kind=native.OPT_ADAM, lr=0.01, hp1=0.9, hp2=0.999)
        c.send_grad("w", np.ones(6, np.float32))
        want = c.get_param("w", 6)
        assert s.save(path) == 0
    finally:
        c.close()
        s.stop()
    s2 = native.ParameterServer(num_trainers=1, sync=True)
    try:
        assert s2.load(path) == 0
        c2 = native.PServerClient("127.0.0.1", s2.port)
        np.testing.assert_allclose(c2.get_param("w", 6), want)
        c2.close()
    finally:
        s2.stop()
    with open(path, "r+b") as f:
        f.seek(20)
        f.write(b"\xde\xad")
    s3 = native.ParameterServer(num_trainers=1, sync=True)
    try:
        assert s3.load(path) == -3
    finally:
        s3.stop()


def test_master_task_queue():
    m = native.Master(timeout_ms=200, failure_max=2)
    try:
        c = native.MasterClient("127.0.0.1", m.port)
        c.set_dataset(["c0", "c1", "c2", "c3"], chunks_per_task=2)
        t0, chunks0 = c.get_task()
        assert t0 >= 0 and chunks0 == ["c0", "c1"]
        t1, chunks1 = c.get_task()
        assert t1 >= 0 and chunks1 == ["c2", "c3"]
        assert c.get_task()[0] == native.MasterClient.NO_TASK
        c.task_finished(t0)
        c.task_failed(t1)
        t1b, chunks1b = c.get_task()
        assert t1b == t1 and chunks1b == ["c2", "c3"]
        c.task_failed(t1b)
        assert c.get_task()[0] == native.MasterClient.PASS_FINISHED
        t4, chunks4 = c.get_task()
        assert t4 >= 0 and chunks4 == ["c0", "c1"]
        c.close()
    finally:
        m.stop()


def test_master_timeout_requeues():
    m = native.Master(timeout_ms=150, failure_max=5)
    try:
        c = native.MasterClient("127.0.0.1", m.port)
        c.set_dataset(["a"], chunks_per_task=1)
        t0, _ = c.get_task()
        assert t0 >= 0
        time.sleep(0.6)
        t1, chunks = c.get_task()
        assert t1 == t0 and chunks == ["a"]
        c.close()
    finally:
        m.stop()


def test_master_snapshot_recover(tmp_path):
    path = str(tmp_path / "master.snap")
    m = native.Master(timeout_ms=5000, failure_max=3)
    c = native.MasterClient("127.0.0.1", m.port)
    try:
        c.set_dataset(["x", "y"], chunks_per_task=1)
        c.get_task()
        assert m.snapshot(path) == 0
    finally:
        c.close()
        m.stop()
    m2 = native.Master(timeout_ms=5000, failure_max=3)
    try:
        assert m2.recover(path) == 0
        c2 = native.MasterClient("127.0.0.1", m2.port)
        seen = set()
        for _ in range(2):
            t, chunks = c2.get_task()
            assert t >= 0
            seen.update(chunks)
        assert seen == {"x", "y"}
        c2.close()
    finally:
        m2.stop()


def test_pserver_stop_unblocks_sync_waiter():
    s = native.ParameterServer(num_trainers=2, sync=True)
    c = native.PServerClient("127.0.0.1", s.port)
    c.init_param("w", np.zeros(2, np.float32), opt_kind=native.OPT_SGD,
                 lr=1.0)
    err = {}

    def lone_trainer():
        try:
            c.send_grad("w", np.ones(2, np.float32))
        except RuntimeError as e:
            err["e"] = e

    t = threading.Thread(target=lone_trainer)
    t.start()
    time.sleep(0.3)
    s.stop()
    t.join(timeout=10)
    assert not t.is_alive()
    assert "e" in err
    c.close()


def test_pserver_checkpoint_preserves_optimizer_config(tmp_path):
    path = str(tmp_path / "ckpt.bin")
    s = native.ParameterServer(num_trainers=1, sync=True)
    c = native.PServerClient("127.0.0.1", s.port)
    g = np.ones(2, np.float32)
    try:
        c.init_param("w", np.zeros(2, np.float32),
                     opt_kind=native.OPT_MOMENTUM, lr=0.5, hp1=0.9)
        c.send_grad("w", g)
        assert s.save(path) == 0
    finally:
        c.close()
        s.stop()
    s2 = native.ParameterServer(num_trainers=1, sync=True)
    try:
        assert s2.load(path) == 0
        c2 = native.PServerClient("127.0.0.1", s2.port)
        np.testing.assert_allclose(c2.send_grad("w", g), -1.45, rtol=1e-6)
        c2.close()
    finally:
        s2.stop()


def test_master_recover_keeps_dataset_guard(tmp_path):
    path = str(tmp_path / "m.snap")
    m = native.Master(timeout_ms=5000, failure_max=3)
    c = native.MasterClient("127.0.0.1", m.port)
    try:
        c.set_dataset(["x"], chunks_per_task=1)
        assert m.snapshot(path) == 0
    finally:
        c.close()
        m.stop()
    m2 = native.Master(timeout_ms=5000, failure_max=3)
    try:
        assert m2.recover(path) == 0
        c2 = native.MasterClient("127.0.0.1", m2.port)
        c2.set_dataset(["x"], chunks_per_task=1)
        assert c2.get_task()[0] >= 0
        assert c2.get_task()[0] == native.MasterClient.NO_TASK
        c2.close()
    finally:
        m2.stop()


def test_master_client_dead_master_raises():
    m = native.Master(timeout_ms=5000, failure_max=3)
    c = native.MasterClient("127.0.0.1", m.port)
    m.stop()
    with pytest.raises(ConnectionError):
        for _ in range(3):  # the first call may drain a buffered response
            c.get_task()
    c.close()


def test_recordio_roundtrip(tmp_path):
    path = str(tmp_path / "data.rio")
    w = native.RecordIOWriter(path)
    records = [b"hello", b"x" * 1000, b"", b"world"]
    for r in records:
        w.write(r)
    w.close()
    rd = native.RecordIOReader(path)
    assert list(rd) == records
    rd.close()
    with open(path, "r+b") as f:
        f.seek(10)
        f.write(b"\xff")
    rd = native.RecordIOReader(path)
    with pytest.raises(IOError):
        list(rd)
    rd.close()


def test_buddy_allocator():
    a = native.BuddyAllocator(1 << 16, min_block=64)
    try:
        p1 = a.alloc(100)
        p2 = a.alloc(64)
        assert a.used == 128 + 64
        a.free(p1)
        assert a.used == 64
        a.free(p2)
        assert a.used == 0
        p3 = a.alloc(1 << 15)
        assert p3
        a.free(p3)
        with pytest.raises(MemoryError):
            a.alloc(1 << 20)
    finally:
        a.destroy()


# -- across the packages ------------------------------------------------------

def _train(client_pkg, server_pkg):
    """A dense Adam parameter and a sparse SGD table trained 3 rounds by
    a `client_pkg` client against a `server_pkg` server: (every value
    the client received, the server's sparse row count)."""
    s = server_pkg.ParameterServer(num_trainers=1, sync=True)
    try:
        c = client_pkg.PServerClient("127.0.0.1", s.port)
        rs = np.random.RandomState(7)
        c.init_param("w@0", rs.randn(33).astype(np.float32),
                     opt_kind=client_pkg.OPT_ADAM, lr=0.01, hp1=0.9,
                     hp2=0.999, hp3=1e-8)
        c.init_param("t@0", rs.randn(6, 4).astype(np.float32),
                     opt_kind=client_pkg.OPT_SGD, lr=0.5)
        got = []
        for _ in range(3):
            got.append(c.send_grad("w@0", rs.randn(33).astype(np.float32)))
            rows = np.array([1, 4, 1, -2, 9], np.int32)
            c.send_sparse_grad("t@0", rows,
                               rs.randn(5, 4).astype(np.float32))
            got.append(c.get_rows("t@0", np.unique(rows), 4))
        got.append(c.get_param("w@0", 33))
        c.barrier()
        c.close()
        return got, s.num_sparse_rows(), s.num_updates()
    finally:
        s.stop()


def test_wire_protocol_crosses_the_packages():
    """The JAX client against the port's server, and the port's client
    against the JAX server, receive what the JAX client receives from
    the JAX server, bit for bit."""
    want = _train(jnative, jnative)
    for client, server in ((jnative, native), (native, jnative),
                           (native, native)):
        got = _train(client, server)
        assert got[1:] == want[1:]
        for a, b in zip(got[0], want[0]):
            np.testing.assert_array_equal(a, b)


def test_the_port_builds_its_own_library():
    """Its library lives under build/paddle_tpu_torch/native/, built
    from the port's sources, which equal the JAX package's byte for
    byte; the port's Makefile names only the runtime."""
    native.lib()
    path = native.library_path()
    assert path == os.path.join(ROOT, "build", "paddle_tpu_torch", "native",
                                "libpaddle_tpu_rt.so")
    assert os.path.exists(path)
    assert not native._stale(path)
    for f in ("transport.cc", "transport.h", "pserver.cc", "master.cc",
              "recordio.cc", "optimizer.h", "paddle_tpu_rt.h"):
        assert filecmp.cmp(os.path.join(ROOT, "native", f),
                           os.path.join(native.SOURCE_DIR, f), shallow=False)
    with open(os.path.join(native.SOURCE_DIR, "Makefile")) as f:
        assert "capi" not in f.read()
    assert sorted(os.listdir(native.SOURCE_DIR)) == sorted(
        ["Makefile", "master.cc", "optimizer.h", "paddle_tpu_rt.h",
         "pserver.cc", "recordio.cc", "transport.cc", "transport.h"])


_LOAD = r'''
import sys
from paddle_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
native.lib()
s = native.ParameterServer()
print(s.port > 0, flush=True)
s.stop()
'''


def test_concurrent_first_use_builds_once(tmp_path):
    """Four processes load the library at once from an empty build
    directory: each gets a working runtime, and one library (no
    temporary left) stands there, built under the file lock."""
    build = str(tmp_path / "build")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD, build], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    assert [o.strip() for o, _ in outs] == ["True"] * 4
    assert sorted(os.listdir(build)) == ["build.lock", "libpaddle_tpu_rt.so"]


def test_a_failed_build_raises_with_makes_output(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "Makefile").write_text("all:\n\t@echo no compiler here; false\n")
    monkeypatch.setattr(native, "SOURCE_DIR", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="no compiler here"):
        native._build(os.path.join(str(tmp_path / "build"),
                                   "libpaddle_tpu_rt.so"))


def test_a_port_that_cannot_be_bound_raises():
    s = native.ParameterServer()
    try:
        with pytest.raises(OSError, match="could not bind"):
            native.ParameterServer(port=s.port)
        with pytest.raises(OSError, match="could not bind"):
            native.Master(port=s.port)
    finally:
        s.stop()
