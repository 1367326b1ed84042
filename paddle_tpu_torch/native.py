"""ctypes bindings to the native C++ runtime (libpaddle_tpu_rt.so).

Counterpart of paddle_tpu/native.py.  The library holds the services the
reference implements in C++/Go rather than Python (reference:
paddle/pserver/ParameterServer2, go/master/service.go, recordio,
paddle/memory BuddyAllocator): the parameter server, the task master
with its TTL-lease registry, RecordIO chunk files and a buddy
allocator.  Its sources are the package's own copy (`native/` beside
this file: the same code and the same wire protocol as the JAX
package's), built with `make` and g++ at first use into
`build/paddle_tpu_torch/native/` beside the package.

Several processes may load the library at once (a test run's workers, a
cluster's role processes).  The build runs under an exclusive `fcntl`
lock on a file in the build directory, into a temporary directory, and
`os.replace`s the finished library into place, so no process loads a
half-written one; it runs only when a source is newer than the library.
A failed build raises with make's output.
"""

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

__all__ = ["lib", "ParameterServer", "PServerClient", "Master",
           "MasterClient", "RecordIOWriter", "RecordIOReader",
           "BuddyAllocator", "OPT_SGD", "OPT_MOMENTUM", "OPT_ADAGRAD",
           "OPT_ADAM", "SOURCE_DIR", "BUILD_DIR", "library_path"]

OPT_SGD = 0
OPT_MOMENTUM = 1
OPT_ADAGRAD = 2
OPT_ADAM = 3

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE_DIR = os.path.join(_PKG_DIR, "native")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "paddle_tpu_torch", "native")
_LIB_NAME = "libpaddle_tpu_rt.so"

_load_lock = threading.Lock()
_lib = None


def library_path():
    """Where the built library lives."""
    return os.path.join(BUILD_DIR, _LIB_NAME)


def _stale(so_path):
    """True when the library is missing or a source, header or the
    Makefile is newer than it."""
    if not os.path.exists(so_path):
        return True
    so_mtime = os.path.getmtime(so_path)
    return any(os.path.getmtime(os.path.join(SOURCE_DIR, f)) > so_mtime
               for f in os.listdir(SOURCE_DIR)
               if f.endswith((".cc", ".h")) or f == "Makefile")


def _build(so_path):
    """Build the library into `so_path` unless it is fresh: make writes
    into a temporary directory beside it, under an exclusive file lock
    that other processes building the same library wait on."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale(so_path):
            return  # another process built it while we waited
        tmp = tempfile.mkdtemp(dir=BUILD_DIR, prefix="make-")
        try:
            out = os.path.join(tmp, _LIB_NAME)
            proc = subprocess.run(["make", "-C", SOURCE_DIR, "OUT=" + out],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
            if proc.returncode != 0 or not os.path.exists(out):
                raise RuntimeError(
                    "native runtime build failed (make -C %s OUT=%s):\n%s"
                    % (SOURCE_DIR, out,
                       proc.stdout.decode(errors="replace")))
            os.replace(out, so_path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


def lib():
    """Load (building if needed) the native runtime library."""
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        so_path = library_path()
        if _stale(so_path):
            _build(so_path)
        L = ctypes.CDLL(so_path)
        c = ctypes
        sigs = {
            "ptrt_pserver_start":
                (c.c_void_p, [c.c_int, c.c_int, c.c_int, c.c_int]),
            "ptrt_pserver_stop": (None, [c.c_void_p]),
            "ptrt_pserver_port": (c.c_int, [c.c_void_p]),
            "ptrt_pserver_save": (c.c_int, [c.c_void_p, c.c_char_p]),
            "ptrt_pserver_load": (c.c_int, [c.c_void_p, c.c_char_p]),
            "ptrt_pserver_num_updates": (c.c_int64, [c.c_void_p]),
            "ptrt_pserver_num_lagged": (c.c_int64, [c.c_void_p]),
            "ptrt_pserver_num_sparse_rows": (c.c_int64, [c.c_void_p]),
            "ptrt_client_connect": (c.c_void_p, [c.c_char_p, c.c_int]),
            "ptrt_client_close": (None, [c.c_void_p]),
            "ptrt_client_init_param":
                (c.c_int, [c.c_void_p, c.c_char_p, c.c_void_p, c.c_int64,
                           c.c_int, c.c_double, c.c_double, c.c_double,
                           c.c_double]),
            "ptrt_client_send_grad":
                (c.c_int, [c.c_void_p, c.c_char_p, c.c_void_p, c.c_int64,
                           c.c_void_p, c.c_int64,
                           c.POINTER(c.c_int64)]),
            "ptrt_client_get_param":
                (c.c_int, [c.c_void_p, c.c_char_p, c.c_void_p, c.c_int64,
                           c.POINTER(c.c_int64)]),
            "ptrt_client_send_sparse_grad":
                (c.c_int, [c.c_void_p, c.c_char_p, c.c_void_p, c.c_void_p,
                           c.c_int64, c.c_int64]),
            "ptrt_client_get_rows":
                (c.c_int, [c.c_void_p, c.c_char_p, c.c_void_p, c.c_void_p,
                           c.c_int64, c.c_int64]),
            "ptrt_client_barrier": (c.c_int, [c.c_void_p]),
            "ptrt_master_start": (c.c_void_p, [c.c_int, c.c_int, c.c_int]),
            "ptrt_master_stop": (None, [c.c_void_p]),
            "ptrt_master_port": (c.c_int, [c.c_void_p]),
            "ptrt_master_snapshot": (c.c_int, [c.c_void_p, c.c_char_p]),
            "ptrt_master_recover": (c.c_int, [c.c_void_p, c.c_char_p]),
            "ptrt_mclient_connect": (c.c_void_p, [c.c_char_p, c.c_int]),
            "ptrt_mclient_close": (None, [c.c_void_p]),
            "ptrt_mclient_set_dataset":
                (c.c_int, [c.c_void_p, c.POINTER(c.c_char_p), c.c_int,
                           c.c_int]),
            "ptrt_mclient_get_task":
                (c.c_int64, [c.c_void_p, c.c_char_p, c.c_int64]),
            "ptrt_mclient_task_finished": (c.c_int, [c.c_void_p, c.c_int64]),
            "ptrt_mclient_task_failed": (c.c_int, [c.c_void_p, c.c_int64]),
            "ptrt_mclient_register":
                (c.c_int64, [c.c_void_p, c.c_char_p, c.c_char_p, c.c_int]),
            "ptrt_mclient_keepalive": (c.c_int, [c.c_void_p, c.c_int64]),
            "ptrt_mclient_unregister": (c.c_int, [c.c_void_p, c.c_int64]),
            "ptrt_mclient_list":
                (c.c_int64, [c.c_void_p, c.c_char_p, c.c_char_p,
                             c.c_int64]),
            "ptrt_recordio_writer_open": (c.c_void_p, [c.c_char_p]),
            "ptrt_recordio_write":
                (c.c_int, [c.c_void_p, c.c_void_p, c.c_int64]),
            "ptrt_recordio_writer_close": (c.c_int, [c.c_void_p]),
            "ptrt_recordio_reader_open": (c.c_void_p, [c.c_char_p]),
            "ptrt_recordio_read":
                (c.c_int64, [c.c_void_p, c.c_void_p, c.c_int64]),
            "ptrt_recordio_reader_close": (None, [c.c_void_p]),
            "ptrt_buddy_create": (c.c_void_p, [c.c_int64, c.c_int64]),
            "ptrt_buddy_alloc": (c.c_void_p, [c.c_void_p, c.c_int64]),
            "ptrt_buddy_free": (None, [c.c_void_p, c.c_void_p]),
            "ptrt_buddy_used": (c.c_int64, [c.c_void_p]),
            "ptrt_buddy_destroy": (None, [c.c_void_p]),
        }
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(L, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = L
        return _lib


def _f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _check_bound(server, what, port):
    """Raise OSError, the server stopped, when it could not bind `port`
    (the native server then serves nothing and reports port 0)."""
    if server.port <= 0:
        server.stop()
        raise OSError("native %s could not bind port %d" % (what, port))


class ParameterServer:
    """An in-process parameter server (reference:
    ParameterServerController starts pservers in-process for tests;
    production runs one per host).  `port=0` binds a free port, read back
    from `port`; a port that cannot be bound raises OSError."""

    def __init__(self, port=0, num_trainers=1, sync=True,
                 async_lagged_threshold=0):
        """async_lagged_threshold > 0 discards async gradients computed
        against parameters at least that many versions old (reference:
        ParameterServer2.h:243 lagged-async commit control; 0 keeps
        the unbounded behavior)."""
        self._h = lib().ptrt_pserver_start(port, num_trainers,
                                           1 if sync else 0,
                                           int(async_lagged_threshold))
        _check_bound(self, "pserver", port)

    @property
    def port(self):
        return lib().ptrt_pserver_port(self._h)

    def num_updates(self):
        return lib().ptrt_pserver_num_updates(self._h)

    def num_lagged(self):
        """Async gradients discarded by the staleness bound."""
        return lib().ptrt_pserver_num_lagged(self._h)

    def num_sparse_rows(self):
        """Sparse rows applied through send_sparse_grad, each row of
        each message counted (rows outside the table are not)."""
        return lib().ptrt_pserver_num_sparse_rows(self._h)

    def save(self, path):
        return lib().ptrt_pserver_save(self._h, path.encode())

    def load(self, path):
        return lib().ptrt_pserver_load(self._h, path.encode())

    def stop(self):
        """Stop serving; a trainer blocked on a sync round or barrier is
        woken with an error."""
        if self._h:
            lib().ptrt_pserver_stop(self._h)
            self._h = None


class PServerClient:
    """One connection to a parameter server.  Values travel as f32."""

    def __init__(self, host, port):
        self._h = lib().ptrt_client_connect(host.encode(), port)
        if not self._h:
            raise ConnectionError("cannot connect to pserver %s:%d"
                                  % (host, port))
        # last server version seen per param: the base version stamped
        # onto outgoing gradients for the async staleness bound
        self._versions = {}
        self.last_grad_applied = True

    def init_param(self, name, value, opt_kind=OPT_SGD, lr=0.01,
                   hp1=0.0, hp2=0.0, hp3=0.0):
        """Create `name` on the server with its optimizer (the first
        trainer to call wins)."""
        v = _f32(value).reshape(-1)
        rc = lib().ptrt_client_init_param(
            self._h, name.encode(), _ptr(v), v.size, opt_kind, lr, hp1,
            hp2, hp3)
        if rc != 0:
            raise RuntimeError("init_param(%s) rc=%d" % (name, rc))

    def send_grad(self, name, grad):
        """Blocking: returns the freshly updated parameter (sync mode
        waits for all trainers' gradients).  In async mode a gradient
        older than the server's staleness bound is discarded
        (last_grad_applied False); the returned parameter is fresh
        either way, so the trainer resynchronizes."""
        g = _f32(grad).reshape(-1)
        out = np.empty_like(g)
        new_ver = ctypes.c_int64(0)
        rc = lib().ptrt_client_send_grad(
            self._h, name.encode(), _ptr(g), g.size, _ptr(out),
            self._versions.get(name, 0), ctypes.byref(new_ver))
        if rc not in (0, 4):
            raise RuntimeError("send_grad(%s) rc=%d" % (name, rc))
        self._versions[name] = new_ver.value
        self.last_grad_applied = rc == 0
        return out

    def get_param(self, name, size):
        out = np.empty(size, np.float32)
        ver = ctypes.c_int64(0)
        rc = lib().ptrt_client_get_param(
            self._h, name.encode(), _ptr(out), out.size,
            ctypes.byref(ver))
        if rc != 0:
            raise RuntimeError("get_param(%s) rc=%d" % (name, rc))
        self._versions[name] = ver.value
        return out

    def send_sparse_grad(self, name, rows, values):
        """Apply `values` [nrows, width] at `rows` (int32), one row after
        another, so a repeated row is updated once per occurrence."""
        rows = np.ascontiguousarray(rows, np.int32).reshape(-1)
        vals = _f32(values)
        if vals.ndim != 2 or vals.shape[0] != rows.size:
            raise ValueError("send_sparse_grad(%s): values of shape %s for "
                             "%d rows" % (name, vals.shape, rows.size))
        rc = lib().ptrt_client_send_sparse_grad(
            self._h, name.encode(), _ptr(rows), _ptr(vals), rows.size,
            vals.shape[1])
        if rc != 0:
            raise RuntimeError("send_sparse_grad(%s) rc=%d" % (name, rc))

    def get_rows(self, name, rows, width):
        """The rows `rows` [n, width] of `name` (zeros for a row outside
        the table)."""
        rows = np.ascontiguousarray(rows, np.int32).reshape(-1)
        out = np.empty((rows.size, width), np.float32)
        rc = lib().ptrt_client_get_rows(
            self._h, name.encode(), _ptr(rows), _ptr(out), rows.size,
            width)
        if rc != 0:
            raise RuntimeError("get_rows(%s) rc=%d" % (name, rc))
        return out

    def barrier(self):
        rc = lib().ptrt_client_barrier(self._h)
        if rc != 0:
            raise RuntimeError("barrier rc=%d" % rc)

    def close(self):
        if self._h:
            lib().ptrt_client_close(self._h)
            self._h = None


class Master:
    """The task master (go/master/service.go): chunk tasks leased with a
    timeout, and the TTL-lease registry.  A port that cannot be bound
    raises OSError."""

    def __init__(self, port=0, timeout_ms=5000, failure_max=3):
        self._h = lib().ptrt_master_start(port, timeout_ms, failure_max)
        _check_bound(self, "master", port)

    @property
    def port(self):
        return lib().ptrt_master_port(self._h)

    def snapshot(self, path):
        return lib().ptrt_master_snapshot(self._h, path.encode())

    def recover(self, path):
        return lib().ptrt_master_recover(self._h, path.encode())

    def stop(self):
        if self._h:
            lib().ptrt_master_stop(self._h)
            self._h = None


class MasterClient:
    PASS_FINISHED = -2
    NO_TASK = -1

    def __init__(self, host, port):
        self._h = lib().ptrt_mclient_connect(host.encode(), port)
        if not self._h:
            raise ConnectionError("cannot connect to master %s:%d"
                                  % (host, port))

    def set_dataset(self, chunk_paths, chunks_per_task=1):
        arr = (ctypes.c_char_p * len(chunk_paths))(
            *[p.encode() for p in chunk_paths])
        rc = lib().ptrt_mclient_set_dataset(self._h, arr,
                                            len(chunk_paths),
                                            chunks_per_task)
        if rc != 0:
            raise RuntimeError("set_dataset rc=%d" % rc)

    def get_task(self):
        """(task_id, [chunk paths]); task_id is NO_TASK (-1) while every
        task is leased out, PASS_FINISHED (-2) once when a pass drains
        (the queue then recycles for the next pass).  Raises
        ConnectionError if the master is unreachable."""
        buf = ctypes.create_string_buffer(1 << 20)
        tid = lib().ptrt_mclient_get_task(self._h, buf, len(buf))
        if tid == -3:
            raise ConnectionError("master unreachable")
        if tid == -4:
            raise ValueError("task chunk list exceeds client buffer")
        if tid < 0:
            return tid, []
        chunks = buf.value.decode().split("\n") if buf.value else []
        return tid, chunks

    def task_finished(self, task_id):
        lib().ptrt_mclient_task_finished(self._h, task_id)

    def task_failed(self, task_id):
        lib().ptrt_mclient_task_failed(self._h, task_id)

    # -- TTL-lease registry (reference: go/pserver/etcd_client.go) ------

    def register(self, key, value, ttl_ms):
        """Claim `key` with a TTL lease; returns the lease id, or None
        if a live lease already holds the key."""
        lease = lib().ptrt_mclient_register(self._h, key.encode(),
                                            value.encode(), int(ttl_ms))
        if lease == -2:
            raise ConnectionError("master unreachable")
        return None if lease < 0 else lease

    def keep_alive(self, lease):
        """Renew; returns False when the lease already lapsed (the
        holder must re-register)."""
        rc = lib().ptrt_mclient_keepalive(self._h, int(lease))
        if rc == -2:
            raise ConnectionError("master unreachable")
        return rc == 0

    def unregister(self, lease):
        lib().ptrt_mclient_unregister(self._h, int(lease))

    def list_prefix(self, prefix):
        """{key: value} of unexpired leases under `prefix`."""
        buf = ctypes.create_string_buffer(1 << 20)
        n = lib().ptrt_mclient_list(self._h, prefix.encode(), buf,
                                    len(buf))
        if n == -2:
            raise ConnectionError("master unreachable")
        if n < 0:
            raise RuntimeError("list_prefix rc=%d" % n)
        out = {}
        if buf.value:
            for line in buf.value.decode().split("\n"):
                k, _, v = line.partition("=")
                out[k] = v
        return out

    def close(self):
        if self._h:
            lib().ptrt_mclient_close(self._h)
            self._h = None


class RecordIOWriter:
    """A RecordIO chunk file, each record with its CRC."""

    def __init__(self, path):
        self._h = lib().ptrt_recordio_writer_open(path.encode())
        if not self._h:
            raise IOError("cannot open %s" % path)

    def write(self, data):
        if isinstance(data, str):
            data = data.encode()
        rc = lib().ptrt_recordio_write(self._h, data, len(data))
        if rc != 0:
            raise IOError("write failed rc=%d" % rc)

    def close(self):
        if self._h:
            lib().ptrt_recordio_writer_close(self._h)
            self._h = None


class RecordIOReader:
    """Iterates the records of a chunk file; a corrupt record raises
    IOError."""

    def __init__(self, path, max_record=1 << 24):
        self._h = lib().ptrt_recordio_reader_open(path.encode())
        if not self._h:
            raise IOError("cannot open %s" % path)
        self._buf = ctypes.create_string_buffer(max_record)

    def __iter__(self):
        return self

    def __next__(self):
        n = lib().ptrt_recordio_read(self._h, self._buf, len(self._buf))
        if n == -1:
            raise StopIteration
        if n < 0:
            raise IOError("corrupt record (rc=%d)" % n)
        return self._buf.raw[:n]

    def close(self):
        if self._h:
            lib().ptrt_recordio_reader_close(self._h)
            self._h = None


class BuddyAllocator:
    """A buddy allocator over one host pool (paddle/memory)."""

    def __init__(self, total_bytes, min_block=64):
        self._h = lib().ptrt_buddy_create(total_bytes, min_block)

    def alloc(self, n):
        p = lib().ptrt_buddy_alloc(self._h, n)
        if not p:
            raise MemoryError("buddy pool exhausted (%d bytes)" % n)
        return p

    def free(self, p):
        lib().ptrt_buddy_free(self._h, p)

    @property
    def used(self):
        return lib().ptrt_buddy_used(self._h)

    def destroy(self):
        if self._h:
            lib().ptrt_buddy_destroy(self._h)
            self._h = None
