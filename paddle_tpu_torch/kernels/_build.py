"""Build the CUDA sources under csrc/ into shared libraries, at first use.

Each source is compiled on its own by `nvcc -gencode
arch=compute_90a,code=sm_90a` into a shared library with a plain C
interface, loaded with ctypes.  Libraries go to `build/paddle_tpu_torch/`
beside the package, named by a hash of the source and the flags, so an
edited source builds anew and an unchanged one is reused.  `build_all()`
starts one nvcc per source, all at once, and waits for them together.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["SOURCES", "build_all", "load", "library_path", "build_log"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "paddle_tpu_torch")

# every kernel source of the package, by library name
SOURCES = {
    "flash_attention_fwd": "flash_attention_fwd.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded = {}
_logs = {}


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "paddle_tpu_torch build on a machine with the "
                           "CUDA toolkit")
    return path


def library_path(name):
    """Where the library for `name` lives once built."""
    with open(os.path.join(CSRC_DIR, SOURCES[name]), "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "lib%s-%s.so"
                        % (name, digest.hexdigest()[:12]))


def _start(name):
    """Popen of the nvcc building `name` into a temporary file, or None
    when the library is already built."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    cmd = [_nvcc()] + NVCC_FLAGS + [
        "-o", tmp, os.path.join(CSRC_DIR, SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name, started):
    proc, tmp, out = started
    log, _ = proc.communicate()
    _logs[name] = log
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError("nvcc failed on %s (exit %d):\n%s"
                           % (SOURCES[name], proc.returncode, log))
    os.replace(tmp, out)


def build_all():
    """Build every library not built yet, one nvcc per source, all
    started together.  Returns the seconds it took."""
    t0 = time.perf_counter()
    with _lock:
        started = {n: _start(n) for n in SOURCES}
        errors = []
        for name, s in started.items():
            if s is None:
                continue
            try:
                _finish(name, s)
            except RuntimeError as exc:
                errors.append(str(exc))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name):
    """nvcc's output (ptxas register and spill report) of the build made
    by this process, or None when the library was already built."""
    return _logs.get(name)


def load(name):
    """The ctypes library for `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
        return lib
