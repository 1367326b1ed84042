"""Persistent on-disk cache of the executor's program plans.

Counterpart of paddle_tpu/compile/pcache.py.  The JAX cache stores each
segment's serialized XLA executable, so a restart compiles nothing.  A
CUDA graph cannot be saved and reloaded, so a port entry holds what a
process can reload: a program's pass-rewritten clone (its ProgramDesc
JSON), its segment plan, its donation plan and the verifier's clean
verdict, keyed by the canonical Program fingerprint (`fingerprint.py`).
A later process with the same program content, feeds, fetches, flags
and stack runs no verifier, no pass pipeline and no donation analysis;
it still captures its graphs, and those captures are counted apart
(`Executor.captures`, `executor_jit_traces_total`).

Each capture stores a "stub" entry keyed by its (segment, signature),
as the JAX cache does for executables that do not serialize: it records
the capture's seconds and pool bytes.  Stats and eviction see stubs; a
load of one is a miss.

The payload is JSON, never pickle: loading an entry runs no code.  Port
entries have their own magic line and file suffix (`.ptp`), so a JAX
entry (`.ptx`) under the same root is never read, counted, evicted or
quarantined here.

Durability discipline (as fluid/checkpoint.py):

  * atomic writes: mkstemp in the entries dir, fsync, os.replace, dir
    fsync; a kill mid-store never leaves a torn entry;
  * CRC'd entries: every payload carries a crc32; a bit-rotted or
    truncated file is found on load;
  * quarantine, never a crash: a corrupt or unparsable entry is moved
    to `<root>/quarantine/` and reported as a miss; the run plans anew
    and stores again, it never fails;
  * LRU size cap: `FLAGS_compile_cache_max_bytes`; loads touch mtime,
    stores evict the oldest-used entries until the cache fits.

Metrics (obs registry): `compile_cache_{hits,misses,evictions,
errors}_total`, the `compile_cache_{load,compile}_seconds` histograms,
and `compile_cache_saved_compile_seconds_total`: the host seconds of
planning (verifier, passes, segment analysis, donation analysis) that
hits refunded.
"""

import io
import json
import logging
import os
import tempfile
import threading
import time
import zlib

from ..obs import registry as registry_mod
from ..utils import flags

__all__ = ["PersistentCache", "enabled", "get_cache", "reset",
           "publish_stats"]

_MAGIC = b"PTPP1\n"
_SUFFIX = ".ptp"

_log = logging.getLogger("paddle_tpu_torch.compile.pcache")

_lock = threading.Lock()
_caches = {}  # root -> PersistentCache


def _reg():
    return registry_mod.get_registry()


def _hits():
    return _reg().counter("compile_cache_hits_total",
                          "persistent plan cache loads served from disk")


def _misses():
    return _reg().counter("compile_cache_misses_total",
                          "persistent plan cache lookups that had to "
                          "plan")


def _evictions():
    return _reg().counter("compile_cache_evictions_total",
                          "entries evicted by the LRU size cap")


def _errors(kind):
    return _reg().counter("compile_cache_errors_total",
                          "corrupt or unusable cache entries, by kind",
                          labelnames=("kind",)).labels(kind=kind)


def _saved():
    return _reg().counter("compile_cache_saved_compile_seconds_total",
                          "sum of the planning host seconds served back "
                          "as cache hits")


def enabled():
    return bool(flags.get_flag("compile_cache_dir"))


def donation_aliasing_safe(backend=None):
    """Whether a reloaded entry keeps the donation of its program: True.
    The JAX cache reloads executables, whose donated-input binding one
    backend loses on reload; a port entry holds a plan, and a reloaded
    plan is captured anew with its donation, so no aliasing can be lost
    (`analysis/alias.py` A005 reads this verdict)."""
    return True


def get_cache(root=None):
    """Process-wide cache for `root` (default: the flag dir); one
    instance per directory."""
    root = root or flags.get_flag("compile_cache_dir")
    if not root:
        return None
    root = os.path.abspath(root)
    with _lock:
        cache = _caches.get(root)
        if cache is None:
            cache = PersistentCache(root)
            _caches[root] = cache
        return cache


def reset():
    """Drop all cache instances (tests; the on-disk state stays)."""
    with _lock:
        _caches.clear()


def publish_stats(root=None):
    """Export the on-disk entry count and byte size as gauges (the
    supervisor calls this on restore, so a resumed run's /metrics says
    what the cache held at resume time)."""
    cache = get_cache(root)
    if cache is None:
        return None
    stats = cache.stats()
    _reg().gauge("compile_cache_entries",
                 "entries in the persistent plan cache") \
        .set(stats["entries"])
    _reg().gauge("compile_cache_bytes",
                 "bytes held by the persistent plan cache") \
        .set(stats["bytes"])
    return stats


class PersistentCache:
    """One cache root.  Layout::

        <root>/entries/<key[:2]>/<key>.ptp
        <root>/quarantine/<key>.ptp      (corrupt entries, kept for
                                          post-mortems, cleared by gc)
    """

    def __init__(self, root, max_bytes=None):
        self.root = os.path.abspath(str(root))
        self.entries_dir = os.path.join(self.root, "entries")
        self.quarantine_dir = os.path.join(self.root, "quarantine")
        self._max_bytes = max_bytes
        self._io_lock = threading.Lock()
        # running size estimate, so put() does not walk the entries tree
        # per store; set by the first walk, kept by put and evict
        self._approx_bytes = None
        os.makedirs(self.entries_dir, exist_ok=True)
        os.makedirs(self.quarantine_dir, exist_ok=True)

    @property
    def max_bytes(self):
        if self._max_bytes is not None:
            return self._max_bytes
        return int(flags.get_flag("compile_cache_max_bytes"))

    # -- paths --------------------------------------------------------------
    def _entry_path(self, key):
        return os.path.join(self.entries_dir, key[:2], key + _SUFFIX)

    def _iter_entries(self):
        for sub in sorted(os.listdir(self.entries_dir)):
            subdir = os.path.join(self.entries_dir, sub)
            if not os.path.isdir(subdir):
                continue
            for fname in sorted(os.listdir(subdir)):
                if fname.endswith(_SUFFIX):
                    yield os.path.join(subdir, fname)

    # -- load ---------------------------------------------------------------
    def get(self, key, check=None):
        """The stored payload (a JSON dict) for `key`, or None (a miss;
        a stub is one).  Corrupt entries are quarantined, never
        raised.  `check(payload)`, when given, is the caller's check of
        the parsed payload: an entry it raises on is quarantined under
        "acquire" and is a miss, so a hit, its load time and its saved
        seconds are counted only for an entry the caller can use."""
        path = self._entry_path(key)
        t0 = time.perf_counter()
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            _misses().inc()
            return None
        header, payload = self._parse(path, raw)
        if header is None:
            _misses().inc()
            return None
        if header.get("kind") != "plan":
            # a stub records a capture, which no process can reload
            _misses().inc()
            return None
        try:
            loaded = json.loads(payload.decode("utf-8"))
            if not isinstance(loaded, dict):
                raise ValueError("payload is not an object")
        except Exception as exc:
            _log.warning("quarantining unparsable cache entry %s: %r",
                         path, exc)
            self._quarantine(path, "deserialize")
            _misses().inc()
            return None
        if check is not None:
            try:
                check(loaded)
            except Exception as exc:
                _log.warning("quarantining unusable cache entry %s: %r",
                             path, exc)
                self._quarantine(path, "acquire")
                _misses().inc()
                return None
        try:
            os.utime(path, None)  # LRU touch
        except OSError:
            pass
        _hits().inc()
        _saved().inc(float(header.get("compile_seconds", 0.0)))
        _reg().histogram("compile_cache_load_seconds",
                         help_text="wall time to load and parse a cached "
                                   "plan") \
              .observe(time.perf_counter() - t0)
        return loaded

    def _parse(self, path, raw):
        """(header, payload) or (None, None) with the file quarantined
        when anything about it is off."""
        try:
            if not raw.startswith(_MAGIC):
                raise ValueError("bad magic")
            head, sep, rest = raw[len(_MAGIC):].partition(b"\n")
            if not sep:
                raise ValueError("truncated header")
            header = json.loads(head.decode("utf-8"))
            payload = rest
            if len(payload) != int(header.get("payload_len", -1)):
                raise ValueError("payload length mismatch")
            if zlib.crc32(payload) != int(header.get("crc", -1)):
                raise ValueError("crc mismatch")
            return header, payload
        except Exception as exc:
            _log.warning("quarantining corrupt cache entry %s: %r",
                         path, exc)
            self._quarantine(path, "corrupt")
            return None, None

    def _quarantine(self, path, kind):
        _errors(kind).inc()
        try:
            dest = os.path.join(self.quarantine_dir,
                                os.path.basename(path))
            os.replace(path, dest)
        except OSError:
            try:
                os.remove(path)
            except OSError:
                pass

    def quarantine(self, key, kind):
        """Move `key`'s entry to the quarantine (a caller found the
        parsed payload unusable: a desc that fails the structural
        check), counted under `kind`."""
        self._quarantine(self._entry_path(key), kind)

    # -- store --------------------------------------------------------------
    def put(self, key, payload, compile_seconds=0.0, meta=None):
        """Store `payload` (a JSON-able dict) under `key`; None stores a
        stub.  Returns the entry kind stored: "plan" or "stub"."""
        kind = "plan" if payload is not None else "stub"
        body = b"" if payload is None else json.dumps(
            payload, sort_keys=True).encode("utf-8")
        header = {
            "key": key, "kind": kind, "crc": zlib.crc32(body),
            "payload_len": len(body),
            "compile_seconds": round(float(compile_seconds), 6),
            "created": time.time(), "meta": meta or {},
        }
        blob = io.BytesIO()
        blob.write(_MAGIC)
        blob.write(json.dumps(header, sort_keys=True).encode("utf-8"))
        blob.write(b"\n")
        blob.write(body)
        data = blob.getvalue()
        path = self._entry_path(key)
        try:
            old = os.stat(path).st_size
        except OSError:
            old = 0
        self._atomic_write(path, data)
        _reg().histogram("compile_cache_compile_seconds",
                         help_text="host seconds of the plans and "
                                   "captures the cache stored") \
              .observe(float(compile_seconds))
        # the size cap against the running estimate; the walking evict
        # runs only when the estimate crosses the cap
        if self._approx_bytes is None:
            self._approx_bytes = sum(
                os.stat(p).st_size for p in self._iter_entries())
        else:
            self._approx_bytes += len(data) - old
        cap = self.max_bytes
        if cap > 0 and self._approx_bytes > cap:
            self.evict()
        return kind

    def _atomic_write(self, path, data):
        """mkstemp + fsync + rename + dir fsync (the checkpoint
        discipline: a kill mid-write never leaves a torn entry)."""
        d = os.path.dirname(path)
        os.makedirs(d, exist_ok=True)
        with self._io_lock:
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise
            try:
                dfd = os.open(d, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:
                pass

    # -- maintenance --------------------------------------------------------
    def evict(self, max_bytes=None):
        """Drop oldest-used entries until the cache fits the size cap.
        Returns the number evicted."""
        cap = self.max_bytes if max_bytes is None else int(max_bytes)
        if cap <= 0:
            return 0
        entries = []
        total = 0
        for path in self._iter_entries():
            try:
                st = os.stat(path)
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, path))
            total += st.st_size
        evicted = 0
        for _, size, path in sorted(entries):
            if total <= cap:
                break
            try:
                os.remove(path)
            except OSError:
                continue
            total -= size
            evicted += 1
            _evictions().inc()
            _log.debug("evicted cache entry %s (%d bytes)", path, size)
        self._approx_bytes = total
        return evicted

    def gc(self, max_bytes=None, clear_quarantine=True):
        """Operator entry point (`pcache_cli gc`): enforce the size cap
        and (by default) clear the port's quarantined entries.  Returns
        a summary dict."""
        evicted = self.evict(max_bytes=max_bytes)
        cleared = 0
        if clear_quarantine:
            for fname in os.listdir(self.quarantine_dir):
                if not fname.endswith(_SUFFIX):
                    continue
                try:
                    os.remove(os.path.join(self.quarantine_dir, fname))
                    cleared += 1
                except OSError:
                    pass
        return {"evicted": evicted, "quarantine_cleared": cleared,
                **self.stats()}

    def stats(self):
        entries = nbytes = stubs = 0
        for path in self._iter_entries():
            try:
                nbytes += os.stat(path).st_size
                with open(path, "rb") as f:
                    head = f.read(512)
            except OSError:
                continue
            entries += 1
            if b'"kind": "stub"' in head:
                stubs += 1
        quarantined = len([f for f in os.listdir(self.quarantine_dir)
                           if f.endswith(_SUFFIX)])
        return {"root": self.root, "entries": entries, "bytes": nbytes,
                "stubs": stubs, "quarantined": quarantined,
                "max_bytes": self.max_bytes}
