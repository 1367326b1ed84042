"""Interval training checkpoints with background writes.

Counterpart of paddle_tpu/fluid/checkpoint.py, writing the same
format: a directory of numbered snapshots `checkpoint_<step, 9
digits>`, each holding one `<name>.npz` per persistable (fluid/io.py's
layout) and, written last with tmp + rename, `_manifest.json`, {name:
{"file", "crc32"}}.  A snapshot without a manifest, or with a file
whose CRC32 does not match, is torn: loading skips it for the one
before, and the saver's garbage collection removes it.  The saver keeps
the newest `max_to_keep` snapshots.

`save` copies every value to the host before it returns (the optimizer
ops update parameters and their state in place on the next step) and
writes from a background thread; one write is in flight at a time, and
its error surfaces on the next `wait` or `save`.  `load_checkpoint`
restores the newest whole snapshot into a scope, on a place's device.
"""

import io
import json
import os
import shutil
import tempfile
import threading
import time
import zlib

from . import framework
from .io import _load_one, _save_one, host_array, is_persistable
from ..core.scope import global_scope
from ..resilience import faults as faults_mod
from ..resilience.retry import RetryPolicy

__all__ = ["CheckpointSaver", "load_checkpoint", "latest_checkpoint"]

_MANIFEST = "_manifest.json"
_PREFIX = "checkpoint_"


def _crc_file(path):
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc


def _snapshot_dirs(root):
    """The snapshot directories under `root`, oldest step first."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith(_PREFIX):
            try:
                out.append((int(name[len(_PREFIX):]), name))
            except ValueError:
                pass
    return [os.path.join(root, name) for _, name in sorted(out)]


def _is_complete(snap_dir):
    return os.path.exists(os.path.join(snap_dir, _MANIFEST))


def latest_checkpoint(root):
    """The newest snapshot directory whose manifest landed, or None."""
    for snap in reversed(_snapshot_dirs(root)):
        if _is_complete(snap):
            return snap
    return None


def _fsync_path(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointSaver:
    """Periodic snapshots of the persistable variables:

        saver = CheckpointSaver("ckpts", interval_secs=600, max_to_keep=3)
        for step, batch in enumerate(reader()):
            exe.run(...)
            saver.maybe_save(step, scope)
        saver.save(step, scope)
        saver.wait()

    It snapshots the persistables of `main_program` (default the default
    main program); a write retries transient I/O errors 3 times."""

    def __init__(self, root, main_program=None, interval_secs=600,
                 max_to_keep=3):
        self.root = root
        self.interval_secs = interval_secs
        self.max_to_keep = max_to_keep
        self._program = main_program
        self._write_retry = RetryPolicy(max_attempts=3, base_delay=0.05,
                                        max_delay=0.5)
        # the first interval counts from construction: a run just
        # resumed does not snapshot again what it loaded
        self._last_time = time.time()
        self._thread = None
        self._error = None

    def _var_names(self):
        program = self._program or framework.default_main_program()
        return [v.name for v in program.list_vars() if is_persistable(v)]

    def maybe_save(self, step, scope=None):
        """Snapshot when `interval_secs` passed since the last one;
        returns the snapshot's path when a save started, else None."""
        if time.time() - self._last_time < self.interval_secs:
            return None
        return self.save(step, scope)

    def save(self, step, scope=None):
        """Copy the persistables' values in `scope` (default the global
        scope) to the host now, and write them as snapshot `step` on a
        background thread; returns the snapshot's path."""
        self.wait()
        scope = scope or global_scope()
        values = {}
        for name in self._var_names():
            val = scope.get(name)
            if val is not None:
                values[name] = host_array(name, val)
        self._last_time = time.time()
        snap = os.path.join(self.root, "%s%09d" % (_PREFIX, step))
        self._thread = threading.Thread(
            target=self._write, args=(snap, values), daemon=True)
        self._thread.start()
        return snap

    def wait(self):
        """Join the write in flight; raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, snap, values):
        try:
            self._write_retry.call(self._write_once, snap, values)
            self._gc()
        except BaseException as e:  # surfaced by the next wait()
            self._error = e

    def _write_once(self, snap, values):
        faults_mod.check("checkpoint/write", snap=snap)
        os.makedirs(snap, exist_ok=True)
        manifest = {}
        for name, value in values.items():
            _save_one(snap, name, value)
            fname = name.replace("/", "_") + ".npz"
            path = os.path.join(snap, fname)
            # on disk before the manifest names it
            _fsync_path(path)
            manifest[name] = {"file": fname, "crc32": _crc_file(path)}
        faults_mod.check("checkpoint/manifest", snap=snap)
        fd, tmp = tempfile.mkstemp(dir=snap)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, os.path.join(snap, _MANIFEST))
        except BaseException:
            # a failed attempt leaves no stray temporary file
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        _fsync_path(snap)

    def _gc(self):
        # on the writer thread, after this snapshot's manifest landed,
        # with no other write in flight: a directory without a manifest
        # is a torn write
        complete, torn = [], []
        for s in _snapshot_dirs(self.root):
            (complete if _is_complete(s) else torn).append(s)
        stale = torn + (complete[:-self.max_to_keep]
                        if self.max_to_keep else [])
        for s in stale:
            shutil.rmtree(s, ignore_errors=True)


def load_checkpoint(root_or_snap, scope=None, strict=True, place=None):
    """Restore the newest whole snapshot under `root_or_snap` (or that
    snapshot itself) into `scope` (default the global scope), each
    value on `place`'s device (default CUDAPlace(0)).  Torn snapshots
    (no manifest, a CRC mismatch, an unreadable file) are skipped for
    the one before.  Returns the restored snapshot's step, or None when
    there is no snapshot; with `strict`, snapshots that all fail to load
    raise IOError."""
    if place is None:
        from .executor import CUDAPlace

        place = CUDAPlace(0)
    device = place.device()
    scope = scope or global_scope()
    if os.path.basename(root_or_snap).startswith(_PREFIX):
        candidates = [root_or_snap]
    else:
        candidates = list(reversed(_snapshot_dirs(root_or_snap)))
    last_err = None
    for snap in candidates:
        if not _is_complete(snap):
            last_err = last_err or IOError("%s has no manifest (torn "
                                           "write?)" % snap)
            continue
        try:
            with open(os.path.join(snap, _MANIFEST)) as f:
                manifest = json.load(f)
            loaded = {}
            for name, meta in manifest.items():
                with open(os.path.join(snap, meta["file"]), "rb") as f:
                    blob = f.read()
                if zlib.crc32(blob) != meta["crc32"]:
                    raise IOError("crc mismatch for %s" % name)
                loaded[name] = _load_one(snap, name,
                                         fileobj=io.BytesIO(blob))
        except (IOError, OSError, ValueError, KeyError) as e:
            last_err = e
            continue
        for name, val in loaded.items():
            scope.set(name, val.to(device))
        return int(os.path.basename(snap)[len(_PREFIX):])
    if candidates and strict:
        raise IOError("no loadable checkpoint under %r (newest error: "
                      "%s)" % (root_or_snap, last_err))
    return None
