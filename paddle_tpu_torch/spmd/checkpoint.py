"""Sharded per-rank checkpoints: save shards, restore shards.

Counterpart of paddle_tpu/spmd/checkpoint.py, with its on-disk format:

    <root>/checkpoint_<step>/host00000/<var>.shard0.npz
                             host00000/_host_manifest.json
                             host00001/...
                             _spmd_manifest.json      (written last)

Each npz holds one shard (`data`), each host manifest maps a var to its
global shape, dtype and shards (file, CRC-32, index `[[start, stop],
...]` into the global array), and the global manifest names the mesh,
the elastic generation, the plan fingerprint and the host directories.
A snapshot written by either package restores in the other.

The JAX package runs one process for all of a host's devices and reads
`Array.addressable_shards`.  Here every rank of the process group is a
process with one shard of each DTensor: a rank writes `host<rank>/`, and
of a DTensor only the local shard it holds at coordinate 0 of every mesh
axis the value is replicated over (JAX's replica 0), its global slice
worked out from the placements and the rank's mesh coordinate.  A plain
tensor or array is one full-extent shard.  The capture is a host copy
taken when `save` is called, so a step run before the writer thread
writes cannot reach the snapshot.

Restore is the mirror: each rank loads only the shard file that covers
its slice of the target layout and builds the DTensor from it
(`DTensor.from_local`, no collective).  When the layout changed between
save and restore (another mesh), the var falls back to a one-off dense
reassembly on the host and the returned info names it.

In a world of more than one rank, every rank writes its shards, the
ranks agree that all wrote (one `all_gather_object`), and rank 0 writes
the global manifest last; `SpmdCheckpointSaver` does that agreement in
`wait()` on the calling thread, never on the writer thread.  So every
rank must call `save` and `wait` at the same step: where each rank
decides by itself (its own clock for an interval, a signal delivered to
one rank), the saver's `agree` makes the decision one for all ranks
first (one all-reduce), and the supervisor and `maybe_save` ask it.

`SpmdCheckpointSaver` adapts this to the resilience supervisor's saver
protocol (save/wait/maybe_save/interval_secs) and adds the
`latest()`/`restore_latest()` hooks the supervisor defers to for sharded
resume (resilience/supervisor.py).
"""

import io as _io
import json
import os
import shutil
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

from ..core.types import tensor_from_numpy
from ..fluid.checkpoint import _PREFIX, _crc_file
from ..fluid.io import _BF16_BYTES, host_array
from ..resilience import faults as faults_mod
from ..resilience.retry import RetryPolicy

__all__ = ["SpmdCheckpointSaver", "save_sharded", "restore_sharded",
           "latest_sharded_checkpoint", "SPMD_MANIFEST",
           "StaleGenerationError", "measure_densify_restore"]

SPMD_MANIFEST = "_spmd_manifest.json"
HOST_MANIFEST = "_host_manifest.json"
SPMD_CKPT_KIND = "spmd_sharded_checkpoint"


class StaleGenerationError(RuntimeError):
    """A sharded manifest carries a newer elastic generation than the
    restoring process: the caller is a STALE host (it missed a view
    change) and must not resurrect an old layout.  Deliberately not an
    IOError — retry policies and the supervisor's transient-fault
    restart loop must never paper over it."""

    def __init__(self, snap, manifest_generation, caller_generation):
        super().__init__(
            "sharded checkpoint %s was written at elastic generation "
            "%d but this process is at generation %d — a stale host "
            "must rejoin the fleet (and adopt the committed view) "
            "before restoring, not resurrect an old layout"
            % (snap, manifest_generation, caller_generation))
        self.snap = snap
        self.manifest_generation = int(manifest_generation)
        self.caller_generation = int(caller_generation)


def _host_dir(process_index):
    return "host%05d" % int(process_index)


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _process():
    """(this process's rank, the world size): (0, 1) without a group."""
    dist = _dist()
    if dist is None:
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _dtensor_cls():
    from torch.distributed.tensor import DTensor

    return DTensor


def _dtype_str(t):
    """The JAX package's name of a tensor's dtype ("float32", ...)."""
    return str(t.dtype).replace("torch.", "")


def _full_key(shape):
    return tuple((0, int(d)) for d in shape)


def _local_key(shape, mesh, placements):
    """This rank's global slice [[start, stop], ...] of a value of
    `shape` laid out by `placements` on `mesh` (torch's chunk split:
    shards of ceil(n / k) rows, the last ones shorter or empty, a
    dimension split over several mesh axes in mesh-axis order), or None
    when the rank is not on the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    start = [0] * len(shape)
    size = [int(d) for d in shape]
    for axis, pl in enumerate(placements):
        if not pl.is_shard():
            continue
        d = pl.dim if pl.dim >= 0 else pl.dim + len(shape)
        n, c = mesh.size(axis), coord[axis]
        chunk = -(-size[d] // n)
        off = min(chunk * c, size[d])
        size[d] = max(0, min(chunk, size[d] - off))
        start[d] += off
    return tuple((s, s + n) for s, n in zip(start, size))


def _is_replica0(mesh, placements):
    """Whether this rank holds replica 0 of its slice: coordinate 0 on
    every mesh axis the value is not split over."""
    coord = mesh.get_coordinate()
    if coord is None:
        return False
    return all(c == 0 for c, pl in zip(coord, placements)
               if not pl.is_shard())


def _capture_shards(name, value):
    """Host copies of the shards of `value` this rank writes, captured
    NOW (the state is replaced, or updated in place, by the next step
    before any writer thread runs).  Returns (global_shape, dtype_str,
    [(index_key, np_array), ...])."""
    if isinstance(value, _dtensor_cls()):
        shape = tuple(int(s) for s in value.shape)
        shards = []
        mesh, pl = value.device_mesh, value.placements
        if _is_replica0(mesh, pl):
            shards.append((_local_key(shape, mesh, pl),
                           host_array(name, value.to_local())))
        return shape, _dtype_str(value), shards
    if isinstance(value, torch.Tensor):
        shape = tuple(int(s) for s in value.shape)
        return shape, _dtype_str(value), [(_full_key(shape),
                                           host_array(name, value))]
    arr = np.array(value)
    shape = tuple(int(s) for s in arr.shape)
    return shape, str(arr.dtype), [(_full_key(shape), arr)]


def _fsync_path(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_json(dirpath, fname, blob):
    fd, tmp = tempfile.mkstemp(dir=dirpath)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(blob, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, os.path.join(dirpath, fname))
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    _fsync_path(dirpath)


def _write_host_shards(snap, captured, process_index):
    """Write one host's shard files + host manifest under `snap`."""
    faults_mod.check("checkpoint/write", snap=snap)
    hdir = os.path.join(snap, _host_dir(process_index))
    os.makedirs(hdir, exist_ok=True)
    manifest = {}
    for name, (shape, dtype, shards) in captured.items():
        entries = []
        for j, (key, arr) in enumerate(shards):
            fname = "%s.shard%d.npz" % (name.replace("/", "_"), j)
            path = os.path.join(hdir, fname)
            with open(path, "wb") as f:
                np.savez(f, data=arr)
                f.flush()
                os.fsync(f.fileno())
            entries.append({"file": fname, "crc32": _crc_file(path),
                            "index": [list(se) for se in key]})
        manifest[name] = {"global_shape": list(shape), "dtype": dtype,
                          "shards": entries}
    _atomic_json(hdir, HOST_MANIFEST, manifest)
    return hdir


def _global_manifest(step, n_processes, names, mesh_axes, specs,
                     generation, plan_fingerprint):
    return {
        "kind": SPMD_CKPT_KIND,
        "step": int(step),
        "n_processes": int(n_processes),
        "hosts": [_host_dir(i) for i in range(int(n_processes))],
        "vars": sorted(names),
        "mesh": dict(mesh_axes or {}),
        "specs": {n: list(s) if s is not None else None
                  for n, s in (specs or {}).items()},
        # elastic identity: which cluster view trained this state,
        # laid out by which plan — a view change is DETECTABLE at
        # restore (generation guard + mesh/fingerprint mismatch)
        "generation": int(generation or 0),
        "plan_fingerprint": plan_fingerprint,
        "time": time.time(),
    }


def _all_ok(ok):
    """Every rank's `ok`, gathered (a collective every rank joins, so a
    rank whose write failed never leaves the others waiting)."""
    dist = _dist()
    if dist is None:
        return [bool(ok)]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, bool(ok))
    return out


def _any_rank(flags):
    """Each of `flags`, True on every rank where any rank of the process
    group has it True (one all-reduce every rank joins); the flags as
    given in a world of one."""
    flags = [bool(f) for f in flags]
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return flags
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    votes = torch.tensor(flags, dtype=torch.int32, device=device)
    dist.all_reduce(votes, op=dist.ReduceOp.MAX)
    return [bool(v) for v in votes.tolist()]


def save_sharded(root, step, state, process_index=None, n_processes=None,
                 mesh_axes=None, specs=None, generation=0,
                 plan_fingerprint=None):
    """Write this rank's shards of `state` under a new snapshot dir.

    process_index and n_processes default to the process group's rank
    and world size (0 and 1 without a group).  Process 0 writes the
    global `_spmd_manifest.json` completion marker LAST, once every
    rank of a world of more than one has written its shards (every rank
    of the group calls this), so an incomplete snapshot (a host died
    mid-write) is detectable exactly like the dense saver's torn
    writes.

    Returns the snapshot path.
    """
    rank, world = _process()
    process_index = rank if process_index is None else int(process_index)
    n_processes = world if n_processes is None else int(n_processes)
    snap = os.path.join(str(root), "%s%09d" % (_PREFIX, int(step)))
    os.makedirs(snap, exist_ok=True)
    captured = {n: _capture_shards(n, v) for n, v in state.items()}
    err = None
    try:
        _write_host_shards(snap, captured, process_index)
    except Exception as e:  # noqa: BLE001 — re-raised after the vote
        err = e
    if n_processes > 1 and not all(_all_ok(err is None)):
        raise err or IOError("another rank failed to write its shards "
                             "of %s" % snap)
    if err is not None:
        raise err
    if process_index == 0:
        _atomic_json(snap, SPMD_MANIFEST, _global_manifest(
            step, n_processes, captured, mesh_axes, specs, generation,
            plan_fingerprint))
    if n_processes > 1:
        _all_ok(True)  # nobody reads the snapshot before it is whole
    return snap


def _snapshot_dirs(root):
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


def latest_sharded_checkpoint(root):
    """Newest snapshot whose global spmd manifest landed, or None."""
    for snap in reversed(_snapshot_dirs(str(root))):
        if os.path.exists(os.path.join(snap, SPMD_MANIFEST)):
            return snap
    return None


def _empty(shape, dtype):
    """A zero host array of a manifest dtype (bfloat16 by its bits)."""
    if dtype == "bfloat16":
        return np.zeros(shape, dtype=_BF16_BYTES)
    return np.zeros(shape, dtype=np.dtype(dtype))


class _ShardReader:
    """CRC-verified lazy loader over one snapshot's host manifests:
    each shard file is read at most once, and only when some rank
    actually needs its slice."""

    def __init__(self, snap):
        self.snap = snap
        with open(os.path.join(snap, SPMD_MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("kind") != SPMD_CKPT_KIND:
            raise IOError("%s is not a sharded spmd checkpoint (kind=%r)"
                          % (snap, self.manifest.get("kind")))
        self.step = int(self.manifest["step"])
        self.generation = int(self.manifest.get("generation", 0))
        self.plan_fingerprint = self.manifest.get("plan_fingerprint")
        # var -> index_key -> (host_dir, entry); later hosts never
        # collide with earlier ones on a key (each host saves only the
        # replica-0 shards it owns)
        self.index = {}
        self.vars = {}
        for host in self.manifest.get("hosts", []):
            hpath = os.path.join(snap, host, HOST_MANIFEST)
            if not os.path.exists(hpath):
                raise IOError("snapshot %s is missing %s/%s (torn "
                              "multi-host write?)" % (snap, host,
                                                      HOST_MANIFEST))
            with open(hpath) as f:
                hman = json.load(f)
            for name, ventry in hman.items():
                self.vars.setdefault(name, ventry)
                per_var = self.index.setdefault(name, {})
                for entry in ventry["shards"]:
                    key = tuple(tuple(se) for se in entry["index"])
                    per_var.setdefault(key, (host, entry))
        self._cache = {}

    def load_shard(self, name, key):
        """The np array for var `name`'s shard at `key`, or None when
        the snapshot holds no shard with exactly that slice."""
        hit = self.index.get(name, {}).get(key)
        if hit is None:
            return None
        host, entry = hit
        ck = (host, entry["file"])
        if ck not in self._cache:
            path = os.path.join(self.snap, host, entry["file"])
            with open(path, "rb") as f:
                blob = f.read()
            if zlib.crc32(blob) != entry["crc32"]:
                raise IOError("crc mismatch for %s shard %s"
                              % (name, entry["file"]))
            with np.load(_io.BytesIO(blob)) as z:
                self._cache[ck] = z["data"]
        return self._cache[ck]

    def dense(self, name):
        """Dense reassembly of var `name` from all its shards — the
        layout-changed fallback only."""
        ventry = self.vars[name]
        shape = tuple(ventry["global_shape"])
        out = None
        for key in self.index.get(name, {}):
            arr = self.load_shard(name, key)
            if out is None:
                out = np.zeros(shape, dtype=arr.dtype)
            out[tuple(slice(s, e) for s, e in key)] = arr
        return out if out is not None else _empty(shape,
                                                  ventry["dtype"])


def _to_tensor(arr, device):
    if arr.dtype == _BF16_BYTES:
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16).to(device)
    return tensor_from_numpy(arr, device)


def _mesh_device(mesh):
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def restore_sharded(snap, shardings, strict=True, max_generation=None):
    """Re-place a sharded snapshot onto the mesh WITHOUT densifying.

    snap: a snapshot dir (or a root — the newest complete snapshot is
        picked).
    shardings: {name: parallel.sharding.NamedSharding} — the TARGET
        layout (the trainer's step shardings).  Each rank loads exactly
        the saved shard covering its slice and the DTensor is built
        from it with `DTensor.from_local`.
    max_generation: the caller's elastic generation; a manifest
        stamped with a NEWER generation raises `StaleGenerationError`
        naming both (a host that missed a view change must not
        silently resurrect an old layout).  None skips the guard
        (non-elastic jobs).

    Returns (state, info): info carries "step", "generation" and
    "densified" — vars whose saved slicing didn't match the target
    layout (mesh changed between save and restore) and went through a
    dense host rebuild.  With strict=True, a var present in
    `shardings` but absent from the snapshot raises.
    """
    snap = str(snap)
    if not os.path.exists(os.path.join(snap, SPMD_MANIFEST)):
        newest = latest_sharded_checkpoint(snap)
        if newest is None:
            raise IOError("no complete sharded checkpoint under %r"
                          % snap)
        snap = newest
    reader = _ShardReader(snap)
    if max_generation is not None \
            and reader.generation > int(max_generation):
        raise StaleGenerationError(snap, reader.generation,
                                   max_generation)
    state, densified = {}, []
    for name in sorted(shardings):
        sharding = shardings[name]
        ventry = reader.vars.get(name)
        if ventry is None:
            if strict:
                raise KeyError("sharded checkpoint %s is missing var %r"
                               % (snap, name))
            continue
        shape = tuple(ventry["global_shape"])
        mesh, pl = sharding.mesh, sharding.placements
        key = _local_key(shape, mesh, pl)
        if key is None:  # this rank is not on the target mesh
            arr = _empty([0] * len(shape), ventry["dtype"])
        else:
            arr = reader.load_shard(name, key)
            if arr is None:
                # layout changed since the save: rebuild densely once
                # and slice — the exception path, never the mainline
                arr = reader.dense(name)[
                    tuple(slice(s, e) for s, e in key)]
                densified.append(name)
        local = _to_tensor(np.ascontiguousarray(arr), _mesh_device(mesh))
        stride = torch.empty(shape, device="meta").stride()
        state[name] = _dtensor_cls().from_local(
            local, mesh, pl, run_check=False, shape=torch.Size(shape),
            stride=stride)
    return state, {"step": reader.step, "snap": snap,
                   "generation": reader.generation,
                   "densified": sorted(set(densified))}


def _spec_entries(spec):
    return [list(e) if isinstance(e, (list, tuple)) else e for e in spec]


class SpmdCheckpointSaver:
    """The supervisor-protocol saver over sharded snapshots.

    Bound to a trainer (anything with `.state` {name: DTensor},
    `._shardings` {name: NamedSharding} and a `mesh`): `save` captures
    host copies of this rank's shards synchronously and writes them on
    a background thread (the dense CheckpointSaver contract —
    `save(step, scope)` ignores the scope, the trainer's state IS the
    source of truth); `restore_latest` re-places the newest complete
    snapshot into the trainer sharded.  The resilience supervisor
    detects `latest`/`restore_latest` and routes resume through them
    (see TrainingSupervisor._restore_latest), which is what
    `spmd.attach_supervisor` wires up.

    In a world of one the writer thread also writes the global manifest,
    as on the JAX side; in a larger world every rank calls `save` and
    `wait` at the same step, and `wait` (on the calling thread) agrees
    with the other ranks that all shards landed before rank 0 writes
    the manifest.  `agree` gives a per-rank decision to save (an
    interval on this rank's clock, a preemption signal this rank saw)
    as one answer for all ranks: `maybe_save` and the supervisor ask it
    before a save.  `last_capture_s` and `last_write_s` time the latest
    save's capture (on the caller's thread) and its background write.
    """

    def __init__(self, trainer, root, interval_secs=30.0,
                 max_to_keep=3, write_retry=None):
        self.trainer = trainer
        self.root = str(root)
        self.interval_secs = interval_secs
        self.max_to_keep = max_to_keep
        self._write_retry = write_retry or RetryPolicy(
            max_attempts=3, base_delay=0.05, max_delay=0.5,
            name="spmd_checkpoint_write")
        self._last_time = time.time()
        self._thread = None
        self._error = None
        self._pending = None   # the manifest a larger world still owes
        self.last_capture_s = None
        self.last_write_s = None

    # -- CheckpointSaver protocol ------------------------------------------
    def maybe_save(self, step, scope=None):
        (due,) = self.agree(time.time() - self._last_time
                            >= self.interval_secs)
        if not due:
            return None
        return self.save(step, scope)

    def agree(self, *flags):
        """Each flag True on every rank where any rank of the process
        group has it True (the flags as given in a world of one); every
        rank calls it at the same step."""
        return _any_rank(flags)

    def save(self, step, scope=None):
        self.wait()  # one in-flight snapshot at a time
        state = self.trainer.state
        if state is None:
            raise ValueError("trainer has no state to checkpoint "
                             "(init() not run)")
        t0 = time.perf_counter()
        captured = {n: _capture_shards(n, v) for n, v in state.items()}
        self.last_capture_s = time.perf_counter() - t0
        specs = {n: _spec_entries(s.spec) for n, s in
                 getattr(self.trainer, "_shardings", {}).items()}
        from ..parallel.mesh import mesh_shape

        mesh_axes = {a: int(v) for a, v in
                     mesh_shape(self.trainer.mesh).items()}
        # elastic identity, captured NOW (the trainer may adopt a new
        # view before the writer thread runs)
        generation = getattr(self.trainer, "elastic_generation",
                             None) or 0
        plan = getattr(self.trainer, "plan", None)
        plan_fp = plan.fingerprint() if plan is not None else None
        rank, world = _process()
        self._last_time = time.time()
        snap = os.path.join(self.root, "%s%09d" % (_PREFIX, int(step)))
        manifest = _global_manifest(step, world, captured, mesh_axes,
                                    specs, generation, plan_fp)
        self._pending = (snap, manifest, rank, world)
        self._thread = threading.Thread(
            target=self._write, args=(snap, captured, manifest, rank,
                                      world), daemon=True)
        self._thread.start()
        return snap

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        pending, self._pending = self._pending, None
        if pending is not None and pending[3] > 1:
            snap, manifest, rank, _world = pending
            ok = all(_all_ok(self._error is None))
            if ok and rank == 0:
                try:
                    manifest["time"] = time.time()
                    _atomic_json(snap, SPMD_MANIFEST, manifest)
                    self._gc()
                except Exception as e:  # noqa: BLE001 — surfaced below
                    self._error = e
            ok = all(_all_ok(self._error is None)) and ok
            if self._error is None and not ok:
                self._error = IOError("another rank failed to write its "
                                      "shards of %s" % snap)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, snap, captured, manifest, rank, world):
        t0 = time.perf_counter()
        try:
            self._write_retry.call(self._write_once, snap, captured,
                                   manifest, rank, world)
            if world == 1:
                self._gc()
        except BaseException as e:  # surfaced on the next wait()/save()
            self._error = e
        self.last_write_s = time.perf_counter() - t0

    def _write_once(self, snap, captured, manifest, rank, world):
        os.makedirs(snap, exist_ok=True)
        _write_host_shards(snap, captured, process_index=rank)
        if world == 1:
            manifest["time"] = time.time()
            _atomic_json(snap, SPMD_MANIFEST, manifest)

    def _gc(self):
        complete, torn = [], []
        for s in _snapshot_dirs(self.root):
            (complete if os.path.exists(os.path.join(s, SPMD_MANIFEST))
             else torn).append(s)
        stale = torn + (complete[:-self.max_to_keep]
                        if self.max_to_keep else [])
        for s in stale:
            shutil.rmtree(s, ignore_errors=True)

    # -- supervisor sharded-resume hooks -----------------------------------
    def latest(self):
        """Newest complete snapshot dir (the supervisor's existence +
        meta-sidecar anchor), or None."""
        return latest_sharded_checkpoint(self.root)

    def restore_latest(self, scope=None):
        """Restore the newest complete snapshot into the trainer,
        sharded; falls back over torn/corrupt snapshots like the dense
        loader.  Returns the restored step, or None when the root
        holds no snapshot at all."""
        candidates = [s for s in reversed(_snapshot_dirs(self.root))
                      if os.path.exists(os.path.join(s, SPMD_MANIFEST))]
        if not candidates:
            return None
        last_err = None
        max_gen = getattr(self.trainer, "elastic_generation", None)
        for snap in candidates:
            try:
                # StaleGenerationError is a RuntimeError and escapes
                # this loop on purpose: a stale host must stop, not
                # fall back to an even older snapshot
                state, info = restore_sharded(
                    snap, self.trainer._shardings,
                    max_generation=max_gen)
            except (IOError, OSError, ValueError, KeyError) as e:
                last_err = e
                continue
            self.trainer.state = state
            self._last_time = time.time()
            if info["densified"]:
                print("spmd.checkpoint: layout changed since save; "
                      "densified %d var(s) on restore: %s"
                      % (len(info["densified"]),
                         ", ".join(info["densified"][:5])))
            return info["step"]
        raise IOError("no loadable sharded checkpoint under %r "
                      "(newest error: %s)" % (self.root, last_err))


def measure_densify_restore(root, from_dp=8, to_dp=4, n_vars=4,
                            rows=1024, cols=256, seed=0):
    """Pin the cost of the layout-changed densify restore path.

    Saves a synthetic `from_dp`-way dp-sharded state (over the first
    `from_dp` ranks of the process group; every rank of the group
    calls this; its ranks' device, the CPU without a group of NCCL
    ranks), then restores it onto a `to_dp`-way mesh — every
    var's saved slicing misses the target slices when the split
    changed, so each goes through the one-off dense reassembly (the
    elastic shrink's restore path).  Verifies the round-trip bit-exactly
    on every rank and returns a pmem-style blob (`kind:
    paddle_tpu.densify_restore_measurement`) with the reassembly
    throughput and, on the card, `device_peak_bytes` from `obs.mem`'s
    device watermarks (the CPU reports none, and the blob leaves it
    out, as the JAX function does where the backend reports no
    allocator stats).  `elastic_cli densify-bench` prints it.
    """
    from torch.distributed.tensor import Shard

    from ..parallel.mesh import ensure_world, make_mesh

    dist = _dist()
    device = "cuda" if dist is not None \
        and dist.get_backend() == "nccl" else "cpu"
    world = ensure_world(device)
    need = max(int(from_dp), int(to_dp))
    if world < need:
        raise ValueError("need %d devices for the measurement, have %d"
                         % (need, world))
    if rows % need:
        raise ValueError("rows=%d not divisible by %d" % (rows, need))
    rng = np.random.default_rng(seed)
    originals = {"w%03d" % i:
                 rng.standard_normal((int(rows), int(cols)))
                 .astype(np.float32) for i in range(int(n_vars))}
    mesh_from = make_mesh(n_devices=int(from_dp), dp=int(from_dp),
                          axes=("dp",), device=device)
    dtensor = _dtensor_cls()
    state = {}
    for n, a in originals.items():
        key = _local_key(a.shape, mesh_from, [Shard(0)])
        part = a[key[0][0]:key[0][1]] if key is not None else a[:0]
        state[n] = dtensor.from_local(
            torch.from_numpy(part.copy()).to(_mesh_device(mesh_from)),
            mesh_from, [Shard(0)], run_check=False,
            shape=torch.Size(a.shape), stride=(int(cols), 1))
    snap = save_sharded(root, step=0, state=state,
                        mesh_axes={"dp": int(from_dp)})
    mesh_to = make_mesh(n_devices=int(to_dp), dp=int(to_dp),
                        axes=("dp",), device=device)
    from ..parallel.sharding import NamedSharding, P

    shardings_to = {n: NamedSharding(mesh_to, P("dp")) for n in state}
    t0 = time.perf_counter()
    restored, info = restore_sharded(snap, shardings_to)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    good = True
    for n, arr in originals.items():
        key = _local_key(arr.shape, mesh_to, [Shard(0)])
        if key is None:
            continue
        local = restored[n].to_local().cpu().numpy()
        good = good and np.array_equal(local, arr[key[0][0]:key[0][1]])
    if not all(_all_ok(good)):
        raise AssertionError("densify restore corrupted a var")
    bytes_total = sum(a.nbytes for a in originals.values())
    blob = {
        "kind": "paddle_tpu.densify_restore_measurement", "version": 1,
        "from_mesh": {"dp": int(from_dp)},
        "to_mesh": {"dp": int(to_dp)},
        "n_vars": int(n_vars), "bytes_total": int(bytes_total),
        "densified": len(info["densified"]),
        "seconds": round(seconds, 6),
        "mib_per_s": round(bytes_total / (1 << 20) / seconds, 2)
        if seconds > 0 else None,
        "verified": True,
    }
    from ..obs import mem as mem_mod

    marks = mem_mod.device_watermarks()
    if marks:
        blob["device_peak_bytes"] = max(
            s.get("peak_bytes_in_use", 0) for s in marks.values())
    return blob
