"""CUDA graph capture: the pieces the executor's captured segments and
the decoder's captured loops share.

Counterpart of what `jax.jit` gives the JAX package: a function traced
once per input signature and replayed after.  Here a function of tensors
is captured once into a `torch.cuda.CUDAGraph` on its static input
buffers and replayed; on the CPU nothing is captured and the same
function runs against the same static buffers (the graph's plain
version), so everything but the graph itself runs in the CPU tests.

A signature is warmed up eagerly the first time it runs (cuBLAS and
cuDNN pick their algorithms, the flash kernel is built and loaded,
lazy allocations happen) and captured the second time, as
`torch.compile`'s "reduce-overhead" mode does: a program that runs once
(a startup program, a one-off inference) never pays a capture.

`capture_guard(device)` holds a capture to the rules CUDA sets: no read
of the device from the host (`.item()`, `bool(t)`, `.tolist()`,
`.cpu()`, `.numpy()`, an output whose size depends on values:
`nonzero`, `unique`, `masked_select`, a boolean-mask index, tensor
repeats) and no copy of host data to the device (`torch.tensor`/
`torch.as_tensor` of host data).  On the card a tensor on the CPU is
exempt; on the CPU every tensor is on the capture's device, so the
guard is conservative there and a kernel that reads a CPU tensor it
made itself must not run under it.  The one exception on the CPU is
torch.distributed's own code, whose DTensor bookkeeping reads host
tensors it makes itself (on the card they lie on the host).  A breach
raises `CaptureError`.

A graph holds its memory pool's blocks for as long as it lives.  The
graphs on a card may hold `POOL_SHARE` of its memory together
(`hold`): past that, the least recently replayed other graphs are
dropped (their owners count and log the eviction), so a process that
trains several large programs in turn keeps only the recent ones'
graphs.  A dropped signature is captured again when it next runs.

Kernel launch counts (`kernels.flash_attention`'s) are Python counters
that a replay does not touch: a capture records how many launches its
Python pass made (`launch_snapshot`/`launch_delta`), takes them back
out (the capture launched nothing), and `add_launches` adds them on
each replay.
"""

import contextlib
import gc
import logging
import sys
import threading
import time
import weakref
from collections import OrderedDict

import torch

__all__ = ["CaptureError", "capture_guard", "capturing", "launch_snapshot",
           "launch_delta", "add_launches", "graph_capture", "GraphCall",
           "count_capture", "hold", "touch", "release", "POOL_SHARE"]

_log = logging.getLogger("paddle_tpu_torch.executor")

_FLASH = "paddle_tpu_torch.kernels.flash_attention"


class CaptureError(RuntimeError):
    """A kernel did what a CUDA graph capture forbids, or a capture
    failed; the message names where."""


# -- the guard ----------------------------------------------------------------

_local = threading.local()
_patch_lock = threading.Lock()
_patch_users = 0
_saved = {}

_TENSOR_READS = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                 "__float__", "__index__")
_VALUE_SIZED = (("nonzero", "an output sized by its values"),
                ("unique", "an output sized by its values"),
                ("unique_consecutive", "an output sized by its values"),
                ("masked_select", "an output sized by its values"))


def _guarded_device():
    return getattr(_local, "device", None)


def capturing():
    """Whether this thread runs inside a capture (or, on the CPU, the
    capture's plain version): inside `capture_guard`."""
    return _guarded_device() is not None


def _torch_internal_caller():
    """Whether the guarded call comes from torch.distributed's own code
    (DTensor's bookkeeping: shard sizes and offsets worked out on host
    tensors it makes itself)."""
    f = sys._getframe(1)
    while f is not None and f.f_globals.get("__name__") == __name__:
        f = f.f_back
    return f is not None and str(f.f_globals.get("__name__", "")) \
        .startswith("torch.distributed")


def _breach(what):
    dev = _guarded_device()
    if dev.type == "cpu" and _torch_internal_caller():
        # on the card those tensors lie on the host, which the guard
        # exempts; on the CPU it cannot tell them from the device's
        return
    raise CaptureError("%s inside a CUDA graph capture on %s" % (what, dev))


def _on_device(t):
    dev = _guarded_device()
    return dev is not None and isinstance(t, torch.Tensor) \
        and t.device.type == dev.type


def _wrap_read(name, fn):
    def guarded(self, *args, **kwargs):
        if _on_device(self):
            _breach("a read of the device from the host (Tensor.%s)" % name)
        return fn(self, *args, **kwargs)
    guarded.__name__ = name
    return guarded


def _wrap_sized(name, why, fn):
    def guarded(*args, **kwargs):
        if _guarded_device() is not None and any(
                _on_device(a) for a in args[:1]):
            _breach("%s (%s)" % (name, why))
        return fn(*args, **kwargs)
    guarded.__name__ = name
    return guarded


def _wrap_repeat(fn):
    def guarded(*args, **kwargs):
        repeats = args[1] if len(args) > 1 else kwargs.get("repeats")
        if _guarded_device() is not None and _on_device(repeats) \
                and kwargs.get("output_size") is None:
            _breach("repeat_interleave by tensor repeats without "
                    "output_size (an output sized by its values)")
        return fn(*args, **kwargs)
    return guarded


def _wrap_getitem(fn):
    def guarded(self, idx):
        if _guarded_device() is not None and _on_device(self):
            items = idx if isinstance(idx, tuple) else (idx,)
            if any(isinstance(i, torch.Tensor) and i.dtype in
                   (torch.bool, torch.uint8) for i in items):
                _breach("a boolean-mask index (an output sized by its "
                        "values)")
        return fn(self, idx)
    return guarded


def _wrap_factory(name, fn):
    def guarded(data, *args, **kwargs):
        dev = _guarded_device()
        if dev is not None and not isinstance(data, torch.Tensor):
            target = kwargs.get("device")
            if target is None and name == "as_tensor" and len(args) > 1:
                target = args[1]
            if target is not None and torch.device(target).type == dev.type:
                _breach("a copy of host data to the device "
                        "(torch.%s)" % name)
        return fn(data, *args, **kwargs)
    guarded.__name__ = name
    return guarded


def _patch(owner, name, wrap):
    """Replace owner.name by wrap(original), remembering how to undo it
    (a method the class only inherits is deleted again, not copied)."""
    orig = getattr(owner, name)
    _saved[(owner, name)] = orig if name in vars(owner) else None
    setattr(owner, name, wrap(orig))


def _install():
    for name in _TENSOR_READS:
        _patch(torch.Tensor, name, lambda fn, n=name: _wrap_read(n, fn))
    for name, why in _VALUE_SIZED:
        for owner in (torch, torch.Tensor):
            if hasattr(owner, name):
                _patch(owner, name,
                       lambda fn, n=name, w=why: _wrap_sized(n, w, fn))
    for owner in (torch, torch.Tensor):
        _patch(owner, "repeat_interleave", _wrap_repeat)
    _patch(torch.Tensor, "__getitem__", _wrap_getitem)
    for name in ("tensor", "as_tensor"):
        _patch(torch, name, lambda fn, n=name: _wrap_factory(n, fn))


def _uninstall():
    for (owner, name), orig in _saved.items():
        if orig is None:
            delattr(owner, name)
        else:
            setattr(owner, name, orig)
    _saved.clear()


@contextlib.contextmanager
def capture_guard(device):
    """Within this context, on this thread, a kernel's read of the device
    from the host or copy of host data to the device raises
    CaptureError.  Other threads are not affected."""
    global _patch_users
    with _patch_lock:
        if _patch_users == 0:
            _install()
        _patch_users += 1
    prev = _guarded_device()
    _local.device = torch.device(device)
    try:
        yield
    finally:
        _local.device = prev
        with _patch_lock:
            _patch_users -= 1
            if _patch_users == 0:
                _uninstall()


# -- launch counts ------------------------------------------------------------

def launch_snapshot():
    """The kernel launch counters as they stand: {route: count} plus
    "launches" (empty while no kernel module is imported)."""
    mod = sys.modules.get(_FLASH)
    if mod is None:
        return {}
    fwd = mod.flash_attention_fwd
    snap = dict(fwd.route_launches)
    snap["launches"] = fwd.launches
    return snap


def launch_delta(before):
    """The launches counted since `before` (a launch_snapshot)."""
    now = launch_snapshot()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


def add_launches(delta, sign=1):
    """Add `delta` (a launch_delta) to the counters: each replay of a
    graph adds the launches its capture recorded."""
    if not delta:
        return
    fwd = sys.modules[_FLASH].flash_attention_fwd
    for k, v in delta.items():
        if k == "launches":
            fwd.launches += sign * v
        else:
            fwd.route_launches[k] += sign * v


# -- the pools' budget ---------------------------------------------------------

# the share of a card's memory the captured graphs' pools may hold
# together
POOL_SHARE = 0.4

# (id(owner), key) -> [weakref to the owner, key, device index, bytes],
# least recently replayed first
_held = OrderedDict()
_held_lock = threading.Lock()


def hold(owner, key, device, nbytes):
    """Register the graph `owner` captured under `key`, whose pool grew
    by `nbytes` on `device`; then, while the graphs on that card hold
    more than POOL_SHARE of its memory, drop the least recently replayed
    other ones (`owner.drop_graph(key)`)."""
    if device.type != "cuda":
        return
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    budget = POOL_SHARE * torch.cuda.get_device_properties(idx).total_memory
    token = (id(owner), key)
    victims = []
    with _held_lock:
        for t in [t for t, e in _held.items() if e[0]() is None]:
            del _held[t]
        _held[token] = [weakref.ref(owner), key, idx, int(nbytes)]
        total = sum(e[3] for e in _held.values() if e[2] == idx)
        for t, e in list(_held.items()):
            if total <= budget:
                break
            if t != token and e[2] == idx:
                victims.append(e)
                total -= e[3]
                del _held[t]
    for ref, vkey, _, nb in victims:
        victim = ref()
        if victim is not None:
            _log.debug("dropped the captured graph %r (%d pool bytes) for "
                       "the pools' budget", vkey, nb)
            victim.drop_graph(vkey)


def touch(owner, key):
    """The graph `owner` holds under `key` replayed: most recent now."""
    token = (id(owner), key)
    with _held_lock:
        if token in _held:
            _held.move_to_end(token)


def release(owner, key):
    """The graph `owner` held under `key` is gone."""
    with _held_lock:
        _held.pop((id(owner), key), None)


# -- capture ------------------------------------------------------------------

def _reserved(device):
    return torch.cuda.memory_stats(device).get(
        "reserved_bytes.all.current", 0)


_streams = {}


def _capture_stream(device):
    """The side stream captures run on, one per device."""
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


def graph_capture(fn, device, pool=None, generators=(), label="graph"):
    """Capture `fn()` into a CUDA graph on `device` (in memory pool
    `pool`, with `generators` registered so each replay draws fresh
    random numbers); returns (graph, fn's result, stats), where stats
    holds the capture's seconds, the bytes the pool grew by, and the
    kernel launches the capture recorded.  On the CPU `fn()` runs once
    under `capture_guard` and graph is None.  A failure raises
    CaptureError naming `label`."""
    device = torch.device(device)
    before = launch_snapshot()
    t0 = time.perf_counter()
    try:
        if device.type != "cuda":
            with capture_guard(device):
                out = fn()
            graph, grew = None, 0
        else:
            # as torch.cuda.graph begins a capture, but for its garbage
            # collection, a full collection a capture would pay: no
            # collection runs inside the capture instead, where
            # destroying a graph that dies in a reference cycle breaks
            # it.  The allocator's cache is emptied first (a capture may
            # free no memory), so the growth is the pool's own.
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            reserved = _reserved(device)
            graph = torch.cuda.CUDAGraph()
            for gen in generators:
                graph.register_generator_state(gen)
            stream = _capture_stream(device)
            current = torch.cuda.current_stream(device)
            stream.wait_stream(current)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with capture_guard(device), torch.cuda.stream(stream):
                    graph.capture_begin(pool=pool,
                                        capture_error_mode="thread_local")
                    try:
                        out = fn()
                    except BaseException:
                        # end the broken capture; its own error says less
                        # than the one raised in it
                        with contextlib.suppress(Exception):
                            graph.capture_end()
                        raise
                    graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
            current.wait_stream(stream)
            grew = max(0, _reserved(device) - reserved)
    except CaptureError as exc:
        raise CaptureError("capturing %s: %s" % (label, exc)) from exc
    except Exception as exc:
        raise CaptureError("capturing %s failed: %s: %s"
                           % (label, type(exc).__name__, exc)) from exc
    seconds = time.perf_counter() - t0
    launches = launch_delta(before)
    if graph is not None:
        # the capture's Python pass counted launches that never ran
        add_launches(launches, sign=-1)
    return graph, out, {"seconds": seconds, "pool_bytes": grew,
                        "launches": launches}


def count_capture(label, stats):
    """A capture's telemetry: `executor_jit_traces_total` and the
    `jit_build` instant (obs.telemetry), and its seconds and pool bytes
    as gauges (obs.health.publish_compile_stats)."""
    from ..obs import health as obs_health
    from ..obs import telemetry as obs_tele

    obs_tele.on_jit_trace(label)
    obs_health.publish_compile_stats(label, stats)


class GraphCall:
    """A function of tensors, captured once per key and replayed: the
    decoder's captured loops (fluid/fast_decode.py).

    `__call__(key, fn, inputs, generators=())`: `fn(inputs)` with
    `inputs` {name: tensor}.  The first call with a key runs `fn`
    eagerly (the warmup); the second captures it on static copies of
    the inputs and replays it; later calls copy the inputs into the
    static buffers and replay.  The result of a replay is the graph's
    own output tensors, which the next call with the same key
    overwrites: the caller copies out what it keeps.  On the CPU the
    "replay" runs `fn` on the static buffers.  At most `max_keys`
    graphs are kept (least recently used first out)."""

    def __init__(self, device, max_keys=64):
        self.device = torch.device(device)
        self.max_keys = max_keys
        self._warm = set()
        self._graphs = {}
        self._lock = threading.RLock()
        self.pool = None
        self.captures = 0
        self.replays = 0

    def _pool(self):
        if self.pool is None and self.device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
        return self.pool

    def __call__(self, key, fn, inputs, generators=(), label="call"):
        with self._lock:
            rec = self._graphs.pop(key, None)
            if rec is None and key not in self._warm:
                self._warm.add(key)
                return fn(inputs)
            if rec is None:
                self._warm.discard(key)
                static = {n: t.clone() for n, t in inputs.items()}
                graph, out, stats = graph_capture(
                    lambda: fn(static), self.device, pool=self._pool(),
                    generators=generators, label=label)
                rec = {"graph": graph, "static": static, "out": out,
                       "fn": fn, "stats": stats}
                self.captures += 1
                if graph is None:
                    self._graphs[key] = rec
                    self._evict()
                    return out
                count_capture(label, stats)
                hold(self, key, self.device, stats["pool_bytes"])
            else:
                for n, t in inputs.items():
                    rec["static"][n].copy_(t)
                touch(self, key)
            self._graphs[key] = rec
            self._evict()
            self.replays += 1
            from ..obs import telemetry as obs_tele

            obs_tele.on_graph_replay()
            if rec["graph"] is None:
                return fn(rec["static"])
            rec["graph"].replay()
            add_launches(rec["stats"]["launches"])
            return rec["out"]

    def _evict(self):
        while len(self._graphs) > self.max_keys:
            self.drop_graph(next(iter(self._graphs)))

    def drop_graph(self, key):
        """Drop the graph of `key` (counted as an eviction); its next
        call captures again."""
        from ..obs import telemetry as obs_tele

        with self._lock:
            if self._graphs.pop(key, None) is not None:
                if not self._graphs:
                    # a pool whose graphs are all gone is released
                    self.pool = None
                release(self, key)
                self._warm.add(key)
                obs_tele.on_program_cache_evict()
