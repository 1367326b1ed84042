"""Numerics health monitoring: on-device nonfinite detection, grad-norm
gauges, and a bisection tool for a step that went nonfinite.

Counterpart of paddle_tpu/obs/health.py.  The reference executor's only
numerics guard is the per-op NaN/Inf scan (reference: executor.cc:29
FLAGS_check_nan_inf + CheckTensorNANOrInf executor.cc:66-77), which the
port's executor runs under the same flag at the cost of one read back
per op output.  This module adds the cheap, always-on layer beside it:

  * `NumericsMonitor` — appends on-device reductions to a Program
    (nan/inf counts via the `count_nonfinite` op, max-abs via
    abs+reduce_max, global grad norm via `fluid/clip.py`'s
    `append_global_norm`).  The reductions ride the regular fetch path
    as a few extra scalars, read back with the step's other fetches
    after its last op.  `record()` feeds them into registry
    counters/gauges: `numerics_nonfinite_total{tensor=...}`,
    `numerics_max_abs{tensor=...}`, `grad_global_norm`.
  * `locate_nonfinite(program, feed)` — replays the offending step
    with FLAGS_check_nan_inf set and returns the first op whose output
    went non-finite (op type, index, output var), against a copy of
    the scope that leaves the caller's bit for bit as it was.
  * `scan_outputs` — the serving engine's host-side count over its
    already-fetched outputs.

Trainers check the module switch: `health.enable()` makes the v2 SGD
loop install a monitor by itself (watching the cost plus every
parameter gradient).  Everything here only watches — results are never
changed.

`publish_compile_stats` and `retire_compile_stats` keep the JAX
module's names for what a capture costs: the JAX module publishes each
compiled segment's XLA memory and cost analyses (`xla_*` gauges), the
port publishes each captured segment's capture seconds and the bytes
its graph pool grew by (`graph_capture_seconds{segment}`,
`graph_pool_bytes{segment}`), forwards the pool bytes to `obs.mem`
(the actual side of its drift join), and retires them when the
executor's cache evicts the program.  On the card every capture
publishes.  `force_attribution` and `attribution_forced` keep the JAX
package's switch: in its body the executor also registers each captured
segment's static peak at plan time (the static side of obs.mem's drift
join) and publishes the CPU's plain captures (their seconds; nothing
holds a pool there).  FLAGS_xla_cost_attribution, the JAX flag, means
the same and is read only by `attribution_wanted`.  Neither causes an
extra warm-up or capture.

Import-cheap by design: fluid is imported lazily inside methods, so
`paddle_tpu_torch.obs` stays free of framework import cycles.
"""

import threading

import numpy as np

from . import registry as registry_mod
from . import telemetry as telemetry_mod

__all__ = ["NumericsMonitor", "locate_nonfinite", "scan_outputs",
           "enable", "disable", "enabled", "force_attribution",
           "attribution_forced", "publish_compile_stats",
           "retire_compile_stats"]

_enabled = False

# one stable prefix so health vars are recognizable in program dumps
VAR_PREFIX = "health_"

# counting override of the compile-attribution switch (see above)
_attr_lock = threading.Lock()
_attr_forced = 0


class _ForcedAttribution:
    def __enter__(self):
        global _attr_forced
        with _attr_lock:
            _attr_forced += 1
        return self

    def __exit__(self, *exc):
        global _attr_forced
        with _attr_lock:
            _attr_forced -= 1
        return False


def force_attribution():
    """`with health.force_attribution(): ...` — compile attribution is
    on in the body; nests and composes across threads."""
    return _ForcedAttribution()


def attribution_forced():
    return _attr_forced > 0


def enable():
    """Turn trainer-side numerics monitoring on: the v2 SGD loop
    installs a NumericsMonitor on its next train/step_runner."""
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def enabled():
    return _enabled


def _nonfinite_family(reg):
    return reg.counter("numerics_nonfinite_total",
                       "NaN/Inf elements observed in watched tensors",
                       labelnames=("tensor",))


# ---------------------------------------------------------------------------
# NumericsMonitor
# ---------------------------------------------------------------------------

class NumericsMonitor:
    """Appends on-device numerics reductions to a Program and turns the
    fetched scalars into registry signals.

    Usage:
        mon = NumericsMonitor(program, tensors=[loss.name],
                              grads=None).install()   # None = discover
        outs = exe.run(program, feed=...,
                       fetch_list=user_fetches + mon.fetch_names)
        mon.record(dict(zip(mon.fetch_names, outs[len(user_fetches):])))

    tensors: Variables/names to watch (nonfinite count + max-abs each).
    grads:   grad Variables/names folded into ONE global-norm scalar
             (fluid/clip.py's append_global_norm); None auto-discovers
             every parameter gradient written in block 0; pass [] to
             skip the norm.
    loss_scaler: optional fluid.amp.LossScaler updated from the
             found-nonfinite signal on every record() (publishes the
             `amp_loss_scale` gauge).
    """

    def __init__(self, program, tensors=None, grads=None,
                 loss_scaler=None):
        self.program = program
        self.loss_scaler = loss_scaler
        self._tensors = [self._name_of(t) for t in (tensors or [])]
        self._grads = (None if grads is None
                       else [self._name_of(g) for g in grads])
        self._outputs = []   # (kind, tensor_label, out_var_name)
        self._installed = False
        self.last = None

    @staticmethod
    def _name_of(v):
        return v if isinstance(v, str) else v.name

    @classmethod
    def for_train_program(cls, program, cost=None, params_grads=None,
                          loss_scaler=None):
        """Monitor a training program: watch the cost, global-norm all
        known gradients (from params_grads when the caller has them,
        discovered from the block otherwise)."""
        grads = None
        if params_grads is not None:
            grads = [g for _, g in params_grads if g is not None]
        return cls(program, tensors=[cost] if cost is not None else [],
                   grads=grads, loss_scaler=loss_scaler)

    # -- program instrumentation --------------------------------------------
    def _discover_grads(self):
        from ..fluid import framework

        block = self.program.global_block()
        written = set()
        for od in block.desc.ops:
            for names in od.outputs.values():
                written.update(names)
        return [name + "@GRAD" for name, var in block.vars.items()
                if isinstance(var, framework.Parameter)
                and name + "@GRAD" in written]

    def _count(self, block, name):
        from ..fluid import framework

        cnt = block.create_var(
            name=framework.unique_name(VAR_PREFIX + "nonfinite"),
            dtype="int32", shape=(1,))
        block.append_op(type="count_nonfinite", inputs={"X": [name]},
                        outputs={"Out": [cnt]})
        self._outputs.append(("nonfinite", name, cnt.name))

    def install(self):
        """Append the reduction ops (idempotent).  Returns self."""
        if self._installed:
            return self
        from ..fluid import clip as clip_mod
        from ..fluid import framework

        block = self.program.global_block()
        for name in self._tensors:
            watched = block.var_recursive(name)
            self._count(block, name)
            absv = block.create_var(
                name=framework.unique_name(VAR_PREFIX + "abs"),
                dtype=watched.dtype, shape=watched.shape)
            block.append_op(type="abs", inputs={"X": [name]},
                            outputs={"Out": [absv]})
            mx = block.create_var(
                name=framework.unique_name(VAR_PREFIX + "maxabs"),
                dtype=watched.dtype, shape=(1,))
            block.append_op(type="reduce_max", inputs={"X": [absv]},
                            outputs={"Out": [mx]},
                            attrs={"reduce_all": True})
            self._outputs.append(("maxabs", name, mx.name))
        grads = self._grads if self._grads is not None \
            else self._discover_grads()
        for gname in grads:
            self._count(block, gname)
        if grads:
            gnorm = clip_mod.append_global_norm(
                block, [block.var_recursive(g) for g in grads],
                prefix=VAR_PREFIX + "global_norm")
            self._outputs.append(("gnorm", None, gnorm.name))
        self._installed = True
        return self

    @property
    def fetch_names(self):
        """Monitor output var names to append to the fetch list."""
        return [vname for _, _, vname in self._outputs]

    # -- signal publishing ---------------------------------------------------
    def record(self, values):
        """Feed one step's fetched monitor scalars into the registry.
        `values`: dict name->value, or a sequence aligned with
        `fetch_names`.  Returns a summary dict (and remembers it as
        `.last`)."""
        if not isinstance(values, dict):
            values = dict(zip(self.fetch_names, values))
        reg = registry_mod.get_registry()
        fam = _nonfinite_family(reg)
        summary = {"nonfinite": {}, "max_abs": {}}
        found = 0
        for kind, label, vname in self._outputs:
            val = values.get(vname)
            if val is None:
                continue
            scalar = np.asarray(val).reshape(-1)[0]
            if kind == "nonfinite":
                c = int(scalar)
                summary["nonfinite"][label] = c
                found += c
                # inc(0) still creates the child, so /metrics shows the
                # watched tensor at 0 instead of omitting it
                fam.labels(tensor=label).inc(c)
            elif kind == "maxabs":
                v = float(scalar)
                summary["max_abs"][label] = v
                reg.gauge("numerics_max_abs",
                          "max |x| of watched tensors (most recent "
                          "step)", labelnames=("tensor",)) \
                   .labels(tensor=label).set(v)
            else:
                v = float(scalar)
                summary["grad_global_norm"] = v
                telemetry_mod.set_gauge("grad_global_norm", v)
        summary["found_nonfinite"] = bool(found)
        if self.loss_scaler is not None:
            summary["loss_scale"] = self.loss_scaler.update(found > 0)
        self.last = summary
        return summary


# ---------------------------------------------------------------------------
# eager bisection
# ---------------------------------------------------------------------------

def _copy_value(value):
    """An independent copy of a scope value: tensors (also inside a
    RaggedTensor, SelectedRows or TensorArray) cloned, a random stream
    (torch.Generator) copied with its state."""
    import torch
    import torch.utils._pytree as pytree

    if isinstance(value, torch.Generator):
        gen = torch.Generator(device=value.device)
        gen.set_state(value.get_state())
        return gen
    return pytree.tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, value)


def _clone_scope(scope):
    """A flat copy of a scope chain in a fresh Scope, every tensor
    copied, so the replay can neither rebind nor write in place into
    the caller's state (optimizer ops re-run during the replay, and
    some update in place: core/ragged.py `add_rows_`)."""
    from ..core.scope import Scope

    clone = Scope()
    s = scope
    while s is not None:
        for name, value in s._vars.items():
            if name not in clone._vars:
                clone._vars[name] = _copy_value(value)
        s = s._parent
    return clone


def locate_nonfinite(program, feed, fetch_list=None, scope=None,
                     place=None, clone_scope=True):
    """Replay `program` with FLAGS_check_nan_inf set and return the
    first op producing a non-finite output, as a dict:

        {"op_type", "op_index", "output_slot", "var_name",
         "nonfinite_count", "message"}

    or None when the whole replay stays finite.  `place` defaults to
    the executor's, CUDAPlace(0).

    The replay runs against a copy of `scope` by default
    (clone_scope=False replays in place, mutating optimizer state
    exactly like a real step would).  Flight-recorder crash dumps are
    suppressed for the replay — it is a diagnosis, not a crash.
    """
    from ..core.scope import global_scope
    from ..fluid import executor as executor_mod
    from ..utils import flags as flags_mod
    from . import flight as flight_mod

    scope = scope if scope is not None else global_scope()
    if clone_scope:
        scope = _clone_scope(scope)
    exe = executor_mod.Executor(place)
    prev = flags_mod.get_flag("check_nan_inf")
    flags_mod.set_flag("check_nan_inf", True)
    try:
        with flight_mod.suppressed():
            exe.run(program, feed=dict(feed),
                    fetch_list=list(fetch_list or []), scope=scope)
        return None
    except executor_mod.NonfiniteError as err:
        return {"op_type": err.op_type, "op_index": err.op_index,
                "output_slot": err.slot, "var_name": err.var_name,
                "nonfinite_count": err.nonfinite_count,
                "message": str(err)}
    finally:
        flags_mod.set_flag("check_nan_inf", prev)


# ---------------------------------------------------------------------------
# host-side output scanning (serving)
# ---------------------------------------------------------------------------

def scan_outputs(named_values):
    """Count NaN/Inf elements in already-fetched host values (serving
    fetch outputs: numpy arrays, host RaggedTensors) into
    `numerics_nonfinite_total{tensor=}`.  Returns the total found."""
    from ..core.ragged import RaggedTensor, SelectedRows

    fam = _nonfinite_family(registry_mod.get_registry())
    total = 0
    for name, val in named_values:
        if isinstance(val, (RaggedTensor, SelectedRows)):
            val = val.values
        arr = np.asarray(val)
        if arr.dtype.kind not in "fc":
            continue
        bad = int(arr.size - np.isfinite(arr).sum())
        fam.labels(tensor=name).inc(bad)
        total += bad
    return total


_COMPILE_GAUGES = (
    ("graph_capture_seconds", "seconds",
     "seconds one CUDA graph capture took, per captured segment"),
    ("graph_pool_bytes", "pool_bytes",
     "bytes the graph memory pool grew by at the capture, per captured "
     "segment"),
)


def attribution_wanted():
    """Whether captures publish their stats on the CPU too and the
    executor registers static peaks: FLAGS_xla_cost_attribution or a
    `force_attribution` body."""
    from ..utils import flags

    return bool(flags.get_flag("xla_cost_attribution")
                or attribution_forced())


def publish_compile_stats(segment, stats):
    """Publish one capture's `stats` ({"seconds", "pool_bytes"}, from
    fluid.graphs.graph_capture) as per-segment-label gauges and forward
    the pool bytes to `obs.mem` (its drift join's actual side;
    `stats["first_in_pool"]` says whether the capture was the first
    into its pool); returns the published values."""
    reg = registry_mod.get_registry()
    published = {}
    for gauge, key, help_text in _COMPILE_GAUGES:
        v = (stats or {}).get(key)
        if v is None:
            continue
        reg.gauge(gauge, help_text, labelnames=("segment",)) \
           .labels(segment=segment).set(float(v))
        published[gauge] = float(v)
    if "graph_pool_bytes" in published:
        from . import mem as mem_mod

        mem_mod.on_compile_captured(segment, published,
                                    first=stats.get("first_in_pool"))
    return published or None


def retire_compile_stats(segments):
    """Drop the per-segment gauge children of retired segment labels
    (the executor's program-cache eviction)."""
    reg = registry_mod.get_registry()
    for gauge, _key, help_text in _COMPILE_GAUGES:
        fam = reg.gauge(gauge, help_text, labelnames=("segment",))
        for segment in segments:
            fam.remove(segment=segment)
