"""Sharding specs for program state and feeds, and the per-rank map.

Counterpart of paddle_tpu/parallel/sharding.py.  A spec has the JAX
`PartitionSpec`'s shape: a tuple with one mesh axis name (or a tuple of
names, or None) per tensor dimension.  `placements(mesh, spec)` turns
it into DTensor placements, one per mesh dimension: `Shard(d)` where
dimension d names the axis, else `Replicate()`.  The rules that pick a
spec (`param_spec`, `batch_spec`, `zero1_spec` and their reasons) are
the JAX module's word for word, reasons' text included.

`shard_map_norep` is the counterpart of the JAX helper of that name: it
runs a per-rank function on the local shards of its arguments, each laid
out by its spec, and gives back DTensors laid out by the output specs.
An argument may be a DTensor on the mesh or a plain tensor, which is
taken as the same full value on every rank.  Gradients follow JAX's
shard_map transpose: an output's cotangent is divided by the size of
the axes its spec leaves out, and an input's cotangent is summed over
the axes its spec leaves out.  The collectives the function may call
(`collectives.py`) find the mesh's axes through the map.
"""

import contextlib
import re as _re
import threading

import torch

from .mesh import mesh_shape

__all__ = ["P", "PartitionSpec", "NamedSharding", "placements",
           "param_spec", "param_spec_reason", "batch_spec", "replicated",
           "shard_state", "shard_feeds", "zero1_spec",
           "zero1_spec_reason", "optimizer_state_names",
           "is_optimizer_state", "shard_map_norep", "distribute",
           "to_full", "replicating"]


class PartitionSpec(tuple):
    """One entry per tensor dimension: a mesh axis name, a tuple of
    names (the dimension splits over all of them, the first major), or
    None (whole).  Trailing dimensions left out are whole."""

    def __new__(cls, *entries):
        return tuple.__new__(cls, entries)

    def __getnewargs__(self):  # pickles as P(*entries)
        return tuple(self)

    def __repr__(self):
        return "P(%s)" % ", ".join(repr(e) for e in self)


P = PartitionSpec


def placements(mesh, spec):
    """DTensor placements (one per mesh dimension) of `spec`."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    seen = {}
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        order = [names.index(a) if a in names else -1 for a in group]
        if -1 in order:
            raise ValueError("spec %r names axis %r, which mesh %s lacks"
                             % (spec, group[order.index(-1)], names))
        if order != sorted(order):
            raise NotImplementedError(
                "spec %r splits a dimension over axes %r out of the "
                "mesh's axis order %s" % (spec, group, names))
        for i in order:
            if i in seen:
                raise ValueError("spec %r uses axis %r twice"
                                 % (spec, names[i]))
            seen[i] = dim
            out[i] = Shard(dim)
    return out


class NamedSharding:
    """A spec over a mesh (the JAX class of that name): `.placements`
    are the DTensor placements it gives."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    @property
    def placements(self):
        return placements(self.mesh, self.spec)

    def __repr__(self):
        return "NamedSharding(%s, %r)" % (
            dict(mesh_shape(self.mesh)), self.spec)


def replicated(mesh):
    return NamedSharding(mesh, P())


def param_spec_reason(name, shape, mesh, mp_axis="mp", min_shard_dim=512):
    """(spec, reason) for a parameter under the default tensor-parallel
    layout.  `reason` is None when the spec shards (or replication is
    deliberate policy: no mp axis, or a non-2-D tensor the conv policy
    replicates on purpose); otherwise it is a sentence explaining what
    FORCED replication (min_shard_dim or divisibility) — the sharding
    analyzer's S001 cites it instead of letting the fallback stay
    silent."""
    axes = mesh_shape(mesh)
    if mp_axis not in axes:
        return P(), None
    mp = axes[mp_axis]
    if mp == 1:
        return P(), None
    if len(shape) != 2:
        return P(), None  # conv filters / biases / stats: policy
    rows, cols = int(shape[0]), int(shape[1])
    # embedding / big row-major tables: shard rows
    if rows >= min_shard_dim * mp and rows % mp == 0 and rows >= cols:
        return P(mp_axis, None), None
    if cols % mp == 0 and cols >= min_shard_dim:
        return P(None, mp_axis), None
    if rows % mp == 0 and rows >= min_shard_dim:
        return P(mp_axis, None), None
    if max(rows, cols) < min_shard_dim:
        reason = ("both dims of (%d, %d) are below min_shard_dim %d"
                  % (rows, cols, min_shard_dim))
    elif cols >= min_shard_dim and cols % mp:
        reason = ("cols %d not divisible by %s=%d (rows %d %s)"
                  % (cols, mp_axis, mp,
                     rows, "not divisible either" if rows % mp
                     else "below min_shard_dim %d" % min_shard_dim))
    else:
        reason = ("rows %d not divisible by %s=%d and cols %d below "
                  "min_shard_dim %d" % (rows, mp_axis, mp, cols,
                                        min_shard_dim))
    return P(), reason


def param_spec(name, shape, mesh, mp_axis="mp", min_shard_dim=512):
    """Default tensor-parallel layout for a parameter.

    Large 2-D weights (fc/projection) shard their output dim over mp;
    large embedding tables shard the vocab dim over mp; everything else
    (conv filters, biases, BN stats) is replicated.  See
    `param_spec_reason` for the variant that also says WHY a tensor
    fell back to replication."""
    spec, _reason = param_spec_reason(name, shape, mesh, mp_axis=mp_axis,
                                      min_shard_dim=min_shard_dim)
    return spec


def batch_spec(shape, mesh, dp_axis="dp"):
    """Feeds shard their leading (batch) dim over dp."""
    if dp_axis not in mesh_shape(mesh) or len(shape) == 0:
        return P()
    return P(dp_axis)


def shard_state(state, mesh, var_shapes=None, mp_axis="mp"):
    """Return {name: NamedSharding} for a state dict (tensors, or names
    with `var_shapes`)."""
    specs = {}
    for name, v in state.items():
        shape = v.shape if hasattr(v, "shape") else var_shapes[name]
        specs[name] = NamedSharding(mesh, param_spec(name, shape, mesh,
                                                     mp_axis=mp_axis))
    return specs


def shard_feeds(feeds, mesh, dp_axis="dp"):
    specs = {}
    for name, v in feeds.items():
        specs[name] = NamedSharding(mesh, batch_spec(v.shape, mesh,
                                                     dp_axis=dp_axis))
    return specs


# optimizer accumulator vars are named {param}_{acc}_{N} by
# fluid/optimizer.py _add_accumulator; these are the acc strings of the
# 11 optimizers
_ACC_NAME = _re.compile(
    r"_(velocity|moment[12]?|inf_norm|avg_squared_grad|"
    r"avg_squared_update|mean_square|squared|linear)_\d+$")

_OPTIMIZER_OPS = frozenset([
    "sgd", "momentum", "adam", "adamax", "adagrad", "decayed_adagrad",
    "adadelta", "rmsprop", "ftrl", "proximal_gd", "proximal_adagrad",
    # stacked same-recipe updates (fluid/fusion.py) — same slot layout,
    # so the Param/Grad/LearningRate exclusion below applies unchanged
    "fused_update"])

# optimizer-op input slots that are NOT accumulator state
_NON_STATE_SLOTS = frozenset(["Param", "Grad", "LearningRate"])


def _blocks(program):
    """The BlockDescs of a Program or ProgramDesc."""
    return getattr(program, "desc", program).blocks


def optimizer_state_names(program):
    """The exact accumulator var names of a built program: every input
    to an optimizer op except Param/Grad/LearningRate.  Exact where the
    name-suffix regex is a guess (a user var named '*_squared_3' would
    fool the regex but can never appear in an optimizer slot)."""
    names = set()
    for block in _blocks(program):
        for op in block.ops:
            if op.type not in _OPTIMIZER_OPS:
                continue
            for slot, vars_ in op.inputs.items():
                if slot not in _NON_STATE_SLOTS:
                    names.update(vars_)
    return names


def is_optimizer_state(name, known=None):
    """`known` (from optimizer_state_names) is authoritative; the name
    regex is the fallback for detached state dicts with no program."""
    if known is not None:
        return name in known
    return bool(_ACC_NAME.search(name))


def zero1_spec_reason(base_spec, shape, mesh, dp_axis="dp"):
    """(spec, reason) for the ZeRO-1 layout of an optimizer-state
    tensor.  `reason` is None when a dim sharded (or there is no dp
    axis to shard over); otherwise it says why every dim stayed whole —
    the S001 citation for optimizer state that silently keeps dp full
    copies."""
    axes = mesh_shape(mesh)
    if dp_axis not in axes or axes[dp_axis] == 1:
        return base_spec, None
    dp = axes[dp_axis]
    dims = list(base_spec) + [None] * (len(shape) - len(base_spec))
    for i, (d, s) in enumerate(zip(dims, shape)):
        if d is None and int(s) % dp == 0 and int(s) >= dp:
            dims[i] = dp_axis
            return P(*dims), None
    if not shape:
        reason = "scalar state cannot shard over %s=%d" % (dp_axis, dp)
    else:
        reason = ("no free dim of %s divides %s=%d (zero-1 keeps %d "
                  "full copies)" % (tuple(int(s) for s in shape),
                                    dp_axis, dp, dp))
    return base_spec, reason


def zero1_spec(base_spec, shape, mesh, dp_axis="dp"):
    """ZeRO-1: shard an optimizer-state tensor over the dp axis on its
    first free, divisible dim (on top of any mp sharding the matching
    parameter has).  The update then reads the gradient reduce-scattered
    into the accumulator's shard, and the parameter is gathered back to
    its own layout: all-reduce bandwidth, 1/dp optimizer-state memory.
    See `zero1_spec_reason` for the variant that reports why a tensor
    could not shard."""
    spec, _reason = zero1_spec_reason(base_spec, shape, mesh,
                                      dp_axis=dp_axis)
    return spec


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


_replicating = threading.local()


@contextlib.contextmanager
def replicating():
    """While the block runs, an op mixing DTensors with plain tensors
    takes each plain tensor as the same full value on every rank
    (DTensor's `implicit_replication`, entered once however deeply this
    nests: that context's exit turns it off for the enclosing ones)."""
    if getattr(_replicating, "on", False):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _replicating.on = True
    try:
        with implicit_replication():
            yield
    finally:
        _replicating.on = False


def distribute(t, mesh, spec_or_placements, src_data_rank=0):
    """`t` as a DTensor on `mesh` laid out by a spec (or placements).
    A DTensor is redistributed.  A plain tensor is the full value: rank
    `src_data_rank`'s copy is scattered (a new leaf, for state and
    feeds), or with `src_data_rank=None` every rank takes its shard of
    its own copy, with no communication and differentiably (for values
    every rank holds alike)."""
    from torch.distributed.tensor import distribute_tensor

    pl = placements(mesh, spec_or_placements) \
        if isinstance(spec_or_placements, PartitionSpec) \
        else list(spec_or_placements)
    if isinstance(t, _dtensor()) or src_data_rank is None:
        return _lift(t, mesh).redistribute(mesh, pl)
    return distribute_tensor(t, mesh, pl, src_data_rank=src_data_rank)


def to_full(t):
    """The full value of a DTensor as a plain tensor; anything else as
    it is."""
    return t.full_tensor() if isinstance(t, _dtensor()) else t


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the cotangent times `scale` backward."""

    @staticmethod
    def forward(x, scale):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.scale = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _lift(t, mesh):
    """A DTensor on `mesh`: `t` itself, or a plain tensor taken as the
    same full value on every rank (Replicate; no communication)."""
    from torch.distributed.tensor import Replicate

    if isinstance(t, _dtensor()):
        if t.device_mesh != mesh:
            raise ValueError("a DTensor argument lies on another mesh")
        return t
    return _dtensor().from_local(t, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)


def _leaves(tree, spec):
    """[(path, tensor, spec)] of a tensor, or a dict of them whose spec
    is one spec for all or a dict of specs."""
    if isinstance(tree, dict):
        return [(k,) + rest
                for k in sorted(tree)
                for rest in _leaves(tree[k], spec[k] if isinstance(
                    spec, dict) else spec)]
    return [(tree, spec)]


def _rebuild(tree, values):
    it = iter(values)

    def go(t):
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        return next(it)

    return go(tree)


def shard_map_norep(fn, mesh, in_specs, out_specs):
    """fn(*local args) -> local outputs, run on every rank of `mesh` on
    the local shards of its arguments; returns a function of the global
    arguments (DTensors on `mesh`, or plain tensors holding the same
    full value on every rank; dicts of them for a dict spec) that
    returns DTensors laid out by `out_specs` (a spec, or a tuple of
    specs for a tuple of outputs).  Inside fn, `collectives.py` reaches
    the mesh's axes by name."""
    from torch.distributed.tensor import Partial, Shard

    from . import collectives

    names = mesh.mesh_dim_names
    sizes = mesh_shape(mesh)

    def grad_placements(spec):
        pl = placements(mesh, spec)
        return [p if isinstance(p, Shard) else Partial() for p in pl]

    def left_out(spec):
        used = set()
        for entry in spec:
            if entry is not None:
                used.update(entry if isinstance(entry, tuple) else (entry,))
        n = 1
        for a in names:
            if a not in used:
                n *= sizes[a]
        return n

    def wrapped(*args):
        if len(args) != len(in_specs):
            raise TypeError("shard_map: %d arguments for %d specs"
                            % (len(args), len(in_specs)))
        local_args = []
        for arg, spec in zip(args, in_specs):
            leaves = _leaves(arg, spec)
            locs = []
            for leaf in leaves:
                t, sp = leaf[-2], leaf[-1]
                if not isinstance(t, torch.Tensor):
                    locs.append(t)
                    continue
                dt = _lift(t, mesh).redistribute(mesh, placements(mesh, sp))
                locs.append(dt.to_local(grad_placements=grad_placements(sp)))
            local_args.append(_rebuild(arg, locs))
        with collectives.axis_env(mesh):
            out = fn(*local_args)
        single = not isinstance(out_specs, tuple) \
            or isinstance(out_specs, PartitionSpec)
        outs = (out,) if single else tuple(out)
        specs = (out_specs,) if single else out_specs
        results = []
        for o, sp in zip(outs, specs):
            n = left_out(sp)
            if n > 1 and o.requires_grad:
                o = _ScaleGrad.apply(o, 1.0 / n)
            results.append(_dtensor().from_local(
                o, mesh, placements(mesh, sp), run_check=False))
        return results[0] if single else tuple(results)

    return wrapped
