"""Device mesh construction over the process group's ranks.

Counterpart of paddle_tpu/parallel/mesh.py.  There a `jax.sharding.Mesh`
with named axes lays the program over devices; here a
`torch.distributed.device_mesh.DeviceMesh` with the same axis names lays
it over the ranks of the process group, one CUDA device per rank
(NCCL), or, when the caller asks for the CPU (`device="cpu"`, as the
tests do), CPU ranks over gloo.  Where the JAX package counts devices,
this module counts ranks: a mesh of more ranks than the world has
raises, naming the world size.

`MeshConfig` and `parse_mesh_spec` are the JAX module's, pure Python.
`mesh_layout` is `make_mesh`'s axis arithmetic (names, order, size-1
rules, the custom-name rule and every error), apart from the ranks, so
it can be checked against the JAX function at any size without a
process group.

A world of one rank needs no launcher: `make_mesh` starts a single-rank
group itself when none is up, meeting at a `file://` store in a fresh
temporary directory (never a fixed TCP port).

`mesh_scope(mesh)` is the ambient mesh (`with mesh:` on the JAX side),
which `ParallelTrainer.step` enters and the `flash_attention` op reads
(`ambient_mesh()`) to find the sequence-parallel axis.
"""

import contextlib
import os
import tempfile
import threading
from collections import OrderedDict

import numpy as np
import torch

__all__ = ["make_mesh", "MeshConfig", "parse_mesh_spec", "mesh_layout",
           "mesh_shape", "mesh_scope", "ambient_mesh", "ensure_world",
           "backend_for"]

# the canonical axis vocabulary: dp data, mp model/tensor, sp sequence,
# pp pipeline, ep expert
AXIS_NAMES = ("dp", "mp", "sp", "pp", "ep")


class MeshConfig:
    """Axis layout for a training job.

    dp: data parallel (batch) — the gradient all-reduce rides this axis.
    mp: model/tensor parallel — weight shards; matmul partials reduce
    here.  sp/pp/ep: sequence / pipeline / expert parallelism over the
    same ranks.

    A MeshConfig is a static mesh description: `.shape` gives the same
    axis-name -> size mapping `mesh_shape` gives for a built DeviceMesh,
    so the spec helpers in `sharding.py` accept either one.
    """

    def __init__(self, dp=None, mp=1, sp=1, pp=1, ep=1, axes=None):
        self.dp = dp
        self.mp = mp
        self.sp = sp
        self.pp = pp
        self.ep = ep
        sizes = {"dp": dp, "mp": mp, "sp": sp, "pp": pp, "ep": ep}
        if axes is None:
            axes = ("dp", "mp") if (sp == pp == ep == 1) else tuple(
                a for a in AXIS_NAMES
                if a == "dp" or (sizes[a] or 1) > 1)
        self.axes = tuple(axes)

    @property
    def shape(self):
        """axis name -> size, in axis order (a dp of None means
        'whatever ranks remain' and reads as size 1 here)."""
        sizes = {"dp": self.dp, "mp": self.mp, "sp": self.sp,
                 "pp": self.pp, "ep": self.ep}
        return OrderedDict(
            (a, int(sizes.get(a) or 1)) for a in self.axes)

    def validate(self, n_devices):
        """Check the axis product against a rank count; raises a
        ValueError naming the axes."""
        shape = self.shape
        product = int(np.prod(list(shape.values()))) if shape else 1
        if self.dp is None:
            denom = int(np.prod(
                [s for a, s in shape.items() if a != "dp"]))
            if denom == 0 or n_devices % denom:
                raise ValueError(
                    "%d device(s) not divisible by the non-dp axis "
                    "product %s = %d" % (n_devices, _axis_product_str(
                        {a: s for a, s in shape.items() if a != "dp"}),
                        denom))
        elif product != n_devices:
            raise ValueError(
                "mesh axis product %s = %d != %d device(s); resize an "
                "axis or the device set" % (_axis_product_str(shape),
                                            product, n_devices))
        return self

    @classmethod
    def parse(cls, spec):
        """Parse "dp=4,mp=2"-style mesh specs into a MeshConfig with
        that exact axis order."""
        return parse_mesh_spec(spec)

    def __repr__(self):
        return "MeshConfig(%s)" % ",".join(
            "%s=%d" % (a, s) for a, s in self.shape.items())


def _axis_product_str(shape):
    return " * ".join("%s=%s" % (a, s) for a, s in shape.items()) \
        or "(no axes)"


def parse_mesh_spec(spec):
    """"dp=4,mp=2" -> MeshConfig(dp=4, mp=2, axes=("dp", "mp"))."""
    if isinstance(spec, MeshConfig):
        return spec
    sizes, axes = {}, []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                "bad mesh spec %r: expected comma-separated axis=size "
                "pairs like 'dp=4,mp=2'" % (spec,))
        name, _, val = part.partition("=")
        name = name.strip()
        if name not in AXIS_NAMES:
            raise ValueError(
                "bad mesh spec %r: unknown axis %r (axes are %s)"
                % (spec, name, "/".join(AXIS_NAMES)))
        try:
            size = int(val)
        except ValueError:
            raise ValueError("bad mesh spec %r: size of axis %r is not "
                             "an integer" % (spec, name))
        if size < 1:
            raise ValueError("bad mesh spec %r: axis %r must be >= 1"
                             % (spec, name))
        if name in sizes:
            raise ValueError("bad mesh spec %r: axis %r named twice"
                             % (spec, name))
        sizes[name] = size
        axes.append(name)
    if not axes:
        raise ValueError("bad mesh spec %r: no axes" % (spec,))
    return MeshConfig(axes=tuple(axes), **sizes)


def mesh_shape(mesh):
    """axis name -> size of a DeviceMesh, a MeshConfig or any mapping,
    in axis order (the JAX Mesh's `.shape`)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return OrderedDict(zip(names, (int(s) for s in mesh.shape)))
    return OrderedDict(getattr(mesh, "shape", mesh))


def mesh_layout(n_devices, dp=None, mp=1, sp=1, pp=1, ep=1, axes=None,
                drop_unit_axes=False):
    """(axis names, {name: size}) of `make_mesh` over `n_devices` ranks:
    the JAX function's arithmetic and errors, apart from the ranks."""
    sizes = {"dp": dp, "mp": mp, "sp": sp, "pp": pp, "ep": ep}
    if axes is None:
        axes = ("dp", "mp") if (sp == pp == ep == 1) else tuple(
            a for a in ("dp", "mp", "sp", "pp", "ep")
            if a == "dp" or sizes[a] > 1)
    if any(a not in sizes for a in axes):
        # custom axis names with (dp, mp) semantics, e.g.
        # axes=("data", "model"): sizes map positionally
        if len(axes) != 2:
            raise ValueError("custom axis names are only supported for "
                             "two-axis (dp, mp)-shaped meshes; got %r"
                             % (axes,))
        if sp != 1 or pp != 1 or ep != 1:
            raise ValueError("sp/pp/ep cannot combine with custom axis "
                             "names %r" % (axes,))
        sizes = {axes[0]: dp, axes[1]: mp}
        dp_name = axes[0]
    else:
        dp_name = "dp"
        dropped = [a for a, s in sizes.items()
                   if a not in axes and s not in (None, 1)]
        if dropped:
            raise ValueError(
                "axis size(s) %s requested but axes=%r omits them — an "
                "explicit axes tuple must name every non-unit axis"
                % ({a: sizes[a] for a in dropped}, tuple(axes)))
    denom = int(np.prod([sizes[a] for a in axes if a != dp_name]))
    if dp is None:
        if n_devices % denom != 0:
            raise ValueError(
                "%d device(s) not divisible by the non-%s axis product "
                "%s = %d; resize an axis or pass %s explicitly"
                % (n_devices, dp_name,
                   _axis_product_str({a: sizes[a] for a in axes
                                      if a != dp_name}), denom, dp_name))
        dp = n_devices // denom
    if dp * denom != n_devices:
        raise ValueError(
            "mesh axis product %s = %d != %d device(s); resize an axis "
            "or the device set"
            % (_axis_product_str(
                {a: (dp if a == dp_name else sizes[a]) for a in axes}),
               dp * denom, n_devices))
    sizes[dp_name] = dp
    if drop_unit_axes:
        # "dp" always survives: batch_spec / trainer / moe default to a
        # dp axis existing, and a dp=1 axis costs nothing
        axes = tuple(a for a in axes if sizes[a] > 1 or a == dp_name)
    return tuple(axes), {a: sizes[a] for a in axes}


def backend_for(device):
    """The process group's backend for ranks on `device`: NCCL for
    "cuda", gloo for "cpu".  "cuda" without a CUDA device raises; there
    is no fallback to the CPU."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA mesh needs a CUDA device and there is none; pass "
                "device='cpu' to run the ranks on the CPU over gloo")
        return "nccl"
    if device == "cpu":
        return "gloo"
    raise ValueError("mesh device must be 'cuda' or 'cpu', got %r"
                     % (device,))


def ensure_world(device="cuda"):
    """The process group, started as a world of one rank (over a
    `file://` store in a fresh temporary directory) when none is up;
    returns the world size.  A group that is up must have the backend
    `device` needs."""
    dist = torch.distributed
    backend = backend_for(device)
    if not dist.is_initialized():
        store = os.path.join(tempfile.mkdtemp(prefix="paddle_mesh_"),
                             "store")
        if device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method="file://" + store,
                                rank=0, world_size=1)
    elif device == "cuda" and dist.get_backend() != "nccl":
        raise RuntimeError("a CUDA mesh needs the nccl backend; the "
                           "process group runs %s" % dist.get_backend())
    return dist.get_world_size()


def make_mesh(n_devices=None, dp=None, mp=1, sp=1, pp=1, ep=1,
              axes=None, devices=None, drop_unit_axes=False,
              device="cuda"):
    """Build a DeviceMesh over the five parallelism axes.

    dp defaults to n_devices // (mp*sp*pp*ep).  With mp=1 this is pure
    data parallelism; mp>1 shards weights, sp shards sequences
    (ring/Ulysses attention), pp pipelines stages, ep shards experts.
    By default the mesh keeps the ("dp", "mp") axes even at size 1;
    extended axes appear when requested, and drop_unit_axes=True trims
    every size-1 axis ("dp" always remains).

    The mesh lies over the ranks of the process group (`devices`: the
    global ranks to use, default all of them; n_devices the count, by
    default the world size), one CUDA device per rank over NCCL
    (`device="cuda"`), or CPU ranks over gloo (`device="cpu"`).  Without
    a process group it starts a world of one rank.
    """
    world = ensure_world(device)
    if devices is None:
        devices = list(range(world))
    devices = [int(r) for r in devices]
    if n_devices is not None and len(devices) < n_devices:
        raise ValueError(
            "requested a %d-device mesh but the process group's world "
            "has %d rank(s); start %d ranks (one per device) or pass a "
            "smaller n_devices" % (n_devices, len(devices), n_devices))
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if any(r >= world or r < 0 for r in devices):
        raise ValueError("mesh ranks %s lie outside the world of %d"
                         % (devices, world))
    names, sizes = mesh_layout(n_devices, dp, mp, sp, pp, ep, axes,
                               drop_unit_axes)
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.tensor(devices, dtype=torch.int64).reshape(
        [sizes[a] for a in names])
    if device == "cuda":
        torch.cuda.set_device(torch.distributed.get_rank()
                              % torch.cuda.device_count())
    return DeviceMesh(device, ranks, mesh_dim_names=names)


_ambient = threading.local()


@contextlib.contextmanager
def mesh_scope(mesh):
    """Make `mesh` the ambient mesh while the block runs (the JAX
    side's `with mesh:`)."""
    stack = getattr(_ambient, "stack", None)
    if stack is None:
        stack = _ambient.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def ambient_mesh():
    """The mesh of the innermost `mesh_scope`, or None."""
    stack = getattr(_ambient, "stack", None)
    return stack[-1] if stack else None
