"""Per-rank collectives over a mesh axis, with JAX's transpose rules as
their gradients.

The JAX package's shard_map code calls `lax.ppermute`, `lax.all_to_all`,
`lax.psum`, `lax.pmean`, `lax.axis_index` and `lax.psum(1, axis)` by
axis name.  Here a function run by `sharding.shard_map_norep` calls the
functions below by the same names: `axis_env` (which the map enters)
holds the mesh, and an axis name resolves to that mesh dimension's
process group (NCCL on the card, gloo on the CPU).

Each collective is a torch.autograd.Function in the form torch.func
transforms (`forward` without ctx, `setup_context`), with the gradient
JAX's transpose rule gives: ppermute's is the inverse permutation,
all_to_all's the all_to_all with split and concat axes swapped, psum's
a psum of the cotangents (shard_map divides an output's cotangent by
the axes its spec leaves out, `sharding.py`, which makes the pair
right), pmean's that over the axes' size.  On an axis of size 1 each is
the identity and communicates nothing.
"""

import contextlib
import threading

import torch
import torch.distributed as dist

__all__ = ["axis_env", "axis_size", "axis_index", "ppermute",
           "all_to_all", "psum", "pmean"]

_env = threading.local()


@contextlib.contextmanager
def axis_env(mesh):
    """Resolve axis names against `mesh` while the block runs."""
    stack = getattr(_env, "stack", None)
    if stack is None:
        stack = _env.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def _mesh():
    stack = getattr(_env, "stack", None)
    if not stack:
        raise RuntimeError("a collective over a named axis runs only "
                           "inside shard_map_norep")
    return stack[-1]


def _names(axis_name):
    return axis_name if isinstance(axis_name, tuple) else (axis_name,)


def axis_size(axis_name):
    """The size of a mesh axis (or the product over a tuple of axes):
    `lax.psum(1, axis_name)`."""
    mesh = _mesh()
    n = 1
    for a in _names(axis_name):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def axis_index(axis_name):
    """This rank's index along a mesh axis: `lax.axis_index`."""
    return _mesh().get_local_rank(axis_name)


def _group(axis_name):
    return _mesh().get_group(axis_name)


def _permute(x, group, perm):
    """Send x to dst and receive from src for this rank's pairs of
    `perm` ((src, dst) indices along the group); zeros where nothing
    arrives."""
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, group=group,
                                  group_peer=dst))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, group=group,
                                  group_peer=src))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):

    @staticmethod
    def forward(x, group, perm):
        return _permute(x, group, perm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]
        ctx.perm = inputs[2]

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _PPermute.apply(g, ctx.group, inverse), None, None


def ppermute(x, axis_name, perm):
    """`lax.ppermute`: along `axis_name`, index src's x goes to index
    dst for each (src, dst) of `perm`; an index nothing is sent to gets
    zeros."""
    perm = [(int(s), int(d)) for s, d in perm]
    if axis_size(axis_name) == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, _group(axis_name), perm)


def _all_to_all(x, group, split_axis, concat_axis, tiled):
    n = dist.get_world_size(group)
    if tiled:
        if x.shape[split_axis] % n:
            raise ValueError("all_to_all: axis %d of size %d does not "
                             "split %d ways" % (split_axis,
                                                x.shape[split_axis], n))
        parts = x.unflatten(split_axis, (n, x.shape[split_axis] // n))
        send = parts.movedim(split_axis, 0).contiguous()
    else:
        if x.shape[split_axis] != n:
            raise ValueError("all_to_all: axis %d has size %d, the axis "
                             "size is %d" % (split_axis,
                                             x.shape[split_axis], n))
        send = x.movedim(split_axis, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[j] is the part index j sent: stack (untiled) or concatenate
    # (tiled) those along concat_axis
    if not tiled:
        return recv.movedim(0, concat_axis)
    rest = list(recv.shape[1:])
    out = recv.movedim(0, concat_axis)
    rest[concat_axis] *= n
    return out.reshape(rest)


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(x, group, split_axis, concat_axis, tiled):
        return _all_to_all(x, group, split_axis, concat_axis, tiled)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis, tiled = ctx.args
        return (_AllToAll.apply(g, group, concat_axis, split_axis, tiled),
                None, None, None, None)


def all_to_all(x, axis_name, split_axis, concat_axis, tiled=False):
    """`lax.all_to_all`: x splits along `split_axis` into one part per
    index of the axis (with `tiled`, into equal slices; without, the
    axis must have the axis's size and its entries are the parts), part
    j goes to index j, and the parts received are stacked (untiled) or
    concatenated (tiled) along `concat_axis` in index order."""
    if axis_size(axis_name) == 1:
        return x if tiled else x.movedim(split_axis, concat_axis)
    return _AllToAll.apply(x, _group(axis_name), split_axis, concat_axis,
                           tiled)


def _all_reduce(x, groups):
    out = x.clone()
    for group in groups:
        dist.all_reduce(out, group=group)
    return out


class _PSum(torch.autograd.Function):

    @staticmethod
    def forward(x, groups):
        return _all_reduce(x, groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.groups = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _PSum.apply(g, ctx.groups), None


def psum(x, axis_name):
    """`lax.psum` over an axis or a tuple of axes."""
    groups = tuple(_group(a) for a in _names(axis_name)
                   if axis_size(a) > 1)
    if not groups:
        return x
    return _PSum.apply(x, groups)


def pmean(x, axis_name):
    """`lax.pmean` over an axis or a tuple of axes."""
    return psum(x, axis_name) / axis_size(axis_name)
