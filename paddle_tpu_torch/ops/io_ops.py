"""The host IO ops: `feed`, `fetch`, `save`, `load` and `print`.

Counterpart of paddle_tpu/ops/io_ops.py (reference: feed_op.cc,
fetch_op.cc, save_op.cc, load_op.cc, print_op.cc).  These are the ops a
program carries when it moves its own data: `feed` reads column `col`
of the scope's "feed" list, `fetch` writes its input into column `col`
of the scope's "fetch" list; `save` writes one `.npz` file per var in
the JAX op's layout (`__ragged__`, `values`, and for a ragged value
`nvalid` and one `rs<i>` per level of splits), so a file written by
either package's `save` op is read by the other's `load` op; `load`
puts the file's value on the executor's device.  The executor's own
feeds and fetches do not go through them (fluid/executor.py).  `print`
reads its input back to the host to print it (a sync on the card, as
the JAX op runs on the host), in the JAX op's format: the message, then
the name, shape, dtype and data fields its attrs ask for, `summarize`
cutting the data to its first values.  The grad passes the output's
grad through unprinted.
"""

import os

import numpy as np
import torch

from ..core.ragged import RaggedTensor
from ..core.types import tensor_from_numpy
from .registry import (keep_declared, register_grad_kernel, register_op,
                       values_of)


@register_op("feed", jittable=False, stop_gradient_op=True,
             infer_desc=keep_declared)
def feed(ctx, ins, attrs):
    """Column `col` of the scope's "feed" list."""
    feed_list = ctx.scope.get("feed") or []
    return {"Out": [feed_list[int(attrs.get("col", 0))]]}


@register_op("fetch", jittable=False, stop_gradient_op=True,
             infer_desc=keep_declared)
def fetch(ctx, ins, attrs):
    """X into column `col` of the scope's "fetch" list (grown with None
    as needed)."""
    col = int(attrs.get("col", 0))
    fetch_list = ctx.scope.get("fetch") or []
    while len(fetch_list) <= col:
        fetch_list.append(None)
    fetch_list[col] = ins["X"][0]
    ctx.scope.set("fetch", fetch_list)
    return {}


def _numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


@register_op("save", jittable=False, stop_gradient_op=True,
             infer_desc=keep_declared)
def save(ctx, ins, attrs):
    """X to `file_path` (np.savez, which adds `.npz`), its directory
    made; an existing file raises unless `overwrite` (default True)."""
    path = attrs["file_path"]
    if os.path.exists(path) and not attrs.get("overwrite", True):
        raise RuntimeError("%r exists and overwrite=False" % path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    x = ins["X"][0]
    if isinstance(x, RaggedTensor):
        np.savez(path, __ragged__=1, values=_numpy(x.values),
                 nvalid=_numpy(x.nvalid),
                 **{"rs%d" % i: _numpy(rs)
                    for i, rs in enumerate(x.row_splits)})
    else:
        np.savez(path, __ragged__=0, values=_numpy(x))
    return {}


@register_op("load", jittable=False, stop_gradient_op=True,
             infer_desc=keep_declared)
def load(ctx, ins, attrs):
    """The value `save` wrote to `file_path` (or `file_path`.npz), on
    the executor's device; int64 ids narrowed to int32 as a feed is."""
    path = attrs["file_path"]
    real = path if os.path.exists(path) else path + ".npz"
    device = ctx.device if ctx.device is not None else "cpu"
    with np.load(real) as data:
        values = tensor_from_numpy(data["values"], device)
        if int(data["__ragged__"]) == 1:
            splits, i = [], 0
            while "rs%d" % i in data:
                splits.append(torch.from_numpy(data["rs%d" % i]).to(device))
                i += 1
            out = RaggedTensor(values, splits, nvalid=int(data["nvalid"]))
        else:
            out = values
    return {"Out": [out]}


@register_op("print", jittable=False)
def print_op(ctx, ins, attrs):
    x = ins["In"][0] if "In" in ins else ins["X"][0]
    v = values_of(x).detach()
    arr = (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
    parts = [attrs.get("message", "")]
    if attrs.get("print_tensor_name", True):
        parts.append("var")
    if attrs.get("print_tensor_shape", True):
        parts.append("shape=%s" % (arr.shape,))
    if attrs.get("print_tensor_dtype", True):
        parts.append("dtype=%s" % arr.dtype)
    flat = arr.reshape(-1)
    summarize = int(attrs.get("summarize", -1))
    if summarize > 0:
        flat = flat[:summarize]
    parts.append("data=%s" % (flat,))
    print(" ".join(str(p) for p in parts))
    return {"Out": [x]}


@register_grad_kernel("print")
def print_grad(ctx, ins, attrs):
    slot = "In" if "In" in ins else "X"
    return {slot + "@GRAD": [ins["OG@Out"][0]]}
