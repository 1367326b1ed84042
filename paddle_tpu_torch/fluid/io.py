"""Inference export and load, in the JAX package's format.

Counterpart of paddle_tpu/fluid/io.py save_inference_model /
load_inference_model.  An export directory holds `__model__`, a JSON
object {program, feed_names, fetch_names, feed_meta[, bucket_hints]},
and one `<name>.npz` per persistable, `np.savez(__ragged__=0,
values=...)`.  Either package loads what the other wrote.  Parameters
cross between the two as numpy arrays (`params_from_numpy`).  Program
pruning and the structural verifier stay on the JAX side for now.
"""

import json
import os

import numpy as np
import torch

from ..core.desc import ProgramDesc
from ..core.scope import global_scope
from ..core.types import np_dtype, tensor_from_numpy

__all__ = ["params_from_numpy", "save_inference_model",
           "load_inference_model"]


def _var_path(dirname, name):
    return os.path.join(dirname, name.replace("/", "_"))


def params_from_numpy(scope, arrays, device):
    """Set each {name: ndarray} in `scope` as a tensor on `device`,
    64-bit types narrowed to what they execute as."""
    device = torch.device(device)
    for name, arr in arrays.items():
        scope.set(name, tensor_from_numpy(arr, device))


def _persistables(desc):
    return [v for b in desc.blocks for v in b.vars.values()
            if v.persistable]


def _feed_meta(desc, feed_names):
    block = desc.block(0)
    meta = {}
    for name in feed_names:
        var = block.var(name)
        meta[name] = {"shape": list(var.shape),
                      "dtype": (np_dtype(var.dtype).name
                                if var.dtype is not None else None),
                      "lod_level": var.lod_level}
    return meta


def save_inference_model(dirname, feed_names, fetch_names, scope, program,
                         bucket_hints=None, model_filename="__model__"):
    """Write `program` (a ProgramDesc, already pruned to the fetches) and
    the values of its persistables in `scope`."""
    if isinstance(feed_names, str):
        feed_names = [feed_names]
    if isinstance(fetch_names, str):
        fetch_names = [fetch_names]
    os.makedirs(dirname, exist_ok=True)
    meta = {
        "program": program.to_dict(),
        "feed_names": list(feed_names),
        "fetch_names": list(fetch_names),
        "feed_meta": _feed_meta(program, feed_names),
    }
    if bucket_hints is not None:
        meta["bucket_hints"] = dict(bucket_hints)
    with open(os.path.join(dirname, model_filename), "w") as f:
        json.dump(meta, f)
    for var in _persistables(program):
        val = scope.get(var.name)
        if val is None:
            continue
        if isinstance(val, torch.Tensor):
            if val.dtype == torch.bfloat16:
                raise TypeError("save_inference_model: %r is bfloat16, "
                                "which numpy cannot hold" % var.name)
            val = val.detach().cpu().numpy()
        np.savez(_var_path(dirname, var.name), __ragged__=0,
                 values=np.asarray(val))


def _load_one(dirname, name):
    path = _var_path(dirname, name) + ".npz"
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        if int(data["__ragged__"]) != 0:
            raise NotImplementedError(
                "%s holds a ragged (LoD) value; ragged persistables are "
                "not ported yet" % path)
        return data["values"].copy()


def load_inference_model(dirname, executor, model_filename="__model__",
                         return_meta=False):
    """Returns (program_desc, feed_names, fetch_names); with
    `return_meta`, also the export's {feed_meta, bucket_hints}.  The
    persistables land in the global scope (use `scope_guard`), on the
    executor's device."""
    with open(os.path.join(dirname, model_filename)) as f:
        meta = json.load(f)
    program = ProgramDesc.from_dict(meta["program"])
    arrays = {}
    for var in _persistables(program):
        val = _load_one(dirname, var.name)
        if val is not None:
            arrays[var.name] = val
    params_from_numpy(global_scope(), arrays, executor.device)
    fetch_names = list(meta["fetch_names"])
    if return_meta:
        extra = {k: meta.get(k) for k in ("feed_meta", "bucket_hints")}
        return program, meta["feed_names"], fetch_names, extra
    return program, meta["feed_names"], fetch_names
