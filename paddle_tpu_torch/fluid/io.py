"""Program pruning, and inference export and load in the JAX
package's format.

Counterpart of paddle_tpu/fluid/io.py `prune_program`,
`get_inference_program`, `save_inference_model` and
`load_inference_model`.  An export directory holds `__model__`, a JSON
object {program, feed_names, fetch_names, feed_meta[, bucket_hints]},
and one `<name>.npz` per persistable of the pruned program,
`np.savez(__ragged__=0, values=...)`.  Either package loads what the
other wrote.  Parameters cross between the two as numpy arrays
(`params_from_numpy`).  The structural verifier stays on the JAX side
for now.
"""

import json
import os

import numpy as np
import torch

from ..core.desc import ProgramDesc
from ..core.scope import global_scope
from ..core.types import np_dtype, tensor_from_numpy
from .framework import Program, Variable, default_main_program

__all__ = ["params_from_numpy", "prune_program", "get_inference_program",
           "save_inference_model", "load_inference_model"]


def _var_path(dirname, name):
    return os.path.join(dirname, name.replace("/", "_"))


def params_from_numpy(scope, arrays, device):
    """Set each {name: ndarray} in `scope` as a tensor on `device`,
    64-bit types narrowed to what they execute as."""
    device = torch.device(device)
    for name, arr in arrays.items():
        scope.set(name, tensor_from_numpy(arr, device))


def _as_program(program):
    return program if isinstance(program, Program) \
        else Program.from_desc(program)


def _names(vars_or_names):
    if isinstance(vars_or_names, (str, Variable)):
        vars_or_names = [vars_or_names]
    return [v.name if isinstance(v, Variable) else str(v)
            for v in vars_or_names]


def prune_program(program, targets):
    """The test clone of `program` (a Program or ProgramDesc) keeping
    only the block-0 ops that `targets` (Variables or names) need, and
    the VarDescs those ops or the targets name, and every persistable
    (reference: framework/prune.cc)."""
    target_names = set(_names(targets))
    pruned = _as_program(program).clone(for_test=True)
    block = pruned.desc.block(0)
    needed, produced, keep = set(target_names), set(), []
    for op in reversed(block.ops):
        if any(n in needed for n in op.output_names()):
            keep.append(op)
            needed.update(n for n in op.input_names() if n != "@EMPTY@")
            produced.update(op.output_names())
    block.ops = keep[::-1]
    for name in target_names:
        if name in produced or (name in block.vars
                                and block.vars[name].persistable):
            continue
        if name not in block.vars:
            raise ValueError("inference target %r is not a block-0 "
                             "variable" % name)
        raise ValueError("inference target %r is produced by no op (feed "
                         "variables cannot be targets)" % name)
    referenced = set(target_names)
    for op in block.ops:
        referenced.update(op.input_names())
        referenced.update(op.output_names())
    for name in list(block.vars):
        if name not in referenced and not block.vars[name].persistable:
            del block.vars[name]
    pruned.global_block().vars = {
        n: v for n, v in pruned.global_block().vars.items()
        if n in block.vars}
    pruned.global_block().sync_with_desc()
    return pruned


def get_inference_program(target_vars, main_program=None):
    return prune_program(main_program or default_main_program(),
                         target_vars)


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


def save_inference_model(dirname, feeded_var_names, target_vars, scope,
                         main_program=None, bucket_hints=None,
                         model_filename="__model__"):
    """Write `main_program` (a Program or ProgramDesc; default the
    default main program) pruned to `target_vars` (Variables or names),
    and the values in `scope` of the pruned program's persistables.
    Returns the pruned Program.  (The JAX side takes the executor, whose
    scope is global there; the port's values live in the scope given.)"""
    feed_names = _names(feeded_var_names)
    fetch_names = _names(target_vars)
    source = _as_program(main_program or default_main_program())
    pruned = prune_program(source, fetch_names)
    program = pruned.desc
    os.makedirs(dirname, exist_ok=True)
    meta = {
        "program": program.to_dict(),
        "feed_names": feed_names,
        "fetch_names": fetch_names,
        "feed_meta": _feed_meta(source.desc, feed_names),
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
    return pruned


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
