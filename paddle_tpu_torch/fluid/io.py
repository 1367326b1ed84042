"""Saving and loading variables, program pruning, and inference
export and load, in the JAX package's format.

Counterpart of paddle_tpu/fluid/io.py (reference:
python/paddle/v2/fluid/io.py save_vars:63, save_persistables:112,
load_persistables:174, save_inference_model:237,
load_inference_model:325).  Each variable is one `<name>.npz` file
(`/` in a name becomes `_`), `np.savez(__ragged__=0, values=...)`; a
bfloat16 value is stored by its bits as a 2-byte void array, as numpy
holds the JAX package's bfloat16 arrays.  An export directory adds
`__model__`, a JSON object {program, feed_names, fetch_names,
feed_meta[, bucket_hints]}.  Either package loads what the other wrote.
A ragged (LoD) value is saved as the JAX side saves one,
`np.savez(__ragged__=1, values=..., nvalid=..., rs0=..., rs1=...)`
with one `rs<i>` per level of row splits, and loads back as a
RaggedTensor (without a `max_seqlen` hint, as on the JAX side).
The `save_*`/`load_*` functions take the executor, as the JAX side's
do, and read or write the global scope (`scope_guard` sets it); values
load onto the executor's device.  Parameters cross between the two
packages as numpy arrays too (`params_from_numpy`).  The structural verifier stays on the
JAX side for now.
"""

import json
import os

import numpy as np
import torch

from ..core.desc import BlockRef, ProgramDesc
from ..core.ragged import RaggedTensor
from ..core.scope import Scope, global_scope
from ..core.types import np_dtype, tensor_from_numpy
from .framework import (Parameter, Program, Variable,
                        default_main_program)

__all__ = ["params_from_numpy", "prune_program", "get_inference_program",
           "save_inference_model", "load_inference_model", "save_vars",
           "save_params", "save_persistables", "load_vars", "load_params",
           "load_persistables", "is_parameter", "is_persistable"]

# numpy's view of a bfloat16 value: its 2 bytes, unnamed
_BF16_BYTES = np.dtype("V2")


def _var_path(dirname, name):
    return os.path.join(dirname, name.replace("/", "_"))


def is_parameter(var):
    return isinstance(var, Parameter) or getattr(var.desc, "is_parameter",
                                                 False)


def is_persistable(var):
    return var.persistable


def host_array(name, value):
    """A copy of `value` on the host, as its file holds it: a tensor or
    array as a numpy array, bfloat16 as its bits in a V2 array; a
    RaggedTensor as {"values", "nvalid", "rs0", ...} of numpy arrays.
    Later in-place updates of `value` do not reach the copy."""
    if isinstance(value, RaggedTensor):
        arrays = {"values": host_array(name, value.values),
                  "nvalid": host_array(name, value.nvalid)}
        for i, rs in enumerate(value.row_splits):
            arrays["rs%d" % i] = host_array(name, rs)
        return arrays
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            return value.view(torch.int16).to("cpu", copy=True).numpy() \
                .view(_BF16_BYTES)
        return value.to("cpu", copy=True).numpy()
    if isinstance(value, np.ndarray):
        return value.copy()
    raise TypeError("%r: cannot save a %s" % (name, type(value).__name__))


def _save_one(dirname, name, value):
    """Write `<dirname>/<name>.npz` (the JAX side's `_save_one`); `value`
    may be what `host_array` gave."""
    if not isinstance(value, dict):
        value = host_array(name, value)
    if isinstance(value, dict):
        np.savez(_var_path(dirname, name), __ragged__=1, **value)
    else:
        np.savez(_var_path(dirname, name), __ragged__=0, values=value)


def _from_file(arr):
    if arr.dtype == _BF16_BYTES:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return tensor_from_numpy(arr, "cpu")


def _load_one(dirname, name, missing_ok=False, fileobj=None):
    """The value saved as `name` under `dirname` (or read from the open
    file `fileobj`), as a CPU tensor of its execution dtype, or a
    RaggedTensor of CPU tensors; None when absent and `missing_ok`."""
    if fileobj is None:
        fileobj = _var_path(dirname, name) + ".npz"
        if not os.path.exists(fileobj):
            if missing_ok:
                return None
            raise IOError("no saved var %r under %s" % (name, dirname))
    with np.load(fileobj) as data:
        values = _from_file(data["values"].copy())
        if int(data["__ragged__"]) == 0:
            return values
        splits = []
        while "rs%d" % len(splits) in data:
            splits.append(torch.from_numpy(
                data["rs%d" % len(splits)].astype(np.int32)))
        return RaggedTensor(values, splits, nvalid=int(data["nvalid"]))


def _names_of(main_program, vars, predicate):
    if vars is None:
        vars = [v for v in (main_program or default_main_program())
                .list_vars() if predicate(v)]
    return [v.name if isinstance(v, Variable) else str(v) for v in vars]


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None):
    """Write each of `vars` (Variables or names; default those of
    `main_program` that `predicate` keeps) that has a value in the
    global scope to `<dirname>/<name>.npz`."""
    os.makedirs(dirname, exist_ok=True)
    scope = global_scope()
    for name in _names_of(main_program, vars, predicate):
        val = scope.get(name)
        if val is not None:
            _save_one(dirname, name, val)


def save_params(executor, dirname, main_program=None):
    save_vars(executor, dirname, main_program, predicate=is_parameter)


def save_persistables(executor, dirname, main_program=None):
    save_vars(executor, dirname, main_program, predicate=is_persistable)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None):
    """Set each of `vars` (default those of `main_program` that
    `predicate` keeps) saved under `dirname` in the global scope, on the
    executor's device; a var with no file is skipped, as save skips a
    var with no value."""
    scope = global_scope()
    for name in _names_of(main_program, vars, predicate):
        val = _load_one(dirname, name, missing_ok=True)
        if val is not None:
            scope.set(name, val.to(executor.device))


def load_params(executor, dirname, main_program=None):
    load_vars(executor, dirname, main_program, predicate=is_parameter)


def load_persistables(executor, dirname, main_program=None):
    load_vars(executor, dirname, main_program, predicate=is_persistable)


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


def _op_block_refs(op):
    """The sub-block indices an op's attrs reference."""
    refs = []
    for v in op.attrs.values():
        if isinstance(v, BlockRef):
            refs.append(v.idx)
        elif isinstance(v, (list, tuple)):
            refs.extend(x.idx for x in v if isinstance(x, BlockRef))
    return refs


def _closure_reads(desc, block_idx, memo):
    """Every name a block tree reads before writing it and does not
    declare: what a parent must keep alive when it keeps the op that
    owns the tree.  The control-flow layers list their closure among the
    op's inputs already; this is the net for an op that does not."""
    if block_idx in memo:
        return memo[block_idx]
    bd = desc.block(block_idx)
    reads, writes = set(), set()
    for op in bd.ops:
        for n in op.input_names():
            if n != "@EMPTY@" and n not in writes:
                reads.add(n)
        for sub in _op_block_refs(op):
            reads |= _closure_reads(desc, sub, memo) - writes
        writes.update(op.output_names())
    memo[block_idx] = {n for n in reads if n not in bd.vars}
    return memo[block_idx]


def prune_program(program, targets):
    """The test clone of `program` (a Program or ProgramDesc) keeping
    only the block-0 ops that `targets` (Variables or names) need, and
    the VarDescs those ops or the targets name, and every persistable
    (reference: framework/prune.cc).  A kept op keeps its whole
    sub-block tree, and the closure that tree reads; every sub-block
    stays, and so do the block-0 VarDescs a sub-block names."""
    target_names = set(_names(targets))
    pruned = _as_program(program).clone(for_test=True)
    desc = pruned.desc
    block = desc.block(0)
    needed, produced, keep, memo = set(target_names), set(), [], {}
    for op in reversed(block.ops):
        if any(n in needed for n in op.output_names()):
            keep.append(op)
            needed.update(n for n in op.input_names() if n != "@EMPTY@")
            produced.update(op.output_names())
            for sub in _op_block_refs(op):
                needed |= _closure_reads(desc, sub, memo)
    block.ops = keep[::-1]
    for name in target_names:
        if name in produced or (name in block.vars
                                and block.vars[name].persistable):
            continue
        if name not in block.vars:
            raise ValueError(
                "inference target %r is not a block-0 variable; fetch a "
                "block-0 output (the recurrent group's result, not a "
                "variable inside its step block)" % name)
        raise ValueError("inference target %r is produced by no op (feed "
                         "variables cannot be targets)" % name)
    referenced = set(target_names)
    for b in desc.blocks:
        for op in b.ops:
            referenced.update(op.input_names())
            referenced.update(op.output_names())
        if b.idx != 0:
            referenced.update(b.vars)
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


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename="__model__",
                         bucket_hints=None):
    """Write `main_program` (a Program or ProgramDesc; default the
    default main program) pruned to `target_vars` (Variables or names),
    and the values of the pruned program's persistables.  Returns the
    pruned Program.  `executor` is an Executor, whose values live in the
    global scope as on the JAX side, or the Scope that holds them."""
    scope = executor if isinstance(executor, Scope) else global_scope()
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
        if val is not None:
            _save_one(dirname, var.name, val)
    return pruned


def load_inference_model(dirname, executor, model_filename="__model__",
                         return_meta=False):
    """Returns (program_desc, feed_names, fetch_names); with
    `return_meta`, also the export's {feed_meta, bucket_hints}.  The
    persistables land in the global scope (use `scope_guard`), on the
    executor's device."""
    with open(os.path.join(dirname, model_filename)) as f:
        meta = json.load(f)
    program = ProgramDesc.from_dict(meta["program"])
    scope = global_scope()
    for var in _persistables(program):
        val = _load_one(dirname, var.name, missing_ok=True)
        if val is not None:
            scope.set(var.name, val.to(executor.device))
    fetch_names = list(meta["fetch_names"])
    if return_meta:
        extra = {k: meta.get(k) for k in ("feed_meta", "bucket_hints")}
        return program, meta["feed_names"], fetch_names, extra
    return program, meta["feed_names"], fetch_names
