"""Canonical, content-addressed fingerprints of programs.

Counterpart of paddle_tpu/compile/fingerprint.py.

  * `canonical_desc(program)`: a canonical dict form of the Program IR:
    vars sorted by name, op order kept (it is semantic), input and
    output slots and attrs sorted, BlockRefs and numpy scalars made
    plain JSON.  Two Programs built independently (in either package)
    that describe the same computation give the same form.
  * `program_fingerprint(...)`: sha256 over the canonical desc and the
    inputs that specialize a run: feed and fetch names, the dtype
    policy flags, the rewrite pipeline's id and an optional mesh
    description.  The same program with the same feeds, fetches, flags
    and pipeline id gives the same hex digest in both packages.
  * `values_signature(...)`: a canonical string of the runtime shapes
    and dtypes of named values (torch tensors, RaggedTensors,
    SelectedRows).
  * `environment_fingerprint()`: the torch and CUDA versions, the
    device's name and the device count.  It differs from the JAX
    package's by design: a result built for one stack is never offered
    to the other.

Fingerprints are hex sha256 strings; `combine(*parts)` folds any number
of them (or raw strings) into one key.
"""

import hashlib
import json

import numpy as np

from ..core.desc import BlockRef

__all__ = ["canonical_desc", "program_fingerprint", "values_signature",
           "values_signature_key", "environment_fingerprint", "combine"]


def _jsonable(v):
    """An attr value in canonical JSON-able form (BlockRefs and the
    numpy scalars that shape arithmetic leaves included)."""
    if isinstance(v, BlockRef):
        return {"__block__": v.idx}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, bytes):
        return v.decode("utf-8", "backslashreplace")
    return v


def canonical_desc(program_or_desc):
    """Canonical dict form of a Program or ProgramDesc (see the module
    docstring).  Op order is kept, every unordered collection sorted."""
    desc = getattr(program_or_desc, "desc", program_or_desc)
    blocks = []
    for bd in desc.blocks:
        ops = []
        for od in bd.ops:
            ops.append({
                "type": od.type,
                "inputs": {k: list(od.inputs[k])
                           for k in sorted(od.inputs)},
                "outputs": {k: list(od.outputs[k])
                            for k in sorted(od.outputs)},
                "attrs": {k: _jsonable(od.attrs[k])
                          for k in sorted(od.attrs)},
            })
        variables = []
        for name in sorted(bd.vars):
            vd = bd.vars[name]
            variables.append({
                "name": vd.name, "type": vd.type, "dtype": vd.dtype,
                "shape": (list(vd.shape) if vd.shape is not None
                          else None),
                "lod_level": vd.lod_level,
                "persistable": bool(vd.persistable),
            })
        blocks.append({"idx": bd.idx, "parent_idx": bd.parent_idx,
                       "vars": variables, "ops": ops})
    return {"blocks": blocks}


def _sha(text):
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def combine(*parts):
    """Fold any number of strings or fingerprints into one key."""
    return _sha("\x1f".join(str(p) for p in parts))


def program_fingerprint(program, feeds=(), fetches=(), flag_items=None,
                        pipeline_id="", mesh=None):
    """Content fingerprint of a Program specialized by its run inputs.

    flag_items: explicit (name, value) pairs of the process flags that
        change what runs (the dtype policy); None means no flag
        dependence.
    pipeline_id: the rewrite PassManager's pipeline id.
    mesh: an optional mesh description: a {axis: size} dict, or any
        object with a `shape` dict.
    """
    payload = {
        "ir": canonical_desc(program),
        "feeds": sorted(str(f) for f in feeds),
        "fetches": [str(f) for f in fetches],
        "flags": (sorted((str(k), _jsonable(v))
                         for k, v in flag_items) if flag_items else []),
        "pipeline": str(pipeline_id),
        "mesh": _mesh_desc(mesh),
    }
    return _sha(json.dumps(payload, sort_keys=True))


def _mesh_desc(mesh):
    if mesh is None:
        return None
    shape = getattr(mesh, "shape", None)
    if shape is not None and hasattr(shape, "items"):
        return sorted((str(k), int(v)) for k, v in shape.items())
    if hasattr(mesh, "items"):
        return sorted((str(k), int(v)) for k, v in mesh.items())
    return str(mesh)


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _value_sig(v):
    from ..core.ragged import RaggedTensor, SelectedRows

    if isinstance(v, RaggedTensor):
        return ("ragged", _value_sig(v.values),
                tuple(_value_sig(rs) for rs in v.row_splits))
    if isinstance(v, SelectedRows):
        return ("rows", _value_sig(v.values), _value_sig(v.rows))
    shape = getattr(v, "shape", None)
    dtype = getattr(v, "dtype", None)
    if shape is None or dtype is None:
        return ("py", type(v).__name__, repr(v))
    return ("t", tuple(int(s) for s in shape), _dtype_name(dtype))


def values_signature_key(named_values):
    """Hashable signature tuple of a {name: value} dict (or (name,
    value) pairs): names sorted, each value reduced to its shapes and
    dtypes (nested container types included)."""
    items = (named_values.items() if hasattr(named_values, "items")
             else named_values)
    return tuple((str(n), _value_sig(v))
                 for n, v in sorted(items, key=lambda kv: str(kv[0])))


def values_signature(named_values):
    """String form of `values_signature_key`, stable across
    processes."""
    return repr(values_signature_key(named_values))


def environment_fingerprint():
    """Fingerprint of the run environment: the torch and CUDA versions,
    the name of device 0 and the device count (the CPU when no CUDA
    device is present)."""
    import torch

    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
    else:
        kind, count = "cpu", 0
    return combine("torch=%s" % torch.__version__,
                   "cuda=%s" % torch.version.cuda,
                   "device=%s" % kind, "n=%d" % count)
