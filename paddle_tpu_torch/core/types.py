"""Variable kinds and dtype tables, with torch dtypes.

Counterpart of paddle_tpu/core/types.py.  Descs keep the declared
dtype (int64, float64) for API parity, but values execute as the
32-bit types, exactly as on the JAX side (x64 disabled there): an
int64 feed runs as int32, so export `feed_meta` says int32 and the two
packages agree on what a feed is.
"""

import numpy as np
import torch

GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    """The gradient variable of `name` (reference:
    paddle/framework/grad_op_desc_maker.h GradVarName)."""
    return name + GRAD_SUFFIX


class VarType:
    """Variable kinds (same strings as the JAX package's desc JSON)."""

    DENSE_TENSOR = "dense_tensor"
    SELECTED_ROWS = "selected_rows"
    FEED_MINIBATCH = "feed_minibatch"
    FETCH_LIST = "fetch_list"
    STEP_SCOPES = "step_scopes"
    LOD_RANK_TABLE = "lod_rank_table"
    TENSOR_ARRAY = "tensor_array"
    PLACE_LIST = "place_list"
    READER = "reader"
    RAW = "raw"

    LOD_TENSOR = DENSE_TENSOR
    LOD_TENSOR_ARRAY = TENSOR_ARRAY


_DTYPE_ALIASES = {
    "float32": "float32",
    "float64": "float64",
    "float16": "float16",
    "bfloat16": "bfloat16",
    "int8": "int8",
    "int16": "int16",
    "int32": "int32",
    "int64": "int64",
    "uint8": "uint8",
    "uint32": "uint32",
    "bool": "bool",
    "float": "float32",
    "double": "float64",
    "int": "int32",
    "long": "int64",
}

# what a declared dtype executes as (the JAX side's canonicalisation)
_EXEC_DTYPE = {
    "float64": "float32",
    "int64": "int32",
    "uint64": "uint32",
}

_TORCH_DTYPE = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "uint8": torch.uint8,
    "uint32": torch.uint32,
    "bool": torch.bool,
}


def canonical_dtype(dtype) -> str:
    """Normalise a dtype spec (string, numpy or torch dtype) to its
    canonical name."""
    if isinstance(dtype, str):
        name = dtype
    elif isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    else:
        name = np.dtype(dtype).name
    if name not in _DTYPE_ALIASES:
        raise ValueError("unsupported dtype: %r" % (dtype,))
    return _DTYPE_ALIASES[name]


def exec_dtype(dtype) -> str:
    """The dtype a declared dtype executes as."""
    name = canonical_dtype(dtype)
    return _EXEC_DTYPE.get(name, name)


def torch_dtype(dtype):
    """The torch dtype a declared dtype executes as."""
    return _TORCH_DTYPE[exec_dtype(dtype)]


def np_dtype(dtype):
    """The numpy dtype a declared dtype executes as (numpy has no
    bfloat16: a bfloat16 desc raises TypeError here)."""
    return np.dtype(exec_dtype(dtype))


def tensor_from_numpy(arr, device):
    """A numpy array as a tensor of its execution dtype on `device`.
    bfloat16 arrays (ml_dtypes, as the JAX package hands them out) cross
    by their bits; a read-only array is copied, since the tensor may
    share its memory."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr).view(np.uint16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    arr = np.ascontiguousarray(
        arr.astype(exec_dtype(arr.dtype), copy=False))
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def guard_int64_narrowing(arr, name="feed"):
    """int64 host arrays execute as int32.  An id that does not fit
    raises OverflowError instead of wrapping silently (embedding ids
    beyond 2^31 would corrupt lookups).  Counterpart of
    paddle_tpu/fluid/executor.py guard_int64_narrowing."""
    if getattr(arr, "dtype", None) == np.int64 and arr.size \
            and (arr.max() > np.iinfo(np.int32).max
                 or arr.min() < np.iinfo(np.int32).min):
        raise OverflowError(
            "feed %r: int64 values exceed int32 range; ids must stay "
            "below 2^31" % name)
