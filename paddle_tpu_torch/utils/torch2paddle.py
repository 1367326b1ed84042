"""Import torch model weights into a Program's parameters.

Parity target: the reference's migration tool
(python/paddle/utils/torch2paddle.py — walks a (lua-)torch serialized
model's layer list in order and writes each weight/bias pair into the
corresponding Paddle parameter file).  Counterpart of
paddle_tpu/utils/torch2paddle.py: it consumes a ``torch.nn.Module``
``state_dict`` (or a saved ``.pt`` of one) and places the tensors into a
scope by matching against the target program's parameter list, as torch
tensors on the executor's place (``executor=``; default the CPU).

Layout notes (why this is more than a rename):
  * torch ``Linear.weight`` is ``[out, in]``; the ``mul``-based fc here
    multiplies ``x @ W`` with ``W=[in, out]`` — 2-D weights whose
    transposed shape matches the target are transposed.
  * torch ``Conv2d.weight`` is OIHW — identical to the conv kernels
    here (ops/conv.py), copied as-is.
"""

import collections

import numpy as np

__all__ = ["torch_state_to_numpy", "load_torch_state"]


def torch_state_to_numpy(state):
    """state_dict / path-to-saved-state_dict -> ordered name->ndarray
    (f32; buffers like BN running stats are kept, num_batches_tracked
    counters are dropped)."""
    if isinstance(state, str):
        import torch

        state = torch.load(state, map_location="cpu",
                           weights_only=True)
    out = collections.OrderedDict()
    for name, tensor in state.items():
        if name.endswith("num_batches_tracked"):
            continue
        arr = np.asarray(tensor.detach().cpu().numpy()
                         if hasattr(tensor, "detach") else tensor)
        out[name] = arr.astype(np.float32) if arr.dtype == np.float64 \
            else arr
    return out


def _fit(arr, shape, our_name, torch_name):
    if tuple(arr.shape) == tuple(shape):
        return arr
    if arr.ndim == 2 and tuple(arr.shape[::-1]) == tuple(shape):
        return arr.T          # torch Linear [out,in] -> mul [in,out]
    if arr.ndim == 1 and tuple(shape) == (1,) + tuple(arr.shape):
        return arr[None]      # bias row-vector convention
    raise ValueError(
        "torch tensor %r %s does not fit parameter %r %s"
        % (torch_name, arr.shape, our_name, tuple(shape)))


def load_torch_state(program, state, scope=None, name_map=None,
                     strict=True, executor=None):
    """Place torch weights into ``program``'s parameters.

    ``name_map``: {our parameter name: torch state key}; when omitted,
    parameters and state entries are paired in declaration order (the
    reference tool's convention — torch layer lists and config layer
    order agree for a faithfully re-declared topology).  Each value
    lands on ``executor``'s place (the CPU without one).  Returns the
    list of parameter names written.
    """
    import torch

    from ..core.scope import global_scope

    scope = scope if scope is not None else global_scope()
    device = executor.place.device() if executor is not None else "cpu"
    tensors = torch_state_to_numpy(state)
    params = [v for v in program.list_vars()
              if getattr(v.desc, "is_parameter", False)
              or getattr(v, "is_parameter", False)]
    if name_map is None:
        if strict and len(params) != len(tensors):
            raise ValueError(
                "positional import needs equal counts: %d parameters "
                "vs %d torch tensors (pass name_map)"
                % (len(params), len(tensors)))
        pairs = list(zip(params, tensors.items()))
    else:
        by_name = {v.name: v for v in params}
        pairs = [(by_name[ours], (theirs, tensors[theirs]))
                 for ours, theirs in name_map.items()]
    written = []
    for var, (tname, arr) in pairs:
        value = _fit(arr, var.shape, var.name, tname)
        scope.set_local(var.name, torch.from_numpy(
            np.ascontiguousarray(value)).to(device))
        written.append(var.name)
    return written
