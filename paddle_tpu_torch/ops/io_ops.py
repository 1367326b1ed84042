"""The `print` op: a tensor debugger that forwards its input.

Counterpart of paddle_tpu/ops/io_ops.py's `print` (reference:
print_op.cc); the JAX module's `save` and `load` ops are the port's
fluid/io.py functions, not ops.  The kernel reads its input back to the
host to print it (a sync on the card, as the JAX op runs on the host),
in the JAX op's format: the message, then the name, shape, dtype and
data fields its attrs ask for, `summarize` cutting the data to its
first values.  The grad passes the output's grad through unprinted.
"""

import torch

from .registry import register_grad_kernel, register_op, values_of


@register_op("print")
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
