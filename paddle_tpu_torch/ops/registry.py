"""Operator registry, forward half.

Counterpart of paddle_tpu/ops/registry.py.  A kernel is one function
per op type, `fn(ctx, ins, attrs) -> {slot: [tensor]}`, over torch
tensors; PyTorch runs it eagerly on whatever device its inputs live
on.  Gradients (grad makers, generic vjp kernels) and shape inference
come with the training slice.
"""

__all__ = ["OpInfo", "register_op", "get_op_info", "has_op",
           "registered_ops"]


class OpInfo:
    __slots__ = ("type", "kernel")

    def __init__(self, type, kernel):
        self.type = type
        self.kernel = kernel


_OP_REGISTRY = {}


def register_op(type):
    """Decorator registering `fn` as the kernel for op `type`.

    Kernel signature: fn(ctx, ins, attrs) -> outs, where ins/outs map a
    slot name to a list of tensors and ctx is the executor's
    ExecContext (pure ops ignore it)."""

    def deco(fn):
        _OP_REGISTRY[type] = OpInfo(type, fn)
        return fn

    return deco


def get_op_info(type):
    info = _OP_REGISTRY.get(type)
    if info is None:
        raise KeyError("operator %r is not registered" % type)
    return info


def has_op(type):
    return type in _OP_REGISTRY


def registered_ops():
    return sorted(_OP_REGISTRY.keys())
