"""Shared helpers for the analysis passes: the scope-chain VarDesc walk
and the grad-op-to-forward OpInfo resolution, so the passes never
disagree about name or op resolution.

Counterpart of paddle_tpu/analysis/common.py."""

from ..ops import registry as op_registry

__all__ = ["EMPTY", "find_var_desc", "resolve_op_info"]

EMPTY = "@EMPTY@"


def resolve_op_info(op_type):
    """The OpInfo governing `op_type`, a `<fwd>_grad` op resolving to its
    forward's; None when the type is unknown (the verifier's V001)."""
    if op_registry.has_op(op_type):
        return op_registry.get_op_info(op_type)
    if op_registry.is_grad_op_type(op_type):
        fwd = op_registry.forward_type_of_grad(op_type)
        if op_registry.has_op(fwd):
            return op_registry.get_op_info(fwd)
    return None


def find_var_desc(desc, block_idx, name):
    """The VarDesc of `name` resolved through block `block_idx`'s parent
    chain, or None."""
    bd = desc.block(block_idx)
    while True:
        if name in bd.vars:
            return bd.vars[name]
        if bd.parent_idx < 0:
            return None
        bd = desc.block(bd.parent_idx)
