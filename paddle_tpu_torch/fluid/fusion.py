"""Optimizer-update fusion: the program rewrite that stacks update ops.

Counterpart of paddle_tpu/fluid/fusion.py:75-187 and :344
(`fuse_update_ops`, `unfuse_update_ops`, `_recipe_key`).  The port runs
ops eagerly, so each per-parameter update op launches its own kernels
on the card: a few microseconds of elementwise work each, for every
parameter of a step.  `fuse_update_ops` groups the update ops of a
block that share a recipe (the same op type, hyperparameter attrs,
learning-rate input, cross-parameter scalars such as Adam's beta
powers, parameter dtype and grad type) and rewrites each group of two
or more into one `fused_update` op (ops/optimizer_ops.py), which
concatenates the group's flattened tensors, runs the recipe once and
splits the results.  Every recipe is elementwise per parameter, so a
fused step gives the unfused step's bits.  Parameters of more than
`max_numel` elements (the flag `fuse_optimizer_max_numel`) keep their
own op: the launches a stack saves scale with the op count, dominated
by small tensors, while the copies it adds scale with bytes, dominated
by the big ones.  `unfuse_update_ops` expands the fused ops back.  The
rewritten programs equal the JAX package's through `to_dict()`.

The elementwise-chain fusion of the JAX module (`fuse_elemwise_chains`)
waits with `paddle_tpu/compile/`, its only caller (ROADMAP A10).
"""

from collections import OrderedDict

from ..core.desc import OpDesc
from ..ops.optimizer_ops import FUSION_ATTRS
from ..utils import flags

__all__ = ["PER_PARAM_UPDATE_OPS", "FUSED_UPDATE_OP", "fuse_update_ops",
           "unfuse_update_ops"]

# every per-parameter update op (ops/optimizer_ops.py)
PER_PARAM_UPDATE_OPS = frozenset([
    "sgd", "momentum", "adam", "adamax", "adagrad", "decayed_adagrad",
    "adadelta", "rmsprop", "ftrl", "proximal_gd", "proximal_adagrad"])

FUSED_UPDATE_OP = "fused_update"

# input slots of cross-parameter [1]-shaped state that every op of one
# optimizer shares: never stacked, so they join the recipe key
_SHARED_STATE_SLOTS = {
    "adam": ("Beta1Pow", "Beta2Pow"),
    "adamax": ("Beta1Pow",),
}


def _freeze(value):
    return tuple(value) if isinstance(value, list) else value


def _recipe_key(block, op):
    """Ops fuse iff they run the same math on the same dtype with the
    same learning rate and the same shared scalars.  SelectedRows grads
    group apart: one in a group would make the fused op run the recipe
    per parameter."""
    param = block.var_recursive(op.desc.input("Param")[0])
    grad = block.var_recursive(op.desc.input("Grad")[0])
    shared = tuple(tuple(op.desc.input(slot))
                   for slot in _SHARED_STATE_SLOTS.get(op.type, ()))
    return (op.type,
            tuple(sorted((k, _freeze(v)) for k, v in op.desc.attrs.items())),
            tuple(op.desc.input("LearningRate")),
            shared,
            str(param.dtype),
            str(getattr(grad, "type", "")))


def _numel(block, op):
    """The parameter's element count, None where its shape is unknown
    or dynamic."""
    shape = getattr(block.var_recursive(op.desc.input("Param")[0]),
                    "shape", None)
    if not shape or any(int(s) < 0 for s in shape):
        return None
    numel = 1
    for s in shape:
        numel *= int(s)
    return numel


def fuse_update_ops(block, ops=None, min_group=2, max_numel=None):
    """Rewrite the groups of same-recipe update ops of `block` (or of
    `ops`, a list of its Operators) into `fused_update` ops, each at its
    first member's place.  Returns the Operators that now stand for the
    requested ops, fused ones and the rest, in block order.
    `max_numel` (default: the flag `fuse_optimizer_max_numel`; 0 for no
    cap) keeps bigger parameters out of every stack."""
    if max_numel is None:
        max_numel = flags.get_flag("fuse_optimizer_max_numel")
    candidates = [op for op in (block.ops if ops is None else ops)
                  if op.type in PER_PARAM_UPDATE_OPS]
    groups = OrderedDict()
    for op in candidates:
        numel = _numel(block, op) if max_numel else None
        if numel is None or numel <= max_numel:
            groups.setdefault(_recipe_key(block, op), []).append(op)

    fused_descs = []
    for group in groups.values():
        if len(group) < min_group:
            continue
        first = group[0].desc
        # a slot is shared iff every member names the same vars there
        stacked = [slot for slot in first.inputs
                   if any(op.desc.inputs.get(slot) != first.inputs[slot]
                          for op in group)]
        ins = OrderedDict(
            (slot, [op.desc.input(slot)[0] for op in group]
             if slot in stacked else list(first.inputs[slot]))
            for slot in first.inputs)
        outs = OrderedDict(
            (slot, [op.desc.output(slot)[0] for op in group])
            for slot in first.outputs)
        attrs = dict(first.attrs)
        attrs["inner_type"] = first.type
        attrs["stacked_slots"] = sorted(stacked)
        member_ids = {id(op.desc) for op in group}
        insert_at = next(i for i, od in enumerate(block.desc.ops)
                         if id(od) in member_ids)
        block.desc.ops[:] = [od for od in block.desc.ops
                             if id(od) not in member_ids]
        fused = OpDesc(FUSED_UPDATE_OP, ins, outs, attrs)
        block.desc.ops.insert(insert_at, fused)
        fused_descs.append(fused)

    if fused_descs:
        block.sync_with_desc()
    mine = ({id(d) for d in fused_descs}
            | {id(op.desc) for op in candidates})
    return [op for op in block.ops if id(op.desc) in mine]


def unfuse_update_ops(block):
    """Expand every `fused_update` of `block` into its per-parameter ops,
    in stack order, at the fused op's place."""
    if not any(od.type == FUSED_UPDATE_OP for od in block.desc.ops):
        return
    expanded = []
    for od in block.desc.ops:
        if od.type != FUSED_UPDATE_OP:
            expanded.append(od)
            continue
        stacked = set(od.attrs["stacked_slots"])
        inner_attrs = {k: v for k, v in od.attrs.items()
                       if k not in FUSION_ATTRS}
        for i in range(len(od.input("Param"))):
            ins = {slot: [names[i]] if slot in stacked else list(names)
                   for slot, names in od.inputs.items()}
            outs = {slot: [names[i]] for slot, names in od.outputs.items()}
            expanded.append(OpDesc(od.attrs["inner_type"], ins, outs,
                                   dict(inner_attrs)))
    block.desc.ops[:] = expanded
    block.sync_with_desc()
