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

The second rewrite, `fuse_elemwise_chains` (paddle_tpu/fluid/fusion.py
:189-343, run by the `fuse` pass of compile/opt_passes.py), collapses
straight-line chains of elementwise, activation and bias ops (a
residual `elementwise_add` feeding its `relu`, a bias add feeding an
activation) into one `fused_elemwise_chain` op (ops/math.py), whose
kernel applies the original kernels in order; the chain's
intermediates leave the program.  The rewritten descs equal the JAX
package's.
"""

import json
from collections import OrderedDict

from ..analysis.common import EMPTY
from ..core.desc import OpDesc
from ..core.types import FUSED_ELEMWISE_OP
from ..ops.optimizer_ops import FUSION_ATTRS
from ..utils import flags

__all__ = ["PER_PARAM_UPDATE_OPS", "FUSED_UPDATE_OP", "fuse_update_ops",
           "unfuse_update_ops", "FUSABLE_UNARY", "FUSABLE_BINARY",
           "fuse_elemwise_chains"]

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


# single-input stages: one "X" operand, one "Out" output, registered
# deterministic device kernels (dropout draws from the random stream,
# batch_norm is a multi-output reduction: neither belongs here)
FUSABLE_UNARY = frozenset([
    "relu", "relu6", "sigmoid", "tanh", "exp", "sqrt", "abs", "square",
    "softplus", "softsign", "leaky_relu", "elu", "brelu", "scale",
    "cast", "clip"])

# two-input stages: the chain value enters X or Y, the other operand
# rides along as a side input (bias adds, residual adds, gating muls)
FUSABLE_BINARY = frozenset([
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min"])


def _stage_kind(od):
    """'unary' / 'binary' when `od` can be a fused-chain stage, else
    None.  Requires exactly the canonical slots, one name each."""
    outs = od.output("Out")
    if len(outs) != 1 or outs[0] == EMPTY:
        return None
    if any(slot != "Out" and names
           for slot, names in od.outputs.items()):
        return None
    if od.type in FUSABLE_UNARY:
        want = ("X",)
    elif od.type in FUSABLE_BINARY:
        want = ("X", "Y")
    else:
        return None
    for slot in want:
        names = od.input(slot)
        if len(names) != 1 or names[0] == EMPTY:
            return None
    if any(slot not in want and names
           for slot, names in od.inputs.items()):
        return None
    return "unary" if len(want) == 1 else "binary"


def _stage_reads(od):
    return [n for n in od.input_names() if n != EMPTY]


def fuse_elemwise_chains(desc, block_idx=0, keep=(), cap=0):
    """Greedily fuse single-consumer elementwise chains in one block.

    A chain extends from stage k to the op consuming its output iff
    the intermediate has exactly one definition and one use in the
    program, is not in ``keep`` (fetches, persistables, names other
    blocks read), and the consumer is itself a fusable stage.  Every
    var any stage reads must be defined at most once in the block, so
    running the whole chain at the last stage's position reads the
    same values the originals read: the rewrite gives the same bits by
    construction (the fused kernel applies the original registered
    kernels in order).

    ``cap`` bounds stages per fused op (0 = unbounded).  Chains
    shorter than 2 stages are left alone.  Returns the explain list
    (one entry per fused chain); the block is rewritten in place and
    the dead intermediate VarDescs are dropped.
    """
    from ..compile.fingerprint import _jsonable

    bd = desc.block(block_idx)
    ops = bd.ops
    keep = set(keep)

    def_count, use_count, sole_consumer = {}, {}, {}
    for i, od in enumerate(ops):
        for n in _stage_reads(od):
            use_count[n] = use_count.get(n, 0) + 1
            sole_consumer[n] = i
        for n in od.output_names():
            if n != EMPTY:
                def_count[n] = def_count.get(n, 0) + 1

    kinds = {i: k for i, od in enumerate(ops)
             for k in [_stage_kind(od)] if k}

    def stable_reads(idx):
        # every read var must be single-def so its value at the fused
        # position (the chain's last index) matches the original read
        return all(def_count.get(n, 0) <= 1 for n in _stage_reads(ops[idx]))

    consumed = set()
    groups = []            # (chain indices, fused OpDesc)
    explain = []
    dead_names = []
    for i in range(len(ops)):
        if i in consumed or i not in kinds or not stable_reads(i):
            continue
        chain = [i]
        while True:
            if cap and len(chain) >= cap:
                break
            cur = ops[chain[-1]].output("Out")[0]
            if cur in keep or def_count.get(cur, 0) != 1 \
                    or use_count.get(cur, 0) != 1:
                break
            j = sole_consumer[cur]
            if j in consumed or j not in kinds or not stable_reads(j):
                break
            od_j = ops[j]
            if kinds[j] == "binary":
                on_x = od_j.input("X")[0] == cur
                on_y = od_j.input("Y")[0] == cur
                if on_x == on_y:  # both slots (x*x) or neither
                    break
            elif od_j.input("X")[0] != cur:
                break
            chain.append(j)
        if len(chain) < 2:
            continue

        stages = []
        side_ins = []
        for k, idx in enumerate(chain):
            od = ops[idx]
            st = {"op": od.type}
            attrs = {a: _jsonable(v) for a, v in sorted(od.attrs.items())}
            if attrs:
                st["attrs"] = attrs
            if k == 0:
                st["in"] = "X"
                side = od.input("Y")[0] if kinds[idx] == "binary" \
                    else None
            else:
                prev_out = ops[chain[k - 1]].output("Out")[0]
                if kinds[idx] == "binary":
                    if od.input("X")[0] == prev_out:
                        st["in"], side = "X", od.input("Y")[0]
                    else:
                        st["in"], side = "Y", od.input("X")[0]
                else:
                    st["in"], side = "X", None
            if side is not None:
                st["side"] = len(side_ins)
                side_ins.append(side)
            stages.append(st)

        x0 = ops[chain[0]].input("X")[0]
        final_out = ops[chain[-1]].output("Out")[0]
        ins = OrderedDict([("X", [x0])])
        if side_ins:
            ins["SideIns"] = side_ins
        fused = OpDesc(
            FUSED_ELEMWISE_OP, ins, {"Out": [final_out]},
            {"stages": json.dumps(stages, sort_keys=True),
             "inner_types": [ops[idx].type for idx in chain]})
        consumed.update(chain)
        inter = [ops[idx].output("Out")[0] for idx in chain[:-1]]
        dead_names.extend(inter)
        groups.append((chain, fused))
        explain.append({"block": block_idx,
                        "ops": [ops[idx].type for idx in chain],
                        "out": final_out, "stages": len(chain),
                        "intermediates": inter})

    if not groups:
        return []
    replace_at = {chain[-1]: fused for chain, fused in groups}
    removed = consumed - set(replace_at)
    bd.ops = [replace_at.get(i, od) for i, od in enumerate(ops)
              if i in replace_at or i not in removed]
    for n in dead_names:
        bd.vars.pop(n, None)
    return explain


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
