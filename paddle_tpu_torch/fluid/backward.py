"""Symbolic backward pass over a Program.

Counterpart of paddle_tpu/fluid/backward.py (reference:
python/paddle/v2/fluid/backward.py:338 append_backward).
`append_backward(loss)` appends to the loss's block 0 the seed
`fill_constant`, one `<type>_grad` op per forward op that a grad
reaches (slots: the forward inputs, `O@<slot>` the forward outputs,
`OG@<slot>` their grads), and a `sum` op wherever a variable gets more
than one grad contribution, with the same op order, var names
(`<var>@GRAD`, `@RENAME@<n>`, the `@RENAME@0r` rename before a `sum`)
and grad VarDescs as the JAX side: the desc equals the JAX package's
through `to_dict()`.  The grad ops go straight into the desc, without
shape inference: each grad VarDesc mirrors its forward var, found in
the block or one of its parents, and a parent's stop_gradient vars get
no grad.  The grad of a `recurrent` op (a StaticRNN or DynamicRNN) is
its generic grad, as on the JAX side: no backward sub-block is built.
After each grad op it appends, `append_backward` runs its `callbacks`
(default: fluid/clip.py `error_clip_callback`, which clips in place the
grad of a var that carries an `error_clip`).  `calc_gradient(targets,
inputs)` appends the grads of targets (seeded with ones, or with given
target grads) with respect to any inputs, stop_gradient ones included.
"""

from collections import defaultdict

from ..core.desc import OpDesc, VarDesc
from ..core.types import GRAD_SUFFIX, VarType, grad_var_name
from ..ops import registry as op_registry

__all__ = ["append_backward", "calc_gradient"]

EMPTY = "@EMPTY@"


class _GradState:
    def __init__(self):
        self.contribs = defaultdict(list)  # var name -> [grad contrib names]
        self.new_ops = []

    def add_contrib(self, var_name):
        """Reserve a fresh grad contribution name for var_name."""
        n = len(self.contribs[var_name])
        gname = (grad_var_name(var_name) if n == 0
                 else "%s@RENAME@%d" % (grad_var_name(var_name), n))
        self.contribs[var_name].append(gname)
        return gname

    def has_grad(self, var_name):
        return len(self.contribs[var_name]) > 0

    def finalize(self, var_name):
        """The final grad var name of var_name, emitting a `sum` op when
        it has several contributions (reference: backward.py:116
        _addup_repetitive_outputs_)."""
        contribs = self.contribs[var_name]
        if not contribs:
            return None
        if len(contribs) == 1:
            return contribs[0]
        out = grad_var_name(var_name)
        if out in contribs:
            # rename the canonical one so sum's output is fresh
            renamed = out + "@RENAME@0r"
            for op in self.new_ops:
                for names in list(op.outputs.values()) + \
                        list(op.inputs.values()):
                    for i, n in enumerate(names):
                        if n == out:
                            names[i] = renamed
            contribs = [renamed if c == out else c for c in contribs]
        self.new_ops.append(OpDesc("sum", {"X": contribs}, {"Out": [out]},
                                   {}))
        self.contribs[var_name] = [out]
        return out


def _make_grad_op(op_desc, state, no_grad_names):
    """The grad OpDesc of one forward op; None if no input needs a
    grad."""
    info = op_registry.get_op_info(op_desc.type)
    if info.stop_gradient_op:
        return None

    # out grads (finalize accumulations from already-emitted consumers)
    og_inputs = {}
    any_og = False
    for slot, names in op_desc.outputs.items():
        gs = []
        for n in names:
            g = state.finalize(n) if n != EMPTY else None
            gs.append(g if g is not None else EMPTY)
            any_og = any_og or g is not None
        og_inputs["OG@" + slot] = gs
    if not any_og:
        return None

    # which inputs get grads
    out_slots = {}
    any_grad = False
    for slot, names in op_desc.inputs.items():
        if slot in info.nondiff_inputs:
            continue
        outs = []
        for n in names:
            if n in no_grad_names:
                outs.append(EMPTY)
            else:
                outs.append(state.add_contrib(n))
                any_grad = True
        out_slots[slot + GRAD_SUFFIX] = outs
    if not any_grad:
        return None

    grad_inputs = dict(op_desc.inputs)
    for slot, names in op_desc.outputs.items():
        grad_inputs["O@" + slot] = list(names)
    grad_inputs.update(og_inputs)
    return OpDesc(op_desc.type + "_grad", grad_inputs, out_slots,
                  dict(op_desc.attrs))


def _chain(block, program):
    """`block` (a BlockDesc) and its parents up to block 0, through the
    ProgramDesc `program`."""
    while True:
        yield block
        if block.parent_idx < 0:
            return
        block = program.block(block.parent_idx)


def _collect_no_grad(block, no_grad_set, program):
    """`no_grad_set` and every stop_gradient var of `block` and of its
    parents."""
    return set(no_grad_set or ()) | {
        name for b in _chain(block, program)
        for name, vd in b.vars.items() if vd.stop_gradient}


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Append the ops computing d(loss)/d(param) for every trainable
    parameter of the loss's program (or those named in
    `parameter_list`); returns [(Parameter, grad Variable)] in the
    block's parameter order (reference: backward.py:338).  Each of
    `callbacks` (one or a list; default [`clip.error_clip_callback`])
    runs as fn(block=, context={}) after each grad op is appended."""
    from .clip import error_clip_callback

    block = loss.block.program.global_block()
    params = [p for p in block.all_parameters() if p.trainable]
    if parameter_list is not None:
        wanted = set(parameter_list)
        params = [p for p in params if p.name in wanted]
    if callbacks is None:
        callbacks = [error_clip_callback]
    elif not isinstance(callbacks, (list, tuple)):
        callbacks = [callbacks]

    def after_op():
        for cb in callbacks:
            cb(block=block, context={})

    pairs = _append_backward_desc(block.desc, loss.name,
                                  [p.name for p in params], no_grad_set,
                                  block.program.desc, after_op)
    block.sync_with_desc()
    by_name = {p.name: p for p in params}
    return [(by_name[p], block.var(g)) for p, g in pairs]


def _append_grad_ops(block, targets, target_grads, no_grad_names):
    """Grad ops for the reverse slice from `targets`, seeded with the
    grads named by `target_grads`; returns the _GradState holding them."""
    state = _GradState()
    for t, tg in zip(targets, target_grads):
        state.contribs[t].append(tg)
    for op_desc in reversed(list(block.ops)):
        if op_registry.is_grad_op_type(op_desc.type):
            continue
        if op_registry.get_op_info(op_desc.type).stop_gradient_op:
            continue
        if not any(state.has_grad(n) for n in op_desc.output_names()):
            continue
        g = _make_grad_op(op_desc, state, no_grad_names)
        if g is not None:
            state.new_ops.append(g)
    return state


def _append_backward_desc(block, loss_name, params, no_grad_set,
                          program, after_op=None):
    """append_backward on the BlockDesc `block` of the ProgramDesc
    `program`, for the parameters named in `params`; returns
    [(param name, grad name)].  A var of a parent block has its
    stop_gradient and meta found there.  `after_op()` runs after each
    grad op is appended."""
    loss = block.var(loss_name)
    no_grad_names = _collect_no_grad(block, no_grad_set, program)

    # seed: d loss / d loss = 1 (reference fills with fill_constant)
    loss_grad = grad_var_name(loss_name)
    block.ops.append(OpDesc(
        "fill_constant", {}, {"Out": [loss_grad]},
        {"shape": list(loss.shape) or [1], "value": 1.0,
         "dtype": loss.dtype}))
    _ensure_grad_var(block, loss_name, program)

    state = _append_grad_ops(block, [loss_name], [loss_grad], no_grad_names)

    # finalize leaf grads (params) — emits pending sum ops
    params_grads = []
    for p in params:
        gname = state.finalize(p)
        if gname is not None:
            params_grads.append((p, gname))

    for op in state.new_ops:
        _append_grad_op(block, op, program)
        if after_op is not None:
            after_op()
    return params_grads


def _append_grad_op(block, op, program):
    """Append the grad OpDesc `op` to `block` with the VarDescs of the
    grads it writes."""
    block.ops.append(op)
    for n in op.output_names():
        if n != EMPTY:
            _ensure_grad_var(block, _src_of(n), program)
    _apply_sparse_grad_types(block, op)


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Append the grads of `targets` (a Variable or a list) with respect
    to `inputs` (the same), each target seeded with ones of its shape or
    with its entry of `target_gradients`; returns the grad Variables of
    the inputs, None where none reaches one.  An input gets its grad even
    when it is stop_gradient."""
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    block = targets[0].block
    bd, program = block.desc, block.program.desc
    no_grad_names = _collect_no_grad(bd, no_grad_set, program) \
        - {v.name for v in inputs}
    tnames, tgrads = [], []
    for i, t in enumerate(targets):
        g = grad_var_name(t.name)
        if target_gradients is not None and target_gradients[i] is not None:
            g = target_gradients[i].name
        else:
            bd.ops.append(OpDesc(
                "fill_constant", {}, {"Out": [g]},
                {"shape": list(t.shape) or [1], "value": 1.0,
                 "dtype": t.dtype}))
            _ensure_grad_var(bd, t.name, program)
        tnames.append(t.name)
        tgrads.append(g)
    state = _append_grad_ops(bd, tnames, tgrads, no_grad_names)
    grads = [state.finalize(v.name) for v in inputs]
    # all the grad ops first, then their VarDescs, in the JAX side's
    # order (the VarDescs' order is part of the desc)
    bd.ops.extend(state.new_ops)
    for op in state.new_ops:
        for n in op.output_names():
            if n != EMPTY:
                _ensure_grad_var(bd, _src_of(n), program)
        _apply_sparse_grad_types(bd, op)
    block.sync_with_desc()
    return [block.var(g) if g is not None else None for g in grads]


def _src_of(grad_name):
    base = grad_name.split("@RENAME@")[0]
    if base.endswith(GRAD_SUFFIX):
        return base[: -len(GRAD_SUFFIX)]
    return base


def _apply_sparse_grad_types(block, op_desc):
    """Type as SelectedRows the grad VarDescs that the forward op's
    `sparse_grad_slots` names (lookup_table with is_sparse), and the
    output of a `sum` whose inputs all are (reference: the per-op
    VarTypeInference pass)."""
    if op_desc.type == "sum":
        in_descs = [block.vars.get(n) for n in op_desc.input("X")
                    if n != EMPTY]
        if in_descs and all(vd is not None
                            and vd.type == VarType.SELECTED_ROWS
                            for vd in in_descs):
            for n in op_desc.output("Out"):
                if n in block.vars:
                    block.vars[n].type = VarType.SELECTED_ROWS
        return
    if not op_registry.is_grad_op_type(op_desc.type):
        return
    hook = op_registry.get_op_info(
        op_registry.forward_type_of_grad(op_desc.type)).sparse_grad_slots
    if hook is None:
        return
    for slot in hook(op_desc.attrs):
        for n in op_desc.outputs.get(slot + GRAD_SUFFIX, []):
            if n != EMPTY and n in block.vars:
                block.vars[n].type = VarType.SELECTED_ROWS


def _ensure_grad_var(block, src_name, program):
    """Create the VarDescs of `src@GRAD` and of every rename of it that
    an op already references, mirroring src's meta (src found in
    `block` or a parent)."""
    src = next((b.vars[src_name] for b in _chain(block, program)
                if src_name in b.vars), None)
    gname = grad_var_name(src_name)
    names = [gname]
    for op in block.ops:
        for n in op.output_names() + op.input_names():
            if n.startswith(gname + "@RENAME@"):
                names.append(n)
    for n in names:
        if n not in block.vars:
            vd = VarDesc(n)
            if src is not None:
                vd.type = src.type
                vd.dtype = src.dtype
                vd.shape = src.shape
                vd.lod_level = src.lod_level
            block.vars[n] = vd
