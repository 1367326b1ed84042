"""Control-flow op kernels: `recurrent` (the StaticRNN and DynamicRNN
engine), `while`, `conditional_block`, `cond`, the tensor-array ops and
the LoD rank-table ops.

Counterpart of paddle_tpu/ops/control_flow.py (reference:
recurrent_op.cc, the StaticRNN engine, and RecurrentGradientMachine's
per-timestep expansion; while_op.cc, conditional_block_op.cc,
cond_op.cc, tensor_array_read_write_op.cc, lod_rank_table_op.cc and
the rest of the DynamicRNN plumbing).  The reference runs a step block through a
nested Executor once per step; the JAX side lowers the step block into
one `lax.scan` body over time-major step inputs, with the memories as
its carry and an optional per-step mask for variable-length sequences.
Here the same step block runs once per step in a Python loop over the
static time extent of the padded step inputs: each step's ops run
eagerly on the executor's device through `ctx.run_block`, and no step
reads a value on the host, so the loop never waits on the device.

The grad is the generic vjp (ops/registry.py): the step block's reads
from outside (the weights) are the op's `Closure` inputs, so
`torch.func.vjp` of the whole loop differentiates them with the step
inputs and the boot memories, as `jax.vjp` of the scan does on the JAX
side (the reference builds a backward sub-block instead: backward.cc
MakeBlockBackward).  The float `Mask` enters the vjp too: the kernel
reads it only through a cast to bool, so its grad is zero, as on the
JAX side.

`while` runs its block the same way.  Bounded by `max_steps` it is a
masked loop of exactly that many steps: each step runs the block and
keeps each carry's new value where the condition held before it
(`torch.where` on every leaf, a TensorArray's included), as the JAX
side's `lax.scan` does, so the loop reads nothing on the host and its
grad is the generic vjp of the loop, as `jax.vjp` of the scan.
Unbounded it is forward only and reads its condition on the host once
per iteration: the one synchronizing call this op cannot avoid.
`conditional_block` reads its scalar predicate on the host once and
runs its block or gives the outer values back; its generic grad is
then the vjp of the branch taken, as `lax.cond`'s on the JAX side.
`cond` runs both blocks over the full batch and picks rows by mask.

The tensor-array ops keep a TensorArray's dense buffer and device
length (core/tensor_array.py).  The rank-table ops (`lod_rank_table`,
`reorder_lod_tensor_by_rank`, `lod_tensor_to_array`,
`array_to_lod_tensor`, `shrink_rnn_memory`, `max_sequence_len`) and
the row routing of `split_lod_tensor`/`merge_lod_tensor` are host ops
on the JAX side: each reads its input's row splits (or its mask, or
its step index) to the host once, then moves rows on the device by
one indexed gather.  They are the reference's DynamicRNN plumbing; the
`recurrent` engine is the fast path.
"""

import torch
import torch.utils._pytree as pytree

from ..core.rank_table import LoDRankTable
from ..core.ragged import RaggedTensor
from ..core.tensor_array import DEFAULT_CAPACITY, EmptyTensorArray
from .registry import (keep_declared, register_grad_kernel, register_op,
                       values_of)


def _device(ctx):
    """The executor's device (the CPU for a kernel called without
    one)."""
    return getattr(ctx, "device", None) or torch.device("cpu")


def _scalar_bool(v):
    return values_of(v).reshape(()).to(torch.bool)


def _step_mask(m_t, like):
    """The [B] validity of one step, as a bool broadcastable to `like`."""
    m = m_t.to(torch.bool)
    return m.reshape(m.shape + (1,) * (like.dim() - m.dim()))


def _recurrent_infer_desc(block, op_desc):
    """FinalMems take their Boot's meta; each StepOutputs is [T] + its
    step-block var's shape, T the step inputs' time extent (the JAX
    side's `_recurrent_infer_shape`)."""
    from ..fluid.framework import _find_var_desc

    T = None
    for n in op_desc.input("StepInputs"):
        vd = _find_var_desc(block, n)
        T = vd.shape[0] if vd.shape else None
        break
    for bn, on in zip(op_desc.input("Boot"), op_desc.output("FinalMems")):
        src = _find_var_desc(block, bn)
        dst = _find_var_desc(block, on)
        dst.shape, dst.dtype, dst.lod_level = src.shape, src.dtype, 0
    sub_bd = block.program.desc.block(op_desc.attrs["sub_block"].idx)
    for name, out_n in zip(op_desc.attrs["step_output_names"],
                           op_desc.output("StepOutputs")):
        if name in sub_bd.vars:
            sv = sub_bd.vars[name]
            dst = _find_var_desc(block, out_n)
            dst.shape = (T if T is not None else -1,) + tuple(sv.shape or ())
            dst.dtype = sv.dtype
            dst.lod_level = 0


@register_op("recurrent", infer_desc=_recurrent_infer_desc)
def recurrent(ctx, ins, attrs):
    """The step block `sub_block` once per step over time.

    inputs:
      StepInputs: time-major [T, B, ...] tensors, one per step-input name
      Boot: initial memory values, one per memory
      Closure: the step block's reads from outside (weights)
      Mask: optional [T, B] validity (float or bool)
    attrs:
      sub_block; step_input_names; closure_names;
      mem_pre_names / mem_post_names (parallel lists);
      step_output_names; has_mask
    outputs:
      StepOutputs: stacked [T, B, ...] per step output (masked rows zero)
      FinalMems: memory values after each sequence's last valid step
    With a Mask, a step past a sequence's end keeps each memory's last
    value (`where(mask, new, old)`) and gives zero step outputs."""
    blk = attrs["sub_block"].idx
    step_in_names = list(attrs["step_input_names"])
    pre_names = list(attrs["mem_pre_names"])
    post_names = list(attrs["mem_post_names"])
    out_names = list(attrs["step_output_names"])
    xs = list(ins.get("StepInputs", []))
    mems = list(ins.get("Boot", []))
    closure = dict(zip(attrs["closure_names"], ins.get("Closure", [])))
    mask = ins["Mask"][0] if attrs.get("has_mask", False) else None

    steps = [[] for _ in out_names]
    for t in range(xs[0].shape[0]):
        env = dict(closure)
        env.update(zip(step_in_names, (x[t] for x in xs)))
        env.update(zip(pre_names, mems))
        ctx.run_block(blk, env)
        new_mems = [env[n] for n in post_names]
        outs_t = [env[n] for n in out_names]
        if mask is not None:
            new_mems = [torch.where(_step_mask(mask[t], new), new, old)
                        for new, old in zip(new_mems, mems)]
            outs_t = [torch.where(_step_mask(mask[t], o), o,
                                  torch.zeros((), dtype=o.dtype,
                                              device=o.device))
                      for o in outs_t]
        mems = new_mems
        for acc, o in zip(steps, outs_t):
            acc.append(o)
    return {"StepOutputs": [torch.stack(acc) for acc in steps],
            "FinalMems": mems}


# -- while ---------------------------------------------------------------------

def _select(active, new, old):
    """`new` where `active` holds, else `old`, leaf by leaf (a
    TensorArray's buffer and length, a RaggedTensor's values and
    splits)."""
    return pytree.tree_map(lambda a, b: torch.where(active, a, b), new, old)


@register_op("while", nondiff_inputs=("Condition",),
             infer_desc=keep_declared)
def while_op(ctx, ins, attrs):
    """reference: while_op.cc.  attrs: sub_block; x_names, the names of
    ins["X"] (the block's reads from outside and the carries' initial
    values); carry_names, the loop state the block writes; cond_name;
    max_steps.  With max_steps, a masked loop of max_steps steps (no
    host read; differentiable); without, a loop that reads the
    condition on the host before each iteration (forward only)."""
    blk = attrs["sub_block"].idx
    carry_names = list(attrs["carry_names"])
    cond_name = attrs["cond_name"]
    max_steps = attrs.get("max_steps")
    closure = dict(zip(attrs["x_names"], ins["X"]))
    missing = [n for n in carry_names if n not in closure]
    if missing:
        raise RuntimeError(
            "while: loop vars %s have no initial value before the loop "
            "(initialize them — e.g. first array_write — outside)" % missing)
    carry = {n: closure[n] for n in carry_names}
    if any(v is None or isinstance(v, EmptyTensorArray)
           for v in carry.values()):
        raise RuntimeError(
            "while: a TensorArray carried through the loop must be "
            "written once before the loop (static shapes)")

    def body(carry):
        env = dict(closure)
        env.update(carry)
        ctx.run_block(blk, env)
        return {n: env[n] for n in carry_names}

    if max_steps is None:
        while bool(_scalar_bool(carry[cond_name])):
            carry = body(carry)
    else:
        for _ in range(int(max_steps)):
            active = _scalar_bool(carry[cond_name])
            new = body(carry)
            carry = {n: _select(active, new[n], carry[n])
                     for n in carry_names}
    return {"Out": [carry[n] for n in carry_names]}


# -- conditionals --------------------------------------------------------------

@register_op("conditional_block", nondiff_inputs=("Cond",),
             infer_desc=keep_declared)
def conditional_block(ctx, ins, attrs):
    """reference: conditional_block_op.cc.  Runs the sub-block iff the
    condition holds (a scalar, or with `is_scalar_condition` False any
    element of it), read on the host once; the written vars keep their
    outer values otherwise.  attrs: sub_block, x_names, out_names,
    is_scalar_condition."""
    out_names = list(attrs["out_names"])
    cond = values_of(ins["Cond"][0])
    pred = _scalar_bool(cond) if attrs.get("is_scalar_condition", True) \
        else cond.to(torch.bool).any()
    closure = dict(zip(attrs["x_names"], ins["X"]))
    missing = [n for n in out_names if n not in closure]
    if missing:
        raise RuntimeError(
            "conditional_block: outputs %s need outer initial values "
            "(the false branch keeps them)" % missing)
    if bool(pred):
        env = ctx.run_block(attrs["sub_block"].idx, dict(closure))
        return {"Out": [env[n] for n in out_names]}
    return {"Out": [closure[n] for n in out_names]}


@register_op("cond", nondiff_inputs=("Cond",), infer_desc=keep_declared)
def cond_op(ctx, ins, attrs):
    """reference: cond_op.cc.  Cond is a bool vector over rows; each of
    Outs takes its rows from the true block where Cond holds and from
    the false block elsewhere.  Both blocks run over the full batch and
    rows select by mask, as on the JAX side (the reference gathers each
    subset into a sub-scope).  attrs: true_block, false_block, x_names,
    out_names."""
    cond_v = values_of(ins["Cond"][0]).reshape(-1).to(torch.bool)
    out_names = list(attrs["out_names"])

    def run(block_ref):
        env = ctx.run_block(block_ref.idx,
                            dict(zip(attrs["x_names"], ins["Xs"])))
        return [env[n] for n in out_names]

    outs = []
    for t, f in zip(run(attrs["true_block"]), run(attrs["false_block"])):
        mask = cond_v.reshape((-1,) + (1,) * (t.dim() - 1))
        outs.append(torch.where(mask, t, f))
    return {"Outs": outs}


# -- tensor arrays (tensor_array_read_write_op.cc, lod_array_length_op.cc) ---

@register_op("write_to_array", nondiff_inputs=("I",),
             infer_desc=keep_declared)
def write_to_array(ctx, ins, attrs):
    arr = ins.get("Array", [None])[0]
    if arr is None:
        arr = EmptyTensorArray(attrs.get("capacity", DEFAULT_CAPACITY))
    return {"Out": [arr.write(ins["I"][0], ins["X"][0])]}


@register_op("read_from_array", nondiff_inputs=("I",),
             infer_desc=keep_declared)
def read_from_array(ctx, ins, attrs):
    arr = ins["X"][0]
    if arr is None or isinstance(arr, EmptyTensorArray):
        raise RuntimeError("read_from_array on an empty TensorArray")
    return {"Out": [arr.read(ins["I"][0])]}


@register_op("lod_array_length", stop_gradient_op=True,
             infer_desc=keep_declared)
def lod_array_length(ctx, ins, attrs):
    """The array's length as int32 [1] (int64 executes as int32)."""
    arr = ins["X"][0]
    if arr is None or isinstance(arr, EmptyTensorArray):
        return {"Out": [torch.zeros((1,), dtype=torch.int32,
                                    device=_device(ctx))]}
    return {"Out": [arr.length.reshape(1)]}


@register_op("max_sequence_len", stop_gradient_op=True,
             infer_desc=keep_declared)
def max_sequence_len(ctx, ins, attrs):
    """reference: max_sequence_len_op.cc: the longest length of a
    LoDRankTable (a host int), or of a RaggedTensor's last level."""
    rt = ins["RankTable"][0]
    if isinstance(rt, LoDRankTable):
        return {"Out": [torch.tensor([rt.max_len()], dtype=torch.int32,
                                     device=_device(ctx))]}
    lens = rt.seq_lengths() if isinstance(rt, RaggedTensor) else rt
    return {"Out": [lens.max().reshape(1).to(torch.int32)]}


# -- the LoD rank-table machinery (lod_rank_table_op.cc,
# reorder_lod_tensor_by_rank_op.cc, lod_tensor_to_array_op.cc,
# array_to_lod_tensor_op.cc, shrink_rnn_memory_op.cc,
# split_lod_tensor_op.cc, merge_lod_tensor_op.cc) ----------------------------

def _check_levels(x, op_type):
    if x.lod_level > 2:
        raise NotImplementedError(
            "%s supports lod_level 1 and 2 inputs (got %d)"
            % (op_type, x.lod_level))


def _gather_rows(values, rows):
    """values[rows] by one index_select (`rows` a host list)."""
    idx = torch.tensor(rows, dtype=torch.int64, device=values.device)
    return torch.index_select(values, 0, idx)


def _splits_of(lengths, device):
    """Offsets (int32, on `device`) of sequences of host `lengths`."""
    out = [0]
    for n in lengths:
        out.append(out[-1] + int(n))
    return torch.tensor(out, dtype=torch.int32, device=device)


@register_op("lod_rank_table", stop_gradient_op=True,
             infer_desc=keep_declared)
def lod_rank_table(ctx, ins, attrs):
    """Level `level`'s sequences sorted by length, descending.  At level
    0 of a lod-level-2 input, an outer sequence's length is its count
    of subsequences (the nested DynamicRNN's step is one subsequence)."""
    x = ins["X"][0]
    level = int(attrs.get("level", 0))
    if not 0 <= level < x.lod_level:
        raise ValueError(
            "lod_rank_table level %d out of range for lod_level %d"
            % (level, x.lod_level))
    _check_levels(x, "rank-table machinery")
    return {"Out": [LoDRankTable.from_lengths(
        x.seq_lengths(level).cpu().tolist())]}


def _outer_bounds(lod, i):
    """Row range [begin, end) of outer sequence `i`'s values, through
    every level of the host offsets `lod`."""
    begin, end = i, i + 1
    for rs in lod:
        begin, end = rs[begin], rs[end]
    return begin, end


@register_op("reorder_lod_tensor_by_rank", stop_gradient_op=True,
             infer_desc=keep_declared)
def reorder_lod_tensor_by_rank(ctx, ins, attrs):
    """X's level-0 sequences in the rank table's order; deeper levels
    travel with their outer sequence."""
    x, table = ins["X"][0], ins["RankTable"][0]
    _check_levels(x, "reorder_lod_tensor_by_rank")
    lod = x.lod()
    rows, lengths = [], [[] for _ in lod]
    for i in table.indices():
        b, e = _outer_bounds(lod, i)
        rows.extend(range(b, e))
        lengths[0].append(lod[0][i + 1] - lod[0][i])
        if len(lod) == 2:
            lengths[1].extend(lod[1][j + 1] - lod[1][j]
                              for j in range(lod[0][i], lod[0][i + 1]))
    dev = x.values.device
    return {"Out": [RaggedTensor(_gather_rows(x.values, rows),
                                 [_splits_of(ls, dev) for ls in lengths])]}


@register_op("lod_tensor_to_array", stop_gradient_op=True,
             infer_desc=keep_declared)
def lod_tensor_to_array(ctx, ins, attrs):
    """Per-step slices in rank-table order, a list.  Lod level 1: step t
    is a dense batch of the t-th row of every sequence still running.
    Lod level 2: step t is a lod-level-1 RaggedTensor of the t-th
    subsequence of every outer sequence still running."""
    x, table = ins["X"][0], ins["RankTable"][0]
    _check_levels(x, "lod_tensor_to_array")
    lod = x.lod()
    steps = []
    if x.lod_level == 1:
        for t in range(table.max_len()):
            steps.append(_gather_rows(x.values, [
                lod[0][i] + t for i, n in table.items if n > t]))
        return {"Out": [steps]}
    outer, inner = lod
    for t in range(table.max_len()):
        rows, lengths = [], []
        for i, n in table.items:
            if n > t:
                sub = outer[i] + t
                rows.extend(range(inner[sub], inner[sub + 1]))
                lengths.append(inner[sub + 1] - inner[sub])
        steps.append(RaggedTensor(_gather_rows(x.values, rows),
                                  [_splits_of(lengths, x.values.device)]))
    return {"Out": [steps]}


@register_op("array_to_lod_tensor", stop_gradient_op=True,
             infer_desc=keep_declared)
def array_to_lod_tensor(ctx, ins, attrs):
    """The inverse of lod_tensor_to_array (dense or ragged steps); the
    sequences stay in rank-table order (reorder_lod_tensor_by_rank is
    the reference's way back to the input's)."""
    steps, table = ins["X"][0], ins["RankTable"][0]
    nested = any(isinstance(s, RaggedTensor) for s in steps)
    if not nested:
        flat = torch.cat(list(steps), 0)
        offsets = [0]
        for s in steps:
            offsets.append(offsets[-1] + s.shape[0])
        # the k-th sequence of the table is row k of each step it is in
        rows = [offsets[t] + k for k, (_, n) in enumerate(table.items)
                for t in range(n)]
        return {"Out": [RaggedTensor(
            _gather_rows(flat, rows),
            [_splits_of(table.lengths(), flat.device)])]}
    flat = torch.cat([s.values for s in steps], 0)
    # every step's offsets in one host read
    step_lod = torch.cat([s.last_splits() for s in steps]).cpu().tolist()
    starts, base, pos = [], 0, 0
    for s in steps:
        starts.append((pos, base))
        pos += s.nseq() + 1
        base += s.values.shape[0]
    rows, inner = [], []
    for k, (_, n) in enumerate(table.items):
        for t in range(n):
            p, b = starts[t]
            lo, hi = step_lod[p + k], step_lod[p + k + 1]
            rows.extend(range(b + lo, b + hi))
            inner.append(hi - lo)
    dev = flat.device
    return {"Out": [RaggedTensor(
        _gather_rows(flat, rows),
        [_splits_of(table.lengths(), dev), _splits_of(inner, dev)])]}


@register_op("shrink_rnn_memory", nondiff_inputs=("RankTable", "I"),
             infer_desc=keep_declared)
def shrink_rnn_memory(ctx, ins, attrs):
    """The prefix of the dense memory X's rows still active at step I
    (I read on the host)."""
    x = ins["X"][0]
    if isinstance(x, RaggedTensor):
        raise TypeError("shrink_rnn_memory expects a dense memory "
                        "tensor, not a RaggedTensor")
    i = int(torch.as_tensor(ins["I"][0]).reshape(-1)[0])
    return {"Out": [x[:ins["RankTable"][0].active_at(i)]]}


@register_grad_kernel("shrink_rnn_memory")
def shrink_rnn_memory_grad(ctx, ins, attrs):
    """dOut in the active prefix of a zero memory of X's shape.  dOut is
    `OG@Out` (the backward's layout) or `Out@GRAD` (the JAX kernel's)."""
    x = ins["X"][0]
    d_out = (ins.get("OG@Out") or ins["Out@GRAD"])[0]
    dx = torch.zeros_like(x)
    dx[:d_out.shape[0]] = d_out
    return {"X@GRAD": [dx]}


def _mask_host(mask):
    return torch.as_tensor(values_of(mask)).reshape(-1).to(
        torch.bool).cpu().tolist()


@register_op("split_lod_tensor", stop_gradient_op=True,
             infer_desc=keep_declared)
def split_lod_tensor(ctx, ins, attrs):
    """X's rows (a ragged X's sequences) where Mask holds to OutTrue,
    the rest to OutFalse (IfElse's input split); the mask read on the
    host once."""
    x, mask = ins["X"][0], _mask_host(ins["Mask"][0])
    if not isinstance(x, RaggedTensor):
        return {"OutTrue": [_gather_rows(x, [i for i, m in enumerate(mask)
                                             if m])],
                "OutFalse": [_gather_rows(x, [i for i, m in enumerate(mask)
                                              if not m])]}
    splits = x.last_splits().cpu().tolist()
    out = {}
    for slot, want in (("OutTrue", True), ("OutFalse", False)):
        seqs = [i for i, m in enumerate(mask[:len(splits) - 1])
                if m == want]
        rows = [r for i in seqs for r in range(splits[i], splits[i + 1])]
        out[slot] = [RaggedTensor(
            _gather_rows(x.values, rows),
            [_splits_of([splits[i + 1] - splits[i] for i in seqs],
                        x.values.device)])]
    return out


def _segments(r):
    """(values, host offsets) of a ragged value's sequences, or of a
    dense value's rows, one row each."""
    if isinstance(r, RaggedTensor):
        return r.values, r.last_splits().cpu().tolist()
    return r, list(range(r.shape[0] + 1))


@register_op("merge_lod_tensor", stop_gradient_op=True,
             infer_desc=keep_declared)
def merge_lod_tensor(ctx, ins, attrs):
    """The inverse routing (IfElse's output merge): row i (or sequence
    i) from InTrue where Mask holds, else from InFalse, in mask order."""
    mask = _mask_host(ins["Mask"][0])
    t_in, f_in = ins["InTrue"][0], ins["InFalse"][0]
    if isinstance(t_in, RaggedTensor) or isinstance(f_in, RaggedTensor):
        (tv, ts), (fv, fs) = _segments(t_in), _segments(f_in)
        n_true = sum(mask)
        if len(ts) - 1 != n_true or len(fs) - 1 != len(mask) - n_true:
            raise ValueError(
                "merge_lod_tensor: mask selects %d true / %d false rows "
                "but InTrue has %d and InFalse has %d sequences"
                % (n_true, len(mask) - n_true, len(ts) - 1, len(fs) - 1))
        flat = torch.cat([tv, fv.to(tv.dtype)], 0)
        rows, lengths, it, jf = [], [], 0, 0
        for m in mask:
            if m:
                lo, hi = ts[it], ts[it + 1]
                it += 1
            else:
                lo, hi = tv.shape[0] + fs[jf], tv.shape[0] + fs[jf + 1]
                jf += 1
            rows.extend(range(lo, hi))
            lengths.append(hi - lo)
        return {"Out": [RaggedTensor(_gather_rows(flat, rows),
                                     [_splits_of(lengths, flat.device)])]}
    dtype = t_in.dtype if t_in.numel() else f_in.dtype
    flat = torch.cat([t_in.to(dtype), f_in.to(dtype)], 0)
    it, jf, rows = 0, t_in.shape[0], []
    for m in mask:
        if m:
            rows.append(it)
            it += 1
        else:
            rows.append(jf)
            jf += 1
    return {"Out": [_gather_rows(flat, rows)]}
