"""Control-flow layers: StaticRNN and DynamicRNN; While,
ConditionalBlock and IfElse; the comparisons that build their
conditions; the tensor-array and LoD rank-table layers.

Counterpart of paddle_tpu/fluid/layers/control_flow.py (reference:
python/paddle/v2/fluid/layers/control_flow.py — While:602,
StaticRNN:378, DynamicRNN:1252, ConditionalBlock:1065, IfElse, the
array and rank-table helpers, less_than and equal).  `rnn.step()` (or
`rnn.block()`) builds the step block as a sub-block of the current
block; on leaving it one `recurrent` op in the parent runs that block
once per step over time-major step inputs (ops/control_flow.py).  The
step block's reads from outside become the op's `Closure` inputs, so
the backward differentiates them.  A DynamicRNN pads a ragged step
input to [B, maxT, ...] with a validity mask (`sequence_to_dense`):
memories freeze past each sequence's end and the step outputs become
ragged again (`dense_to_sequence`).  `While.block()` and
`ConditionalBlock.block()` build a sub-block the same way and append
one `while` or `conditional_block` op whose `X` are the block's reads
from outside and whose outputs are the outer vars it writes.  `Print`
forwards a var through the `print` op.  `IfElse`
builds no sub-block: it splits its inputs by rows, runs both branches'
ops in the current block and merges their outputs.  The descs equal
the JAX package's.
"""

import contextlib

from ...core.desc import BlockRef
from ...core.tensor_array import DEFAULT_CAPACITY
from ...core.types import VarType
from ..framework import Variable, unique_name
from ..layer_helper import LayerHelper

__all__ = [
    "While", "StaticRNN", "DynamicRNN", "ConditionalBlock", "less_than",
    "array_write", "array_read", "array_length", "create_array",
    "max_sequence_len", "lod_rank_table", "lod_tensor_to_array",
    "array_to_lod_tensor", "shrink_memory", "reorder_lod_tensor_by_rank",
    "split_lod_tensor", "merge_lod_tensor", "IfElse", "equal", "Print",
]


def _compare(op_type, x, y, cond, kwargs):
    helper = LayerHelper(op_type, **kwargs)
    if cond is None:
        cond = helper.create_tmp_variable(dtype="bool")
        cond.stop_gradient = True
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def less_than(x, y, cond=None, **kwargs):
    """x < y into `cond` (a new bool var by default); reference:
    compare_op.cc."""
    return _compare("less_than", x, y, cond, kwargs)


def equal(x, y, cond=None, **kwargs):
    """x == y into `cond`; reference: compare_op.cc."""
    return _compare("equal", x, y, cond, kwargs)


def create_array(dtype, capacity=None, **kwargs):
    """A TENSOR_ARRAY var; the first `array_write` makes its value."""
    helper = LayerHelper("array", **kwargs)
    arr = helper.create_variable(name=unique_name("array"), dtype=dtype,
                                 type=VarType.TENSOR_ARRAY)
    arr.capacity = capacity
    return arr


def array_write(x, i, array=None, capacity=None, **kwargs):
    """array[i] = x (reference: tensor_array_read_write_op.cc); the
    array is made with `capacity` entries (DEFAULT_CAPACITY) at its
    first write."""
    helper = LayerHelper("array_write", **kwargs)
    if array is None:
        array = create_array(x.dtype)
    cap = capacity or getattr(array, "capacity", None) or DEFAULT_CAPACITY
    helper.append_op(type="write_to_array",
                     inputs={"X": [x], "I": [i], "Array": [array]},
                     outputs={"Out": [array]}, attrs={"capacity": int(cap)})
    return array


def array_read(array, i, **kwargs):
    helper = LayerHelper("array_read", **kwargs)
    out = helper.create_tmp_variable(array.dtype)
    helper.append_op(type="read_from_array",
                     inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_length(array, **kwargs):
    helper = LayerHelper("array_length", **kwargs)
    out = helper.create_tmp_variable(dtype="int64")
    out.stop_gradient = True
    helper.append_op(type="lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


def max_sequence_len(rank_table, **kwargs):
    # the JAX package's helper name, misspelt as there (unique names)
    helper = LayerHelper("max_seqence_len", **kwargs)
    out = helper.create_tmp_variable(dtype="int64")
    out.stop_gradient = True
    helper.append_op(type="max_sequence_len",
                     inputs={"RankTable": [rank_table]},
                     outputs={"Out": [out]})
    return out


def _block_reads_writes(block):
    """(reads from outside, writes) of a built sub-block, in op order."""
    produced = set()
    reads, writes = [], []
    for op in block.desc.ops:
        for n in op.input_names():
            if n != "@EMPTY@" and n not in produced and n not in reads:
                reads.append(n)
        for n in op.output_names():
            if n != "@EMPTY@":
                produced.add(n)
                if n not in writes:
                    writes.append(n)
    # names declared in the sub-block itself are internal
    local = set(block.desc.vars.keys())
    outer_reads = [n for n in reads if n not in local or n in writes]
    outer_reads = [n for n in outer_reads
                   if block.parent_block.has_var_recursive(n)]
    return outer_reads, writes


class While:
    """reference: control_flow.py While:602.  `cond` is a bool scalar
    var that the block assigns again.  `max_steps` bounds the loop and
    makes it differentiable (a masked loop of max_steps steps); without
    it the loop runs forward only and reads `cond` on the host once per
    iteration."""

    def __init__(self, cond, max_steps=None, name=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.max_steps = max_steps

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent_block = program.current_block()
        sub_block = program.create_block()
        yield
        program.rollback()
        outer_reads, writes = _block_reads_writes(sub_block)
        cond_name = self.cond_var.name
        # the loop state: the outer vars the block writes, and the cond
        carry = [n for n in writes if parent_block.has_var_recursive(n)]
        if cond_name not in carry:
            carry.append(cond_name)
        x_names = list(dict.fromkeys(outer_reads + carry))
        parent_block.append_op(
            type="while",
            inputs={"X": x_names, "Condition": [cond_name]},
            outputs={"Out": list(carry)},
            attrs={"sub_block": BlockRef(sub_block.idx),
                   "x_names": x_names, "carry_names": list(carry),
                   "cond_name": cond_name, "max_steps": self.max_steps},
            infer_shape=False)


class ConditionalBlock:
    """reference: control_flow.py ConditionalBlock:1065.  The block runs
    iff inputs[0] holds; the outer vars it writes keep their values
    otherwise."""

    def __init__(self, inputs, is_scalar_condition=True, name=None):
        for i in inputs:
            assert isinstance(i, Variable)
        self.inputs = inputs
        self.is_scalar_condition = is_scalar_condition
        self.helper = LayerHelper("conditional_block", name=name)

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent_block = program.current_block()
        sub_block = program.create_block()
        yield
        program.rollback()
        outer_reads, writes = _block_reads_writes(sub_block)
        out_names = [n for n in writes if parent_block.has_var_recursive(n)]
        x_names = list(dict.fromkeys(outer_reads + out_names))
        parent_block.append_op(
            type="conditional_block",
            inputs={"X": x_names, "Cond": [self.inputs[0].name]},
            outputs={"Out": list(out_names)},
            attrs={"sub_block": BlockRef(sub_block.idx),
                   "x_names": x_names, "out_names": list(out_names),
                   "is_scalar_condition": self.is_scalar_condition},
            infer_shape=False)


class StaticRNN:
    """A fixed-length RNN over dense [batch, T, ...] inputs (reference:
    control_flow.py StaticRNN:378, backed by recurrent_op.cc)."""

    BEFORE_RNN_BLOCK = 0
    IN_RNN_BLOCK = 1
    AFTER_RNN_BLOCK = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.status = self.BEFORE_RNN_BLOCK
        self.seq_inputs = []      # (outer Variable [B, T, ...], step var)
        self.memories = []        # dicts: boot (outer), pre (step), post
        self.step_outputs = []    # step vars
        self.outputs = []         # outer Variables [B, T, ...]
        self.sub_block = None
        self.seq_len = None
        self._ragged_like = None  # DynamicRNN: the first ragged input
        self._mask_var = None     # DynamicRNN: its [B, maxT] mask

    @contextlib.contextmanager
    def step(self):
        program = self.helper.main_program
        self.parent_block = program.current_block()
        self.sub_block = program.create_block()
        self.status = self.IN_RNN_BLOCK
        yield
        self.status = self.AFTER_RNN_BLOCK
        program.rollback()
        self._complete()

    def _assert_in_rnn(self):
        if self.status != self.IN_RNN_BLOCK:
            raise ValueError("must be called inside rnn.step()")

    @contextlib.contextmanager
    def _in_parent(self):
        """Build into the parent block for the duration."""
        prog = self.helper.main_program
        cur = prog.current_block_idx
        prog.current_block_idx = self.parent_block.idx
        try:
            yield
        finally:
            prog.current_block_idx = cur

    def step_input(self, x):
        """x: [batch, T, ...] dense; returns the per-step [batch, ...]
        var inside the block."""
        self._assert_in_rnn()
        if self.seq_len is None:
            self.seq_len = x.shape[1]
        ipt = self.sub_block.create_var(
            name=unique_name("@".join([self.helper.name, "step_in"])),
            dtype=x.dtype,
            shape=(x.shape[0],) + tuple(x.shape[2:]))
        self.seq_inputs.append((x, ipt))
        return ipt

    def memory(self, init=None, shape=None, batch_ref=None, value=0.0,
               dtype="float32", init_batch_dim_idx=0, ref_batch_dim_idx=0):
        """Loop-carried state.  init: the outer Variable holding the
        initial value; else `value` in [batch_ref's batch] + shape."""
        self._assert_in_rnn()
        from . import tensor as tensor_layers

        if init is not None and init_batch_dim_idx != 0:
            raise ValueError(
                "init_batch_dim_idx != 0 is not supported: memories are "
                "batch-major ([batch, ...]) in this framework")
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("memory needs init or (shape, batch_ref)")
            # a step-input ref resolves to its outer (batch-major) var,
            # whose batch dim is 0; an outer ref keeps ref_batch_dim_idx
            outer_ref, ref_dim = batch_ref, ref_batch_dim_idx
            for x, ipt in self.seq_inputs:
                if batch_ref.name == ipt.name:
                    outer_ref, ref_dim = x, 0
                    break
            with self._in_parent():
                init = tensor_layers.fill_constant_batch_size_like(
                    input=outer_ref, shape=[1] + list(shape), value=value,
                    dtype=dtype, input_dim_idx=ref_dim)
        pre = self.sub_block.create_var(
            name=unique_name("@".join([self.helper.name, "mem"])),
            dtype=init.dtype, shape=init.shape)
        self.memories.append({"boot": init, "pre": pre, "post": None})
        return pre

    def update_memory(self, mem, var):
        self._assert_in_rnn()
        for m in self.memories:
            if m["pre"].name == mem.name:
                m["post"] = var
                return
        raise ValueError("unknown memory %r" % mem.name)

    def step_output(self, o):
        self._assert_in_rnn()
        self.step_outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _transpose(self, x, perm):
        block = self.helper.main_program.current_block()
        out = block.create_var(name=unique_name(self.helper.name + "@t"),
                               dtype=x.dtype)
        block.append_op(type="transpose", inputs={"X": [x]},
                        outputs={"Out": [out]}, attrs={"axis": list(perm)})
        return out

    def _complete(self):
        """Append to the parent: the step inputs made time-major, the
        `recurrent` op, and its step outputs made batch-major again
        (ragged again over a DynamicRNN's ragged input)."""
        parent = self.parent_block
        for m in self.memories:
            if m["post"] is None:
                raise ValueError("memory never updated; call update_memory")

        tm_inputs = []
        for x, ipt in self.seq_inputs:
            perm = [1, 0] + list(range(2, len(x.shape)))
            tm_inputs.append((self._transpose(x, perm), ipt))
        mask_tm = None
        if self._mask_var is not None:
            mask_tm = self._transpose(self._mask_var, [1, 0])

        outer_reads, _ = _block_reads_writes(self.sub_block)
        bound = ({ipt.name for _, ipt in self.seq_inputs}
                 | {m["pre"].name for m in self.memories})
        closure_names = [n for n in outer_reads if n not in bound]

        step_out_vars = [
            parent.create_var(name=unique_name(self.helper.name + "@out_tm"),
                              dtype=so.dtype)
            for so in self.step_outputs]
        final_mem_vars = [
            parent.create_var(name=unique_name(self.helper.name + "@fmem"),
                              dtype=m["boot"].dtype)
            for m in self.memories]

        inputs = {
            "StepInputs": [tm.name for tm, _ in tm_inputs],
            "Boot": [m["boot"].name for m in self.memories],
            "Closure": closure_names,
        }
        if mask_tm is not None:
            inputs["Mask"] = [mask_tm.name]
        parent.append_op(
            type="recurrent", inputs=inputs,
            outputs={"StepOutputs": [v.name for v in step_out_vars],
                     "FinalMems": [v.name for v in final_mem_vars]},
            attrs={
                "sub_block": BlockRef(self.sub_block.idx),
                "step_input_names": [ipt.name for _, ipt in tm_inputs],
                "closure_names": closure_names,
                "mem_pre_names": [m["pre"].name for m in self.memories],
                "mem_post_names": [m["post"].name for m in self.memories],
                "step_output_names": [o.name for o in self.step_outputs],
                "has_mask": mask_tm is not None,
            })

        self.outputs = []
        for v, so in zip(step_out_vars, self.step_outputs):
            perm = [1, 0] + list(range(2, len(so.shape) + 1))
            bm = self._transpose(v, perm)          # [B, T, ...]
            if self._ragged_like is not None:
                bm = _dense_to_sequence(self.helper, bm, self._ragged_like)
            self.outputs.append(bm)
        self.final_memories = final_mem_vars

    def __call__(self, *args, **kwargs):
        if self.status != self.AFTER_RNN_BLOCK:
            raise ValueError("rnn() must be called after the step block")
        if len(self.outputs) == 1:
            return self.outputs[0]
        return self.outputs


class DynamicRNN(StaticRNN):
    """A variable-length RNN over ragged (LoD) inputs (reference:
    control_flow.py DynamicRNN:1252, which expands to lod_rank_table,
    while and memory shrinking).  Here a ragged input pads to
    [B, maxT, ...] with a mask and runs the same `recurrent` engine with
    masked memory carries; the step outputs are ragged again."""

    def __init__(self, name=None):
        StaticRNN.__init__(self, name=name)
        self.helper = LayerHelper("dynamic_rnn", name=name)

    def block(self):
        return self.step()

    def step_input(self, x):
        """x: a ragged Variable (lod level 1), or a dense one as in
        StaticRNN; returns the per-step [batch, ...] var."""
        self._assert_in_rnn()
        if x.lod_level == 0:
            return StaticRNN.step_input(self, x)
        with self._in_parent():
            padded, mask = _sequence_to_dense(self.helper, x)
            if self._ragged_like is None:
                self._ragged_like = x
                self._mask_var = mask
        ipt = self.sub_block.create_var(
            name=unique_name("@".join([self.helper.name, "step_in"])),
            dtype=x.dtype, shape=(-1,) + tuple(x.shape[1:]))
        self.seq_inputs.append((padded, ipt))
        return ipt


def _sequence_to_dense(helper, x):
    block = helper.main_program.current_block()
    padded = block.create_var(name=unique_name(helper.name + "@padded"),
                              dtype=x.dtype)
    mask = block.create_var(name=unique_name(helper.name + "@mask"),
                            dtype="float32")
    mask.stop_gradient = True
    block.append_op(
        type="sequence_to_dense", inputs={"X": [x]},
        outputs={"Out": [padded], "Mask": [mask]})
    return padded, mask


def _dense_to_sequence(helper, x, like):
    block = helper.main_program.current_block()
    out = block.create_var(name=unique_name(helper.name + "@ragged"),
                           dtype=x.dtype, lod_level=like.lod_level)
    block.append_op(
        type="dense_to_sequence", inputs={"X": [x], "Like": [like]},
        outputs={"Out": [out]})
    return out


# -- the LoD rank-table layers (ops/control_flow.py: host ops that keep the
# metas declared here) ---------------------------------------------------------

def lod_rank_table(x, level=0, **kwargs):
    helper = LayerHelper("lod_rank_table", **kwargs)
    table = helper.create_variable(
        name=unique_name("lod_rank_table.tmp"), dtype="int32",
        type=VarType.RAW, stop_gradient=True)
    helper.append_op(type="lod_rank_table", inputs={"X": [x]},
                     outputs={"Out": [table]}, attrs={"level": level},
                     infer_shape=False)
    return table


def lod_tensor_to_array(x, table, **kwargs):
    helper = LayerHelper("lod_tensor_to_array", **kwargs)
    array = helper.create_variable(
        name=unique_name("lod_tensor_to_array.tmp"), dtype=x.dtype,
        type=VarType.TENSOR_ARRAY, stop_gradient=True)
    helper.append_op(type="lod_tensor_to_array",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [array]}, infer_shape=False)
    return array


def array_to_lod_tensor(x, table, **kwargs):
    helper = LayerHelper("array_to_lod_tensor", **kwargs)
    out = helper.create_tmp_variable(dtype=x.dtype, lod_level=1)
    helper.append_op(type="array_to_lod_tensor",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [out]}, infer_shape=False)
    return out


def shrink_memory(x, i, table, **kwargs):
    helper = LayerHelper("shrink_memory", **kwargs)
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="shrink_rnn_memory",
                     inputs={"X": [x], "I": [i], "RankTable": [table]},
                     outputs={"Out": [out]}, infer_shape=False)
    return out


def reorder_lod_tensor_by_rank(x, rank_table, **kwargs):
    helper = LayerHelper("reorder_lod_tensor_by_rank", **kwargs)
    out = helper.create_tmp_variable(dtype=x.dtype, lod_level=1)
    helper.append_op(type="reorder_lod_tensor_by_rank",
                     inputs={"X": [x], "RankTable": [rank_table]},
                     outputs={"Out": [out]}, infer_shape=False)
    return out


def split_lod_tensor(input, mask, level=0, **kwargs):
    helper = LayerHelper("split_lod_tensor", **kwargs)
    out_true = helper.create_tmp_variable(dtype=input.dtype,
                                          lod_level=input.lod_level)
    out_false = helper.create_tmp_variable(dtype=input.dtype,
                                           lod_level=input.lod_level)
    helper.append_op(type="split_lod_tensor",
                     inputs={"X": [input], "Mask": [mask]},
                     outputs={"OutTrue": [out_true], "OutFalse": [out_false]},
                     attrs={"level": level}, infer_shape=False)
    return out_true, out_false


def merge_lod_tensor(in_true, in_false, x, mask, level=0, **kwargs):
    helper = LayerHelper("merge_lod_tensor", **kwargs)
    out = helper.create_tmp_variable(dtype=in_true.dtype,
                                     lod_level=x.lod_level)
    helper.append_op(type="merge_lod_tensor",
                     inputs={"X": [x], "Mask": [mask], "InTrue": [in_true],
                             "InFalse": [in_false]},
                     outputs={"Out": [out]}, attrs={"level": level},
                     infer_shape=False)
    return out


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both", **kwargs):
    """The `print` op over `input`: prints it as it flows and forwards
    it unchanged (reference: print_op.cc)."""
    helper = LayerHelper("print", **kwargs)
    out = helper.create_tmp_variable(dtype=input.dtype,
                                     lod_level=input.lod_level)
    helper.append_op(type="print", inputs={"In": [input]},
                     outputs={"Out": [out]},
                     attrs={"first_n": first_n,
                            "message": message or "",
                            "summarize": summarize,
                            "print_tensor_name": print_tensor_name,
                            "print_phase": print_phase},
                     infer_shape=False)
    return out


class IfElse:
    """Rows routed to two branches (reference: control_flow.py IfElse
    over split_lod_tensor, the branches' ops and merge_lod_tensor): rows
    where `cond` holds go through the true block, the rest through the
    false block, and the outputs merge back in input order."""

    OUT_IF_ELSE_BLOCKS = 0
    IN_IF_ELSE_TRUE_BLOCKS = 1
    IN_IF_ELSE_FALSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self.status = self.OUT_IF_ELSE_BLOCKS
        self._true_inputs = {}
        self._false_inputs = {}
        self._true_outputs = []
        self._false_outputs = []

    def input(self, x):
        if self.status == self.OUT_IF_ELSE_BLOCKS:
            raise ValueError("input() must be called inside a block")
        true_part, false_part = split_lod_tensor(x, self.cond)
        self._true_inputs[x.name] = true_part
        self._false_inputs[x.name] = false_part
        return (true_part if self.status == self.IN_IF_ELSE_TRUE_BLOCKS
                else false_part)

    @contextlib.contextmanager
    def true_block(self):
        self.status = self.IN_IF_ELSE_TRUE_BLOCKS
        yield
        self.status = self.OUT_IF_ELSE_BLOCKS

    @contextlib.contextmanager
    def false_block(self):
        self.status = self.IN_IF_ELSE_FALSE_BLOCKS
        yield
        self.status = self.OUT_IF_ELSE_BLOCKS

    def output(self, *outs):
        if self.status == self.IN_IF_ELSE_TRUE_BLOCKS:
            self._true_outputs.extend(outs)
        elif self.status == self.IN_IF_ELSE_FALSE_BLOCKS:
            self._false_outputs.extend(outs)
        else:
            raise ValueError("output() must be called inside a block")

    def __call__(self):
        if len(self._true_outputs) != len(self._false_outputs):
            raise ValueError("true/false blocks must produce the same "
                             "number of outputs")
        # any split input gives the row order
        template = self.helper.main_program.current_block().var(
            next(iter(self._true_inputs)))
        merged = [merge_lod_tensor(t, f, template, self.cond)
                  for t, f in zip(self._true_outputs, self._false_outputs)]
        return merged if len(merged) > 1 else merged[0]
