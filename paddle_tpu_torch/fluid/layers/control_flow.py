"""Control-flow layers: the RNN half — StaticRNN and DynamicRNN.

Counterpart of paddle_tpu/fluid/layers/control_flow.py (reference:
python/paddle/v2/fluid/layers/control_flow.py — StaticRNN:378,
DynamicRNN:1252).  `rnn.step()` (or `rnn.block()`) builds the step
block as a sub-block of the current block; on leaving it one
`recurrent` op in the parent runs that block once per step over
time-major step inputs (ops/control_flow.py).  The step block's reads
from outside become the op's `Closure` inputs, so the backward
differentiates them.  A DynamicRNN pads a ragged step input to
[B, maxT, ...] with a validity mask (`sequence_to_dense`): memories
freeze past each sequence's end and the step outputs become ragged again
(`dense_to_sequence`).  The descs equal the JAX package's.

`While`, `ConditionalBlock`, `IfElse`, the tensor-array and rank-table
layers and `less_than`/`equal` wait with ROADMAP A7 (their ops are not
ported yet).
"""

import contextlib

from ...core.desc import BlockRef
from ..framework import unique_name
from ..layer_helper import LayerHelper

__all__ = ["StaticRNN", "DynamicRNN"]


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
