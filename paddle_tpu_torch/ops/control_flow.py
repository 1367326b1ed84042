"""Control-flow op kernels: `recurrent`, the StaticRNN and DynamicRNN
engine.

Counterpart of paddle_tpu/ops/control_flow.py (reference:
recurrent_op.cc, the StaticRNN engine, and RecurrentGradientMachine's
per-timestep expansion).  The reference runs a step block through a
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

`while`, `conditional_block`, the tensor-array ops and the rank-table
ops of the same JAX module wait with ROADMAP A7.
"""

import torch

from .registry import register_op


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
