"""Operator registry: kernels, grad kernels and the generic vjp kernel.

Counterpart of paddle_tpu/ops/registry.py.  A kernel is one function
per op type, `fn(ctx, ins, attrs) -> {slot: [tensor]}`, over torch
tensors; PyTorch runs it eagerly on whatever device its inputs live
on.  A grad op `<type>_grad` runs the explicit grad kernel registered
for `<type>`, or else `run_generic_grad`: `torch.func.vjp` of the
forward kernel, as the JAX side takes `jax.vjp` of it.

Shape inference (`infer_meta`, the counterpart of the JAX side's
`generic_infer_shape`) runs the op's kernel on tensors on the "meta"
device, which carry a shape and a dtype and no values.  An op whose
kernel cannot run there (one that reads values, or launches a CUDA
kernel on `data_ptr()`) registers an `infer_shape` stand-in instead: a
function of the same (ins, attrs) over meta tensors.
"""

import contextlib

import torch

from ..core.types import GRAD_SUFFIX

__all__ = ["OpInfo", "register_op", "register_grad_kernel", "get_op_info",
           "has_op", "registered_ops", "is_grad_op_type",
           "forward_type_of_grad", "run_generic_grad", "span",
           "infer_meta", "dense"]


def span(name):
    """A torch.profiler range named `name` while a profiler records,
    else a no-op: opening a range costs host time even when nothing
    records, far more than the check."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def dense(x, op_type):
    """`x` if it is a dense tensor; a ragged (LoD) value raises
    NotImplementedError: ragged inputs come with ROADMAP A7."""
    if not isinstance(x, torch.Tensor):
        raise NotImplementedError(
            "%s: ragged (LoD) inputs come with ROADMAP A7, got %s"
            % (op_type, type(x).__name__))
    return x


class OpInfo:
    __slots__ = ("type", "kernel", "grad_kernel", "infer_shape", "uses_rng",
                 "nondiff_inputs", "stop_gradient_op", "in_place_outputs",
                 "sparse_grad_slots")

    def __init__(self, type, kernel, grad_kernel=None, infer_shape=None,
                 uses_rng=False, nondiff_inputs=(), stop_gradient_op=False,
                 in_place_outputs=(), sparse_grad_slots=None):
        self.type = type
        self.kernel = kernel
        self.grad_kernel = grad_kernel        # None => generic vjp kernel
        # fn(ins, attrs) -> outs over meta tensors; None => the kernel
        self.infer_shape = infer_shape
        self.uses_rng = uses_rng
        self.nondiff_inputs = tuple(nondiff_inputs)  # slots never differentiated
        self.stop_gradient_op = stop_gradient_op     # no grads flow at all
        # slots whose output aliases an input (optimizer ops: ParamOut=Param)
        self.in_place_outputs = tuple(in_place_outputs)
        # fn(attrs) -> forward-input slots whose grad is a SelectedRows;
        # the backward builder types those grad VarDescs accordingly
        self.sparse_grad_slots = sparse_grad_slots


_OP_REGISTRY = {}


def register_op(type, **kwargs):
    """Decorator registering `fn` as the kernel for op `type`.

    Kernel signature: fn(ctx, ins, attrs) -> outs, where ins/outs map a
    slot name to a list of tensors and ctx is the executor's
    ExecContext (pure ops ignore it).  Keyword arguments set the
    OpInfo fields (nondiff_inputs, stop_gradient_op, ...)."""

    def deco(fn):
        _OP_REGISTRY[type] = OpInfo(type, fn, **kwargs)
        return fn

    return deco


def register_grad_kernel(fwd_type):
    """Register an explicit kernel for `<fwd_type>_grad`."""

    def deco(fn):
        _OP_REGISTRY[fwd_type].grad_kernel = fn
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


def is_grad_op_type(type):
    return type.endswith("_grad")


def forward_type_of_grad(type):
    if not is_grad_op_type(type):
        raise ValueError("%r is not a grad op type" % type)
    return type[: -len("_grad")]


def _differentiable(v):
    return isinstance(v, torch.Tensor) and v.is_floating_point()


def run_generic_grad(ctx, fwd_type, ins, attrs):
    """Execute `<fwd_type>_grad` with inputs laid out by the grad maker
    (fluid/backward.py):
      ins[slot]       : forward inputs (original slots)
      ins["O@SLOT"]   : forward outputs (ignored: the vjp recomputes the
                        forward, as on the JAX side, where XLA then
                        removes the recomputation; run eagerly here, the
                        port pays for it, in a profiler range named
                        "recompute")
      ins["OG@SLOT"]  : grads of forward outputs (None where absent)
    An output grad is cast and reshaped to its output's dtype and shape.
    Returns {"SLOT@GRAD": [...]} for the differentiable forward input
    slots: None where an input is not a float tensor, else its grad."""
    info = get_op_info(fwd_type)
    if info.uses_rng:
        raise RuntimeError(
            "op %r consumes RNG; register an explicit grad kernel" % fwd_type)

    fwd_in, out_grads = {}, {}
    for slot, vals in ins.items():
        if slot.startswith("OG@"):
            out_grads[slot[len("OG@"):]] = vals
        elif not slot.startswith("O@"):
            fwd_in[slot] = vals

    # the vjp differentiates float tensors of differentiable slots; the
    # rest (nondiff slots, integer ids, absent inputs) pass through
    diff = {slot: [v for v in vals if _differentiable(v)]
            for slot, vals in fwd_in.items()
            if slot not in info.nondiff_inputs}
    out_keys = []

    def f(dpart):
        merged = {}
        for slot, vals in fwd_in.items():
            if slot in dpart:
                it = iter(dpart[slot])
                vals = [next(it) if _differentiable(v) else v for v in vals]
            merged[slot] = vals
        outs = info.kernel(ctx, merged, attrs)
        out_keys.clear()
        flat = []
        for slot, vals in outs.items():
            for i, v in enumerate(vals):
                if _differentiable(v):
                    out_keys.append((slot, i))
                    flat.append(v)
        return tuple(flat)

    with span("recompute"):
        primals_out, vjp_fn = torch.func.vjp(f, diff)

    cots = []
    for (slot, i), p in zip(out_keys, primals_out):
        gs = out_grads.get(slot)
        g = gs[i] if gs is not None and i < len(gs) else None
        if g is None:
            cots.append(torch.zeros_like(p))
        else:
            g = g.to(p.dtype)
            cots.append(g.reshape(p.shape) if g.shape != p.shape else g)
    (grads,) = vjp_fn(tuple(cots))

    result = {}
    for slot, gs in grads.items():
        it = iter(gs)
        result[slot + GRAD_SUFFIX] = [
            next(it) if _differentiable(p) else None
            for p in fwd_in[slot]]
    return result


# Every dynamic (-1) dim takes the SAME substitute within one inference
# run (they are the batch dim and must broadcast together); a second run
# with another substitute tells static dims from dynamic ones.  The
# JAX side's values, highly composite (840 = lcm 1..8, 2520 = lcm 1..9)
# so that kernels folding the dynamic dim see a divisible size; the
# same values keep the VarDesc shapes equal to the JAX package's.
_SUB_A = 840
_SUB_B = 2520

META = torch.device("meta")


class _MetaCtx:
    """The ExecContext of shape inference: the meta device, no random
    stream (random ops infer from their attrs)."""

    device = META

    def next_rng(self):
        raise RuntimeError("shape inference has no random stream")


def infer_meta(op_type, ins_meta, attrs):
    """{slot: [(shape, dtype name)]} of the outputs of op `op_type` for
    inputs `ins_meta` {slot: [(shape, dtype)]}: the kernel (or the op's
    `infer_shape`) run on meta tensors with every -1 dim substituted,
    twice where an input has one; a dim that differs between the two
    runs is -1.  Dtypes are what the inputs execute as (int64 as
    int32), so the result is what the op gives at run time."""
    from ..core.types import torch_dtype

    info = get_op_info(op_type)
    fn = info.infer_shape or (
        lambda ins, a: info.kernel(_MetaCtx(), ins, a))

    def run(sub):
        ins = {slot: [torch.empty(tuple(sub if d < 0 else d
                                        for d in shape),
                                  dtype=torch_dtype(dtype), device=META)
                      for shape, dtype in metas]
               for slot, metas in ins_meta.items()}
        with torch.no_grad():
            return fn(ins, attrs)

    dynamic = any(d < 0 for metas in ins_meta.values()
                  for shape, _ in metas for d in shape)
    out_a = run(_SUB_A)
    out_b = run(_SUB_B) if dynamic else out_a
    result = {}
    for slot, vals in out_a.items():
        metas = []
        for va, vb in zip(vals, out_b[slot]):
            if va is None:
                metas.append(None)
                continue
            shape = tuple(int(a) if a == b else -1
                          for a, b in zip(va.shape, vb.shape))
            metas.append((shape, str(va.dtype).replace("torch.", "")))
        result[slot] = metas
    return result
