"""Operator registry: kernels, grad kernels and the generic vjp kernel.

Counterpart of paddle_tpu/ops/registry.py.  A kernel is one function
per op type, `fn(ctx, ins, attrs) -> {slot: [tensor]}`, over torch
tensors; PyTorch runs it eagerly on whatever device its inputs live
on.  A grad op `<type>_grad` runs the explicit grad kernel registered
for `<type>`, or else `run_generic_grad`: `torch.func.vjp` of the
forward kernel, as the JAX side takes `jax.vjp` of it (for an op whose
inputs are DTensors on a device mesh, the same vjp by torch.autograd,
since torch.func cannot transform DTensor's `to_local` and the
collectives' Functions).

Shape inference (`infer_meta`, the counterpart of the JAX side's
`generic_infer_shape`) runs the op's kernel on tensors on the "meta"
device, which carry a shape and a dtype and no values.  An op whose
kernel cannot run there (one that reads values, or launches a CUDA
kernel on `data_ptr()`) registers an `infer_shape` stand-in instead: a
function of the same (ins, attrs) over meta tensors.  An op whose
output metas follow from descs rather than from its inputs' shapes
(`recurrent` reads its step block's VarDescs; `sequence_to_dense`
leaves its time extent dynamic) registers an `infer_desc` rule, a
function of (block, op_desc) that sets the output VarDescs itself, as
the JAX side's `infer_shape` hooks do.

A kernel that runs a sub-block (`recurrent`) does so through
`ctx.run_block` (fluid/executor.py); every tensor the sub-block reads
from outside is one of the op's inputs, so the generic grad takes the
vjp of all of them at once.

Ragged (LoD) values are `core.ragged.RaggedTensor`s.  A kernel that
takes them reads `values_of(x)` and gives a ragged input's structure to
its output with `like(x, out)`; a kernel that takes none calls
`dense(x, op_type)`, which refuses a ragged value by name.  The generic
grad of a ragged input is ragged with the input's splits, as on the JAX
side.  A sparse gradient is a `core.ragged.SelectedRows`; `sum` and the
optimizer update ops take one, and `dense` refuses it elsewhere.

An op registered `deterministic=True` (`conv2d`) runs its kernel, and
its generic grad runs the vjp's recompute and backward, with cuDNN
held to deterministic algorithms (`deterministic_cudnn`): cuDNN's
fastest f32 weight-grad algorithms add atomically, so a step would not
repeat bit for bit.  The scope is the op alone; torch's global
deterministic mode stays off.
"""

import contextlib
import functools
import sys

import torch

from ..core.ragged import RaggedTensor, SelectedRows
from ..core.tensor_array import TensorArray
from ..core.types import GRAD_SUFFIX, VarType

__all__ = ["OpInfo", "register_op", "register_grad_kernel", "get_op_info",
           "has_op", "capture_exceptions", "registered_ops",
           "is_grad_op_type",
           "forward_type_of_grad", "run_generic_grad", "span",
           "infer_meta", "dense", "values_of", "like", "keep_declared",
           "deterministic_cudnn", "dtensor_type", "device_constant"]


# values with a structure around one float tensor: the generic grad
# differentiates that tensor and rebuilds the structure around it
_STRUCTURED = (RaggedTensor, TensorArray)


def span(name):
    """A torch.profiler range named `name` while a profiler records,
    else a no-op: opening a range costs host time even when nothing
    records, far more than the check."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def dense(x, op_type):
    """`x` if it is a dense tensor.  A SelectedRows raises TypeError: a
    sparse gradient goes only to `sum` and the optimizer update ops, as
    on the JAX side.  A RaggedTensor raises TypeError too: the op takes
    no ragged input, as the JAX op takes none (it hands the value to
    `jnp`, which refuses it)."""
    if isinstance(x, SelectedRows):
        raise TypeError(
            "%s takes dense tensors, got a SelectedRows (a sparse "
            "gradient, which only `sum` and the optimizer update ops "
            "take)" % op_type)
    if not isinstance(x, torch.Tensor):
        raise TypeError(
            "%s takes no ragged (LoD) input, got a %s (as on the JAX "
            "side, the op reads dense tensors only)"
            % (op_type, type(x).__name__))
    return x


def deterministic_cudnn():
    """A context in which cuDNN picks only deterministic algorithms (no
    autotuning), its other settings (TF32 off, see the package
    docstring) as they are."""
    b = torch.backends.cudnn
    return b.flags(enabled=b.enabled, benchmark=False,
                   deterministic=True, allow_tf32=b.allow_tf32)


@functools.lru_cache(maxsize=1024)
def _constant(values, dtype, device, inference):
    return torch.tensor(values, dtype=dtype, device=device)


def device_constant(values, dtype, device):
    """`values` (a number or a nested tuple of numbers) as a tensor on
    `device`, made once and kept: a kernel's constant that a CUDA graph
    capture could not copy from the host, which reads the one the
    signature's warm-up made.  Read-only: a kernel returns a copy of it.
    One per inference mode, since a grad cannot save an inference
    tensor."""
    return _constant(values, dtype, torch.device(device),
                     torch.is_inference_mode_enabled())


def keep_declared(block, op_desc):
    """An `infer_desc` rule that leaves the output VarDescs as their
    layer declared them: the JAX side's `infer_shape` hooks that return
    None, and its host ops, whose outputs' sizes depend on the data."""
    return None


def values_of(x):
    """A RaggedTensor's flat values, a TensorArray's buffer; a dense
    tensor (or None) as is."""
    return x.values if isinstance(x, _STRUCTURED) else x


def like(x, out):
    """`out` with the structure of `x`: ragged over x's splits when x is
    ragged, a TensorArray of x's length when x is one, else `out`
    itself."""
    return x.with_values(out) if isinstance(x, _STRUCTURED) else out


class OpInfo:
    """What the framework knows of one op type.  `jittable` is the JAX
    package's fact about the type, kept with the same value: False for
    a host op there (it reads values on the host, or has an effect:
    `print`, `save`, `dist_send`, the beam and rank-table bookkeeping),
    True for a device op.  The program analysis reads it: dead-code
    elimination keeps a host op, CSE merges only device ops, lint L002
    reports a host op between device ops, and the donation analysis
    (analysis/alias.py) segments by it as the JAX executor does.

    `capturable` is the port's own fact: whether the torch kernel (and
    its grad kernel) can run inside a CUDA graph capture, i.e. makes no
    read of the device from the host (`.item()`, `bool(t)`, `.cpu()`,
    an output whose shape depends on values) and no copy of host data
    to the device.  It defaults to `jittable`; a jittable op whose
    kernel reads the device from the host registers `capturable=False`
    and names why in `not_capturable` (`capture_exceptions()` lists
    them).  The executor captures maximal runs of capturable ops
    (fluid/executor.py) and runs the others eagerly between them."""

    __slots__ = ("type", "kernel", "grad_kernel", "infer_shape",
                 "infer_desc", "jittable", "capturable", "not_capturable",
                 "uses_rng", "nondiff_inputs",
                 "stop_gradient_op", "in_place_outputs", "sparse_grad_slots",
                 "deterministic")

    def __init__(self, type, kernel, grad_kernel=None, infer_shape=None,
                 infer_desc=None, jittable=True, uses_rng=False,
                 nondiff_inputs=(), stop_gradient_op=False,
                 in_place_outputs=(), sparse_grad_slots=None,
                 deterministic=False, capturable=None, not_capturable=None):
        self.type = type
        self.kernel = kernel
        self.grad_kernel = grad_kernel        # None => generic vjp kernel
        # fn(ins, attrs) -> outs over meta tensors; None => the kernel
        self.infer_shape = infer_shape
        # fn(block, op_desc) setting the output VarDescs; None => meta run
        self.infer_desc = infer_desc
        self.jittable = jittable
        self.capturable = jittable if capturable is None else capturable
        if jittable and not self.capturable and not not_capturable:
            raise ValueError("op %r: a jittable op that cannot be captured "
                             "names why (not_capturable=...)" % type)
        self.not_capturable = not_capturable
        self.uses_rng = uses_rng
        self.nondiff_inputs = tuple(nondiff_inputs)  # slots never differentiated
        self.stop_gradient_op = stop_gradient_op     # no grads flow at all
        # slots whose output aliases an input (optimizer ops: ParamOut=Param)
        self.in_place_outputs = tuple(in_place_outputs)
        # fn(attrs) -> forward-input slots whose grad is a SelectedRows;
        # the backward builder types those grad VarDescs accordingly
        self.sparse_grad_slots = sparse_grad_slots
        # the kernel and its generic grad under `deterministic_cudnn`
        self.deterministic = deterministic


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


def capture_exceptions():
    """{op type: reason} of every registered op whose two marks differ:
    jittable on the JAX side, not capturable here."""
    return {t: i.not_capturable for t, i in sorted(_OP_REGISTRY.items())
            if i.jittable != i.capturable}


def registered_ops():
    return sorted(_OP_REGISTRY.keys())


def is_grad_op_type(type):
    return type.endswith("_grad")


def forward_type_of_grad(type):
    if not is_grad_op_type(type):
        raise ValueError("%r is not a grad op type" % type)
    return type[: -len("_grad")]


def _differentiable(v):
    """A float tensor, or a RaggedTensor or TensorArray over float
    values (its values are what the vjp differentiates)."""
    v = values_of(v)
    return isinstance(v, torch.Tensor) and v.is_floating_point()


def dtensor_type():
    """The DTensor class once torch.distributed.tensor is imported (a
    parallel entry point imports it), else None: no DTensor exists yet,
    and the single-device path does not pay for the import."""
    return getattr(sys.modules.get("torch.distributed.tensor"), "DTensor",
                   None)


def _is_dtensor(t):
    dtensor = dtensor_type()
    return dtensor is not None and isinstance(t, dtensor)


def _autograd_vjp(f, primals, cotangents, scoped):
    """The vjp of `f` at `primals` ({slot: [tensor]}) by torch.autograd:
    the generic grad of an op whose inputs are DTensors (under
    `parallel.ParallelTrainer`), whose per-rank pieces (`to_local`, the
    collectives' Functions) torch.func cannot transform.  An input the
    outputs do not depend on gets zeros, as from torch.func.vjp."""
    leaves = {slot: [t.detach().requires_grad_(True) for t in vals]
              for slot, vals in primals.items()}
    flat = [t for vals in leaves.values() for t in vals]
    with scoped(), span("recompute"), torch.enable_grad():
        outs = f(leaves)
    cots = cotangents(outs)
    pairs = [(o, c if _is_dtensor(c) or not _is_dtensor(o)
              else _replicate_like(c, o))
             for o, c in zip(outs, cots) if o.requires_grad]
    got = [None] * len(flat)
    if pairs and flat:
        with scoped():
            got = torch.autograd.grad([o for o, _ in pairs], flat,
                                      [c for _, c in pairs],
                                      allow_unused=True)
    it = iter(torch.zeros_like(t) if g is None else g
              for t, g in zip(flat, got))
    return {slot: [next(it) for _ in vals] for slot, vals in leaves.items()}


def _replicate_like(t, like):
    """A plain tensor as a replicated DTensor on `like`'s mesh."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


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
    slots: None where an input is not a float tensor, else its grad.  A
    ragged input is differentiated through its values, rebuilt around
    the vjp's values in the forward; its grad is ragged with its splits.
    A ragged output's cotangent is the values of its grad."""
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
    diff = {slot: [values_of(v) for v in vals if _differentiable(v)]
            for slot, vals in fwd_in.items()
            if slot not in info.nondiff_inputs}
    out_keys = []

    def f(dpart):
        merged = {}
        for slot, vals in fwd_in.items():
            if slot in dpart:
                it = iter(dpart[slot])
                vals = [like(v, next(it)) if _differentiable(v) else v
                        for v in vals]
            merged[slot] = vals
        outs = info.kernel(ctx, merged, attrs)
        out_keys.clear()
        flat = []
        for slot, vals in outs.items():
            for i, v in enumerate(vals):
                if _differentiable(v):
                    out_keys.append((slot, i))
                    flat.append(values_of(v))
        return tuple(flat)

    def cotangents(primals_out):
        cots = []
        for (slot, i), p in zip(out_keys, primals_out):
            gs = out_grads.get(slot)
            g = gs[i] if gs is not None and i < len(gs) else None
            if g is None:
                cots.append(torch.zeros_like(p))
            else:
                g = values_of(g).to(p.dtype)
                cots.append(g.reshape(p.shape) if g.shape != p.shape else g)
        return cots

    def scoped():
        return deterministic_cudnn() if info.deterministic \
            else contextlib.nullcontext()

    if any(_is_dtensor(t) for vals in diff.values() for t in vals):
        grads = _autograd_vjp(f, diff, cotangents, scoped)
    else:
        with scoped(), span("recompute"):
            primals_out, vjp_fn = torch.func.vjp(f, diff)
        with scoped():
            (grads,) = vjp_fn(tuple(cotangents(primals_out)))

    result = {}
    for slot, gs in grads.items():
        it = iter(gs)
        result[slot + GRAD_SUFFIX] = [
            like(p, next(it)) if _differentiable(p) else None
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


def _meta_value(shape, dtype, lod_level, sub,
                var_type=VarType.DENSE_TENSOR):
    """A meta tensor of `shape` with every -1 dim `sub`; with a lod
    level, a RaggedTensor over it: `sub` sequences at every level, as on
    the JAX side, and a `max_seqlen` of 1, so a recurrence runs one step
    (the time extent of a densified value reaches no output's shape).
    A SELECTED_ROWS var is a SelectedRows of `sub` rows (a dynamic
    count) and of height shape[0] (static, else `sub`)."""
    from ..core.types import torch_dtype

    dims = tuple(sub if d < 0 else d for d in shape)
    if var_type == VarType.SELECTED_ROWS:
        height = dims[0] if dims else sub
        return SelectedRows(
            torch.empty((sub,), dtype=torch.int32, device=META),
            torch.empty((sub,) + dims[1:], dtype=torch_dtype(dtype),
                        device=META), height)
    values = torch.empty(dims, dtype=torch_dtype(dtype), device=META)
    if not lod_level:
        return values
    splits = [torch.empty((sub + 1,), dtype=torch.int32, device=META)
              for _ in range(lod_level)]
    return RaggedTensor(values, splits,
                        torch.empty((), dtype=torch.int32, device=META),
                        max_seqlen=1)


def infer_meta(op_type, ins_meta, attrs):
    """{slot: [(shape, dtype name, lod level)]} of the outputs of op
    `op_type` for inputs `ins_meta` {slot: [(shape, dtype, lod level[,
    var type])]}: the kernel (or the op's `infer_shape`) run on meta
    tensors (RaggedTensors over them where the lod level is above 0,
    SelectedRows where the var type is SELECTED_ROWS) with every -1 dim
    substituted, twice where an input has one or is a SelectedRows; a
    dim that differs between the two runs is -1.  Dtypes are what the
    inputs execute as (int64 as int32), so the result is what the op
    gives at run time; a ragged output has the lod level of its
    RaggedTensor.  A SelectedRows output's meta is (shape, dtype, 0,
    SELECTED_ROWS), its shape [height, ...]."""
    info = get_op_info(op_type)
    fn = info.infer_shape or (
        lambda ins, a: info.kernel(_MetaCtx(), ins, a))

    def run(sub):
        ins = {slot: [_meta_value(*meta[:3], sub, *meta[3:])
                      for meta in metas]
               for slot, metas in ins_meta.items()}
        with torch.no_grad():
            return fn(ins, attrs)

    dynamic = any(meta[2] or any(d < 0 for d in meta[0])
                  or meta[3:] == (VarType.SELECTED_ROWS,)
                  for metas in ins_meta.values() for meta in metas)
    out_a = run(_SUB_A)
    out_b = run(_SUB_B) if dynamic else out_a
    result = {}
    for slot, vals in out_a.items():
        metas = []
        for va, vb in zip(vals, out_b[slot]):
            if va is None:
                metas.append(None)
                continue
            if isinstance(va, SelectedRows):
                shape = tuple(int(a) if a == b else -1
                              for a, b in zip(va.shape, vb.shape))
                metas.append((shape, str(va.dtype).replace("torch.", ""),
                              0, VarType.SELECTED_ROWS))
                continue
            lod = va.lod_level if isinstance(va, RaggedTensor) else 0
            va, vb = values_of(va), values_of(vb)
            shape = tuple(int(a) if a == b else -1
                          for a, b in zip(va.shape, vb.shape))
            metas.append((shape, str(va.dtype).replace("torch.", ""), lod))
        result[slot] = metas
    return result
