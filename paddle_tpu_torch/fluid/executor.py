"""Executor: runs block 0 of a Program, its maximal runs of capturable
ops as captured CUDA graphs.

Counterpart of paddle_tpu/fluid/executor.py, whose `_CompiledProgram`
splits block 0 into maximal runs of jittable ops and jits each with
its updated buffers donated.  Here block 0 splits into maximal runs of
capturable ops (`OpInfo.capturable`, the JAX mark but where a kernel
reads the device from the host) and the host ops between them; each
run (a segment) is captured into a `torch.cuda.CUDAGraph` per input
signature and replayed (`_CompiledProgram`, fluid/graphs.py).  A
signature's first run warms it up eagerly, its second captures it,
later runs copy the feeds into the graph's static inputs and replay.
The signature is the inputs' shapes, dtypes and structure (a ragged
feed's `max_seqlen`) and the address of every state tensor the graph
reads in place from the scope, so a tensor swapped into the scope
(`io.params_from_numpy`, `io.load_persistables`, `jit.state_to_scope`,
a supervisor's restore) forces a new, counted capture.  The graphs of a
program share one memory pool; at most `_CACHE_MAX` programs and, per
program, signatures are kept, and an eviction is counted
(`executor_program_cache_evictions_total`) and logged.  The executor's
random stream is registered with each graph, so a replay draws afresh.
A capture that fails raises `graphs.CaptureError` naming the segment,
its first op type and the op that failed; nothing falls back to an
eager run by itself.  On the CPU nothing is captured: the same
segments run the same ops against the same static buffers, donation
and plan (the graph's plain version; `captures` and `replays` count it
there too, `executor_jit_traces_total` and `executor_graph_replays_total`
count the card's only).

Donation (FLAGS_donation, analysis/alias.py): a segment's outputs that
it also reads (parameters, optimizer state) are written into the scope
tensor's own storage, so the graph's output is that storage and the
scope keeps its tensor; an update op whose in-place slot is donated
writes there itself (ExecContext.in_place, ops/optimizer_ops.py).
"auto" also gives up the reads the analysis proves dead after their
segment; "off" donates nothing: the state a segment updates is copied
into its static inputs and its new value out of the graph, the
numerics baseline.  Eager runs never donate.

`run(..., eager=True)` runs every op eagerly from Python, as the port
ran before and the JAX executor's eager mode does: each op in an
`op_registry.span` range while torch.profiler records (profiles by op
type), in `profiler.record_event` while `fluid.profiler` or the obs
trace is on (a row of the per-op table, a span on the trace).  A
captured segment has neither; `fluid.profiler` records a row per
replayed segment.  Host segments always run so.  An eager run drops
the program's captured graphs first (counted as evictions): a graph
holds its step's memory, and an eager step beside it would need as
much again.

Under `FLAGS_check_nan_inf` a run is eager (the JAX jitted path ignores
the flag; the port's callers rely on it), and every top-level op's
float outputs are scanned after it runs (reference: executor.cc:29,
CheckTensorNANOrInf executor.cc:66-77): one read back to the host per
output, and the first op with a NaN or Inf raises `NonfiniteError`
naming the op type, its index in block 0, the output slot and var, and
the count.  Ops of a sub-block run inside their op's kernel and are not
scanned, as on the JAX side.  An exception from a run reaches
`obs.flight.on_crash` with the feeds described (shapes and dtypes)
before it propagates.

Ops with DTensor inputs (`parallel.ParallelTrainer`'s step, a run fed
DTensors) run through `_run_on_mesh`, and their segments are captured
like any other: the signature adds each DTensor's mesh and placements
(a state DTensor's local tensor by its address), a donated state
DTensor's new value is laid out as the old one and written into its
local tensor's storage, and the waits of DTensor's asynchronous
collectives are issued inside the capture.  NCCL's communicators exist
by then: the warm-up ran the same collectives.

Release at the last reader: each value of a run leaves the run's
values (and a segment's own, eager, at its capture or on the CPU) after
the last op that reads it, by the `analysis.dataflow.Liveness` of block
0, so a captured graph's pool follows the values' lifetimes as XLA's
buffer assignment does for the JAX package.  A fetch, a persistable, a
name another block or a string attr references, a donated target and a
graph's own output stay.  A release drops a reference and changes no
value: the outputs and the state are bit for bit as without it.

A control-flow kernel runs a sub-block through `ExecContext.run_block`
(the JAX side lowers the same call into its scan body): the sub-block's
ops see only the env the kernel seeds (its closure, step inputs and
memories) and what they write there; a name outside it raises a
KeyError naming it.  The scope is not read from a sub-block: every
outside value reaches it as an input of the op, so the generic grad
differentiates it.

Before the ops run, as on the JAX side (paddle_tpu/fluid/executor.py
:883-951): the fault point `executor/run` is checked
(resilience/faults.py); under `FLAGS_verify_program` the program is
verified by `analysis.check_program(level="full")` once per (program,
version), and an error finding raises ProgramVerificationError; under
`FLAGS_compile_passes` the run executes a clone rewritten by
`compile.passes.optimize_program(program, spec, fetches)`, the caller's
program unchanged.  The rewritten clone is cached by (program identity,
version, fetch names, spec, AMP flags), the JAX compile cache's key, so
the pipeline runs once for a program and not on every step
(`pipeline_runs` counts its runs).  A program's version is the identity
of its op lists and its count of vars: an appended or removed op or
var makes another version.  The plan is cached by (program, version,
feeds, fetches, the AMP and batch-norm flags the kernels read, the
donation mode).  Under FLAGS_mem_budget_gb a program's static peak is
checked before its plan is made (`obs.mem.preflight`, which raises
MemoryBudgetError before any eager run or capture).

The persistent plan cache (FLAGS_compile_cache_dir, compile/pcache.py),
as the JAX executor's `_pcache_base` and `_aot_acquire`: a program is
keyed by its content (`fingerprint.program_fingerprint` over the IR,
feeds, fetches, the flags that change what runs and the pipeline id,
with the stack and the entry format), not by its identity, so a
restarted process finds it.  A hit takes the rewritten clone, its
segments, its plan and its donation sets from the entry and runs no
verifier (a clean verdict is in the entry), no pass pipeline
(`pipeline_runs` does not move) and no donation analysis; a miss plans
and stores them.  A CUDA graph cannot be saved: the restarted process
captures again, and each capture stores a stub entry (its seconds and
pool bytes).  An entry that fails to parse or the structural check is
quarantined and the run plans as on a miss.  `use_program_cache=False`
plans and runs a program without entering either cache.

Memory (obs/mem.py): under attribution (`obs.health.force_attribution`
or FLAGS_xla_cost_attribution) each captured segment's static
activation peak and its program's are registered at plan time; each
capture's pool growth joins them (on the card; on the CPU a capture
holds no pool).  A run
that raises an OOM-class error leaves a flight bundle whose "oom" note
blames the timeline's top buffers of the program that ran.

A program without grad ops that writes no persistable runs under
`torch.inference_mode()` (the served forward); any other runs under
`torch.no_grad()`, since inference tensors cannot be saved for a
backward and `torch.func.vjp` computes its grads regardless.

Telemetry, as on the JAX side (paddle_tpu/fluid/executor.py:921,
:1080, :1092): a run's feed preparation is timed
(`obs.telemetry.on_feed_seconds`), each feed the run places on the
device counts its bytes as h2d and each fetch pulled to the host its
bytes as d2h (`on_transfer`); a feed already on the device moves
nothing and counts nothing.  A capture counts in
`executor_jit_traces_total`, marks a `jit_build` instant with the
segment's label (`jit_segment[i:a..b xN]`, the JAX label) and publishes
its seconds and pool bytes (`obs.health.publish_compile_stats`, which
hands the pool bytes to obs.mem); a replay counts in
`executor_graph_replays_total` and adds the flash kernel's launches its
capture recorded (fluid/graphs.py).

Places: `CUDAPlace(device_id)` is the default; `CPUPlace()` must be
asked for.  A CUDAPlace without a CUDA device raises RuntimeError when
the executor is made — the port never carries on on the CPU by itself.
"""

import contextlib
import logging
import os
import threading
import time
from collections import OrderedDict

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core import scope as scope_mod
from ..core.desc import ProgramDesc
from ..core.ragged import RaggedTensor, SelectedRows, host_copy
from .framework import Program, Variable, default_main_program
from ..core.scope import global_scope
from ..core.types import (VarType, guard_int64_narrowing, np_dtype,
                          tensor_from_numpy, torch_dtype)
from ..obs import flight as obs_flight
from ..obs import telemetry as obs_tele
from ..obs import trace as obs_trace
from ..ops import registry as op_registry
from ..resilience import faults as faults_mod
from ..utils import flags
from . import profiler as profiler_mod

_log = logging.getLogger("paddle_tpu_torch.executor")

EMPTY = "@EMPTY@"
# the scope entry holding a scope's random stream (a torch.Generator)
RNG_STATE_NAME = "@RNG_STATE@"

__all__ = ["Executor", "Place", "CPUPlace", "CUDAPlace", "TPUPlace",
           "ExecContext",
           "NonfiniteError", "global_scope", "scope_guard", "fetch_var",
           "apply_op", "prepare_feed", "fetch_to_host"]


class NonfiniteError(FloatingPointError):
    """Raised by the FLAGS_check_nan_inf scan, carrying the identity of
    the first offending op so `obs.health.locate_nonfinite` can report
    it structurally (op_index is its position in block 0)."""

    def __init__(self, message, op_type=None, slot=None, var_name=None,
                 op_index=None, nonfinite_count=None):
        super().__init__(message)
        self.op_type = op_type
        self.slot = slot
        self.var_name = var_name
        self.op_index = op_index
        self.nonfinite_count = nonfinite_count


def _check_outputs_finite(op_desc, outs):
    """The NaN/Inf scan of one op's float outputs (a ragged or
    SelectedRows output's values): one device-to-host read per output."""
    for slot, names in op_desc.outputs.items():
        for name, val in zip(names, outs.get(slot) or ()):
            arr = val.values if isinstance(val, SelectedRows) \
                else op_registry.values_of(val)
            if name == EMPTY or not isinstance(arr, torch.Tensor) \
                    or not arr.is_floating_point():
                continue
            bad = int(torch.logical_not(torch.isfinite(arr)).sum())
            if bad:
                raise NonfiniteError(
                    "%d NaN/Inf element(s) in output %r (slot %r) of "
                    "op %r" % (bad, name, slot, op_desc.type),
                    op_type=op_desc.type, slot=slot, var_name=name,
                    nonfinite_count=bad)


class Place:
    def device(self):
        raise NotImplementedError


class CPUPlace(Place):
    def device(self):
        return torch.device("cpu")

    def __repr__(self):
        return "CPUPlace()"


class CUDAPlace(Place):
    """One CUDA device (reference: platform/place.h CUDAPlace)."""

    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def device(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDAPlace(%d): no CUDA device is available; pass "
                "place=CPUPlace() to run on the CPU" % self.device_id)
        if self.device_id >= torch.cuda.device_count():
            raise RuntimeError("CUDAPlace(%d): only %d CUDA devices"
                               % (self.device_id,
                                  torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)

    def __repr__(self):
        return "CUDAPlace(%d)" % self.device_id


# the accelerator place of scripts written for the JAX package
# (`fluid.TPUPlace(0)`): there TPUPlace is the class and CUDAPlace its
# alias; here the card's class is CUDAPlace and TPUPlace the alias
TPUPlace = CUDAPlace


@contextlib.contextmanager
def scope_guard(scope):
    old = scope_mod._global_scope
    scope_mod._global_scope = scope
    try:
        yield
    finally:
        scope_mod._global_scope = old


def fetch_var(name, scope=None, return_numpy=True):
    """The value of `name` in `scope` (default: the global scope): on
    the host (`fetch_to_host`) unless return_numpy is False; None where
    the scope has none."""
    val = (scope or global_scope()).get(name)
    if return_numpy and val is not None:
        return fetch_to_host(val)
    return val


class ExecContext:
    """Handed to every kernel: the program, block and value env, the
    scope, the place and its device, and the executor's random stream.
    Pure ops ignore it."""

    def __init__(self, program, block_idx, env, scope=None, place=None,
                 device=None, rng=None):
        self.program = program
        self.block_idx = block_idx
        self.env = env
        self.scope = scope
        self.place = place
        self.device = device
        self._rng = rng
        # the output slots the running op may write into its aliased
        # input's storage: the executor's donation (an update op whose
        # in-place slot names a donated state tensor), else none
        self.in_place = frozenset()

    def next_rng(self):
        """The torch.Generator on the executor's device that random ops
        without a seed of their own draw from; each draw advances it."""
        if self._rng is None:
            raise RuntimeError("this op needs a random stream; run it "
                               "through an Executor")
        return self._rng

    def run_block(self, block_idx, env):
        """Run every op of block `block_idx` against `env` (a dict the
        caller seeds with the sub-block's inputs), which takes the ops'
        outputs; returns it.  The random stream carries over (a
        torch.Generator, advanced in place)."""
        sub = ExecContext(self.program, block_idx, env, scope=None,
                          place=self.place, device=self.device,
                          rng=self._rng)
        for op_desc in self.program.block(block_idx).ops:
            apply_op(sub, op_desc)
        return env


def _declared_array(ctx, name):
    """Whether `name` is declared a TENSOR_ARRAY in the context's block
    or a parent of it."""
    if ctx.program is None:
        return False
    bd = ctx.program.block(ctx.block_idx)
    while True:
        if name in bd.vars:
            return bd.vars[name].type == VarType.TENSOR_ARRAY
        if bd.parent_idx < 0:
            return False
        bd = ctx.program.block(bd.parent_idx)


def _lookup(ctx, name):
    if name in ctx.env:
        return ctx.env[name]
    val = ctx.scope.get(name) if ctx.scope is not None else None
    if val is None and _declared_array(ctx, name):
        # a TensorArray read before its first write: `write_to_array`
        # makes it (the JAX side's executor does the same)
        return None
    if val is None:
        raise KeyError("variable %r is not initialized (op inputs must be "
                       "fed, persistable, or produced earlier in the "
                       "block; block %d)" % (name, ctx.block_idx))
    return val


def _kernel_of(op_type):
    """The kernel of a registered op, else of the grad op of a
    registered forward op: its explicit grad kernel or the generic vjp
    kernel."""
    if op_registry.has_op(op_type):
        return op_registry.get_op_info(op_type).kernel
    if op_registry.is_grad_op_type(op_type):
        fwd = op_registry.forward_type_of_grad(op_type)
        if op_registry.has_op(fwd):
            kernel = op_registry.get_op_info(fwd).grad_kernel
            if kernel is not None:
                return kernel
            return lambda ctx, ins, attrs: op_registry.run_generic_grad(
                ctx, fwd, ins, attrs)
    raise KeyError("operator %r is not registered" % op_type)


def _mesh_of(ins):
    """The device mesh of the first DTensor among an op's inputs, or
    None (every input a plain tensor: the single-device path)."""
    dtensor = op_registry.dtensor_type()
    if dtensor is None:
        return None
    for vals in ins.values():
        for v in vals:
            if isinstance(v, dtensor):
                return v.device_mesh
    return None


# op types whose kernels fail on DTensors (no sharding rule, a value
# read on the host, a launch on raw pointers): they run on full values
_FULL_VALUE_OPS = set()


def _run_on_mesh(ctx, op_type, kernel, ins, attrs, mesh):
    """Run a kernel whose inputs include DTensors (an op under
    `parallel.ParallelTrainer`): on the DTensors themselves, with plain
    tensors taken as replicated, so DTensor's sharding rules give the
    op's global result; an op type whose kernel cannot run so runs, once
    it has failed and from then on, on the full values, its outputs
    distributed back as replicated.  This is the one place where the
    executor meets the mesh.  The failure is learned in a signature's
    eager warm-up: inside a capture a failure raises CaptureError."""
    from ..parallel.sharding import replicating
    from . import graphs

    if op_type not in _FULL_VALUE_OPS:
        try:
            with replicating():
                return kernel(ctx, ins, attrs)
        except graphs.CaptureError:
            raise
        except Exception as exc:
            if graphs.capturing():
                # a capture cannot take the failed attempt back
                raise graphs.CaptureError(
                    "%r failed on DTensors inside a capture (%s: %s); "
                    "its warm-up ran it on DTensors"
                    % (op_type, type(exc).__name__, exc)) from exc
            # DTensor's dispatch raises what its checks raise (no
            # sharding rule, an assertion, a host read of a sharded
            # value); a kernel's own error raises again from the run on
            # full values below
            _FULL_VALUE_OPS.add(op_type)
    from torch.distributed.tensor import DTensor, Replicate

    full = pytree.tree_map(
        lambda v: v.full_tensor() if isinstance(v, DTensor) else v, ins)
    outs = kernel(ctx, full, attrs)
    rep = [Replicate()] * mesh.ndim
    return pytree.tree_map(
        lambda v: DTensor.from_local(v, mesh, rep, run_check=False)
        if isinstance(v, torch.Tensor) and not isinstance(v, DTensor)
        else v, outs)


def apply_op(ctx, op_desc):
    """Run one op's kernel against ctx.env; returns its outputs.
    `@EMPTY@` inputs read as None and `@EMPTY@` or None outputs are not
    written.  An op with a DTensor input runs through `_run_on_mesh`."""
    kernel = _kernel_of(op_desc.type)
    ins = {slot: [None if n == EMPTY else _lookup(ctx, n) for n in names]
           for slot, names in op_desc.inputs.items()}
    mesh = _mesh_of(ins)
    if mesh is None:
        outs = kernel(ctx, ins, op_desc.attrs)
    else:
        outs = _run_on_mesh(ctx, op_desc.type, kernel, ins, op_desc.attrs,
                            mesh)
    for slot, names in op_desc.outputs.items():
        for name, val in zip(names, outs.get(slot) or ()):
            if val is not None and name != EMPTY:
                ctx.env[name] = val
    return outs


def prepare_feed(block_desc, name, val, device):
    """A fed value (array, tensor, RaggedTensor or SelectedRows) cast to
    its var desc's execution dtype and moved to `device` (int64 ids are
    range-checked before they narrow to int32).  A RaggedTensor's values
    take the cast (int64 values on the host are range-checked first);
    its splits and `nvalid` move as they are.  A SelectedRows (a sparse
    grad fed to an update op) moves its rows and values as they are, as
    the JAX side feeds one as is.  A list of RaggedTensors (the per-step
    selections `beam_search_decode` reads) moves item by item."""
    if isinstance(val, SelectedRows):
        return val.to(device)
    if isinstance(val, (list, tuple)) and val and all(
            isinstance(v, RaggedTensor) for v in val):
        return [prepare_feed(block_desc, name, v, device) for v in val]
    vd = block_desc.vars.get(name)
    declared = vd.dtype if vd is not None else None
    if isinstance(val, RaggedTensor):
        values = val.values
        if values.dtype == torch.int64 and values.device.type == "cpu":
            guard_int64_narrowing(values.numpy(), name)
        values = prepare_feed(block_desc, name, values, device)
        return pytree.tree_map(lambda t: t.to(device),
                               val).with_values(values)
    dtensor = op_registry.dtensor_type()
    if dtensor is not None and isinstance(val, dtensor):
        # laid out over a mesh already: cast, never gathered to a device
        return val if declared is None else val.to(torch_dtype(declared))
    if isinstance(val, torch.Tensor):
        if declared is not None:
            val = val.to(torch_dtype(declared))
        if val.device != torch.device(device):
            obs_tele.on_transfer("h2d", val.numel() * val.element_size())
        return val.to(device)
    arr = np.asarray(val)
    target = (np_dtype(declared) if declared is not None
              else np.dtype(np.int32) if arr.dtype == np.int64
              else arr.dtype)
    if target == np.int32:
        guard_int64_narrowing(arr, name)
    arr = arr.astype(target, copy=False)
    obs_tele.on_transfer("h2d", arr.nbytes)
    return tensor_from_numpy(arr, device)


def _count_fetch(t):
    """A dense fetch's bytes as d2h, counted before bf16 widens (the
    JAX executor counts its arrays' bytes; ragged fetches count
    nothing there either)."""
    if isinstance(t, torch.Tensor):
        obs_tele.on_transfer("d2h", t.numel() * t.element_size())
    return t


def fetch_to_host(t):
    """A fetch on the host: a numpy array, or a RaggedTensor or
    SelectedRows of CPU tensors; bf16 values widen to f32 (the fetch
    contract).  The host copy shares no memory with `t`: a donated
    state tensor is written in place by the next run, and a fetched
    array must keep its values, as the JAX package's does."""
    if isinstance(t, (RaggedTensor, SelectedRows)):
        return pytree.tree_map(lambda v: v.clone(), host_copy(t))
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().to("cpu", copy=True).numpy()




def _desc_version(desc):
    """The version of a ProgramDesc: each block's ops (compared by
    identity; holding them keeps their ids from being reused) and its
    count of vars."""
    return tuple((tuple(b.ops), len(b.vars)) for b in desc.blocks)


def _op_capturable(op_desc):
    """Whether an op (a grad op: its forward's) can run inside a CUDA
    graph capture (`OpInfo.capturable`)."""
    t = op_desc.type
    if op_registry.has_op(t):
        return op_registry.get_op_info(t).capturable
    if op_registry.is_grad_op_type(t):
        fwd = op_registry.forward_type_of_grad(t)
        if op_registry.has_op(fwd):
            return op_registry.get_op_info(fwd).capturable
    raise KeyError("operator %r is not registered" % t)


def _segment_block(op_descs):
    """Block 0's ops as maximal runs [(capturable, [op_desc])], as the
    JAX executor's `_segment_block` splits them by `jittable`."""
    segments = []
    for od in op_descs:
        c = _op_capturable(od)
        if segments and segments[-1][0] == c:
            segments[-1][1].append(od)
        else:
            segments.append((c, [od]))
    return segments


def _is_dtensor(t):
    dtensor = op_registry.dtensor_type()
    return dtensor is not None and isinstance(t, dtensor)


def _settled(t):
    """`t`, or for the result of an asynchronous collective the plain
    tensor behind it, its wait issued (inside a capture, captured)."""
    from torch.distributed._functional_collectives import \
        AsyncCollectiveTensor

    return t.wait() if isinstance(t, AsyncCollectiveTensor) else t


def _local(t):
    """A DTensor's local tensor, settled; anything else as it is."""
    return _settled(t._local_tensor) if _is_dtensor(t) else t


def _settle_value(v):
    """A DTensor whose local tensor is an asynchronous collective's
    result, rebuilt on the settled local tensor; anything else as it
    is."""
    if not _is_dtensor(v) or _local(v) is v._local_tensor:
        return v
    return type(v).from_local(_local(v), v.device_mesh, v.placements,
                              run_check=False, shape=v.shape,
                              stride=v.stride())


def _leaf_key(t, by_address):
    """A tensor's part of a signature: shape, dtype and device, and
    where a graph reads it in place, its address and strides; a
    DTensor's mesh and placements beside its local tensor's."""
    if not isinstance(t, torch.Tensor):
        return t
    if _is_dtensor(t):
        return (t.device_mesh, tuple(t.placements), tuple(t.shape),
                _leaf_key(t._local_tensor, by_address))
    if by_address:
        return (tuple(t.shape), t.dtype, t.device, t.data_ptr(),
                t.stride())
    return (tuple(t.shape), t.dtype, t.device)


def _value_key(v, by_address):
    """A value's part of a signature; a RaggedTensor, SelectedRows or
    TensorArray by its structure (lod level, `max_seqlen`, length) and
    its tensors."""
    if isinstance(v, torch.Tensor) or v is None:
        return _leaf_key(v, by_address)
    leaves, spec = pytree.tree_flatten(v)
    return (str(spec),) + tuple(_leaf_key(t, by_address) for t in leaves)


def _copy_into(static, v):
    """Copy `v`'s tensors into the static buffers `static` (a DTensor's
    local tensor into the static DTensor's: their signatures hold equal
    placements)."""
    for dst, src in zip(pytree.tree_leaves(static), pytree.tree_leaves(v)):
        if isinstance(dst, torch.Tensor) and dst is not src:
            if _is_dtensor(dst):
                dst, src = dst._local_tensor, _local(src)
            dst.copy_(src)


def _clone(v):
    """A copy of a value's tensors (a graph's own output buffers)."""
    if isinstance(v, torch.Tensor):
        return v.clone()
    return pytree.tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, v)


def _storage(t):
    return _local(t).untyped_storage().data_ptr()


def _donatable(t):
    """Whether a state value can be donated: a plain tensor, or a
    DTensor (through its local tensor)."""
    return type(t) is torch.Tensor or (
        _is_dtensor(t) and type(_local(t)) is torch.Tensor)


def _donate_into(tgt, new):
    """Write `new` into donated `tgt`'s storage; whether it was written.
    A DTensor's new value is laid out as the old one first (inside a
    capture its collectives are captured)."""
    if _is_dtensor(tgt):
        if not _is_dtensor(new) or new.device_mesh != tgt.device_mesh:
            return False
        if tuple(new.placements) != tuple(tgt.placements):
            new = new.redistribute(tgt.device_mesh, tgt.placements)
        tgt, new = _local(tgt), _local(new)
    if not _fits(tgt, new):
        return False
    if _storage(new) == _storage(tgt):
        new = new.clone()
    tgt.copy_(new)
    return True


def _fits(target, new):
    """Whether `new` can be written into `target`'s storage: two plain
    tensors alike in shape, dtype and device, `target` writable here."""
    dtensor = op_registry.dtensor_type()
    return (type(target) is torch.Tensor and type(new) is torch.Tensor
            and (dtensor is None or not isinstance(target, dtensor))
            and target.shape == new.shape and target.dtype == new.dtype
            and target.device == new.device
            and (not target.is_inference()
                 or torch.is_inference_mode_enabled()))


# the format of the port's persistent-cache plan entries: in the key,
# so an entry an older port wrote is a miss
PCACHE_FORMAT = 1

# the flags the program key folds in (the JAX executor's _pcache_base)
_PCACHE_FLAGS = ("amp_bf16", "amp_bf16_act", "bn_shifted_stats",
                 "donation")

_SEG_KEYS = ("reads", "writes", "outputs", "persist_writes")

# the modules whose output a plan entry stores (the segment plan and
# _analyze here, the pass pipeline, the verifier's verdict, the donation
# analysis), relative to the package: their source is in the key, so an
# entry a fixed planner would not make is a miss
_PLANNER_SOURCES = ("fluid/executor.py", "compile", "analysis")
_planner_digest = None


def planner_digest():
    """A digest of the planning code's source (`_PLANNER_SOURCES`) and
    of the registry's capturable marks, computed once per process: the
    persistent cache's program key folds it in (`_pcache_base`)."""
    global _planner_digest
    if _planner_digest is None:
        import hashlib

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        files = []
        for rel in _PLANNER_SOURCES:
            path = os.path.join(root, rel)
            if os.path.isdir(path):
                files += sorted(os.path.join(path, f)
                                for f in os.listdir(path)
                                if f.endswith(".py"))
            else:
                files.append(path)
        h = hashlib.sha256()
        for path in files:
            h.update(os.path.relpath(path, root).encode())
            with open(path, "rb") as f:
                h.update(f.read())
        for t in op_registry.registered_ops():
            h.update(("%s=%d" % (t, op_registry.get_op_info(t)
                                 .capturable)).encode())
        _planner_digest = h.hexdigest()
    return _planner_digest


def _check_entry(entry, feed_names, fetch_names):
    """The desc a persistent-cache entry holds, parsed, once the entry
    passes the structural check: its format, feeds and fetches, and a
    plan whose segments cover block 0's ops in order with the op types
    they name.  Raises ValueError otherwise."""
    if entry.get("format") != PCACHE_FORMAT:
        raise ValueError("entry format %r" % entry.get("format"))
    if list(entry["feeds"]) != list(feed_names) \
            or list(entry["fetches"]) != list(fetch_names):
        raise ValueError("entry feeds or fetches differ")
    desc = ProgramDesc.parse_from_string(entry["desc"])
    ops = desc.block(0).ops
    start = 0
    for rec in entry["plan"]:
        n = int(rec["n"])
        if rec["start"] != start or [od.type for od in
                                     ops[start:start + n]] != rec["types"]:
            raise ValueError("segment %r names other ops than the desc"
                             % rec.get("label"))
        if bool(rec["capture"]) != all(_op_capturable(od) for od in
                                       ops[start:start + n]):
            raise ValueError("segment %r is planned for another registry"
                             % rec.get("label"))
        for k in _SEG_KEYS:
            if not isinstance(rec[k], list):
                raise ValueError("segment %r has no %s" % (rec["label"], k))
        start += n
    if start != len(ops):
        raise ValueError("the plan covers %d of %d ops" % (start, len(ops)))
    dn = entry["donation"]
    if dn["mode"] not in ("auto", "conservative", "off"):
        raise ValueError("donation mode %r" % dn["mode"])
    return desc


def _plan_from_entry(block, entry):
    """The executor's segment plan rebuilt from a checked entry."""
    plan = []
    for rec in entry["plan"]:
        start, n = int(rec["start"]), int(rec["n"])
        seg = {"capture": bool(rec["capture"]),
               "ops": block.ops[start:start + n], "start": start,
               "label": rec["label"]}
        for k in _SEG_KEYS:
            seg[k] = list(rec[k])
        plan.append(seg)
    return plan


class _CompiledProgram:
    """A program as the executor runs it: block 0 split into maximal
    runs of capturable ops (segments) and host ops between them, each
    segment's reads, writes and outputs, and its donation.  The
    counterpart of the JAX executor's `_CompiledProgram`; its captured
    segments are CUDA graphs, one per (segment, signature), in one
    memory pool per program.  A signature is the segment's inputs'
    shapes, dtypes and structure (a ragged feed's `max_seqlen`), and the
    address of every state tensor the graph reads in place from the
    scope: a tensor swapped into the scope forces a new capture.

    `donation="off"` donates nothing whatever FLAGS_donation says (a
    mesh step made with `donate_state=False`).  `seams` {op index in
    block 0: fn(values)} runs fn on the run's values just before that op,
    in a capture too: the bucketed dp step's gradient reduction
    (spmd/overlap.py)."""

    def __init__(self, executor, desc, feed_names, fetch_names, entry=None,
                 donation=None, seams=None):
        self.executor = executor
        self._donation_override = donation
        self.seams = dict(seams or {})
        self.desc = desc
        self.block = desc.block(0)
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        # host seconds of planning and capturing: what a persistent
        # cache hit refunds ("verify", "passes", "plan", "donation") and
        # what it cannot ("capture")
        self.seconds = {}
        # the program's persistent-cache key (compile/pcache.py) and how
        # the plan was acquired: "hit", "miss" or None (the cache off)
        self.pcache_key = None
        self.acquired = None
        if entry is None:
            t0 = time.perf_counter()
            self.segments = _segment_block(self.block.ops)
            self._plan = self._analyze()
            t1 = time.perf_counter()
            self._donation = self._donation_setup()
            self.seconds = {"plan": t1 - t0,
                            "donation": time.perf_counter() - t1}
        else:
            # a reloaded plan, its op types checked (`_check_entry`)
            self._plan = _plan_from_entry(self.block, entry)
            self.segments = [(seg["capture"], seg["ops"])
                             for seg in self._plan]
            widened = entry["donation"]["widened"]
            self._donation = {
                "mode": entry["donation"]["mode"],
                "widened": None if widened is None
                else [tuple(w) for w in widened]}
        for i, seg in enumerate(self._plan):
            seg["mutated"], seg["donate"], seg["widened"] = \
                self._donate_sets(i, seg)
        self._release_plan()
        persist = any(seg["persist_writes"] for seg in self._plan)
        self.trains = persist or any(
            op_registry.is_grad_op_type(od.type) for od in self.block.ops)
        # (segment, signature) -> captured record, least recent first
        self._records = OrderedDict()
        # (segment, signature) pairs warmed up once, eagerly -> the
        # donated names another value of the warmup viewed
        self._warm = OrderedDict()
        self.pool = None
        # the bytes this program's live graphs' pool grew by
        self.pool_bytes = 0
        # obs.mem's label for the whole program's row, when registered
        self.mem_label = None
        self._register_static()

    def to_entry(self):
        """The plan and donation plan as a persistent-cache entry
        holds them (JSON): each segment by its op range and op types."""
        plan = []
        for seg in self._plan:
            plan.append({
                "capture": bool(seg["capture"]), "start": seg["start"],
                "n": len(seg["ops"]),
                "types": [od.type for od in seg["ops"]],
                "reads": list(seg["reads"]), "writes": list(seg["writes"]),
                "outputs": list(seg["outputs"]),
                "persist_writes": list(seg["persist_writes"]),
                "label": seg["label"]})
        widened = self._donation["widened"]
        return {"plan": plan,
                "donation": {"mode": self._donation["mode"],
                             "widened": None if widened is None
                             else [list(w) for w in widened]}}

    def _register_static(self):
        """obs.mem's static side, at plan time under attribution (as the
        JAX executor registers it at a segment's first build under the
        same gate): each captured segment's activation peak and the whole
        program's.  A liveness walk over a program's ops costs tenths of
        a host second for ResNet-50, so it is not paid by every plan."""
        from ..obs import health as obs_health
        from ..obs import mem as obs_mem

        if not obs_health.attribution_wanted():
            return
        captured = [seg for seg in self._plan if seg["capture"]]
        if not captured:
            return
        t0 = time.perf_counter()
        try:
            for seg in captured:
                obs_mem.register_segment_static(
                    seg["label"], seg["ops"], seg["outputs"], self.block)
            label = self._program_label()
            final = {n for n, vd in self.block.vars.items()
                     if vd.persistable} | set(self.fetch_names)
            obs_mem.register_segment_static(label, self.block.ops, final,
                                            self.block)
            self.mem_label = label
        except Exception:
            _log.debug("static memory registration failed", exc_info=True)
        self.seconds["mem"] = time.perf_counter() - t0

    # -- planning -----------------------------------------------------------
    def _analyze(self):
        """Each segment's reads (first read before any write, in order),
        writes, outputs (writes read later, fetched or persistable) and
        persistable writes, as the JAX executor's `_analyze`."""
        bd = self.block
        later_reads = [set(self.fetch_names)]
        for _, ops in reversed(self.segments):
            reads = set()
            for od in ops:
                reads.update(od.input_names())
            later_reads.append(later_reads[-1] | reads)
        later_reads = list(reversed(later_reads))
        plan, base = [], 0
        for i, (capture, ops) in enumerate(self.segments):
            reads, writes, seen = [], [], set()
            for od in ops:
                for n in od.input_names():
                    if n != EMPTY and n not in seen and n not in reads:
                        reads.append(n)
                for n in od.output_names():
                    if n != EMPTY:
                        seen.add(n)
                        if n not in writes:
                            writes.append(n)
            persist_writes = [n for n in writes if n in bd.vars
                              and bd.vars[n].persistable]
            outputs = [n for n in writes
                       if n in later_reads[i + 1] or n in persist_writes]
            types = [od.type for od in ops]
            span = types[0] if len(types) == 1 else "%s..%s" % (
                types[0], types[-1])
            plan.append({"capture": capture, "ops": ops, "start": base,
                         "reads": reads, "writes": writes,
                         "outputs": outputs, "persist_writes": persist_writes,
                         "label": "jit_segment[%d:%s x%d]" % (i, span,
                                                              len(types))})
            base += len(ops)
        return plan

    def _release_plan(self):
        """Each segment's releases, seg["release"] = {op index in the
        segment: the names dead after it}, by the Liveness of block 0:
        a name leaves after the last op that reads it (or after the op
        that writes it, when nothing reads it).  The kept names never
        leave: the fetches, the persistables, and the names another
        block or a string attr references (a sub-block reads the outer
        names by name)."""
        from ..analysis.dataflow import (Liveness, _attr_name_refs,
                                         _block_sub_reads)

        bd = self.block
        keep = set(self.fetch_names)
        keep.update(n for n, vd in bd.vars.items() if vd.persistable)
        keep |= _block_sub_reads(self.desc, 0)
        for od in bd.ops:
            keep |= _attr_name_refs(od)
        lv = Liveness(bd.ops).analyze()
        for seg in self._plan:
            release = {}
            for k in range(len(seg["ops"])):
                g = seg["start"] + k
                dead = (lv.live_in[g] | lv.defs[g]) - lv.live_out[g] - keep
                if dead:
                    release[k] = tuple(sorted(dead))
            seg["release"] = release

    def _donation_setup(self):
        """FLAGS_donation resolved as the JAX executor resolves it:
        {"mode", "widened": [names per segment] or None}.  Only "auto"
        runs the donation-safety analysis (analysis/alias.py); a failure
        of the analysis degrades to "conservative", since the plan must
        never be the reason a step fails.  The backend's verdict is the
        persistent cache's (`pcache.donation_aliasing_safe`): a reloaded
        plan is captured anew with its donation, so it is safe."""
        from .. import analysis
        from ..compile import pcache as pcache_mod

        mode = self._donation_override or analysis.donation_mode()
        if mode != "auto":
            return {"mode": mode, "widened": None}
        try:
            plan = analysis.analyze_donation(
                self.desc, fetches=self.fetch_names, feeds=self.feed_names,
                backend_safe=pcache_mod.donation_aliasing_safe())
            if plan.effective_mode != "auto":
                return {"mode": plan.effective_mode, "widened": None}
            return {"mode": "auto",
                    "widened": [tuple(s["widened"]) for s in plan.segments]}
        except Exception:
            _log.debug("donation analysis failed; falling back to "
                       "conservative donation", exc_info=True)
            return {"mode": "conservative", "widened": None}

    def _donate_sets(self, i, seg):
        """(mutated, donated, widened) of segment i: the outputs it also
        reads; what it donates under the mode (the JAX executor's
        `mutated`: conservative's set, plus under "auto" the plan's
        widened reads); and those widened reads alone."""
        if not seg["capture"]:
            return (), (), ()
        mutated = tuple(n for n in seg["outputs"] if n in seg["reads"])
        dn = self._donation
        if dn["mode"] == "off":
            return mutated, (), ()
        widened = ()
        if dn["mode"] == "auto" and dn["widened"] \
                and i < len(dn["widened"]):
            widened = tuple(n for n in dn["widened"][i]
                            if n not in mutated and n in seg["reads"])
        return mutated, mutated + widened, widened

    def labels(self):
        return [seg["label"] for seg in self._plan]

    def _program_label(self):
        """obs.mem's label for the whole program's row."""
        from ..obs import mem as obs_mem

        ops = self.block.ops
        return "%s%s..%s x%d]" % (obs_mem.PROGRAM_PREFIX, ops[0].type,
                                  ops[-1].type, len(ops))

    def mem_labels(self):
        """The labels obs.mem may hold for this program: its captured
        segments' and its own row's."""
        labels = [seg["label"] for seg in self._plan if seg["capture"]]
        return labels + [self._program_label()] if labels else []

    # -- running ------------------------------------------------------------
    def run(self, ctx, scope, eager):
        """Run block 0 against ctx.env (the feeds), writing persistables
        back to the scope after each segment; returns the names whose
        values are a graph's own output buffers (a later replay
        overwrites them)."""
        check = flags.get_flag("check_nan_inf")
        reason = "eager" if eager else "check_nan_inf" if check else None
        if reason is not None and self._records:
            # an eager run and the program's graphs would each hold a
            # step's memory at once: the graphs go (captured again when
            # the program runs captured twice more)
            for key in list(self._records):
                self.drop_graph(key)
            if self.executor.device.type == "cuda":
                torch.cuda.empty_cache()
        graph_owned = set()
        for i, seg in enumerate(self._plan):
            if seg["capture"] and reason is None:
                ins = {n: _lookup(ctx, n) for n in seg["reads"]}
                self._run_captured(i, seg, ctx, ins, scope, graph_owned)
                # the values whose last reader ran; a graph's own
                # outputs stay (its pool holds them)
                for names in seg["release"].values():
                    for n in names:
                        if n not in graph_owned:
                            ctx.env.pop(n, None)
                continue
            if seg["capture"]:
                obs_tele.on_eager_segment(reason)
            self._run_eager(seg, ctx, check)
            for n in seg["persist_writes"]:
                if n in ctx.env:
                    scope.set(n, ctx.env[n])
        return graph_owned

    def _run_eager(self, seg, ctx, check):
        """Op by op from Python: a `record_event` row per op while the
        profiler or the trace is on, an `op_registry.span` range per op
        while torch.profiler records, the FLAGS_check_nan_inf scan.
        Nothing is donated.  Each value leaves the run's values after
        its last reader."""
        timed = profiler_mod.active()
        release = seg["release"]
        for k, op_desc in enumerate(seg["ops"]):
            seam = self.seams.get(seg["start"] + k)
            if seam is not None:
                seam(ctx.env)
            with op_registry.span(op_desc.type):
                if timed:
                    with profiler_mod.record_event(op_desc.type):
                        outs = apply_op(ctx, op_desc)
                else:
                    outs = apply_op(ctx, op_desc)
            if check:
                try:
                    _check_outputs_finite(op_desc, outs)
                except NonfiniteError as err:
                    err.op_index = seg["start"] + k
                    raise
            for n in release.get(k, ()):
                ctx.env.pop(n, None)

    def _signature(self, seg, ins, env):
        """(signature, the names read in place from the scope)."""
        off = self._donation["mode"] == "off"
        in_place = set()
        key = []
        for n in seg["reads"]:
            v = ins[n]
            by_address = n not in env and not (off and n in seg["mutated"])
            if by_address:
                in_place.add(n)
            key.append(_value_key(v, by_address))
        return tuple(key), in_place

    def _runner(self, seg, ctx, donate_state, in_place_ops):
        """The segment as a function of its input env: its ops, each
        value released after its last reader in the segment (but the
        segment's outputs and the donated targets), then each donated
        state tensor's new value written into the scope tensor's own
        storage (what a CUDA graph capture records).  `in_place_ops`
        {op index: slots} lets an update op write into its input
        (ExecContext.in_place).  `run(env_in, aliased)` adds to the set
        `aliased` the donated names another value of the run viewed (the
        warm-up's finding)."""
        from . import graphs

        ops, outputs = seg["ops"], seg["outputs"]
        release = seg["release"]
        hold = set(outputs) | set(donate_state)
        seams = self.seams
        executor = self.executor

        def run(env_in, aliased=None):
            env = dict(env_in)
            sub = ExecContext(self.desc, 0, env, scope=ctx.scope,
                              place=executor.place, device=executor.device,
                              rng=ctx._rng)
            targets = {_storage(env_in[n]): n for n in donate_state}
            for k, od in enumerate(ops):
                sub.in_place = in_place_ops.get(k, frozenset())
                seam = seams.get(seg["start"] + k)
                try:
                    if seam is not None:
                        seam(env)
                    outs_k = apply_op(sub, od)
                except graphs.CaptureError as exc:
                    raise graphs.CaptureError(
                        "op %d (%r): %s" % (seg["start"] + k, od.type,
                                            exc)) from exc
                if aliased is not None and targets:
                    for slot, names in od.outputs.items():
                        for name, v in zip(names, outs_k.get(slot) or ()):
                            if _donatable(v) and v is not env_in.get(name) \
                                    and _storage(v) in targets:
                                aliased.add(targets[_storage(v)])
                for n in release.get(k, ()):
                    if n not in hold:
                        env.pop(n, None)
            sub.in_place = frozenset()
            outs = {n: _settle_value(env[n]) for n in outputs if n in env}
            if targets:
                # an output that views a donated tensor keeps its value
                for n, v in outs.items():
                    if n not in donate_state and _donatable(v) \
                            and _storage(v) in targets:
                        outs[n] = _clone(v)
                for n in donate_state:
                    tgt, new = env_in[n], env.get(n)
                    if new is None or new is tgt:
                        continue
                    if _donate_into(tgt, new) and n in outs:
                        outs[n] = tgt
            return outs

        return run

    def _in_place_ops(self, seg, donate_state, aliased):
        """{op index: output slots} of the update ops that may write a
        donated state tensor in place: the op is the tensor's first
        writer in the segment, its declared in-place slot names the same
        var as the aliased input, and no other value of the warmup
        shared the tensor's storage (`aliased`)."""
        from ..analysis.dataflow import _in_place_pairs

        plan, written = {}, set()
        for k, od in enumerate(seg["ops"]):
            slots = set()
            for out_slot, in_slot in _in_place_pairs(od):
                outs = od.outputs.get(out_slot) or ()
                ins = od.inputs.get(in_slot) or () if in_slot else ()
                if len(outs) == 1 and len(ins) == 1 and outs[0] == ins[0] \
                        and outs[0] in donate_state \
                        and outs[0] not in aliased \
                        and outs[0] not in written:
                    slots.add(out_slot)
            if slots:
                plan[k] = frozenset(slots)
            written.update(od.output_names())
        return plan

    def drop_graph(self, key):
        """Drop the captured record of `key` ((segment, signature)),
        counted and logged as an eviction: its next run warms up again
        (the executor's LRU bound, or the graph pools' budget,
        fluid/graphs.py)."""
        from . import graphs

        if self._records.pop(key, None) is None:
            return
        if not self._records:
            # a pool whose graphs are all gone is released: the next
            # capture takes a new one
            self.pool = None
            self.pool_bytes = 0
        graphs.release(self, key)
        obs_tele.on_program_cache_evict()
        _log.debug("evicted captured signature of %s",
                    self._plan[key[0]]["label"])

    def _run_captured(self, i, seg, ctx, ins, scope, graph_owned):
        from . import graphs

        executor = self.executor
        env = ctx.env
        sig, by_address = self._signature(seg, ins, env)
        # the random stream a graph draws from is the one registered at
        # its capture (the record keeps it alive, so its id is not reused)
        key = (i, id(ctx._rng), sig)
        donate_state = tuple(n for n in seg["donate"] if n in by_address
                             and _donatable(ins[n]))
        rec = self._records.get(key)
        if rec is not None:
            self._records.move_to_end(key)
            graphs.touch(self, key)
            outs = self._replay(rec, seg, ins)
        elif key not in self._warm:
            # first run of this signature: the warmup, eagerly, with the
            # donation a replay makes; it finds which donated tensors
            # another value views, which must not be written early
            while len(self._warm) >= 4 * executor._CACHE_MAX:
                self._warm.popitem(last=False)
            run = self._runner(seg, ctx, donate_state, {})
            aliased = set()
            outs = run(ins, aliased=aliased)
            self._warm[key] = aliased
        else:
            # a capture that fails stays due: the next run of this
            # signature captures (and raises) again, never warming up
            # eagerly in its place
            rec = self._capture(i, seg, ctx, ins, by_address, donate_state,
                                self._warm[key])
            self._warm.pop(key, None)
            self._records[key] = rec
            while len(self._records) > executor._CACHE_MAX:
                self.drop_graph(next(iter(self._records)))
            if rec["graph"] is not None:
                graphs.hold(self, key, executor.device,
                            rec["stats"]["pool_bytes"])
            # on the card the capture ran nothing; on the CPU it ran once
            outs = dict(rec["out"]) if rec["graph"] is None else \
                self._replay(rec, seg, ins)
        # a graph's outputs (on the CPU, its plain version's, which may
        # view the static buffers) are overwritten by the next replay
        if rec is not None:
            graph_owned.update(n for n, v in outs.items()
                               if not (n in donate_state and v is ins[n]))
        env.update(outs)
        for n in seg["persist_writes"]:
            v = outs.get(n)
            if v is None or v is scope.get(n):
                continue
            if n in graph_owned:
                # a replay would overwrite the graph's own buffer
                v = env[n] = _clone(v)
                graph_owned.discard(n)
            scope.set(n, v)
        for n in seg["widened"]:
            # provably dead after this segment: given up
            env.pop(n, None)

    def _capture(self, i, seg, ctx, ins, by_address, donate_state, aliased):
        """Capture segment i for this signature: static buffers for the
        inputs that are copied in (feeds, earlier segments' values, and
        under FLAGS_donation=off the state a segment updates), the scope
        tensors read in place, the executor's random stream registered
        with the graph, and the flash kernel's launches recorded."""
        from . import graphs

        from ..obs import health as obs_health

        executor = self.executor
        label = seg["label"]
        env_in = {n: (v if n in by_address else _clone(v))
                  for n, v in ins.items()}
        # a DTensor's update op writes a new value, donated afterwards
        in_place_ops = self._in_place_ops(
            seg, [n for n in donate_state if type(ins[n]) is torch.Tensor],
            aliased)
        run = self._runner(seg, ctx, donate_state, in_place_ops)
        device = executor.device
        first = self.pool is None
        if device.type == "cuda" and first:
            self.pool = torch.cuda.graph_pool_handle()
        gens = (ctx._rng,) if ctx._rng is not None \
            and ctx._rng.device.type == "cuda" else ()
        obs_trace.instant("jit_build", cat="compile", segment=label)
        try:
            graph, out, stats = graphs.graph_capture(
                lambda: run(env_in), device, pool=self.pool,
                generators=gens, label=label)
        except graphs.CaptureError as exc:
            raise graphs.CaptureError(
                "%s (first op %r): %s" % (label, seg["ops"][0].type,
                                          exc)) from exc
        executor.captures += 1
        self.seconds["capture"] = self.seconds.get("capture", 0.0) \
            + stats["seconds"]
        if graph is not None:
            graphs.count_capture(label, dict(stats, first_in_pool=first))
            self.pool_bytes += int(stats["pool_bytes"])
            executor.captured_pool_bytes += int(stats["pool_bytes"])
            if self.mem_label is not None:
                from ..obs import mem as obs_mem

                obs_mem.on_compile_captured(
                    self.mem_label, {"graph_pool_bytes": self.pool_bytes})
        elif obs_health.attribution_wanted():
            # the plain version on the CPU: its seconds; no pool
            obs_health.publish_compile_stats(
                label, {"seconds": stats["seconds"]})
        self._store_stub(i, seg, ins, stats)
        return {"graph": graph, "env_in": env_in, "out": out, "run": run,
                "rng": ctx._rng, "by_address": by_address, "stats": stats,
                "in_place": in_place_ops}

    def _store_stub(self, i, seg, ins, stats):
        """A capture's stub entry in the persistent cache, keyed as the
        JAX executor keys a segment's executable (the program key, the
        segment, its outputs and mutated set, the inputs' shapes and
        dtypes): it records the capture's seconds and pool bytes, and a
        load of it is a miss.  The cache is never why a step fails."""
        if self.pcache_key is None:
            return
        from ..compile import fingerprint as fp_mod
        from ..compile import pcache as pcache_mod

        try:
            cache = pcache_mod.get_cache()
            if cache is None:
                return
            sig = repr(tuple((n, _value_key(ins[n], False))
                             for n in seg["reads"]))
            key = fp_mod.combine(self.pcache_key, "seg%d" % i,
                                 ",".join(seg["outputs"]),
                                 ",".join(seg["mutated"]), sig)
            cache.put(key, None, compile_seconds=stats["seconds"],
                      meta={"segment": seg["label"],
                            "ops": len(seg["ops"]),
                            "pool_bytes": int(stats["pool_bytes"])})
        except Exception as exc:
            _log.warning("persistent cache stub for %s not stored (%r)",
                         seg["label"], exc)
            pcache_mod._errors("stub").inc()

    def _replay(self, rec, seg, ins):
        from . import graphs

        executor = self.executor
        env_in = rec["env_in"]
        for n, v in ins.items():
            if n not in rec["by_address"]:
                _copy_into(env_in[n], v)
        executor.replays += 1
        profiled = profiler_mod.is_enabled()
        t0 = time.perf_counter()
        if rec["graph"] is None:
            outs = rec["run"]({n: (ins[n] if n in rec["by_address"]
                                   else env_in[n]) for n in ins})
        else:
            rec["graph"].replay()
            graphs.add_launches(rec["stats"]["launches"])
            obs_tele.on_graph_replay()
            outs = rec["out"]
        if profiled:
            if executor.device.type == "cuda":
                torch.cuda.synchronize(executor.device)
            profiler_mod.record(seg["label"], time.perf_counter() - t0)
        return dict(outs)


class Executor:
    """reference: python/paddle/v2/fluid/executor.py Executor.

    Random ops without a `seed` attr draw from a random stream.  By
    default it lives in the scope, as on the JAX side: the first program
    run in a scope seeds it from its `random_seed` (0 for a bare
    ProgramDesc), and later runs in that scope go on drawing from it.
    `seed` gives the executor a stream of its own instead, seeded with
    it and shared by every scope it runs in.

    `captures` and `replays` count the segment captures and replays
    this executor made (on the CPU, the plain version's)."""

    # compiled programs kept, and captured signatures per program (the
    # JAX executor's cache bound)
    _CACHE_MAX = 64

    def __init__(self, place=None, seed=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.device()
        self.rng = None if seed is None else \
            torch.Generator(device=self.device).manual_seed(seed)
        self._verified = set()
        # (id(desc), fetches, spec, amp flags) -> (desc, version, clone)
        self._optimized = OrderedDict()
        # the rewrite pipeline's runs, and the last run's PassManager
        self.pipeline_runs = 0
        self.last_pipeline = None
        # (id(desc), feeds, fetches, flags) -> (desc, version, compiled)
        self._cache = OrderedDict()
        # captures and the serving batcher's thread share the executor
        self._lock = threading.RLock()
        self.captures = 0
        self.replays = 0
        # the graph pool bytes this executor's captures added, summed
        # (a dropped graph does not take its bytes off)
        self.captured_pool_bytes = 0

    def _stream(self, scope, seed):
        """The random stream of a run in `scope`: the executor's own, or
        the scope's, made from `seed` at its first run on this device."""
        if self.rng is not None:
            return self.rng
        gen = scope.get(RNG_STATE_NAME)
        if gen is None or gen.device != self.device:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            scope.set(RNG_STATE_NAME, gen)
        return gen

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True, eager=False):
        """Run block 0 of `program` (a Program, its ProgramDesc, or None
        for the default main program) with `feed` {name: array or
        tensor, a RaggedTensor for a var with a lod level, or a
        SelectedRows}; returns the values of `fetch_list` (Variables or
        names), as numpy arrays (a ragged or SelectedRows value on the
        host) or, with return_numpy=False, as they are on the place's
        device.  A SelectedRows grad lives in the run's values between
        the grad op that makes it and the update op that reads it.

        By default the maximal runs of capturable ops run as captured
        CUDA graphs (see the module docstring).  `eager=True` runs every
        op eagerly from Python, donating nothing: the per-op profiler
        rows and op-type ranges and the old numerics; so does a run
        under FLAGS_check_nan_inf.

        `feed_var_name` and `fetch_var_name` are the JAX signature's and
        change nothing.  `use_program_cache=False` plans and runs the
        program without entering the executor's caches or the
        persistent one (compile/pcache.py).  Under
        FLAGS_compile_cache_dir a program planned once, in this process
        or an earlier one, is reloaded from disk: no verifier, pass
        pipeline or donation analysis runs (see `_acquire`)."""
        if program is None:
            program = default_main_program()
        source = program
        seed = 0
        if isinstance(program, Program):
            seed = program.random_seed or 0
            program = program.desc
        if not isinstance(program, ProgramDesc):
            raise TypeError("Executor.run needs a Program or ProgramDesc, "
                            "got %r" % type(program).__name__)
        fetch_list = [v.name if isinstance(v, Variable) else v
                      for v in fetch_list or ()]
        scope = scope if scope is not None else global_scope()
        obs_tele.on_executor_run()
        # chaos hook: an injected IOError or latency on the run's
        # dispatch (one None check when no fault plan is active)
        faults_mod.check("executor/run")
        try:
            with obs_trace.span("executor/run", cat="executor",
                                feeds=len(feed or {}),
                                fetches=len(fetch_list)), self._lock:
                compiled = self._prepare(source, program,
                                         list(feed or ()), fetch_list,
                                         use_program_cache)
                return self._run(compiled, seed, feed, fetch_list, scope,
                                 return_numpy, eager)
        except Exception as exc:
            # a crashing run leaves a post-mortem bundle (a no-op unless
            # obs.flight.install() was called); an OOM-class failure (a
            # CUDA out of memory, the FLAGS_mem_budget_gb pre-flight)
            # also carries the static timeline's top blamed buffers and
            # the last mem_* gauges (obs/mem.py; {} for anything else)
            from ..obs import mem as obs_mem

            obs_flight.on_crash(exc, origin="executor/run",
                                feeds=obs_flight.describe_feeds(feed),
                                fetches=list(fetch_list), eager=bool(eager),
                                **obs_mem.oom_context(exc, program,
                                                      fetch_list))
            raise

    def _prepare(self, source, desc, feed_names, fetch_names,
                 use_program_cache):
        """The _CompiledProgram a run of `desc` executes: planned anew
        without the caches (`use_program_cache=False`), acquired through
        the persistent cache under FLAGS_compile_cache_dir, else from
        the executor's own caches."""
        if not use_program_cache:
            program = self._program_to_run(source, desc, fetch_names,
                                           cached=False)
            return self._new_compiled(program, sorted(feed_names),
                                      fetch_names)
        from ..compile import pcache as pcache_mod

        if pcache_mod.enabled():
            return self._acquire(source, desc, feed_names, fetch_names)
        program = self._program_to_run(source, desc, fetch_names)
        return self._compiled(program, feed_names, fetch_names)

    def _new_compiled(self, desc, feed_names, fetch_names, entry=None,
                      **kw):
        """A new _CompiledProgram of `desc`, after the FLAGS_mem_budget_gb
        pre-flight (obs/mem.py), which refuses a program whose static
        peak exceeds the budget before its first eager run or
        capture."""
        budget = flags.get_flag("mem_budget_gb")
        if budget:
            from ..obs import mem as obs_mem

            obs_mem.preflight(desc, fetch_names, budget)
        return _CompiledProgram(self, desc, feed_names, fetch_names,
                                entry=entry, **kw)

    def _pcache_base(self, desc, feed_names, fetch_names):
        """The persistent cache's program key (the JAX executor's
        `_pcache_base`): the canonical IR with the feed and fetch
        names, the flags that change what runs, the rewrite pipeline's
        id, the stack (`environment_fingerprint`), the port's entry
        format, the planning code (`planner_digest`) and the place's
        device type."""
        from ..compile import fingerprint as fp_mod
        from ..compile import passes as passes_mod

        prog_fp = fp_mod.program_fingerprint(
            desc, feeds=feed_names, fetches=fetch_names,
            flag_items=[(k, flags.get_flag(k)) for k in _PCACHE_FLAGS],
            pipeline_id=passes_mod.pipeline_id(
                flags.get_flag("compile_passes")))
        return fp_mod.combine(prog_fp, fp_mod.environment_fingerprint(),
                              "port-plan-v%d" % PCACHE_FORMAT,
                              planner_digest(), self.device.type)

    def _acquire(self, source, desc, feed_names, fetch_names):
        """The JAX executor's `_aot_acquire` for a program: the
        _CompiledProgram of `desc` from this executor's cache, else its
        plan loaded from the persistent cache (a hit runs no verifier,
        no pass pipeline and no donation analysis), else planned and
        stored (a miss).  An entry that fails to parse or whose desc
        fails the structural check (`_check_entry`, run inside the
        cache's load) is quarantined and counted as an error and a miss
        (`compile_cache_errors_total{kind="acquire"}`), and the run plans
        as on a miss: the cache is never why a step fails."""
        from ..compile import pcache as pcache_mod

        feeds = sorted(feed_names)
        key = self._cache_key(desc, feeds, fetch_names) + (
            "pcache", flags.get_flag("compile_passes"),
            flags.get_flag("verify_program"),
            flags.get_flag("compile_cache_dir"))
        version = _desc_version(desc)
        hit = self._cache_hit(key, desc, version)
        if hit is not None:
            return hit
        cache = pcache_mod.get_cache()
        base = self._pcache_base(desc, feeds, fetch_names)
        verify = flags.get_flag("verify_program")
        t0 = time.perf_counter()
        checked = {}

        def check(loaded):
            checked["desc"] = _check_entry(loaded, feeds, fetch_names)

        # a hit is counted only for an entry that passes the check
        entry = cache.get(base, check=check)
        if entry is not None:
            run_desc = checked["desc"]
            load_s = time.perf_counter() - t0
            seconds = {}
            if verify and not entry.get("verified"):
                t1 = time.perf_counter()
                self._verify_program(source, version, fetch_names)
                seconds["verify"] = time.perf_counter() - t1
            compiled = self._new_compiled(run_desc, feeds, fetch_names,
                                          entry=entry)
            compiled.acquired = "hit"
            compiled.seconds.update(seconds, load=load_s)
            obs_trace.instant("pcache_hit", cat="compile",
                              program=base[:12])
            if seconds:
                entry["verified"] = True
                self._store_plan(cache, base, entry, compiled)
        else:
            seconds = {}
            run_desc = self._program_to_run(source, desc, fetch_names,
                                            seconds=seconds)
            compiled = self._new_compiled(run_desc, feeds, fetch_names)
            compiled.acquired = "miss"
            compiled.seconds.update(seconds)
            entry = dict(compiled.to_entry(), format=PCACHE_FORMAT,
                         feeds=feeds, fetches=list(fetch_names),
                         verified=bool(verify))
            try:
                entry["desc"] = run_desc.serialize_to_string()
            except Exception as exc:
                _log.warning("program %s does not serialize (%r); not "
                             "stored", base[:12], exc)
                pcache_mod._errors("serialize").inc()
            else:
                self._store_plan(cache, base, entry, compiled)
        compiled.pcache_key = base
        self._cache_insert(key, desc, version, compiled)
        return compiled

    @staticmethod
    def _store_plan(cache, base, entry, compiled):
        secs = {k: v for k, v in compiled.seconds.items()
                if k in ("verify", "passes", "plan", "donation")}
        try:
            cache.put(base, entry, compile_seconds=sum(secs.values()),
                      meta={"ops": len(compiled.block.ops),
                            "segments": len(compiled.labels()),
                            "seconds": {k: round(v, 6)
                                        for k, v in secs.items()}})
        except Exception as exc:
            from ..compile import pcache as pcache_mod

            _log.warning("persistent cache entry %s not stored (%r)",
                         base[:12], exc)
            pcache_mod._errors("store").inc()

    def _program_to_run(self, source, desc, fetch_names, cached=True,
                        seconds=None):
        """The ProgramDesc a run of `desc` executes: `desc` itself, or
        under FLAGS_compile_passes its rewritten clone (kept for later
        runs unless `cached` is False); verified first under
        FLAGS_verify_program.  `source` is what the caller passed (a
        Program carries its random_seed, which lint L003 reads).
        `seconds` (a dict) takes the verifier's and the pipeline's host
        seconds."""
        verify = flags.get_flag("verify_program")
        spec = flags.get_flag("compile_passes")
        seconds = {} if seconds is None else seconds
        if not verify and not spec:
            return desc
        version = _desc_version(desc)
        if verify:
            t0 = time.perf_counter()
            self._verify_program(source, version, fetch_names)
            seconds["verify"] = time.perf_counter() - t0
        if not spec:
            return desc
        key = (id(desc), tuple(fetch_names), spec,
               flags.get_flag("amp_bf16"), flags.get_flag("amp_bf16_act"))
        hit = self._optimized.get(key) if cached else None
        if hit is not None and hit[0] is desc and hit[1] == version:
            self._optimized.move_to_end(key)
            return hit[2]
        from ..compile import passes as passes_mod

        t0 = time.perf_counter()
        optimized, pm = passes_mod.optimize_program(
            desc, spec, fetches=list(fetch_names))
        seconds["passes"] = time.perf_counter() - t0
        self.pipeline_runs += 1
        self.last_pipeline = pm
        if cached:
            self._optimized[key] = (desc, version, optimized.desc)
            self._optimized.move_to_end(key)
            if len(self._optimized) > self._CACHE_MAX:
                self._optimized.popitem(last=False)
        return optimized.desc

    def _verify_program(self, source, version, fetch_names):
        """FLAGS_verify_program: the full analysis, once per (program,
        version); a clean verdict is remembered, so later runs pay one
        set lookup."""
        if version in self._verified:
            return
        from .. import analysis

        analysis.check_program(
            source, level="full", fetches=list(fetch_names),
            origin="executor").raise_on_error()
        self._verified.add(version)
        if len(self._verified) > 4 * self._CACHE_MAX:
            self._verified.clear()  # rare: unbounded program churn

    @staticmethod
    def _cache_key(desc, feed_names, fetch_names):
        return (id(desc), tuple(sorted(feed_names)), tuple(fetch_names),
                flags.get_flag("amp_bf16"), flags.get_flag("amp_bf16_act"),
                flags.get_flag("bn_shifted_stats"), flags.get_flag("donation"))

    def _cache_hit(self, key, desc, version):
        hit = self._cache.get(key)
        if hit is not None and hit[0] is desc and hit[1] == version:
            self._cache.move_to_end(key)
            return hit[2]
        return None

    def _cache_insert(self, key, desc, version, compiled):
        """Keep `compiled`; the least recently used of more than
        _CACHE_MAX is evicted (counted and logged, as on the JAX side),
        its gauges retired."""
        self._cache[key] = (desc, version, compiled)
        self._cache.move_to_end(key)
        while len(self._cache) > self._CACHE_MAX:
            ekey, (_d, _v, evicted) = self._cache.popitem(last=False)
            obs_tele.on_program_cache_evict()
            self._retire_segment_gauges(evicted)
            _log.debug("evicted program cache entry: program=%s feeds=%s "
                       "fetches=%s", ekey[0], ekey[1], ekey[2])

    def _compiled(self, desc, feed_names, fetch_names):
        """The cached _CompiledProgram of `desc` for these feeds and
        fetches under the flags its kernels read, planned anew when the
        program changed."""
        key = self._cache_key(desc, feed_names, fetch_names)
        version = _desc_version(desc)
        hit = self._cache_hit(key, desc, version)
        if hit is not None:
            return hit
        compiled = self._new_compiled(desc, sorted(feed_names), fetch_names)
        self._cache_insert(key, desc, version, compiled)
        return compiled

    def _retire_segment_gauges(self, evicted):
        """Drop the evicted program's per-segment gauges (obs.health's
        and obs.mem's), but for labels a still-cached program shares:
        labels do not depend on shapes, so a structurally identical
        program that stays would never publish them again."""
        from ..obs import health as obs_health
        from ..obs import mem as obs_mem

        labels = set(evicted.labels())
        mem_labels = set(evicted.mem_labels())
        for _d, _v, other in self._cache.values():
            labels.difference_update(other.labels())
            mem_labels.difference_update(other.mem_labels())
        if labels:
            obs_health.retire_compile_stats(labels)
        if mem_labels:
            obs_mem.retire_segments(mem_labels)

    def _run(self, compiled, seed, feed, fetch_list, scope, return_numpy,
             eager):
        program = compiled.desc
        with torch.no_grad() if compiled.trains else \
                torch.inference_mode():
            t_feed = time.perf_counter()
            env = {name: prepare_feed(program.block(0), name, val,
                                      self.device)
                   for name, val in (feed or {}).items()}
            if feed:
                obs_tele.on_feed_seconds(time.perf_counter() - t_feed)
            ctx = ExecContext(program, 0, env, scope=scope,
                              place=self.place, device=self.device,
                              rng=self._stream(scope, seed))
            try:
                graph_owned = compiled.run(ctx, scope, eager)
            except Exception as exc:
                # a device OOM is blamed on the program that ran: under
                # FLAGS_compile_passes the rewritten clone (run()'s
                # flight hook reads this through obs.mem.oom_context)
                from ..obs import mem as obs_mem

                if obs_mem.is_oom(exc) and not hasattr(exc, "_mem_program"):
                    try:
                        exc._mem_program = program
                    except Exception:
                        pass
                raise
            # a fetch the run did not write (a parameter, optimizer
            # state) resolves from the scope
            outs = [_lookup(ctx, n) for n in fetch_list]
            if not return_numpy:
                # a graph's own buffer is overwritten by its next replay
                outs = [_clone(o) if n in graph_owned else o
                        for n, o in zip(fetch_list, outs)]
        if return_numpy:
            return [fetch_to_host(_count_fetch(o)) for o in outs]
        return outs
