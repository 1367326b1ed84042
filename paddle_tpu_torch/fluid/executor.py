"""Executor: runs block 0 of a Program op by op, eagerly.

Counterpart of paddle_tpu/fluid/executor.py without its jit
segmentation, buffer donation and compile cache.  Each op's
kernel comes from the registry and runs on the tensors of the
executor's place; PyTorch dispatches the work to the card as it goes.
A grad op `<type>_grad` runs the explicit grad kernel registered for
`<type>`, or else the generic vjp kernel (ops/registry.py).  Persistable
outputs (parameters updated by the optimizer ops, everything a startup
program makes) are written back to the scope after the run.

While torch.profiler records, each op runs in a range named by its
type, so a profile attributes device time to op types.  While
`fluid.profiler` or the obs trace is on, each top-level op also runs in
`profiler.record_event` (a row of the per-op table, a span on the
trace); while both are off the run asks once and opens nothing.  While
the obs trace is on, a run is an `executor/run` span (cat "executor")
around its ops' spans, as on the JAX side.

Under `FLAGS_check_nan_inf` every top-level op's float outputs are
scanned after it runs (reference: executor.cc:29, CheckTensorNANOrInf
executor.cc:66-77): one read back to the host per output, and the
first op with a NaN or Inf raises `NonfiniteError` naming the op type,
its index in block 0, the output slot and var, and the count.  Ops of a
sub-block run inside their op's kernel and are not scanned, as on the
JAX side.  An exception from a run reaches `obs.flight.on_crash` with
the feeds described (shapes and dtypes) before it propagates.

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
var makes another version.

A program without grad ops that writes no persistable runs under
`torch.inference_mode()` (the served forward); any other runs under
`torch.no_grad()`, since inference tensors cannot be saved for a
backward and `torch.func.vjp` computes its grads regardless.

Telemetry, as on the JAX side (paddle_tpu/fluid/executor.py:921,
:1080, :1092): a run's feed preparation is timed
(`obs.telemetry.on_feed_seconds`), each feed the run places on the
device counts its bytes as h2d and each fetch pulled to the host its
bytes as d2h (`on_transfer`); a feed already on the device moves
nothing and counts nothing.

Places: `CUDAPlace(device_id)` is the default; `CPUPlace()` must be
asked for.  A CUDAPlace without a CUDA device raises RuntimeError when
the executor is made — the port never carries on on the CPU by itself.
"""

import contextlib
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


def apply_op(ctx, op_desc):
    """Run one op's kernel against ctx.env; returns its outputs.
    `@EMPTY@` inputs read as None and `@EMPTY@` or None outputs are not
    written."""
    kernel = _kernel_of(op_desc.type)
    ins = {slot: [None if n == EMPTY else _lookup(ctx, n) for n in names]
           for slot, names in op_desc.inputs.items()}
    outs = kernel(ctx, ins, op_desc.attrs)
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
    contract)."""
    if isinstance(t, (RaggedTensor, SelectedRows)):
        return host_copy(t)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def _desc_version(desc):
    """The version of a ProgramDesc: each block's ops (compared by
    identity; holding them keeps their ids from being reused) and its
    count of vars."""
    return tuple((tuple(b.ops), len(b.vars)) for b in desc.blocks)


class Executor:
    """reference: python/paddle/v2/fluid/executor.py Executor.

    Random ops without a `seed` attr draw from a random stream.  By
    default it lives in the scope, as on the JAX side: the first program
    run in a scope seeds it from its `random_seed` (0 for a bare
    ProgramDesc), and later runs in that scope go on drawing from it.
    `seed` gives the executor a stream of its own instead, seeded with
    it and shared by every scope it runs in."""

    # rewritten programs kept (the JAX executor's cache bound)
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

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """Run block 0 of `program` (a Program, its ProgramDesc, or None
        for the default main program) with `feed` {name: array or
        tensor, a RaggedTensor for a var with a lod level, or a
        SelectedRows}; returns the values of `fetch_list` (Variables or
        names), as numpy arrays (a ragged or SelectedRows value on the
        host) or, with return_numpy=False, as they are on the place's
        device.  A SelectedRows grad lives in the run's values between
        the grad op that makes it and the update op that reads it."""
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
                                fetches=len(fetch_list)):
                program = self._program_to_run(source, program,
                                               fetch_list)
                return self._run(program, seed, feed, fetch_list, scope,
                                 return_numpy)
        except Exception as exc:
            # a crashing run leaves a post-mortem bundle (a no-op unless
            # obs.flight.install() was called)
            obs_flight.on_crash(exc, origin="executor/run",
                                feeds=obs_flight.describe_feeds(feed),
                                fetches=list(fetch_list), eager=True)
            raise

    def _program_to_run(self, source, desc, fetch_names):
        """The ProgramDesc a run of `desc` executes: `desc` itself, or
        under FLAGS_compile_passes its rewritten clone; verified first
        under FLAGS_verify_program.  `source` is what the caller passed
        (a Program carries its random_seed, which lint L003 reads)."""
        verify = flags.get_flag("verify_program")
        spec = flags.get_flag("compile_passes")
        if not verify and not spec:
            return desc
        version = _desc_version(desc)
        if verify:
            self._verify_program(source, version, fetch_names)
        if not spec:
            return desc
        key = (id(desc), tuple(fetch_names), spec,
               flags.get_flag("amp_bf16"), flags.get_flag("amp_bf16_act"))
        hit = self._optimized.get(key)
        if hit is not None and hit[0] is desc and hit[1] == version:
            self._optimized.move_to_end(key)
            return hit[2]
        from ..compile import passes as passes_mod

        optimized, pm = passes_mod.optimize_program(
            desc, spec, fetches=list(fetch_names))
        self.pipeline_runs += 1
        self.last_pipeline = pm
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

    def _run(self, program, seed, feed, fetch_list, scope, return_numpy):
        block = program.block(0)
        persist = [n for op in block.ops for n in op.output_names()
                   if n in block.vars and block.vars[n].persistable]
        trains = bool(persist) or any(
            op_registry.is_grad_op_type(op.type) for op in block.ops)
        with torch.no_grad() if trains else torch.inference_mode():
            t_feed = time.perf_counter()
            env = {name: prepare_feed(block, name, val, self.device)
                   for name, val in (feed or {}).items()}
            if feed:
                obs_tele.on_feed_seconds(time.perf_counter() - t_feed)
            ctx = ExecContext(program, 0, env, scope=scope,
                              place=self.place, device=self.device,
                              rng=self._stream(scope, seed))
            timed = profiler_mod.active()
            check = flags.get_flag("check_nan_inf")
            for index, op_desc in enumerate(block.ops):
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
                        err.op_index = index
                        raise
            for name in persist:
                if name in env:
                    scope.set(name, env[name])
            # a fetch the run did not write (a parameter, optimizer
            # state) resolves from the scope
            outs = [_lookup(ctx, n) for n in fetch_list]
        if return_numpy:
            return [fetch_to_host(_count_fetch(o)) for o in outs]
        return outs
