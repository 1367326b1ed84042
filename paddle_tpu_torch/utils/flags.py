"""Process flags: the few the port reads, each with the JAX package's
name, default and `FLAGS_<name>` environment bootstrap, and
`DEFINE_flag` for a caller's own.

Counterpart of paddle_tpu/utils/flags.py, holding only what the port
consults: the eager NaN/Inf scan (`check_nan_inf`: fluid/executor.py),
the AMP policy (`amp_bf16`, `amp_bf16_act`), the batch-norm statistics
form (`bn_shifted_stats`), the optimizer's update fusion
(`fuse_optimizer`, `fuse_optimizer_max_numel`: fluid/fusion.py), and
the executor's program verification and rewrite pipeline
(`verify_program`, `compile_passes`: fluid/executor.py), the buffer
donation of its captured segments (`donation`: fluid/executor.py,
analysis/alias.py), and the C
inference API's place (`use_gpu`: capi_impl.py; the C signature has
none, so `FLAGS_use_gpu=0` in a C program's environment asks for the
CPU), the sharding verification of the parallel trainer
(`verify_sharding`: parallel/), the persistent plan cache
(`compile_cache_dir`, `compile_cache_max_bytes`: compile/pcache.py),
and memory observability (`mem_budget_gb`, `xla_cost_attribution`:
obs/mem.py, obs/health.py).
Kernels read a flag when they run, so a flag set around `Executor.run`
(`fluid.amp.bf16_guard()`) governs that run; the optimizer reads the
fusion flags when it builds the updates.
"""

import os

__all__ = ["DEFINE_flag", "get_flag", "set_flag", "all_flags",
           "parse_flags_from_env"]

_FLAGS = {}


def _coerce(value, default):
    if isinstance(default, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(default, int):
        return int(value)
    if isinstance(default, float):
        return float(value)
    return value


def DEFINE_flag(name, default, help_str=""):
    """Register flag `name` with its default (whose type later values
    are coerced to) and help; returns the default."""
    _FLAGS[name] = {"value": default, "default": default,
                    "help": help_str}
    return default


def get_flag(name):
    return _FLAGS[name]["value"]


def set_flag(name, value):
    if name not in _FLAGS:
        raise KeyError("unknown flag %r" % name)
    f = _FLAGS[name]
    f["value"] = _coerce(value, f["default"])


def all_flags():
    return {k: v["value"] for k, v in _FLAGS.items()}


def parse_flags_from_env(names=None):
    """Set each flag of `names` (default: all) from `FLAGS_<name>` where
    the environment has it."""
    for name in names if names is not None else list(_FLAGS):
        if "FLAGS_" + name in os.environ:
            set_flag(name, os.environ["FLAGS_" + name])


DEFINE_flag("check_nan_inf", False,
            "scan every top-level op's float outputs for NaN/Inf, raising "
            "NonfiniteError (reference: executor.cc:29); one read back "
            "per output")
DEFINE_flag("amp_bf16", False,
            "cast mul/conv operands to bfloat16, f32 master weights "
            "(fluid.amp)")
DEFINE_flag("amp_bf16_act", True,
            "under amp_bf16, keep activations bfloat16 between ops")
DEFINE_flag("bn_shifted_stats", False,
            "batch-norm statistics in the shifted one-pass form "
            "(ops/norm.py)")
DEFINE_flag("fuse_optimizer", False,
            "stack same-recipe update ops into fused_update ops "
            "(fluid/fusion.py)")
DEFINE_flag("fuse_optimizer_max_numel", 1 << 18,
            "only parameters of at most this many elements join a "
            "stack; 0: all")
DEFINE_flag("verify_program", False,
            "run paddle_tpu_torch.analysis.check_program on every "
            "program before its first run (per executor, program and "
            "version): structure, re-derived shapes and dtypes, "
            "write/alias hazards and lints.  Error findings raise "
            "ProgramVerificationError naming the op index and variable "
            "instead of surfacing as an error from inside a kernel.  "
            "Default off: the full check re-derives every op's output "
            "meta, a build-time cost that the surfaces opting into "
            "verification (tests, serving warmup) pay explicitly")
DEFINE_flag("compile_passes", "",
            "Program-level IR rewrite pipeline the executor applies to a "
            "clone of a program before running it "
            "(paddle_tpu_torch.compile.passes): pass names joined by ',' "
            "or '+': the cleanup set (dce,fold,cse,dve; 'default') and "
            "the cost-model-guided passes (layout, fuse, auto_remat; "
            "compile/opt_passes.py), with knobs attached by ':' as in "
            "'default+fuse:cap=8'.  Every pass is verified before and "
            "after it runs.  Empty (the default) runs programs exactly "
            "as built")
DEFINE_flag("donation", "auto",
            "buffer donation of the executor's captured segments "
            "(analysis/alias.py): 'conservative' writes the new value "
            "of every state tensor a segment reads and updates (the "
            "outputs-intersect-reads set: parameters, optimizer state) "
            "into the scope tensor's own storage; 'auto' (default) "
            "also gives up every buffer the A0xx analysis proves dead "
            "after its segment; 'off' donates nothing (the numerics "
            "baseline: donation preserves values, so the three modes "
            "match bit for bit).  Eager runs never donate")
DEFINE_flag("verify_sharding", False,
            "run the static SPMD analyzer (analysis/shard.py) at the "
            "parallel trust boundaries before a step runs: "
            "ParallelTrainer.init and make_parallel_step check the "
            "program against the mesh, the pipeline and MoE schedules "
            "their axis layouts, and an S0xx error raises "
            "ProgramVerificationError before anything runs")
DEFINE_flag("use_gpu", True,
            "the C inference API (capi_impl.CEngine) runs on CUDAPlace(0); "
            "0 runs it on the CPU.  Read from FLAGS_use_gpu when the "
            "package is imported, as the other flags are")

DEFINE_flag("xla_cost_attribution", False,
            "register each captured segment's and program's static "
            "liveness peak at plan time (obs.mem's mem_static_peak_bytes, "
            "the static side of its drift join) and publish the CPU's "
            "plain captures' seconds too (on the card every capture "
            "publishes its seconds and graph-pool bytes).  The same as "
            "obs.health.force_attribution(), read only through "
            "obs.health.attribution_wanted().  It never causes an extra "
            "warm-up or capture")
DEFINE_flag("mem_budget_gb", 0.0,
            "OOM pre-flight (obs/mem.py): before a program's first eager "
            "run or capture, check its static peak estimate (params + "
            "optimizer state + liveness activation peak, the S005 "
            "accounting) against this many GiB and raise "
            "MemoryBudgetError naming the top blamed buffers instead of "
            "letting the device raise an opaque CUDA out of memory; the "
            "failure routes through the flight recorder like a real "
            "OOM.  0 (default) disables")
DEFINE_flag("compile_cache_dir", "",
            "root directory of the persistent plan cache "
            "(paddle_tpu_torch.compile.pcache).  When set, the executor "
            "stores what a process can reload of each program it plans, "
            "keyed by a canonical Program fingerprint: the pass-rewritten "
            "clone, its segment plan, its donation plan and the "
            "verifier's clean verdict; a later process (serving warmup, "
            "supervisor auto-resume) reloads it and runs no verifier, "
            "pass pipeline or donation analysis.  A CUDA graph cannot be "
            "saved: each capture stores a stub entry (its seconds and "
            "pool bytes), and a restarted process captures again.  "
            "Empty (the default) disables the cache entirely")
DEFINE_flag("compile_cache_max_bytes", 2 << 30,
            "LRU size cap for the persistent plan cache; the oldest-used "
            "entries are evicted after each store until the cache fits "
            "(compile_cache_evictions_total counts them).  0 disables "
            "eviction")

parse_flags_from_env()
