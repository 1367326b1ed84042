"""Process flags: the few the port reads, each with the JAX package's
name, default and `FLAGS_<name>` environment bootstrap, and
`DEFINE_flag` for a caller's own.

Counterpart of paddle_tpu/utils/flags.py, holding only what the port
consults: the eager NaN/Inf scan (`check_nan_inf`: fluid/executor.py),
the AMP policy (`amp_bf16`, `amp_bf16_act`), the batch-norm statistics
form (`bn_shifted_stats`), the optimizer's update fusion
(`fuse_optimizer`, `fuse_optimizer_max_numel`: fluid/fusion.py), and
the executor's program verification and rewrite pipeline
(`verify_program`, `compile_passes`: fluid/executor.py), and the C
inference API's place (`use_gpu`: capi_impl.py; the C signature has
none, so `FLAGS_use_gpu=0` in a C program's environment asks for the
CPU).
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
DEFINE_flag("use_gpu", True,
            "the C inference API (capi_impl.CEngine) runs on CUDAPlace(0); "
            "0 runs it on the CPU.  Read from FLAGS_use_gpu when the "
            "package is imported, as the other flags are")

parse_flags_from_env()
