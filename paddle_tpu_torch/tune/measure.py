"""Measure the top-K ranked candidates, each on one card.

Counterpart of paddle_tpu/tune/measure.py, with its contract: the
static model (tune/rank.py) earns nothing until it is checked against
hardware, but measuring the WHOLE space is what the tuner exists to
avoid, so this module runs only the plan's top-K survivors, each as one
child process of the measurement leg (`python -m
paddle_tpu_torch.tune.leg`, the port's counterpart of the part of the
JAX package's `bench.py` the tuner drives).

What one card can measure of a multi-card candidate is its per-device
proxy: the leg runs the candidate's per-device batch slice
(`batch / dp`), its micro-batch split and its pass pipeline — the
compute + overhead terms of the prediction.  The comm term stays
analytic; tune/fit.py fits the correction on exactly the terms that
were measured.

Every record lands in `perf_history.jsonl` with leg `ptune:<tag>` and
the stamped `"config"` blob, so the calibration join is a history
lookup.  Ambient BENCH_* settings are scrubbed from each leg's
environment, one failed leg is recorded and not fatal, and each
record's config blob is checked against its candidate.

Only `RankedPlan.ranked` entries can be measured: rejections never
carry a `bench_env`, and `measure_plan` walks the ranked list.
`cache_dir` runs the legs with `FLAGS_compile_cache_dir` set (the
persistent plan cache, compile/pcache.py), so a candidate measured
again reloads its plans.
"""

import json
import os
import subprocess
import sys

__all__ = ["measure_plan", "measurement_env", "leg_launches",
           "MeasureError", "LEG_MODULE", "repo_root"]

LEG_MODULE = "paddle_tpu_torch.tune.leg"

class MeasureError(RuntimeError):
    pass


def repo_root():
    """The checkout this package runs from: the legs' working
    directory, and the path their child processes import it by."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _entries(plan, model=None):
    """Uniform (tag, config, bench_env, context) view over a
    RankedPlan or a loaded plan-JSON dict."""
    if hasattr(plan, "ranked") and not isinstance(plan, dict):
        model = model or plan.model
        return [(e.candidate.tag(), e.candidate.config(model),
                 e.candidate.bench_env(model))
                for e in plan.ranked], model, dict(plan.context)
    model = model or plan.get("model")
    return [(e["tag"], e["config"], dict(e["bench_env"]))
            for e in plan.get("ranked", ())], model, \
        dict(plan.get("context") or {})


def measurement_env(env_over, context, model, history=None, iters=2,
                    warmup=1, image_size=None, cache_dir=None,
                    extra_env=None):
    """The full env overrides for one candidate's measurement leg.

    Starts from the candidate's own `bench_env` and replays the PLAN
    CONTEXT so the measured program is the one the ranking priced:
    BENCH_AMP follows the plan's `bf16_act` (an `--f32` plan must not
    be measured under the leg's bf16 default), and the builder's
    image_size/class_dim knobs carry over unless overridden here.
    Relative history paths are absolutized against the CALLER's cwd —
    the leg subprocess runs from the repo root, and `ptune fit`
    later resolves the same path from the caller's cwd again.
    `cache_dir` sets FLAGS_compile_cache_dir for the leg (the
    persistent plan cache)."""
    env = dict(env_over)
    env.setdefault("BENCH_MODEL", model)
    env["BENCH_ITERS"] = str(iters)
    env["BENCH_WARMUP"] = str(warmup)
    if "bf16_act" in context:
        env["BENCH_AMP"] = "1" if context["bf16_act"] else "0"
    size = image_size or context.get("image_size")
    if size:
        env["BENCH_IMAGE_SIZE"] = str(size)
    if context.get("class_dim"):
        env["BENCH_CLASS_DIM"] = str(context["class_dim"])
    if history:
        env["BENCH_HISTORY"] = os.path.abspath(history)
    if cache_dir:
        env["FLAGS_compile_cache_dir"] = os.path.abspath(cache_dir)
    env.update(extra_env or {})
    return env


def _config_matches(expected, got, context):
    """The measured record's config blob must be the candidate point:
    the leg's global batch is the candidate's per-device slice, and the
    AMP mode must match what the plan was ranked under."""
    if not isinstance(got, dict):
        return "record carries no config blob"
    checks = [
        ("mesh", expected["mesh"], got.get("mesh")),
        ("batch", expected["per_device_batch"], got.get("batch")),
        ("micro_batches", expected["micro_batches"],
         got.get("micro_batches")),
        ("pass_pipeline", expected["pass_pipeline"],
         got.get("pass_pipeline")),
    ]
    if "bf16_act" in context:
        checks.append(("amp_bf16", bool(context["bf16_act"]),
                       got.get("amp_bf16")))
    for name, want, have in checks:
        if want != have:
            return "config.%s mismatch: expected %r, measured %r" \
                % (name, want, have)
    return None


def measure_plan(plan, topk=3, history=None, iters=2, warmup=1,
                 model=None, image_size=None, cache_dir=None,
                 extra_env=None, timeout=900, echo=None):
    """Run the measurement leg on the plan's top-K ranked candidates.

    plan: a `RankedPlan` or a loaded plan-JSON dict.
    history: perf-history path the records append to (the leg's
        default — `perf_history.jsonl` at the repo root — when None).
    cache_dir: FLAGS_compile_cache_dir for the legs (the persistent
        plan cache); None leaves the caller's setting to the legs.
    extra_env: overrides applied last (the selftest pins BENCH_USE_GPU
        and tiny iters here).

    Returns a list of {"tag", "ok", "record" | "error"}; raises
    MeasureError only for setup problems — one failed leg does not
    forfeit the rest.
    """
    entries, model, context = _entries(plan, model)
    if model is None:
        raise MeasureError("plan names no model and none was given")
    root = repo_root()
    results = []
    for tag, config, env_over in entries[:int(topk)]:
        # ambient BENCH_*/FLAGS_compile_passes (a leftover A/B sweep
        # export, say) would silently measure a different program than
        # the one the plan ranked — scrub them; the candidate's env is
        # the only leg config (re-add knobs via extra_env if needed)
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("BENCH_")
               and k != "FLAGS_compile_passes"}
        env.update(measurement_env(
            env_over, context, model, history=history, iters=iters,
            warmup=warmup, image_size=image_size, cache_dir=cache_dir,
            extra_env=extra_env))
        # the child imports this checkout's package
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        if echo:
            echo("[ptune] measuring %s (batch %s x mb %s)"
                 % (tag, env["BENCH_BATCH"], env["BENCH_MICRO_BATCH"]))
        try:
            proc = subprocess.run(
                [sys.executable, "-m", LEG_MODULE], cwd=root, env=env,
                capture_output=True, text=True, timeout=timeout)
        except subprocess.TimeoutExpired:
            # one wedged leg forfeits its own measurement, never the rest
            results.append({"tag": tag, "ok": False,
                            "error": "the leg exceeded the %gs budget"
                            % timeout})
            continue
        if proc.returncode != 0:
            results.append({"tag": tag, "ok": False,
                            "error": "the leg exited %d: %s"
                            % (proc.returncode,
                               proc.stderr.strip()[-500:])})
            continue
        try:
            record = json.loads(proc.stdout.strip().splitlines()[-1])
        except (ValueError, IndexError):
            results.append({"tag": tag, "ok": False,
                            "error": "the leg emitted no JSON record: "
                            "%r" % proc.stdout[-200:]})
            continue
        mismatch = _config_matches(config, record.get("config"),
                                   context)
        if mismatch:
            results.append({"tag": tag, "ok": False, "record": record,
                            "error": mismatch})
            continue
        results.append({"tag": tag, "ok": True, "record": record})
    return results


def leg_launches(results):
    """{kernel: launches} summed over the measured legs of `results`
    (`measure_plan`'s): each leg counts its own process's launches of
    the port's hand-written kernels.  Raises MeasureError for a
    measured record that carries no count."""
    total = {}
    for r in results:
        record = r.get("record")
        if record is None:
            continue
        counts = record.get("kernel_launches")
        if not isinstance(counts, dict) or not counts:
            raise MeasureError("the leg of %s counted no kernel launches"
                               % r["tag"])
        for name, n in counts.items():
            total[name] = total.get(name, 0) + int(n)
    return total
