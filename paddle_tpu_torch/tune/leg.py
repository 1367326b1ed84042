"""The autotuner's single-card measurement leg.

    BENCH_MODEL=resnet50 BENCH_BATCH=32 BENCH_MICRO_BATCH=2 \\
    BENCH_MESH="dp=8,mp=1" BENCH_LEG="ptune:dp8.mp1-b256-mb2-none" \\
    python -m paddle_tpu_torch.tune.leg

The JAX package's tuner measures a candidate through the repo's
`bench.py` (paddle_tpu/tune/measure.py); that script is the JAX
package's.  This module is the port's counterpart of the part of it the
tuner uses: it trains one image model of `tune.models` at `BENCH_BATCH`
images a step, run as `BENCH_MICRO_BATCH` sequential optimizer steps of
`batch / m` images each (bench.py's micro-batch split), and times it.

Environment (bench.py's names):
  BENCH_MODEL        a `tune.models` name (default resnet50)
  BENCH_BATCH        images a step (default 128)
  BENCH_MICRO_BATCH  sequential micro-steps a step (default 1)
  BENCH_ITERS        timed steps (default 10)
  BENCH_WARMUP       untimed steps first (default 3)
  BENCH_IMAGE_SIZE, BENCH_CLASS_DIM   the builder's knobs
  BENCH_AMP          1 (the default) trains under bf16 AMP, 0 in f32
  BENCH_MESH, BENCH_LEG  stamps joining the record to a tuner
                     candidate (the mesh is informational: one card runs
                     the candidate's per-device slice)
  BENCH_HISTORY      perf-history path the record appends to (default
                     `perf_history.jsonl` at the repo root; 0: none)
  BENCH_USE_GPU      0 runs on the CPU; otherwise the card, which raises
                     without a CUDA device
  FLAGS_compile_passes  the pass pipeline, applied by the executor

The feeds are made from seed 0 and put on the device once.  The time is
the host clock around the timed steps, ending in a synchronize.  The
record (one JSON line, the last of standard output) carries `value`
(img/s), `step_ms`, the MFU against the card's peak (none on the CPU),
the last loss, `platform` and `platform_class`, bench.py's `config`
blob (`pass_pipeline` the pipeline id of FLAGS_compile_passes, `mesh`
BENCH_MESH), and `kernel_launches`: this process's launches of the
port's hand-written kernels (`kernels.launch_counts`) over the leg,
counted from 0 at its start.
"""

import json
import os
import sys
import time

import numpy as np

__all__ = ["run_leg", "config_blob", "main"]

SEED = 0


def config_blob(env, model, batch, micro, amp_bf16, pass_spec,
                image_size):
    """bench.py's `_config_blob`: the candidate point this record
    measured, which tune/fit.py joins back to its plan entry."""
    from ..compile.passes import pipeline_id

    return {
        "model": model, "mode": "train", "batch": batch,
        "micro_batches": micro,
        "mesh": env.get("BENCH_MESH") or None,
        "pass_pipeline": pipeline_id(pass_spec) or None,
        "amp_bf16": amp_bf16,
        "recompute": 0,
        "prefetch": 0,
        "layout": "NCHW",
        "tag": None,
        "image_size": image_size,
    }


def _int(env, name, default):
    try:
        return int(env.get(name) or default)
    except ValueError:
        raise SystemExit("%s must be an integer, got %r"
                         % (name, env.get(name)))


def run_leg(env=None, log=None):
    """Train and time one leg as `env` (default os.environ) describes;
    returns the record (appended to the history unless BENCH_HISTORY is
    0)."""
    import torch

    from .. import fluid
    from .. import kernels
    from ..fluid.analysis import program_costs
    from ..obs import mem as obs_mem
    from ..obs import perf as obs_perf
    from ..obs import telemetry as obs_tele
    from ..utils import flags
    from . import models as tune_models
    from .measure import repo_root

    env = os.environ if env is None else env
    model = env.get("BENCH_MODEL") or "resnet50"
    if model not in tune_models.MODELS:
        raise SystemExit("BENCH_MODEL must be one of %s"
                         % ", ".join(tune_models.model_names()))
    batch = _int(env, "BENCH_BATCH", 128)
    micro = _int(env, "BENCH_MICRO_BATCH", 1)
    iters = _int(env, "BENCH_ITERS", 10)
    warmup = _int(env, "BENCH_WARMUP", 3)
    if batch < 1 or micro < 1 or iters < 1 or warmup < 0:
        raise SystemExit("BENCH_BATCH, BENCH_MICRO_BATCH and BENCH_ITERS "
                         "must be >= 1, BENCH_WARMUP >= 0")
    if batch % micro:
        raise SystemExit("BENCH_BATCH=%d not divisible by "
                         "BENCH_MICRO_BATCH=%d" % (batch, micro))
    spec = tune_models.MODELS[model]
    image_size = _int(env, "BENCH_IMAGE_SIZE", spec["image_size"])
    class_dim = _int(env, "BENCH_CLASS_DIM", spec["class_dim"])
    amp_bf16 = env.get("BENCH_AMP", "1") != "0"
    use_gpu = env.get("BENCH_USE_GPU", "1") != "0"
    pass_spec = (env.get("FLAGS_compile_passes") or "").strip()

    place = fluid.CUDAPlace(0) if use_gpu else fluid.CPUPlace()
    device = place.device()  # raises here without a CUDA device
    kernels.reset_launches()
    snap_start = obs_tele.snapshot()
    build_batch = batch // micro
    seconds = {}
    t = time.perf_counter()
    main, startup, loss_name = tune_models.builder(
        model, image_size=image_size, class_dim=class_dim,
        with_startup=True)(build_batch)
    seconds["build"] = time.perf_counter() - t

    rs = np.random.RandomState(SEED)
    feed = {
        "image": torch.from_numpy(rs.rand(
            build_batch, spec["channels"], image_size,
            image_size).astype(np.float32)).to(device),
        "label": torch.from_numpy(rs.randint(
            0, class_dim, size=(build_batch, 1)).astype(np.int64))
        .to(device),
    }

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    saved = {n: flags.get_flag(n) for n in ("compile_passes", "amp_bf16")}
    flags.set_flag("compile_passes", pass_spec)
    flags.set_flag("amp_bf16", amp_bf16)
    try:
        t = time.perf_counter()
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(startup, scope=scope)
        sync()
        seconds["startup"] = time.perf_counter() - t

        def step():
            return exe.run(main, feed=feed, fetch_list=[loss_name],
                           scope=scope, return_numpy=False)

        t = time.perf_counter()
        for _ in range(warmup * micro):
            step()
        sync()
        seconds["warmup"] = time.perf_counter() - t
        t0 = time.perf_counter()
        for _ in range(iters * micro):
            fetches = step()
        sync()
        dt = time.perf_counter() - t0
    finally:
        for n, v in saved.items():
            flags.set_flag(n, v)
    launches = kernels.launch_counts()
    loss = float(torch.as_tensor(fetches[0]).float().reshape(-1)[0])
    samples_per_sec = batch * iters / dt
    step_ms = dt / iters * 1e3

    peak = obs_perf.default_peak_tflops(amp_bf16) if use_gpu else None
    mfu = None
    if peak:
        flops = sum(f for _, f, _, _ in program_costs(main))
        mfu = round(samples_per_sec * flops / build_batch
                    / (peak * 1e12), 4)
    record = {
        "metric": "%s_train_imgs_per_sec_batch%d%s"
                  % (model, batch, "+mb%d" % micro if micro > 1 else ""),
        "value": round(samples_per_sec, 2),
        "unit": "img/s",
        "step_ms": round(step_ms, 4),
        "mfu": mfu,
        "flops_model": None if mfu is None else "ir-2flops-per-mac",
        "amp_bf16": amp_bf16,
        "loss": loss,
        "platform": "gpu" if device.type == "cuda" else "cpu",
        # the program is the micro-batch slice: its own per-micro step
        # against its floors
        "perf": obs_perf.leg_perf_blob(
            main, dt / (iters * micro),
            bf16_act=amp_bf16 and flags.get_flag("amp_bf16_act"),
            peak_tflops=peak),
        "config": config_blob(env, model, batch, micro, amp_bf16,
                              pass_spec, image_size),
        # host seconds of the leg's parts before the timed steps
        "seconds": {k: round(v, 3) for k, v in seconds.items()},
        "kernel_launches": launches,
    }
    # the leg's memory: the static peak, the pool bytes the train
    # program's captures added and the card's watermark (obs/perf's
    # memory gate reads it)
    compiled = [c for _d, _v, c in exe._cache.values()
                if c.fetch_names == [loss_name]]
    record["memory"] = obs_mem.bench_memory_blob(
        main, fetches=[loss_name],
        pool_stats={"pool_bytes": sum(c.pool_bytes for c in compiled)})
    if flags.get_flag("compile_cache_dir"):
        # this leg's persistent plan cache efficacy
        cc = obs_tele.snapshot_delta(snap_start)
        record["compile_cache"] = {
            "hits": cc.get("compile_cache_hits_total", 0),
            "misses": cc.get("compile_cache_misses_total", 0),
            "compile_seconds_saved": round(
                cc.get("compile_cache_saved_compile_seconds_total",
                       0.0), 3),
        }
    record["platform_class"] = obs_perf.platform_class(record)
    dest = env.get("BENCH_HISTORY", "")
    if dest != "0":
        obs_perf.append_history(
            record, dest or os.path.join(repo_root(), "perf_history.jsonl"),
            leg=env.get("BENCH_LEG") or None)
    if log is not None:
        print("tune.leg: %s batch %d x mb %d on %s: %.4f ms a step, "
              "%.2f img/s, loss %.6f" % (model, batch, micro,
                                         record["platform"], step_ms,
                                         samples_per_sec, loss),
              file=log, flush=True)
    return record


def main():
    record = run_leg(log=sys.stderr)
    print(json.dumps(record, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
