"""Multi-card bench legs — SPMD scaling measurements per mesh shape.

Counterpart of paddle_tpu/spmd/bench.py.  Each leg builds one of the
autotuner's image models, trains it end-to-end with `SpmdTrainer` on one
mesh shape over the process group's ranks, and emits a perf-history
record with:

  * img/s and MFU (against `BENCH_PEAK_TFLOPS` per card when set);
  * a `comm` blob pairing the plan's ANALYTIC ring floor (`pred_s`,
    from the sharding analyzer's comm cost report) with a TIMED
    bucketed gradient ring-allreduce over the same byte volume
    (`measured_s`), with the per-bucket split and `comm_ratio`;
  * `platform_class` / `n_devices` / `mesh` stamps (`gpu:d1:dp=1,mp=1`
    on one card), so the perf gate baselines a run only against runs of
    its own class.

The models come from the autotuner's builder (`tune.models`).
Per-host telemetry rides the fleet store: with `fleet=True` each leg
pushes its counters through a `FleetReporter` into an in-process lease
master and the run summary carries the aggregator's merged view.

`bench.py` at the repository root is the JAX package's and stays so;
the port's entry reads the same BENCH_* contract::

    BENCH_MULTICHIP="dp=1" BENCH_MODEL=lenet5 \\
    python -m paddle_tpu_torch.spmd.bench

Every rank of the process group runs the same call (a launcher's world,
or a world of one started here); `BENCH_USE_GPU=0` runs the ranks on
the CPU over gloo.
"""

import json
import os
import sys
import time

import numpy as np

__all__ = ["run_leg", "run_multichip", "main_from_env",
           "DEFAULT_MESH_SPECS", "measure_comm"]

# the two canonical 8-card layouts: pure data-parallel and dp x mp —
# enough points for a scaling curve and a comm-volume contrast
DEFAULT_MESH_SPECS = ("dp=8", "dp=4,mp=2")


def _mesh_tag(mesh_spec):
    # "dp=4,mp=2" -> "dp4_mp2": metric names stay shell/grep friendly
    return str(mesh_spec).replace("=", "").replace(",", "_")


def _build_mesh(mesh_spec, device):
    from ..parallel.mesh import make_mesh, parse_mesh_spec

    cfg = parse_mesh_spec(mesh_spec)
    return make_mesh(dp=cfg.dp, mp=cfg.mp, sp=cfg.sp, pp=cfg.pp,
                     ep=cfg.ep, device=device)


def _sync(mesh):
    import torch

    if mesh.device_type == "cuda":
        torch.cuda.synchronize()


def measure_comm(trainer, reps=5, bucket_bytes=None):
    """Time the gradient ring-allreduce the plan predicted.

    Runs `bucketed_allreduce` over zero buffers shaped like every
    trainable parameter (gradient volume == parameter volume for the
    image models) under `shard_map_norep` on the trainer's mesh, and
    pairs the median wall time with the plan's analytic
    `step_seconds_floor`.  The blob also carries the PER-BUCKET split
    (`obs.comm.measure_bucket_times`) and `comm_ratio`, the median
    per-bucket measured/predicted drift.  Returns None when the plan
    has no wire traffic to measure (dp=1 or a fully replicated layout).
    Every rank of the mesh makes the call.
    """
    import torch

    from ..obs import comm as obs_comm
    from ..parallel import sharding as psharding
    from ..parallel.mesh import mesh_shape
    from ..parallel.ring import bucketed_allreduce
    from .overlap import DEFAULT_BUCKET_BYTES

    plan_comm = trainer.plan.comm or {}
    wire_bytes = plan_comm.get("total_wire_bytes")
    pred_s = plan_comm.get("step_seconds_floor")
    if not wire_bytes or not pred_s:
        return None
    dp_axis = trainer.dp_axis
    if mesh_shape(trainer.mesh).get(dp_axis, 1) <= 1:
        return None
    bucket_bytes = bucket_bytes or DEFAULT_BUCKET_BYTES
    # gradient volume == trainable-parameter volume; param_reasons
    # keys are exactly the params the analyzer priced into the floor
    params = set(trainer.plan.param_reasons) or set(trainer.state)
    shapes = {n: tuple(v.shape) for n, v in trainer.state.items()
              if n in params and len(v.shape) > 0}
    if not shapes:
        return None
    device = trainer.place.device()
    grads = {n: torch.zeros(s, dtype=torch.float32, device=device)
             for n, s in shapes.items()}
    specs = {n: psharding.P() for n in grads}
    members = sorted(grads)

    def reduce_all(g):
        out = bucketed_allreduce(g, bucket_bytes, axis_name=dp_axis,
                                 mean=True)
        return tuple(out[n] for n in members)

    fn = psharding.shard_map_norep(
        reduce_all, trainer.mesh, in_specs=(specs,),
        out_specs=tuple(psharding.P() for _ in members))
    with torch.no_grad():
        fn(grads)                               # warm
        _sync(trainer.mesh)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(grads)
            _sync(trainer.mesh)
            times.append(time.perf_counter() - t0)
    blob = {
        "wire_bytes": int(wire_bytes),
        "pred_s": float(pred_s),
        "measured_s": float(np.median(times)),
        "bucket_bytes": int(bucket_bytes),
    }
    buckets = obs_comm.measure_bucket_times(
        trainer.mesh, {n: np.zeros(s, np.float32)
                       for n, s in shapes.items()},
        bucket_bytes, axis_name=dp_axis, reps=min(int(reps), 3))
    if buckets:
        blob["n_buckets"] = len(buckets["buckets"])
        blob["buckets"] = buckets["buckets"]
        ratios = [r["ratio"] for r in buckets["buckets"]
                  if r.get("ratio")]
        if ratios:
            blob["comm_ratio"] = round(float(np.median(ratios)), 6)
    return blob


def run_leg(model="lenet5", mesh_spec="dp=8", batch=None, iters=8,
            warmup=2, rules=None, zero_stage=0, bucket_bytes=0,
            history=None, use_pcache=False, device="cuda"):
    """One multi-card leg: train `model` on `mesh_spec` over the
    process group's ranks (`device` "cuda", the default, or "cpu"),
    return the perf-history record (appended to `history` when given,
    by rank 0)."""
    import torch

    from ..fluid.analysis import program_costs
    from ..obs import perf as obs_perf
    from ..parallel.mesh import mesh_shape
    from ..tune.models import MODELS, builder
    from .trainer import SpmdTrainer

    mesh = _build_mesh(mesh_spec, device)
    axes = {a: int(s) for a, s in mesh_shape(mesh).items()}
    n_devices = int(np.prod(list(axes.values()))) or 1
    if batch is None:
        # same global batch on every mesh shape (4 per device), so
        # the img/s curve compares layouts, not batch sizes; dp
        # divides n_devices, so the dp split stays exact
        batch = 4 * n_devices
    spec = MODELS[model]
    size = spec["image_size"]

    main, startup, loss_name = builder(model, with_startup=True)(batch)
    trainer = SpmdTrainer(
        main, startup, ["image", "label"], [loss_name], mesh,
        rules=rules, zero_stage=zero_stage, bucket_bytes=bucket_bytes,
        model=model, use_pcache=use_pcache)
    trainer.init()

    rs = np.random.RandomState(0)
    dev = trainer.place.device()
    feed_pool = [
        {"image": torch.from_numpy(
            rs.rand(batch, spec["channels"], size, size)
            .astype(np.float32)).to(dev),
         "label": torch.from_numpy(
             rs.randint(0, spec["class_dim"], size=(batch, 1))
             .astype(np.int32)).to(dev)}
        for _ in range(2)
    ]
    fetches = None
    for i in range(warmup):
        fetches = trainer.step(feed_pool[i % 2])
    _sync(mesh)
    t0 = time.perf_counter()
    for i in range(iters):
        fetches = trainer.step(feed_pool[i % 2])
    _sync(mesh)
    dt = time.perf_counter() - t0

    samples_per_sec = batch * iters / dt
    step_ms = dt / iters * 1e3
    loss = float(fetches[0].reshape(-1)[0])

    step_flops = sum(f for _, f, _, _ in program_costs(main))
    gflop_per_sample = step_flops / 1e9 / batch
    platform = "gpu" if mesh.device_type == "cuda" else "cpu"
    # MFU against a peak only when the caller supplied one (per card;
    # the peak scales with the device count)
    peak_tflops = float(os.environ.get("BENCH_PEAK_TFLOPS", "0") or 0)
    mfu = None
    if peak_tflops > 0:
        mfu = round(samples_per_sec * gflop_per_sample
                    / (peak_tflops * n_devices * 1e3), 4)

    comm = measure_comm(trainer)
    if comm is not None:
        # stamp HOW this leg reduced gradients: fallback (gspmd) runs
        # carry their reason and never acquire overlap-efficiency
        # fields, so the exposed-comm baseline only ever joins real
        # overlapped runs against each other
        comm["step_mode"] = trainer.step_mode
        comm["plan_fingerprint"] = trainer.plan.fingerprint()
        if trainer.overlap_fallback_reason:
            comm["overlap_fallback_reason"] = \
                trainer.overlap_fallback_reason
        if trainer.step_mode == "overlap-dp" and \
                os.environ.get("BENCH_OVERLAP_REPORT", "1") != "0":
            from ..obs import comm as obs_comm

            rep = obs_comm.overlap_report(trainer, feed_pool[0],
                                          reps=min(iters, 3))
            if rep.get("supported"):
                comm["exposed_s"] = round(rep["exposed_s"], 6)
                comm["hidden_s"] = round(rep["hidden_s"], 6)
                if rep.get("overlap_efficiency") is not None:
                    comm["overlap_efficiency"] = round(
                        rep["overlap_efficiency"], 4)
    record = {
        "metric": "multichip_%s_%s" % (model, _mesh_tag(mesh_spec)),
        "value": round(samples_per_sec, 2),
        "unit": "img/s",
        "step_ms": round(step_ms, 2),
        "mfu": mfu,
        "amp_bf16": False,
        "platform": platform,
        "n_devices": n_devices,
        "mesh": axes,
        "comm": comm,
        "loss": round(loss, 4),
        "config": {
            "model": model, "mode": "spmd", "batch": batch,
            "mesh": str(mesh_spec), "zero_stage": zero_stage,
            "bucket_bytes": bucket_bytes,
            "step_mode": trainer.step_mode,
            "aot": trainer._aot_state,
        },
    }
    record["platform_class"] = obs_perf.platform_class(record)
    if history and _rank() == 0:
        obs_perf.append_history(record, history,
                                leg="multichip:%s" % mesh_spec)
    return record


def _rank():
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def run_multichip(model="lenet5", mesh_specs=DEFAULT_MESH_SPECS,
                  batch=None, iters=8, warmup=2, rules=None,
                  zero_stage=0, bucket_bytes=0, history=None,
                  fleet=False, out=sys.stdout, device="cuda"):
    """The multi-card suite: one `run_leg` per mesh shape + the fleet
    telemetry round-trip.  Returns {"records": [...], "fleet": {...}}
    and prints the scaling curve."""
    master = reporter = None
    fleet_info = None
    if fleet:
        try:
            from .. import native
            from ..obs.fleet import FleetReporter

            master = native.Master()
            reporter = FleetReporter("127.0.0.1:%d" % master.port,
                                     host="host%d" % _rank(),
                                     interval_s=3600.0)
        except Exception as exc:  # noqa: BLE001 — telemetry is
            print("spmd-bench: fleet store unavailable (%r); "  # a
                  "skipping per-host telemetry" % (exc,),  # rider,
                  file=sys.stderr)                 # never the run
            fleet = False
    try:
        records = []
        for spec in mesh_specs:
            rec = run_leg(model=model, mesh_spec=spec, batch=batch,
                          iters=iters, warmup=warmup, rules=rules,
                          zero_stage=zero_stage,
                          bucket_bytes=bucket_bytes, history=history,
                          device=device)
            records.append(rec)
            if reporter is not None:
                reporter.push_once()
        if fleet and master is not None:
            from ..obs.fleet import FleetAggregator

            agg = FleetAggregator()
            n = agg.collect("127.0.0.1:%d" % master.port)
            fleet_info = {"hosts": n,
                          "stragglers": agg.stragglers(publish=False)}
    finally:
        if reporter is not None:
            try:
                reporter.stop(unregister=True)
            except Exception:  # noqa: BLE001
                pass
        if master is not None:
            try:
                master.stop()
            except Exception:  # noqa: BLE001
                pass

    base = records[0]["value"] if records else 1.0
    print("MULTICHIP scaling (%s):" % model, file=out)
    for rec in records:
        comm = rec.get("comm") or {}
        print("  %-12s %9.1f img/s  %7.2f ms/step  mfu=%s  "
              "x%.2f  comm %s"
              % (rec["config"]["mesh"], rec["value"], rec["step_ms"],
                 rec["mfu"] if rec["mfu"] is not None else "n/a",
                 rec["value"] / base,
                 "%.2fms meas / %.2fms floor" %
                 (1e3 * comm["measured_s"], 1e3 * comm["pred_s"])
                 if comm else "n/a"), file=out)
    if fleet_info:
        print("  fleet: %d host snapshot(s), stragglers=%s"
              % (fleet_info["hosts"],
                 fleet_info["stragglers"].get("flagged")), file=out)
    return {"records": records, "fleet": fleet_info}


def main_from_env():
    """The BENCH_* env contract of the JAX package's `bench.py`
    BENCH_MULTICHIP delegate; returns a process exit code.  The legs run
    over the process group's ranks (a world of one started here when
    none is up), on the card unless BENCH_USE_GPU=0."""
    import torch.distributed as dist

    from ..parallel.mesh import ensure_world

    specs = [s for s in os.environ.get(
        "BENCH_MULTICHIP", "|".join(DEFAULT_MESH_SPECS)).split("|")
        if s.strip()]
    history = os.environ.get("BENCH_HISTORY") or None
    if history in ("0", ""):
        history = None
    batch = int(os.environ.get("BENCH_BATCH", "0") or 0) or None
    device = "cpu" if os.environ.get("BENCH_USE_GPU", "1") == "0" \
        else "cuda"
    started = not dist.is_initialized()
    ensure_world(device)
    try:
        result = run_multichip(
            model=os.environ.get("BENCH_MODEL", "lenet5"),
            mesh_specs=specs,
            batch=batch,
            iters=int(os.environ.get("BENCH_ITERS", "8")),
            warmup=int(os.environ.get("BENCH_WARMUP", "2")),
            zero_stage=int(os.environ.get("BENCH_ZERO_STAGE", "0")),
            bucket_bytes=int(os.environ.get("BENCH_BUCKET_BYTES", "0")),
            history=history,
            fleet=os.environ.get("BENCH_FLEET", "1") != "0",
            device=device)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(
        {"legs": [{k: r[k] for k in
                   ("metric", "value", "step_ms", "mfu",
                    "platform_class")} for r in result["records"]]},
        sort_keys=True))
    return 0 if result["records"] else 1


if __name__ == "__main__":
    sys.exit(main_from_env())
