"""The rank-side cases of the spmd and obs.comm parity tests.

Each function here runs in every gloo rank that `torch_ranks.run_cases`
spawns, as `fn(rank, *args)`, and returns plain data (rank 0's comes
back to the test).  This module imports the port only, never jax: the
tests compute the JAX side in their own process and pass the initial
state in as numpy arrays.  The program is `torch_parallel_cases`' MLP
(tests/test_spmd.py's probe: a wide first layer and a small head, so a
KB-scale bucket cap gives several buckets).
"""

import hashlib

import numpy as np
import torch.distributed as dist

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.parallel import make_mesh
from paddle_tpu_torch.spmd import SpmdTrainer, overlap as spmd_overlap

from torch_parallel_cases import build_mlp, mlp_feeds


def trainer(mesh_kw, init, bucket_bytes, **kw):
    """SpmdTrainer over the MLP on a CPU mesh of `mesh_kw`, its state set
    to `init` ({name: array}) when given."""
    main, startup, avg = build_mlp()
    tr = SpmdTrainer(main, startup, ["x", "label"], [avg.name],
                     make_mesh(device="cpu", **mesh_kw),
                     bucket_bytes=bucket_bytes, use_pcache=False,
                     **kw).init()
    if init is not None:
        scope = fluid.Scope()
        tio.params_from_numpy(scope, init, "cpu")
        tr.load_state_from(scope)
    return tr


def _local_digest(state):
    """A digest of this rank's own copies of the state (the local
    tensors of replicated DTensors)."""
    h = hashlib.sha256()
    for n in sorted(state):
        v = state[n]
        local = v.to_local() if hasattr(v, "to_local") else v
        h.update(n.encode())
        h.update(local.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _gathered(obj):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def overlapped_dp(rank, init, steps, bucket_bytes):
    """The overlapped dp step at the world's dp (4 ranks) from `init`:
    (step_mode, losses, final state, every rank's digest of its own
    state copy, every rank's digest of the skip_reduce twin's state,
    whether the twin left the trainer's state as it was)."""
    tr = trainer({}, init, bucket_bytes)
    losses = [float(tr.step(mlp_feeds(i))[0].reshape(-1)[0])
              for i in range(steps)]
    state = {n: tr.fetch_state(n) for n in sorted(tr.state)}
    before = _local_digest(tr.state)
    # the twin donates nothing (as obs.comm.overlap_report builds it):
    # a donating step writes its new state into the state it is given
    twin, _ = spmd_overlap.make_overlapped_dp_step(
        tr.main_program, tr.feed_names, tr._fetch_all, tr.mesh,
        tr._state_template, bucket_bytes=bucket_bytes, skip_reduce=True,
        donate_state=False)
    _fetches, twin_state = twin(tr.state, mlp_feeds(steps), None)
    unchanged = _local_digest(tr.state) == before
    return (tr.step_mode, losses, state, _gathered(before),
            _gathered(_local_digest(twin_state)), unchanged)


def overlap_capture(rank, init, steps, bucket_bytes):
    """The overlapped dp step at dp 4 from `init`, captured (donated),
    uncaptured, and captured with donate_state=False through
    make_overlapped_dp_step: {tag: (losses, every rank's digest of its
    final state, whether the state kept its local storage, (captures,
    replays) or None)}."""
    out = {}
    for tag in ("captured", "uncaptured", "nodonate"):
        tr = trainer({}, init, bucket_bytes, capture=tag != "uncaptured")
        if tag == "nodonate":
            tr._step_fn, _ = spmd_overlap.make_overlapped_dp_step(
                tr.main_program, tr.feed_names, tr._fetch_all, tr.mesh,
                tr._state_template, bucket_bytes=bucket_bytes,
                donate_state=False)
        ptrs = {n: v.to_local().data_ptr() for n, v in tr.state.items()}
        losses = [float(tr.step(mlp_feeds(i))[0].reshape(-1)[0])
                  for i in range(steps)]
        kept = all(v.to_local().data_ptr() == ptrs[n]
                   for n, v in tr.state.items())
        core = getattr(tr._step_fn, "captured", None)
        out[tag] = (tr.step_mode, losses, _gathered(_local_digest(tr.state)),
                    kept, core and (core.captures, core.replays))
    return out


def comm_observed(rank, init, bucket_bytes, ici_gbps):
    """One traced step of the overlapped trainer at dp 4 and what the
    obs.comm module makes of it: the schedule, the trace events of the
    step, the flight host context, the reduce seam's grad order,
    `measure_bucket_times` at `ici_gbps` and `measure_trainer_comm`'s
    rows, the registry's comm samples, `overlap_report`'s split and
    gauges, the platform class, and a dp 2 x mp 2 trainer's refused
    report."""
    from paddle_tpu_torch.obs import comm as obs_comm
    from paddle_tpu_torch.obs import flight as obs_flight
    from paddle_tpu_torch.obs import registry as obs_registry
    from paddle_tpu_torch.obs import trace as obs_trace

    obs_registry.reset_registry()
    obs_comm.reset()
    obs_trace.enable()
    tr = trainer({}, init, bucket_bytes)
    tr.step(mlp_feeds(0))
    sched = obs_comm.last_schedule()
    events = [dict(e) for e in obs_trace.events()]
    obs_trace.disable()
    obs_trace.reset()
    host_ctx = obs_flight.host_context()
    _split, grad_order = spmd_overlap._split_point(
        list(tr.main_program.desc.block(0).ops))

    grads = {n: np.zeros(tuple(v.shape), np.float32)
             for n, v in tr.state.items()
             if n in tr.plan.param_reasons and len(v.shape) > 0}
    timed = obs_comm.measure_bucket_times(tr.mesh, grads, bucket_bytes,
                                          reps=1, ici_gbps=ici_gbps)
    obs_registry.reset_registry()
    trainer_rep = obs_comm.measure_trainer_comm(tr, reps=1)
    reg = obs_registry.get_registry()
    hist = reg.histogram("comm_collective_seconds",
                         labelnames=("collective", "bucket"))
    ctr = reg.counter("comm_bytes_total", labelnames=("collective",))
    samples = {
        "hist_buckets": sorted({s["labels"]["bucket"]
                                for s in hist.samples()
                                if s["labels"].get("collective")
                                == "allreduce"}),
        "bytes_total": sum(s["value"] for s in ctr.samples()
                           if s["labels"]["collective"] == "allreduce"),
    }
    report = obs_comm.overlap_report(tr, mlp_feeds(0), reps=1,
                                     bucket_report=trainer_rep)
    gauges = {name: [s["value"] for s in reg.gauge(name).samples()]
              for name in ("comm_exposed_seconds", "overlap_efficiency")}
    report.pop("spans")
    fallback = obs_comm.overlap_report(
        trainer({"mp": 2}, None, bucket_bytes), mlp_feeds(0), reps=1)
    return {
        "step_mode": tr.step_mode,
        "plan_fingerprint": tr.plan.fingerprint(),
        "sched": sched,
        "events": events,
        "host_ctx": host_ctx,
        "grad_order": grad_order,
        "timed": timed,
        "trainer_rep": trainer_rep,
        "samples": samples,
        "report": report,
        "gauges": gauges,
        "platform_class": obs_comm._platform_class(tr.mesh),
        "fallback": fallback,
    }
