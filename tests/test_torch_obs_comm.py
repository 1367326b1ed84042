"""The port's collective observability (`paddle_tpu_torch.obs.comm`, its
in-process half) against the JAX package's, on the CPU.

- `record_schedule`, `comm_bucket_schedules_total` and `reset`; the
  `comm/bucketed_allreduce` span nesting one `comm/bucket` span per
  bucket with its bytes, member count and first name, bracketed by the
  launch/complete instants.
- The overlapped dp step at dp 4 (tests/test_obs_comm.py's probe MLP,
  24 KiB buckets) in ONE spawn of 4 gloo ranks: its bucket schedule
  equals the JAX step's at dp 4 (count, names, bytes, in the
  last-produced-first order of the reduce seam, `_split_point`), its
  spans nest and carry the JAX spans' arguments, the flight host
  context names rank, mesh and plan; `measure_bucket_times` rows have
  the JAX function's buckets, bytes, wire bytes and predicted seconds
  (both at the same `ici_gbps`), and `measure_trainer_comm`'s timed
  replays land in the registry; `overlap_report`'s split is consistent
  and its gauges published; a dp 2 x mp 2 trainer's report is refused
  without an `exposed_s`.
- `drift_report` and `calibration_blob` on one bucket report through
  both packages, equal; the blob's file read by the port's
  `tune.fit.load_comm_calibration` and the JAX package's alike, with
  their platform-class discipline.
- The cross-host half's names and key prefixes equal the JAX module's
  (its cases are in tests/test_torch_obs_fleet.py).
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.obs import comm as jcomm
from paddle_tpu.obs import registry as jregistry
from paddle_tpu.obs import trace as jtrace
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.spmd import SpmdTrainer as JSpmd
from paddle_tpu.tune import fit as jfit

from paddle_tpu_torch.obs import comm as obs_comm
from paddle_tpu_torch.obs import registry as obs_registry
from paddle_tpu_torch.obs import trace as obs_trace
from paddle_tpu_torch.tune import fit as tune_fit

import torch_parallel_cases as pcases
import torch_spmd_cases as cases
from torch_ranks import CaseFailed, run_cases

torch.set_num_threads(1)

BUCKET = 24 << 10
ICI_GBPS = 100.0
FEEDS = ["x", "label"]


@pytest.fixture(autouse=True)
def fresh_obs():
    obs_registry.reset_registry()
    obs_comm.reset()
    obs_trace.disable()
    obs_trace.reset()
    yield
    obs_trace.disable()
    obs_trace.reset()


@pytest.fixture(scope="module")
def jax_side():
    """The JAX overlapped trainer at dp 4, traced once: its initial
    state, schedule, events and `measure_bucket_times` at ICI_GBPS."""
    jtrace.enable()
    jcomm.reset()
    main, startup, avg = pcases.build_mlp(jfluid)
    tr = JSpmd(main, startup, feed_names=FEEDS, fetch_names=[avg.name],
               mesh=jmake_mesh(n_devices=4, dp=4), bucket_bytes=BUCKET,
               use_pcache=False).init()
    init = {n: np.array(v) for n, v in tr.state.items()}
    tr.step(pcases.mlp_feeds(0))
    sched = jcomm.last_schedule()
    events = [dict(e) for e in jtrace.events()]
    jtrace.disable()
    jtrace.reset()
    grads = {n: np.zeros(np.shape(v), np.float32)
             for n, v in tr.state.items()
             if n in tr.plan.param_reasons and np.ndim(v) > 0}
    timed = jcomm.measure_bucket_times(tr.mesh, grads, BUCKET, reps=1,
                                       ici_gbps=ICI_GBPS)
    jregistry.reset_registry()
    return {"init": init, "sched": sched, "events": events,
            "timed": timed, "mode": tr.step_mode}


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """The rank-side case of this file, in one spawn of 4 ranks."""
    todo = {"comm": (cases.comm_observed,
                     (jax_side["init"], BUCKET, ICI_GBPS))}
    return run_cases(todo, 4, tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def observed(ranks):
    got = ranks["comm"]
    if isinstance(got, CaseFailed):
        pytest.fail("rank-side case raised:\n%s" % got)
    return got


def _named(events, name):
    return [e for e in events if e.get("name") == name]


# -- schedule instrumentation ----------------------------------------------

def test_record_schedule_counter_and_reset():
    obs_trace.enable()
    buckets = [{"bucket": 0, "names": ["b@GRAD", "a@GRAD"], "bytes": 128},
               {"bucket": 1, "names": ["w@GRAD"], "bytes": 64}]
    sched = obs_comm.record_schedule("allreduce", "dp", buckets)
    assert sched == jcomm.record_schedule("allreduce", "dp", buckets)
    assert obs_comm.last_schedule() is sched
    assert sched["n_buckets"] == 2 and sched["total_bytes"] == 192
    ctr = obs_registry.get_registry().counter(
        "comm_bucket_schedules_total", labelnames=("collective",))
    assert {s["labels"]["collective"]: s["value"]
            for s in ctr.samples()} == {"allreduce": 1}
    assert _named(obs_trace.events(), "comm/schedule")
    with obs_comm.schedule_span(sched):
        for i in range(sched["n_buckets"]):
            with obs_comm.bucket_span(sched, i):
                pass
    evs = obs_trace.events()
    assert len(_named(evs, "comm/bucket")) == 2
    assert len(_named(evs, "comm/bucket_launch")) == 2
    assert len(_named(evs, "comm/bucket_complete")) == 2
    parent = _named(evs, "comm/bucketed_allreduce")[0]
    for child in _named(evs, "comm/bucket"):
        assert parent["ts"] <= child["ts"]
        assert child["ts"] + child["dur"] <= parent["ts"] + parent["dur"]
    obs_comm.reset()
    assert obs_comm.last_schedule() is None
    jcomm.reset()


def test_bucketed_allreduce_at_world_one():
    """At a world of one the ring is the identity: the outputs equal the
    inputs bit for bit, and the schedule's buckets are the JAX
    `grad_buckets`' over the grads in reverse order."""
    from paddle_tpu.parallel.ring import grad_buckets as jbuckets
    from paddle_tpu_torch.parallel import make_mesh, ring
    from paddle_tpu_torch.parallel.sharding import P, shard_map_norep

    rs = np.random.RandomState(0)
    grads = {"a@GRAD": rs.randn(3, 5).astype(np.float32),
             "b@GRAD": rs.randn(7).astype(np.float32),
             "c@GRAD": rs.randn(300).astype(np.float32)}
    def reduce(g):
        out = ring.bucketed_allreduce(g, 100)
        return tuple(out[n] for n in sorted(g))

    mesh = make_mesh(device="cpu")
    try:
        fn = shard_map_norep(
            reduce, mesh, in_specs=({n: P() for n in grads},),
            out_specs=tuple(P() for _ in grads))
        obs_trace.enable()
        out = fn({n: torch.from_numpy(v) for n, v in grads.items()})
    finally:
        torch.distributed.destroy_process_group()
    for n, o in zip(sorted(grads), out):
        np.testing.assert_array_equal(o.to_local().numpy(), grads[n])
    sched = obs_comm.last_schedule()
    sized = [(n, grads[n].nbytes) for n in reversed(sorted(grads))]
    assert [b["names"] for b in sched["buckets"]] == \
        jbuckets(sized, 100) == [["c@GRAD"], ["b@GRAD", "a@GRAD"]]
    assert [b["bytes"] for b in sched["buckets"]] == [1200, 88]
    assert len(_named(obs_trace.events(), "comm/bucket")) == 2


# -- the overlapped step at dp 4 --------------------------------------------

def test_schedule_equals_jax_and_names_last_produced_first(observed,
                                                           jax_side):
    sched = observed["sched"]
    assert observed["step_mode"] == jax_side["mode"] == "overlap-dp"
    assert sched == jax_side["sched"]
    assert sched["collective"] == "allreduce" and sched["axis"] == "dp"
    assert sched["mean"] and sched["n_buckets"] >= 2
    assert sched["total_bytes"] == sum(b["bytes"]
                                       for b in sched["buckets"])
    flat = [n for b in sched["buckets"] for n in b["names"]]
    want = [g for g in reversed(observed["grad_order"]) if g in set(flat)]
    assert flat == want


def test_span_nesting_bytes_labels_and_instants(observed, jax_side):
    sched, evs = observed["sched"], observed["events"]
    (parent,) = _named(evs, "comm/bucketed_allreduce")
    (jparent,) = _named(jax_side["events"], "comm/bucketed_allreduce")
    assert parent["args"] == jparent["args"]
    bspans = _named(evs, "comm/bucket")
    assert [e["args"] for e in bspans] == \
        [e["args"] for e in _named(jax_side["events"], "comm/bucket")]
    for i, e in enumerate(bspans):
        assert e["args"]["bucket"] == i
        assert e["args"]["bytes"] == sched["buckets"][i]["bytes"] > 0
        assert e["args"]["first"] == sched["buckets"][i]["names"][0]
        assert parent["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= parent["ts"] + parent["dur"]
    assert len(_named(evs, "comm/bucket_launch")) == \
        len(_named(evs, "comm/bucket_complete")) == sched["n_buckets"]
    (seam,) = _named(evs, "comm/reduce_seam")
    (jseam,) = _named(jax_side["events"], "comm/reduce_seam")
    assert seam["args"] == jseam["args"]


def test_trainer_stamps_flight_host_context(observed):
    ctx = observed["host_ctx"]
    assert ctx["process_index"] == 0 and ctx["host"]
    assert ctx["mesh_axes"] == {"dp": 4, "mp": 1}
    assert ctx["plan_fingerprint"] == observed["plan_fingerprint"]


def test_measure_bucket_times_rows_equal_jax(observed, jax_side):
    rep, jrep = observed["timed"], jax_side["timed"]
    keys = ("bucket", "names", "bytes", "wire_bytes", "pred_s")
    assert [{k: r[k] for k in keys} for r in rep["buckets"]] == \
        [{k: r[k] for k in keys} for r in jrep["buckets"]]
    for k in ("collective", "axis", "n", "bucket_bytes", "pred_s",
              "wire_bytes"):
        assert rep[k] == jrep[k], k
    assert rep["n"] == 4 and len(rep["buckets"]) >= 2
    for r in rep["buckets"]:
        assert r["measured_s"] > 0 and r["wire_bytes"] > r["bytes"]
        assert r["ratio"] == r["measured_s"] / r["pred_s"]
    assert rep["measured_s"] == pytest.approx(
        sum(r["measured_s"] for r in rep["buckets"]))


def test_measure_trainer_comm_metrics(observed):
    rep = observed["trainer_rep"]
    assert rep["collective"] == "allreduce" and rep["n"] == 4
    assert [str(r["bucket"]) for r in rep["buckets"]] == \
        observed["samples"]["hist_buckets"]
    # reps=1: one timed replay per bucket
    assert observed["samples"]["bytes_total"] == rep["wire_bytes"]
    # the trainer's gradient volume at the port's own link rate
    from paddle_tpu_torch.analysis.costmodel import DEFAULT_ICI_GBPS

    assert rep["pred_s"] == pytest.approx(
        rep["wire_bytes"] / (DEFAULT_ICI_GBPS * 1e9))


def test_overlap_report_split_and_gauges(observed):
    rep = observed["report"]
    assert rep["supported"] and rep["step_mode"] == "overlap-dp"
    assert rep["plan_fingerprint"] == observed["plan_fingerprint"]
    assert rep["bucket_bytes"] == BUCKET
    assert rep["step_s"] > 0 and rep["compute_s"] > 0
    assert rep["comm_s"] == pytest.approx(
        observed["trainer_rep"]["measured_s"])
    assert rep["exposed_s"] >= 0
    assert 0.0 <= rep["overlap_efficiency"] <= 1.0
    assert rep["exposed_s"] + rep["hidden_s"] == \
        pytest.approx(rep["comm_s"]) or rep["exposed_s"] >= rep["comm_s"]
    gauges = observed["gauges"]
    assert gauges["comm_exposed_seconds"][0] == pytest.approx(
        rep["exposed_s"], abs=1e-6)
    assert gauges["overlap_efficiency"][0] == pytest.approx(
        rep["overlap_efficiency"], abs=1e-4)
    assert observed["platform_class"] == "cpu:d4"


def test_overlap_report_fallback_carries_no_exposed_s(observed):
    rep = observed["fallback"]
    assert not rep["supported"] and rep["step_mode"] == "gspmd"
    assert "not pure data-parallel" in rep["overlap_fallback_reason"]
    assert rep["plan_fingerprint"]
    assert "exposed_s" not in rep and "overlap_efficiency" not in rep


# -- drift -> calibration blob ----------------------------------------------

_BUCKET_REPORT = {
    "collective": "allreduce", "axis": "dp", "n": 8,
    "bucket_bytes": 1 << 10, "measured_s": 0.0035, "pred_s": 0.0015,
    "wire_bytes": 2625,
    "buckets": [
        {"bucket": 0, "names": ["b", "a"], "bytes": 1000,
         "wire_bytes": 1750, "pred_s": 0.001, "measured_s": 0.002,
         "ratio": 2.0},
        {"bucket": 1, "names": ["w"], "bytes": 500, "wire_bytes": 875,
         "pred_s": 0.0005, "measured_s": 0.0015, "ratio": 3.0},
    ],
}


def test_drift_report_rows_and_gauge():
    drift = obs_comm.drift_report(_BUCKET_REPORT)
    assert drift == jcomm.drift_report(_BUCKET_REPORT)
    assert drift["n"] == 2 and drift["median_ratio"] == 2.5
    gauge = obs_registry.get_registry().gauge(
        "comm_estimate_ratio", labelnames=("bucket",))
    assert {s["labels"]["bucket"]: s["value"]
            for s in gauge.samples()} == {"0": 2.0, "1": 3.0}
    assert obs_comm.drift_report(None) == jcomm.drift_report(None)
    assert obs_comm.drift_report(None)["n"] == 0


def test_calibration_blob_roundtrip_and_class_discipline(tmp_path):
    blob = obs_comm.calibration_blob(
        _BUCKET_REPORT, platform_class="gpu:d8:dp=8", model="mlp")
    assert blob == jcomm.calibration_blob(
        _BUCKET_REPORT, platform_class="gpu:d8:dp=8", model="mlp")
    assert blob["kind"] == obs_comm.COMM_CALIBRATION_KIND
    assert blob["n"] == 2 and blob["comm_ratio"] == 2.5
    path = str(tmp_path / "comm_cal.json")
    obs_comm.save_calibration(blob, path)
    with open(path) as f:
        assert json.load(f) == blob
    pairs = tune_fit.load_comm_calibration(path)
    assert pairs == jfit.load_comm_calibration(path)
    assert len(pairs) == 2 and pairs[0]["leg"].endswith("bucket0")
    assert tune_fit.fit_calibration(
        [], comm_pairs=pairs).coef["comm"] == pytest.approx(2.5)
    assert tune_fit.fit_calibration([], comm_pairs=pairs).to_dict() == \
        jfit.fit_calibration([], comm_pairs=pairs).to_dict()
    foreign = [{"leg": "ptune:x", "measured_s": 0.1,
                "meas_compute_s": 0.08, "overhead_s": 0.01,
                "platform_class": "cpu:d8:dp=8"}]
    cal = tune_fit.fit_calibration(foreign, comm_pairs=pairs)
    assert cal.coef["comm"] == 1.0 and "kept analytic" in cal.note
    assert cal.to_dict() == \
        jfit.fit_calibration(foreign, comm_pairs=pairs).to_dict()
    assert obs_comm.calibration_blob({"buckets": []}) is None
    assert obs_comm.calibration_blob(None, platform_class="x") is None
    # without a class, this process's: no group up, no card here
    assert obs_comm.calibration_blob(_BUCKET_REPORT)["platform_class"] \
        == "cpu:d1"


def test_cross_host_half_waits_with_the_fleet():
    assert sorted(obs_comm.__all__) == sorted(jcomm.__all__)
    assert (obs_comm.SPAN_PREFIX, obs_comm.CLOCK_PING_PREFIX,
            obs_comm.CLOCK_PONG_PREFIX) == (
        jcomm.SPAN_PREFIX, jcomm.CLOCK_PING_PREFIX,
        jcomm.CLOCK_PONG_PREFIX)
    # the half came with obs/fleet.py: every name is callable, and a
    # merge of no windows is the JAX function's empty trace
    for name in ("span_window_payload", "push_span_window",
                 "collect_span_windows", "merge_windows",
                 "estimate_clock_offsets", "ClockResponder"):
        assert callable(getattr(obs_comm, name))
    assert obs_comm.merge_windows({}) == jcomm.merge_windows({})
