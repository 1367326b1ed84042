"""The port's fleet aggregation (`paddle_tpu_torch.obs.fleet`,
`tools/fleet_cli.py`, `distributed.start_fleet_reporter`, the launcher's
fleet view) and the cross-host half of `obs.comm` (`tools/comm_cli.py`)
against the JAX package's, on the CPU.

- The fleet cases of tests/test_obs_dist.py: the reporter singleton
  refusing contradicting arguments, and started by `init_multihost`
  where PADDLE_OBS_MASTER is set; the aggregator's merge, straggler
  verdict and gauges, newest snapshot winning, bad ingests; a real
  master carrying pushes, a corrupt one skipped, a stopped reporter's
  snapshot and gauges retired — each view against the JAX aggregator
  on the same payloads, and each package's aggregator reading the other
  package's pushes.
- The cross-host cases of tests/test_obs_comm.py: `merge_windows`
  against the JAX function on the same windows and offsets;
  `span_window_payload` against the JAX function on the same trace
  events; the clock-offset exchange recovering an injected skew (the
  JAX estimator against the port's responder too) and a silent host
  giving None; span windows pushed, collected and retired with the
  reporter, and the snapshot-age gauge.
- `comm_cli merge` of the same window files equal to the JAX CLI's
  trace, and `merge --master` over pushes; `comm_cli report` over 4
  gloo ranks (one spawn through `torch_ranks`) and at a world of one,
  where the overlapped step falls back with its reason;
  `comm_cli --selftest --use_gpu=0` (its own spawn of 4 ranks; its
  calibration leg fits the comm coefficient through the port's own
  `tune.fit` and prints it); `fleet_cli --push` and `--aggregate`
  against the JAX CLI's
  view of one master; the launcher's `print_fleet_view`.
"""

import contextlib
import io
import json
import os
import re
import time

import numpy as np
import pytest
import torch

from paddle_tpu import native as jnative
from paddle_tpu.obs import comm as jcomm
from paddle_tpu.obs import fleet as jfleet
from paddle_tpu.obs import registry as jregistry
from paddle_tpu.tools import comm_cli as jcomm_cli
from paddle_tpu.tools.obs_dump import validate_chrome_trace

from paddle_tpu_torch import native
from paddle_tpu_torch.distributed import coordinator
from paddle_tpu_torch.obs import comm as obs_comm
from paddle_tpu_torch.obs import fleet as obs_fleet
from paddle_tpu_torch.obs import registry as obs_registry
from paddle_tpu_torch.obs import telemetry as obs_tele
from paddle_tpu_torch.obs import trace as obs_trace
from paddle_tpu_torch.tools import cluster_launch
from paddle_tpu_torch.tools import comm_cli, fleet_cli

from torch_ranks import CaseFailed, run_cases

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh_obs():
    obs_registry.reset_registry()
    jregistry.reset_registry()
    obs_trace.disable()
    obs_trace.reset()
    yield
    obs_trace.disable()
    obs_trace.reset()


@pytest.fixture
def master():
    m = native.Master()
    yield m, "127.0.0.1:%d" % m.port
    m.stop()


def _snap(host, step_s, n_steps, ts=1.0):
    return {"host": host, "ts": ts, "metrics": {
        "trainer_step_seconds{trainer=v2}_sum": step_s * n_steps,
        "trainer_step_seconds{trainer=v2}_count": n_steps,
        "executor_runs_total": n_steps}}


def _gauges(reg):
    out = {}
    for name in ("fleet_host_step_ms", "fleet_straggler"):
        g = reg.gauge(name, labelnames=("host",))
        out[name] = {s["labels"]["host"]: s["value"] for s in g.samples()}
    out["fleet_hosts"] = reg.gauge("fleet_hosts").value
    return out


def _strip_ages(text):
    return [l for l in text.splitlines() if not l.startswith("# fleet host")]


# -- the reporter -------------------------------------------------------------

def test_start_fleet_reporter_rejects_conflicting_args():
    rep = obs_fleet.FleetReporter("127.0.0.1:1", host="a",
                                  interval_s=60.0)
    assert coordinator._fleet_reporter[0] is None
    coordinator._fleet_reporter[0] = rep
    try:
        assert coordinator.start_fleet_reporter() is rep
        assert coordinator.start_fleet_reporter(master="127.0.0.1:1",
                                                host="a") is rep
        with pytest.raises(RuntimeError):
            coordinator.start_fleet_reporter(master="other:2")
        with pytest.raises(RuntimeError):
            coordinator.start_fleet_reporter(host="b")
    finally:
        coordinator._fleet_reporter[0] = None
    # nothing named and no PADDLE_OBS_MASTER: reporting is opt-in
    assert coordinator.start_fleet_reporter() is None
    assert coordinator.stop_fleet_reporter() is None


def test_init_multihost_starts_the_reporter(master, monkeypatch):
    _m, addr = master
    monkeypatch.setenv("PADDLE_OBS_MASTER", addr)
    monkeypatch.setenv("PADDLE_FLEET_HOST", "worker7")
    try:
        assert coordinator.init_multihost() is False   # one process
        rep = coordinator._fleet_reporter[0]
        assert rep is not None and rep.host == "worker7"
        agg = jfleet.FleetAggregator()   # the JAX aggregator reads it
        assert agg.collect(addr) == 1 and agg.hosts() == ["worker7"]
    finally:
        assert coordinator.stop_fleet_reporter() is rep
    assert obs_fleet.FleetAggregator().collect(addr) == 0


# -- the aggregator -----------------------------------------------------------

def test_aggregator_merge_and_straggler_gauges_equal_jax():
    aggs = (obs_fleet.FleetAggregator(), jfleet.FleetAggregator())
    for agg in aggs:
        for payload in (_snap("host0", 0.010, 10),
                        _snap("host1", 0.011, 10),
                        _snap("host2", 0.100, 10)):   # the straggler
            agg.ingest(payload)
    report, jreport = (a.stragglers() for a in aggs)
    assert report == jreport
    assert report["flagged"] == ["host2"]
    assert report["step_ms"]["host2"] == pytest.approx(100.0)
    assert report["median_ms"] == pytest.approx(11.0)
    assert aggs[0].merged_samples() == aggs[1].merged_samples()
    assert aggs[0].merged_samples()["executor_runs_total{host=host0}"] == 10
    assert _strip_ages(aggs[0].render_text()) == \
        _strip_ages(aggs[1].render_text())
    assert "executor_runs_total{host=host1} 10" in aggs[0].render_text()
    assert _gauges(obs_registry.get_registry()) == \
        _gauges(jregistry.get_registry())
    assert obs_registry.get_registry().gauge("fleet_hosts").value == 3


def test_aggregator_newest_snapshot_wins_and_bad_ingest():
    agg = obs_fleet.FleetAggregator()
    agg.ingest(_snap("h", 0.2, 10, ts=2.0))
    agg.ingest(_snap("h", 0.1, 10, ts=1.0))   # older: ignored
    assert agg.step_times()["h"] == pytest.approx(200.0)
    with pytest.raises(ValueError):
        agg.ingest({"metrics": {}})            # no host
    agg.ingest({"host": "idle", "ts": 3.0,
                "metrics": {"executor_runs_total": 1}})
    assert "idle" not in agg.step_times()
    assert agg.stragglers()["flagged"] == []


def test_reporter_push_collect_roundtrip_across_packages(master):
    m, addr = master
    for _ in range(3):
        with obs_tele.step("fleet_test", examples=1):
            pass
    rep = obs_fleet.FleetReporter(addr, host="fast", interval_s=60.0)
    assert rep.push_once() and rep.push_once()   # the update path
    jrep = jfleet.FleetReporter(addr, host="jaxhost", interval_s=60.0)
    assert jrep.push_once()
    bad = native.MasterClient("127.0.0.1", m.port)
    assert bad.register("/obs/bad", "42", 60000) is not None
    bad.close()
    try:
        aggs = (obs_fleet.FleetAggregator(), jfleet.FleetAggregator())
        for agg in aggs:
            agg.ingest(_snap("slow", 0.5, 4, ts=time.time()))
            assert agg.collect(addr) == 2
            assert set(agg.hosts()) == {"fast", "jaxhost", "slow"}
        port_view = aggs[0].snapshots()["fast"]
        assert port_view["metrics"][
            "trainer_step_seconds{trainer=fleet_test}_count"] == 3
        assert aggs[0].stragglers()["flagged"] == ["slow"]
        rep.stop(unregister=True)
        jrep.stop(unregister=True)
        assert obs_fleet.FleetAggregator().collect(addr) == 0
        agg = aggs[0]
        assert agg.collect(addr) == 0 and agg.hosts() == ["slow"]
        agg.stragglers()
        host_ms = obs_registry.get_registry().gauge(
            "fleet_host_step_ms", labelnames=("host",))
        assert {s["labels"]["host"] for s in host_ms.samples()} == {"slow"}
    finally:
        rep.stop()
        jrep.stop()


def test_fleet_snapshot_age_from_ingest():
    agg = obs_fleet.FleetAggregator()
    agg.ingest({"host": "old", "ts": time.time() - 7.0, "metrics": {}})
    agg.stragglers()
    age = obs_registry.get_registry().gauge(
        "fleet_snapshot_age_seconds", labelnames=("host",))
    ages = {s["labels"]["host"]: s["value"] for s in age.samples()}
    assert ages["old"] >= 6.5


def test_names_equal_jax():
    assert sorted(obs_fleet.__all__) == sorted(jfleet.__all__)
    assert sorted(obs_comm.__all__) == sorted(jcomm.__all__)
    assert (obs_fleet.OBS_PREFIX, obs_fleet.MASTER_ENV,
            obs_fleet.DEFAULT_PUSH_PREFIXES) == (
        jfleet.OBS_PREFIX, jfleet.MASTER_ENV, jfleet.DEFAULT_PUSH_PREFIXES)


# -- the cross-host half of obs.comm ------------------------------------------

def _fake_window(host, epoch_wall, n=3):
    return {"host": host, "ts": epoch_wall + 1.0,
            "epoch_wall": epoch_wall, "dropped": 0,
            "events": [{"name": "step", "cat": "paddle_tpu",
                        "ph": "X", "ts": 1000.0 * i, "dur": 500.0,
                        "tid": 0} for i in range(n)]
            + [{"name": "mark", "cat": "c", "ph": "i", "ts": 7.0,
                "tid": 1, "s": "g", "args": {"k": 1}}]}


@pytest.mark.parametrize("offsets", [None, {"hostB": 0.5},
                                     {"hostA": -0.25, "hostB": 0.5}])
def test_merge_windows_equal_jax(offsets):
    windows = {"hostA": _fake_window("hostA", 100.0),
               "hostB": _fake_window("hostB", 100.5)}
    merged = obs_comm.merge_windows(windows, offsets)
    assert merged == jcomm.merge_windows(windows, offsets)
    events = validate_chrome_trace(merged)
    names = {e["args"]["name"]: e["pid"] for e in events
             if e.get("name") == "process_name"}
    assert names == {"hostA": 1, "hostB": 2}
    if offsets == {"hostB": 0.5}:
        a_ts = sorted(e["ts"] for e in events
                      if e.get("ph") == "X" and e["pid"] == 1)
        b_ts = sorted(e["ts"] for e in events
                      if e.get("ph") == "X" and e["pid"] == 2)
        assert a_ts == b_ts   # the skew cancelled
    assert obs_comm.merge_windows({}) == jcomm.merge_windows({})
    assert obs_comm.merge_windows([windows["hostB"]]) == \
        jcomm.merge_windows([windows["hostB"]])


def test_span_window_payload_equals_jax_on_the_same_events(monkeypatch):
    from paddle_tpu.obs import trace as jtrace

    obs_trace.enable()
    sched = obs_comm.record_schedule(
        "allreduce", "dp", [{"bucket": 0, "names": ["a@GRAD"],
                             "bytes": 64}])
    with obs_comm.schedule_span(sched):
        with obs_comm.bucket_span(sched, 0):
            pass
    events = obs_trace.events()
    payload = obs_comm.span_window_payload(host="me", limit=16)
    assert payload["host"] == "me" and payload["events"]
    assert -0.001 <= payload["ts"] - payload["epoch_wall"] < 3600
    assert all(e["ph"] in ("X", "i") for e in payload["events"])
    assert any(e["name"] == "comm/bucket" for e in payload["events"])
    # the JAX function over the same events gives the same rows
    monkeypatch.setattr(jtrace, "events", lambda: list(events))
    monkeypatch.setattr(jtrace, "dropped_events",
                        obs_trace.dropped_events)
    jpayload = jcomm.span_window_payload(host="me", limit=16)
    assert jpayload["events"] == payload["events"]
    assert jpayload["dropped"] == payload["dropped"]
    assert sorted(jpayload) == sorted(payload)


def test_clock_offset_recovery_over_lease_store(master):
    _m, addr = master
    responder = obs_comm.ClockResponder(addr, host="skewed", poll_s=0.02,
                                        skew_s=0.25).start()
    try:
        offsets = obs_comm.estimate_clock_offsets(addr, ["skewed"],
                                                  reps=2, timeout_s=5.0)
        assert offsets["skewed"] is not None \
            and abs(offsets["skewed"] - 0.25) < 0.2, offsets
        # the JAX estimator over the same store hears the port's pongs
        joff = jcomm.estimate_clock_offsets(addr, ["skewed"], reps=2,
                                            timeout_s=5.0)
        assert abs(joff["skewed"] - 0.25) < 0.2, joff
        silent = obs_comm.estimate_clock_offsets(addr, ["ghost"], reps=1,
                                                 timeout_s=0.3)
        assert silent["ghost"] is None
    finally:
        responder.stop()


def test_span_push_collect_reporter_lease_and_age_gauge(master):
    _m, addr = master
    obs_trace.enable()
    sched = obs_comm.record_schedule(
        "allreduce", "dp", [{"bucket": 0, "names": ["a@GRAD"],
                             "bytes": 64}])
    with obs_comm.schedule_span(sched):
        with obs_comm.bucket_span(sched, 0):
            pass
    reporter = None
    try:
        lease = obs_comm.push_span_window(addr, host="bare", limit=64)
        assert lease is not None
        assert obs_comm.push_span_window(addr, host="bare", limit=64,
                                         lease_prev=lease) is not None
        reporter = obs_fleet.FleetReporter(addr, host="ridden",
                                           interval_s=60.0, span_window=64)
        assert reporter.push_once() and reporter._span_lease is not None
        windows = obs_comm.collect_span_windows(addr)
        assert {"bare", "ridden"} <= set(windows)
        assert windows["bare"]["events"]
        assert windows["ridden"]["epoch_wall"] > 0
        assert jcomm.collect_span_windows(addr) == windows
        agg = obs_fleet.FleetAggregator()
        assert agg.collect(addr) >= 1
        agg.stragglers()
        age = obs_registry.get_registry().gauge(
            "fleet_snapshot_age_seconds", labelnames=("host",))
        ages = {s["labels"]["host"]: s["value"] for s in age.samples()}
        assert "ridden" in ages and ages["ridden"] >= 0
        reporter.stop(unregister=True)
        reporter = None
        agg.collect(addr)
        agg.stragglers()
        assert not any(s["labels"]["host"] == "ridden"
                       for s in age.samples())
        assert "ridden" not in obs_comm.collect_span_windows(addr)
    finally:
        if reporter is not None:
            reporter.stop(unregister=True)


# -- the CLIs -----------------------------------------------------------------

def test_comm_cli_merge_of_window_files_equals_jax(tmp_path, capsys):
    paths = []
    for host, wall in (("hostA", 100.0), ("hostB", 100.5)):
        p = str(tmp_path / ("%s.json" % host))
        with open(p, "w") as f:
            json.dump(_fake_window(host, wall), f)
        paths.append(p)
    outs = {}
    for name, cli in (("port", comm_cli), ("jax", jcomm_cli)):
        out = str(tmp_path / ("%s_trace.json" % name))
        assert cli.main(["merge", "--windows"] + paths
                        + ["--out", out, "--json"]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        with open(out) as f:
            outs[name] = (json.load(f), line["hosts"], line["events"])
    assert outs["port"] == outs["jax"]
    validate_chrome_trace(outs["port"][0])
    with pytest.raises(SystemExit, match="--master or --windows"):
        comm_cli.main(["merge"])


def test_comm_cli_merge_from_the_master(master, tmp_path, capsys):
    _m, addr = master
    obs_trace.enable()
    with obs_trace.span("work"):
        pass
    assert obs_comm.push_span_window(addr, host="h1") is not None
    responder = obs_comm.ClockResponder(addr, host="h1",
                                        poll_s=0.02).start()
    try:
        out = str(tmp_path / "merged.json")
        assert comm_cli.main(["merge", "--master", addr, "--out", out,
                              "--clock-reps", "1"]) == 0
    finally:
        responder.stop()
    assert "merged 1 host track(s) (h1)" in capsys.readouterr().out
    with open(out) as f:
        merged = json.load(f)
    validate_chrome_trace(merged)
    assert merged["otherData"]["hosts"] == ["h1"]
    assert abs(merged["otherData"]["clock_offsets"]["h1"]) < 0.2


def _report_rank(rank, argv):
    """`comm_cli report` in every rank of the group; rank 0's output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = comm_cli.main(argv)
    return rc, buf.getvalue()


def test_comm_cli_report_over_4_ranks(tmp_path):
    cal = str(tmp_path / "cal.json")
    got = run_cases({"report": (_report_rank, ([
        "report", "--use_gpu=0", "--json", "--reps", "1",
        "--calibration-out", cal],))}, 4, tmp_path)["report"]
    if isinstance(got, CaseFailed):
        pytest.fail("rank-side report raised:\n%s" % got)
    rc, out = got
    assert rc == 0, out
    doc = json.loads(out.strip().splitlines()[-1])
    rep = doc["overlap"]
    assert rep["supported"] and rep["step_mode"] == "overlap-dp"
    assert rep["step_s"] > 0 and rep["comm_s"] > 0
    assert doc["drift"]["n"] >= 2
    with open(cal) as f:
        blob = json.load(f)
    assert blob["kind"] == jcomm.COMM_CALIBRATION_KIND
    assert blob["platform_class"] == "cpu:d4"


def test_comm_cli_report_at_a_world_of_one(capsys):
    assert comm_cli.main(["report", "--use_gpu=0", "--reps", "1"]) == 2
    out = capsys.readouterr().out
    assert "overlap NOT measured: step_mode=gspmd (mesh has no dp axis " \
        "wider than 1)" in out
    assert not torch.distributed.is_initialized()


def test_comm_cli_selftest_on_the_cpu(capsys):
    assert comm_cli.main(["--selftest", "--use_gpu=0"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"\[pcomm\] calibration -> tune\.fit comm coefficient "
                     r"(\S+) \(the blob's comm_ratio (\S+) over", out)
    coef, ratio = re.search(r"comm coefficient (\S+) \(the blob's "
                            r"comm_ratio (\S+) over", out).groups()
    assert float(coef) == float(ratio) > 0
    assert "a foreign class keeps the analytic prior; a wrong-kind blob " \
        "is refused" in out
    assert "[pcomm] selftest green" in out and "4 gloo ranks" in out


def test_fleet_cli_push_and_aggregate_against_jax(master, capsys):
    _m, addr = master
    assert fleet_cli.main(["--push", "--master", addr, "--host", "pw",
                           "--steps", "2", "--step-ms", "1"]) == 0
    assert "[fleet] ok: pushed snapshot as pw" in capsys.readouterr().out
    views = {}
    for name, main in (("port", fleet_cli.main), ("jax", jfleet.main)):
        assert main(["--aggregate", "--master", addr, "--json"]) == 0
        views[name] = json.loads(capsys.readouterr().out)
    assert views["port"]["hosts"] == views["jax"]["hosts"] == ["pw"]
    assert views["port"]["samples"] == views["jax"]["samples"]
    assert views["port"]["straggler_report"] == \
        views["jax"]["straggler_report"]
    assert views["port"]["samples"][
        "trainer_step_seconds{host=pw,trainer=fleet_dryrun}_count"] == 2
    assert fleet_cli.main(["--aggregate", "--master", addr]) == 0
    assert "1 host snapshot(s)" in capsys.readouterr().out


def test_launcher_prints_the_fleet_view(master):
    m, addr = master
    out = io.StringIO()
    assert cluster_launch.print_fleet_view(m, out=out) is None
    assert out.getvalue() == ""
    rep = obs_fleet.FleetReporter(addr, host="trainer0", interval_s=60.0)
    assert rep.push_once()
    try:
        report = cluster_launch.print_fleet_view(m, out=out)
    finally:
        rep.stop()
    assert report is not None and "[cluster] fleet: 1 host snapshot(s)" \
        in out.getvalue()
    jout = io.StringIO()
    from paddle_tpu.tools import cluster_launch as jlaunch

    class _Port:
        port = 1   # nothing listens: the view says so, never raises

    assert cluster_launch.print_fleet_view(_Port(), out=out) is None
    assert jlaunch.print_fleet_view(_Port(), out=jout) is None
    assert "fleet view unavailable" in out.getvalue()
    assert "fleet view unavailable" in jout.getvalue()
