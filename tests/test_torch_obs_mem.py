"""The port's memory observability (`obs/mem.py`) against the JAX
package's on the same programs, case by case against
tests/test_obs_mem.py: the static timeline, its Chrome counter track,
the drift join and its calibration blob, the donation audit, the OOM
pre-flight and post-mortem, the gauge retirement on program-cache
eviction, the memory regression gate and the bench blob, S005's blame
and the serving /healthz memory section.

Each program is built by both packages' own layers in fresh Program
pairs, so the var names agree, and the timelines, peaks, top buffers and
audits equal the JAX package's.  The JAX drift joins each segment's
static peak with XLA's `memory_analysis()`; the port's joins it with the
graph pool bytes of the card's captures.  The CPU holds no pool, so
`test_static_peak_within_pinned_factor_of_xla` is a join test: each
label's actual side is injected as the JAX package's XLA bytes for the
same segment, and the port's ratios equal the JAX ratios, within the
pinned factor; the card's own reading is chip_smoke.py's phase 27.
"""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.obs import health as jhealth
from paddle_tpu.obs import mem as jmem
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.compile import pcache
from paddle_tpu_torch.obs import flight as obs_flight
from paddle_tpu_torch.obs import health as obs_health
from paddle_tpu_torch.obs import mem as obs_mem
from paddle_tpu_torch.obs import perf as obs_perf
from paddle_tpu_torch.obs import registry as obs_registry
from paddle_tpu_torch.obs import telemetry as obs_tele
from paddle_tpu_torch.utils import flags as pt_flags

torch.set_num_threads(1)
CPU = fluid.CPUPlace()

# the pinned static-vs-actual factor of tests/test_obs_mem.py
PINNED_FACTOR = 4.0


@pytest.fixture(autouse=True)
def _reset_mem_state():
    obs_mem.reset()
    obs_registry.reset_registry()
    pcache.reset()
    yield
    obs_mem.reset()
    pt_flags.set_flag("mem_budget_gb", 0.0)


def _build_lenet5(pkg, batch=8):
    from importlib import import_module

    zoo = import_module(pkg.__name__.replace(".fluid", "") + ".models")
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        image = pkg.layers.data(
            name="image", shape=[batch, 1, 28, 28], dtype="float32",
            append_batch_size=False)
        logits = zoo.lenet5(image, class_dim=10)
        label = pkg.layers.data(
            name="label", shape=[batch, 1], dtype="int64",
            append_batch_size=False)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, label))
        pkg.optimizer.MomentumOptimizer(
            learning_rate=0.01, momentum=0.9).minimize(loss)
    feeds = {"image": np.random.RandomState(0)
             .rand(batch, 1, 28, 28).astype("float32"),
             "label": np.random.RandomState(1)
             .randint(0, 10, (batch, 1)).astype("int64")}
    return main, startup, loss, feeds


def _build_mlp(pkg, batch=16):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[batch, 256], dtype="float32",
                            append_batch_size=False)
        h = pkg.layers.fc(input=x, size=512, act="relu")
        h = pkg.layers.fc(input=h, size=256, act="relu")
        y = pkg.layers.fc(input=h, size=10)
        label = pkg.layers.data(name="label", shape=[batch, 1],
                                dtype="int64", append_batch_size=False)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(y, label))
        pkg.optimizer.MomentumOptimizer(
            learning_rate=0.01, momentum=0.9).minimize(loss)
    feeds = {"x": np.random.RandomState(0)
             .rand(batch, 256).astype("float32"),
             "label": np.random.RandomState(1)
             .randint(0, 10, (batch, 1)).astype("int64")}
    return main, startup, loss, feeds


def _build_adam_toy(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[64], dtype="float32")
        h = pkg.layers.fc(input=x, size=32)
        cost = pkg.layers.mean(x=h)
        pkg.optimizer.AdamOptimizer(learning_rate=0.01).minimize(cost)
    return main, startup, cost


def _run_captured(main, startup, loss, feeds, steps=2):
    """Steps under force_attribution: the static side registered at plan
    time, the second step captures (the CPU's plain version)."""
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    with obs_health.force_attribution():
        for _ in range(steps):
            exe.run(main, feed=feeds, fetch_list=[loss], scope=scope)
    return exe, scope


def _jrun_captured(main, startup, loss, feeds):
    scope = JScope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup, scope=scope)
        with jhealth.force_attribution():
            exe.run(main, feed=feeds, fetch_list=[loss], scope=scope)


def _inject_jax_actuals():
    """Each port label the JAX store joined gets the JAX XLA bytes as
    its pool bytes; the program row gets their sum."""
    jstore = jmem.segments()
    total = 0
    for label, e in obs_mem.segments().items():
        if label in jstore and "xla_program_bytes" in jstore[label]:
            b = jstore[label]["xla_program_bytes"]
            obs_mem.on_compile_captured(label, {"graph_pool_bytes": b},
                                        first=True)
            total += b
    for label in obs_mem.segments():
        if label.startswith(obs_mem.PROGRAM_PREFIX):
            obs_mem.on_compile_captured(label,
                                        {"graph_pool_bytes": total})
    return jstore


def _timeline_keys(tl):
    return {k: tl[k] for k in ("ops", "op_types", "series", "peak_bytes",
                               "peak_op", "peak_op_type", "params_bytes",
                               "total_peak_bytes", "top_buffers")}


# ---------------------------------------------------------------------------
# static timeline
# ---------------------------------------------------------------------------

def test_timeline_matches_peak_walk():
    """liveness_peak_bytes is the timeline's peak (one shared walk), and
    both equal the JAX package's."""
    from paddle_tpu.analysis.dataflow import liveness_timeline as jwalk
    from paddle_tpu_torch.analysis.dataflow import (liveness_peak_bytes,
                                                    liveness_timeline)

    main, _startup, loss, _ = _build_lenet5(fluid)
    jmain, _js, jloss, _ = _build_lenet5(jfluid)
    bd = main.desc.block(0)
    final = {n for n, vd in bd.vars.items() if vd.persistable}
    final.add(loss.name)

    def nbytes(name):
        vd = bd.vars.get(name)
        if vd is None or vd.persistable or vd.shape is None:
            return 0
        return int(np.prod([max(s, 1) for s in vd.shape])) * 4

    tl = liveness_timeline(bd.ops, nbytes, final, top_n=4)
    peak, peak_op = liveness_peak_bytes(bd.ops, nbytes, final)
    assert tl["peak_bytes"] == peak and tl["peak_op"] == peak_op
    assert len(tl["series"]) == len(bd.ops)
    assert max(tl["series"]) == peak
    sizes = [b["bytes"] for b in tl["top_buffers"]]
    assert sizes == sorted(sizes, reverse=True) and sizes[0] > 0
    for b in tl["top_buffers"]:
        assert b["def_op"] is None or b["def_op"] <= peak_op
    assert tl == jwalk(jmain.desc.block(0).ops, nbytes, final, top_n=4)


@pytest.mark.parametrize("build", [_build_lenet5, _build_mlp,
                                   lambda p: _build_adam_toy(p) + (None,)],
                         ids=["lenet5", "mlp", "adam_toy"])
def test_program_timeline_and_render(build):
    main, _startup, loss, _ = build(fluid)
    jmain, _js, jloss, _ = build(jfluid)
    tl = obs_mem.program_timeline(main, fetches=[loss.name], top_n=5)
    assert tl["ops"] == len(main.desc.block(0).ops)
    assert tl["peak_bytes"] > 0 and tl["params_bytes"] > 0
    assert tl["total_peak_bytes"] == tl["peak_bytes"] + tl["params_bytes"]
    assert tl["peak_op_type"] == tl["op_types"][tl["peak_op"]]
    text = obs_mem.render_timeline(tl)
    assert "<- peak" in text
    assert tl["top_buffers"][0]["name"] in text
    jtl = jmem.program_timeline(jmain, fetches=[jloss.name], top_n=5)
    assert _timeline_keys(tl) == _timeline_keys(jtl)
    assert text == jmem.render_timeline(jtl)


def test_timeline_chrome_trace_counter_track(tmp_path):
    from paddle_tpu_torch.tools.obs_dump import validate_chrome_trace

    main, _startup, loss, _ = _build_lenet5(fluid)
    tl = obs_mem.program_timeline(main, fetches=[loss.name])
    path = str(tmp_path / "mem_trace.json")
    obs_mem.timeline_chrome_trace(tl, path=path)
    events = validate_chrome_trace(path)
    counters = [ev for ev in events if ev["ph"] == "C"]
    assert len(counters) == tl["ops"]
    assert max(ev["args"]["live_bytes"] for ev in counters) \
        == tl["peak_bytes"]
    jmain, _js, jloss, _ = _build_lenet5(jfluid)
    jdoc = jmem.timeline_chrome_trace(
        jmem.program_timeline(jmain, fetches=[jloss.name]))
    assert [e for e in events if e["ph"] != "M"] == \
        [e for e in jdoc["traceEvents"] if e["ph"] != "M"]


# ---------------------------------------------------------------------------
# the drift join: static estimate against actuals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("build", [_build_lenet5, _build_mlp],
                         ids=["lenet5", "mlp"])
def test_static_peak_within_pinned_factor_of_xla(build):
    """The CPU holds no pool: a captured run registers the static side
    and joins nothing; with the JAX package's XLA bytes injected as the
    same segments' actuals, the port's ratios are the JAX ratios, within
    the pinned factor, and the program row joins their sum."""
    main, startup, loss, feeds = build(fluid)
    exe, _scope = _run_captured(main, startup, loss, feeds)
    assert exe.captures >= 1
    assert not obs_mem.drift_report()["n"]
    jmain, jstartup, jloss, jfeeds = build(jfluid)
    _jrun_captured(jmain, jstartup, jloss, jfeeds)
    jstore = _inject_jax_actuals()
    rep = obs_mem.drift_report()
    jrep = jmem.drift_report()
    rows = {r["segment"]: r for r in rep["segments"]}
    jrows = [r for r in jrep["segments"] if r["ratio"]]
    assert jrows, "the JAX run joined nothing"
    for jr in jrows:
        row = rows[jr["segment"]]
        assert row["static_peak_bytes"] == jr["static_peak_bytes"]
        assert row["pool_bytes"] == jr["xla_program_bytes"]
        assert row["ratio"] == jr["ratio"]
        assert 1.0 / PINNED_FACTOR <= row["ratio"] <= PINNED_FACTOR, row
        assert row["top_buffers"] == jstore[jr["segment"]]["top_buffers"]
    program = [r for r in rep["segments"] if r["scope"] == "program"]
    assert len(program) == 1 and rep["basis"] == "program"
    assert rep["median_ratio"] == program[0]["ratio"]
    assert rep["first_segment_median_ratio"] == jrep["median_ratio"]
    snap = {k for k in obs_tele.snapshot()
            if k.startswith("mem_estimate_ratio{")}
    assert snap, "mem_estimate_ratio gauge never published"


def test_store_dump_load_roundtrip(tmp_path):
    main, startup, loss, feeds = _build_lenet5(fluid)
    _run_captured(main, startup, loss, feeds)
    for label, e in obs_mem.segments().items():
        obs_mem.on_compile_captured(
            label, {"graph_pool_bytes": 2 * e["static_peak_bytes"]})
    path = str(tmp_path / "store.json")
    obs_mem.dump_store(path)
    offline = obs_mem.drift_report(obs_mem.load_store(path))
    live = obs_mem.drift_report()
    assert offline["n"] == live["n"] > 0
    assert offline["median_ratio"] == live["median_ratio"] == 2.0
    with pytest.raises(ValueError):
        bad = str(tmp_path / "bad.json")
        with open(bad, "w") as f:
            json.dump({"kind": "other"}, f)
        obs_mem.load_store(bad)


def test_calibration_blob_feeds_ptune(tmp_path):
    from paddle_tpu.tune.fit import load_hbm_calibration as jload
    from paddle_tpu_torch.tune.fit import (MEM_CALIBRATION_KIND,
                                           load_hbm_calibration)

    assert MEM_CALIBRATION_KIND is obs_mem.MEM_CALIBRATION_KIND \
        == jmem.MEM_CALIBRATION_KIND
    main, startup, loss, feeds = _build_lenet5(fluid)
    _run_captured(main, startup, loss, feeds)
    for label, e in obs_mem.segments().items():
        obs_mem.on_compile_captured(
            label, {"graph_pool_bytes": 3 * e["static_peak_bytes"]})
    rep = obs_mem.drift_report()
    blob = obs_mem.calibration_blob(rep, model="lenet5")
    assert blob["kind"] == obs_mem.MEM_CALIBRATION_KIND
    assert blob["basis"] == "program"
    path = str(tmp_path / "cal.json")
    obs_mem.save_calibration(blob, path)
    ratio = load_hbm_calibration(path)
    assert ratio == rep["median_ratio"] == 3.0
    assert jload(path) == ratio  # the JAX tuner reads the port's blob
    with pytest.raises(ValueError):
        bad = str(tmp_path / "notcal.json")
        with open(bad, "w") as f:
            json.dump({"kind": "something"}, f)
        load_hbm_calibration(bad)


def test_rank_applies_hbm_ratio():
    """A measured ratio scales the static peak before the S005 budget
    check: a budget the analytic peak fits busts under ratio 10."""
    from paddle_tpu_torch.tune import models as tune_models
    from paddle_tpu_torch.tune import rank as tune_rank
    from paddle_tpu_torch.tune.space import SearchSpace

    builder = tune_models.builder("lenet5")
    cands = SearchSpace(1, meshes=["dp=1"], pipelines=["none"],
                        batches=[8], micro_batches=[1]).points()
    analytic = tune_rank.rank(builder, cands, 1, model="lenet5",
                              hbm_gb=1.0, bf16_act=False)
    assert analytic.ranked and not analytic.rejected
    budget_gb = (analytic.ranked[0].peak_hbm_bytes * 3) / 2 ** 30
    calibrated = tune_rank.rank(builder, cands, 1, model="lenet5",
                                hbm_gb=budget_gb, bf16_act=False,
                                hbm_ratio=10.0)
    assert not calibrated.ranked and calibrated.rejected
    rej = calibrated.rejected[0]
    assert rej.code == "S005" and "calibration" in rej.message


# ---------------------------------------------------------------------------
# donation audit
# ---------------------------------------------------------------------------

def _same_audit(got, want):
    """Equal audits; a refusal's reason is the port's own wording (it
    names the update, where the JAX package's names XLA)."""
    for k in ("ops", "jit_segments", "mode", "effective_mode", "widened",
              "donated_bytes", "reclaimable_bytes"):
        assert got[k] == want[k], k
    assert got["donated"] == want["donated"]

    def strip(items):
        return [{k: v for k, v in r.items() if k != "reason"}
                for r in items]

    assert strip(got["reclaimable"]) == strip(want["reclaimable"])
    assert all(r["reason"] for r in got["reclaimable"])


def test_donation_audit_clean_program():
    main, _startup, cost = _build_adam_toy(fluid)
    jmain, _js, jcost = _build_adam_toy(jfluid)
    audit = obs_mem.audit_donation(main, fetches=[cost.name])
    assert audit["donated"] and audit["donated_bytes"] > 0
    assert not audit["reclaimable"]
    donated_names = {d["name"] for d in audit["donated"]}
    assert any(n.endswith("moment1_0") for n in donated_names)
    assert any(d["kind"] == "param" for d in audit["donated"])
    _same_audit(audit, jmem.audit_donation(jmain, fetches=[jcost.name]))


def _fork(pkg, main):
    desc_mod = __import__(pkg.__name__.replace(".fluid", "")
                          + ".core.desc", fromlist=["VarDesc"])
    bd = main.desc.block(0)
    for od in bd.ops:
        if od.type == "adam":
            forked = od.input("Moment1")[0]
            src = bd.vars[forked]
            fork = forked + "__fork"
            bd.vars[fork] = desc_mod.VarDesc(fork, src.type, src.dtype,
                                             src.shape, persistable=True)
            od.outputs["Moment1Out"] = [fork]
            return forked
    return None


def test_donation_audit_finds_forked_adam_slot():
    main, _startup, cost = _build_adam_toy(fluid)
    jmain, _js, jcost = _build_adam_toy(jfluid)
    forked = _fork(fluid, main)
    assert forked and _fork(jfluid, jmain) == forked
    audit = obs_mem.audit_donation(main, fetches=[cost.name])
    hits = [r for r in audit["reclaimable"] if r["name"] == forked]
    assert hits and hits[0]["bytes"] > 0
    assert hits[0]["kind"] == "optimizer_state"
    assert "forks" in hits[0]["reason"]
    assert audit["reclaimable_bytes"] >= hits[0]["bytes"]
    text = obs_mem.render_audit(audit)
    assert "RECLAIM" in text and forked in text
    _same_audit(audit, jmem.audit_donation(jmain, fetches=[jcost.name]))


def test_donation_audit_dropped_alias():
    """A declared in-place out slot missing from the op strands the
    input buffer: the 'dropped alias' class."""
    main, _startup, cost = _build_adam_toy(fluid)
    jmain, _js, jcost = _build_adam_toy(jfluid)
    name = None
    for prog in (main, jmain):
        for od in prog.desc.block(0).ops:
            if od.type == "adam":
                name = od.input("Moment2")[0]
                del od.outputs["Moment2Out"]
                break
    audit = obs_mem.audit_donation(main, fetches=[cost.name])
    hits = [r for r in audit["reclaimable"] if r["name"] == name]
    assert hits and "absent" in hits[0]["reason"]
    _same_audit(audit, jmem.audit_donation(jmain, fetches=[jcost.name]))


# ---------------------------------------------------------------------------
# OOM pre-flight + post-mortem
# ---------------------------------------------------------------------------

def test_oom_context_is_empty_for_non_oom():
    assert obs_mem.oom_context(ValueError("boom")) == {}
    assert obs_mem.is_oom(MemoryError("x"))
    assert obs_mem.is_oom(RuntimeError("RESOURCE_EXHAUSTED: hbm"))
    assert not obs_mem.is_oom(RuntimeError("shape mismatch"))
    # the card's out-of-memory error, by type and by its message
    assert obs_mem.is_oom(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 96.00 GiB"))
    assert obs_mem.is_oom(RuntimeError("CUDA out of memory. Tried to "
                                       "allocate 2.00 GiB"))


def test_preflight_budget_and_flight_bundle(tmp_path):
    main, startup, loss, feeds = _build_lenet5(fluid)
    jmain, _js, jloss, _ = _build_lenet5(jfluid)
    tl = obs_mem.program_timeline(main, fetches=[loss.name], top_n=8)
    jtl = jmem.program_timeline(jmain, fetches=[jloss.name], top_n=8)
    recorder = obs_flight.install(out_dir=str(tmp_path), capacity=8)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    try:
        exe.run(startup, scope=scope)
        pt_flags.set_flag("mem_budget_gb", 1e-6)
        with pytest.raises(obs_mem.MemoryBudgetError) as ei:
            exe.run(main, feed=feeds, fetch_list=[loss], scope=scope,
                    use_program_cache=False)
        assert "RESOURCE_EXHAUSTED" in str(ei.value)
        assert ei.value.timeline is not None
        # refused before any eager run or capture: not planned
        assert exe.captures == 0
        assert all(d is not main.desc for d, _v, _c in
                   exe._cache.values())
        with pytest.raises(obs_mem.MemoryBudgetError):
            exe.run(main, feed=feeds, fetch_list=[loss], scope=scope)
        # a budget the program fits runs
        pt_flags.set_flag("mem_budget_gb", 16.0)
        exe.run(main, feed=feeds, fetch_list=[loss], scope=scope)
    finally:
        pt_flags.set_flag("mem_budget_gb", 0.0)
        obs_flight.uninstall()
    bundle = recorder.last_bundle_path
    assert bundle and os.path.exists(bundle)
    with open(bundle) as f:
        doc = json.load(f)
    ooms = [n["oom"] for n in doc["notes"] if n.get("oom")]
    assert ooms, "flight bundle carries no oom note"
    # the bundle's top blamed buffer is the static timeline's peak
    # resident, and the JAX package's
    assert ooms[0]["top_buffers"][0]["name"] == \
        tl["top_buffers"][0]["name"] == jtl["top_buffers"][0]["name"]
    from paddle_tpu_torch.tools.obs_dump import render_flight

    rendered = render_flight(bundle)
    assert "OOM post-mortem" in rendered
    assert tl["top_buffers"][0]["name"] in rendered


def test_a_device_oom_blames_the_program_that_ran(tmp_path, monkeypatch):
    """A CUDA out of memory raised inside a run leaves a bundle whose
    oom note blames the program that ran (under FLAGS_compile_passes
    the rewritten clone)."""
    from paddle_tpu_torch.fluid import executor as executor_mod

    main, startup, loss, feeds = _build_lenet5(fluid)
    recorder = obs_flight.install(out_dir=str(tmp_path), capacity=8)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    real = executor_mod._CompiledProgram.run

    def oom(self, *a, **k):
        if self.fetch_names == [loss.name]:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried "
                                              "to allocate 80.00 GiB")
        return real(self, *a, **k)

    monkeypatch.setattr(executor_mod._CompiledProgram, "run", oom)
    pt_flags.set_flag("compile_passes", "default")
    try:
        exe.run(startup, scope=scope)
        with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
            exe.run(main, feed=feeds, fetch_list=[loss], scope=scope)
    finally:
        pt_flags.set_flag("compile_passes", "")
        obs_flight.uninstall()
    ran = list(exe._cache.values())[-1][2].desc
    assert ei.value._mem_program is ran and ran is not main.desc
    with open(recorder.last_bundle_path) as f:
        doc = json.load(f)
    ooms = [n["oom"] for n in doc["notes"] if n.get("oom")]
    assert ooms, "flight bundle carries no oom note"
    tl = obs_mem.program_timeline(ran, fetches=[loss.name], top_n=8)
    assert ooms[0]["top_buffers"] == tl["top_buffers"]


# ---------------------------------------------------------------------------
# gauge retirement on program-cache eviction
# ---------------------------------------------------------------------------

def _segment_gauge_labels(name):
    fam = obs_registry.get_registry().gauge(name, labelnames=("segment",))
    return {dict(s.get("labels", {})).get("segment")
            for s in fam.samples()}


def test_segment_gauges_retired_on_eviction():
    main, startup, loss, feeds = _build_lenet5(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe._CACHE_MAX = 1  # evict on the second program
    exe.run(startup, scope=scope)
    with obs_health.force_attribution():
        for _ in range(2):
            exe.run(main, feed=feeds, fetch_list=[loss], scope=scope)
    assert _segment_gauge_labels("mem_static_peak_bytes"), \
        "attribution run published no mem gauges"
    labels_before = _segment_gauge_labels("graph_capture_seconds")
    assert labels_before
    for label, e in obs_mem.segments().items():
        obs_mem.on_compile_captured(label, {"graph_pool_bytes": 1 << 20})
    main2, startup2, loss2, feeds2 = _build_mlp(fluid)
    scope2 = fluid.Scope()
    exe.run(startup2, scope=scope2)
    exe.run(main2, feed=feeds2, fetch_list=[loss2], scope=scope2)
    lenet_labels = {l for l in labels_before if "conv2d" in (l or "")}
    assert lenet_labels
    for fam in ("graph_capture_seconds", "mem_static_peak_bytes",
                "mem_pool_bytes", "mem_estimate_ratio"):
        assert not (_segment_gauge_labels(fam) & lenet_labels), \
            "evicted segment labels still render in %s" % fam
    assert not (set(obs_mem.segments()) & lenet_labels)
    assert not any("conv2d" in l for l in obs_mem.segments())


def test_eviction_keeps_labels_shared_with_live_program():
    """Labels do not depend on shapes: evicting one of two structurally
    identical programs must not retire the survivor's gauges."""
    main_a, startup_a, loss_a, feeds = _build_lenet5(fluid)
    main_b, startup_b, loss_b, _ = _build_lenet5(fluid)
    init_exe = fluid.Executor(CPU)  # keeps the startups out
    exe = fluid.Executor(CPU)       # of the tiny cache
    exe._CACHE_MAX = 1
    scope_a, scope_b = fluid.Scope(), fluid.Scope()
    init_exe.run(startup_a, scope=scope_a)
    with obs_health.force_attribution():
        for _ in range(2):
            exe.run(main_a, feed=feeds, fetch_list=[loss_a],
                    scope=scope_a)
    labels = _segment_gauge_labels("mem_static_peak_bytes")
    assert labels
    seconds = _segment_gauge_labels("graph_capture_seconds")
    init_exe.run(startup_b, scope=scope_b)
    exe.run(main_b, feed=feeds, fetch_list=[loss_b], scope=scope_b)
    assert _segment_gauge_labels("mem_static_peak_bytes") == labels
    assert _segment_gauge_labels("graph_capture_seconds") >= seconds


# ---------------------------------------------------------------------------
# history + regression gate (the bench memory blob)
# ---------------------------------------------------------------------------

def _mem_record(value, peak_bytes, platform="gpu"):
    return {"metric": "resnet50_train_imgs_per_sec_batch128",
            "value": value, "unit": "img/s", "step_ms": 50.0,
            "amp_bf16": True, "platform": platform,
            "memory": {"static_peak_bytes": peak_bytes,
                       "xla_total_bytes": peak_bytes,
                       "estimate_ratio": 1.0}}


def test_normalize_record_forwards_memory():
    from paddle_tpu.obs import perf as jperf

    rec = _mem_record(2400.0, 1 << 30)
    norm = obs_perf.normalize_record(rec, leg="default-b128")
    assert norm["memory"]["xla_total_bytes"] == 1 << 30
    assert norm["memory"]["estimate_ratio"] == 1.0
    assert norm["memory"] == jperf.normalize_record(
        rec, leg="default-b128")["memory"]
    # the port's pool bytes are kept beside them
    rec["memory"]["pool_bytes"] = 1 << 29
    assert obs_perf.normalize_record(rec)["memory"]["pool_bytes"] == 1 << 29
    rec = _mem_record(2400.0, 1 << 30)
    del rec["memory"]
    assert "memory" not in obs_perf.normalize_record(rec)


def test_gate_memory_regression_opt_in():
    base = 1 << 30
    records = [obs_perf.normalize_record(_mem_record(2400.0, base), ts=i)
               for i in range(4)]
    records.append(obs_perf.normalize_record(
        _mem_record(2400.0, int(base * 1.4)), ts=9))
    assert obs_perf.gate_history(records).ok
    result = obs_perf.gate_history(records, mem_tolerance=0.10)
    assert not result.ok
    assert result.failures[0]["kind"] == "memory"
    assert "peak memory" in result.failures[0]["why"]
    ok = obs_perf.gate_history(records[:-1], mem_tolerance=0.10)
    assert ok.ok


def test_gate_memory_never_mixes_keys():
    """A candidate with static bytes only never gates its static peak
    against a baseline of another key."""
    base = 1 << 30
    records = []
    for i in range(4):
        r = obs_perf.normalize_record(_mem_record(2400.0, base), ts=i)
        del r["memory"]["static_peak_bytes"]
        records.append(r)
    cand = obs_perf.normalize_record(
        _mem_record(2400.0, int(base * 0.5)), ts=9)
    del cand["memory"]["xla_total_bytes"]
    records.append(cand)
    assert obs_perf.gate_history(records, mem_tolerance=0.10).ok
    cand["memory"]["static_peak_bytes"] = int(base * 2)
    assert obs_perf.gate_history(records, mem_tolerance=0.10).ok
    for r in records[:-1]:
        r["memory"]["static_peak_bytes"] = base
    result = obs_perf.gate_history(records, mem_tolerance=0.10)
    assert not result.ok
    assert "static_peak_bytes" in result.failures[0]["why"]


def test_bench_memory_blob_shapes():
    main, _startup, loss, _feeds = _build_lenet5(fluid)
    jmain, _js, jloss, _ = _build_lenet5(jfluid)
    blob = obs_mem.bench_memory_blob(main, fetches=[loss.name])
    assert blob["static_peak_bytes"] == \
        blob["params_bytes"] + blob["activation_peak_bytes"]
    assert "estimate_ratio" not in blob  # no capture given
    jblob = jmem.bench_memory_blob(jmain, fetches=[jloss.name])
    assert blob == jblob
    blob2 = obs_mem.bench_memory_blob(main, fetches=[loss.name],
                                      pool_stats={"pool_bytes": 1600})
    assert blob2["pool_bytes"] == 1600
    # actual/static, the direction of mem_estimate_ratio
    assert blob2["estimate_ratio"] == round(
        1600 / blob2["activation_peak_bytes"], 4)


# ---------------------------------------------------------------------------
# S005 blame + the serving /healthz memory section
# ---------------------------------------------------------------------------

def test_s005_cites_top_peak_buffers():
    from paddle_tpu import analysis as janalysis
    from paddle_tpu_torch import analysis

    main, _startup, loss, _feeds = _build_mlp(fluid)
    jmain, _js, jloss, _ = _build_mlp(jfluid)
    plan = analysis.analyze_sharding(main, {"dp": 4, "mp": 2},
                                     fetches=[loss.name], hbm_gb=1e-6)
    errs = [d for d in plan.report.errors if d.code == "S005"]
    assert errs
    top = plan.hbm_breakdown["top_buffers"]
    assert top and top[0]["bytes"] > 0
    assert "top resident" in errs[0].message
    assert top[0]["name"] in errs[0].message
    jplan = janalysis.analyze_sharding(jmain, {"dp": 4, "mp": 2},
                                       fetches=[jloss.name], hbm_gb=1e-6,
                                       publish=False)
    assert top == jplan.hbm_breakdown["top_buffers"]


def test_serving_healthz_memory_section():
    """The JAX CPU warmup records per-bucket XLA bytes; the port's CPU
    warmup captures no pool, so its /healthz has no memory section
    until a bucket's pool bytes are recorded (the card's warmup records
    them).  A server lists its own engine's buckets, not another
    engine's in the same process."""
    from paddle_tpu_torch.fluid import io as fluid_io
    from paddle_tpu_torch.serving import (EngineConfig, InferenceEngine,
                                          InferenceServer, ServerConfig)

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[8], dtype="float32")
        probs = fluid.layers.fc(input=img, size=3, act="softmax")
    scope = fluid.Scope()
    fluid.Executor(CPU).run(startup, scope=scope)
    program = fluid_io.prune_program(main, [probs])
    engine = InferenceEngine(program, ["img"], [probs], scope=scope,
                             place=CPU,
                             config=EngineConfig(batch_buckets=[2, 4]))
    server = InferenceServer(engine, ServerConfig(port=0, warmup=False))
    engine.warmup()
    assert engine.last_warmup_stats["captures"] == 2
    assert engine.last_warmup_stats["bucket_captures"] == {2: 1, 4: 1}
    assert engine.last_warmup_stats["bucket_pool_bytes"] == {}
    assert "memory" not in server.health_signals()
    other = InferenceEngine(program, ["img"], [probs], scope=scope,
                            place=CPU,
                            config=EngineConfig(batch_buckets=[4, 32]))
    assert other.mem_label != engine.mem_label
    obs_mem.record_bucket_bytes(4, 7, engine=other.mem_label)
    obs_mem.record_bucket_bytes(32, 0, engine=other.mem_label)
    assert "memory" not in server.health_signals()
    for bucket in (2, 4):
        obs_mem.record_bucket_bytes(bucket, bucket << 20,
                                    engine=engine.mem_label)
    body = server.health_signals()
    buckets = body["memory"]["bucket_pool_bytes"]
    assert buckets == {"2": 2 << 20, "4": 4 << 20}
    assert InferenceServer(other, ServerConfig(port=0, warmup=False)) \
        .health_signals()["memory"]["bucket_pool_bytes"] == {"4": 7,
                                                              "32": 0}
    snap = {k for k in obs_tele.snapshot()
            if k.startswith("mem_bucket_pool_bytes{")}
    assert len(snap) == 4


# ---------------------------------------------------------------------------
# the operator CLI (tools/mem_cli.py)
# ---------------------------------------------------------------------------

def test_mem_cli_selftest_on_the_cpu(capsys):
    from paddle_tpu_torch.tools import mem_cli

    assert mem_cli.main(["--selftest", "--use_gpu=0"]) == 0
    out = capsys.readouterr().out
    assert "[pmem] selftest green" in out
    # the CPU holds no pool: the join is checked on injected bytes
    assert "injected pool bytes (the CPU holds no pool)" in out


def test_mem_cli_commands(tmp_path, capsys):
    """timeline (the JAX CLI's render for the same program), audit, and
    drift: on the CPU a run joins nothing (exit 2); a stored capture
    with pool bytes joins and writes the calibration the tuner reads."""
    from paddle_tpu.tools import mem_cli as jmem_cli
    from paddle_tpu_torch.tools import mem_cli
    from paddle_tpu_torch.tune.fit import load_hbm_calibration

    trace = str(tmp_path / "mem.json")
    assert mem_cli.main(["timeline", "--f32", "--trace-out", trace]) == 0
    out = capsys.readouterr().out
    assert "<- peak" in out and os.path.exists(trace)
    assert jmem_cli.main(["timeline", "--f32"]) == 0
    jout = capsys.readouterr().out
    assert out.splitlines()[1:-1] == jout.splitlines()[1:]
    assert mem_cli.main(["audit", "--f32"]) == 0
    assert "nothing to reclaim" in capsys.readouterr().out
    assert mem_cli.main(["drift", "--f32", "--use_gpu=0"]) == 2
    capsys.readouterr()
    for label, e in obs_mem.segments().items():
        obs_mem.on_compile_captured(
            label, {"graph_pool_bytes": 2 * e["static_peak_bytes"]})
    store = str(tmp_path / "store.json")
    obs_mem.dump_store(store)
    cal = str(tmp_path / "cal.json")
    assert mem_cli.main(["drift", "--store", store, "--calibration-out",
                         cal]) == 0
    assert "calibration written" in capsys.readouterr().out
    assert load_hbm_calibration(cal) == 2.0
