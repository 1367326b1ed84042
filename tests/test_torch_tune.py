"""The port's autotuner (`paddle_tpu_torch.tune`, `tools/tune_cli.py`)
against the JAX package's on the CPU, at lenet5's widths and at
ResNet-50 with `image_size=32`.

- space: the same `SearchSpace` arguments give equal points, tags,
  `to_dict()`, skipped points, pipeline ids, config blobs and
  `bench_env` in both packages.
- rank: with the same explicit peaks and budget, the same candidates
  ranked and rejected (S002 from an injected batch-36 candidate, S005
  at 1e-6 GiB citing bytes), the compute and overhead terms, the peak
  memory and its breakdown and the wire bytes within a relative 1e-9.
  The comm term prices the same wire bytes at the port's NVLink 450
  GB/s where the JAX package prices them at its 90 GB/s ICI, so the
  comm seconds agree after that ratio, and the port's order is the one
  the JAX terms give at the port's bandwidth.
- fit: the same records give exactly equal coefficients and errors;
  calibration files, pmem and pcomm blobs read across the packages.
- auto_remat: a candidate whose pipeline holds it is priced over its
  rewritten program, lower in activation peak and higher in compute,
  as the JAX tuner prices it.
- the CLI's plan is byte-identical across two fresh processes;
  `measure_plan` on the CPU measures the top-2 lenet5 candidates into a
  history that `join_history` pairs; the leg and the CLI raise without
  CUDA unless asked for the CPU.
- the builder's one copy: `spmd.bench.run_leg` and `shard_cli` build
  through `tune.models`, equal to the JAX builder's programs.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from paddle_tpu.analysis import costmodel as jcostmodel
from paddle_tpu.obs import comm as jcomm
from paddle_tpu.obs import mem as jmem
from paddle_tpu.tune import fit as jfit
from paddle_tpu.tune import models as jmodels
from paddle_tpu.tune import rank as jrank
from paddle_tpu.tune import space as jspace

from paddle_tpu_torch import kernels as tkernels
from paddle_tpu_torch.analysis import costmodel as tcostmodel
from paddle_tpu_torch.obs import comm as tcomm
from paddle_tpu_torch.obs import perf as tperf
from paddle_tpu_torch.tune import fit as tfit
from paddle_tpu_torch.tune import leg as tleg
from paddle_tpu_torch.tune import measure as tmeasure
from paddle_tpu_torch.tune import models as tmodels
from paddle_tpu_torch.tune import rank as trank
from paddle_tpu_torch.tune import space as tspace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-9
# the JAX package's ICI and the port's NVLink bandwidth, GB/s
COMM_RATIO = tcostmodel.DEFAULT_ICI_GBPS / jcostmodel.DEFAULT_ICI_GBPS
PEAKS = dict(peak_tflops=197.0, hbm_gbps=819.0)

torch.set_num_threads(1)


def _close(a, b):
    return abs(a - b) <= RTOL * max(abs(a), abs(b))


# ---------------------------------------------------------------------------
# space
# ---------------------------------------------------------------------------

SPACES = {
    "default": dict(chips=8),
    "constrained": dict(chips=8, batches=[12, 32], micro_batches=[1, 2],
                        pipelines=["none"]),
    "three_axes": dict(chips=4, axes=("dp", "mp", "sp"), batches=[16],
                       micro_batches=[1, 4]),
    "knobs": dict(chips=4, meshes=["dp=4"], batches=[64],
                  micro_batches=[1],
                  pipelines=["none", "default+fuse+auto_remat"],
                  fusion_caps=[0, 4], remat_strides=[0, 4]),
    "dedupe": dict(chips=4, meshes=["dp=4"], batches=[64],
                   micro_batches=[1], pipelines=["default+auto_remat"],
                   remat_strides=[0, 8]),
    "pinned": dict(chips=4, meshes=["dp=4"], batches=[64],
                   micro_batches=[1], pipelines=["fuse:cap=2"],
                   fusion_caps=[0, 4]),
    "repeats": dict(chips=4, meshes=["dp=4"], batches=[64],
                    micro_batches=[1],
                    pipelines=["dce,fuse,dce", "fuse,dce,fuse"],
                    fusion_caps=[0, 4]),
    "resnet_cell": dict(chips=8, batches=[256], micro_batches=[1, 2],
                        pipelines=["none", "default"]),
}


@pytest.mark.parametrize("name", sorted(SPACES))
def test_space_points_equal_jax(name):
    kw = SPACES[name]
    tsp, jsp = tspace.SearchSpace(**kw), jspace.SearchSpace(**kw)
    tpts, jpts = tsp.points(), jsp.points()
    assert [c.tag() for c in tpts] == [c.tag() for c in jpts]
    assert tpts
    for t, j in zip(tpts, jpts):
        assert t.to_dict() == j.to_dict()
        assert t.pipeline_id() == j.pipeline_id()
        assert t.config("lenet5") == j.config("lenet5")
        assert t.bench_env("lenet5") == j.bench_env("lenet5")
        assert (t.n_devices, t.dp, t.per_device_batch) == \
            (j.n_devices, j.dp, j.per_device_batch)
    assert tsp.to_dict() == jsp.to_dict()
    assert dict(tsp.skipped) == dict(jsp.skipped)


def test_mesh_shapes_and_construction_errors_equal_jax():
    for chips, axes in ((8, ("dp", "mp")), (1, ("dp", "mp")),
                        (12, ("dp", "mp", "sp"))):
        assert tspace.mesh_shapes_for(chips, axes=axes) == \
            jspace.mesh_shapes_for(chips, axes=axes)
    for kw, match in ((dict(meshes=["dp=4,mp=1"]), "axis product"),
                      (dict(pipelines=["dce,not_a_pass"]), "unknown pass"),
                      (dict(fusion_caps=[1]), "fusion_caps"),
                      (dict(remat_strides=[-1]), "remat_strides"),
                      (dict(pipelines=["default+fuse:cap=1"]), "cap")):
        for mod in (tspace, jspace):
            with pytest.raises(ValueError, match=match):
                mod.SearchSpace(8, **kw)


# ---------------------------------------------------------------------------
# rank
# ---------------------------------------------------------------------------

RANK_CASES = {
    "lenet5": dict(model="lenet5", image_size=None,
                   meshes=["dp=8,mp=1", "dp=4,mp=2", "dp=2,mp=4"],
                   batches=[32, 64], micro=[1, 2]),
    "resnet50_32": dict(model="resnet50", image_size=32,
                        meshes=["dp=8,mp=1", "dp=2,mp=4"], batches=[32],
                        micro=[1, 2]),
}


def _rank(pkg, case, hbm_gb=16, extra=()):
    space_mod, rank_mod, models_mod = pkg
    space = space_mod.SearchSpace(
        8, meshes=case["meshes"], batches=case["batches"],
        micro_batches=case["micro"], pipelines=["none", "default"])
    cands = space.points() + [space_mod.Candidate(*c) for c in extra]
    return rank_mod.rank(
        models_mod.builder(case["model"], image_size=case["image_size"]),
        cands, 8, model=case["model"], hbm_gb=hbm_gb,
        space_dict=space.to_dict(), skipped=space.skipped, **PEAKS)


PORT = (tspace, trank, tmodels)
JAX = (jspace, jrank, jmodels)
# batch 36 does not split over dp=8: the analyzer's S002
BAD = ("dp=8,mp=1", "", 36, 1)


@pytest.fixture(scope="module", params=sorted(RANK_CASES))
def ranked(request):
    case = RANK_CASES[request.param]
    return (_rank(PORT, case, extra=[BAD]), _rank(JAX, case, extra=[BAD]),
            case)


def test_rank_prices_equal_jax(ranked):
    tplan, jplan, _case = ranked
    assert tplan.ranked and len(tplan.ranked) == len(jplan.ranked)
    jby = {e.candidate.tag(): e for e in jplan.ranked}
    assert set(jby) == {e.candidate.tag() for e in tplan.ranked}
    for e in tplan.ranked:
        j = jby[e.candidate.tag()]
        assert _close(e.terms["compute_s"], j.terms["compute_s"])
        assert _close(e.terms["overhead_s"], j.terms["overhead_s"])
        assert _close(e.terms["comm_s"] * COMM_RATIO, j.terms["comm_s"])
        assert e.comm_wire_bytes == j.comm_wire_bytes
        assert _close(e.peak_hbm_bytes, j.peak_hbm_bytes)
        assert e.hbm_breakdown == j.hbm_breakdown
        assert e.warnings == j.warnings
    # the port's order is the one the JAX terms give at the port's link
    identity = trank.Calibration.identity()

    def at_port_link(j):
        terms = dict(j.terms, comm_s=j.terms["comm_s"] / COMM_RATIO)
        return (identity.apply(terms), j.candidate.tag())

    assert [e.candidate.tag() for e in tplan.ranked] == \
        [j.candidate.tag() for j in sorted(jplan.ranked, key=at_port_link)]
    for e in tplan.ranked:
        assert _close(e.predicted_step_s, at_port_link(jby[
            e.candidate.tag()])[0])


def test_rank_rejections_equal_jax(ranked):
    tplan, jplan, _case = ranked
    bad = tspace.Candidate(*BAD).tag()
    assert [(r.candidate.tag(), r.code) for r in tplan.rejected] == \
        [(r.candidate.tag(), r.code) for r in jplan.rejected] == \
        [(bad, "S002")]
    assert bad not in [e.candidate.tag() for e in tplan.ranked]
    d = tplan.to_dict()
    assert d["context"]["peak_tflops"] == PEAKS["peak_tflops"]
    assert d["context"]["hbm_gbps"] == PEAKS["hbm_gbps"]
    jd = jplan.to_dict()
    assert d["space"] == jd["space"] and d["rejected"] == jd["rejected"]


@pytest.mark.parametrize("name", sorted(RANK_CASES))
def test_rank_s005_budget_equal_jax(name):
    case = dict(RANK_CASES[name], meshes=["dp=8,mp=1"], micro=[1, 2])
    tplan = _rank(PORT, case, hbm_gb=1e-6)
    jplan = _rank(JAX, case, hbm_gb=1e-6)
    assert not tplan.ranked and tplan.rejected
    assert [r.to_dict() for r in tplan.rejected] == \
        [r.to_dict() for r in jplan.rejected]
    for r in tplan.rejected:
        assert r.code == "S005" and r.peak_hbm_bytes > 0
        assert "params" in r.message and "activation peak" in r.message
        assert "exceeds" in r.message and "budget" in r.message


def test_rank_defaults_to_the_cards_peaks():
    space = tspace.SearchSpace(8, meshes=["dp=8,mp=1"], batches=[32],
                               micro_batches=[1], pipelines=["none"])
    for bf16, peak in ((True, 989.0), (False, 67.0)):
        plan = trank.rank(tmodels.builder("lenet5"), space.points(), 8,
                          model="lenet5", bf16_act=bf16)
        assert plan.context["peak_tflops"] == peak
        assert plan.context["hbm_gbps"] == 3350.0


def test_auto_remat_candidate_raises_naming_a5():
    """Named for what the candidate once did (it raised naming A5): the
    port's `auto_remat` now rewrites through fluid/recompute.py, so the
    candidate is priced over its rewritten program, as the JAX test
    `tests/test_tune.py::test_rank_prices_auto_remat_with_reduced_
    activation_peak` holds the JAX tuner: a lower activation peak and
    peak memory than the unoptimized candidate, a higher compute term;
    and every term and the breakdown equal the JAX plan's."""
    space = tspace.SearchSpace(
        8, meshes=["dp=8,mp=1"], batches=[32], micro_batches=[1],
        pipelines=["none", "default+auto_remat:stride=2:budget_gb=0"])
    jspace_ = jspace.SearchSpace(
        8, meshes=["dp=8,mp=1"], batches=[32], micro_batches=[1],
        pipelines=["none", "default+auto_remat:stride=2:budget_gb=0"])
    plan = trank.rank(tmodels.builder("lenet5"), space.points(), 8,
                      model="lenet5", hbm_gb=16, **PEAKS)
    jplan = jrank.rank(jmodels.builder("lenet5"), jspace_.points(), 8,
                       model="lenet5", hbm_gb=16, **PEAKS)
    assert len(plan.ranked) == 2 and not plan.rejected
    by_pipe = {e.candidate.pipeline_label: e for e in plan.ranked}
    remat = by_pipe["dce,fold,cse,dve,auto_remat:budget_gb=0.0:stride=2"]
    raw = by_pipe["none"]
    assert remat.hbm_breakdown["activation_peak_bytes"] \
        < raw.hbm_breakdown["activation_peak_bytes"]
    assert remat.peak_hbm_bytes < raw.peak_hbm_bytes
    assert remat.terms["compute_s"] > raw.terms["compute_s"]
    jby = {e.candidate.pipeline_label: e for e in jplan.ranked}
    for label, e in by_pipe.items():
        j = jby[label]
        assert e.hbm_breakdown == j.hbm_breakdown
        assert _close(e.terms["compute_s"], j.terms["compute_s"])
        assert _close(e.peak_hbm_bytes, j.peak_hbm_bytes)


# ---------------------------------------------------------------------------
# fit and calibrations
# ---------------------------------------------------------------------------

def _records(plan, scale=50.0, platform="gpu"):
    """Measurements `scale` times the proxy floor, plus rows fit must
    skip: a stale re-emit, a foreign leg, an unknown tag."""
    out = []
    for i, e in enumerate(plan.ranked):
        meas = (e.terms["compute_s"] * e.candidate.n_devices
                / e.candidate.dp + e.terms["overhead_s"]) * scale
        out.append({"leg": "ptune:" + e.candidate.tag(),
                    "step_ms": meas * 1e3 * (1.0 + 0.01 * i),
                    "platform": platform, "metric": "m", "value": 1.0})
    tag = plan.ranked[0].candidate.tag()
    out += [{"leg": "ptune:" + tag, "step_ms": 999.0,
             "platform": "tpu-stale"},
            {"leg": "default-b128", "step_ms": 51.8, "platform": "gpu"},
            {"leg": "ptune:dp8.mp1-b99-mb1-none", "step_ms": 1.0,
             "platform": "gpu"}]
    return out


def test_fit_equals_jax_exactly():
    tplan = _rank(PORT, RANK_CASES["lenet5"])
    plan_dict = json.loads(tplan.to_json())
    records = _records(tplan)
    tpairs = tfit.join_history(plan_dict, records)
    jpairs = jfit.join_history(plan_dict, records)
    assert tpairs == jpairs and len(tpairs) == len(tplan.ranked)
    # the plan object's terms are unrounded, the JSON's rounded to 1e-6 ms
    assert [p["tag"] for p in tfit.join_history(tplan, records)] == \
        [p["tag"] for p in tpairs]
    comm = [{"leg": "multichip:dp=8", "measured_s": 0.004, "pred_s": 0.001,
             "wire_bytes": 10, "platform_class": "gpu:d1"},
            {"leg": "multichip:dp=4", "measured_s": 0.003, "pred_s": 0.002,
             "wire_bytes": 10, "platform_class": "gpu:d1"}]
    for n, comm_pairs in ((len(tpairs), None), (len(tpairs), comm),
                          (1, None), (2, None), (0, comm), (0, None)):
        tcal = tfit.fit_calibration(tpairs[:n], model="lenet5",
                                    comm_pairs=comm_pairs)
        jcal = jfit.fit_calibration(jpairs[:n], model="lenet5",
                                    comm_pairs=comm_pairs)
        assert tcal.coef == jcal.coef
        assert (tcal.bias_s, tcal.n, tcal.error_before,
                tcal.error_after, tcal.note) == \
            (jcal.bias_s, jcal.n, jcal.error_before, jcal.error_after,
             jcal.note)
        assert tcal.to_dict() == jcal.to_dict()
        assert tfit.format_fit_report(tcal, tpairs[:n]) == \
            jfit.format_fit_report(jcal, jpairs[:n])
    cal = tfit.fit_calibration(tpairs, model="lenet5")
    assert cal.error_after < cal.error_before
    # a foreign class drops out of the fit, as the JAX fit drops it
    mixed = [dict(p, platform_class="cpu:d1") for p in tpairs[:2]] + tpairs
    assert tfit.fit_calibration(mixed).to_dict() == \
        jfit.fit_calibration(mixed).to_dict()


def test_calibration_files_cross_both_ways(tmp_path):
    kw = dict(coef={"compute": 2.0, "overhead": 3.0}, bias_s=0.001, n=4,
              model="lenet5", error_before=0.5, error_after=0.05,
              note="n")
    for write, read in ((trank, jrank), (jrank, trank)):
        path = str(tmp_path / ("%s.json" % write.__name__))
        write.Calibration(**kw).save(path)
        loaded = read.Calibration.load(path)
        assert loaded.to_dict() == write.Calibration(**kw).to_dict()
    # a calibrated rank moves the prediction in both packages alike
    case = dict(RANK_CASES["lenet5"], meshes=["dp=8,mp=1"], micro=[1])
    base = _rank(PORT, case)
    cal = trank.Calibration(**kw)
    space = tspace.SearchSpace(8, meshes=case["meshes"], batches=[32],
                               micro_batches=[1], pipelines=["none"])
    calibrated = trank.rank(tmodels.builder("lenet5"), space.points(), 8,
                            model="lenet5", calibration=cal, **PEAKS)
    tag = calibrated.ranked[0].candidate.tag()
    assert calibrated.entry(tag).predicted_step_s != \
        base.entry(tag).predicted_step_s
    assert calibrated.to_dict()["calibration"] == cal.to_dict()
    with pytest.raises(ValueError, match="unknown calibration term"):
        trank.Calibration(coef={"wires": 2.0})


def test_pmem_and_pcomm_blobs_cross_both_ways(tmp_path):
    assert tfit.MEM_CALIBRATION_KIND == jmem.MEM_CALIBRATION_KIND
    drift = {"n": 3, "median_ratio": 1.25,
             "segments": [{"segment": "s%d" % i, "ratio": r}
                          for i, r in enumerate((1.2, 1.25, 1.4))]}
    mem_path = str(tmp_path / "mem_cal.json")
    jmem.save_calibration(jmem.calibration_blob(drift, model="m"),
                          mem_path)
    assert tfit.load_hbm_calibration(mem_path) == \
        jfit.load_hbm_calibration(mem_path) == 1.25
    report = {"buckets": [
        {"bucket": 0, "bytes": 1000, "wire_bytes": 1750, "pred_s": 0.001,
         "measured_s": 0.002, "ratio": 2.0},
        {"bucket": 1, "bytes": 500, "wire_bytes": 875, "pred_s": 0.0005,
         "measured_s": 0.0015, "ratio": 3.0}]}
    for blob_mod, save_mod in ((tcomm, tcomm), (jcomm, jcomm)):
        path = str(tmp_path / ("comm_%s.json" % blob_mod.__name__))
        save_mod.save_calibration(blob_mod.calibration_blob(
            report, platform_class="gpu:d8:dp=8", model="m"), path)
        tp, jp = tfit.load_comm_calibration(path), \
            jfit.load_comm_calibration(path)
        assert tp == jp and len(tp) == 2
        assert tfit.fit_calibration([], comm_pairs=tp).coef["comm"] == 2.5
    for loader in (tfit.load_hbm_calibration, tfit.load_comm_calibration):
        with pytest.raises(ValueError):
            loader(mem_path if loader is tfit.load_comm_calibration
                   else path)


# ---------------------------------------------------------------------------
# the CLI, the measurement leg, measure_plan
# ---------------------------------------------------------------------------

PLAN_ARGS = ["plan", "--model", "lenet5", "--chips", "8", "--hbm-gb", "80",
             "--batches", "32", "--micro-batches", "1,2",
             "--pipelines", "none,default", "--json"]


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.update(kw)
    return env


def test_cli_plan_byte_identical_across_processes():
    outs = []
    for _ in range(2):
        proc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.tools.tune_cli"]
            + PLAN_ARGS, cwd=ROOT, env=_env(), capture_output=True,
            text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs.append(proc.stdout)
    assert outs[0] == outs[1]
    plan = json.loads(outs[0])
    assert plan["ranked"] and not plan["rejected"]
    assert plan["context"]["peak_tflops"] == 989.0  # bf16, the card's
    assert plan["context"]["bf16_act"] is True


@pytest.fixture(scope="module")
def measured(tmp_path_factory):
    d = tmp_path_factory.mktemp("measure")
    space = tspace.SearchSpace(8, meshes=["dp=8,mp=1", "dp=4,mp=2"],
                               batches=[32], micro_batches=[1, 2],
                               pipelines=["none", "default"])
    plan = trank.rank(tmodels.builder("lenet5"), space.points(), 8,
                      model="lenet5", hbm_gb=80, bf16_act=False,
                      space_dict=space.to_dict(), skipped=space.skipped,
                      extra_context={"image_size": 28, "class_dim": 10})
    history = str(d / "history.jsonl")
    old = os.environ.get("BENCH_MODEL")
    os.environ["BENCH_MODEL"] = "smallnet"  # ambient: must be scrubbed
    try:
        results = tmeasure.measure_plan(
            plan, topk=2, history=history, iters=1, warmup=1,
            extra_env={"BENCH_USE_GPU": "0"}, timeout=300)
    finally:
        if old is None:
            os.environ.pop("BENCH_MODEL")
        else:
            os.environ["BENCH_MODEL"] = old
    return plan, results, tperf.load_history(history)


def test_measure_plan_on_the_cpu(measured):
    plan, results, records = measured
    top2 = [e.candidate.tag() for e in plan.ranked[:2]]
    assert [r["tag"] for r in results] == top2
    for r, e in zip(results, plan.ranked):
        assert r["ok"], r
        rec = r["record"]
        assert rec["platform"] == "cpu" and rec["platform_class"] == "cpu:d1"
        assert rec["config"]["model"] == "lenet5"
        assert rec["config"]["batch"] == e.candidate.per_device_batch
        assert rec["config"]["mesh"] == e.candidate.mesh_spec
        assert rec["config"]["pass_pipeline"] == \
            (e.candidate.pipeline_id() or None)
        assert rec["amp_bf16"] is False and rec["step_ms"] > 0
        assert rec["loss"] == rec["loss"]  # finite, not NaN
    assert [rec["leg"] for rec in records] == ["ptune:" + t for t in top2]
    for rec in records:
        assert rec["config"]["mesh"] and rec["platform_class"] == "cpu:d1"
    pairs = tfit.join_history(plan, records)
    assert [p["tag"] for p in pairs] == top2
    plan_dict = json.loads(plan.to_json())
    assert tfit.join_history(plan_dict, records) == \
        jfit.join_history(plan_dict, records)
    cal = tfit.fit_calibration(pairs, model="lenet5")
    assert cal.n == 2 and cal.error_after <= cal.error_before
    # each leg's process counted its own launches: lenet5 runs no
    # hand-written kernel
    assert tmeasure.leg_launches(results) == \
        dict.fromkeys(tkernels.launch_counts(), 0)


def test_leg_launches_sums_each_legs_own_count():
    legs = [{"tag": "a", "ok": True,
             "record": {"kernel_launches": {"k": 1, "k[r]": 1}}},
            {"tag": "b", "ok": True,
             "record": {"kernel_launches": {"k": 2, "k[r]": 0}}},
            {"tag": "c", "ok": False, "error": "the leg exited 1"}]
    assert tmeasure.leg_launches(legs) == {"k": 3, "k[r]": 1}
    for record in ({}, {"kernel_launches": {}}):
        with pytest.raises(tmeasure.MeasureError,
                           match="d counted no kernel launches"):
            tmeasure.leg_launches([{"tag": "d", "ok": True,
                                    "record": record}])


def test_config_mismatch_and_pcache_refused():
    expected = {"mesh": "dp=8,mp=1", "per_device_batch": 4,
                "micro_batches": 1, "pass_pipeline": None}
    got = {"mesh": "dp=8,mp=1", "batch": 4, "micro_batches": 1,
           "pass_pipeline": None, "amp_bf16": True}
    assert tmeasure._config_matches(expected, got, {"bf16_act": True}) \
        is None
    assert "amp_bf16" in tmeasure._config_matches(
        expected, got, {"bf16_act": False})
    assert "batch" in tmeasure._config_matches(
        dict(expected, per_device_batch=8), got, {})
    assert tmeasure._config_matches(expected, None, {}) == \
        "record carries no config blob"
    # the persistent plan cache is no longer refused: the legs run with
    # FLAGS_compile_cache_dir set
    assert tmeasure.measure_plan({"model": "lenet5", "ranked": []},
                                 cache_dir="pcache") == []
    env = tmeasure.measurement_env({}, {}, "lenet5", cache_dir="pcache")
    assert env["FLAGS_compile_cache_dir"] == os.path.abspath("pcache")


def test_leg_record_equals_bench_config_blob(tmp_path):
    history = str(tmp_path / "h.jsonl")
    env = {"BENCH_MODEL": "lenet5", "BENCH_BATCH": "8",
           "BENCH_MICRO_BATCH": "2", "BENCH_ITERS": "2",
           "BENCH_WARMUP": "1", "BENCH_AMP": "0", "BENCH_USE_GPU": "0",
           "BENCH_MESH": "dp=4,mp=2", "BENCH_LEG": "ptune:x",
           "BENCH_HISTORY": history,
           "FLAGS_compile_passes": "dce,fold,cse,dve"}
    # the leg counts from 0 what its own process launches
    fa = tkernels.flash_attention.flash_attention_fwd
    fa.launches, fa.route_launches["f32"] = 5, 5
    try:
        rec = tleg.run_leg(env=env)
    finally:
        tkernels.reset_launches()
    assert rec["kernel_launches"] == \
        dict.fromkeys(tkernels.launch_counts(), 0)
    assert "flash_attention_fwd[f32]" in rec["kernel_launches"]
    assert rec["config"] == {
        "model": "lenet5", "mode": "train", "batch": 8, "micro_batches": 2,
        "mesh": "dp=4,mp=2", "pass_pipeline": "v1:dce,fold,cse,dve",
        "amp_bf16": False, "recompute": 0, "prefetch": 0,
        "layout": "NCHW", "tag": None, "image_size": 28}
    assert rec["metric"] == "lenet5_train_imgs_per_sec_batch8+mb2"
    assert rec["unit"] == "img/s" and rec["value"] > 0
    assert rec["mfu"] is None and rec["platform_class"] == "cpu:d1"
    (line,) = tperf.load_history(history)
    assert line["leg"] == "ptune:x" and line["config"] == rec["config"]
    with pytest.raises(SystemExit, match="divisible"):
        tleg.run_leg(env=dict(env, BENCH_BATCH="7"))


def test_leg_record_carries_memory_and_cache_blobs(tmp_path):
    """A leg's record carries obs.mem's bench blob (the static peak the
    memory gate reads; on the CPU no pool) and, with the persistent plan
    cache on, its hits and misses: a second leg on the same cache loads
    every plan."""
    from paddle_tpu_torch.compile import pcache
    from paddle_tpu_torch.obs import mem as tmem
    from paddle_tpu_torch.utils import flags

    env = {"BENCH_MODEL": "lenet5", "BENCH_BATCH": "8", "BENCH_ITERS": "1",
           "BENCH_WARMUP": "1", "BENCH_AMP": "0", "BENCH_USE_GPU": "0",
           "BENCH_HISTORY": "0"}
    flags.set_flag("compile_cache_dir", str(tmp_path / "pcache"))
    try:
        cold = tleg.run_leg(env=env)
        pcache.reset()
        warm = tleg.run_leg(env=env)
    finally:
        flags.set_flag("compile_cache_dir", "")
        pcache.reset()
    main, _loss = tmodels.builder("lenet5")(8)
    assert cold["memory"]["static_peak_bytes"] == \
        tmem.program_timeline(main, fetches=[_loss], bf16_act=False)[
            "total_peak_bytes"] > 0
    assert "pool_bytes" not in cold["memory"]  # the CPU holds no pool
    assert cold["compile_cache"]["misses"] == 2
    assert warm["compile_cache"] == {"hits": 2, "misses": 0,
                                     "compile_seconds_saved":
                                     warm["compile_cache"][
                                         "compile_seconds_saved"]}
    norm = tperf.normalize_record(cold)
    assert norm["memory"]["static_peak_bytes"] == \
        cold["memory"]["static_peak_bytes"]


def test_leg_and_cli_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default place is valid")
    from paddle_tpu_torch.tools import tune_cli

    with pytest.raises(RuntimeError, match="CUDA"):
        tleg.run_leg(env={"BENCH_MODEL": "lenet5", "BENCH_HISTORY": "0"})
    plan = str(tmp_path / "plan.json")
    assert tune_cli.main(PLAN_ARGS[:-1] + ["--out", plan]) == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        tune_cli.main(["measure", "--plan", plan])
    with pytest.raises(RuntimeError, match="CUDA"):
        tune_cli.main(["--selftest"])
    assert tune_cli.parse_args(["--use_gpu=0"]).use_gpu is False
    assert tune_cli.parse_args([]).use_gpu is True


# ---------------------------------------------------------------------------
# the builder's one copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,size", [("lenet5", None),
                                        ("resnet50", 32)])
def test_builder_equals_jax(model, size):
    tmain, tstartup, tloss = tmodels.builder(
        model, image_size=size, with_startup=True)(8)
    jmain, jstartup, jloss = jmodels.builder(
        model, image_size=size, with_startup=True)(8)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    assert tstartup.desc.to_dict() == jstartup.desc.to_dict()
    assert tloss == jloss
    tm, tl = tmodels.builder(model, image_size=size)(8)
    assert tm.desc.to_dict() == tmain.desc.to_dict() and tl == tloss
    assert tmodels.MODELS == jmodels.MODELS
    assert tmodels.model_names() == jmodels.model_names()


def test_bench_and_shard_cli_build_through_tune_models(monkeypatch):
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.spmd import bench
    from paddle_tpu_torch.tools import shard_cli

    built = []
    real = tmodels.builder

    def recording(*args, **kw):
        build = real(*args, **kw)

        def inner(batch):
            out = build(batch)
            built.append(out)
            return out
        return inner

    monkeypatch.setattr(tmodels, "builder", recording)
    make_mesh(device="cpu")
    try:
        rec = bench.run_leg(model="lenet5", mesh_spec="dp=1", batch=4,
                            iters=1, warmup=0, device="cpu")
    finally:
        torch.distributed.destroy_process_group()
    assert rec["value"] > 0
    (main, startup, loss), = built
    jmain, jstartup, jloss = jmodels.builder("lenet5",
                                             with_startup=True)(4)
    assert main.desc.to_dict() == jmain.desc.to_dict()
    assert startup.desc.to_dict() == jstartup.desc.to_dict()
    assert loss == jloss
    # shard_cli lists the same models and builds the same program
    assert sorted(shard_cli.MODELS) == [
        "alexnet", "googlenet", "lenet5", "resnet50", "smallnet", "vgg16",
        "vgg19"]
    smain, sstartup, sloss = shard_cli.builder("lenet5",
                                               with_startup=True)(32)
    jmain, jstartup, jloss = jmodels.builder("lenet5",
                                             with_startup=True)(32)
    assert smain.desc.to_dict() == jmain.desc.to_dict()
    assert sstartup.desc.to_dict() == jstartup.desc.to_dict()
    assert not hasattr(shard_cli, "_model_fn")
    assert not hasattr(shard_cli, "_build_program")
