"""The port's static sharding analyzer (`paddle_tpu_torch.analysis.shard`
and `costmodel`) against the JAX package's, on the CPU.

The cases of tests/test_shard_analysis.py, each through both packages:
the programs are built by each package's own layers from the same
calls (their descs equal), and the meshes are plain dicts or
MeshConfigs, so no ranks are spawned.  For every analysis the port's
diagnostics (code, severity, var, op index, op type and message), its
`var_specs` and `param_reasons`, its comm bytes by collective and its
top entries, and its peak-memory estimate with `hbm_breakdown` equal
the JAX package's exactly.  The link rate behind the comm floor is the
one number the packages do not share (each defaults to its own
hardware's), so comparisons that reach it set the same `ici_gbps` on
both reports first.

Also: `check_pipeline`, `check_moe` and `check_ring`; the
FLAGS_verify_sharding gates of `verify_sharding`, `ParallelTrainer`
(a world of one rank in this process, over gloo), `make_parallel_step`,
`pipeline_apply`, `PipelineProgramTrainer` and `MoEProgramLayer`
raising the JAX gates' errors, word for word, before anything runs;
`lint_cli --mesh/--hbm-gb/--zero` and `shard_cli plan`, `show` and
`--selftest` with their exit codes and findings equal to the JAX
CLIs'.
"""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import analysis as janalysis
from paddle_tpu.analysis import costmodel as jcost
from paddle_tpu.obs import registry as jregistry
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel import sharding as jshard
from paddle_tpu.tools import lint_cli as jlint
from paddle_tpu.tools import shard_cli as jshard_cli
from paddle_tpu.utils import flags as jflags

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import analysis as tanalysis
from paddle_tpu_torch.analysis import costmodel as tcost
from paddle_tpu_torch.obs import registry as tregistry
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.parallel import sharding as tshard
from paddle_tpu_torch.tools import lint_cli as tlint
from paddle_tpu_torch.tools import shard_cli as tshard_cli
from paddle_tpu_torch.utils import flags as tflags

torch.set_num_threads(1)

# the link rate both reports are set to where a floor is compared
ICI_GBPS = 100.0

PKGS = {
    "torch": dict(fluid=tfluid, analysis=tanalysis, mesh=tmesh,
                  shard=tshard, flags=tflags, cost=tcost, lint=tlint,
                  shard_cli=tshard_cli, registry=tregistry),
    "jax": dict(fluid=jfluid, analysis=janalysis, mesh=jmesh,
                shard=jshard, flags=jflags, cost=jcost, lint=jlint,
                shard_cli=jshard_cli, registry=jregistry),
}


@pytest.fixture(scope="module", autouse=True)
def world_of_one():
    """The world-1 gloo group the trainer gates below make (through
    `make_mesh(device="cpu")`); gone afterwards."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


@pytest.fixture(autouse=True)
def fresh_registries():
    tregistry.reset_registry()
    jregistry.reset_registry()
    yield


# -- the programs (either package's fluid) ------------------------------------

def build_mlp(fl, batch=None, width=1024):
    """fc -> relu -> fc -> mean(+SGD); width 1024 makes the fc weights
    mp-shardable under the default rules."""
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        if batch is None:
            x = fl.layers.data(name="x", shape=[width], dtype="float32")
        else:
            x = fl.layers.data(name="x", shape=[batch, width],
                               dtype="float32", append_batch_size=False)
        h = fl.layers.fc(input=x, size=width, act="relu")
        h2 = fl.layers.fc(input=h, size=width)
        loss = fl.layers.mean(x=h2)
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss.name


def build_near_miss(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[513], dtype="float32")
        fl.layers.fc(input=x, size=1023)  # 513x1023: near miss
    return main, startup, None


def build_add(fl, dtype="float32"):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        a = fl.layers.data(name="a", shape=[8, 16], dtype=dtype,
                           append_batch_size=False)
        b = fl.layers.data(name="b", shape=[8, 16], dtype=dtype,
                           append_batch_size=False)
        fl.layers.elementwise_add(x=a, y=b)
    return main, startup, None


def build_batched_matmul(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        a = fl.layers.data(name="a", shape=[8, 16, 32], dtype="float32",
                           append_batch_size=False)
        b = fl.layers.data(name="b", shape=[8, 32, 16], dtype="float32",
                           append_batch_size=False)
        fl.layers.matmul(x=a, y=b)
    return main, startup, None


def build_wide_fc(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[1024], dtype="float32")
        h = fl.layers.fc(input=x, size=2048)
        loss = fl.layers.mean(x=h)
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss.name


def _lenet5(which):
    if which == "jax":
        from paddle_tpu.models.image import lenet5
    else:
        from paddle_tpu_torch.models.image import lenet5
    fl = PKGS[which]["fluid"]
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        img = fl.layers.data(name="img", shape=[1, 28, 28],
                             dtype="float32")
        label = fl.layers.data(name="label", shape=[1], dtype="int64")
        probs = lenet5(img, class_dim=10)
        loss = fl.layers.mean(
            x=fl.layers.cross_entropy(input=probs, label=label))
        fl.optimizer.MomentumOptimizer(
            learning_rate=0.01, momentum=0.9).minimize(loss)
    return main, startup, loss.name


# -- the comparison ----------------------------------------------------------

def facts(plan):
    """Everything the analyzer decides, in plain data."""
    plan.comm.ici_gbps = ICI_GBPS
    return {
        "diagnostics": [(d.code, d.severity, d.var_name, d.op_index,
                         d.op_type, d.message)
                        for d in plan.report.diagnostics],
        "var_specs": dict(plan.var_specs),
        "param_reasons": dict(plan.param_reasons),
        "events": [ev.to_dict() for ev in plan.comm.events],
        "comm": plan.comm.to_dict(topk=10),
        "peak_hbm_bytes": plan.peak_hbm_bytes,
        "hbm_breakdown": plan.hbm_breakdown,
        "mesh": dict(plan.mesh_axes),
    }


def analyze_both(build, mesh, build_kw=None, **kw):
    """{package: (plan, facts)} of `analyze_sharding` over the same
    program built by each package, against `mesh` (a dict, or a mesh
    spec string parsed by each package's parse_mesh_spec)."""
    out = {}
    for which, pk in PKGS.items():
        main, _startup, loss = build(pk["fluid"], **(build_kw or {}))
        m = pk["mesh"].parse_mesh_spec(mesh) if isinstance(mesh, str) \
            else dict(mesh)
        kwargs = dict(kw)
        if loss is not None and "fetches" not in kwargs:
            kwargs["fetches"] = [loss]
        plan = pk["analysis"].analyze_sharding(main, m, publish=False,
                                               **kwargs)
        out[which] = (plan, facts(plan))
    assert out["torch"][1] == out["jax"][1]
    return out["torch"][0]


# ---------------------------------------------------------------------------
# mesh descriptions and reasoned spec fallbacks
# ---------------------------------------------------------------------------

def test_parse_mesh_spec():
    for spec in ("dp=4,mp=2", "pp=4,dp=2", "dp=2,mp=2,sp=2"):
        t, j = tmesh.parse_mesh_spec(spec), jmesh.parse_mesh_spec(spec)
        assert list(t.shape.items()) == list(j.shape.items())
        assert tanalysis.mesh_axis_sizes(t) == janalysis.mesh_axis_sizes(j)
    for bad, match in (("dp=4,zz=2", "unknown axis"), ("dp4", "axis=size"),
                       ("dp=2,dp=4", "named twice")):
        for pk in PKGS.values():
            with pytest.raises(ValueError, match=match):
                pk["mesh"].parse_mesh_spec(bad)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tanalysis.mesh_axis_sizes(7)


def test_mesh_config_validate_names_axes():
    for cfg, n in ((dict(dp=4, mp=3), 8), (dict(mp=3), 8)):
        errs = []
        for pk in PKGS.values():
            with pytest.raises(ValueError) as err:
                pk["mesh"].MeshConfig(**cfg).validate(n)
            errs.append(str(err.value))
        assert errs[0] == errs[1] and "mp=3" in errs[0]
    for pk in PKGS.values():
        pk["mesh"].MeshConfig(dp=4, mp=2).validate(8)
        pk["mesh"].MeshConfig(mp=2).validate(8)


def test_make_mesh_error_names_axes():
    for kw in (dict(dp=4, mp=3), dict(mp=3)):
        with pytest.raises(ValueError) as terr:
            tmesh.mesh_layout(8, **kw)
        with pytest.raises(ValueError) as jerr:
            jmesh.make_mesh(n_devices=8, **kw)
        assert str(terr.value) == str(jerr.value)
        assert "mp=3" in str(terr.value)


def test_param_spec_reason():
    cases = [((1024, 1024), "dp=4,mp=2"), ((512, 1024), "dp=4,mp=2"),
             ((64, 3, 3, 3), "dp=4,mp=2"), ((1024, 1024), "dp=8"),
             ((100, 200), "dp=4,mp=2"), ((513, 1023), "dp=4,mp=2")]
    for shape, spec in cases:
        t = tshard.param_spec_reason("w", shape,
                                     tmesh.parse_mesh_spec(spec))
        j = jshard.param_spec_reason("w", shape,
                                     jmesh.parse_mesh_spec(spec))
        assert (tuple(t[0]), t[1]) == (tuple(j[0]), j[1]), (shape, spec)
    _, r = tshard.param_spec_reason("w", (513, 1023),
                                    tmesh.parse_mesh_spec("dp=4,mp=2"))
    assert r and "not divisible" in r


def test_zero1_spec_reason():
    for shape in ((1024,), (6,), ()):
        t = tshard.zero1_spec_reason((), shape,
                                     tmesh.parse_mesh_spec("dp=4,mp=2"))
        j = jshard.zero1_spec_reason((), shape,
                                     jmesh.parse_mesh_spec("dp=4,mp=2"))
        assert (tuple(t[0]), t[1]) == (tuple(j[0]), j[1]), shape


# ---------------------------------------------------------------------------
# S0xx diagnostics
# ---------------------------------------------------------------------------

def test_s001_unmatched_rule():
    plan = analyze_both(build_mlp, {"dp": 4, "mp": 2},
                        rules=[("^no_such_param$", ())])
    diags = [d for d in plan.report.diagnostics if d.code == "S001"]
    assert diags and all(d.severity == "warning" for d in diags)
    assert "matched no partition rule" in diags[0].message


def test_s001_heuristic_cites_reason():
    plan = analyze_both(build_near_miss, {"dp": 4, "mp": 2})
    diags = [d for d in plan.report.diagnostics if d.code == "S001"
             and d.var_name == "fc_0.w_0"]
    assert diags and "not divisible" in diags[0].message
    assert plan.param_reasons["fc_0.w_0"]


def test_s002_concrete_feed_batch_is_error():
    plan = analyze_both(build_mlp, {"dp": 4, "mp": 2},
                        build_kw={"batch": 6}, concrete_feeds=True)
    errs = [d for d in plan.report.errors if d.code == "S002"]
    assert errs and errs[0].var_name == "x" and "dp=4" in errs[0].message


def test_s002_pinned_feed_batch_is_advisory():
    plan = analyze_both(build_mlp, {"dp": 4, "mp": 2},
                        build_kw={"batch": 6})
    assert plan.report.ok()
    infos = [d for d in plan.report.by_severity("info")
             if d.code == "S002"]
    assert infos and "rebuild" in infos[0].message


def test_s002_rule_forced_non_divisible_param():
    plan = analyze_both(build_mlp, {"dp": 2, "mp": 3},
                        rules=[(r"\.w_0$", ("mp", None)), (".*", ())])
    errs = [d for d in plan.report.errors if d.code == "S002"]
    assert errs and "mp=3" in errs[0].message


def test_s004_unknown_axis_in_rule_or_feed_spec():
    plan = analyze_both(build_mlp, {"dp": 4, "mp": 2},
                        rules=[(r"\.w_0$", ("tp", None)), (".*", ())])
    errs = [d for d in plan.report.errors if d.code == "S004"]
    assert errs and "'tp'" in errs[0].message
    plan = analyze_both(build_mlp, {"dp": 4, "mp": 2},
                        feed_specs={"x": ("data",)})
    assert any(d.code == "S004" and d.var_name == "x"
               for d in plan.report.errors)


def test_comm_pricing_follows_dtype():
    plan = analyze_both(build_add, {"dp": 4, "mp": 2},
                        build_kw={"dtype": "bfloat16"},
                        feed_specs={"b": ("mp",)})
    ev = next(e for e in plan.comm.events if e.collective == "allgather")
    assert ev.payload_bytes == 8 * 16 * 2


def test_s003_conflicting_layouts():
    plan = analyze_both(build_add, {"dp": 4, "mp": 2},
                        feed_specs={"b": ("mp",)})
    diags = [d for d in plan.report.diagnostics if d.code == "S003"]
    assert diags and diags[0].op_type == "elementwise_add"
    assert any(ev.collective == "allgather" for ev in plan.comm.events)


def _schedule_reports(check, *args, **kw):
    reps = [getattr(pk["analysis"], check)(*args, **kw)
            for pk in PKGS.values()]
    got = [[(d.code, d.severity, d.message) for d in r.diagnostics]
           for r in reps]
    assert got[0] == got[1], got
    return reps[0]


def test_s004_pipeline_schedule():
    rep = _schedule_reports("check_pipeline", {"pp": 4, "dp": 2},
                            n_stages=3, n_microbatches=8)
    assert [d.code for d in rep.errors] == ["S004"]
    assert "3 stages" in rep.errors[0].message
    rep = _schedule_reports("check_pipeline", {"pp": 4}, n_stages=4,
                            n_microbatches=2)
    assert rep.ok() and rep.has("S004")
    rep = _schedule_reports("check_pipeline", {"dp": 8}, n_stages=4,
                            n_microbatches=8)
    assert not rep.ok() and "not a mesh axis" in rep.errors[0].message
    rep = _schedule_reports("check_pipeline", {"pp": 4}, n_stages=4,
                            n_microbatches=3, batch_size=8)
    assert any("not divisible into 3 microbatches" in d.message
               for d in rep.errors)
    assert _schedule_reports("check_pipeline", {"pp": 1}, n_stages=1,
                             n_microbatches=0).ok()


def test_s004_moe_schedule():
    rep = _schedule_reports("check_moe", {"dp": 2, "ep": 4}, n_experts=6)
    assert not rep.ok() and "6 experts" in rep.errors[0].message
    rep = _schedule_reports("check_moe", {"dp": 2, "ep": 4}, n_experts=8,
                            capacity_factor=0.25, tokens=1024)
    assert any("dropped EVERY step" in d.message for d in rep.diagnostics)
    rep = _schedule_reports("check_moe", {"dp": 2, "ep": 4}, n_experts=8,
                            capacity_factor=2.0, tokens=1024)
    assert rep.ok() and not rep.diagnostics
    rep = _schedule_reports("check_moe", {"dp": 2, "ep": 4}, n_experts=8,
                            tokens=1001)
    assert rep.has("S002")
    assert not _schedule_reports("check_moe", {"dp": 8}, 8).ok()


def test_s004_ring_schedule():
    assert not _schedule_reports("check_ring", {"dp": 4, "mp": 2},
                                 seq_len=32).ok()
    assert _schedule_reports("check_ring", {"sp": 2, "dp": 4},
                             seq_len=33).has("S002")
    assert _schedule_reports("check_ring", {"sp": 2, "dp": 4}, seq_len=32,
                             n_heads=3, mode="ulysses").has("S004")
    assert _schedule_reports("check_ring", {"sp": 2, "dp": 4}, seq_len=32,
                             n_heads=4, mode="ulysses").ok()


def test_s005_hbm_budget():
    plan = analyze_both(build_mlp, {"dp": 4, "mp": 2}, hbm_gb=1e-6)
    errs = [d for d in plan.report.errors if d.code == "S005"]
    assert errs and "budget" in errs[0].message
    assert plan.hbm_breakdown["params_bytes"] > 0
    assert plan.hbm_breakdown["activation_peak_bytes"] > 0
    ok = analyze_both(build_mlp, {"dp": 4, "mp": 2}, hbm_gb=16)
    assert not ok.report.has("S005")


def test_hbm_shrinks_with_mp():
    rep1 = analyze_both(build_mlp, {"dp": 8})
    rep2 = analyze_both(build_mlp, {"dp": 4, "mp": 2})
    assert rep2.hbm_breakdown["params_bytes"] < \
        rep1.hbm_breakdown["params_bytes"]


# ---------------------------------------------------------------------------
# the comm cost model
# ---------------------------------------------------------------------------

def test_collective_wire_bytes():
    for coll in tcost.COLLECTIVES:
        for payload, n in ((1000, 4), (1000, 1), (12345, 8), (7, 3)):
            assert tcost.collective_wire_bytes(coll, payload, n) == \
                jcost.collective_wire_bytes(coll, payload, n)
    assert tcost.collective_wire_bytes("allreduce", 1000, 4) == 1500
    for pk in PKGS.values():
        with pytest.raises(ValueError):
            pk["cost"].collective_wire_bytes("gossip", 1, 2)
    # the port's default link rate is the card's NVLink, each way
    assert tcost.DEFAULT_ICI_GBPS == 450.0
    rep = tcost.CommCostReport()
    rep.add("allreduce", "dp", 8, 1 << 20)
    assert rep.step_seconds_floor() == pytest.approx(
        rep.total_wire_bytes() / 450e9)


def test_comm_cost_dp_grad_sync():
    plan = analyze_both(build_mlp, {"dp": 8})
    sync = [ev for ev in plan.comm.events if "grad sync" in ev.detail]
    assert len(sync) == 4
    w = next(ev for ev in sync if "fc_0.w_0" in ev.detail)
    assert w.wire_bytes == int(1024 * 1024 * 4 * 2 * 7 / 8)
    assert plan.comm.totals()["allreduce"] > 0
    assert plan.comm.step_seconds_floor() > 0


def test_comm_cost_zero1_reduce_scatter():
    plan = analyze_both(build_mlp, {"dp": 8}, zero_stage=1)
    colls = {ev.collective for ev in plan.comm.events}
    assert "reducescatter" in colls and "allgather" in colls


def test_comm_cost_published_to_registry():
    for which, pk in PKGS.items():
        main, _, loss = build_mlp(pk["fluid"])
        plan = pk["analysis"].analyze_sharding(main, {"dp": 8},
                                               fetches=[loss],
                                               publish=True)
        snap = {s["name"]: s for s in
                pk["registry"].get_registry().to_dict()["metrics"]
                if s["name"].startswith("shard_")}
        assert "shard_comm_bytes_total" in snap
        assert snap["shard_peak_hbm_bytes"]["value"] == \
            plan.peak_hbm_bytes
    tsnap = [s for s in tregistry.get_registry().to_dict()["metrics"]
             if s["name"].startswith("shard_")]
    jsnap = [s for s in jregistry.get_registry().to_dict()["metrics"]
             if s["name"].startswith("shard_")]
    assert [(s["name"], s.get("labels"), s["value"]) for s in tsnap] == \
        [(s["name"], s.get("labels"), s["value"]) for s in jsnap]


def test_batched_matmul_contraction_dim():
    plan = analyze_both(build_batched_matmul, {"dp": 4, "mp": 2})
    assert not plan.report.has("S003")
    assert not any("partial-sum" in ev.detail for ev in plan.comm.events)


def test_mp_sharding_plan_and_matmul_partials():
    plan = analyze_both(build_wide_fc, {"dp": 4, "mp": 2})
    assert plan.sharded_params() and plan.report.ok()


# ---------------------------------------------------------------------------
# the trust-boundary gates (FLAGS_verify_sharding)
# ---------------------------------------------------------------------------

class _MustNotRun:
    """An 'executor' that fails the test if anything executes."""

    def run(self, *a, **k):
        raise AssertionError("startup executed: the sharding gate did "
                             "not reject first")


@pytest.fixture()
def verify_flag():
    for pk in PKGS.values():
        pk["flags"].set_flag("verify_sharding", True)
    yield
    for pk in PKGS.values():
        pk["flags"].set_flag("verify_sharding", False)


def _gate_errors(run):
    """{package: str(error)} of `run(which, pk)` raising each package's
    ProgramVerificationError; the texts must be equal."""
    errs = {}
    for which, pk in PKGS.items():
        with pytest.raises(pk["analysis"].ProgramVerificationError) as err:
            run(which, pk)
        errs[which] = str(err.value)
    assert errs["torch"] == errs["jax"]
    return errs["torch"]


def _world_one(which):
    if which == "jax":
        return jmesh.make_mesh(n_devices=1)
    return tmesh.make_mesh(device="cpu")


def _trainer(which):
    if which == "jax":
        from paddle_tpu.parallel import ParallelTrainer
    else:
        from paddle_tpu_torch.parallel import ParallelTrainer
    return ParallelTrainer


def test_trainer_init_rejects_s002_before_any_lowering(verify_flag):
    # the S002 of a batch of 6 at dp=4 through the gate itself, over a
    # static mesh (one process holds no 8-rank mesh)...
    def verify(which, pk):
        main, _, loss = build_mlp(pk["fluid"], batch=6)
        mod = __import__("paddle_tpu%s.parallel.trainer"
                         % ("_torch" if which == "torch" else ""),
                         fromlist=["verify_sharding"])
        mod.verify_sharding(main, pk["mesh"].MeshConfig(dp=4, mp=2),
                            ["x"], [loss])

    msg = _gate_errors(verify)
    assert "S002" in msg and "x" in msg and "dp=4" in msg
    # ...and the trainer at world size 1 rejecting a feed spec that
    # names an axis its mesh lacks, before its startup program runs
    trainers = {}

    def init(which, pk):
        main, startup, loss = build_mlp(pk["fluid"], batch=8, width=64)
        tr = _trainer(which)(main, startup, ["x"], [loss],
                             _world_one(which), feed_specs={"x": ("sp",)})
        trainers[which] = tr
        tr.init(executor=_MustNotRun())

    msg = _gate_errors(init)
    assert "S004" in msg and "'sp'" in msg
    assert trainers["torch"].state is None
    assert trainers["torch"]._step_fn is None


def test_trainer_init_passes_clean_program_with_gate(verify_flag):
    main, startup, loss = build_mlp(tfluid, batch=8, width=64)
    tr = _trainer("torch")(main, startup, ["x"], [loss],
                           _world_one("torch")).init()
    (out,) = tr.step({"x": np.random.RandomState(0)
                      .rand(8, 64).astype(np.float32)})
    assert np.isfinite(out.numpy()).all()
    jmain, _, jloss = build_mlp(jfluid, batch=8, width=64)
    jplan = _trainer("jax")(jmain, None, ["x"], [jloss],
                            _world_one("jax")).sharding_plan()
    assert facts(tr.sharding_plan()) == facts(jplan)


def test_make_parallel_step_gate(verify_flag):
    def build_step(which, pk):
        mod = __import__("paddle_tpu%s.parallel"
                         % ("_torch" if which == "torch" else ""),
                         fromlist=["make_parallel_step"])
        main, _, loss = build_mlp(pk["fluid"], batch=8, width=64)
        mod.make_parallel_step(main, ["x"], [loss], _world_one(which), {},
                               feed_specs={"x": ("sp",)})

    assert "S004" in _gate_errors(build_step)


def test_pipeline_apply_gate(verify_flag):
    import jax.numpy as jnp
    from paddle_tpu.parallel import pipeline_apply as jpipeline_apply
    from paddle_tpu_torch.parallel import pipeline_apply

    def run(which, pk):
        mesh = pk["mesh"].parse_mesh_spec("pp=4,dp=2")
        if which == "jax":
            stacked = {"w": jnp.ones((4, 8, 8), jnp.float32)}
            jpipeline_apply(mesh, lambda p, h: h @ p["w"], stacked,
                            jnp.ones((8, 8), jnp.float32), 3)
        else:
            stacked = {"w": torch.ones(4, 8, 8)}
            pipeline_apply(mesh, lambda p, h: h @ p["w"], stacked,
                           torch.ones(8, 8), 3)

    assert "S004" in _gate_errors(run)


def _expert(fl):
    def build():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            h = fl.layers.data(name="h", shape=[8], dtype="float32")
            out = fl.layers.fc(input=h, size=8, act="tanh")
        return main, startup, "h", out.name

    return build


def test_program_schedule_gates(verify_flag):
    """PipelineProgramTrainer on a mesh without a pp axis and
    MoEProgramLayer with 6 experts over ep=4 reject before building."""
    def pipe(which, pk):
        mod = __import__("paddle_tpu%s.parallel"
                         % ("_torch" if which == "torch" else ""),
                         fromlist=["PipelineProgramTrainer"])
        mod.PipelineProgramTrainer(_expert(pk["fluid"]),
                                   pk["mesh"].parse_mesh_spec("dp=8"),
                                   n_microbatches=4)

    def moe(which, pk):
        mod = __import__("paddle_tpu%s.parallel"
                         % ("_torch" if which == "torch" else ""),
                         fromlist=["MoEProgramLayer"])
        mod.MoEProgramLayer(_expert(pk["fluid"]), n_experts=6, d_model=8,
                            mesh=pk["mesh"].parse_mesh_spec("dp=2,ep=4"))

    assert "not a mesh axis" in _gate_errors(pipe)
    assert "6 experts" in _gate_errors(moe)


def test_schedule_introspection_hooks():
    from paddle_tpu.parallel import (expert_capacity, moe_axis_info,
                                     pipeline_schedule_info, sp_axis_info)
    from paddle_tpu_torch import parallel as tpar

    assert tpar.pipeline_schedule_info({"pp": 4, "dp": 2}, 8,
                                       batch_size=32) == \
        pipeline_schedule_info({"pp": 4, "dp": 2}, 8, batch_size=32)
    assert tpar.expert_capacity(128, 8, 2.0) == \
        expert_capacity(128, 8, 2.0) == 32
    assert tpar.moe_axis_info({"dp": 2, "ep": 4}, 8, tokens=1024) == \
        moe_axis_info({"dp": 2, "ep": 4}, 8, tokens=1024)
    assert tpar.sp_axis_info({"sp": 2}, seq_len=32, n_heads=4,
                             mode="ulysses") == \
        sp_axis_info({"sp": 2}, seq_len=32, n_heads=4, mode="ulysses")


def test_transpiler_validates_split_blocks():
    from paddle_tpu_torch.distributed.transpiler import (
        DistributeTranspiler, split_dense_variable)

    def bad_split(var_list, pserver_count, **kw):
        return [(v.name, 0, 0, max(int(np.prod(v.shape)) - 1, 1))
                for v in var_list]

    def dropping_split(var_list, pserver_count, **kw):
        return split_dense_variable(var_list[:1], pserver_count)

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[13], dtype="float32")
        y = tfluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = tfluid.layers.fc(input=x, size=1)
        loss = tfluid.layers.mean(
            x=tfluid.layers.square_error_cost(input=pred, label=y))
        optimize_ops, params_grads = tfluid.optimizer.SGD(
            learning_rate=0.01).minimize(loss)
    for split, match in ((bad_split, "covers"),
                         (dropping_split, "no pserver blocks")):
        with pytest.raises(ValueError, match=match):
            DistributeTranspiler().transpile(
                optimize_ops=optimize_ops, params_grads=params_grads,
                trainer_id=0, trainers=2, pservers="127.0.0.1:6174",
                split_method=split, program=main)


# ---------------------------------------------------------------------------
# the acceptance sweep: clean programs on all four dryrun mesh shapes
# ---------------------------------------------------------------------------

DRYRUN_MESHES = ["dp=4,mp=2", "dp=2,mp=2,sp=2", "pp=4,dp=2", "dp=2,ep=4"]


@pytest.mark.parametrize("mesh_spec", DRYRUN_MESHES)
def test_lenet5_clean_on_dryrun_meshes(mesh_spec):
    out = {}
    for which, pk in PKGS.items():
        main, _, loss = _lenet5(which)
        plan = pk["analysis"].analyze_sharding(
            main, pk["mesh"].parse_mesh_spec(mesh_spec), fetches=[loss],
            publish=False)
        assert plan.report.ok(), plan.report.format()
        out[which] = facts(plan)
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def _lint_lines(out):
    return [line for line in out.splitlines() if line.startswith("[lint]")]


@pytest.mark.parametrize("extra", [[], ["--hbm-gb", "16"],
                                   ["--zero", "1"], ["--hbm-gb", "1e-6"]])
def test_lint_cli_golden_mesh(capsys, extra):
    argv = ["--golden", "--quiet", "--mesh", "dp=4,mp=2"] + extra
    rc = tlint.main(argv)
    out = capsys.readouterr().out
    jrc = jlint.main(argv)
    jout = capsys.readouterr().out
    assert rc == jrc == (1 if "1e-6" in extra else 0)
    assert _lint_lines(out) == _lint_lines(jout)
    assert "mesh={'dp': 4, 'mp': 2}" in out


def _model_dir(tmp_path, which, build, fetch=True):
    main, _, loss = build(PKGS[which]["fluid"])
    d = str(tmp_path / ("model_" + which))
    os.makedirs(d)
    doc = {"program": main.desc.to_dict()}
    if fetch:
        doc["fetch_names"] = [loss]
    with open(os.path.join(d, "__model__"), "w") as f:
        json.dump(doc, f)
    return d


def test_lint_cli_mesh_publishes_each_finding_once(tmp_path, capsys):
    def build(fl):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data(name="x", shape=[4, 8], dtype="float32",
                               append_batch_size=False)
            fl.layers.scale(x=x, scale=2.0)
            main.global_block().create_var(name="orphan", shape=[1],
                                           dtype="float32")
        return main, startup, None

    for which, pk in PKGS.items():
        d = _model_dir(tmp_path, which, build, fetch=False)
        assert pk["lint"].main([d, "--mesh", "dp=4", "--quiet"]) == 0
        capsys.readouterr()
        samples = [s for s in
                   pk["registry"].get_registry().to_dict()["metrics"]
                   if s["name"] == "analysis_diagnostics_total"
                   and (s.get("labels") or {}).get("code") == "D002"]
        assert samples and samples[0]["value"] == 1, (which, samples)


def test_lint_cli_mesh_json(tmp_path, capsys):
    docs = {}
    for which, pk in PKGS.items():
        d = _model_dir(tmp_path, which,
                       lambda fl: build_mlp(fl, width=64))
        assert pk["lint"].main([d, "--mesh", "dp=8", "--zero", "1",
                                "--json"]) == 0
        docs[which] = json.loads(capsys.readouterr().out)
    for doc in docs.values():
        doc["sharding"]["comm"].pop("step_seconds_floor")
    # the S0xx findings word for word (the base lints' texts name each
    # package's own hardware), and the whole sharding section
    assert [d for d in docs["torch"]["diagnostics"]
            if d["code"].startswith("S")] == \
        [d for d in docs["jax"]["diagnostics"] if d["code"].startswith("S")]
    assert [d["code"] for d in docs["torch"]["diagnostics"]] == \
        [d["code"] for d in docs["jax"]["diagnostics"]]
    assert docs["torch"]["sharding"] == docs["jax"]["sharding"]
    sharding = docs["torch"]["sharding"]
    assert sharding["mesh"] == {"dp": 8}
    assert sharding["comm"]["totals"].get("reducescatter", 0) > 0
    assert sharding["peak_hbm_bytes"] > 0


def _summary_lines(out):
    # the ring floor (ms) prices the wire bytes at each package's own
    # link rate; everything else must be equal
    return [line for line in out.splitlines()
            if "ring floor" not in line
            and not line.startswith("plan written to")]


@pytest.mark.parametrize("argv", [
    ["--mesh", "dp=4,mp=2"],
    ["--mesh", "dp=4,mp=2", "--zero-stage", "1"],
    ["--mesh", "dp=2,mp=3", "--batch", "30"],
    ["--mesh", "dp=8", "--rules", "RULES"],
])
def test_shard_cli_plan_and_show(tmp_path, capsys, argv):
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps({"rules": [[r"fc_.*\.w_0", ["dp", None]],
                                           [r"conv.*", [None]]]}))
    argv = [str(rules) if a == "RULES" else a for a in argv]
    outs, rcs, fps = {}, {}, {}
    for which, pk in PKGS.items():
        os.makedirs(str(tmp_path / which))
        path = str(tmp_path / which / "plan.json")
        rcs[which] = pk["shard_cli"].main(["plan"] + argv + ["--out", path])
        outs[which] = capsys.readouterr().out
        with open(path) as f:
            fps[which] = json.load(f)["fingerprint"]
    assert rcs["torch"] == rcs["jax"]
    assert fps["torch"] == fps["jax"]
    assert _summary_lines(outs["torch"]) == _summary_lines(outs["jax"])
    # a plan crosses between the packages: the port shows the JAX
    # package's artifact exactly as the JAX CLI does
    jpath = str(tmp_path / "jax" / "plan.json")
    assert tshard_cli.main(["show", "--plan", jpath]) == 0
    tout = capsys.readouterr().out
    assert jshard_cli.main(["show", "--plan", jpath]) == 0
    assert tout == capsys.readouterr().out


def test_shard_cli_selftest(capsys):
    assert tshard_cli.main(["--selftest", "--use_gpu=0"]) == 0
    tout = capsys.readouterr().out
    assert jshard_cli.main(["--selftest"]) == 0
    jout = capsys.readouterr().out

    def checks(out):
        return [line for line in out.splitlines()
                if line.endswith("PASS") or " PASS " in line]

    tchecks, jchecks = checks(tout), checks(jout)
    # the same five static checks, word for word; both trained a step;
    # and both ran the sharded checkpoint round trip
    assert tchecks[:5] == jchecks[:5]
    assert "plan-driven step trains (1 device(s))" in tchecks[5]
    assert tchecks[6] == jchecks[6] == ("  sharded checkpoint round-trip, "
                                        "nothing densified PASS")
    assert "slice 22" not in tout and "pshard selftest: green" in tout
