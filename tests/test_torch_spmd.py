"""The port's plan-driven SPMD trainer (`paddle_tpu_torch.spmd`) against
the JAX package's, on the CPU.

- The plan artifact, the cases of tests/test_spmd.py: the spec-reason
  boundaries; rule matching; `build_partition_plan`'s `to_dict` equal
  to the JAX plan's (the comm floor, priced at each package's own link
  rate, aside) and its `fingerprint()` equal exactly; save/load round
  trips, a plan crossing between the packages as its JSON; rules that
  reshape the layout; a trainer refusing a plan built for another mesh.
- `overlap_supported`'s reasons, word for word, and `_split_point`.
- `SpmdTrainer` at world size 1 in this process: the mesh step
  ("gspmd"), the fallback reason of a dp axis of 1, `_aot_state`
  "no-cache" without a cache directory, and with one "compiled" (the
  first trainer's capture stores its entry), "hit" (a second trainer),
  "error" (a cache that cannot be made; the step runs captured all the
  same) and "off", the entry's meta; the flight host context, losses and state against the
  JAX single-device trainer from one initial state; the checkpoint
  names, which work now (their cases are in
  tests/test_torch_spmd_checkpoint.py), with the JAX package's
  `__all__`.
- The overlapped dp step at dp 4, in ONE spawn of 4 gloo ranks
  (`torch_ranks`): its losses and state against the JAX overlapped step
  at dp 4 on 4 virtual devices and against the port's single-rank step,
  at rtol 1e-5 (atol 1e-6 for losses, 1e-7 for state, for entries near
  zero: f32 sums of 4 shards' gradients in another order); every rank
  holds the same state after it, while the `skip_reduce` twin (local
  gradients, no ring) leaves each rank a different state and the
  trainer's own state untouched.  The captured step (the default)
  equals the uncaptured one bit for bit there, keeps every rank's state
  in its storage when donated, and returns new state tensors with
  donate_state=False.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel.mesh import parse_mesh_spec as jparse
from paddle_tpu.parallel.sharding import (param_spec_reason as jreason,
                                          zero1_spec_reason as jzreason)
from paddle_tpu.spmd import PartitionPlan as JPlan
from paddle_tpu.spmd import SpmdTrainer as JSpmd
from paddle_tpu.spmd import build_partition_plan as jbuild
from paddle_tpu.spmd import overlap as joverlap

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import spmd
from paddle_tpu_torch.parallel.mesh import parse_mesh_spec
from paddle_tpu_torch.parallel.sharding import (P, param_spec_reason,
                                                zero1_spec_reason)
from paddle_tpu_torch.spmd import overlap as toverlap

import torch_parallel_cases as pcases
import torch_spmd_cases as cases
from torch_ranks import CaseFailed, run_cases

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
STATE_TOL = dict(rtol=1e-5, atol=1e-7)
STEPS = 4
BUCKET = 64 << 10
FEEDS = ["x", "label"]


def _jax_trainer(n_devices, **kw):
    main, startup, avg = pcases.build_mlp(jfluid)
    return JSpmd(main, startup, feed_names=FEEDS, fetch_names=[avg.name],
                 mesh=jmake_mesh(n_devices=n_devices), use_pcache=False,
                 **kw).init()


def _run_jax(tr, steps=STEPS):
    losses = [float(np.asarray(tr.step(pcases.mlp_feeds(i))[0])
                    .reshape(-1)[0]) for i in range(steps)]
    return losses, {n: np.asarray(v) for n, v in tr.state.items()}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX trainers: single-device (its initial state is every
    run's) and overlapped at dp 4."""
    single = _jax_trainer(1)
    init = {n: np.array(v) for n, v in single.state.items()}
    over = _jax_trainer(4, bucket_bytes=BUCKET)
    over.state = {n: jnp_put(init[n], over._shardings[n])
                  for n in over.state}
    return {"init": init, "single": _run_jax(single),
            "overlap": _run_jax(over), "overlap_mode": over.step_mode}


def jnp_put(value, sharding):
    import jax

    return jax.device_put(value, sharding)


@pytest.fixture(scope="module")
def world_one():
    """The port's trainer at world size 1 in this process, from the JAX
    initial state; the group is gone afterwards."""
    yield cases.trainer({}, None, BUCKET)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """The rank-side case of this file, in one spawn of 4 ranks."""
    todo = {"overlap": (cases.overlapped_dp,
                        (jax_side["init"], STEPS, BUCKET)),
            "overlap_capture": (cases.overlap_capture,
                                (jax_side["init"], STEPS, BUCKET))}
    return run_cases(todo, 4, tmp_path_factory.mktemp("ranks"))


def _result(ranks, name):
    got = ranks[name]
    if isinstance(got, CaseFailed):
        pytest.fail("rank-side case %s raised:\n%s" % (name, got))
    return got


def _assert_close(a, b):
    np.testing.assert_allclose(a[0], b[0], **LOSS_TOL)
    assert a[1].keys() == b[1].keys()
    for n in a[1]:
        np.testing.assert_allclose(a[1][n], b[1][n], err_msg=n,
                                   **STATE_TOL)


# -- param_spec_reason / zero1_spec_reason boundaries ----------------------

@pytest.mark.parametrize("shape,mesh", [
    ((1024, 1024), "dp=4,mp=2"), ((1024, 1025), "dp=4,mp=2"),
    ((512, 512), "dp=4,mp=2"), ((512, 511), "dp=4,mp=2"),
    ((511, 511), "dp=4,mp=2"), ((515, 515), "dp=4,mp=2"),
    ((64, 3, 3, 3), "dp=4,mp=2"), ((515, 515), "dp=8")])
def test_spec_reason_boundaries(shape, mesh):
    t = param_spec_reason("w", shape, parse_mesh_spec(mesh))
    j = jreason("w", shape, jparse(mesh))
    assert (tuple(t[0]), t[1]) == (tuple(j[0]), j[1])


@pytest.mark.parametrize("base,shape,mesh", [
    ((), (8,), "dp=8"), ((), (), "dp=8"), ((), (7, 9), "dp=8"),
    (("mp", None), (1024, 1024), "dp=4,mp=2"), ((), (8,), "mp=2")])
def test_zero1_boundaries(base, shape, mesh):
    t = zero1_spec_reason(P(*base), shape, parse_mesh_spec(mesh))
    j = jzreason(jax_p(base), shape, jparse(mesh))
    assert (tuple(t[0]), t[1]) == (tuple(j[0]), j[1])


def jax_p(entries):
    from jax.sharding import PartitionSpec

    return PartitionSpec(*entries)


# -- the plan artifact -----------------------------------------------------

def test_rule_matching_precedence():
    doc = [[r"fc_.*\.w_0", ["mp", None]], [r".*\.w_0", [None, "mp"]]]
    from paddle_tpu.spmd import load_rules as jload
    from paddle_tpu.spmd import match_partition_rules as jmatch

    rules, jrules = spmd.load_rules(doc), jload(doc)
    assert rules == jrules
    for name in ("fc_1.w_0", "conv0.w_0", "fc_1.b_0"):
        assert spmd.match_partition_rules(rules, name) == \
            jmatch(jrules, name)
    assert spmd.match_partition_rules(rules, "fc_1.b_0") == (None, None)
    with pytest.raises(Exception):
        spmd.load_rules([["(unclosed", [None]]])


def _plans(mesh="dp=4,mp=2", **kw):
    tmain, _, tavg = pcases.build_mlp(tfluid)
    jmain, _, javg = pcases.build_mlp(jfluid)
    return (spmd.build_partition_plan(tmain, parse_mesh_spec(mesh), FEEDS,
                                      [tavg.name], **kw),
            jbuild(jmain, jparse(mesh), FEEDS, [javg.name], **kw))


def _comparable(doc):
    doc = json.loads(json.dumps(doc))
    doc["comm"].pop("step_seconds_floor")
    return doc


@pytest.mark.parametrize("mesh,kw", [
    ("dp=4,mp=2", {}), ("dp=8", {"zero_stage": 1}),
    ("dp=2,mp=2", {"rules": [(r"fc_1\.w_0", (None, "mp"))]}),
    ("dp=4,mp=2", {"zero_stage": 1, "model": "mlp"})])
def test_plan_to_dict_and_fingerprint_equal_jax(mesh, kw):
    plan, jplan = _plans(mesh, **kw)
    assert plan.fingerprint() == jplan.fingerprint()
    assert _comparable(plan.to_dict()) == _comparable(jplan.to_dict())
    assert plan.summary().splitlines()[:2] == \
        jplan.summary().splitlines()[:2]


def test_plan_roundtrip_and_fingerprint(tmp_path):
    plan, jplan = _plans()
    again, _ = _plans()
    assert plan.fingerprint() == again.fingerprint()
    path = str(tmp_path / "plan.json")
    plan.save(path)
    loaded = spmd.PartitionPlan.load(path)
    assert loaded.fingerprint() == plan.fingerprint()
    assert loaded.var_specs == plan.var_specs
    assert loaded.mesh_axes == {"dp": 4, "mp": 2}
    assert "comm" in plan.summary()
    # a plan crosses between the packages as its JSON, both ways
    assert JPlan.load(path).fingerprint() == jplan.fingerprint()
    jpath = str(tmp_path / "jplan.json")
    jplan.save(jpath)
    crossed = spmd.PartitionPlan.load(jpath)
    assert crossed.fingerprint() == plan.fingerprint()
    assert crossed.to_dict() == JPlan.load(jpath).to_dict()
    with pytest.raises(ValueError, match="not a partition plan"):
        spmd.PartitionPlan.from_dict({"kind": "other"})


def test_rules_reshape_the_plan():
    base, _ = _plans()
    ruled, jruled = _plans(rules=spmd.load_rules(
        [[r"fc_1\.w_0", [None, "mp"]]]))
    assert tuple(base.var_specs["fc_1.w_0"]) == ("mp", None)
    assert tuple(ruled.var_specs["fc_1.w_0"]) == (None, "mp")
    assert base.fingerprint() != ruled.fingerprint() == \
        jruled.fingerprint()
    assert ruled.spec_of("fc_1.w_0") == P(None, "mp")
    assert ruled.spec_of("no_such_var") == P()


def test_trainer_rejects_mismatched_plan(world_one):
    plan, _ = _plans("dp=2,mp=2")
    main, startup, avg = pcases.build_mlp(tfluid)
    tr = spmd.SpmdTrainer(main, startup, FEEDS, [avg.name],
                          world_one.mesh, plan=plan, use_pcache=False)
    with pytest.raises(ValueError, match="shard_cli plan"):
        tr.init()


# -- the overlapped schedule's gate ----------------------------------------

def test_overlap_supported_reasons():
    def both(mesh, zero_stage=0, build=pcases.build_mlp):
        t = toverlap.overlap_supported(build(tfluid)[0], mesh,
                                       zero_stage=zero_stage)
        j = joverlap.overlap_supported(build(jfluid)[0],
                                       jmake_mesh(n_devices=8, **mesh),
                                       zero_stage=zero_stage)
        assert t == j
        return t

    assert both({"dp": 1, "mp": 8}) == (
        False, "mesh has no dp axis wider than 1")
    assert "not pure data-parallel" in both({"dp": 4, "mp": 2})[1]
    assert "zero1" in both({"dp": 8}, zero_stage=1)[1]
    assert both({"dp": 8}) == (True, None)
    assert "batch_norm" in both({"dp": 8}, build=pcases.build_conv_bn)[1]

    def no_optimizer(fl):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data(name="x", shape=[4], dtype="float32")
            fl.layers.mean(x=fl.layers.fc(input=x, size=2))
        return main, startup, None

    assert "no optimizer op" in both({"dp": 8}, build=no_optimizer)[1]


def test_split_point_matches_jax():
    tmain, _, _ = pcases.build_mlp(tfluid)
    jmain, _, _ = pcases.build_mlp(jfluid)
    t = toverlap._split_point(list(tmain.desc.block(0).ops))
    j = joverlap._split_point(list(jmain.desc.block(0).ops))
    assert t == j and t[0] is not None and len(t[1]) == 4


# -- SpmdTrainer at world size 1 -------------------------------------------

def test_world_one_trainer_matches_jax_single_device(world_one,
                                                     jax_side):
    tr = world_one
    assert tr.step_mode == "gspmd"
    assert tr.overlap_fallback_reason == \
        "mesh has no dp axis wider than 1"
    scope = tfluid.Scope()
    tfluid.io.params_from_numpy(scope, jax_side["init"], "cpu")
    tr.load_state_from(scope)
    assert tr._aot_state == "off"
    losses = [float(tr.step(pcases.mlp_feeds(i))[0].reshape(-1)[0])
              for i in range(STEPS)]
    state = {n: tr.fetch_state(n) for n in tr.state}
    _assert_close((losses, state), jax_side["single"])
    from paddle_tpu_torch.obs import flight

    ctx = flight.host_context()
    assert ctx["process_index"] == 0 and ctx["host"]
    assert ctx["mesh_axes"] == {"dp": 1, "mp": 1}
    assert ctx["plan_fingerprint"] == tr.plan.fingerprint()


def test_aot_state_and_checkpoint_names(world_one, tmp_path):
    """Without FLAGS_compile_cache_dir the first step records
    "no-cache", as the JAX trainer does when `get_cache()` is None."""
    main, startup, avg = pcases.build_mlp(tfluid)
    tr = spmd.SpmdTrainer(main, startup, FEEDS, [avg.name],
                          world_one.mesh).init()
    assert tr._aot_state == "pending"
    tr.step(pcases.mlp_feeds(0))
    assert tr._aot_state == "no-cache"
    # the checkpoint names came with spmd/checkpoint.py: an empty root
    # has nothing to restore, the JAX trainer's IOError
    with pytest.raises(IOError, match="no complete sharded checkpoint"):
        tr.restore_checkpoint(str(tmp_path))


def _cached_trainer(world_one, **kw):
    main, startup, avg = pcases.build_mlp(tfluid)
    return spmd.SpmdTrainer(main, startup, FEEDS, [avg.name],
                            world_one.mesh, **kw).init()


def test_aot_states_compiled_hit_error_off(world_one, tmp_path):
    """On a cache directory: the first trainer looks up ("tried"), its
    capture at the second step stores the entry ("compiled"); a second
    trainer hits at its first step and still captures, with the same
    losses; a directory that cannot be made records "error" and the
    steps run captured; use_pcache=False records "off"."""
    from paddle_tpu_torch.compile import pcache
    from paddle_tpu_torch.utils import flags

    flags.set_flag("compile_cache_dir", str(tmp_path / "cache"))
    try:
        pcache.reset()
        first = _cached_trainer(world_one)
        states, losses = [], []
        for i in range(3):
            losses.append(float(first.step(pcases.mlp_feeds(i))[0]
                                .reshape(-1)[0]))
            states.append(first._aot_state)
        assert states == ["tried", "compiled", "compiled"]
        assert first.captured.captures == 1
        cache = pcache.get_cache()
        entry = cache.get(first._pcache_key(pcases.mlp_feeds(0)))
        assert entry["origin"] == "spmd_step" and entry["mode"] == "gspmd"
        assert entry["donated"] is True
        assert entry["mesh"] == {"dp": 1, "mp": 1}
        assert entry["plan"] == first.plan.fingerprint()
        assert entry["capture_seconds"] > 0
        pcache.reset()
        second = _cached_trainer(world_one)
        again = [float(second.step(pcases.mlp_feeds(i))[0].reshape(-1)[0])
                 for i in range(3)]
        assert second._aot_state == "hit" and again == losses
        assert second.captured.captures == 1
        off = _cached_trainer(world_one, use_pcache=False)
        off.step(pcases.mlp_feeds(0))
        assert off._aot_state == "off"
        flags.set_flag("compile_cache_dir", "")
        broken = _cached_trainer(world_one)
        # a cache root that is a file: the lookup's I/O fails
        (tmp_path / "file").write_text("")
        flags.set_flag("compile_cache_dir", str(tmp_path / "file"))
        pcache.reset()
        out = [float(broken.step(pcases.mlp_feeds(i))[0].reshape(-1)[0])
               for i in range(3)]
        assert broken._aot_state == "error" and out == losses
        assert (broken.captured.captures, broken.captured.replays) == (1, 1)
    finally:
        flags.set_flag("compile_cache_dir", "")
        pcache.reset()


def test_a_cache_entry_of_another_step_is_no_hit(world_one, tmp_path):
    """An entry under the key whose meta names another step (here, a
    plan fingerprint edited in place) fails the check: quarantined, a
    miss, and the trainer's capture stores its own."""
    import json as json_mod

    from paddle_tpu_torch.compile import pcache
    from paddle_tpu_torch.utils import flags

    flags.set_flag("compile_cache_dir", str(tmp_path / "cache"))
    try:
        pcache.reset()
        first = _cached_trainer(world_one)
        for i in range(2):
            first.step(pcases.mlp_feeds(i))
        key = first._pcache_key(pcases.mlp_feeds(0))
        cache = pcache.get_cache()
        entry = cache.get(key)
        cache.put(key, dict(entry, plan="0" * 64))
        second = _cached_trainer(world_one)
        for i in range(2):
            second.step(pcases.mlp_feeds(i))
        assert second._aot_state == "compiled"
        assert json_mod.dumps(cache.get(key)["plan"]) == \
            json_mod.dumps(first.plan.fingerprint())
    finally:
        flags.set_flag("compile_cache_dir", "")
        pcache.reset()


def test_overlapped_dp_matches_jax_and_single_rank(ranks, jax_side,
                                                   world_one):
    (mode, losses, state, digests, twin_digests,
     unchanged) = _result(ranks, "overlap")
    assert mode == "overlap-dp" == jax_side["overlap_mode"]
    assert all(np.isfinite(losses))
    _assert_close((losses, state), jax_side["overlap"])
    _assert_close((losses, state), jax_side["single"])
    # the port's single-rank step from the same state
    tr = cases.trainer({}, jax_side["init"], BUCKET)
    single = [float(tr.step(pcases.mlp_feeds(i))[0].reshape(-1)[0])
              for i in range(STEPS)]
    _assert_close((losses, state),
                  (single, {n: tr.fetch_state(n) for n in tr.state}))
    # every rank holds the same state; the twin's differ rank to rank
    assert len(set(digests)) == 1
    assert len(set(twin_digests)) == 4
    assert unchanged


def test_overlapped_dp_captured_equals_uncaptured(ranks):
    got = _result(ranks, "overlap_capture")
    cap, unc, nod = got["captured"], got["uncaptured"], got["nodonate"]
    assert cap[0] == unc[0] == nod[0] == "overlap-dp"
    assert cap[1] == unc[1] == nod[1]
    assert cap[2] == unc[2] == nod[2] and len(set(cap[2])) == 1
    # donated: each rank's state in its own storage; else new tensors
    assert cap[3] and not unc[3] and not nod[3]
    assert cap[4] == nod[4] == (1, STEPS - 2) and unc[4] is None
