"""The port's sharded SPMD checkpoints (`paddle_tpu_torch.spmd.checkpoint`)
and multi-card bench legs (`spmd.bench`) against the JAX package's, on
the CPU.

- In this process, on a world of one gloo rank: `save_sharded`'s
  manifest fields for a plain state equal the JAX function's;
  `StaleGenerationError` names both generations, from both packages; a
  torn snapshot (no global manifest) is skipped by
  `latest_sharded_checkpoint`, and a corrupt newest one by the saver's
  `restore_latest`, across the packages; a snapshot is unchanged by a
  step (and by an in-place update of the state) taken between `save`
  and `wait`, while the writer is held by an injected latency;
  bfloat16 state crosses as the JAX saver's bytes (`|V2`) both ways;
  `measure_densify_restore` refuses a world too small with the JAX
  error.
- In ONE spawn of 4 gloo ranks (`torch_ranks`), with the JAX side on 4
  of the virtual CPU devices in this process (the probe MLP, ZeRO-1,
  mesh {"dp": 4, "mp": 1}): the JAX package's snapshot restores in the
  port with `densified == []`, bit for bit, and the port's in the JAX
  package the same way; the two snapshots' manifests carry the same
  mesh, specs, vars, generation, plan fingerprint, shapes, dtypes and
  shard index keys (the port writes one host directory per rank, the
  JAX package one for its 4 devices); tests/test_spmd.py's save,
  restore and `attach_supervisor` resume at dp 4 equal the
  uninterrupted run bit for bit; a dp 4 snapshot restored onto dp 2
  goes through the densify path to the same values;
  `measure_densify_restore`'s blob from 4 shards to 2 has the JAX
  blob's fields and values (its `device_peak_bytes` comes from the
  card's watermarks, and on the CPU neither package reports one);
  `spmd.bench.run_leg` at dp 4 gives tests/test_spmd.py's record
  schema, and its history line is one the port's
  `tune.fit.join_comm_history` joins as the JAX package's does.
- In a second spawn of 4 gloo ranks, `attach_supervisor(...).run()`
  decides its saves on every rank at once: a wall-clock interval that
  comes due on one rank a step before the others, and SIGTERM sent to
  one rank only, give every rank the same snapshots at the same steps,
  and the run equals the unsupervised one (ROADMAP C11: each rank read
  its own clock and its own signal, and a rank that saved alone met the
  others' step collectives with its checkpoint's).  In the same spawn a
  retryable fault on one rank only (an io_error at `supervisor/step` on
  rank 1, a reader IOError on rank 2, an injected nonfinite on rank 3)
  restarts every rank from the same snapshot, and the run again equals
  the unsupervised one (ROADMAP C12: the faulted rank restored alone
  while the others waited in their next step's collectives).
"""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.spmd import SpmdTrainer as JSpmd
from paddle_tpu.spmd import checkpoint as jckpt

from paddle_tpu_torch import spmd
from paddle_tpu_torch.parallel import make_mesh
from paddle_tpu_torch.parallel.sharding import NamedSharding, P
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.spmd import checkpoint as tckpt

import torch_ckpt_cases as ckcases
import torch_parallel_cases as pcases
import torch_spmd_cases as cases
from torch_ranks import CaseFailed, run_cases

torch.set_num_threads(1)

FEEDS = ["x", "label"]
RULES = [[r"fc_1\.w_0", ["mp", None]]]


def _jax_trainer(**kw):
    main, startup, avg = pcases.build_mlp(jfluid)
    return JSpmd(main, startup, feed_names=FEEDS, fetch_names=[avg.name],
                 mesh=jmake_mesh(n_devices=4), zero_stage=1,
                 use_pcache=False, **kw).init()


def _np_state(tr):
    return {n: np.asarray(v) for n, v in tr.state.items()}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX trainer at 4 devices with ZeRO-1: its initial state, 2
    steps, a snapshot of them and the state it holds."""
    root = str(tmp_path_factory.mktemp("jax_ckpt"))
    tr = _jax_trainer()
    init = {n: np.array(v) for n, v in tr.state.items()}
    for i in range(2):
        tr.step(pcases.mlp_feeds(i))
    snap = tr.save_checkpoint(root, step=2)
    return {"init": init, "root": root, "snap": snap,
            "state": _np_state(tr)}


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """The rank-side cases of this file, in one spawn of 4 ranks."""
    d = tmp_path_factory.mktemp("ranks")
    init = jax_side["init"]
    todo = {
        "restore_jax": (ckcases.restore_jax_snapshot, (jax_side["root"],)),
        "save_for_jax": (ckcases.save_for_jax,
                         (str(d / "port_ckpt"), init, 2)),
        "resume": (ckcases.resume_and_supervise,
                   (str(d / "resume"), str(d / "sup"), init, RULES)),
        "densify": (ckcases.densify_4_to_2, (str(d / "densify"), init)),
        "bench": (ckcases.bench_leg, (str(d / "hist.jsonl"),)),
    }
    return run_cases(todo, 4, d, timeout=360)


def _result(ranks, name):
    got = ranks[name]
    if isinstance(got, CaseFailed):
        pytest.fail("rank-side case %s raised:\n%s" % (name, got))
    return got


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for n in a:
        np.testing.assert_array_equal(np.asarray(a[n]), np.asarray(b[n]),
                                      err_msg=n)


@pytest.fixture(scope="module")
def world_one():
    """A world of one gloo rank in this process (the mesh of the
    in-process cases); gone afterwards."""
    yield make_mesh(device="cpu")
    torch.distributed.destroy_process_group()


# -- in this process -------------------------------------------------------

def test_manifest_fields_equal_jax_for_a_plain_state(tmp_path):
    state = {"w": np.arange(8.0, dtype=np.float32).reshape(2, 4),
             "b": np.ones(3, np.float32)}
    kw = dict(mesh_axes={"dp": 2}, generation=5,
              plan_fingerprint="fp123", specs={"w": ["dp", None]})
    snaps = {"port": tckpt.save_sharded(tmp_path / "port", 7, state, **kw),
             "jax": jckpt.save_sharded(tmp_path / "jax", 7, state, **kw)}
    docs = {}
    for k, snap in snaps.items():
        assert os.path.basename(snap) == "checkpoint_000000007"
        with open(os.path.join(snap, tckpt.SPMD_MANIFEST)) as f:
            man = json.load(f)
        man.pop("time")
        with open(os.path.join(snap, "host00000",
                               "_host_manifest.json")) as f:
            docs[k] = (man, json.load(f),
                       sorted(os.listdir(os.path.join(snap, "host00000"))))
    assert docs["port"] == docs["jax"]
    assert docs["port"][0]["generation"] == 5
    assert docs["port"][0]["plan_fingerprint"] == "fp123"
    # each reads the other's
    for other, reader in (("jax", tckpt._ShardReader),
                          ("port", jckpt._ShardReader)):
        r = reader(snaps[other])
        np.testing.assert_array_equal(
            r.load_shard("w", ((0, 2), (0, 4))), state["w"])


def test_stale_generation_error_names_both(world_one, tmp_path):
    snap = tckpt.save_sharded(tmp_path, 7, {"w": np.arange(8.0)},
                              generation=5)
    shardings = {"w": NamedSharding(world_one, P())}
    with pytest.raises(spmd.StaleGenerationError) as err:
        tckpt.restore_sharded(snap, shardings, max_generation=4)
    assert (err.value.manifest_generation,
            err.value.caller_generation) == (5, 4)
    jerr = jckpt.StaleGenerationError(snap, 5, 4)
    assert str(err.value) == str(jerr)
    assert "generation 5" in str(err.value) \
        and "generation 4" in str(err.value)
    assert not isinstance(err.value, IOError)
    state, info = tckpt.restore_sharded(snap, shardings,
                                        max_generation=5)
    assert info["generation"] == 5 and info["densified"] == []
    np.testing.assert_array_equal(state["w"].full_tensor().numpy(),
                                  np.arange(8.0))


def test_torn_snapshot_is_skipped(world_one, tmp_path):
    for step in (1, 2):
        tckpt.save_sharded(tmp_path, step, {"w": np.full(4, float(step))})
    jckpt.save_sharded(tmp_path, 3, {"w": np.full(4, 3.0)})
    # the newest is torn (its global manifest never landed): skipped
    os.remove(os.path.join(tmp_path, "checkpoint_000000003",
                           tckpt.SPMD_MANIFEST))
    latest = tckpt.latest_sharded_checkpoint(tmp_path)
    assert latest == jckpt.latest_sharded_checkpoint(tmp_path)
    assert latest.endswith("checkpoint_000000002")
    # a corrupt newest complete one: the saver falls back past it
    shard = os.path.join(latest, "host00000", "w.shard0.npz")
    with open(shard, "rb") as f:
        blob = bytearray(f.read())
    blob[len(blob) // 2] ^= 0xFF
    with open(shard, "wb") as f:
        f.write(bytes(blob))

    class _Trainer:
        state = None
        _shardings = {"w": NamedSharding(world_one, P())}

    tr = _Trainer()
    saver = spmd.SpmdCheckpointSaver(tr, tmp_path)
    assert saver.latest() == latest
    assert saver.restore_latest() == 1
    np.testing.assert_array_equal(tr.state["w"].full_tensor().numpy(),
                                  np.full(4, 1.0))
    with pytest.raises(IOError, match="crc mismatch"):
        tckpt.restore_sharded(latest, tr._shardings)


def test_capture_is_a_copy(world_one, tmp_path):
    tr = cases.trainer({}, None, 0, zero_stage=1)
    tr.step(pcases.mlp_feeds(0))
    # copies: at world one a fetched value may share the state's memory
    before = {n: np.array(tr.fetch_state(n)) for n in tr.state}
    saver = spmd.SpmdCheckpointSaver(tr, tmp_path, interval_secs=0.0)
    faults.enable(seed=0)
    try:
        # the writer thread sleeps before its first file
        faults.inject("checkpoint/write", "latency", latency_s=0.5)
        saver.save(1)
        assert saver._thread.is_alive()
        tr.step(pcases.mlp_feeds(1))
        for v in tr.state.values():   # and an in-place optimizer
            v.to_local().add_(1.0)
        saver.wait()
    finally:
        faults.disable()
    assert saver.last_capture_s > 0 and saver.last_write_s >= 0.5
    fresh = cases.trainer({}, None, 0, zero_stage=1)
    info = fresh.restore_checkpoint(tmp_path)
    assert info["step"] == 1 and info["densified"] == []
    _assert_same({n: fresh.fetch_state(n) for n in fresh.state}, before)


def test_bfloat16_state_crosses_as_the_jax_bytes(world_one, tmp_path):
    import jax.numpy as jnp

    vals = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    tbf = torch.from_numpy(vals).to(torch.bfloat16)
    tsnap = tckpt.save_sharded(tmp_path / "port", 1, {"h": tbf})
    jsnap = jckpt.save_sharded(tmp_path / "jax", 1,
                               {"h": jnp.asarray(vals, jnp.bfloat16)})
    for snap in (tsnap, jsnap):
        path = os.path.join(snap, "host00000", "h.shard0.npz")
        with np.load(path) as z:
            assert z["data"].dtype.str == "|V2", z["data"].dtype
        with open(os.path.join(snap, "host00000",
                               "_host_manifest.json")) as f:
            assert json.load(f)["h"]["dtype"] == "bfloat16"
        state, _ = tckpt.restore_sharded(
            snap, {"h": NamedSharding(world_one, P())})
        got = state["h"].full_tensor()
        assert got.dtype == torch.bfloat16 and torch.equal(got, tbf)
    # the same array bytes (the npz's zip headers carry their write time)
    datas = []
    for snap in (tsnap, jsnap):
        with np.load(os.path.join(snap, "host00000", "h.shard0.npz")) as z:
            datas.append(z["data"].tobytes())
    assert datas[0] == datas[1]


def test_measure_densify_restore_needs_the_ranks(world_one, tmp_path):
    with pytest.raises(ValueError, match="need 4 devices for the "
                                         "measurement, have 1"):
        spmd.measure_densify_restore(tmp_path, from_dp=4, to_dp=2)


def test_checkpoint_names_equal_jax():
    assert sorted(tckpt.__all__) == sorted(jckpt.__all__)
    assert tckpt.SPMD_MANIFEST == jckpt.SPMD_MANIFEST
    assert (tckpt.HOST_MANIFEST, tckpt.SPMD_CKPT_KIND) == \
        (jckpt.HOST_MANIFEST, jckpt.SPMD_CKPT_KIND)


# -- 4 ranks ---------------------------------------------------------------

def test_jax_snapshot_restores_in_the_port(ranks, jax_side):
    info, state = _result(ranks, "restore_jax")
    assert info["step"] == 2 and info["densified"] == []
    assert info["generation"] == 0
    _assert_same(state, jax_side["state"])


def test_port_snapshot_restores_in_jax(ranks):
    snap, _losses, state, _man, _hosts = _result(ranks, "save_for_jax")
    fresh = _jax_trainer()
    info = fresh.restore_checkpoint(os.path.dirname(snap))
    assert info["step"] == 2 and info["densified"] == []
    _assert_same(_np_state(fresh), state)


def test_manifests_equal_jax(ranks, jax_side):
    _snap, _losses, _state, man, hosts = _result(ranks, "save_for_jax")
    jman, jhosts = ckcases._manifests(jax_side["snap"])
    assert man["n_processes"] == 4 and jman["n_processes"] == 1
    assert man["hosts"] == ["host%05d" % i for i in range(4)]
    for key in ("kind", "step", "vars", "mesh", "specs", "generation",
                "plan_fingerprint"):
        assert man[key] == jman[key], key
    assert man["mesh"] == {"dp": 4, "mp": 1}

    def by_var(host_docs):
        out = {}
        for doc in host_docs.values():
            for name, v in doc.items():
                ent = out.setdefault(name, {"global_shape": v[
                    "global_shape"], "dtype": v["dtype"], "index": []})
                ent["index"] += [e["index"] for e in v["shards"]]
        for ent in out.values():
            ent["index"].sort()
        return out

    assert by_var(hosts) == by_var(jhosts)
    # ZeRO-1 split each velocity 4 ways, one shard per rank's host dir
    vel = by_var(hosts)["fc_0.w_0_velocity_0"]["index"]
    assert len(vel) == 4 and all(
        any(e["index"] for e in hosts["host%05d" % r][
            "fc_0.w_0_velocity_0"]["shards"]) for r in range(4))


def test_resume_and_supervisor_equal_the_uninterrupted_run(ranks):
    got = _result(ranks, "resume")
    assert got["info"]["step"] == 2 and got["info"]["densified"] == []
    assert got["manifest"]["mesh"] == {"dp": 4, "mp": 1}
    _assert_same(got["restored"], got["saved"])
    assert got["resumed"] == got["straight"]
    _assert_same(got["resumed_state"], got["straight_state"])
    assert got["sup_latest"] is not None and got["sup_step"] == 3
    assert got["sup_spec"] == ["mp", None]
    _assert_same(got["sup_restored"], got["sup_state"])


def test_dp4_snapshot_densifies_onto_dp2(ranks):
    info, full4, full2, _blob = _result(ranks, "densify")
    assert info["step"] == 2
    # the ZeRO-1 velocities were split 4 ways and now 2: rebuilt
    assert info["densified"] == sorted(
        n for n in full4 if n.endswith("_velocity_0"))
    _assert_same(full2, full4)


def test_measure_densify_restore_blob_equals_jax(ranks, tmp_path):
    _info, _full4, _full2, blob = _result(ranks, "densify")
    jblob = jckpt.measure_densify_restore(tmp_path, from_dp=4, to_dp=2,
                                          n_vars=2, rows=512, cols=64)
    timing = ("seconds", "mib_per_s")
    assert "device_peak_bytes" not in blob
    assert {k: v for k, v in blob.items() if k not in timing} == \
        {k: v for k, v in jblob.items() if k not in timing}
    assert blob["densified"] == 2 and blob["verified"]
    assert blob["bytes_total"] == 2 * 512 * 64 * 4
    assert blob["seconds"] > 0 and blob["mib_per_s"] > 0


def test_bench_record_schema_at_dp4(ranks):
    from paddle_tpu.tune import fit as jfit

    from paddle_tpu_torch.tune import fit as tune_fit

    rec, lines = _result(ranks, "bench")
    assert rec["unit"] == "img/s" and rec["value"] > 0
    assert rec["n_devices"] == 4 and rec["mesh"] == {"dp": 4, "mp": 1}
    assert rec["platform_class"] == "cpu:d4:dp=4,mp=1"
    assert rec["metric"] == "multichip_lenet5_dp4"
    comm = rec["comm"]
    assert comm["wire_bytes"] > 0 and comm["measured_s"] > 0
    assert comm["pred_s"] > 0 and comm["n_buckets"] >= 1
    assert comm["step_mode"] == rec["config"]["step_mode"] == "gspmd"
    (line,) = lines
    assert line["platform_class"] == rec["platform_class"]
    # the record is one the port's fit joins as the JAX package's does
    pairs = tune_fit.join_comm_history([line])
    assert pairs and pairs == jfit.join_comm_history([line])
    assert tune_fit.fit_calibration([], comm_pairs=pairs).to_dict() == \
        jfit.fit_calibration([], comm_pairs=pairs).to_dict()


def test_supervisor_meta_needs_no_shared_temporary(world_one, tmp_path):
    """Every rank of a sharded job's supervisor writes `supervisor.json`
    into the one snapshot; a temporary file of a fixed name (another
    rank's, mid-write, here held by a directory of that name) must not
    stand in its way (ROADMAP C10)."""
    tr = cases.trainer({}, None, 0, zero_stage=1)
    sup = spmd.attach_supervisor(tr, tmp_path, interval_secs=0.0)
    snap = os.path.join(str(tmp_path), "checkpoint_%09d" % 0)
    os.makedirs(os.path.join(snap, "supervisor.json.tmp"))
    assert sup._checkpoint("periodic") == snap
    with open(os.path.join(snap, "supervisor.json")) as f:
        assert json.load(f)["step"] == 0
    sup._restore_latest()
    assert sup._step == 0 and sup.generation == 0


SUPERVISED_STEPS = 8
# (case, fault kind at `supervisor/step`, the one rank it fires on, step)
STEP_FAULTS = (("step_io_error", "io_error", 1, 5),
               ("step_nonfinite", "nonfinite", 3, 7))


@pytest.fixture(scope="module")
def supervised(jax_side, tmp_path_factory):
    """The supervised runs of 4 ranks, in one spawn."""
    d = tmp_path_factory.mktemp("supervised")
    init, n = jax_side["init"], SUPERVISED_STEPS
    todo = {
        "straight": (ckcases.straight_run, (init, n)),
        "clock_skew": (ckcases.supervised_clock_skew,
                       (str(d / "skew"), init, n)),
        "sigterm": (ckcases.supervised_sigterm,
                    (str(d / "sigterm"), init, n)),
    }
    for name, kind, rank, at in STEP_FAULTS:
        todo[name] = (ckcases.supervised_step_fault,
                      (str(d / name), init, n, kind, rank, at))
    todo["reader_io_error"] = (ckcases.supervised_reader_fault,
                               (str(d / "reader"), init, n, 2, 3))
    return run_cases(todo, 4, d, timeout=180)


def test_supervised_saves_agree_under_clock_skew(supervised):
    straight, straight_state = _result(supervised, "straight")
    everyone, summary, losses, state = _result(supervised, "clock_skew")
    made = everyone[0]
    assert all(m == made for m in everyone), everyone
    assert ("interval" in {kind for _, kind in made}), made
    assert made[0] == (0, "baseline") and made[-1] == (8, "final")
    assert summary == {"steps": 8, "epochs": 1, "restarts": 0}
    assert losses == straight
    _assert_same(state, straight_state)


def test_sigterm_on_one_rank_preempts_every_rank(supervised):
    straight, straight_state = _result(supervised, "straight")
    everyone, summary, losses, state = _result(supervised, "sigterm")
    expected = [(0, "baseline"), (4, "urgent"), (8, "epoch"), (8, "final")]
    assert everyone == [expected] * 4
    assert summary == {"steps": 8, "epochs": 1, "restarts": 1}
    assert losses == straight
    _assert_same(state, straight_state)


@pytest.mark.parametrize("case", ["step_io_error", "reader_io_error",
                                  "step_nonfinite"])
def test_fault_on_one_rank_restarts_every_rank(supervised, case):
    """A retryable fault on one rank of four (ROADMAP C12): an io_error at
    `supervisor/step` on rank 1, a reader IOError on rank 2, an injected
    nonfinite on rank 3.  The ranks agree on it at the step boundary, so
    every rank restores the same snapshot and replays (before the repair
    the faulted rank restored alone and the others hung in their next
    step's collectives)."""
    straight, straight_state = _result(supervised, "straight")
    everyone, summary, losses, state = _result(supervised, case)
    made = everyone[0]
    assert all(m == made for m in everyone), everyone
    assert made[0] == (0, "baseline") and made[-1] == (8, "final"), made
    assert summary == {"steps": 8, "epochs": 1, "restarts": 1}
    assert losses == straight
    _assert_same(state, straight_state)
