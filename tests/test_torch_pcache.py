"""The port's persistent plan cache (`compile/pcache.py`) and its executor
wiring, case by case against tests/test_compile_cache.py.

A JAX entry is a serialized executable; a port entry holds what a
process can reload: a program's pass-rewritten clone, its segment plan,
its donation plan and the verifier's verdict.  So the JAX cases read in
the port's terms:

  * the fingerprint cases run on the port's `fingerprint` module and
    give the JAX package's digests for the same programs;
  * `test_put_get_roundtrip` stores and loads a plan payload (JSON),
    and `test_serialize_unsupported_stores_stub` is a capture's stub
    (a miss on load, seen by stats and eviction);
  * `test_restart_reload_zero_compiles` becomes zero pipeline runs and
    no donation analysis on a plan hit, with the restart's captures
    counted apart and its outputs the cold run's bits;
  * `test_different_shapes_get_distinct_entries`: a plan does not
    depend on shapes, so two feed shapes share one plan entry and give
    one capture stub each.

The port's own cases: a JAX `.ptx` entry under the same root is left
alone and uncounted; a pickle payload is quarantined unread; an entry
whose desc fails the structural check is quarantined under "acquire"; a
cold and a warm training run give the same losses and parameters;
`use_program_cache=False` enters neither cache.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.compile import fingerprint as jfp
from paddle_tpu.compile import pcache as jpcache
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import analysis as tanalysis
from paddle_tpu_torch.compile import fingerprint, pcache
from paddle_tpu_torch.fluid import executor as executor_mod
from paddle_tpu_torch.obs import mem as obs_mem
from paddle_tpu_torch.obs import registry as obs_registry
from paddle_tpu_torch.obs import telemetry as obs_tele
from paddle_tpu_torch.tools.lint_cli import _build_adam_toy
from paddle_tpu_torch.utils import flags

torch.set_num_threads(1)
CPU = fluid.CPUPlace()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_compile_state():
    pcache.reset()
    obs_mem.reset()
    obs_registry.reset_registry()
    yield
    for name in ("compile_cache_dir", "compile_passes"):
        flags.set_flag(name, "")
    flags.set_flag("verify_program", False)
    pcache.reset()
    obs_mem.reset()


def _build_mlp(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[8], dtype="float32")
        h = pkg.layers.fc(input=x, size=4, act="tanh")
        y = pkg.layers.fc(input=h, size=2, act="softmax")
    return main, startup, y.name


def _fp(main, fetch, fp_mod=fingerprint, **kw):
    kw.setdefault("feeds", ["x"])
    kw.setdefault("fetches", [fetch])
    return fp_mod.program_fingerprint(main, **kw)


def _snap(name):
    return obs_tele.snapshot().get(name, 0)


# ---------------------------------------------------------------------------
# fingerprint stability
# ---------------------------------------------------------------------------

class TestFingerprint:
    def test_same_program_rebuilt_same_fingerprint(self):
        m1, _, f1 = _build_mlp(fluid)
        m2, _, f2 = _build_mlp(fluid)
        assert m1 is not m2
        assert _fp(m1, f1) == _fp(m2, f2)
        # the JAX package's digest for the same program
        jm, _, jf = _build_mlp(jfluid)
        assert _fp(m1, f1) == _fp(jm, jf, fp_mod=jfp)

    def test_clone_same_fingerprint(self):
        m, _, f = _build_mlp(fluid)
        assert _fp(m, f) == _fp(m.clone(), f)

    def test_fresh_process_same_fingerprint(self):
        """The restart contract: an independent interpreter building the
        same Program computes the same fingerprint."""
        m, _, f = _build_mlp(fluid)
        here = _fp(m, f)
        code = (
            "import paddle_tpu_torch.fluid as fluid\n"
            "from paddle_tpu_torch.compile import fingerprint\n"
            "main, startup = fluid.Program(), fluid.Program()\n"
            "with fluid.program_guard(main, startup):\n"
            "    x = fluid.layers.data(name='x', shape=[8],"
            " dtype='float32')\n"
            "    h = fluid.layers.fc(input=x, size=4, act='tanh')\n"
            "    y = fluid.layers.fc(input=h, size=2, act='softmax')\n"
            "print(fingerprint.program_fingerprint(main, feeds=['x'],"
            " fetches=[y.name]))\n")
        env = dict(os.environ, PYTHONPATH=REPO)
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             env=env, capture_output=True, text=True,
                             timeout=240)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip().splitlines()[-1] == here

    @pytest.mark.parametrize("label,mutate", [
        ("op attr", lambda m: m.global_block().desc.ops[0]
            .attrs.update(extra_knob=3.0)),
        ("var dtype", lambda m: setattr(
            m.global_block().desc.vars["x"], "dtype", "int32")),
        ("var shape", lambda m: setattr(
            m.global_block().desc.vars["x"], "shape", (-1, 16))),
        ("extra op", lambda m: m.global_block().desc.ops.append(
            m.global_block().desc.ops[0])),
        ("op order", lambda m: m.global_block().desc.ops.reverse()),
    ])
    def test_ir_changes_change_fingerprint(self, label, mutate):
        m, _, f = _build_mlp(fluid)
        base = _fp(m, f)
        mutated = m.clone()
        mutate(mutated)
        assert _fp(mutated, f) != base, label

    def test_context_changes_change_fingerprint(self):
        m, _, f = _build_mlp(fluid)
        base = _fp(m, f)
        table = {
            "feeds": _fp(m, f, feeds=["x", "x2"]),
            "fetches": _fp(m, "other_fetch"),
            "flags": _fp(m, f, flag_items=[("amp_bf16", True)]),
            "pipeline": _fp(m, f, pipeline_id="v1:dce,cse"),
            "mesh": _fp(m, f, mesh={"dp": 4, "mp": 2}),
            "mesh axis": _fp(m, f, mesh={"dp": 8}),
        }
        for label, fp in table.items():
            assert fp != base, label
        assert len(set(table.values())) == len(table)

    def test_values_signature(self):
        a = torch.zeros(2, 3)
        assert fingerprint.values_signature({"a": a}) == \
            fingerprint.values_signature([("a", torch.ones(2, 3))])
        assert fingerprint.values_signature({"a": a}) != \
            fingerprint.values_signature({"a": torch.zeros(2, 4)})
        assert fingerprint.values_signature({"a": a}) != \
            fingerprint.values_signature(
                {"a": torch.zeros(2, 3, dtype=torch.int32)})

    def test_program_key_equals_the_jax_fingerprint_part(self):
        """The executor's program key folds the JAX executor's
        `_pcache_base` fingerprint (IR, feeds, fetches, the four flags,
        the pipeline id) with the port's stack and entry format."""
        from paddle_tpu.compile import passes as jpasses
        from paddle_tpu.utils import flags as jflags
        from paddle_tpu_torch.compile import passes as tpasses

        m, _, f = _build_mlp(fluid)
        jm, _, jf = _build_mlp(jfluid)
        names = executor_mod._PCACHE_FLAGS
        assert names == ("amp_bf16", "amp_bf16_act", "bn_shifted_stats",
                         "donation")
        ours = _fp(m, f, flag_items=[(k, flags.get_flag(k))
                                     for k in names],
                   pipeline_id=tpasses.pipeline_id("default"))
        theirs = _fp(jm, jf, fp_mod=jfp,
                     flag_items=[(k, jflags.get_flag(k)) for k in names],
                     pipeline_id=jpasses.pipeline_id("default"))
        assert ours == theirs
        exe = fluid.Executor(CPU)
        base = exe._pcache_base(m.desc, ["x"], [f])
        assert base == fingerprint.combine(
            _fp(m, f, flag_items=[(k, flags.get_flag(k)) for k in names],
                pipeline_id=""),
            fingerprint.environment_fingerprint(),
            "port-plan-v%d" % executor_mod.PCACHE_FORMAT,
            executor_mod.planner_digest(), "cpu")


# ---------------------------------------------------------------------------
# the persistent cache itself
# ---------------------------------------------------------------------------

def _payload(scale=2.0):
    return {"format": 1, "plan": [{"label": "seg", "scale": scale}]}


class TestPersistentCache:
    def test_get_counts_a_hit_only_for_a_checked_entry(self, tmp_path):
        """`get(key, check=)`: an entry the caller's check refuses is
        quarantined under "acquire" and counted as a miss, with no hit,
        load time or saved seconds."""
        cache = pcache.PersistentCache(str(tmp_path))
        cache.put("k" * 64, _payload(), compile_seconds=1.5)

        def refuse(loaded):
            raise ValueError("unusable")

        assert cache.get("k" * 64, check=refuse) is None
        snap = obs_tele.snapshot()
        assert snap["compile_cache_misses_total"] == 1
        assert snap["compile_cache_errors_total{kind=acquire}"] == 1
        assert "compile_cache_hits_total" not in snap
        assert "compile_cache_saved_compile_seconds_total" not in snap
        assert cache.stats()["quarantined"] == 1
        cache.put("k" * 64, _payload(), compile_seconds=1.5)
        seen = []
        assert cache.get("k" * 64, check=seen.append) == _payload()
        assert seen == [_payload()]
        snap = obs_tele.snapshot()
        assert snap["compile_cache_hits_total"] == 1
        assert snap["compile_cache_saved_compile_seconds_total"] == 1.5

    def test_put_get_roundtrip(self, tmp_path):
        cache = pcache.PersistentCache(str(tmp_path))
        kind = cache.put("a" * 64, _payload(), compile_seconds=0.5)
        assert kind == "plan"
        assert cache.get("a" * 64) == _payload()
        snap = obs_tele.snapshot()
        assert snap["compile_cache_hits_total"] == 1
        assert snap["compile_cache_saved_compile_seconds_total"] \
            == pytest.approx(0.5)

    def test_missing_key_is_miss(self, tmp_path):
        cache = pcache.PersistentCache(str(tmp_path))
        assert cache.get("b" * 64) is None
        assert obs_tele.snapshot()["compile_cache_misses_total"] == 1

    def test_corrupt_entry_quarantined_not_raised(self, tmp_path):
        cache = pcache.PersistentCache(str(tmp_path))
        cache.put("c" * 64, _payload())
        path = cache._entry_path("c" * 64)
        blob = bytearray(open(path, "rb").read())
        blob[-10] ^= 0xFF
        open(path, "wb").write(bytes(blob))
        assert cache.get("c" * 64) is None  # a miss, no exception
        assert not os.path.exists(path)
        assert os.path.exists(os.path.join(
            str(tmp_path), "quarantine", os.path.basename(path)))
        snap = obs_tele.snapshot()
        assert snap["compile_cache_errors_total{kind=corrupt}"] == 1

    def test_truncated_entry_quarantined(self, tmp_path):
        cache = pcache.PersistentCache(str(tmp_path))
        cache.put("d" * 64, _payload())
        path = cache._entry_path("d" * 64)
        blob = open(path, "rb").read()
        open(path, "wb").write(blob[:len(blob) // 2])
        assert cache.get("d" * 64) is None
        assert cache.stats()["quarantined"] == 1

    def test_serialize_unsupported_stores_stub(self, tmp_path):
        """A capture cannot be saved: its entry is a stub, which stats
        see and a load reports as a miss."""
        cache = pcache.PersistentCache(str(tmp_path))
        kind = cache.put("e" * 64, None, compile_seconds=1.0,
                         meta={"pool_bytes": 4096})
        assert kind == "stub"
        assert cache.get("e" * 64) is None  # stub loads are misses
        stats = cache.stats()
        assert stats["entries"] == 1 and stats["stubs"] == 1
        assert obs_tele.snapshot()["compile_cache_misses_total"] == 1
        assert "compile_cache_hits_total" not in obs_tele.snapshot()

    def test_lru_eviction_by_size(self, tmp_path):
        cache = pcache.PersistentCache(str(tmp_path), max_bytes=1)
        cache._max_bytes = 10 ** 9  # let both land first
        cache.put("f" * 64, _payload())
        os.utime(cache._entry_path("f" * 64), (1, 1))  # oldest-used
        cache.put("g" * 64, _payload(3.0))
        size_one = os.path.getsize(cache._entry_path("g" * 64))
        cache._max_bytes = size_one  # room for exactly one entry
        assert cache.evict() == 1
        assert not os.path.exists(cache._entry_path("f" * 64))
        assert os.path.exists(cache._entry_path("g" * 64))
        assert obs_tele.snapshot()[
            "compile_cache_evictions_total"] == 1

    def test_gc_clears_quarantine(self, tmp_path):
        cache = pcache.PersistentCache(str(tmp_path))
        cache.put("h" * 64, _payload())
        path = cache._entry_path("h" * 64)
        open(path, "wb").write(b"garbage")
        cache.get("h" * 64)  # quarantines
        assert cache.stats()["quarantined"] == 1
        summary = cache.gc()
        assert summary["quarantine_cleared"] == 1
        assert cache.stats()["quarantined"] == 0

    def test_a_jax_entry_is_left_alone(self, tmp_path):
        """A JAX entry (`.ptx`) under the same root is never read,
        counted, evicted or quarantined by the port."""
        jcache = jpcache.PersistentCache(str(tmp_path))
        jcache.put("j" * 64, object(), compile_seconds=1.0)  # a stub
        jpath = jcache._entry_path("j" * 64)
        jbytes = open(jpath, "rb").read()
        jq = os.path.join(str(tmp_path), "quarantine", "q" * 64 + ".ptx")
        open(jq, "wb").write(b"a JAX quarantined entry")
        cache = pcache.PersistentCache(str(tmp_path))
        assert cache.stats()["entries"] == 0
        assert cache.stats()["quarantined"] == 0
        assert cache.get("j" * 64) is None
        cache.put("k" * 64, _payload())
        assert cache.evict(max_bytes=1) == 1  # the port's own entry
        summary = cache.gc(max_bytes=1)
        assert summary["quarantine_cleared"] == 0
        assert open(jpath, "rb").read() == jbytes
        assert os.path.exists(jq)
        assert jcache.stats()["entries"] == 1
        assert "compile_cache_errors_total{kind=corrupt}" \
            not in obs_tele.snapshot()

    def test_a_pickle_payload_is_never_loaded(self, tmp_path):
        """The payload is JSON: a pickle with a valid CRC is quarantined
        unread, and the code it would run never runs."""
        import zlib

        marker = tmp_path / "ran"
        payload = pickle.dumps(_Boom(str(marker)))
        cache = pcache.PersistentCache(str(tmp_path))
        cache.put("p" * 64, _payload())
        path = cache._entry_path("p" * 64)
        header = ('{"compile_seconds": 0.0, "crc": %d, "key": "%s", '
                  '"kind": "plan", "meta": {}, "payload_len": %d}'
                  % (zlib.crc32(payload), "p" * 64, len(payload)))
        open(path, "wb").write(pcache._MAGIC + header.encode() + b"\n"
                               + payload)
        assert cache.get("p" * 64) is None
        assert not marker.exists()
        assert cache.stats()["quarantined"] == 1
        assert obs_tele.snapshot()[
            "compile_cache_errors_total{kind=deserialize}"] == 1
        src = open(pcache.__file__).read()
        assert "import pickle" not in src


class _Boom:
    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return (open, (self.path, "w"))


# ---------------------------------------------------------------------------
# executor wiring
# ---------------------------------------------------------------------------

def _build_scale_program(scale=2.0):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.scale(x=x, scale=scale)
        z = fluid.layers.scale(x=y, scale=3.0)
    return main, startup, z.name


def _run(main, startup, fetch, x, runs=1):
    exe = fluid.Executor(CPU)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    out = None
    for _ in range(runs):
        out = exe.run(main, feed={"x": x}, fetch_list=[fetch],
                      scope=scope)[0]
    return np.asarray(out), exe


def _train(steps=3):
    """(losses, final parameters, executor) of the Adam toy, fresh
    programs, executor and scope, seeded alike."""
    from paddle_tpu_torch.fluid import framework

    framework.reset_unique_name()
    main, startup, cost = _build_adam_toy()
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    torch.manual_seed(0)
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(0)
    losses = [exe.run(main, feed={"x": rs.randn(4, 64).astype(np.float32)},
                      fetch_list=[cost], scope=scope)[0]
              for _ in range(steps)]
    params = {n: scope.get(n).clone() for n, v in
              main.desc.block(0).vars.items()
              if v.persistable and isinstance(scope.get(n), torch.Tensor)}
    return losses, params, exe


class TestExecutorPCache:
    def test_restart_reload_zero_compiles(self, tmp_path, monkeypatch):
        """A simulated restart: every plan a hit, zero pipeline runs, no
        donation analysis, the verifier not rerun; its captures are
        counted apart; the outputs equal the cold run's bits."""
        flags.set_flag("compile_cache_dir", str(tmp_path))
        flags.set_flag("compile_passes", "default")
        flags.set_flag("verify_program", True)
        x = np.arange(8, dtype=np.float32).reshape(2, 4)
        cold, exe = _run(*_build_scale_program(), x, runs=3)
        # the startup and main programs each ran the pipeline once
        assert exe.pipeline_runs == 2 and exe.captures == 1
        stats = pcache.get_cache().stats()
        assert stats["entries"] == 3 and stats["stubs"] == 1, stats
        pcache.reset()
        calls = []
        for mod, name in ((tanalysis, "analyze_donation"),
                          (tanalysis, "check_program")):
            real = getattr(mod, name)
            monkeypatch.setattr(
                mod, name, lambda *a, _r=real, _n=name, **k:
                (calls.append(_n), _r(*a, **k))[1])
        hits0 = _snap("compile_cache_hits_total")
        warm, exe = _run(*_build_scale_program(), x, runs=3)
        assert exe.pipeline_runs == 0 and not calls, calls
        assert all(c.acquired == "hit" for _d, _v, c in
                   exe._cache.values())
        assert exe.captures == 1  # captured again, counted apart
        np.testing.assert_array_equal(cold, warm)
        assert _snap("compile_cache_hits_total") == hits0 + 2
        assert _snap("compile_cache_saved_compile_seconds_total") > 0
        assert pcache.get_cache().stats()["entries"] == 3

    def test_different_shapes_get_distinct_entries(self, tmp_path):
        """One plan for the program (a plan does not depend on shapes),
        one capture stub per signature."""
        flags.set_flag("compile_cache_dir", str(tmp_path))
        main, startup, fetch = _build_scale_program()
        exe = fluid.Executor(CPU)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        for n in (2, 5):
            for _ in range(2):
                exe.run(main, feed={"x": np.zeros((n, 4), np.float32)},
                        fetch_list=[fetch], scope=scope)
        stats = pcache.get_cache().stats()
        assert stats["stubs"] == 2 and stats["entries"] == 4, stats

    def test_attr_change_misses(self, tmp_path):
        flags.set_flag("compile_cache_dir", str(tmp_path))
        x = np.arange(8, dtype=np.float32).reshape(2, 4)
        _run(*_build_scale_program(2.0), x)
        hits0 = _snap("compile_cache_hits_total")
        out, _ = _run(*_build_scale_program(5.0), x)
        np.testing.assert_array_equal(out, x * 15.0)
        # the startup programs are alike and hit; the main programs differ
        assert _snap("compile_cache_hits_total") == hits0 + 1
        assert pcache.get_cache().stats()["entries"] == 3

    def test_disabled_flag_means_no_disk_io(self, tmp_path):
        x = np.arange(8, dtype=np.float32).reshape(2, 4)
        _run(*_build_scale_program(), x, runs=3)
        assert "compile_cache_hits_total" not in obs_tele.snapshot()
        assert "compile_cache_misses_total" not in obs_tele.snapshot()
        assert os.listdir(str(tmp_path)) == []

    def test_corrupt_entry_recompiles_and_requarantines(self, tmp_path):
        flags.set_flag("compile_cache_dir", str(tmp_path))
        x = np.arange(8, dtype=np.float32).reshape(2, 4)
        main, startup, fetch = _build_scale_program()
        cold, exe = _run(main, startup, fetch, x)
        cache = pcache.get_cache()
        key = list(exe._cache.values())[-1][2].pcache_key
        open(cache._entry_path(key), "wb").write(b"PTPP1\nnot json\n")
        pcache.reset()
        out, exe = _run(*_build_scale_program(), x)
        np.testing.assert_array_equal(cold, out)
        stats = pcache.get_cache().stats()
        assert stats["quarantined"] == 1
        # the plan made anew was stored again
        assert stats["entries"] == 2
        assert list(exe._cache.values())[-1][2].acquired == "miss"

    def test_entry_failing_the_structural_check_is_quarantined(
            self, tmp_path):
        """A parsed entry whose plan names other ops than its desc is
        quarantined and counted under "acquire"; the run plans anew and
        still gives the cold run's bits."""
        import json

        flags.set_flag("compile_cache_dir", str(tmp_path))
        x = np.arange(8, dtype=np.float32).reshape(2, 4)
        main, startup, fetch = _build_scale_program()
        cold, exe = _run(main, startup, fetch, x)
        cache = pcache.get_cache()
        key = list(exe._cache.values())[-1][2].pcache_key
        entry = cache.get(key)
        entry["plan"][0]["types"][0] = "mul"
        cache.put(key, entry)
        pcache.reset()
        hits0 = _snap("compile_cache_hits_total")
        misses0 = _snap("compile_cache_misses_total")
        out, exe = _run(*_build_scale_program(), x)
        np.testing.assert_array_equal(cold, out)
        assert _snap("compile_cache_errors_total{kind=acquire}") == 1
        # the startup program's intact entry is the one hit; the
        # unusable entry counts as a miss and not as a hit
        assert _snap("compile_cache_hits_total") == hits0 + 1
        assert _snap("compile_cache_misses_total") == misses0 + 1
        assert pcache.get_cache().stats()["quarantined"] == 1
        assert list(exe._cache.values())[-1][2].acquired == "miss"
        restored = pcache.get_cache().get(key)
        assert json.dumps(restored["plan"][0]["types"]) == '["scale", ' \
            '"scale"]'

    def test_an_older_entry_format_misses(self, tmp_path, monkeypatch):
        flags.set_flag("compile_cache_dir", str(tmp_path))
        x = np.arange(8, dtype=np.float32).reshape(2, 4)
        _run(*_build_scale_program(), x)
        before = pcache.get_cache().stats()["entries"]
        monkeypatch.setattr(executor_mod, "PCACHE_FORMAT",
                            executor_mod.PCACHE_FORMAT + 1)
        pcache.reset()
        hits0 = _snap("compile_cache_hits_total")
        _run(*_build_scale_program(), x)
        assert _snap("compile_cache_hits_total") == hits0
        assert pcache.get_cache().stats()["entries"] == before + 2

    def test_a_changed_planner_misses(self, tmp_path, monkeypatch):
        """The planning code's digest is in the key: an entry the
        planner before a fix wrote is a miss, not a reloaded plan."""
        flags.set_flag("compile_cache_dir", str(tmp_path))
        x = np.arange(8, dtype=np.float32).reshape(2, 4)
        _run(*_build_scale_program(), x)
        before = pcache.get_cache().stats()["entries"]
        digest = executor_mod.planner_digest()
        assert len(digest) == 64 and digest == executor_mod.planner_digest()
        monkeypatch.setattr(executor_mod, "_planner_digest", "0" * 64)
        pcache.reset()
        hits0 = _snap("compile_cache_hits_total")
        out, exe = _run(*_build_scale_program(), x)
        assert _snap("compile_cache_hits_total") == hits0
        assert list(exe._cache.values())[-1][2].acquired == "miss"
        assert pcache.get_cache().stats()["entries"] == before + 2
        np.testing.assert_array_equal(out, x * 6.0)

    def test_cold_and_warm_training_give_the_same_bits(self, tmp_path):
        flags.set_flag("compile_passes", "default")
        plain, pparams, _ = _train()
        flags.set_flag("compile_cache_dir", str(tmp_path))
        cold, cparams, exe = _train()
        assert exe.pipeline_runs > 0
        pcache.reset()
        warm, wparams, wexe = _train()
        assert wexe.pipeline_runs == 0
        assert wexe.captures == exe.captures
        for a, b, c in zip(plain, cold, warm):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, c)
        for n in cparams:
            assert torch.equal(cparams[n], wparams[n]), n
            assert torch.equal(pparams[n], cparams[n]), n

    def test_use_program_cache_false_bypasses_both_caches(self, tmp_path):
        flags.set_flag("compile_cache_dir", str(tmp_path))
        flags.set_flag("compile_passes", "default")
        main, startup, fetch = _build_scale_program()
        exe = fluid.Executor(CPU)
        scope = fluid.Scope()
        exe.run(startup, scope=scope, use_program_cache=False)
        x = np.ones((2, 4), np.float32)
        outs = [exe.run(main, feed={"x": x}, fetch_list=[fetch],
                        scope=scope, use_program_cache=False)[0]
                for _ in range(3)]
        assert not exe._cache and not exe._optimized
        assert exe.pipeline_runs == 4 and exe.captures == 0
        assert pcache.get_cache().stats()["entries"] == 0
        assert "compile_cache_misses_total" not in obs_tele.snapshot()
        for o in outs:
            np.testing.assert_array_equal(o, x * 6.0)


class TestProgramCacheEvictionMetric:
    def test_eviction_counted_and_logged(self, monkeypatch, caplog):
        import logging

        monkeypatch.setattr(executor_mod.Executor, "_CACHE_MAX", 1)
        exe = fluid.Executor(CPU)
        x = np.arange(8, dtype=np.float32).reshape(2, 4)
        scope = fluid.Scope()
        evict0 = _snap("executor_program_cache_evictions_total")
        with caplog.at_level(logging.DEBUG,
                             logger="paddle_tpu_torch.executor"):
            for scale in (2.0, 3.0):
                main, startup, fetch = _build_scale_program(scale)
                exe.run(startup, scope=scope)
                exe.run(main, feed={"x": x}, fetch_list=[fetch],
                        scope=scope)
        assert _snap("executor_program_cache_evictions_total") > evict0
        assert any("evicted program cache entry" in r.message
                   for r in caplog.records)


# ---------------------------------------------------------------------------
# the operator CLI (tools/pcache_cli.py)
# ---------------------------------------------------------------------------

def test_pcache_cli_selftest_on_the_cpu(capsys):
    from paddle_tpu_torch.tools import pcache_cli

    assert pcache_cli.main(["--selftest", "--use_gpu=0"]) == 0
    out = capsys.readouterr().out
    for leg in ("cache leg green", "passes leg green",
                "opt-passes leg green", "selftest green"):
        assert "[pcache] " + leg in out, out


def test_pcache_cli_prewarm_stats_gc(tmp_path, capsys):
    """prewarm plans a saved inference model through the serving
    warmup (every bucket), stats counts the entries and their capture
    stubs, gc enforces the cap; a second prewarm loads every plan."""
    import json

    from paddle_tpu_torch.fluid import io as tio
    from paddle_tpu_torch.tools import pcache_cli

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[8], dtype="float32")
        probs = fluid.layers.fc(input=img, size=3, act="softmax")
    scope = fluid.Scope()
    fluid.Executor(CPU).run(startup, scope=scope)
    model = str(tmp_path / "model")
    tio.save_inference_model(model, ["img"], [probs], scope, main,
                             bucket_hints={"batch_buckets": [2, 4]})
    cache = str(tmp_path / "pcache")
    argv = ["prewarm", "--cache-dir", cache, "--model-dir", model,
            "--use_gpu=0"]
    assert pcache_cli.main(argv) == 0
    assert "prewarmed 2 bucket(s)" in capsys.readouterr().out
    assert pcache_cli.main(["stats", "--cache-dir", cache, "--json"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["entries"] == 3 and stats["stubs"] == 2, stats
    pcache.reset()
    assert pcache_cli.main(argv) == 0
    assert "(0 plan(s) made, 1 loaded, 2 capture(s))" \
        in capsys.readouterr().out
    assert pcache_cli.main(["gc", "--cache-dir", cache, "--max-bytes",
                            "1"]) == 0
    assert "evicted 3" in capsys.readouterr().out
    flags.set_flag("compile_cache_dir", "")  # prewarm set it
    with pytest.raises(SystemExit, match="no cache dir"):
        pcache_cli.main(["stats"])
