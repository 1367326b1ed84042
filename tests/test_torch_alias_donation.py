"""The port's donation-safety analysis (`analysis/alias.py`, the A0xx
codes) and its executor wiring behind FLAGS_donation, against the JAX
package's on the same programs (tests/test_alias_donation.py, case by
case, its persistent-cache case among them).

Each program is built by both packages' own layers in fresh Program
pairs, so the var names agree.  The plans (each segment's conservative,
widened and declined sets, every in-place entry's status and code, the
effective mode and the fingerprint) and the report's codes equal the JAX
package's; the JAX package's memory audit (`obs.mem.audit_donation`) is
held against the port's `obs.mem.audit_donation`, which prices the
port's plan.  Donation preserves values: the
three modes train to the same bits on the CPU, where the port's
executor runs its segments' plain version with the same donation.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import analysis as janalysis
from paddle_tpu.compile import pcache as jpcache
from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.obs import mem as jmem
from paddle_tpu.tools.lint_cli import _build_two_segment as j_two_segment
from paddle_tpu.tools.mem_cli import _build_adam_toy as j_adam_toy
from paddle_tpu.tools.mem_cli import _fork_adam_slot as j_fork
from paddle_tpu.utils import flags as jflags
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import analysis as tanalysis
from paddle_tpu_torch.core.desc import OpDesc
from paddle_tpu_torch.obs import mem as tmem
from paddle_tpu_torch.tools.lint_cli import (_build_adam_toy,
                                             _build_two_segment,
                                             _fork_adam_slot)
from paddle_tpu_torch.utils import flags

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_donation_flags():
    old, jold = flags.get_flag("donation"), jflags.get_flag("donation")
    yield
    flags.set_flag("donation", old)
    jflags.set_flag("donation", jold)


def _feeds(rs, n=4, d=64):
    return {"x": rs.randn(n, d).astype(np.float32)}


def _train(main, startup, cost, steps=4, d=64, init=None):
    """(per-step losses, final parameters, executor) of a fresh port
    Executor and Scope on the CPU, from `init` ({name: array}) when
    given."""
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    if init is not None:
        tfluid.io.params_from_numpy(scope, init, "cpu")
    rs = np.random.RandomState(0)
    losses = [exe.run(main, feed=_feeds(rs, d=d), fetch_list=[cost],
                      scope=scope)[0].copy() for _ in range(steps)]
    params = {n: scope.get(n).clone() for n in main.global_block().vars
              if isinstance(scope.get(n), torch.Tensor)}
    return losses, params, exe


def _jtrain(main, startup, cost, steps=4, d=64):
    from paddle_tpu.core.scope import Scope as JScope

    scope = JScope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup, scope=scope)
        init = {n: np.array(scope.get(n)) for n, v in
                main.desc.block(0).vars.items()
                if v.persistable and scope.get(n) is not None}
        rs = np.random.RandomState(0)
        return [np.asarray(exe.run(main, feed=_feeds(rs, d=d),
                                   fetch_list=[cost], scope=scope)[0])
                for _ in range(steps)], init


def _same_plan(got, want):
    """The two plans' decisions are equal: segments, entries, modes,
    fingerprint and report codes."""
    assert got.mode == want.mode
    assert got.effective_mode == want.effective_mode
    assert got.fingerprint() == want.fingerprint()
    assert len(got.segments) == len(want.segments)
    for g, w in zip(got.segments, want.segments):
        for key in ("index", "jit", "start", "end", "conservative",
                    "widened"):
            assert g[key] == w[key], key
        assert [(d["name"], d["code"]) for d in g["declined"]] == \
            [(d["name"], d["code"]) for d in w["declined"]]
    strip = ("name", "op_index", "op_type", "slot", "segment", "status",
             "code")
    assert [{k: e[k] for k in strip} for e in got.entries] == \
        [{k: e[k] for k in strip} for e in want.entries]
    assert sorted(got.report.codes()) == sorted(want.report.codes())


def _audit(program, fetches=(), mode=None):
    """The port's `obs.mem.audit_donation`, which prices the port's
    plan: each donated and reclaimable in-place buffer with its full
    size from its VarDesc, the bytes summed."""
    return tmem.audit_donation(program, fetches=fetches, mode=mode)


def _same_audit(got, want):
    assert got["effective_mode"] == want["effective_mode"]
    assert got["donated_bytes"] == want["donated_bytes"]
    assert got["reclaimable_bytes"] == want["reclaimable_bytes"]
    assert [(r["name"], r.get("code")) for r in got["reclaimable"]] == \
        [(r["name"], r.get("code")) for r in want["reclaimable"]]


# -- the plan -----------------------------------------------------------------

def test_mode_ladder_and_fingerprints():
    main, _startup, cost = _build_adam_toy()
    jmain, _jstartup, jcost = j_adam_toy()
    plans = {m: tanalysis.analyze_donation(main, fetches=[cost.name],
                                           mode=m)
             for m in ("off", "conservative", "auto")}
    auto = plans["auto"]
    assert not auto.report.errors
    nseg = len(auto.segments)
    assert any(auto.donate(i) for i in range(nseg))
    for i in range(nseg):
        assert plans["off"].donate(i) == ()
        assert set(plans["conservative"].donate(i)) <= set(auto.donate(i))
    fps = {m: p.fingerprint() for m, p in plans.items()}
    assert len(set(fps.values())) == 3, fps
    for m, plan in plans.items():
        _same_plan(plan, janalysis.analyze_donation(
            jmain, fetches=[jcost.name], mode=m))


def test_feed_is_never_widened():
    main, _startup, cost = _build_adam_toy()
    plan = tanalysis.analyze_donation(main, fetches=[cost.name],
                                      mode="auto")
    for i in range(len(plan.segments)):
        assert "x" not in plan.donate(i)
    plan2 = tanalysis.analyze_donation(main, fetches=[cost.name],
                                       feeds=["x"], mode="auto")
    assert plan2.fingerprint() == plan.fingerprint()
    jmain, _jstartup, jcost = j_adam_toy()
    _same_plan(plan2, janalysis.analyze_donation(
        jmain, fetches=[jcost.name], feeds=["x"], mode="auto"))


def test_donation_mode_parsing():
    from paddle_tpu_torch.analysis.alias import state_donation

    assert tanalysis.donation_mode("off") == "off"
    assert tanalysis.donation_mode("bogus") == "auto"
    assert tanalysis.donation_mode(" Conservative ") == "conservative"
    flags.set_flag("donation", "off")
    assert state_donation() is False
    flags.set_flag("donation", "auto")
    assert state_donation() is True
    assert tanalysis.donation_mode() == "auto"


# -- the A-codes --------------------------------------------------------------

def test_a001_forked_slot_and_audit_delta():
    main, _startup, cost = _build_adam_toy()
    forked = _fork_adam_slot(main)
    jmain, _jstartup, jcost = j_adam_toy()
    assert j_fork(jmain) == forked
    plan = tanalysis.analyze_donation(main, fetches=[cost.name],
                                      mode="auto")
    assert "A001" in plan.report.codes()
    _same_plan(plan, janalysis.analyze_donation(
        jmain, fetches=[jcost.name], mode="auto"))
    broken = _audit(main, fetches=[cost.name], mode="auto")
    _same_audit(broken, jmem.audit_donation(jmain, fetches=[jcost.name],
                                            mode="auto"))
    hits = [r for r in broken["reclaimable"] if r["name"] == forked]
    assert hits and hits[0]["code"] == "A001"
    assert broken["reclaimable_bytes"] > 0
    off = _audit(main, fetches=[cost.name], mode="off")
    _same_audit(off, jmem.audit_donation(jmain, fetches=[jcost.name],
                                         mode="off"))
    assert not off["donated"]
    assert off["reclaimable_bytes"] == (broken["reclaimable_bytes"]
                                        + broken["donated_bytes"])


def test_a002_read_after_donation_via_stale_plan():
    main, _startup, hname, lname = _build_two_segment()
    jmain, _jstartup, jh, jl = j_two_segment()
    assert (jh, jl) == (hname, lname)
    plan = tanalysis.analyze_donation(main, fetches=[lname], mode="auto")
    jplan = janalysis.analyze_donation(jmain, fetches=[lname], mode="auto")
    _same_plan(plan, jplan)
    assert any(hname in plan.widened(i) for i in range(len(plan.segments)))
    main.desc.block(0).ops.append(
        OpDesc("scale", {"X": [hname]}, {"Out": ["__late__"]},
               {"scale": 2.0}))
    jmain.desc.block(0).ops.append(
        JOpDesc("scale", {"X": [hname]}, {"Out": ["__late__"]},
                {"scale": 2.0}))
    rep = plan.verify(main, fetches=[lname, "__late__"])
    assert "A002" in rep.codes() and rep.errors
    assert rep.codes() == jplan.verify(jmain,
                                       fetches=[lname, "__late__"]).codes()


def test_a003_fetch_declines_widening():
    main, _startup, hname, lname = _build_two_segment()
    jmain, _jstartup, _jh, _jl = j_two_segment()
    plan = tanalysis.analyze_donation(main, fetches=[lname, hname],
                                      mode="auto")
    assert "A003" in plan.report.codes()
    assert not any(hname in plan.widened(i)
                   for i in range(len(plan.segments)))
    _same_plan(plan, janalysis.analyze_donation(
        jmain, fetches=[lname, hname], mode="auto"))


def test_a004_update_in_a_host_segment():
    main, _startup, cost = _build_adam_toy()
    jmain, _jstartup, jcost = j_adam_toy()
    for prog, desc_cls in ((main, OpDesc), (jmain, JOpDesc)):
        bd = prog.desc.block(0)
        pname = next(n for n, vd in bd.vars.items() if vd.is_parameter)
        bd.ops.append(desc_cls("dist_send",
                               {"Param": [pname], "Grad": [pname]},
                               {"ParamOut": [pname]},
                               {"param_name": pname, "blocks": []}))
    plan = tanalysis.analyze_donation(main, fetches=[cost.name])
    assert "A004" in plan.report.codes()
    _same_plan(plan, janalysis.analyze_donation(jmain,
                                                fetches=[jcost.name]))


def test_a005_unsafe_backend_degrades():
    main, _startup, cost = _build_adam_toy()
    jmain, _jstartup, jcost = j_adam_toy()
    plan = tanalysis.analyze_donation(main, fetches=[cost.name],
                                      mode="auto", backend_safe=False)
    assert plan.effective_mode == "conservative"
    assert "A005" in plan.report.codes()
    assert not plan.report.errors
    _same_plan(plan, janalysis.analyze_donation(
        jmain, fetches=[jcost.name], mode="auto", backend_safe=False))


# -- executor wiring ----------------------------------------------------------

def _compiled(exe):
    return list(exe._cache.values())[-1][2]


def test_executor_applies_widened_plan():
    flags.set_flag("donation", "auto")
    main, startup, hname, lname = _build_two_segment()
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    out = [exe.run(main, feed={"x": np.ones((4, 16), np.float32)},
                   fetch_list=[lname], scope=scope)[0] for _ in range(3)]
    cp = _compiled(exe)
    assert cp._donation["mode"] == "auto"
    donated = [seg["donate"] for seg in cp._plan]
    assert any(hname in d for d in donated), donated
    # the widened intermediate is given up once its segment read it
    assert all(np.array_equal(o, out[0]) for o in out)
    assert exe.captures == 2 and exe.replays == 2


def test_auto_degrades_on_unsafe_backend_bit_identical(monkeypatch):
    """Where the backend is unsafe, auto quietly becomes conservative and
    numerics match off exactly."""
    real = tanalysis.analyze_donation
    monkeypatch.setattr(tanalysis, "analyze_donation",
                        lambda *a, **k: real(*a, **dict(k,
                                                        backend_safe=False)))
    runs = {}
    for mode in ("off", "auto"):
        flags.set_flag("donation", mode)
        main, startup, cost = _build_adam_toy()
        runs[mode] = _train(main, startup, cost)
    cp = _compiled(runs["auto"][2])
    assert cp._donation["mode"] == "conservative"
    for a, b in zip(runs["off"][0], runs["auto"][0]):
        np.testing.assert_array_equal(a, b)
    for n, v in runs["off"][1].items():
        assert torch.equal(v, runs["auto"][1][n]), n


def test_modes_bit_identical_f32(monkeypatch):
    """Donation never changes a value: the three modes train to the same
    bits, and to the JAX package's losses."""
    monkeypatch.setattr(jpcache, "donation_aliasing_safe",
                        lambda backend=None: True)
    jflags.set_flag("donation", "auto")
    jmain, jstartup, jcost = j_adam_toy()
    want, init = _jtrain(jmain, jstartup, jcost)
    runs = {}
    for mode in ("off", "conservative", "auto"):
        flags.set_flag("donation", mode)
        main, startup, cost = _build_adam_toy()
        runs[mode] = _train(main, startup, cost, init=init)
    ref_losses, ref_params, _ = runs["off"]
    for mode in ("conservative", "auto"):
        losses, params, exe = runs[mode]
        assert exe.captures == 1 and exe.replays == 2
        for a, b in zip(ref_losses, losses):
            np.testing.assert_array_equal(a, b)
        for n, v in ref_params.items():
            assert torch.equal(v, params[n]), n
    np.testing.assert_allclose(np.concatenate(ref_losses),
                               np.concatenate(want), rtol=1e-5, atol=1e-6)


def test_donation_under_amp_bf16():
    """Under amp_bf16 the state's dtypes reach their fixed point in two
    steps (f32 -> bf16 -> f32 masters); the donation plan rides the new
    signatures: after the fixed point no segment captures again, and auto
    matches off bit for bit."""
    runs = {}
    for mode in ("off", "auto"):
        flags.set_flag("donation", mode)
        with tfluid.amp.bf16_guard():
            main, startup, cost = _build_adam_toy()
            runs[mode] = _train(main, startup, cost, steps=5)
    for a, b in zip(runs["off"][0], runs["auto"][0]):
        np.testing.assert_array_equal(a, b)
    _losses, _params, exe = runs["auto"]
    cp = _compiled(exe)
    assert cp._donation["mode"] == "auto"
    per_segment = {}
    for key in cp._records:
        per_segment[key[0]] = per_segment.get(key[0], 0) + 1
    assert per_segment and all(n <= 3 for n in per_segment.values()), \
        per_segment


# -- audit --------------------------------------------------------------------

def test_audit_clean_toy_zero_reclaimable_under_auto():
    main, _startup, cost = _build_adam_toy()
    jmain, _jstartup, jcost = j_adam_toy()
    audit = _audit(main, fetches=[cost.name], mode="auto")
    _same_audit(audit, jmem.audit_donation(jmain, fetches=[jcost.name],
                                           mode="auto"))
    assert audit["effective_mode"] == "auto"
    assert audit["reclaimable_bytes"] == 0, audit["reclaimable"]
    assert audit["donated_bytes"] > 0
    off = _audit(main, fetches=[cost.name], mode="off")
    _same_audit(off, jmem.audit_donation(jmain, fetches=[jcost.name],
                                         mode="off"))
    assert off["reclaimable_bytes"] > 0
    for r in off["reclaimable"]:
        assert r["reason"]


# -- compile-cache key separation -------------------------------------------

def _build_two_segment_infer():
    """fc -> print -> mean with no optimizer (tests/test_alias_donation.py
    `_build_two_segment_infer`): zero in-place ops, two captured
    segments around a host one."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[16], dtype="float32")
        h = tfluid.layers.fc(input=x, size=8)
        loss = tfluid.layers.mean(x=h)
    bd = main.desc.block(0)
    i = next(i for i, od in enumerate(bd.ops) if od.type == "mean")
    bd.ops.insert(i, OpDesc("print", {"X": [h.name]}, {"Out": [h.name]},
                            {"message": "seg", "summarize": 1}))
    return main, startup, loss.name


def test_pcache_keys_separate_modes(tmp_path):
    """FLAGS_donation folds into the persistent-cache keys: each mode
    fills its own entries cold and reloads its own warm, adding 0
    entries (a capture's stub, rewritten warm, keeps its key), never
    another mode's; the three modes' program keys differ."""
    from paddle_tpu_torch.compile import pcache as tpcache
    from paddle_tpu_torch.obs import telemetry as tele

    flags.set_flag("compile_cache_dir", str(tmp_path))
    tpcache.reset()
    x = np.zeros((4, 16), np.float32)
    keys = {}
    try:
        def run_once(mode):
            flags.set_flag("donation", mode)
            main, startup, lname = _build_two_segment_infer()
            scope = tfluid.Scope()
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup, scope=scope)
            outs = [exe.run(main, feed={"x": x}, fetch_list=[lname],
                            scope=scope)[0] for _ in range(3)]
            cp = _compiled(exe)
            keys.setdefault(mode, set()).add(cp.pcache_key)
            return outs, exe

        entries = {}
        for mode in ("off", "conservative", "auto"):
            before = tpcache.get_cache().stats()["entries"]
            _outs, exe = run_once(mode)
            entries[mode] = tpcache.get_cache().stats()["entries"]
            assert entries[mode] > before, \
                "mode %r reused another mode's entries" % mode
            assert exe.captures == 2
        for mode in ("off", "conservative", "auto"):
            tpcache.reset()
            before = tpcache.get_cache().stats()["entries"]
            hits0 = tele.snapshot().get("compile_cache_hits_total", 0)
            _outs, exe = run_once(mode)
            assert tpcache.get_cache().stats()["entries"] == before
            assert tele.snapshot().get("compile_cache_hits_total", 0) \
                > hits0
            assert exe.pipeline_runs == 0
        assert all(len(k) == 1 for k in keys.values()), keys
        assert len({k for ks in keys.values() for k in ks}) == 3
    finally:
        flags.set_flag("compile_cache_dir", "")
        tpcache.reset()
