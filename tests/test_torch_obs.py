"""The observability and numerics-health slice of the port against the
JAX package, on the CPU.

- `isfinite` and `count_nonfinite` in f32, bf16 and f16, dense and
  ragged, with NaN and Inf planted at seeded places: exactly the JAX
  kernels' outputs.
- `FLAGS_check_nan_inf`: the port's `NonfiniteError` carries the JAX
  eager scan's op type, block index, slot, var and count.
- `NumericsMonitor` on the transformer (batch 2, seq 16, vocab 32, 2
  layers, 2 heads, d_model 16, Adam at lr 1e-3): the same appended ops
  and vars (descs equal through `to_dict()`), and over 3 Adam steps from
  one state the same summaries: counts exactly, max-abs and the grad
  global norm at rtol 1e-5 (f32 on both sides, sums in other orders
  through 2 layers and 3 updates); a fourth step with an Inf planted in
  a weight is found by both, and both loss scalers halve.
- `LossScaler`: the same trajectory over a seeded run of verdicts.
- `locate_nonfinite`: the JAX package's answer, and the caller's scope
  (every tensor, and the random stream's state) bit for bit as it was,
  after a finite replay of a whole step (a sparse embedding, dropout
  and SGD) and after a nonfinite one.
- `obs.context`, `obs.tail` and `obs.flight`: the same traceparent
  parse, tail classification and bundle keys as the JAX modules; the
  JAX package's `obs_dump` validators accept the port's bundles;
  `describe_feeds` reads no value (meta tensors have none).
- The v2 `SGD` under `health.enable()`: it installs the monitor by
  itself, whose summary equals the JAX trainer's; a failing step leaves
  a flight bundle.
- Every unary activation at NaN, +-Inf and signed zeros, value and grad,
  against the JAX kernel (the relu and clip repairs).
"""

import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.fluid as jfluid
import paddle_tpu.v2 as jv2
from paddle_tpu.core.ragged import RaggedTensor as JRagged
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.fluid.amp import LossScaler as JLossScaler
from paddle_tpu.fluid.executor import NonfiniteError as JNonfiniteError
from paddle_tpu.models.transformer_program import (
    build_transformer_program as j_build, transformer_program_feeds)
from paddle_tpu.obs import context as j_context
from paddle_tpu.obs import flight as j_flight
from paddle_tpu.obs import health as j_health
from paddle_tpu.obs import tail as j_tail
from paddle_tpu.ops.registry import get_op_info as j_op
from paddle_tpu.tools import obs_dump
from paddle_tpu.utils import flags as j_flags

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.v2 as tv2
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.core.ragged import RaggedTensor
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid.amp import LossScaler
from paddle_tpu_torch.fluid.executor import NonfiniteError
from paddle_tpu_torch.models.transformer_program import (
    build_transformer_program)
from paddle_tpu_torch.obs import context as t_context
from paddle_tpu_torch.obs import flight as t_flight
from paddle_tpu_torch.obs import health as t_health
from paddle_tpu_torch.obs import registry as t_registry
from paddle_tpu_torch.obs import tail as t_tail
from paddle_tpu_torch.obs import trace as t_trace
from paddle_tpu_torch.ops.registry import get_op_info as t_op
from paddle_tpu_torch.utils import flags as t_flags
from paddle_tpu_torch.v2 import config as tconfig

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

B, T, V, N_LAYER, N_HEAD, D = 2, 16, 32, 2, 2, 16
STEPS = 3
RTOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_port_obs():
    """The port's process-global observability state (its registry,
    tracer, flight recorder, health switch and nan flag) reset around
    every test, as the conftest does for the JAX package's."""
    t_registry.reset_registry()
    t_trace.disable()
    t_trace.reset()
    yield
    t_health.disable()
    t_flight.uninstall()
    t_flags.set_flag("check_nan_inf", False)


# -- the ops ------------------------------------------------------------------

def _planted(shape, dtype, seed):
    """Seeded values with NaN, +Inf and -Inf at seeded places."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    flat = x.reshape(-1)
    idx = rs.choice(flat.size, size=min(5, flat.size), replace=False)
    flat[idx[:2]] = np.nan
    flat[idx[2:4]] = np.inf
    flat[idx[4:]] = -np.inf
    return x


def _cast_pair(x, dtype):
    """(the JAX operand, the port operand) of float32 `x` as `dtype`."""
    import jax.numpy as jnp

    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
           "float16": jnp.float16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("seed,shape", [(0, (7, 5)), (1, (3, 4, 6)),
                                        (2, (1,))])
@pytest.mark.parametrize("op", ["isfinite", "count_nonfinite"])
def test_finiteness_ops_match_jax(op, seed, shape, dtype):
    for x in (_planted(shape, dtype, seed),
              np.random.RandomState(seed).randn(*shape).astype(np.float32)):
        jx, tx = _cast_pair(x, dtype)
        want = np.asarray(j_op(op).kernel(None, {"X": [jx]}, {})["Out"][0])
        got = t_op(op).kernel(None, {"X": [tx]}, {})["Out"][0]
        assert tuple(got.shape) == want.shape == (1,)
        assert str(got.dtype).replace("torch.", "") == (
            "bool" if op == "isfinite" else "int32") == want.dtype.name
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", ["isfinite", "count_nonfinite"])
def test_finiteness_ops_read_ragged_values(op):
    x = _planted((9, 3), "float32", 3)
    seqs = [x[0:2], x[2:2], x[2:9]]
    want = np.asarray(j_op(op).kernel(
        None, {"X": [JRagged.from_sequences(seqs, bucket=16)]},
        {})["Out"][0])
    rt = RaggedTensor.from_sequences(seqs, bucket=16)
    got = t_op(op).kernel(None, {"X": [rt]}, {})["Out"][0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert t_op(op).stop_gradient_op


# -- the eager scan -----------------------------------------------------------

def _mlp(fluid, sparse=False, dropout=False):
    """ids -> embedding -> fc -> (dropout) -> fc -> mean, SGD; or x -> fc
    -> fc -> mean.  Returns (main, startup, cost, params_grads)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        if sparse:
            ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
            x = fluid.layers.embedding(ids, size=[20, 4], is_sparse=True)
        else:
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        h = fluid.layers.fc(input=x, size=6, act="relu")
        if dropout:
            h = fluid.layers.dropout(h, dropout_prob=0.5)
        cost = fluid.layers.mean(x=fluid.layers.fc(input=h, size=3))
        _, pg = fluid.optimizer.SGDOptimizer(learning_rate=0.1) \
            .minimize(cost)
    return main, startup, cost, pg


def _mlp_state(main, startup):
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
    return {n: np.array(scope.get(n)) for n, v in
            main.desc.block(0).vars.items()
            if v.persistable and scope.get(n) is not None}


def _scans(feed, plant):
    """(JAX NonfiniteError, port NonfiniteError) of one step of the MLP
    from one state, with `plant(state)` applied."""
    jmain, jstartup, jcost, _ = _mlp(jfluid)
    tmain, _, tcost, _ = _mlp(tfluid)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    state = _mlp_state(jmain, jstartup)
    plant(state)
    jscope = JScope()
    for n, v in state.items():
        jscope.set_local(n, v)
    j_flags.set_flag("check_nan_inf", True)
    try:
        with pytest.raises(JNonfiniteError) as jerr:
            jfluid.Executor(jfluid.CPUPlace()).run(
                jmain, feed=feed, fetch_list=[jcost], scope=jscope,
                eager=True)
    finally:
        j_flags.set_flag("check_nan_inf", False)
    tscope_ = tfluid.Scope()
    tfluid.io.params_from_numpy(tscope_, state, "cpu")
    t_flags.set_flag("check_nan_inf", True)
    with pytest.raises(NonfiniteError) as terr:
        tfluid.Executor(tfluid.CPUPlace()).run(
            tmain, feed=feed, fetch_list=[tcost], scope=tscope_)
    return jerr.value, terr.value


def _plant_second_fc(state):
    state["fc_1.w_0"][1, 2] = np.inf


@pytest.mark.parametrize("feed_x,plant", [
    (np.full((2, 4), np.nan, np.float32), lambda s: None),
    (np.ones((2, 4), np.float32), _plant_second_fc)],
    ids=["nan_feed", "inf_weight"])
def test_nonfinite_error_fields_match_jax_eager_scan(feed_x, plant):
    want, got = _scans({"x": feed_x}, plant)
    for field in ("op_type", "op_index", "slot", "var_name",
                  "nonfinite_count"):
        assert getattr(got, field) == getattr(want, field), field
    assert str(got) == str(want)
    assert (got.op_index > 0) == (plant is _plant_second_fc)


def test_scan_is_off_by_default_and_skips_sub_blocks():
    assert t_flags.get_flag("check_nan_inf") is False
    main, startup, cost, _ = _mlp(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    out = exe.run(main, feed={"x": np.full((2, 4), np.nan, np.float32)},
                  fetch_list=[cost], scope=scope)[0]
    assert np.isnan(out).all()


# -- NumericsMonitor ----------------------------------------------------------

def _transformer_pair():
    """(JAX main, startup, loss, params_grads; port main Program, startup
    desc, loss name, params_grads) of the transformer with Adam."""
    jmain, jstartup, jloss, _ = j_build(B, T, V, n_layer=N_LAYER,
                                        n_head=N_HEAD, d_model=D)
    with jfluid.program_guard(jmain, jstartup):
        _, jpg = jfluid.optimizer.Adam(learning_rate=1e-3).minimize(jloss)
    main_d, startup_d, loss, _ = build_transformer_program(
        B, T, V, n_layer=N_LAYER, n_head=N_HEAD, d_model=D)
    _, tpg = tfluid.Adam(1e-3).minimize(loss, main_d, startup_d)
    return (jmain, jstartup, jloss, jpg), \
        (tframework.Program.from_desc(main_d), startup_d, loss, tpg)


@pytest.mark.parametrize("discover", [False, True],
                         ids=["params_grads", "discovered"])
def test_monitor_appends_the_jax_ops_and_vars(discover):
    (jmain, _, jloss, jpg), (tmain, _, tloss, tpg) = _transformer_pair()
    # the monitor names its vars in the current main program, as JAX's
    with jfluid.program_guard(jmain):
        jmon = j_health.NumericsMonitor.for_train_program(
            jmain, cost=jloss, params_grads=None if discover else jpg) \
            .install()
    with tfluid.program_guard(tmain):
        tmon = t_health.NumericsMonitor.for_train_program(
            tmain, cost=tloss, params_grads=None if discover else tpg) \
            .install()
    assert tmon.install() is tmon  # idempotent
    assert tmon.fetch_names == jmon.fetch_names
    # the cost's count and max-abs, one count per parameter grad (12 a
    # layer, 6 outside), the norm
    assert len(tmon.fetch_names) == 2 + 12 * N_LAYER + 6 + 1
    assert tmain.desc.to_dict() == jmain.desc.to_dict()


def test_monitor_summaries_over_three_adam_steps_match_jax():
    (jmain, jstartup, jloss, jpg), (tmain, tstartup, tloss, tpg) = \
        _transformer_pair()
    jscaler = JLossScaler(growth_interval=2)
    tscaler = LossScaler(growth_interval=2)
    with jfluid.program_guard(jmain):
        jmon = j_health.NumericsMonitor.for_train_program(
            jmain, cost=jloss, params_grads=jpg, loss_scaler=jscaler) \
            .install()
    with tfluid.program_guard(tmain):
        tmon = t_health.NumericsMonitor.for_train_program(
            tmain, cost=tloss, params_grads=tpg, loss_scaler=tscaler) \
            .install()
    persist = [n for n, v in jmain.desc.block(0).vars.items()
               if v.persistable]
    feeds = [transformer_program_feeds(B, T, V, seed=s)
             for s in range(STEPS + 1)]
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
    init = {n: np.array(jscope.get(n)) for n in persist}
    texe, tscope_ = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.io.params_from_numpy(tscope_, init, "cpu")
    for step, feed in enumerate(feeds):
        if step == STEPS:  # the last step with an Inf in a weight
            w = np.array(jscope.get("fc_2.w_0"))
            w[0, 0] = np.inf
            jscope.set_local("fc_2.w_0", w)
            tscope_.get("fc_2.w_0")[0, 0] = float("inf")
        with jfluid.scope_guard(jscope):
            jouts = jexe.run(jmain, feed=feed,
                             fetch_list=[jloss] + jmon.fetch_names)
        touts = texe.run(tmain, feed=feed, fetch_list=[tloss]
                         + tmon.fetch_names, scope=tscope_)
        want, got = jmon.record(jouts[1:]), tmon.record(touts[1:])
        assert got["nonfinite"] == want["nonfinite"]
        assert got["found_nonfinite"] == want["found_nonfinite"] \
            == (step == STEPS)
        assert got["loss_scale"] == want["loss_scale"]
        if step < STEPS:
            np.testing.assert_allclose(
                [got["grad_global_norm"]] + list(got["max_abs"].values()),
                [want["grad_global_norm"]] + list(want["max_abs"].values()),
                rtol=RTOL, atol=0)
    assert [tscaler.scale, jscaler.scale] == [2.0 ** 15, 2.0 ** 15]
    assert t_registry.get_registry().gauge("amp_loss_scale").value \
        == 2.0 ** 15
    nonfinite = t_registry.get_registry().counter(
        "numerics_nonfinite_total", labelnames=("tensor",))
    assert sum(s["value"] for s in nonfinite.samples()) == sum(
        tmon.last["nonfinite"].values()) > 0


def test_loss_scaler_trajectory_matches_jax():
    rs = np.random.RandomState(0)
    verdicts = rs.rand(200) < 0.08
    kw = dict(init_scale=2.0 ** 10, growth_interval=7, max_scale=2.0 ** 14,
              min_scale=2.0)
    j, t = JLossScaler(**kw), LossScaler(**kw)
    traj = [(t.update(bool(v)), j.update(bool(v))) for v in verdicts]
    assert all(a == b for a, b in traj)
    assert len({a for a, _ in traj}) > 3
    assert t.set_scale(1e9) == j.set_scale(1e9) == 2.0 ** 14
    with pytest.raises(ValueError):
        LossScaler(init_scale=0)


# -- locate_nonfinite ---------------------------------------------------------

def _scope_bits(scope):
    """{name: bytes of every tensor (or the generator's state)} of a
    scope: the caller's state bit for bit."""
    import torch.utils._pytree as pytree

    out = {}
    for name, value in scope._vars.items():
        if isinstance(value, torch.Generator):
            out[name] = value.get_state().numpy().tobytes()
        else:
            out[name] = [t.clone() for t in pytree.tree_leaves(value)
                         if isinstance(t, torch.Tensor)]
    return out


def _same_bits(a, b):
    assert a.keys() == b.keys()
    for name in a:
        if isinstance(a[name], bytes):
            assert a[name] == b[name], name
        else:
            assert len(a[name]) == len(b[name])
            for x, y in zip(a[name], b[name]):
                assert x.dtype == y.dtype and torch.equal(
                    x.view(torch.uint8) if x.dtype.is_floating_point
                    else x, y.view(torch.uint8) if y.dtype.is_floating_point
                    else y), name


def test_locate_nonfinite_matches_jax_and_leaves_the_scope_bit_for_bit():
    jmain, jstartup, jcost, _ = _mlp(jfluid, sparse=True, dropout=True)
    tmain, _, tcost, _ = _mlp(tfluid, sparse=True, dropout=True)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    state = _mlp_state(jmain, jstartup)
    feed = {"ids": np.array([[1], [3], [3], [7]], np.int64)}
    tscope_ = tfluid.Scope()
    tfluid.io.params_from_numpy(tscope_, state, "cpu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tmain, feed=feed, fetch_list=[tcost], scope=tscope_)
    # a finite replay runs the whole step: dropout draws, the sparse
    # grad and every SGD update, all into the copy
    before = _scope_bits(tscope_)
    assert t_health.locate_nonfinite(tmain, feed, scope=tscope_,
                                     place=tfluid.CPUPlace()) is None
    _same_bits(before, _scope_bits(tscope_))
    assert t_flags.get_flag("check_nan_inf") is False

    state["fc_1.w_0"][2, 1] = -np.inf
    jscope = JScope()
    for n, v in state.items():
        jscope.set_local(n, v)
    want = j_health.locate_nonfinite(jmain, feed, scope=jscope)
    tfluid.io.params_from_numpy(tscope_, {"fc_1.w_0": state["fc_1.w_0"]},
                                "cpu")
    before = _scope_bits(tscope_)
    got = t_health.locate_nonfinite(tmain, feed, scope=tscope_,
                                    place=tfluid.CPUPlace())
    _same_bits(before, _scope_bits(tscope_))
    assert want is not None and got == want
    assert got["op_type"] == "mul" and got["op_index"] > 0


def test_locate_nonfinite_defaults_to_the_card():
    main, _, _, _ = _mlp(tfluid)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_health.locate_nonfinite(main, {"x": np.ones((2, 4), np.float32)},
                                  scope=tfluid.Scope())


def test_scan_outputs_and_the_switch():
    vals = [("a", np.array([1.0, np.nan, np.inf], np.float32)),
            ("b", np.array([1, 2], np.int32)),
            ("c", RaggedTensor.from_sequences(
                [np.array([[np.nan]], np.float32)]))]
    assert t_health.scan_outputs(vals) == 3
    fam = t_registry.get_registry().counter("numerics_nonfinite_total",
                                            labelnames=("tensor",))
    assert {s["labels"]["tensor"]: s["value"] for s in fam.samples()} \
        == {"a": 2, "c": 1}
    assert not t_health.enabled()
    t_health.enable()
    assert t_health.enabled() and j_health.enabled() is False
    with t_health.force_attribution():
        assert t_health.attribution_forced()
    assert not t_health.attribution_forced()
    assert set(t_health.__all__) == set(j_health.__all__)


# -- context, tail, flight ----------------------------------------------------

TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"


@pytest.mark.parametrize("header", [
    "00-%s-00f067aa0ba902b7-01" % TRACE_ID,
    "00-%s-00f067aa0ba902b7-00" % TRACE_ID,
    "00-%s-00F067AA0BA902B7-01" % TRACE_ID.upper(),
    "00-%s-00f067aa0ba902b7-01-extra" % TRACE_ID,
    "00-%s-0000000000000000-01" % TRACE_ID,
    "00-%s-00f067aa0ba902b7-01" % ("0" * 32),
    "ff-%s-00f067aa0ba902b7-01" % TRACE_ID,
    "00-%s-00f067aa0ba902b7-1" % TRACE_ID,
    "00-%s-00f0_7aa0ba902b7-01" % TRACE_ID,
    "00-%s-00f067aa0ba902b7" % TRACE_ID, "", None, 42])
def test_traceparent_parse_matches_jax(header):
    want = j_context.from_traceparent(header)
    got = t_context.from_traceparent(header)
    if want is None:
        assert got is None
        return
    for field in ("trace_id", "parent_span_id", "sampled"):
        assert getattr(got, field) == getattr(want, field)
    assert got.traceparent().split("-")[:2] == \
        want.traceparent().split("-")[:2]
    assert got.traceparent()[-2:] == want.traceparent()[-2:]


def test_span_tree_and_cross_thread_record():
    import threading

    ctx = t_context.new_context("00-%s-00f067aa0ba902b7-01" % TRACE_ID)
    with t_context.use(ctx):
        with t_context.span("outer"):
            with t_context.span("inner"):
                pass
    th = threading.Thread(target=lambda: t_context.record(
        "worker", 0.0, 0.001, ctx=ctx))
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    tree = ctx.to_dict()["spans"]
    names = sorted(n["name"] for n in tree)
    assert names == ["outer", "worker"]
    outer = next(n for n in tree if n["name"] == "outer")
    assert [c["name"] for c in outer["children"]] == ["inner"]
    assert set(ctx.to_dict()) == set(j_context.TraceContext().to_dict())


@pytest.mark.parametrize("latency,status,error", [
    (10.0, 200, None), (100.0, 200, None), (150.0, 200, None),
    (1.0, 500, None), (1.0, 503, None), (1.0, 429, None),
    (1.0, 200, RuntimeError("x")), (100.0, None, None)])
@pytest.mark.parametrize("slow_ms", [100.0, None])
def test_tail_classification_matches_jax(latency, status, error, slow_ms):
    want = j_tail.TailRecorder(slow_ms=slow_ms).classify(
        latency, status=status, error=error)
    got = t_tail.TailRecorder(slow_ms=slow_ms).classify(
        latency, status=status, error=error)
    assert got == want


def test_tail_ring_bound_and_dump_keys(tmp_path):
    jrec, trec = j_tail.TailRecorder(capacity=2, slow_ms=5.0), \
        t_tail.TailRecorder(capacity=2, slow_ms=5.0)
    for i in range(4):
        for rec, mod in ((jrec, j_context), (trec, t_context)):
            ctx = mod.TraceContext(request_id="r%d" % i)
            ctx.record("serving/request", 0.0, 0.01)
            assert rec.offer(ctx, 10.0 + i, status=200) == "slow"
    assert trec.offer(t_context.TraceContext(), 1.0, status=200) is None
    assert [r["request_id"] for r in trec.records()] == ["r2", "r3"]
    jdoc, tdoc = jrec.to_dict(), trec.to_dict()
    assert set(tdoc) == set(jdoc) and tdoc["evicted"] == 2
    assert set(tdoc["requests"][0]) == set(jdoc["requests"][0])
    obs_dump.validate_tail_dump(tdoc)
    path = trec.dump(str(tmp_path / "tail.json"))
    assert obs_dump.main(["--tail", path]) == 0


def test_describe_feeds_matches_jax_and_reads_no_value():
    feed = {"a": np.zeros((2, 3), np.float32),
            "b": np.zeros((4,), np.int32), "c": [1, 2, 3]}
    want = j_flight.describe_feeds(feed)
    tfeed = {"a": torch.empty(2, 3, device="meta"),
             "b": torch.empty(4, dtype=torch.int32, device="meta"),
             "c": [1, 2, 3]}
    assert t_flight.describe_feeds(tfeed) == want
    rt = RaggedTensor.from_sequences([np.zeros((2, 5), np.float32)])
    assert t_flight.describe_feeds({"r": rt}) == {"r": "float32[2, 5]"}


def test_flight_bundle_keys_match_jax(tmp_path):
    bundles = []
    for mod, d in ((j_flight, "j"), (t_flight, "t")):
        rec = mod.FlightRecorder(out_dir=str(tmp_path / d), capacity=4)
        for i in range(6):
            rec.record_step("v2", i, feeds={"x": np.ones((2, 4),
                                                         np.float32)},
                            loss=float(i), batch_id=i)
        rec.note("executor/run", feeds={"x": "float32[2, 4]"})
        try:
            raise ValueError("boom")
        except ValueError as exc:
            bundles.append(obs_dump.validate_flight_bundle(
                rec.dump(reason="test", exc=exc)))
    want, got = bundles
    assert set(got) == set(want) and got["kind"] == want["kind"]
    assert set(got["steps"][0]) == set(want["steps"][0])
    assert [s["step"] for s in got["steps"]] == [2, 3, 4, 5]
    assert got["dropped_steps"] == want["dropped_steps"] == 2
    assert got["exception"]["type"] == "ValueError"
    assert got["notes"] == [dict(n, t=got["notes"][0]["t"])
                            for n in want["notes"]]


def test_flight_install_chains_excepthook_and_executor_crash(tmp_path):
    rec = t_flight.install(out_dir=str(tmp_path), min_dump_interval_s=0.0)
    try:
        main, startup, cost, _ = _mlp(tfluid)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        t_flight.record_step("test", 0, loss=1.0)
        with pytest.raises(Exception) as err:
            exe.run(main, feed={"x": np.ones((2, 7), np.float32)},
                    fetch_list=[cost], scope=scope)
        path = rec.last_bundle_path
        doc = obs_dump.validate_flight_bundle(path)
        assert doc["exception"]["type"] == type(err.value).__name__
        note = doc["notes"][-1]
        assert note["origin"] == "executor/run"
        assert note["feeds"] == {"x": "float32[2, 7]"}
        assert doc["steps"][-1]["telemetry_delta"][
            "executor_runs_total"] >= 1
        assert obs_dump.main(["--flight", path]) == 0
        exc = ValueError("uncaught")
        sys.excepthook(ValueError, exc, None)
        assert rec.last_bundle_path != path
        with t_flight.suppressed():
            assert t_flight.on_crash(RuntimeError("x")) is None
    finally:
        t_flight.uninstall()
    assert not t_flight.active()
    assert t_flight.on_crash(RuntimeError("after")) is None


# -- the v2 trainer -----------------------------------------------------------

@pytest.fixture
def fresh_v2():
    """Fresh default programs and global scope for the port, the v2 API
    on the CPU in both packages."""
    old_main = tframework.switch_main_program(tframework.Program())
    old_startup = tframework.switch_startup_program(tframework.Program())
    old_scope = tscope._global_scope
    tscope._global_scope = tscope.Scope()
    old_state = dict(tconfig._state)
    tv2.init(use_gpu=False)
    jv2.init(use_gpu=False)
    yield
    tframework.switch_main_program(old_main)
    tframework.switch_startup_program(old_startup)
    tscope._global_scope = old_scope
    tconfig._state.update(old_state)


def _fit_a_line(v2):
    x = v2.layer.data(name="x", type=v2.data_type.dense_vector(13))
    pred = v2.layer.fc(input=x, size=1, act=v2.activation.Linear())
    y = v2.layer.data(name="y", type=v2.data_type.dense_vector(1))
    cost = v2.layer.square_error_cost(input=pred, label=y)
    params = v2.parameters.create(cost)
    return v2.trainer.SGD(cost=cost, parameters=params,
                          update_equation=v2.optimizer.Momentum(
                              momentum=0.9, learning_rate=1e-3))


def test_v2_sgd_under_health_installs_the_jax_monitor(fresh_v2, tmp_path):
    import paddle_tpu.obs.health as jh

    jh.enable()
    t_health.enable()
    jtrainer, ttrainer = _fit_a_line(jv2), _fit_a_line(tv2)
    from paddle_tpu.core import scope as jscope_mod

    js = jscope_mod.global_scope()
    state = {n: np.asarray(js.get(n)) for n, v in
             tfluid.default_main_program().desc.block(0).vars.items()
             if v.persistable and js.get(n) is not None}
    tfluid.io.params_from_numpy(tscope.global_scope(), state, "cpu")
    feeding = {"x": 0, "y": 1}
    jreader = jv2.batch(jpaddle.dataset.uci_housing.train(), batch_size=20)
    treader = tv2.batch(tpaddle.dataset.uci_housing.train(), batch_size=20)
    rec = t_flight.install(out_dir=str(tmp_path))
    jtrainer.train(reader=jreader, num_passes=1, feeding=feeding)
    ttrainer.train(reader=treader, num_passes=1, feeding=feeding)
    jmon, tmon = jtrainer._health_monitor, ttrainer._health_monitor
    assert tmon is not None and tmon.fetch_names == jmon.fetch_names
    assert tfluid.default_main_program().desc.to_dict() == \
        jfluid.default_main_program().desc.to_dict()
    assert tmon.last["nonfinite"] == jmon.last["nonfinite"]
    np.testing.assert_allclose(
        [tmon.last["grad_global_norm"]] + list(tmon.last["max_abs"].values()),
        [jmon.last["grad_global_norm"]] + list(jmon.last["max_abs"].values()),
        rtol=RTOL)
    # one record a step; step_runner reports a nonfinite verdict as NaN
    steps = [r for r in rec._steps if r["trainer"] == "v2"]
    assert len(steps) == sum(1 for _ in treader())
    step = ttrainer.step_runner(feeding=feeding)
    bad = [(np.full(13, np.nan, np.float32), np.ones(1, np.float32))] * 4
    assert np.isnan(step(bad))
    assert ttrainer._health_monitor is tmon
    with pytest.raises(Exception):
        step([(np.ones(7, np.float32), np.ones(1, np.float32))])
    doc = obs_dump.validate_flight_bundle(rec.last_bundle_path)
    assert any(n["origin"] == "v2/supervised_step" for n in doc["notes"])
    assert os.path.dirname(rec.last_bundle_path) == str(tmp_path)


# -- the activations at nonfinite inputs (the monitor's parity found them) -- 

ACT_X = np.array([np.nan, np.inf, -np.inf, -1.0, 0.0, -0.0, 0.5, 2.0, 6.0,
                  24.0, 41.0], np.float32)
ACT_G = np.array([1, 1, 1, 1, 1, 1, 1, np.nan, 1, 1, 1], np.float32)


def _activation_names():
    from paddle_tpu_torch.ops import activation

    return sorted(list(activation.UNARY) + list(activation.ACTIVATIONS)
                  + ["clip"])


@pytest.mark.parametrize("name", _activation_names())
def test_activation_at_nonfinite_inputs_matches_jax(name):
    """Every unary activation's value and grad at NaN, +-Inf and signed
    zeros equal the JAX kernel's: NaNs and infinities in the same places,
    finite values within 1e-6 absolute and relative (the f32
    transcendentals' last-ulp differences, and 1 - tanh(x)^2 cancelling
    near 0).  `relu`'s grad at a NaN input is 0 (`jax.nn.relu`'s select;
    torch.relu's backward passed dOut), and `jnp_clip`'s is 0 times dOut
    (JAX's max; torch.maximum's passed dOut): the monitor's counts of a
    step with a planted Inf differed before."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu_torch.ops.registry import run_generic_grad

    attrs = {"min": -0.5, "max": 6.0} if name == "clip" else {}
    jout, vjp = jax.vjp(
        lambda v: j_op(name).kernel(None, {"X": [v]}, attrs)["Out"][0],
        jnp.asarray(ACT_X))
    jgrad = np.asarray(vjp(jnp.asarray(ACT_G))[0])
    info = t_op(name)
    tout = info.kernel(None, {"X": [torch.from_numpy(ACT_X)]}, attrs)
    ins = {"X": [torch.from_numpy(ACT_X)], "O@Out": tout["Out"],
           "OG@Out": [torch.from_numpy(ACT_G)]}
    tgrad = (info.grad_kernel(None, ins, attrs) if info.grad_kernel
             else run_generic_grad(None, name, ins, attrs))["X@GRAD"][0]
    np.testing.assert_allclose(tout["Out"][0].numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-6, equal_nan=True)
    np.testing.assert_allclose(tgrad.numpy(), jgrad, rtol=1e-6, atol=1e-6,
                               equal_nan=True)

