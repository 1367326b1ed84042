"""The executor's captured segments (fluid/executor.py, fluid/graphs.py)
against the JAX executor's jitted ones, on the CPU, where nothing is
captured and each segment runs its plain version: the same ops against
the same plan, static buffers and donation.

- The segment plan equals the JAX executor's `_segment_block` on the
  golden fixtures and on the transformer, ResNet-50, seq2seq and CTR
  training programs; `capturable` differs from `jittable` only for the
  op types listed here, each with its reason, and a program holding one
  is split there.
- A signature warms up on its first run, is captured on its second and
  replayed after; a tensor swapped into the scope (as
  `io.params_from_numpy` swaps one) forces a new, counted capture; the
  program cache's eviction is counted and logged (the JAX package's
  tests/test_compile_cache.py:315 case).
- The segment path with donation equals the eager path bit for bit and
  the JAX package's steps within tests/test_torch_training.py's
  tolerance; a value fetched as a tensor survives the next run; eager
  runs (`eager=True`, FLAGS_check_nan_inf) capture nothing and count
  their segments.
- A kernel that reads the device from the host breaks the capture with
  an error naming the segment, its first op and the op; the capture
  guard's rules; a replay adds the flash launches its capture recorded.
"""

import logging

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.core.desc import ProgramDesc as JProgramDesc
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.fluid.executor import _segment_block as j_segment_block
from paddle_tpu.models import image as jimage
from paddle_tpu.models import seq2seq as j_seq2seq
from paddle_tpu.models.ctr import deepfm_ctr as j_ctr
from paddle_tpu.models.transformer_program import (
    build_transformer_program as j_transformer,
    transformer_program_feeds)
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.desc import ProgramDesc
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.fluid import graphs
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models.transformer_program import (
    build_transformer_program)
from paddle_tpu_torch.obs import registry as tregistry
from paddle_tpu_torch.obs import telemetry as ttele
from paddle_tpu_torch.ops import registry as op_registry
from paddle_tpu_torch.tools.lint_cli import _golden_descs
from paddle_tpu_torch.utils import flags

torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
B, T, V, N_LAYER, N_HEAD, D = 4, 32, 64, 2, 4, 32
ATOL = 1e-5   # tests/test_torch_training.py's, f32 on both sides

# the op types whose two marks differ: jittable on the JAX side, not
# capturable here, each with the reason its torch kernel gives
NOT_CAPTURABLE = {
    "conditional_block": "reads its condition on the host to choose "
                         "whether the sub-block runs",
    "seq_renest": "checks the outer splits against its input's rows on "
                  "the host (one read of the last offset)",
    "while": "without max_steps, reads the condition on the host before "
             "each iteration",
}


@pytest.fixture(autouse=True)
def _fresh():
    tregistry.reset_registry()
    old = flags.get_flag("donation")
    yield
    flags.set_flag("donation", old)


def _types(segments):
    return [(flag, [od.type for od in ops]) for flag, ops in segments]


# -- the plan -----------------------------------------------------------------

def test_marks_differ_only_where_listed():
    assert op_registry.capture_exceptions() == NOT_CAPTURABLE
    for t in op_registry.registered_ops():
        info = op_registry.get_op_info(t)
        assert info.jittable or not info.capturable, t


def _jax_programs():
    """{name: JAX main program} of the training programs whose plans
    are compared."""
    out = {}
    main, startup, loss, _ = j_transformer(B, T, V, n_layer=N_LAYER,
                                           n_head=N_HEAD, d_model=D)
    with jfluid.program_guard(main, startup):
        jfluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    out["transformer"] = main
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        image = jfluid.layers.data(name="image", shape=[2, 3, 32, 32],
                                   dtype="float32", append_batch_size=False)
        label = jfluid.layers.data(name="label", shape=[2, 1],
                                   dtype="int64", append_batch_size=False)
        logits = jimage.resnet50(image, class_dim=10)
        loss = jfluid.layers.mean(
            jfluid.layers.softmax_with_cross_entropy(logits, label))
        jfluid.optimizer.MomentumOptimizer(
            learning_rate=0.01, momentum=0.9).minimize(loss)
    out["resnet50"] = main
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        src = jfluid.layers.data(name="src_word_id", shape=[1],
                                 dtype="int64", lod_level=1)
        trg = jfluid.layers.data(name="target_language_word", shape=[1],
                                 dtype="int64", lod_level=1)
        nxt = jfluid.layers.data(name="target_language_next_word",
                                 shape=[1], dtype="int64", lod_level=1)
        prob = j_seq2seq(src, trg, 100, 100, emb_dim=8, hidden_dim=8)
        loss = jfluid.layers.mean(
            jfluid.layers.cross_entropy(input=prob, label=nxt))
        jfluid.optimizer.Adam(learning_rate=0.02).minimize(loss)
    out["seq2seq"] = main
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        ids = jfluid.layers.data(name="ids", shape=[4], dtype="int64")
        label = jfluid.layers.data(name="label", shape=[1],
                                   dtype="float32")
        loss, _ = j_ctr(ids, label, 1000, 4, embed_dim=8,
                        hidden_sizes=(16, 8))
        jfluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    out["ctr"] = main
    return out


@pytest.mark.parametrize("name", ["transformer", "resnet50", "seq2seq",
                                  "ctr"])
def test_plan_equals_jax_segment_block(name):
    jmain = _jax_programs()[name]
    jdesc = jmain.desc if hasattr(jmain, "desc") else jmain
    desc = ProgramDesc.from_dict(jdesc.to_dict())
    want = _types(j_segment_block(jdesc.block(0).ops))
    got = _types(texecutor._segment_block(desc.block(0).ops))
    assert got == want
    assert not {t for _, ts in got for t in ts} & set(NOT_CAPTURABLE)


def test_plan_equals_jax_on_the_golden_fixtures():
    for name, desc in _golden_descs():
        jdesc = JProgramDesc.from_dict(desc.to_dict())
        got = _types(texecutor._segment_block(desc.block(0).ops))
        want = _types(j_segment_block(jdesc.block(0).ops))
        if not {od.type for od in desc.block(0).ops} & set(NOT_CAPTURABLE):
            assert got == want, name


def test_a_listed_op_splits_the_plan_there():
    from paddle_tpu_torch.core.desc import OpDesc

    ops = [OpDesc("scale", {"X": ["a"]}, {"Out": ["b"]}, {}),
           OpDesc("seq_renest", {"X": ["b"], "OuterRef": ["r"]},
                  {"Out": ["c"]}, {}),
           OpDesc("scale", {"X": ["c"]}, {"Out": ["d"]}, {})]
    assert _types(texecutor._segment_block(ops)) == [
        (True, ["scale"]), (False, ["seq_renest"]), (True, ["scale"])]


# -- capture, replay, recapture ----------------------------------------------

def _fit_a_line(opt="SGD"):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[13], dtype="float32")
        y = tfluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = tfluid.layers.fc(input=x, size=1)
        loss = tfluid.layers.mean(
            x=tfluid.layers.square_error_cost(input=pred, label=y))
        getattr(tfluid.optimizer, opt)(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _feed(seed=0, rows=8):
    rs = np.random.RandomState(seed)
    xs = rs.randn(rows, 13).astype(np.float32)
    return {"x": xs, "y": (xs[:, :1] * 2.0 - 1.0).astype(np.float32)}


def test_warm_up_capture_replay_and_a_swapped_tensor_recaptures():
    main, startup, loss = _fit_a_line()
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    w = next(v.name for v in main.global_block().all_parameters())
    for i in range(3):
        exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope)
    assert (exe.captures, exe.replays) == (1, 1)
    kept = scope.get(w)
    exe.run(main, feed=_feed(3), fetch_list=[loss], scope=scope)
    # donated: written in place, the scope keeps its tensor
    assert scope.get(w) is kept and (exe.captures, exe.replays) == (1, 2)
    # another feed shape: another signature, warmed up, then captured
    for i in range(2):
        exe.run(main, feed=_feed(i, rows=4), fetch_list=[loss], scope=scope)
    assert (exe.captures, exe.replays) == (2, 2)
    # a tensor swapped into the scope changes the address the graph
    # reads: a new signature, so a new capture (counted), never a read
    # of the old tensor
    tio.params_from_numpy(scope, {w: scope.get(w).numpy()}, "cpu")
    assert scope.get(w) is not kept
    before = scope.get(w).clone()
    out = [exe.run(main, feed=_feed(5), fetch_list=[loss, w], scope=scope)
           for _ in range(2)]
    assert (exe.captures, exe.replays) == (3, 2)
    assert not np.array_equal(out[0][1], before.numpy())
    assert not torch.equal(scope.get(w), before)


def test_program_cache_eviction_counted_and_logged(monkeypatch, caplog):
    monkeypatch.setattr(texecutor.Executor, "_CACHE_MAX", 1)
    exe = texecutor.Executor(CPU)
    scope = tfluid.Scope()
    x = np.arange(8, dtype=np.float32).reshape(2, 4)
    with caplog.at_level(logging.DEBUG, logger="paddle_tpu_torch.executor"):
        for scale in (2.0, 3.0):
            main, startup = tfluid.Program(), tfluid.Program()
            with tfluid.program_guard(main, startup):
                xv = tfluid.layers.data(name="x", shape=[4],
                                        dtype="float32")
                out = tfluid.layers.scale(xv, scale=scale)
            out_v = exe.run(main, feed={"x": x}, fetch_list=[out],
                            scope=scope)[0]
            np.testing.assert_array_equal(out_v, x * scale)
    snap = ttele.snapshot()
    assert snap["executor_program_cache_evictions_total"] >= 1
    assert any("evicted program cache entry" in r.message
               for r in caplog.records)


def test_signature_cache_eviction_counted(monkeypatch):
    monkeypatch.setattr(texecutor.Executor, "_CACHE_MAX", 1)
    main, startup, loss = _fit_a_line()
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    for rows in (4, 6):
        for _ in range(2):
            exe.run(main, feed=_feed(0, rows=rows), fetch_list=[loss],
                    scope=scope)
    compiled = list(exe._cache.values())[-1][2]
    assert exe.captures == 2 and len(compiled._records) == 1
    assert ttele.snapshot()["executor_program_cache_evictions_total"] >= 1


# -- numerics -----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_steps():
    main, startup, loss, _ = j_transformer(B, T, V, n_layer=N_LAYER,
                                           n_head=N_HEAD, d_model=D)
    with jfluid.program_guard(main, startup):
        jfluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    persist = [n for n, v in main.desc.block(0).vars.items()
               if v.persistable]
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    feeds = [transformer_program_feeds(B, T, V, seed=s) for s in range(4)]
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.array(scope.get(n)) for n in persist}
        losses = [float(exe.run(main, feed=f, fetch_list=[loss])[0][0])
                  for f in feeds]
    return init, losses, feeds


@pytest.mark.parametrize("mode", ["off", "conservative", "auto"])
def test_segment_path_equals_eager_and_jax(jax_steps, mode):
    init, jlosses, feeds = jax_steps
    flags.set_flag("donation", mode)
    main, startup, loss, _ = build_transformer_program(
        B, T, V, n_layer=N_LAYER, n_head=N_HEAD, d_model=D)
    tfluid.Adam(1e-3).minimize(loss, main, startup)
    runs = {}
    for eager in (True, False):
        exe, scope = tfluid.Executor(CPU), tfluid.Scope()
        tio.params_from_numpy(scope, init, "cpu")
        losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope, eager=eager)[0][0])
                  for f in feeds]
        runs[eager] = (losses, {n: scope.get(n) for n in init}, exe)
    assert runs[True][0] == runs[False][0]
    for n in init:
        assert torch.equal(runs[True][1][n], runs[False][1][n]), n
    assert runs[True][2].captures == 0
    assert (runs[False][2].captures, runs[False][2].replays) == (1, 2)
    np.testing.assert_allclose(runs[False][0], jlosses, atol=ATOL, rtol=0)


def test_each_scope_replays_its_own_random_stream():
    """A segment that reads no state has one signature in every scope;
    its graph draws from the stream registered at its capture, so each
    scope's stream keys its own capture: two scopes seeded alike draw
    alike, run by run."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[64], dtype="float32")
        d = tfluid.layers.dropout(x, dropout_prob=0.5)
    exe = tfluid.Executor(CPU)
    feed = {"x": np.ones((4, 64), np.float32)}
    runs = []
    for _ in range(2):
        scope = tfluid.Scope()
        runs.append([exe.run(main, feed=feed, fetch_list=[d], scope=scope)[0]
                     for _ in range(4)])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(runs[0][2], runs[0][3])
    assert exe.captures == 2


def test_fetched_tensor_survives_the_next_run():
    main, startup, loss = _fit_a_line()
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    got = []
    for i in range(4):
        out = exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope,
                      return_numpy=False)[0]
        got.append((out, out.clone()))
    for t, copy in got:
        assert torch.equal(t, copy)
    assert len({float(c) for _, c in got}) == 4


@pytest.mark.parametrize("how", ["eager", "check_nan_inf"])
def test_eager_runs_capture_nothing(how):
    main, startup, loss = _fit_a_line()
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    w = next(v.name for v in main.global_block().all_parameters())
    kept = scope.get(w)
    prev = flags.get_flag("check_nan_inf")
    try:
        if how == "check_nan_inf":
            flags.set_flag("check_nan_inf", True)
        for i in range(3):
            exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope,
                    eager=how == "eager")
    finally:
        flags.set_flag("check_nan_inf", prev)
    assert exe.captures == exe.replays == 0
    # eager runs never donate: the scope's tensor is replaced
    assert scope.get(w) is not kept
    fam = tregistry.get_registry().counter(
        "executor_eager_segments_total", labelnames=("reason",))
    assert fam.labels(reason=how).value == 3


def test_an_eager_run_drops_the_programs_graphs():
    main, startup, loss = _fit_a_line()
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    for i in range(3):
        exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope)
    compiled = list(exe._cache.values())[-1][2]
    assert len(compiled._records) == 1
    exe.run(main, feed=_feed(3), fetch_list=[loss], scope=scope, eager=True)
    assert not compiled._records
    assert ttele.snapshot()["executor_program_cache_evictions_total"] == 1
    for i in range(3):
        exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope)
    assert (exe.captures, exe.replays) == (2, 2)


# -- the guard and the launch counts -----------------------------------------

def test_capture_error_names_segment_and_op():
    def reads_host(ctx, ins, attrs):
        x = ins["X"][0]
        return {"Out": [x * float(x.sum())]}

    op_registry.register_op("test_reads_host")(reads_host)
    try:
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
            h = tfluid.layers.scale(x, scale=2.0)
        block = main.desc.block(0)
        from paddle_tpu_torch.core.desc import OpDesc, VarDesc

        block.vars["bad"] = VarDesc("bad", dtype="float32", shape=(-1, 4))
        block.ops.append(OpDesc("test_reads_host", {"X": [h.name]},
                                {"Out": ["bad"]}, {}))
        exe = tfluid.Executor(CPU)
        feed = {"x": np.ones((2, 4), np.float32)}
        exe.run(main, feed=feed, fetch_list=["bad"])    # the warm-up
        with pytest.raises(graphs.CaptureError) as err:
            exe.run(main, feed=feed, fetch_list=["bad"])
        msg = str(err.value)
        assert "jit_segment[0:scale..test_reads_host x2]" in msg
        assert "first op 'scale'" in msg
        assert "op 1 ('test_reads_host')" in msg and "Tensor.__float__" \
            in msg
    finally:
        del op_registry._OP_REGISTRY["test_reads_host"]


@pytest.mark.parametrize("breach", ["item", "tolist", "bool", "nonzero",
                                    "mask", "tensor", "repeat"])
def test_capture_guard_rules(breach):
    x = torch.arange(4.0)
    calls = {
        "item": lambda: x.sum().item(),
        "tolist": lambda: x.tolist(),
        "bool": lambda: bool(x[0] > 0),
        "nonzero": lambda: torch.nonzero(x),
        "mask": lambda: x[x > 1],
        "tensor": lambda: torch.tensor([1.0, 2.0], device="cpu"),
        "repeat": lambda: torch.repeat_interleave(x, x.long()),
    }
    with graphs.capture_guard("cpu"):
        x[1:].sum()                       # allowed: kernels only
        torch.full((), 2.0, device="cpu")
        with pytest.raises(graphs.CaptureError):
            calls[breach]()
    calls[breach]()                       # outside: as before
    assert "__getitem__" not in vars(torch.Tensor)


def test_replays_add_the_launches_their_capture_recorded():
    fwd = fa.flash_attention_fwd
    saved = fwd.launches, dict(fwd.route_launches)
    try:
        before = graphs.launch_snapshot()
        fwd.launches += 2
        fwd.route_launches["f32"] += 2
        delta = graphs.launch_delta(before)
        assert delta == {"launches": 2, "f32": 2}
        graphs.add_launches(delta, sign=-1)
        assert graphs.launch_delta(before) == {}
        for _ in range(3):
            graphs.add_launches(delta)
        assert graphs.launch_delta(before) == {"launches": 6, "f32": 6}
    finally:
        fwd.launches, fwd.route_launches = saved[0], saved[1]


def test_graph_call_warms_captures_and_replays():
    call = graphs.GraphCall("cpu")
    seen = []

    def fn(ins):
        seen.append(1)
        return ins["a"] * 2 + 1

    outs = [call(("k",), fn, {"a": torch.full((3,), float(i))})
            for i in range(4)]
    assert [float(o[0]) for o in outs] == [1.0, 3.0, 5.0, 7.0]
    assert (call.captures, call.replays) == (1, 2) and len(seen) == 4
    call(("other",), fn, {"a": torch.zeros(3)})
    assert call.captures == 1
