"""The port's utilities against the JAX package's, on the CPU: the
observability dump's validators and renderers (`tools/obs_dump.py`),
the Program diagram (`utils/model_diagram.py`), single-file model
packaging (`utils/merge_model.py`) and torch weight import
(`utils/torch2paddle.py`).

- obs_dump: each package's validators accept the other's traces,
  Prometheus expositions (with and without exemplars), flight bundles
  and tail dumps, and refuse the same malformed ones; the renderers give
  the same text for the same bundle and dump; the port's dump modes
  write a trace and the metrics.
- model_diagram: for one ProgramDesc (tests/test_model_diagram.py's
  program, and one with a While sub-block), the DOT and the text equal
  the JAX module's byte for byte, also through the CLI over a saved
  model.
- merge_model: tests/test_merge_model.py's cases through the port (a
  save_inference_model directory and a v2 topology with its parameters
  tar, each merged and loaded back to the same outputs), and files that
  cross: merged by either package, loaded by the other, to the same
  values, bfloat16 ones included (the JAX package loads those as their
  raw bits, and only without an executor: ROADMAP C1).
- torch2paddle: tests/test_torch2paddle.py's four cases through the
  port (an MLP's and a convolution's outputs equal torch's, the name map
  and its shape guard, a state dict through a file), the values on the
  executor's place.
"""

import io
import json
import os
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.v2 as jv2
from paddle_tpu.obs import flight as j_flight
from paddle_tpu.obs import registry as j_registry
from paddle_tpu.obs import tail as j_tail
from paddle_tpu.obs import trace as j_trace
from paddle_tpu.tools import obs_dump as j_dump
from paddle_tpu.utils import merge_model as j_merge
from paddle_tpu.utils import model_diagram as j_diagram
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.v2 as tv2
from paddle_tpu_torch.core.desc import ProgramDesc
from paddle_tpu_torch.obs import context as t_context
from paddle_tpu_torch.obs import flight as t_flight
from paddle_tpu_torch.obs import registry as t_registry
from paddle_tpu_torch.obs import tail as t_tail
from paddle_tpu_torch.obs import trace as t_trace
from paddle_tpu_torch.tools import obs_dump as t_dump
from paddle_tpu_torch.utils import merge_model as t_merge
from paddle_tpu_torch.utils import model_diagram as t_diagram
from paddle_tpu_torch.utils.torch2paddle import (load_torch_state,
                                                 torch_state_to_numpy)

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
DUMPS = (j_dump, t_dump)


@pytest.fixture(autouse=True)
def fresh_port_obs():
    t_registry.reset_registry()
    t_trace.disable()
    t_trace.reset()
    yield
    t_trace.disable()
    t_trace.reset()


# -- obs_dump ---------------------------------------------------------------------

def _traces(tmp_path):
    """A port trace and a JAX trace of a tiny executor run each."""
    paths = []
    for fluid, trace, tag in ((tfluid, t_trace, "t"), (jfluid, j_trace,
                                                       "j")):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            y = fluid.layers.fc(input=x, size=2, act="relu")
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        trace.enable(clear=True)
        try:
            with trace.span("test/outer", cat="test"):
                exe.run(main, feed={"x": np.ones((3, 4), np.float32)},
                        fetch_list=[y], scope=scope)
            trace.instant("test/mark", cat="test", k=1)
        finally:
            trace.disable()
        path = str(tmp_path / ("trace_%s.json" % tag))
        trace.export_chrome_trace(path)
        paths.append(path)
    return paths


def test_validators_accept_each_others_traces(tmp_path):
    for path in _traces(tmp_path):
        counts = [len(d.validate_chrome_trace(path)) for d in DUMPS]
        assert counts[0] == counts[1] > 2
        for d in DUMPS:
            assert d.main(["--check", path]) == 0
    names = {e["name"] for e in t_dump.validate_chrome_trace(
        _traces(tmp_path)[0])}
    assert {"executor/run", "test/outer", "mul", "test/mark"} <= names


@pytest.mark.parametrize("bad", [
    {}, {"traceEvents": []},
    {"traceEvents": [{"name": "x", "ph": "X", "ts": 0, "pid": 1,
                      "tid": 1}]},
    {"traceEvents": [{"name": "x", "ph": "Q"}]},
    {"traceEvents": [{"name": 3, "ph": "i", "ts": 0, "pid": 1,
                      "tid": 1}]}])
def test_validators_refuse_the_same_traces(bad):
    for d in DUMPS:
        with pytest.raises(AssertionError):
            d.validate_chrome_trace(bad)


def _expositions():
    """Both packages' serving metrics and registry, rendered plain and
    with exemplars."""
    from paddle_tpu.serving.metrics import ServingMetrics as JMetrics
    from paddle_tpu_torch.serving.metrics import ServingMetrics as TMetrics

    texts = []
    for metrics_cls, reg in ((JMetrics, j_registry), (TMetrics,
                                                      t_registry)):
        m = metrics_cls()
        m.responses_total.inc()
        m.observe_stage("total", 0.012, exemplar="deadbeef" * 4)
        reg.get_registry().counter("retries_total", "r",
                                   labelnames=("op",)).labels(op="x").inc()
        texts += [m.render_text(), m.render_text(exemplars=True)]
    return texts


def test_validators_accept_each_others_expositions():
    texts = _expositions()
    for text in texts:
        names = [d.validate_prometheus_text(text) for d in DUMPS]
        assert names[0] == names[1]
        assert {"serving_responses_total", "retries_total"} <= names[0]
    assert " # {" in texts[1] and " # {" in texts[3]
    j_registry.reset_registry()


@pytest.mark.parametrize("bad", ["", "# only comments\n", "a b c\n",
                                 "metric notanumber\n",
                                 'm_bucket{le="1"} 1 # bad 1\n'])
def test_validators_refuse_the_same_expositions(bad):
    for d in DUMPS:
        with pytest.raises((AssertionError, ValueError)):
            d.validate_prometheus_text(bad)


def _bundles(tmp_path):
    out = []
    for mod, tag in ((j_flight, "j"), (t_flight, "t")):
        rec = mod.FlightRecorder(out_dir=str(tmp_path / tag), capacity=4)
        for i in range(5):
            rec.record_step("v2", i, feeds={"x": np.ones((2, 4),
                                                         np.float32)},
                            loss=float(i) / 4, batch_id=i)
        rec.note("faults", point="serving/run", kind="latency", fired=1)
        try:
            raise ValueError("boom")
        except ValueError as exc:
            out.append(rec.dump(reason="test", exc=exc))
    return out


def test_flight_bundles_cross_and_render_alike(tmp_path):
    for path in _bundles(tmp_path):
        renders = [d.render_flight(path) for d in DUMPS]
        assert renders[0] == renders[1]
        assert "ValueError: boom" in renders[0]
        assert "note [faults]" in renders[0]
        for d in DUMPS:
            d.validate_flight_bundle(path)
            assert d.main(["--flight", path]) == 0
    with open(_bundles(tmp_path)[1]) as f:
        doc = json.load(f)
    for broken in (dict(doc, kind="other"), dict(doc, steps=None),
                   dict(doc, exception={"type": "X"})):
        for d in DUMPS:
            with pytest.raises(AssertionError):
                d.validate_flight_bundle(broken)


def test_tail_dumps_cross_and_render_alike(tmp_path):
    paths = []
    for tail, ctx_mod, tag in ((j_tail, __import__(
            "paddle_tpu.obs.context", fromlist=["x"]), "j"),
            (t_tail, t_context, "t")):
        rec = tail.TailRecorder(capacity=4, slow_ms=5.0)
        for i, (latency, status, error) in enumerate(
                ((12.5, 200, None), (1.0, 503, "draining"),
                 (30.0, 200, None))):
            ctx = ctx_mod.TraceContext(request_id="r%d" % i,
                                       trace_id="%032x" % (i + 1))
            ctx.record("serving/request", 0.0, latency / 1e3)
            ctx.record("serving/queue_wait", 0.0, 0.001)
            rec.offer(ctx, latency, status=status, error=error)
        paths.append(rec.dump(str(tmp_path / ("tail_%s.json" % tag))))
    renders = [[d.render_tail(p) for d in DUMPS] for p in paths]
    assert renders[0][0] == renders[0][1] and renders[1][0] == renders[1][1]
    assert renders[0][0].splitlines()[0] == renders[1][0].splitlines()[0]
    for d in DUMPS:
        with pytest.raises(AssertionError):
            d.validate_tail_dump({"kind": "paddle_tpu.tail", "version": 1,
                                  "requests": [{"reason": "odd"}]})


def test_dump_modes_write_the_trace_and_metrics(tmp_path, capsys):
    t_trace.enable(clear=True)
    with t_trace.span("test/work", cat="test"):
        t_registry.get_registry().counter("test_total", "t").inc()
    t_trace.disable()
    trace_path, prom = str(tmp_path / "t.json"), str(tmp_path / "m.prom")
    assert t_dump.main(["--trace-out", trace_path, "--metrics-out",
                        prom]) == 0
    assert j_dump.validate_chrome_trace(trace_path)
    with open(prom) as f:
        assert "test_total" in j_dump.validate_prometheus_text(f.read())
    assert t_dump.main(["--metrics-out", "-", "--format", "jsonl"]) == 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()
             if line.startswith("{")]
    assert any(r.get("name") == "test_total" for r in lines)
    with pytest.raises(SystemExit):
        t_dump.main([])


# -- model_diagram ----------------------------------------------------------------

def _program(fluid):
    """tests/test_model_diagram.py's program."""
    main_p, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_p, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        label = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=4, act="relu")
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=h, label=label))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main_p


def _while_program(fluid):
    main_p, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_p, startup):
        i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        limit = fluid.layers.fill_constant(shape=[1], dtype="int64",
                                           value=3)
        acc = fluid.layers.fill_constant(shape=[2], dtype="float32",
                                         value=1.0)
        cond = fluid.layers.less_than(x=i, y=limit)
        loop = fluid.layers.While(cond=cond)
        with loop.block():
            fluid.layers.assign(fluid.layers.scale(x=acc, scale=2.0), acc)
            fluid.layers.increment(x=i, in_place=True)
            fluid.layers.less_than(x=i, y=limit, cond=cond)
    return main_p


@pytest.mark.parametrize("build", [_program, _while_program],
                         ids=["sgd", "while"])
def test_diagram_and_text_equal_jax_byte_for_byte(build):
    jprog, tprog = build(jfluid), build(tfluid)
    assert tprog.desc.to_dict() == jprog.desc.to_dict()
    dot = t_diagram.program_to_dot(tprog)
    assert dot == j_diagram.program_to_dot(jprog)
    assert t_diagram.program_to_text(tprog) == \
        j_diagram.program_to_text(jprog)
    # a bare ProgramDesc, parsed from the JAX package's JSON
    desc = ProgramDesc.from_dict(jprog.desc.to_dict())
    assert t_diagram.program_to_dot(desc) == dot
    assert dot.startswith("digraph program {") and dot.endswith("}")
    if build is _program:
        for mark in ("style=dashed", "peripheries=2",
                     "fillcolor=lightgray", "float32"):
            assert mark in dot
    else:
        assert "subgraph cluster_block1" in dot


def test_diagram_cli_over_a_saved_model(tmp_path):
    prog = _program(jfluid)
    model = tmp_path / "model.json"
    model.write_text(json.dumps({"program": prog.desc.to_dict()}))
    outs = []
    for mod, tag in ((j_diagram, "j"), (t_diagram, "t")):
        out = tmp_path / ("g_%s.dot" % tag)
        mod.main([str(model), str(out)])
        outs.append(out.read_text())
    assert outs[0] == outs[1] and outs[1].startswith("digraph")
    with pytest.raises(SystemExit):
        t_diagram.main([])


# -- merge_model ------------------------------------------------------------------

def _feeds(n=6):
    rs = np.random.RandomState(3)
    return {"x": rs.rand(n, 13).astype(np.float32)}


def _export(fluid, tmp_path, tag):
    """tests/test_merge_model.py's 13 -> 4 -> 1 model, exported; (dir,
    the outputs on _feeds, its scope's values)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        y = fluid.layers.fc(input=x, size=4, act="tanh")
        out = fluid.layers.fc(input=y, size=1, act=None)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    want, = exe.run(main, feed=_feeds(), fetch_list=[out], scope=scope)
    model_dir = str(tmp_path / ("model_" + tag))
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(model_dir, ["x"], [out], exe,
                                      main_program=main)
    return model_dir, np.asarray(want)


def test_merge_inference_dir_roundtrip_through_the_port(tmp_path):
    model_dir, want = _export(tfluid, tmp_path, "t")
    merged = t_merge.merge_inference_model(model_dir,
                                           str(tmp_path / "one.tar"))
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    prog, feeds, fetches = t_merge.load_merged_model(merged, exe,
                                                     scope=scope)
    assert feeds == ["x"] and isinstance(prog, tfluid.Program)
    assert all(isinstance(scope.get(v.name), torch.Tensor)
               for v in prog.list_vars() if v.persistable)
    got, = exe.run(prog, feed=_feeds(), fetch_list=fetches, scope=scope)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_merged_files_cross_both_ways(tmp_path, direction):
    src_fluid, src_merge = (jfluid, j_merge) if direction == "jax_to_port" \
        else (tfluid, t_merge)
    model_dir, want = _export(src_fluid, tmp_path, "src")
    merged = src_merge.merge_inference_model(model_dir,
                                             str(tmp_path / "one.tar"))
    if direction == "jax_to_port":
        scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
        prog, feeds, fetches = t_merge.load_merged_model(merged, exe,
                                                         scope=scope)
    else:
        scope, exe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
        with jfluid.scope_guard(scope):
            prog, feeds, fetches = j_merge.load_merged_model(merged, exe,
                                                             scope=scope)
    got, = exe.run(prog, feed={feeds[0]: _feeds()["x"]},
                   fetch_list=fetches, scope=scope)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-6)


def _bf16_export(tmp_path):
    """A save_inference_model directory holding a bfloat16 parameter
    (the port's bits as a V2 array, as both packages save bf16)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[13], dtype="float32")
        out = tfluid.layers.fc(input=x, size=3, act=None,
                               param_attr=tfluid.ParamAttr(name="w_bf16"))
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    w = torch.from_numpy(np.random.RandomState(5).randn(13, 3).astype(
        np.float32)).to(torch.bfloat16)
    scope.set("w_bf16", w)
    model_dir = str(tmp_path / "bf16")
    tfluid.io.save_inference_model(model_dir, ["x"], [out], scope,
                                   main_program=main)
    return model_dir, w


@pytest.mark.parametrize("merger", ["port", "jax"])
def test_bf16_values_cross_in_merged_files(tmp_path, merger):
    """A bf16 value merged by either package loads in the port as the
    same bf16 tensor, and in the JAX package as its raw bits (|V2)."""
    model_dir, w = _bf16_export(tmp_path)
    merge = t_merge if merger == "port" else j_merge
    merged = merge.merge_inference_model(model_dir,
                                         str(tmp_path / "one.tar"))
    scope = tfluid.Scope()
    t_merge.load_merged_model(merged, tfluid.Executor(CPU), scope=scope)
    got = scope.get("w_bf16")
    assert got.dtype == torch.bfloat16 and torch.equal(got, w)
    # without an executor: the JAX package's device_put refuses a |V2
    # array, the reference-side fault of ROADMAP C1
    jscope = jfluid.Scope()
    j_merge.load_merged_model(merged, None, scope=jscope)
    raw = np.asarray(jscope.get("w_bf16"))
    assert raw.dtype == np.dtype("V2")
    np.testing.assert_array_equal(raw.view(np.int16),
                                  w.view(torch.int16).numpy())


def _v2_net(v2):
    x = v2.layer.data(name="x", type=v2.data_type.dense_vector(13))
    hidden = v2.layer.fc(input=x, size=4, act=v2.activation.Tanh())
    return v2.layer.fc(input=hidden, size=1, act=v2.activation.Linear())


def test_merge_v2_model_through_the_port(tmp_path):
    """tests/test_merge_model.py::test_merge_v2_model through the port;
    the merged file also loads in the JAX package to the same outputs."""
    feed = _feeds()
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()), \
            tfluid.scope_guard(tfluid.Scope()):
        tv2.init(use_gpu=False)
        out = _v2_net(tv2)
        params = tv2.parameters.create(out)
        param_file = str(tmp_path / "params.tar")
        with open(param_file, "wb") as f:
            params.to_tar(f)
        merged = t_merge.merge_v2_model(out, param_file,
                                        str(tmp_path / "deploy.tar"))
        want = tv2.infer(output_layer=out, parameters=params,
                         input=[(row,) for row in feed["x"]])
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    prog, feeds, fetches = t_merge.load_merged_model(merged, exe,
                                                     scope=scope)
    got, = exe.run(prog, feed={feeds[0]: feed["x"]}, fetch_list=fetches,
                   scope=scope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jprog, jfeeds, jfetches = j_merge.load_merged_model(
            merged, jexe, scope=jscope)
        jgot, = jexe.run(jprog, feed={jfeeds[0]: feed["x"]},
                         fetch_list=jfetches, scope=jscope)
    np.testing.assert_allclose(np.asarray(jgot), got, rtol=1e-5, atol=1e-6)
    with tarfile.open(merged) as tar:
        meta = json.loads(tar.extractfile("__model__").read())
    assert meta["feed_names"] == ["x"] and len(meta["fetch_names"]) == 1


def test_jax_merged_v2_model_loads_in_the_port(tmp_path):
    feed = _feeds()
    with jfluid.program_guard(jfluid.Program(), jfluid.Program()), \
            jfluid.scope_guard(jfluid.Scope()):
        jv2.init(use_gpu=False)
        out = _v2_net(jv2)
        params = jv2.parameters.create(out)
        param_file = str(tmp_path / "params.tar")
        with open(param_file, "wb") as f:
            params.to_tar(f)
        merged = j_merge.merge_v2_model(out, param_file,
                                        str(tmp_path / "deploy.tar"))
        want = jv2.infer(output_layer=out, parameters=params,
                         input=[(row,) for row in feed["x"]])
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    prog, feeds, fetches = t_merge.load_merged_model(merged, exe,
                                                     scope=scope)
    got, = exe.run(prog, feed={feeds[0]: feed["x"]}, fetch_list=fetches,
                   scope=scope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


# -- torch2paddle -----------------------------------------------------------------

def test_mlp_outputs_match():
    tnet = torch.nn.Sequential(torch.nn.Linear(13, 8), torch.nn.Tanh(),
                               torch.nn.Linear(8, 3))
    x = np.random.RandomState(0).rand(5, 13).astype(np.float32)
    with torch.no_grad():
        want = tnet(torch.from_numpy(x)).numpy()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        xv = tfluid.layers.data(name="x", shape=[5, 13], dtype="float32",
                                append_batch_size=False)
        h = tfluid.layers.fc(input=xv, size=8, act="tanh")
        out = tfluid.layers.fc(input=h, size=3, act=None)
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    written = load_torch_state(main, tnet.state_dict(), scope=scope,
                               executor=exe)
    assert len(written) == 4
    assert all(isinstance(scope.get(n), torch.Tensor) for n in written)
    got, = exe.run(main, feed={"x": x}, fetch_list=[out], scope=scope)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_conv_outputs_match():
    tconv = torch.nn.Conv2d(3, 6, kernel_size=3, padding=1)
    x = np.random.RandomState(1).rand(2, 3, 8, 8).astype(np.float32)
    with torch.no_grad():
        want = tconv(torch.from_numpy(x)).numpy()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        xv = tfluid.layers.data(name="x", shape=[2, 3, 8, 8],
                                dtype="float32", append_batch_size=False)
        out = tfluid.layers.conv2d(input=xv, num_filters=6, filter_size=3,
                                   padding=1, act=None)
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    load_torch_state(main, tconv.state_dict(), scope=scope)
    got, = exe.run(main, feed={"x": x}, fetch_list=[out], scope=scope)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_name_map_and_shape_guard():
    tnet = torch.nn.Linear(4, 2)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        xv = tfluid.layers.data(name="x", shape=[1, 4], dtype="float32",
                                append_batch_size=False)
        tfluid.layers.fc(input=xv, size=2, act=None,
                         param_attr=tfluid.ParamAttr(name="w0"),
                         bias_attr=tfluid.ParamAttr(name="b0"))
    scope = tfluid.Scope()
    written = load_torch_state(main, tnet.state_dict(), scope=scope,
                               name_map={"w0": "weight", "b0": "bias"})
    assert set(written) == {"w0", "b0"}
    assert tuple(scope.get("w0").shape) == (4, 2)   # [in, out]
    torch.testing.assert_close(scope.get("w0"),
                               tnet.weight.detach().t())
    bad = torch.nn.Linear(5, 2)
    with pytest.raises(ValueError, match="does not fit"):
        load_torch_state(main, bad.state_dict(), scope=scope,
                         name_map={"w0": "weight"})
    with pytest.raises(ValueError, match="equal counts"):
        load_torch_state(main, torch.nn.Sequential(
            tnet, torch.nn.Linear(2, 2)).state_dict(), scope=scope)


def test_state_roundtrip_via_file(tmp_path):
    tnet = torch.nn.Linear(3, 3)
    p = str(tmp_path / "m.pt")
    torch.save(tnet.state_dict(), p)
    arrs = torch_state_to_numpy(p)
    assert list(arrs) == ["weight", "bias"]
    assert arrs["weight"].shape == (3, 3)
    bn = torch.nn.BatchNorm1d(4)
    assert list(torch_state_to_numpy(bn.state_dict())) == [
        "weight", "bias", "running_mean", "running_var"]
    raw = io.BytesIO()
    torch.save(tnet.state_dict(), raw)
    assert os.path.getsize(p) > 0 and raw.tell() > 0
