"""The port's user entry points against the JAX package's, on the CPU
(`--use_gpu=0`): the inference server CLI (`tools/serve_cli.py`), the
paddle_trainer-style CLI over `trainer_config_helpers`
(`tools/trainer_cli.py`), the observability selftest
(`tools/obs_dump.py --selftest`) and the `latency` fault kind at the
`serving/run` point it uses.

- serve_cli: the selftest is green; one export (the JAX package's
  selftest classifier) served by both CLIs' servers answers the
  selftest's request with the same probabilities (atol 1e-6: f32 on
  both sides, other BLAS) and the same reply keys, and both /metrics
  expositions carry the same serving families with the same counts; the
  port's CLI as a process serves the export, answers, and drains on
  SIGTERM with exit 0, as the JAX CLI does on the same export.
- trainer_cli: examples/trainer_config_fit_a_line.py (its text with
  `paddle_tpu.` made `paddle_tpu_torch.`) for 2 passes from one
  parameters tar (the JAX v2 `Parameters.to_tar`) through both CLIs:
  each pass's average and test cost within 1e-5 relative, the saved
  pass-0000N tars within 1e-5 of each other (f32 Momentum over 21
  batches a pass, sums in other orders); the tests/test_trainer_cli.py
  flow (the cost falls, a warm start resumes below the cold first
  pass).
- obs_dump: the port's selftest with --use_gpu=0 exits 0 and prints
  its green line.
- faults: a `latency` fault sleeps and counts as the JAX kind does, at
  the engine's `serving/run` point; an unknown kind is refused.
"""

import io
import json
import os
import re
import signal
import subprocess
import sys
import tarfile
import time
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.v2 as jv2
from paddle_tpu.resilience import faults as j_faults
from paddle_tpu.serving import InferenceEngine as JEngine
from paddle_tpu.tools import serve_cli as j_serve
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.obs import registry as t_registry
from paddle_tpu_torch.obs import telemetry as t_tele
from paddle_tpu_torch.resilience import faults as t_faults
from paddle_tpu_torch.serving import InferenceEngine as TEngine
from paddle_tpu_torch.tools import serve_cli as t_serve
from paddle_tpu_torch.tools import trainer_cli as t_trainer

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "trainer_config_fit_a_line.py")
CLI_TIMEOUT = 300
REQUEST = {"inputs": {"img": [[0.1] * 16, [0.9] * 16]}}


def _env():
    return dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")


# -- serve_cli -------------------------------------------------------------------

def test_serve_selftest_is_green(capsys):
    assert t_serve.main(["--selftest", "--use_gpu=0"]) == 0
    out = capsys.readouterr().out
    assert "[serve] selftest green: 1 request served on CPUPlace()" in out


@pytest.fixture
def jax_export(tmp_path):
    """The JAX CLI's selftest classifier, exported by the JAX package."""
    return j_serve._selftest_model(str(tmp_path / "export"))


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read().decode()


def _serving_samples(text):
    """{sample: value} of the serving_* samples of an exposition that
    depend on what was served, not on how long it took."""
    out = {}
    for line in text.splitlines():
        if not line.startswith("serving_") or "seconds" in line:
            continue
        body, _, value = line.rpartition(" ")
        out[body] = float(value)
    return out


def test_one_export_served_by_both_clis_alike(jax_export):
    replies, metrics = [], []
    for mod, engine_cls in ((j_serve, JEngine), (t_serve, TEngine)):
        args = mod.parse_args(["--port=0", "--model_dir=" + jax_export]
                              + (["--use_gpu=0"] if mod is t_serve else []))
        kw = {"place": tfluid.CPUPlace()} if mod is t_serve else {}
        engine = engine_cls.from_saved_model(
            jax_export, config=mod._engine_config(args), **kw)
        server = mod._serve(engine, args)
        host, port = server.address
        try:
            status, body = _post("http://%s:%d/v1/infer" % (host, port),
                                 REQUEST)
            text = _get("http://%s:%d/metrics" % (host, port))
        finally:
            server.shutdown()
        assert status == 200
        replies.append(body)
        metrics.append(_serving_samples(text))
    (jbody, tbody), (jm, tm) = replies, metrics
    assert set(tbody) == set(jbody)
    assert list(tbody["outputs"]) == list(jbody["outputs"])
    for name, probs in jbody["outputs"].items():
        got = np.asarray(tbody["outputs"][name])
        assert got.shape == (2, 4)
        np.testing.assert_allclose(got, np.asarray(probs), atol=1e-6,
                                   rtol=0)
    assert tm["serving_responses_total"] == jm["serving_responses_total"] \
        == 1
    assert set(tm) == set(jm)
    for key in ("serving_requests_total", "serving_errors_total",
                "serving_batch_occupancy_count"):
        assert tm[key] == jm[key], key


def _serve_process(module, model_dir):
    """The CLI `module` as a process serving `model_dir` on an ephemeral
    port; (process, base url)."""
    cmd = [sys.executable, "-m", module, "--model_dir=" + model_dir,
           "--port=0"]
    if module.startswith("paddle_tpu_torch"):
        cmd.append("--use_gpu=0")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    deadline = time.time() + CLI_TIMEOUT
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        m = re.search(r"listening on (http://[\d.]+:\d+)", line)
        if m:
            return proc, m.group(1)
    proc.kill()
    raise AssertionError("%s did not start: %s" % (module,
                                                   proc.stderr.read()))


def test_clis_serve_and_drain_on_sigterm(jax_export):
    """Each CLI as its own process: one request answered, then SIGTERM
    drains it and it exits 0; the two answers agree."""
    outs = []
    for module in ("paddle_tpu.tools.serve_cli",
                   "paddle_tpu_torch.tools.serve_cli"):
        proc, url = _serve_process(module, jax_export)
        try:
            status, body = _post(url + "/v1/infer", REQUEST)
            assert status == 200
            outs.append(body["outputs"])
        finally:
            proc.send_signal(signal.SIGTERM)
            rest, err = proc.communicate(timeout=CLI_TIMEOUT)
        assert proc.returncode == 0, err[-2000:]
        assert "draining" in rest and "drained, bye" in rest, rest
    (name, jprobs), = outs[0].items()
    np.testing.assert_allclose(np.asarray(outs[1][name]),
                               np.asarray(jprobs), atol=1e-6, rtol=0)


# -- trainer_cli -------------------------------------------------------------------

def _port_config(tmp_path):
    path = tmp_path / "trainer_config_fit_a_line.py"
    with open(EXAMPLE) as f:
        path.write_text(f.read().replace("paddle_tpu.", "paddle_tpu_torch."))
    return str(path)


def _init_tar(path):
    """A parameters tar of the example's topology from the JAX v2
    Parameters, its values from a numpy seed."""
    with jfluid.program_guard(jfluid.Program(), jfluid.Program()), \
            jfluid.scope_guard(jfluid.Scope()):
        jv2.init(use_gpu=False)
        x = jv2.layer.data(name="x", type=jv2.data_type.dense_vector(13))
        pred = jv2.layer.fc(input=x, size=1,
                            act=jv2.activation.Linear())
        y = jv2.layer.data(name="y", type=jv2.data_type.dense_vector(1))
        cost = jv2.layer.mse_cost(input=pred, label=y)
        params = jv2.parameters.create(cost)
        rs = np.random.RandomState(16)
        for name in params.keys():
            params.set(name, (rs.randn(*params.get_shape(name)) * 0.1)
                       .astype(np.float32))
        with open(path, "wb") as f:
            params.to_tar(f)
    return path


def _costs(stdout):
    return [tuple(float(v) for v in re.findall(r"Cost ([-\d.e+]+)", line))
            for line in stdout.splitlines() if "AvgCost" in line]


def _tar_arrays(path):
    out = {}
    with tarfile.open(path) as tar:
        for m in tar.getmembers():
            if m.name.endswith(".npy"):
                out[m.name[:-4]] = np.load(io.BytesIO(
                    tar.extractfile(m).read()))
    return out


def test_trainer_clis_agree_from_one_init_tar(tmp_path, capsys):
    init = _init_tar(str(tmp_path / "init.tar"))
    jdir, tdir = str(tmp_path / "jax_out"), str(tmp_path / "port_out")
    jrun = subprocess.run(
        [sys.executable, "-m", "paddle_tpu.tools.trainer_cli",
         "--config=" + EXAMPLE, "--num_passes=2", "--save_dir=" + jdir,
         "--init_model_path=" + init, "--log_period=100"],
        cwd=ROOT, env=_env(), capture_output=True, text=True,
        timeout=CLI_TIMEOUT)
    assert jrun.returncode == 0, jrun.stderr[-2000:]
    assert t_trainer.main(["--config=" + _port_config(tmp_path),
                           "--num_passes=2", "--save_dir=" + tdir,
                           "--init_model_path=" + init,
                           "--log_period=100", "--use_gpu=0"]) == 0
    jcosts, tcosts = _costs(jrun.stdout), _costs(capsys.readouterr().out)
    assert len(jcosts) == len(tcosts) == 2
    np.testing.assert_allclose(np.asarray(tcosts), np.asarray(jcosts),
                               rtol=1e-5)
    for p in ("pass-00000", "pass-00001"):
        ja = _tar_arrays(os.path.join(jdir, p, "params.tar"))
        ta = _tar_arrays(os.path.join(tdir, p, "params.tar"))
        assert set(ta) == set(ja) == {"fc_0.w_0", "fc_0.w_1"}
        for name in ja:
            np.testing.assert_allclose(ta[name], ja[name], rtol=1e-5,
                                       atol=1e-6, err_msg=name)


def test_trainer_cli_flow_and_warm_start(tmp_path, capsys):
    """tests/test_trainer_cli.py's flow through the port's CLI."""
    config, out = _port_config(tmp_path), str(tmp_path / "output")
    assert t_trainer.main(["--config=" + config, "--num_passes=2",
                           "--save_dir=" + out, "--log_period=50",
                           "--use_gpu=0"]) == 0
    costs = [c[0] for c in _costs(capsys.readouterr().out)]
    assert len(costs) == 2 and costs[1] < costs[0]
    tar1 = os.path.join(out, "pass-00001", "params.tar")
    assert os.path.exists(os.path.join(out, "pass-00000", "params.tar"))
    assert t_trainer.main(["--config=" + config, "--num_passes=1",
                           "--init_model_path=" + tar1, "--start_pass=2",
                           "--log_period=50", "--use_gpu=0"]) == 0
    text = capsys.readouterr().out
    warm = [c[0] for c in _costs(text)]
    assert warm and warm[0] < costs[0] and "Pass 2" in text


def test_trainer_cli_refuses_a_config_without_outputs(tmp_path):
    bare = tmp_path / "bare.py"
    bare.write_text("from paddle_tpu_torch.trainer_config_helpers import "
                    "*  # noqa\nsettings(batch_size=4)\n")
    with pytest.raises(SystemExit, match="no outputs"):
        t_trainer.main(["--config=%s" % bare, "--use_gpu=0"])


# -- obs_dump -------------------------------------------------------------------

def test_obs_selftest_is_green_on_the_cpu():
    run = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.obs_dump",
         "--selftest", "--use_gpu=0"], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=CLI_TIMEOUT)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "[obs] selftest green on CPUPlace()" in run.stdout
    assert "first nonfinite op 'mul'" in run.stdout


# -- faults -----------------------------------------------------------------------

def test_latency_fault_sleeps_and_counts_as_jax_does():
    t_registry.reset_registry()
    fired = []
    for faults in (j_faults, t_faults):
        plan = faults.enable(seed=0)
        spec = plan.inject("serving/run", "latency", latency_s=0.05,
                           after=1, times=1)
        try:
            assert faults.check("serving/run") is None
            t0 = time.perf_counter()
            assert faults.check("serving/run", batch=2) is spec
            assert time.perf_counter() - t0 >= 0.05
            assert faults.check("serving/run") is None
            fired.append(faults.fired_counts())
        finally:
            faults.disable()
    assert fired[0] == fired[1] == {("serving/run", "latency"): 1}
    counts = {k: v for k, v in t_tele.snapshot().items()
              if k.startswith("faults_injected_total{")}
    assert list(counts.values()) == [1]
    assert "point=serving/run" in next(iter(counts)) \
        and "kind=latency" in next(iter(counts))
    with pytest.raises(ValueError, match="unknown fault kind"):
        t_faults.FaultSpec("serving/run", "no_such_kind")
    t_registry.reset_registry()


def test_serving_run_point_slows_the_engine(jax_export):
    engine = TEngine.from_saved_model(jax_export, place=tfluid.CPUPlace())
    feeds = {"img": np.full((2, 16), 0.5, np.float32)}
    engine.run(feeds)
    plan = t_faults.enable()
    plan.inject("serving/run", "latency", latency_s=0.2)
    try:
        t0 = time.perf_counter()
        engine.run(feeds)
        slow = time.perf_counter() - t0
    finally:
        t_faults.disable()
    assert slow >= 0.2
    plan = t_faults.enable()
    plan.inject("serving/run", "io_error")
    try:
        with pytest.raises(t_faults.InjectedIOError):
            engine.run(feeds)
    finally:
        t_faults.disable()
