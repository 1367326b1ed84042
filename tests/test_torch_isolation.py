"""The port stands alone: no module of paddle_tpu_torch, nor
chip_smoke.py, imports jax or the paddle_tpu package or aliases it in
sys.modules; importing the serving stack (or the CLIs) leaves jax
unloaded; and the entry points, the CLIs among them, refuse to run on
the CPU unless asked, raising where there is no CUDA device."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_tpu_torch")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG):
        out.extend(os.path.join(root, f) for f in files if f.endswith(".py"))
    return sorted(out)


def _forbidden(name):
    return name == "jax" or name.startswith("jax.") \
        or name == "paddle_tpu" or name.startswith("paddle_tpu.")


def test_every_port_module_is_scanned():
    rel = {os.path.relpath(p, ROOT) for p in _sources()}
    assert "chip_smoke.py" in rel
    assert os.path.join("paddle_tpu_torch", "kernels",
                        "flash_attention.py") in rel
    for new in (("core", "tensor_array.py"), ("core", "rank_table.py"),
                ("ops", "ctc.py"), ("ops", "control_flow.py"),
                ("ops", "beam.py"), ("ops", "io_ops.py"),
                ("fluid", "regularizer.py"), ("obs", "__init__.py"),
                ("obs", "trace.py"), ("obs", "registry.py"),
                ("obs", "telemetry.py"), ("fluid", "clip.py"),
                ("fluid", "lr_schedules.py"), ("fluid", "fusion.py"),
                ("fluid", "evaluator.py"), ("native.py",),
                ("ops", "dist.py"), ("analysis", "__init__.py"),
                ("analysis", "common.py"), ("analysis", "diagnostics.py"),
                ("analysis", "verifier.py"), ("distributed", "__init__.py"),
                ("distributed", "transpiler.py"),
                ("distributed", "coordinator.py"), ("tools", "__init__.py"),
                ("tools", "cluster_launch.py"),
                # the user entry points and utilities, and their ops
                ("tools", "serve_cli.py"), ("tools", "trainer_cli.py"),
                ("tools", "obs_dump.py"), ("utils", "merge_model.py"),
                ("utils", "model_diagram.py"), ("utils", "torch2paddle.py"),
                ("trainer_config_helpers", "__init__.py"),
                ("trainer_config_helpers", "config.py"),
                ("dataset", "uci_housing_provider.py"), ("ops", "nn.py"),
                # A10's last op groups and the last dataset stand-ins
                ("ops", "v2_extra.py"), ("ops", "detection.py"),
                ("dataset", "flowers.py"), ("dataset", "mq2007.py"),
                ("dataset", "sentiment.py"), ("dataset", "voc2012.py"),
                ("dataset", "wmt16.py"),
                # the program analysis, the passes and resilience
                ("analysis", "dataflow.py"), ("analysis", "lints.py"),
                ("fluid", "analysis.py"), ("compile", "__init__.py"),
                ("compile", "fingerprint.py"), ("compile", "passes.py"),
                ("compile", "opt_passes.py"),
                ("resilience", "supervisor.py"), ("tools", "chaos_cli.py"),
                ("utils", "device_peaks.py"),
                # perf and load observability, the C API and their CLIs
                ("obs", "perf.py"), ("obs", "load.py"), ("capi_impl.py",),
                ("tools", "perf_cli.py"), ("tools", "load_cli.py"),
                ("tools", "lint_cli.py"),
                # A9's collective half, first part: the mesh and what
                # needs only a mesh
                ("parallel", "__init__.py"), ("parallel", "mesh.py"),
                ("parallel", "sharding.py"), ("parallel", "collectives.py"),
                ("parallel", "trainer.py"), ("parallel", "ring.py"),
                ("parallel", "pipeline.py"), ("parallel", "moe.py"),
                ("parallel", "optim.py"), ("parallel", "program_api.py"),
                ("models", "transformer.py"),
                ("fluid", "layers", "device.py"),
                # A9's second part, first slice: the sharding analyzer,
                # the plan-driven trainer and the comm observability
                ("analysis", "shard.py"), ("analysis", "costmodel.py"),
                ("spmd", "__init__.py"), ("spmd", "plan.py"),
                ("spmd", "overlap.py"), ("spmd", "trainer.py"),
                ("obs", "comm.py"), ("obs", "fleet.py"),
                ("tools", "shard_cli.py"),
                # A9's checkpoint-and-fleet slice: sharded checkpoints,
                # the bench legs, elasticity and their CLIs
                ("spmd", "checkpoint.py"), ("spmd", "bench.py"),
                ("resilience", "elastic.py"), ("distributed", "ranks.py"),
                ("tools", "comm_cli.py"), ("tools", "fleet_cli.py"),
                ("tools", "elastic_cli.py"),
                # A9's last part: the autotuner and its CLI
                ("tune", "__init__.py"), ("tune", "models.py"),
                ("tune", "space.py"), ("tune", "rank.py"),
                ("tune", "measure.py"), ("tune", "fit.py"),
                ("tune", "leg.py"), ("tools", "tune_cli.py"),
                # A2's second part: the persistent plan cache and memory
                # observability, with their CLIs
                ("compile", "pcache.py"), ("obs", "mem.py"),
                ("tools", "pcache_cli.py"), ("tools", "mem_cli.py")):
        assert os.path.join("paddle_tpu_torch", *new) in rel
    v2 = sorted(os.path.basename(p) for p in rel
                if os.path.dirname(p) == os.path.join("paddle_tpu_torch",
                                                      "v2"))
    jax_v2 = sorted(f for f in os.listdir(os.path.join(ROOT, "paddle_tpu",
                                                       "v2"))
                    if f.endswith(".py"))
    assert v2 == jax_v2 and len(v2) == 17
    assert len(rel) >= 25


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_paddle_tpu_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
            elif node.module is None:
                bad += [a.name for a in node.names if _forbidden(a.name)]
    assert not bad, "%s imports %s" % (path, bad)


def _aliases_paddle_tpu(node):
    """An assignment into sys.modules (or a sys.modules.setdefault or
    update call) whose key names the JAX package."""
    def names_it(expr):
        return any(isinstance(c, ast.Constant) and isinstance(c.value, str)
                   and _forbidden(c.value) for c in ast.walk(expr))

    def is_sys_modules(expr):
        return (isinstance(expr, ast.Attribute) and expr.attr == "modules"
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "sys")

    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        return any(isinstance(t, ast.Subscript) and is_sys_modules(t.value)
                   and names_it(t.slice) for t in targets)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        return (node.func.attr in ("setdefault", "update", "__setitem__")
                and is_sys_modules(node.func.value)
                and any(names_it(a) for a in node.args))
    return False


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_sys_modules_alias_for_the_jax_package(path):
    """No module puts a `paddle_tpu` name into sys.modules: a config or
    script written for the port imports `paddle_tpu_torch` itself."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [getattr(n, "lineno", "?") for n in ast.walk(tree)
           if _aliases_paddle_tpu(n)]
    assert not bad, "%s aliases the JAX package at lines %s" % (path, bad)


def test_cli_stack_import_leaves_jax_unloaded():
    """The CLIs, the config DSL, the provider and the utilities."""
    code = ("import sys, paddle_tpu_torch.tools.serve_cli, "
            "paddle_tpu_torch.tools.trainer_cli, "
            "paddle_tpu_torch.tools.obs_dump, "
            "paddle_tpu_torch.tools.pcache_cli, "
            "paddle_tpu_torch.tools.mem_cli, "
            "paddle_tpu_torch.trainer_config_helpers, "
            "paddle_tpu_torch.dataset.uci_housing_provider, "
            "paddle_tpu_torch.utils.merge_model, "
            "paddle_tpu_torch.utils.model_diagram, "
            "paddle_tpu_torch.utils.torch2paddle; "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu'))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_clis_refuse_the_cpu_unless_asked(tmp_path):
    """serve_cli, trainer_cli and the perf, load and lint CLIs run on
    CUDAPlace(0) unless given --use_gpu=0: without a CUDA device they
    raise naming CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default place is valid")
    from paddle_tpu_torch.tools import (lint_cli, load_cli, perf_cli,
                                        serve_cli, trainer_cli)

    from paddle_tpu_torch.tools import mem_cli, pcache_cli

    for cli in (perf_cli, load_cli, lint_cli, pcache_cli, mem_cli):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--selftest"])
        assert cli.parse_args(["--use_gpu=0"]).use_gpu is False
        assert cli.parse_args([]).use_gpu is True

    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["--selftest"])
    config = tmp_path / "conf.py"
    with open(os.path.join(ROOT, "examples",
                           "trainer_config_fit_a_line.py")) as f:
        config.write_text(f.read().replace("paddle_tpu.",
                                           "paddle_tpu_torch."))
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer_cli.main(["--config=%s" % config, "--num_passes=1"])
    for bad in ("2", "maybe"):
        with pytest.raises(SystemExit):
            serve_cli.parse_args(["--use_gpu=%s" % bad])
    assert serve_cli.parse_args(["--use_gpu=0"]).use_gpu is False
    assert trainer_cli.parse_args(["--config=c", "--use_gpu=false"]) \
        .use_gpu is False
    assert trainer_cli.parse_args(["--config=c"]).use_gpu is True


def test_tune_import_leaves_jax_unloaded():
    """The autotuner, its measurement leg and its CLI."""
    code = ("import sys, paddle_tpu_torch.tune, "
            "paddle_tpu_torch.tune.leg, "
            "paddle_tpu_torch.tools.tune_cli; "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu'))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_perf_load_capi_import_leaves_jax_unloaded():
    """The step profiler and gate, the load generator, the C API's
    Python side and the perf, load and lint CLIs."""
    code = ("import sys, paddle_tpu_torch.obs.perf, "
            "paddle_tpu_torch.obs.load, paddle_tpu_torch.capi_impl, "
            "paddle_tpu_torch.tools.perf_cli, "
            "paddle_tpu_torch.tools.load_cli, "
            "paddle_tpu_torch.tools.lint_cli; "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu'))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_checkpoint_fleet_elastic_import_leaves_jax_unloaded():
    """The sharded checkpoints, the bench legs, the fleet, elasticity
    and the comm, fleet and elastic CLIs."""
    code = ("import sys, paddle_tpu_torch.spmd.checkpoint, "
            "paddle_tpu_torch.spmd.bench, paddle_tpu_torch.obs.fleet, "
            "paddle_tpu_torch.resilience.elastic, "
            "paddle_tpu_torch.distributed.ranks, "
            "paddle_tpu_torch.tools.comm_cli, "
            "paddle_tpu_torch.tools.fleet_cli, "
            "paddle_tpu_torch.tools.elastic_cli; "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu'))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_comm_cli_and_bench_refuse_the_cpu_unless_asked():
    """`comm_cli report`, `spmd.bench.run_leg` and the elastic worker's
    trainer run on the card unless asked for the CPU: without a CUDA
    device their mesh raises naming CUDA, and no group is left up."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default place is valid")
    from paddle_tpu_torch.resilience.elastic import ElasticTrainer
    from paddle_tpu_torch.spmd import bench
    from paddle_tpu_torch.tools import comm_cli, elastic_cli

    with pytest.raises(RuntimeError, match="CUDA"):
        comm_cli.main(["report"])
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run_leg(mesh_spec="dp=1")
    assert ElasticTrainer(None, None, "/x").device == "cuda"
    for cli in (comm_cli, elastic_cli):
        assert cli.parse_args(["--use_gpu=0"]).use_gpu is False
        assert cli.parse_args([]).use_gpu is True


def test_serving_import_leaves_jax_unloaded():
    code = ("import sys, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.models.transformer_program; "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu'))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_training_stack_import_leaves_jax_unloaded():
    """The image slice's modules: feeding, readers, datasets,
    checkpoints, fault injection, the image models."""
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.fluid, "
            "paddle_tpu_torch.fluid.checkpoint, paddle_tpu_torch.models, "
            "paddle_tpu_torch.reader, paddle_tpu_torch.dataset, "
            "paddle_tpu_torch.resilience, paddle_tpu_torch.ops.metrics; "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu'))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_v2_import_leaves_jax_unloaded():
    """The v2 API, its trainer's obs copies and the top-level names."""
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.v2, "
            "paddle_tpu_torch.obs; "
            "from paddle_tpu_torch import layer, infer, v2; "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu'))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_pserver_stack_import_leaves_jax_unloaded():
    """The parameter-server path: the native bindings, the transpiler,
    the coordinator, the launcher, the analysis and the readers over
    the runtime."""
    code = ("import sys, paddle_tpu_torch.native, "
            "paddle_tpu_torch.distributed, paddle_tpu_torch.analysis, "
            "paddle_tpu_torch.tools.cluster_launch, "
            "paddle_tpu_torch.reader.creator, paddle_tpu_torch.ops.dist; "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu'))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_tf32_is_off_after_import():
    import paddle_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_default_place_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default place is valid")
    from paddle_tpu_torch.fluid import CUDAPlace, Executor
    from paddle_tpu_torch.models.transformer_program import (
        build_transformer_inference_program, logits_name)
    from paddle_tpu_torch.serving import InferenceEngine

    with pytest.raises(RuntimeError, match="CUDA"):
        Executor()
    with pytest.raises(RuntimeError, match="CUDA"):
        Executor(CUDAPlace(0))
    prog = build_transformer_inference_program(2, 4, 8, n_layer=1,
                                               n_head=1, d_model=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(prog, ["tokens", "positions"], [logits_name(1)])
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine.from_saved_model(str(tmp_path))


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, os.path.join(ROOT,
                                                       "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
