"""The port stands alone: no module of paddle_tpu_torch, nor
chip_smoke.py, imports jax or the paddle_tpu package; importing the
serving stack leaves jax unloaded; and the entry points refuse to run
on the CPU unless asked, raising where there is no CUDA device."""

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
                ("fluid", "evaluator.py")):
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
