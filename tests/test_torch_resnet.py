"""ResNet, bench.py's default model, built and trained through the port's
fluid layers against the JAX package's, on the CPU.

- Descs: ResNet-50 at `bench.py`'s configuration (batch 128, 224x224,
  1000 classes, `__graft_entry__._build_model`'s program: data,
  resnet50, softmax_with_cross_entropy, mean, momentum 0.9 at lr 0.01),
  main and startup, equal the JAX package's through `to_dict()`, built
  in f32 and under each package's `bf16_guard` (whose shape inference
  gives bf16 activations on both sides); so do ResNet-18's and a
  CIFAR ResNet's.  Descs only: nothing runs.
- Training: a small bottleneck ResNet from each package's own
  `models/image.py` helpers (the 7x7/2 stem and 3x3/2 max pool, one
  bottleneck per stage at widths 4, 8, 16, 32, global average pool,
  fc to 10 classes; batch 4 at 64x64).  The JAX package runs its
  startup; its scope moves into the port with `params_from_numpy`.
  3 momentum steps: each loss at atol 5e-5 and every parameter,
  velocity and batch-norm running statistic at atol 2e-4 (f32 on both
  sides; convolutions summed in other orders through 14 conv and batch
  norm layers and 3 updates of velocities up to 4; measured 1e-5 and
  6e-5).
- AMP: one step under each package's `bf16_guard`.  bf16 rounding moves
  this model's grads far: the velocities after the step (the grads)
  differ from the f32 step's by 40 % in relative L2 norm in either
  package (batch norms over 16 to 1024 values at batch 4).  So the gate
  is the loss at atol 2e-3 (measured 8e-4; the bf16 policy moves it by
  1.5e-2 from f32) and the velocities at relative L2 0.3 from the JAX
  package's bf16 step (measured 0.18; the f32 step is 0.42 from it).
- The inference clone: `clone(for_test=True)` of the forward program
  (batch norm on the running statistics the 3 steps left), logits at
  atol 2e-5.
"""

import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import image as jimage
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.models import image as timage

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

B, HW, CLASSES = 4, 64, 10
STEPS = 3
LOSS_ATOL, STATE_ATOL = 5e-5, 2e-4
AMP_LOSS_ATOL, AMP_GRAD_RL2 = 2e-3, 0.3
LOGITS_ATOL = 2e-5


def _small_resnet(m, fluid, image):
    layers = fluid.layers
    t = m._conv_bn(image, 8, 7, 2, 3)
    t = layers.pool2d(input=t, pool_size=3, pool_stride=2, pool_padding=1)
    for i, ch in enumerate([4, 8, 16, 32]):
        t = m._layer_group(m._bottleneck_block, t, ch, 1, 1 if i == 0 else 2)
    t = layers.pool2d(input=t, pool_size=7, pool_type="avg",
                      global_pooling=True)
    return layers.fc(input=t, size=CLASSES)


def _build(fluid, model, batch, hw, classes, train=True):
    """`__graft_entry__._build_model`'s program: (main, startup, logits,
    avg_loss or None)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        image = fluid.layers.data(name="image", shape=[batch, 3, hw, hw],
                                  dtype="float32", append_batch_size=False)
        logits = model(image)
        if not train:
            return main, startup, logits, None
        label = fluid.layers.data(name="label", shape=[batch, 1],
                                  dtype="int64", append_batch_size=False)
        avg_loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.MomentumOptimizer(learning_rate=0.01,
                                          momentum=0.9).minimize(avg_loss)
    return main, startup, logits, avg_loss


def _models(name):
    """(JAX model fn, port model fn, batch, size, classes)."""
    if name == "resnet50":
        return (lambda x: jimage.resnet50(x, class_dim=1000),
                lambda x: timage.resnet50(x, class_dim=1000), 128, 224, 1000)
    if name == "resnet18":
        return (lambda x: jimage.resnet(x, 1000, depth=18),
                lambda x: timage.resnet(x, 1000, depth=18), 8, 224, 1000)
    if name == "resnet_cifar10":
        return (lambda x: jimage.resnet_cifar10(x, depth=8),
                lambda x: timage.resnet_cifar10(x, depth=8), 8, 32, 10)
    return (lambda x: _small_resnet(jimage, jfluid, x),
            lambda x: _small_resnet(timage, tfluid, x), B, HW, CLASSES)


@pytest.mark.parametrize("name,amp", [
    ("resnet50", False), ("resnet50", True), ("resnet18", False),
    ("resnet_cifar10", False)])
def test_descs_equal_jax(name, amp):
    jmodel, tmodel, batch, hw, classes = _models(name)
    with jfluid.amp.bf16_guard() if amp else contextlib.nullcontext():
        jmain, jstartup, _, _ = _build(jfluid, jmodel, batch, hw, classes)
    with tfluid.amp.bf16_guard() if amp else contextlib.nullcontext():
        tmain, tstartup, _, _ = _build(tfluid, tmodel, batch, hw, classes)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    assert tstartup.desc.to_dict() == jstartup.desc.to_dict()
    if name == "resnet50":
        block = tmain.desc.block(0)
        params = [v for v in block.vars.values() if v.is_parameter]
        assert sum(int(np.prod(v.shape)) for v in params) == 25557032
        assert len(block.ops) == 532
        conv = block.vars["conv2d_0.tmp_0"]
        assert conv.shape == (128, 64, 112, 112)
        assert conv.dtype == ("bfloat16" if amp else "float32")


def _feeds(seed=0):
    rs = np.random.RandomState(seed)
    return [{"image": rs.randn(B, 3, HW, HW).astype(np.float32),
             "label": rs.randint(0, CLASSES, (B, 1)).astype(np.int64)}
            for _ in range(STEPS)]


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's small ResNet: its startup's state, the losses
    and state after 3 f32 steps, and after one bf16 step from the start,
    and the inference clone's logits on the trained state."""
    jmodel, _, _, _, _ = _models("small")
    main, startup, _, avg_loss = _build(jfluid, jmodel, B, HW, CLASSES)
    persist = [n for n, v in main.desc.block(0).vars.items()
               if v.persistable]
    exe = jfluid.Executor(jfluid.CPUPlace())
    feeds = _feeds()

    def run(steps, amp, init=None):
        scope = JScope()
        with jfluid.scope_guard(scope):
            if init is None:
                exe.run(startup)
            else:
                for n, v in init.items():
                    scope.set(n, v)
            start = {n: np.array(scope.get(n)) for n in persist}
            with jfluid.amp.bf16_guard() if amp else contextlib.nullcontext():
                losses = [float(exe.run(main, feed=f,
                                        fetch_list=[avg_loss])[0][0])
                          for f in feeds[:steps]]
            return start, losses, {n: np.array(scope.get(n))
                                   for n in persist}

    init, losses, final = run(STEPS, False)
    _, amp_losses, amp_final = run(1, True, init)
    fmain, _, logits, _ = _build(jfluid, jmodel, B, HW, CLASSES,
                                 train=False)
    infer = fmain.clone(for_test=True)
    scope = JScope()
    with jfluid.scope_guard(scope):
        for n, v in final.items():
            scope.set(n, v)
        out = exe.run(infer, feed={"image": feeds[0]["image"]},
                      fetch_list=[logits])[0]
    return {"init": init, "losses": losses, "final": final,
            "amp_losses": amp_losses, "amp_final": amp_final,
            "logits": np.asarray(out), "feeds": feeds}


def _port_run(init, steps, amp):
    _, tmodel, _, _, _ = _models("small")
    main, _, _, avg_loss = _build(tfluid, tmodel, B, HW, CLASSES)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    tio.params_from_numpy(scope, init, "cpu")
    with tfluid.amp.bf16_guard() if amp else contextlib.nullcontext():
        losses = [float(exe.run(main, feed=f, fetch_list=[avg_loss],
                                scope=scope)[0][0])
                  for f in _feeds()[:steps]]
    return losses, {n: scope.get(n).numpy() for n in init}


def test_small_resnet_three_momentum_steps_match_jax(jax_runs):
    losses, final = _port_run(jax_runs["init"], STEPS, False)
    np.testing.assert_allclose(losses, jax_runs["losses"], atol=LOSS_ATOL,
                               rtol=0)
    kinds = set()
    for name, want in jax_runs["final"].items():
        got = final[name]
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, atol=STATE_ATOL, rtol=0,
                                   err_msg=name)
        if not np.array_equal(want, jax_runs["init"][name]):
            kinds.add(name.split("_")[-2] if "velocity" in name
                      else name.split(".")[0].rstrip("_0123456789"))
    # the steps moved the parameters, velocities and running stats
    assert {"velocity", "batch_norm", "conv2d", "fc", "_generated_var"} \
        <= kinds


def _velocity_rl2(got, want):
    names = [n for n in want if n.endswith("_velocity_0")]
    diff = sum(float(((got[n] - want[n]) ** 2).sum()) for n in names)
    norm = sum(float((want[n] ** 2).sum()) for n in names)
    return (diff / norm) ** 0.5


def test_small_resnet_amp_step_matches_jax(jax_runs):
    losses, final = _port_run(jax_runs["init"], 1, True)
    assert abs(losses[0] - jax_runs["amp_losses"][0]) <= AMP_LOSS_ATOL
    assert _velocity_rl2(final, jax_runs["amp_final"]) <= AMP_GRAD_RL2
    # the policy ran: the bf16 step is not the f32 step
    f32_losses, _ = _port_run(jax_runs["init"], 1, False)
    assert abs(losses[0] - f32_losses[0]) > 10 * 1e-5
    assert all(np.isfinite(v).all() for v in final.values())
    for n, v in final.items():
        assert v.dtype == np.float32, n   # masters and state stay f32


def test_inference_clone_logits_match_jax(jax_runs):
    _, tmodel, _, _, _ = _models("small")
    main, _, logits, _ = _build(tfluid, tmodel, B, HW, CLASSES, train=False)
    infer = main.clone(for_test=True)
    bns = [op for op in infer.desc.block(0).ops if op.type == "batch_norm"]
    assert bns and all(op.attrs["is_test"] for op in bns)
    assert not any(op.attrs["is_test"] for op in main.desc.block(0).ops
                   if op.type == "batch_norm")
    scope = tfluid.Scope()
    tio.params_from_numpy(scope, jax_runs["final"], "cpu")
    before = {n: scope.get(n).clone() for n in jax_runs["final"]}
    out = tfluid.Executor(tfluid.CPUPlace()).run(
        infer, feed={"image": jax_runs["feeds"][0]["image"]},
        fetch_list=[logits], scope=scope)[0]
    assert out.shape == (B, CLASSES)
    np.testing.assert_allclose(out, jax_runs["logits"], atol=LOGITS_ATOL,
                               rtol=0)
    # the test clone leaves the running statistics as they were
    assert all(torch.equal(scope.get(n), v) for n, v in before.items())
