"""The training slice as a whole: the transformer's training step in the
port against the JAX package's, on the CPU.

The JAX package builds the program (batch 4, seq 32, vocab 64, 2
layers, 4 heads, d_model 32, momentum 0.9 at lr 0.01, the program
`bench.py` trains at full width) and runs its startup; its scope (the
parameters, the velocities and `learning_rate_0`) moves into the port
with `params_from_numpy`.  The port builds its own descs.  Both take 3
momentum steps on the same feeds.  Tolerance: each step's loss, and
every parameter and velocity after step 3, at atol 1e-5 (f32 on both
sides; the same sums in other orders through 2 layers and 3 updates).

The same 3 steps under the bf16 policy (`bench.py`'s default
`BENCH_AMP=1`), the program built and run under each package's
`bf16_guard()`: each loss at atol 1e-3 (observed 4.3e-4: bf16 products
rounded after f32 sums in other orders), and each parameter's and
velocity's change over the steps within 0.1 of the JAX package's in
relative L2 (observed 0.042).

Also here: the port's `uniform_random` (statistics, and the same values
from the same seed), and what the executor does for training: startup
and optimizer outputs written back to the scope, fetches of state the
run did not write, no inference tensors in a trained scope.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models.transformer_program import (
    build_transformer_program as j_build, transformer_program_feeds)
from paddle_tpu_torch.core.desc import OpDesc, ProgramDesc, VarDesc
from paddle_tpu_torch.fluid import (CPUPlace, Executor, MomentumOptimizer,
                                    Scope, io)
from paddle_tpu_torch.models.transformer_program import (
    build_transformer_inference_program, build_transformer_program,
    logits_name, transformer_feeds)

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

B, T, V, N_LAYER, N_HEAD, D = 4, 32, 64, 2, 4, 32
ATOL = 1e-5
STEPS = 3
AMP_LOSS_ATOL = 1e-3
AMP_CHANGE_RL2 = 0.1


def _port_program():
    main, startup, loss, _ = build_transformer_program(
        B, T, V, n_layer=N_LAYER, n_head=N_HEAD, d_model=D)
    MomentumOptimizer(0.01, 0.9).minimize(loss, main, startup)
    return main, startup, loss


@pytest.fixture(scope="module")
def jax_run():
    """(initial scope as numpy, per-step losses, final scope as numpy,
    the feeds) of 3 JAX momentum steps."""
    main, startup, avg_loss, _ = j_build(B, T, V, n_layer=N_LAYER,
                                         n_head=N_HEAD, d_model=D)
    with jfluid.program_guard(main, startup):
        jfluid.optimizer.MomentumOptimizer(
            learning_rate=0.01, momentum=0.9).minimize(avg_loss)
    persist = [n for n, v in main.desc.block(0).vars.items()
               if v.persistable]
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = JScope()
    feeds = [transformer_program_feeds(B, T, V, seed=s)
             for s in range(STEPS)]
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.array(scope.get(n)) for n in persist}
        losses = [float(exe.run(main, feed=f, fetch_list=[avg_loss])[0][0])
                  for f in feeds]
        final = {n: np.array(scope.get(n)) for n in persist}
    return init, losses, final, feeds


def test_three_momentum_steps_match_jax(jax_run):
    init, jlosses, jfinal, feeds = jax_run
    main, _, loss = _port_program()
    assert {n for n, v in main.block(0).vars.items() if v.persistable} \
        == set(init)
    assert any(n.endswith("_velocity_0") for n in init) \
        and "learning_rate_0" in init
    exe = Executor(CPUPlace())
    scope = Scope()
    io.params_from_numpy(scope, init, "cpu")
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0][0]) for f in feeds]
    np.testing.assert_allclose(losses, jlosses, atol=ATOL, rtol=0)
    for name, want in jfinal.items():
        got = scope.get(name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=name)
        if name.endswith("_velocity_0"):
            assert np.abs(got).max() > 0, name   # the steps reached it


def test_three_amp_momentum_steps_match_jax():
    with jfluid.amp.bf16_guard():
        jmain, jstartup, jloss, _ = j_build(B, T, V, n_layer=N_LAYER,
                                            n_head=N_HEAD, d_model=D)
        with jfluid.program_guard(jmain, jstartup):
            jfluid.optimizer.MomentumOptimizer(
                learning_rate=0.01, momentum=0.9).minimize(jloss)
    persist = [n for n, v in jmain.desc.block(0).vars.items()
               if v.persistable]
    feeds = [transformer_program_feeds(B, T, V, seed=s)
             for s in range(STEPS)]
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    with jfluid.scope_guard(scope), jfluid.amp.bf16_guard():
        exe.run(jstartup)
        init = {n: np.array(scope.get(n)) for n in persist}
        jlosses = [float(exe.run(jmain, feed=f, fetch_list=[jloss])[0][0])
                   for f in feeds]
        jfinal = {n: np.array(scope.get(n)) for n in persist}
    # the policy declares bf16 state, which the first update makes f32
    assert any(v.dtype.name == "bfloat16" for v in init.values())

    with tfluid.amp.bf16_guard():
        main, startup, loss, _ = build_transformer_program(
            B, T, V, n_layer=N_LAYER, n_head=N_HEAD, d_model=D)
        MomentumOptimizer(0.01, 0.9).minimize(loss, main, startup)
    assert main.to_dict() == jmain.desc.to_dict()
    exe, tscope = Executor(CPUPlace()), Scope()
    io.params_from_numpy(tscope, init, "cpu")
    with tfluid.amp.bf16_guard():
        losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=tscope)[0][0]) for f in feeds]
    np.testing.assert_allclose(losses, jlosses, atol=AMP_LOSS_ATOL, rtol=0)
    for name, want in jfinal.items():
        got = tscope.get(name)
        assert str(got.dtype).replace("torch.", "") == want.dtype.name, name
        got = got.float().numpy().astype(np.float64)
        want = want.astype(np.float64)
        change = np.linalg.norm(want - init[name].astype(np.float64))
        assert np.linalg.norm(got - want) <= AMP_CHANGE_RL2 * max(
            change, 1e-30), name


def test_port_feeds_match_jax_feeds():
    for seed in range(2):
        want = transformer_program_feeds(B, T, V, seed=seed)
        got = transformer_feeds(B, T, V, seed=seed, targets=True)
        assert set(got) == set(want)
        for n in want:
            np.testing.assert_array_equal(got[n], want[n])


def test_port_startup_and_training_on_its_own():
    main, startup, loss = _port_program()
    exe = Executor(CPUPlace())
    scope = Scope()
    exe.run(startup, scope=scope)
    persist = {n for n, v in main.block(0).vars.items() if v.persistable}
    assert {n for n in persist if scope.get(n) is not None} == persist
    w = scope.get("fc_0.w_0")
    limit = np.sqrt(6.0 / (D + 3 * D))
    assert tuple(w.shape) == (D, 3 * D) and w.dtype == torch.float32
    assert float(w.abs().max()) <= limit
    assert not scope.get("fc_0.w_1").any()
    assert torch.equal(scope.get("layer_norm_0.w_0"), torch.ones(D))
    assert torch.equal(scope.get("learning_rate_0"),
                       torch.tensor([0.01]))
    # the same batch, stepped on: the loss falls; the state the steps
    # wrote is in the scope; a fetch the run did not write comes from it
    feed = transformer_feeds(B, T, V, seed=0, targets=True)
    losses = []
    for _ in range(5):
        out, lr = exe.run(main, feed=feed, fetch_list=[loss,
                                                       "learning_rate_0"],
                          scope=scope)
        losses.append(float(out[0]))
        assert lr.tolist() == [np.float32(0.01)]
    assert losses[-1] < losses[0]
    assert not torch.equal(scope.get("fc_0.w_0"), w)
    assert scope.get("fc_0.w_0_velocity_0").abs().max() > 0
    # the trained scope holds no inference tensors: a later step can
    # save them for its backward
    assert not any(scope.get(n).is_inference() for n in persist)


def test_forward_only_program_runs_in_inference_mode():
    prog = build_transformer_inference_program(B, T, V, n_layer=N_LAYER,
                                               n_head=N_HEAD, d_model=D)
    main, startup, _ = _port_program()
    exe = Executor(CPUPlace())
    scope = Scope()
    exe.run(startup, scope=scope)
    out = exe.run(prog, feed=transformer_feeds(B, T, V), scope=scope,
                  fetch_list=[logits_name(N_LAYER)], return_numpy=False)[0]
    assert out.is_inference() and tuple(out.shape) == (B, T, V)


def _uniform_program(shape, lo, hi, seed, n=1):
    prog = ProgramDesc()
    block = prog.block(0)
    for i in range(n):
        name = "w%d" % i
        block.vars[name] = VarDesc(name, shape=shape, persistable=True)
        block.ops.append(OpDesc(
            "uniform_random", {}, {"Out": [name]},
            {"shape": list(shape), "dtype": "float32", "min": lo,
             "max": hi, "seed": seed}))
    return prog


def test_uniform_random_statistics():
    lo, hi = -0.25, 0.75
    scope = Scope()
    Executor(CPUPlace()).run(_uniform_program([256, 256], lo, hi, 0),
                             scope=scope)
    w = scope.get("w0")
    assert tuple(w.shape) == (256, 256) and w.dtype == torch.float32
    assert float(w.min()) >= lo and float(w.max()) <= hi
    # 65536 draws: the mean's standard error is (hi-lo)/sqrt(12*65536)
    assert abs(float(w.mean()) - (lo + hi) / 2) < 5 * (hi - lo) / np.sqrt(
        12 * w.numel())
    assert abs(float(w.std()) - (hi - lo) / np.sqrt(12)) < 0.01
    assert float(w.min()) < lo + 0.01 and float(w.max()) > hi - 0.01


def test_uniform_random_seeding():
    def draw(seed, exe_seed=0, n=2):
        scope = Scope()
        Executor(CPUPlace(), seed=exe_seed).run(
            _uniform_program([8, 8], -1.0, 1.0, seed, n), scope=scope)
        return [scope.get("w%d" % i) for i in range(n)]

    # from the executor's stream: reproducible, advancing op by op
    a0, a1 = draw(0)
    b0, b1 = draw(0)
    assert torch.equal(a0, b0) and torch.equal(a1, b1)
    assert not torch.equal(a0, a1)
    assert not torch.equal(draw(0, exe_seed=1)[0], a0)
    # an op's own seed: the same values every time, whatever the stream
    c0, c1 = draw(7)
    assert torch.equal(c0, c1)
    assert torch.equal(draw(7, exe_seed=3)[0], c0)
