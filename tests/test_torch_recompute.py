"""The port's memory passes and the executor's release at the last
reader, against the JAX package's on the CPU.

- `fluid.recompute` (tests/test_recompute.py's cases): the rewritten
  program's `to_dict()` equals the JAX rewrite's; a barrier in the
  rewrite and grad ops reading the `@RCP` clones; training the
  rewritten program in the port equals the plain program bit for bit,
  and the JAX package's training within rtol 1e-5 from one initial
  state; `RecomputeOptimizer` in both its forms; RNG ops never cloned.
- The rewrite reaches the executor (the port's counterpart of the JAX
  test that finds the clones behind optimization barriers in the
  lowered HLO): on a 12-deep 512-wide chain the rewritten program runs
  more products, and the most bytes its run holds at once fall.
- `recompute_barrier`: `Out` is `X` itself, the `Trigger` read and
  dropped; stop-gradient and capturable; both registries hold 213 op
  types.
- `memory_optimize` (tests/test_memory_optimize_and_plot.py's cases):
  the report-only liveness and the rewrite's renames and `to_dict()`
  equal the JAX package's; the rewritten program trains to the plain
  program's bits.
- Release at the last reader: after every op of a run (eager, the
  warm-up, the capture's plain version and a replay) the executor's
  values hold no name past its last reader (fetches and persistables
  stay), and the fetches equal a `FunctionalProgram`'s, which releases
  nothing, bit for bit.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.recompute import recompute_program as jrecompute
from paddle_tpu.ops import registry as jregistry

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.analysis.dataflow import Liveness
from paddle_tpu_torch.fluid import executor as texec
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.fluid.recompute import recompute_program
from paddle_tpu_torch.jit import FunctionalProgram
from paddle_tpu_torch.ops import registry as tregistry

torch.set_num_threads(1)

CPU = tfluid.CPUPlace()


def _build_mlp(fl, depth=6, width=64, checkpoint_every=2, dropout=False):
    main, startup = fl.Program(), fl.Program()
    ckpts = []
    with fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[width], dtype="float32")
        y = fl.layers.data(name="y", shape=[1], dtype="int64")
        t = x
        for i in range(depth):
            t = fl.layers.fc(input=t, size=width, act="relu")
            if dropout and i == depth // 2:
                t = fl.layers.dropout(t, dropout_prob=0.3)
            if (i + 1) % checkpoint_every == 0:
                ckpts.append(t)
        logits = fl.layers.fc(input=t, size=10, act="softmax")
        loss = fl.layers.mean(
            x=fl.layers.cross_entropy(input=logits, label=y))
    return main, startup, loss, ckpts


def _feeds(seed=0):
    rs = np.random.RandomState(seed)
    return {"x": rs.rand(16, 64).astype("float32"),
            "y": rs.randint(0, 10, (16, 1)).astype("int64")}


def _jax_init(startup):
    """The JAX startup's state, as numpy arrays."""
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    return {n: np.array(scope.get(n))
            for n, v in startup.global_block().vars.items()
            if v.persistable and scope.get(n) is not None}


def _jax_train(main, loss, init, steps=5):
    import jax.numpy as jnp

    scope = jfluid.Scope()
    for n, v in init.items():
        scope.set(n, jnp.asarray(v))
    exe = jfluid.Executor(jfluid.CPUPlace())
    return [float(np.asarray(exe.run(main, feed=_feeds(), fetch_list=[loss],
                                     scope=scope)[0]).reshape(-1)[0])
            for _ in range(steps)]


def _train(main, loss, init, steps=5, feed=None):
    """(losses, final state) of `steps` port steps from `init`."""
    scope = tfluid.Scope()
    tio.params_from_numpy(scope, init, "cpu")
    exe = tfluid.Executor(CPU)
    losses = [exe.run(main, feed=feed or _feeds(), fetch_list=[loss],
                      scope=scope)[0] for _ in range(steps)]
    return losses, {n: scope.get(n).numpy().copy() for n in init}


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _momentum_pair(**kw):
    """The MLP with Momentum in both packages: [(main, startup, loss,
    ckpts)] for (port, JAX)."""
    out = []
    for fl in (tfluid, jfluid):
        main, startup, loss, ckpts = _build_mlp(fl, **kw)
        with fl.program_guard(main, startup):
            fl.optimizer.MomentumOptimizer(
                learning_rate=0.1, momentum=0.9).minimize(loss)
        out.append((main, startup, loss, ckpts))
    return out


def test_training_parity_and_rewrite_shape():
    (tmain, tstartup, tloss, tck), (jmain, jstartup, jloss, jck) = \
        _momentum_pair()
    init = _jax_init(jstartup)
    plain = _train(tmain, tloss, init)
    n = recompute_program(tmain, tck)
    assert n > 0 and n == jrecompute(jmain, jck)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    types = [op.type for op in tmain.global_block().ops]
    assert "recompute_barrier" in types
    assert any("@RCP" in name
               for op in tmain.global_block().ops
               if op.type.endswith("_grad")
               for name in op.desc.input_names())
    rewritten = _train(tmain, tloss, init)
    assert all(_same(a, b) for a, b in zip(plain[0], rewritten[0]))
    assert all(_same(plain[1][k], rewritten[1][k]) for k in init)
    losses = [float(x.reshape(-1)[0]) for x in rewritten[0]]
    np.testing.assert_allclose(losses, _jax_train(jmain, jloss, init),
                               rtol=1e-5)
    assert losses[-1] < losses[0]


def test_recompute_optimizer_wrapper():
    progs = []
    for fl in (tfluid, jfluid):
        main, startup, loss, ckpts = _build_mlp(fl, depth=4)
        with fl.program_guard(main, startup):
            opt = fl.RecomputeOptimizer(
                fl.optimizer.SGD(learning_rate=0.1), checkpoints=ckpts)
            opt.minimize(loss)
        progs.append((main, startup, loss))
    (tmain, _, tloss), (jmain, jstartup, jloss) = progs
    assert any(op.type == "recompute_barrier"
               for op in tmain.global_block().ops)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    init = _jax_init(jstartup)
    losses = [float(x.reshape(-1)[0]) for x in _train(tmain, tloss,
                                                      init)[0]]
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, _jax_train(jmain, jloss, init),
                               rtol=1e-5)


def test_recompute_optimizer_desc_form():
    """`minimize(loss_name, main_desc, startup_desc)`, the form the
    port's desc builders use, rewrites `main_desc`."""
    from paddle_tpu_torch.fluid.recompute import auto_checkpoints
    from paddle_tpu_torch.models import transformer_program as tp

    main, startup, loss, _ = tp.build_transformer_program(
        4, 16, 64, n_layer=1, n_head=2, d_model=16)
    picks = auto_checkpoints(tfluid.Program.from_desc(main), every=4)
    assert picks
    tfluid.RecomputeOptimizer(tfluid.MomentumOptimizer(0.01, 0.9),
                              picks).minimize(loss, main, startup)
    types = [od.type for od in main.block(0).ops]
    assert "recompute_barrier" in types and "momentum" in types


def test_rng_ops_never_cloned():
    progs = []
    for fl in (tfluid, jfluid):
        main, startup, loss, ckpts = _build_mlp(fl, dropout=True)
        with fl.program_guard(main, startup):
            fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
        (recompute_program if fl is tfluid else jrecompute)(main, ckpts)
        progs.append((main, startup, loss))
    (main, _, loss), (jmain, jstartup, _) = progs
    assert main.desc.to_dict() == jmain.desc.to_dict()
    ops = main.global_block().ops
    assert sum(1 for op in ops if op.type == "dropout") == 1
    drop_outs = {n for op in ops if op.type == "dropout"
                 for n in op.desc.output_names()}
    for op in ops:
        for n in op.desc.output_names():
            for d in drop_outs:
                assert not (n.startswith(d + "@RCP")
                            and not n.endswith("@IN")), n
    losses = [float(x.reshape(-1)[0])
              for x in _train(main, loss, _jax_init(jstartup))[0]]
    assert losses[-1] < losses[0]


def _spy(monkeypatch):
    """Record, after each op the executor applies, its type and the
    names and bytes its values hold."""
    seen = []
    apply = texec.apply_op

    def spy(ctx, od):
        out = apply(ctx, od)
        tensors = {}
        for n, v in ctx.env.items():
            if isinstance(v, torch.Tensor):
                tensors[v.untyped_storage().data_ptr()] = \
                    v.untyped_storage().nbytes()
        seen.append((od, set(ctx.env), sum(tensors.values())))
        return out

    monkeypatch.setattr(texec, "apply_op", spy)
    return seen


def test_the_rewrite_reaches_the_executor(monkeypatch):
    """A 12-deep 512-wide chain with a checkpoint every 3 layers: the
    rewritten program runs the cloned products in the backward, and the
    most bytes the run's values hold at once fall."""
    stats = {}
    for use_rcp in (False, True):
        main, startup = tfluid.Program(), tfluid.Program()
        ckpts = []
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data(name="x", shape=[512], dtype="float32")
            t = x
            for i in range(12):
                t = tfluid.layers.fc(input=t, size=512, act="relu")
                if (i + 1) % 3 == 0:
                    ckpts.append(t)
            loss = tfluid.layers.mean(x=t)
            tfluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
        if use_rcp:
            assert recompute_program(main, ckpts) > 0
        scope = tfluid.Scope()
        exe = tfluid.Executor(CPU)
        exe.run(startup, scope=scope)
        seen = _spy(monkeypatch)
        exe.run(main, feed={"x": np.ones((256, 512), np.float32)},
                fetch_list=[loss], scope=scope, eager=True)
        monkeypatch.undo()
        stats[use_rcp] = (sum(1 for od, *_ in seen if od.type == "mul"),
                          max(b for *_, b in seen))
    assert stats[True][0] > stats[False][0], stats
    assert stats[True][1] < stats[False][1], stats


def test_the_barrier_is_an_identity():
    info = tregistry.get_op_info("recompute_barrier")
    assert info.stop_gradient_op and info.capturable and info.jittable
    assert jregistry.get_op_info("recompute_barrier").stop_gradient_op
    assert len(tregistry.registered_ops()) == \
        len(jregistry.registered_ops()) == 213
    assert set(tregistry.registered_ops()) == \
        set(jregistry.registered_ops())
    x, y, g = torch.randn(3, 4), torch.randn(5), torch.randn(2)
    out = info.kernel(None, {"X": [x, y], "Trigger": [g]}, {})
    assert len(out["Out"]) == 2
    assert out["Out"][0] is x and out["Out"][1] is y


def _mem_mlp(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[4], dtype="float32")
        h1 = fl.layers.fc(input=x, size=8, act="relu")
        h2 = fl.layers.fc(input=h1, size=8, act="relu")
        h3 = fl.layers.fc(input=h2, size=8, act="relu")
        out = fl.layers.mean(x=h3)
        fl.optimizer.SGD(learning_rate=0.1).minimize(out)
    return main, startup, out


def test_memory_optimize_liveness_equals_jax():
    (tmain, _, tout), (jmain, _, jout) = (_mem_mlp(tfluid),
                                          _mem_mlp(jfluid))
    released, renames = tfluid.memory_optimize(
        tmain, skip_opt_set=[tout.name], rewrite=False)
    jreleased, jrenames = jfluid.memory_optimize(
        jmain, skip_opt_set=[jout.name], rewrite=False)
    assert released == jreleased and renames == jrenames == {}
    all_released = {n for names in released.values() for n in names}
    params = [v.name for v in tmain.global_block().vars.values()
              if isinstance(v, tfluid.Parameter)]
    assert all_released and not (set(params) & all_released)


def test_memory_optimize_rewrite_equals_jax_and_keeps_the_bits():
    (tmain, tstartup, tout), (jmain, jstartup, jout) = (
        _mem_mlp(tfluid), _mem_mlp(jfluid))
    init = _jax_init(jstartup)
    feed = {"x": np.arange(8, dtype=np.float32).reshape(2, 4) / 8.0}
    plain = _train(tmain, tout, init, steps=3, feed=feed)
    n_vars = len(tmain.global_block().desc.vars)
    _, renames = tfluid.memory_optimize(tmain, skip_opt_set=[tout.name])
    _, jrenames = jfluid.memory_optimize(jmain, skip_opt_set=[jout.name])
    assert renames and renames == jrenames and tout.name not in renames
    assert len(tmain.global_block().desc.vars) == n_vars - len(renames)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    rewritten = _train(tmain, tout, init, steps=3, feed=feed)
    assert all(_same(a, b) for a, b in zip(plain[0], rewritten[0]))
    assert all(_same(plain[1][k], rewritten[1][k]) for k in init)


@pytest.mark.parametrize("eager", [True, False])
def test_no_value_outlives_its_last_reader(monkeypatch, eager):
    """Three runs of the MLP with Momentum (eager, or the warm-up, the
    capture's plain version and a replay): after each op the run's
    values hold only what a later op reads, the fetches and the
    persistables; the fetches (the loss and an intermediate) equal a
    FunctionalProgram's bit for bit."""
    main, startup, loss, _ = _momentum_pair()[0]
    mid = [op for op in main.global_block().ops if op.type == "relu"][2]
    mid = mid.desc.output_names()[0]
    init = _jax_init(_momentum_pair()[1][1])
    desc = main.desc
    ops = desc.block(0).ops
    lv = Liveness(ops).analyze()
    keep = {loss.name, mid} | {n for n, v in desc.block(0).vars.items()
                               if v.persistable}
    scope = tfluid.Scope()
    tio.params_from_numpy(scope, init, "cpu")
    fp = FunctionalProgram(main, ["x", "y"], [loss.name, mid], place=CPU)
    fstate = {n: scope.get(n).clone() for n in fp.state_in_names}
    exe = tfluid.Executor(CPU)
    seen = _spy(monkeypatch)
    for i in range(3):
        seen.clear()
        got = exe.run(main, feed=_feeds(i), fetch_list=[loss, mid],
                      scope=scope, eager=eager)
        assert len(seen) == len(ops)
        for g, (od, names, _) in enumerate(seen):
            assert od is ops[g]
            extra = names - lv.live_out[g] - keep
            # only this op's dead outputs, released right after it
            assert extra <= (lv.defs[g] | lv.uses[g]), (g, od.type, extra)
        want, fstate = fp(fstate, {
            n: texec.prepare_feed(desc.block(0), n, v, "cpu")
            for n, v in _feeds(i).items()})
        assert all(_same(a, b.numpy()) for a, b in zip(got, want))
    if not eager:
        assert (exe.captures, exe.replays) == (1, 1)
