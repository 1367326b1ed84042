"""The rest of the optimizer stack: gradient clipping, learning-rate
schedules, fused updates, `calc_gradient`, `fetch_var`,
`switch_*_program`, the evaluators, and the transformer trained with
all of them: the port against the JAX package, on the CPU.

- Each clip class (`GradientClipByValue`, `ByNorm`, `ByGlobalNorm`, one
  instance shared by several parameters and by two programs) and the
  error clip of a hidden var: main and startup descs equal, 3 SGD steps
  from the JAX startup's state at atol 1e-6 (f32, the same ops).
- Each schedule of tests/test_lr_schedules.py over 6 steps: descs equal,
  the rates equal the JAX package's at rtol 1e-6 and the closed form at
  1e-5; a schedule driving SGD applies the decayed rate.
- Fused updates (tests/test_fused_optimizer.py's cases): the fused
  programs equal the JAX package's; a fused and an unfused program, run
  from one state, give the same bits (the port's `fused_update` runs the
  same elementwise ops); the grouping, the round trip, two Adams, one
  optimizer in two programs, the flag, the desc round trip, the cap.
- `calc_gradient` (with and without target grads), `fetch_var`,
  `switch_main_program` and `switch_startup_program`, and `Accuracy`,
  `ChunkEvaluator` and `EditDistance` over two batches and a reset:
  descs and values equal the JAX package's.
- chip_smoke.build_stack (phase 15c's configuration) at 2 layers,
  d_model 64, vocab 512: descs equal (fused and unfused); 2 steps from
  the JAX startup's state: the loss within 1e-5 of its size, the global
  norm within 1e-5, the learning rate exactly, each group's change
  (parameters, both moments) within 1e-4 in relative L2 (ROADMAP C's
  Adam convention); fused and unfused give the same bits.
"""


import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.fluid import clip as jclip
from paddle_tpu.fluid import fusion as jfusion
from paddle_tpu.fluid import lr_schedules as jlrs
from paddle_tpu.utils import flags as jflags
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.ragged import RaggedTensor
from paddle_tpu_torch.fluid import clip as tclip
from paddle_tpu_torch.fluid import fusion as tfusion
from paddle_tpu_torch.fluid import lr_schedules as tlrs
from paddle_tpu_torch.utils import flags as tflags

import chip_smoke

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
PACKAGES = {"jax": (jfluid, jclip, jlrs),
            "port": (tfluid, tclip, tlrs)}


def _state(jstart, tstart):
    """The JAX startup's persistables, {name: ndarray}, and the JAX
    scope holding them."""
    jscope = JScope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstart, scope=jscope)
    return jscope, {n: np.asarray(jscope.get(n))
                    for n, vd in tstart.desc.block(0).vars.items()
                    if vd.persistable}


def _port_scope(state):
    scope = tfluid.Scope()
    tfluid.io.params_from_numpy(scope, state, "cpu")
    return scope


def _equal_descs(j, t):
    for jp, tp in zip(j, t):
        assert tp.desc.to_dict() == jp.desc.to_dict()


# -- clipping ----------------------------------------------------------------------

def _clipped(pkg, kind):
    fluid, clip = pkg[0], pkg[1]
    attrs = {
        "value": lambda: clip.GradientClipByValue(max=0.05),
        "value_min": lambda: clip.GradientClipByValue(max=0.05, min=-0.01),
        "norm": lambda: clip.GradientClipByNorm(clip_norm=0.1),
        "global_norm": lambda: clip.GradientClipByGlobalNorm(clip_norm=0.1),
    }
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        if kind == "mixed":
            shared = clip.GradientClipByGlobalNorm(clip_norm=0.2)
            pattrs = [fluid.ParamAttr(clip=clip.GradientClipByValue(0.05)),
                      fluid.ParamAttr(gradient_clip=shared),
                      fluid.ParamAttr(gradient_clip=shared)]
            battrs = [fluid.ParamAttr(clip=clip.GradientClipByNorm(0.1)),
                      None, None]
        elif kind == "error_clip":
            pattrs, battrs = [None] * 3, [None] * 3
        else:
            make = attrs[kind]
            one = make()
            # global norm: one instance for every parameter, as users set
            # it; the rest: an instance each
            pick = (lambda: one) if kind == "global_norm" else make
            pattrs = [fluid.ParamAttr(gradient_clip=pick())
                      for _ in range(3)]
            battrs = [fluid.ParamAttr(gradient_clip=pick())
                      for _ in range(3)]
        h = fluid.layers.fc(input=x, size=5, act="tanh",
                            param_attr=pattrs[0], bias_attr=battrs[0])
        if kind == "error_clip":
            h.error_clip = clip.ErrorClipByValue(max=0.02)
        h = fluid.layers.fc(input=h, size=5, act="relu",
                            param_attr=pattrs[1], bias_attr=battrs[1])
        y = fluid.layers.fc(input=h, size=2, param_attr=pattrs[2],
                            bias_attr=battrs[2])
        loss = fluid.layers.mean(x=fluid.layers.square(y))
        fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("kind", ["value", "value_min", "norm",
                                  "global_norm", "mixed", "error_clip"])
def test_clipped_steps_match_jax(kind):
    jmain, jstart, jloss = _clipped(PACKAGES["jax"], kind)
    tmain, tstart, tloss = _clipped(PACKAGES["port"], kind)
    _equal_descs((jmain, jstart), (tmain, tstart))
    types = [op.type for op in tmain.desc.block(0).ops]
    want = {"value": "clip", "value_min": "clip", "norm": "clip_by_norm",
            "global_norm": "squared_l2_norm", "mixed": "squared_l2_norm",
            "error_clip": "clip"}[kind]
    assert want in types
    if kind == "error_clip":
        # the clip follows the grad op that writes the clipped var's
        # grad (the second fc's mul_grad), in place
        i = types.index("clip")
        ops = tmain.desc.block(0).ops
        (g,) = ops[i].input("X")
        assert ops[i].output("Out") == [g] and g.endswith("@GRAD")
        assert g in ops[i - 1].output_names() and types[i - 1] == "mul_grad"
    jscope, state = _state(jstart, tstart)
    tscope = _port_scope(state)
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), tfluid.Executor(CPU)
    rs = np.random.RandomState(7)
    for _ in range(3):
        feed = {"x": (3.0 * rs.randn(6, 4)).astype(np.float32)}
        jl, = jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
        tl, = texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)
        np.testing.assert_allclose(tl, np.asarray(jl), atol=1e-6)
    for n in state:
        np.testing.assert_allclose(tscope.get(n).numpy(),
                                   np.asarray(jscope.get(n)), atol=1e-6,
                                   err_msg=n)


def test_one_global_norm_instance_in_two_programs():
    """One GradientClipByGlobalNorm serves two programs built one after
    the other: each program's ops read only its own vars, as the JAX
    package's do, and both programs equal the JAX package's."""
    def build(pkg):
        fluid, clip = pkg[0], pkg[1]
        shared = clip.GradientClipByGlobalNorm(clip_norm=0.5)
        progs = []
        for _ in range(2):
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                x = fluid.layers.data(name="x", shape=[3], dtype="float32")
                y = fluid.layers.fc(
                    input=x, size=2,
                    param_attr=fluid.ParamAttr(gradient_clip=shared),
                    bias_attr=fluid.ParamAttr(gradient_clip=shared))
                fluid.optimizer.SGD(learning_rate=0.1).minimize(
                    fluid.layers.mean(x=y))
            progs.append(main)
        return progs

    jp, tp = build(PACKAGES["jax"]), build(PACKAGES["port"])
    _equal_descs(jp, tp)
    for main in tp:
        block = main.global_block()
        for op in block.ops:
            for n in op.desc.input_names():
                assert block.has_var_recursive(n), (op.type, n)


def test_clip_op_grad_and_value_min_default():
    """`ErrorClipByValue(max)` and `GradientClipByValue(max)` default min
    to -max; `append_gradient_clip_ops` leaves a parameter without a
    clip, and a None grad, as they are."""
    assert tclip.ErrorClipByValue(0.3).min == -0.3
    assert tclip.GradientClipByValue(2.0).min == -2.0
    pairs, ops = tclip.append_gradient_clip_ops([(object(), None)])
    assert pairs[0][1] is None and ops == []


# -- learning-rate schedules ---------------------------------------------------------

SCHEDULES = {
    "exponential": (lambda m: m.exponential_decay(0.1, 4, 0.5),
                    lambda t: 0.1 * 0.5 ** (t / 4.0)),
    "exponential_staircase": (
        lambda m: m.exponential_decay(0.1, 4, 0.5, staircase=True),
        lambda t: 0.1 * 0.5 ** np.floor(t / 4.0)),
    "natural_exp": (lambda m: m.natural_exp_decay(0.2, 5, 0.7),
                    lambda t: 0.2 * np.exp(-0.7 * t / 5.0)),
    "inverse_time": (lambda m: m.inverse_time_decay(0.3, 2, 0.5),
                     lambda t: 0.3 / (1 + 0.5 * t / 2.0)),
    "polynomial": (lambda m: m.polynomial_decay(1.0, 4, end_learning_rate=0.1,
                                                power=2.0),
                   lambda t: 0.9 * (1 - np.minimum(t, 4.0) / 4.0) ** 2 + 0.1),
    "polynomial_cycle": (
        lambda m: m.polynomial_decay(1.0, 3, end_learning_rate=0.0,
                                     power=1.0, cycle=True),
        lambda t: 1 - t / (np.maximum(np.ceil(t / 3.0), 1.0) * 3.0)),
    "piecewise": (lambda m: m.piecewise_decay([3, 5], [1.0, 0.5, 0.1]),
                  lambda t: np.where(t < 3, 1.0, np.where(t < 5, 0.5, 0.1))),
    "v2_poly": (lambda m: m.v2_schedule("poly", 0.5, 0.01, 0.75, 4),
                lambda t: 0.5 * (1 + 0.01 * 4 * t) ** -0.75),
    "v2_exp": (lambda m: m.v2_schedule("exp", 0.5, 0.5, 8.0, 4),
               lambda t: 0.5 * 0.5 ** (4 * t / 8.0)),
    "v2_discexp": (lambda m: m.v2_schedule("discexp", 0.5, 0.5, 8.0, 4),
                   lambda t: 0.5 * 0.5 ** np.floor(4 * t / 8.0)),
    "v2_linear": (lambda m: m.v2_schedule("linear", 0.5, 0.02, 0.3, 4),
                  lambda t: np.maximum(0.5 - 0.02 * 4 * t, 0.3)),
}


def _schedule(pkg, name):
    fluid, mod = pkg[0], pkg[2]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        lr = SCHEDULES[name][0](mod)
    return main, startup, lr


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    """6 steps: the step counter (int64, running as int32) advances at
    the top of each run, so step t = 1..6 computes the rate."""
    jmain, jstart, jlr = _schedule(PACKAGES["jax"], name)
    tmain, tstart, tlr = _schedule(PACKAGES["port"], name)
    _equal_descs((jmain, jstart), (tmain, tstart))
    counter = next(n for n in tstart.desc.block(0).vars
                   if n.startswith("lr_sched_step"))
    jscope, state = _state(jstart, tstart)
    tscope = _port_scope(state)
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), tfluid.Executor(CPU)
    jr = [float(np.asarray(jexe.run(jmain, fetch_list=[jlr],
                                    scope=jscope)[0]).reshape(-1)[0])
          for _ in range(6)]
    tr = [float(texe.run(tmain, fetch_list=[tlr], scope=tscope)[0]
                .reshape(-1)[0]) for _ in range(6)]
    np.testing.assert_allclose(tr, jr, rtol=1e-6)
    np.testing.assert_allclose(tr, SCHEDULES[name][1](np.arange(1.0, 7.0)),
                               rtol=1e-5)
    assert tscope.get(counter).dtype == torch.int32
    assert int(tscope.get(counter)[0]) == 6


def test_schedule_drives_sgd():
    """tests/test_lr_schedules.py:78 through the port: w -= lr * 1, the
    step halving when the schedule does."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[1], dtype="float32")
        pred = tfluid.layers.fc(
            input=x, size=1, bias_attr=False,
            param_attr=tfluid.ParamAttr(
                name="w", initializer=tfluid.initializer.Constant(0.0)))
        loss = tfluid.layers.mean(x=pred)
        lr = tlrs.piecewise_decay([3], [0.5, 0.25])
        tfluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    deltas, prev = [], 0.0
    for _ in range(4):
        exe.run(main, feed={"x": np.ones((4, 1), np.float32)},
                fetch_list=[loss], scope=scope)
        cur = float(tfluid.fetch_var("w", scope)[0, 0])
        deltas.append(round(prev - cur, 6))
        prev = cur
    assert deltas == [0.5, 0.5, 0.25, 0.25]
    assert tlrs.v2_schedule("constant", 0.25) == 0.25
    with pytest.raises(ValueError, match="decay_b"):
        tlrs.v2_schedule("exp", 0.5, 0.5, 0.0)
    with pytest.raises(ValueError, match="increasing"):
        tlrs.piecewise_decay([3, 3], [1.0, 0.5, 0.1])


# -- fused updates ---------------------------------------------------------------------

OPTIMIZERS = {
    "sgd": lambda f: f.optimizer.SGD(learning_rate=0.05),
    "momentum": lambda f: f.optimizer.Momentum(learning_rate=0.05,
                                               momentum=0.9),
    "adam": lambda f: f.optimizer.Adam(learning_rate=0.01),
    "adagrad": lambda f: f.optimizer.Adagrad(learning_rate=0.05),
    "rmsprop": lambda f: f.optimizer.RMSProp(learning_rate=0.01),
    "adadelta": lambda f: f.optimizer.Adadelta(),
}


def _convnet(fluid, make_opt, fuse=True):
    """tests/test_fused_optimizer.py:32's classifier: two convolutions
    and an fc, 6 parameters."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 12, 12],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.conv2d(input=img, num_filters=4, filter_size=3,
                                act="relu")
        h = fluid.layers.conv2d(input=h, num_filters=4, filter_size=3,
                                act="relu")
        h = fluid.layers.fc(input=h, size=10, act="softmax")
        loss = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=h, label=label))
        ops, _ = make_opt(fluid).minimize(loss, fuse_updates=fuse)
    return main, startup, loss, ops


def _train_port(main, startup, loss, state, steps=4, seed=3):
    scope = _port_scope(state)
    exe = tfluid.Executor(CPU)
    rs = np.random.RandomState(seed)
    losses = [exe.run(main, feed={
        "img": rs.randn(8, 1, 12, 12).astype("float32"),
        "label": rs.randint(0, 10, (8, 1)).astype("int64")},
        fetch_list=[loss], scope=scope)[0] for _ in range(steps)]
    return losses, {n: scope.get(n) for n in state}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_fused_and_unfused_give_the_same_bits(name):
    """tests/test_fused_optimizer.py:81: the fused program equals the
    JAX package's; from the JAX startup's state, 4 steps fused and 4
    unfused give the same losses, parameters and state, bit for bit
    (Adam too: each element takes the same torch ops either way)."""
    make = OPTIMIZERS[name]
    jm, js, _, _ = _convnet(jfluid, make)
    fm, fs, fl, fops = _convnet(tfluid, make)
    _equal_descs((jm, js), (fm, fs))
    assert {op.type for op in fops} == {"fused_update"}
    um, us, ul, _ = _convnet(tfluid, make)
    tfusion.unfuse_update_ops(um.global_block())
    assert "fused_update" not in {op.type for op in um.global_block().ops}
    _, state = _state(js, fs)
    lf, sf = _train_port(fm, fs, fl, state)
    lu, su = _train_port(um, us, ul, state)
    for a, b in zip(lf, lu):
        assert np.array_equal(a, b), name
    for n in state:
        assert torch.equal(sf[n], su[n]), (name, n)


def test_fusion_groups_by_recipe():
    """tests/test_fused_optimizer.py:118: one Momentum's 6 parameters
    stack into one op, velocities stacked, the learning rate shared."""
    main, _, _, ops = _convnet(tfluid, OPTIMIZERS["momentum"])
    assert len(ops) == 1 and ops[0].type == "fused_update"
    assert len(ops[0].desc.input("Param")) == 6
    assert "Velocity" in ops[0].attr("stacked_slots")
    assert "LearningRate" not in ops[0].attr("stacked_slots")


def test_unfuse_round_trip():
    """fuse then unfuse gives the unfused program's ops and the JAX
    package's."""
    a = _convnet(tfluid, OPTIMIZERS["adam"])[0]
    tfusion.unfuse_update_ops(a.global_block())
    b = _convnet(tfluid, OPTIMIZERS["adam"], fuse=False)[0]
    j = _convnet(jfluid, OPTIMIZERS["adam"])[0]
    jfusion.unfuse_update_ops(j.global_block())
    assert a.desc.to_dict() == b.desc.to_dict() == j.desc.to_dict()


def test_two_adam_instances_never_share_a_group():
    """tests/test_fused_optimizer.py:146: two Adams' beta powers differ,
    so block-wide fusion keeps them in separate groups."""
    def build(fluid, fusion):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            loss1 = fluid.layers.mean(x=fluid.layers.fc(input=x, size=4))
            loss2 = fluid.layers.mean(x=fluid.layers.fc(input=x, size=4))
            fluid.optimizer.Adam(learning_rate=0.01).minimize(
                loss1, fuse_updates=False)
            fluid.optimizer.Adam(learning_rate=0.01).minimize(
                loss2, fuse_updates=False)
        fused = fusion.fuse_update_ops(main.global_block())
        return main, fused

    (jm, _), (tm, fused) = build(jfluid, jfusion), build(tfluid, tfusion)
    assert tm.desc.to_dict() == jm.desc.to_dict()
    stacks = [op for op in fused if op.type == "fused_update"]
    assert len(stacks) == 2
    for op in stacks:
        assert len(set(op.desc.input("Beta1Pow"))) == 1
        assert "Beta1Pow" not in op.attr("stacked_slots")


def test_one_optimizer_two_programs():
    """tests/test_fused_optimizer.py:175: an instance minimizing in two
    programs makes fresh state in each; every op reads its own
    program's vars."""
    opt = tfluid.optimizer.Adam(learning_rate=0.01)
    for _ in range(2):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
            opt.minimize(tfluid.layers.mean(
                x=tfluid.layers.fc(input=x, size=4)), fuse_updates=True)
        block = main.global_block()
        assert any(op.type == "fused_update" for op in block.ops)
        for op in block.ops:
            for n in op.desc.input_names():
                assert block.has_var_recursive(n), (op.type, n)


def test_fuse_flag_and_its_env_override(monkeypatch):
    """The flags have the JAX package's names and defaults; minimize
    follows `fuse_optimizer`; FLAGS_fuse_optimizer=0 turns it off."""
    for name in ("fuse_optimizer", "fuse_optimizer_max_numel"):
        assert tflags.get_flag(name) == jflags.get_flag(name)
    assert tflags.get_flag("fuse_optimizer_max_numel") == 1 << 18
    prev = tflags.get_flag("fuse_optimizer")
    try:
        tflags.set_flag("fuse_optimizer", True)
        ops = _convnet(tfluid, OPTIMIZERS["sgd"], fuse=None)[3]
        assert [op.type for op in ops] == ["fused_update"]
        monkeypatch.setenv("FLAGS_fuse_optimizer", "0")
        tflags.parse_flags_from_env(["fuse_optimizer"])
        assert tflags.get_flag("fuse_optimizer") is False
        ops = _convnet(tfluid, OPTIMIZERS["sgd"], fuse=None)[3]
        assert [op.type for op in ops] == ["sgd"] * 6
    finally:
        tflags.set_flag("fuse_optimizer", prev)


def test_fused_op_survives_desc_round_trip():
    """inner_type and stacked_slots go through the JSON IR, and the
    round-tripped program runs."""
    from paddle_tpu_torch.core.desc import ProgramDesc

    main, startup, loss, _ = _convnet(tfluid, OPTIMIZERS["sgd"])
    back = ProgramDesc.parse_from_string(main.desc.serialize_to_string())
    fused = [od for od in back.block(0).ops if od.type == "fused_update"]
    assert fused and fused[0].attrs["inner_type"] == "sgd"
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    out, = exe.run(back, feed={"img": np.ones((2, 1, 12, 12), "float32"),
                               "label": np.zeros((2, 1), "int64")},
                   fetch_list=[loss.name], scope=scope)
    assert np.isfinite(out).all()


def test_size_cap_keeps_big_params_unfused():
    """tests/test_fused_optimizer.py:221: at a cap of 1000 elements the
    64 x 64 weight keeps its own sgd op, the three small ones stack; the
    program equals the JAX package's under the same cap."""
    def build(fluid, flags):
        prev = flags.get_flag("fuse_optimizer_max_numel")
        flags.set_flag("fuse_optimizer_max_numel", 1000)
        try:
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                x = fluid.layers.data(name="x", shape=[64], dtype="float32")
                t = fluid.layers.fc(input=x, size=64)
                t = fluid.layers.fc(input=t, size=8)
                fluid.optimizer.SGD(learning_rate=0.1).minimize(
                    fluid.layers.mean(x=t), fuse_updates=True)
        finally:
            flags.set_flag("fuse_optimizer_max_numel", prev)
        return main

    tm, jm = build(tfluid, tflags), build(jfluid, jflags)
    assert tm.desc.to_dict() == jm.desc.to_dict()
    ops = [op for op in tm.global_block().ops
           if op.type in ("sgd", "fused_update")]
    assert [op.type for op in ops].count("sgd") == 1
    big = next(op for op in ops if op.type == "sgd").desc.input("Param")[0]
    assert tm.global_block().var(big).shape == (64, 64)
    fused, = [op for op in ops if op.type == "fused_update"]
    assert len(fused.desc.input("Param")) == 3


# -- calc_gradient, fetch_var, switch_*_program, evaluators --------------------

def _calc(fluid, with_target_grad):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32")
        h = fluid.layers.fc(input=x, size=4, act="tanh")
        y = fluid.layers.reduce_sum(fluid.layers.square(h))
        tg = None
        if with_target_grad:
            tg = [fluid.layers.fill_constant(shape=[1], dtype="float32",
                                             value=3.0)]
        gx, = fluid.calc_gradient(y, x, target_gradients=tg)
    return main, startup, gx


@pytest.mark.parametrize("with_target_grad", [False, True])
def test_calc_gradient_matches_jax(with_target_grad):
    """d(sum(tanh(fc(x))^2))/dx of a stop_gradient data var: descs equal
    and the grad equal to the JAX package's from one state."""
    jm, js, jg = _calc(jfluid, with_target_grad)
    tm, ts, tg = _calc(tfluid, with_target_grad)
    _equal_descs((jm, js), (tm, ts))
    assert tg.name == jg.name
    jscope, state = _state(js, ts)
    feed = {"x": np.random.RandomState(2).randn(5, 3).astype(np.float32)}
    j, = jfluid.Executor(jfluid.CPUPlace()).run(jm, feed=feed,
                                                fetch_list=[jg],
                                                scope=jscope)
    t, = tfluid.Executor(CPU).run(tm, feed=feed, fetch_list=[tg],
                                  scope=_port_scope(state))
    np.testing.assert_allclose(t, np.asarray(j), atol=1e-6)


def test_fetch_var_and_switch_programs():
    """fetch_var reads a scope's value to the host (or as it is);
    switch_main_program and switch_startup_program return the program
    they replace, and the layers build into the new one."""
    main, startup = tfluid.Program(), tfluid.Program()
    old_main = tfluid.switch_main_program(main)
    old_startup = tfluid.switch_startup_program(startup)
    try:
        assert tfluid.default_main_program() is main
        x = tfluid.layers.data(name="x", shape=[2], dtype="float32")
        tfluid.layers.fc(input=x, size=3,
                         param_attr=tfluid.ParamAttr(name="fw"))
    finally:
        assert tfluid.switch_main_program(old_main) is main
        assert tfluid.switch_startup_program(old_startup) is startup
    assert "fw" in main.global_block().vars and \
        "fw" not in tfluid.default_main_program().global_block().vars
    scope = tfluid.Scope()
    tfluid.Executor(CPU).run(startup, scope=scope)
    w = tfluid.fetch_var("fw", scope)
    assert isinstance(w, np.ndarray) and w.shape == (2, 3)
    assert tfluid.fetch_var("fw", scope, return_numpy=False) is \
        scope.get("fw")
    with tfluid.scope_guard(scope):
        np.testing.assert_array_equal(tfluid.fetch_var("fw"), w)
    assert tfluid.fetch_var("absent", scope) is None


def _evaluators(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        p = fluid.layers.data(name="p", shape=[4], dtype="float32")
        lbl = fluid.layers.data(name="lbl", shape=[1], dtype="int64")
        acc = fluid.evaluator.Accuracy(input=p, label=lbl, k=2)
        inf = fluid.layers.data(name="inf", shape=[1], dtype="int64",
                                lod_level=1)
        tags = fluid.layers.data(name="tags", shape=[1], dtype="int64",
                                 lod_level=1)
        chunk = fluid.evaluator.ChunkEvaluator(
            input=inf, label=tags, chunk_scheme="IOB", num_chunk_types=2)
        hyp = fluid.layers.data(name="hyp", shape=[1], dtype="int64",
                                lod_level=1)
        ref = fluid.layers.data(name="ref", shape=[1], dtype="int64",
                                lod_level=1)
        dist = fluid.evaluator.EditDistance(input=hyp, label=ref)
    return main, startup, (acc, chunk, dist)


def _eval_feeds(batch):
    rs = np.random.RandomState(10 + batch)
    lens = [3, 1, 4]
    split = np.cumsum([0] + lens)

    def seqs(hi):
        return [rs.randint(0, hi, (n, 1)).astype(np.int64) for n in lens]

    tags, inf = seqs(5), seqs(5)
    hyp, ref = seqs(3), seqs(3)
    return {"p": rs.rand(6, 4).astype(np.float32),
            "lbl": rs.randint(0, 4, (6, 1)).astype(np.int64),
            "inf": inf, "tags": tags, "hyp": hyp, "ref": ref}, split


def _feed(pkg, feed):
    """Ragged slots as each package's ragged value."""
    out = {}
    for n, v in feed.items():
        if isinstance(v, list):
            if pkg == "jax":
                from paddle_tpu.core.ragged import RaggedTensor as JRagged

                out[n] = JRagged.from_sequences(v)
            else:
                out[n] = RaggedTensor.from_sequences(v)
        else:
            out[n] = v
    return out


def test_evaluators_match_jax():
    """Accuracy (top 2), ChunkEvaluator (IOB) and EditDistance over two
    batches: descs equal, each eval() equal to the JAX package's, and
    after reset() the counters are 0."""
    jm, js, jev = _evaluators(jfluid)
    tm, ts, tev = _evaluators(tfluid)
    _equal_descs((jm, js), (tm, ts))
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), tfluid.Executor(CPU)
    with jfluid.scope_guard(JScope()), tfluid.scope_guard(tfluid.Scope()):
        jexe.run(js)
        texe.run(ts)
        for batch in range(2):
            feed, _ = _eval_feeds(batch)
            jexe.run(jm, feed=_feed("jax", feed),
                     fetch_list=[m for e in jev for m in e.metrics])
            texe.run(tm, feed=_feed("port", feed),
                     fetch_list=[m for e in tev for m in e.metrics])
        for je, te in zip(jev, tev):
            jv, tv = je.eval(jexe), te.eval(texe)
            for a, b in zip(np.atleast_1d(jv) if not isinstance(jv, tuple)
                            else jv, np.atleast_1d(tv)
                            if not isinstance(tv, tuple) else tv):
                np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                           rtol=1e-6)
        for te in tev:
            te.reset(texe)
            for v in te.states:
                assert not tfluid.fetch_var(v.name).any()
    with pytest.raises(NotImplementedError, match="A10"):
        tfluid.evaluator.DetectionMAP(None, None)


# -- the transformer trained with the whole stack --------------------------------------

NARROW = dict(batch=2, seq=16, vocab=512, n_layer=2, n_head=4, d_model=64)


def _stack(fluid, fuse=True, **kw):
    return chip_smoke.build_stack(fluid, fuse=fuse, **dict(NARROW, **kw))


def _groups(names):
    """{group: names}: parameters, first and second moments."""
    g = {"moment1": [n for n in names if n.endswith("_moment1_0")],
         "moment2": [n for n in names if n.endswith("_moment2_0")]}
    moments = set(g["moment1"]) | set(g["moment2"])
    g["parameters"] = [n for n in names if n + "_moment1_0" in names]
    assert not moments & set(g["parameters"])
    return g


@pytest.mark.parametrize("fuse", [True, False])
def test_stack_descs_equal_jax(fuse):
    """Label smoothing, the global-norm clip on every parameter, the
    piecewise schedule and Adam, fused or not: main and startup equal
    the JAX package's."""
    j, t = _stack(jfluid, fuse), _stack(tfluid, fuse)
    _equal_descs(j[:2], t[:2])
    assert t[4] == j[4] == "global_norm_0"
    types = [op.type for op in t[0].desc.block(0).ops]
    assert types.count("squared_l2_norm") == len(
        t[0].global_block().all_parameters())
    assert types.count("fused_update") == (1 if fuse else 0)
    assert "one_hot" in types and "less_than" in types


def test_stack_two_steps_match_jax():
    """2 Adam steps from the JAX startup's state: the loss, the global
    norm and the learning rate per step, each group's change after them;
    the clip binds at this width (the norm is above 1)."""
    jm, js, jl, jlr, jg = _stack(jfluid)
    tm, ts, tl, tlr, tg = _stack(tfluid)
    jscope, state = _state(js, ts)
    before = dict(state)
    tscope = _port_scope(state)
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), tfluid.Executor(CPU)
    for step, feed in enumerate(chip_smoke.stack_feeds(2, 16, 512, 2)):
        j = [float(np.asarray(v).reshape(-1)[0]) for v in jexe.run(
            jm, feed=feed, fetch_list=[jl, jlr, jg], scope=jscope)]
        t = [float(v.reshape(-1)[0]) for v in texe.run(
            tm, feed=feed, fetch_list=[tl, tlr, tg], scope=tscope)]
        assert abs(t[0] - j[0]) <= 1e-5 * abs(j[0])
        assert t[1] == j[1] == np.float32(chip_smoke.STACK_LRS[step])
        assert abs(t[2] - j[2]) <= 1e-5 * abs(j[2]) and j[2] > 1.0
    for group, names in _groups(list(state)).items():
        got = {n: tscope.get(n).numpy() for n in names}
        ref = {n: np.asarray(jscope.get(n)) for n in names}
        err = chip_smoke.change_rl2(got, ref, before, names)
        assert err <= 1e-4, (group, err)


def test_stack_fused_and_unfused_give_the_same_bits():
    """Phase 15c's fused-against-unfused gate at the narrow width: one
    step from one state, every parameter and moment bit for bit."""
    fm, fs, fl, _, _ = _stack(tfluid, True)
    um, us, ul, _, _ = _stack(tfluid, False)
    exe = tfluid.Executor(CPU)
    sf = tfluid.Scope()
    exe.run(fs, scope=sf)
    state = {n: sf.get(n).numpy().copy()
             for n, vd in fs.desc.block(0).vars.items() if vd.persistable}
    su = _port_scope(state)
    feed = chip_smoke.stack_feeds(2, 16, 512, 1)[0]
    a = exe.run(fm, feed=feed, fetch_list=[fl], scope=sf)[0]
    b = exe.run(um, feed=feed, fetch_list=[ul], scope=su)[0]
    assert np.array_equal(a, b)
    for n in state:
        assert torch.equal(sf.get(n), su.get(n)), n
