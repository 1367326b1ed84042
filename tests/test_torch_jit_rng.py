"""`jit.FunctionalProgram`'s random stream (the repair of ROADMAP A9's
first item), against the JAX package's `paddle_tpu/jit.py:70-92`.

Draws cannot equal JAX's (the two packages' generators differ: the
parity of random ops is statistical), so the test holds what the JAX
function promises: a block with a dropout runs; its stream's state,
carried in `state[RNG_STATE_NAME]`, advances and comes back in
`new_state`; a replay from a saved state repeats bit for bit; an
explicit `rng=` leaves `state`'s keys as they were; the keep rate is
the dropout's; and a block with no random op gives what it gave
before, equal to the JAX package's."""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import jit as jjit
from paddle_tpu.core.scope import Scope as JScope
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import jit
from paddle_tpu_torch.fluid import io as tio

CPU = tfluid.CPUPlace()
P = 0.3


def _program(fluid, dropout):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        h = fluid.layers.fc(input=x, size=64, act="relu")
        if dropout:
            h = fluid.layers.dropout(h, dropout_prob=P)
        y = fluid.layers.fc(input=h, size=4)
    return main, startup, y


def _port(dropout):
    main, startup, y = _program(tfluid, dropout)
    scope = tfluid.Scope()
    tfluid.Executor(CPU).run(startup, scope=scope)
    fp = jit.FunctionalProgram(main, ["x"], [y.name], place=CPU)
    return fp, jit.state_from_scope(fp, scope)


def _feed(seed=0):
    return np.random.RandomState(seed).randn(32, 16).astype(np.float32)


def test_a_dropout_block_runs_and_its_stream_advances():
    fp, state = _port(dropout=True)
    gen = torch.Generator().manual_seed(5)
    state[jit.RNG_STATE_NAME] = gen.get_state()
    feeds = {"x": torch.from_numpy(_feed())}
    (y1,), s1 = fp(state, feeds)
    assert set(s1) == set(state)
    assert not torch.equal(s1[jit.RNG_STATE_NAME], state[jit.RNG_STATE_NAME])
    (y2,), s2 = fp(s1, feeds)
    assert not torch.equal(y1, y2)  # the second call drew afresh
    # a replay from the saved state repeats bit for bit, state and all
    (y1b,), s1b = fp(state, feeds)
    assert torch.equal(y1, y1b)
    assert torch.equal(s1[jit.RNG_STATE_NAME], s1b[jit.RNG_STATE_NAME])
    (y2b,), _ = fp(s1b, feeds)
    assert torch.equal(y2, y2b)


def test_explicit_rng_keeps_the_state_keys():
    fp, state = _port(dropout=True)
    feeds = {"x": torch.from_numpy(_feed())}
    gen = torch.Generator().manual_seed(5)
    (y1,), new = fp(state, feeds, rng=gen)
    assert set(new) == set(state) and jit.RNG_STATE_NAME not in new
    # the same draws as the state-carried stream from the same seed
    carried = dict(state)
    carried[jit.RNG_STATE_NAME] = torch.Generator().manual_seed(5) \
        .get_state()
    (y2,), _ = fp(carried, feeds)
    assert torch.equal(y1, y2)
    # with both, the explicit stream runs and its advanced state returns
    gen = torch.Generator().manual_seed(5)
    (y3,), both = fp(carried, feeds, rng=gen)
    assert torch.equal(y3, y1)
    assert torch.equal(both[jit.RNG_STATE_NAME], gen.get_state())


def test_without_a_stream_a_random_op_raises():
    fp, state = _port(dropout=True)
    with pytest.raises(RuntimeError, match="random stream"):
        fp(state, {"x": torch.from_numpy(_feed())})


def test_the_keep_rate_is_the_dropouts():
    """The statistical parity: the share of the hidden layer's units
    the dropout zeroes is P, within 4 standard deviations, as the JAX
    package's FunctionalProgram draws it."""
    main, startup, _ = _program(tfluid, True)
    drop = [op for op in main.desc.block(0).ops if op.type == "dropout"][0]
    mask_name = drop.output("Mask")[0]
    scope = tfluid.Scope()
    tfluid.Executor(CPU).run(startup, scope=scope)
    fp = jit.FunctionalProgram(main, ["x"], [mask_name], place=CPU)
    state = jit.state_from_scope(fp, scope)
    state[jit.RNG_STATE_NAME] = torch.Generator().manual_seed(1).get_state()
    (mask,), _ = fp(state, {"x": torch.from_numpy(_feed())})
    n = mask.numel()
    dropped = float((mask == 0).float().mean())
    assert abs(dropped - P) < 4 * (P * (1 - P) / n) ** 0.5

    jmain, jstartup, _ = _program(jfluid, True)
    jdrop = [op for op in jmain.desc.block(0).ops if op.type == "dropout"][0]
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstartup)
    jfp = jjit.FunctionalProgram(jmain, ["x"], [jdrop.output("Mask")[0]])
    import jax

    jstate = jjit.state_from_scope(jfp, jscope)
    jstate[jjit.RNG_STATE_NAME] = jax.random.PRNGKey(1)
    (jmask,), jnew = jfp(jstate, {"x": _feed()})
    assert jjit.RNG_STATE_NAME in jnew
    jdropped = float((np.asarray(jmask) == 0).mean())
    assert abs(jdropped - P) < 4 * (P * (1 - P) / n) ** 0.5


def test_a_block_without_random_ops_is_unchanged_and_equals_jax():
    jmain, jstartup, jy = _program(jfluid, False)
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstartup)
    jfp = jjit.FunctionalProgram(jmain, ["x"], [jy.name])
    jstate = jjit.state_from_scope(jfp, jscope)
    (want,), _ = jfp(jstate, {"x": _feed()})

    main, _, y = _program(tfluid, False)
    fp = jit.FunctionalProgram(main, ["x"], [y.name], place=CPU)
    state = {n: torch.from_numpy(np.array(v)) for n, v in jstate.items()}
    (got,), new = fp(state, {"x": torch.from_numpy(_feed())})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert set(new) == set(state)
    # a stream in `state` is carried through untouched by a block that
    # draws nothing
    carried = dict(state)
    carried[jit.RNG_STATE_NAME] = torch.Generator().manual_seed(2) \
        .get_state()
    (again,), new = fp(carried, {"x": torch.from_numpy(_feed())})
    assert torch.equal(again, got)
    assert torch.equal(new[jit.RNG_STATE_NAME], carried[jit.RNG_STATE_NAME])


def test_state_to_scope_skips_the_stream():
    fp, state = _port(dropout=True)
    state[jit.RNG_STATE_NAME] = torch.Generator().get_state()
    scope = tfluid.Scope()
    jit.state_to_scope(state, scope)
    assert scope.get(jit.RNG_STATE_NAME) is None
    assert all(scope.get(n) is not None for n in fp.state_in_names)
