"""Saving, loading and checkpoints in the JAX package's format, each
package reading the other's files, on the CPU.

A small program (fc, relu, fc, softmax_with_cross_entropy, momentum)
trained one step by the JAX package gives the values: parameters,
velocities, the learning rate.  Values must come back equal (bit for
bit: the files hold the arrays as they are).

- `save_vars`, `save_params`, `save_persistables` by one package,
  `load_*` by the other, both ways; bfloat16 values cross by their bits.
- A `CheckpointSaver` snapshot written by one package and restored by
  the other's `load_checkpoint`, both ways; a snapshot torn by a fault
  before its manifest, or by a flipped byte, is skipped by both for the
  one before; `max_to_keep` and the garbage collection as on the JAX
  side; `save` copies the values before it returns.
- A ragged value raises and names ROADMAP A7.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.core.ragged import RaggedTensor
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.fluid import checkpoint as jckpt
from paddle_tpu.fluid import io as jio
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import checkpoint as tckpt
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.resilience import faults

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

CPU = tfluid.CPUPlace()


def _program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=5, act="relu")
        logits = fluid.layers.fc(input=h, size=3)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.MomentumOptimizer(learning_rate=0.1,
                                          momentum=0.9).minimize(loss)
    return main, startup, loss


def _feed():
    rs = np.random.RandomState(0)
    return {"x": rs.randn(4, 6).astype(np.float32),
            "label": rs.randint(0, 3, (4, 1)).astype(np.int64)}


@pytest.fixture(scope="module")
def jax_state():
    """(JAX main program, its scope after startup and one step,
    {persistable: ndarray})."""
    main, startup, loss = _program(jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = JScope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        exe.run(main, feed=_feed(), fetch_list=[loss])
    values = {v.name: np.array(scope.get(v.name)) for v in main.list_vars()
              if v.persistable and scope.get(v.name) is not None}
    assert any("velocity" in n for n in values) and len(values) >= 9
    return main, scope, values


def _port_scope(values):
    scope = tfluid.Scope()
    tio.params_from_numpy(scope, values, "cpu")
    return scope


def _assert_values(got, want):
    assert set(got) == set(want)
    for n, w in want.items():
        g = got[n]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, n
        np.testing.assert_array_equal(g, w, err_msg=n)


@pytest.mark.parametrize("kind", ["vars", "params", "persistables"])
def test_jax_saves_port_loads(kind, jax_state, tmp_path):
    jmain, jscope, values = jax_state
    with jfluid.scope_guard(jscope):
        if kind == "vars":
            jio.save_vars(None, str(tmp_path), jmain,
                          vars=[n for n in values if "velocity" in n])
        else:
            getattr(jio, "save_" + kind)(None, str(tmp_path), jmain)
    tmain, _, _ = _program(tfluid)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    with tfluid.scope_guard(scope):
        if kind == "vars":
            names = [n for n in values if "velocity" in n]
            tio.load_vars(exe, str(tmp_path), tmain, vars=names)
        else:
            getattr(tio, "load_" + kind)(exe, str(tmp_path), tmain)
    want = {n: v for n, v in values.items()
            if kind == "persistables"
            or (kind == "vars" and "velocity" in n)
            or (kind == "params" and tmain.global_block().var(n)
                .desc.is_parameter)}
    assert want
    _assert_values({n: scope.get(n) for n in want}, want)
    assert all(scope.get(n) is None for n in values if n not in want)


@pytest.mark.parametrize("kind", ["vars", "params", "persistables"])
def test_port_saves_jax_loads(kind, jax_state, tmp_path):
    _, _, values = jax_state
    tmain, _, _ = _program(tfluid)
    exe = tfluid.Executor(CPU)
    with tfluid.scope_guard(_port_scope(values)):
        if kind == "vars":
            tio.save_vars(exe, str(tmp_path), tmain,
                          vars=[tmain.global_block().var(n)
                                for n in values if "velocity" in n])
        else:
            getattr(tio, "save_" + kind)(exe, str(tmp_path), tmain)
    jmain, _, _ = _program(jfluid)
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        if kind == "vars":
            jio.load_vars(None, str(tmp_path), jmain,
                          vars=[n for n in values if "velocity" in n])
        else:
            getattr(jio, "load_" + kind)(None, str(tmp_path), jmain)
    names = [n for n in values if jscope.get(n) is not None]
    if kind == "persistables":
        assert set(names) == set(values)
    elif kind == "vars":
        assert names and all("velocity" in n for n in names)
    else:
        assert names and all(jmain.global_block().var(n).desc.is_parameter
                             for n in names)
    _assert_values({n: jscope.get(n) for n in names},
                   {n: values[n] for n in names})


def test_bf16_values_cross_by_their_bits(tmp_path):
    rs = np.random.RandomState(1)
    w = rs.randn(3, 4).astype(np.float32)
    # the JAX package writes a bfloat16 array; the port reads it ...
    jio._save_one(str(tmp_path), "w", jnp.asarray(w, jnp.bfloat16))
    got = tio._load_one(str(tmp_path), "w")
    want = torch.from_numpy(w).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    # ... and writes it back in the same bytes
    os.makedirs(str(tmp_path / "port"))
    tio._save_one(str(tmp_path / "port"), "w", got)
    a = np.load(str(tmp_path / "w.npz"))["values"]
    b = np.load(str(tmp_path / "port" / "w.npz"))["values"]
    assert a.dtype == b.dtype == np.dtype("V2")
    assert a.tobytes() == b.tobytes()


def test_ragged_value_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        tio._save_one(str(tmp_path), "r", [torch.ones(2), torch.ones(3)])
    jio._save_one(str(tmp_path), "r", RaggedTensor(
        jnp.ones((3, 2)), [np.array([0, 1, 3], np.int32)]))
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        tio._load_one(str(tmp_path), "r")


# -- checkpoints ----------------------------------------------------------------

def test_jax_checkpoint_loads_in_port(jax_state, tmp_path):
    jmain, jscope, values = jax_state
    saver = jckpt.CheckpointSaver(str(tmp_path), main_program=jmain)
    saver.save(7, jscope)
    saver.wait()
    scope = tfluid.Scope()
    assert tckpt.load_checkpoint(str(tmp_path), scope, place=CPU) == 7
    _assert_values({n: scope.get(n) for n in values}, values)
    assert tckpt.latest_checkpoint(str(tmp_path)).endswith(
        "checkpoint_000000007")


def test_port_checkpoint_loads_in_jax(jax_state, tmp_path):
    _, _, values = jax_state
    tmain, _, _ = _program(tfluid)
    saver = tckpt.CheckpointSaver(str(tmp_path), main_program=tmain)
    saver.save(3, _port_scope(values))
    saver.wait()
    jscope = JScope()
    assert jckpt.load_checkpoint(str(tmp_path), jscope) == 3
    _assert_values({n: jscope.get(n) for n in values}, values)


def _flip_a_byte(snap):
    name = sorted(f for f in os.listdir(snap) if f.endswith(".npz"))[0]
    path = os.path.join(snap, name)
    blob = bytearray(open(path, "rb").read())
    blob[-10] ^= 0xFF
    open(path, "wb").write(bytes(blob))


@pytest.mark.parametrize("tear", ["fault before the manifest",
                                  "flipped byte"])
def test_torn_snapshot_skipped_by_both(tear, jax_state, tmp_path):
    _, _, values = jax_state
    tmain, _, _ = _program(tfluid)
    root = str(tmp_path)
    saver = tckpt.CheckpointSaver(root, main_program=tmain, max_to_keep=5)
    saver.save(1, _port_scope(values))
    saver.wait()
    later = {n: v + 1 if v.dtype == np.float32 else v
             for n, v in values.items()}
    if tear == "fault before the manifest":
        faults.enable(seed=0)
        try:
            spec = faults.inject("checkpoint/manifest", "io_error",
                                 times=None)
            saver.save(2, _port_scope(later))
            with pytest.raises(faults.InjectedIOError):
                saver.wait()
            assert spec.fired == 3   # every attempt of the retry policy
        finally:
            faults.disable()
        torn = os.path.join(root, "checkpoint_000000002")
        assert os.path.isdir(torn) and os.listdir(torn)
    else:
        saver.save(2, _port_scope(later))
        saver.wait()
        _flip_a_byte(os.path.join(root, "checkpoint_000000002"))
    scope = tfluid.Scope()
    assert tckpt.load_checkpoint(root, scope, place=CPU) == 1
    _assert_values({n: scope.get(n) for n in values}, values)
    jscope = JScope()
    assert jckpt.load_checkpoint(root, jscope) == 1
    _assert_values({n: jscope.get(n) for n in values}, values)
    if tear == "flipped byte":
        with pytest.raises(IOError, match="crc mismatch"):
            tckpt.load_checkpoint(
                os.path.join(root, "checkpoint_000000002"), scope,
                place=CPU)


def test_gc_keeps_the_newest_and_removes_torn(jax_state, tmp_path):
    _, _, values = jax_state
    tmain, _, _ = _program(tfluid)
    root = str(tmp_path)
    torn = os.path.join(root, "checkpoint_000000000")
    os.makedirs(torn)
    open(os.path.join(torn, "junk.npz"), "wb").write(b"x")
    saver = tckpt.CheckpointSaver(root, main_program=tmain, max_to_keep=2,
                                  interval_secs=3600)
    scope = _port_scope(values)
    assert saver.maybe_save(1, scope) is None   # the interval is not due
    for step in (1, 2, 3):
        saver.save(step, scope)
    saver.wait()
    assert sorted(os.listdir(root)) == ["checkpoint_000000002",
                                        "checkpoint_000000003"]


def test_save_copies_before_it_returns(tmp_path):
    tmain, _, _ = _program(tfluid)
    scope = tfluid.Scope()
    w = torch.ones(6, 5)
    scope.set("fc_0.w_0", w)
    saver = tckpt.CheckpointSaver(str(tmp_path), main_program=tmain)
    saver.save(1, scope)
    w.add_(1.0)    # an optimizer's in-place update right after the save
    saver.wait()
    loaded = tfluid.Scope()
    tckpt.load_checkpoint(str(tmp_path), loaded, place=CPU)
    assert torch.equal(loaded.get("fc_0.w_0"), torch.ones(6, 5))


def test_all_torn_raises_when_strict(tmp_path):
    os.makedirs(str(tmp_path / "checkpoint_000000004"))
    with pytest.raises(IOError, match="no loadable checkpoint"):
        tckpt.load_checkpoint(str(tmp_path), tfluid.Scope(), place=CPU)
    assert tckpt.load_checkpoint(str(tmp_path), tfluid.Scope(),
                                 strict=False, place=CPU) is None
    assert tckpt.load_checkpoint(str(tmp_path / "none"), tfluid.Scope(),
                                 place=CPU) is None
