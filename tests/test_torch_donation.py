"""Scope tensors own their memory, so donation writes nothing the caller
holds: the port's executor writes a donated state tensor in place
(FLAGS_donation, fluid/executor.py), where the JAX package hands out
arrays that nothing writes.

- An array given to `io.params_from_numpy` keeps its values through
  donated steps (`core.types.tensor_from_numpy` copies it), and so does
  a parameter fetched before them (`executor.fetch_to_host` copies it).
  With either copy taken out, the step's in-place write reaches the
  caller's array and these tests fail.
- A donated step writes the scope's own tensor (same object, same
  storage) and an update op writes its input (`ExecContext.in_place`):
  `sgd` by rows adds into the table itself; FLAGS_donation=off and
  eager runs replace the tensor instead.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.core.ragged import SelectedRows
from paddle_tpu_torch.core.types import tensor_from_numpy
from paddle_tpu_torch.fluid import io
from paddle_tpu_torch.fluid.executor import fetch_to_host
from paddle_tpu_torch.ops.registry import get_op_info
from paddle_tpu_torch.utils import flags

torch.set_num_threads(1)

CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True)
def _restore_donation_flag():
    old = flags.get_flag("donation")
    yield
    flags.set_flag("donation", old)


def _fit_a_line():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    w = next(v.name for v in main.global_block().all_parameters())
    return main, startup, loss, w


def _feed(seed):
    rs = np.random.RandomState(seed)
    xs = rs.randn(8, 13).astype(np.float32)
    return {"x": xs, "y": (xs[:, :1] * 2.0 - 1.0).astype(np.float32)}


def test_caller_arrays_keep_their_values_through_donated_steps():
    main, startup, loss, w = _fit_a_line()
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    given = np.full((13, 1), 0.5, np.float32)
    io.params_from_numpy(scope, {w: given}, "cpu")
    fetched, = exe.run(main, feed=_feed(0), fetch_list=[w], scope=scope)
    kept = fetched.copy()
    for i in range(1, 4):
        exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope)
    assert exe.captures == 1
    assert not np.array_equal(scope.get(w).numpy(), kept)
    np.testing.assert_array_equal(given, np.full((13, 1), 0.5, np.float32))
    np.testing.assert_array_equal(fetched, kept)


def test_the_two_copies():
    arr = np.arange(6, dtype=np.float32)
    t = tensor_from_numpy(arr, "cpu")
    t.add_(1.0)
    np.testing.assert_array_equal(arr, np.arange(6, dtype=np.float32))
    src = torch.arange(6.0)
    host = fetch_to_host(src)
    src.add_(1.0)
    np.testing.assert_array_equal(host, np.arange(6, dtype=np.float32))


@pytest.mark.parametrize("mode", ["conservative", "auto", "off"])
def test_donated_state_is_written_in_place(mode):
    flags.set_flag("donation", mode)
    main, startup, loss, w = _fit_a_line()
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    kept = scope.get(w)
    ptr = kept.data_ptr()
    for i in range(4):
        exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope)
    if mode == "off":
        assert scope.get(w) is not kept
    else:
        assert scope.get(w) is kept and kept.data_ptr() == ptr
    assert exe.captures == 1


class _Donating:
    in_place = frozenset({"ParamOut"})


def test_sgd_by_rows_adds_into_the_table():
    table = torch.randn(10, 4)
    before = table.clone()
    grad = SelectedRows(torch.tensor([1, 3, 1], dtype=torch.int32),
                        torch.ones(3, 4), 10)
    ins = {"Param": [table], "Grad": [grad],
           "LearningRate": [torch.full((1,), 0.5)]}
    sgd = get_op_info("sgd").kernel
    copied = sgd(None, ins, {})["ParamOut"][0]
    assert copied is not table and torch.equal(table, before)
    donated = sgd(_Donating, ins, {})["ParamOut"][0]
    assert donated is table and torch.equal(donated, copied)


@pytest.mark.parametrize("op", ["sgd", "momentum", "adam"])
def test_dense_updates_in_place_equal_the_new_tensors(op):
    rs = np.random.RandomState(0)
    p = torch.from_numpy(rs.randn(5, 3).astype(np.float32))
    ins = {"Param": [p], "Grad": [torch.from_numpy(
        rs.randn(5, 3).astype(np.float32))],
        "LearningRate": [torch.full((1,), 0.1)]}
    attrs = {}
    slots = {"ParamOut"}
    if op == "momentum":
        ins["Velocity"] = [torch.from_numpy(rs.rand(5, 3).astype(np.float32))]
        attrs = {"mu": 0.9}
        slots.add("VelocityOut")
    if op == "adam":
        ins.update(Moment1=[torch.from_numpy(rs.rand(5, 3).astype(
            np.float32))], Moment2=[torch.from_numpy(rs.rand(5, 3).astype(
                np.float32))], Beta1Pow=[torch.full((1,), 0.9)],
            Beta2Pow=[torch.full((1,), 0.999)])
        slots |= {"Moment1Out", "Moment2Out"}
    kernel = get_op_info(op).kernel
    fresh = kernel(None, {k: [t.clone() for t in v] for k, v in ins.items()},
                   attrs)

    class Ctx:
        in_place = frozenset(slots)

    inputs = {k: [t.clone() for t in v] for k, v in ins.items()}
    done = kernel(Ctx, inputs, attrs)
    for slot, (t,) in done.items():
        src = inputs[slot[:-3]][0]
        assert t is src, slot
        assert torch.equal(t, fresh[slot][0]), slot
