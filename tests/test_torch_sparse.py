"""Sparse (SelectedRows) gradients and every optimizer update op in the
port against the JAX package, on the same numpy inputs made from a
seed, on the CPU.

- `SelectedRows`: `to_dense` with repeated rows, negative ids (counted
  from the end) and ids outside [-height, height) (dropped, as JAX's
  scatter drops them); its pytree round trip; shape inference over it.
- `lookup_table_grad(is_sparse=True)`: dense and ragged ids,
  `padding_idx`, negative and out-of-range ids; the raw ids as rows.
- `sum` of SelectedRows (rows and values concatenated) and a mixed
  `sum` (densified).
- Every update op (`sgd`, `momentum`, `adam`, `adamax`, `adagrad`,
  `decayed_adagrad`, `adadelta`, `rmsprop`, `ftrl`, `proximal_gd`,
  `proximal_adagrad`) with a dense grad and with a SelectedRows grad
  whose rows repeat and hold a negative and an out-of-range id.

Tolerance: f32 outputs at rtol 1e-5 and atol 1e-6 (the same f32
arithmetic, scatter-adds summed in other orders); rows, shapes and
integer outputs equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401 — registers the JAX kernels
from paddle_tpu.core.ragged import RaggedTensor as JRagged
from paddle_tpu.core.ragged import SelectedRows as JRows
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.ragged import RaggedTensor, SelectedRows
from paddle_tpu_torch.core.types import VarType
from paddle_tpu_torch.ops import registry as treg

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

RTOL = 1e-5
ATOL = 1e-6
HEIGHT = 10
WIDTH = 4
# repeated rows (3 twice, 7 three times), a negative id (-1 is row 9),
# and ids outside [-HEIGHT, HEIGHT), whose rows add nothing
ROWS = np.array([3, 7, 0, 3, 7, -1, 7, 12, -11, 5], np.int32)


def _f32(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pos(*shape, seed=0):
    return (np.abs(_f32(*shape, seed=seed)) + 0.1).astype(np.float32)


def _pair_rows(rows, values, height):
    return (JRows(jnp.asarray(rows), jnp.asarray(values), height),
            SelectedRows(torch.from_numpy(rows.copy()),
                         torch.from_numpy(values.copy()), height))


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _same_rows(t, j):
    assert isinstance(t, SelectedRows) and isinstance(j, JRows)
    assert t.height == j.height
    np.testing.assert_array_equal(t.rows.numpy(), np.asarray(j.rows))
    assert t.rows.dtype == torch.int32
    _close(t.values, j.values, "values")


# -- SelectedRows -------------------------------------------------------------

@pytest.mark.parametrize("rows", [
    np.array([1, 4, 1, 1, 0], np.int32),   # repeated rows sum
    ROWS,                                  # negative and out-of-range ids
], ids=["repeated", "negative_and_out_of_range"])
def test_to_dense_matches_jax(rows):
    values = _f32(len(rows), WIDTH, seed=1)
    j, t = _pair_rows(rows, values, HEIGHT)
    assert t.shape == j.shape == (HEIGHT, WIDTH)
    assert t.dtype == torch.float32
    _close(t.to_dense(), j.to_dense())
    assert "SelectedRows" in repr(t)


def test_selected_rows_pytree_round_trips():
    import torch.utils._pytree as pytree

    _, t = _pair_rows(ROWS, _f32(len(ROWS), WIDTH), HEIGHT)
    leaves, spec = pytree.tree_flatten(t)
    assert len(leaves) == 2
    back = pytree.tree_unflatten([x * 1 for x in leaves], spec)
    assert isinstance(back, SelectedRows) and back.height == HEIGHT
    np.testing.assert_array_equal(back.rows.numpy(), ROWS)
    moved = t.to("cpu")
    assert isinstance(moved, SelectedRows) and moved.height == HEIGHT


def test_dense_only_ops_refuse_selected_rows_by_name():
    _, t = _pair_rows(ROWS, _f32(len(ROWS), WIDTH), HEIGHT)
    with pytest.raises(TypeError, match="concat takes dense tensors, got a "
                                        "SelectedRows"):
        treg.dense(t, "concat")


@pytest.mark.parametrize("op_type", ["sgd", "sum"])
def test_infer_meta_over_selected_rows_matches_jax(op_type):
    """A SELECTED_ROWS input gives the JAX side's output metas: a dense
    ParamOut from `sgd`, a SELECTED_ROWS output [height, width] from
    `sum`."""
    sr = ((HEIGHT, WIDTH), "float32", 0, VarType.SELECTED_ROWS)
    if op_type == "sgd":
        ins = {"Param": [((HEIGHT, WIDTH), "float32", 0)], "Grad": [sr],
               "LearningRate": [((1,), "float32", 0)]}
    else:
        ins = {"X": [sr, sr]}
    got = treg.infer_meta(op_type, ins, {})
    want = jreg.generic_infer_shape(op_type, ins, {})
    assert got.keys() == want.keys()
    for slot in got:
        for g, w in zip(got[slot], want[slot]):
            assert g[:3] == tuple(w[:3]), slot
            assert (g[3] if len(g) > 3 else VarType.DENSE_TENSOR) == w[3]


# -- lookup_table_grad(is_sparse=True) ----------------------------------------

def _lookup_grad_both(ids_j, ids_t, og, padding_idx=-1, vocab=HEIGHT):
    w = _f32(vocab, WIDTH, seed=3)
    attrs = {"is_sparse": True, "padding_idx": padding_idx}
    jins = {"Ids": [ids_j], "W": [jnp.asarray(w)], "OG@Out": [og[0]]}
    tins = {"Ids": [ids_t], "W": [torch.from_numpy(w)], "OG@Out": [og[1]]}
    j = jreg.get_op_info("lookup_table").grad_kernel(None, jins, attrs)
    t = treg.get_op_info("lookup_table").grad_kernel(None, tins, attrs)
    return j["W@GRAD"][0], t["W@GRAD"][0]


@pytest.mark.parametrize("ids,padding_idx", [
    (np.array([[1, 4, 1], [9, 0, 4]], np.int32), -1),
    (np.array([[1], [4], [1], [9]], np.int32), -1),       # trailing 1 dim
    (np.array([[1, 4, 1], [9, 0, 4]], np.int32), 4),      # padding_idx
    (np.array([[0, -1, 12], [-11, 3, -10]], np.int32), -1),
    (np.array([[0, -1, 12], [-11, 3, -10]], np.int32), 3),
], ids=["dense", "trailing_one", "padding_idx", "negative_out_of_range",
        "negative_padding"])
def test_lookup_table_grad_sparse_matches_jax(ids, padding_idx):
    lead = ids.shape[:-1] if ids.shape[-1] == 1 else ids.shape
    og = _f32(*(lead + (WIDTH,)), seed=1)
    j, t = _lookup_grad_both(jnp.asarray(ids), torch.from_numpy(ids),
                             (jnp.asarray(og), torch.from_numpy(og)),
                             padding_idx)
    _same_rows(t, j)
    np.testing.assert_array_equal(t.rows.numpy(), ids.reshape(-1))
    _close(t.to_dense(), j.to_dense(), "to_dense")


@pytest.mark.parametrize("padding_idx", [-1, 2])
def test_lookup_table_grad_sparse_ragged_matches_jax(padding_idx):
    rs = np.random.RandomState(5)
    seqs = [rs.randint(0, HEIGHT, size=(n, 1)).astype(np.int64)
            for n in (3, 0, 5, 1)]
    ids_j = JRagged.from_sequences(seqs, bucket=4)
    ids_t = RaggedTensor.from_sequences(seqs, bucket=4)
    rows = ids_t.values.shape[0]
    assert rows == 12 and int(ids_t.nvalid) == 9  # 3 rows pad the bucket
    og = _f32(rows, WIDTH, seed=2)
    j, t = _lookup_grad_both(ids_j, ids_t, (ids_j.with_values(
        jnp.asarray(og)), ids_t.with_values(torch.from_numpy(og))),
        padding_idx)
    _same_rows(t, j)
    assert not t.values[9:].any()          # the padding rows add nothing
    _close(t.to_dense(), j.to_dense(), "to_dense")


def test_lookup_table_grad_sparse_densifies_to_the_dense_grad():
    ids = np.array([[1, 4, 1], [-1, 0, 11]], np.int32)
    og = torch.from_numpy(_f32(2, 3, WIDTH, seed=1))
    w = torch.from_numpy(_f32(HEIGHT, WIDTH))
    grad = treg.get_op_info("lookup_table").grad_kernel
    ins = {"Ids": [torch.from_numpy(ids)], "W": [w], "OG@Out": [og]}
    sparse = grad(None, ins, {"is_sparse": True})["W@GRAD"][0]
    dense = grad(None, ins, {"is_sparse": False})["W@GRAD"][0]
    _close(sparse.to_dense(), dense.numpy())


# -- sum ----------------------------------------------------------------------

def test_sum_of_selected_rows_matches_jax():
    a_rows, b_rows = ROWS[:6], np.array([7, 2, 2], np.int32)
    ja, ta = _pair_rows(a_rows, _f32(6, WIDTH, seed=1), HEIGHT)
    jb, tb = _pair_rows(b_rows, _f32(3, WIDTH, seed=2), HEIGHT)
    j = jreg.get_op_info("sum").kernel(None, {"X": [ja, jb]}, {})["Out"][0]
    t = treg.get_op_info("sum").kernel(None, {"X": [ta, tb]}, {})["Out"][0]
    _same_rows(t, j)
    assert t.rows.shape[0] == 9


@pytest.mark.parametrize("order", ["rows_first", "dense_first"])
def test_mixed_sum_densifies_like_jax(order):
    j_sr, t_sr = _pair_rows(ROWS, _f32(len(ROWS), WIDTH, seed=1), HEIGHT)
    d = _f32(HEIGHT, WIDTH, seed=2)
    jx = [j_sr, jnp.asarray(d)]
    tx = [t_sr, torch.from_numpy(d)]
    if order == "dense_first":
        jx, tx = jx[::-1], tx[::-1]
    j = jreg.get_op_info("sum").kernel(None, {"X": jx}, {})["Out"][0]
    t = treg.get_op_info("sum").kernel(None, {"X": tx}, {})["Out"][0]
    assert isinstance(t, torch.Tensor)
    _close(t, j)


# -- the update ops -----------------------------------------------------------

# op -> (state slots {in slot: (out slot, kind)}, shared scalars, attrs);
# "pos" states are positive (they enter a square root)
UPDATES = {
    "sgd": ({}, (), {}),
    "momentum": ({"Velocity": ("VelocityOut", "any")}, (),
                 {"mu": 0.9, "use_nesterov": True}),
    "adam": ({"Moment1": ("Moment1Out", "any"),
              "Moment2": ("Moment2Out", "pos")},
             (("Beta1Pow", 0.9 ** 3), ("Beta2Pow", 0.999 ** 3)),
             {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "adamax": ({"Moment": ("MomentOut", "any"),
                "InfNorm": ("InfNormOut", "pos")},
               (("Beta1Pow", 0.9 ** 2),),
               {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "adagrad": ({"Moment": ("MomentOut", "pos")}, (), {"epsilon": 1e-6}),
    "decayed_adagrad": ({"Moment": ("MomentOut", "pos")}, (),
                        {"decay": 0.95, "epsilon": 1e-6}),
    "adadelta": ({"AvgSquaredGrad": ("AvgSquaredGradOut", "pos"),
                  "AvgSquaredUpdate": ("AvgSquaredUpdateOut", "pos")}, (),
                 {"rho": 0.95, "epsilon": 1e-6}),
    "rmsprop": ({"MeanSquare": ("MeanSquareOut", "pos"),
                 "Moment": ("MomentOut", "any")}, (),
                {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5}),
    "ftrl": ({"SquaredAccumulator": ("SquaredAccumOut", "pos"),
              "LinearAccumulator": ("LinearAccumOut", "any")}, (),
             {"l1": 0.01, "l2": 0.02, "lr_power": -0.5}),
    "proximal_gd": ({}, (), {"l1": 0.01, "l2": 0.02}),
    "proximal_adagrad": ({"Moment": ("MomentOut", "pos")}, (),
                         {"l1": 0.01, "l2": 0.02}),
}


def _update_inputs(op_type, seed=0):
    """{slot: ndarray} of one update op's inputs, bar the grad."""
    states, shared, _ = UPDATES[op_type]
    ins = {"Param": _f32(HEIGHT, WIDTH, seed=seed)}
    if op_type != "adadelta":
        ins["LearningRate"] = np.array([0.05], np.float32)
    for k, (slot, (_, kind)) in enumerate(sorted(states.items())):
        make = _pos if kind == "pos" else _f32
        ins[slot] = make(HEIGHT, WIDTH, seed=seed + 10 + k)
    for slot, value in shared:
        ins[slot] = np.array([value], np.float32)
    return ins


def _run_update(op_type, arrays, grad, attrs):
    """(jax outputs, port outputs) of `op_type` on the same inputs;
    `grad` a (jax, port) pair."""
    jins = {s: [jnp.asarray(a)] for s, a in arrays.items()}
    tins = {s: [torch.from_numpy(a.copy())] for s, a in arrays.items()}
    jins["Grad"], tins["Grad"] = [grad[0]], [grad[1]]
    j = jreg.get_op_info(op_type).kernel(None, jins, attrs)
    t = treg.get_op_info(op_type).kernel(None, tins, attrs)
    return j, t


@pytest.mark.parametrize("grad_kind", ["dense", "selected_rows"])
@pytest.mark.parametrize("op_type", sorted(UPDATES))
def test_update_op_matches_jax(op_type, grad_kind):
    arrays = _update_inputs(op_type)
    if grad_kind == "dense":
        g = _f32(HEIGHT, WIDTH, seed=7)
        grad = (jnp.asarray(g), torch.from_numpy(g))
    else:
        grad = _pair_rows(ROWS, _f32(len(ROWS), WIDTH, seed=7), HEIGHT)
    attrs = UPDATES[op_type][2]
    j, t = _run_update(op_type, arrays, grad, attrs)
    info = treg.get_op_info(op_type)
    assert sorted(t) == sorted(j)
    assert info.stop_gradient_op
    assert info.in_place_outputs == jreg.get_op_info(op_type).in_place_outputs
    for slot in j:
        assert t[slot][0].dtype == torch.float32, slot
        _close(t[slot][0], j[slot][0], "%s %s" % (op_type, slot))


@pytest.mark.parametrize("lr_power", [-0.5, -0.3])
def test_ftrl_lr_power_matches_jax(lr_power):
    arrays = _update_inputs("ftrl", seed=3)
    g = _f32(HEIGHT, WIDTH, seed=8)
    attrs = {"l1": 0.1, "l2": 0.05, "lr_power": lr_power}
    j, t = _run_update("ftrl", arrays, (jnp.asarray(g), torch.from_numpy(g)),
                       attrs)
    for slot in j:
        _close(t[slot][0], j[slot][0], slot)


@pytest.mark.parametrize("op_type", ["sgd", "adagrad"])
def test_row_updates_leave_other_rows_bit_for_bit(op_type):
    """sgd and adagrad update a SelectedRows grad's rows only: every
    other row of the parameter (and of adagrad's moment) keeps its
    bits, and every row the grad names changes."""
    arrays = _update_inputs(op_type)
    rows = np.array([3, 7, 3, -1], np.int32)
    grad = _pair_rows(rows, _f32(len(rows), WIDTH, seed=7), HEIGHT)
    _, t = _run_update(op_type, arrays, grad, UPDATES[op_type][2])
    touched = np.zeros(HEIGHT, bool)
    touched[[3, 7, 9]] = True
    pairs = [("ParamOut", "Param")]
    if op_type == "adagrad":
        pairs.append(("MomentOut", "Moment"))
    for out, src in pairs:
        got, before = t[out][0].numpy(), arrays[src]
        assert got[~touched].tobytes() == before[~touched].tobytes(), out
        assert (got[touched] != before[touched]).all(), out


def test_adagrad_rows_are_not_the_summed_grad():
    """With repeated ids, adagrad's row update squares each row's own
    values: it differs from the dense update of the summed grad (and
    the port gives JAX's answer, in test_update_op_matches_jax)."""
    arrays = _update_inputs("adagrad")
    _, sr = _pair_rows(np.array([3, 3], np.int32), _f32(2, WIDTH, seed=7),
                       HEIGHT)
    kernel = treg.get_op_info("adagrad").kernel
    outs = [kernel(None, dict({s: [torch.from_numpy(a.copy())]
                               for s, a in arrays.items()}, Grad=[g]),
                   {"epsilon": 1e-6})["ParamOut"][0][3].numpy()
            for g in (sr, sr.to_dense())]
    assert not np.allclose(outs[0], outs[1], rtol=1e-3)


# -- the executor and the reader ----------------------------------------------

def _sgd_program():
    main = tfluid.Program()
    block = main.global_block()
    p = block.create_var(name="p", shape=[HEIGHT, WIDTH], dtype="float32",
                         persistable=True)
    g = block.create_var(name="g", shape=[HEIGHT, WIDTH], dtype="float32",
                         type=VarType.SELECTED_ROWS)
    lr = block.create_var(name="lr", shape=[1], dtype="float32",
                          persistable=True)
    block.append_op(type="sgd", inputs={"Param": [p], "Grad": [g],
                                        "LearningRate": [lr]},
                    outputs={"ParamOut": [p]})
    return main


def test_executor_feeds_a_selected_rows_grad_to_sgd():
    main = _sgd_program()
    assert main.global_block().var("p").type == VarType.DENSE_TENSOR
    arrays = _update_inputs("sgd")
    scope = tfluid.Scope()
    from paddle_tpu_torch.fluid import io as tio

    tio.params_from_numpy(scope, {"p": arrays["Param"],
                                  "lr": arrays["LearningRate"]}, "cpu")
    values = _f32(len(ROWS), WIDTH, seed=7)
    j_sr, t_sr = _pair_rows(ROWS, values, HEIGHT)
    exe = tfluid.Executor(tfluid.CPUPlace())
    got, fetched = exe.run(main, feed={"g": t_sr}, fetch_list=["p", "g"],
                           scope=scope)
    want = jreg.get_op_info("sgd").kernel(
        None, {"Param": [jnp.asarray(arrays["Param"])], "Grad": [j_sr],
               "LearningRate": [jnp.asarray(arrays["LearningRate"])]},
        {})["ParamOut"][0]
    _close(got, want)
    assert isinstance(fetched, SelectedRows)
    assert fetched.rows.device.type == "cpu"
    _same_rows(fetched, j_sr)


def test_fetched_bf16_selected_rows_widen_to_f32():
    from paddle_tpu_torch.fluid.executor import fetch_to_host

    sr = SelectedRows(torch.tensor([1, 1]), torch.ones(2, 3,
                                                       dtype=torch.bfloat16),
                      4)
    out = fetch_to_host(sr)
    assert isinstance(out, SelectedRows) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.to_dense().numpy()[1], [2, 2, 2])


def test_device_prefetch_passes_selected_rows_through():
    from paddle_tpu_torch.reader import device_prefetch

    _, t_sr = _pair_rows(ROWS, _f32(len(ROWS), WIDTH), HEIGHT)

    def reader():
        yield {"g": t_sr, "x": np.ones((2, 2), np.float32)}

    batches = list(device_prefetch(reader, place=tfluid.CPUPlace())())
    assert len(batches) == 1 and batches[0]["g"] is t_sr
    assert isinstance(batches[0]["x"], torch.Tensor)
