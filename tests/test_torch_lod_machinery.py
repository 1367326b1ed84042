"""The LoD rank-table machinery and the row routing of IfElse in the port
against the JAX package, on the CPU: the programs and kernel calls of
`tests/test_lod_machinery.py` (its tests at :21, :48, :142, :158 and
:183) through both packages, on the same inputs.

- The rank-table round trip built by both packages' layers (descs equal
  through `to_dict()`): `array_to_lod_tensor` and
  `reorder_lod_tensor_by_rank` give the JAX side's values and lod
  exactly, for a feed without and with rows that pad it to a bucket.
- The lod-level-2 input ranked at level 0: the rank table, each array
  step (a lod-level-1 RaggedTensor of subsequences), the round trip and
  the reorder, exactly.
- `shrink_rnn_memory` and its grad kernel (in the JAX kernel's
  `Out@GRAD` layout and the backward's `OG@Out`), and
  `max_sequence_len` of a table and of a ragged value, exactly.
- IfElse row routing built by both packages (descs equal), and
  `split_lod_tensor`/`merge_lod_tensor` over dense and ragged inputs,
  exactly.

Every output here is a copy or a permutation of its input's rows, or
an integer: all are held exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.core.rank_table import LoDRankTable as JTable
from paddle_tpu.core.ragged import RaggedTensor as JRagged
from paddle_tpu.ops.registry import get_op_info as jop
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.rank_table import LoDRankTable
from paddle_tpu_torch.core.ragged import RaggedTensor
from paddle_tpu_torch.ops.registry import get_op_info as top

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
SEQS = [[[1, 1]],                       # len 1
        [[2, 2], [3, 3], [4, 4]],       # len 3
        [[5, 5], [6, 6]]]               # len 2


def _host(v):
    """(values ndarray with padding rows dropped, lod) of a ragged
    value of either package, or (ndarray, None)."""
    if isinstance(v, (JRagged, RaggedTensor)):
        lod = [list(map(int, np.asarray(rs))) for rs in v.row_splits]
        return np.asarray(v.values)[:lod[-1][-1]], lod
    return np.asarray(v), None


def _equal(port, jax_value, what):
    (tv, tlod), (jv, jlod) = _host(port), _host(jax_value)
    assert tlod == jlod, (what, tlod, jlod)
    assert tv.dtype == jv.dtype or tv.size == 0, (what, tv.dtype, jv.dtype)
    np.testing.assert_array_equal(tv, jv, err_msg=what)


def _roundtrip_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        layers = fluid.layers
        x = layers.data(name="x", shape=[2], dtype="float32", lod_level=1)
        table = layers.lod_rank_table(x)
        arr = layers.lod_tensor_to_array(x, table)
        back = layers.array_to_lod_tensor(arr, table)
        reordered = layers.reorder_lod_tensor_by_rank(x, table)
        longest = layers.max_sequence_len(table)
    return main, x, [back, reordered, longest]


@pytest.mark.parametrize("bucket", [None, 16])
def test_rank_table_array_roundtrip_matches_jax(bucket):
    jmain, jx, jouts = _roundtrip_program(jfluid)
    tmain, tx, touts = _roundtrip_program(tfluid)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    seqs = [np.asarray(s, np.float32) for s in SEQS]
    jfeed = {"x": JRagged.from_sequences(seqs, bucket=bucket)}
    tfeed = {"x": RaggedTensor.from_sequences(seqs, bucket=bucket)}
    jres = jfluid.Executor(jfluid.CPUPlace()).run(
        jmain, feed=jfeed, fetch_list=jouts, return_numpy=False)
    tres = tfluid.Executor(CPU).run(tmain, feed=tfeed, fetch_list=touts,
                                    return_numpy=False)
    for what, t, j in zip(("back", "reordered", "max_sequence_len"),
                          tres, jres):
        _equal(t, j, what)
    # rank order: seq1 (len 3), seq2 (len 2), seq0 (len 1)
    assert _host(tres[0])[0].tolist() == [[2, 2], [3, 3], [4, 4], [5, 5],
                                          [6, 6], [1, 1]]
    assert tres[0].lod() == [[0, 3, 5, 6]]
    assert tres[2].tolist() == [3]


def _nested():
    vals = np.arange(1, 7, dtype=np.float32).reshape(6, 1)
    splits = [np.array([0, 1, 3], np.int32), np.array([0, 2, 3, 6], np.int32)]
    return (JRagged(jnp.asarray(vals), splits),
            RaggedTensor(torch.from_numpy(vals),
                         [torch.from_numpy(s) for s in splits]))


def test_nested_rank_table_array_roundtrip_matches_jax():
    """The lod-level-2 input of tests/test_lod_machinery.py:48: ranking
    at level 0 orders documents by sentence count, each array step is a
    lod-level-1 batch of the t-th sentences, and the round trip gives
    the nested tensor in rank order."""
    jx, tx = _nested()
    jt = jop("lod_rank_table").kernel(None, {"X": [jx]}, {"level": 0})
    tt = top("lod_rank_table").kernel(None, {"X": [tx]}, {"level": 0})
    jt, tt = jt["Out"][0], tt["Out"][0]
    assert isinstance(tt, LoDRankTable) and tt.items == jt.items
    assert tt.indices() == [1, 0] and tt.lengths() == [2, 1]

    def both(op, ins_j, ins_t):
        j = jop(op).kernel(None, ins_j, {})["Out"][0]
        t = top(op).kernel(None, ins_t, {})["Out"][0]
        return j, t

    jsteps, tsteps = both("lod_tensor_to_array",
                          {"X": [jx], "RankTable": [jt]},
                          {"X": [tx], "RankTable": [tt]})
    assert len(tsteps) == len(jsteps) == 2
    for k, (t, j) in enumerate(zip(tsteps, jsteps)):
        _equal(t, j, "step %d" % k)
    assert tsteps[0].values.reshape(-1).tolist() == [3, 1, 2]
    j, t = both("array_to_lod_tensor", {"X": [jsteps], "RankTable": [jt]},
                {"X": [tsteps], "RankTable": [tt]})
    _equal(t, j, "back")
    assert t.lod() == [[0, 2, 3], [0, 1, 4, 6]]
    j, t = both("reorder_lod_tensor_by_rank", {"X": [jx], "RankTable": [jt]},
                {"X": [tx], "RankTable": [tt]})
    _equal(t, j, "reordered")
    assert t.values.reshape(-1).tolist() == [3, 4, 5, 6, 1, 2]


@pytest.mark.parametrize("level", [-1, 2])
def test_rank_table_level_out_of_range_raises_as_jax(level):
    jx, tx = _nested()
    with pytest.raises(ValueError) as jerr:
        jop("lod_rank_table").kernel(None, {"X": [jx]}, {"level": level})
    with pytest.raises(ValueError) as terr:
        top("lod_rank_table").kernel(None, {"X": [tx]}, {"level": level})
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("step", [0, 1, 2, 3])
def test_shrink_memory_and_its_grad_match_jax(step):
    """tests/test_lod_machinery.py:142: the rows still active at `step`
    of lengths [1, 3, 2]; the grad puts dOut in that prefix of zeros."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    i = np.array([step])
    jt, tt = JTable.from_lengths([1, 3, 2]), LoDRankTable.from_lengths(
        [1, 3, 2])
    j = jop("shrink_rnn_memory").kernel(
        None, {"X": [x], "RankTable": [jt], "I": [i]}, {})["Out"][0]
    t = top("shrink_rnn_memory").kernel(
        None, {"X": [torch.from_numpy(x)], "RankTable": [tt],
               "I": [torch.from_numpy(i)]}, {})["Out"][0]
    _equal(t, j, "Out")
    assert t.shape[0] == [3, 2, 1, 0][step]
    d_out = np.random.RandomState(step).randn(*t.shape).astype(np.float32)
    jg = jop("shrink_rnn_memory").grad_kernel(
        None, {"X": [x], "Out@GRAD": [d_out]}, {})["X@GRAD"][0]
    for slot in ("Out@GRAD", "OG@Out"):
        tg = top("shrink_rnn_memory").grad_kernel(
            None, {"X": [torch.from_numpy(x)],
                   slot: [torch.from_numpy(d_out)]}, {})["X@GRAD"][0]
        _equal(tg, jg, slot)


def test_max_sequence_len_of_a_ragged_value_matches_jax():
    vals = np.zeros((9, 1), np.float32)
    splits = np.array([0, 2, 2, 7, 9], np.int32)
    j = jop("max_sequence_len").kernel(
        None, {"RankTable": [JRagged(jnp.asarray(vals), [splits])]},
        {})["Out"][0]
    t = top("max_sequence_len").kernel(
        None, {"RankTable": [RaggedTensor(torch.from_numpy(vals),
                                          [torch.from_numpy(splits)])]},
        {})["Out"][0]
    _equal(t, j, "Out")
    assert t.tolist() == [5]


def _ifelse_program(fluid):
    """tests/test_lod_machinery.py:158: rows with x < 0 negate, the
    others pass."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        layers = fluid.layers
        x = layers.data(name="x", shape=[1], dtype="float32")
        zero = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        cond = layers.less_than(x=x, y=zero)
        ie = layers.IfElse(cond)
        with ie.true_block():
            ie.output(layers.scale(x=ie.input(x), scale=-1.0))
        with ie.false_block():
            ie.output(ie.input(x))
        out = ie()
    return main, out


@pytest.mark.parametrize("xs", [[-1.0, 2.0, -3.0, 4.0], [5.0, 6.0],
                                [-7.0, -8.0, -9.0]])
def test_ifelse_row_routing_matches_jax(xs):
    jmain, jout = _ifelse_program(jfluid)
    tmain, tout = _ifelse_program(tfluid)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    feed = {"x": np.asarray(xs, np.float32).reshape(-1, 1)}
    j, = jfluid.Executor(jfluid.CPUPlace()).run(jmain, feed=feed,
                                                fetch_list=[jout])
    t, = tfluid.Executor(CPU).run(tmain, feed=feed, fetch_list=[tout])
    _equal(t, j, "out")
    np.testing.assert_array_equal(t.reshape(-1), np.abs(xs))


def _split_merge(x_j, x_t, mask):
    """split_lod_tensor then merge_lod_tensor through both packages:
    {slot: (jax value, port value)}."""
    res = {}
    for name, op, x, m in (("j", jop, x_j, mask),
                           ("t", top, x_t, torch.from_numpy(mask))):
        parts = op("split_lod_tensor").kernel(None, {"X": [x], "Mask": [m]},
                                              {})
        merged = op("merge_lod_tensor").kernel(
            None, {"X": [x], "Mask": [m], "InTrue": parts["OutTrue"],
                   "InFalse": parts["OutFalse"]}, {})["Out"][0]
        res[name] = {"OutTrue": parts["OutTrue"][0],
                     "OutFalse": parts["OutFalse"][0], "Out": merged}
    return {k: (res["j"][k], res["t"][k]) for k in res["j"]}


@pytest.mark.parametrize("mask", [[1, 0, 1], [0, 0, 0], [1, 1, 1]])
def test_split_merge_ragged_roundtrip_matches_jax(mask):
    """tests/test_lod_machinery.py:183, and a mask with no true and no
    false sequence: the parts and the merge equal the JAX side's, and
    the merge is the input."""
    vals = np.arange(12, dtype=np.float32).reshape(6, 2)
    splits = np.array([0, 1, 4, 6], np.int32)          # lengths 1, 3, 2
    mask = np.asarray(mask, np.int32).reshape(-1, 1)
    res = _split_merge(JRagged(jnp.asarray(vals), [splits]),
                       RaggedTensor(torch.from_numpy(vals),
                                    [torch.from_numpy(splits)]), mask)
    for slot, (j, t) in res.items():
        _equal(t, j, slot)
    merged = res["Out"][1]
    np.testing.assert_array_equal(merged.values.numpy(), vals)
    assert merged.lod() == [splits.tolist()]


def test_split_merge_dense_roundtrip_matches_jax():
    x = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    mask = np.array([[True], [False], [False], [True], [False]])
    res = _split_merge(jnp.asarray(x), torch.from_numpy(x), mask)
    for slot, (j, t) in res.items():
        _equal(t, j, slot)
    np.testing.assert_array_equal(res["Out"][1].numpy(), x)
