"""Nested sequences, `print`, the beam ops, the ragged inputs of
`concat`, `increment`, the `reduce_*` family, `dropout` and `accuracy`,
`sign`, and the weight-decay regularizers: the port against the JAX
package, on the CPU, on inputs made from a numpy seed.

- `seq_unnest`, `seq_outer_expand` and `seq_renest` over a lod-level-2
  input with rows that pad it past `nvalid` (filled with 1e4): outputs
  and splits exactly (they move splits and rows); `seq_outer_expand`'s
  generic grad at the f32 tolerance (its gather's grad sums repeated
  rows); `seq_renest`'s check that the outer splits cover the step's
  rows raises on both sides.
- tests/test_lod_machinery.py's nested DynamicRNN (:98) and `Print`
  (:208), built by both packages' layers: descs equal, outputs exactly,
  the printed line equal.
- `beam_search` and `beam_search_decode` on tests/test_beam_detection_ops.py's
  inputs (:51, :89) and on seeded ones over several steps and sources:
  ids, scores and both levels of splits exactly (host bookkeeping on
  both sides); their layers' descs equal.
- The five ops' ragged inputs (and `split` and `scale`, which the v2
  layers hand ragged values): outputs and splits equal to the JAX
  kernels', exactly where nothing is summed, sums and means at rtol
  1e-6; `increment`, whose JAX kernel raises a TypeError on a
  RaggedTensor, adds to the values and keeps the splits; dropout in
  training keeps its splits and its mask's statistics (its stream is
  torch's), in test mode and its grad exactly.
- `sign` dense, exactly; ragged (which the JAX kernel does not take)
  keeping the splits.
- `L2Decay` and `L1Decay`, as the optimizer's `regularization` and as a
  parameter's own `regularizer`, with a `global_step`, under each of
  the nine optimizers: main and startup descs equal; 3 Momentum steps
  from one state at atol 1e-6 (f32, the same ops).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.core.ragged import RaggedTensor as JRagged
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.fluid import regularizer as jreg
from paddle_tpu.ops.registry import get_op_info as jop
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.ragged import RaggedTensor
from paddle_tpu_torch.fluid import regularizer as treg
from paddle_tpu_torch.ops.registry import get_op_info as top

from test_torch_sequence import (Ragged, _apply_both, _compare, _grad_ins,
                                 ragged)

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
PAD_FILL = 1e4


class Nested:
    """A lod-level-2 input spec: values (padding rows included), outer
    and inner splits, nvalid."""

    def __init__(self, values, outer, inner):
        self.values = values
        self.splits = [np.asarray(outer, np.int32),
                       np.asarray(inner, np.int32)]
        self.nvalid = int(self.splits[1][-1])

    def jax(self):
        return JRagged(jnp.asarray(self.values), self.splits,
                       nvalid=self.nvalid)

    def port(self):
        return RaggedTensor(torch.from_numpy(self.values),
                            [torch.from_numpy(s) for s in self.splits],
                            nvalid=self.nvalid, max_seqlen=8)


# documents of 2, 0 and 3 sentences of 2, 1 | - | 3, 1, 2 words, 3 wide,
# then 3 padding rows
NESTED = Nested(np.concatenate([
    np.random.RandomState(0).randn(9, 3),
    np.full((3, 3), PAD_FILL)]).astype(np.float32),
    [0, 2, 2, 5], [0, 2, 3, 6, 7, 9])


def _apply_nested(op_type, ins, outs, attrs=None):
    """_apply_both with Nested inputs allowed."""
    import test_torch_sequence as ts

    old_j, old_p = ts._to_jax, ts._to_port
    ts._to_jax = lambda v: v.jax() if isinstance(v, Nested) else old_j(v)
    ts._to_port = lambda v: v.port() if isinstance(v, Nested) else old_p(v)
    try:
        return _apply_both(op_type, ins, outs, attrs or {})
    finally:
        ts._to_jax, ts._to_port = old_j, old_p


def _exact(pairs):
    for slot, ps in pairs.items():
        for j, t in ps:
            assert isinstance(t, RaggedTensor) == isinstance(j, JRagged)
            if isinstance(j, JRagged):
                assert t.lod() == j.lod(), slot
                assert int(t.nvalid) == int(j.nvalid), slot
                j, t = j.values, t.values
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=slot)


# -- the nested-sequence ops -----------------------------------------------------

def test_seq_unnest_matches_jax():
    res = _apply_nested("seq_unnest", {"X": [("x", NESTED)]},
                        {"Inner": ["i"], "OuterRef": ["r"]})
    _exact(res)
    inner, ref = res["Inner"][0][1], res["OuterRef"][0][1]
    assert inner.lod() == [[0, 2, 3, 6, 7, 9]]
    assert ref.lod() == [[0, 2, 2, 5]] and tuple(ref.values.shape) == (5, 1)


def test_seq_outer_expand_and_grad_match_jax():
    """One row per document tiled over its sentences; the grad sums the
    rows of a document's sentences."""
    ref = Ragged(np.zeros((5, 1), np.float32), [0, 2, 2, 5], 5, None)
    x = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    ins = {"X": [("x", x)], "OuterRef": [("r", ref)]}
    res = _apply_both("seq_outer_expand", ins, {"Out": ["o"]}, {})
    _exact(res)
    np.testing.assert_array_equal(res["Out"][0][1].numpy(),
                                  x[[0, 0, 2, 2, 2]])
    og = np.random.RandomState(2).randn(5, 4).astype(np.float32)
    grad = _apply_both("seq_outer_expand_grad",
                       _grad_ins(ins, {"Out": ["o"]}, {"Out": og}),
                       {"X@GRAD": ["x@GRAD"]}, {})
    _compare(grad)
    np.testing.assert_allclose(grad["X@GRAD"][0][1].numpy()[1], 0.0)


@pytest.mark.parametrize("ragged_x", [False, True])
def test_seq_renest_matches_jax(ragged_x):
    """Dense rows, one per sentence, become a sequence over documents; a
    ragged x (each sentence's steps) the nested sequence again."""
    ref = Ragged(np.zeros((5, 1), np.float32), [0, 2, 2, 5], 5, None)
    if ragged_x:
        x = ragged([2, 1, 3, 1, 2], 3, seed=3)
    else:
        x = np.random.RandomState(3).randn(5, 3).astype(np.float32)
    res = _apply_both("seq_renest", {"X": [("x", x)], "OuterRef": [
        ("r", ref)]}, {"Out": ["o"]}, {})
    _exact(res)
    out = res["Out"][0][1]
    assert out.lod() == ([[0, 2, 2, 5], [0, 2, 3, 6, 7, 9]] if ragged_x
                         else [[0, 2, 2, 5]])


def test_seq_renest_checks_the_outer_splits():
    ref = Ragged(np.zeros((5, 1), np.float32), [0, 2, 2, 5], 5, None)
    x = np.zeros((4, 3), np.float32)
    for apply in ("jax", "port"):
        with pytest.raises(ValueError, match="cover 5 inner sequences"):
            if apply == "jax":
                jop("seq_renest").kernel(None, {"X": [jnp.asarray(x)],
                                                "OuterRef": [ref.jax()]}, {})
            else:
                top("seq_renest").kernel(None, {"X": [torch.from_numpy(x)],
                                                "OuterRef": [ref.port()]}, {})


def _nested_rnn(fluid):
    """tests/test_lod_machinery.py:98 through `fluid`'s layers."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[2], dtype="float32", lod_level=2)
        inner, outer_ref = layers.sequence_unnest(x)
        drnn_in = layers.DynamicRNN()
        with drnn_in.block():
            tok = drnn_in.step_input(inner)
            mem = drnn_in.memory(shape=[2], batch_ref=tok, value=0.0)
            acc = layers.elementwise_add(x=mem, y=tok)
            drnn_in.update_memory(mem, acc)
            drnn_in.output(acc)
        token_sums = layers.sequence_last_step(drnn_in())
        sent_seq = layers.sequence_renest(token_sums, outer_ref)
        drnn_out = layers.DynamicRNN()
        with drnn_out.block():
            sent = drnn_out.step_input(sent_seq)
            mem = drnn_out.memory(shape=[2], batch_ref=sent, value=0.0)
            acc = layers.elementwise_add(x=mem, y=sent)
            drnn_out.update_memory(mem, acc)
            drnn_out.output(acc)
        doc_enc = layers.sequence_last_step(drnn_out())
    return main, x, [doc_enc, sent_seq]


DOCS = [[[[1, 1], [2, 2]], [[3, 3]]], [[[10, 10]]],
        [[[1, 2]], [[3, 4], [5, 6], [7, 8]], [[9, 0]]]]


def test_nested_dynamic_rnn_matches_jax():
    """Token sums per sentence, then the sentence sums per document:
    both recurrences as DynamicRNNs over the flattened batch, the
    sentence-level sequence between them renested."""
    res = []
    for fluid in (jfluid, tfluid):
        main, x, outs = _nested_rnn(fluid)
        res.append((main, fluid.Executor(fluid.CPUPlace()).run(
            main, feed=fluid.DataFeeder(place=fluid.CPUPlace(), feed_list=[
                x]).feed([(d,) for d in DOCS]), fetch_list=outs,
            return_numpy=False)))
    (jmain, jout), (tmain, tout) = res
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(tout[0].numpy(),
                                  [[6, 6], [10, 10], [25, 20]])
    assert tout[1].lod() == jout[1].lod() == [[0, 2, 3, 6]]


def _print_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[2], dtype="float32")
        y = fluid.layers.Print(x, message="dbg", summarize=3)
        out = fluid.layers.mean(x=y)
    return main, out


def test_print_layer_matches_jax(capsys):
    """tests/test_lod_machinery.py:208: the print op forwards its input;
    both packages print the same line."""
    xs = np.arange(4, dtype=np.float32).reshape(2, 2)
    lines, res = [], []
    for fluid in (jfluid, tfluid):
        main, out = _print_program(fluid)
        res.append(fluid.Executor(fluid.CPUPlace()).run(
            main, feed={"x": xs}, fetch_list=[out])[0])
        lines.append(capsys.readouterr().out)
        res.append(main)
    assert res[3].desc.to_dict() == res[1].desc.to_dict()
    assert lines[1] == lines[0] == \
        "dbg var shape=(2, 2) dtype=float32 data=[0. 1. 2.]\n"
    assert float(np.asarray(res[2]).reshape(-1)[0]) == 1.5


def test_print_grad_passes_the_grad_through():
    """The port's print grad passes the output's grad through unprinted.
    The JAX package's print has no grad of its own: its generic vjp runs
    the host print on a tracer and raises (ROADMAP C), so a Print in a
    program the JAX package differentiates fails there."""
    import jax

    og = np.random.RandomState(4).randn(3, 2).astype(np.float32)
    out = top("print").grad_kernel(None, {"In": [torch.from_numpy(og * 2)],
                                          "OG@Out": [torch.from_numpy(og)]},
                                   {})
    np.testing.assert_array_equal(out["In@GRAD"][0].numpy(), og)
    with pytest.raises(jax.errors.TracerArrayConversionError):
        from paddle_tpu.ops.registry import run_generic_grad

        run_generic_grad(None, "print", {"In": [jnp.asarray(og * 2)],
                                         "OG@Out": [jnp.asarray(og)]}, {})


# -- the beam ops ------------------------------------------------------------------

def _two_level(values, lod0, lod1):
    vals = np.asarray(values)
    splits = [np.asarray(lod0, np.int32), np.asarray(lod1, np.int32)]
    return (JRagged(jnp.asarray(vals), splits),
            RaggedTensor(torch.from_numpy(vals),
                         [torch.from_numpy(s) for s in splits]))


def _beam_both(pre_ids, ids, scores, attrs):
    out = []
    for i, op in ((0, jop), (1, top)):
        res = op("beam_search").kernel(None, {
            "pre_ids": [pre_ids[i]], "ids": [ids[i]],
            "scores": [scores[i]]}, attrs)
        out.append((res["selected_ids"][0], res["selected_scores"][0]))
    return out


def _same_ragged(t, j, exact=True):
    assert t.lod() == j.lod()
    tv, jv = t.values.numpy(), np.asarray(j.values)
    if exact:
        np.testing.assert_array_equal(tv, jv)
    else:
        np.testing.assert_allclose(tv, jv, rtol=1e-6)


def test_beam_search_matches_jax():
    """tests/test_beam_detection_ops.py:51 (reference
    beam_search_op_test.cc): 2 sources x 2 beams, 3 candidates each,
    beam 2, end id 0; the row whose prefix ended is pruned."""
    lod = ([0, 2, 4], [0, 1, 2, 3, 4])
    pre = _two_level(np.asarray([[1], [2], [0], [4]], np.int64), *lod)
    ids = _two_level(np.asarray([[4, 2, 5], [2, 1, 3], [3, 5, 2],
                                 [8, 2, 1]], np.int64), *lod)
    sc = _two_level(np.asarray([[0.5, 0.3, 0.2], [0.6, 0.3, 0.1],
                                [0.9, 0.5, 0.1], [0.7, 0.5, 0.1]],
                               np.float32), *lod)
    (jid, jsc), (tid, tsc) = _beam_both(pre, ids, sc, {
        "level": 0, "beam_size": 2, "end_id": 0})
    _same_ragged(tid, jid)
    _same_ragged(tsc, jsc)
    assert tid.values.reshape(-1).tolist() == [4, 2, 8]
    assert tid.lod() == [[0, 2, 4], [0, 1, 2, 2, 3]]


def _beam_steps(n_src, beam, cands, steps, seed):
    """Per-step selections of `steps` beam_search calls over seeded
    candidates (the prefix ids of step t are step t-1's selections),
    through both packages: [(JAX (ids, scores), port (ids, scores))]."""
    rs = np.random.RandomState(seed)
    lod0 = np.arange(n_src + 1) * 1
    lod1 = np.arange(n_src + 1)
    pre_vals = np.zeros((n_src, 1), np.int64)
    out = []
    for _ in range(steps):
        rows = int(lod1[-1])
        # ids above the end id: no beam ends, so every step has rows
        # (the reference test prunes an ended one)
        ids = rs.randint(2, 20, size=(rows, cands)).astype(np.int64)
        scores = rs.rand(rows, cands).astype(np.float32)
        pre = _two_level(pre_vals, lod0, lod1)
        res = _beam_both(pre, _two_level(ids, lod0, lod1),
                         _two_level(scores, lod0, lod1),
                         {"level": 0, "beam_size": beam, "end_id": 1})
        (jid, jsc), (tid, tsc) = res
        _same_ragged(tid, jid)
        _same_ragged(tsc, jsc)
        out.append(res)
        # the next step's rows are this step's selected items
        lod0 = np.asarray(tid.row_splits[1])[np.asarray(tid.row_splits[0])]
        lod1 = np.arange(int(tid.row_splits[1][-1]) + 1)
        pre_vals = tid.values.numpy().astype(np.int64)
    return out


@pytest.mark.parametrize("n_src,beam,cands", [(1, 2, 3), (3, 3, 4)])
def test_beam_search_steps_match_jax(n_src, beam, cands):
    steps = _beam_steps(n_src, beam, cands, 4, seed=n_src)
    assert all(len(t[0].values) for _, t in steps)


def test_beam_search_decode_matches_jax():
    """tests/test_beam_detection_ops.py:89: two steps of one source
    traced back into [1, 3], [1, 4], [2, 5], fed as a list of per-step
    selections through both executors."""
    step0 = _two_level(np.asarray([[1], [2]], np.int64), [0, 2], [0, 1, 2])
    s0 = _two_level(np.asarray([[0.1], [0.2]], np.float32), [0, 2],
                    [0, 1, 2])
    step1 = _two_level(np.asarray([[3], [4], [5]], np.int64), [0, 2],
                       [0, 2, 3])
    s1 = _two_level(np.asarray([[0.3], [0.4], [0.5]], np.float32), [0, 2],
                    [0, 2, 3])
    res = []
    for i, fluid in ((0, jfluid), (1, tfluid)):
        prog = fluid.Program()
        block = prog.global_block()
        ids_v = block.create_var(name="ids_arr", shape=[1], dtype="int64")
        sc_v = block.create_var(name="sc_arr", shape=[1], dtype="float32")
        for n, d in (("sent_ids", "int64"), ("sent_scores", "float32")):
            block.create_var(name=n, shape=[1], dtype=d)
        block.append_op(type="beam_search_decode",
                        inputs={"Ids": [ids_v], "Scores": [sc_v]},
                        outputs={"SentenceIds": ["sent_ids"],
                                 "SentenceScores": ["sent_scores"]},
                        infer_shape=False)
        res.append(fluid.Executor(fluid.CPUPlace()).run(
            prog, feed={"ids_arr": [step0[i], step1[i]],
                        "sc_arr": [s0[i], s1[i]]},
            fetch_list=["sent_ids", "sent_scores"],
            scope=(JScope() if i == 0 else tfluid.Scope()),
            return_numpy=False))
    _same_ragged(res[1][0], res[0][0])
    _same_ragged(res[1][1], res[0][1])
    assert res[1][0].values.reshape(-1).tolist() == [1, 3, 1, 4, 2, 5]
    assert res[1][0].lod() == [[0, 3], [0, 2, 4, 6]]


@pytest.mark.parametrize("n_src,beam,cands", [(1, 2, 3), (3, 3, 4)])
def test_beam_search_decode_of_seeded_steps_matches_jax(n_src, beam, cands):
    """The selections of 4 seeded beam_search steps traced back by both
    packages: hypotheses, scores and both levels of splits exactly."""
    steps = _beam_steps(n_src, beam, cands, 4, seed=10 + n_src)
    outs = []
    for i, op in ((0, jop), (1, top)):
        ins = {"Ids": [[s[i][0] for s in steps]],
               "Scores": [[s[i][1] for s in steps]]}
        r = op("beam_search_decode").kernel(None, ins, {})
        outs.append((r["SentenceIds"][0], r["SentenceScores"][0]))
    _same_ragged(outs[1][0], outs[0][0])
    _same_ragged(outs[1][1], outs[0][1])
    assert outs[1][0].nseq(0) == n_src


def _beam_layers(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        layers = fluid.layers
        pre = layers.data(name="pre", shape=[1], dtype="int64", lod_level=2)
        ids = layers.data(name="ids", shape=[3], dtype="int64", lod_level=2)
        sc = layers.data(name="sc", shape=[3], dtype="float32", lod_level=2)
        sel_ids, sel_sc = layers.beam_search(pre, ids, sc, beam_size=2,
                                             end_id=0)
        layers.beam_search_decode([sel_ids], [sel_sc])
    return main


def test_beam_layers_descs_equal_jax():
    assert _beam_layers(tfluid).desc.to_dict() == \
        _beam_layers(jfluid).desc.to_dict()


# -- ragged inputs of concat, increment, reduce_*, dropout, accuracy -----------

X = ragged([2, 0, 3, 1], 3, seed=5)          # 6 rows, 3 padding rows


@pytest.mark.parametrize("axis", [0, 1])
def test_ragged_concat_matches_jax(axis):
    y = Ragged(np.random.RandomState(6).randn(*X.values.shape).astype(
        np.float32), X.splits, X.nvalid, X.max_seqlen)
    res = _apply_both("concat", {"X": [("x", X), ("y", y)]}, {"Out": ["o"]},
                      {"axis": axis})
    _exact(res)
    assert isinstance(res["Out"][0][1], RaggedTensor) == (axis == 1)


def test_ragged_increment_keeps_the_splits():
    """The JAX kernel's `x + step` raises a TypeError on a RaggedTensor
    (ROADMAP C); the port adds to the values and keeps the splits, as
    the JAX kernel does on the values."""
    with pytest.raises(TypeError):
        jop("increment").kernel(None, {"X": [X.jax()]}, {"step": 2.0})
    out = top("increment").kernel(None, {"X": [X.port()]},
                                  {"step": 2.0})["Out"][0]
    ref = jop("increment").kernel(None, {"X": [jnp.asarray(X.values)]},
                                  {"step": 2.0})["Out"][0]
    assert out.lod() == [X.splits.tolist()] and int(out.nvalid) == 6
    np.testing.assert_array_equal(out.values.numpy(), np.asarray(ref))


REDUCE_ATTRS = [
    {"dim": 0, "keep_dim": False}, {"dim": 0, "keep_dim": True},
    {"dim": 1, "keep_dim": True}, {"dim": -1, "keep_dim": False},
    {"dim": 0, "keep_dim": False, "reduce_all": True},
    {"dim": 0, "keep_dim": True, "reduce_all": True}]


@pytest.mark.parametrize("attrs", REDUCE_ATTRS,
                         ids=lambda a: "-".join("%s%s" % kv
                                                for kv in a.items()))
@pytest.mark.parametrize("op", ["reduce_sum", "reduce_mean", "reduce_max",
                                "reduce_min"])
def test_ragged_reduce_matches_jax(op, attrs):
    """Across the rows, the padding rows (1e4) count for nothing; over a
    feature dim with keep_dim the result stays ragged."""
    res = _apply_both(op, {"X": [("x", X)]}, {"Out": ["o"]}, attrs)
    (j, t), = res["Out"]
    assert isinstance(t, RaggedTensor) == isinstance(j, JRagged)
    if isinstance(j, JRagged):
        assert t.lod() == j.lod()
        j, t = j.values, t.values
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                               atol=1e-6)
    assert np.abs(t.numpy()).max() < 100.0 or attrs["dim"] == 1 or \
        attrs["dim"] == -1


def test_ragged_dropout_in_training_keeps_splits():
    x = ragged([40, 0, 60], 8, seed=7, pad=5)
    out = _apply_both("dropout", {"X": [("x", x)]},
                      {"Out": ["o"], "Mask": ["m"]},
                      {"dropout_prob": 0.3, "fix_seed": True, "seed": 3})
    (_, t), = out["Out"]
    (_, mask), = out["Mask"]
    assert t.lod() == [x.splits.tolist()] and int(t.nvalid) == 100
    mask = mask.numpy()
    keep = mask[:100].mean()
    assert abs(keep - 0.7) < 5 * np.sqrt(0.21 / 800)
    np.testing.assert_array_equal(t.values.numpy(), x.values * mask)


def test_ragged_dropout_in_test_mode_and_grad_match_jax():
    attrs = {"dropout_prob": 0.3, "is_test": True}
    res = _apply_both("dropout", {"X": [("x", X)]},
                      {"Out": ["o"], "Mask": ["m"]}, attrs)
    _compare(res)
    mask = (np.random.RandomState(8).rand(*X.values.shape) > 0.3).astype(
        np.float32)
    og = Ragged(np.random.RandomState(9).randn(*X.values.shape).astype(
        np.float32), X.splits, X.nvalid, X.max_seqlen)
    for test_mode in (False, True):
        grad = _apply_both("dropout_grad", {
            "X": [("x", X)], "O@Out": [("o", X)], "O@Mask": [("m", mask)],
            "OG@Out": [("g", og)]}, {"X@GRAD": ["gx"]},
            {"dropout_prob": 0.3, "is_test": test_mode})
        _exact(grad)


@pytest.mark.parametrize("ragged_slot", ["Indices", "Label", "both"])
def test_ragged_accuracy_matches_jax(ragged_slot):
    """The padding rows' hits count neither as hits nor in the total."""
    rs = np.random.RandomState(10)
    idx = rs.randint(0, 4, size=(9, 2)).astype(np.int32)
    lab = rs.randint(0, 4, size=(9, 1)).astype(np.int32)
    idx[6:] = 3
    lab[6:] = 3
    splits = [0, 2, 2, 6]
    ins = {"Out": [("o", idx.astype(np.float32))],
           "Indices": [("i", Ragged(idx, splits, 6, 4)
                        if ragged_slot != "Label" else idx[:6])],
           "Label": [("l", Ragged(lab, splits, 6, 4)
                      if ragged_slot != "Indices" else lab[:6])]}
    if ragged_slot == "Indices":
        ins["Label"] = [("l", lab)]
    if ragged_slot == "Label":
        ins["Indices"] = [("i", idx)]
    res = _apply_both("accuracy", ins, {"Accuracy": ["a"], "Correct": ["c"],
                                        "Total": ["t"]}, {"k": 2})
    _exact(res)
    assert int(res["Total"][0][1][0]) == 6


@pytest.mark.parametrize("ragged_x", [False, True])
def test_sign_matches_jax(ragged_x):
    """The JAX kernel takes a dense X (a parameter, for the L1 decay);
    the port's also keeps a ragged X's splits, its values' signs the
    JAX kernel's of the values."""
    x = ragged([2, 3], 4, seed=11, ties=True)
    if not ragged_x:
        _exact(_apply_both("sign", {"X": [("x", x.values)]}, {"Out": ["o"]},
                           {}))
        return
    out = top("sign").kernel(None, {"X": [x.port()]}, {})["Out"][0]
    ref = jop("sign").kernel(None, {"X": [jnp.asarray(x.values)]},
                             {})["Out"][0]
    assert out.lod() == [x.splits.tolist()]
    np.testing.assert_array_equal(out.values.numpy(), np.asarray(ref))


def test_sign_layer_desc_equals_jax():
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[3], dtype="float32")
            fluid.layers.sign(x)
        return main

    assert build(tfluid).desc.to_dict() == build(jfluid).desc.to_dict()


@pytest.mark.parametrize("axis", [0, 1])
def test_ragged_split_and_scale_match_jax(axis):
    """The v2 layers' multi-head attention splits ragged projections by
    feature and scales a ragged score."""
    res = _apply_both("split", {"X": [("x", X)]}, {"Out": ["a", "b", "c"]},
                      {"axis": axis, "num": 3, "sections": []}) \
        if axis else _apply_both("split", {"X": [("x", X)]},
                                 {"Out": ["a", "b"]},
                                 {"axis": 0, "num": 0, "sections": [4, 5]})
    _exact(res)
    _compare(_apply_both("scale", {"X": [("x", X)]}, {"Out": ["o"]},
                         {"scale": 0.5}))


# -- regularizers -------------------------------------------------------------------

OPTIMIZERS = {
    "SGD": {}, "Momentum": {"momentum": 0.9}, "Adagrad": {},
    "Adam": {}, "Adamax": {}, "DecayedAdagrad": {}, "Adadelta": {},
    "RMSProp": {}, "Ftrl": {}}


def _regularized(fluid, reg, opt, kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        layers = fluid.layers
        x = layers.data(name="x", shape=[4], dtype="float32")
        h = layers.fc(input=x, size=5, act="tanh", param_attr=fluid.ParamAttr(
            regularizer=reg.L1Decay(0.01)))
        y = layers.fc(input=h, size=2)
        loss = layers.mean(x=layers.square(y))
        step = layers.create_global_var(shape=[1], value=0.0,
                                        dtype="float32", persistable=True,
                                        name="global_step")
        getattr(fluid.optimizer, opt)(
            learning_rate=0.1, regularization=reg.L2Decay(8e-4),
            global_step=step, **kw).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_regularized_descs_equal_jax(opt):
    """L2Decay as the optimizer's regularization, L1Decay as the first
    fc weight's own regularizer (`sign` and `scale` of the weight, then
    `sum` into its grad), and a global step one `increment` advances."""
    jmain, jstart, _ = _regularized(jfluid, jreg, opt, OPTIMIZERS[opt])
    tmain, tstart, _ = _regularized(tfluid, treg, opt, OPTIMIZERS[opt])
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    assert tstart.desc.to_dict() == jstart.desc.to_dict()
    types = [op.type for op in tmain.desc.block(0).ops]
    assert types.count("sign") == 1 and types[-1] == "increment"
    assert types.count("sum") >= 4


def test_regularized_momentum_steps_match_jax():
    """3 Momentum steps with both decays from the JAX startup's state:
    the loss, the parameters, the velocities and the global step at atol
    1e-6."""
    jmain, jstart, jloss = _regularized(jfluid, jreg, "Momentum",
                                        {"momentum": 0.9})
    tmain, tstart, tloss = _regularized(tfluid, treg, "Momentum",
                                        {"momentum": 0.9})
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    names = [n for n, vd in tstart.desc.block(0).vars.items()
             if vd.persistable]
    tscope = tfluid.Scope()
    tfluid.io.params_from_numpy(tscope, {n: np.asarray(jscope.get(n))
                                         for n in names}, "cpu")
    texe = tfluid.Executor(CPU)
    feed = {"x": np.random.RandomState(12).randn(6, 4).astype(np.float32)}
    for _ in range(3):
        jl = jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)[0]
        tl = texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)[0]
        np.testing.assert_allclose(tl, np.asarray(jl), atol=1e-6)
    for n in names:
        np.testing.assert_allclose(tscope.get(n).numpy(),
                                   np.asarray(jscope.get(n)), atol=1e-6,
                                   err_msg=n)
    assert float(tscope.get("global_step").numpy()[0]) == 3.0
