"""The rest of the sequence ops, the CRF ops and `cos_sim` in the port
against the JAX package's, on the CPU.

- Each op's forward through both executors' `apply_op`, and its generic
  grad (`torch.func.vjp` against `jax.vjp`) where it has one, on ragged
  inputs made from a numpy seed with an empty and a length-1 sequence
  and rows past `nvalid` that pad the flat length (filled with 1e4, so
  a padding row that leaked would show): `sequence_softmax`,
  `sequence_conv` (filters 1 to 4), `row_conv`, `sequence_expand`
  (dense and ragged X), `sequence_concat` (time and features),
  `sequence_reshape` (wider and narrower rows), `sequence_slice`,
  `sequence_reverse`, `lod_reset` (attr and TargetLoD), `gru` (reversed,
  other activations, an initial state; f32 and under the bf16 policy),
  `gru_unit`, `cos_sim` (and a broadcast Y) and `linear_chain_crf`.
- `crf_decoding`: the Viterbi paths equal the JAX package's exactly,
  a tie built by hand goes to the first tag, and with a Label the match
  mask equals too; `chunk_eval`'s six outputs equal under each scheme.
- Every new layer appends the JAX package's ops and vars
  (`to_dict()`), and the port registers these 15 op types among its
  108.

Tolerances: f32 outputs and grads at atol 1e-5 times the larger of 1
and the largest magnitude (the same f32 arithmetic summed in other
orders), 1e-6 absolute below that; under the bf16 policy, outputs at
atol 1e-2 and grads at 2e-2 of their largest magnitude, as
tests/test_torch_sequence.py holds the lstm.  Integer outputs, Viterbi
paths, chunk counts and the structure of ragged outputs (splits,
`nvalid`) must be equal.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import crf as tcrf
from paddle_tpu_torch.ops.registry import registered_ops
from test_torch_sequence import (BF16_ATOL, BF16_GRAD_RTOL, PAD_FILL,
                                 Ragged, _apply_both, _bf16_guard,
                                 _compare, _grad_ins, ragged)

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

LENGTHS = [3, 0, 5, 1, 4]
NEW_OPS = ["cos_sim", "sequence_conv", "linear_chain_crf", "crf_decoding",
           "chunk_eval", "sequence_softmax", "row_conv", "sequence_expand",
           "sequence_concat", "sequence_reshape", "sequence_slice",
           "sequence_reverse", "lod_reset", "gru", "gru_unit"]


def _og_like(x, width, seed):
    """A ragged output grad over x's structure."""
    og = np.random.RandomState(seed).randn(x.values.shape[0], width)
    return Ragged(og.astype(np.float32), x.splits, x.nvalid, x.max_seqlen)


def _check(op, ins, outs, attrs, og, grads, amp=False):
    """The forward and the generic grad of `op` against JAX's."""
    with _bf16_guard(amp):
        fwd = _apply_both(op, ins, outs, attrs)
        _compare(fwd, atol=BF16_ATOL if amp else None)
        grad = _apply_both(op + "_grad", _grad_ins(ins, outs, og),
                           {s + "@GRAD": [n + "@GRAD"] for s, n in grads},
                           attrs)
        _compare(grad, grad_rtol=BF16_GRAD_RTOL if amp else None)
    return fwd, grad


def test_the_port_registers_the_fifteen_new_op_types():
    """The 15 op types of the sequence-op slice; the port's count since
    the nested-sequence slice added seq_unnest, seq_outer_expand,
    seq_renest, print, beam_search, beam_search_decode and sign, the
    optimizer and layer stack's slice 44 more, the observability slice
    isfinite and count_nonfinite, the parameter-server slice
    split_selected_rows and dist_send, the entry-point slice 15
    (ops/nn.py, conv2d_transpose, 6 losses, 3 metrics), and A10's last
    op groups 32 (the rest of ops/conv.py, ops/v2_extra.py,
    ops/detection.py, feed, fetch, save and load), the program
    analysis slice fused_elemwise_chain, the mesh slice get_places, and
    the recompute slice recompute_barrier."""
    ops = set(registered_ops())
    assert set(NEW_OPS) <= ops
    assert len(ops) == 213


# -- sequence_softmax, sequence_conv, row_conv ---------------------------------

def test_sequence_softmax_matches_jax():
    x = ragged(LENGTHS, 1, seed=1)
    fwd, grad = _check("sequence_softmax", {"X": [("x", x)]},
                       {"Out": ["o"]}, {}, {"Out": _og_like(x, 1, 2)},
                       [("X", "x")])
    out = fwd["Out"][0][1].values.numpy()[:, 0]
    np.testing.assert_allclose(out[:3].sum(), 1.0, atol=1e-6)
    assert out[8] == 1.0 and not out[x.nvalid:].any()


@pytest.mark.parametrize("filter_size", [1, 2, 3, 4])
def test_sequence_conv_matches_jax(filter_size):
    D, M = 5, 6
    x = ragged(LENGTHS, D, seed=3)
    filt = np.random.RandomState(4).randn(filter_size * D, M).astype(
        np.float32)
    attrs = {"contextStart": -(filter_size // 2),
             "contextLength": filter_size, "contextStride": 1}
    fwd, grad = _check("sequence_conv",
                       {"X": [("x", x)], "Filter": [("f", filt)]},
                       {"Out": ["o"]}, attrs, {"Out": _og_like(x, M, 5)},
                       [("X", "x"), ("Filter", "f")])
    # rows past nvalid come out 0 and take no grad
    assert not fwd["Out"][0][1].values[x.nvalid:].any()
    assert not grad["X@GRAD"][0][1].values[x.nvalid:].any()


def test_sequence_conv_filter_4_takes_offsets_minus_2_to_1():
    """contextStart -(4 // 2): row i reads rows i-2 .. i+1 of its own
    sequence (zeros outside it)."""
    x = Ragged(np.arange(1, 6, dtype=np.float32).reshape(5, 1), [0, 5], 5,
               8)
    filt = np.eye(4, dtype=np.float32)
    out = _apply_both("sequence_conv",
                      {"X": [("x", x)], "Filter": [("f", filt)]},
                      {"Out": ["o"]},
                      {"contextStart": -2, "contextLength": 4})["Out"][0][1]
    np.testing.assert_array_equal(out.values.numpy()[2], [1, 2, 3, 4])
    np.testing.assert_array_equal(out.values.numpy()[4], [3, 4, 5, 0])


def test_row_conv_matches_jax():
    x = ragged(LENGTHS, 4, seed=6)
    filt = np.random.RandomState(7).randn(3, 4).astype(np.float32)
    _check("row_conv", {"X": [("x", x)], "Filter": [("f", filt)]},
           {"Out": ["o"]}, {}, {"Out": _og_like(x, 4, 8)},
           [("X", "x"), ("Filter", "f")])


# -- sequence_expand, sequence_concat, sequence_reshape ------------------------

@pytest.mark.parametrize("ragged_x", [False, True])
def test_sequence_expand_matches_jax(ragged_x):
    y = ragged(LENGTHS, 2, seed=9)
    if ragged_x:
        x = ragged([2, 1, 3, 1, 2], 3, seed=10)
    else:
        x = np.random.RandomState(10).randn(len(LENGTHS), 3).astype(
            np.float32)
    _check("sequence_expand", {"X": [("x", x)], "Y": [("y", y)]},
           {"Out": ["o"]}, {}, {"Out": _og_like(y, 3, 11)},
           [("X", "x")])


@pytest.mark.parametrize("n_inputs", [2, 3])
def test_sequence_concat_in_time_matches_jax(n_inputs):
    xs = [ragged(lengths, 3, seed=12 + i) for i, lengths in enumerate(
        ([3, 0, 5, 1, 4], [1, 2, 0, 3, 1], [0, 1, 1, 2, 2])[:n_inputs])]
    ins = {"X": [("x%d" % i, x) for i, x in enumerate(xs)]}
    fwd = _apply_both("sequence_concat", ins, {"Out": ["o"]}, {"axis": 0})
    _compare(fwd)
    j = fwd["Out"][0][0]
    og = Ragged(np.random.RandomState(15).randn(*j.values.shape).astype(
        np.float32), np.array(j.last_splits()), int(j.nvalid), None)
    grad = _apply_both("sequence_concat_grad",
                       _grad_ins(ins, {"Out": ["o"]}, {"Out": og}),
                       {"X@GRAD": ["x%d@GRAD" % i for i in range(n_inputs)]},
                       {"axis": 0})
    _compare(grad)


def test_sequence_concat_in_features_matches_jax():
    a, b = ragged(LENGTHS, 3, seed=16), ragged(LENGTHS, 2, seed=17)
    _check("sequence_concat", {"X": [("a", a), ("b", b)]}, {"Out": ["o"]},
           {"axis": 1}, {"Out": _og_like(a, 5, 18)}, [("X", "a")])


@pytest.mark.parametrize("width,new_dim", [(4, 2), (2, 4), (6, 4)])
def test_sequence_reshape_matches_jax(width, new_dim):
    lengths = [2, 0, 4, 2, 2] if (width, new_dim) != (6, 4) \
        else [2, 0, 4, 2, 4]
    x = ragged(lengths, width, seed=19, pad=2)
    fwd = _apply_both("sequence_reshape", {"X": [("x", x)]}, {"Out": ["o"]},
                      {"new_dim": new_dim})
    _compare(fwd)
    j = fwd["Out"][0][0]
    og = Ragged(np.random.RandomState(20).randn(*j.values.shape).astype(
        np.float32), np.array(j.last_splits()), int(j.nvalid), None)
    grad = _apply_both("sequence_reshape_grad",
                       _grad_ins({"X": [("x", x)]}, {"Out": ["o"]},
                                 {"Out": og}),
                       {"X@GRAD": ["x@GRAD"]}, {"new_dim": new_dim})
    _compare(grad)


# -- sequence_slice, sequence_reverse, lod_reset -------------------------------

def test_sequence_slice_matches_jax():
    x = ragged(LENGTHS, 3, seed=21)
    offset = np.array([[1], [0], [2], [0], [0]], np.int64)
    length = np.array([[2], [0], [3], [1], [4]], np.int64)
    ins = {"X": [("x", x)], "Offset": [("off", offset)],
           "Length": [("len", length)]}
    fwd, _ = _check("sequence_slice", ins, {"Out": ["o"]}, {},
                    {"Out": _og_like(x, 3, 22)}, [("X", "x")])
    out = fwd["Out"][0][1]
    assert out.lod() == [[0, 2, 2, 5, 6, 10]]
    assert out.values.shape[0] == x.values.shape[0]
    assert not out.values[10:].any()


def test_sequence_reverse_matches_jax():
    x = ragged(LENGTHS, 3, seed=23)
    fwd, _ = _check("sequence_reverse", {"X": [("x", x)]}, {"Y": ["y"]},
                    {}, {"Y": _og_like(x, 3, 24)}, [("X", "x")])
    np.testing.assert_array_equal(fwd["Y"][0][1].values.numpy()[:3],
                                  x.values[2::-1])


@pytest.mark.parametrize("by_input", [False, True])
def test_lod_reset_matches_jax(by_input):
    x = np.random.RandomState(25).randn(7, 3).astype(np.float32)
    ins = {"X": [("x", x)]}
    attrs = {}
    if by_input:
        ins["TargetLoD"] = [("t", np.array([0, 2, 2, 7], np.int32))]
    else:
        attrs = {"target_lod": [0, 4, 7]}
    og = np.random.RandomState(26).randn(7, 3).astype(np.float32)
    fwd, _ = _check("lod_reset", ins, {"Out": ["o"]}, attrs,
                    {"Out": Ragged(og, [0, 7], 7, None)}, [("X", "x")])
    assert fwd["Out"][0][1].lod() == ([[0, 2, 2, 7]] if by_input
                                      else [[0, 4, 7]])


# -- gru, gru_unit --------------------------------------------------------------

GRU_CASES = {
    # name: (lengths, hidden, attrs, with h0)
    "forward": ([3, 0, 7, 1, 5], 6, {}, False),
    "reverse": ([4, 1, 0, 6, 2], 5, {"is_reverse": True}, False),
    "activations": ([5, 2, 8], 4, {"gate_activation": "sigmoid",
                                   "activation": "relu"}, False),
    "h0_reverse": ([3, 6, 1], 4, {"is_reverse": True}, True),
}
GRU_OUTS = {"Hidden": ["h"], "BatchGate": ["bg"],
            "BatchResetHiddenPrev": ["br"], "BatchHidden": ["bh"]}


@pytest.mark.parametrize("amp", [False, True])
@pytest.mark.parametrize("case", sorted(GRU_CASES))
def test_gru_matches_jax(case, amp):
    lengths, hidden, attrs, with_h0 = GRU_CASES[case]
    x = ragged(lengths, 3 * hidden, seed=len(case))
    x.values = x.values * 0.5
    x.values[x.nvalid:] = PAD_FILL
    if amp:
        x.values = x.values.astype(ml_dtypes.bfloat16)
    rs = np.random.RandomState(len(case) + 1)
    ins = {"Input": [("x", x)],
           "Weight": [("w", (rs.randn(hidden, 3 * hidden) * 0.3).astype(
               np.float32))],
           "Bias": [("b", (rs.randn(1, 3 * hidden) * 0.3).astype(
               np.float32))]}
    grads = [("Input", "x"), ("Weight", "w"), ("Bias", "b")]
    if with_h0:
        ins["H0"] = [("h0", rs.randn(len(lengths), hidden).astype(
            np.float32))]
        grads.append(("H0", "h0"))
    fwd, grad = _check("gru", ins, GRU_OUTS, attrs,
                       {"Hidden": _og_like(x, hidden, 27)}, grads, amp=amp)
    h = fwd["Hidden"][0][1]
    assert h.values.dtype == (torch.bfloat16 if amp else torch.float32)
    assert not h.values[sum(lengths):].float().any()
    assert not grad["Input@GRAD"][0][1].values[sum(lengths):].float().any()


def test_gru_reset_gate_multiplies_before_the_product():
    """h = u h + (1 - u) c with c = tanh(x_c + (r h) W_c): one step from
    a known h0, by hand."""
    D = 2
    rs = np.random.RandomState(28)
    xv = rs.randn(1, 3 * D).astype(np.float32)
    w = rs.randn(D, 3 * D).astype(np.float32)
    h0 = rs.randn(1, D).astype(np.float32)
    x = Ragged(xv, [0, 1], 1, 8)
    out = _apply_both("gru", {"Input": [("x", x)], "Weight": [("w", w)],
                              "H0": [("h0", h0)]},
                      GRU_OUTS, {})["Hidden"][0][1].values.numpy()
    sig = 1 / (1 + np.exp(-(xv[:, :2 * D] + h0 @ w[:, :2 * D])))
    u, r = sig[:, :D], sig[:, D:]
    c = np.tanh(xv[:, 2 * D:] + (r * h0) @ w[:, 2 * D:])
    np.testing.assert_allclose(out, u * h0 + (1 - u) * c, atol=1e-6)


@pytest.mark.parametrize("amp", [False, True])
def test_gru_unit_matches_jax(amp):
    N, D = 4, 5
    rs = np.random.RandomState(29)
    x = (rs.randn(N, 3 * D) * 0.5).astype(np.float32)
    if amp:
        x = x.astype(ml_dtypes.bfloat16)
    ins = {"Input": [("x", x)],
           "HiddenPrev": [("h", rs.randn(N, D).astype(np.float32))],
           "Weight": [("w", (rs.randn(D, 3 * D) * 0.3).astype(np.float32))],
           "Bias": [("b", (rs.randn(1, 3 * D) * 0.3).astype(np.float32))]}
    outs = {"Gate": ["g"], "ResetHiddenPrev": ["r"], "Hidden": ["o"]}
    og = {"Hidden": rs.randn(N, D).astype(np.float32),
          "Gate": rs.randn(N, 3 * D).astype(np.float32)}
    _check("gru_unit", ins, outs, {}, og,
           [("Input", "x"), ("HiddenPrev", "h"), ("Weight", "w"),
            ("Bias", "b")], amp=amp)


# -- cos_sim --------------------------------------------------------------------

@pytest.mark.parametrize("y_rows", [6, 1])
def test_cos_sim_matches_jax(y_rows):
    rs = np.random.RandomState(30)
    x = rs.randn(6, 7).astype(np.float32)
    y = rs.randn(y_rows, 7).astype(np.float32)
    x[2] = 0.0  # a zero row: the 1e-12 keeps it finite
    outs = {"Out": ["o"], "XNorm": ["xn"], "YNorm": ["yn"]}
    fwd, _ = _check("cos_sim", {"X": [("x", x)], "Y": [("y", y)]}, outs,
                    {}, {"Out": rs.randn(6, 1).astype(np.float32)},
                    [("X", "x"), ("Y", "y")])
    out = fwd["Out"][0][1].numpy()
    assert out[2, 0] == 0.0 and np.all(np.abs(out) <= 1 + 1e-6)


# -- linear_chain_crf, crf_decoding, chunk_eval --------------------------------

def _crf_inputs(lengths, D, seed):
    e = ragged(lengths, D, seed=seed)
    rs = np.random.RandomState(seed + 1)
    label = Ragged(rs.randint(0, D, size=(e.values.shape[0], 1)).astype(
        np.int32), e.splits, e.nvalid, e.max_seqlen)
    trans = (rs.randn(D + 2, D) * 0.5).astype(np.float32)
    return e, label, trans


CRF_OUTS = {"Alpha": ["al"], "EmissionExps": ["ee"],
            "TransitionExps": ["te"], "LogLikelihood": ["ll"]}


@pytest.mark.parametrize("lengths", [[3, 1, 5, 4], [1, 6, 2, 1, 3]])
def test_linear_chain_crf_matches_jax(lengths):
    e, label, trans = _crf_inputs(lengths, 4, seed=31)
    ins = {"Emission": [("e", e)], "Transition": [("t", trans)],
           "Label": [("l", label)]}
    og = {"LogLikelihood": np.random.RandomState(32).randn(
        len(lengths), 1).astype(np.float32)}
    fwd, _ = _check("linear_chain_crf", ins, CRF_OUTS, {}, og,
                    [("Emission", "e"), ("Transition", "t")])
    nll = fwd["LogLikelihood"][0][1].numpy()
    assert nll.shape == (len(lengths), 1) and np.all(nll > 0)


def test_linear_chain_crf_length_one_is_start_emission_end():
    """A sequence of one step: log Z = logsumexp(a + e_0 + b), the gold
    score a[y] + e_0[y] + b[y]."""
    e, label, trans = _crf_inputs([1], 3, seed=33)
    ll = _apply_both("linear_chain_crf", {
        "Emission": [("e", e)], "Transition": [("t", trans)],
        "Label": [("l", label)]}, CRF_OUTS, {})["LogLikelihood"][0][1]
    s = trans[0] + e.values[0] + trans[1]
    y = int(label.values[0, 0])
    want = np.log(np.exp(s).sum()) - s[y]
    np.testing.assert_allclose(ll.numpy()[0, 0], want, atol=1e-5)


@pytest.mark.parametrize("with_label", [False, True])
def test_crf_decoding_paths_equal_jax(with_label):
    e, label, trans = _crf_inputs([3, 0, 7, 1, 5, 2], 5, seed=34)
    ins = {"Emission": [("e", e)], "Transition": [("t", trans)]}
    if with_label:
        ins["Label"] = [("l", label)]
    pairs = _apply_both("crf_decoding", ins, {"ViterbiPath": ["p"]}, {})
    j, t = pairs["ViterbiPath"][0]
    assert t.values.dtype == torch.int32 and t.lod() == j.lod()
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    if not with_label:
        assert t.values.numpy()[:18].max() > 0


def test_crf_decoding_tie_goes_to_the_first_tag():
    """Every emission and transition equal: every path ties, and numpy's
    argmax (the JAX side) and the port both take tag 0 throughout; a
    tie between tags 1 and 3 at the end goes to 1."""
    D = 4
    e = Ragged(np.zeros((5, D), np.float32), [0, 2, 5], 5, 8)
    trans = np.zeros((D + 2, D), np.float32)
    ins = {"Emission": [("e", e)], "Transition": [("t", trans)]}
    j, t = _apply_both("crf_decoding", ins, {"ViterbiPath": ["p"]},
                       {})["ViterbiPath"][0]
    np.testing.assert_array_equal(t.values.numpy().ravel(), [0] * 5)
    np.testing.assert_array_equal(np.asarray(j.values).ravel(), [0] * 5)
    trans[1] = [0.0, 1.0, 0.0, 1.0]   # end weights: tags 1 and 3 tie
    j, t = _apply_both("crf_decoding", ins, {"ViterbiPath": ["p"]},
                       {})["ViterbiPath"][0]
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    assert t.values.numpy()[1, 0] == 1 and t.values.numpy()[4, 0] == 1


def test_viterbi_tags_score_the_best_path():
    """The port's batched Viterbi against every path, by brute force."""
    import itertools

    rs = np.random.RandomState(35)
    D, T = 3, 4
    ev = rs.randn(T, D)
    trans = rs.randn(D + 2, D)
    e = Ragged(ev.astype(np.float32), [0, T], T, 8)
    tags = tcrf.viterbi_tags(e.port(), torch.from_numpy(trans))[0].numpy()
    ev = ev.astype(np.float32).astype(np.float64)

    def score(p):
        return trans[0][p[0]] + sum(ev[i][p[i]] for i in range(T)) + sum(
            trans[2 + p[i]][p[i + 1]] for i in range(T - 1)) + trans[1][p[-1]]

    best = max(itertools.product(range(D), repeat=T), key=score)
    np.testing.assert_array_equal(tags[:T], best)


CHUNK_CASES = {
    # scheme: (num_chunk_types, tag values, excluded types)
    "IOB": (3, 7, []),
    "IOE": (2, 5, []),
    "IOBES": (2, 9, [1]),
    "plain": (4, 5, []),
}


@pytest.mark.parametrize("scheme", sorted(CHUNK_CASES))
def test_chunk_eval_matches_jax(scheme):
    num_types, n_tags, excluded = CHUNK_CASES[scheme]
    rs = np.random.RandomState(36)
    lengths = [6, 0, 9, 1, 12]
    total = sum(lengths)
    lbl = rs.randint(0, n_tags, size=(total, 1)).astype(np.int32)
    inf = np.where(rs.rand(total, 1) < 0.7, lbl,
                   rs.randint(0, n_tags, size=(total, 1))).astype(np.int32)
    splits = np.cumsum([0] + lengths)
    ins = {"Inference": [("i", Ragged(inf, splits, total, 16))],
           "Label": [("l", Ragged(lbl, splits, total, 16))]}
    outs = {s: [s.lower()] for s in (
        "Precision", "Recall", "F1-Score", "NumInferChunks",
        "NumLabelChunks", "NumCorrectChunks")}
    attrs = {"num_chunk_types": num_types, "chunk_scheme": scheme,
             "excluded_chunk_types": excluded}
    pairs = _apply_both("chunk_eval", ins, outs, attrs)
    for slot, ((j, t),) in pairs.items():
        assert t.dtype == (torch.int32 if slot.startswith("Num")
                           else torch.float32), slot
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=slot)
    assert int(pairs["NumCorrectChunks"][0][1][0]) > 0


# -- the layers' descs ----------------------------------------------------------

def _build_layers(fluid, which):
    """One program per layer (or pair), built through `fluid`."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = L.data(name="x", shape=[12], dtype="float32", lod_level=1)
        y = L.data(name="y", shape=[12], dtype="float32", lod_level=1)
        d = L.data(name="d", shape=[12], dtype="float32")
        ids = L.data(name="ids", shape=[1], dtype="int64", lod_level=1)
        if which == "cos_sim":
            L.cos_sim(X=d, Y=L.fc(input=d, size=12))
        elif which == "sequence_conv":
            L.sequence_conv(input=x, num_filters=8, filter_size=4,
                            act="tanh")
        elif which == "dynamic_gru":
            L.dynamic_gru(input=x, size=4, is_reverse=True)
        elif which == "gru_unit":
            h = L.fc(input=d, size=5)
            L.gru_unit(input=L.fc(input=d, size=15), hidden=h, size=15)
        elif which == "sequence_softmax":
            L.sequence_softmax(L.fc(input=x, size=1))
        elif which == "sequence_concat":
            L.sequence_concat(input=[x, y])
            L.sequence_concat(input=[x, y], axis=1)
        elif which == "sequence_slice":
            off = L.data(name="off", shape=[1], dtype="int64")
            ln = L.data(name="len", shape=[1], dtype="int64")
            L.sequence_slice(input=x, offset=off, length=ln)
        elif which == "lod_reset":
            L.lod_reset(d, target_lod=[0, 2, 5])
            L.lod_reset(d, y=L.data(name="t", shape=[1], dtype="int32"))
        elif which == "sequence_reverse":
            L.sequence_reverse(x)
        elif which == "sequence_expand":
            L.sequence_expand(x=d, y=y)
        elif which == "sequence_reshape":
            L.sequence_reshape(input=x, new_dim=4)
        elif which == "row_conv":
            L.row_conv(input=x, future_context_size=2, act="relu")
        elif which == "crf":
            emission = L.fc(input=x, size=7)
            cost = L.linear_chain_crf(
                input=emission, label=ids,
                param_attr=fluid.ParamAttr(name="crfw"))
            path = L.crf_decoding(input=emission,
                                  param_attr=fluid.ParamAttr(name="crfw"))
            L.crf_decoding(input=emission, label=ids,
                           param_attr=fluid.ParamAttr(name="crfw"))
            L.chunk_eval(input=path, label=ids, chunk_scheme="IOB",
                         num_chunk_types=3)
            fluid.optimizer.SGD(learning_rate=0.01).minimize(
                L.mean(x=cost))
    return main, startup


LAYERS = ["cos_sim", "sequence_conv", "dynamic_gru", "gru_unit",
          "sequence_softmax", "sequence_concat", "sequence_slice",
          "lod_reset", "sequence_reverse", "sequence_expand",
          "sequence_reshape", "row_conv", "crf"]


@pytest.mark.parametrize("which", LAYERS)
def test_layer_descs_equal_jax(which):
    jmain, jstartup = _build_layers(jfluid, which)
    tmain, tstartup = _build_layers(tfluid, which)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    assert tstartup.desc.to_dict() == jstartup.desc.to_dict()
