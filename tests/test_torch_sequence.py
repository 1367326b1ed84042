"""The sequence op kernels of the stacked-LSTM path in the port against
the JAX package's, on the CPU, forward and grads, on ragged inputs made
from a numpy seed: mixed lengths, an empty sequence, and rows past
`nvalid` that pad the flat length to a bucket (filled with 1e4, so a
padding row that leaked would show).

- `sequence_pool`, all six pool types, including tied maxima (values
  drawn from {-1, 0, 1}: JAX's segment max splits the gradient evenly
  among ties, and so must the port).
- `lstm`, with peepholes on and off, `is_reverse`, the three activation
  attrs, f32 and under the bf16 policy (bf16 input, f32 weights).
- The ragged branches of the other ops on the path: `lookup_table` and
  its grad over ragged ids, `mul`, `elementwise_add`, `sum`, `mean`,
  the activations, `softmax` and `cross_entropy`.

Each op runs through both executors' `apply_op`; a grad op is laid out
as the backward builder lays it out and runs the generic vjp on both
sides (`torch.func.vjp` against `jax.vjp`).

Tolerances: f32 outputs and grads at atol 1e-5 times the larger of 1
and the largest magnitude (the same f32 arithmetic summed in other
orders; the recurrence runs up to 16 steps).  Under the bf16 policy,
outputs at atol 1e-2 (bf16's 8 mantissa bits: 2 units in the last place
of values up to 1, from products rounded to bf16 after f32 sums in
other orders) and grads at 2e-2 of their largest magnitude.  Integer
outputs and the structure of ragged outputs (splits, `nvalid`) must be
equal.
"""

import contextlib

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401 — registers the JAX kernels
import paddle_tpu.fluid as jfluid
from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.ragged import RaggedTensor as JRagged
from paddle_tpu.fluid import executor as jexec
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.desc import OpDesc
from paddle_tpu_torch.core.ragged import RaggedTensor
from paddle_tpu_torch.core.types import tensor_from_numpy
from paddle_tpu_torch.fluid import executor as texec
from paddle_tpu_torch.ops import sequence as tseq

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

EMPTY = "@EMPTY@"
F32_ATOL = 1e-5
BF16_ATOL = 1e-2
BF16_GRAD_RTOL = 2e-2
PAD_FILL = 1e4


class Ragged:
    """A ragged input spec: flat values (padding rows included),
    lod-level-1 splits, nvalid, max_seqlen."""

    def __init__(self, values, splits, nvalid, max_seqlen):
        self.values, self.splits = values, np.asarray(splits, np.int32)
        self.nvalid, self.max_seqlen = nvalid, max_seqlen

    def jax(self):
        return JRagged(jnp.asarray(self.values), [self.splits],
                       nvalid=self.nvalid, max_seqlen=self.max_seqlen)

    def port(self):
        return RaggedTensor(tensor_from_numpy(self.values, "cpu"),
                            [torch.from_numpy(self.splits)],
                            nvalid=self.nvalid, max_seqlen=self.max_seqlen)


def ragged(lengths, width, seed, ties=False, dtype=np.float32, pad=3,
           hi=None):
    """Ragged values of `lengths` rows of `width` (ints in [0, hi) when
    `hi`), then `pad` padding rows filled with PAD_FILL (or hi - 1)."""
    rs = np.random.RandomState(seed)
    total = int(sum(lengths))
    if hi is not None:
        vals = rs.randint(0, hi, size=(total + pad, width)).astype(dtype)
        vals[total:] = hi - 1
    else:
        vals = (rs.randint(-1, 2, size=(total + pad, width)) if ties
                else rs.randn(total + pad, width)).astype(np.float32)
        vals[total:] = PAD_FILL
        vals = vals.astype(dtype)
    splits = np.cumsum([0] + list(lengths))
    return Ragged(vals, splits, total, max(8, max(lengths)))


def _to_jax(v):
    if isinstance(v, Ragged):
        return v.jax()
    return jnp.asarray(v)


def _to_port(v):
    if isinstance(v, Ragged):
        return v.port()
    return tensor_from_numpy(v, "cpu")


def _apply_both(op_type, ins, outs, attrs):
    """Run op `op_type` through both executors' apply_op.  ins: {slot:
    [(name, ndarray, Ragged or None)]}; outs: {slot: [name]}.  Returns
    {slot: [(jax value, port value)]}."""
    names = {s: [n if a is not None else EMPTY for n, a in v]
             for s, v in ins.items()}
    values = {n: a for v in ins.values() for n, a in v if a is not None}
    jctx = jexec.ExecContext(None, None, 0,
                             {n: _to_jax(a) for n, a in values.items()})
    jexec.apply_op(jctx, JOpDesc(op_type, names, outs, attrs))
    tctx = texec.ExecContext(None, 0,
                             {n: _to_port(a) for n, a in values.items()},
                             device=torch.device("cpu"))
    texec.apply_op(tctx, OpDesc(op_type, names, outs, attrs))
    return {slot: [(jctx.env[n], tctx.env[n]) for n in out_names]
            for slot, out_names in outs.items()}


def _host(v):
    """(values as f32 or int ndarray, lod or None)."""
    if isinstance(v, (JRagged, RaggedTensor)):
        lod = v.lod()
        v = v.values
    else:
        lod = None
    if isinstance(v, torch.Tensor):
        v = v.float() if v.dtype == torch.bfloat16 else v
        return v.numpy(), lod
    v = np.asarray(v)
    return (v.astype(np.float32) if v.dtype.name == "bfloat16" else v), lod


def _compare(pairs, atol=None, grad_rtol=None):
    for slot, ps in pairs.items():
        for j, t in ps:
            assert isinstance(t, RaggedTensor) == isinstance(j, JRagged), slot
            (jv, jlod), (tv, tlod) = _host(j), _host(t)
            assert tlod == jlod, slot
            assert tv.shape == jv.shape, (slot, tv.shape, jv.shape)
            if np.issubdtype(jv.dtype, np.integer):
                np.testing.assert_array_equal(tv, jv, err_msg=slot)
                continue
            scale = max(1.0, float(np.abs(jv).max()) if jv.size else 1.0)
            tol = (grad_rtol * scale if grad_rtol is not None
                   else atol if atol is not None else F32_ATOL * scale)
            np.testing.assert_allclose(tv, jv, atol=tol, rtol=0,
                                       err_msg=slot)


def _grad_ins(fwd_ins, fwd_outs, out_grads):
    """A generic grad op's inputs: the forward's inputs, its outputs (as
    O@ slots, unread) and the out grads (OG@ slots; None for EMPTY)."""
    ins = dict(fwd_ins)
    for slot, names in fwd_outs.items():
        ins["O@" + slot] = [(n, None) for n in names]
        ins["OG@" + slot] = [(n + "@GRAD", out_grads.get(slot))
                             for n in names]
    return ins


# -- sequence_pool ------------------------------------------------------------

POOL_TYPES = ["SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST"]
LENGTHS = [3, 0, 5, 1, 4]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("pooltype", POOL_TYPES)
def test_sequence_pool_matches_jax(pooltype, ties):
    x = ragged(LENGTHS, 4, seed=1, ties=ties)
    attrs = {"pooltype": pooltype}
    outs = {"Out": ["o"], "MaxIndex": ["mi"]}
    _compare(_apply_both("sequence_pool", {"X": [("x", x)]}, outs, attrs))
    og = np.random.RandomState(2).randn(len(LENGTHS), 4).astype(np.float32)
    grad = _apply_both(
        "sequence_pool_grad",
        _grad_ins({"X": [("x", x)]}, outs, {"Out": og}),
        {"X@GRAD": ["x@GRAD"]}, attrs)
    _compare(grad)
    gx = grad["X@GRAD"][0][1]
    # the padding rows get no grad
    assert not gx.values[x.nvalid:].any()
    if pooltype == "MAX" and ties:
        # ties split the grad: some row gets a fraction of its sequence's
        seg_rows = gx.values[:x.nvalid].numpy()
        assert np.any((np.abs(seg_rows) > 0)
                      & (np.abs(seg_rows) < np.abs(og).max() - 1e-6))


def test_sequence_pool_max_tie_split_is_even():
    """[1, 3, 3]: the grad of the max goes half to each tied 3."""
    x = Ragged(np.array([[1.0], [3.0], [3.0]], np.float32), [0, 3], 3, 8)
    outs = {"Out": ["o"], "MaxIndex": ["mi"]}
    grad = _apply_both(
        "sequence_pool_grad",
        _grad_ins({"X": [("x", x)]}, outs,
                  {"Out": np.ones((1, 1), np.float32)}),
        {"X@GRAD": ["x@GRAD"]}, {"pooltype": "MAX"})
    j, t = grad["X@GRAD"][0]
    np.testing.assert_array_equal(t.values.numpy().ravel(), [0, 0.5, 0.5])
    np.testing.assert_array_equal(np.asarray(j.values).ravel(),
                                  [0, 0.5, 0.5])


def test_empty_sequences_pool_to_zero():
    x = ragged([0, 2, 0], 3, seed=3)
    for pooltype in ("SUM", "AVERAGE", "SQRT", "MAX"):
        out = _apply_both("sequence_pool", {"X": [("x", x)]},
                          {"Out": ["o"], "MaxIndex": ["mi"]},
                          {"pooltype": pooltype})["Out"][0][1]
        assert not out[0].any() and not out[2].any() and out[1].any()


# -- lstm ---------------------------------------------------------------------

LSTM_CASES = {
    # name: (lengths, hidden, attrs)
    "peepholes": ([3, 7, 1, 5], 6, {}),
    "no_peepholes": ([3, 7, 1, 5], 6, {"use_peepholes": False}),
    "reverse": ([4, 0, 6, 2], 5, {"is_reverse": True}),
    "activations": ([5, 2, 8], 4, {"gate_activation": "sigmoid",
                                   "cell_activation": "relu",
                                   "candidate_activation": "identity"}),
    "long": ([16, 9, 12, 3, 1], 8, {}),
}


def _lstm_inputs(lengths, hidden, attrs, seed, bf16=False):
    peep = attrs.get("use_peepholes", True)
    x = ragged(lengths, 4 * hidden, seed=seed)
    x.values = x.values * 0.5
    x.values[x.nvalid:] = PAD_FILL
    rs = np.random.RandomState(seed + 1)
    w = (rs.randn(hidden, 4 * hidden) * 0.3).astype(np.float32)
    b = (rs.randn(1, (7 if peep else 4) * hidden) * 0.3).astype(np.float32)
    if bf16:
        x.values = x.values.astype(ml_dtypes.bfloat16)
    return {"Input": [("x", x)], "Weight": [("w", w)], "Bias": [("b", b)]}


LSTM_OUTS = {"Hidden": ["h"], "Cell": ["c"], "BatchGate": ["bg"],
             "BatchCellPreAct": ["bc"]}


def _bf16_guard(amp):
    if not amp:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(jfluid.amp.bf16_guard())
    stack.enter_context(tfluid.amp.bf16_guard())
    return stack


@pytest.mark.parametrize("amp", [False, True])
@pytest.mark.parametrize("case", sorted(LSTM_CASES))
def test_lstm_matches_jax(case, amp):
    lengths, hidden, attrs = LSTM_CASES[case]
    ins = _lstm_inputs(lengths, hidden, attrs, seed=len(case), bf16=amp)
    with _bf16_guard(amp):
        fwd = _apply_both("lstm", ins, LSTM_OUTS, attrs)
        _compare(fwd, atol=BF16_ATOL if amp else None)
        h = fwd["Hidden"][0][1]
        assert h.values.dtype == (torch.bfloat16 if amp else torch.float32)
        # padding rows come out 0, nothing of PAD_FILL leaks
        assert not h.values[sum(lengths):].float().any()
        assert float(h.values.float().abs().max()) < 10
        x = ins["Input"][0][1]
        rs = np.random.RandomState(7)
        og_h = rs.randn(x.values.shape[0], hidden).astype(np.float32)
        og_c = rs.randn(x.values.shape[0], hidden).astype(np.float32)
        og = {"Hidden": Ragged(og_h, x.splits, x.nvalid, x.max_seqlen),
              "Cell": Ragged(og_c, x.splits, x.nvalid, x.max_seqlen)}
        grad = _apply_both(
            "lstm_grad", _grad_ins(ins, LSTM_OUTS, og),
            {"Input@GRAD": ["x@GRAD"], "Weight@GRAD": ["w@GRAD"],
             "Bias@GRAD": ["b@GRAD"]}, attrs)
        _compare(grad, grad_rtol=BF16_GRAD_RTOL if amp else None)
    gx = grad["Input@GRAD"][0][1]
    assert not gx.values[sum(lengths):].float().any()
    assert float(grad["Weight@GRAD"][0][1].abs().max()) > 0


def test_lstm_steps_past_a_length_keep_the_carry():
    """A sequence's last hidden state equals the one it reaches alone."""
    lengths, hidden, attrs = [2, 6], 3, {}
    ins = _lstm_inputs(lengths, hidden, attrs, seed=4)
    both = _apply_both("lstm", ins, LSTM_OUTS, attrs)["Hidden"][0][1]
    x = ins["Input"][0][1]
    alone = Ragged(x.values[:2], [0, 2], 2, 8)
    ins["Input"] = [("x", alone)]
    first = _apply_both("lstm", ins, LSTM_OUTS, attrs)["Hidden"][0][1]
    np.testing.assert_allclose(both.values[:2].numpy(),
                               first.values.numpy(), atol=1e-6, rtol=0)


def test_ragged_to_padded_round_trip():
    x = ragged([3, 0, 5, 2], 2, seed=5).port()
    padded, lens = tseq.ragged_to_padded(x)
    assert tuple(padded.shape) == (4, 8, 2) and lens.tolist() == [3, 0, 5, 2]
    assert not padded[1].any() and not padded[0, 3:].any()
    torch.testing.assert_close(padded[2, :5], x.values[3:8])
    back = tseq.padded_to_ragged(padded, x)
    torch.testing.assert_close(back.values[:10], x.values[:10])
    assert not back.values[10:].any() and back.lod() == x.lod()


# -- the ragged branches of the other ops on the path -------------------------

def test_lookup_table_over_ragged_ids_matches_jax():
    ids = ragged([3, 0, 4], 1, seed=6, dtype=np.int32, hi=20)
    w = np.random.RandomState(7).randn(20, 5).astype(np.float32)
    ins = {"Ids": [("ids", ids)], "W": [("w", w)]}
    outs = {"Out": ["o"]}
    for padding_idx in (-1, 3):
        attrs = {"padding_idx": padding_idx, "is_sparse": False}
        fwd = _apply_both("lookup_table", ins, outs, attrs)
        _compare(fwd)
        og = Ragged(np.random.RandomState(8).randn(10, 5).astype(np.float32),
                    ids.splits, ids.nvalid, ids.max_seqlen)
        grad = _apply_both("lookup_table_grad", _grad_ins(ins, outs,
                                                          {"Out": og}),
                           {"W@GRAD": ["w@GRAD"]}, attrs)
        _compare(grad)
    # the padding rows' ids (19) get no grad
    assert not grad["W@GRAD"][0][1][19].any()


def _dense(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


OTHER_OPS = {
    # name: (op type, ins, outs, attrs)
    "mul": ("mul", lambda x: {"X": [("x", x)], "Y": [("y", _dense(4, 6,
                                                                  seed=9))]},
            {"Out": ["o"]}, {"x_num_col_dims": 1, "y_num_col_dims": 1}),
    "elementwise_add": ("elementwise_add",
                        lambda x: {"X": [("x", x)],
                                   "Y": [("y", _dense(4, seed=10))]},
                        {"Out": ["o"]}, {"axis": 1}),
    "sum": ("sum", lambda x: {"X": [("x", x), ("x2", Ragged(
        _dense(*x.values.shape, seed=11), x.splits, x.nvalid,
        x.max_seqlen))]}, {"Out": ["o"]}, {}),
    "mean": ("mean", lambda x: {"X": [("x", x)]}, {"Out": ["o"]}, {}),
    "sigmoid": ("sigmoid", lambda x: {"X": [("x", x)]}, {"Out": ["o"]}, {}),
    "tanh": ("tanh", lambda x: {"X": [("x", x)]}, {"Out": ["o"]}, {}),
    "softmax": ("softmax", lambda x: {"X": [("x", x)]}, {"Out": ["o"]}, {}),
}


@pytest.mark.parametrize("name", sorted(OTHER_OPS))
def test_ragged_branches_match_jax(name):
    op_type, make_ins, outs, attrs = OTHER_OPS[name]
    x = ragged([2, 3, 0, 1], 4, seed=12)
    if name != "mean":
        x.values[x.nvalid:] = 0.5   # padding rows stay finite here
    ins = make_ins(x)
    fwd = _apply_both(op_type, ins, outs, attrs)
    _compare(fwd)
    j_out = fwd["Out"][0][0]
    og = (Ragged(_dense(*j_out.values.shape, seed=13), x.splits, x.nvalid,
                 x.max_seqlen) if isinstance(j_out, JRagged)
          else _dense(*np.asarray(j_out).shape, seed=13))
    grad_outs = {slot + "@GRAD": [n + "@GRAD" for n, _ in v]
                 for slot, v in ins.items()}
    _compare(_apply_both(op_type + "_grad", _grad_ins(ins, outs,
                                                      {"Out": og}),
                         grad_outs, attrs))


def test_ragged_cross_entropy_matches_jax():
    rs = np.random.RandomState(14)
    probs = rs.rand(9, 3).astype(np.float32) + 0.1
    probs /= probs.sum(1, keepdims=True)
    x = Ragged(probs, [0, 4, 6], 6, 8)
    label = rs.randint(0, 3, size=(9, 1)).astype(np.int32)
    ins = {"X": [("x", x)], "Label": [("l", label)]}
    outs = {"Y": ["y"]}
    fwd = _apply_both("cross_entropy", ins, outs, {"soft_label": False})
    _compare(fwd)
    og = Ragged(_dense(9, 1, seed=15), x.splits, x.nvalid, x.max_seqlen)
    _compare(_apply_both("cross_entropy_grad",
                         _grad_ins(ins, outs, {"Y": og}),
                         {"X@GRAD": ["x@GRAD"]}, {"soft_label": False}))
