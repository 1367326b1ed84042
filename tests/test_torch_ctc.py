"""CTC in the port against the JAX package, on the CPU, on inputs made
from a numpy seed; and the CRNN-CTC text recognizer built by both.

- `warpctc`'s loss and generic grad through both executors (`_apply_both`)
  on ragged logits with padding rows past `nvalid` (filled with 1e4),
  a length-1 sequence, a repeated label, an empty label, blank 0 and
  blank C - 1, with and without `norm_by_times`: f32 at atol 1e-5
  times the larger of 1 and the largest magnitude (the same log-space
  arithmetic in other orders over 9 steps).  JAX's grad is held against
  `jax.vjp` of its kernel directly, and the port's loss and grad against
  `F.ctc_loss` over `log_softmax` (PyTorch's own CTC, a second
  implementation of the same function) at the same tolerance.
- `ctc_align` (merging on and off), `edit_distance` (plain,
  `normalized`, `ignored_tokens`, an empty hypothesis) and
  `sequence_erase`: outputs and splits equal exactly.
- `im2sequence` with kh, kw > 1, strides and asymmetric padding, and its
  generic grad, at the f32 tolerance; `top_k` over a ragged input keeps
  its splits.
- `tests/test_ctc_training.py`'s flow (its program, seed and data): 3
  SGD steps through both packages from one state (losses and
  parameters at 1e-5 of their size), then its 200 steps and greedy
  decode through the port (the JAX test's criterion, decode exact).
- CRNN-CTC (PaddlePaddle/models fluid/ocr_recognition
  crnn_ctc_model.py, built by chip_smoke.py's `build_crnn` through
  each package's layers, with ctc_train.py's L2 decay and gradient clip
  on every parameter): the training, inference and startup descs
  equal between the packages at full width (1 x 48 x 512 images, four
  conv groups, GRUs of 200, 95 classes + blank); at a narrow width (one conv
  group, 8 x 32 images, GRUs of 16, 10 classes) 2 Momentum steps from
  one state match the JAX side (loss at atol 1e-5 of its size, each
  tensor's change in relative L2 at 1e-4: the convolutions' and the
  batch norms' sums run in other orders); the decode and edit distance
  of the inference program equal the JAX side's exactly; its export,
  served by InferenceEngine and InferenceServer on the CPU, gives the
  executor's ids.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.core.ragged import RaggedTensor as JRagged
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import io as tio
from chip_smoke import build_crnn, crnn_decode_state, crnn_samples
from test_ctc_training import FEAT, V, _make_data
from test_torch_sequence import (F32_ATOL, Ragged, _apply_both, _compare,
                                 _grad_ins, ragged)

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

CPU = tfluid.CPUPlace()


def _labels(lengths, classes, blank, seed, repeat=False):
    """Ragged [L, 1] int32 labels in [0, classes] less the blank."""
    rs = np.random.RandomState(seed)
    pool = [c for c in range(classes + 1) if c != blank]
    vals = [pool[rs.randint(len(pool))] for _ in range(sum(lengths))]
    if repeat and len(vals) > 1:
        vals[1] = vals[0]           # a label that repeats: a blank between
    vals = np.asarray(vals + [pool[0]], np.int32).reshape(-1, 1)
    splits = np.cumsum([0] + list(lengths))
    return Ragged(vals, splits, int(sum(lengths)), max(8, max(lengths)))


# -- warpctc --------------------------------------------------------------

T_LENGTHS = [9, 1, 6, 4]
L_LENGTHS = [3, 1, 2, 0]
C = 6


@pytest.mark.parametrize("blank", [0, C - 1])
@pytest.mark.parametrize("norm", [False, True])
def test_warpctc_matches_jax(blank, norm):
    logits = ragged(T_LENGTHS, C, seed=1)
    label = _labels(L_LENGTHS, C - 1, blank, seed=2, repeat=True)
    ins = {"Logits": [("lg", logits)], "Label": [("lb", label)]}
    outs = {"Loss": ["loss"], "WarpCTCGrad": ["wg"]}
    attrs = {"blank": blank, "norm_by_times": norm}
    fwd = _apply_both("warpctc", ins, outs, attrs)
    _compare(fwd)
    loss = fwd["Loss"][0][1]
    assert torch.isfinite(loss).all() and (loss > 0).all()
    assert not fwd["WarpCTCGrad"][0][1].values.any()
    og = np.random.RandomState(3).randn(len(T_LENGTHS), 1) \
        .astype(np.float32)
    grad = _apply_both("warpctc_grad", _grad_ins(ins, outs, {"Loss": og}),
                       {"Logits@GRAD": ["lg@GRAD"]}, attrs)
    _compare(grad)
    g = grad["Logits@GRAD"][0][1]
    # no grad reaches the rows that pad the flat length
    assert not g.values[sum(T_LENGTHS):].any()


def test_jax_warpctc_grad_is_jax_vjp():
    """JAX's warpctc_grad is jax.vjp of its forward: held here against
    jax.vjp called directly, so the port's match above is a match with
    the vjp."""
    logits = ragged(T_LENGTHS, C, seed=4)
    label = _labels(L_LENGTHS, C - 1, 0, seed=5)
    og = np.random.RandomState(6).randn(len(T_LENGTHS), 1) \
        .astype(np.float32)
    kernel = jreg.get_op_info("warpctc").kernel
    jl = label.jax()

    def f(values):
        lg = JRagged(values, [logits.splits], nvalid=logits.nvalid,
                     max_seqlen=logits.max_seqlen)
        return kernel(None, {"Logits": [lg], "Label": [jl]},
                      {"blank": 0, "norm_by_times": True})["Loss"][0]

    _, vjp = jax.vjp(f, jnp.asarray(logits.values))
    want, = vjp(jnp.asarray(og))
    ins = {"Logits": [("lg", logits)], "Label": [("lb", label)]}
    outs = {"Loss": ["loss"], "WarpCTCGrad": ["wg"]}
    grad = _apply_both("warpctc_grad", _grad_ins(ins, outs, {"Loss": og}),
                       {"Logits@GRAD": ["lg@GRAD"]},
                       {"blank": 0, "norm_by_times": True})
    got = grad["Logits@GRAD"][0][1].values.numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=F32_ATOL * scale)


@pytest.mark.parametrize("norm", [False, True])
def test_warpctc_matches_torch_ctc_loss(norm):
    """F.ctc_loss over log_softmax of the logits, divided by each
    sequence's length where norm_by_times is set: the same loss, and
    its autograd the same grad as the port's generic vjp."""
    lengths, label_lengths, blank = [7, 5, 8], [3, 2, 4], 0
    logits = ragged(lengths, C, seed=7, pad=0)
    label = _labels(label_lengths, C - 1, blank, seed=8, repeat=True)
    ins = {"Logits": [("lg", logits)], "Label": [("lb", label)]}
    outs = {"Loss": ["loss"], "WarpCTCGrad": ["wg"]}
    attrs = {"blank": blank, "norm_by_times": norm}
    og = np.ones((len(lengths), 1), np.float32)
    port = _apply_both("warpctc", ins, outs, attrs)["Loss"][0][1]
    gport = _apply_both("warpctc_grad", _grad_ins(ins, outs, {"Loss": og}),
                        {"Logits@GRAD": ["lg@GRAD"]},
                        attrs)["Logits@GRAD"][0][1].values

    x = torch.from_numpy(logits.values).requires_grad_(True)
    padded = torch.zeros(max(lengths), len(lengths), C)
    for b, (lo, n) in enumerate(zip(np.cumsum([0] + lengths), lengths)):
        padded[:n, b] = x[lo:lo + n]
    targets = torch.from_numpy(label.values[:sum(label_lengths), 0]).long()
    ref = F.ctc_loss(F.log_softmax(padded, -1), targets,
                     torch.tensor(lengths), torch.tensor(label_lengths),
                     blank=blank, reduction="none", zero_infinity=False)
    if norm:
        ref = ref / torch.tensor(lengths, dtype=ref.dtype)
    ref.sum().backward()
    scale = max(1.0, float(ref.detach().abs().max()))
    np.testing.assert_allclose(port.reshape(-1).numpy(),
                               ref.detach().numpy(), rtol=0,
                               atol=F32_ATOL * scale)
    np.testing.assert_allclose(gport.numpy(), x.grad.numpy(), rtol=0,
                               atol=F32_ATOL)


# -- ctc_align, edit_distance, sequence_erase ------------------------------

def _ids(seqs, pad=2, fill=7):
    """Ragged [N, 1] int32 ids of the host sequences `seqs`, then `pad`
    padding rows of `fill`."""
    flat = [t for s in seqs for t in s] + [fill] * pad
    return Ragged(np.asarray(flat, np.int32).reshape(-1, 1),
                  np.cumsum([0] + [len(s) for s in seqs]),
                  sum(len(s) for s in seqs), 8)


ALIGN_SEQS = [[0, 1, 1, 0, 2, 2, 0, 3, 0, 3], [], [5, 5, 5], [0, 0],
              [4, 0, 4, 4, 1]]


@pytest.mark.parametrize("blank", [0, 5])
@pytest.mark.parametrize("merge", [True, False])
def test_ctc_align_matches_jax(blank, merge):
    res = _apply_both("ctc_align", {"Input": [("x", _ids(ALIGN_SEQS))]},
                      {"Output": ["o"]},
                      {"blank": blank, "merge_repeated": merge})
    _compare(res)
    if blank == 0 and merge:
        got = res["Output"][0][1]
        assert got.lod() == [[0, 4, 4, 5, 5, 8]]
        assert got.values.reshape(-1).tolist() == [1, 2, 3, 3, 5, 4, 4, 1]


@pytest.mark.parametrize("normalized,ignored", [
    (False, []), (True, []), (False, [3]), (True, [0, 9])])
def test_edit_distance_matches_jax(normalized, ignored):
    hyps = _ids([[1, 2, 3], [5, 6, 7, 8], [], [3, 3], [9]])
    refs = _ids([[1, 3, 3, 4], [5, 6, 9, 8], [1, 2], [], [9]], fill=0)
    res = _apply_both("edit_distance", {"Hyps": [("h", hyps)],
                                        "Refs": [("r", refs)]},
                      {"Out": ["d"], "SequenceNum": ["n"]},
                      {"normalized": normalized, "ignored_tokens": ignored})
    for slot, ((j, t),) in res.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), slot)
        assert t.dtype == (torch.float32 if slot == "Out" else torch.int32)
    if not normalized and not ignored:
        assert res["Out"][0][1].reshape(-1).tolist() == [2, 1, 2, 2, 0]


def test_sequence_erase_matches_jax():
    res = _apply_both("sequence_erase",
                      {"X": [("x", _ids([[1, 0, 2, 0], [0, 3, 4], [0],
                                         [5]]))]},
                      {"Out": ["o"]}, {"tokens": [0, 5]})
    _compare(res)
    got = res["Out"][0][1]
    assert got.lod() == [[0, 2, 4, 4, 4]]
    assert got.values.reshape(-1).tolist() == [1, 2, 3, 4]


# -- im2sequence, ragged top_k ---------------------------------------------

@pytest.mark.parametrize("kernels,strides,paddings", [
    ([1, 1], [1, 1], [0, 0, 0, 0]),
    ([3, 2], [1, 1], [1, 1, 1, 1]),
    ([2, 3], [2, 1], [0, 1, 2, 1]),
    ([3, 1], [1, 1], [0, 0, 0, 0]),   # CRNN's: the image's height
])
def test_im2sequence_matches_jax(kernels, strides, paddings):
    x = np.random.RandomState(9).randn(2, 3, 3, 5).astype(np.float32)
    ins = {"X": [("x", x)]}
    outs = {"Out": ["o"]}
    attrs = {"kernels": kernels, "strides": strides, "paddings": paddings}
    fwd = _apply_both("im2sequence", ins, outs, attrs)
    _compare(fwd)
    j, t = fwd["Out"][0]
    steps = t.nseq() and t.values.shape[0] // t.nseq()
    assert t.max_seqlen == steps
    og = Ragged(np.random.RandomState(10).randn(*t.values.shape)
                .astype(np.float32), np.asarray(t.lod()[0]),
                t.values.shape[0], steps)
    _compare(_apply_both("im2sequence_grad", _grad_ins(ins, outs,
                                                       {"Out": og}),
                         {"X@GRAD": ["x@GRAD"]}, attrs))


def test_im2sequence_orders_a_patch_c_kh_kw():
    """The features of one patch run channel, then kernel row, then
    kernel column."""
    x = np.arange(2 * 2 * 3, dtype=np.float32).reshape(1, 2, 2, 3)
    res = _apply_both("im2sequence", {"X": [("x", x)]}, {"Out": ["o"]},
                      {"kernels": [2, 2], "strides": [1, 1],
                       "paddings": [0, 0, 0, 0]})
    got = res["Out"][0][1].values.numpy()
    want = np.stack([x[0, :, :, w:w + 2].reshape(-1) for w in range(2)])
    np.testing.assert_array_equal(got, want)


def test_top_k_over_ragged_matches_jax():
    x = ragged([3, 0, 5, 1], 6, seed=11, ties=True)
    res = _apply_both("top_k", {"X": [("x", x)]},
                      {"Out": ["o"], "Indices": ["i"]}, {"k": 2})
    _compare(res)
    assert res["Indices"][0][1].lod() == [[0, 3, 3, 8, 9]]


# -- tests/test_ctc_training.py's flow ---------------------------------------

def _ctc_flow(fluid):
    """The JAX test's program: (main, startup, loss, decoded, x, y)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[FEAT], dtype="float32",
                              lod_level=1)
        y = fluid.layers.data(name="y", shape=[1], dtype="int64",
                              lod_level=1)
        logits = fluid.layers.fc(input=x, size=V + 1, act=None)
        loss = fluid.layers.mean(
            x=fluid.layers.warpctc(input=logits, label=y, blank=0))
        decoded = fluid.layers.ctc_greedy_decoder(logits, blank=0)
        fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return main, startup, loss, decoded, x, y


def _persistables(main):
    return [n for n, v in main.desc.block(0).vars.items() if v.persistable]


def test_ctc_flow_steps_match_jax():
    jmain, jstartup, jloss, _, jx, jy = _ctc_flow(jfluid)
    tmain, tstartup, tloss, _, tx, ty = _ctc_flow(tfluid)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    assert tstartup.desc.to_dict() == jstartup.desc.to_dict()
    xs, ys = _make_data(np.random.RandomState(0))
    rows = list(zip(xs, ys))
    persist = _persistables(jmain)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    with jfluid.scope_guard(scope):
        exe.run(jstartup)
        init = {n: np.array(scope.get(n)) for n in persist}
        feed = jfluid.DataFeeder(place=jfluid.CPUPlace(),
                                 feed_list=[jx, jy]).feed(rows)
        jl = [float(np.asarray(exe.run(jmain, feed=feed,
                                       fetch_list=[jloss])[0])[0])
              for _ in range(3)]
        jfinal = {n: np.array(scope.get(n)) for n in persist}
    texe, tscope = tfluid.Executor(CPU), tfluid.Scope()
    tio.params_from_numpy(tscope, init, "cpu")
    feed = tfluid.DataFeeder(place=CPU, feed_list=[tx, ty]).feed(rows)
    tl = [float(texe.run(tmain, feed=feed, fetch_list=[tloss],
                         scope=tscope)[0][0]) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert tl[-1] < tl[0]
    params = {p.name for p in tmain.global_block().all_parameters()}
    for n in persist:
        got, want = tscope.get(n).numpy(), jfinal[n]
        assert n not in params or not np.array_equal(want, init[n]), n
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(
            1.0, float(np.abs(want).max())), err_msg=n)


def test_ctc_flow_converges_and_decodes_through_the_port():
    """tests/test_ctc_training.py's criterion through the port: 200 SGD
    steps take the loss below a tenth of the first, and the greedy
    decode is the targets."""
    main, startup, loss, decoded, x, y = _ctc_flow(tfluid)
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    xs, ys = _make_data(np.random.RandomState(0))
    feed = tfluid.DataFeeder(place=CPU, feed_list=[x, y]).feed(
        list(zip(xs, ys)))
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0][0]) for _ in range(200)]
    assert losses[-1] < losses[0] * 0.1, (losses[0], losses[-1])
    dec, = exe.run(main, feed=feed, fetch_list=[decoded], scope=scope,
                   return_numpy=False)
    splits, vals = dec.lod()[0], dec.values.reshape(-1).tolist()
    got = [vals[splits[i]:splits[i + 1]] for i in range(len(splits) - 1)]
    assert got == [yy.reshape(-1).tolist() for yy in ys]


# -- CRNN-CTC ---------------------------------------------------------------

# CRNN-CTC's builder, samples and decode state are chip_smoke.py's
# (which drives the same program at full width on the card); the JAX
# package's layers build the same descs through the same function.
# The narrow width: one conv group, 8 x 32 images, GRUs of 16
CRNN_NARROW = {"hw": (8, 32), "groups": ((16, 16),), "hidden": 16,
               "classes": 10}


def test_crnn_descs_equal_jax_at_full_width():
    j = build_crnn(jfluid)
    t = build_crnn(tfluid)
    for jp, tp in zip(j[:3], t[:3]):
        assert tp.desc.to_dict() == jp.desc.to_dict()
    block = t[0].desc.block(0)
    types = [op.type for op in block.ops]
    assert types.count("conv2d") == 8 and types.count("gru") == 2
    assert types.count("im2sequence") == 1 and "warpctc_grad" in types
    n_params = sum(1 for v in block.vars.values() if v.is_parameter)
    assert types.count("momentum") == n_params
    # ctc_train.py's GradientClipByValue(10, -10) and L2Decay(0.0004) on
    # every parameter: a clip, then the decay's scale and sum, per grad
    assert types.count("clip") == n_params
    clips = [op for op in block.ops if op.type == "clip"]
    assert {(op.attrs["min"], op.attrs["max"]) for op in clips} == \
        {(-10.0, 10.0)}
    assert sum(1 for op in block.ops if op.type == "scale"
               and abs(op.attrs["scale"] - 0.0004) < 1e-12) == n_params
    # the sequence is 32 steps of 128 x 3 features
    seq = next(op for op in block.ops if op.type == "im2sequence")
    assert block.vars[seq.output("Out")[0]].shape == (-1, 384)
    infer_types = [op.type for op in t[2].desc.block(0).ops]
    assert infer_types[-3:] == ["top_k", "ctc_align", "edit_distance"]
    assert "warpctc_grad" not in infer_types


def _crnn_run(exe, main, infer, loss, decoded, distance, feeder, batches,
              **scope):
    """2 steps of `main` from the scope's state, then one run of
    `infer` on the first batch: (losses, decoded, distances)."""
    losses = [float(np.asarray(exe.run(main, feed=feeder.feed(b),
                                       fetch_list=[loss], **scope)[0])
                    .reshape(-1)[0]) for b in batches]
    dec, dist = exe.run(infer, feed=feeder.feed(batches[0]),
                        fetch_list=[decoded, distance], return_numpy=False,
                        **scope)
    return losses, dec, dist


def test_crnn_narrow_steps_match_jax():
    jm, js, ji, jl, jd, jdist = build_crnn(jfluid, **CRNN_NARROW)
    tm, ts, ti, tl, td, tdist = build_crnn(tfluid, **CRNN_NARROW)
    assert tm.desc.to_dict() == jm.desc.to_dict()
    samples = crnn_samples(8, CRNN_NARROW["hw"], CRNN_NARROW["classes"],
                           seed=0, lengths=(2, 6))
    batches = [samples[:4], samples[4:]]
    persist = _persistables(jm)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    with jfluid.scope_guard(scope):
        exe.run(js)
        init = {n: np.array(scope.get(n)) for n in persist}
    jfeeder = jfluid.DataFeeder(
        place=jfluid.CPUPlace(),
        feed_list=[jm.global_block().var(n) for n in ("pixel", "label")])
    with jfluid.scope_guard(scope):
        jloss, jdec, jdistv = _crnn_run(exe, jm, ji, jl, jd, jdist, jfeeder,
                                        batches)
    jfinal = {n: np.array(scope.get(n)) for n in persist}

    texe, tscope = tfluid.Executor(CPU), tfluid.Scope()
    tio.params_from_numpy(tscope, init, "cpu")
    tfeeder = tfluid.DataFeeder(
        place=CPU,
        feed_list=[tm.global_block().var(n) for n in ("pixel", "label")])
    tloss, tdec, tdistv = _crnn_run(texe, tm, ti, tl, td, tdist, tfeeder,
                                    batches, scope=tscope)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5, atol=0)
    # each group's change in relative L2: a conv bias before a batch norm
    # gets a grad of rounding size only, so tensors are not held alone
    params = [p.name for p in tm.global_block().all_parameters()]
    groups = {"parameters": params,
              "velocities": [n for n in persist if "_velocity_" in n],
              "statistics": [n for n in persist
                             if n.startswith("_generated_var_")]}
    assert all(groups.values())
    for g, names in groups.items():
        num = sum(np.sum((tscope.get(n).numpy() - jfinal[n])
                         .astype(np.float64) ** 2) for n in names)
        den = sum(np.sum((jfinal[n] - init[n]).astype(np.float64) ** 2)
                  for n in names)
        assert den > 0 and (num / den) ** 0.5 <= 1e-4, (g, num, den)
    assert tdec.lod() == jdec.lod()
    np.testing.assert_array_equal(tdec.values.numpy(),
                                  np.asarray(jdec.values))
    np.testing.assert_array_equal(np.asarray(tdistv), np.asarray(jdistv))


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_crnn_export_served_on_the_cpu(tmp_path):
    """The inference program's export (image -> decoded ids), loaded by
    InferenceEngine and served by InferenceServer: 3 concurrent requests
    of one image each give the ids the executor gives."""
    from paddle_tpu_torch.serving import (InferenceEngine, InferenceServer,
                                          ServerConfig)

    main, startup, infer, loss, decoded, _ = build_crnn(tfluid,
                                                        **CRNN_NARROW)
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    samples = crnn_samples(3, CRNN_NARROW["hw"], CRNN_NARROW["classes"],
                           seed=1, lengths=(2, 6))
    feeder = tfluid.DataFeeder(place=CPU, feed_list=[
        main.global_block().var(n) for n in ("pixel", "label")])
    exe.run(main, feed=feeder.feed(samples), fetch_list=[loss], scope=scope)
    # chip_smoke's decode state: every bias 0, the batch norms' scales 1
    # and the last fc's weights N(0, 1); under the source's initializers
    # every image decodes alike
    params = [p.name for p in main.global_block().all_parameters()]
    tio.params_from_numpy(scope, crnn_decode_state(
        {n: scope.get(n).numpy() for n in params}, params), "cpu")
    with tfluid.scope_guard(scope):
        tio.save_inference_model(str(tmp_path), ["pixel"], [decoded], exe,
                                 infer,
                                 bucket_hints={"batch_buckets": [1, 2, 4]})
    images = np.stack([s[0] for s in samples])
    want, = exe.run(infer, feed=feeder.feed(samples), fetch_list=[decoded],
                    scope=scope, return_numpy=False)
    want_seqs = [want.values[a:b, 0].tolist() for a, b in
                 zip(want.lod()[0][:-1], want.lod()[0][1:])]
    assert len({tuple(w) for w in want_seqs}) > 1   # the images differ
    engine = InferenceEngine.from_saved_model(str(tmp_path), place=CPU)
    got = engine.run({"pixel": images})[0]
    assert [got.values[a:b, 0].tolist() for a, b in
            zip(got.lod()[0][:-1], got.lod()[0][1:])] == want_seqs
    server = InferenceServer(engine, ServerConfig(port=0, max_batch=4,
                                                  max_wait_ms=50.0))
    server.start()
    try:
        host, port = server.address
        url = "http://%s:%d/v1/infer" % (host, port)
        replies = [None] * 3

        def client(i):
            replies[i] = _post(url, {"inputs": {"pixel": [
                images[i].tolist()]}})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        server.shutdown()
    fetch = engine.fetch_names[0]
    for i, r in enumerate(replies):
        ids = [row[0] for row in r["outputs"][fetch][0]]
        assert ids == want_seqs[i], (i, ids, want_seqs[i])


def test_chip_smoke_copy_of_the_ctc_flow_data():
    """chip_smoke.py (which imports nothing of the JAX package) carries a
    copy of tests/test_ctc_training.py's data: it gives the same
    arrays."""
    import chip_smoke

    xs, ys = _make_data(np.random.RandomState(0))
    cx, cy = chip_smoke.ctc_flow_data(np.random.RandomState(0))
    assert (chip_smoke.CTC_FLOW_V, chip_smoke.CTC_FLOW_FEAT) == (V, FEAT)
    for a, b in zip(xs + ys, cx + cy):
        np.testing.assert_array_equal(a, b)
