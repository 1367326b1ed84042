"""ops/detection.py's 6 op types, `fluid.evaluator.DetectionMAP`,
`v2.evaluator.detection_map_evaluator` and an SSD-shaped net: the port
against the JAX package, on the CPU, on inputs made from a numpy seed.

- Each op through both executors' `apply_op`: prior_box (max sizes,
  flip, clip, steps), iou_similarity dense and ragged, bipartite_match
  dense and ragged, detection_output (equal scores, an image with
  nothing kept, a batch with nothing: one row of -1), multibox_loss and
  its generic grad, detection_map 11-point and integral with difficult
  gts.  Floats within F32_ATOL of the larger of 1 and the reference's
  magnitude, the host ops' outputs exactly.
- The forced match (tests/test_v2_layer_zoo.py::
  test_multibox_loss_bipartite_guarantee): a gt whose best IoU is below
  the threshold still makes a positive, on both packages.
- The JAX v2 `detection_output` layer's program raises KeyError (its op
  reads `Conf` and `num_classes`, which the layer does not give); the
  port's layer gives what the JAX op gives called directly.
- DetectionMAP and detection_map_evaluator over two batches: the mean
  of the batches' mAPs equal to the JAX package's.
- `chip_smoke.build_ssd` at SSD_SMALL (3 maps at 32 x 32) in both
  packages: descs equal, 2 Momentum steps from the JAX startup's state
  (loss, every parameter's grad and the parameters after within
  SSD_RTOL of their magnitude), then the test clone's detection rows
  (SSD_SMALL's shorter NMS), exactly from the same Loc and Conf, and
  their mAP; and at SSD300 by desc (8,732 priors).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401 — registers the JAX kernels
import paddle_tpu.v2 as jv2
from paddle_tpu.core.ragged import RaggedTensor as JRagged
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.ops.registry import get_op_info as j_op
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.v2 as tv2
from paddle_tpu_torch.core.ragged import RaggedTensor
from paddle_tpu_torch.ops.registry import get_op_info as t_op

import chip_smoke
from test_torch_stack_ops import _compare, _grad_pairs, _run

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
F32_ATOL = 1e-5
# SSD_SMALL's 2 steps, f32 on both sides: the convolutions and the loss's
# sums in other orders through 7 convolutions; the loss (about 100) and
# every grad and parameter within 1e-4 of its magnitude
SSD_RTOL = 1e-4


def _ragged(values, splits, nvalid=None):
    return RaggedTensor(torch.as_tensor(values),
                        [torch.tensor(splits, dtype=torch.int32)],
                        nvalid=nvalid)


def _boxes(rs, n):
    lo = rs.uniform(0, 0.7, (n, 2))
    return np.concatenate([lo, lo + rs.uniform(0.05, 0.3, (n, 2))],
                          1).astype(np.float32)


def _prior(rs, p):
    return np.concatenate([_boxes(rs, p), np.tile(
        np.array([[0.1, 0.1, 0.2, 0.2]], np.float32), (p, 1))])


def _cases():
    rs = np.random.RandomState(chip_smoke.SEED + 192)
    t = torch.from_numpy
    feat, image = torch.zeros(2, 3, 4, 5), torch.zeros(2, 3, 40, 48)
    cases = [
        ("prior_box", "prior_box",
         {"Input": [("f", feat)], "Image": [("i", image)]},
         {"Boxes": ["b"], "Variances": ["v"]},
         {"min_sizes": [8.0, 16.0], "max_sizes": [16.0, 30.0],
          "aspect_ratios": [2.0, 3.0, 2.0], "variances": [0.1, 0.1, 0.2,
                                                          0.2]}, [], None,
         False),
        ("prior_box_steps_no_flip_no_clip", "prior_box",
         {"Input": [("f", feat)], "Image": [("i", image)]},
         {"Boxes": ["b"], "Variances": ["v"]},
         {"min_sizes": [20.0], "aspect_ratios": [2.0], "flip": False,
          "clip": False, "step_w": 11.0, "step_h": 9.0, "offset": 0.25},
         [], None, False),
        ("iou_similarity", "iou_similarity",
         {"X": [("x", t(_boxes(rs, 5)))], "Y": [("y", t(_boxes(rs, 4)))]},
         {"Out": ["o"]}, {}, [], None, False),
        ("iou_similarity_ragged", "iou_similarity",
         {"X": [("x", _ragged(t(_boxes(rs, 5)), [0, 2, 5]))],
          "Y": [("y", t(_boxes(rs, 3)))]}, {"Out": ["o"]}, {}, [], None,
         False),
    ]
    dist = rs.rand(5, 4).astype(np.float32)
    dist[1, 2] = dist[3, 0] = 0.9     # a tie
    dist[4] = 0.0                     # a row below 1e-6
    cases += [
        ("bipartite_match", "bipartite_match",
         {"DistMat": [("d", t(dist))]},
         {"ColToRowMatchIndices": ["m"], "ColToRowMatchDis": ["d2"]}, {},
         [], None, True),
        ("bipartite_match_ragged", "bipartite_match",
         {"DistMat": [("d", _ragged(t(dist), [0, 3, 5]))]},
         {"ColToRowMatchIndices": ["m"], "ColToRowMatchDis": ["d2"]}, {},
         [], None, True),
    ]
    p, c = 12, 4
    prior = _prior(rs, p)
    conf = rs.randn(3, p * c).astype(np.float32) * 2
    conf[0, 4:8] = conf[0, 8:12]      # two priors with equal scores
    conf[2] = 0.0                     # every class at 1/4
    loc = (rs.randn(3, p * 4) * 0.3).astype(np.float32)
    attrs = {"num_classes": c, "nms_threshold": 0.45, "nms_top_k": 5,
             "top_k": 6, "confidence_threshold": 0.3,
             "background_label_id": 0}
    det_ins = {"Loc": [("l", t(loc))], "Conf": [("c", t(conf))],
               "PriorBox": [("p", t(prior))]}
    cases += [
        ("detection_output", "detection_output", det_ins, {"Out": ["o"]},
         attrs, [], None, True),
        ("detection_output_nothing", "detection_output", det_ins,
         {"Out": ["o"]}, dict(attrs, confidence_threshold=0.99), [], None,
         True),
    ]
    gt = t(np.concatenate([_boxes(rs, 4), prior[2:3] + 0.01]))
    lab = t(np.array([[1], [3], [2], [1], [2]], np.int64))
    mb_ins = {"Loc": [("l", t(loc))], "Conf": [("c", t(conf))],
              "PriorBox": [("p", t(prior))],
              "GtBox": [("g", _ragged(gt, [0, 2, 2, 5]))],
              "GtLabel": [("gl", _ragged(lab, [0, 2, 2, 5]))]}
    cases.append(("multibox_loss", "multibox_loss", mb_ins,
                  {"Loss": ["o"]}, {"num_classes": c}, ["Loc", "Conf"],
                  {"Loss": t(rs.uniform(-1, 1, (3, 1)).astype(np.float32))},
                  False))
    det_rows = np.array([[1, 0.9, 0.1, 0.1, 0.4, 0.4],
                         [1, 0.8, 0.1, 0.1, 0.4, 0.41],
                         [2, 0.7, 0.5, 0.5, 0.9, 0.9],
                         [2, 0.95, 0.0, 0.0, 0.2, 0.2],
                         [1, 0.6, 0.3, 0.3, 0.6, 0.6],
                         [3, 0.5, 0.2, 0.2, 0.5, 0.5]], np.float32)
    gt_rows = np.array([[1, 0.1, 0.1, 0.4, 0.4, 0],
                        [2, 0.5, 0.5, 0.9, 0.9, 1],
                        [2, 0.0, 0.0, 0.2, 0.21, 0],
                        [1, 0.3, 0.3, 0.6, 0.6, 0],
                        [1, 0.7, 0.7, 0.9, 0.9, 0]], np.float32)
    for ap, hard in (("11point", False), ("integral", False),
                     ("11point", True)):
        cases.append(("detection_map_%s%s" % (ap, "_difficult" * hard),
                      "detection_map",
                      {"DetectRes": [("d", _ragged(t(det_rows),
                                                   [0, 3, 6]))],
                       "Label": [("g", _ragged(t(gt_rows), [0, 3, 5]))]},
                      {"MAP": ["m"]},
                      {"ap_type": ap, "evaluate_difficult": hard}, [], None,
                      False))
    return cases


CASES = _cases()


def test_the_cases_cover_every_op_type():
    assert {c[1] for c in CASES} == {
        "prior_box", "iou_similarity", "bipartite_match",
        "detection_output", "multibox_loss", "detection_map"}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    _, op, ins, outs, attrs, _, _, exact = case
    _compare(_run(op, ins, outs, attrs), exact)


def test_multibox_loss_grad_matches_jax():
    case = next(c for c in CASES if c[0] == "multibox_loss")
    _compare(_grad_pairs(case), False)


def test_detection_output_edge_rows():
    """Nothing kept is one row of -1s; an image with nothing kept has no
    row; the equal scores keep numpy's order on both sides (the rows
    equal exactly)."""
    case = next(c for c in CASES if c[0] == "detection_output_nothing")
    (j, t), = _run(*case[1:5]).values()
    np.testing.assert_array_equal(t.numpy(), -np.ones((1, 7), np.float32))
    case = next(c for c in CASES if c[0] == "detection_output")
    (j, t), = _run(*case[1:5]).values()
    # image 2's scores (1/4 each) are all below the threshold
    assert t.shape[0] > 6 and set(t.numpy()[:, 0]) == {0.0, 1.0}


def test_multibox_forced_match():
    """A gt whose best prior IoU is far below 0.5 still makes a positive:
    the loss is above 0 on both packages, and equal."""
    p, c = 2, 2
    pboxes = np.array([[0.0, 0.0, 0.2, 0.2], [0.8, 0.8, 1.0, 1.0]],
                      np.float32)
    prior = np.concatenate([pboxes, np.full((p, 4), 0.1, np.float32)])
    gt = np.array([[0.15, 0.15, 0.5, 0.5]], np.float32)
    ins = {"Loc": np.zeros((1, p * 4), np.float32),
           "Conf": np.zeros((1, p * c), np.float32), "PriorBox": prior}
    jout = j_op("multibox_loss").kernel(None, dict(
        {k: [jnp.asarray(v)] for k, v in ins.items()},
        GtBox=[JRagged(jnp.asarray(gt), [jnp.asarray([0, 1], jnp.int32)])],
        GtLabel=[JRagged(jnp.asarray([[1]], jnp.int32),
                         [jnp.asarray([0, 1], jnp.int32)])]),
        {"num_classes": c})
    tout = t_op("multibox_loss").kernel(None, dict(
        {k: [torch.from_numpy(v)] for k, v in ins.items()},
        GtBox=[_ragged(torch.from_numpy(gt), [0, 1])],
        GtLabel=[_ragged(torch.tensor([[1]], dtype=torch.int32), [0, 1])]),
        {"num_classes": c})
    loss = float(tout["Loss"][0].reshape(-1)[0])
    assert loss > 0.0
    assert loss == pytest.approx(float(np.asarray(jout["Loss"][0])[0, 0]),
                                 rel=1e-6)


def _detect_layer(v2, fluid):
    a = fluid.layers.data(name="a", shape=[5], dtype="float32")
    prior = fluid.layers.data(name="prior", shape=[12, 4], dtype="float32",
                              append_batch_size=False)
    loc = fluid.layers.fc(input=a, size=6 * 4)
    conf = fluid.layers.fc(input=a, size=6 * 3)
    out = v2.layer.detection_output(input_loc=loc, input_conf=conf,
                                    priorbox=prior, num_classes=3,
                                    confidence_threshold=0.2,
                                    keep_top_k=5, nms_top_k=4)
    return loc, conf, out


def test_v2_detection_output_fault():
    """The JAX v2 layer's program cannot run (KeyError: its op reads
    `Conf` and `num_classes`); the port's layer gives what the JAX op,
    called directly on the same Loc and Conf, gives."""
    rs = np.random.RandomState(3)
    feed = {"a": rs.randn(2, 5).astype(np.float32),
            "prior": _prior(rs, 6)}
    programs = []
    for v2, fluid in ((jv2, jfluid), (tv2, tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            programs.append((main, startup) + _detect_layer(v2, fluid))
    (jm, js, jloc, jconf, jout), (tm, ts, tloc, tconf, tout) = programs
    jscope, jexe = JScope(), jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    with pytest.raises(KeyError):
        jexe.run(jm, feed=feed, fetch_list=[jout], scope=jscope)
    op = tm.desc.block(0).ops[-1]
    assert op.type == "detection_output" and "Conf" in op.inputs
    assert op.attrs["num_classes"] == 3 and op.attrs["top_k"] == 5
    state = {n: np.asarray(jscope.get(n))
             for n, vd in ts.desc.block(0).vars.items() if vd.persistable}
    tscope = tfluid.Scope()
    tfluid.io.params_from_numpy(tscope, state, "cpu")
    loc, conf, rows = tfluid.Executor(CPU).run(
        tm, feed=feed, fetch_list=[tloc, tconf, tout], scope=tscope)
    ref = j_op("detection_output").kernel(
        None, {"Loc": [jnp.asarray(loc)], "Conf": [jnp.asarray(conf)],
               "PriorBox": [jnp.asarray(feed["prior"])]},
        dict(op.attrs))["Out"][0]
    np.testing.assert_array_equal(rows, np.asarray(ref))


def _map_program(fluid, v2):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        det = fluid.layers.data(name="det", shape=[6], dtype="float32",
                                lod_level=1)
        gt = fluid.layers.data(name="gt", shape=[6], dtype="float32",
                               lod_level=1)
        ev = fluid.evaluator.DetectionMAP(det, gt, ap_type="integral",
                                          evaluate_difficult=False)
        batch_map = v2.evaluator.detection_map_evaluator(
            input=det, label=gt, overlap_threshold=0.4)
    return main, startup, ev, batch_map


def test_detection_map_evaluators_match_jax():
    """Two batches through DetectionMAP and detection_map_evaluator: each
    batch's mAP, and eval()'s mean of them, equal the JAX package's;
    reset() zeroes the counters."""
    rs = np.random.RandomState(9)
    batches = []
    for _ in range(2):
        dets, gts = [], []
        for _ in range(3):
            g = np.concatenate([rs.randint(1, 4, (3, 1)), _boxes(rs, 3),
                                rs.randint(0, 2, (3, 1))], 1)
            d = np.concatenate([np.concatenate([g[:, :1], [[2]]]),
                                rs.rand(4, 1),
                                np.concatenate([g[:, 1:5], _boxes(rs, 1)])
                                + rs.uniform(-0.05, 0.05, (4, 4))], 1)
            gts.append(g.astype(np.float32))
            dets.append(d.astype(np.float32))
        batches.append((dets, gts))
    (jm, js, jev, jmap), (tm, ts, tev, tmap) = (
        _map_program(jfluid, jv2), _map_program(tfluid, tv2))
    assert tm.desc.to_dict() == jm.desc.to_dict()
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), tfluid.Executor(CPU)
    with jfluid.scope_guard(JScope()), tfluid.scope_guard(tfluid.Scope()):
        jexe.run(js)
        texe.run(ts)
        for dets, gts in batches:
            j = jexe.run(jm, feed={"det": JRagged.from_sequences(dets),
                                   "gt": JRagged.from_sequences(gts)},
                         fetch_list=[jev.metrics[0], jmap])
            t = texe.run(tm, feed={"det": RaggedTensor.from_sequences(dets),
                                   "gt": RaggedTensor.from_sequences(gts)},
                         fetch_list=[tev.metrics[0], tmap])
            for a, b in zip(j, t):
                np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6)
        np.testing.assert_allclose(tev.eval(texe), jev.eval(jexe),
                                   rtol=1e-6)
        assert 0.0 < float(tev.eval(texe)[0]) <= 1.0
        tev.reset(texe)
        for v in tev.states:
            assert not tfluid.fetch_var(v.name).any()


# -- the SSD-shaped net ----------------------------------------------------------

def test_ssd300_descs_equal_jax():
    """SSD300 at the published width, main and test clone: the same
    descs in both packages, 8,732 priors."""
    for train in (True, False):
        j = chip_smoke.build_ssd(jv2, jfluid, chip_smoke.SSD300, train)
        t = chip_smoke.build_ssd(tv2, tfluid, chip_smoke.SSD300, train)
        assert t[0].desc.to_dict() == j[0].desc.to_dict()
        assert t[1].desc.to_dict() == j[1].desc.to_dict()
        assert tuple(t[2]["prior"].shape) == (2 * chip_smoke.SSD_PRIORS, 4)


def _close(t, j, what):
    j = np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=0, atol=SSD_RTOL * max(
        1.0, float(np.abs(j).max())), err_msg=what)


def test_ssd_small_trains_detects_and_scores_as_jax():
    cfg = chip_smoke.SSD_SMALL
    jm, js, jo = chip_smoke.build_ssd(jv2, jfluid, cfg)
    tm, ts, to = chip_smoke.build_ssd(tv2, tfluid, cfg)
    assert tm.desc.to_dict() == jm.desc.to_dict()
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    jexe.run(js, scope=jscope)
    state = {n: np.asarray(jscope.get(n))
             for n, vd in ts.desc.block(0).vars.items() if vd.persistable}
    texe, tscope = tfluid.Executor(CPU), tfluid.Scope()
    tfluid.io.params_from_numpy(tscope, state, "cpu")
    params = [p.name for p in tm.global_block().all_parameters()]
    grads = [n + "@GRAD" for n in params]
    for step in range(2):
        image, boxes, labels = chip_smoke.ssd_data(4, 40 + step, cfg)
        j = jexe.run(jm, feed=chip_smoke.ssd_feed(JRagged, image, boxes,
                                                  labels),
                     fetch_list=[jo["loss"]] + grads, scope=jscope)
        t = texe.run(tm, feed=chip_smoke.ssd_feed(RaggedTensor, image,
                                                  boxes, labels),
                     fetch_list=[to["loss"]] + grads, scope=tscope)
        assert np.isfinite(t[0]).all() and float(t[0][0]) > 0
        for name, a, b in zip(["loss"] + grads, j, t):
            _close(b, a, "step %d %s" % (step, name))
    for n in params:
        _close(tscope.get(n).numpy(), jscope.get(n), n)

    jt, _, jto = chip_smoke.build_ssd(jv2, jfluid, cfg, train=False)
    tt, _, tto = chip_smoke.build_ssd(tv2, tfluid, cfg, train=False)
    assert tt.desc.to_dict() == jt.desc.to_dict()
    image, boxes, labels = chip_smoke.ssd_data(4, 50, cfg)
    feed_j = chip_smoke.ssd_feed(JRagged, image, boxes, labels)
    loc, conf = texe.run(tt, feed=chip_smoke.ssd_feed(
        RaggedTensor, image, boxes, labels),
        fetch_list=[tto["loc"], tto["conf"]], scope=tscope)
    jloc, jconf, jrows = jexe.run(
        jt, feed=feed_j, fetch_list=[jto["loc"], jto["conf"],
                                     jto["detections"]], scope=jscope)
    _close(loc, jloc, "loc")
    _close(conf, jconf, "conf")
    trows = texe.run(tt, feed=chip_smoke.ssd_feed(
        RaggedTensor, image, boxes, labels), fetch_list=[tto["detections"]],
        scope=tscope)[0]
    assert trows.shape == np.asarray(jrows).shape
    _close(trows, jrows, "detections")
    # the port's Loc and Conf through the JAX op and the port's op: the
    # same rows
    attrs = dict(tt.desc.block(0).ops[-1].attrs)
    prior = texe.run(tt, feed=chip_smoke.ssd_feed(
        RaggedTensor, image, boxes, labels), fetch_list=[tto["prior"]],
        scope=tscope)[0]
    rows = t_op("detection_output").kernel(
        None, {"Loc": [torch.from_numpy(loc)], "Conf": [torch.from_numpy(
            conf)], "PriorBox": [torch.from_numpy(prior)]}, attrs)["Out"][0]
    ref = j_op("detection_output").kernel(
        None, {"Loc": [jnp.asarray(loc)], "Conf": [jnp.asarray(conf)],
               "PriorBox": [jnp.asarray(prior)]}, attrs)["Out"][0]
    np.testing.assert_array_equal(rows.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(rows.numpy(), trows)
    # mAP of the detections against the gts, both packages
    dets = [rows.numpy()[rows.numpy()[:, 0] == i, 1:] for i in range(4)]
    gts = [np.concatenate([lab.astype(np.float32), box], 1)
           for box, lab in zip(boxes, labels)]
    maps = []
    for run, ragged in ((_run_map_port, RaggedTensor), (_run_map_jax,
                                                        JRagged)):
        maps.append(run(ragged.from_sequences(dets),
                        ragged.from_sequences(gts)))
    assert maps[0] == pytest.approx(maps[1], rel=1e-6)


def _run_map_port(det, gt):
    return float(t_op("detection_map").kernel(
        None, {"DetectRes": [det], "Label": [gt]}, {})["MAP"][0][0])


def _run_map_jax(det, gt):
    return float(np.asarray(j_op("detection_map").kernel(
        None, {"DetectRes": [det], "Label": [gt]}, {})["MAP"][0])[0])
