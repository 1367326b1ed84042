"""ops/v2_extra.py's 12 op types and the 21 v2 layer names that waited
for A10's last op groups: the port against the JAX package, on the CPU,
on inputs made from a numpy seed.

- Every case of `chip_smoke.v2_extra_op_cases()` (which phase 19d also
  runs on the card): each op through both executors' `apply_op`, and its
  grad (the port's generic vjp, or hsigmoid's own kernel, against the
  JAX generic vjp) with the same output grads.  Outputs and grads within
  F32_ATOL of the larger of 1 and the reference's magnitude (the same
  f32 arithmetic in other orders); the host ops' outputs exactly.
  bilinear_interp down (antialiased) and up, against jax.image.resize
  itself, where F.interpolate without antialiasing differs.
- `sampling_id` held statistically: the draw's counts within 6 standard
  deviations of the probabilities; int32 ids, as the JAX op's int64
  executes.
- hsigmoid's grad twice to the same bits (its rows add in a fixed
  order).
- Each of the 21 v2 names built by both packages from one seed: the
  descs equal, and one forward from the JAX startup's state equal
  within F32_ATOL (sampling_id, whose draws differ: in range).
  `detection_output`'s op differs on purpose (its JAX layer gives the
  op slots and attrs the op does not read; tests/test_torch_detection.py
  holds that fault).
- Every reference name tests/test_v2_layer_zoo.py::test_export_surface
  lists is callable in the port's trainer_config_helpers, whose three
  detection aliases build their ops.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401 — registers the JAX kernels
import paddle_tpu.v2 as jv2
from paddle_tpu.core.ragged import RaggedTensor as JRagged
from paddle_tpu.core.scope import Scope as JScope
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.v2 as tv2
from paddle_tpu_torch.core.ragged import RaggedTensor as TRagged
from paddle_tpu_torch.ops.registry import get_op_info as t_op

import chip_smoke
from test_torch_stack_ops import _compare, _grad_pairs, _run

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
F32_ATOL = 1e-5

CASES = chip_smoke.v2_extra_op_cases()
GRAD_CASES = [c for c in CASES if c[5]]

NEW_OPS = ["bilinear_interp", "hsigmoid", "sampling_id", "kmax_seq_score",
           "sub_nested_seq", "scale_sub_region", "lambda_cost",
           "cross_entropy_selfnorm", "multi_binary_label_cross_entropy",
           "rotate", "out_prod", "linear_comb"]

ZOO_NAMES = ["conv_operator", "kmax_seq_score", "sub_nested_seq", "maxout",
             "spp", "img_pool3d", "img_conv3d", "bilinear_interp", "rotate",
             "out_prod", "linear_comb", "scale_sub_region", "sampling_id",
             "hsigmoid", "lambda_cost", "cross_entropy_with_selfnorm",
             "multi_binary_label_cross_entropy", "priorbox", "roi_pool",
             "detection_output", "multibox_loss"]


def test_the_cases_cover_every_new_op_type():
    assert {c[1] for c in CASES} == set(NEW_OPS) - {"sampling_id"}
    assert len(ZOO_NAMES) == 21 and not tv2.layer._WAITING


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    _, op, ins, outs, attrs, _, _, exact = case
    _compare(_run(op, ins, outs, attrs), exact)


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_grad_matches_jax(case):
    _compare(_grad_pairs(case), False)


@pytest.mark.parametrize("shape,out", [((2, 3, 38, 38), (75, 75)),
                                       ((2, 3, 38, 38), (19, 19)),
                                       ((1, 2, 7, 5), (3, 11))])
def test_bilinear_interp_is_jax_image_resize(shape, out):
    """Up and down (antialiased) against jax.image.resize itself;
    F.interpolate without antialiasing is another function when it
    downsamples."""
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    attrs = {"out_h": out[0], "out_w": out[1]}
    t = t_op("bilinear_interp").kernel(None, {"X": [torch.from_numpy(x)]},
                                       attrs)["Out"][0].numpy()
    j = np.asarray(jax.image.resize(jnp.asarray(x), shape[:2] + out,
                                    method="bilinear"))
    np.testing.assert_allclose(t, j, atol=F32_ATOL, rtol=0)
    if out[0] < shape[2]:
        lib = F.interpolate(torch.from_numpy(x), size=out, mode="bilinear",
                            align_corners=False).numpy()
        assert np.abs(lib - j).max() > 1e-3


def test_sampling_id_draws_in_proportion():
    """20,000 rows of one distribution over 5 ids: each id's count within
    6 standard deviations of its probability's share; int32 ids."""
    from paddle_tpu_torch.fluid import executor as texec
    from paddle_tpu_torch.core.desc import OpDesc

    p = torch.tensor([0.5, 0.25, 0.15, 0.1, 0.0]).repeat(20000, 1)
    ctx = texec.ExecContext(None, 0, {"p": p}, device=torch.device("cpu"),
                            rng=torch.Generator().manual_seed(0))
    texec.apply_op(ctx, OpDesc("sampling_id", {"X": ["p"]},
                               {"Out": ["o"]}, {}))
    ids = ctx.env["o"]
    assert ids.dtype == torch.int32 and ids.shape == (20000,)
    counts = np.bincount(ids.numpy(), minlength=5)
    probs = p[0].numpy()
    sd = np.sqrt(20000 * probs * (1 - probs))
    assert counts[4] == 0
    assert (np.abs(counts - 20000 * probs) <= 6 * sd + 1e-9).all(), counts
    jctx_ids = jax.eval_shape(
        lambda x: jax.random.categorical(jax.random.PRNGKey(0), x,
                                         axis=-1).astype(jnp.int64),
        jnp.zeros((3, 5)))
    assert jctx_ids.dtype == jnp.int32


def test_hsigmoid_grad_repeats_bit_for_bit():
    case = next(c for c in GRAD_CASES if c[0] == "hsigmoid_bias")
    a, b = (_grad_pairs(case) for _ in range(2))
    for n in a:
        assert chip_smoke.same_bits(a[n][1], b[n][1]), n


# -- the 21 v2 names -------------------------------------------------------------

def zoo_layer(v2, fluid, ragged, name):
    """(output Variable, feed) of the v2 layer `name` built in the
    current program by package (v2, fluid, RaggedTensor type), from a
    seed."""
    L, data = v2.layer, fluid.layers.data
    rs = np.random.RandomState(17)

    def f32(*shape):
        return rs.randn(*shape).astype(np.float32)

    def seqs(lengths, width, dtype=np.float32, hi=None):
        return ragged.from_sequences(
            [(rs.randint(0, hi, (n, width)) if hi else rs.randn(n, width))
             .astype(dtype) for n in lengths])

    feed = {}
    if name == "conv_operator":
        img = data(name="img", shape=[2, 6, 6], dtype="float32")
        a = data(name="a", shape=[5], dtype="float32")
        filt = L.fc(input=a, size=4 * 2 * 3 * 3)
        out = L.mixed(input=[L.conv_operator(
            img=img, filter=filt, filter_size=3, num_filters=4,
            num_channels=2, padding=1)])
        feed = {"img": f32(3, 2, 6, 6), "a": f32(3, 5)}
    elif name == "kmax_seq_score":
        s = data(name="s", shape=[1], dtype="float32", lod_level=1)
        out = L.kmax_seq_score(input=s, beam_size=2)
        feed = {"s": seqs([3, 1, 4], 1)}
    elif name == "sub_nested_seq":
        x = data(name="x", shape=[2], dtype="float32", lod_level=2)
        s = data(name="s", shape=[1], dtype="int64", lod_level=1)
        out = L.sub_nested_seq(input=x, selected_indices=s)
        from_seq = ragged.from_sequences([f32(9, 2)])
        feed = {"x": ragged(from_seq.values, [np.array([0, 3, 5], np.int32),
                                              np.array([0, 2, 3, 6, 8, 9],
                                                       np.int32)]),
                "s": ragged.from_sequences([np.array([[2], [0]]),
                                            np.array([[1]])],
                                           dtype=np.int64)}
    elif name in ("maxout", "spp", "bilinear_interp", "scale_sub_region"):
        img = data(name="img", shape=[4, 7, 9], dtype="float32")
        feed = {"img": f32(2, 4, 7, 9)}
        if name == "maxout":
            out = L.maxout(input=img, groups=2)
        elif name == "spp":
            out = L.spp(input=img, pyramid_height=2,
                        pool_type=v2.pooling.Avg())
        elif name == "bilinear_interp":
            out = L.bilinear_interp(input=img, out_size_x=5, out_size_y=4)
        else:
            idx = data(name="idx", shape=[6], dtype="int32")
            out = L.scale_sub_region(input=img, indices=idx, value=3.0)
            feed["idx"] = np.array([[1, 2, 2, 5, 1, 9], [4, 4, 1, 1, 3, 3]],
                                   np.int32)
    elif name in ("img_pool3d", "img_conv3d"):
        vol = data(name="vol", shape=[2, 4, 5, 5], dtype="float32")
        feed = {"vol": f32(2, 2, 4, 5, 5)}
        out = (L.img_pool3d(input=vol, pool_size=2)
               if name == "img_pool3d" else
               L.img_conv3d(input=vol, filter_size=3, num_filters=3,
                            padding=1, act=v2.activation.Relu()))
    elif name in ("rotate", "out_prod", "linear_comb"):
        a = data(name="a", shape=[12], dtype="float32")
        b = data(name="b", shape=[3], dtype="float32")
        feed = {"a": f32(3, 12), "b": f32(3, 3)}
        out = (L.rotate(input=a, height=3, width=2) if name == "rotate"
               else L.out_prod(a, b) if name == "out_prod"
               else L.linear_comb(weights=b, vectors=a, size=4))
    elif name in ("sampling_id", "hsigmoid", "cross_entropy_with_selfnorm",
                  "multi_binary_label_cross_entropy"):
        a = data(name="a", shape=[5], dtype="float32")
        lab = data(name="lab", shape=[1], dtype="int64")
        feed = {"a": f32(6, 5),
                "lab": rs.randint(0, 7, (6, 1)).astype(np.int64)}
        if name == "sampling_id":
            out = L.sampling_id(input=L.fc(input=a, size=7,
                                           act=v2.activation.Softmax()))
        elif name == "hsigmoid":
            out = L.hsigmoid(input=a, label=lab, num_classes=7)
        elif name == "cross_entropy_with_selfnorm":
            out = L.cross_entropy_with_selfnorm(
                input=L.fc(input=a, size=7, act=v2.activation.Sigmoid()),
                label=lab, softmax_selfnorm_alpha=0.2)
        else:
            bits = data(name="bits", shape=[4], dtype="float32")
            feed["bits"] = rs.randint(0, 2, (6, 4)).astype(np.float32)
            out = L.multi_binary_label_cross_entropy(
                input=L.fc(input=a, size=4, act=v2.activation.Sigmoid()),
                label=bits)
    elif name == "lambda_cost":
        x = data(name="x", shape=[3], dtype="float32", lod_level=1)
        y = data(name="y", shape=[1], dtype="float32", lod_level=1)
        out = L.lambda_cost(input=L.fc(input=x, size=1), score=y,
                            NDCG_num=3)
        feed = {"x": seqs([4, 6], 3),
                "y": seqs([4, 6], 1, np.float32, hi=3)}
    elif name in ("priorbox", "roi_pool"):
        fm = data(name="fm", shape=[3, 4, 4], dtype="float32")
        feed = {"fm": f32(2, 3, 4, 4)}
        if name == "priorbox":
            image = data(name="image", shape=[3, 16, 16], dtype="float32")
            feed["image"] = f32(2, 3, 16, 16)
            out = L.priorbox(input=fm, image=image, min_size=[4.0],
                             max_size=[9.0], aspect_ratio=[2.0])[0]
        else:
            rois = data(name="rois", shape=[5], dtype="float32")
            feed["rois"] = np.array([[0, 0, 0, 3, 3], [1, 1, 0, 2, 3],
                                     [1, 2, 2, 9, 9]], np.float32)
            out = L.roi_pool(input=fm, rois=rois, pooled_width=2,
                             pooled_height=2, spatial_scale=0.5)
    else:   # detection_output, multibox_loss
        a = data(name="a", shape=[5], dtype="float32")
        prior = data(name="prior", shape=[12, 4], dtype="float32",
                     append_batch_size=False)
        loc = L.fc(input=a, size=6 * 4)
        conf = L.fc(input=a, size=6 * 3)
        lo = rs.uniform(0, 0.6, (6, 2))
        boxes = np.concatenate([lo, lo + rs.uniform(0.1, 0.4, (6, 2))], 1)
        feed = {"a": f32(2, 5), "prior": np.concatenate(
            [boxes, np.full((6, 4), 0.1)]).astype(np.float32)}
        if name == "detection_output":
            out = L.detection_output(input_loc=loc, input_conf=conf,
                                     priorbox=prior, num_classes=3,
                                     confidence_threshold=0.2)
        else:
            gt = data(name="gt", shape=[4], dtype="float32", lod_level=1)
            gl = data(name="gl", shape=[1], dtype="int64", lod_level=1)
            out = L.multibox_loss(input_loc=loc, input_conf=conf,
                                  priorbox=prior, label=gl, gt_box=gt,
                                  num_classes=3)
            feed["gt"] = ragged.from_sequences(
                [boxes[:2].astype(np.float32), boxes[3:4].astype(
                    np.float32)])
            feed["gl"] = ragged.from_sequences(
                [np.array([[1], [2]]), np.array([[1]])], dtype=np.int64)
    return out, feed


def _zoo(name):
    built = []
    for v2, fluid, ragged in ((jv2, jfluid, JRagged),
                              (tv2, tfluid, TRagged)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            out, feed = zoo_layer(v2, fluid, ragged, name)
        built.append((main, startup, out, feed))
    return built


def _host(v):
    if isinstance(v, (JRagged, TRagged)):
        return np.asarray(v.values), v.lod()
    return np.asarray(v), None


@pytest.mark.parametrize("name", ZOO_NAMES)
def test_zoo_layer_matches_jax(name):
    (jmain, jstart, jout, jfeed), (tmain, tstart, tout, tfeed) = _zoo(name)
    jd, td = jmain.desc.to_dict(), tmain.desc.to_dict()
    if name == "detection_output":
        jops, tops = jd["blocks"][0].pop("ops"), td["blocks"][0].pop("ops")
        assert jops[:-1] == tops[:-1] and jops[-1]["type"] == \
            tops[-1]["type"] == "detection_output"
        assert "Scores" in jops[-1]["inputs"] and "Conf" in tops[-1][
            "inputs"]
    assert td == jd
    assert tstart.desc.to_dict() == jstart.desc.to_dict()
    jscope, jexe = JScope(), jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    state = {n: np.asarray(jscope.get(n))
             for n, vd in tstart.desc.block(0).vars.items()
             if vd.persistable}
    tscope = tfluid.Scope()
    tfluid.io.params_from_numpy(tscope, state, "cpu")
    t, = tfluid.Executor(CPU).run(tmain, feed=tfeed, fetch_list=[tout],
                                  scope=tscope, return_numpy=False)
    tv, tlod = _host(t)
    if name == "sampling_id":
        assert tv.dtype == np.int32 and ((tv >= 0) & (tv < 7)).all()
        return
    if name == "detection_output":
        return
    j, = jexe.run(jmain, feed=jfeed, fetch_list=[jout], scope=jscope,
                  return_numpy=False)
    jv, jlod = _host(j)
    assert tlod == jlod and tv.shape == jv.shape and tv.dtype == jv.dtype
    np.testing.assert_allclose(tv, jv, atol=F32_ATOL * max(
        1.0, float(np.abs(jv).max())), rtol=0)


# the reference names tests/test_v2_layer_zoo.py::test_export_surface lists
ZOO_REF_NAMES = ["maxout_layer", "spp_layer", "bilinear_interp_layer",
                 "tensor_layer", "conv_projection", "dotmul_operator",
                 "conv_operator", "scaling_projection", "slice_projection",
                 "trans_full_matrix_projection", "nce_layer", "hsigmoid",
                 "multibox_loss_layer", "factorization_machine",
                 "gated_unit_layer"]


@pytest.mark.parametrize("name", ZOO_REF_NAMES)
def test_trainer_config_helpers_name_is_callable(name):
    import paddle_tpu.trainer_config_helpers as jtch
    import paddle_tpu_torch.trainer_config_helpers as ttch

    assert callable(getattr(ttch, name)) and callable(getattr(jtch, name))


def test_trainer_config_helpers_detection_aliases_build():
    """priorbox_layer, multibox_loss_layer and detection_output_layer are
    the v2 layers, and build in the port."""
    import paddle_tpu_torch.trainer_config_helpers as ttch

    assert ttch.priorbox_layer is tv2.layer.priorbox
    assert ttch.multibox_loss_layer is tv2.layer.multibox_loss
    assert ttch.detection_output_layer is tv2.layer.detection_output
    for name in ("priorbox", "multibox_loss", "detection_output"):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            zoo_layer(tv2, tfluid, TRagged, name)
        assert name.replace("priorbox", "prior_box") in {
            op.type for op in main.desc.block(0).ops}
