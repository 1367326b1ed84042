"""The rewrite passes, the fingerprints and `fused_elemwise_chain` of the
port against the JAX package's, on the CPU.

The same programs, built by each package's own layers, go through each
package's PassManager with the same spec and fetches; the rewritten
descs must be equal through `to_dict()`, and so must the pass records
(ops and vars before and after, changed or not).  `layout`'s gate reads
the roofline's defaults, which are the card's in the port and a TPU's
in the JAX package, so it is compared with `force=1` and, for the gate,
at the JAX package's figures.  The optimized programs run in the port
against the unoptimized ones: f32 fetches bit for bit, or within 1e-5
of the largest value where `layout` converted the program (NHWC
convolutions sum in another order).  The cases are
those of tests/test_compile_passes.py and tests/test_opt_passes.py;
`auto_remat` against the JAX pass on a training program.

`fused_elemwise_chain`: its forward and generic grad against the JAX
kernel's on the same inputs (atol 1e-5 relative to the largest value,
f32) and against the unfused chain in the port (the forward bit for
bit; the grads at rtol 1e-6 in f32 and 1e-2 in bf16, the same
elementwise math with autograd's order of the chain rule).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.compile import fingerprint as jfp
from paddle_tpu.compile import passes as jpasses
from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.ragged import RaggedTensor as JRagged
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.fluid import executor as jexec
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.compile import fingerprint as tfp
from paddle_tpu_torch.compile import opt_passes as topt
from paddle_tpu_torch.compile import passes as tpasses
from paddle_tpu_torch.core.desc import OpDesc
from paddle_tpu_torch.core.ragged import RaggedTensor
from paddle_tpu_torch.fluid import executor as texec
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.utils import flags as tflags

torch.set_num_threads(1)

CPU = tfluid.CPUPlace()


@pytest.fixture(autouse=True)
def _reset_flags():
    yield
    tflags.set_flag("compile_passes", "")
    tflags.set_flag("verify_program", False)
    tflags.set_flag("amp_bf16", False)


def _pkg(name):
    return jfluid if name == "jax" else tfluid


# -- programs: (main, startup, fetch name, feed) in package `fluid` -----------

def b_crafted(fluid):
    """The JAX test's program exercising every cleanup pass: a dead op
    (dce), a duplicate pure op (cse), a static `shape` op (fold), and
    the vars they orphan (dve)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32",
                              append_batch_size=False)
        y = fluid.layers.scale(x=x, scale=2.0)
        fluid.layers.scale(x=x, scale=9.0)
        y2 = fluid.layers.scale(x=x, scale=2.0)
        z = fluid.layers.elementwise_add(x=y, y=y2)
        blk = main.global_block()
        sv = blk.create_var(name="shp_vec", dtype="int32", shape=[1])
        blk.append_op(type="shape", inputs={"Input": [y.name]},
                      outputs={"Out": [sv.name]}, infer_shape=False)
        shp = fluid.layers.cast(x=sv, dtype="float32")
        fin = fluid.layers.elementwise_add(
            x=z, y=fluid.layers.reduce_sum(shp))
    return main, startup, fin.name, {
        "x": np.arange(4, dtype=np.float32)}


def b_shape_dynamic(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        blk = main.global_block()
        sv = blk.create_var(name="s", dtype="int32", shape=[2])
        blk.append_op(type="shape", inputs={"Input": [x.name]},
                      outputs={"Out": [sv.name]}, infer_shape=False)
    return main, startup, sv.name, {"x": np.ones((3, 4), np.float32)}


def b_redefinition(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32",
                              append_batch_size=False)
        blk = main.global_block()
        a = fluid.layers.scale(x=x, scale=2.0)
        blk.append_op(type="scale", inputs={"X": [a.name]},
                      outputs={"Out": [a.name]}, attrs={"scale": 5.0},
                      infer_shape=False)
        b = fluid.layers.scale(x=x, scale=2.0)
        out = fluid.layers.elementwise_add(x=a, y=b)
    return main, startup, out.name, {"x": np.arange(4, dtype=np.float32)}


def b_while(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        i = fluid.layers.fill_constant(shape=[1], dtype="float32",
                                       value=0.0)
        acc = fluid.layers.fill_constant(shape=[1], dtype="float32",
                                         value=0.0)
        limit = fluid.layers.fill_constant(shape=[1], dtype="float32",
                                           value=5.0)
        cond = fluid.layers.less_than(x=i, y=limit)
        w = fluid.layers.While(cond=cond)
        with w.block():
            ni = fluid.layers.increment(x=i, value=1.0, in_place=True)
            nacc = fluid.layers.elementwise_add(x=acc, y=ni)
            fluid.layers.assign(input=nacc, output=acc)
            fluid.layers.less_than(x=ni, y=limit, cond=cond)
        out = fluid.layers.scale(x=acc, scale=2.0)
    return main, startup, out.name, {}


def b_dynamic_rnn(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32",
                              lod_level=1)
        drnn = fluid.layers.DynamicRNN()
        with drnn.block():
            step = drnn.step_input(x)
            mem = drnn.memory(shape=[8], batch_ref=step, value=0.0)
            h = fluid.layers.fc(input=[step, mem], size=8, act="tanh")
            drnn.update_memory(mem, h)
            drnn.output(h)
        last = fluid.layers.sequence_last_step(input=drnn())
        loss = fluid.layers.mean(x=last)
        fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    rs = np.random.RandomState(0)
    seqs = [rs.rand(n, 8).astype(np.float32) for n in (3, 5)]
    return main, startup, loss.name, {"x": seqs}


def b_fit_a_line(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    rs = np.random.RandomState(0)
    return main, startup, loss.name, {
        "x": rs.rand(4, 13).astype(np.float32),
        "y": rs.rand(4, 1).astype(np.float32)}


def b_conv_classifier(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 28, 28],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        conv = fluid.layers.conv2d(input=img, num_filters=8,
                                   filter_size=3, act="relu")
        pool = fluid.layers.pool2d(input=conv, pool_size=2, pool_stride=2)
        logits = fluid.layers.fc(input=pool, size=10, act="softmax")
        loss = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=logits, label=label))
        fluid.optimizer.MomentumOptimizer(learning_rate=0.01,
                                          momentum=0.9).minimize(loss)
    rs = np.random.RandomState(0)
    return main, startup, loss.name, {
        "img": rs.rand(4, 1, 28, 28).astype(np.float32),
        "label": rs.randint(0, 10, size=(4, 1)).astype(np.int64)}


def b_deepfm(fluid):
    if fluid is jfluid:
        from paddle_tpu.models.ctr import deepfm_ctr
    else:
        from paddle_tpu_torch.models.ctr import deepfm_ctr
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[4], dtype="int64")
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        avg_loss, _ = deepfm_ctr(ids, label, num_features=64, num_fields=4,
                                 embed_dim=4, hidden_sizes=(8,))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(avg_loss)
    rs = np.random.RandomState(0)
    return main, startup, avg_loss.name, {
        "ids": rs.randint(0, 64, size=(4, 4)).astype(np.int64),
        "label": rs.randint(0, 2, size=(4, 1)).astype(np.float32)}


def b_transformer(fluid):
    if fluid is jfluid:
        from paddle_tpu.models.transformer_program import (
            build_transformer_program, transformer_program_feeds)

        main, startup, loss, _ = build_transformer_program(
            2, 8, 32, n_layer=1, n_head=2, d_model=16)
        with jfluid.program_guard(main, startup):
            jfluid.optimizer.MomentumOptimizer(
                learning_rate=0.01, momentum=0.9).minimize(loss)
        return main, startup, loss.name, transformer_program_feeds(2, 8,
                                                                   32)
    from paddle_tpu_torch.models.transformer_program import (
        build_transformer_program, transformer_feeds)

    main, startup, loss, _ = build_transformer_program(
        2, 8, 32, n_layer=1, n_head=2, d_model=16)
    tfluid.MomentumOptimizer(0.01, 0.9).minimize(loss, main, startup)
    return main, startup, loss, transformer_feeds(2, 8, 32, targets=True)


def _forward_conv(fluid, channels):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[4, channels, 8, 8],
                                dtype="float32", append_batch_size=False)
        conv = fluid.layers.conv2d(input=img, num_filters=channels,
                                   filter_size=3, padding=1, act="relu")
        pool = fluid.layers.pool2d(input=conv, pool_size=8,
                                   pool_type="avg", global_pooling=True)
        out = fluid.layers.fc(input=pool, size=4)
    rs = np.random.RandomState(1)
    return main, startup, out.name, {
        "img": rs.rand(4, channels, 8, 8).astype(np.float32)}


def b_forward_conv8(fluid):
    return _forward_conv(fluid, 8)


def b_forward_conv128(fluid):
    return _forward_conv(fluid, 128)


def b_residual(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4, 8], dtype="float32",
                              append_batch_size=False)
        y = fluid.layers.scale(x=x, scale=2.0)
        z = fluid.layers.elementwise_add(x=x, y=y)
        r = fluid.layers.relu(z)
        out = fluid.layers.reduce_sum(r)
    return main, startup, out.name, {
        "x": np.random.RandomState(0).rand(4, 8).astype(np.float32) - 0.5}


def b_multi_use(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4, 8], dtype="float32",
                              append_batch_size=False)
        y = fluid.layers.relu(x)
        a = fluid.layers.scale(x=y, scale=2.0)
        b = fluid.layers.scale(x=y, scale=3.0)
        out = fluid.layers.elementwise_add(x=a, y=b)
    return main, startup, out.name, {
        "x": np.random.RandomState(0).rand(4, 8).astype(np.float32) - 0.5}


def b_resnet50_forward(fluid):
    if fluid is jfluid:
        from paddle_tpu.models.image import resnet50
    else:
        from paddle_tpu_torch.models.image import resnet50
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        image = fluid.layers.data(name="image", shape=[2, 3, 32, 32],
                                  dtype="float32", append_batch_size=False)
        logits = resnet50(image, class_dim=10)
    main = main.clone(for_test=True)
    return main, startup, logits.name, {
        "image": np.random.RandomState(2).randn(2, 3, 32, 32)
        .astype(np.float32)}


PROGRAMS = {name[2:]: fn for name, fn in sorted(globals().items())
            if name.startswith("b_")}

# (prog, spec) pairs: each pass alone where it acts, the default
# pipeline everywhere, and the opt passes (layout forced: its gate reads
# each package's own default figures)
CASES = sorted(
    [(b, s) for b in ("crafted",) for s in ("dce", "fold", "cse", "dve")]
    + [("shape_dynamic", "fold"), ("redefinition", "cse"),
       ("while", "default"), ("dynamic_rnn", "dce,dve"),
       ("residual", "fuse"), ("residual", "fuse:cap=2"),
       ("multi_use", "fuse"), ("forward_conv8", "layout:force=1"),
       ("resnet50_forward", "default+layout:force=1+fuse"),
       ("resnet50_forward", "default+fuse:cap=2")]
    + [(b, s) for b in ("fit_a_line", "conv_classifier", "dynamic_rnn",
                        "deepfm", "transformer", "crafted")
       for s in ("default", "default+layout:force=1+fuse",
                 "default+layout:force=1+fuse:cap=2")])


def _optimize(pkg, prog, spec, fetches=None):
    main, startup, fetch, feed = PROGRAMS[prog](_pkg(pkg))
    passes = jpasses if pkg == "jax" else tpasses
    pm = passes.PassManager(spec, verify_level="full", explain=True)
    opt = pm.run(main, fetches=[fetch] if fetches is None else fetches)
    return main, startup, fetch, feed, opt, pm


def _record(r):
    """A pass record without its seconds; a note by its first words (a
    declining `layout` prices its floors at each package's own default
    figures, and names fluid.convert_layout alone in the port)."""
    out = {k: r[k] for k in ("pass", "changed", "ops_before", "ops_after",
                             "vars_before", "vars_after")}
    out["note"] = r["note"] and " ".join(r["note"].split()[:3])
    return out


def _diff(r):
    """A pass's explain diff without the layout floors (each package's
    own default figures)."""
    diff = dict(r["diff"] or {})
    diff.pop("floor_ms_ideal", None)
    return diff


@pytest.mark.parametrize("prog,spec", CASES,
                         ids=["%s-%s" % c for c in CASES])
def test_rewrite_equals_jax(prog, spec):
    """The rewritten desc, the records and the explain diffs equal the
    JAX pipeline's."""
    *_, jopt, jpm = _optimize("jax", prog, spec)
    *_, topt_, tpm = _optimize("torch", prog, spec)
    assert topt_.desc.to_dict() == jopt.desc.to_dict()
    assert [_record(r) for r in tpm.records] == \
        [_record(r) for r in jpm.records]
    assert [_diff(r) for r in tpm.records] == \
        [_diff(r) for r in jpm.records]
    assert tpm.pipeline_id == jpm.pipeline_id


def _port_run(main, startup, fetch, feed):
    """The fetch of one run of `main` from startup's state in a fresh
    scope on the CPU."""
    exe = texec.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    if feed and isinstance(next(iter(feed.values())), list):
        feed = {k: RaggedTensor.from_sequences(v) for k, v in feed.items()}
    return exe.run(main, feed=feed, fetch_list=[fetch], scope=scope)[0]


def _same_bits(a, b):
    if isinstance(a, RaggedTensor):
        return a.lod() == b.lod() and _same_bits(a.values.numpy(),
                                                 b.values.numpy())
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("prog,spec", CASES,
                         ids=["%s-%s" % c for c in CASES])
def test_optimized_fetch_equals_plain(prog, spec):
    """The optimized program's fetch in the port, bit for bit the
    unoptimized program's (f32); within 1e-5 of the largest value where
    `layout` converted the program."""
    main, startup, fetch, feed, opt, pm = _optimize("torch", prog, spec)
    torch.manual_seed(0)
    plain = _port_run(main, startup, fetch, feed)
    torch.manual_seed(0)
    got = _port_run(opt, startup, fetch, feed)
    if any(r["pass"].startswith("layout") and r["changed"]
           for r in pm.records):
        # NHWC convolutions sum in another order: not the same bits
        top = float(np.abs(plain).max())
        np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5 * top)
    else:
        assert _same_bits(plain, got), (plain, got)


def test_every_cleanup_pass_acts_on_the_crafted_program():
    _, _, fetch, _, opt, pm = _optimize("torch", "crafted", "default")
    assert all(r["changed"] for r in pm.records), pm.records
    types = [od.type for od in opt.desc.block(0).ops]
    assert types.count("scale") == 1 and "shape" not in types \
        and "assign_value" in types
    od = opt.desc.block(0).ops[types.index("assign_value")]
    assert od.attrs["values"] == [4]
    add = next(od for od in opt.desc.block(0).ops
               if od.type == "elementwise_add")
    assert add.input("X") == add.input("Y")


def test_passes_never_change_the_input_program():
    main, _, fetch, _ = b_crafted(tfluid)
    before = main.desc.serialize_to_string()
    tpasses.PassManager("default+fuse").run(main, fetches=[fetch])
    assert main.desc.serialize_to_string() == before


def test_dce_declines_without_fetches_and_keeps_sub_blocks():
    main, _, fetch, _ = b_crafted(tfluid)
    opt = tpasses.PassManager("dce").run(main, fetches=[])
    assert len(opt.desc.block(0).ops) == len(main.desc.block(0).ops)
    for name in ("while", "dynamic_rnn"):
        main, _, fetch, _, opt, _ = _optimize("torch", name, "default")
        assert len(opt.desc.block(1).ops) == len(main.desc.block(1).ops)
    main, startup, fetch, feed = b_while(tfluid)
    assert float(_port_run(main, startup, fetch, feed)[0]) == 30.0


def test_fold_under_the_amp_policy_equals_jax():
    """`fold` keeps a float fill while the bf16 policy is on (the flag
    that `bf16_guard()` sets, read inside the run), and folds it with
    the policy off, as the JAX pass under its flag does; a program built
    under the guard folds as the JAX one built under its flag."""
    from paddle_tpu.utils import flags as jflags
    from paddle_tpu_torch.fluid import amp

    def program(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[2, 4], dtype="float32",
                                  append_batch_size=False)
            h = fluid.layers.fc(input=x, size=4)
            blk = main.global_block()
            z = blk.create_var(name="zeros", dtype=h.dtype, shape=[2, 4])
            blk.append_op(type="fill_zeros_like", inputs={"X": [h.name]},
                          outputs={"Out": [z.name]})
            out = fluid.layers.elementwise_add(x=h, y=z)
        return main, out.name

    def fold_both(build_amp, run_amp):
        jflags.set_flag("amp_bf16", build_amp)
        try:
            jm, jout = program(jfluid)
            jflags.set_flag("amp_bf16", run_amp)
            want = jpasses.PassManager("fold").run(jm, fetches=[jout])
        finally:
            jflags.set_flag("amp_bf16", False)
        if build_amp:
            with amp.bf16_guard():
                tm, tout = program(tfluid)
        else:
            tm, tout = program(tfluid)
        if run_amp:
            with amp.bf16_guard():
                got = tpasses.PassManager("fold").run(tm, fetches=[tout])
        else:
            got = tpasses.PassManager("fold").run(tm, fetches=[tout])
        assert got.desc.to_dict() == want.desc.to_dict()
        return [od.type for od in got.desc.block(0).ops]

    assert "fill_zeros_like" in fold_both(False, True)
    assert "fill_zeros_like" not in fold_both(False, False)
    fold_both(True, True)


def test_layout_gate_at_the_jax_figures(monkeypatch):
    """The gate itself (not forced) at the JAX package's default figures
    decides as the JAX gate does, on a narrow and a wide conv."""
    from paddle_tpu_torch.fluid import analysis as troof

    def floor(program):
        return troof.roofline_report(
            program, peak_tflops=197.0, hbm_gbps=819.0, tpu_tiling=True,
            bf16_act=topt._bf16_act_now())["floor_ms_ideal"]

    monkeypatch.setattr(topt.LayoutOptimize, "_tiled_floor",
                        staticmethod(floor))
    for prog in ("forward_conv8", "forward_conv128", "resnet50_forward"):
        *_, jo, jpm = _optimize("jax", prog, "layout")
        *_, to, tpm = _optimize("torch", prog, "layout")
        assert to.desc.to_dict() == jo.desc.to_dict(), prog
        assert [_record(r) for r in tpm.records] == \
            [_record(r) for r in jpm.records], prog
    *_, tpm = _optimize("torch", "forward_conv8", "layout")
    assert "no win" in tpm.records[0]["note"]


def test_layout_declines_as_the_jax_pass_does():
    for prog, fetches, note in (
            ("forward_conv8", [], "dce contract"),
            ("conv_classifier", None, "before append_backward")):
        main, _, _, _, opt, pm = _optimize("torch", prog,
                                           "layout:force=1", fetches)
        assert not pm.records[0]["changed"] and note in \
            pm.records[0]["note"]
        assert opt.desc.serialize_to_string() == \
            main.desc.serialize_to_string()
    # a fetched C==H==W intermediate
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            img = fluid.layers.data(name="img", shape=[2, 8, 8, 8],
                                    dtype="float32",
                                    append_batch_size=False)
            conv = fluid.layers.conv2d(input=img, num_filters=8,
                                       filter_size=3, padding=1,
                                       act="relu")
            out = fluid.layers.reduce_sum(conv)
        mid = next(od.output("Out")[0] for od in main.desc.block(0).ops
                   if od.type == "relu")
        passes = jpasses if fluid is jfluid else tpasses
        pm = passes.PassManager("layout:force=1")
        pm.run(main, fetches=[mid, out.name])
        assert "changes layout" in pm.records[0]["note"]


def test_fuse_contracts():
    main, _, fetch, _, opt, _ = _optimize("torch", "residual", "fuse")
    types = [od.type for od in opt.desc.block(0).ops]
    assert "fused_elemwise_chain" in types and "relu" not in types \
        and "elementwise_add" not in types
    *_, opt, _ = _optimize("torch", "residual", "fuse:cap=2")
    assert all(len(od.attr("inner_types")) <= 2
               for od in opt.desc.block(0).ops
               if od.type == "fused_elemwise_chain")
    mid = next(od.output("Out")[0] for od in main.desc.block(0).ops
               if od.type == "elementwise_add")
    *_, opt, _ = _optimize("torch", "residual", "fuse", fetches=[mid])
    assert mid in opt.desc.block(0).vars and "relu" in [
        od.type for od in opt.desc.block(0).ops]
    *_, pm = _optimize("torch", "residual", "fuse", fetches=[])
    assert "dce contract" in pm.records[0]["note"]
    *_, opt, _ = _optimize("torch", "multi_use", "fuse")
    assert "relu" in [od.type for od in opt.desc.block(0).ops]


def test_auto_remat_waits_with_recompute():
    """Named for what the pass once did (it raised, waiting with
    fluid/recompute.py): the port's `auto_remat` now rewrites through
    its own recompute.py.  The rewritten desc, the record and the
    explain diff (the activation peak before and after) equal the JAX
    pass's; the peak falls; 3 Momentum steps of the rewritten program
    in the port equal the plain program's bit for bit."""
    assert tpasses.available_passes() == jpasses.available_passes()
    spec = "auto_remat:stride=2:budget_gb=0"
    *_, jopt, jpm = _optimize("jax", "conv_classifier", spec)
    main, startup, fetch, feed, opt, pm = _optimize(
        "torch", "conv_classifier", spec)
    assert opt.desc.to_dict() == jopt.desc.to_dict()
    assert [_record(r) for r in pm.records] == \
        [_record(r) for r in jpm.records]
    assert [_diff(r) for r in pm.records] == \
        [_diff(r) for r in jpm.records]
    peaks = pm.records[0]["diff"]["activation_peak_bytes"]
    assert peaks["after"] < peaks["before"]
    types = [od.type for od in opt.desc.block(0).ops]
    assert "recompute_barrier" in types
    # the activation-peak estimate, its accept gate, equals the JAX one
    jm, _, jfetch, _ = b_conv_classifier(jfluid)
    from paddle_tpu.compile import opt_passes as jopt_mod

    assert topt.activation_peak_bytes(main.desc, [fetch]) == \
        jopt_mod.activation_peak_bytes(jm.desc, [jfetch])
    runs = []
    for desc in (main.desc, opt.desc):
        exe = texec.Executor(CPU)
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        runs.append([exe.run(desc, feed=feed, fetch_list=[fetch],
                             scope=scope)[0] for _ in range(3)])
    assert all(_same_bits(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("spec", [
    "default", "default+layout+fuse", "default+layout+fuse:cap=2",
    "default+layout+fuse:cap=4", "default+layout+fuse+auto_remat",
    "default+layout+fuse+auto_remat:stride=2",
    "default+layout+fuse+auto_remat:stride=4:budget_gb=0",
    "fuse:cap=0", "layout:force=0", "auto_remat:budget_gb=2000000",
    "dce,fold,cse,dve,layout,fuse", ""])
def test_pipeline_id_and_spec_equal_jax(spec):
    assert tpasses.pipeline_id(spec) == jpasses.pipeline_id(spec)
    if spec:
        assert tpasses.PassManager(spec, verify=False).spec == \
            jpasses.PassManager(spec, verify=False).spec


@pytest.mark.parametrize("spec,match", [
    ("dce,nope", "unknown pass"), ("fuse:nope=1", "no option"),
    ("fuse:cap=1", "cap"), ("auto_remat:stride=0", "stride"),
    ("fuse:cap", "malformed")])
def test_bad_specs_rejected(spec, match):
    with pytest.raises(ValueError, match=match):
        tpasses.PassManager(spec)


def test_explain_text_equals_jax_but_for_times():
    def strip(text):
        import re

        return re.sub(r"\(\d+\.\d ms\)", "", text)

    *_, jpm = _optimize("jax", "crafted", "default+fuse")
    *_, tpm = _optimize("torch", "crafted", "default+fuse")
    assert strip(tpm.explain_text()) == strip(jpm.explain_text())
    assert "removed_ops" in tpm.explain_text()


def test_verifier_runs_around_every_pass(monkeypatch):
    from paddle_tpu_torch.analysis import ProgramVerificationError

    class BreakIR(tpasses.RewritePass):
        name = "dce"

        def run(self, desc, ctx):
            del desc.block(0).vars["x"]
            return {"broke": ["it"]}

    monkeypatch.setitem(tpasses._PASSES, "dce", BreakIR())
    main, _, fetch, _ = b_crafted(tfluid)
    with pytest.raises(ProgramVerificationError):
        tpasses.PassManager("dce").run(main, fetches=[fetch])


# -- fingerprints ---------------------------------------------------------------

def _jax_transformer():
    main, *_ = b_transformer(jfluid)
    return main


def _jax_seq2seq(fluid):
    if fluid is jfluid:
        from paddle_tpu.models.text import seq2seq
    else:
        from paddle_tpu_torch.models.text import seq2seq
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.layers.data(name="src", shape=[1], dtype="int64",
                                lod_level=1)
        trg = fluid.layers.data(name="trg", shape=[1], dtype="int64",
                                lod_level=1)
        lbl = fluid.layers.data(name="lbl", shape=[1], dtype="int64",
                                lod_level=1)
        cost = seq2seq(src, trg, 100, 100, emb_dim=8, hidden_dim=8)
        loss = fluid.layers.mean(x=fluid.layers.cross_entropy(
            input=cost, label=lbl)) if cost.shape[-1] != 1 else \
            fluid.layers.mean(x=cost)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main


@pytest.mark.parametrize("program", ["transformer", "resnet50_forward",
                                     "seq2seq", "crafted", "dynamic_rnn"])
def test_program_fingerprint_equals_jax(program):
    """The same program, feeds, fetches, flags and pipeline id give the
    same hex digest in both packages."""
    if program == "seq2seq":
        try:
            jm, tm = _jax_seq2seq(jfluid), _jax_seq2seq(tfluid)
        except (ImportError, TypeError) as exc:
            raise AssertionError("seq2seq prog: %s" % exc)
        fetch = "x"
    else:
        jm, _, fetch, _ = PROGRAMS[program](jfluid)
        tm, *_ = PROGRAMS[program](tfluid)
    kw = dict(feeds=["b", "a"], fetches=[fetch],
              flag_items=[("amp_bf16", False), ("amp_bf16_act", True)],
              pipeline_id=tpasses.pipeline_id("default+fuse"),
              mesh={"dp": 1})
    assert tfp.canonical_desc(tm) == jfp.canonical_desc(jm)
    assert tfp.program_fingerprint(tm, **kw) == \
        jfp.program_fingerprint(jm, **kw)
    assert tfp.program_fingerprint(tm) != tfp.program_fingerprint(
        tm, pipeline_id="x")


def test_canonical_attrs_and_combine_equal_jax():
    from paddle_tpu.core.desc import BlockRef as JBlockRef
    from paddle_tpu_torch.core.desc import BlockRef

    vals = [np.int64(3), np.float32(0.1), np.bool_(True), (1, 2), [1.5],
            b"ab", "s", 0.1, None]
    assert [tfp._jsonable(v) for v in vals] == \
        [jfp._jsonable(v) for v in vals]
    assert tfp._jsonable(BlockRef(2)) == jfp._jsonable(JBlockRef(2))
    assert tfp.combine("a", 1, "b") == jfp.combine("a", 1, "b")


def test_values_signature():
    rt = RaggedTensor.from_sequences([np.ones((2, 3), np.float32),
                                      np.ones((1, 3), np.float32)])
    sig = tfp.values_signature({"b": torch.zeros(2, 3), "a": rt,
                                "c": np.zeros((4,), np.int32)})
    assert sig == tfp.values_signature([("a", rt), ("c", np.zeros(
        (4,), np.int32)), ("b", torch.zeros(2, 3))])
    key = tfp.values_signature_key({"b": torch.zeros(2, 3)})
    assert key == (("b", ("t", (2, 3), "float32")),)
    # JAX values of the same shapes sign the same way
    jkey = jfp.values_signature_key({"b": jnp.zeros((2, 3))})
    assert key == jkey
    assert tfp.environment_fingerprint() != jfp.environment_fingerprint()


# -- fused_elemwise_chain --------------------------------------------------------

def _jax_value(v):
    if isinstance(v, RaggedTensor):
        return JRagged(jnp.asarray(v.values.numpy()),
                       [s.numpy() for s in v.row_splits],
                       nvalid=int(v.nvalid), max_seqlen=v.max_seqlen)
    return jnp.asarray(v.float().numpy() if v.dtype == torch.bfloat16
                       else v.numpy())


def _run(op_type, env, ins, outs, attrs):
    jctx = jexec.ExecContext(None, None, 0,
                             {n: _jax_value(v) for n, v in env.items()})
    jexec.apply_op(jctx, JOpDesc(op_type, ins, outs, attrs))
    tctx = texec.ExecContext(None, 0, dict(env), device=torch.device("cpu"))
    texec.apply_op(tctx, OpDesc(op_type, ins, outs, attrs))
    return jctx.env, tctx.env


_STAGES = [
    {"op": "scale", "attrs": {"scale": 2.0, "bias": 0.5}, "in": "X"},
    {"op": "elementwise_add", "in": "X", "side": 0, "attrs": {"axis": -1}},
    {"op": "relu", "in": "X"},
    {"op": "elementwise_mul", "in": "Y", "side": 1, "attrs": {"axis": -1}},
    {"op": "tanh", "in": "X"},
    {"op": "elementwise_sub", "in": "X", "side": 0, "attrs": {"axis": -1}},
    {"op": "sigmoid", "in": "X"},
]


def _chain_inputs(dtype):
    rs = np.random.RandomState(5)
    return {n: torch.from_numpy(rs.randn(6, 8).astype(np.float32))
            .to(dtype) for n in ("x", "s0", "s1")}


def _fused_attrs():
    import json

    return {"stages": json.dumps(_STAGES, sort_keys=True),
            "inner_types": [s["op"] for s in _STAGES]}


_FUSED_INS = {"X": ["x"], "SideIns": ["s0", "s1"]}


def test_fused_chain_forward_and_grad_equal_jax():
    env = _chain_inputs(torch.float32)
    attrs = _fused_attrs()
    j, t = _run("fused_elemwise_chain", env, _FUSED_INS, {"Out": ["y"]},
                attrs)
    want = np.asarray(j["y"])
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(t["y"].numpy(), want, rtol=0,
                               atol=1e-5 * scale)
    og = torch.from_numpy(np.random.RandomState(6).randn(6, 8)
                          .astype(np.float32))
    genv = dict(env, y=t["y"], og=og)
    gins = dict(_FUSED_INS, **{"O@Out": ["y"], "OG@Out": ["og"]})
    gouts = {"X@GRAD": ["x@GRAD"], "SideIns@GRAD": ["s0@GRAD", "s1@GRAD"]}
    j, t = _run("fused_elemwise_chain_grad", genv, gins, gouts, attrs)
    for n in ("x@GRAD", "s0@GRAD", "s1@GRAD"):
        want = np.asarray(j[n])
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(t[n].numpy(), want, rtol=0,
                                   atol=1e-5 * scale, err_msg=n)


def _unfused_chain(x, s0, s1):
    """The chain's stages through the port's registered kernels, one op
    after the other, in autograd."""
    from paddle_tpu_torch.ops.registry import get_op_info

    side = [s0, s1]
    val = x
    for st in _STAGES:
        ins = {st.get("in", "X"): [val]}
        if "side" in st:
            ins["Y" if st.get("in", "X") == "X" else "X"] = \
                [side[st["side"]]]
        val = get_op_info(st["op"]).kernel(None, ins, st.get(
            "attrs") or {})["Out"][0]
    return val


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6),
                                        (torch.bfloat16, 1e-2)])
def test_fused_chain_against_the_unfused_chain(dtype, rtol):
    """The fused op's forward gives the unfused ops' bits; its generic
    grad (torch.func.vjp through the stage kernels) the unfused chain's
    grads."""
    env = _chain_inputs(dtype)
    ctx = texec.ExecContext(None, 0, dict(env), device=torch.device("cpu"))
    texec.apply_op(ctx, OpDesc("fused_elemwise_chain", _FUSED_INS,
                               {"Out": ["y"]}, _fused_attrs()))
    x, s0, s1 = (env[n].clone().requires_grad_() for n in ("x", "s0",
                                                           "s1"))
    ref = _unfused_chain(x, s0, s1)
    assert _same_bits(ctx.env["y"].float().numpy(),
                      ref.detach().float().numpy())
    og = torch.from_numpy(np.random.RandomState(6).randn(6, 8)
                          .astype(np.float32)).to(dtype)
    ref.backward(og)
    ctx.env.update(og=og)
    texec.apply_op(ctx, OpDesc(
        "fused_elemwise_chain_grad",
        dict(_FUSED_INS, **{"O@Out": ["y"], "OG@Out": ["og"]}),
        {"X@GRAD": ["x@GRAD"], "SideIns@GRAD": ["s0@GRAD", "s1@GRAD"]},
        _fused_attrs()))
    for n, leaf in (("x", x), ("s0", s0), ("s1", s1)):
        got = ctx.env[n + "@GRAD"].float()
        want = leaf.grad.float()
        torch.testing.assert_close(got, want, rtol=rtol,
                                   atol=rtol * float(want.abs().max()))


def test_fused_program_trains_like_the_unfused_one():
    """A forward fused by the pass, then append_backward: the fused op's
    grad in a training step gives the unfused program's parameters."""
    def program(fuse):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data(name="x", shape=[8], dtype="float32")
            h = tfluid.layers.fc(input=x, size=8)
            z = tfluid.layers.relu(tfluid.layers.scale(x=h, scale=0.5))
            out = tfluid.layers.tanh(z)
            loss = tfluid.layers.mean(x=out)
        if fuse:
            main = tpasses.PassManager("fuse").run(main, fetches=[loss.name])
            assert "fused_elemwise_chain" in [
                od.type for od in main.desc.block(0).ops]
        with tfluid.program_guard(main, startup):
            tfluid.optimizer.SGD(learning_rate=0.5).minimize(
                main.global_block().var(loss.name))
        return main, startup, loss.name

    rs = np.random.RandomState(3)
    feed = {"x": rs.randn(4, 8).astype(np.float32)}
    params = []
    for fuse in (False, True):
        main, startup, loss = program(fuse)
        exe, scope = texec.Executor(CPU), tfluid.Scope()
        torch.manual_seed(0)
        exe.run(startup, scope=scope)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        names = [n for n, v in startup.desc.block(0).vars.items()
                 if v.persistable]
        params.append({p: scope.get(p).numpy() for p in names})
    for p in params[0]:
        np.testing.assert_allclose(params[1][p], params[0][p], rtol=1e-6,
                                   atol=1e-7)


# -- the executor under both flags ------------------------------------------------

def _transformer_steps(spec, verify, steps=3):
    from paddle_tpu_torch.models.transformer_program import (
        build_transformer_program, transformer_feeds)

    main, startup, loss, _ = build_transformer_program(
        2, 8, 32, n_layer=1, n_head=2, d_model=16)
    tfluid.AdamOptimizer(1e-3).minimize(loss, main, startup)
    exe, scope = texec.Executor(CPU), tfluid.Scope()
    torch.manual_seed(0)
    exe.run(startup, scope=scope)
    tflags.set_flag("compile_passes", spec)
    tflags.set_flag("verify_program", verify)
    try:
        out = [exe.run(main, feed=transformer_feeds(2, 8, 32, seed=i,
                                                     targets=True),
                       fetch_list=[loss], scope=scope)[0]
               for i in range(steps)]
    finally:
        tflags.set_flag("compile_passes", "")
        tflags.set_flag("verify_program", False)
    state = {n: scope.get(n).numpy() for n, v in main.block(0).vars.items()
             if v.persistable}
    return out, state, exe


def test_executor_under_both_flags_fetches_the_plain_run():
    plain, pstate, _ = _transformer_steps("", False)
    got, gstate, exe = _transformer_steps("default+fuse", True)
    assert all(_same_bits(a, b) for a, b in zip(plain, got))
    assert all(_same_bits(pstate[n], gstate[n]) for n in pstate)
    assert exe.pipeline_runs == 1
    assert exe.last_pipeline.spec == "dce,fold,cse,dve,fuse"


def test_executor_runs_the_rewritten_clone_once():
    main, startup, fetch, feed = b_crafted(tfluid)
    exe, scope = texec.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    plain = exe.run(main, feed=feed, fetch_list=[fetch], scope=scope)[0]
    tflags.set_flag("compile_passes", "default")
    outs = [exe.run(main, feed=feed, fetch_list=[fetch], scope=scope)[0]
            for _ in range(3)]
    assert exe.pipeline_runs == 1
    assert all(_same_bits(plain, o) for o in outs)
    assert [od.type for od in main.desc.block(0).ops].count("scale") == 3
    # another spec, the AMP flags or an edited program each rewrite anew
    tflags.set_flag("compile_passes", "default+fuse")
    exe.run(main, feed=feed, fetch_list=[fetch], scope=scope)
    assert exe.pipeline_runs == 2
    with tfluid.program_guard(main, startup):
        extra = tfluid.layers.scale(x=main.global_block().var(fetch),
                                    scale=1.0)
    exe.run(main, feed=feed, fetch_list=[extra.name], scope=scope)
    exe.run(main, feed=feed, fetch_list=[extra.name], scope=scope)
    assert exe.pipeline_runs == 3


def test_executor_verify_gate_with_passes_raises_on_a_broken_program():
    from paddle_tpu_torch.analysis import ProgramVerificationError

    main, startup, fetch, feed = b_crafted(tfluid)
    bad = main.clone()
    bad.desc.block(0).ops[1].type = "definitely_not_an_op"
    exe, scope = texec.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    tflags.set_flag("compile_passes", "default")
    with pytest.raises(ProgramVerificationError):
        exe.run(bad, feed=feed, fetch_list=[fetch], scope=scope)


def test_serving_warmup_refuses_a_broken_export(tmp_path):
    import json
    import os

    from paddle_tpu_torch.analysis import ProgramVerificationError
    from paddle_tpu_torch.serving import EngineConfig, InferenceEngine

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        img = tfluid.layers.data(name="img", shape=[8], dtype="float32")
        probs = tfluid.layers.fc(input=img, size=3, act="softmax")
    scope = tfluid.Scope()
    texec.Executor(CPU).run(startup, scope=scope)
    tio.save_inference_model(str(tmp_path), ["img"], [probs], scope, main,
                             bucket_hints={"batch_buckets": [1, 2]})
    # an op whose output shape no longer follows from its inputs passes
    # the load's structural check and fails the warmup's full check
    path = os.path.join(str(tmp_path), "__model__")
    with open(path) as f:
        meta = json.load(f)
    for var in meta["program"]["blocks"][0]["vars"]:
        if var["name"] == probs.name:
            var["shape"] = [-1, 7]
    with open(path, "w") as f:
        json.dump(meta, f)
    engine = InferenceEngine.from_saved_model(
        str(tmp_path), place=CPU, config=EngineConfig(batch_buckets=[1]))
    tflags.set_flag("compile_passes", "default+fuse")
    with pytest.raises(ProgramVerificationError) as ei:
        engine.warmup()
    assert "V006" in {d.code for d in ei.value.report.errors}
