"""The program analysis of the port against the JAX package's, on the CPU.

The same programs, built by each package's own layers (or edited the
same way), go through both packages' `check_program`, `verify_program`,
`analyze_dataflow`, `lint_program` and `roofline_report`.  Tolerance:
none.  Findings compare by (code, severity, block, op index, op type,
var) and by the count of suppressed ones; the roofline's reports
compare as dicts, float for float, at the same explicit figures.  The
cases are those of tests/test_program_analysis.py (the memory-optimize
ones aside: the port has no memory_optimize transpiler), the
transformer and ResNet-50 at small sizes, and the census of the
registry facts the analysis reads.  Also here: the port's wiring (the
executor's FLAGS_verify_program gate, `load_inference_model`'s check,
the serving warmup's check, the published counters).
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu import analysis as janalysis
from paddle_tpu.core import desc as jdesc
from paddle_tpu.fluid import analysis as jroof
from paddle_tpu.fluid.layers import tensor as jtensor
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch import analysis as tanalysis
from paddle_tpu_torch.core import desc as tdesc
from paddle_tpu_torch.fluid import analysis as troof
from paddle_tpu_torch.fluid.layers import tensor as ttensor
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.utils import flags as tflags

torch.set_num_threads(1)

J = SimpleNamespace(fluid=jfluid, analysis=janalysis, desc=jdesc,
                    tensor=jtensor, name="jax")
T = SimpleNamespace(fluid=tfluid, analysis=tanalysis, desc=tdesc,
                    tensor=ttensor, name="torch")


def _build_train(P):
    """fc -> mse -> SGD in a fresh Program pair (the JAX test's)."""
    fluid = P.fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def findings(rep):
    return (sorted((d.code, d.severity, d.block_idx, d.op_index,
                    d.op_type, d.var_name) for d in rep.diagnostics),
            len(rep.suppressed))


# -- the cases: each builds a program in package P and names the check ------

def case_clean_train(P):
    main, _, loss = _build_train(P)
    return main, dict(fetches=[loss.name])


def case_clean_startup(P):
    return _build_train(P)[1], {}


def case_v001_unknown_op(P):
    main, _, _ = _build_train(P)
    main.desc.block(0).ops[1].type = "definitely_not_an_op"
    return main, dict(level="structural")


def case_v002_undeclared_var(P):
    main, _, _ = _build_train(P)
    main.desc.block(0).ops[0].inputs["X"] = ["never_declared"]
    return main, dict(level="structural")


def case_v003_use_before_def(P):
    main, _, loss = _build_train(P)
    ops = main.desc.block(0).ops
    idx = next(i for i, od in enumerate(ops)
               if loss.name in od.output_names())
    ops.insert(0, ops.pop(idx))
    return main, dict(level="structural")


def case_v004_dangling_block_ref(P):
    main, _, _ = _build_train(P)
    main.desc.block(0).ops[0].attrs["sub_block"] = P.desc.BlockRef(42)
    return main, dict(level="structural")


def _mul_out(main):
    bd = main.desc.block(0)
    return bd, next(od.output_names()[0] for od in bd.ops
                    if od.type == "mul")


def case_v005_dtype_mismatch(P):
    main, _, _ = _build_train(P)
    bd, out = _mul_out(main)
    bd.vars[out].dtype = "int32"
    return main, {}


def case_v006_shape_mismatch(P):
    main, _, _ = _build_train(P)
    bd, out = _mul_out(main)
    bd.vars[out].shape = (-1, 7)
    return main, {}


def case_v007_infer_failure(P):
    main, _, _ = _build_train(P)
    main.desc.block(0).vars["x"].shape = (-1, 5)
    return main, {}


def case_v008_bad_attr(P):
    main, _, _ = _build_train(P)
    main.desc.block(0).ops[0].attrs["hook"] = object()
    return main, dict(level="structural")


def case_inplace_first_writer(P):
    fluid = P.fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[1], dtype="float32",
                              append_batch_size=False)
        P.tensor.increment(x, value=1.0, in_place=True)
    return main, dict(level="structural")


def _dropout_program(P):
    fluid = P.fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        fluid.layers.dropout(x=x, dropout_prob=0.5)
    return main


def case_l003_rng_unseeded(P):
    return _dropout_program(P), {}


def case_l003_program_seed(P):
    main = _dropout_program(P)
    main.random_seed = 7
    return main, {}


def case_l003_fix_seed(P):
    main = _dropout_program(P)
    next(od for od in main.desc.block(0).ops
         if od.type == "dropout").attrs["fix_seed"] = True
    return main, {}


def case_l003_bare_desc(P):
    main = _dropout_program(P)
    main.random_seed = 1234
    return P.desc.ProgramDesc.from_dict(main.desc.to_dict()), {}


def case_d001_with_fetches(P):
    main, _, loss = _build_train(P)
    bd = main.desc.block(0)
    bd.vars["__unused__"] = P.desc.VarDesc("__unused__", dtype="float32",
                                           shape=(1,))
    bd.ops.append(P.desc.OpDesc("scale", {"X": [loss.name]},
                                {"Out": ["__unused__"]}, {"scale": 1.0}))
    return main, dict(fetches=[loss.name])


def case_d001_without_fetches(P):
    main, _ = case_d001_with_fetches(P)
    return main, {}


def case_d002_dead_var(P):
    main, _, _ = _build_train(P)
    main.desc.block(0).vars["__orphan__"] = P.desc.VarDesc(
        "__orphan__", dtype="float32", shape=(4,))
    return main, {}


def case_h001_write_write(P):
    main, _, _ = _build_train(P)
    bd = main.desc.block(0)
    i = next(i for i, od in enumerate(bd.ops) if od.type == "mul")
    od = bd.ops[i]
    bd.ops.insert(i + 1, P.desc.OpDesc(od.type, dict(od.inputs),
                                       dict(od.outputs), dict(od.attrs)))
    return main, {}


def case_h002_inplace_read(P):
    main, _, _ = _build_train(P)
    bd = main.desc.block(0)
    param = next(n for n, vd in bd.vars.items() if vd.is_parameter)
    bd.vars["__shadow__"] = P.desc.VarDesc("__shadow__", dtype="float32",
                                           shape=(13, 1))
    bd.ops.insert(0, P.desc.OpDesc("scale", {"X": [param]},
                                   {"Out": ["__shadow__"]}, {"scale": 2.0}))
    return main, {}


def case_h002_overwrite_read(P):
    main = P.fluid.Program()
    bd = main.desc.block(0)
    for n in ("c1", "c2", "v", "out", "out2"):
        bd.vars[n] = P.desc.VarDesc(n, dtype="float32", shape=(4,))
    for x, out in (("c1", "v"), ("v", "out"), ("c2", "v"), ("v", "out2")):
        bd.ops.append(P.desc.OpDesc("scale", {"X": [x]}, {"Out": [out]},
                                    {"scale": 1.0}))
    return main, dict(fetches=["out", "out2"])


def case_h003_forked(P):
    main, _, _ = _build_train(P)
    bd = main.desc.block(0)
    sgd = next(od for od in bd.ops if od.type == "sgd")
    bd.vars["__forked__"] = P.desc.VarDesc(
        "__forked__", dtype="float32",
        shape=bd.vars[sgd.input("Param")[0]].shape)
    sgd.outputs["ParamOut"] = ["__forked__"]
    return main, {}


def case_h003_abbreviated_slot(P):
    main = P.fluid.Program()
    bd = main.desc.block(0)
    for n, shape in (("p", (4,)), ("g", (4,)), ("lr", (1,)),
                     ("sq", (4,)), ("lin", (4,)), ("sq_fork", (4,))):
        bd.vars[n] = P.desc.VarDesc(n, dtype="float32", shape=shape,
                                    persistable=(n != "g"))
    bd.ops.append(P.desc.OpDesc(
        "ftrl",
        {"Param": ["p"], "Grad": ["g"], "LearningRate": ["lr"],
         "SquaredAccumulator": ["sq"], "LinearAccumulator": ["lin"]},
        {"ParamOut": ["p"], "SquaredAccumOut": ["sq_fork"],
         "LinearAccumOut": ["lin"]}, {}))
    return main, {}


def _adam_program(P):
    fluid = P.fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        loss = fluid.layers.mean(x=fluid.layers.fc(input=x, size=3))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main


def case_adam_beta_pow(P):
    return _adam_program(P), {}


def case_adam_beta_pow_suppressed(P):
    return _adam_program(P), dict(suppress=("H002@scale",))


def case_l001_plain(P):
    return _build_train(P)[0], {}


def case_l001_bucket_hints(P):
    return _build_train(P)[0], dict(bucket_hints={"batch_buckets": [8]})


def case_l004_amp_mix(P):
    main = P.fluid.Program()
    bd = main.desc.block(0)
    bd.vars["a"] = P.desc.VarDesc("a", dtype="bfloat16", shape=(4, 4))
    bd.vars["b"] = P.desc.VarDesc("b", dtype="float32", shape=(4, 4))
    bd.vars["c"] = P.desc.VarDesc("c", dtype="float32", shape=(4, 4))
    bd.ops.append(P.desc.OpDesc("elementwise_add", {"X": ["a"], "Y": ["b"]},
                                {"Out": ["c"]}, {}))
    return main, dict(level="structural")


def case_l004_persistable_bf16(P):
    main = P.fluid.Program()
    main.desc.block(0).vars["w"] = P.desc.VarDesc(
        "w", dtype="bfloat16", shape=(4,), persistable=True)
    return main, {}


def case_l005_unapplied_grads(P):
    fluid = P.fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        loss = fluid.layers.mean(x=fluid.layers.fc(input=x, size=3))
        fluid.append_backward(loss)
    return main, {}


def case_l005_debris(P):
    main = P.fluid.Program()
    main.desc.block(0).vars["v@GRAD"] = P.desc.VarDesc(
        "v@GRAD", dtype="float32", shape=(4,))
    return main, {}


def case_l002_segment_split(P):
    main = P.fluid.Program()
    bd = main.desc.block(0)
    for n in ("a", "b", "c"):
        bd.vars[n] = P.desc.VarDesc(n, dtype="float32", shape=(4,))
    bd.ops.append(P.desc.OpDesc("scale", {"X": ["a"]}, {"Out": ["b"]},
                                {"scale": 1.0}))
    bd.ops.append(P.desc.OpDesc("print", {"X": ["b"]}, {"Out": ["b"]},
                                {"message": "mid"}))
    bd.ops.append(P.desc.OpDesc("scale", {"X": ["b"]}, {"Out": ["c"]},
                                {"scale": 1.0}))
    return main, dict(level="structural")


def case_backward_output(P):
    fluid = P.fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        h = fluid.layers.fc(input=x, size=4, act="relu")
        loss = fluid.layers.mean(x=fluid.layers.fc(input=h, size=1))
        fluid.append_backward(loss)
    return main, {}


def case_transpiler_output(P):
    fluid = P.fluid
    if P is J:
        from paddle_tpu.distributed.transpiler import DistributeTranspiler
    else:
        from paddle_tpu_torch.distributed.transpiler import \
            DistributeTranspiler
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=pred, label=y))
        optimize_ops, params_grads = fluid.optimizer.SGD(
            learning_rate=0.01).minimize(loss)
        DistributeTranspiler().transpile(
            optimize_ops=optimize_ops, params_grads=params_grads,
            trainer_id=0, trainers=2,
            pservers="127.0.0.1:6174,127.0.0.1:6175")
    return main, {}


def case_lenet5(P):
    fluid = P.fluid
    if P is J:
        from paddle_tpu.models.image import lenet5
    else:
        from paddle_tpu_torch.models.image import lenet5
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 28, 28],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        probs = lenet5(img, class_dim=10)
        loss = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=probs, label=label))
        fluid.optimizer.MomentumOptimizer(learning_rate=0.01,
                                          momentum=0.9).minimize(loss)
    return main, dict(fetches=[loss.name])


def _build_while_program(P):
    """The JAX test's while program: a carried accumulator fed by a
    block-0 temp the body reads."""
    fluid = P.fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[1, 4], dtype="float32",
                              append_batch_size=False)
        bridge = fluid.layers.scale(x=x, scale=2.0)
        acc = fluid.layers.fill_constant(shape=[1, 4], dtype="float32",
                                         value=0.0)
        i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        limit = fluid.layers.fill_constant(shape=[1], dtype="int64",
                                           value=3)
        cond = fluid.layers.less_than(x=i, y=limit)
        w = fluid.layers.While(cond=cond, max_steps=8)
        with w.block():
            fluid.layers.sums(input=[acc, bridge], out=acc)
            fluid.layers.increment(x=i, value=1, in_place=True)
            fluid.layers.less_than(x=i, y=limit, cond=cond)
        loss = fluid.layers.mean(x=acc)
    return main, loss, {"bridge": bridge.name, "acc": acc.name}


def case_while_program(P):
    main, loss, _ = _build_while_program(P)
    return main, dict(fetches=[loss.name])


def case_suppress_by_code(P):
    main, _ = case_v001_unknown_op(P)
    return main, dict(level="structural", suppress=("V001",))


def case_suppress_by_op(P):
    main, _ = case_v001_unknown_op(P)
    return main, dict(level="structural",
                      suppress=("V001@definitely_not_an_op",))


def case_suppress_unrelated(P):
    main, _ = case_v001_unknown_op(P)
    return main, dict(level="structural", suppress=("V001@other",))


def case_suppress_by_var(P):
    main, _ = case_h002_inplace_read(P)
    param = next(n for n, vd in main.desc.block(0).vars.items()
                 if vd.is_parameter)
    return main, dict(suppress=("H002@var:" + param,))


def _small_transformer(P):
    if P is J:
        from paddle_tpu.models.transformer_program import \
            build_transformer_program
        main, startup, loss, _ = build_transformer_program(
            4, 32, 64, n_layer=2, n_head=4, d_model=32)
        with jfluid.program_guard(main, startup):
            jfluid.optimizer.AdamOptimizer(learning_rate=1e-3) \
                .minimize(loss)
        return main, loss.name
    from paddle_tpu_torch.models.transformer_program import \
        build_transformer_program
    main, startup, loss, _ = build_transformer_program(
        4, 32, 64, n_layer=2, n_head=4, d_model=32)
    tfluid.AdamOptimizer(1e-3).minimize(loss, main, startup)
    return main, loss


def case_transformer_adam(P):
    main, loss = _small_transformer(P)
    return main, dict(fetches=[loss])


def _small_resnet(P, train=True):
    fluid = P.fluid
    if P is J:
        from paddle_tpu.models.image import resnet50
    else:
        from paddle_tpu_torch.models.image import resnet50
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        image = fluid.layers.data(name="image", shape=[2, 3, 32, 32],
                                  dtype="float32", append_batch_size=False)
        logits = resnet50(image, class_dim=10)
        if not train:
            return main, startup, logits
        label = fluid.layers.data(name="label", shape=[2, 1],
                                  dtype="int64", append_batch_size=False)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.MomentumOptimizer(0.01, 0.9).minimize(loss)
    return main, startup, loss


def case_resnet50_momentum(P):
    main, _, loss = _small_resnet(P)
    return main, dict(fetches=[loss.name])


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


def _check(P, case):
    program, kw = CASES[case](P)
    return P.analysis.check_program(program, publish=False, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_check_program_equals_jax(case):
    """check_program's findings (the verifier, the dataflow pass and the
    lints) over the case's program, built by each package."""
    want, got = _check(J, case), _check(T, case)
    assert findings(got) == findings(want), (got.format(), want.format())


def test_the_cases_cover_every_code():
    """The cases above reach every code of the three layers (a
    regression in a pass that silenced a code would not show as an
    inequality if no case reached it)."""
    seen = set()
    for case in CASES:
        seen |= {d.code for d in _check(T, case).diagnostics}
    assert seen >= {"V001", "V002", "V003", "V004", "V005", "V006",
                    "V008", "D001", "D002", "H001", "H002", "H003",
                    "L001", "L002", "L003", "L004", "L005"}, sorted(seen)


def test_messages_of_the_jax_test_cases():
    """The JAX tests' assertions on severities and messages, on the
    port's findings."""
    rep = _check(T, "l001_plain")
    l001 = [d for d in rep.diagnostics if d.code == "L001"]
    assert l001 and all(d.severity == "info" for d in l001)
    assert any("without shape buckets" in d.message for d in l001)
    assert all("bucketing covers it" in d.message
               for d in _check(T, "l001_bucket_hints").diagnostics
               if d.code == "L001")
    assert [d for d in _check(T, "h001_write_write").errors
            if d.code == "H001"]
    rep = _check(T, "adam_beta_pow")
    assert rep.has("H002") and rep.ok()
    sup = _check(T, "adam_beta_pow_suppressed")
    assert not sup.has("H002") and sup.suppressed
    assert any("never applied" in d.message
               for d in _check(T, "l005_unapplied_grads").diagnostics
               if d.code == "L005")
    assert not _check(T, "clean_train").warnings
    assert not _check(T, "lenet5").warnings
    assert not _check(T, "transpiler_output").warnings


@pytest.mark.parametrize("fetch", [False, True])
def test_analyze_dataflow_and_lint_program_equal_jax(fetch):
    """The two layers called alone, on the small transformer."""
    (jm, jl), (tm, tl) = _small_transformer(J), _small_transformer(T)
    kw = (lambda loss: dict(fetches=[loss])) if fetch else (lambda _: {})
    assert findings(tanalysis.analyze_dataflow(tm, **kw(tl))) == \
        findings(janalysis.analyze_dataflow(jm, **kw(jl)))
    assert findings(tanalysis.lint_program(tm)) == \
        findings(janalysis.lint_program(jm))


def test_liveness_of_the_while_body_equals_jax():
    """The JAX test's liveness cases over the while body: live sets and
    reuse candidates equal the JAX Liveness's."""
    from paddle_tpu.analysis import dataflow as jdf
    from paddle_tpu_torch.analysis import dataflow as tdf

    out = []
    for P, df in ((J, jdf), (T, tdf)):
        main, _, names = _build_while_program(P)
        desc = main.desc
        sub_idx = next(i for i in range(len(desc.blocks))
                       if i > 0 and desc.block(i).ops)
        sub = desc.block(sub_idx)
        cross = df._block_sub_reads(desc, sub_idx)
        lv = df.Liveness(sub.ops, final_live=cross).analyze()
        released = {n for ns in lv.reuse_candidates().values() for n in ns}
        assert names["acc"] in lv.live_out[len(sub.ops) - 1]
        assert names["acc"] not in released
        assert names["bridge"] not in released
        out.append(([sorted(s) for s in lv.live_in],
                    [sorted(s) for s in lv.live_out], sorted(released),
                    lv.reachability()))
    assert out[0] == out[1]


def test_liveness_timeline_equals_jax():
    """liveness_timeline's series, peak and blamed buffers over the
    small transformer, by one byte policy."""
    from paddle_tpu.analysis import dataflow as jdf
    from paddle_tpu_torch.analysis import dataflow as tdf

    out = []
    for P, df in ((J, jdf), (T, tdf)):
        main, loss = _small_transformer(P)
        bd = main.desc.block(0) if hasattr(main, "desc") else main.block(0)

        def nbytes(n, bd=bd):
            vd = bd.vars.get(n)
            if vd is None or vd.persistable or vd.shape is None:
                return 0
            return 4 * int(np.prod([max(int(s), 1) for s in vd.shape]))

        out.append(df.liveness_timeline(bd.ops, nbytes, final_live=[loss],
                                        top_n=5))
    assert out[0] == out[1]


# -- the roofline --------------------------------------------------------------

def _roof_programs(P):
    main, _, _ = _build_train(P)
    tm, _ = _small_transformer(P)
    rn, _, _ = _small_resnet(P)
    return {"fit_a_line": main, "transformer": tm, "resnet50": rn}


@pytest.mark.parametrize("program", ["fit_a_line", "transformer",
                                     "resnet50"])
@pytest.mark.parametrize("tiling", [False, True])
@pytest.mark.parametrize("bf16_act", [False, True])
def test_roofline_report_equals_jax(program, tiling, bf16_act):
    """roofline_report at the same explicit figures (the card's f32
    rate and memory rate): every per-type row and both floors equal."""
    kw = dict(peak_tflops=67.0, hbm_gbps=3350.0, bf16_act=bf16_act,
              tpu_tiling=tiling)
    want = jroof.roofline_report(_roof_programs(J)[program], **kw)
    got = troof.roofline_report(_roof_programs(T)[program], **kw)
    assert got == want
    assert troof.format_report(got) == jroof.format_report(want)


def test_roofline_defaults_are_the_cards():
    from paddle_tpu_torch.utils import device_peaks

    assert troof.DEFAULT_PEAK_TFLOPS == 989.0
    assert troof.DEFAULT_HBM_GBPS == 3350.0
    assert device_peaks.F32_CORE_FLOPS == 67e12
    rep = troof.roofline_report(_build_train(T)[0])
    assert rep["peak_tflops"] == 989.0 and rep["hbm_gbps"] == 3350.0


def test_program_costs_rows_equal_jax():
    (jm, _), (tm, _) = _small_transformer(J), _small_transformer(T)
    assert troof.program_costs(tm, tiled=True) == \
        jroof.program_costs(jm, tiled=True)


# -- the registry facts the analysis reads --------------------------------------

_JAX_TYPES = sorted(jreg._OP_REGISTRY)
# the type the port does not register: recompute_barrier (ROADMAP A5)
# none since the recompute slice registered recompute_barrier
_WAITING = set()


def test_the_port_registers_all_but_two_jax_types():
    """Named for an earlier count: the port now registers every JAX
    type."""
    assert set(_JAX_TYPES) - set(treg.registered_ops()) == _WAITING
    assert len(treg.registered_ops()) == 213
    assert set(treg.registered_ops()) <= set(_JAX_TYPES)


@pytest.mark.parametrize("op_type", [t for t in _JAX_TYPES
                                     if t not in _WAITING])
def test_registry_facts_equal_jax(op_type):
    """jittable, uses_rng and in_place_outputs of each type, which dce,
    cse, the hazard checks and lint L002 read."""
    j, t = jreg.get_op_info(op_type), treg.get_op_info(op_type)
    assert (t.jittable, t.uses_rng, tuple(t.in_place_outputs)) == \
        (j.jittable, j.uses_rng, tuple(j.in_place_outputs))


# -- the wiring ---------------------------------------------------------------

def _feed():
    return {"x": np.zeros((2, 13), np.float32),
            "y": np.zeros((2, 1), np.float32)}


def test_executor_verify_gate_catches_before_running():
    main, startup, loss = _build_train(T)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    prev = tflags.get_flag("verify_program")
    tflags.set_flag("verify_program", True)
    try:
        exe.run(startup, scope=scope)
        out, = exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
        assert np.isfinite(out).all()
        bad = main.clone()
        bad.desc.block(0).ops[2].type = "definitely_not_an_op"
        with pytest.raises(tanalysis.ProgramVerificationError) as ei:
            exe.run(bad, feed=_feed(), fetch_list=[loss], scope=scope)
        assert "op 2" in str(ei.value)
        first = ei.value.report.errors[0]
        assert first.op_index == 2 and first.block_idx == 0
        # a clean verdict is kept: the same version is not checked again
        n = len(exe._verified)
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
        assert len(exe._verified) == n
    finally:
        tflags.set_flag("verify_program", prev)


def _broken_export(tmp_path, P):
    main, startup, loss = _build_train(P)
    if P is J:
        from paddle_tpu.core.scope import Scope
        from paddle_tpu.fluid import io as fluid_io

        scope = Scope()
        exe = jfluid.Executor(jfluid.CPUPlace())
        with jfluid.scope_guard(scope):
            exe.run(startup)
            fluid_io.save_inference_model(str(tmp_path), ["x", "y"],
                                          [loss], exe, main_program=main)
    else:
        from paddle_tpu_torch.fluid import io as fluid_io

        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        with tfluid.scope_guard(scope):
            fluid_io.save_inference_model(str(tmp_path), ["x", "y"],
                                          [loss], exe, main_program=main)
    return exe, fluid_io


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_load_inference_model_verifies_the_export(tmp_path, writer):
    """A loaded export is verified (its structure) before anything else:
    a malformed op raises ProgramVerificationError in both packages,
    with the same codes, whichever package wrote it."""
    from paddle_tpu.fluid import io as jio
    from paddle_tpu_torch.fluid import io as tio

    _broken_export(tmp_path, J if writer == "jax" else T)
    # the clean export loads
    prog, feeds, fetches = tio.load_inference_model(
        str(tmp_path), tfluid.Executor(tfluid.CPUPlace()))
    assert feeds == ["x", "y"]
    path = os.path.join(str(tmp_path), "__model__")
    with open(path) as f:
        meta = json.load(f)
    meta["program"]["blocks"][0]["ops"][0]["type"] = "nope_op"
    with open(path, "w") as f:
        json.dump(meta, f)
    errors = []
    with pytest.raises(tanalysis.ProgramVerificationError) as ei:
        tio.load_inference_model(str(tmp_path),
                                 tfluid.Executor(tfluid.CPUPlace()))
    errors.append(sorted((d.code, d.op_index) for d in
                         ei.value.report.errors))
    with pytest.raises(janalysis.ProgramVerificationError) as ej:
        from paddle_tpu.core.scope import Scope

        with jfluid.scope_guard(Scope()):
            jio.load_inference_model(str(tmp_path),
                                     jfluid.Executor(jfluid.CPUPlace()))
    errors.append(sorted((d.code, d.op_index) for d in
                         ej.value.report.errors))
    assert errors[0] == errors[1] and ("V001", 0) in errors[0]


def test_serving_warmup_checks_the_program():
    from paddle_tpu_torch.fluid import io as tio
    from paddle_tpu_torch.obs import registry as obs_registry
    from paddle_tpu_torch.serving import EngineConfig, InferenceEngine

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        img = tfluid.layers.data(name="img", shape=[8], dtype="float32")
        probs = tfluid.layers.fc(input=img, size=3, act="softmax")
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    pruned = tio.prune_program(main, [probs])
    kw = dict(scope=scope, place=tfluid.CPUPlace())
    engine = InferenceEngine(pruned, ["img"], [probs],
                             config=EngineConfig(batch_buckets=[2]), **kw)
    assert engine.warmup() == 1
    assert engine.last_check["report"].ok()
    names = {s["name"] for s in
             obs_registry.get_registry().to_dict()["metrics"]}
    assert "analysis_runs_total" in names
    bad = pruned.clone()
    bad.desc.block(0).ops[0].type = "definitely_not_an_op"
    for buckets in ([2], None):
        engine2 = InferenceEngine(bad, ["img"], [probs],
                                  config=EngineConfig(batch_buckets=buckets),
                                  **kw)
        with pytest.raises(tanalysis.ProgramVerificationError):
            engine2.warmup()


def test_report_counters_published():
    from paddle_tpu_torch.obs import registry as obs_registry

    main, _, _ = _build_train(T)
    main.desc.block(0).ops[1].type = "definitely_not_an_op"
    reg = obs_registry.get_registry()
    runs = reg.counter("analysis_runs_total", "program analysis passes "
                       "executed", labelnames=("origin",))
    before = runs.labels(origin="torch_test").value
    tanalysis.check_program(main, origin="torch_test")
    fam = reg.counter("analysis_diagnostics_total",
                      "static-analysis findings by diagnostic code",
                      labelnames=("code", "severity"))
    assert fam.labels(code="V001", severity="error").value >= 1
    assert runs.labels(origin="torch_test").value == before + 1
