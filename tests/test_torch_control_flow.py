"""Sub-blocks and the `recurrent` engine in the port against the JAX
package, on the CPU, on inputs made from a numpy seed.

- Framework: `create_block`/`rollback`/`block_guard`, lookups through
  the parent chain, shape inference of a step-block op reading a
  block-0 var, a program with a sub-block round-tripping through
  `clone`, `to_dict` and `Program.from_desc`, and `run_block`'s
  KeyError naming a name the sub-block cannot see.
- `recurrent` with and without a mask, two memories and two closure
  weights: StepOutputs, FinalMems and the generic grad of every input
  against `jax.vjp` through the JAX op (`recurrent_grad` on both sides),
  f32 at atol 1e-6 times the larger of 1 and the largest magnitude (the
  same f32 arithmetic summed in other orders over 5 steps).  The mask
  is held constant: the port gives it no grad, JAX a zero one.
- `sequence_to_dense` and `dense_to_sequence` over ragged input whose
  flat rows pad past `nvalid` with 1e4 (a leaked row would show), the
  round trip, and their grads; `transpose` and
  `fill_constant_batch_size_like` (dense and ragged reference), at the
  same atol.
- A StaticRNN over dense input and a DynamicRNN over ragged input built
  by both packages: descs equal through `to_dict()`, and from one
  initial state the forward, the loss and the parameters after one SGD
  step agree at atol 1e-6 (scaled as above).
- The three prune tests of `tests/test_inference_prune.py`, mirrored:
  the export of a DynamicRNN classifier keeps its sub-block and reloads
  into a fresh scope with the outputs of the unpruned run, a target
  inside the step block raises naming block 0, a fed target raises
  "produced by no op".
- The 10 comparison and logical ops on broadcast f32, int32 and bool
  operands: the bool results equal exactly.
- `TensorArray` against the JAX class (writes past the capacity and
  from the end, the length, reads, `stack`), and
  tests/test_op_coverage.py's tensor-array program (less get_places)
  built by both packages: descs equal, its fetches exactly equal.
- `while` built by both packages' `While` (descs equal): unbounded,
  bounded past the loop's end and short of it, at the f32 tolerance
  above (integer carries and the array's length exactly); the bounded
  loop's generic grad (a TensorArray carry through its buffer) against
  JAX's while_grad and jax.vjp of the JAX kernel; an unwritten array
  carried in raises the JAX side's message; tests/test_compile_passes.py
  :143's unbounded loop through both executors.
- `conditional_block` built by `ConditionalBlock` (descs equal), the
  branch taken and not, forward and generic grad; `cond` picking rows.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import paddle_tpu.ops  # noqa: F401 — registers the JAX kernels
import paddle_tpu.fluid as jfluid
from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.ragged import RaggedTensor as JRagged
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.fluid import executor as jexec
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.desc import BlockRef, OpDesc, ProgramDesc
from paddle_tpu_torch.core.ragged import RaggedTensor
from paddle_tpu_torch.core.types import tensor_from_numpy
from paddle_tpu_torch.fluid import executor as texec
from paddle_tpu_torch.fluid import io as tio

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
EMPTY = "@EMPTY@"
ATOL = 1e-6
PAD_FILL = 1e4


def _assert_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, atol=ATOL * scale, rtol=0,
                               err_msg=what)


def _host(v):
    if isinstance(v, (JRagged, RaggedTensor)):
        return np.asarray(v.values), v.lod()
    if isinstance(v, torch.Tensor):
        return v.detach().numpy(), None
    return np.asarray(v), None


def _jax_program(desc_dict):
    return jfluid.Program.parse_from_string(json.dumps(desc_dict))


# -- the framework's sub-blocks ----------------------------------------------

def test_create_block_rollback_and_parent_lookups():
    prog = tfluid.Program()
    gb = prog.global_block()
    w = gb.create_var(name="w", shape=[4, 3], dtype="float32")
    with prog.block_guard() as sub:
        assert prog.current_block() is sub and sub.idx == 1
        assert sub.parent_idx == 0 and sub.parent_block is gb
        x = sub.create_var(name="x", shape=[-1, 4], dtype="float32")
        y = sub.create_var(name="y", dtype="float32")
        sub.append_op(type="mul", inputs={"X": [x], "Y": [w]},
                      outputs={"Out": [y]},
                      attrs={"x_num_col_dims": 1, "y_num_col_dims": 1})
        # the step-block op read block 0's `w` for its shape
        assert y.shape == (-1, 3)
        assert sub.has_var_recursive("w") and not sub.has_var("w")
        assert sub.var_recursive("w").name == "w"
        with pytest.raises(ValueError):
            sub.var("w")
        with pytest.raises(ValueError):
            sub.var_recursive("nope")
        inner = prog.create_block()
        assert inner.parent_idx == 1 and prog.current_block_idx == 2
        prog.rollback()
        assert prog.current_block() is sub
    assert prog.current_block() is gb
    assert not gb.has_var_recursive("x")
    assert [b.parent_idx for b in prog.desc.blocks] == [-1, 0, 1]


def test_sub_blocks_round_trip():
    prog, _, _ = _static_rnn_program(tfluid)
    d = prog.desc.to_dict()
    assert len(d["blocks"]) == 2 and d["blocks"][1]["parent_idx"] == 0
    rec = [op for op in prog.desc.block(0).ops if op.type == "recurrent"]
    assert rec[0].attrs["sub_block"] == BlockRef(1)
    for p in (prog.clone(), prog.clone(for_test=True),
              tfluid.Program.from_desc(ProgramDesc.from_dict(d)),
              tfluid.Program.from_desc(ProgramDesc.parse_from_string(
                  prog.desc.serialize_to_string()))):
        assert p.desc.to_dict() == d
        assert len(p.blocks) == 2 and p.block(1).parent_block is p.block(0)
        assert p.current_block_idx == 0
    # an appended block survives the JSON both packages share
    assert _jax_program(d).desc.to_dict() == d


def test_run_block_names_a_missing_var():
    prog = tfluid.Program()
    with prog.block_guard() as sub:
        a = sub.create_var(name="a", shape=[2], dtype="float32")
        b = sub.create_var(name="b", dtype="float32")
        sub.append_op(type="tanh", inputs={"X": [a]}, outputs={"Out": [b]})
    ctx = texec.ExecContext(prog.desc, 0, {"zzz": torch.ones(2)},
                            device=torch.device("cpu"))
    env = ctx.run_block(1, {"a": torch.zeros(2)})
    assert torch.equal(env["b"], torch.zeros(2))
    with pytest.raises(KeyError, match="'a'"):
        # the caller's env is not the sub-block's
        ctx.run_block(1, {})


# -- the recurrent op ---------------------------------------------------------

T, B, D, H = 5, 3, 4, 6


def _recurrent_program(has_mask):
    """Block 1: h = tanh(x_t W + h_pre U), c = c_pre + h; outputs h, c.
    Returns (ProgramDesc dict, op desc dict)."""
    prog = tfluid.Program()
    gb = prog.global_block()
    for n, shape in (("x", [T, B, D]), ("h0", [B, H]), ("c0", [B, H]),
                     ("w", [D, H]), ("u", [H, H]), ("mask", [T, B])):
        gb.create_var(name=n, shape=shape, dtype="float32")
    with prog.block_guard() as sub:
        for n, shape in (("x_t", [B, D]), ("h_pre", [B, H]),
                         ("c_pre", [B, H])):
            sub.create_var(name=n, shape=shape, dtype="float32")
        for n in ("xw", "hu", "s", "h", "c"):
            sub.create_var(name=n, dtype="float32")
        mul = {"x_num_col_dims": 1, "y_num_col_dims": 1}
        sub.append_op(type="mul", inputs={"X": ["x_t"], "Y": ["w"]},
                      outputs={"Out": ["xw"]}, attrs=mul)
        sub.append_op(type="mul", inputs={"X": ["h_pre"], "Y": ["u"]},
                      outputs={"Out": ["hu"]}, attrs=mul)
        sub.append_op(type="sum", inputs={"X": ["xw", "hu"]},
                      outputs={"Out": ["s"]})
        sub.append_op(type="tanh", inputs={"X": ["s"]},
                      outputs={"Out": ["h"]})
        sub.append_op(type="elementwise_add",
                      inputs={"X": ["c_pre"], "Y": ["h"]},
                      outputs={"Out": ["c"]}, attrs={"axis": -1})
    inputs = {"StepInputs": ["x"], "Boot": ["h0", "c0"],
              "Closure": ["w", "u"]}
    if has_mask:
        inputs["Mask"] = ["mask"]
    op = OpDesc("recurrent", inputs,
                {"StepOutputs": ["hs", "cs"], "FinalMems": ["hT", "cT"]},
                {"sub_block": BlockRef(1), "step_input_names": ["x_t"],
                 "closure_names": ["w", "u"],
                 "mem_pre_names": ["h_pre", "c_pre"],
                 "mem_post_names": ["h", "c"],
                 "step_output_names": ["h", "c"], "has_mask": has_mask})
    return prog.desc.to_dict(), op


def _recurrent_values(seed=0):
    rs = np.random.RandomState(seed)
    lengths = np.array([5, 2, 0])
    return {"x": rs.randn(T, B, D).astype(np.float32),
            "h0": rs.randn(B, H).astype(np.float32),
            "c0": rs.randn(B, H).astype(np.float32),
            "w": (rs.randn(D, H) * 0.5).astype(np.float32),
            "u": (rs.randn(H, H) * 0.5).astype(np.float32),
            "mask": (np.arange(T)[:, None] < lengths[None, :])
            .astype(np.float32)}


def _run_both(prog_dict, op, values):
    """Run `op` (a port OpDesc) in block 0 of both programs; returns the
    (jax env, port env)."""
    jprog = _jax_program(prog_dict)
    jctx = jexec.ExecContext(None, jprog, 0,
                             {n: jnp.asarray(v) for n, v in values.items()})
    jexec.apply_op(jctx, JOpDesc.from_dict(op.to_dict()))
    tctx = texec.ExecContext(ProgramDesc.from_dict(prog_dict), 0,
                             {n: tensor_from_numpy(v, "cpu")
                              for n, v in values.items()},
                             device=torch.device("cpu"))
    texec.apply_op(tctx, op)
    return jctx.env, tctx.env


def _grad_op(op, og_names):
    ins = dict(op.inputs)
    for slot, names in op.outputs.items():
        ins["O@" + slot] = list(names)
        ins["OG@" + slot] = [n + "@GRAD" if n in og_names else EMPTY
                             for n in names]
    outs = {slot + "@GRAD": [n + "@GRAD" for n in names]
            for slot, names in op.inputs.items()}
    return OpDesc("recurrent_grad", ins, outs, dict(op.attrs))


@pytest.mark.parametrize("has_mask", [False, True])
def test_recurrent_matches_jax(has_mask):
    prog_dict, op = _recurrent_program(has_mask)
    values = _recurrent_values()
    jenv, tenv = _run_both(prog_dict, op, values)
    for n in ("hs", "cs", "hT", "cT"):
        _assert_close(tenv[n], jenv[n], n)
    if has_mask:
        # the empty sequence: outputs zero, memories at their boot
        assert not tenv["hs"][:, 2].any()
        torch.testing.assert_close(tenv["hT"][2], torch.from_numpy(
            values["h0"][2]), rtol=0, atol=0)
        # the length-2 sequence's memories froze after its 2nd step
        torch.testing.assert_close(tenv["cT"][1], tenv["cs"][1, 1])

    rs = np.random.RandomState(1)
    og = {"hs@GRAD": rs.randn(T, B, H).astype(np.float32),
          "cs@GRAD": rs.randn(T, B, H).astype(np.float32),
          "hT@GRAD": rs.randn(B, H).astype(np.float32)}
    grad = _grad_op(op, {k[:-len("@GRAD")] for k in og})
    fwd_outs = {n: np.asarray(jenv[n]) for n in ("hs", "cs", "hT", "cT")}
    jenv, tenv = _run_both(prog_dict, grad, dict(values, **og, **fwd_outs))
    for n in ("x", "h0", "c0", "w", "u"):
        _assert_close(tenv[n + "@GRAD"], jenv[n + "@GRAD"], n + "@GRAD")
    if has_mask:
        # the mask reaches the outputs only through a cast to bool
        _assert_close(tenv["mask@GRAD"], jenv["mask@GRAD"], "mask@GRAD")
        assert not tenv["mask@GRAD"].any()


def test_recurrent_grad_is_jax_vjp():
    """JAX's recurrent_grad is jax.vjp of its forward: held here against
    jax.vjp called directly, so the port's match above is a match with
    the vjp."""
    prog_dict, op = _recurrent_program(True)
    values = _recurrent_values(seed=2)
    jprog = _jax_program(prog_dict)
    info = jreg.get_op_info("recurrent")
    diff = ("x", "h0", "c0", "w", "u")

    def f(x, h0, c0, w, u):
        ctx = jexec.ExecContext(None, jprog, 0, {})
        ins = {"StepInputs": [x], "Boot": [h0, c0], "Closure": [w, u],
               "Mask": [jnp.asarray(values["mask"])]}
        out = info.kernel(ctx, ins, dict(op.attrs))
        return out["StepOutputs"][0].sum() + out["FinalMems"][1].sum()

    want = jax.grad(f, argnums=tuple(range(5)))(
        *[jnp.asarray(values[n]) for n in diff])
    og = {"hs@GRAD": np.zeros((T, B, H), np.float32),
          "cs@GRAD": np.zeros((T, B, H), np.float32),
          "hT@GRAD": np.zeros((B, H), np.float32),
          "cT@GRAD": np.zeros((B, H), np.float32)}
    og["hs@GRAD"][:] = 1.0
    og["cT@GRAD"][:] = 1.0
    og.update({n: np.zeros_like(og[n + "@GRAD"])
               for n in ("hs", "cs", "hT", "cT")})   # the O@ slots
    _, tenv = _run_both(prog_dict, _grad_op(op, {"hs", "hT", "cs", "cT"}),
                        dict(values, **og))
    for n, w in zip(diff, want):
        _assert_close(tenv[n + "@GRAD"], w, n)


# -- sequence_to_dense / dense_to_sequence, transpose, fill -----------------

LENGTHS = [3, 0, 5, 2]


def _ragged_values(seed, width=4, pad=3):
    rs = np.random.RandomState(seed)
    total = sum(LENGTHS)
    vals = rs.randn(total + pad, width).astype(np.float32)
    vals[total:] = PAD_FILL
    splits = np.cumsum([0] + LENGTHS).astype(np.int32)
    return vals, splits, total


def _both_ragged(vals, splits, nvalid, max_seqlen=8):
    return (JRagged(jnp.asarray(vals), [splits], nvalid=nvalid,
                    max_seqlen=max_seqlen),
            RaggedTensor(torch.from_numpy(vals), [torch.from_numpy(splits)],
                         nvalid=nvalid, max_seqlen=max_seqlen))


def _apply_both(op_type, ins, outs, attrs=None):
    """ins: {slot: [(name, (jax value, port value))]}."""
    names = {s: [n for n, _ in v] for s, v in ins.items()}
    jctx = jexec.ExecContext(None, None, 0,
                             {n: p[0] for v in ins.values() for n, p in v})
    jexec.apply_op(jctx, JOpDesc(op_type, names, outs, attrs or {}))
    tctx = texec.ExecContext(None, 0,
                             {n: p[1] for v in ins.values() for n, p in v},
                             device=torch.device("cpu"))
    texec.apply_op(tctx, OpDesc(op_type, names, outs, attrs or {}))
    return jctx.env, tctx.env


def test_sequence_to_dense_and_back_match_jax():
    vals, splits, nvalid = _ragged_values(3)
    x = _both_ragged(vals, splits, nvalid)
    jenv, tenv = _apply_both("sequence_to_dense", {"X": [("x", x)]},
                             {"Out": ["p"], "Mask": ["m"]})
    for n in ("p", "m"):
        _assert_close(tenv[n], jenv[n], n)
    assert tenv["m"].dtype == torch.float32
    assert tuple(tenv["p"].shape) == (4, 8, 4)
    assert not (tenv["p"] == PAD_FILL).any()       # padding rows stay out
    assert tenv["m"].sum(1).tolist() == LENGTHS

    p = (jenv["p"], tenv["p"])
    jenv, tenv = _apply_both("dense_to_sequence",
                             {"X": [("p", p)], "Like": [("x", x)]},
                             {"Out": ["y"]})
    (jv, jlod), (tv, tlod) = _host(jenv["y"]), _host(tenv["y"])
    assert tlod == jlod == [list(splits)]
    _assert_close(tv, jv, "y")
    # the round trip gives the valid rows back, zeros past nvalid
    np.testing.assert_array_equal(tv[:nvalid], vals[:nvalid])
    assert not tv[nvalid:].any()

    rs = np.random.RandomState(4)
    og_d = rs.randn(4, 8, 4).astype(np.float32)
    ins = {"X": [("x", x)], "O@Out": [("p", p)], "O@Mask": [("m", p)],
           "OG@Out": [("p@GRAD", (jnp.asarray(og_d),
                                  torch.from_numpy(og_d)))],
           "OG@Mask": [(EMPTY, (None, None))]}
    ins = {s: [(n, v) for n, v in vs if n != EMPTY] for s, vs in ins.items()}
    jenv, tenv = _apply_both("sequence_to_dense_grad", ins,
                             {"X@GRAD": ["x@GRAD"]})
    (jv, jlod), (tv, tlod) = _host(jenv["x@GRAD"]), _host(tenv["x@GRAD"])
    assert tlod == jlod
    _assert_close(tv, jv, "x@GRAD")

    og_r = _both_ragged(rs.randn(*vals.shape).astype(np.float32), splits,
                        nvalid)
    ins = {"X": [("p", p)], "Like": [("x", x)], "O@Out": [("y", og_r)],
           "OG@Out": [("y@GRAD", og_r)]}
    jenv, tenv = _apply_both("dense_to_sequence_grad", ins,
                             {"X@GRAD": ["p@GRAD"], "Like@GRAD": ["x@GRAD"]})
    _assert_close(tenv["p@GRAD"], jenv["p@GRAD"], "p@GRAD")
    _assert_close(_host(tenv["x@GRAD"])[0], _host(jenv["x@GRAD"])[0],
                  "Like@GRAD")


@pytest.mark.parametrize("axis", [[1, 0, 2], [2, 0, 1], [1, 0]])
def test_transpose_matches_jax(axis):
    rs = np.random.RandomState(5)
    x = rs.randn(*[3, 4, 5][:len(axis)]).astype(np.float32)
    jenv, tenv = _apply_both("transpose", {"X": [("x", (jnp.asarray(x),
                                                       torch.from_numpy(x)))]},
                             {"Out": ["o"]}, {"axis": axis})
    _assert_close(tenv["o"], jenv["o"], "o")
    og = rs.randn(*np.transpose(x, axis).shape).astype(np.float32)
    ins = {"X": [("x", (jnp.asarray(x), torch.from_numpy(x)))],
           "OG@Out": [("o@GRAD", (jnp.asarray(og), torch.from_numpy(og)))]}
    jenv, tenv = _apply_both("transpose_grad", ins, {"X@GRAD": ["x@GRAD"]},
                             {"axis": axis})
    _assert_close(tenv["x@GRAD"], jenv["x@GRAD"], "x@GRAD")


@pytest.mark.parametrize("ragged", [False, True])
def test_fill_constant_batch_size_like_matches_jax(ragged):
    if ragged:
        vals, splits, nvalid = _ragged_values(6)
        ref = _both_ragged(vals, splits, nvalid)
        in_idx = 0
    else:
        r = np.zeros((2, 7, 3), np.float32)
        ref = (jnp.asarray(r), torch.from_numpy(r))
        in_idx = 1
    attrs = {"shape": [1, 5, 2], "dtype": "float32", "value": 0.25,
             "input_dim_idx": in_idx, "output_dim_idx": 1}
    jenv, tenv = _apply_both("fill_constant_batch_size_like",
                             {"Input": [("r", ref)]}, {"Out": ["o"]}, attrs)
    _assert_close(tenv["o"], jenv["o"], "o")
    assert tuple(tenv["o"].shape) == ((1, 13, 2) if ragged else (1, 7, 2))


# -- StaticRNN and DynamicRNN built by both packages -------------------------

def _static_rnn_program(fluid):
    """A StaticRNN over dense [4, 5, 3] input with a memory from
    `batch_ref`; (main, startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4, 5, 3], dtype="float32",
                              append_batch_size=False)
        rnn = fluid.layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            mem = rnn.memory(shape=[6], batch_ref=xt, value=0.5)
            h = fluid.layers.fc(input=[xt, mem], size=6, act="tanh")
            rnn.update_memory(mem, h)
            rnn.step_output(h)
        out = rnn()
        loss = fluid.layers.mean(x=out)
        fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return main, startup, loss


def _dynamic_rnn_program(fluid):
    """A DynamicRNN over ragged rows of 3 with an fc-booted memory and
    two step outputs; (main, startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32",
                              lod_level=1)
        boot = fluid.layers.fc(
            input=fluid.layers.sequence_pool(input=x, pool_type="sum"),
            size=6, act="tanh")
        rnn = fluid.layers.DynamicRNN()
        with rnn.block():
            xt = rnn.step_input(x)
            mem = rnn.memory(init=boot)
            h = fluid.layers.fc(input=[xt, mem], size=6, act="tanh")
            p = fluid.layers.fc(input=h, size=4, act="sigmoid")
            rnn.update_memory(mem, h)
            rnn.output(h, p)
        hs, ps = rnn()
        last = fluid.layers.sequence_last_step(input=hs)
        loss = fluid.layers.mean(x=fluid.layers.elementwise_add(
            fluid.layers.mean(x=last), fluid.layers.mean(x=ps)))
        fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return main, startup, loss


RNN_CASES = {"static": _static_rnn_program, "dynamic": _dynamic_rnn_program}


def _rnn_feed(case, ragged_cls, seed=7):
    rs = np.random.RandomState(seed)
    if case == "static":
        return {"x": rs.randn(4, 5, 3).astype(np.float32)}
    seqs = [rs.randn(n, 3).astype(np.float32) for n in (4, 1, 6, 2)]
    return {"x": ragged_cls.from_sequences(seqs, bucket=16)}


@pytest.mark.parametrize("case", sorted(RNN_CASES))
def test_rnn_layers_match_jax(case):
    jmain, jstartup, jloss = RNN_CASES[case](jfluid)
    tmain, tstartup, tloss = RNN_CASES[case](tfluid)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    assert tstartup.desc.to_dict() == jstartup.desc.to_dict()
    assert len(tmain.desc.blocks) == 2
    types = [op.type for op in tmain.desc.block(0).ops]
    assert "recurrent" in types and "recurrent_grad" in types

    persist = [n for n, v in jmain.desc.block(0).vars.items()
               if v.persistable]
    params = [p.name for p in tmain.global_block().all_parameters()]
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    with jfluid.scope_guard(scope):
        exe.run(jstartup)
        init = {n: np.array(scope.get(n)) for n in persist}
        jl, = exe.run(jmain, feed=_rnn_feed(case, JRagged),
                      fetch_list=[jloss])
        jfinal = {n: np.array(scope.get(n)) for n in persist}
    texe, tscope = tfluid.Executor(CPU), tfluid.Scope()
    tio.params_from_numpy(tscope, init, "cpu")
    tl, = texe.run(tmain, feed=_rnn_feed(case, RaggedTensor),
                   fetch_list=[tloss], scope=tscope)
    _assert_close(tl, jl, "loss")
    for n in params:
        assert not np.array_equal(jfinal[n], init[n]), n
        _assert_close(tscope.get(n).numpy(), jfinal[n], n)


# -- pruning across sub-blocks (tests/test_inference_prune.py, mirrored) -----

def _build_rnn_classifier():
    x = tfluid.layers.data(name="x", shape=[4], dtype="float32",
                           lod_level=1)
    drnn = tfluid.layers.DynamicRNN()
    with drnn.block():
        step = drnn.step_input(x)
        mem = drnn.memory(shape=[6], batch_ref=step, value=0.0)
        h = tfluid.layers.fc(input=[step, mem], size=6, act="tanh")
        drnn.update_memory(mem, h)
        drnn.output(h)
    seq = drnn()
    last = tfluid.layers.sequence_last_step(input=seq)
    logits = tfluid.layers.fc(input=last, size=3, act="softmax")
    label = tfluid.layers.data(name="y", shape=[1], dtype="int64")
    loss = tfluid.layers.mean(
        x=tfluid.layers.cross_entropy(input=logits, label=label))
    tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return x, logits, loss


def _prune_feed(x):
    rs = np.random.RandomState(0)
    seqs = [rs.rand(3, 4).tolist(), rs.rand(2, 4).tolist()]
    return tfluid.DataFeeder(feed_list=[x], place=CPU).feed(
        [(s,) for s in seqs])


@pytest.fixture
def fresh_programs():
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        yield


def test_prune_keeps_subblock_graph(tmp_path, fresh_programs):
    x, logits, loss = _build_rnn_classifier()
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(tfluid.default_startup_program(), scope=scope)
    feeds = _prune_feed(x)
    # saved before the reference run, which applies the SGD update
    with tfluid.scope_guard(scope):
        tio.save_inference_model(str(tmp_path), ["x"], [logits], exe)
    want, = exe.run(tfluid.default_main_program(),
                    feed=dict(feeds, y=np.zeros((2, 1), np.int64)),
                    fetch_list=[logits], scope=scope)

    pruned = tio.prune_program(tfluid.default_main_program(), [logits])
    types = [op.type for op in pruned.desc.block(0).ops]
    assert "recurrent" in types, types
    assert not any("grad" in t or t == "sgd" for t in types), types
    assert len(pruned.desc.blocks) == 2

    fresh = tfluid.Scope()
    with tfluid.scope_guard(fresh):
        prog, feed_names, fetch_vars = tio.load_inference_model(
            str(tmp_path), exe)
    assert len(prog.blocks) == 2 and feed_names == ["x"]
    got, = exe.run(prog, feed=feeds, fetch_list=fetch_vars, scope=fresh)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_prune_rejects_subblock_target(fresh_programs):
    _build_rnn_classifier()
    prog = tfluid.default_main_program()
    sub_names = set(prog.desc.block(1).vars) - set(prog.desc.block(0).vars)
    inner = sorted(sub_names)[0]
    with pytest.raises(ValueError, match="block-0"):
        tio.prune_program(prog, [inner])


def test_prune_rejects_feed_target(fresh_programs):
    x, _, _ = _build_rnn_classifier()
    with pytest.raises(ValueError, match="produced by no op"):
        tio.prune_program(tfluid.default_main_program(), [x])


# -- comparison and logical ops -----------------------------------------------

COMPARE_OPS = ["less_than", "less_equal", "greater_than", "greater_equal",
               "equal", "not_equal"]
LOGICAL_OPS = ["logical_and", "logical_or", "logical_xor"]


def _both(v):
    return (jnp.asarray(v), tensor_from_numpy(np.asarray(v), "cpu"))


@pytest.mark.parametrize("op", COMPARE_OPS + LOGICAL_OPS + ["logical_not"])
def test_compare_and_logical_ops_match_jax(op):
    """Broadcast operands, f32 and int32 (ties included); bool operands
    for the logical ops; the bool results equal exactly."""
    rs = np.random.RandomState(0)
    if op.startswith("logical"):
        cases = [(rs.rand(3, 4) > 0.5, rs.rand(3, 4) > 0.5),
                 (rs.rand(3, 4) > 0.5, np.array([True, False, True, True]))]
    else:
        cases = [(rs.randint(-2, 3, (3, 4)).astype(np.float32),
                  rs.randint(-2, 3, (3, 4)).astype(np.float32)),
                 (rs.randint(-2, 3, (3, 4)).astype(np.int32),
                  np.array([0], np.int32)),
                 (np.array([1], np.int32), np.array([1], np.int32))]
    for x, y in cases:
        ins = {"X": [("x", _both(x))]}
        if op != "logical_not":
            ins["Y"] = [("y", _both(y))]
        jenv, tenv = _apply_both(op, ins, {"Out": ["o"]})
        assert tenv["o"].dtype == torch.bool
        np.testing.assert_array_equal(tenv["o"].numpy(),
                                      np.asarray(jenv["o"]))


# -- TensorArray and the array ops --------------------------------------------

def test_tensor_array_matches_jax():
    """Writes in and past the capacity (clamped, as dynamic_update_slice
    clamps) and from the end, the length as the largest index + 1,
    reads, and `stack` with zeros past the length."""
    from paddle_tpu.core.tensor_array import EmptyTensorArray as JEmpty
    from paddle_tpu_torch.core.tensor_array import (DEFAULT_CAPACITY,
                                                    EmptyTensorArray)

    assert DEFAULT_CAPACITY == 256
    rs = np.random.RandomState(1)
    vals = [rs.randn(2, 3).astype(np.float32) for _ in range(4)]
    ja, ta = JEmpty(4), EmptyTensorArray(4)
    for i, v in zip([1, 0, 6, -2], vals):
        ja = ja.write(jnp.asarray(i), jnp.asarray(v))
        ta = ta.write(torch.tensor(i), torch.from_numpy(v))
        assert int(ta.length) == int(ja.length)
        np.testing.assert_array_equal(ta.buffer.numpy(),
                                      np.asarray(ja.buffer))
    assert int(ta.length) == 7 and ta.capacity == 4
    for i in (0, 3, 9, -1):
        np.testing.assert_array_equal(ta.read(torch.tensor(i)).numpy(),
                                      np.asarray(ja.read(jnp.asarray(i))))
    short = EmptyTensorArray(5).write(torch.tensor(1), torch.ones(2))
    np.testing.assert_array_equal(short.stack().numpy(),
                                  [[0, 0], [1, 1], [0, 0], [0, 0], [0, 0]])


def _array_ops_program(fluid):
    """tests/test_op_coverage.py:541's tensor-array program, less
    get_places: two writes, the length, a read and an IfElse."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        layers = fluid.layers
        x = layers.data(name="x", shape=[2], dtype="float32")
        i = layers.fill_constant(shape=[1], dtype="int64", value=0)
        arr = layers.array_write(x, i=i)
        i2 = layers.increment(x=i, value=1, in_place=False)
        layers.array_write(x, i=i2, array=arr)
        length = layers.array_length(arr)
        back = layers.array_read(array=arr, i=i)
        cond = layers.less_than(x=i, y=i2)
        ie = layers.IfElse(cond)
        with ie.true_block():
            ie.output(layers.scale(x=ie.input(x), scale=2.0))
        with ie.false_block():
            ie.output(ie.input(x))
        out = ie()
    return main, [length, back, out]


def test_array_ops_program_matches_jax():
    jmain, jfetch = _array_ops_program(jfluid)
    tmain, tfetch = _array_ops_program(tfluid)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    feed = {"x": np.array([[1.0, 2.0]], np.float32)}
    jres = jfluid.Executor(jfluid.CPUPlace()).run(jmain, feed=feed,
                                                  fetch_list=jfetch)
    tres = texec.Executor(CPU).run(tmain, feed=feed, fetch_list=tfetch)
    for t, j in zip(tres, jres):
        np.testing.assert_array_equal(t, np.asarray(j))
    assert tres[0].tolist() == [2] and tres[2].tolist() == [[2, 4]]


# -- while ------------------------------------------------------------------

# chip_smoke.py's loop: acc = tanh(acc W + x), a counter, its condition
# and an array written each step, built by either package's layers
_while_program = chip_smoke.ctc_while_program
WHILE_LIMIT = chip_smoke.CTC_LOOP_LIMIT


def _while_values(main, seed=0, limit=WHILE_LIMIT):
    """{name: (jax value, port value)} of the while op's inputs: the
    feeds, the weight, and block 0's values before the loop (the
    counter at 0, the bound, the condition, the array holding x)."""
    from paddle_tpu.core.tensor_array import TensorArray as JArray
    from paddle_tpu_torch.core.tensor_array import TensorArray

    rs = np.random.RandomState(seed)
    x = rs.randn(2, 4).astype(np.float32)
    out = {n: _both(v) for n, v in (
        ("x", x), ("acc", rs.randn(2, 4).astype(np.float32)),
        ("fc_0.w_0", (rs.randn(4, 4) * 0.5).astype(np.float32)))}
    for o in main.desc.block(0).ops:
        name = (o.output("Out") or [None])[0]
        if o.type == "fill_constant":
            out[name] = _both(np.array([o.attrs["value"]], np.int32))
        elif o.type == "less_than":
            out[name] = _both(np.array([True]))
        elif o.type == "write_to_array":
            buf = np.zeros((8, 2, 4), np.float32)
            buf[0] = x
            out[name] = (JArray(jnp.asarray(buf), 1),
                         TensorArray(torch.from_numpy(buf), 1))
    return out


def _while_op(main):
    op = next(o for o in main.desc.block(0).ops if o.type == "while")
    return OpDesc.from_dict(op.to_dict())


def _run_op_both(prog_dict, op, values):
    """Run `op` in block 0 of both programs over `values` ({name: (jax,
    port)}); returns (jax env, port env)."""
    jctx = jexec.ExecContext(None, _jax_program(prog_dict), 0,
                             {n: v[0] for n, v in values.items()})
    jexec.apply_op(jctx, JOpDesc.from_dict(op.to_dict()))
    tctx = texec.ExecContext(ProgramDesc.from_dict(prog_dict), 0,
                             {n: v[1] for n, v in values.items()},
                             device=torch.device("cpu"))
    texec.apply_op(tctx, op)
    return jctx.env, tctx.env


def _array_host(v):
    return (np.asarray(v.buffer), int(np.asarray(v.length))) \
        if hasattr(v, "buffer") else (np.asarray(v), None)


@pytest.mark.parametrize("max_steps", [None, 5, 2])
def test_while_matches_jax(max_steps):
    """Unbounded (a host read a step), bounded past the loop's end (the
    masked steps keep the carries) and bounded short of it."""
    main = _while_program(tfluid, max_steps)
    assert main.desc.to_dict() == \
        _while_program(jfluid, max_steps).desc.to_dict()
    op = _while_op(main)
    assert op.attrs["max_steps"] == max_steps
    prog_dict = main.desc.to_dict()
    jenv, tenv = _run_op_both(prog_dict, op, _while_values(main))
    steps = min(WHILE_LIMIT, max_steps or WHILE_LIMIT)
    for n in op.output("Out"):
        (tv, tl), (jv, jl) = _array_host(tenv[n]), _array_host(jenv[n])
        assert tl == jl, n
        assert tv.dtype == jv.dtype, (n, tv.dtype, jv.dtype)
        _assert_close(tv, jv, n)
    i_name = next(n for n in op.output("Out")
                  if getattr(tenv[n], "dtype", None) == torch.int32)
    assert tenv[i_name].tolist() == [steps]


def test_bounded_while_grad_matches_jax_vjp():
    """The bounded loop's generic grad (torch.func.vjp of the masked
    loop, the TensorArray carry through its buffer) against JAX's
    while_grad and against jax.vjp of the JAX kernel called directly:
    the grads of x, the initial acc, the weight and the array."""
    from paddle_tpu.core.tensor_array import TensorArray as JArray
    from paddle_tpu_torch.core.tensor_array import TensorArray

    main = _while_program(tfluid, 5)
    op = _while_op(main)
    prog_dict = main.desc.to_dict()
    values = _while_values(main, seed=3)
    jenv, tenv = _run_op_both(prog_dict, op, values)
    outs = op.output("Out")
    arr_name = next(n for n in outs if hasattr(tenv[n], "buffer"))
    rs = np.random.RandomState(4)
    og_acc = rs.randn(2, 4).astype(np.float32)
    og_buf = rs.randn(8, 2, 4).astype(np.float32)
    grads = {"acc@GRAD": _both(og_acc),
             arr_name + "@GRAD": (JArray(jnp.asarray(og_buf), 0),
                                  TensorArray(torch.from_numpy(og_buf), 0))}
    ins = dict(op.inputs)
    ins["O@Out"] = list(outs)
    ins["OG@Out"] = [n + "@GRAD" if n + "@GRAD" in grads else EMPTY
                     for n in outs]
    grad_op = OpDesc("while_grad", ins,
                     {"X@GRAD": [n + "@GRAD" for n in op.input("X")]},
                     dict(op.attrs))
    fwd = {n: (jenv[n], tenv[n]) for n in outs}
    jg, tg = _run_op_both(prog_dict, grad_op,
                          dict(values, **{k: v for k, v in fwd.items()
                                          if k not in values}, **grads))

    jprog = _jax_program(prog_dict)
    info = jreg.get_op_info("while")
    names = op.input("X")

    def f(x, acc, w, buf):
        env = {n: values[n][0] for n in names}
        env.update({"x": x, "acc": acc, "fc_0.w_0": w,
                    arr_name: JArray(buf, values[arr_name][0].length)})
        ctx = jexec.ExecContext(None, jprog, 0, {})
        out = dict(zip(outs, info.kernel(
            ctx, {"X": [env[n] for n in names],
                  "Condition": [env[op.input("Condition")[0]]]},
            dict(op.attrs))["Out"]))
        return (jnp.sum(out["acc"] * og_acc)
                + jnp.sum(out[arr_name].buffer * og_buf))

    want = dict(zip(("x", "acc", "fc_0.w_0", arr_name), jax.grad(
        f, argnums=(0, 1, 2, 3))(values["x"][0], values["acc"][0],
                                 values["fc_0.w_0"][0],
                                 values[arr_name][0].buffer)))
    for n, w in want.items():
        got = tg[n + "@GRAD"]
        got = got.buffer if hasattr(got, "buffer") else got
        ref = jg[n + "@GRAD"]
        ref = ref.buffer if hasattr(ref, "buffer") else ref
        _assert_close(got, np.asarray(ref), n + "@GRAD (JAX's while_grad)")
        _assert_close(got, np.asarray(w), n + "@GRAD (jax.vjp)")
        assert np.abs(np.asarray(w)).max() > 0, n


def test_while_rejects_an_unwritten_array_as_jax():
    from paddle_tpu.core.tensor_array import EmptyTensorArray as JEmpty
    from paddle_tpu_torch.core.tensor_array import EmptyTensorArray

    main = _while_program(tfluid, 5)
    op = _while_op(main)
    values = _while_values(main)
    arr = [n for n in op.input("X") if n.startswith("array")][0]
    values[arr] = (JEmpty(8), EmptyTensorArray(8))
    with pytest.raises(RuntimeError) as jerr:
        _run_op_both(main.desc.to_dict(), op, values)
    tctx = texec.ExecContext(main.desc, 0,
                             {n: v[1] for n, v in values.items()},
                             device=torch.device("cpu"))
    with pytest.raises(RuntimeError) as terr:
        texec.apply_op(tctx, op)
    assert str(terr.value) == str(jerr.value)
    assert "written once before the loop" in str(terr.value)


def test_unbounded_while_program_runs_as_jax():
    """tests/test_compile_passes.py:143's loop (acc += i + 1 while i <
    5, then 2 * acc), with `sums` where it assigns: 30 in both."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            layers = fluid.layers
            i = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
            acc = layers.fill_constant(shape=[1], dtype="float32",
                                       value=0.0)
            limit = layers.fill_constant(shape=[1], dtype="float32",
                                         value=5.0)
            cond = layers.less_than(x=i, y=limit)
            loop = layers.While(cond=cond)
            with loop.block():
                ni = layers.increment(x=i, value=1.0, in_place=True)
                layers.sums(input=[acc, ni], out=acc)
                layers.less_than(x=ni, y=limit, cond=cond)
            out = layers.scale(x=acc, scale=2.0)
        return main, out

    jmain, jout = build(jfluid)
    tmain, tout = build(tfluid)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    j, = jfluid.Executor(jfluid.CPUPlace()).run(jmain, fetch_list=[jout])
    t, = texec.Executor(CPU).run(tmain, fetch_list=[tout])
    np.testing.assert_array_equal(t, np.asarray(j))
    assert t.tolist() == [30.0]


# -- conditional_block and cond -----------------------------------------------

def _conditional_program(fluid):
    """out = x W where the scalar a < b holds, else out keeps its value
    (scale(x, 3)); built by `fluid`'s ConditionalBlock."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        layers = fluid.layers
        x = layers.data(name="x", shape=[3, 4], dtype="float32",
                        append_batch_size=False)
        a = layers.data(name="a", shape=[1], dtype="float32",
                        append_batch_size=False)
        b = layers.data(name="b", shape=[1], dtype="float32",
                        append_batch_size=False)
        out = layers.scale(x=x, scale=3.0)
        cond = layers.less_than(x=a, y=b)
        block = layers.ConditionalBlock([cond])
        with block.block():
            layers.sums(input=[layers.fc(input=x, size=4, bias_attr=False)],
                        out=out)
    return main


@pytest.mark.parametrize("taken", [True, False])
def test_conditional_block_and_its_grad_match_jax(taken):
    """The predicate read once; the branch's outputs and the generic
    grad of the branch taken (lax.cond's vjp on the JAX side)."""
    main = _conditional_program(tfluid)
    assert main.desc.to_dict() == \
        _conditional_program(jfluid).desc.to_dict()
    prog_dict = main.desc.to_dict()
    op = OpDesc.from_dict(next(o for o in main.desc.block(0).ops
                               if o.type == "conditional_block").to_dict())
    rs = np.random.RandomState(5)
    values = {n: _both(rs.randn(*s).astype(np.float32))
              for n, s in (("x", (3, 4)), ("fc_0.w_0", (4, 4)))}
    out_name = op.output("Out")[0]
    values[out_name] = _both(rs.randn(3, 4).astype(np.float32))
    values[op.input("Cond")[0]] = _both(np.array([taken]))
    jenv, tenv = _run_op_both(prog_dict, op, values)
    _assert_close(tenv[out_name], np.asarray(jenv[out_name]), "Out")
    want = values["x"][0] @ values["fc_0.w_0"][0] if taken \
        else values[out_name][0]
    _assert_close(tenv[out_name], np.asarray(want), "Out by hand")

    og = rs.randn(3, 4).astype(np.float32)
    ins = dict(op.inputs)
    ins["O@Out"] = [out_name]
    ins["OG@Out"] = [out_name + "@GRAD"]
    grad = OpDesc("conditional_block_grad", ins,
                  {"X@GRAD": [n + "@GRAD" for n in op.input("X")]},
                  dict(op.attrs))
    vals = dict(values)
    vals[out_name + "@GRAD"] = _both(og)
    jg, tg = _run_op_both(prog_dict, grad, vals)
    for n in op.input("X"):
        if n + "@GRAD" in jg and jg[n + "@GRAD"] is not None:
            _assert_close(tg[n + "@GRAD"], np.asarray(jg[n + "@GRAD"]),
                          n + "@GRAD")
    w_grad = tg["fc_0.w_0@GRAD"]
    assert bool(w_grad.abs().max() > 0) == taken


def test_cond_op_picks_rows_as_jax():
    """Both blocks over the full batch, rows by mask: 2x where the
    mask holds, -x elsewhere."""
    prog = tfluid.Program()
    gb = prog.global_block()
    for n in ("x", "c", "o"):
        gb.create_var(name=n, dtype="float32")
    for scale in (2.0, -1.0):
        with prog.block_guard() as sub:
            sub.create_var(name="y", dtype="float32")
            sub.append_op(type="scale", inputs={"X": ["x"]},
                          outputs={"Out": ["y"]}, attrs={"scale": scale},
                          infer_shape=False)
    op = OpDesc("cond", {"Cond": ["c"], "Xs": ["x"]}, {"Outs": ["o"]},
                {"true_block": BlockRef(1), "false_block": BlockRef(2),
                 "x_names": ["x"], "out_names": ["y"]})
    x = np.random.RandomState(6).randn(5, 3).astype(np.float32)
    mask = np.array([True, False, False, True, True])
    jenv, tenv = _run_op_both(prog.desc.to_dict(), op,
                              {"x": _both(x), "c": _both(mask)})
    np.testing.assert_array_equal(tenv["o"].numpy(), np.asarray(jenv["o"]))
    np.testing.assert_array_equal(tenv["o"].numpy(),
                                  np.where(mask[:, None], 2 * x, -x))
