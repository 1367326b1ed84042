"""Four faults of the port against the JAX package, each repaired:

- The flash kernel's routes: head dims up to 256 in float32, bfloat16
  and float16 (129..256 on routes of their own), a clear error above
  256 or for another dtype; and the plain version at head dims 192 and
  256 against the Pallas kernel in interpret mode (float32 at atol 2e-5,
  as tests/test_torch_flash_attention.py holds the smaller ones).
- `save_inference_model` takes the executor, as the JAX package's
  does, reading the global scope; a Scope in that slot still works;
  `model_filename` comes before `bucket_hints`.
- `Program.random_seed` seeds the scope's random stream: startup
  programs with seeds 1 and 2 give different fc weights, the same seed
  equal ones, and `clone` keeps the seed.
- Sums of repeated rows repeat bit for bit: `core.ragged.sum_rows`
  sorts the ids stably and sums each run in row order, and
  `add_rows_` (the SelectedRows `to_dense` and `sum`, the row updates
  of `sgd` and `adagrad`), the dense `lookup_table_grad` and
  `sequence_pool`'s SUM go through such fixed-order sums instead of
  `index_add_`'s atomic adds.  With repeated, negative and
  out-of-range ids each equals `index_add_` and JAX's `segment_sum`
  within f32 rounding (atol 1e-6 times the number of addends and the
  largest magnitude), gives the same bits when run twice, adds -0.0
  where nothing lands (a -0.0 entry keeps its sign) and leaves the rows
  no id names bit for bit.
"""

import importlib
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401 — registers the JAX kernels
from paddle_tpu.core.scope import Scope as JScope
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import io as tio

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
tfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")

DTYPES = {"float32": "f32", "bfloat16": "bf16", "float16": "f16"}


# -- flash attention: routes by head dim and dtype ------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D", [64, 128, 192, 256])
def test_flash_routes(D, dtype):
    tdt = getattr(torch, dtype)
    want = DTYPES[dtype] + ("" if D <= 128 else "_d256")
    assert tfa.kernel_route(tdt, D) == want
    assert want in tfa.ROUTES
    # the split op's views of a [B, T, 3*H*D] fc output pass the check
    x = torch.zeros(2, 24, 3 * 2 * D, dtype=tdt)
    q, k, v = (t.unflatten(-1, (2, D)) for t in x.split(2 * D, dim=-1))
    o = torch.empty(2, 24, 2 * D, dtype=tdt).unflatten(-1, (2, D))
    strides = tfa.check_kernel_args(q, k, v, o)
    assert strides[:3] == [24 * 6 * D, 6 * D, D]


@pytest.mark.parametrize("D", [257, 512])
def test_flash_head_dim_above_256_raises(D):
    with pytest.raises(ValueError, match="head dim %d; the kernel takes "
                                         "1..256" % D):
        tfa.kernel_route(torch.float32, D)
    q = torch.zeros(1, 8, 1, D)
    with pytest.raises(ValueError, match="1..256"):
        tfa.check_kernel_args(q, q, q, torch.empty(q.shape))


def test_flash_other_dtype_raises():
    with pytest.raises(TypeError, match="float16, float32 or bfloat16"):
        tfa.kernel_route(torch.float64, 64)


def test_flash_launches_counted_by_route():
    assert set(tfa.flash_attention_fwd.route_launches) == set(tfa.ROUTES)
    assert len(tfa.ROUTES) == 6


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [192, 256])
def test_plain_matches_pallas_at_wide_heads(D, causal):
    rs = np.random.RandomState(D)
    arrs = [rs.randn(1, 2, 16, D).astype(np.float32) for _ in range(3)]
    scale = D ** -0.5
    jo, jm, jl = jfa._fwd(*[jnp.asarray(a) for a in arrs], scale, causal,
                          128, 128, 0)
    to, tm, tl = tfa.flash_attention_plain(
        *[torch.from_numpy(a) for a in arrs], scale, causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5)


# -- save_inference_model with the executor -----------------------------------

def _fc_program(fluid, seed=0):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[5], dtype="float32")
        y = fluid.layers.fc(input=x, size=3, act="relu")
    return main, startup, y


def test_save_inference_model_takes_the_executor(tmp_path):
    main, startup, y = _fc_program(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        # the JAX package's call, positionally
        tio.save_inference_model(str(tmp_path / "a"), ["x"], [y], exe, main)
        tio.save_inference_model(str(tmp_path / "b"), ["x"], [y], exe,
                                 main, "model.json", {"batch_buckets": [2]})
    tio.save_inference_model(str(tmp_path / "c"), ["x"], [y], scope, main)
    meta = json.load(open(str(tmp_path / "b" / "model.json")))
    assert meta["bucket_hints"] == {"batch_buckets": [2]}
    xs = np.random.RandomState(0).randn(2, 5).astype(np.float32)
    outs = []
    for d, fname in (("a", "__model__"), ("b", "model.json"),
                     ("c", "__model__")):
        load_scope = tfluid.Scope()
        with tfluid.scope_guard(load_scope):
            prog, feeds, fetches = tio.load_inference_model(
                str(tmp_path / d), exe, model_filename=fname)
            outs.append(exe.run(prog, feed={"x": xs}, fetch_list=fetches)[0])
    want = exe.run(main, feed={"x": xs}, fetch_list=[y], scope=scope)[0]
    for got in outs:
        np.testing.assert_array_equal(got, want)
    # and the JAX package reads the port's export
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(JScope()):
        prog, feeds, fetches = jfluid.io.load_inference_model(
            str(tmp_path / "a"), jexe)
        jout = jexe.run(prog, feed={"x": xs}, fetch_list=fetches)[0]
    np.testing.assert_allclose(np.asarray(jout), want, atol=1e-6, rtol=0)


# -- Program.random_seed --------------------------------------------------------

def _weights(fluid, seed, scope_cls, exe_place):
    _, startup, _ = _fc_program(fluid, seed)
    exe = fluid.Executor(exe_place)
    scope = scope_cls()
    with fluid.scope_guard(scope):
        exe.run(startup)
    return np.array(scope.get("fc_0.w_0"))


def test_random_seed_seeds_the_stream():
    def port(seed):
        return _weights(tfluid, seed, tfluid.Scope, tfluid.CPUPlace())

    def jax(seed):
        return _weights(jfluid, seed, JScope, jfluid.CPUPlace())

    for weights in (port, jax):
        w1, w1b, w2 = weights(1), weights(1), weights(2)
        assert np.array_equal(w1, w1b)
        assert not np.array_equal(w1, w2)
        assert w1.shape == (5, 3)


def test_random_seed_survives_clone_and_stream_advances():
    main, startup, _ = _fc_program(tfluid, seed=5)
    assert startup.clone().random_seed == 5
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    first = scope.get("fc_0.w_0").clone()
    # a second run in the same scope draws on from the scope's stream
    exe.run(startup, scope=scope)
    assert not torch.equal(scope.get("fc_0.w_0"), first)
    # an executor given a seed keeps a stream of its own
    a, b = tfluid.Scope(), tfluid.Scope()
    seeded = tfluid.Executor(tfluid.CPUPlace(), seed=5)
    seeded.run(startup, scope=a)
    seeded.run(startup, scope=b)
    assert not torch.equal(a.get("fc_0.w_0"), b.get("fc_0.w_0"))


# -- sums of repeated rows in a fixed order ------------------------------------

def _rows_case(seed, n=64, height=10, width=3):
    """Ids with repeats, negatives in [-height, 0) and ids outside
    [-height, height), and their values."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(-height - 3, height + 3, size=n).astype(np.int32)
    ids[:8] = 2  # one id hit eight times
    vals = rs.randn(n, width).astype(np.float32)
    return ids, vals


def _jax_scatter(ids, vals, height):
    """The JAX side's `x.at[ids].add(values)` into zeros."""
    return np.asarray(jnp.zeros((height, vals.shape[1]), jnp.float32)
                      .at[jnp.asarray(ids)].add(jnp.asarray(vals)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_add_rows_matches_index_add_and_jax(seed):
    from paddle_tpu_torch.core.ragged import add_rows_, row_index

    height = 10
    ids, vals = _rows_case(seed, height=height)
    got = add_rows_(torch.zeros(height, 3), torch.from_numpy(ids),
                    torch.from_numpy(vals))
    index, valid = row_index(torch.from_numpy(ids), height)
    atomic = torch.zeros(height, 3).index_add_(
        0, index, torch.from_numpy(vals) * valid[:, None])
    tol = 1e-6 * len(ids) * float(np.abs(vals).max())
    np.testing.assert_allclose(got.numpy(), atomic.numpy(), atol=tol,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), _jax_scatter(ids, vals, height),
                               atol=tol, rtol=0)
    again = add_rows_(torch.zeros(height, 3), torch.from_numpy(ids),
                      torch.from_numpy(vals))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_sum_rows_sums_runs_in_row_order():
    from paddle_tpu_torch.core.ragged import sum_rows

    index = torch.tensor([3, 1, 3, 0, 1, 3])
    vals = torch.tensor([[1.0], [2.0], [4.0], [8.0], [16.0], [32.0]])
    ids, sums = sum_rows(index, vals)
    assert ids[:3].tolist() == [0, 1, 3]
    assert sums[:3, 0].tolist() == [8.0, 18.0, 37.0]
    # past the last run: the last id again, adding -0.0
    assert ids[3:].tolist() == [3, 3, 3]
    assert torch.signbit(sums[3:]).all() and not sums[3:].any()
    # f32 sums in row order: 1e8 + 1 + ... is not 1 + ... + 1e8
    big = torch.tensor([[1e8], [1.0], [1.0], [1.0], [1.0]])
    _, s = sum_rows(torch.zeros(5, dtype=torch.long), big)
    want = np.float32(1e8)
    for _ in range(4):
        want = np.float32(want + np.float32(1.0))
    assert s[0, 0].item() == want


def test_add_rows_keeps_negative_zero_and_untouched_rows():
    from paddle_tpu_torch.core.ragged import add_rows_

    x = torch.full((6, 2), -0.0)
    x[5] = 7.0
    ids = torch.tensor([1, 1, 9, -9, 3], dtype=torch.int32)
    vals = torch.tensor([[1.0, -0.0], [-1.0, -0.0], [5.0, 5.0],
                         [5.0, 5.0], [-0.0, -0.0]])
    out = add_rows_(x.clone(), ids, vals)
    # rows 0, 2, 4 untouched; row 3 added -0.0 only; out-of-range ids
    # (9, -9) add nothing; row 1 sums 1 + -1 = 0 in row order
    for r in (0, 2, 3, 4):
        assert torch.equal(out[r].view(torch.int32),
                           x[r].view(torch.int32)), r
    assert out[5].tolist() == [7.0, 7.0]
    assert out[1].tolist() == [0.0, 0.0]


def test_dense_lookup_table_grad_repeats_and_matches_jax():
    from paddle_tpu.fluid import executor as jexec
    from paddle_tpu.core.desc import OpDesc as JOpDesc
    from paddle_tpu_torch.core.desc import OpDesc
    from paddle_tpu_torch.fluid import executor as texec

    rs = np.random.RandomState(3)
    ids = rs.randint(-12, 12, size=(40, 1)).astype(np.int32)
    ids[:10] = 0
    w = rs.randn(12, 4).astype(np.float32)
    og = rs.randn(40, 4).astype(np.float32)
    names = {"Ids": ["ids"], "W": ["w"], "O@Out": ["@EMPTY@"],
             "OG@Out": ["og"]}
    attrs = {"is_sparse": False, "padding_idx": -1}
    env = {"ids": ids, "w": w, "og": og}
    op = ("lookup_table_grad", names, {"W@GRAD": ["gw"]}, attrs)
    jctx = jexec.ExecContext(None, None, 0,
                             {k: jnp.asarray(v) for k, v in env.items()})
    jexec.apply_op(jctx, JOpDesc(*op))
    runs = []
    for _ in range(2):
        tctx = texec.ExecContext(
            None, 0, {k: torch.from_numpy(v) for k, v in env.items()},
            device=torch.device("cpu"))
        texec.apply_op(tctx, OpDesc(*op))
        runs.append(tctx.env["gw"])
    assert torch.equal(runs[0].view(torch.int32), runs[1].view(torch.int32))
    np.testing.assert_allclose(runs[0].numpy(), np.asarray(jctx.env["gw"]),
                               atol=1e-6 * 40 * np.abs(og).max(), rtol=0)


def test_sequence_pool_sum_is_the_rows_in_order():
    """SUM over a sequence of 1e8 and four 1s: the f32 sum in row order
    (a segment reduction over the splits); padding rows take no part."""
    from paddle_tpu_torch.core.ragged import RaggedTensor
    from paddle_tpu_torch.ops.sequence import sequence_pool

    vals = torch.tensor([[1e8], [1.0], [1.0], [1.0], [1.0], [2.0], [9e9]])
    x = RaggedTensor(vals, [torch.tensor([0, 5, 5, 6])], nvalid=6)
    out = sequence_pool(None, {"X": [x]}, {"pooltype": "SUM"})["Out"][0]
    want = np.float32(1e8)
    for _ in range(4):
        want = np.float32(want + np.float32(1.0))
    assert out[:, 0].tolist() == [float(want), 0.0, 2.0]
