"""Eight faults of the port against the JAX package, each repaired:

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
- The retry policy's deadline, attempt timeout, retryable set, name and
  metrics (ROADMAP C6): tests/test_resilience.py's policy cases (backoff
  bounds, the overall deadline, the attempt timeout, the retry and
  exhaustion counters) on both packages' `RetryPolicy`, and its lease
  cases on both packages' `ServiceLease`, whose default policy now has
  the JAX coordinator's deadline (0.9 of a beat), retryable set and name.
- The public names the port lacked (ROADMAP C7): `fluid.Block`,
  `fluid.RaggedTensor`, `fluid.TPUPlace` (the port's accelerator place,
  the same class as `CUDAPlace`), `utils`' flags surface with
  `DEFINE_flag`, and `jit.functionalize`; the `__all__` of `fluid`,
  `fluid.layers`, `utils` and `jit` hold every JAX name (the last two,
  `ParallelDo` and `get_places`, came with the parallel package).
- The executor's feed and transfer telemetry (found in PR 19): the
  port's executor timed no feed preparation and counted no transfer
  bytes, where the JAX executor publishes `executor_feed_seconds_total`
  and `executor_transfer_bytes_total{direction}` (h2d per placed feed,
  d2h per fetch) and its DataFeeder counts what it places; a DataFeeder
  batch then fed counts once, as in the JAX package.
- The server's replies on a kept-alive connection (found in PR 19):
  headers and body left in two writes without TCP_NODELAY, so each
  reply after a connection's first waited for the client's delayed ACK
  (about 40 ms a request on Linux); the handler now sets TCP_NODELAY.
- A ragged input to an op that takes dense tensors only (ROADMAP C8):
  `ops.registry.dense` raised NotImplementedError calling the input
  "not ported", where the JAX op refuses one too (`jnp` takes no
  RaggedTensor); it now raises TypeError saying the op takes no ragged
  input, for each op that calls it.
- `fluid.framework.reset_unique_name` (ROADMAP C9): the port lacked it,
  where the JAX package's builders (and `resilience.elastic`'s
  `build_fn`) call it before rebuilding into one program; after a reset
  a build into the same program gives the JAX package's names again.
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


# -- retry policy and the lease heartbeat (ROADMAP C6) -------------------------

def _retry_pair():
    from paddle_tpu.resilience import retry as jretry
    from paddle_tpu_torch.resilience import retry as tretry

    return jretry, tretry


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_retry_backoff_deadline_and_attempt_timeout(pkg):
    """tests/test_resilience.py:63-112 on either package's policy."""
    import random
    import time

    mod = _retry_pair()[pkg == "port"]
    RetryPolicy, AttemptTimeout = mod.RetryPolicy, mod.AttemptTimeout
    policy = RetryPolicy(base_delay=0.1, max_delay=1.0,
                         rng=random.Random(0))
    for attempt in range(1, 8):
        cap = min(1.0, 0.1 * (2 ** (attempt - 1)))
        for _ in range(20):
            assert 0 <= policy.backoff(attempt) <= cap
    nojit = RetryPolicy(base_delay=0.1, max_delay=1.0, jitter=False)
    assert nojit.backoff(1) == 0.1 and nojit.backoff(5) == 1.0

    slept = []

    def never():
        raise IOError("x")

    with pytest.raises(IOError):
        RetryPolicy(max_attempts=100, base_delay=10.0, jitter=False,
                    deadline=0.5, sleep=slept.append).call(never)
    assert slept == []   # the first backoff would blow the budget

    calls = []

    def hangs_once():
        calls.append(1)
        if len(calls) == 1:
            time.sleep(5)
        return "done"

    assert RetryPolicy(max_attempts=2, base_delay=0.0,
                       attempt_timeout=0.2).call(hangs_once) == "done"
    assert len(calls) == 2
    with pytest.raises(AttemptTimeout):
        RetryPolicy(max_attempts=1, attempt_timeout=0.05).call(
            time.sleep, 5)
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=5, base_delay=0.0,
                    retryable=(ConnectionError,)).call(
            lambda: (_ for _ in ()).throw(ValueError("bug")))
    blips = [IOError("t"), IOError("t")]

    def two_blips():
        if blips:
            raise blips.pop()
        return "ok"

    # a predicate as the retryable set
    assert RetryPolicy(max_attempts=3, base_delay=0.0,
                       retryable=lambda e: isinstance(e, IOError)).call(
        two_blips) == "ok"


def test_retry_metrics_match_jax():
    """retries_total{op} and retry_exhausted_total{op}, by the policy's
    name, on each package's registry."""
    from paddle_tpu.obs import registry as j_registry
    from paddle_tpu.obs import telemetry as j_tele
    from paddle_tpu_torch.obs import registry as t_registry
    from paddle_tpu_torch.obs import telemetry as t_tele

    snaps = []
    for (mod, reg, tele) in zip(_retry_pair(), (j_registry, t_registry),
                                (j_tele, t_tele)):
        reg.reset_registry()
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise IOError("transient")
            return "ok"

        assert mod.RetryPolicy(max_attempts=3, base_delay=0.0,
                               name="t").call(flaky) == "ok"
        with pytest.raises(ConnectionError):
            mod.RetryPolicy(max_attempts=2, base_delay=0.0,
                            name="boom").call(
                lambda: (_ for _ in ()).throw(ConnectionError("down")))
        snap = tele.snapshot()
        snaps.append({k: v for k, v in snap.items()
                      if k.startswith(("retries_total",
                                       "retry_exhausted_total"))})
        reg.reset_registry()
    assert snaps[0] == snaps[1] == {"retries_total{op=t}": 2,
                                    "retries_total{op=boom}": 1,
                                    "retry_exhausted_total{op=boom}": 1}


class _FakeLeaseClient:
    """tests/test_resilience.py's fake master client."""

    def __init__(self, fail_beats=0):
        self.fail_beats = fail_beats
        self.beats = 0
        self.closed = False
        self.unregistered = False

    def keep_alive(self, lease):
        self.beats += 1
        if self.fail_beats > 0:
            self.fail_beats -= 1
            raise ConnectionError("blip")
        return True

    def unregister(self, lease):
        self.unregistered = True

    def close(self):
        self.closed = True


def _lease_classes():
    from paddle_tpu.distributed.coordinator import ServiceLease as J
    from paddle_tpu_torch.distributed.coordinator import ServiceLease as T

    return J, T


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_lease_survives_a_blip_and_lapses_on_persistent_failure(pkg):
    """tests/test_resilience.py:394-420 on either package's lease."""
    import time

    ServiceLease = _lease_classes()[pkg == "port"]
    client = _FakeLeaseClient(fail_beats=1)
    lease = ServiceLease(client, lease_id=1, ttl_ms=120)
    deadline = time.time() + 3
    while client.beats < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert not lease.lapsed
    lease.release()
    assert client.unregistered and client.closed

    client = _FakeLeaseClient(fail_beats=10 ** 6)
    lease = ServiceLease(client, lease_id=1, ttl_ms=120)
    deadline = time.time() + 3
    while not lease.lapsed and time.time() < deadline:
        time.sleep(0.01)
    assert lease.lapsed
    lease.release()


def test_lease_retry_budget_is_the_jax_coordinators():
    """The default heartbeat policy: 3 attempts, its whole budget under
    0.9 of a beat interval, only connection errors retried, named
    lease_heartbeat — as the JAX coordinator builds it."""
    policies = []
    for cls in _lease_classes():
        client = _FakeLeaseClient()
        lease = cls(client, lease_id=1, ttl_ms=300)
        policies.append(lease._retry)
        lease.release()
    jp, tp = policies
    for key in ("max_attempts", "base_delay", "max_delay", "deadline",
                "retryable", "name", "jitter", "attempt_timeout"):
        assert getattr(tp, key) == getattr(jp, key), key
    assert tp.deadline == pytest.approx(0.09)
    assert tp.name == "lease_heartbeat"
    assert not tp.is_retryable(ValueError("bug"))


# -- public names (ROADMAP C7) ----------------------------------------------------

def test_public_names_match_jax_but_the_mesh_layers():
    """The JAX `__all__` of fluid, fluid.layers, utils and jit, and the
    port's: every name (ParallelDo and get_places came with the parallel
    package)."""
    import paddle_tpu.jit as jjit
    import paddle_tpu.utils as jutils
    import paddle_tpu_torch.jit as tjit
    import paddle_tpu_torch.utils as tutils

    missing = set()
    for j, t in ((jfluid, tfluid), (jfluid.layers, tfluid.layers),
                 (jutils, tutils), (jjit, tjit)):
        missing |= set(j.__all__) - set(t.__all__)
        for name in t.__all__:
            assert hasattr(t, name), (t.__name__, name)
    assert missing == set()


def test_tpu_place_is_the_accelerator_place():
    """The JAX package aliases CUDAPlace to its TPUPlace; the port
    aliases TPUPlace to its CUDAPlace, so `fluid.TPUPlace(0)` in a
    script written for the JAX package names the card."""
    assert tfluid.TPUPlace is tfluid.CUDAPlace
    assert jfluid.CUDAPlace is jfluid.TPUPlace
    assert repr(tfluid.TPUPlace(0)) == "CUDAPlace(0)"
    assert tfluid.Block is tfluid.framework.Block
    from paddle_tpu_torch.core.ragged import RaggedTensor

    assert tfluid.RaggedTensor is RaggedTensor
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tfluid.Executor(tfluid.TPUPlace(0))


def test_define_flag_and_functionalize():
    from paddle_tpu_torch import utils as tutils
    from paddle_tpu_torch.jit import FunctionalProgram, functionalize

    assert tutils.DEFINE_flag("port_test_flag", 1.5, "a test flag") == 1.5
    tutils.set_flag("port_test_flag", "2.25")
    assert tutils.get_flag("port_test_flag") == 2.25
    assert tutils.flags.all_flags()["check_nan_inf"] is False
    with pytest.raises(KeyError):
        tutils.set_flag("no_such_flag", 1)
    import os

    os.environ["FLAGS_port_test_flag"] = "3.5"
    try:
        tutils.parse_flags_from_env(["port_test_flag"])
    finally:
        del os.environ["FLAGS_port_test_flag"]
    assert tutils.get_flag("port_test_flag") == 3.5

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[3], dtype="float32")
        y = tfluid.layers.scale(x=x, scale=2.0)
    fp = functionalize(main, ["x"], [y.name], place=tfluid.CPUPlace())
    assert isinstance(fp, FunctionalProgram)
    (out,), _ = fp({}, {"x": torch.ones(2, 3)})
    assert out.tolist() == [[2.0] * 3] * 2


def test_executor_and_feeder_count_feeds_and_transfers():
    from paddle_tpu.obs import telemetry as jtele
    from paddle_tpu_torch.obs import registry as tregistry
    from paddle_tpu_torch.obs import telemetry as ttele

    tregistry.reset_registry()
    rows = [(np.full(13, i, np.float32), np.full(1, i, np.float32))
            for i in range(5)]
    got = {}
    for name, fluid, tele in (("jax", jfluid, jtele),
                              ("torch", tfluid, ttele)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[13], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
            loss = fluid.layers.mean(x=fluid.layers.square_error_cost(
                input=fluid.layers.fc(input=x, size=1), label=y))
            fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            exe.run(startup)
            feeder = fluid.DataFeeder(place=fluid.CPUPlace(),
                                      feed_list=[x, y])
            snap = tele.snapshot()
            exe.run(main, feed=feeder.feed(rows), fetch_list=[loss])
            exe.run(main, feed={"x": np.ones((2, 13), np.float32),
                                "y": np.ones((2, 1), np.float32)},
                    fetch_list=[loss])
            delta = tele.snapshot_delta(snap)
        got[name] = {k: v for k, v in delta.items()
                     if k.startswith("executor_transfer_bytes_total")}
        assert delta.get("executor_feed_seconds_total", 0) > 0
    assert got["torch"] == got["jax"] == {
        "executor_transfer_bytes_total{direction=h2d}": 5 * 14 * 4
        + 2 * 14 * 4,
        "executor_transfer_bytes_total{direction=d2h}": 2 * 4}


def test_server_replies_without_nagle_delay():
    import socket

    from paddle_tpu_torch.obs import context as obs_context
    from paddle_tpu_torch.obs import load as obs_load
    from paddle_tpu_torch.serving import InferenceServer, ServerConfig
    from paddle_tpu_torch.serving import server as server_mod

    nodelay = []
    handler = server_mod._Handler
    setup = handler.setup

    def recording_setup(self):
        setup(self)
        nodelay.append(self.connection.getsockopt(
            socket.IPPROTO_TCP, socket.TCP_NODELAY))

    engine = obs_load.build_tiny_engine(dim=8, classes=3, buckets=(2,),
                                        place=tfluid.CPUPlace())
    handler.setup = recording_setup
    try:
        server = InferenceServer(engine, ServerConfig(
            port=0, max_batch=2, warmup=False)).start()
        try:
            host, port = server.address
            target = obs_load.HttpTarget("http://%s:%d" % (host, port))
            payload = obs_load.vector_payload("img", 8)(2)
            for _ in range(3):
                status, _, _ = target.infer(payload,
                                            obs_context.TraceContext())
                assert status == 200
        finally:
            server.shutdown()
    finally:
        handler.setup = setup
    assert nodelay and all(nodelay), nodelay


# -- ragged inputs to dense-only ops (C8) ---------------------------------------

_RAGGED_REFUSED = {
    "transpose": ({}, {"axis": [1, 0]}),
    "expand": ({}, {"expand_times": [1, 2]}),
    "clip": ({}, {"min": -1.0, "max": 1.0}),
    "clip_by_norm": ({}, {"max_norm": 1.0}),
    "gather": ({"Index": [[0, 1]]}, {}),
    "scatter": ({"Index": [[0, 1]], "Updates": [np.ones((2, 3))]}, {}),
    "pad": ({}, {"paddings": [0, 0, 0, 1], "pad_value": 0.0}),
    "crop": ({}, {"shape": [1, 3], "offsets": [0, 0]}),
}


@pytest.mark.parametrize("op_type", sorted(_RAGGED_REFUSED))
def test_dense_only_ops_refuse_a_ragged_input(op_type):
    """The JAX op refuses a RaggedTensor (its kernel hands it to
    `jnp`); the port's raises TypeError saying the op takes none."""
    from paddle_tpu.core.ragged import RaggedTensor as JRagged
    from paddle_tpu.ops import registry as jreg
    from paddle_tpu_torch.core.ragged import RaggedTensor as TRagged
    from paddle_tpu_torch.ops import registry as treg

    extra, attrs = _RAGGED_REFUSED[op_type]
    seqs = [np.ones((2, 3), np.float32), np.ones((1, 3), np.float32)]
    slot = "Ref" if op_type == "scatter" else "X"

    def ins(ragged, as_array):
        out = {slot: [ragged]}
        for k, v in extra.items():
            arr = np.asarray(v[0], np.int32 if k == "Index"
                             else np.float32)
            out[k] = [as_array(arr)]
        return out

    with pytest.raises((TypeError, AttributeError)):
        jreg.get_op_info(op_type).kernel(
            None, ins(JRagged.from_sequences(seqs), jnp.asarray), attrs)
    with pytest.raises(TypeError, match="takes no ragged"):
        treg.get_op_info(op_type).kernel(
            None, ins(TRagged.from_sequences(seqs), torch.from_numpy),
            attrs)


# -- reset_unique_name (C9) ------------------------------------------------------

def _names_built_twice(fl, reset):
    """The parameter names of two fc layers built into one program, the
    second build after `reset` (or not)."""
    main, startup = fl.Program(), fl.Program()
    names = []
    with fl.program_guard(main, startup):
        for i in range(2):
            if reset and i:
                fl.framework.reset_unique_name()
            x = fl.layers.data(name="x%d" % i, shape=[4], dtype="float32")
            fl.layers.fc(input=x, size=3)
            names.append(sorted(p.name for p in
                                main.global_block().all_parameters()))
    return names


@pytest.mark.parametrize("reset", [True, False])
def test_reset_unique_name_gives_the_jax_names(reset):
    got = _names_built_twice(tfluid, reset)
    assert got == _names_built_twice(jfluid, reset)
    assert (got[1] == got[0]) is reset
    # a program given by name is reset alone
    prog = tfluid.Program()
    tfluid.framework.unique_name("fc", prog)
    tfluid.framework.reset_unique_name(prog)
    assert tfluid.framework.unique_name("fc", prog) == "fc_0"


def test_executor_run_has_the_jax_signature():
    """`Executor.run` takes the JAX executor's parameters, in its order
    (`feed_var_name`, `fetch_var_name` and `use_program_cache` among
    them), and the port's `eager` in the JAX place."""
    import inspect

    from paddle_tpu.fluid import executor as jexec
    from paddle_tpu_torch.fluid import executor as texec

    def params(cls):
        return list(inspect.signature(cls.run).parameters)

    assert params(texec.Executor) == params(jexec.Executor)
    assert {"feed_var_name", "fetch_var_name", "use_program_cache"} \
        <= set(params(texec.Executor))
    jdefaults = {n: p.default for n, p in inspect.signature(
        jexec.Executor.run).parameters.items()}
    tdefaults = {n: p.default for n, p in inspect.signature(
        texec.Executor.run).parameters.items()}
    assert tdefaults == jdefaults
