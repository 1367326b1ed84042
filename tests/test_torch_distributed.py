"""The parameter-server path in the port against the JAX package, on the
CPU, each package's program trained through its own native pservers on
loopback (servers on port 0, stopped in a `finally`; every wait has its
own timeout).

- `split_dense_variable` and the transpiled descs equal the JAX
  package's (tuples and lists compared as equal), fused updates
  unfused first; a bad split and an unsupported optimizer raise alike.
- fit-a-line (SGD, blocks of 4 over two servers) and the CTR DeepFM
  (Adam, two `is_sparse` tables, two servers) trained through both
  packages from one state: losses and every parameter within
  TRAIN_ATOL times the larger of 1 and the parameter's largest
  magnitude (the same f32 arithmetic on both sides' servers; the
  trainers' forward and backward round differently in the last bits,
  and Adam's division by the root of the second moment carries that
  into the update); the sparse rows each server applied exactly equal,
  and equal to one row per id a step and table.
- `dist_send`'s sparse path with a negative id, a negative id beside its
  wrapped twin, and an id outside the table, against the JAX op on its
  own server: the table, the server's rows and the error.
- async SGD with its staleness bound; the learning-rate-decay warning;
  `init_pservers` keeping the scope's device and dtype.
- The roles as processes through the port's launcher (two pservers, two
  trainers in sync mode: both exit 0 with equal parameters), and its
  elastic form (a master, leases, `discover_pservers`).
- The elastic registry: lease, expiry and rediscovery; a pserver killed
  mid-training and recovered from its checkpoint, as in
  tests/test_elastic_coordination.py.
- `analysis.verify_program` against the JAX verifier on good and broken
  descs; the names that used to wait (`init_multihost`, the fleet
  reporter, `print_fleet_view`) work, with the JAX package's `__all__`
  (their cases are in tests/test_torch_obs_fleet.py).
"""

import io
import os
import socket
import tempfile
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import native as jnative
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.distributed import transpiler as jtranspiler
from paddle_tpu.models.ctr import deepfm_ctr as j_deepfm
from paddle_tpu.ops.dist import ClientPool as JClientPool
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import analysis, distributed, native
from paddle_tpu_torch.distributed import coordinator, transpiler
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.models.ctr import deepfm_ctr as t_deepfm
from paddle_tpu_torch.ops.dist import ClientPool
from paddle_tpu_torch.tools import cluster_launch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = tfluid.CPUPlace()
TRAIN_ATOL = 1e-5
TIMEOUT_S = 240
NUM_FEATURES = 120
NUM_FIELDS = 4


def _norm(v):
    """A desc dict with tuples as lists."""
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    return v


@pytest.fixture
def servers():
    """Make pservers in both packages on free ports; stops them and
    drops both packages' client connections afterwards."""
    made = []

    def make(pkg, n, **kw):
        s = [pkg.ParameterServer(**kw) for _ in range(n)]
        made.extend(s)
        return s

    try:
        yield make
    finally:
        ClientPool.reset()
        JClientPool.reset()
        for s in made:
            s.stop()


def _endpoints(srv):
    return ",".join("127.0.0.1:%d" % s.port for s in srv)


# -- the programs -------------------------------------------------------------

def _fit_a_line(fluid, opt="SGD", lr=0.01, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        y_predict = fluid.layers.fc(input=x, size=1, act=None)
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        cost = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=y_predict, label=y))
        ops, pg = getattr(fluid.optimizer, opt)(
            learning_rate=lr, **kw).minimize(cost)
    return main, startup, cost, ops, pg


def _deepfm(fluid, opt="Adam", lr=1e-2, fuse_updates=None):
    model = j_deepfm if fluid is jfluid else t_deepfm
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[NUM_FIELDS],
                                dtype="int64")
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        loss, _ = model(ids, label, NUM_FEATURES, NUM_FIELDS, embed_dim=8,
                        hidden_sizes=(32, 16))
        ops, pg = getattr(fluid.optimizer, opt)(
            learning_rate=lr).minimize(loss, fuse_updates=fuse_updates)
    return main, startup, loss, ops, pg


def _ctr_data(n, seed):
    """tests/test_ctr_deepfm.py's synthetic batch."""
    rs = np.random.RandomState(seed)
    per_field = NUM_FEATURES // NUM_FIELDS
    ids = np.stack([rs.randint(f * per_field, (f + 1) * per_field, size=n)
                    for f in range(NUM_FIELDS)], axis=1).astype(np.int64)
    w = rs.randn(NUM_FEATURES) * 0.7
    latent = rs.randn(NUM_FEATURES, 3)
    logit = w[ids].sum(axis=1)
    logit += np.einsum("nd,nd->n", latent[ids[:, 0]], latent[ids[:, 1]])
    label = (rs.rand(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    return ids, label.reshape(-1, 1)


def _small_split(vs, n):
    return transpiler.split_dense_variable(vs, n, min_block_size=4)


def _j_small_split(vs, n):
    return jtranspiler.split_dense_variable(vs, n, min_block_size=4)


# -- descs --------------------------------------------------------------------

class _Var:
    def __init__(self, name, shape):
        self.name = name
        self.shape = shape


@pytest.mark.parametrize("count,min_block,max_block", [
    (1, 1024, 1 << 20), (2, 1024, 1 << 20), (3, 1024, 1 << 20),
    (2, 4, 1 << 20), (4, 8, 64)])
def test_split_dense_variable_equals_jax(count, min_block, max_block):
    vs = [_Var("a", (4000,)), _Var("b", (10,)), _Var("c", (13, 1)),
          _Var("d", (1 << 21,)), _Var("e", (3, 7, 5))]
    want = jtranspiler.split_dense_variable(vs, count, min_block, max_block)
    got = transpiler.split_dense_variable(vs, count, min_block, max_block)
    assert got == want
    for v in vs:
        assert sum(s for n, _, _, s in got if n == v.name) \
            == int(np.prod(v.shape))


def _transpile_both(build, endpoints, **kw):
    """The JAX and port programs built by `build(fluid)` and transpiled
    for `endpoints`: (jax Program, port Program, jax transpiler, port
    transpiler)."""
    jmain, jstartup, _, jops, jpg = build(jfluid)
    tmain, tstartup, _, tops, tpg = build(tfluid)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    jsplit = kw.pop("jsplit", jtranspiler.split_dense_variable)
    tsplit = kw.pop("tsplit", transpiler.split_dense_variable)
    jt = jtranspiler.DistributeTranspiler().transpile(
        optimize_ops=jops, params_grads=jpg, program=jmain,
        pservers=endpoints, split_method=jsplit, **kw)
    tt = transpiler.DistributeTranspiler().transpile(
        optimize_ops=tops, params_grads=tpg, program=tmain,
        pservers=endpoints, split_method=tsplit, **kw)
    return jmain, tmain, jt, tt


@pytest.mark.parametrize("case", ["fit_a_line_sgd", "fit_a_line_momentum",
                                  "fit_a_line_adagrad", "deepfm_adam",
                                  "deepfm_adam_fused", "deepfm_sgd"])
def test_transpiled_descs_equal_jax(case):
    builds = {
        "fit_a_line_sgd": lambda f: _fit_a_line(f),
        "fit_a_line_momentum": lambda f: _fit_a_line(f, "Momentum",
                                                     momentum=0.9),
        "fit_a_line_adagrad": lambda f: _fit_a_line(f, "Adagrad"),
        "deepfm_adam": lambda f: _deepfm(f),
        "deepfm_adam_fused": lambda f: _deepfm(f, fuse_updates=True),
        "deepfm_sgd": lambda f: _deepfm(f, "SGD", 0.05),
    }
    eps = "127.0.0.1:7001,127.0.0.1:7002"
    jmain, tmain, jt, tt = _transpile_both(
        builds[case], eps, tsplit=_small_split, jsplit=_j_small_split)
    assert _norm(tmain.desc.to_dict()) == _norm(jmain.desc.to_dict())
    assert _norm(tt.param_blocks) == _norm(jt.param_blocks)
    assert tt.param_opt == jt.param_opt
    assert tt._sparse_params == jt._sparse_params
    sends = [op for op in tmain.desc.block(0).ops if op.type == "dist_send"]
    assert len(sends) == len(tt.param_blocks)
    assert not any(op.type in ("sgd", "momentum", "adagrad", "adam",
                               "fused_update")
                   for op in tmain.desc.block(0).ops)
    if case.startswith("deepfm"):
        assert tt._sparse_params == {"embedding_0.w_0", "embedding_1.w_0"}


def test_transpile_refuses_what_jax_refuses():
    _, _, _, ops, pg = _fit_a_line(tfluid, "Adamax", lr=0.01)
    main = pg[0][0].block.program
    with pytest.raises(NotImplementedError, match="sgd/momentum"):
        transpiler.DistributeTranspiler().transpile(
            ops, pg, program=main, pservers="127.0.0.1:7001")

    def gap(vs, n):
        return [(v.name, 0, 0, max(1, int(np.prod(v.shape)) - 1))
                for v in vs]

    main, _, _, ops, pg = _fit_a_line(tfluid)
    with pytest.raises(ValueError, match="covers"):
        transpiler.DistributeTranspiler().transpile(
            ops, pg, program=main, pservers="127.0.0.1:7001",
            split_method=gap)


def test_lr_decay_warning():
    """An op writing the optimizer's LR var means the pserver's
    snapshotted LR goes stale: transpile warns, as the JAX package's
    does (tests/test_distribute_transpiler.py)."""
    main, _, _, ops, pg = _fit_a_line(tfluid)
    block = main.global_block()
    lr_name = ops[0].desc.input("LearningRate")[0]
    block.append_op(type="scale", inputs={"X": [block.var(lr_name)]},
                    outputs={"Out": [block.var(lr_name)]},
                    attrs={"scale": 0.9}, infer_shape=False)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        transpiler.DistributeTranspiler().transpile(
            ops, pg, program=main, pservers="127.0.0.1:6174")
    assert any("learning-rate" in str(w.message) for w in rec)
    # a constant LR warns nothing
    main, _, _, ops, pg = _fit_a_line(tfluid)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        transpiler.DistributeTranspiler().transpile(
            ops, pg, program=main, pservers="127.0.0.1:6174")
    assert not any("learning-rate" in str(w.message) for w in rec)


# -- training through the servers ---------------------------------------------

def _train_both(servers, build, feeds, n_servers=2, **kw):
    """Train `feeds` through both packages' transpiled programs, each on
    its own `n_servers` pservers, from the JAX startup state: (jax
    losses, jax state, port losses, port scope, jax servers, port
    servers)."""
    jsrv = servers(jnative, n_servers, num_trainers=1, sync=True)
    tsrv = servers(native, n_servers, num_trainers=1, sync=True)
    jmain, jstartup, jloss, jops, jpg = build(jfluid)
    tmain, tstartup, tloss, tops, tpg = build(tfluid)
    jt = jtranspiler.DistributeTranspiler().transpile(
        optimize_ops=jops, params_grads=jpg, program=jmain,
        pservers=_endpoints(jsrv), split_method=kw.get("jsplit",
                                                       _j_small_split))
    tt = transpiler.DistributeTranspiler().transpile(
        optimize_ops=tops, params_grads=tpg, program=tmain,
        pservers=_endpoints(tsrv), split_method=kw.get("tsplit",
                                                       _small_split))
    persist = [n for n, v in jmain.desc.block(0).vars.items()
               if v.persistable]
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        init = {n: np.array(jscope.get(n)) for n in persist
                if jscope.get(n) is not None}
        jt.init_pservers(jscope)
        jlosses = [float(np.asarray(jexe.run(jmain, feed=f,
                                             fetch_list=[jloss])[0])
                         .reshape(-1)[0]) for f in feeds]
        jstate = {n: np.array(jscope.get(n)) for n in init}
    tscope = tfluid.Scope()
    tio.params_from_numpy(tscope, {n: a.copy() for n, a in init.items()},
                          "cpu")
    tt.init_pservers(tscope)
    texe = tfluid.Executor(CPU)
    tlosses = [float(texe.run(tmain, feed=f, fetch_list=[tloss],
                              scope=tscope)[0].reshape(-1)[0])
               for f in feeds]
    return jlosses, jstate, tlosses, tscope, jsrv, tsrv, tt


def _assert_state(jstate, tscope, names):
    for n in names:
        want = jstate[n]
        got = tscope.get(n).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, n
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=TRAIN_ATOL * max(1.0, float(np.abs(want).max())),
            err_msg=n)


def test_fit_a_line_through_pservers_matches_jax(servers):
    rs = np.random.RandomState(0)
    xs = rs.randn(6, 20, 13).astype(np.float32)
    feeds = [{"x": x, "y": (x[:, :1] * 2.0 - 1.0).astype(np.float32)}
             for x in xs]
    jl, js, tl, ts, jsrv, tsrv, tt = _train_both(
        servers, lambda f: _fit_a_line(f, lr=0.05), feeds)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=TRAIN_ATOL)
    assert tl[-1] < tl[0]
    _assert_state(js, ts, tt.param_blocks)
    # both servers served blocks, the same number of rounds each side
    assert [s.num_updates() for s in tsrv] == \
        [s.num_updates() for s in jsrv]
    assert all(s.num_updates() > 0 for s in tsrv)


def test_deepfm_through_pservers_matches_jax(servers):
    """3 Adam steps at batch 64 through two servers: losses, every
    parameter, and the sparse rows applied (one per id a step and
    table, exactly the JAX package's count on each server)."""
    steps, batch = 3, 64
    ids, label = _ctr_data(batch * steps, seed=1)
    feeds = [{"ids": ids[k::steps], "label": label[k::steps]}
             for k in range(steps)]
    jl, js, tl, ts, jsrv, tsrv, tt = _train_both(
        servers, lambda f: _deepfm(f), feeds)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=TRAIN_ATOL)
    _assert_state(js, ts, tt.param_blocks)
    rows = [s.num_sparse_rows() for s in tsrv]
    assert rows == [s.num_sparse_rows() for s in jsrv]
    assert sum(rows) == steps * batch * NUM_FIELDS * 2
    assert [s.num_updates() for s in tsrv] == \
        [s.num_updates() for s in jsrv]


def test_deepfm_pserver_end_to_end_criterion(servers):
    """tests/test_ctr_deepfm.py::test_deepfm_sparse_pserver_end_to_end on
    the port: 40 Adam steps at lr 0.02 on one batch of 128 through two
    servers take the loss below 0.8 of the first, with the rows shipped
    sparse and both servers updating."""
    tsrv = servers(native, 2, num_trainers=1, sync=True)
    main, startup, loss, ops, pg = _deepfm(tfluid, lr=0.02)
    t = transpiler.DistributeTranspiler().transpile(
        ops, pg, program=main, pservers=_endpoints(tsrv))
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    t.init_pservers(scope)
    ids, label = _ctr_data(128, seed=0)
    feed = {"ids": ids, "label": label}
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0].reshape(-1)[0])
              for _ in range(40)]
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])
    assert sum(s.num_sparse_rows() for s in tsrv) >= 40 * 128 * NUM_FIELDS
    assert all(s.num_updates() > 0 for s in tsrv)


def test_init_pservers_keeps_device_and_dtype(servers):
    tsrv = servers(native, 1, num_trainers=1, sync=True)
    main, startup, _, ops, pg = _fit_a_line(tfluid)
    tt = transpiler.DistributeTranspiler().transpile(
        ops, pg, program=main, pservers=_endpoints(tsrv))
    scope = tfluid.Scope()
    tfluid.Executor(CPU).run(startup, scope=scope)
    w = scope.get("fc_0.w_0")
    scope.set("fc_0.w_0", w.to(torch.float64))
    tt.init_pservers(scope)
    got = scope.get("fc_0.w_0")
    assert got.dtype == torch.float64 and got.device == w.device
    np.testing.assert_array_equal(got.numpy(), w.numpy().astype(np.float64))


def test_chip_smoke_pserver_loop_on_the_cpu():
    """chip_smoke.py's phase 17a loop (the example's program, reader and
    DataFeeder through two fresh servers) on the CPU for 2 steps: every
    id of a step sends one row to each table's server, and the bytes it
    counts a step match the rows and blocks it ships."""
    import chip_smoke

    main, startup, _, _, _ = chip_smoke.build_ctr(chip_smoke.CTR_FEATURES)
    scope = tfluid.Scope()
    tfluid.Executor(CPU).run(startup, scope=scope)
    init = {n: scope.get(n).numpy()
            for n, v in main.desc.block(0).vars.items() if v.persistable}
    reader = chip_smoke.ctr_reader(chip_smoke.CTR_FEATURES)
    batches = [next(reader) for _ in range(2)]
    losses, rows = chip_smoke.ps_loop("test", CPU, init, batches)
    assert np.isfinite(losses).all()
    assert sum(rows) == 2 * chip_smoke.CTR_BATCH * chip_smoke.CTR_FIELDS * 2
    ids = batches[0][0]
    u = len(np.unique(ids))
    blocks = {"t": [("e", 0, 40)], "d": [("e", 0, 6), ("f", 6, 4)]}
    out, back = chip_smoke.ps_bytes(batches[0], blocks, {"t"}, {"t": 4})
    assert out == 4 * 10 + 4 * ids.size * 5 + 4 * u
    assert back == 4 * 10 + 4 * u * 4


# -- dist_send's sparse path at the edges ----------------------------------

def _run_send(pkg_native, pool, op_kernel, table, rows, values, port,
              to_value):
    c = pool.get("127.0.0.1:%d" % port)
    c.init_param("t@0", table, opt_kind=pkg_native.OPT_SGD, lr=1.0)
    return op_kernel(None, {"Param": [to_value(table)],
                            "Grad": [values]},
                     {"param_name": "t", "blocks": [
                         ("127.0.0.1:%d" % port, 0, table.size)]})


@pytest.mark.parametrize("ids", [[1, 3, 3, -1], [2, -3, 7, 0], [4, 9]],
                         ids=["negative", "negative_beside_twin",
                              "outside"])
def test_sparse_send_edges_match_jax(servers, ids):
    """One SGD row update at lr 1 with ids that repeat, are negative, or
    fall outside the 8-row table: the port's table equals the JAX op's,
    the servers' rows agree, or both raise IndexError."""
    import jax.numpy as jnp
    from paddle_tpu.core.ragged import SelectedRows as JRows
    from paddle_tpu.ops.dist import dist_send as j_send
    from paddle_tpu_torch.core.ragged import SelectedRows as TRows
    from paddle_tpu_torch.ops.dist import dist_send as t_send

    (jsrv,) = servers(jnative, 1)
    (tsrv,) = servers(native, 1)
    rs = np.random.RandomState(3)
    table = rs.randn(8, 3).astype(np.float32)
    rows = np.array(ids, np.int32)
    vals = rs.randn(len(ids), 3).astype(np.float32)
    outs = {}
    for name, pkg, pool, kernel, grad, to_value in (
            ("jax", jnative, JClientPool, j_send,
             JRows(jnp.asarray(rows), jnp.asarray(vals), 8), jnp.asarray),
            ("port", native, ClientPool, t_send,
             TRows(torch.from_numpy(rows), torch.from_numpy(vals), 8),
             torch.from_numpy)):
        port = (jsrv if name == "jax" else tsrv).port
        try:
            out = _run_send(pkg, pool, kernel, table, rows, grad, port,
                            to_value)
            outs[name] = np.asarray(out["ParamOut"][0])
        except IndexError as err:
            outs[name] = "IndexError: " + str(err).split(": ")[-1]
        outs[name + "_server"] = pool.get(
            "127.0.0.1:%d" % port).get_param("t@0", table.size)
    if isinstance(outs["jax"], str):
        assert isinstance(outs["port"], str), outs["port"]
        assert outs["port"].endswith(outs["jax"].split("IndexError: ")[-1])
    else:
        np.testing.assert_array_equal(outs["port"], outs["jax"])
    np.testing.assert_array_equal(outs["port_server"], outs["jax_server"])
    assert tsrv.num_sparse_rows() == jsrv.num_sparse_rows()


@pytest.mark.parametrize("sections", [[4, 4], [3, 2, 3], [8], [1, 7]])
def test_split_selected_rows_matches_jax(sections):
    """Each section's SelectedRows against the JAX kernel's, exactly:
    rows in range rebased, every other row at 0 with zero values (ids
    on a section's edges, repeated, negative and past the height)."""
    import jax.numpy as jnp
    from paddle_tpu.core.ragged import SelectedRows as JRows
    from paddle_tpu.ops.registry import get_op_info as j_info
    from paddle_tpu_torch.core.ragged import SelectedRows as TRows
    from paddle_tpu_torch.ops.registry import get_op_info as t_info

    rows = np.array([1, 5, 0, 7, 3, 4, 3, -1, 8, 2], np.int32)
    vals = np.random.RandomState(0).randn(rows.size, 3).astype(np.float32)
    attrs = {"height_sections": sections}
    want = j_info("split_selected_rows").kernel(
        None, {"X": [JRows(jnp.asarray(rows), jnp.asarray(vals), 8)]},
        attrs)["Out"]
    got = t_info("split_selected_rows").kernel(
        None, {"X": [TRows(torch.from_numpy(rows), torch.from_numpy(vals),
                           8)]}, attrs)["Out"]
    assert len(got) == len(want) == len(sections)
    for g, w, h in zip(got, want, sections):
        assert g.height == w.height == h
        assert g.rows.dtype == torch.int32
        np.testing.assert_array_equal(g.rows.numpy(), np.asarray(w.rows))
        np.testing.assert_array_equal(g.values.numpy(),
                                      np.asarray(w.values))


# -- async --------------------------------------------------------------------

def test_async_sgd_convergence_and_staleness(servers):
    """tests/test_distribute_transpiler.py's async case on the port:
    gradients apply at once with no barrier, training converges, and a
    client 5 versions behind has its gradient discarded, then
    resynchronizes."""
    (server,) = servers(native, 1, num_trainers=2, sync=False,
                        async_lagged_threshold=4)
    endpoint = "127.0.0.1:%d" % server.port
    main, startup, cost, ops, pg = _fit_a_line(tfluid)
    t = transpiler.DistributeTranspiler().transpile(
        ops, pg, program=main, pservers=endpoint, trainers=2,
        sync_mode=False)
    assert t.sync is False
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    t.init_pservers(scope)
    block = main.global_block()
    feeder = tfluid.DataFeeder(place=CPU, feed_list=[block.var("x"),
                                                     block.var("y")])
    reader = tpaddle.batch(tpaddle.dataset.uci_housing.train(),
                           batch_size=20)
    losses = [float(exe.run(main, feed=feeder.feed(d), fetch_list=[cost],
                            scope=scope)[0].reshape(-1)[0])
              for _ in range(4) for d in reader()]
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    assert server.num_updates() > 0 and server.num_lagged() == 0

    pname = next(iter(t.param_blocks))
    _ep, begin, size = t.param_blocks[pname][0]
    bname = "%s@%d" % (pname, begin)
    lagger = native.PServerClient("127.0.0.1", server.port)
    fresh = native.PServerClient("127.0.0.1", server.port)
    try:
        lagger.get_param(bname, size)
        fresh.get_param(bname, size)
        for _ in range(5):
            fresh.send_grad(bname, np.zeros(size, np.float32))
        lagger.send_grad(bname, np.zeros(size, np.float32))
        assert not lagger.last_grad_applied
        assert server.num_lagged() >= 1
        lagger.send_grad(bname, np.zeros(size, np.float32))
        assert lagger.last_grad_applied
    finally:
        lagger.close()
        fresh.close()


# -- the launcher ------------------------------------------------------------

_TRAINER = r'''
import os, sys
import numpy as np
import paddle_tpu_torch as paddle
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.distributed import (DistributeTranspiler,
                                          discover_pservers)
from paddle_tpu_torch.ops.dist import ClientPool

x = fluid.layers.data(name="x", shape=[13], dtype="float32")
y_predict = fluid.layers.fc(input=x, size=1, act=None)
y = fluid.layers.data(name="y", shape=[1], dtype="float32")
cost = fluid.layers.mean(
    x=fluid.layers.square_error_cost(input=y_predict, label=y))
ops, pg = fluid.optimizer.SGD(learning_rate=0.01).minimize(cost)
pservers = os.environ.get("PSERVERS") or ",".join(discover_pservers(
    timeout=60))
t = DistributeTranspiler()
t.transpile(ops, pg, trainer_id=int(os.environ["TRAINER_ID"]),
            pservers=pservers, trainers=int(os.environ["TRAINERS"]),
            sync=os.environ["PADDLE_SYNC"] == "1")
place = fluid.CPUPlace()
exe = fluid.Executor(place)
exe.run(fluid.default_startup_program())
t.init_pservers()
feeder = fluid.DataFeeder(place=place, feed_list=[x, y])
reader = paddle.batch(paddle.dataset.uci_housing.train(), batch_size=20)
losses = [float(exe.run(feed=feeder.feed(d), fetch_list=[cost])[0]
                .reshape(-1)[0]) for _ in range(2) for d in reader()]
out = os.path.join(os.environ["OUT_DIR"],
                   "trainer%s.npz" % os.environ["TRAINER_ID"])
np.savez(out, **{n: fluid.global_scope().get(n).numpy()
                 for n in t.param_blocks})
ClientPool.reset()
sys.exit(0 if losses[-1] < losses[0] else 1)
'''


def _free_port():
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _launch_and_check(tmp_path, elastic):
    script = tmp_path / "trainer.py"
    script.write_text(_TRAINER)
    env = {"PYTHONPATH": ROOT, "OUT_DIR": str(tmp_path)}
    pservers = ["127.0.0.1:%d" % _free_port() for _ in range(2)]
    ps, tr, master = cluster_launch.launch(
        [str(script)], pservers, trainers=2, sync=True, env=env,
        elastic=elastic)
    try:
        rcs = [p.wait(timeout=TIMEOUT_S) for p in tr]
    finally:
        for p in tr:
            if p.poll() is None:
                p.kill()
        for p in ps:
            p.terminate()
        for p in ps:
            p.wait(timeout=30)
            p.stdout.close()
        if master is not None:
            master.stop()
    assert rcs == [0, 0]
    a = np.load(tmp_path / "trainer0.npz")
    b = np.load(tmp_path / "trainer1.npz")
    assert sorted(a.files) == sorted(b.files) and len(a.files) == 2
    for n in a.files:
        np.testing.assert_array_equal(a[n], b[n])
    return master


def test_launcher_roles_as_processes(tmp_path):
    """examples/dist_pserver_fit_a_line.py's flow through the port's
    launcher: 2 pserver processes, 2 trainer processes in sync mode;
    both trainers exit 0 with bit-equal parameters."""
    assert _launch_and_check(tmp_path, elastic=False) is None


def test_launcher_elastic(tmp_path):
    """The elastic form: a master, each pserver on a free port claiming
    a slot with a lease, trainers discovering them."""
    assert _launch_and_check(tmp_path, elastic=True) is not None


def test_launcher_main_rejects_bad_arguments():
    for argv in ([], ["x.py"], ["--pservers=a:1", "--hosts=h", "x.py"],
                 ["--hosts=h", "--elastic", "x.py"]):
        with pytest.raises(SystemExit):
            cluster_launch.main(argv)


def test_launcher_reports_a_pserver_that_fails(tmp_path):
    """A pserver that dies before it is ready fails the launch (its
    port is taken)."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        sk.listen(1)
        taken = "127.0.0.1:%d" % sk.getsockname()[1]
        try:
            ps, tr, _ = cluster_launch.launch(["unused.py"], [taken],
                                              trainers=1,
                                              env={"PYTHONPATH": ROOT})
        except RuntimeError as err:
            assert "failed to start" in str(err)
        else:
            for p in ps + tr:
                p.kill()
                p.wait(timeout=30)
            pytest.fail("a pserver on a taken port reported ready")


# -- the elastic registry -----------------------------------------------------

TTL_MS = 300


def test_lease_register_expire_rediscover():
    master = native.Master()
    try:
        reg = distributed.ElasticRegistry("127.0.0.1", master.port)
        slot_a, lease_a = reg.register_pserver("h1:1", 2, ttl_ms=TTL_MS)
        slot_b, lease_b = reg.register_pserver("h2:2", 2, ttl_ms=TTL_MS)
        assert {slot_a, slot_b} == {0, 1}
        with pytest.raises(TimeoutError):
            reg.register_pserver("h3:3", 2, ttl_ms=TTL_MS, timeout=0.3)
        assert reg.wait_for_pservers(2, timeout=5) == ["h1:1", "h2:2"]
        assert distributed.discover_pservers(
            2, timeout=5, master="127.0.0.1:%d" % master.port) \
            == ["h1:1", "h2:2"]
        time.sleep(TTL_MS / 1000.0 * 3)
        assert len(reg.pservers()) == 2
        assert not lease_a.lapsed
        lease_a._stop.set()
        lease_a._thread.join(timeout=5)
        assert not lease_a._thread.is_alive()
        deadline = time.time() + 5
        while len(reg.pservers()) != 1 and time.time() < deadline:
            time.sleep(0.05)
        assert reg.pservers() == {slot_b: "h2:2"}
        slot_c, lease_c = reg.register_pserver("h4:4", 2, ttl_ms=TTL_MS)
        assert slot_c == slot_a
        assert sorted(reg.pservers().values()) == ["h2:2", "h4:4"]
        lease_b.release()
        lease_c.release()
        reg.close()
    finally:
        master.stop()


def test_kill_pserver_and_recover_training(servers):
    """tests/test_elastic_coordination.py's drill on the port: the
    trainer discovers two pservers through the registry, one dies
    mid-training, a replacement restores its shard from checkpoint and
    claims the slot, the trainer rediscovers and training goes on
    converging."""
    master = native.Master()
    srv = servers(native, 2, num_trainers=1, sync=True)
    reg = distributed.ElasticRegistry("127.0.0.1", master.port)
    leases = {}
    try:
        for s in srv:
            slot, lease = reg.register_pserver("127.0.0.1:%d" % s.port, 2,
                                               ttl_ms=TTL_MS)
            leases[slot] = lease
        endpoints = reg.wait_for_pservers(2, timeout=10)
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
            pred = tfluid.layers.fc(input=x, size=1, act=None)
            y = tfluid.layers.data(name="y", shape=[1], dtype="float32")
            cost = tfluid.layers.mean(
                x=tfluid.layers.square_error_cost(input=pred, label=y))
            ops, pg = tfluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
        t = transpiler.DistributeTranspiler().transpile(
            ops, pg, program=main, pservers=",".join(endpoints),
            split_method=lambda vs, n: transpiler.split_dense_variable(
                vs, n, min_block_size=2))
        scope = tfluid.Scope()
        exe = tfluid.Executor(CPU)
        exe.run(startup, scope=scope)
        t.init_pservers(scope)
        rs = np.random.RandomState(0)
        xs = rs.rand(32, 4).astype(np.float32)
        ys = (xs @ np.array([1.0, -2.0, 0.5, 3.0], np.float32)
              ).reshape(-1, 1)
        feed = {"x": xs, "y": ys}

        def steps(n):
            return [float(exe.run(main, feed=feed, fetch_list=[cost],
                                  scope=scope)[0].reshape(-1)[0])
                    for _ in range(n)]

        losses = steps(10)
        ckpt = os.path.join(tempfile.mkdtemp(), "ps0.ckpt")
        assert srv[0].save(ckpt) == 0
        dead = "127.0.0.1:%d" % srv[0].port
        leases[0]._stop.set()
        srv[0].stop()
        ClientPool.reset()
        deadline = time.time() + 5
        while len(reg.pservers()) != 1 and time.time() < deadline:
            time.sleep(0.05)
        (replacement,) = servers(native, 1, num_trainers=1, sync=True)
        assert replacement.load(ckpt) == 0
        slot, lease = reg.register_pserver(
            "127.0.0.1:%d" % replacement.port, 2, ttl_ms=TTL_MS)
        assert slot == 0
        leases[0] = lease
        new_endpoints = reg.wait_for_pservers(2, timeout=10)
        assert dead not in new_endpoints
        remap = {dead: "127.0.0.1:%d" % replacement.port}
        for op in main.desc.block(0).ops:
            if op.type == "dist_send":
                op.attrs["blocks"] = [(remap.get(ep, ep), b, s)
                                      for ep, b, s in op.attrs["blocks"]]
        losses += steps(10)
        assert losses[-1] < losses[9], (losses[9], losses[-1])
        assert losses[-1] < losses[0]
        assert replacement.num_updates() > 0
    finally:
        for lease in leases.values():
            lease._stop.set()
        reg.close()
        master.stop()


def test_waiting_names_raise_naming_their_item():
    # the fleet reporter came with obs/fleet.py: opt-in, nothing to
    # start or stop without a master (the JAX functions' None)
    assert coordinator.start_fleet_reporter() is None
    assert coordinator.stop_fleet_reporter() is None
    # the mesh entry points came with the parallel package: a single
    # process with nothing set starts no group (as jax.distributed is
    # left alone there), and a CUDA mesh without a device raises
    assert coordinator.init_multihost() is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            coordinator.global_mesh()

    class _Gone:
        port = 1   # no master listens: the view says so, never raises

    out = io.StringIO()
    assert cluster_launch.print_fleet_view(_Gone(), out=out) is None
    assert "fleet view unavailable" in out.getvalue()
    assert coordinator.process_count() == 1
    assert coordinator.process_index() == 0
    jall = set(__import__("paddle_tpu.distributed",
                          fromlist=["__all__"]).__all__)
    assert set(distributed.__all__) == jall


# -- the verifier -------------------------------------------------------------

def _broken(fluid):
    """fit-a-line's main program with an unknown op, an undeclared var
    and a read before its definition."""
    from paddle_tpu.core.desc import OpDesc as JOpDesc
    from paddle_tpu_torch.core.desc import OpDesc as TOpDesc

    main, _, _, _, _ = _fit_a_line(fluid)
    OpDesc = JOpDesc if fluid is jfluid else TOpDesc
    ops = main.desc.block(0).ops
    ops.insert(0, OpDesc("scale", {"X": [ops[2].output_names()[0]]},
                         {"Out": ["nowhere"]}, {"scale": 2.0}))
    ops.append(OpDesc("no_such_op", {"X": ["x"]}, {"Out": ["x"]},
                      {"bad": object()}))
    return main


@pytest.mark.parametrize("level", ["structural", "full"])
def test_verifier_matches_jax(level):
    from paddle_tpu import analysis as janalysis

    for build in (lambda f: _fit_a_line(f)[0], lambda f: _deepfm(f)[0],
                  _broken):
        want = janalysis.verify_program(build(jfluid), level=level)
        got = analysis.verify_program(build(tfluid), level=level)
        assert [(d.code, d.severity, d.op_index, d.op_type, d.var_name)
                for d in got.sorted()] == \
            [(d.code, d.severity, d.op_index, d.op_type, d.var_name)
             for d in want.sorted()]
    got = analysis.verify_program(_broken(tfluid))
    assert not got.ok() and got.has("V001") and got.has("V002") \
        and got.has("V003") and got.has("V008")
    with pytest.raises(analysis.ProgramVerificationError, match="V00"):
        got.raise_on_error()
    assert analysis.verify_program(_broken(tfluid), suppress=(
        "V001", "V002", "V003", "V008")).ok()
