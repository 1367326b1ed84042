"""The port's ParallelTrainer at 4 gloo ranks against the JAX package's on
a 4-device mesh, and against the port at world size 1.

The JAX side runs here, on `make_mesh(n_devices=4, ...)` over the
virtual CPU devices; its initial state moves to the ranks as numpy
arrays (`params_from_numpy`, then `load_state_from`).  The port's side
runs in 4 gloo ranks spawned once for the file (`torch_ranks`), each
building its program through the port's layers.  Tolerances are
`tests/test_parallel_trainer.py`'s: losses at rtol 2e-5 and atol 1e-6,
params at rtol 2e-4 and atol 1e-5.

- The JAX test's MLP (4 Momentum steps) at dp 4, dp 2 x mp 2, ZeRO-1 at
  dp 4 and ZeRO-1 with mp 2; the accumulators ZeRO-1 should shard are
  `Shard` on dp, and the mp-sized fc weight `Shard` on mp.
- A conv + batch_norm program at dp 4 equals the single-device step,
  statistics included (the global-batch contract: a data-parallel port
  whose ranks normalise their own shards would fail it).
- `get_places` at 4 ranks counts the mesh; in one process its output
  has the JAX op's shape and dtype.
- `ParallelDo` equals inline execution, as on the JAX side.
- The step captured (the default) against the uncaptured one at dp 2 x
  mp 2 with ZeRO-1, from the JAX run's state: bit for bit, under
  FLAGS_donation=off too; the captured step's state keeps its storage
  (donated), the others' moves; one capture, replays after it; and the
  JAX trainer's result within the tolerances.
- At world size 1 in this process: the captured step against the
  uncaptured one and the JAX trainer; a new feed shape captures anew;
  `donate_state=False`; a dropout program's losses captured and
  uncaptured; a capture that fails raises naming the step and the op.
- At world size 1 in this process: the MLP through ParallelTrainer
  equals the plain Executor, and `TrainingSupervisor.for_parallel`
  snapshots and restores the trainer's state, the resumed run's params
  equal to an unbroken run's; the step's telemetry (the `parallel`
  step's counters and the numerics monitor's records, as the JAX
  step's); `sharding_plan` against the JAX trainer's and
  `FLAGS_verify_sharding` rejecting a bad feed spec before the startup
  program runs, with the JAX gate's error.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.parallel import ParallelTrainer as JTrainer
from paddle_tpu.parallel import make_mesh as jmake_mesh

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.parallel import ParallelTrainer, make_mesh
from paddle_tpu_torch.parallel.sharding import is_optimizer_state

import torch_parallel_cases as cases
from torch_ranks import CaseFailed, run_cases

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=2e-5, atol=1e-6)
PARAM_TOL = dict(rtol=2e-4, atol=1e-5)
STEPS = 4
CONFIGS = {
    "dp4": ({}, 0),
    "dp2_mp2": ({"mp": 2}, 0),
    "zero1_dp4": ({}, 1),
    "zero1_dp2_mp2": ({"mp": 2}, 1),
}


def _jax_run(build, feeds_fn, feed_names, mesh_kw, steps, zero_stage=0):
    """(initial state, losses, final state) of the JAX trainer on a
    4-device mesh."""
    main, startup, avg = build(jfluid)
    tr = JTrainer(main, startup, feed_names=feed_names,
                  fetch_names=[avg.name],
                  mesh=jmake_mesh(n_devices=4, **mesh_kw),
                  zero_stage=zero_stage).init()
    init = {n: np.array(v) for n, v in tr.state.items()}
    losses = [float(np.asarray(tr.step(feeds_fn(i))[0]).reshape(-1)[0])
              for i in range(steps)]
    return init, losses, {n: np.asarray(v) for n, v in tr.state.items()}


@pytest.fixture(scope="module")
def jax_runs():
    runs = {name: _jax_run(cases.build_mlp, cases.mlp_feeds,
                           ["x", "label"], mesh_kw, STEPS, zero)
            for name, (mesh_kw, zero) in CONFIGS.items()}
    runs["conv_bn"] = _jax_run(cases.build_conv_bn, cases.conv_bn_feeds,
                               ["img", "label"], {}, 2)
    return runs


@pytest.fixture(scope="module")
def ranks(jax_runs, tmp_path_factory):
    """Every rank-side case of this file, in one spawn of 4 ranks."""
    todo = {}
    for name, (mesh_kw, zero) in CONFIGS.items():
        todo[name] = (cases.train, (
            cases.build_mlp, cases.mlp_feeds, ["x", "label"], mesh_kw,
            jax_runs[name][0], STEPS, zero))
    todo["conv_bn"] = (cases.train, (
        cases.build_conv_bn, cases.conv_bn_feeds, ["img", "label"], {},
        jax_runs["conv_bn"][0], 2))
    todo["places"] = (cases.place_count, ({"mp": 2},))
    todo["capture_pair"] = (cases.capture_pair, (
        cases.build_mlp, cases.mlp_feeds, ["x", "label"], {"mp": 2},
        jax_runs["zero1_dp2_mp2"][0], STEPS, 1))
    return run_cases(todo, 4, tmp_path_factory.mktemp("ranks"))


def _result(ranks, name):
    got = ranks[name]
    if isinstance(got, CaseFailed):
        pytest.fail("rank-side case %s raised:\n%s" % (name, got))
    return got


def _assert_parity(losses_a, state_a, losses_b, state_b):
    np.testing.assert_allclose(losses_a, losses_b, **LOSS_TOL)
    assert state_a.keys() == state_b.keys()
    for n in state_a:
        np.testing.assert_allclose(state_a[n], state_b[n], err_msg=n,
                                   **PARAM_TOL)


@pytest.fixture(scope="module")
def world_one(jax_runs):
    """The MLP through ParallelTrainer at world size 1 in this process,
    from each configuration's initial state (the world-1 run the JAX
    test holds every mesh against)."""
    runs = {name: cases.train(0, cases.build_mlp, cases.mlp_feeds,
                              ["x", "label"], {}, jax_runs[name][0], STEPS)
            for name in CONFIGS}
    runs["conv_bn"] = cases.train(0, cases.build_conv_bn,
                                  cases.conv_bn_feeds, ["img", "label"], {},
                                  jax_runs["conv_bn"][0], 2)
    yield runs
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mlp_at_4_ranks_matches_jax(name, ranks, jax_runs):
    losses, state, _ = _result(ranks, name)
    _, jlosses, jstate = jax_runs[name]
    assert all(np.isfinite(losses))
    _assert_parity(losses, state, jlosses, jstate)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mlp_at_4_ranks_matches_world_one(name, ranks, world_one):
    losses, state, _ = _result(ranks, name)
    _assert_parity(losses, state, *world_one[name][:2])


def test_layouts_are_the_specs(ranks):
    """ZeRO-1's accumulators shard over dp (the shape-[4] bias velocity
    at dp 4 too: 4 divides it), the dp-only mesh's params replicate, and
    the (8, 1024) fc weight shards over mp."""
    _, _, dp4 = _result(ranks, "dp4")
    assert all(p == ["Replicate()", "Replicate()"] for p in dp4.values())
    _, _, z1 = _result(ranks, "zero1_dp4")
    accs = [n for n in z1 if is_optimizer_state(n)]
    assert accs and all(z1[n][0].startswith("Shard(") for n in accs), z1
    assert all(z1[n][0] == "Replicate()" for n in z1
               if not is_optimizer_state(n))
    _, _, mp = _result(ranks, "zero1_dp2_mp2")
    assert mp["fc_0.w_0"] == ["Replicate()", "Shard(dim=1)"]
    assert mp["fc_0.w_0_velocity_0"] == ["Shard(dim=0)", "Shard(dim=1)"]


def test_conv_batch_norm_step_is_the_global_batch_step(ranks, jax_runs,
                                                       world_one):
    losses, state, _ = _result(ranks, "conv_bn")
    _, jlosses, jstate = jax_runs["conv_bn"]
    _assert_parity(losses, state, jlosses, jstate)
    _assert_parity(losses, state, *world_one["conv_bn"][:2])
    # the running statistics moved with the whole batch's mean
    mean = [n for n in state if n.endswith(".w_1") and
            state[n].shape == (4,) and "batch_norm" in n]
    assert mean and np.abs(state[mean[0]]).max() > 0.1


def test_get_places_counts_the_mesh(ranks):
    out = _result(ranks, "places")
    np.testing.assert_array_equal(out, np.arange(4, dtype=np.int32))


def test_get_places_has_the_jax_ops_shape_and_dtype():
    from paddle_tpu.ops.registry import get_op_info as jop

    jout = np.asarray(jop("get_places").kernel(None, {},
                                               {"device_count": 1})["Out"][0])
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        places = tfluid.layers.get_places(device_count=1)
    out, = tfluid.Executor(tfluid.CPUPlace()).run(main,
                                                  fetch_list=[places])
    assert out.shape == jout.shape and out.dtype == jout.dtype
    np.testing.assert_array_equal(out, jout)
    jmain, jstartup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(jmain, jstartup):
        jfluid.layers.get_places(device_count=1)
    assert [op.type for op in main.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]


def test_parallel_do_shim_matches_plain_execution():
    """ParallelDo runs its block once on the global batch."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        pd = tfluid.layers.ParallelDo(places=None)
        with pd.do():
            xi = pd.read_input(x)
            pd.write_output(tfluid.layers.scale(x=xi, scale=3.0))
        out = pd()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    xs = np.arange(8, dtype=np.float32).reshape(2, 4)
    res, = exe.run(main, feed={"x": xs}, fetch_list=[out])
    np.testing.assert_allclose(res, xs * 3.0, rtol=1e-6)


def test_world_one_trainer_equals_the_executor(jax_runs, world_one):
    """ParallelTrainer over a world of one rank is the plain executor's
    training, from the same state."""
    init = jax_runs["dp4"][0]
    main, startup, avg = cases.build_mlp()
    scope = tfluid.Scope()
    tfluid.io.params_from_numpy(scope, init, "cpu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses = [float(exe.run(main, feed=cases.mlp_feeds(i), fetch_list=[avg],
                            scope=scope)[0].reshape(-1)[0])
              for i in range(STEPS)]
    state = {n: scope.get(n).numpy() for n in init}
    wlosses, wstate, _ = world_one["dp4"]
    np.testing.assert_allclose(wlosses, losses, rtol=0, atol=1e-6)
    for n in state:
        np.testing.assert_allclose(wstate[n], state[n], rtol=0, atol=1e-6,
                                   err_msg=n)


def test_for_parallel_snapshots_and_restores(tmp_path, world_one):
    """Supervised run_parallel at world 1: interrupted after a snapshot
    and resumed by a new supervisor into a fresh trainer, it ends where
    an unbroken run ends."""
    from paddle_tpu_torch.resilience.supervisor import TrainingSupervisor

    feeds = [cases.mlp_feeds(i) for i in range(6)]
    mesh = make_mesh(device="cpu")

    def trainer():
        main, startup, avg = cases.build_mlp()
        return ParallelTrainer(main, startup, ["x", "label"], [avg.name],
                               mesh).init()

    unbroken = trainer()
    for f in feeds:
        unbroken.step(f)

    def reader_of(batches):
        return lambda: iter(batches)

    class Cut(Exception):
        pass

    class CutAt:
        """The trainer, stopped by an error at its `at`-th step."""

        def __init__(self, trainer, at):
            self.trainer, self.at, self.n = trainer, at, 0

        def step(self, data):
            self.n += 1
            if self.n == self.at:
                raise Cut()
            return self.trainer.step(data)

    first = trainer()
    sup = TrainingSupervisor.for_parallel(first, str(tmp_path / "ck"),
                                          steps_per_checkpoint=3)
    assert sup.place.device() == torch.device("cpu")
    with pytest.raises(Cut):
        sup.run_parallel(CutAt(first, 5), reader_of(feeds))
    # a new trainer (its own startup: other weights) resumes from the
    # snapshot of step 3, skips the 3 batches it consumed and runs 3
    second = trainer()
    sup2 = TrainingSupervisor.for_parallel(second, str(tmp_path / "ck"),
                                           steps_per_checkpoint=3)
    out = sup2.run_parallel(second, reader_of(feeds))
    assert out["steps"] == 6
    for n in unbroken.state:
        np.testing.assert_allclose(second.fetch_state(n),
                                   unbroken.fetch_state(n), rtol=0,
                                   atol=1e-6, err_msg=n)


def test_step_telemetry_and_the_numerics_monitor(world_one):
    """The step counts as a `parallel` trainer step with its examples,
    and under obs.health the monitor's extra fetches are recorded and
    left out of the step's fetches, as on the JAX side."""
    from paddle_tpu_torch.obs import health, registry, telemetry

    registry.reset_registry()
    mesh = make_mesh(device="cpu")
    main, startup, avg = cases.build_mlp()
    tr = ParallelTrainer(main, startup, ["x", "label"], [avg.name],
                         mesh).init()
    tr.step(cases.mlp_feeds(0))
    snap = telemetry.snapshot()
    assert snap["trainer_steps_total{trainer=parallel}"] == 1
    assert snap["trainer_examples_total{trainer=parallel}"] == \
        cases.MLP["BATCH"]
    health.enable()
    try:
        main, startup, avg = cases.build_mlp()
        tr = ParallelTrainer(main, startup, ["x", "label"], [avg.name],
                             mesh).init()
        fetches = tr.step(cases.mlp_feeds(0))
    finally:
        health.disable()
    assert len(fetches) == 1 and tr._monitor is not None
    last = tr._monitor.last
    assert last is not None and last["nonfinite"]
    assert all(v == 0 for v in last["nonfinite"].values())


def test_verify_sharding_waits_with_the_analyzer(world_one):
    """The analyzer the gate waited for is here: `sharding_plan` gives
    the JAX trainer's plan at world size 1 (specs and comm alike), and
    under FLAGS_verify_sharding `init` analyzes first — a feed spec
    naming an axis the mesh lacks rejects (S004) before the startup
    program runs, as the JAX trainer does, and a clean program
    trains."""
    from paddle_tpu.analysis import ProgramVerificationError as JErr
    from paddle_tpu.utils import flags as jflags
    from paddle_tpu_torch.analysis import ProgramVerificationError
    from paddle_tpu_torch.utils import flags

    class MustNotRun:
        def run(self, *a, **k):
            raise AssertionError("startup ran before the gate rejected")

    mesh = make_mesh(device="cpu")
    main, startup, avg = cases.build_mlp()
    jmain, jstartup, javg = cases.build_mlp(jfluid)
    tr = ParallelTrainer(main, startup, ["x", "label"], [avg.name], mesh)
    jtr = JTrainer(jmain, jstartup, ["x", "label"], [javg.name],
                   jmake_mesh(n_devices=1))
    plan, jplan = tr.sharding_plan(), jtr.sharding_plan()
    assert plan.var_specs == jplan.var_specs
    assert plan.to_dict() == jplan.to_dict()
    errors = []
    flags.set_flag("verify_sharding", True)
    jflags.set_flag("verify_sharding", True)
    try:
        for trainer_cls, fl, make, err_cls in (
                (ParallelTrainer, tfluid, lambda: mesh, ProgramVerificationError),
                (JTrainer, jfluid, lambda: jmake_mesh(n_devices=1), JErr)):
            m, s, a = cases.build_mlp(fl)
            bad = trainer_cls(m, s, ["x", "label"], [a.name], make(),
                              feed_specs={"x": ("sp",)})
            with pytest.raises(err_cls) as err:
                bad.init(executor=MustNotRun())
            errors.append(str(err.value))
            assert bad.state is None
        assert "S004" in errors[0] and errors[0] == errors[1]
        tr.init()
        (loss,) = tr.step(cases.mlp_feeds(0))
        assert np.isfinite(loss.numpy()).all()
    finally:
        flags.set_flag("verify_sharding", False)
        jflags.set_flag("verify_sharding", False)


def _same_state(a, b):
    return a.keys() == b.keys() and all(np.array_equal(a[n], b[n])
                                        for n in a)


def test_captured_step_at_4_ranks_equals_uncaptured(ranks, jax_runs):
    got = _result(ranks, "capture_pair")
    cap, unc, off = got["captured"], got["uncaptured"], got["off"]
    assert cap[0] == unc[0] == off[0]
    assert _same_state(cap[1], unc[1]) and _same_state(cap[1], off[1])
    # donated: every shard where it was; copied: the updated state moves
    assert cap[2] == [] and unc[2] and off[2] == unc[2]
    # the warm-up, the capture (on the CPU its plain version), replays
    assert cap[3] == off[3] == (1, STEPS - 2) and unc[3] is None
    _, jlosses, jstate = jax_runs["zero1_dp2_mp2"]
    _assert_parity(cap[0], cap[1], jlosses, jstate)


def _fit_a_line(fl=tfluid):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[13], dtype="float32")
        y = fl.layers.data(name="y", shape=[1], dtype="float32")
        h = fl.layers.fc(input=x, size=16, act="relu")
        pred = fl.layers.fc(input=h, size=1)
        avg = fl.layers.mean(fl.layers.square_error_cost(input=pred,
                                                         label=y))
        fl.optimizer.MomentumOptimizer(learning_rate=0.05,
                                       momentum=0.9).minimize(avg)
    return main, startup, avg


def _line_feed(i, rows=8):
    rs = np.random.RandomState(300 + i)
    x = rs.randn(rows, 13).astype(np.float32)
    return {"x": x, "y": x[:, :1] * 2.0 - 1.0}


def _line_trainer(mesh, init=None, **kw):
    main, startup, avg = _fit_a_line()
    tr = ParallelTrainer(main, startup, ["x", "y"], [avg.name], mesh,
                         **kw).init()
    if init is not None:
        scope = tfluid.Scope()
        tfluid.io.params_from_numpy(scope, init, "cpu")
        tr.load_state_from(scope)
    return tr


def test_world_one_captured_step_equals_uncaptured_and_jax(world_one):
    """At world 1: the captured step's losses and state are the
    uncaptured step's bit for bit and the JAX trainer's within the
    tolerances; the state keeps its storage; a new feed shape (16 rows
    after 8) warms up and captures anew, counted; the replays of the
    first shape go on."""
    mesh = make_mesh(device="cpu")
    jmain, jstartup, javg = _fit_a_line(jfluid)
    jtr = JTrainer(jmain, jstartup, ["x", "y"], [javg.name],
                   jmake_mesh(n_devices=1)).init()
    init = {n: np.array(v) for n, v in jtr.state.items()}
    feeds = [_line_feed(i) for i in range(4)] + \
        [_line_feed(i, rows=16) for i in range(4, 7)] + [_line_feed(7)]
    jlosses = [float(np.asarray(jtr.step(f)[0]).reshape(-1)[0])
               for f in feeds]
    runs = {}
    for capture in (True, False):
        tr = _line_trainer(mesh, init, capture=capture)
        ptrs = {n: v.to_local().data_ptr() for n, v in tr.state.items()}
        losses = [float(tr.step(f)[0].reshape(-1)[0]) for f in feeds]
        moved = [n for n, v in tr.state.items()
                 if v.to_local().data_ptr() != ptrs[n]]
        runs[capture] = (losses, {n: tr.fetch_state(n) for n in tr.state},
                         moved, tr.captured)
    (closs, cstate, cmoved, core), (uloss, ustate, umoved, _) = \
        runs[True], runs[False]
    assert closs == uloss and _same_state(cstate, ustate)
    assert cmoved == [] and umoved
    # 8 rows: warm-up, capture, replay, replay; 16 rows: warm-up,
    # capture, replay; 8 rows again: a replay
    assert (core.captures, core.replays) == (2, 4)
    _assert_parity(closs, cstate, jlosses,
                   {n: np.asarray(v) for n, v in jtr.state.items()})


def test_donate_state_false_keeps_copies(world_one):
    from paddle_tpu_torch.jit import FunctionalProgram, state_from_scope
    from paddle_tpu_torch.parallel import make_parallel_step

    mesh = make_mesh(device="cpu")
    tr = _line_trainer(mesh)
    fp = FunctionalProgram(tr.main_program, ["x", "y"], tr.fetch_names,
                           place=tfluid.CPUPlace())
    step, _ = make_parallel_step(tr.main_program, ["x", "y"],
                                 tr.fetch_names, mesh,
                                 state_from_scope(fp, _scope_of(tr)),
                                 fp=fp, donate_state=False)
    assert not step.captured.donate
    state = tr.state
    for i in range(3):
        _, new = step(state, _line_feed(i), None)
        assert all(new[n] is not state[n] for n in
                   fp.state_out_names)
        state = new


def _scope_of(tr):
    scope = tfluid.Scope()
    tr.dump_state_to(scope)
    return scope


def test_dropout_draws_alike_captured_and_uncaptured(world_one):
    mesh = make_mesh(device="cpu")

    def build():
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data(name="x", shape=[16, 32],
                                   dtype="float32", append_batch_size=False)
            h = tfluid.layers.fc(input=x, size=32)
            d = tfluid.layers.dropout(h, dropout_prob=0.5)
            cost = tfluid.layers.mean(x=tfluid.layers.square(d))
            tfluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
        return main, startup, cost

    feed = {"x": np.random.RandomState(5).randn(16, 32).astype(np.float32)}
    out, init = {}, None
    for capture in (True, False):
        main, startup, cost = build()
        tr = ParallelTrainer(main, startup, ["x"], [cost.name], mesh,
                             seed=7, capture=capture).init()
        if init is None:
            init = {n: tr.fetch_state(n) for n in tr.state}
        scope = tfluid.Scope()
        tfluid.io.params_from_numpy(scope, init, "cpu")
        tr.load_state_from(scope)
        out[capture] = [float(tr.step(feed)[0].reshape(-1)[0])
                        for _ in range(5)]
    assert out[True] == out[False] and len(set(out[True])) == 5


def test_a_failed_capture_names_the_step_and_the_op(world_one,
                                                    monkeypatch):
    """A kernel that reads the device from the host inside the capture
    (here `mean`'s, made to) fails the capture with CaptureError naming
    the step, the segment and the op; the step does not go on
    uncaptured."""
    from paddle_tpu_torch.fluid import graphs
    from paddle_tpu_torch.ops import registry as op_registry

    mesh = make_mesh(device="cpu")
    tr = _line_trainer(mesh)
    info = op_registry.get_op_info("mean")
    kernel = info.kernel

    def reads_the_host(ctx, ins, attrs):
        out = kernel(ctx, ins, attrs)
        if graphs.capturing():
            float(out["Out"][0].to_local().sum())
        return out

    monkeypatch.setattr(info, "kernel", reads_the_host)
    tr.step(_line_feed(0))
    with pytest.raises(graphs.CaptureError,
                       match=r"parallel_step: .*'mean'") as err:
        tr.step(_line_feed(1))
    assert "read of the device from the host" in str(err.value)
    with pytest.raises(graphs.CaptureError):
        tr.step(_line_feed(2))


def test_executor_captures_segments_fed_dtensors(world_one):
    """Executor.run fed DTensors (the mesh path through the executor):
    its segments warm up, capture and replay like any other, and no
    segment counts as eager for the mesh; the losses are those of the
    same runs fed plain tensors.  The first run's updates make the
    scope's plain state DTensors, so the second run is a new signature:
    its warm-up, then the capture and the replays."""
    from paddle_tpu_torch.obs import registry as tregistry
    from paddle_tpu_torch.parallel.sharding import P, distribute

    mesh = make_mesh(device="cpu")
    fam = tregistry.get_registry().counter(
        "executor_eager_segments_total", labelnames=("reason",))
    before = fam.labels(reason="mesh").value
    runs = {}
    for fed in ("dtensor", "plain"):
        main, startup, avg = _fit_a_line()
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        torch.manual_seed(3)
        exe.run(startup, scope=scope)
        losses = []
        for i in range(5):
            feed = {n: torch.from_numpy(v)
                    for n, v in _line_feed(i).items()}
            if fed == "dtensor":
                feed = {n: distribute(v, mesh, P()) for n, v in feed.items()}
            out, = exe.run(main, feed=feed, fetch_list=[avg], scope=scope,
                           return_numpy=False)
            losses.append(float(out.full_tensor() if hasattr(
                out, "full_tensor") else out))
        runs[fed] = (losses, exe.captures, exe.replays)
    assert runs["dtensor"][1:] == (1, 2)
    assert fam.labels(reason="mesh").value == before
    np.testing.assert_allclose(runs["dtensor"][0], runs["plain"][0],
                               rtol=0, atol=1e-6)
