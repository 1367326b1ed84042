"""Mesh-parallel training.

Counterpart of paddle_tpu/parallel/trainer.py.  There the whole train
step (forward, backward and optimizer, one Program block) is one jitted
function laid out over the mesh, XLA's GSPMD inserting the collectives.
Here the same step runs through the port's `FunctionalProgram` with its
state and feeds as DTensors on a `DeviceMesh`: each parameter and
accumulator laid out by its spec (`sharding.param_spec`, with ZeRO-1's
rewrite of the accumulators), each feed by `batch_spec` (or
`feed_specs`), and every op runs on them through the executor's mesh
path (fluid/executor.py `_run_on_mesh`), so DTensor's sharding rules
place the collectives.  The step has the single-device step's global
semantics: batch_norm's statistics, `mean` and the fetched loss are
those of the whole batch.  After a step the state is laid out by its
specs again (the JAX step's `out_shardings`), and the fetches come back
as full tensors, as the JAX fetches come back replicated.

The JAX step is one `jax.jit` with its state donated.  Here the step is
captured (`capture=True`, the default; parallel/captured.py): the
block's runs of capturable ops are CUDA graphs per signature, replayed
from the third call, and with `donate_state` (FLAGS_donation not "off")
each state DTensor's new value is written into its old local tensor's
storage, so the state keeps its addresses.  `capture=False` runs the
step op by op from Python: the reference the captured step is held to,
bit for bit.

The mesh's ranks run on CUDA over NCCL unless it was made for the CPU
(`make_mesh(..., device="cpu")`, gloo).  With `FLAGS_verify_sharding`
on, the static SPMD analyzer (`analysis/shard.py`) checks the program
against the mesh before the startup program runs or a step is built
(`verify_sharding`), and `sharding_plan` returns its analysis without
raising, as on the JAX side.
"""

import numpy as np
import torch

from ..fluid.executor import (CPUPlace, CUDAPlace, Executor,
                              fetch_to_host, prepare_feed)
from ..core.scope import Scope
from ..jit import FunctionalProgram, state_from_scope
from ..obs import flight as obs_flight
from ..obs import health as obs_health
from ..obs import telemetry as obs_tele
from ..utils import flags as _flags
from .captured import ProgramStep
from .mesh import mesh_scope
from .sharding import (NamedSharding, _dtensor, batch_spec, distribute,
                       is_optimizer_state, optimizer_state_names,
                       param_spec, replicating, to_full, zero1_spec)

__all__ = ["make_parallel_step", "ParallelTrainer", "verify_sharding"]


def verify_sharding(program, mesh, feed_names, fetch_names,
                    feed_specs=None, zero_stage=0, dp_axis="dp",
                    mp_axis="mp", origin="parallel_trainer", hbm_gb=None):
    """Run the static SPMD analyzer over `program` against `mesh` and
    raise ProgramVerificationError on any error-severity S0xx finding
    (non-divisible shard, schedule hazard, budget overrun) before
    anything runs.  The trust-boundary gate behind
    FLAGS_verify_sharding; callers can also invoke it directly.
    Returns the ShardingPlan for introspection."""
    from ..analysis import shard as shard_analysis

    plan = shard_analysis.analyze_sharding(
        program, mesh, feed_names=list(feed_names),
        feed_specs=feed_specs, fetches=list(fetch_names),
        zero_stage=zero_stage, dp_axis=dp_axis, mp_axis=mp_axis,
        hbm_gb=hbm_gb, publish=True, origin=origin,
        # trainer feeds carry their real runtime shapes: a
        # non-divisible static batch is a hard S002 here
        concrete_feeds=True)
    plan.report.raise_on_error()
    return plan


def place_of(mesh):
    """The executor place of this rank's device on `mesh`."""
    if mesh.device_type == "cuda":
        return CUDAPlace(torch.cuda.current_device())
    return CPUPlace()


def make_parallel_step(program, feed_names, fetch_names, mesh,
                       state_template, dp_axis="dp", mp_axis="mp",
                       donate_state=None, fp=None, zero_stage=0,
                       feed_specs=None, spec_overrides=None, capture=True):
    """A Program block as a step over the mesh.

    Returns (step, state_shardings) where
      step(state, feeds, rng) -> (fetches, new_state)
    takes the state as DTensors laid out by `state_shardings` (a
    NamedSharding per name: param_spec, and with zero_stage=1 the
    optimizer accumulators also sharded over dp), feeds (arrays or
    tensors; each is distributed by `feed_specs`, else by batch_spec)
    and rng (a torch.Generator on the mesh's device, or None), and
    returns the fetches as full tensors and the new state laid out by
    `state_shardings`.

    spec_overrides maps a state name to the spec it takes, bypassing
    param_spec and the zero1 rewrite.  With capture (the default) the
    step runs the block's runs of capturable ops as CUDA graphs
    (parallel/captured.py; `step.captured` is its `ProgramStep`); with
    donate_state (None: `analysis.alias.state_donation()`, False under
    FLAGS_donation=off) the new state is written into the old state's
    storage and the step returns the same DTensors; without it the step
    returns new state tensors.  capture=False runs the block op by op
    (it makes new state tensors whatever donate_state says).

    With FLAGS_verify_sharding on, the static SPMD analyzer runs over
    the program and mesh first (unless the caller already did:
    ParallelTrainer.init verifies before running startup, and passes
    `fp`) and rejects S0xx errors before the step is built.
    """
    if fp is None:
        if program is not None and _flags.get_flag("verify_sharding"):
            verify_sharding(program, mesh, feed_names, fetch_names,
                            feed_specs=feed_specs,
                            zero_stage=zero_stage, dp_axis=dp_axis,
                            mp_axis=mp_axis, origin="parallel_step")
        fp = FunctionalProgram(program, feed_names, fetch_names,
                               place=place_of(mesh))
    acc_names = optimizer_state_names(program) if program is not None \
        else None
    spec_overrides = spec_overrides or {}

    def spec_for(name, shape):
        if name in spec_overrides:
            return spec_overrides[name]
        spec = param_spec(name, shape, mesh, mp_axis=mp_axis)
        if zero_stage >= 1 and is_optimizer_state(name, known=acc_names):
            spec = zero1_spec(spec, shape, mesh, dp_axis=dp_axis)
        return spec

    state_shardings = {
        name: NamedSharding(mesh, spec_for(name, tuple(v.shape)))
        for name, v in state_template.items()}
    placements = {n: s.placements for n, s in state_shardings.items()}
    feed_specs = feed_specs or {}
    block = fp.desc.block(fp.block_idx)
    device = fp.device

    def distribute_feeds(feeds):
        dist_feeds = {}
        for n in sorted(feeds):
            v = prepare_feed(block, n, feeds[n], device)
            if isinstance(v, torch.Tensor):
                v = distribute(v, mesh, feed_specs.get(
                    n, batch_spec(tuple(v.shape), mesh, dp_axis)))
            dist_feeds[n] = v
        return dist_feeds

    def laid_out(new_state):
        return {n: (distribute(v, mesh, placements[n])
                    if n in placements and not (
                        isinstance(v, _dtensor())
                        and tuple(v.placements) == tuple(placements[n]))
                    else v)
                for n, v in new_state.items()}

    if not capture:
        def step(state, feeds, rng):
            dist_feeds = distribute_feeds(feeds)
            with replicating():
                fetches, new_state = fp(state, dist_feeds, rng)
                new_state = laid_out(new_state)
                fetches = [to_full(f) for f in fetches]
            return fetches, new_state

        return step, state_shardings

    core = ProgramStep(fp, "parallel_step", donate=donate_state)

    def step(state, feeds, rng):
        dist_feeds = distribute_feeds(feeds)
        with replicating():
            fetches, new_state, owned = core.run(state, dist_feeds, rng)
            new_state = laid_out(new_state)
            # a graph's own buffer, or a state tensor a later step
            # writes in place, is copied out
            fetches = [to_full(f).clone() if n in owned or n in state
                       else to_full(f)
                       for n, f in zip(fp.fetch_names, fetches)]
        return fetches, new_state

    step.captured = core
    return step, state_shardings


class ParallelTrainer:
    """End-to-end sharded trainer for a built Program.

    Usage:
        mesh = make_mesh(dp=2, mp=2)        # over the process group
        trainer = ParallelTrainer(main_prog, startup_prog,
                                  feed_names=["image", "label"],
                                  fetch_names=[loss.name], mesh=mesh)
        trainer.init()                       # run startup, shard params
        (loss,) = trainer.step({"image": x, "label": y})

    Every rank of the mesh runs the same calls with the same feeds (the
    global batch; each rank keeps its shard of it).

    `capture` (default True) runs the step captured and donated
    (`make_parallel_step`); `captured` is then its `ProgramStep`
    (`captures`, `replays`, `pool_bytes`, `capture_seconds`), None for
    `capture=False`.
    """

    def __init__(self, main_program, startup_program, feed_names,
                 fetch_names, mesh, dp_axis="dp", mp_axis="mp", seed=0,
                 zero_stage=0, feed_specs=None, capture=True):
        self.main_program = main_program
        self.startup_program = startup_program
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.mp_axis = mp_axis
        self.zero_stage = zero_stage
        self.feed_specs = feed_specs
        self.seed = int(seed)
        self.capture = bool(capture)
        self.place = place_of(mesh)
        self._step_count = 0
        self._step_fn = None
        self._monitor = None
        self.state = None

    def init(self, scope=None, executor=None):
        """Run the startup program on this rank's device, then lay the
        state out over the mesh by the sharding specs.

        With FLAGS_verify_sharding on, the static SPMD analyzer runs
        first, before the startup program executes, so a non-divisible
        shard or a schedule hazard rejects with op, var and spec
        identity instead of failing inside a step."""
        self._verify()
        scope = scope or Scope()
        exe = executor or Executor(self.place)
        exe.run(self.startup_program, scope=scope)

        # numerics health: the monitor's reductions (nonfinite counts
        # over fetches and grads, global grad norm) join the step as
        # extra fetches
        fetch_all = list(self.fetch_names)
        self._monitor = None
        if obs_health.enabled():
            self._monitor = obs_health.NumericsMonitor(
                self.main_program,
                tensors=list(self.fetch_names)).install()
            fetch_all += self._monitor.fetch_names

        fp = FunctionalProgram(self.main_program, self.feed_names,
                               fetch_all, place=self.place)
        state = state_from_scope(fp, scope)
        self._step_fn, self._shardings = self._make_step(fp, state,
                                                         fetch_all)
        device = self.place.device()
        # sorted: every rank distributes in one order
        self.state = {n: distribute(torch.as_tensor(state[n]).to(device),
                                    self.mesh,
                                    self._shardings[n].placements)
                      for n in sorted(state)}
        return self

    def _verify(self):
        """The pre-startup trust-boundary gate; `SpmdTrainer` replaces
        it with the partition-plan build (which raises on the same S0xx
        errors, rules included)."""
        if _flags.get_flag("verify_sharding"):
            verify_sharding(self.main_program, self.mesh,
                            self.feed_names, self.fetch_names,
                            feed_specs=self.feed_specs,
                            zero_stage=self.zero_stage,
                            dp_axis=self.dp_axis, mp_axis=self.mp_axis,
                            origin="parallel_trainer")

    def _make_step(self, fp, state, fetch_all):
        """Build (step_fn, state_shardings): the hook a subclass
        overrides."""
        return make_parallel_step(
            self.main_program, self.feed_names, fetch_all, self.mesh,
            state, dp_axis=self.dp_axis, mp_axis=self.mp_axis, fp=fp,
            zero_stage=self.zero_stage, feed_specs=self.feed_specs,
            capture=self.capture)

    @property
    def captured(self):
        """The step's `ProgramStep` (parallel/captured.py), or None."""
        return getattr(self._step_fn, "captured", None)

    def step(self, feeds):
        """One training step on the global batch `feeds`; returns the
        fetches as full tensors on this rank's device."""
        if self.state is None:
            raise RuntimeError("call init() before step()")
        step_id = self._step_count
        self._step_count += 1
        rng = torch.Generator(device=self.place.device()).manual_seed(
            self.seed * 1000003 + step_id)
        examples = next((int(v.shape[0]) for v in feeds.values()
                         if getattr(v, "ndim", 0)), None)
        try:
            with obs_tele.step("parallel", examples=examples,
                               step=step_id):
                # under the mesh: mesh-aware ops (flash_attention's
                # sequence parallelism) find it here
                with mesh_scope(self.mesh):
                    fetches, self.state = self._step_fn(self.state,
                                                        feeds, rng)
                if self.mesh.device_type == "cuda":
                    torch.cuda.synchronize()
        except Exception as exc:
            obs_flight.on_crash(exc, origin="parallel/step",
                                step=step_id,
                                feeds=obs_flight.describe_feeds(feeds))
            raise
        if self._monitor is not None:
            n_user = len(self.fetch_names)
            self._monitor.record(dict(zip(
                self._monitor.fetch_names,
                [fetch_to_host(f) for f in fetches[n_user:]])))
            fetches = fetches[:n_user]
        if obs_flight.active():
            loss = None
            first = fetches[0] if fetches else None
            if first is not None and first.numel() == 1:
                loss = float(first.reshape(-1)[0])
            obs_flight.record_step("parallel", step_id, feeds=feeds,
                                   loss=loss)
        return fetches

    def fetch_state(self, name):
        return fetch_to_host(to_full(self.state[name]))

    def sharding_plan(self, hbm_gb=None):
        """Introspection: the static SPMD analysis of this trainer's
        program and mesh (specs, replication reasons, comm cost,
        per-device peak-memory estimate) without raising."""
        from ..analysis import shard as shard_analysis

        return shard_analysis.analyze_sharding(
            self.main_program, self.mesh, feed_names=self.feed_names,
            feed_specs=self.feed_specs, fetches=self.fetch_names,
            zero_stage=self.zero_stage, dp_axis=self.dp_axis,
            mp_axis=self.mp_axis, hbm_gb=hbm_gb, publish=False)

    # -- supervisor integration ---------------------------------------------
    def dump_state_to(self, scope):
        """The full values of the sharded state into `scope` (called by
        the resilience supervisor right before a checkpoint save)."""
        for name, val in self.state.items():
            scope.set(name, to_full(val))

    def load_state_from(self, scope):
        """Lay checkpointed values out on the mesh again with the step's
        shardings (after a supervisor restore)."""
        device = self.place.device()
        restored = {}
        for name in sorted(self.state):
            val = scope.get(name)
            if val is None:
                raise KeyError("checkpoint is missing state var %r"
                               % name)
            restored[name] = distribute(
                torch.as_tensor(np.asarray(val) if not isinstance(
                    val, torch.Tensor) else val).to(device),
                self.mesh, self._shardings[name].placements)
        self.state = restored
