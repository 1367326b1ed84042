"""Program-stack entries for pipeline and expert parallelism.

Counterpart of paddle_tpu/parallel/program_api.py.  `ParallelTrainer`
drives dp x mp from a built Program; these classes do the same for the
other axes: pipeline stages and MoE experts are built with fluid layers
as Programs, lowered to functions that run the block op by op through
the executor's `apply_op` (as `FunctionalProgram` runs one, but with
autograd on, since the schedules differentiate through them), their
parameters made by the startup program, and the pp / ep schedules
(pipeline.py / moe.py) stream them over the mesh.
"""

import numpy as np
import torch

from .mesh import mesh_shape
from .moe import moe_shard_map
from .pipeline import pipeline_apply, stack_stage_params
from .sharding import P, distribute, replicating, to_full
from .trainer import place_of

__all__ = ["lower_program_fn", "PipelineProgramTrainer",
           "MoEProgramLayer"]


def lower_program_fn(program, startup, feed_name, fetch_name, seed=None,
                     place=None):
    """Lower a single-input single-output Program to fn(params, x) -> y
    plus its startup-initialized parameters ({name: tensor} on `place`'s
    device; CUDAPlace(0) unless the caller passes another).

    The Program must not mutate state (no optimizer ops): stages and
    experts are pure transforms whose gradients flow through the
    surrounding schedule, by autograd through the ops' kernels."""
    from ..core.scope import Scope
    from ..fluid.executor import ExecContext, Executor, apply_op
    from ..jit import FunctionalProgram, state_from_scope

    if seed is not None:
        startup.random_seed = int(seed)
    exe = Executor(place)
    scope = Scope()
    exe.run(startup, scope=scope)
    fp = FunctionalProgram(program, [feed_name], [fetch_name],
                           place=exe.place)
    if fp.state_out_names:
        raise ValueError(
            "stage/expert programs must be pure (no optimizer or "
            "state-mutating ops); %r writes %s"
            % (program, sorted(fp.state_out_names)))
    params = dict(state_from_scope(fp, scope))

    def fn(params, x):
        env = dict(params)
        env[feed_name] = x
        ctx = ExecContext(fp.desc, fp.block_idx, env, place=fp.place,
                          device=fp.device)
        for od in fp.ops:
            apply_op(ctx, od)
        return env[fetch_name]

    return fn, params


class PipelineProgramTrainer:
    """GPipe over fluid-built stages.

    build_stage(stage_idx) -> (program, startup, feed_name, fetch_name)
    must append the same layer topology for every stage (the weights
    differ; the names must match across stages so the per-stage states
    stack into the [S, ...] pp-sharded dict).

    step(x, target) runs forward through the microbatch schedule,
    backprops through it, and applies `optimizer`'s update rule (a
    fluid.optimizer instance, through PytreeOptimizer) over the stacked
    stage weights, so pipeline training keeps the accumulator state
    executor training keeps.  Every rank of the mesh makes the same
    calls with the same batch.
    """

    def __init__(self, build_stage, mesh, n_microbatches, pp_axis="pp",
                 optimizer=None, lr=0.1):
        from ..fluid.optimizer import MomentumOptimizer
        from .optim import PytreeOptimizer

        self.mesh = mesh
        self.n_microbatches = n_microbatches
        self.pp_axis = pp_axis
        if optimizer is None:
            optimizer = MomentumOptimizer(learning_rate=lr, momentum=0.9)
        self.optimizer = PytreeOptimizer(optimizer)
        from ..utils import flags as _flags

        if _flags.get_flag("verify_sharding"):
            from ..analysis import shard as _shard

            _shard.check_pipeline(
                mesh, n_stages=mesh_shape(mesh).get(pp_axis, 0),
                n_microbatches=n_microbatches,
                axis_name=pp_axis).raise_on_error()
        place = place_of(mesh)
        self.device = place.device()
        n_stages = mesh_shape(mesh)[pp_axis]
        fns, states = [], []
        for i in range(n_stages):
            program, startup, feed, fetch = build_stage(i)
            fn, params = lower_program_fn(program, startup, feed, fetch,
                                          seed=i, place=place)
            fns.append(fn)
            states.append(params)
        keys = sorted(states[0])
        for s in states[1:]:
            if sorted(s) != keys:
                raise ValueError(
                    "stage programs disagree on parameter names: "
                    "%s vs %s" % (keys, sorted(s)))
        self.stage_fn = fns[0]
        # the stage axis shards over pp; the optimizer state stacks
        # [S, ...] like the params it tracks and shards with them
        self._spec = P(pp_axis)
        self.stacked = {k: distribute(v, mesh, self._spec) for k, v in
                        sorted(stack_stage_params(states).items())}
        self.opt_state = self.optimizer.init(self.stacked)

    def _loss(self, stacked, x, tgt):
        out = pipeline_apply(self.mesh, self.stage_fn, stacked, x,
                             self.n_microbatches, axis_name=self.pp_axis)
        return torch.mean(torch.square(out - tgt))

    def step(self, x, tgt):
        x = torch.as_tensor(np.asarray(x), device=self.device)
        tgt = torch.as_tensor(np.asarray(tgt), device=self.device)
        keys = sorted(self.stacked)
        params = {k: self.stacked[k].detach().requires_grad_(True)
                  for k in keys}
        with replicating(), torch.enable_grad():
            loss = self._loss(params, x, tgt)
            grads = dict(zip(keys, torch.autograd.grad(
                loss, [params[k] for k in keys])))
        with replicating():
            stacked, opt_state = self.optimizer.apply(self.stacked, grads,
                                                      self.opt_state)
            # the update's results keep the stage layout
            self.stacked = {k: distribute(stacked[k], self.mesh,
                                          self._spec) for k in keys}
            slots = {name: {k: distribute(v[k], self.mesh, self._spec)
                            for k in keys}
                     for name, v in opt_state["slots"].items()}
            self.opt_state = {"slots": slots,
                              "shared": opt_state["shared"]}
            return float(to_full(loss))


class MoEProgramLayer:
    """Switch-MoE whose expert network is a fluid-built Program.

    build_expert() -> (program, startup, feed_name, fetch_name): the
    expert transform ([tokens, d] -> [tokens, d]).  One Program is built
    per expert (startup seeded per expert for distinct inits); their
    states stack into the [E, ...] ep-sharded dict and apply over the
    local expert axis one expert at a time inside the dispatch/combine
    schedule."""

    def __init__(self, build_expert, n_experts, d_model, mesh,
                 ep_axis="ep", batch_axis="dp", capacity_factor=1.25,
                 seed=0):
        from ..utils import flags as _flags

        if _flags.get_flag("verify_sharding"):
            from ..analysis import shard as _shard

            _shard.check_moe(
                mesh, n_experts, capacity_factor=capacity_factor,
                axis_name=ep_axis,
                batch_axis=batch_axis).raise_on_error()
        place = place_of(mesh)
        expert_states, fns = [], []
        for e in range(n_experts):
            program, startup, feed, fetch = build_expert()
            fn, params = lower_program_fn(program, startup, feed, fetch,
                                          seed=seed + e, place=place)
            fns.append(fn)
            expert_states.append(params)
        experts = stack_stage_params(expert_states)
        rs = np.random.RandomState(seed)
        self.params = {
            "gate_w": torch.as_tensor(
                rs.randn(d_model, n_experts).astype(np.float32)
                * (2.0 / d_model) ** 0.5, device=place.device()),
            "experts": experts,
        }
        expert = fns[0]

        def expert_fn(local, xin):
            # one expert at a time over the local expert axis
            return torch.stack([
                expert({k: v[e] for k, v in local.items()}, xin[e])
                for e in range(xin.shape[0])])

        self.fn = moe_shard_map(
            mesh, axis_name=ep_axis, batch_axis=batch_axis,
            capacity_factor=capacity_factor, expert_fn=expert_fn,
            expert_param_template=experts)

    def __call__(self, params, x):
        with replicating():
            return self.fn(params, x)
