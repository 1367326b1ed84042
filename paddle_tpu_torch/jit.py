"""A Program block as a function of (state, feeds).

Counterpart of paddle_tpu/jit.py, which turns a block into one pure
function that `jax.jit` compiles.  This one compiles nothing: calling it
runs the block op by op through the executor's `apply_op`
(fluid/executor.py) under `torch.inference_mode()`, on tensors that stay
on the place's device, so a decode loop built on it costs one host pass
over the block's ops per call and no copy to or from the host.

Parameters and other persistable state flow through the `state`
argument, not a scope, so the caller owns every buffer.
"""

import torch

from .core.desc import ProgramDesc
from .core.scope import global_scope
from .fluid.executor import CUDAPlace, ExecContext, apply_op
from .fluid.framework import Program
from .ops.registry import span

__all__ = ["FunctionalProgram", "state_from_scope", "state_to_scope"]


class FunctionalProgram:
    """A Program block as a function.

    __call__(state, feeds) -> (fetches, new_state)
      state:   {name: tensor} for every persistable var the block reads
               (`state_in_names`: parameters, statistics, accumulators)
      feeds:   {feed name: tensor}, on the place's device
      fetches: tensors in `fetch_names` order; a fetch may name a feed
      new_state: `state` with the persistables the block writes
               (`state_out_names`) replaced by their new values

    `place` is the device the block's own tensors (constants) are made
    on; CUDAPlace(0) unless the caller asks for another, raising without
    a CUDA device.  The block runs without a random stream: a random op
    in it raises (a test clone's dropout draws nothing).
    """

    def __init__(self, program, feed_names, fetch_names, block_idx=0,
                 place=None):
        self.desc = program.desc if isinstance(program, Program) \
            else program
        if not isinstance(self.desc, ProgramDesc):
            raise TypeError("FunctionalProgram needs a Program or "
                            "ProgramDesc, got %r" % type(program).__name__)
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.block_idx = block_idx
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.device()

        block_desc = self.desc.block(block_idx)
        self.ops = list(block_desc.ops)
        # persistable: marked so in this block or a block it nests in
        persist = set()
        bd = block_desc
        while True:
            persist.update(n for n, vd in bd.vars.items() if vd.persistable)
            if bd.parent_idx < 0:
                break
            bd = self.desc.block(bd.parent_idx)
        reads, writes = set(), set()
        produced = set(self.feed_names)
        for od in self.ops:
            reads.update(n for n in od.input_names()
                         if n != "@EMPTY@" and n not in produced)
            for n in od.output_names():
                if n != "@EMPTY@":
                    produced.add(n)
                    writes.add(n)
        self.state_in_names = sorted(persist & reads)
        self.state_out_names = sorted(persist & writes)

    def __call__(self, state, feeds):
        env = dict(state)
        env.update(feeds)
        ctx = ExecContext(self.desc, self.block_idx, env, place=self.place,
                          device=self.device)
        with torch.inference_mode():
            for od in self.ops:
                with span(od.type):
                    apply_op(ctx, od)
        new_state = dict(state)
        new_state.update((n, env[n]) for n in self.state_out_names
                         if n in env)
        return [env[n] for n in self.fetch_names], new_state


def state_from_scope(fp, scope=None):
    """{name: value} of the state a FunctionalProgram reads and writes,
    from a Scope (after the startup program, and training, ran in it);
    names the scope lacks are left out."""
    scope = scope if scope is not None else global_scope()
    state = {}
    for n in set(fp.state_in_names) | set(fp.state_out_names):
        v = scope.get(n)
        if v is not None:
            state[n] = v
    return state


def state_to_scope(state, scope=None):
    """Write a state dict back into a Scope."""
    scope = scope if scope is not None else global_scope()
    for n, v in state.items():
        scope.set(n, v)
