"""The mesh steps captured: a Program block run over the mesh as CUDA
graphs, its state donated.

Counterpart of what `jax.jit(step, in_shardings, out_shardings,
donate_argnums=(0,))` gives the JAX package's mesh step
(paddle_tpu/parallel/trainer.py:131-136).  `ProgramStep` runs a
`FunctionalProgram`'s block through the executor's captured segments
(fluid/executor.py `_CompiledProgram`), on the values the step hands
it: DTensors on the mesh for `parallel.make_parallel_step`, each rank's
local tensors for the bucketed dp step (`spmd.overlap`).  So everything
the executor does for a program, the mesh step does too:

  * the block splits into maximal runs of capturable ops and the host
    ops between them, and no run is captured across a host op;
  * per signature (the feeds' shapes and dtypes, each DTensor's mesh and
    placements, the address of every state tensor read in place), the
    first call warms up eagerly (NCCL's communicators are made, cuBLAS
    picks its algorithms, `_run_on_mesh` learns which op types run on
    full values), the second captures through `graphs.graph_capture`,
    later calls copy the feeds into the graph's static inputs and
    replay; a new signature captures anew, counted, and nothing falls
    back to an uncaptured step (a failed capture raises
    `graphs.CaptureError` naming the segment and the op);
  * captures and replays count on the step's own executor (`captures`,
    `replays`), in `executor_jit_traces_total` and
    `executor_graph_replays_total` on the card, a replay adds the flash
    launches its capture recorded, and each graph's pool joins
    `graphs.hold`'s budget;
  * with donation (`donate=True`, FLAGS_donation not "off"), each state
    tensor's new value is written into the old one's storage (a
    DTensor's new value laid out as the old one first, ZeRO-1's sharded
    accumulators too), so a replay updates the state in place and the
    state keeps its addresses; without it the state is copied into the
    graph and its new value out of it;
  * each value leaves the run after its last reader.

The step's random stream is one generator registered with the graphs:
before each call it takes the state of the generator the caller passes
(the trainer seeds a fresh one for each step from `(seed, step)`), and
after the call the caller's generator takes its advanced state, so a
dropout program draws the same masks captured as uncaptured.

On the CPU (gloo ranks) nothing is captured: the same static buffers,
plan and donation run once per call, counted as captures and replays
all the same.
"""

import torch

from ..core.scope import Scope
from ..fluid import graphs
from ..fluid.executor import ExecContext, Executor, _lookup

__all__ = ["ProgramStep"]


class ProgramStep:
    """A FunctionalProgram's block 0 as the executor's captured segments.

    `run(state, feeds, rng)` -> (fetches, new_state, graph_owned): the
    fetches as the run left them, {name: value} of `state` with the
    block's writes, and the names whose values are a graph's own output
    buffers (a later call overwrites them; the caller copies what it
    keeps).  `donate` None is `analysis.alias.state_donation()` (False
    under FLAGS_donation=off).  `on_capture(seconds, pool_bytes)`, when
    set, is called after each call that captured."""

    def __init__(self, fp, label, donate=None, seams=None):
        if fp.block_idx != 0:
            raise ValueError("a captured mesh step runs block 0, not %d"
                             % fp.block_idx)
        self.fp = fp
        self.label = label
        if donate is None:
            from ..analysis.alias import state_donation

            donate = state_donation()
        self.executor = Executor(fp.place)
        self.scope = Scope()
        self.compiled = self.executor._new_compiled(
            fp.desc, sorted(fp.feed_names), fp.fetch_names,
            donation=None if donate else "off", seams=seams)
        self.donate = self.compiled._donation["mode"] != "off"
        self.on_capture = None
        self._gen = None

    @property
    def captures(self):
        return self.executor.captures

    @property
    def replays(self):
        return self.executor.replays

    @property
    def pool_bytes(self):
        """The bytes the step's graphs' pool grew by (0 on the CPU)."""
        return self.compiled.pool_bytes

    @property
    def capture_seconds(self):
        return self.compiled.seconds.get("capture", 0.0)

    def _stream(self, rng):
        """The generator the graphs register, set to `rng`'s state."""
        if rng is None:
            return None
        if self._gen is None or self._gen.device != rng.device:
            self._gen = torch.Generator(device=rng.device)
        self._gen.set_state(rng.get_state())
        return self._gen

    def run(self, state, feeds, rng=None):
        for n, v in state.items():
            self.scope.set(n, v)
        gen = self._stream(rng)
        ctx = ExecContext(self.fp.desc, 0, dict(feeds), scope=self.scope,
                          place=self.fp.place, device=self.fp.device,
                          rng=gen)
        captures = self.executor.captures
        seconds, pool = self.capture_seconds, self.pool_bytes
        try:
            with torch.no_grad() if self.compiled.trains else \
                    torch.inference_mode():
                graph_owned = self.compiled.run(ctx, self.scope,
                                                eager=False)
        except graphs.CaptureError as exc:
            raise graphs.CaptureError("%s: %s" % (self.label, exc)) from exc
        if gen is not None:
            rng.set_state(gen.get_state())
        fetches = [_lookup(ctx, n) for n in self.fp.fetch_names]
        new_state = {n: self.scope.get(n) for n in state}
        if self.on_capture is not None and self.executor.captures > captures:
            self.on_capture(self.capture_seconds - seconds,
                            self.pool_bytes - pool)
        return fetches, new_state, graph_owned

