"""Forward rematerialization (activation checkpointing) as an IR pass.

Counterpart of paddle_tpu/fluid/recompute.py, with the same rewrite: a
program built by `append_backward` keeps every forward activation live
until its grad op reads it, so its peak memory grows with depth times
batch.  Given checkpoint variables, the forward slice is cut into
segments of recomputable ops.  In the backward region the first grad op
that reads a segment's intermediate gets a cloned copy of the segment
inserted before it (its outputs renamed `<name>@RCP<k>`), and every
later reader of the intermediate is remapped to the clone.  The
originals then die at the end of the forward.

The clone's checkpoint inputs pass through a `recompute_barrier` op
(`X` -> `Out`, named `<name>@RCP<k>@IN`) whose `Trigger` operand is an
incoming gradient of the triggering grad op.  In the JAX package the
barrier is `lax.optimization_barrier`, which keeps XLA from merging the
clone back into the original forward and from hoisting it next to it.
In the port the program's order is the order it runs in and nothing
merges duplicate ops, so the barrier is an identity
(ops/tensor_ops.py): the clone runs where the rewrite put it.  What
frees the originals is the executor, which releases every value after
its last reader (fluid/executor.py).

Ops that must not run twice are never cloned, and their outputs become
implicit checkpoints: random ops (a re-drawn dropout mask would decouple
the forward and backward masks), host ops (not `jittable`, the JAX
package's mark, so both packages rewrite a program alike) and ops that
carry a sub-block.  A program that both packages rewrite has the same
`to_dict()`.
"""

from ..core.desc import BlockRef, OpDesc, VarDesc
from ..core.types import GRAD_SUFFIX
from ..ops import registry as op_registry
from .backward import EMPTY

__all__ = ["recompute_program", "RecomputeOptimizer", "auto_checkpoints"]

_RCP = "@RCP"


def _is_recomputable(op_desc):
    if not op_registry.has_op(op_desc.type):
        return False
    info = op_registry.get_op_info(op_desc.type)
    if not info.jittable or info.uses_rng:
        return False
    if any(isinstance(a, BlockRef) for a in op_desc.attrs.values()):
        return False
    return op_desc.type not in ("feed", "fetch")


def _fwd_outputs(op_desc):
    """The real forward outputs: no empties and no grad-named vars (the
    loss grad's seed is a fill_constant in the forward slice)."""
    return [n for n in op_desc.output_names()
            if n and GRAD_SUFFIX not in n]


class _Rewriter:
    def __init__(self, block, checkpoints):
        self.block = block
        bd = block.desc
        self.ops = bd.ops
        self.first_grad = next(
            (i for i, od in enumerate(self.ops)
             if op_registry.is_grad_op_type(od.type)), None)

        ckpt = set(checkpoints)
        for name, vd in bd.vars.items():
            if vd.persistable or vd.is_parameter:
                ckpt.add(name)

        # the forward slice as segments of recomputable ops, cut after
        # each op that writes a checkpoint
        self.seg_ops = []          # segment id -> [OpDesc]
        self.seg_of = {}           # intermediate var -> segment id
        cur = []
        for od in self.ops[:self.first_grad or 0]:
            outs = _fwd_outputs(od)
            if not outs:
                # the loss grad's seed: not a forward value, and a clone
                # would be a second writer of a live backward var
                continue
            if not _is_recomputable(od):
                ckpt.update(outs)
                continue
            cur.append(od)
            if any(n in ckpt for n in outs):
                self._close_segment(cur, ckpt)
                cur = []
        self._close_segment(cur, ckpt)
        # what the forward never wrote (feeds, startup state) is a
        # checkpoint: it is in no segment
        self.ckpt = ckpt
        self.materialized = {}     # segment id -> {name: renamed}
        self.n_cloned = 0

    def _close_segment(self, ops, ckpt):
        if not ops:
            return
        sid = len(self.seg_ops)
        self.seg_ops.append(list(ops))
        for od in ops:
            for n in _fwd_outputs(od):
                if n not in ckpt:
                    self.seg_of[n] = sid

    def run(self):
        if self.first_grad is None or not self.seg_of:
            return 0
        i = self.first_grad
        while i < len(self.ops):
            od = self.ops[i]
            needed = sorted({n for n in od.input_names()
                             if n in self.seg_of})
            if needed:
                clones = []
                renames = {}
                for n in needed:
                    renames.update(
                        self._materialize(self.seg_of[n], od, clones))
                self.ops[i:i] = clones
                i += len(clones)
                od.inputs = type(od.inputs)(
                    (slot, [renames.get(n, n) for n in names])
                    for slot, names in od.inputs.items())
            i += 1
        self.block.sync_with_desc()
        return self.n_cloned

    def _trigger_of(self, grad_op):
        """A value on the backward front: an incoming grad of the op
        that first needs the segment (its OG@ slots; else any grad-named
        input, as a grad sum has).  Never the EMPTY placeholder and
        never a forward value, which would keep the original live across
        the backward."""
        for slot, names in grad_op.inputs.items():
            if slot.startswith("OG@"):
                for n in names:
                    if n and n != EMPTY:
                        return n
        for names in grad_op.inputs.values():
            for n in names:
                if n and n != EMPTY and GRAD_SUFFIX in n:
                    return n
        return None

    def _materialize(self, sid, trigger_op, out_clones):
        """Append the clone ops of segment `sid` (and first, of any
        earlier segment it reads) to `out_clones`; returns the rename
        map of its intermediates."""
        if sid in self.materialized:
            return self.materialized[sid]
        renames = {}
        self.materialized[sid] = renames
        suffix = "%s%d" % (_RCP, sid)

        # one barrier over the segment's checkpoint inputs: its reads
        # that are neither another segment's intermediate (those
        # rematerialize below) nor written in the segment
        own_outs = {n for od in self.seg_ops[sid]
                    for n in _fwd_outputs(od)}
        barrier_ins = sorted({
            n for od in self.seg_ops[sid] for n in od.input_names()
            if n and n not in self.seg_of and n not in own_outs})
        for n in barrier_ins:
            renames[n] = n + suffix + "@IN"
            self._clone_var(n, renames[n])
        barrier = OpDesc(
            "recompute_barrier",
            {"X": list(barrier_ins),
             "Trigger": [t for t in [self._trigger_of(trigger_op)] if t]},
            {"Out": [renames[n] for n in barrier_ins]}, {})
        out_clones.append(barrier)

        for od in self.seg_ops[sid]:
            if not any(n in self.seg_of for n in _fwd_outputs(od)):
                # every output a checkpoint (the segment's last op): the
                # original stays live, a clone would be dead code
                continue
            ins = type(od.inputs)()
            for slot, names in od.inputs.items():
                mapped = []
                for n in names:
                    if n in renames:
                        mapped.append(renames[n])
                    elif n in self.seg_of and self.seg_of[n] != sid:
                        # an earlier segment's intermediate: that segment
                        # rematerializes first
                        sub = self._materialize(self.seg_of[n],
                                                trigger_op, out_clones)
                        mapped.append(sub.get(n, n))
                    else:
                        mapped.append(n)
                ins[slot] = mapped
            outs = type(od.outputs)()
            for slot, names in od.outputs.items():
                row = []
                for n in names:
                    if n and GRAD_SUFFIX not in n:
                        renames[n] = n + suffix
                        self._clone_var(n, renames[n])
                        row.append(renames[n])
                    else:
                        row.append(n)
                outs[slot] = row
            out_clones.append(OpDesc(od.type, ins, outs, dict(od.attrs)))
            self.n_cloned += 1
        # only the intermediates' renames leave: every reader outside
        # the clone keeps a checkpoint's original value
        self.materialized[sid] = {
            n: rn for n, rn in renames.items() if n in self.seg_of}
        return self.materialized[sid]

    def _clone_var(self, src_name, new_name):
        bd = self.block.desc
        if new_name in bd.vars:
            return
        src = bd.vars.get(src_name)
        vd = VarDesc(new_name)
        if src is not None:
            vd.type = src.type
            vd.dtype = src.dtype
            vd.shape = src.shape
            vd.lod_level = src.lod_level
        vd.stop_gradient = True
        bd.vars[new_name] = vd


def recompute_program(program, checkpoints, block=None):
    """Rewrite a built training program (forward, backward and updates)
    so that the forward segments between `checkpoints` (Variables or
    names) are recomputed in the backward region instead of kept live
    across it.  Returns the number of cloned forward ops (0: nothing to
    do).  The global block only: sub-block bodies stay as they are."""
    names = [c if isinstance(c, str) else c.name for c in checkpoints]
    block = block if block is not None else program.global_block()
    return _Rewriter(block, names).run()


def auto_checkpoints(program, every=8, block=None):
    """Checkpoints for a model that names no cut points: the output of
    every `every`-th recomputable single-output forward op.  Enough for
    chain-like networks; a model builder's own block outputs are the
    better choice where it has them."""
    if every < 1:
        raise ValueError("auto_checkpoints stride must be >= 1, got %r"
                         % (every,))
    block = block if block is not None else program.global_block()
    picks, seen = [], 0
    for op in block.desc.ops:
        if op_registry.is_grad_op_type(op.type):
            break
        outs = _fwd_outputs(op)
        if len(outs) != 1 or not _is_recomputable(op):
            continue
        seen += 1
        if seen % every == 0:
            picks.append(outs[0])
    return picks


class RecomputeOptimizer:
    """An optimizer wrapper: the inner optimizer's `minimize`, then the
    recompute rewrite of the loss's program over `checkpoints` (the
    wrapper shape later Paddle releases gave their RecomputeOptimizer,
    as in the JAX package).  The desc form of `minimize`
    (`minimize(loss_name, main_desc, startup_desc)`) rewrites
    `main_desc`."""

    def __init__(self, optimizer, checkpoints):
        self._inner = optimizer
        self._checkpoints = list(checkpoints)

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, **kwargs):
        optimize_ops, params_grads = self._inner.minimize(
            loss, startup_program, parameter_list, no_grad_set, **kwargs)
        if isinstance(loss, str):
            from .framework import Program

            program = Program.from_desc(startup_program)
        else:
            program = loss.block.program
        recompute_program(program, self._checkpoints)
        return optimize_ops, params_grads
