"""Memory-optimization transpiler: liveness-driven reuse of variable
slots.

Counterpart of paddle_tpu/fluid/memory_optimization_transpiler.py
(reference: python/paddle/v2/fluid/memory_optimization_transpiler.py,
ControlFlowGraph:33), with the same rewrite: a later temporary adopts
the name of a dead one of the same shape and dtype, so its value takes
the dead one's slot.  A program that both packages rewrite has the same
`to_dict()` and the same renames.  `memory_optimize(..., rewrite=False)`
reports the liveness only.

What the rewrite saves differs by package.  The JAX package leaves the
reuse to XLA's buffer assignment.  In the port a slot is a name in the
executor's values: rebinding it drops the dead value, and the executor
already releases every value after its last reader (fluid/executor.py),
so the rewrite frees nothing the executor would keep.  It stays the
reference's surface, and a rewritten program runs to the same results.

Liveness is `analysis.dataflow.Liveness`, the engine behind the
analyzer's dead-code and hazard findings and the executor's releases,
so all of them share one definition of a variable's lifetime.
"""

from collections import defaultdict

from ..analysis.dataflow import Liveness
from ..core.types import VarType
from . import framework

__all__ = ["memory_optimize", "ControlFlowGraph"]


class ControlFlowGraph:
    """Liveness over the root block (reference:
    memory_optimization_transpiler.py ControlFlowGraph:33).  The uses,
    defs, live-in and live-out are `analysis.dataflow.Liveness`'s; this
    class keeps the transpiler's surface (the program, the persistable
    filter) and the reference's attribute names."""

    def __init__(self, program):
        self._program = program
        block = program.global_block()
        # Liveness leaves out "@EMPTY@", the backward's missing slot
        self._lv = Liveness(block.desc.ops)
        self._ops = self._lv.ops

    @property
    def _uses(self):
        return self._lv.uses

    @property
    def _defs(self):
        return self._lv.defs

    @property
    def _live_in(self):
        return self._lv.live_in

    @property
    def _live_out(self):
        return self._lv.live_out

    def analyze(self):
        self._lv.analyze()
        return self

    def reuse_candidates(self):
        """{op index: [names]}: the vars dead after each op whose slot a
        later def could take."""
        block = self._program.global_block()
        persist = {name for name, var in block.vars.items()
                   if getattr(var, "persistable", False)}
        return self._lv.reuse_candidates(persistable=persist)


def _sub_block_names(program):
    """The names any block but the root references: they cross block
    boundaries by name, so the root block's rename leaves them alone."""
    names = set()
    for block in program.blocks[1:]:
        for od in block.desc.ops:
            names.update(od.input_names())
            names.update(od.output_names())
        names.update(block.desc.vars.keys())
    return names


def _rewrite_for_reuse(program, cfg, skip_set):
    """Rename later temporaries' defs onto dead compatible temporaries
    (reference: the ControlFlowGraph rewrite loop).  Both vars are
    root-block, not persistable, dense (lod level 0), of one static
    shape and dtype, not fed, fetched or skipped, and no sub-block
    references them.  Returns {original name: adopted name}."""
    block = program.global_block()
    bd = block.desc
    sub_names = _sub_block_names(program)

    # a name defined more than once (an assign into an existing var)
    # stays out of the pool: its redefinition would overwrite an
    # adopter's live value; a name defined and never read is a sink (a
    # loss or metric fetched by name at run time, which the pass cannot
    # see) and stays untouched both ways
    def_count = defaultdict(int)
    used = set()
    for od in cfg._ops:
        for n in od.output_names():
            def_count[n] += 1
        used.update(od.input_names())
    sinks = {n for n, c in def_count.items() if n not in used}

    def eligible(name):
        vd = bd.vars.get(name)
        if vd is None or name in skip_set or name in sub_names:
            return False
        if def_count[name] != 1 or name in sinks:
            return False
        if vd.persistable or (vd.lod_level or 0) > 0:
            return False
        # shapes compare as signatures: a dynamic batch dim matches
        # positionally ((-1, 8) takes (-1, 8)'s slot)
        if not tuple(vd.shape or ()):
            return False
        if vd.type not in (None, VarType.DENSE_TENSOR):
            return False
        return True

    def signature(name):
        vd = bd.vars[name]
        return (tuple(vd.shape), vd.dtype)

    # feeds: root vars no op writes, not persistable; never renamed
    produced = set()
    for od in cfg._ops:
        produced.update(od.output_names())
    feeds = {n for n, vd in bd.vars.items()
             if not vd.persistable and n not in produced}

    pool = defaultdict(list)     # (shape, dtype) -> [dead names]
    renames = {}                 # original -> adopted name
    pooled = set()               # names in the pool now
    seen_defs = set()

    def resolve(n):
        return renames.get(n, n)

    for i, od in enumerate(cfg._ops):
        # the vars whose last use is this op join the pool (the
        # candidates on the original names, mapped through earlier
        # renames); this op's own dead defs join only after its outputs
        # are placed, so two outputs never take one slot
        dead_uses = (cfg._live_in[i] - cfg._live_out[i]) - cfg._defs[i]
        dead_defs = cfg._defs[i] - cfg._live_out[i]
        for orig in sorted(dead_uses):
            name = resolve(orig)
            if orig in feeds or not eligible(orig):
                continue
            if name not in pooled:
                pool[signature(orig)].append(name)
                pooled.add(name)
        for slot, names in od.outputs.items():
            for orig in names:
                if orig in seen_defs or orig in renames:
                    continue
                seen_defs.add(orig)
                if not eligible(orig) or orig in cfg._uses[i]:
                    continue
                sig = signature(orig)
                if pool[sig]:
                    adopted = pool[sig].pop()
                    pooled.discard(adopted)
                    renames[orig] = adopted
        for orig in sorted(dead_defs):
            name = resolve(orig)
            if not eligible(orig):
                continue
            if name not in pooled:
                pool[signature(orig)].append(name)
                pooled.add(name)

    if renames:
        for od in bd.ops:
            for names in list(od.inputs.values()) + \
                    list(od.outputs.values()):
                for j, n in enumerate(names):
                    if n in renames:
                        names[j] = renames[n]
        for orig in renames:
            bd.vars.pop(orig, None)
            block.vars.pop(orig, None)
        block.sync_with_desc()
    return renames


def memory_optimize(input_program=None, skip_opt_set=None,
                    print_log=False, rewrite=True):
    """reference: memory_optimization_transpiler.py memory_optimize.
    Rewrites the root block so that compatible later temporaries adopt
    dead temporaries' slots; returns (released map, renames).

    A fetch is a by-name lookup at run time, which the pass cannot see:
    sinks (losses, metrics) are left alone, but a fetched intermediate
    must be listed in `skip_opt_set`, or its slot may hold a later
    temporary's value.  `rewrite=False` reports the liveness only."""
    program = input_program or framework.default_main_program()
    cfg = ControlFlowGraph(program).analyze()
    candidates = cfg.reuse_candidates()
    renames = {}
    if rewrite:
        renames = _rewrite_for_reuse(program, cfg,
                                     set(skip_opt_set or ()))
    if print_log:
        for i, names in sorted(candidates.items()):
            print("op %d releases %s" % (i, names))
        for orig, adopted in sorted(renames.items()):
            print("reuse: %s -> %s" % (orig, adopted))
    return candidates, renames
