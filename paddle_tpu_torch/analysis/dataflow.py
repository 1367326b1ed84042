"""Def-use chains, liveness, dead code, and write/alias hazards over a
block's op list.

Counterpart of paddle_tpu/analysis/dataflow.py, whole: the same
liveness, the same dead-op fixpoint (which the `dce` rewrite pass
shares, so the lint and the transform never disagree about what is
removable) and the same hazard checks, with the same codes, severities
and locations for the same desc.

Diagnostics:

  D001 dead-op   an op none of whose outputs are live (no later read,
                 not persistable, not fetched).  Only computed when the
                 caller supplies `fetches`: a fetch is a by-name scope
                 lookup at run time, invisible to the IR, so without
                 the fetch set every sink (loss, metric) would be a
                 false positive.
  D002 dead-var  a VarDesc no op in any block reads or writes (prune
                 leftovers).  Advisory.
  H001 write-write race  two ops write the same var with no read in
                 between and no dataflow path ordering them: the first
                 value is lost, and under a scheduler that reorders ops
                 the final value is a coin flip.
  H002 read-write hazard  a var is overwritten (in place: an output
                 names an input, or the registry declares
                 `in_place_outputs`; or by a plain redefinition) while
                 another op reads it with no dataflow path to or from
                 the writer.  List order saves the program today; any
                 schedule that honors only data edges races.
  H003 in-place-not-aliased  an op slot the registry declares in-place
                 (ParamOut=Param) writing a different var than its
                 aliased input: the update forks the state instead of
                 advancing it.
"""

from collections import defaultdict

from ..ops import registry as op_registry
from .common import EMPTY, resolve_op_info
from .diagnostics import Diagnostic, Report, Severity

__all__ = ["Liveness", "analyze_block", "analyze_dataflow",
           "dead_op_indices", "liveness_peak_bytes",
           "liveness_timeline"]


def liveness_timeline(op_descs, var_bytes, final_live=(), top_n=0):
    """Per-op live-bytes series of `sum(var_bytes(name))` over each
    op's live set (live-in plus own defs): the activation-peak walk
    (`compile.opt_passes.activation_peak_bytes` runs it), parameterized
    only by the byte policy (`var_bytes`: name -> bytes, returning 0
    for names that don't count).

    Returns {"series": [bytes per op], "peak_bytes", "peak_op",
    "top_buffers"}; `top_buffers` (only when top_n > 0) lists the
    top-N nonzero buffers live at the peak, largest first, each
    blamed to its defining op — `{"name", "bytes", "def_op",
    "def_op_type"}` (def_op None for values live from outside the op
    list: feeds, carried state)."""
    lv = Liveness(op_descs, final_live=final_live).analyze()
    cache = {}

    def nbytes(name):
        b = cache.get(name)
        if b is None:
            b = cache[name] = var_bytes(name)
        return b

    series = []
    peak, peak_op, peak_live = 0, None, ()
    for i in range(len(lv.ops)):
        live = lv.live_in[i] | lv.defs[i]
        total = 0
        for n in live:
            total += nbytes(n)
        series.append(total)
        if total > peak:
            peak, peak_op, peak_live = total, i, live
    top = []
    if top_n and peak_live:
        def_sites = lv.def_sites()
        ranked = sorted(peak_live, key=lambda n: (-nbytes(n), n))
        for name in ranked[:int(top_n)]:
            if nbytes(name) <= 0:
                break
            defs = [d for d in def_sites.get(name, ())
                    if d <= peak_op]
            d = defs[-1] if defs else None
            top.append({"name": name, "bytes": int(nbytes(name)),
                        "def_op": d,
                        "def_op_type": (lv.ops[d].type
                                        if d is not None else None)})
    return {"series": series, "peak_bytes": peak, "peak_op": peak_op,
            "top_buffers": top}


def liveness_peak_bytes(op_descs, var_bytes, final_live=()):
    """(peak, op_index) — the timeline walk reduced to its peak; see
    `liveness_timeline` for the full series + blamed buffers."""
    tl = liveness_timeline(op_descs, var_bytes, final_live=final_live)
    return tl["peak_bytes"], tl["peak_op"]


class Liveness:
    """Forward liveness over a straight-line op list (the uses, defs,
    live-in and live-out of the reference's ControlFlowGraph).

    `final_live` seeds the live set after the last op (fetch targets,
    persistables)."""

    def __init__(self, op_descs, final_live=()):
        self.ops = list(op_descs)
        self.uses = [set(od.input_names()) - {EMPTY} for od in self.ops]
        self.defs = [set(od.output_names()) - {EMPTY} for od in self.ops]
        self.live_in = [set() for _ in self.ops]
        self.live_out = [set() for _ in self.ops]
        self.final_live = set(final_live)

    def analyze(self):
        changed = True
        n = len(self.ops)
        while changed:
            changed = False
            for i in reversed(range(n)):
                live_out = (self.live_in[i + 1] if i + 1 < n
                            else self.final_live)
                live_in = self.uses[i] | (live_out - self.defs[i])
                if live_in != self.live_in[i] or \
                        live_out != self.live_out[i]:
                    self.live_in[i] = live_in
                    self.live_out[i] = live_out
                    changed = True
        return self

    def reuse_candidates(self, persistable=()):
        """Vars dead after each op whose buffer a later def could
        reuse: {op_index: [names]}.  `persistable` names never release."""
        persistable = set(persistable)
        released = defaultdict(list)
        for i in range(len(self.ops)):
            dead = (self.live_in[i] | self.defs[i]) - self.live_out[i]
            for name in sorted(dead - persistable):
                released[i].append(name)
        return dict(released)

    # -- def-use chains ------------------------------------------------------
    def def_sites(self):
        """name -> ordered op indices that write it."""
        sites = defaultdict(list)
        for i, ds in enumerate(self.defs):
            for n in ds:
                sites[n].append(i)
        return dict(sites)

    def use_sites(self):
        """name -> ordered op indices that read it."""
        sites = defaultdict(list)
        for i, us in enumerate(self.uses):
            for n in us:
                sites[n].append(i)
        return dict(sites)

    def reachability(self):
        """Per-op bitset of ops reachable through def-use edges
        (i reaches j if j transitively consumes a value i defines).
        Edges only go forward in list order, so one reverse sweep
        suffices.  Returns a list of ints: bit j set in reach[i] means
        i reaches j (every op reaches itself)."""
        n = len(self.ops)
        last_def = {}
        succs = [[] for _ in range(n)]
        for j in range(n):
            for name in self.uses[j]:
                i = last_def.get(name)
                if i is not None:
                    succs[i].append(j)
            for name in self.defs[j]:
                last_def[name] = j
        reach = [0] * n
        for i in reversed(range(n)):
            r = 1 << i
            for j in succs[i]:
                r |= reach[j]
            reach[i] = r
        return reach


def _in_place_pairs(od):
    """[(out_slot, in_slot)] pairs that alias for this op: registry
    `in_place_outputs` declarations, plus any output that names the
    same var as an input (the by-name in-place idiom: optimizer state,
    scale-into-self).  The aliased input slot is "FooOut" -> "Foo",
    falling back to the prefix convention for abbreviated output slots
    (ftrl's "SquaredAccumOut" aliases "SquaredAccumulator")."""
    declared = ()
    if op_registry.has_op(od.type):
        declared = op_registry.get_op_info(od.type).in_place_outputs
    pairs = []
    for out_slot in declared:
        base = out_slot[:-3] if out_slot.endswith("Out") else out_slot
        if base in od.inputs:
            in_slot = base
        else:
            matches = sorted(s for s in od.inputs if s.startswith(base))
            in_slot = matches[0] if matches else None
        pairs.append((out_slot, in_slot))
    return pairs


def _attr_name_refs(od):
    """Names an op references through plain STRING attrs — the
    `recurrent` op wires its sub-block through name-list attrs
    (mem_pre_names/mem_post_names/step_input_names/closure_names/
    step_output_names), which slot-only scanning cannot see; killing
    the body ops that define those names would silently break the
    recurrence.  Conservative by construction: a cosmetic string attr that
    happens to match a var name only keeps that var alive."""
    refs = set()
    for v in od.attrs.values():
        if isinstance(v, str):
            refs.add(v)
        elif isinstance(v, (list, tuple)):
            refs.update(x for x in v if isinstance(x, str))
    return refs


def _block_name_sets(desc):
    """Per-block sets of every name the block references (op slots +
    string attrs + declared vars) — computed ONCE per program; a
    block's cross-block live set is the union of every OTHER block's
    set."""
    sets = []
    for b in desc.blocks:
        names = set(b.vars)
        for od in b.ops:
            names.update(od.input_names())
            names.update(od.output_names())
            names.update(_attr_name_refs(od))
        names.discard(EMPTY)
        sets.append(names)
    return sets


def _block_sub_reads(desc, skip_idx, name_sets=None):
    """Names referenced by any block other than `skip_idx` — those
    cross block boundaries by name and must be treated as live."""
    if name_sets is None:
        name_sets = _block_name_sets(desc)
    names = set()
    for idx, s in enumerate(name_sets):
        if idx != skip_idx:
            names |= s
    return names


def _is_effectful(od):
    """Ops the dead-code pass must never remove-or-flag: host ops
    (print/save/send have side effects), unregistered types (already a
    V001), and anything holding a sub-block."""
    info = resolve_op_info(od.type)
    if info is None or not info.jittable:
        return True
    from ..core.desc import BlockRef

    for v in od.attrs.values():
        if isinstance(v, BlockRef) or (isinstance(v, (list, tuple))
                                       and any(isinstance(x, BlockRef)
                                               for x in v)):
            return True
    return False


def _referenced_names(desc):
    """Every name any op in any block reads or writes — the D002
    universe, computed ONCE per program (analyze_dataflow passes it
    down).  String attr refs count: the recurrent op names its
    carries through attrs, and sweeping those VarDescs would break
    the recurrence."""
    referenced = set()
    for b in desc.blocks:
        for od in b.ops:
            referenced.update(od.input_names())
            referenced.update(od.output_names())
            referenced.update(_attr_name_refs(od))
    return referenced


def dead_op_indices(desc, block_idx, fetches, name_sets=None):
    """The D001 dead set for one block: op indices none of whose
    outputs are ever read by a live op, fetched, persisted, or
    referenced by another block.  Iterates to a fixpoint (killing an
    op may kill its producers); effectful ops (host side effects,
    sub-block holders, unregistered types) are never dead.

    Shared by the D001 diagnostic below and the dead-op-elimination
    rewrite pass (`compile.passes`), so the lint and the transform can
    never disagree about what is removable.  Returns
    (dead_index_set, Liveness).

    The live seed takes the WHOLE cross-block read set, not just the
    names this block declares: control-flow carry variables (a while
    body writing `acc` declared in its parent) are referenced by the
    parent op's slots but declared elsewhere; intersecting with
    `bd.vars` would make the body's carried writes look dead."""
    bd = desc.block(block_idx)
    persistable = {n for n, vd in bd.vars.items() if vd.persistable}
    sub_reads = _block_sub_reads(desc, block_idx, name_sets=name_sets)
    live_seed = set(persistable) | sub_reads | set(fetches or ())
    lv = Liveness(bd.ops, final_live=live_seed).analyze()
    dead = set()
    changed = True
    while changed:
        changed = False
        needed = set(live_seed)
        for i in reversed(range(len(lv.ops))):
            if i in dead:
                continue
            if _is_effectful(lv.ops[i]) or (lv.defs[i] & needed):
                needed |= lv.uses[i]
            else:
                dead.add(i)
                changed = True
    return dead, lv


def analyze_block(desc, block_idx, report, fetches=None,
                  referenced=None, name_sets=None):
    """Dead-code + hazard diagnostics for one block."""
    bd = desc.block(block_idx)

    # -- dead ops (only with a fetch set; see module docstring) -------------
    if fetches is not None:
        # without a fetch set every sink is live by assumption; with
        # one, the shared fixpoint names the removable set (its
        # Liveness doubles as this block's analysis — the hazard
        # checks below only read def/use structure, not the seed)
        dead, lv = dead_op_indices(desc, block_idx, fetches,
                                   name_sets=name_sets)
        for i in sorted(dead):
            od = lv.ops[i]
            outs = sorted(lv.defs[i])
            report.add(Diagnostic(
                "D001", Severity.WARNING,
                "dead op: output(s) %s are never read, fetched, or "
                "persisted" % (", ".join(map(repr, outs)) or "(none)"),
                block_idx=block_idx, op_index=i, op_type=od.type,
                var_name=outs[0] if outs else None))
    else:
        persistable = {n for n, vd in bd.vars.items()
                       if vd.persistable}
        sub_reads = _block_sub_reads(desc, block_idx,
                                     name_sets=name_sets)
        lv = Liveness(bd.ops,
                      final_live=persistable | sub_reads).analyze()

    # -- dead vars ----------------------------------------------------------
    if referenced is None:
        referenced = _referenced_names(desc)
    for name, vd in bd.vars.items():
        if name in referenced or vd.persistable:
            continue
        if fetches is not None and name in fetches:
            continue
        report.add(Diagnostic(
            "D002", Severity.INFO,
            "var is declared but no op reads or writes it",
            block_idx=block_idx, var_name=name))

    # -- write/alias hazards ------------------------------------------------
    reach = lv.reachability()

    def ordered(a, b):
        return bool(reach[a] & (1 << b)) or bool(reach[b] & (1 << a))

    def_sites = lv.def_sites()
    use_sites = lv.use_sites()

    for name, writers in def_sites.items():
        if len(writers) < 2:
            continue
        for a, b in zip(writers, writers[1:]):
            # a read anywhere in (a, b] consumes the first value: the
            # overwrite is an intentional in-place chain or var reuse,
            # not a lost update — but each such reader must itself be
            # ordered against the overwrite, else it races it (the
            # read-write half of the hazard detector)
            between = [u for u in use_sites.get(name, ())
                       if a < u <= b]
            if not between:
                if not ordered(a, b):
                    report.add(Diagnostic(
                        "H001", Severity.ERROR,
                        "write-write race: op %d (%s) and op %d (%s) "
                        "both write %r with no read in between and no "
                        "dataflow path ordering them — the first "
                        "value is lost"
                        % (a, lv.ops[a].type, b, lv.ops[b].type, name),
                        block_idx=block_idx, op_index=b,
                        op_type=lv.ops[b].type, var_name=name))
                continue
            if name in lv.uses[b]:
                continue  # in-place overwrite: the alias loop below
                          # checks every reader against the writer
            for u in between:
                if u == b or ordered(u, b):
                    continue
                report.add(Diagnostic(
                    "H002", Severity.WARNING,
                    "overwrite of %r by op %d (%s) races op %d (%s), "
                    "which reads the previous value with no dataflow "
                    "path to the overwrite; only list order protects "
                    "this today"
                    % (name, b, lv.ops[b].type, u, lv.ops[u].type),
                    block_idx=block_idx, op_index=b,
                    op_type=lv.ops[b].type, var_name=name))

    for w, od in enumerate(lv.ops):
        in_place_names = set()
        for out_slot, in_slot in _in_place_pairs(od):
            outs = od.output(out_slot)
            ins = od.input(in_slot) if in_slot else []
            for k, out_name in enumerate(outs):
                if out_name == EMPTY:
                    continue
                in_name = ins[k] if k < len(ins) else None
                if in_name is not None and in_name != out_name:
                    report.add(Diagnostic(
                        "H003", Severity.WARNING,
                        "slot %r is declared in-place over %r but "
                        "writes %r while reading %r — the update "
                        "forks the state instead of advancing it"
                        % (out_slot, in_slot, out_name, in_name),
                        block_idx=block_idx, op_index=w,
                        op_type=od.type, var_name=out_name))
                else:
                    in_place_names.add(out_name)
        # the by-name idiom: any output that is also an input
        in_place_names |= (lv.defs[w] & lv.uses[w])

        for name in sorted(in_place_names):
            for r in use_sites.get(name, ()):
                if r == w or ordered(w, r):
                    continue
                report.add(Diagnostic(
                    "H002", Severity.WARNING,
                    "in-place update of %r races op %d (%s), which "
                    "reads it with no dataflow path to or from the "
                    "writer; only list order protects this today"
                    % (name, r, lv.ops[r].type),
                    block_idx=block_idx, op_index=w, op_type=od.type,
                    var_name=name))
    return report


def analyze_dataflow(desc, fetches=None, suppress=(), report=None):
    """Dead-code + hazard diagnostics for every block of a ProgramDesc
    (or Program); returns a `Report`."""
    desc = getattr(desc, "desc", desc)
    report = report if report is not None else Report(suppress=suppress)
    referenced = _referenced_names(desc)
    name_sets = _block_name_sets(desc)
    for block_idx in range(len(desc.blocks)):
        analyze_block(desc, block_idx, report,
                      fetches=fetches if block_idx == 0 else None,
                      referenced=referenced, name_sets=name_sets)
    return report
