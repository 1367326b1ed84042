"""May-alias and last-use donation-safety analysis over the Program IR.

Counterpart of paddle_tpu/analysis/alias.py, over the port's dataflow
(`analysis/dataflow.py`).  The JAX executor donates the buffers of a
jitted segment to XLA, which reuses them for its outputs; the port's
executor donates the state tensors a captured segment updates: the new
value is written into the scope tensor's own storage, so the graph's
output is that storage and nothing is replaced in the scope
(fluid/executor.py).  Either way, donating a buffer something still
reads is wrong, and this module is the proof obligation: an abstract
interpretation over block 0, layered on `dataflow.Liveness`, that
classifies every buffer per segment as provably donatable or not and
explains each refusal with a stable code.

The safety argument, per candidate buffer `n` in segment `i`:

  * reads INSIDE the donating segment are safe: the segment's ops read
    it in order before the write;
  * hazards lie outside it: a later segment's op reads `n` (last-use
    violation), a fetch returns `n` to the caller (A003), a sub-block
    references `n` by name (A002, invisible to block-0 liveness), `n`
    is persistable (the scope re-reads it on every future `run()`), or
    `n` is a feed (the caller owns that buffer).

Segments are the port executor's: maximal runs of capturable ops
(`OpInfo.capturable`), which equal the JAX executor's jittable runs
wherever the two marks agree (`ops.registry.capture_exceptions()`
lists where they do not).

Diagnostic codes, as on the JAX side:

  A001  declared in-place slot whose input buffer strands: the op
        forks the output under a new name (`Moment1` -> `Moment1__fork`)
        or omits the declared slot, so the conservative
        `outputs ∩ reads` donation never fires.
  A002  read-after-donation hazard: a later op or a sub-block reads a
        buffer the plan would donate.  Always an error; by construction
        `analyze_donation` never plans one, and A002 surfaces when
        `DonationPlan.verify` re-checks a plan against a program that
        changed after planning.
  A003  a fetch aliases a donatable buffer: the donation is declined.
  A004  in-place update stranded outside a captured segment: eager
        execution never donates, so the declared reuse cannot happen.
  A005  donation requested where `backend_safe` is false: `auto`
        degrades to `conservative`.  The executor passes the persistent
        cache's verdict, `pcache.donation_aliasing_safe()`, as the JAX
        executor does; a port entry holds a plan, which is captured anew
        with its donation, so the verdict is True and A005 is reached
        only by passing False.

The executor consumes the `DonationPlan` when it plans a program,
behind `FLAGS_donation=auto|conservative|off` (default `auto`);
`lint_cli --donation` lints it.
"""

from .common import EMPTY
from .dataflow import (Liveness, _block_sub_reads, _in_place_pairs)
from .diagnostics import Diagnostic, Report, Severity
from ..utils import flags

__all__ = ["MODES", "DonationPlan", "analyze_donation", "donation_mode",
           "state_donation"]

MODES = ("auto", "conservative", "off")


def donation_mode(value=None):
    """Normalize a requested donation mode; None reads FLAGS_donation.
    Unknown strings fall back to "auto" (the flag default) rather than
    raising — a typo'd env var must not take down a training job."""
    if value is None:
        try:
            value = flags.get_flag("donation")
        except Exception:
            value = "auto"
    value = str(value or "auto").strip().lower()
    return value if value in MODES else "auto"


def state_donation(default=True):
    """Whole-state donation decision for the mesh trainers
    (`make_parallel_step`, `make_overlapped_dp_step`, `SpmdTrainer`):
    False under FLAGS_donation=off, `default` otherwise.  A mesh step
    donates its whole state as one argument, so the plan's only say is
    the off switch: with it on, the port's captured mesh step writes
    each state tensor's new value into the old one's storage
    (parallel/captured.py)."""
    return False if donation_mode() == "off" else bool(default)


class DonationPlan:
    """The analysis result: per-segment donate sets plus the
    per-buffer classification a memory audit prices.

    segments: one dict per executor segment —
        {"index", "jit", "start", "end", "conservative", "widened",
         "declined": [{"name", "code", "reason"}]}
      `conservative` is the executor's own `outputs ∩ reads` set (in
      executor output order); `widened` are the extra provably-dead
      buffers `auto` mode adds.  start/end are block-0 op indices —
      `verify()` re-checks reads against them.
    entries: the per-op in-place walk (one row per declared in-place
      pair) — {"name", "op_index", "op_type", "slot", "segment",
      "status": donated|reclaimable|pinned|skip, "code", "reason"}.
      `reclaimable` rows carry the A-code explaining the refusal
      (code None only under mode=off, where the refusal IS the flag).
    """

    def __init__(self, mode, effective_mode, backend_safe, report,
                 segments, entries):
        self.mode = mode
        self.effective_mode = effective_mode
        self.backend_safe = backend_safe
        self.report = report
        self.segments = segments
        self.entries = entries

    def donate(self, i):
        """The names segment `i` donates under the effective mode."""
        if self.effective_mode == "off":
            return ()
        seg = self.segments[i]
        if self.effective_mode == "conservative":
            return tuple(seg["conservative"])
        return tuple(seg["conservative"]) + tuple(seg["widened"])

    def widened(self, i):
        """The names `auto` adds beyond conservative for segment `i`
        (empty under conservative/off)."""
        if self.effective_mode != "auto":
            return ()
        return tuple(self.segments[i]["widened"])

    def fingerprint(self):
        """Stable content hash of the effective donation decision —
        folds into compile-cache keys so a plan change re-keys."""
        import hashlib

        h = hashlib.sha256()
        h.update(self.effective_mode.encode())
        for i in range(len(self.segments)):
            h.update(b"|%d:" % i)
            h.update(",".join(self.donate(i)).encode())
        return h.hexdigest()[:16]

    def verify(self, program, fetches=(), report=None):
        """Re-check every planned donation against `program` as it is
        NOW.  A donation planned earlier becomes a read-after-donation
        hazard (A002, error) when a later op or a sub-block reads the
        buffer at-or-after the recorded segment end, and an A003
        decline when a fetch now aliases it.  Returns a Report; use it
        before replaying a cached plan over a rewritten program."""
        report = report if report is not None else Report()
        desc = getattr(program, "desc", program)
        bd = desc.block(0)
        fetch_set = set(fetches or ())
        lv = Liveness(bd.ops, final_live=fetch_set).analyze()
        use_sites = lv.use_sites()
        sub_reads = _block_sub_reads(desc, 0)
        for seg in self.segments:
            for name in tuple(seg["conservative"]) + tuple(seg["widened"]):
                late = [u for u in use_sites.get(name, ())
                        if u >= seg["end"]]
                if late or name in sub_reads:
                    where = ("op %d" % late[0]) if late else "a sub-block"
                    report.add(Diagnostic(
                        "A002", Severity.ERROR,
                        "read-after-donation hazard: segment %d donates "
                        "%r but %s reads it after the segment ends at op "
                        "%d" % (seg["index"], name, where, seg["end"]),
                        block_idx=0,
                        op_index=late[0] if late else None,
                        var_name=name))
                elif name in fetch_set:
                    report.add(Diagnostic(
                        "A003", Severity.WARNING,
                        "fetch %r aliases a buffer segment %d donates; "
                        "the fetch would return a deleted array"
                        % (name, seg["index"]),
                        block_idx=0, var_name=name))
        return report

    def to_dict(self):
        return {
            "mode": self.mode,
            "effective_mode": self.effective_mode,
            "backend_safe": self.backend_safe,
            "fingerprint": self.fingerprint(),
            "segments": [dict(s) for s in self.segments],
            "entries": [dict(e) for e in self.entries],
            "report": self.report.to_dict(),
        }


def _find_vd(desc, bd, name):
    """VarDesc lookup through the parent chain (executor idiom)."""
    cur = bd
    while True:
        if name in cur.vars:
            return cur.vars[name]
        if cur.parent_idx < 0:
            return None
        cur = desc.block(cur.parent_idx)


def analyze_donation(program, fetches=(), feeds=(), mode=None,
                     backend_safe=None, suppress=(), report=None,
                     publish=False, origin="alias"):
    """Whole-program donation-safety analysis; returns a DonationPlan.

    program: a Program or ProgramDesc (block 0 is analyzed, segmented
        exactly as the port's executor segments it).
    fetches: runtime fetch names — a fetch is a host-side read the IR
        cannot see; donating a fetched buffer returns a deleted array.
    feeds: runtime feed names — feed buffers are caller-owned (the
        device-prefetch path re-uses them across steps), never donated
        beyond what the caller's own signature says.
    mode: "auto" | "conservative" | "off"; None reads FLAGS_donation.
    backend_safe: tri-state.  True/False is the backend's verdict
        (False degrades `auto` to `conservative` with an A005; the
        executor passes True); None means "do not consult the backend":
        static audits and `lint_cli` stay zero-device and emit no A005.
    """
    # lazy import: the executor imports analysis lazily and vice versa
    from ..fluid.executor import _segment_block

    desc = getattr(program, "desc", program)
    bd = desc.block(0)
    mode = donation_mode(mode)
    report = report if report is not None else Report(suppress=suppress)

    effective = mode
    if mode == "auto" and backend_safe is False:
        report.add(Diagnostic(
            "A005", Severity.WARNING,
            "donation mode 'auto' requested but this backend's "
            "executable reload does not preserve donation aliasing "
            "(backend_safe is false); degrading to "
            "'conservative'", block_idx=0))
        effective = "conservative"

    fetch_set = set(fetches or ())
    feed_set = set(feeds or ())
    segments = _segment_block(bd.ops)
    lv = Liveness(bd.ops, final_live=fetch_set).analyze()
    use_sites = lv.use_sites()
    def_sites = lv.def_sites()
    sub_reads = _block_sub_reads(desc, 0)
    persistable = {n for n, vd in bd.vars.items() if vd.persistable}

    seg_rows, entries = [], []
    base = 0
    for si, (jit_ok, ops) in enumerate(segments):
        end = base + len(ops)
        # replicate the executor's per-segment signature exactly
        # (executor._CompiledProgram._analyze): first-read-before-
        # write order for reads, write order for writes
        reads, writes, seen_writes = [], [], set()
        for od in ops:
            for n in od.input_names():
                if n not in seen_writes and n not in reads:
                    reads.append(n)
            for n in od.output_names():
                if n != EMPTY:
                    seen_writes.add(n)
                    if n not in writes:
                        writes.append(n)
        needed_later = set(fetch_set)
        for od in bd.ops[end:]:
            needed_later.update(od.input_names())
        outputs = [n for n in writes
                   if n in needed_later or n in persistable]
        conservative = tuple(n for n in outputs if n in reads) \
            if jit_ok else ()
        conservative_set = set(conservative)

        # -- widening: extra provably-dead reads `auto` donates -------
        widened, declined = [], []
        if jit_ok:
            for n in reads:
                if n in conservative_set or n in feed_set \
                        or n in persistable:
                    # persistable: live at entry of EVERY future run()
                    # — the scope re-reads it; a forked in-place slot
                    # lands here and gets its A001 in the entry walk
                    continue
                if not any(d < base for d in def_sites.get(n, ())):
                    # read-before-def: the value comes from the
                    # caller's feed env (declared in `feeds` or not) —
                    # that buffer is caller-owned, never ours to donate
                    continue
                if any(u >= end for u in use_sites.get(n, ())):
                    continue  # a later op still reads it
                if n in sub_reads:
                    d = Diagnostic(
                        "A002", Severity.ERROR,
                        "a sub-block reads %r by name; donating it in "
                        "segment %d would hand the sub-block a deleted "
                        "buffer" % (n, si), block_idx=0, var_name=n)
                    report.add(d)
                    declined.append({"name": n, "code": "A002",
                                     "reason": d.message})
                    continue
                if n in fetch_set:
                    d = Diagnostic(
                        "A003", Severity.WARNING,
                        "fetch %r aliases a donatable buffer in segment "
                        "%d; donation declined (the fetch would return "
                        "a deleted array)" % (n, si),
                        block_idx=0, var_name=n)
                    report.add(d)
                    declined.append({"name": n, "code": "A003",
                                     "reason": d.message})
                    continue
                widened.append(n)

        seg_rows.append({
            "index": si, "jit": jit_ok, "start": base, "end": end,
            "conservative": conservative, "widened": tuple(widened),
            "declined": declined,
        })

        # -- the per-op in-place walk a memory audit prices ----------
        for off, od in enumerate(ops):
            op_idx = base + off
            for out_slot, in_slot in _in_place_pairs(od):
                outs = od.output(out_slot)
                ins = od.input(in_slot) if in_slot else []
                for k, in_name in enumerate(ins):
                    if in_name == EMPTY:
                        continue
                    out_name = outs[k] if k < len(outs) else None
                    entry = {"name": in_name, "op_index": op_idx,
                             "op_type": od.type, "slot": out_slot,
                             "segment": si, "status": "skip",
                             "code": None, "reason": None}
                    entries.append(entry)
                    if out_name == in_name \
                            and in_name in conservative_set:
                        if effective == "off":
                            entry["status"] = "reclaimable"
                            entry["reason"] = (
                                "donation disabled "
                                "(FLAGS_donation=off); the buffer is "
                                "provably donatable")
                        else:
                            entry["status"] = "donated"
                        continue
                    if in_name in fetch_set or any(
                            u > op_idx
                            for u in use_sites.get(in_name, ())):
                        entry["status"] = "pinned"  # genuinely live
                        continue
                    if out_name == in_name and not jit_ok:
                        entry["status"] = "reclaimable"
                        entry["code"] = "A004"
                        entry["reason"] = (
                            "in-place update runs in a non-capturable "
                            "segment — eager execution never donates")
                        report.add(Diagnostic(
                            "A004", Severity.WARNING,
                            entry["reason"],
                            block_idx=0, op_index=op_idx,
                            op_type=od.type, var_name=in_name))
                    elif out_name is None:
                        entry["status"] = "reclaimable"
                        entry["code"] = "A001"
                        entry["reason"] = (
                            "declared in-place slot %r is absent from "
                            "the op; the input buffer is stranded"
                            % out_slot)
                        report.add(Diagnostic(
                            "A001", Severity.WARNING,
                            entry["reason"],
                            block_idx=0, op_index=op_idx,
                            op_type=od.type, var_name=in_name))
                    elif out_name != in_name:
                        entry["status"] = "reclaimable"
                        entry["code"] = "A001"
                        entry["reason"] = (
                            "in-place slot %r forks %r -> %r; the update sees "
                            "two buffers, no donation"
                            % (out_slot, in_name, out_name))
                        report.add(Diagnostic(
                            "A001", Severity.WARNING,
                            entry["reason"],
                            block_idx=0, op_index=op_idx,
                            op_type=od.type, var_name=in_name))
                    # else: same-name dead write inside a captured segment
                    # that never leaves it — nothing to donate ("skip")
        base = end

    if publish:
        report.publish(origin=origin)
    return DonationPlan(mode, effective, backend_safe, report,
                        seg_rows, entries)
