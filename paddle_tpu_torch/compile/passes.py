"""Program-level IR rewrite passes: a verified Program -> Program pass
pipeline.

Counterpart of paddle_tpu/compile/passes.py, whole.  It grows
`analysis.dataflow` from a lint into a rewrite engine: the dead-code
diagnostics (D001/D002) become transforms, with constant folding of
shape and fill ops and common-subexpression elimination of pure ops
over the def-use chains.  Every pass:

  * works on a clone: the caller's Program is never changed;
  * is verified with `analysis.verifier` before and after it runs (a
    pass that leaves a malformed desc raises `ProgramVerificationError`
    naming the op and var; it never reaches a kernel);
  * records an explain entry (ops before and after, what was removed
    or rewritten): `PassManager(explain=True)` and `explain_text()`.

For the same program, spec and fetches, each pass gives the desc the
JAX pass gives.  The executor runs the pipeline under
FLAGS_compile_passes (fluid/executor.py).

Cleanup passes (the "default" pipeline, in order):

  dce   dead-op elimination: the D001 fixpoint set, removed.  Needs the
        fetch set (a fetch is a by-name lookup at run time, invisible
        to the IR); without it the pass declines.
  fold  constant folding of shape and fill ops whose result the var
        metas pin: `shape` of a fully static var becomes
        `assign_value`; `fill_zeros_like` and
        `fill_constant_batch_size_like` over static inputs become
        `fill_constant`.
  cse   common-subexpression elimination over pure ops (device ops, no
        random stream, no in-place aliasing, no sub-blocks, single-def
        outputs) by value numbering on the def-use chains: a later op
        computing the same (type, attrs, input versions) expression is
        deleted and its uses renamed to the first result.  The result
        is the same bits wherever the op gives the same bits on every
        call.
  dve   dead-var elimination: VarDescs no op in any block references
        (D002), dropped.  Runs last, to sweep what dce and cse left.

Cost-model-guided passes (compile/opt_passes.py; opt-in, appended to
the spec: "default+layout+fuse"):

  layout      the NCHW->NHWC rewrite of conv, pool and batch-norm
              chains, accepted only when the roofline's tiled byte
              model predicts a strictly lower ideal floor.
  fuse        single-use elementwise, activation and bias chains into
              `fused_elemwise_chain` ops (fluid/fusion.py);
              `fuse:cap=N` bounds a group's size.
  auto_remat  activation checkpointing over the backward region
              (fluid/recompute.py) when the activation-peak estimate
              exceeds the budget; `auto_remat:stride=N:budget_gb=G`.

Spec grammar: pass tokens separated by ',' or '+' ("default" expands to
the cleanup pipeline), each optionally carrying ':'-joined `key=value`
knobs: "default+fuse:cap=8".  The knobs fold into `pipeline_id`.
"""

import json
import time
from collections import OrderedDict

from ..analysis import dataflow
from ..analysis.common import EMPTY, resolve_op_info
from ..analysis.diagnostics import Report
from ..analysis.verifier import verify_program
from ..core.desc import OpDesc, ProgramDesc
from .fingerprint import _jsonable

__all__ = ["PassManager", "optimize_program", "available_passes",
           "register_pass", "pipeline_id", "RewritePass",
           "DEFAULT_PIPELINE"]

# the JAX pipeline's version: part of pipeline_id, which the
# fingerprints of both packages fold in
_PIPELINE_VERSION = 1

# the dtypes numpy classifies as floating, as the JAX pass tests them
# (numpy does not count bfloat16 among them)
_FLOAT_DTYPES = ("float16", "float32", "float64")


def program_copy(desc):
    """A Program over a deep copy of ProgramDesc `desc`."""
    from ..fluid import framework

    return framework.Program.from_desc(
        ProgramDesc.parse_from_string(desc.serialize_to_string()))


class _PassContext:
    """What a pass may rely on: the run's fetch names (by-name scope
    lookups the IR cannot see), the per-program keep set (names a
    rewrite must never remove or rename away: fetches, persistables,
    names other blocks reference) and the Program wrapper (`program`)
    for passes built on Program-level machinery (convert_layout).
    `note` lets a pass say why it declined to act (surfaced in the
    PassManager records)."""

    def __init__(self, desc, fetches, program=None):
        self.desc = desc
        self.fetches = set(fetches or ())
        self.program = program
        self.note = None

    def keep_names(self, block_idx):
        bd = self.desc.block(block_idx)
        keep = set(self.fetches)
        keep |= {n for n, vd in bd.vars.items() if vd.persistable}
        keep |= dataflow._block_sub_reads(self.desc, block_idx)
        return keep


def _fmt_opt(value):
    if isinstance(value, float):
        # repr round-trips exactly (no %g-style truncation that could
        # alias two knob values onto one pipeline_id); strip the '+'
        # from exponents: '+' separates tokens in the spec grammar, so
        # '2e+06' would not re-parse ('2e06' does)
        return repr(value).replace("e+", "e")
    return "%s" % value


class RewritePass:
    """One Program->Program rewrite.  Subclasses set `name` and
    implement `run(desc, ctx) -> explain-dict-or-None` (None/empty
    means "changed nothing").

    Knobbed passes declare `options = {"knob": (coerce, default)}`;
    the spec grammar `name:knob=value` instantiates a configured copy
    and the explicit knobs join the pass's `spec_token` (and so
    `pipeline_id`)."""

    name = None
    options = {}

    def __init__(self, **opts):
        unknown = sorted(set(opts) - set(self.options))
        if unknown:
            raise ValueError(
                "pass %r has no option(s) %s; available: %s"
                % (self.name, unknown, sorted(self.options)))
        self._explicit = {}
        for key, (coerce, default) in self.options.items():
            if key in opts:
                value = coerce(opts[key])
                if value != default:
                    # an explicitly spelled default ("fuse:cap=0") is
                    # the same pipeline as the bare pass: it must not
                    # mint a distinct spec_token or pipeline_id
                    self._explicit[key] = value
            else:
                value = default
            setattr(self, key, value)
        self.validate_options()

    def validate_options(self):
        """Subclass hook: raise ValueError for invalid knob values
        (called at construction, so a bad spec never becomes a
        pipeline)."""

    @property
    def spec_token(self):
        """Canonical spec token: the pass name plus any explicitly-set
        knobs, sorted — the unit `pipeline_id` is built from."""
        if not self._explicit:
            return self.name
        return self.name + "".join(
            ":%s=%s" % (k, _fmt_opt(self._explicit[k]))
            for k in sorted(self._explicit))

    def with_options(self, opts):
        """A configured instance of this pass's class (the registry
        holds default-configured singletons)."""
        if not opts:
            return self
        return type(self)(**opts)

    def run(self, desc, ctx):
        raise NotImplementedError


class DeadOpElimination(RewritePass):
    name = "dce"

    def run(self, desc, ctx):
        if not ctx.fetches:
            # the D001 diagnostic's contract: a fetch is a by-name
            # lookup at run time the IR cannot see; without the fetch
            # set every non-persisted sink would look dead, so the
            # rewrite (like the lint) declines to act
            return None
        removed = []
        for block_idx in range(len(desc.blocks)):
            fetches = ctx.fetches if block_idx == 0 else ()
            dead, _ = dataflow.dead_op_indices(desc, block_idx, fetches)
            if not dead:
                continue
            bd = desc.block(block_idx)
            removed.extend(
                {"block": block_idx, "op_index": i, "type": bd.ops[i].type}
                for i in sorted(dead))
            bd.ops = [od for i, od in enumerate(bd.ops)
                      if i not in dead]
        return {"removed_ops": removed} if removed else None


class DeadVarElimination(RewritePass):
    name = "dve"

    def run(self, desc, ctx):
        referenced = dataflow._referenced_names(desc)
        referenced |= ctx.fetches
        removed = []
        for bd in desc.blocks:
            for name in [n for n, vd in bd.vars.items()
                         if n not in referenced and not vd.persistable]:
                del bd.vars[name]
                removed.append({"block": bd.idx, "var": name})
        return {"removed_vars": removed} if removed else None


def _static_shape(vd):
    """The var's fully-static shape tuple, or None when any dim is
    dynamic/unknown."""
    if vd is None or vd.shape is None:
        return None
    if any(int(s) < 0 for s in vd.shape):
        return None
    return tuple(int(s) for s in vd.shape)


class ConstantFold(RewritePass):
    """Fold shape/fill ops whose result the var metas already pin.

    Trusts the recorded VarDescs, the contract the verifier's V005/V006
    re-derivation enforces (a feed that violates a declared fully
    static shape is already outside the IR's meaning; dynamic dims are
    -1 and never fold).  Run the pipeline with verify_level="full" to
    check the metas first."""

    name = "fold"

    def run(self, desc, ctx):
        folded = []
        for bd in desc.blocks:
            for i, od in enumerate(bd.ops):
                new = self._fold_one(bd, od)
                if new is not None:
                    folded.append({"block": bd.idx, "op_index": i,
                                   "from": od.type, "to": new.type})
                    bd.ops[i] = new
        return {"folded_ops": folded} if folded else None

    @staticmethod
    def _vd(bd, name):
        # this block's own VarDescs, as on the JAX side
        return bd.vars.get(name)

    @staticmethod
    def _amp_rewrites(dtype):
        """Under FLAGS_amp_bf16 (which `fluid.amp.bf16_guard()` sets) a
        float op's run-time dtype can be bfloat16 while the desc records
        f32: `fill_zeros_like` follows its input's actual dtype, so
        folding it to a fill_constant of the recorded dtype would change
        the program.  Float fills do not fold while AMP is on (integer
        and bool fills and the `shape` fold are unaffected).  The
        executor runs the pipeline inside the run, under the policy the
        run uses, and keys its cache of rewritten programs by it."""
        from ..utils import flags

        if not flags.get_flag("amp_bf16"):
            return False
        return dtype in _FLOAT_DTYPES

    def _fold_one(self, bd, od):
        if od.type == "shape":
            names = od.input("Input")
            vd = self._vd(bd, names[0]) if names else None
            shape = _static_shape(vd)
            if shape is None or vd.lod_level:
                return None
            return OpDesc("assign_value", {},
                          {"Out": list(od.output("Out"))},
                          {"shape": [len(shape)], "dtype": "int32",
                           "values": [int(s) for s in shape]})
        if od.type == "fill_zeros_like":
            names = od.input("X")
            vd = self._vd(bd, names[0]) if names else None
            shape = _static_shape(vd)
            if shape is None or vd.lod_level or vd.dtype is None:
                return None
            if self._amp_rewrites(vd.dtype):
                return None
            return OpDesc("fill_constant", {},
                          {"Out": list(od.output("Out"))},
                          {"shape": list(shape), "dtype": vd.dtype,
                           "value": 0.0})
        if od.type == "fill_constant_batch_size_like":
            names = od.input("Input")
            vd = self._vd(bd, names[0]) if names else None
            shape = _static_shape(vd)
            if shape is None or vd.lod_level:
                return None
            out_shape = [int(s) for s in od.attr("shape", [])]
            in_idx = int(od.attr("input_dim_idx", 0))
            out_idx = int(od.attr("output_dim_idx", 0))
            if not out_shape or in_idx >= len(shape) \
                    or out_idx >= len(out_shape):
                return None
            out_shape[out_idx] = shape[in_idx]
            if any(s < 0 for s in out_shape):
                return None
            return OpDesc("fill_constant", {},
                          {"Out": list(od.output("Out"))},
                          {"shape": out_shape,
                           "dtype": od.attr("dtype", "float32"),
                           "value": od.attr("value", 0.0)})
        return None


class CommonSubexpression(RewritePass):
    """Value-numbering CSE over block 0's pure ops."""

    name = "cse"

    @staticmethod
    def _pure(od):
        info = resolve_op_info(od.type)
        if info is None or not info.jittable or info.uses_rng \
                or info.in_place_outputs:
            return False
        if dataflow._is_effectful(od):  # BlockRef attrs, host ops
            return False
        outs = set(od.output_names()) - {EMPTY}
        if not outs or outs & (set(od.input_names()) - {EMPTY}):
            return False  # in-place by name
        return True

    def run(self, desc, ctx):
        bd = desc.block(0)
        keep = ctx.keep_names(0)
        def_count = {}
        for od in bd.ops:
            for n in od.output_names():
                if n != EMPTY:
                    def_count[n] = def_count.get(n, 0) + 1

        version = {}       # name -> def version at current position
        exprs = {}         # value-number key -> canonical output names
        rename = {}        # dup name -> canonical name
        dropped = []
        new_ops = []
        for i, od in enumerate(bd.ops):
            # rewrite reads through accumulated renames first
            for slot, names in od.inputs.items():
                od.inputs[slot] = [rename.get(n, n) for n in names]

            outs = [n for n in od.output_names() if n != EMPTY]
            candidate = (
                self._pure(od)
                and all(def_count.get(n, 0) == 1 for n in outs)
                and not (set(outs) & keep))
            if candidate:
                key = (od.type,
                       json.dumps({k: _jsonable(v) for k, v in
                                   sorted(od.attrs.items())},
                                  sort_keys=True),
                       tuple((slot,
                              tuple((n, version.get(n, 0))
                                    for n in names))
                             for slot, names in sorted(od.inputs.items())))
                prior = exprs.get(key)
                if prior is not None and prior["slots"] == \
                        tuple((s, len(v)) for s, v in
                              sorted(od.outputs.items())):
                    for slot, names in sorted(od.outputs.items()):
                        for n, canon in zip(names,
                                            prior["outs"][slot]):
                            if n != EMPTY:
                                rename[n] = canon
                    dropped.append({"op_index": i, "type": od.type,
                                    "reused": dict(prior["outs"])})
                    continue  # op deleted; versions untouched
                if prior is None:
                    exprs[key] = {
                        "outs": {s: list(v)
                                 for s, v in od.outputs.items()},
                        "slots": tuple((s, len(v)) for s, v in
                                       sorted(od.outputs.items())),
                    }
            for n in outs:
                version[n] = version.get(n, 0) + 1
            new_ops.append(od)
        if not dropped:
            return None
        bd.ops = new_ops
        return {"removed_ops": dropped,
                "renamed": {k: v for k, v in sorted(rename.items())}}


_PASSES = OrderedDict((p.name, p) for p in
                      (DeadOpElimination(), ConstantFold(),
                       CommonSubexpression(), DeadVarElimination()))

# the "default" pipeline is the cleanup set only; the cost-model-guided
# passes (layout, fuse, auto_remat, registered below from
# opt_passes.py) are opt-in: "default+layout+fuse"
DEFAULT_PIPELINE = "dce,fold,cse,dve"


def register_pass(p):
    """Add a RewritePass instance to the registry (its class is what
    `name:knob=value` specs instantiate)."""
    if not p.name:
        raise ValueError("pass has no name: %r" % (p,))
    _PASSES[p.name] = p
    return p


def available_passes():
    return list(_PASSES)


def _parse_spec(spec):
    """spec -> [(name, {opt: raw value})].  Tokens separate on ',' or
    '+' ("default" expands to the cleanup pipeline); knobs attach with
    ':' as `name:key=value[:key=value...]`."""
    tokens = []
    for part in (spec or "").replace("+", ",").split(","):
        part = part.strip()
        if not part:
            continue
        if part == "default":
            tokens.extend((n, {}) for n in DEFAULT_PIPELINE.split(","))
            continue
        fields = part.split(":")
        name = fields[0].strip()
        opts = {}
        for field in fields[1:]:
            if "=" not in field:
                raise ValueError(
                    "malformed pass option %r in token %r (want "
                    "name:key=value)" % (field, part))
            key, value = field.split("=", 1)
            opts[key.strip()] = value.strip()
        tokens.append((name, opts))
    return tokens


class PassManager:
    """Run a verified pipeline of rewrite passes over a Program.

        pm = PassManager("dce,fold,cse,dve", explain=True)
        optimized = pm.run(program, fetches=[loss.name])
        print(pm.explain_text())

    spec: comma list of pass names, or "default".
    verify_level: "structural" (default: desc walking before and after
        every pass) or "full" (adds the shape re-derivation).
    """

    def __init__(self, spec=DEFAULT_PIPELINE, verify=True,
                 verify_level="structural", explain=False):
        spec = (spec or "").strip()
        if spec == "":
            spec = DEFAULT_PIPELINE
        parsed = _parse_spec(spec)
        unknown = [n for n, _ in parsed if n not in _PASSES]
        if unknown:
            raise ValueError("unknown pass(es) %s; available: %s"
                             % (unknown, list(_PASSES)))
        self.passes = [_PASSES[n].with_options(opts)
                       for n, opts in parsed]
        self.verify = bool(verify)
        self.verify_level = verify_level
        self.explain = bool(explain)
        self.records = []

    @property
    def spec(self):
        """The canonical comma-joined spec these passes resolve to
        (knobs included)."""
        return ",".join(p.spec_token for p in self.passes)

    @property
    def pipeline_id(self):
        """Stable id of this pass config (knobs included), which
        `fingerprint.program_fingerprint` folds in."""
        return "v%d:%s" % (_PIPELINE_VERSION, self.spec)

    def _verify(self, desc):
        report = Report()
        verify_program(desc, level=self.verify_level, report=report)
        report.raise_on_error()

    def run(self, program, fetches=()):
        """Apply the pipeline to a CLONE of `program`; returns the
        optimized Program (the input is untouched)."""
        from ..fluid import framework

        if isinstance(program, framework.Program):
            out = program.clone()
        else:  # a bare ProgramDesc: wrap for uniform handling
            out = program_copy(program)
        desc = out.desc
        ctx = _PassContext(desc, fetches, program=out)
        self.records = []
        if self.verify:
            self._verify(desc)
        for p in self.passes:
            t0 = time.perf_counter()
            ops_before = sum(len(b.ops) for b in desc.blocks)
            vars_before = sum(len(b.vars) for b in desc.blocks)
            ctx.note = None
            diff = p.run(desc, ctx)
            if self.verify:
                # a pass that broke the IR fails here, named, before the
                # broken desc can reach a kernel
                self._verify(desc)
            self.records.append({
                "pass": p.spec_token, "changed": bool(diff),
                "ops_before": ops_before,
                "ops_after": sum(len(b.ops) for b in desc.blocks),
                "vars_before": vars_before,
                "vars_after": sum(len(b.vars) for b in desc.blocks),
                "seconds": round(time.perf_counter() - t0, 6),
                "note": ctx.note,
                "diff": diff if self.explain else None,
            })
        for b in out.blocks:
            b.sync_with_desc()
        return out

    def explain_text(self):
        """Human-readable per-pass diff dump (the `--explain` view)."""
        lines = ["pipeline %s" % self.pipeline_id]
        for r in self.records:
            idle = "" if r["changed"] else (
                "  [no change: %s]" % r["note"] if r.get("note")
                else "  [no change]")
            lines.append(
                "  %-5s ops %d->%d vars %d->%d (%.1f ms)%s"
                % (r["pass"], r["ops_before"], r["ops_after"],
                   r["vars_before"], r["vars_after"],
                   r["seconds"] * 1e3, idle))
            diff = r.get("diff") or {}
            for kind, items in sorted(diff.items()):
                if isinstance(items, dict):
                    for k, v in sorted(items.items()):
                        lines.append("        %s: %s -> %s"
                                     % (kind, k, v))
                elif isinstance(items, (list, tuple)):
                    for item in items:
                        lines.append("        %s: %s"
                                     % (kind, json.dumps(
                                         item, sort_keys=True,
                                         default=str)))
                else:  # scalar facts (counts, flags)
                    lines.append("        %s: %s" % (kind, items))
        return "\n".join(lines)


def optimize_program(program, spec=DEFAULT_PIPELINE, fetches=(),
                     verify=True, verify_level="structural"):
    """One-shot helper: clone+optimize `program` through `spec`.
    Returns (optimized_program, pass_manager)."""
    pm = PassManager(spec, verify=verify, verify_level=verify_level)
    return pm.run(program, fetches=fetches), pm


def pipeline_id(spec):
    """The pipeline id a spec resolves to, without running anything
    ('' -> '')."""
    spec = (spec or "").strip()
    if not spec:
        return ""
    return PassManager(spec, verify=False).pipeline_id


# the cost-model-guided passes (layout, fuse, auto_remat) register
# themselves; imported last so opt_passes can import the RewritePass
# and register_pass machinery from this module
from . import opt_passes  # noqa: E402,F401  (registers passes)
