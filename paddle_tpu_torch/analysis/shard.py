"""Static SPMD/sharding analysis over the Program IR.

Counterpart of paddle_tpu/analysis/shard.py.  A bad partition rule, a
non-divisible mesh axis or a mis-ordered collective fails only once the
step runs on the mesh — or worse, silently replicates a tensor that
should be sharded.  This pass propagates specs (the default
`parallel/sharding.py` rules, or explicit `match_partition_rules`-style
regex rules) through every op of a Program against a mesh description,
before anything runs, and reports stable diagnostics:

  S001 unsharded-param   a parameter (or ZeRO-1 optimizer slot) falls
                 back to replication: it matched no partition rule, or
                 min_shard_dim / divisibility forced the fallback.  The
                 message cites the reason (`param_spec_reason`).
                 Warning when the tensor is large enough that sharding
                 would have paid; info otherwise.
  S002 non-divisible     a sharded dim's static size is not divisible
                 by the product of its mesh axes.  Error at
                 spec-introduction points (params, rules, concrete
                 trainer feeds, sequence extents); advisory for the
                 feed batch of pinned/exported IR, where the batch is
                 a runtime choice a rebuild can fix.
  S003 spec-conflict     two inputs of an op demand incompatible
                 layouts for the same dim: the step redistributes one
                 of them (an all-gather) at that seam.  Warning; the
                 reshard is priced into the comm cost report.
  S004 schedule-hazard   collective ordering/deadlock hazards in the
                 pipeline/ring/moe schedules: an axis name missing
                 from the mesh, stage-count vs pp-size mismatch,
                 microbatch-count vs pp-stage mismatch (bubble
                 dominance), MoE expert-count not divisible by ep, or
                 MoE capacity overflow (guaranteed token drops).
  S005 hbm-over-budget   the static per-device peak-memory estimate
                 (sharded params + optimizer state + liveness-derived
                 activation peak) exceeds a caller-supplied budget.
                 Error.

The specs, reasons, codes, severities, op indices, comm bytes and
memory estimate equal the JAX module's for the same program and mesh,
and so does each message's text, word for word (its "GSPMD" names the
partitioner the JAX step runs under; here DTensor redistributes at the
same seams).

`analyze_sharding` is the program-level entry point; `check_pipeline`
/ `check_moe` / `check_ring` cover the schedule-level hazards that
have no Program to walk.  The mesh argument is anything with an
axis-name -> size mapping: a built `DeviceMesh`, a
`parallel.mesh.MeshConfig`, or a plain dict — so a lint can run
against `dp=256,mp=4` from a laptop with no card.

Wired in at the trust boundaries (all gated by FLAGS_verify_sharding):
`ParallelTrainer.init` / `make_parallel_step` analyze before the
startup program runs, the pipeline and MoE schedules check their
layout, and `lint_cli --mesh dp=4,mp=2` runs it from CI.  Communication
costs ride along in a `costmodel.CommCostReport`
(`shard_comm_bytes_total{collective}` in the obs registry).
"""

import re
from collections import OrderedDict

from ..core.types import GRAD_SUFFIX
from .common import EMPTY, find_var_desc
from .costmodel import CommCostReport
from .dataflow import liveness_timeline
from .diagnostics import Diagnostic, Report, Severity

__all__ = ["analyze_sharding", "ShardingPlan", "mesh_axis_sizes",
           "check_pipeline", "check_moe", "check_ring"]

# ops whose outputs alias their inputs (state advance): specs are
# preserved by construction, nothing to propagate
_UPDATE_OPS = frozenset([
    "sgd", "momentum", "adam", "adamax", "adagrad", "decayed_adagrad",
    "adadelta", "rmsprop", "ftrl", "proximal_gd", "proximal_adagrad",
    "fused_update"])

_NON_STATE_SLOTS = frozenset(["Param", "Grad", "LearningRate"])

_MATMUL_OPS = frozenset(["mul", "matmul"])

_REDUCE_OPS = frozenset(["mean", "reduce_sum", "reduce_mean",
                         "reduce_max", "reduce_min", "reduce_prod"])

_BYTES = {"float64": 8, "int64": 8, "float32": 4, "int32": 4,
          "float16": 2, "bfloat16": 2, "uint8": 1, "int8": 1, "bool": 1}


# ---------------------------------------------------------------------------
# mesh / spec plumbing
# ---------------------------------------------------------------------------

def mesh_axis_sizes(mesh):
    """Axis-name -> size for a DeviceMesh, MeshConfig, or plain dict."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        from ..parallel.mesh import mesh_shape

        shape = mesh_shape(mesh)
    else:
        shape = getattr(mesh, "shape", mesh)
    try:
        items = list(dict(shape).items())
    except (TypeError, ValueError):
        raise TypeError("mesh must be a DeviceMesh, a MeshConfig, or an "
                        "axis->size mapping; got %r" % (mesh,))
    return OrderedDict((str(a), int(s)) for a, s in items)


class _MeshView:
    """A static mesh: just the `.shape` mapping, which is all
    `parallel.sharding`'s spec rules consult."""

    def __init__(self, axes):
        self.shape = axes


def _norm_spec(spec, ndim):
    """PartitionSpec / tuple -> canonical tuple of length `ndim` whose
    entries are None, an axis name, or a tuple of axis names."""
    entries = list(tuple(spec))[:ndim] if spec is not None else []
    entries += [None] * (ndim - len(entries))
    out = []
    for e in entries:
        if e is None:
            out.append(None)
        elif isinstance(e, (list, tuple)):
            out.append(tuple(str(a) for a in e))
        else:
            out.append(str(e))
    return tuple(out)


def _dim_axes(entry):
    if entry is None:
        return ()
    if isinstance(entry, tuple):
        return entry
    return (entry,)


def _spec_str(spec):
    if not any(e is not None for e in spec):
        return "P() [replicated]"
    return "P(%s)" % ", ".join(
        "None" if e is None else
        ("(%s)" % ",".join(e) if isinstance(e, tuple) else e)
        for e in spec)


def _shard_factor(spec, axes):
    f = 1
    for e in spec:
        for a in _dim_axes(e):
            f *= axes.get(a, 1)
    return max(f, 1)


def _numel(shape):
    n = 1
    for s in shape or ():
        n *= max(int(s), 1)  # -1 (dynamic) counts as 1; documented
    return n


def _var_bytes(vd, spec, axes):
    if vd is None or vd.shape is None:
        return 0
    eb = _BYTES.get(vd.dtype, 4)
    return _numel(vd.shape) * eb // _shard_factor(spec, axes)


def _elem_bytes_of(desc, name):
    """Element size of a var by its recorded dtype (4 when unknown) —
    so comm pricing of bf16 programs stays consistent with the
    dtype-aware grad-sync pricing."""
    vd = find_var_desc(desc, 0, name)
    if vd is None or vd.dtype is None:
        return 4
    return _BYTES.get(vd.dtype, 4)


def _check_axes_known(name, spec, axes, report, op_index=None,
                      op_type=None):
    """S004: a user-supplied spec (partition rule / feed override)
    naming an axis the mesh does not have would silently analyze as
    unsharded (factor 1) while the real layout rejects or
    replicates — the exact typo class this analyzer exists to catch."""
    ok = True
    for e in spec:
        for a in _dim_axes(e):
            if a not in axes:
                report.add(Diagnostic(
                    "S004", Severity.ERROR,
                    "spec %s names axis %r, which is not a mesh axis "
                    "(mesh has %s)" % (_spec_str(spec), a, list(axes)),
                    op_index=op_index, op_type=op_type, var_name=name))
                ok = False
    return ok


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

class ShardingPlan:
    """The analyzer's output: per-var specs, replication reasons, the
    merged diagnostic report, the comm cost report, and the per-device
    HBM estimate."""

    def __init__(self, mesh_axes, report, comm):
        self.mesh_axes = mesh_axes
        self.report = report
        self.comm = comm
        self.var_specs = {}        # name -> canonical spec tuple
        self.param_reasons = {}    # name -> why it replicated (or None)
        self.peak_hbm_bytes = None
        self.hbm_breakdown = {}

    def spec_of(self, name):
        return self.var_specs.get(name)

    def sharded_params(self):
        return sorted(n for n in self.param_reasons
                      if any(e is not None for e in self.var_specs[n]))

    def replicated_params(self):
        return sorted(n for n in self.param_reasons
                      if not any(e is not None for e in self.var_specs[n]))

    def to_dict(self, topk=10):
        return {
            "mesh": dict(self.mesh_axes),
            "params_sharded": len(self.sharded_params()),
            "params_replicated": len(self.replicated_params()),
            "replication_reasons": {
                n: r for n, r in sorted(self.param_reasons.items()) if r},
            "peak_hbm_bytes": self.peak_hbm_bytes,
            "hbm_breakdown": dict(self.hbm_breakdown),
            "comm": self.comm.to_dict(topk=topk),
        }

    def publish(self, origin="shard", diagnostics=True):
        """Diagnostic counters + comm bytes + peak-HBM gauge into the
        obs registry.  `diagnostics=False` skips the Report counters —
        for callers that merged into an ALREADY-PUBLISHED report
        (re-publishing would double-count every earlier finding)."""
        if diagnostics:
            self.report.publish(origin=origin)
        self.comm.publish()
        if self.peak_hbm_bytes is not None:
            from ..obs import registry as registry_mod

            registry_mod.get_registry().gauge(
                "shard_peak_hbm_bytes",
                "static per-device peak-HBM estimate from the sharding "
                "analyzer").set(self.peak_hbm_bytes)
        return self


# ---------------------------------------------------------------------------
# program-level analysis
# ---------------------------------------------------------------------------

def analyze_sharding(program, mesh, feed_names=None, feed_specs=None,
                     rules=None, fetches=None, zero_stage=0,
                     dp_axis="dp", mp_axis="mp", min_shard_dim=512,
                     hbm_gb=None, suppress=(), report=None,
                     publish=False, origin="shard",
                     concrete_feeds=False):
    """Propagate PartitionSpecs through `program` against `mesh`.

    program: a Program or bare ProgramDesc (block 0 is analyzed; specs
        are a global-block property).
    mesh: DeviceMesh / MeshConfig / {axis: size} dict.
    feed_names: runtime feeds (inferred as producer-less
        non-persistable vars when omitted); they shard their leading
        dim over `dp_axis` unless `feed_specs` overrides.
    rules: optional match_partition_rules-style [(regex, spec), ...];
        first match wins, an unmatched param is an S001.  When None the
        default `param_spec_reason` heuristic applies and S001 cites
        its reason for any forced replication.
    zero_stage: >=1 prices/checks the ZeRO-1 optimizer-state layout.
    hbm_gb: per-device HBM budget in GiB; enables the S005 check.
    concrete_feeds: the feed shapes ARE the runtime shapes (the
        ParallelTrainer boundary) — a non-divisible static batch dim
        is then an S002 error.  False (linting pinned/exported IR)
        demotes it to an advisory: the batch is a runtime choice a
        rebuild can fix, unlike a parameter dim.

    Returns a `ShardingPlan` (`.report` has the diagnostics; pass
    `report=` to merge into an existing Report, e.g. check_program's).
    """
    desc = getattr(program, "desc", program)
    axes = mesh_axis_sizes(mesh)
    mesh_view = _MeshView(axes)
    report = report if report is not None else Report(suppress=suppress)
    comm = CommCostReport()
    plan = ShardingPlan(axes, report, comm)
    bd = desc.block(0)

    from ..parallel.sharding import param_spec_reason, zero1_spec_reason

    produced, consumed = set(), set()
    for od in bd.ops:
        produced.update(n for n in od.output_names() if n != EMPTY)
        consumed.update(n for n in od.input_names() if n != EMPTY)

    # -- parameters ---------------------------------------------------------
    params = {n: vd for n, vd in bd.vars.items()
              if getattr(vd, "is_parameter", False)}
    compiled_rules = None
    if rules is not None:
        compiled_rules = [(re.compile(pat), spec) for pat, spec in rules]
    for name, vd in sorted(params.items()):
        shape = vd.shape or ()
        reason = None
        if compiled_rules is not None:
            spec = None
            for pat, s in compiled_rules:
                if pat.search(name):
                    spec = _norm_spec(s, len(shape))
                    _check_axes_known(name, spec, axes, report)
                    break
            if spec is None:
                spec = _norm_spec((), len(shape))
                reason = "matched no partition rule"
                report.add(Diagnostic(
                    "S001", Severity.WARNING,
                    "parameter matched no partition rule: silently "
                    "replicated on all %d devices"
                    % _total_devices(axes), var_name=name))
        else:
            raw, reason = param_spec_reason(name, shape, mesh_view,
                                            mp_axis=mp_axis,
                                            min_shard_dim=min_shard_dim)
            spec = _norm_spec(raw, len(shape))
            if reason is not None:
                # worth a warning only when some dim could have
                # sharded profitably (>= min_shard_dim) yet didn't
                big = shape and max(int(s) for s in shape) \
                    >= min_shard_dim
                report.add(Diagnostic(
                    "S001",
                    Severity.WARNING if big else Severity.INFO,
                    "parameter falls back to replication: %s" % reason,
                    var_name=name))
        plan.param_reasons[name] = reason
        plan.var_specs[name] = spec
        _check_divisible(name, shape, spec, axes, report, op_index=None)

    # -- optimizer state ----------------------------------------------------
    state_param = _optimizer_state_params(bd)
    for name, pname in sorted(state_param.items()):
        vd = bd.vars.get(name)
        if vd is None or name in plan.var_specs:
            continue
        shape = vd.shape or ()
        base = plan.var_specs.get(pname, _norm_spec((), len(shape)))
        spec = base
        if zero_stage >= 1:
            raw, zreason = zero1_spec_reason(base, shape, mesh_view,
                                             dp_axis=dp_axis)
            spec = _norm_spec(raw, len(shape))
            if zreason is not None:
                report.add(Diagnostic(
                    "S001", Severity.INFO,
                    "zero-1 optimizer state stays unsharded: %s"
                    % zreason, var_name=name))
        plan.var_specs[name] = spec
        _check_divisible(name, shape, spec, axes, report, op_index=None)

    # -- feeds --------------------------------------------------------------
    feed_severity = Severity.ERROR if concrete_feeds else Severity.INFO
    if feed_names is None:
        feed_names = [n for n, vd in bd.vars.items()
                      if not vd.persistable and n not in produced
                      and n in consumed and n not in plan.var_specs]
    feed_specs = dict(feed_specs or {})
    for name in feed_names:
        vd = bd.vars.get(name)
        if vd is None:
            continue
        shape = vd.shape or ()
        if name in feed_specs:
            spec = _norm_spec(feed_specs[name], len(shape))
            _check_axes_known(name, spec, axes, report)
        elif shape and dp_axis in axes:
            spec = _norm_spec((dp_axis,), len(shape))
        else:
            spec = _norm_spec((), len(shape))
        plan.var_specs[name] = spec
        _check_divisible(name, shape, spec, axes, report, op_index=None,
                         severity=feed_severity,
                         hint=None if concrete_feeds else
                         " — a rebuild with a divisible batch fixes "
                         "this; the parameter layout is unaffected")

    # -- propagate through the op list --------------------------------------
    for i, od in enumerate(bd.ops):
        if od.type in ("flash_attention", "flash_attention_grad"):
            _check_flash_attention(desc, bd, i, od, axes, comm, report)
        if od.type in _UPDATE_OPS:
            continue  # outputs alias inputs; specs preserved
        _propagate_op(desc, bd, i, od, axes, plan, comm, report)

    # -- gradient synchronization cost --------------------------------------
    dp = axes.get(dp_axis, 1)
    for name, vd in sorted(params.items()):
        gname = name + GRAD_SUFFIX
        if gname not in produced:
            continue
        spec = plan.var_specs.get(name, ())
        nbytes = _var_bytes(vd, spec, axes)
        if dp > 1 and not any(dp_axis in _dim_axes(e) for e in spec):
            if zero_stage >= 1:
                comm.add("reducescatter", dp_axis, dp, nbytes,
                         "grad reduce-scatter %s" % name)
                comm.add("allgather", dp_axis, dp, nbytes,
                         "param all-gather %s" % name)
            else:
                comm.add("allreduce", dp_axis, dp, nbytes,
                         "grad sync %s" % name)

    # -- per-device peak HBM -------------------------------------------------
    _estimate_hbm(desc, bd, plan, axes, fetches, state_param, hbm_gb,
                  report)

    if publish:
        plan.publish(origin=origin)
    return plan


def _total_devices(axes):
    n = 1
    for s in axes.values():
        n *= s
    return n


def _optimizer_state_params(bd):
    """{state var name: param name} from the block's update ops (the
    desc-level sibling of parallel.sharding.optimizer_state_names)."""
    out = {}
    for od in bd.ops:
        if od.type not in _UPDATE_OPS:
            continue
        pnames = od.input("Param")
        pname = pnames[0] if pnames else None
        for slot, names in od.inputs.items():
            if slot in _NON_STATE_SLOTS:
                continue
            for n in names:
                if n != EMPTY and pname is not None:
                    out.setdefault(n, pname)
    return out


def _check_divisible(name, shape, spec, axes, report, op_index=None,
                     op_type=None, severity=Severity.ERROR, hint=None):
    """S002: a sharded STATIC dim must divide by its axes' product
    (dynamic -1 dims are runtime-bucketed; nothing to check).  Only
    the INTRODUCTION point of a spec is checked — a propagated dim was
    already checked at its source, so downstream vars never repeat the
    finding."""
    bad = False
    for d, (s, e) in enumerate(zip(shape or (), spec)):
        ax = _dim_axes(e)
        if not ax:
            continue
        prod = 1
        for a in ax:
            prod *= axes.get(a, 1)
        if prod > 1 and s is not None and int(s) > 0 and int(s) % prod:
            report.add(Diagnostic(
                "S002", severity,
                "dim %d (size %d) sharded %s is not divisible by "
                "%s=%d%s"
                % (d, int(s), _spec_str(spec), "*".join(ax), prod,
                   hint or ""),
                op_index=op_index, op_type=op_type, var_name=name))
            bad = True
    return bad


def _spec_for(plan, name, ndim):
    s = plan.var_specs.get(name)
    if s is None:
        return _norm_spec((), ndim)
    return s if len(s) == ndim else _norm_spec(s, ndim)


def _propagate_op(desc, bd, i, od, axes, plan, comm, report):
    """Transfer function for one op: derive output specs from input
    specs, flag S003 conflicts, and record partial-sum collectives."""
    def shape_of(name):
        vd = find_var_desc(desc, 0, name)
        return None if vd is None else vd.shape

    ins = []
    for n in od.input_names():
        if n == EMPTY:
            continue
        shp = shape_of(n)
        if shp is None:
            continue
        ins.append((n, shp, _spec_for(plan, n, len(shp))))

    for slot, names in od.outputs.items():
        for out_name in names:
            if out_name == EMPTY:
                continue
            out_shape = shape_of(out_name)
            if out_shape is None:
                continue
            ndim = len(out_shape)
            if out_name in plan.var_specs:
                continue  # params/feeds keep their assigned layout

            spec = None
            # the backward contract: X@GRAD mirrors X
            if out_name.endswith(GRAD_SUFFIX):
                src = out_name[: -len(GRAD_SUFFIX)]
                if src in plan.var_specs:
                    src_shape = shape_of(src)
                    if src_shape is not None \
                            and len(src_shape) == ndim:
                        spec = _spec_for(plan, src, ndim)
            if spec is None and od.type in _MATMUL_OPS \
                    and slot == "Out":
                spec = _matmul_spec(desc, od, i, ins, out_shape, axes,
                                    plan, comm, report)
            if spec is None and od.type in _REDUCE_OPS:
                spec = _norm_spec((), ndim)
                sharded = [s for _n, _shp, s in ins
                           if any(e is not None for e in s)]
                if sharded:
                    ax = next(a for e in sharded[0]
                              for a in _dim_axes(e))
                    comm.add("allreduce", ax, axes.get(ax, 1),
                             _numel(out_shape)
                             * _elem_bytes_of(desc, out_name),
                             "partial reduce at op %d (%s)"
                             % (i, od.type))
            if spec is None:
                spec = _generic_spec(desc, od, i, ins, out_name,
                                     out_shape, axes, comm, report)
            # no divisibility re-check here: every propagated dim was
            # checked where its spec was introduced (param/feed/rule)
            plan.var_specs[out_name] = spec


def _matmul_spec(desc, od, i, ins, out_shape, axes, plan, comm,
                 report):
    """mul/matmul: rows from X, cols from Y, and a partial-sum
    all-reduce when the contracted dim is sharded (the Megatron
    row-parallel pattern)."""
    xs = od.input("X")
    ys = od.input("Y")
    if not xs or not ys:
        return None
    by_name = {n: (shp, s) for n, shp, s in ins}
    if xs[0] not in by_name or ys[0] not in by_name:
        return None
    x_shape, x_spec = by_name[xs[0]]
    y_shape, y_spec = by_name[ys[0]]
    ndim = len(out_shape)
    if od.type == "mul":
        col = int(od.attr("x_num_col_dims", 1) or 1)
    else:
        col = max(len(x_shape) - 1, 1)
        if od.attr("transpose_X") or od.attr("transpose_Y"):
            return None  # transposed operands: stay conservative
    k_x = x_spec[-1] if x_spec else None
    # Y's contraction dim: -2 for (batched) matmul [.., k, n]; dim 0
    # for mul (Y is 2-D [k, n]) and 1-D vector operands
    k_y = y_spec[-2] if len(y_shape) >= 2 else \
        (y_spec[0] if y_spec else None)
    out = list(_norm_spec((), ndim))
    for d in range(min(col, ndim)):
        out[d] = x_spec[d] if d < len(x_spec) else None
    if ndim > col and len(y_spec) >= 2:
        out[-1] = y_spec[-1]
    kx_axes, ky_axes = set(_dim_axes(k_x)), set(_dim_axes(k_y))
    if kx_axes and ky_axes:
        if kx_axes == ky_axes:
            ax = sorted(kx_axes)[0]
            n = 1
            for a in kx_axes:
                n *= axes.get(a, 1)
            out_name = (od.output("Out") or [None])[0]
            nbytes = _numel(out_shape) \
                * _elem_bytes_of(desc, out_name) \
                // _shard_factor(tuple(out), axes)
            comm.add("allreduce", ax, n, nbytes,
                     "matmul partial-sum at op %d (%s -> %s)"
                     % (i, xs[0], out_name))
        else:
            report.add(Diagnostic(
                "S003", Severity.WARNING,
                "contraction dim sharded on incompatible axes: %r is "
                "%s, %r is %s — GSPMD must reshard one side"
                % (xs[0], _spec_str(x_spec), ys[0], _spec_str(y_spec)),
                op_index=i, op_type=od.type, var_name=xs[0]))
    return tuple(out)


def _generic_spec(desc, od, i, ins, out_name, out_shape, axes, comm,
                  report):
    """Default transfer: dimwise join over same-shape inputs (S003 on
    disagreement), else carry the leading-dim (batch) axis from an
    input with the same leading extent, else replicate."""
    ndim = len(out_shape)
    same = [(n, s) for n, shp, s in ins
            if tuple(shp or ()) == tuple(out_shape)]
    if same:
        out = [None] * ndim
        conflicted = False
        for n, s in same:
            for d, e in enumerate(s[:ndim]):
                if e is None:
                    continue
                if out[d] is None:
                    out[d] = e
                elif out[d] != e and not conflicted:
                    conflicted = True
                    first = next(nm for nm, sp in same
                                 if sp[d] == out[d])
                    report.add(Diagnostic(
                        "S003", Severity.WARNING,
                        "inputs demand incompatible layouts for dim "
                        "%d: %r wants %s, %r wants %s — GSPMD inserts "
                        "an implicit reshard here"
                        % (d, first, _axis_str(out[d]), n,
                           _axis_str(e)),
                        op_index=i, op_type=od.type, var_name=n))
                    shp = next(shp for nm, shp, sp in ins if nm == n)
                    ax = _dim_axes(e)[0]
                    comm.add("allgather", ax, axes.get(ax, 1),
                             _numel(shp) * _elem_bytes_of(desc, n),
                             "implicit reshard of %s at op %d (%s)"
                             % (n, i, od.type))
        return tuple(out)
    if ndim >= 1:
        lead = out_shape[0]
        for n, shp, s in ins:
            if not shp or s[0] is None:
                continue
            if int(shp[0]) == int(lead) or (int(shp[0]) < 0
                                            and int(lead) < 0):
                return tuple([s[0]] + [None] * (ndim - 1))
    return _norm_spec((), ndim)


def _axis_str(entry):
    return "+".join(_dim_axes(entry)) or "None"


def _check_flash_attention(desc, bd, i, od, axes, comm, report):
    """S004/S002 for in-program sequence parallelism: the op's
    `sequence_parallel_axis` attr must name a mesh axis, the sequence
    extent must divide by it (ring), and ulysses additionally needs
    the head count divisible (the all-to-all head swap)."""
    sp_axis = od.attr("sequence_parallel_axis", "") or ""
    if not sp_axis:
        return
    if sp_axis not in axes:
        # the op degrades gracefully (local attention) when the mesh
        # lacks the axis — that's the single-chip path of a program
        # built for sp meshes, so advisory, not an error
        report.add(Diagnostic(
            "S004", Severity.INFO,
            "op declares sequence-parallel axis %r but the mesh has "
            "axes %s: attention runs WITHOUT sequence parallelism "
            "here" % (sp_axis, list(axes)),
            op_index=i, op_type=od.type))
        return
    sp = axes[sp_axis]
    if sp <= 1:
        return
    q = (od.input("Q") or [None])[0]
    vd = find_var_desc(desc, 0, q) if q else None
    shape = vd.shape if vd is not None else None
    if shape and len(shape) == 3:
        t = int(shape[1])
        if t > 0 and t % sp:
            report.add(Diagnostic(
                "S002", Severity.ERROR,
                "sequence length %d not divisible by %s=%d"
                % (t, sp_axis, sp),
                op_index=i, op_type=od.type, var_name=q))
        mode = od.attr("sequence_parallel_mode", "ring") or "ring"
        heads = int(od.attr("num_heads", 1) or 1)
        if mode == "ulysses" and heads % sp:
            report.add(Diagnostic(
                "S004", Severity.ERROR,
                "ulysses all-to-all needs num_heads %d divisible by "
                "%s=%d" % (heads, sp_axis, sp),
                op_index=i, op_type=od.type))
        if t > 0 and od.type == "flash_attention":
            # ring cost: local K/V shards hop sp-1 times (a dynamic
            # batch dim prices at the documented -1 -> 1 floor)
            kv_bytes = 2 * _numel(shape) \
                * _elem_bytes_of(desc, q) // sp
            comm.add("ppermute", sp_axis, sp, kv_bytes * (sp - 1),
                     "ring attention K/V hops at op %d" % i)


def _estimate_hbm(desc, bd, plan, axes, fetches, state_param, hbm_gb,
                  report):
    """S005: params + optimizer state + liveness-derived activation
    peak, each divided by its spec's shard factor.  Dynamic (-1) dims
    count as 1, so the estimate is a floor for bucketed feeds."""
    persist_bytes = 0
    state_bytes = 0
    for name, vd in bd.vars.items():
        if not vd.persistable:
            continue
        spec = _spec_for(plan, name, len(vd.shape or ()))
        b = _var_bytes(vd, spec, axes)
        if name in state_param:
            state_bytes += b
        else:
            persist_bytes += b

    final_live = {n for n, vd in bd.vars.items() if vd.persistable}
    if fetches:
        final_live |= set(fetches)

    def _act_bytes(n):
        vd = bd.vars.get(n)
        if vd is None or vd.persistable:
            return 0
        return _var_bytes(vd, _spec_for(plan, n, len(vd.shape or ())),
                          axes)

    tl = liveness_timeline(bd.ops, _act_bytes, final_live, top_n=3)
    act_peak, peak_op = tl["peak_bytes"], tl["peak_op"]
    total = persist_bytes + state_bytes + act_peak
    plan.peak_hbm_bytes = total
    plan.hbm_breakdown = {
        "params_bytes": persist_bytes,
        "optimizer_state_bytes": state_bytes,
        "activation_peak_bytes": act_peak,
        "activation_peak_op": peak_op,
        # the top resident activations at the peak, blamed to their
        # defining ops (one shared liveness_timeline walk — the same
        # accounting the S005 total uses): the error can name WHICH
        # activations to remat instead of citing only totals
        "top_buffers": tl["top_buffers"],
    }
    if hbm_gb is not None and total > float(hbm_gb) * (1 << 30):
        top = "; ".join(
            "%s %.1f MiB (op %s %s)"
            % (b["name"], b["bytes"] / 2**20, b["def_op"],
               b["def_op_type"])
            for b in tl["top_buffers"])
        report.add(Diagnostic(
            "S005", Severity.ERROR,
            "static per-device peak HBM %.3f GiB (params %.3f + "
            "optimizer state %.3f + activation peak %.3f at op %s) "
            "exceeds the %.3f GiB budget%s"
            % (total / 2**30, persist_bytes / 2**30,
               state_bytes / 2**30, act_peak / 2**30, peak_op,
               float(hbm_gb),
               "" if not top else " — top resident: " + top),
            op_index=peak_op))


# ---------------------------------------------------------------------------
# schedule-level checks (no Program to walk)
# ---------------------------------------------------------------------------

def check_pipeline(mesh, n_stages, n_microbatches, axis_name="pp",
                   batch_size=None, report=None, suppress=()):
    """S004 hazards of a GPipe schedule: axis missing from the mesh,
    stage-count vs pp-size mismatch (the ppermute ring misroutes —
    stage i's output lands on a device holding different weights), and
    microbatch starvation (bubbles dominate)."""
    axes = mesh_axis_sizes(mesh)
    report = report if report is not None else Report(suppress=suppress)
    if axis_name not in axes:
        report.add(Diagnostic(
            "S004", Severity.ERROR,
            "pipeline axis %r is not a mesh axis (mesh has %s)"
            % (axis_name, list(axes))))
        return report
    pp = axes[axis_name]
    if n_stages != pp:
        report.add(Diagnostic(
            "S004", Severity.ERROR,
            "schedule stacks %d stages but mesh axis %s=%d — the "
            "stage-to-device ppermute ring would misroute activations"
            % (n_stages, axis_name, pp)))
    if n_microbatches < pp and (n_microbatches + pp - 1) > 0:
        report.add(Diagnostic(
            "S004", Severity.WARNING,
            "only %d microbatches for %d pipeline stages: bubble "
            "fraction %.0f%% of every step"
            % (n_microbatches, pp,
               100.0 * (pp - 1) / (n_microbatches + pp - 1))))
    if batch_size is not None and n_microbatches \
            and batch_size % n_microbatches:
        report.add(Diagnostic(
            "S004", Severity.ERROR,
            "global batch %d not divisible into %d microbatches"
            % (batch_size, n_microbatches)))
    return report


def check_moe(mesh, n_experts, capacity_factor=1.25, tokens=None,
              axis_name="ep", batch_axis="dp", report=None,
              suppress=()):
    """S004/S002 hazards of the Switch-MoE dispatch: axis missing,
    expert count not divisible by ep (the all_to_all reshape needs
    e_loc = E/ep), token batch not divisible by its shard axes, and
    guaranteed capacity overflow (tokens dropped every step)."""
    axes = mesh_axis_sizes(mesh)
    report = report if report is not None else Report(suppress=suppress)
    if axis_name not in axes:
        report.add(Diagnostic(
            "S004", Severity.ERROR,
            "expert axis %r is not a mesh axis (mesh has %s)"
            % (axis_name, list(axes))))
        return report
    ep = axes[axis_name]
    if n_experts % ep:
        report.add(Diagnostic(
            "S004", Severity.ERROR,
            "%d experts not divisible by mesh axis %s=%d — the "
            "dispatch all_to_all needs %d local experts per device"
            % (n_experts, axis_name, ep, n_experts // max(ep, 1))))
    if tokens is not None:
        shard = ep * axes.get(batch_axis, 1)
        if tokens % shard:
            report.add(Diagnostic(
                "S002", Severity.ERROR,
                "token batch %d not divisible by %s*%s=%d"
                % (tokens, batch_axis, axis_name, shard)))
        elif n_experts and n_experts % ep == 0:
            from ..parallel.moe import expert_capacity

            b_local = tokens // shard
            cap = expert_capacity(b_local, n_experts, capacity_factor)
            if cap * n_experts < b_local:
                report.add(Diagnostic(
                    "S004", Severity.WARNING,
                    "expert capacity %d * %d experts < %d local "
                    "tokens (capacity_factor %.2f): >= %d tokens "
                    "dropped EVERY step even under perfect balance"
                    % (cap, n_experts, b_local, capacity_factor,
                       b_local - cap * n_experts)))
    return report


def check_ring(mesh, seq_len=None, n_heads=None, axis_name="sp",
               mode="ring", report=None, suppress=()):
    """S004/S002 hazards of sequence parallelism: axis missing,
    sequence not divisible by sp, ulysses head-swap divisibility."""
    axes = mesh_axis_sizes(mesh)
    report = report if report is not None else Report(suppress=suppress)
    if axis_name not in axes:
        report.add(Diagnostic(
            "S004", Severity.ERROR,
            "sequence axis %r is not a mesh axis (mesh has %s)"
            % (axis_name, list(axes))))
        return report
    sp = axes[axis_name]
    if sp > 1 and seq_len is not None and seq_len % sp:
        report.add(Diagnostic(
            "S002", Severity.ERROR,
            "sequence length %d not divisible by %s=%d"
            % (seq_len, axis_name, sp)))
    if sp > 1 and mode == "ulysses" and n_heads is not None \
            and n_heads % sp:
        report.add(Diagnostic(
            "S004", Severity.ERROR,
            "ulysses all-to-all needs head count %d divisible by "
            "%s=%d" % (n_heads, axis_name, sp)))
    return report
