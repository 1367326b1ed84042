"""Static cost-model ranking of launch candidates — zero devices.

Counterpart of paddle_tpu/tune/rank.py.  For every candidate the search
space enumerates, this module answers "would it even run, and how fast"
before anything runs:

  1. **validity** — the sharding analyzer (`analysis.analyze_sharding`)
     abstract-interprets the candidate's (pass-optimized) program
     against its mesh with `concrete_feeds=True`.  Any error-severity
     S-code (S001–S005) rejects the candidate outright; it never
     reaches the ranked table, let alone a measurement.
  2. **memory** — the analyzer's per-device peak-memory breakdown
     (sharded params + optimizer state + liveness activation peak),
     with the activation term scaled by 1/micro_batches (each
     micro-step materializes only its own slice).  Over the `hbm_gb`
     budget -> an S005 rejection citing the per-device component bytes.
  3. **speed** — a predicted step time from three additive terms:

         compute_s  = max(t_flops, t_bytes roofline floor) / n_devices
         comm_s     = costmodel ring-cost wire bytes / link bandwidth
         overhead_s = fixed dispatch cost + (m-1) * per-micro-step cost

     The floors default to the card's peaks (`obs.perf.roofline_floors`:
     989 TFLOP/s under bf16 activations, 67 in f32, 3,350 GB/s) and the
     link to the costmodel's NVLink 450 GB/s; the plan's `context`
     carries the peaks it used.  `compute_s` assumes ideal linear
     scaling over the mesh — an optimistic floor, least trustworthy for
     meshes the analyzer flagged S001-replicated (the warning count
     rides the entry so the table says so).  A `Calibration`
     (tune/fit.py, fitted from perf-history measurements) corrects each
     term; identity until something has been measured.

A candidate is priced over its pass-optimized program, so an
`auto_remat` candidate pays its recomputed forward in the compute term
and carries the rewrite's lower activation peak into its memory term.

The output `RankedPlan` is deterministic — same model, same space,
same arguments => byte-identical `to_dict()` JSON across fresh
processes: no timestamps, no set iteration, no device state, floats
from one arithmetic path.
"""

import json
import os

from ..analysis import analyze_sharding
from ..analysis.diagnostics import Severity
from .space import Candidate

__all__ = ["rank", "RankedPlan", "ScoredCandidate", "Rejection",
           "Calibration", "DEFAULT_STEP_OVERHEAD_S",
           "DEFAULT_MICRO_OVERHEAD_S"]

# fixed per-step dispatch/host cost and the marginal cost of one more
# micro-step — deliberately rough priors; calibration owns the truth
# once measurements exist
DEFAULT_STEP_OVERHEAD_S = 500e-6
DEFAULT_MICRO_OVERHEAD_S = 200e-6

_TERM_NAMES = ("compute", "comm", "overhead")


class Calibration:
    """Per-term correction of the predicted step time:

        predicted = coef.compute * compute_s + coef.comm * comm_s
                  + coef.overhead * overhead_s + bias_s

    Identity (all coefficients 1, bias 0) until `tune/fit.py` fits one
    from measured history; `n` records how many measurements it
    learned from, `error_before`/`error_after` the median relative
    error on the measurable terms with/without the correction."""

    def __init__(self, coef=None, bias_s=0.0, n=0, model=None,
                 error_before=None, error_after=None, note=None):
        self.coef = dict.fromkeys(_TERM_NAMES, 1.0)
        self.coef.update(coef or {})
        unknown = set(self.coef) - set(_TERM_NAMES)
        if unknown:
            raise ValueError("unknown calibration term(s) %s; terms "
                             "are %s" % (sorted(unknown), _TERM_NAMES))
        self.bias_s = float(bias_s)
        self.n = int(n)
        self.model = model
        self.error_before = error_before
        self.error_after = error_after
        self.note = note

    @classmethod
    def identity(cls):
        return cls()

    @property
    def is_identity(self):
        return self.n == 0 and self.bias_s == 0.0 and \
            all(c == 1.0 for c in self.coef.values())

    def apply(self, terms):
        """terms: {"compute_s", "comm_s", "overhead_s"} -> corrected
        predicted step seconds (floored at a microsecond: a fitted
        bias must never predict a non-positive step)."""
        s = self.bias_s
        for name in _TERM_NAMES:
            s += self.coef[name] * terms["%s_s" % name]
        return max(s, 1e-6)

    def to_dict(self):
        out = {"coef": {k: round(float(self.coef[k]), 9)
                        for k in _TERM_NAMES},
               "bias_s": round(self.bias_s, 9), "n": self.n}
        if self.model is not None:
            out["model"] = self.model
        if self.error_before is not None:
            out["error_before"] = round(self.error_before, 6)
        if self.error_after is not None:
            out["error_after"] = round(self.error_after, 6)
        if self.note:
            out["note"] = self.note
        return out

    @classmethod
    def from_dict(cls, d):
        return cls(coef=d.get("coef"), bias_s=d.get("bias_s", 0.0),
                   n=d.get("n", 0), model=d.get("model"),
                   error_before=d.get("error_before"),
                   error_after=d.get("error_after"),
                   note=d.get("note"))

    def save(self, path):
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, sort_keys=True, indent=1)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def __repr__(self):
        return "Calibration(%s, bias=%.3gms, n=%d)" % (
            ", ".join("%s=%.3g" % (k, self.coef[k])
                      for k in _TERM_NAMES), self.bias_s * 1e3, self.n)


class ScoredCandidate:
    """One ranked entry: the candidate, its cost terms, and the
    static prices every acceptance check cites."""

    __slots__ = ("candidate", "terms", "predicted_step_s",
                 "comm_wire_bytes", "peak_hbm_bytes", "hbm_breakdown",
                 "warnings")

    def __init__(self, candidate, terms, predicted_step_s,
                 comm_wire_bytes, peak_hbm_bytes, hbm_breakdown,
                 warnings):
        self.candidate = candidate
        self.terms = terms
        self.predicted_step_s = predicted_step_s
        self.comm_wire_bytes = comm_wire_bytes
        self.peak_hbm_bytes = peak_hbm_bytes
        self.hbm_breakdown = hbm_breakdown
        self.warnings = warnings  # {code: count}, warning severity

    def predicted_samples_per_sec(self):
        return self.candidate.batch / self.predicted_step_s

    def to_dict(self, model=None):
        c = self.candidate
        return {
            "tag": c.tag(),
            "config": c.config(model),
            "predicted_step_ms": round(self.predicted_step_s * 1e3, 6),
            "predicted_samples_per_sec": round(
                self.predicted_samples_per_sec(), 3),
            "terms_ms": {k: round(self.terms["%s_s" % k] * 1e3, 6)
                         for k in _TERM_NAMES},
            "comm_wire_bytes": int(self.comm_wire_bytes),
            "peak_hbm_bytes": int(self.peak_hbm_bytes),
            "hbm_breakdown": {k: int(v) for k, v in
                              sorted(self.hbm_breakdown.items())
                              if isinstance(v, (int, float))},
            "warnings": dict(sorted(self.warnings.items())),
            "bench_env": c.bench_env(model),
        }


class Rejection:
    """A candidate the static checks refused, with the diagnostic
    code and the cited numbers (S005 carries the per-device bytes)."""

    __slots__ = ("candidate", "code", "severity", "message",
                 "peak_hbm_bytes")

    def __init__(self, candidate, code, severity, message,
                 peak_hbm_bytes=None):
        self.candidate = candidate
        self.code = code
        self.severity = severity
        self.message = message
        self.peak_hbm_bytes = peak_hbm_bytes

    def to_dict(self):
        out = {"tag": self.candidate.tag(), "code": self.code,
               "severity": self.severity, "message": self.message}
        if self.peak_hbm_bytes is not None:
            out["peak_hbm_bytes"] = int(self.peak_hbm_bytes)
        return out

    def __repr__(self):
        return "Rejection(%s: %s %s)" % (self.candidate.tag(),
                                         self.code, self.message)


class RankedPlan:
    """The plan: ranked survivors (ascending predicted step time),
    rejections with their codes, and everything needed to reproduce
    or measure it."""

    def __init__(self, model, chips, hbm_gb, space_dict, calibration,
                 ranked, rejected, skipped, context):
        self.model = model
        self.chips = chips
        self.hbm_gb = hbm_gb
        self.space_dict = space_dict
        self.calibration = calibration
        self.ranked = ranked
        self.rejected = rejected
        self.skipped = skipped      # {tag: reason} from the space
        self.context = context      # peak_tflops/hbm_gbps/bf16 etc.

    def entry(self, tag):
        for e in self.ranked:
            if e.candidate.tag() == tag:
                return e
        return None

    def to_dict(self):
        return {
            "ptune": 1,
            "model": self.model,
            "chips": self.chips,
            "hbm_gb": self.hbm_gb,
            "context": dict(sorted(self.context.items())),
            "space": self.space_dict,
            "calibration": (None if self.calibration.is_identity
                            else self.calibration.to_dict()),
            "ranked": [e.to_dict(self.model) for e in self.ranked],
            "rejected": [r.to_dict() for r in self.rejected],
            "skipped_by_space": dict(self.skipped),
        }

    def to_json(self):
        """The reproducible launch-plan artifact (deterministic:
        sorted keys, rounded floats, no timestamps)."""
        return json.dumps(self.to_dict(), sort_keys=True, indent=1)

    def save(self, path):
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_json() + "\n")
        os.replace(tmp, path)
        return path

    def format_table(self, topk=None):
        """The priced, ranked table `ptune plan` prints."""
        lines = ["ranked launch plan: model=%s chips=%d%s%s"
                 % (self.model, self.chips,
                    (" hbm_gb=%g" % self.hbm_gb)
                    if self.hbm_gb else "",
                    "" if self.calibration.is_identity else
                    "  [calibrated from %d run(s)]"
                    % self.calibration.n)]
        lines.append(
            "  %-4s %-38s %10s %12s %10s %10s %9s %s"
            % ("rank", "candidate", "pred ms", "samples/s",
               "comp ms", "comm ms", "hbm GiB", "warns"))
        entries = self.ranked if topk is None else self.ranked[:topk]
        for i, e in enumerate(entries):
            warns = ",".join("%s:%d" % (k, v)
                             for k, v in sorted(e.warnings.items()))
            lines.append(
                "  %-4d %-38s %10.3f %12.1f %10.3f %10.3f %9.3f %s"
                % (i + 1, e.candidate.tag(),
                   e.predicted_step_s * 1e3,
                   e.predicted_samples_per_sec(),
                   e.terms["compute_s"] * 1e3,
                   e.terms["comm_s"] * 1e3,
                   e.peak_hbm_bytes / 2**30, warns or "-"))
        if self.rejected:
            lines.append("  rejected (never measured):")
            for r in self.rejected:
                lines.append("    %-40s %s: %s"
                             % (r.candidate.tag(), r.code, r.message))
        if self.skipped:
            lines.append("  skipped by space constraints: %d point(s)"
                         % len(self.skipped))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def _severity_errors(report):
    """Error-severity diagnostics, S-codes first (the rejection cites
    the first — sharding findings outrank anything else here)."""
    errs = report.by_severity(Severity.ERROR)
    return sorted(errs, key=lambda d: (not d.code.startswith("S"),
                                       d.code))


def _warning_counts(report):
    counts = {}
    for d in report.by_severity(Severity.WARNING):
        counts[d.code] = counts.get(d.code, 0) + 1
    return counts


def rank(builder, candidates, chips, model=None, hbm_gb=None,
         calibration=None, bf16_act=True, peak_tflops=None,
         hbm_gbps=None, rules=None, space_dict=None, skipped=None,
         extra_context=None, hbm_ratio=None,
         step_overhead_s=DEFAULT_STEP_OVERHEAD_S,
         micro_overhead_s=DEFAULT_MICRO_OVERHEAD_S):
    """Score every candidate statically and return a `RankedPlan`.

    builder: batch -> (main_program, loss_name); called once per
        distinct batch (program IR only — no devices).
    candidates: Candidate list (usually `SearchSpace.points()`; an
        explicitly injected invalid candidate is rejected here, which
        is exactly what the selftest proves).
    chips: target device count; every candidate's mesh must multiply
        out to it (defense in depth for hand-built candidate lists).
    hbm_gb: per-device HBM budget; enables the S005 rejection.
    hbm_ratio: measured actual/static memory ratio from a `pmem
        drift` calibration (`tune.fit.load_hbm_calibration`); scales
        the static peak before the budget check so the memory term is
        no longer purely analytic.  None/1.0 keeps the analytic peak
        (and the plan JSON byte-identical to uncalibrated runs).
    calibration: a fitted `Calibration` (identity when None).
    rules: optional match_partition_rules-style [(regex, spec), ...]
        forwarded to the sharding analyzer.
    extra_context: merged into the plan's `context` — the knobs the
        builder was constructed with (image_size/class_dim), which
        `tune/measure.py` replays so a measurement runs the SAME
        program the ranking priced.
    """
    from ..compile.passes import optimize_program
    from ..obs import perf as obs_perf
    from ..parallel.mesh import parse_mesh_spec

    calibration = calibration or Calibration.identity()
    progs = {}      # batch -> (program, loss_name)
    opts = {}       # (batch, pipeline) -> program
    floors = {}     # (batch, pipeline) -> roofline dict
    analyses = {}   # (mesh, batch, pipeline) -> ShardingPlan
    ranked, rejected = [], []

    def _program(batch):
        if batch not in progs:
            progs[batch] = builder(batch)
        return progs[batch]

    def _optimized(batch, pipeline):
        key = (batch, pipeline)
        if key not in opts:
            prog, loss = _program(batch)
            if pipeline:
                prog, _pm = optimize_program(prog, pipeline,
                                             fetches=[loss])
            opts[key] = (prog, loss)
        return opts[key]

    def _floors(batch, pipeline):
        key = (batch, pipeline)
        if key not in floors:
            prog, _loss = _optimized(batch, pipeline)
            floors[key] = obs_perf.roofline_floors(
                prog, bf16_act=bf16_act, peak_tflops=peak_tflops,
                hbm_gbps=hbm_gbps)
        return floors[key]

    def _analysis(mesh_spec, batch, pipeline):
        key = (mesh_spec, batch, pipeline)
        if key not in analyses:
            prog, loss = _optimized(batch, pipeline)
            analyses[key] = analyze_sharding(
                prog, parse_mesh_spec(mesh_spec), fetches=[loss],
                rules=rules, concrete_feeds=True, publish=False)
        return analyses[key]

    for cand in candidates:
        if cand.n_devices != chips:
            rejected.append(Rejection(
                cand, "MESH", Severity.ERROR,
                "mesh %s has axis product %d but the plan targets %d "
                "chip(s)" % (cand.mesh_spec, cand.n_devices, chips)))
            continue
        plan = _analysis(cand.mesh_spec, cand.batch, cand.pipeline)
        errs = _severity_errors(plan.report)
        if errs:
            d = errs[0]
            rejected.append(Rejection(cand, d.code, d.severity,
                                      d.format()))
            continue

        # per-device peak memory with the micro-batch activation
        # scaling, over the PASS-OPTIMIZED program (`_optimized` applies
        # the candidate's pipeline before `_analysis`), so a pass that
        # changes liveness changes the S005 price as it will at run time
        bd = plan.hbm_breakdown
        m = cand.micro_batches
        act = int(bd.get("activation_peak_bytes", 0))
        fixed = int(bd.get("params_bytes", 0)) \
            + int(bd.get("optimizer_state_bytes", 0))
        act_scaled = act // m if m > 1 else act
        peak = fixed + act_scaled
        if hbm_ratio and hbm_ratio != 1.0:
            # a measured drift calibration (`pmem drift
            # --calibration-out`): the static model under-counts the
            # real temporary footprint; scale before the budget check
            # so "fits" means fits on hardware
            peak = int(peak * float(hbm_ratio))
        breakdown = {
            "params_bytes": int(bd.get("params_bytes", 0)),
            "optimizer_state_bytes": int(
                bd.get("optimizer_state_bytes", 0)),
            "activation_peak_bytes": act_scaled,
        }
        if hbm_gb is not None and peak > float(hbm_gb) * (1 << 30):
            cal = ("" if not hbm_ratio or hbm_ratio == 1.0
                   else ", x%.3g measured calibration" % hbm_ratio)
            rejected.append(Rejection(
                cand, "S005", Severity.ERROR,
                "static per-device peak HBM %.3f GiB (params %.3f + "
                "optimizer state %.3f + activation peak %.3f at "
                "micro_batches=%d%s) exceeds the %.3f GiB budget"
                % (peak / 2**30,
                   breakdown["params_bytes"] / 2**30,
                   breakdown["optimizer_state_bytes"] / 2**30,
                   act_scaled / 2**30, m, cal, float(hbm_gb)),
                peak_hbm_bytes=peak))
            continue

        fl = _floors(cand.batch, cand.pipeline)
        terms = {
            "compute_s": max(fl["t_mxu_s"], fl["t_hbm_s"])
            / cand.n_devices,
            "comm_s": plan.comm.step_seconds_floor(),
            "overhead_s": step_overhead_s
            + (m - 1) * micro_overhead_s,
        }
        ranked.append(ScoredCandidate(
            cand, terms, calibration.apply(terms),
            plan.comm.total_wire_bytes(), peak, breakdown,
            _warning_counts(plan.report)))

    ranked.sort(key=lambda e: (e.predicted_step_s, e.candidate.tag()))
    rejected.sort(key=lambda r: r.candidate.tag())
    context = {
        "bf16_act": bool(bf16_act),
        "step_overhead_s": step_overhead_s,
        "micro_overhead_s": micro_overhead_s,
    }
    if hbm_ratio and hbm_ratio != 1.0:
        context["hbm_ratio"] = float(hbm_ratio)
    context.update(extra_context or {})
    if ranked:
        any_fl = next(iter(floors.values()))
        context["peak_tflops"] = any_fl["peak_tflops"]
        context["hbm_gbps"] = any_fl["hbm_gbps"]
    return RankedPlan(model, chips, hbm_gb, space_dict or {},
                      calibration, ranked, rejected, skipped or {},
                      context)
