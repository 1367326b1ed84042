"""History-fitted calibration of the static ranking model.

Counterpart of paddle_tpu/tune/fit.py, pure Python as there, so the
same records give exactly the same coefficients and errors in both
packages.  An analytic cost model ranks; a learned correction makes the
ranking trustworthy, and the training data is free, because every
measured run already lands in `perf_history.jsonl`.  This module joins
a plan's predictions to the history records its measurements produced
(leg `ptune:<tag>` + the stamped `"config"` blob), fits a per-term
correction, and reports how wrong the model was before and after.

What gets fitted: the measurement leg (tune/leg.py) runs a candidate's
single-card proxy (the per-device batch slice; see tune/measure.py), so
the measurable prediction for a record is

    meas_pred = a * compute_s * n_devices / dp   (the slice's floor)
              + b * overhead_s + bias

and the least-squares fit learns (a, b, bias) — the multiplicative
gap between roofline floors and reality, and the real dispatch cost.

The comm term: multi-card bench legs (spmd/bench.py, leg
`multichip:<mesh>`) stamp a `comm` blob pairing the plan's analytic
ring floor (`pred_s`) with a measured grad-allreduce time
(`measured_s`); `join_comm_history` collects those pairs and
`fit_calibration(comm_pairs=...)` prices the comm coefficient from
them.  Without them the coefficient stays at its prior (1.0, analytic)
and the calibration says so in its `note`.

Records are partitioned by `obs.perf.platform_class` (platform +
device count + mesh): a CPU run must never train the calibration
alongside one-card GPU records — the fit keeps only the newest
record's class and notes what it dropped.  Records with a
stale/fallback platform are never trained on.
"""

import json
import math

from ..obs.mem import MEM_CALIBRATION_KIND
from .rank import Calibration

__all__ = ["join_history", "join_comm_history", "fit_calibration",
           "format_fit_report", "load_hbm_calibration",
           "load_comm_calibration", "LEG_PREFIX", "MEM_CALIBRATION_KIND"]

LEG_PREFIX = "ptune:"



def load_hbm_calibration(path):
    """Load a `pmem drift --calibration-out` blob
    (obs/mem.calibration_blob) and return its measured
    actual/static memory ratio — the multiplier `rank(...,
    hbm_ratio=)` applies to the static per-device peak before the
    S005 budget check, so the tuner's memory term carries a measured
    footprint instead of staying purely analytic.  Raises on a blob of
    the wrong kind or a non-positive ratio (a corrupt calibration must
    never silently widen the budget)."""
    with open(path) as f:
        blob = json.load(f)
    if blob.get("kind") != MEM_CALIBRATION_KIND:
        raise ValueError(
            "%s is not a pmem memory calibration (kind=%r; produce "
            "one with `pmem drift --calibration-out`)"
            % (path, blob.get("kind")))
    ratio = float(blob.get("hbm_ratio") or 0.0)
    if not math.isfinite(ratio) or ratio <= 0:
        raise ValueError("memory calibration %s carries unusable "
                         "hbm_ratio=%r" % (path, blob.get("hbm_ratio")))
    return ratio


def load_comm_calibration(path):
    """Load a `pcomm report --calibration-out` blob
    (obs/comm.calibration_blob) and return its measured/predicted
    ring pairs in the `join_comm_history` shape, ready for
    `fit_calibration(comm_pairs=...)` — each pair keeps its
    `platform_class` stamp so the fit's same-class filter still
    excludes CPU rings from a card's calibration.  Raises on a
    blob of the wrong kind or one with no usable pairs (a corrupt
    calibration must never silently keep the analytic prior while
    claiming to have fitted)."""
    from ..obs.comm import COMM_CALIBRATION_KIND

    with open(path) as f:
        blob = json.load(f)
    if blob.get("kind") != COMM_CALIBRATION_KIND:
        raise ValueError(
            "%s is not a pcomm comm calibration (kind=%r; produce "
            "one with `pcomm report --calibration-out`)"
            % (path, blob.get("kind")))
    pairs = []
    for p in blob.get("pairs") or []:
        try:
            measured = float(p["measured_s"])
            pred = float(p["pred_s"])
        except (KeyError, TypeError, ValueError):
            continue
        if not (math.isfinite(measured) and math.isfinite(pred)) \
                or measured <= 0 or pred <= 0:
            continue
        pairs.append({"leg": p.get("leg", "pcomm"),
                      "measured_s": measured, "pred_s": pred,
                      "wire_bytes": int(p.get("wire_bytes") or 0),
                      "platform_class": p.get("platform_class")})
    if not pairs:
        raise ValueError("comm calibration %s carries no usable "
                         "measured/predicted pairs" % path)
    return pairs


def _plan_entries(plan):
    """tag -> {terms (seconds), dp, n_devices} for a RankedPlan or a
    loaded plan-JSON dict."""
    out = {}
    if hasattr(plan, "ranked") and not isinstance(plan, dict):
        for e in plan.ranked:
            c = e.candidate
            out[c.tag()] = {"terms": dict(e.terms), "dp": c.dp,
                            "n_devices": c.n_devices}
        return out, getattr(plan, "model", None)
    from ..parallel.mesh import parse_mesh_spec

    for e in plan.get("ranked", ()):
        axes = parse_mesh_spec(e["config"]["mesh"]).shape
        n = 1
        for s in axes.values():
            n *= s
        out[e["tag"]] = {
            "terms": {"%s_s" % k: v / 1e3
                      for k, v in e["terms_ms"].items()},
            "dp": int(axes.get("dp", 1)), "n_devices": n,
        }
    return out, plan.get("model")


def join_history(plan, records):
    """Pair every usable `ptune:<tag>` history record with its
    candidate's predicted terms.

    Returns a list of {"tag", "measured_s", "meas_compute_s",
    "overhead_s", "platform", "leg"} — `meas_compute_s` is the
    compute floor of what the leg actually ran (the per-device slice),
    i.e. compute_s rescaled from 1/n_devices to 1/dp.  Stale-platform
    records are skipped (never train on a re-emit)."""
    from ..obs import perf as obs_perf

    entries, _model = _plan_entries(plan)
    pairs = []
    for r in records:
        leg = r.get("leg") or ""
        if not leg.startswith(LEG_PREFIX):
            continue
        tag = leg[len(LEG_PREFIX):]
        ent = entries.get(tag)
        if ent is None:
            continue
        if obs_perf.is_stale_platform(r.get("platform")):
            continue
        step_ms = r.get("step_ms")
        if not step_ms or step_ms <= 0:
            continue
        t = ent["terms"]
        pairs.append({
            "tag": tag,
            "measured_s": float(step_ms) / 1e3,
            "meas_compute_s": t["compute_s"] * ent["n_devices"]
            / max(ent["dp"], 1),
            "overhead_s": t["overhead_s"],
            "platform": r.get("platform"),
            "platform_class": obs_perf.platform_class(r),
            "leg": leg,
        })
    return pairs


def join_comm_history(records):
    """Comm-measurement pairs from multichip history records.

    A multi-card bench record (spmd/bench.py) carries a `comm` blob:
    `pred_s` (the partition plan's analytic ring floor for one step's
    gradient traffic) and `measured_s` (the timed bucketed
    ring-allreduce of the same gradients on the same mesh).  Returns
    [{"leg", "measured_s", "pred_s", "wire_bytes", "platform_class"}]
    — stale platforms skipped, non-positive predictions skipped (no
    ratio to learn from)."""
    from ..obs import perf as obs_perf

    pairs = []
    for r in records:
        comm = r.get("comm") or {}
        meas = comm.get("measured_s")
        pred = comm.get("pred_s")
        if not meas or not pred or float(pred) <= 0:
            continue
        if obs_perf.is_stale_platform(r.get("platform")):
            continue
        pairs.append({
            "leg": r.get("leg"),
            "measured_s": float(meas),
            "pred_s": float(pred),
            "wire_bytes": comm.get("wire_bytes"),
            "platform_class": obs_perf.platform_class(r),
        })
    return pairs


def _median(vals):
    vals = sorted(vals)
    n = len(vals)
    if not n:
        return None
    if n % 2:
        return vals[n // 2]
    return (vals[n // 2 - 1] + vals[n // 2]) / 2.0


def _fit_comm(prior, comm_pairs, cls):
    """(comm coefficient, note) — the median measured/predicted ring
    ratio over comm pairs from the training platform class, or the
    prior's analytic price when there is nothing (usable) to learn
    from."""
    if comm_pairs:
        cp = [p for p in comm_pairs
              if cls is None or p.get("platform_class") == cls]
        if cp:
            ratio = _median([p["measured_s"] / p["pred_s"]
                             for p in cp])
            if ratio is not None and math.isfinite(ratio) \
                    and ratio > 0:
                return float(ratio), (
                    "comm coef %.3g fitted from %d multichip "
                    "measurement(s)%s"
                    % (ratio, len(cp),
                       (" on %s" % cls) if cls else ""))
        else:
            return prior.coef["comm"], (
                "comm term kept analytic: no multichip measurements "
                "in training class %s" % cls)
    return prior.coef["comm"], (
        "comm term uncalibrated: measurements are single-chip "
        "proxies (per-device batch slice)")


def _rel_error(pairs, a, b, bias):
    """Median |predicted - measured| / measured over the pairs."""
    errs = []
    for p in pairs:
        pred = a * p["meas_compute_s"] + b * p["overhead_s"] + bias
        errs.append(abs(pred - p["measured_s"]) / p["measured_s"])
    return _median(errs)


def fit_calibration(pairs, model=None, prior=None, comm_pairs=None):
    """Least-squares per-term correction from measured pairs.

    prior: the Calibration the `error_before` is charged against
        (identity when None — the uncalibrated model).
    comm_pairs: `join_comm_history` output; when present (and from
        the training platform class), the comm coefficient becomes
        the median measured/predicted ring-time ratio instead of the
        analytic prior.

    Degenerate data falls back gracefully: one measurement (or a
    singular/negative LS solution) fits a single scalar on
    compute+overhead; zero measurements returns the prior unchanged.
    """
    import numpy as np

    prior = prior or Calibration.identity()
    notes = []
    cls = None
    if pairs:
        # train on ONE platform class: the newest record's.  Mixing a
        # CPU sweep with one-card GPU history would average two
        # different physical machines into one line.
        cls = pairs[-1].get("platform_class")
        kept = [p for p in pairs
                if p.get("platform_class") == cls]
        if len(kept) != len(pairs):
            notes.append("dropped %d record(s) from other platform "
                         "classes (training on %s)"
                         % (len(pairs) - len(kept), cls))
        pairs = kept
    comm_coef, comm_note = _fit_comm(prior, comm_pairs, cls)
    notes.append(comm_note)
    if not pairs:
        if comm_pairs:
            return Calibration(
                coef=dict(prior.coef, comm=comm_coef),
                bias_s=prior.bias_s, n=prior.n, model=model,
                note="; ".join(notes))
        return prior
    err_before = _rel_error(pairs, prior.coef["compute"],
                            prior.coef["overhead"], prior.bias_s)
    n = len(pairs)
    a = b = bias = None
    if n >= 2:
        cols = [[p["meas_compute_s"] for p in pairs],
                [p["overhead_s"] for p in pairs]]
        if n >= 3:
            cols.append([1.0] * n)
        X = np.array(cols, dtype=np.float64).T
        y = np.array([p["measured_s"] for p in pairs],
                     dtype=np.float64)
        sol, _res, _rank, _sv = np.linalg.lstsq(X, y, rcond=None)
        sol = [float(v) for v in sol] + [0.0] * (3 - len(sol))
        a, b, bias = sol[0], sol[1], sol[2]
        if not all(math.isfinite(v) for v in (a, b, bias)) \
                or a <= 0 or b < 0:
            a = b = bias = None  # collinear/degenerate: scalar fallback
    if a is None:
        ratio = _median([p["measured_s"]
                         / (p["meas_compute_s"] + p["overhead_s"])
                         for p in pairs])
        a = b = float(ratio)
        bias = 0.0
    err_after = _rel_error(pairs, a, b, bias)
    if err_after is not None and err_before is not None \
            and err_after > err_before:
        # never ship a correction worse than what we had (can happen
        # when the median metric disagrees with the LS objective)
        a, b, bias = (prior.coef["compute"], prior.coef["overhead"],
                      prior.bias_s)
        err_after = err_before
    return Calibration(
        coef={"compute": a, "comm": comm_coef, "overhead": b},
        bias_s=bias, n=n, model=model,
        error_before=err_before, error_after=err_after,
        note="; ".join(notes))


def format_fit_report(calibration, pairs):
    """The `ptune fit`/`report` table: per-record predicted (with the
    fitted correction) vs measured, and the before/after error."""
    lines = ["calibration over %d measured run(s)%s:"
             % (len(pairs),
                (" for %s" % calibration.model)
                if calibration.model else "")]
    a = calibration.coef["compute"]
    b = calibration.coef["overhead"]
    bias = calibration.bias_s
    lines.append("  coef: compute %.4g, overhead %.4g, comm %.4g, "
                 "bias %.4g ms"
                 % (a, b, calibration.coef["comm"], bias * 1e3))
    lines.append("  %-44s %12s %12s %8s"
                 % ("candidate", "pred ms", "measured ms", "err"))
    for p in sorted(pairs, key=lambda p: p["tag"]):
        pred = a * p["meas_compute_s"] + b * p["overhead_s"] + bias
        err = abs(pred - p["measured_s"]) / p["measured_s"]
        lines.append("  %-44s %12.3f %12.3f %7.1f%%"
                     % (p["tag"], pred * 1e3,
                        p["measured_s"] * 1e3, err * 100))
    if calibration.error_before is not None:
        lines.append(
            "  median relative error: %.1f%% -> %.1f%% "
            "(before -> after fit)"
            % (calibration.error_before * 100,
               calibration.error_after * 100))
    if calibration.note:
        lines.append("  note: %s" % calibration.note)
    return "\n".join(lines)
