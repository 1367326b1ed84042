"""Rule-driven partition planning with a serializable plan artifact.

Counterpart of paddle_tpu/spmd/plan.py.  The layering (the
`match_partition_rules` idiom): explicit regex rules decide first; any
parameter no rule matches falls back to the
`sharding.param_spec_reason` heuristics, so a handful of rules tunes the
layout without re-deriving the obvious (embedding/classifier) shards.
Everything flows through the static analyzer
(`analysis.shard.analyze_sharding`), so the plan is never a parallel
bookkeeping path: the analyzer's S001 diagnostics cite rule misses,
S002 rejects non-divisible shards before anything runs, and the plan's
specs ARE the analyzer's propagated `var_specs`.

The artifact (`shard_cli plan --out plan.json`) is a JSON document with
a content `fingerprint()`, the JAX plan's for the same program, mesh and
rules: a plan crosses between the packages as its JSON.  `SpmdTrainer`
lays its state out by the plan and stamps the fingerprint into the
flight recorder's host context; the JAX trainer also keys its
persistent compile cache on it, and so does the port's `SpmdTrainer`
for the entry of its captured step.
"""

import hashlib
import json
import os
import re

from ..parallel.sharding import NamedSharding, PartitionSpec as P

__all__ = ["PartitionPlan", "build_partition_plan",
           "match_partition_rules", "load_rules", "PLAN_KIND"]

PLAN_KIND = "spmd_partition_plan"


def _spec_to_json(spec):
    """Canonical spec tuple (analysis.shard._norm_spec form) -> a JSON
    list whose entries are None, an axis name, or a list of names."""
    if spec is None:
        return None
    return [list(e) if isinstance(e, (list, tuple)) else e
            for e in spec]


def _spec_from_json(spec):
    if spec is None:
        return None
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


def _partition_spec(spec):
    """JSON/canonical spec -> PartitionSpec."""
    if spec is None:
        return P()
    return P(*[tuple(e) if isinstance(e, (list, tuple)) else e
               for e in spec])


def match_partition_rules(rules, name):
    """First-match-wins regex lookup: returns (spec, pattern) for the
    first rule whose pattern `re.search`es `name`, or (None, None)
    when nothing matches (the caller's heuristic fallback point: a
    miss is not an error here, because `param_spec_reason` still
    stands behind the rules)."""
    for pat, spec in rules:
        if re.search(pat, name):
            return spec, pat
    return None, None


def load_rules(path_or_obj):
    """Partition rules from a JSON file / dict / list.

    Accepted shapes:
      [["pattern", ["mp", null]], ...]            (bare rule list)
      {"rules": [["pattern", ["mp", null]], ...]} (rule document)

    Spec entries are None (replicate the dim), an axis name, or a
    list of axis names.  Returns [(pattern, spec_tuple), ...].
    """
    obj = path_or_obj
    if isinstance(obj, str):
        with open(obj) as f:
            obj = json.load(f)
    if isinstance(obj, dict):
        obj = obj.get("rules", [])
    rules = []
    for entry in obj:
        pat, spec = entry[0], entry[1]
        re.compile(pat)  # raise early on a bad pattern
        rules.append((str(pat), _spec_from_json(spec) or ()))
    return rules


class PartitionPlan:
    """The partition-plan artifact: mesh axes, per-var specs with
    replication reasons, the rule list that produced them, comm/HBM
    estimates, and the analyzer's diagnostics — one JSON document
    shared by `shard_cli plan` and the trainer's layout.
    """

    def __init__(self, mesh_axes, var_specs, param_reasons=None,
                 rules=None, zero_stage=0, dp_axis="dp", mp_axis="mp",
                 comm=None, peak_hbm_bytes=None, diagnostics=None,
                 feeds=None, fetches=None, model=None):
        self.mesh_axes = dict(mesh_axes)
        self.var_specs = {n: tuple(s) if s is not None else None
                          for n, s in var_specs.items()}
        self.param_reasons = dict(param_reasons or {})
        self.rules = list(rules) if rules else None
        self.zero_stage = int(zero_stage)
        self.dp_axis = dp_axis
        self.mp_axis = mp_axis
        self.comm = comm or {}
        self.peak_hbm_bytes = peak_hbm_bytes
        self.diagnostics = list(diagnostics or [])
        self.feeds = list(feeds or [])
        self.fetches = list(fetches or [])
        self.model = model

    # -- layout lookups -----------------------------------------------------
    def spec_of(self, name):
        """PartitionSpec for `name` (replicated when the plan carries
        no entry — the analyzer covers every param/state var, so a
        miss is an activation or a detached var)."""
        return _partition_spec(self.var_specs.get(name))

    def has(self, name):
        return name in self.var_specs

    def sharding_for(self, name, mesh):
        return NamedSharding(mesh, self.spec_of(name))

    def sharded_params(self):
        return sorted(n for n, s in self.var_specs.items()
                      if s and any(e is not None for e in s))

    def replicated_params(self):
        return sorted(n for n, s in self.var_specs.items()
                      if not (s and any(e is not None for e in s)))

    # -- serialization ------------------------------------------------------
    def to_dict(self):
        return {
            "kind": PLAN_KIND,
            "mesh": dict(self.mesh_axes),
            "dp_axis": self.dp_axis,
            "mp_axis": self.mp_axis,
            "zero_stage": self.zero_stage,
            "model": self.model,
            "feeds": list(self.feeds),
            "fetches": list(self.fetches),
            "rules": ([[p, _spec_to_json(s)] for p, s in self.rules]
                      if self.rules else None),
            "var_specs": {n: _spec_to_json(s)
                          for n, s in sorted(self.var_specs.items())},
            "replication_reasons": {
                n: r for n, r in sorted(self.param_reasons.items())
                if r},
            "comm": self.comm,
            "peak_hbm_bytes": self.peak_hbm_bytes,
            "diagnostics": self.diagnostics,
            "fingerprint": self.fingerprint(),
        }

    @classmethod
    def from_dict(cls, blob):
        if blob.get("kind") != PLAN_KIND:
            raise ValueError("not a partition plan (kind=%r)"
                             % blob.get("kind"))
        rules = blob.get("rules")
        return cls(
            blob["mesh"],
            {n: _spec_from_json(s)
             for n, s in blob.get("var_specs", {}).items()},
            param_reasons=blob.get("replication_reasons"),
            rules=[(p, _spec_from_json(s)) for p, s in rules]
            if rules else None,
            zero_stage=blob.get("zero_stage", 0),
            dp_axis=blob.get("dp_axis", "dp"),
            mp_axis=blob.get("mp_axis", "mp"),
            comm=blob.get("comm"),
            peak_hbm_bytes=blob.get("peak_hbm_bytes"),
            diagnostics=blob.get("diagnostics"),
            feeds=blob.get("feeds"), fetches=blob.get("fetches"),
            model=blob.get("model"))

    def save(self, path):
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def fingerprint(self):
        """Content hash of exactly what changes the layout:
        mesh axes, per-var specs, zero stage, and the rule list —
        NOT the diagnostics or cost estimates (a cost model change
        must not change a layout's identity).  The same digest as the
        JAX plan's."""
        basis = {
            "mesh": sorted(self.mesh_axes.items()),
            "zero_stage": self.zero_stage,
            "var_specs": {n: _spec_to_json(s)
                          for n, s in sorted(self.var_specs.items())},
            "rules": ([[p, _spec_to_json(s)] for p, s in self.rules]
                      if self.rules else None),
        }
        payload = json.dumps(basis, sort_keys=True).encode()
        return hashlib.sha256(payload).hexdigest()

    def summary(self):
        """The `shard_cli plan` stdout: layout counts, rule coverage,
        comm totals, HBM, and any non-INFO diagnostics."""
        n_sh, n_rep = len(self.sharded_params()), \
            len(self.replicated_params())
        mesh = ",".join("%s=%d" % kv
                        for kv in sorted(self.mesh_axes.items()))
        lines = ["partition plan over mesh {%s}  zero%d  "
                 "fingerprint %s" % (mesh, self.zero_stage,
                                     self.fingerprint()[:12])]
        lines.append("  params: %d sharded, %d replicated%s"
                     % (n_sh, n_rep,
                        "  (%d rules)" % len(self.rules)
                        if self.rules else "  (heuristic specs)"))
        for name, why in sorted(self.param_reasons.items()):
            if why:
                lines.append("    replicated %-32s %s" % (name, why))
        comm = self.comm or {}
        if comm.get("total_wire_bytes") is not None:
            lines.append("  comm: %.2f MiB/step on the wire, "
                         "%.3f ms ring floor"
                         % (comm["total_wire_bytes"] / 2 ** 20,
                            1e3 * (comm.get("step_seconds_floor")
                                   or 0.0)))
        if self.peak_hbm_bytes:
            lines.append("  peak HBM/device (static): %.1f MiB"
                         % (self.peak_hbm_bytes / 2 ** 20))
        bad = [d for d in self.diagnostics
               if d.get("severity") not in (None, "info")]
        for d in bad:
            lines.append("  [%s/%s] %s%s"
                         % (d.get("code"), d.get("severity"),
                            ("%s: " % d["var_name"])
                            if d.get("var_name") else "",
                            d.get("message", "")))
        return "\n".join(lines)


def build_partition_plan(program, mesh, feed_names, fetch_names,
                         rules=None, zero_stage=0, feed_specs=None,
                         dp_axis="dp", mp_axis="mp", hbm_gb=None,
                         concrete_feeds=True, model=None,
                         raise_on_error=True):
    """Run the static sharding analyzer and package its output as a
    `PartitionPlan` artifact.

    rules: `load_rules` output ([(pattern, spec), ...]) or None for
        pure heuristics.  Rules route through the analyzer's own rule
        path so a miss surfaces as its S001 diagnostic and the plan's
        `replication_reasons` carry "matched no partition rule".
    raise_on_error: propagate the analyzer's
        ProgramVerificationError on any S0xx error finding (S002
        non-divisible, S004 hazard, S005 over budget) — the
        trust-boundary default; `shard_cli plan` passes False to print
        the findings instead.
    """
    from ..analysis import shard as shard_analysis

    analysis = shard_analysis.analyze_sharding(
        program, mesh, feed_names=list(feed_names),
        feed_specs=feed_specs, rules=rules, fetches=list(fetch_names),
        zero_stage=zero_stage, dp_axis=dp_axis, mp_axis=mp_axis,
        hbm_gb=hbm_gb, concrete_feeds=concrete_feeds)
    if raise_on_error:
        analysis.report.raise_on_error()
    axes = {a: int(s) for a, s in dict(analysis.mesh_axes).items()}
    plan = PartitionPlan(
        axes, analysis.var_specs,
        param_reasons=analysis.param_reasons, rules=rules,
        zero_stage=zero_stage, dp_axis=dp_axis, mp_axis=mp_axis,
        comm=analysis.comm.to_dict(topk=5),
        peak_hbm_bytes=analysis.peak_hbm_bytes,
        diagnostics=[d.to_dict()
                     for d in analysis.report.diagnostics],
        feeds=list(feed_names), fetches=list(fetch_names),
        model=model)
    plan.analysis = analysis  # the full ShardingPlan, for callers
    return plan
