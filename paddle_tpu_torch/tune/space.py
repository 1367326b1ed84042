"""Declarative search space for the offline autotuner (`ptune`).

Counterpart of paddle_tpu/tune/space.py: the same knobs, constraints,
order, tags and pipeline ids, so one set of arguments enumerates the
same points in both packages.

The launch-config decisions made by hand — mesh shape, pass pipeline,
global batch, micro-batch split — form an enumerable space: every knob
has a finite choice list, and most invalid combinations are knowable
*before* any analysis runs (a mesh whose axis product misses the device
count, a batch the mesh cannot split, a micro-batch that does not divide
the per-device batch).  `SearchSpace` enumerates only the points that
survive its per-knob constraints, in a deterministic order, so a plan
built twice from the same arguments is the same plan.

Knobs:

  mesh           "dp=4,mp=2"-style specs (`parallel.mesh.parse_mesh_spec`
                 syntax).  `mesh_shapes_for(chips)` enumerates every
                 ordered factorization of the device count over the
                 requested axes; explicit lists are validated against
                 the device count at construction — an invalid mesh is
                 a ValueError, never a candidate.
  pipeline       a `compile.passes.PassManager` spec ("none" for the
                 raw program, "default" for dce,fold,cse,dve, or any
                 comma list of registered passes — layout, fuse and
                 auto_remat included, knobs and all:
                 "default+fuse:cap=8").  Unknown pass names are
                 rejected at construction.
  batch          global batch size (split over the dp axis).
  micro_batches  μ-cuDNN-style split of the per-device batch into m
                 sequential micro-steps — the memory-vs-speed knob:
                 activations scale ~1/m, dispatch overhead ~m.
  fusion_caps    `fuse:cap=` settings crossed with the pipelines that
                 contain a bare `fuse` pass (0 = leave the pipeline's
                 own setting); a cap paired with a fuse-less pipeline
                 is skipped AT ENUMERATION — no invalid points.
  remat_strides  `auto_remat:stride=` settings, same contract against
                 pipelines containing a bare `auto_remat` pass.

Deeper validity (S001–S005) is the sharding analyzer's job; `rank.py`
runs it per candidate and rejects what the space could not see
statically.  Enumerating a thousand points costs microseconds.
"""

from collections import OrderedDict

__all__ = ["Candidate", "SearchSpace", "mesh_shapes_for",
           "default_constraints", "DEFAULT_PIPELINES",
           "DEFAULT_BATCHES", "DEFAULT_MICRO_BATCHES",
           "DEFAULT_FUSION_CAPS", "DEFAULT_REMAT_STRIDES"]

# "none" keeps the program as built; "default" is the full verified
# rewrite pipeline (compile/passes.py DEFAULT_PIPELINE)
DEFAULT_PIPELINES = ("none", "default")
DEFAULT_BATCHES = (64, 128, 256)
DEFAULT_MICRO_BATCHES = (1, 2, 4)
# 0 = "leave the pipeline's own knob": the default space does not
# multiply itself by pass knobs until the pipelines list opts into
# the opt passes (e.g. --pipelines default+fuse+auto_remat
# --fusion-caps 0,4,8 --remat-strides 0,4,8)
DEFAULT_FUSION_CAPS = (0,)
DEFAULT_REMAT_STRIDES = (0,)


def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


def mesh_shapes_for(chips, axes=("dp", "mp")):
    """Every ordered factorization of `chips` over `axes`, as
    "dp=4,mp=2"-style specs.  Deterministic: the leading axis runs
    from `chips` down to 1 (pure data parallelism — the common
    launch — ranks first), recursing the remainder over later axes."""
    chips = int(chips)
    if chips < 1:
        raise ValueError("chips must be >= 1, got %d" % chips)
    if not axes:
        raise ValueError("mesh_shapes_for needs at least one axis")
    specs = []

    def rec(i, remaining, parts):
        if i == len(axes) - 1:
            parts = parts + [(axes[i], remaining)]
            specs.append(",".join("%s=%d" % p for p in parts))
            return
        for d in sorted(_divisors(remaining), reverse=True):
            rec(i + 1, remaining // d, parts + [(axes[i], d)])

    rec(0, chips, [])
    return specs


def _normalize_pipeline(spec):
    """CLI pipeline names -> PassManager specs ("" = no passes);
    validates pass names AND pass knobs at SPACE construction so a
    typo'd pipeline can never become a candidate."""
    spec = (spec or "").strip()
    if spec in ("none", "raw", ""):
        return ""
    from ..compile.passes import PassManager

    # construction validates names and knob values; "default" expands
    # here (and knobs canonicalize) so two spellings of one pipeline
    # cannot enumerate as two points
    return PassManager(spec, verify=False).spec


def _fold_knob(tokens, pass_name, knob_token, knob_desc):
    """Replace the single bare `pass_name` token in `tokens` (a list,
    mutated in place) with `knob_token`.  Returns None on success or a
    skip reason: pass absent, pass already knobbed, or pass repeated
    (folding into one of several occurrences would be ambiguous AND
    the old name-keyed dict silently dropped the duplicates — the
    knobbed variant must never run a different pipeline than the
    baseline it is compared against)."""
    bare = [i for i, t in enumerate(tokens) if t == pass_name]
    pinned = [t for t in tokens
              if t.startswith(pass_name + ":")]
    if not bare:
        if pinned:
            return "pipeline already pins %s knobs (%s)" \
                % (pass_name, pinned[0])
        return "%s needs the %s pass in the pipeline" \
            % (knob_desc, pass_name)
    if len(bare) + len(pinned) > 1:
        return "pipeline repeats the %s pass; knob folding would be " \
            "ambiguous" % pass_name
    tokens[bare[0]] = knob_token
    return None


def _apply_pass_knobs(pipeline, fusion_cap, remat_stride):
    """Fold the space's fusion_cap/remat_stride dimensions into one
    pipeline spec.  Returns (spec, None) for a valid combination or
    (None, reason) for one that must be SKIPPED at enumeration —
    a knob aimed at a pass the pipeline does not run, or at a pass
    that already pins that knob, is never a candidate."""
    if not fusion_cap and not remat_stride:
        return pipeline, None
    tokens = [t for t in pipeline.split(",") if t]
    if fusion_cap:
        why = _fold_knob(tokens, "fuse", "fuse:cap=%d" % fusion_cap,
                         "fusion_cap=%d" % fusion_cap)
        if why:
            return None, why
    if remat_stride:
        why = _fold_knob(tokens, "auto_remat",
                         "auto_remat:stride=%d" % remat_stride,
                         "remat_stride=%d" % remat_stride)
        if why:
            return None, why
    return ",".join(tokens), None


class Candidate:
    """One point of the space: (mesh, pipeline, batch, micro_batches).

    Everything downstream keys off `tag()` — the stable identity the
    measurement leg name (`ptune:<tag>`) and the calibration join use
    — and `config()`, the blob the measurement leg stamps into its
    record so a measured row joins back to its candidate point."""

    __slots__ = ("mesh_spec", "pipeline", "batch", "micro_batches")

    def __init__(self, mesh_spec, pipeline="", batch=128,
                 micro_batches=1):
        self.mesh_spec = str(mesh_spec)
        self.pipeline = _normalize_pipeline(pipeline)
        self.batch = int(batch)
        self.micro_batches = int(micro_batches)
        if self.batch < 1:
            raise ValueError("batch must be >= 1, got %d" % self.batch)
        if self.micro_batches < 1:
            raise ValueError("micro_batches must be >= 1, got %d"
                             % self.micro_batches)

    @property
    def mesh_axes(self):
        """axis -> size, via the canonical parser."""
        from ..parallel.mesh import parse_mesh_spec

        return OrderedDict(parse_mesh_spec(self.mesh_spec).shape)

    @property
    def n_devices(self):
        n = 1
        for s in self.mesh_axes.values():
            n *= s
        return n

    @property
    def dp(self):
        """Size of the batch-sharding axis (1 when the mesh has no
        dp axis — the whole batch lands on every replica group)."""
        return self.mesh_axes.get("dp", 1)

    @property
    def per_device_batch(self):
        return self.batch // self.dp

    @property
    def pipeline_label(self):
        return self.pipeline or "none"

    def pipeline_id(self):
        """The compile-cache pipeline id this candidate's pass spec
        resolves to ('' for the raw program)."""
        from ..compile.passes import pipeline_id

        return pipeline_id(self.pipeline)

    def tag(self):
        """Stable candidate identity, e.g. "dp4.mp2-b128-mb2-dce,fold,
        cse,dve" — the measurement leg is `ptune:<tag>`."""
        mesh = self.mesh_spec.replace("=", "").replace(",", ".")
        return "%s-b%d-mb%d-%s" % (mesh, self.batch,
                                   self.micro_batches,
                                   self.pipeline_label)

    def config(self, model=None):
        """The candidate point as the "config" blob schema the
        measurement leg stamps (tune/measure.py asserts the measured
        record's blob matches this)."""
        cfg = {
            "mesh": self.mesh_spec,
            "batch": self.batch,
            "per_device_batch": self.per_device_batch,
            "micro_batches": self.micro_batches,
            "pass_pipeline": self.pipeline_id() or None,
        }
        if model is not None:
            cfg["model"] = model
        return cfg

    def bench_env(self, model=None):
        """The env overrides that make the measurement leg
        (`tune/leg.py`) measure this point's single-card proxy: the
        per-device batch slice, the micro-batch split, the candidate's
        pass pipeline, and the mesh/leg tags that join the record back
        here (`tune/measure.py` runs it; the plan JSON embeds it so a
        plan alone reproduces the measurement)."""
        env = {
            "BENCH_BATCH": str(self.per_device_batch),
            "BENCH_MICRO_BATCH": str(self.micro_batches),
            "BENCH_MESH": self.mesh_spec,
            "BENCH_LEG": "ptune:" + self.tag(),
            "FLAGS_compile_passes": self.pipeline,
        }
        if model is not None:
            env["BENCH_MODEL"] = model
        return env

    def to_dict(self):
        return {"mesh": self.mesh_spec, "pipeline": self.pipeline_label,
                "batch": self.batch,
                "micro_batches": self.micro_batches}

    def _key(self):
        return (self.mesh_spec, self.pipeline, self.batch,
                self.micro_batches)

    def __eq__(self, other):
        return isinstance(other, Candidate) and \
            self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return "Candidate(%s)" % self.tag()


# ---------------------------------------------------------------------------
# per-knob constraints
# ---------------------------------------------------------------------------

def _batch_splits_over_dp(cand):
    if cand.batch % cand.dp:
        return "batch %d not divisible by dp=%d" % (cand.batch,
                                                    cand.dp)
    return None


def _micro_divides_per_device_batch(cand):
    pdb = cand.batch // cand.dp if cand.batch % cand.dp == 0 else None
    if pdb is None:
        return None  # _batch_splits_over_dp already rejected it
    if pdb % cand.micro_batches:
        return "per-device batch %d not divisible by micro_batches=%d" \
            % (pdb, cand.micro_batches)
    if pdb // cand.micro_batches < 1:
        return "micro-batch of %d/%d samples is empty" \
            % (pdb, cand.micro_batches)
    return None


def default_constraints():
    """The built-in per-knob constraints: each takes a Candidate and
    returns None (valid) or a reason string (never enumerated)."""
    return [_batch_splits_over_dp, _micro_divides_per_device_batch]


class SearchSpace:
    """The declarative config space `ptune plan` enumerates.

        space = SearchSpace(chips=8, batches=[64, 128])
        for cand in space.points():
            ...

    chips: devices the plan targets; every mesh's axis product must
        equal it (explicit `meshes` are validated, generated ones are
        correct by construction).
    meshes: explicit mesh-spec list, or None to enumerate every
        factorization over `axes`.
    fusion_caps / remat_strides: `fuse:cap=` / `auto_remat:stride=`
        settings crossed with the pipelines (0 = leave the pipeline's
        own knob); combinations aimed at a pass the pipeline does not
        run are skipped at enumeration with a reason — no invalid
        points.
    constraints: extra per-knob predicates appended to
        `default_constraints()` (each: Candidate -> None | reason).

    `points()` is deterministic: mesh (leading axis descending) ->
    batch -> micro_batches -> pipeline -> fusion_cap -> remat_stride,
    constraints applied at enumeration so invalid points never exist.
    `skipped` records what the constraints rejected (tag -> reason)
    for the plan log.
    """

    def __init__(self, chips, meshes=None, pipelines=DEFAULT_PIPELINES,
                 batches=DEFAULT_BATCHES,
                 micro_batches=DEFAULT_MICRO_BATCHES,
                 axes=("dp", "mp"), constraints=None,
                 fusion_caps=DEFAULT_FUSION_CAPS,
                 remat_strides=DEFAULT_REMAT_STRIDES):
        from ..parallel.mesh import parse_mesh_spec

        self.chips = int(chips)
        if self.chips < 1:
            raise ValueError("chips must be >= 1, got %d" % self.chips)
        if meshes is None:
            meshes = mesh_shapes_for(self.chips, axes=axes)
        self.meshes = []
        for spec in meshes:
            cfg = parse_mesh_spec(spec)  # raises on bad syntax/axes
            n = 1
            for s in cfg.shape.values():
                n *= s
            if n != self.chips:
                raise ValueError(
                    "mesh %r has axis product %d but the space targets "
                    "%d chip(s) — resize an axis or drop the mesh"
                    % (spec, n, self.chips))
            self.meshes.append(str(spec))
        self.pipelines = [_normalize_pipeline(p) for p in pipelines]
        if len(set(self.pipelines)) != len(self.pipelines):
            raise ValueError("duplicate pipelines after normalization: "
                             "%r" % (pipelines,))
        self.batches = [int(b) for b in batches]
        self.micro_batches = [int(m) for m in micro_batches]
        if any(b < 1 for b in self.batches):
            raise ValueError("batches must be >= 1: %r" % (batches,))
        if any(m < 1 for m in self.micro_batches):
            raise ValueError("micro_batches must be >= 1: %r"
                             % (micro_batches,))
        self.fusion_caps = [int(c) for c in fusion_caps]
        self.remat_strides = [int(s) for s in remat_strides]
        if any(c < 0 or c == 1 for c in self.fusion_caps):
            raise ValueError("fusion_caps must be 0 (pipeline default) "
                             "or >= 2: %r" % (fusion_caps,))
        if any(s < 0 for s in self.remat_strides):
            raise ValueError("remat_strides must be >= 0: %r"
                             % (remat_strides,))
        self.constraints = default_constraints() + \
            list(constraints or [])
        self.skipped = OrderedDict()

    def points(self):
        """Enumerate the valid candidates (deterministic order).
        Duplicate points are skipped with a reason: a knob spelled at
        its pass default ("auto_remat:stride=8" when 8 IS the
        default) normalizes to the bare pass, so two knob settings
        can denote ONE pipeline — it must rank and measure once."""
        self.skipped = OrderedDict()
        seen = set()
        out = []
        for mesh in self.meshes:
            for batch in self.batches:
                for micro in self.micro_batches:
                    for pipe in self.pipelines:
                        for cap in self.fusion_caps:
                            for stride in self.remat_strides:
                                spec, why = _apply_pass_knobs(
                                    pipe, cap, stride)
                                if spec is None:
                                    key = "%s-b%d-mb%d-%s+cap%d+rs%d" \
                                        % (mesh.replace("=", "")
                                           .replace(",", "."),
                                           batch, micro, pipe or "none",
                                           cap, stride)
                                    self.skipped[key] = why
                                    continue
                                cand = Candidate(mesh, spec, batch,
                                                 micro)
                                reason = None
                                for check in self.constraints:
                                    reason = check(cand)
                                    if reason:
                                        break
                                if reason:
                                    self.skipped[cand.tag()] = reason
                                    continue
                                if cand in seen:
                                    self.skipped[
                                        "%s+cap%d+rs%d"
                                        % (cand.tag(), cap, stride)] = \
                                        "duplicate point after knob " \
                                        "normalization"
                                    continue
                                seen.add(cand)
                                out.append(cand)
        return out

    def to_dict(self):
        return {
            "chips": self.chips,
            "meshes": list(self.meshes),
            "pipelines": [p or "none" for p in self.pipelines],
            "batches": list(self.batches),
            "micro_batches": list(self.micro_batches),
            "fusion_caps": list(self.fusion_caps),
            "remat_strides": list(self.remat_strides),
        }
