"""SpmdTrainer — the plan-driven SPMD trainer.

Counterpart of paddle_tpu/spmd/trainer.py.  A thin subclass of
`parallel.ParallelTrainer` that routes the step through the
partition-plan artifact (`plan.build_partition_plan`):

  * the plan build IS the pre-startup verification (it runs the static
    analyzer with the partition rules and raises on S0xx errors), so
    `_verify` defers to it instead of running the analyzer twice, and
    stamps this worker's identity (host, rank, mesh, plan fingerprint)
    into the flight recorder's host context;
  * the plan's per-var specs override the `sharding.param_spec`
    heuristics in the mesh step (`make_parallel_step`'s
    `spec_overrides`), so a regex rule edit changes the layout with no
    trainer code change;
  * with `bucket_bytes > 0` and a pure-dp layout, the step is the
    explicit bucketed schedule (`overlap.make_overlapped_dp_step`), and
    it falls back to the mesh step otherwise (`overlap_fallback_reason`
    says why, in the JAX trainer's words).  `step_mode` names the step
    that runs: "overlap-dp" or "gspmd" (the JAX package's name for the
    mesh step, kept so records join across the packages).

The JAX trainer's first step acquires its compiled step from the
persistent compile cache (`_try_aot`).  The port's step is captured
(parallel/captured.py), and a CUDA graph cannot be saved, so its cache
entry records the capture instead: keyed as the JAX trainer keys its
step (`_pcache_key`: the program with its feeds, fetches, flags and
mesh, the stack, the step mode, ZeRO stage and bucket size, the plan's
fingerprint and the feeds' shapes and dtypes), it holds the capture's
seconds and pool bytes and the meta `origin="spmd_step"`, the mode,
whether the state is donated, the mesh and the plan's fingerprint.
`_aot_state` reads as the JAX trainer's: "pending" before the first
step, "tried" from the first step's lookup until its capture, then
"compiled" once a miss's capture stored its entry, "hit" when the first
step found an entry that passes its check (the step still captures),
"error" when the cache failed (the step runs captured all the same),
"no-cache" without a cache directory (or an uncaptured step), and "off"
with `use_pcache=False`.
`save_checkpoint` and `restore_checkpoint` write and read the sharded
per-rank snapshots of `checkpoint.py`, and `attach_supervisor` puts a
resilience supervisor over them; `elastic_generation` (set by
`resilience.elastic`) stamps each snapshot and guards each restore.
"""

import logging

from ..parallel.trainer import ParallelTrainer, make_parallel_step
from .overlap import make_overlapped_dp_step, overlap_supported
from .plan import build_partition_plan, load_rules

__all__ = ["SpmdTrainer", "attach_supervisor"]

_log = logging.getLogger("paddle_tpu_torch.spmd")

# the flags the step's cache key folds in (the JAX trainer's)
_TRACE_FLAGS = ("amp_bf16", "amp_bf16_act", "bn_shifted_stats",
                "donation")


def _rank():
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


class SpmdTrainer(ParallelTrainer):
    """End-to-end plan-driven SPMD trainer.

    Usage::

        trainer = SpmdTrainer(main_prog, startup_prog,
                              feed_names=["image", "label"],
                              fetch_names=[loss.name], mesh=mesh,
                              rules=[(r"fc_.*\\.w_0", ("mp", None))],
                              zero_stage=1)
        trainer.init()
        (loss,) = trainer.step({"image": x, "label": y})

    rules: partition rules in any `plan.load_rules` shape (path, rule
        document, or [(pattern, spec), ...]); None keeps the pure
        heuristic layout.
    plan: a pre-built `PartitionPlan` (e.g. loaded from the `shard_cli
        plan` artifact) — skips the analyzer run; the plan's mesh axes
        must match `mesh`.
    bucket_bytes: > 0 requests the explicit bucketed dp step with
        ring-allreduce buckets of that size; 0 (default) keeps the mesh
        step.  `step_mode` records which step runs.
    use_pcache: whether the first step looks its captured step up in
        the persistent cache (FLAGS_compile_cache_dir) and a miss's
        capture stores its entry; `_aot_state` says what happened.
    """

    def __init__(self, main_program, startup_program, feed_names,
                 fetch_names, mesh, rules=None, plan=None,
                 bucket_bytes=0, model=None, use_pcache=True, **kw):
        super().__init__(main_program, startup_program, feed_names,
                         fetch_names, mesh, **kw)
        self.rules = load_rules(rules) if rules is not None else None
        self.plan = plan
        self.bucket_bytes = int(bucket_bytes or 0)
        self.model = model
        self.use_pcache = bool(use_pcache)
        self.step_mode = None
        self.overlap_fallback_reason = None
        self._fetch_all = list(fetch_names)
        self._state_template = None
        self._aot_state = "pending" if self.use_pcache else "off"
        # the committed elastic view's generation (resilience.elastic
        # sets it): stamped into sharded snapshots, guards restores
        self.elastic_generation = None

    # -- plan-driven step hooks -----------------------------------------------
    def _build_plan(self):
        return build_partition_plan(
            self.main_program, self.mesh, self.feed_names,
            self.fetch_names, rules=self.rules,
            zero_stage=self.zero_stage, feed_specs=self.feed_specs,
            dp_axis=self.dp_axis, mp_axis=self.mp_axis,
            model=self.model, raise_on_error=True)

    def _mesh_axes(self):
        from ..parallel.mesh import mesh_shape

        return {a: int(s) for a, s in mesh_shape(self.mesh).items()}

    def _verify(self):
        # the plan build runs the analyzer (rules included) and raises
        # on the same S0xx errors verify_sharding would — one pass
        if self.plan is None:
            self.plan = self._build_plan()
        else:
            want = self._mesh_axes()
            if dict(self.plan.mesh_axes) != want:
                raise ValueError(
                    "partition plan was built for mesh %r but the "
                    "trainer mesh is %r — rebuild with `shard_cli plan`"
                    % (dict(self.plan.mesh_axes), want))
        # stamp this worker's identity into any future flight bundle:
        # a multi-process post-mortem must say WHICH process on WHICH
        # mesh (and against which plan) died, not just that one did
        from ..obs import fleet as obs_fleet
        from ..obs import flight as obs_flight

        obs_flight.set_host_context(
            host=obs_fleet.host_id(), process_index=_rank(),
            mesh_axes=self._mesh_axes(),
            plan_fingerprint=self.plan.fingerprint())

    def _make_step(self, fp, state, fetch_all, donate_state=None):
        if self.plan is None:       # init() not used (a caller drives
            self.plan = self._build_plan()  # _make_step directly)
        self._fetch_all = list(fetch_all)
        self._state_template = state
        if self.bucket_bytes > 0:
            ok, reason = overlap_supported(
                self.main_program, self.mesh, dp_axis=self.dp_axis,
                zero_stage=self.zero_stage)
            if ok:
                self.step_mode = "overlap-dp"
                return make_overlapped_dp_step(
                    self.main_program, self.feed_names, fetch_all,
                    self.mesh, state, dp_axis=self.dp_axis,
                    bucket_bytes=self.bucket_bytes,
                    donate_state=donate_state,
                    feed_specs=self.feed_specs, capture=self.capture)
            self.overlap_fallback_reason = reason
        self.step_mode = "gspmd"
        overrides = {n: self.plan.spec_of(n) for n in state
                     if self.plan.has(n)}
        return make_parallel_step(
            self.main_program, self.feed_names, fetch_all, self.mesh,
            state, dp_axis=self.dp_axis, mp_axis=self.mp_axis, fp=fp,
            zero_stage=self.zero_stage, feed_specs=self.feed_specs,
            donate_state=donate_state, spec_overrides=overrides,
            capture=self.capture)

    # -- the persistent cache -------------------------------------------------
    def _pcache_key(self, feeds):
        """The JAX trainer's `_pcache_key`, through the port's
        fingerprint module."""
        from ..compile import fingerprint as fp_mod
        from ..utils import flags

        return fp_mod.combine(
            fp_mod.program_fingerprint(
                self.main_program, feeds=self.feed_names,
                fetches=self._fetch_all,
                flag_items=[(k, flags.get_flag(k)) for k in _TRACE_FLAGS],
                mesh=self._mesh_axes()),
            fp_mod.environment_fingerprint(),
            "spmd:%s:z%d:b%d" % (self.step_mode, self.zero_stage,
                                 self.bucket_bytes),
            self.plan.fingerprint(),
            fp_mod.values_signature(feeds))

    def _entry_meta(self):
        return {"origin": "spmd_step", "mode": self.step_mode,
                "donated": bool(self.captured.donate),
                "mesh": self._mesh_axes(),
                "plan": self.plan.fingerprint()}

    def _try_aot(self, feeds):
        """The first step's lookup (the JAX `_try_aot`): a hit is an
        entry whose meta equals this step's; on a miss the step's first
        capture stores the entry.  A cache failure records "error" and
        never fails the step."""
        from ..compile import pcache as pcache_mod

        core = self.captured
        if core is None:
            self._aot_state = "no-cache"
            return
        meta = self._entry_meta()

        def check(entry):
            if {k: entry.get(k) for k in meta} != meta:
                raise ValueError("the entry records another step: %r"
                                 % ({k: entry.get(k) for k in meta},))

        try:
            cache = pcache_mod.get_cache()
            if cache is None:
                self._aot_state = "no-cache"
                return
            key = self._pcache_key(feeds)
            entry = cache.get(key, check=check)
        except Exception as exc:
            _log.warning("spmd step cache lookup failed (%r)", exc)
            self._aot_state = "error"
            return
        if entry is not None:
            self._aot_state = "hit"
            return

        def store(seconds, pool_bytes):
            core.on_capture = None
            try:
                cache.put(key, dict(meta, capture_seconds=seconds,
                                    pool_bytes=int(pool_bytes)),
                          compile_seconds=seconds, meta=meta)
            except Exception as exc:
                _log.warning("spmd step cache entry not stored (%r)", exc)
                self._aot_state = "error"
                return
            self._aot_state = "compiled"

        core.on_capture = store

    def step(self, feeds):
        if self._aot_state == "pending":
            self._aot_state = "tried"
            self._try_aot(feeds)
        return super().step(feeds)

    # -- sharded checkpoints --------------------------------------------------
    def save_checkpoint(self, root, step):
        """Blocking sharded save: this rank's shard files + manifests
        under root/checkpoint_<step> (every rank of the mesh calls it).
        Use `attach_supervisor` / `SpmdCheckpointSaver` for the
        background-writing loop form."""
        from .checkpoint import SpmdCheckpointSaver

        saver = SpmdCheckpointSaver(self, root, interval_secs=0.0)
        snap = saver.save(step)
        saver.wait()
        return snap

    def restore_checkpoint(self, root, max_generation=None):
        """Restore the newest complete sharded snapshot under `root`
        into this trainer's shardings (shard-exact when the layout
        matches; densified reassembly only on a layout change).
        `max_generation` defaults to the trainer's elastic generation
        (when set) so a stale host refuses a newer manifest.
        Returns the restore info dict ({step, snap, generation,
        densified})."""
        from .checkpoint import (latest_sharded_checkpoint,
                                 restore_sharded)

        snap = latest_sharded_checkpoint(root)
        if snap is None:
            raise IOError("no complete sharded checkpoint under %r"
                          % str(root))
        if max_generation is None:
            max_generation = self.elastic_generation
        state, info = restore_sharded(snap, self._shardings,
                                      max_generation=max_generation)
        self.state = state
        return info


def attach_supervisor(trainer, ckpt_dir, interval_secs=30.0,
                      max_to_keep=3, **kw):
    """A resilience `TrainingSupervisor` whose checkpoints are the
    SHARDED per-rank snapshots — preempt/auto-resume without ever
    densifying the optimizer state.

    The supervisor detects the saver's `latest`/`restore_latest`
    protocol and routes resume through them; `state_dump` stays None
    because `SpmdCheckpointSaver.save` captures the trainer's sharded
    state directly (no dense scope copy exists at any point).  The
    supervisor's place is the trainer's unless `place` is given.
    """
    from ..core.scope import Scope
    from ..resilience.supervisor import TrainingSupervisor
    from .checkpoint import SpmdCheckpointSaver

    if trainer.state is None:
        raise ValueError("call trainer.init() before attaching a "
                         "supervisor")
    saver = SpmdCheckpointSaver(trainer, ckpt_dir,
                                interval_secs=interval_secs,
                                max_to_keep=max_to_keep)
    kw.setdefault("generation",
                  getattr(trainer, "elastic_generation", None) or 0)
    kw.setdefault("place", trainer.place)
    return TrainingSupervisor(ckpt_dir, scope=Scope(), saver=saver,
                              **kw)
