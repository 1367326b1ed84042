"""Preemption-safe auto-resume training supervisor.

Counterpart of paddle_tpu/resilience/supervisor.py.  A training job on
a preemptible pool will be interrupted: the scheduler sends SIGTERM
with a grace window, disks and coordinators flake, and a bad batch can
blow the loss to NaN.  `TrainingSupervisor` wraps a step-driven loop so
that it survives all three:

  * **Preemption**: SIGTERM and SIGINT hooks (installed on the main
    thread only, the handlers before restored on exit) flip a flag; the
    step loop notices it at the next step boundary (the same boundary
    on every rank where the saver's ranks must agree), writes an urgent
    synchronous checkpoint (parameters, optimizer state and a
    `supervisor.json` meta with step, epoch and batch), and either
    resumes in place (`on_preempt="resume"`) or raises `Preempted` so
    the process can exit and be rescheduled (`on_preempt="raise"`: the
    next start of the same supervisor resumes from the urgent
    snapshot).
  * **Resume**: `run()` restores `latest_checkpoint` into the scope, on
    the supervisor's place (the card unless given `CPUPlace()`), reads
    the meta and replays the epoch's reader, skipping the batches
    already consumed: with a deterministic reader the resumed
    trajectory equals an uninterrupted run's step for step.
  * **Transient faults**: retryable exceptions (IOError, OSError,
    ConnectionError, TimeoutError by default) from the step or the
    reader trigger a restore and resume, bounded by `max_restarts`
    across the run; anything else propagates.
  * **Nonfinite loss**: when the step's loss (or an attached numerics
    monitor's summary) goes NaN or Inf, the supervisor rolls back to
    the last good snapshot, backs off the `fluid.amp.LossScaler` when
    one is attached, and replays from there.

In a sharded job (a saver with `agree`, one answer for every rank) the
ranks decide each of these at the same step boundary: whether the
reader's next batch raised a retryable error, whether the
`supervisor/step` fault point fired (`io_error`, `nonfinite`), and
whether the step's loss is nonfinite.  Only then does any rank raise,
restore or go on, so a fault on one rank restarts every rank from the
same snapshot, as the JAX package's one-process sharded job does.  A
fault raised inside `step_fn` after the step's first collective cannot
be agreed this way: the other ranks already wait in that collective.
Nor can a reader that fails where the other ranks' readers end their
epoch.

The checkpoints are the supervisor's own synchronous saves
(`steps_per_checkpoint` or `interval_secs`): synchronous because the
meta sidecar and the rollback need the manifest on disk before training
goes on past it.  Random state is not checkpointed: resume determinism
holds for programs whose per-step ops draw nothing from the random
stream (dropout-free); see docs/RESILIENCE.md.  The mesh-parallel
adapters (`run_parallel`, `for_parallel`) supervise a
`parallel.ParallelTrainer`, whose snapshots hold the full values of its
sharded state.  On restore the supervisor reports the persistent plan
cache (compile/pcache.py) as the JAX supervisor reports its executable
cache: `compile_cache_entries` and `compile_cache_bytes` gauges and a
`supervisor_pcache` instant.
"""

import json
import math
import os
import signal as signal_mod
import threading
import time

import numpy as np
import torch

from ..fluid.checkpoint import (CheckpointSaver, latest_checkpoint,
                                load_checkpoint)
from ..obs import registry as registry_mod
from ..obs import trace as trace_mod
from . import faults as faults_mod
from .retry import DEFAULT_RETRYABLE

__all__ = ["TrainingSupervisor", "Preempted", "RestartBudgetExceeded",
           "ElasticResized", "SUPERVISOR_META"]

SUPERVISOR_META = "supervisor.json"


class Preempted(Exception):
    """A preemption signal arrived; the urgent checkpoint is on disk."""


class ElasticResized(Exception):
    """The elastic membership layer committed a new cluster view and
    already moved the trainer onto it (state restored at the new
    layout).  A step loop raises this so the supervisor counts the
    cycle as `reason="elastic_resize"`, distinct from `preempt`,
    without rolling the re-placed state back to a snapshot from before
    the resize."""

    def __init__(self, generation, direction="shrink"):
        super().__init__("elastic resize to generation %d (%s)"
                         % (int(generation), direction))
        self.generation = int(generation)
        self.direction = direction


class RestartBudgetExceeded(RuntimeError):
    """The supervisor restarted `max_restarts` times and gave up."""


class _Rollback(Exception):
    """Internal: roll back to the last-good snapshot and resume."""

    def __init__(self, reason):
        super().__init__(reason)
        self.reason = reason


class _PeerFault(Exception):
    """Internal: another rank of the job faulted at this step boundary;
    this rank restores with it."""


def _reg():
    return registry_mod.get_registry()


class TrainingSupervisor:
    """Supervise a step-driven train loop with checkpoint/resume.

    Core entry point::

        sup = TrainingSupervisor("ckpts", program=main_program,
                                 steps_per_checkpoint=50)
        sup.run(step_fn, reader_fn, num_epochs=3)

    where `step_fn(batch) -> loss` runs one optimizer step and
    `reader_fn()` yields one epoch of batches (re-invocable, the paddle
    reader contract: resume re-creates the iterator and skips the
    consumed batches).  `run_v2` adapts the v2 trainer onto this loop.

    program: the Program (or ProgramDesc) whose persistables the
    snapshots hold, unless `var_names` names them.
    place: where a restore loads the snapshot: CUDAPlace(0) by default
    (which raises without a CUDA device), CPUPlace() when asked; give
    the executor's place.
    state_dump(scope) and state_restore(scope) run before every
    snapshot save and after every snapshot load.
    """

    def __init__(self, ckpt_dir, program=None, scope=None,
                 var_names=None, interval_secs=30.0,
                 steps_per_checkpoint=None, max_to_keep=3,
                 max_restarts=3, retryable=DEFAULT_RETRYABLE,
                 loss_scaler=None, on_preempt="resume",
                 preempt_signals=(signal_mod.SIGTERM,
                                  signal_mod.SIGINT),
                 resume=True, state_dump=None, state_restore=None,
                 saver=None, generation=0, place=None):
        if on_preempt not in ("resume", "raise"):
            raise ValueError("on_preempt must be 'resume' or 'raise'")
        if place is None:
            from ..fluid.executor import CUDAPlace

            place = CUDAPlace(0)
        place.device()  # a CUDAPlace without a CUDA device raises here
        self.place = place
        if var_names is None and program is not None \
                and not hasattr(program, "list_vars"):
            # a ProgramDesc: its persistables
            var_names = [n for b in program.blocks
                         for n, vd in b.vars.items() if vd.persistable]
        self.ckpt_dir = str(ckpt_dir)
        # elastic generation of the view this supervisor serves; the
        # meta records it, so a resume after a restart of the whole job
        # picks the view after a shrink, not the one at launch
        self.generation = int(generation or 0)
        self.max_restarts = int(max_restarts)
        self.retryable = retryable
        self.loss_scaler = loss_scaler
        self.on_preempt = on_preempt
        self.preempt_signals = tuple(preempt_signals)
        self.resume = bool(resume)
        self.steps_per_checkpoint = steps_per_checkpoint
        self.state_dump = state_dump
        self.state_restore = state_restore
        from ..core.scope import global_scope

        self._scope = scope if scope is not None else global_scope()
        self._saver = saver or CheckpointSaver(
            self.ckpt_dir,
            main_program=program if var_names is None else None,
            interval_secs=interval_secs, max_to_keep=max_to_keep,
            var_names=var_names)
        self._step = 0
        self._epoch = 0
        self._batch = 0          # batches consumed in the current epoch
        self._restarts = 0
        self._last_ckpt_step = 0
        self._last_ckpt_time = time.time()
        self._preempted = False
        self._old_handlers = None

    # -- signal hooks -------------------------------------------------------
    def _on_signal(self, signum, frame):
        self._preempted = True
        _reg().counter("supervisor_preemptions_total",
                       "preemption signals observed by the "
                       "supervisor").inc()
        trace_mod.instant("preempt_signal", cat="supervisor",
                          signum=int(signum))

    def _install_signals(self):
        if threading.current_thread() is not threading.main_thread():
            return  # signal.signal only works from the main thread
        self._old_handlers = {}
        for sig in self.preempt_signals:
            self._old_handlers[sig] = signal_mod.signal(
                sig, self._on_signal)

    def _restore_signals(self):
        if self._old_handlers is None:
            return
        for sig, handler in self._old_handlers.items():
            try:
                signal_mod.signal(sig, handler)
            except (ValueError, TypeError):
                pass
        self._old_handlers = None

    # -- checkpointing ------------------------------------------------------
    def _checkpoint(self, kind):
        """Synchronous snapshot + supervisor meta sidecar.  Returns the
        snapshot path."""
        if self.state_dump is not None:
            self.state_dump(self._scope)
        snap = self._saver.save(self._step, self._scope)
        self._saver.wait()  # manifest + fsync done before meta lands
        meta = {"step": self._step, "epoch": self._epoch,
                "batch": self._batch, "kind": kind,
                "generation": self.generation,
                "time": time.time()}
        if self.loss_scaler is not None:
            meta["loss_scale"] = self.loss_scaler.scale
        # every rank of a sharded job writes the same meta into the one
        # snapshot: a temporary of its own, so no rank renames another's
        tmp = os.path.join(snap, "%s.%d.tmp" % (SUPERVISOR_META,
                                                os.getpid()))
        with open(tmp, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(snap, SUPERVISOR_META))
        self._last_ckpt_step = self._step
        self._last_ckpt_time = time.time()
        _reg().counter("supervisor_checkpoints_total",
                       "supervisor-driven snapshots, by kind",
                       labelnames=("kind",)).labels(kind=kind).inc()
        return snap

    def _checkpoint_due(self):
        if self.steps_per_checkpoint is not None:
            return (self._step - self._last_ckpt_step
                    >= self.steps_per_checkpoint)
        return (time.time() - self._last_ckpt_time
                >= self._saver.interval_secs)

    def _latest_snapshot(self):
        """Newest complete snapshot path, through the saver when it has
        `latest` (a saver of another snapshot layout), else the
        `latest_checkpoint` scan."""
        if hasattr(self._saver, "latest"):
            return self._saver.latest()
        return latest_checkpoint(self.ckpt_dir)

    def _restore_latest(self):
        """Load the newest valid snapshot and its meta into the scope, on
        the supervisor's place; resets step, epoch and batch to the
        restored position.  A saver with `restore_latest` owns the
        load."""
        if hasattr(self._saver, "restore_latest"):
            step = self._saver.restore_latest(scope=self._scope)
        else:
            step = load_checkpoint(self.ckpt_dir, scope=self._scope,
                                   place=self.place)
        if step is None:
            raise IOError("no checkpoint to restore under %r"
                          % self.ckpt_dir)
        snap = self._latest_snapshot()
        meta = {}
        meta_path = os.path.join(snap, SUPERVISOR_META) if snap else None
        if meta_path and os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        self._step = int(meta.get("step", step))
        self._epoch = int(meta.get("epoch", 0))
        self._batch = int(meta.get("batch", 0))
        self.generation = int(meta.get("generation", self.generation))
        if self.loss_scaler is not None and "loss_scale" in meta:
            self.loss_scaler.set_scale(meta["loss_scale"])
        if self.state_restore is not None:
            self.state_restore(self._scope)
        # a just-restored run must not immediately re-snapshot what it
        # loaded: the checkpoint cadence restarts from here
        self._last_ckpt_step = self._step
        self._last_ckpt_time = time.time()
        trace_mod.instant("supervisor_restore", cat="supervisor",
                          step=self._step, epoch=self._epoch,
                          batch=self._batch)
        # resume is the moment the persistent plan cache pays off (a
        # restarted process plans nothing before its first step): say
        # what the cache holds, so /metrics on a resumed run shows
        # whether the warm start was real
        from ..compile import pcache

        if pcache.enabled():
            stats = pcache.publish_stats()
            if stats is not None:
                trace_mod.instant("supervisor_pcache", cat="supervisor",
                                  entries=stats["entries"],
                                  bytes=stats["bytes"])
        return self._step

    # -- the supervised loop ------------------------------------------------
    @staticmethod
    def _loss_value(out):
        """Best-effort scalar view of a step result (a float, an array
        or tensor, a [loss, ...] fetch list); None when there is no
        scalar to check."""
        if out is None:
            return None
        if isinstance(out, (list, tuple)):
            out = out[0] if out else None
            if out is None:
                return None
        if isinstance(out, torch.Tensor):
            out = out.detach().float().cpu().numpy()
        try:
            return float(np.asarray(out).reshape(-1)[0])
        except (TypeError, ValueError, IndexError):
            return None

    def _agreed(self, *flags):
        """`flags` as every rank of the job reads them: through the
        saver's `agree` where it has one (a sharded saver, whose saves
        every rank must make at the same step), else as given."""
        agree = getattr(self._saver, "agree", None)
        return flags if agree is None else tuple(agree(*flags))

    @staticmethod
    def _raise_fault(error):
        """Raise this rank's own fault, or, when the fault was another
        rank's, `_PeerFault`."""
        if error is not None:
            raise error
        raise _PeerFault("a fault on another rank")

    def _preempt(self):
        """The urgent snapshot, then Preempted."""
        self._preempted = False
        self._checkpoint("urgent")
        raise Preempted("preemption signal at step %d" % self._step)

    def _check_preempt(self, due=False):
        """The end of a step: the interval snapshot when `due`, then the
        urgent snapshot and Preempted when a signal was seen, both
        decided for all ranks at once (`_agreed`)."""
        due, preempted = self._agreed(due, self._preempted)
        if due:
            self._checkpoint("interval")
        if preempted:
            self._preempt()

    def _start_step(self, error):
        """The start of a step, decided for all ranks in one vote
        (`_agreed`): a fault (this rank's reader `error`, or the
        `supervisor/step` fault point raising), else a pending
        preemption signal, else a simulated blowup, which is returned.
        The fault point is not evaluated where the reader failed or a
        signal is pending, as a world of one never reached it there."""
        preempted, fault = self._preempted, None
        if error is None and not preempted:
            try:
                fault = faults_mod.check("supervisor/step",
                                         step=self._step)
            except self.retryable as exc:
                error = exc
        faulted, preempted, blowup = self._agreed(
            error is not None, preempted,
            fault is not None and fault.kind == "nonfinite")
        if faulted:
            self._raise_fault(error)
        if preempted:
            self._preempt()
        return blowup

    def _train(self, step_fn, reader_fn, num_epochs, on_step):
        while self._epoch < num_epochs:
            skip = self._batch
            batches = None
            while True:
                error = None
                try:
                    if batches is None:
                        batches = enumerate(reader_fn())
                    batch_idx, data = next(batches)
                except StopIteration:
                    break
                except self.retryable as exc:
                    # agreed at the step boundary, then raised
                    error = exc
                if error is None and batch_idx < skip:
                    continue
                blowup = self._start_step(error)
                if blowup:
                    # a simulated numerics blowup: the step does not run
                    # (the parameters are untouched); the supervisor
                    # observes a nonfinite loss and must recover
                    loss = float("nan")
                else:
                    loss = self._loss_value(step_fn(data))
                (nonfinite,) = self._agreed(
                    loss is not None and not math.isfinite(loss))
                if nonfinite:
                    _reg().counter(
                        "supervisor_nonfinite_total",
                        "nonfinite step losses observed by the "
                        "supervisor").inc()
                    trace_mod.instant("supervisor_nonfinite",
                                      cat="supervisor",
                                      step=self._step)
                    raise _Rollback("nonfinite")
                self._step += 1
                self._batch = batch_idx + 1
                _reg().gauge("supervisor_step",
                             "global step of the supervised "
                             "run").set(self._step)
                _reg().gauge("supervisor_epoch",
                             "epoch of the supervised "
                             "run").set(self._epoch)
                if on_step is not None:
                    on_step(self._step, loss)
                self._check_preempt(due=self._checkpoint_due())
            self._epoch += 1
            self._batch = 0
            self._checkpoint("epoch")
        self._checkpoint("final")

    def run(self, step_fn, reader_fn, num_epochs=1, on_step=None):
        """Supervise `num_epochs` of training; returns a summary dict.

        Restores the newest checkpoint first (resume=True), restarts on
        retryable failures / preemption / nonfinite rollback up to
        `max_restarts` times, and always leaves a final checkpoint on
        success."""
        self._install_signals()
        try:
            if self.resume and self._latest_snapshot():
                self._restore_latest()
            else:
                # baseline snapshot: the rollback target before the
                # first interval checkpoint lands
                self._checkpoint("baseline")
            while True:
                try:
                    self._train(step_fn, reader_fn, num_epochs,
                                on_step)
                    return {"steps": self._step,
                            "epochs": self._epoch,
                            "restarts": self._restarts}
                except Preempted:
                    if self.on_preempt == "raise":
                        raise
                    reason = "preempt"
                except ElasticResized as er:
                    # the elastic layer already re-placed the state at
                    # the new generation: count the cycle, adopt the
                    # generation, and do not restore (that would roll
                    # back the resize)
                    reason = "elastic_resize"
                    self.generation = er.generation
                except _Rollback as rb:
                    reason = rb.reason
                except _PeerFault:
                    reason = "fault"
                    trace_mod.instant("supervisor_fault",
                                      cat="supervisor", error="peer")
                except Exception as exc:
                    if not isinstance(exc, self.retryable):
                        raise
                    reason = "fault"
                    trace_mod.instant("supervisor_fault",
                                      cat="supervisor",
                                      error=type(exc).__name__)
                self._restarts += 1
                _reg().counter(
                    "supervisor_restarts_total",
                    "supervisor restore-and-resume cycles, by reason",
                    labelnames=("reason",)).labels(reason=reason).inc()
                if self._restarts > self.max_restarts:
                    raise RestartBudgetExceeded(
                        "gave up after %d restarts (last reason: %s)"
                        % (self._restarts - 1, reason))
                if reason != "elastic_resize":
                    self._restore_latest()
                if reason == "nonfinite" and self.loss_scaler is not None:
                    # back off after the restore, so the meta's scale
                    # (captured before the blowup) does not undo it
                    self.loss_scaler.update(True)
        finally:
            self._restore_signals()

    # -- trainer adapters ---------------------------------------------------
    def run_v2(self, sgd, reader_fn, num_passes=1, feeding=None,
               on_step=None):
        """Supervise a `v2.trainer.SGD`: one supervised step is one
        forward, backward and update through its executor (the numerics
        monitor included when `obs.health.enable()` is on)."""
        return self.run(sgd.step_runner(feeding=feeding), reader_fn,
                        num_epochs=num_passes, on_step=on_step)

    @classmethod
    def for_v2(cls, sgd, ckpt_dir, **kw):
        """Supervisor over the v2 trainer's program and the global
        scope, restoring onto its executor's place."""
        from ..core.scope import global_scope

        kw.setdefault("loss_scaler", getattr(sgd, "loss_scaler", None))
        kw.setdefault("place", sgd._exe.place)
        return cls(ckpt_dir, program=sgd._main_program,
                   scope=global_scope(), **kw)

    def run_parallel(self, trainer, reader_fn, num_epochs=1,
                     on_step=None):
        """Supervise a `parallel.ParallelTrainer` (init() already
        called): the sharded state syncs through the supervisor scope
        around every snapshot (see for_parallel)."""

        def step(data):
            fetches = trainer.step(data)
            return self._loss_value(fetches)

        return self.run(step, reader_fn, num_epochs=num_epochs,
                        on_step=on_step)

    @classmethod
    def for_parallel(cls, trainer, ckpt_dir, **kw):
        """Supervisor over a ParallelTrainer's state dict: snapshots save
        the full values of the sharded state (`dump_state_to`), restores
        lay them out on the mesh again (`load_state_from`) on the
        trainer's place."""
        from ..core.scope import Scope

        if trainer.state is None:
            raise ValueError("call trainer.init() before attaching a "
                             "supervisor")
        kw.setdefault("place", trainer.place)
        return cls(ckpt_dir, scope=Scope(),
                   var_names=list(trainer.state),
                   state_dump=trainer.dump_state_to,
                   state_restore=trainer.load_state_from, **kw)
