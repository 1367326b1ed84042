"""Elastic data-parallel training that survives host loss and rejoin.

Counterpart of paddle_tpu/resilience/elastic.py.  Production fleets
treat host churn as steady state: a preemptible pool reclaims a machine
mid-step, a heartbeat lease lapses, a replacement registers minutes
later.  This module is the contract for the SPMD trainer — losing a
host SHRINKS dp and training continues, a rejoining host GROWS it back.

Two layers:

* `ElasticMembership` — the JAX package's generation-numbered
  cluster-view protocol over the native master's TTL-lease store (the
  registry `distributed.coordinator.ElasticRegistry` already speaks),
  key for key.  Every worker holds a member lease under
  ``/elastic/member/<host>``; the LEADER (the lexicographically first
  live member) notices membership drift and runs a two-phase view
  change:

      propose   /elastic/view/<gen>     (under the leader's lease)
      ack       /elastic/ack/<gen>/<host>   one per proposed member
      commit    /elastic/commit/<gen>   only when every member acked

  Generations are monotonic, and a slow-but-alive host cannot be
  shrunk away: it only leaves the live set when its lease ACTUALLY
  expires at the master (no survivor-side timeout guesses, hence no
  split-brain shrink).  Every wait (`join`, `wait_for`) has a deadline.

* `ElasticTrainer` — rebinds an `SpmdTrainer` to each committed view:
  snapshot the current state (stamped with the OLD generation), build
  the new mesh at the new dp, re-derive the partition plan, restore the
  newest consistent sharded checkpoint across all hosts' roots —
  shard-exact when the layout held, through the densify path when dp
  changed — and continue.  `trainer.elastic_generation` guards
  restores: a stale host that missed a view change gets
  `StaleGenerationError`, never an old layout resurrected silently.

  A mesh here lies over the ranks of a process group, one rank per
  device, so the JAX trainer's two modes become:

  * local (`local=True`, one process per worker): the mesh spans this
    process's own group (a world of one when none is up) at every view;
    the view drives the per-host feed split and checkpoint identity,
    and restores stay shard-exact (`densified == []`).  Two workers may
    share one card this way.
  * global (`local=False`, one program over `devices_per_host` ranks
    per host): every rank of the group builds a mesh over the first
    `devices_per_host * len(view.hosts)` ranks, so a shrink REALLY
    rebuilds dp smaller and the restore densifies dp-sharded (zero1)
    state.  A collective hangs unless every rank adopts the same view
    at the same step, so rank 0 alone polls the membership and
    broadcasts what it read (the view and the snapshot directory) over
    the default group on every turn; the protocol in the master stays
    the JAX one.  Ranks outside the new mesh make every call (the mesh,
    the trainer, the snapshots) but take no part in its steps: their
    `step` returns None.

Fault points `elastic/propose` and `elastic/commit` plus the
coordinator's `lease_expiry` heartbeat kind make the whole path
chaos-drillable (`elastic_cli --selftest`); every committed transition
publishes `elastic_generation`, `elastic_resizes_total{direction,
reason}`, `elastic_lost_hosts_total` and a flight-recorder note.
"""

import json
import os
import signal as signal_mod
import threading
import time

import numpy as np

from ..obs import registry as registry_mod
from ..obs import trace as trace_mod
from . import faults as faults_mod

__all__ = ["ClusterView", "ElasticMembership", "ElasticTrainer",
           "run_elastic_worker", "latest_elastic_checkpoint",
           "feed_slice", "MEMBER_PREFIX", "VIEW_PREFIX", "ACK_PREFIX",
           "COMMIT_PREFIX"]

MEMBER_PREFIX = "/elastic/member/"
VIEW_PREFIX = "/elastic/view/"
ACK_PREFIX = "/elastic/ack/"
COMMIT_PREFIX = "/elastic/commit/"


def _reg():
    return registry_mod.get_registry()


class ClusterView:
    """One committed (or proposed) cluster membership: a monotonic
    generation id plus the sorted host set it covers.  Serialized as
    single-line JSON — the master store's list buffer is
    newline-delimited, so a value must never contain one."""

    def __init__(self, gen, hosts, reason="bootstrap", proposer=None):
        self.gen = int(gen)
        self.hosts = sorted(str(h) for h in hosts)
        self.reason = str(reason)
        self.proposer = proposer

    def to_json(self):
        return json.dumps(
            {"gen": self.gen, "hosts": self.hosts,
             "reason": self.reason, "proposer": self.proposer},
            separators=(",", ":"), sort_keys=True)

    @classmethod
    def from_json(cls, blob):
        d = json.loads(blob)
        return cls(d["gen"], d.get("hosts", ()),
                   reason=d.get("reason", "unknown"),
                   proposer=d.get("proposer"))

    def __eq__(self, other):
        return (isinstance(other, ClusterView)
                and self.gen == other.gen
                and self.hosts == other.hosts)

    def __repr__(self):
        return ("ClusterView(gen=%d, hosts=%r, reason=%r)"
                % (self.gen, self.hosts, self.reason))


class ElasticMembership:
    """One host's handle on the elastic cluster-view protocol.

    Symmetric-peer design: there is no membership server beyond the
    TTL-lease store.  Every member runs the same `poll()` turn —
    adopt any newer committed view, ack any pending proposal that
    includes this host, and (when this host is the leader: the first
    live member in sort order) propose on membership drift and commit
    once every proposed member has acked.  Proposal/commit keys live
    under the proposer's leases; if the proposer dies mid-protocol the
    keys lapse with it and the next leader re-proposes at a strictly
    higher generation.

    `master` is ``"host:port"`` of the native master, or an existing
    `ElasticRegistry` via the `registry` kwarg (ownership stays with
    the caller then)."""

    def __init__(self, master=None, host=None, ttl_ms=2000,
                 registry=None):
        from ..obs import fleet as fleet_mod

        self.host = str(host) if host else fleet_mod.host_id()
        self.ttl_ms = int(ttl_ms)
        if registry is not None:
            self._registry, self._own_registry = registry, False
        else:
            from ..distributed.coordinator import ElasticRegistry

            mhost, mport = str(master).rsplit(":", 1)
            self._registry = ElasticRegistry(mhost, int(mport))
            self._own_registry = True
        self.view = ClusterView(0, (), reason="init")
        self._member_lease = None
        self._held = []    # proposer-side view/commit leases
        self._acks = {}    # gen -> this host's ack lease

    # -- membership -----------------------------------------------------
    @property
    def alive(self):
        lease = self._member_lease
        return lease is not None and not lease.lapsed

    def join(self, timeout=15.0):
        """Claim ``/elastic/member/<host>``.  A rejoin after our own
        lease lapsed may find the orphan still unexpired — keep
        retrying within `timeout` (one TTL reclaims it).  Returns
        self."""
        deadline = time.time() + float(timeout)
        value = json.dumps({"host": self.host, "t": round(time.time())},
                           separators=(",", ":"))
        while True:
            lease = self._registry.register(
                MEMBER_PREFIX + self.host, value, ttl_ms=self.ttl_ms)
            if lease is not None:
                self._member_lease = lease
                trace_mod.instant("elastic_join", cat="elastic",
                                  host=self.host)
                return self
            if time.time() >= deadline:
                raise TimeoutError(
                    "member key %r still leased after %.1fs (another "
                    "process with this host id?)"
                    % (MEMBER_PREFIX + self.host, float(timeout)))
            time.sleep(min(0.05, self.ttl_ms / 4000.0))

    def leave(self):
        """Release the member lease (discovery drops us immediately —
        the graceful-shutdown path, no TTL wait) and every protocol
        lease this host holds."""
        lease, self._member_lease = self._member_lease, None
        if lease is not None:
            lease.release()
        for held in self._held:
            held.release()
        self._held = []
        for ack in self._acks.values():
            ack.release()
        self._acks = {}

    def members(self):
        """Sorted live member hosts — exactly the unexpired leases the
        master still holds.  Nothing here guesses at liveness: a slow
        host stays a member until its lease truly lapses."""
        entries = self._registry.list(MEMBER_PREFIX)
        return sorted(k[len(MEMBER_PREFIX):] for k in entries)

    # -- protocol reads -------------------------------------------------
    def _read_views(self, prefix):
        out = {}
        for k, v in self._registry.list(prefix).items():
            try:
                gen = int(k[len(prefix):])
                out[gen] = ClusterView.from_json(v)
            except (ValueError, KeyError):
                continue  # torn/foreign key: not ours to interpret
        return out

    def _read_acks(self, gen):
        prefix = "%s%d/" % (ACK_PREFIX, int(gen))
        return {k[len(prefix):] for k in self._registry.list(prefix)}

    # -- the protocol turn ----------------------------------------------
    def poll(self):
        """One protocol turn; returns the current committed view.

        Injected faults at `coordinator/discover`, `elastic/propose`
        and `elastic/commit` surface as IOError from here — callers
        treat a failed turn as transient and re-poll, exactly like a
        flaky master RPC."""
        if self._member_lease is not None and self._member_lease.lapsed:
            # the cluster is entitled to presume us dead; we must
            # re-register before we count as live again
            self._member_lease = None
        commits = self._read_views(COMMIT_PREFIX)
        newer = [g for g in commits if g > self.view.gen]
        if newer:
            self._adopt(commits[max(newer)])
            return self.view
        proposals = {g: v for g, v
                     in self._read_views(VIEW_PREFIX).items()
                     if g > self.view.gen}
        for gen in sorted(proposals):
            if (self.host in proposals[gen].hosts
                    and gen not in self._acks):
                self._ack(gen)
        live = self.members()
        if live and live[0] == self.host and self.alive:
            self._lead(live, proposals, commits)
        return self.view

    def _ack(self, gen):
        lease = self._registry.register(
            "%s%d/%s" % (ACK_PREFIX, int(gen), self.host),
            json.dumps({"host": self.host}, separators=(",", ":")),
            ttl_ms=self.ttl_ms)
        if lease is not None:
            self._acks[gen] = lease

    def _lead(self, live, proposals, commits):
        """Leader duties: supersede a drifted proposal, commit a fully
        acked one, or propose when the live set left the view."""
        if proposals:
            gen = max(proposals)
            view = proposals[gen]
            if view.hosts != live:
                # membership drifted under the in-flight proposal (the
                # proposed host died before acking, or another joined):
                # supersede it at a higher generation
                self._propose(live, commits)
                return
            if set(view.hosts) <= self._read_acks(gen):
                self._commit(gen, view)
        elif live != self.view.hosts:
            self._propose(live, commits)

    def _drift_reason(self, live):
        if self.view.gen == 0:
            return "bootstrap"
        old = set(self.view.hosts)
        new = set(live)
        if new < old:
            return "host_lost"
        if old < new:
            return "rejoin"
        return "membership_change"

    def _propose(self, live, commits):
        faults_mod.check("elastic/propose", host=self.host)
        known = ({self.view.gen} | set(commits)
                 | set(self._read_views(VIEW_PREFIX)))
        gen = max(known) + 1
        view = ClusterView(gen, live, reason=self._drift_reason(live),
                           proposer=self.host)
        lease = self._registry.register(VIEW_PREFIX + str(gen),
                                        view.to_json(),
                                        ttl_ms=self.ttl_ms)
        if lease is None:
            return None  # raced another proposer; next poll re-reads
        self._held.append(lease)
        trace_mod.instant("elastic_propose", cat="elastic", gen=gen,
                          hosts=",".join(view.hosts),
                          reason=view.reason)
        return view

    def _commit(self, gen, view):
        faults_mod.check("elastic/commit", host=self.host)
        lease = self._registry.register(COMMIT_PREFIX + str(int(gen)),
                                        view.to_json(),
                                        ttl_ms=self.ttl_ms)
        if lease is not None:
            self._held.append(lease)
        # the leader adopts in the same turn; followers see the commit
        # key on their next poll
        self._adopt(view)

    def _adopt(self, view):
        old, self.view = self.view, view
        # ack leases for superseded generations are dead weight
        for gen in [g for g in self._acks if g <= view.gen]:
            self._acks.pop(gen).release()
        reg = _reg()
        reg.gauge("elastic_generation",
                  "generation id of the committed elastic cluster "
                  "view").set(view.gen)
        lost = set(old.hosts) - set(view.hosts)
        if lost:
            reg.counter("elastic_lost_hosts_total",
                        "hosts removed from the committed elastic "
                        "view").inc(len(lost))
        if old.hosts:  # bootstrap (empty -> first view) is not a resize
            direction = ("shrink" if len(view.hosts) < len(old.hosts)
                         else "grow" if len(view.hosts) > len(old.hosts)
                         else "reshape")
            reg.counter("elastic_resizes_total",
                        "committed elastic view changes, by direction "
                        "and reason",
                        labelnames=("direction", "reason")) \
                .labels(direction=direction, reason=view.reason).inc()
        trace_mod.instant("elastic_adopt", cat="elastic", gen=view.gen,
                          hosts=",".join(view.hosts),
                          reason=view.reason, lost=len(lost))
        from ..obs import flight as flight_mod

        rec = flight_mod.get_recorder()
        if rec is not None:
            rec.note("elastic", gen=view.gen, hosts=list(view.hosts),
                     reason=view.reason, lost=sorted(lost))

    def wait_for(self, n_hosts=None, gen=None, timeout=30.0,
                 poll_interval=0.05):
        """Poll until a committed view satisfies the predicate —
        `n_hosts` members and/or generation >= `gen` (either alone is
        fine; at least one committed view is always required)."""
        deadline = time.time() + float(timeout)
        while True:
            try:
                view = self.poll()
            except (IOError, OSError):
                view = self.view  # transient registry fault: re-poll
            if view.gen > 0 \
                    and (n_hosts is None or len(view.hosts) == n_hosts) \
                    and (gen is None or view.gen >= gen):
                return view
            if time.time() >= deadline:
                raise TimeoutError(
                    "no committed view with n_hosts=%r gen>=%r within "
                    "%.1fs (current: %r)" % (n_hosts, gen,
                                             float(timeout), self.view))
            time.sleep(poll_interval)

    def close(self):
        self.leave()
        if self._own_registry:
            self._registry.close()


# ---------------------------------------------------------------------------
# checkpoints across hosts
# ---------------------------------------------------------------------------

def latest_elastic_checkpoint(root):
    """Newest consistent sharded snapshot under `root`, looking BOTH at
    `root` itself and at every per-host subdir (`root/<host>/...`) —
    ordered by (generation, step, manifest time), so a rejoining host
    restores the survivors' post-shrink snapshot, never its own stale
    one.  Returns the snapshot path or None."""
    from ..spmd.checkpoint import (SPMD_MANIFEST,
                                   latest_sharded_checkpoint)

    root = str(root)
    if not os.path.isdir(root):
        return None
    candidates = [latest_sharded_checkpoint(root)]
    for name in sorted(os.listdir(root)):
        sub = os.path.join(root, name)
        if os.path.isdir(sub):
            candidates.append(latest_sharded_checkpoint(sub))
    best = None
    for snap in candidates:
        if snap is None:
            continue
        try:
            with open(os.path.join(snap, SPMD_MANIFEST)) as f:
                man = json.load(f)
        except (IOError, OSError, ValueError):
            continue
        key = (int(man.get("generation", 0)), int(man.get("step", 0)),
               float(man.get("time", 0.0)))
        if best is None or key > best[0]:
            best = (key, snap)
    return best[1] if best else None


def feed_slice(host, hosts, global_batch):
    """Deterministic [start, stop) share of the global batch for
    `host`: contiguous by rank in the SORTED view, remainder rows to
    the first hosts — every member computes the same split from the
    committed view alone, no extra coordination."""
    hosts = sorted(hosts)
    rank = hosts.index(host)
    base, rem = divmod(int(global_batch), len(hosts))
    start = rank * base + min(rank, rem)
    return start, start + base + (1 if rank < rem else 0)


# ---------------------------------------------------------------------------
# the elastic trainer
# ---------------------------------------------------------------------------

def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


class ElasticTrainer:
    """An `SpmdTrainer` rebound to every committed cluster view.

    build_fn() -> (main_program, startup_program, feed_names,
    fetch_names); it MUST produce identical var names on every call
    (`fluid.framework.reset_unique_name()` first) — the rebuilt
    trainer's state dict has to line up with the checkpointed one.

    local=True: the mesh spans this process's group at every view (see
    the module docstring); local=False: `devices_per_host` ranks of the
    group per host of the view, rank 0's `membership` the one polled
    (the other ranks may pass None).  `device` is the ranks' device:
    "cuda" (the default) or "cpu".
    """

    def __init__(self, membership, build_fn, ckpt_root,
                 devices_per_host=1, local=False, rules=None,
                 zero_stage=0, trainer_kw=None, device="cuda"):
        self.membership = membership
        self.build_fn = build_fn
        self.ckpt_root = str(ckpt_root)
        self.devices_per_host = int(devices_per_host)
        self.local = bool(local)
        self.rules = rules
        self.zero_stage = int(zero_stage)
        self.trainer_kw = dict(trainer_kw or {})
        self.device = device
        self.trainer = None
        self.view = None
        self.last_resize = None
        self.restored_step = 0
        # global mode: the snapshot dir every rank writes into (rank
        # 0's host, broadcast with the view)
        self._ckpt_host = membership.host if membership is not None \
            else None

    @property
    def generation(self):
        return self.view.gen if self.view is not None else 0

    @property
    def dp(self):
        if self.trainer is None:
            return 0
        from ..parallel.mesh import mesh_shape

        return int(mesh_shape(self.trainer.mesh).get("dp", 1))

    @property
    def in_mesh(self):
        """Whether this rank is on the bound trainer's mesh."""
        return self.trainer is not None \
            and self.trainer.mesh.get_coordinate() is not None

    def _lockstep(self):
        """Global mode over a group of more than one rank: every turn
        is rank 0's reading, broadcast."""
        dist = _dist()
        return (not self.local and dist is not None
                and dist.get_world_size() > 1)

    def _broadcast(self, payload):
        """Rank 0's `payload` on every rank (the default group)."""
        dist = _dist()
        box = [payload if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def _ckpt_dir(self):
        # per-host subdir: concurrent hosts never collide on one
        # snapshot dir, and latest_elastic_checkpoint scans across
        return os.path.join(self.ckpt_root, self._ckpt_host)

    def save(self, step):
        """Blocking sharded snapshot stamped with the CURRENT
        generation (a post-resize restore accepts it: old <= new).
        Every rank of the group calls it in global mode."""
        if self.trainer is None:
            return None
        return self.trainer.save_checkpoint(self._ckpt_dir(), step)

    def wait_until_ready(self, n_hosts=None, timeout=30.0):
        """Block until a view containing `n_hosts` members commits,
        then bind the trainer to it.  Returns the view."""
        if self._lockstep():
            err = None
            if _dist().get_rank() == 0:
                try:
                    self.membership.wait_for(n_hosts=n_hosts,
                                             timeout=timeout)
                except TimeoutError as e:
                    err = str(e)
            err = self._broadcast(err)
            if err is not None:
                raise TimeoutError(err)
        else:
            self.membership.wait_for(n_hosts=n_hosts, timeout=timeout)
        self.maybe_resize()
        return self.view

    def _poll(self):
        """The committed view this turn (None on a transient registry
        fault), the same on every rank."""
        if not self._lockstep():
            try:
                return self.membership.poll()
            except (IOError, OSError):
                return None
        payload = None
        if _dist().get_rank() == 0:
            try:
                payload = (self.membership.poll().to_json(),
                           self.membership.host)
            except (IOError, OSError):
                payload = None
        payload = self._broadcast(payload)
        if payload is None:
            return None
        self._ckpt_host = payload[1]
        return ClusterView.from_json(payload[0])

    def maybe_resize(self, save_step=None):
        """One elasticity turn: poll the membership protocol and, on a
        newer committed view, snapshot the current state (old
        generation), rebuild mesh/plan/trainer at the new dp, and
        restore the newest consistent checkpoint — densified only when
        the layout actually changed.  Returns a resize info dict, or
        None when the view held."""
        view = self._poll()
        if view is None:
            return None  # transient registry fault: next turn retries
        if view.gen == 0 or (self.view is not None
                             and view.gen <= self.view.gen):
            return None
        old = self.view
        if self.trainer is not None and save_step is not None:
            self.save(save_step)
        info = self._rebuild(view)
        direction = ("bootstrap" if old is None
                     else "shrink" if len(view.hosts) < len(old.hosts)
                     else "grow" if len(view.hosts) > len(old.hosts)
                     else "reshape")
        self.last_resize = {
            "generation": view.gen, "direction": direction,
            "reason": view.reason, "hosts": list(view.hosts),
            "dp": self.dp, "restored_step": self.restored_step,
            "densified": list(info["densified"]) if info else [],
        }
        return self.last_resize

    def _mesh(self, view):
        from ..parallel import make_mesh
        from ..parallel.mesh import ensure_world

        world = ensure_world(self.device)
        if self.local:
            if world > 1:
                raise ValueError("local mode runs one worker per process "
                                 "group; this group has %d ranks" % world)
            need = 1
        else:
            need = self.devices_per_host * len(view.hosts)
            if world < need:
                raise ValueError(
                    "view %r needs %d ranks (%d/host), have %d"
                    % (view, need, self.devices_per_host, world))
        return make_mesh(n_devices=need, dp=need,
                         devices=list(range(need)), drop_unit_axes=True,
                         device=self.device)

    def _rebuild(self, view):
        from ..spmd.checkpoint import restore_sharded
        from ..spmd.trainer import SpmdTrainer

        mesh = self._mesh(view)
        main, startup, feed_names, fetch_names = self.build_fn()
        kw = dict(self.trainer_kw)
        kw.setdefault("use_pcache", False)
        trainer = SpmdTrainer(main, startup, feed_names=feed_names,
                              fetch_names=fetch_names, mesh=mesh,
                              rules=self.rules,
                              zero_stage=self.zero_stage, **kw)
        trainer.init()
        trainer.elastic_generation = view.gen
        snap = latest_elastic_checkpoint(self.ckpt_root)
        info = None
        if snap is not None:
            state, info = restore_sharded(snap, trainer._shardings,
                                          max_generation=view.gen)
            trainer.state = state
            self.restored_step = int(info["step"])
        self.trainer = trainer
        self.view = view
        return info

    def step(self, feeds):
        """One step of the bound trainer on the global batch `feeds`;
        None on a rank outside the mesh (global mode after a shrink)."""
        if self.trainer is None:
            raise RuntimeError("no committed view bound yet — call "
                               "wait_until_ready() / maybe_resize()")
        if not self.in_mesh:
            return None
        return self.trainer.step(feeds)


# ---------------------------------------------------------------------------
# the worker mainline (elastic_cli worker)
# ---------------------------------------------------------------------------

def _loss_of(fetches):
    try:
        first = fetches[0] if isinstance(fetches, (list, tuple)) \
            else fetches
        if hasattr(first, "detach"):
            first = first.detach().cpu().numpy()
        return float(np.asarray(first).reshape(-1)[0])
    except (TypeError, ValueError, IndexError):
        return None


def run_elastic_worker(membership, build_fn, make_feeds, ckpt_root,
                       steps=20, global_batch=16, min_hosts=1,
                       save_every=5, status_path=None, step_sleep=0.0,
                       ready_timeout=60.0, local=True,
                       devices_per_host=1, zero_stage=0, rules=None,
                       device="cuda"):
    """One elastic worker's training mainline (the `elastic_cli worker`
    entry): join the membership, bind to the first committed view with
    `min_hosts` members, then loop — one elasticity turn, one training
    step on this host's deterministic `feed_slice` of the global
    batch, periodic sharded snapshots — until `steps` global steps.

    `make_feeds(step, start, stop)` must build the feed dict for rows
    [start, stop) of global step `step`, deterministically from those
    three values alone (every member derives its slice from the
    committed view — a resize re-splits the SAME global batch).

    SIGTERM is the preemption drill: the handler flips a flag, the
    loop notices it at the next step boundary, writes an urgent
    snapshot, LEAVES the membership (releasing the lease, so survivors
    shrink immediately instead of waiting out the TTL) and returns
    with ``"preempted": True``.  A worker whose heartbeat silently
    lapsed instead (the `lease_expiry` chaos kind) re-joins and is
    grown back in by the leader.

    `status_path` (when set) gets a single-line JSON status after
    every step — the chaos harness's window into a live worker.
    """
    preempted = threading.Event()

    def _on_sigterm(signum, frame):
        preempted.set()

    old_handler = None
    if threading.current_thread() is threading.main_thread():
        old_handler = signal_mod.signal(signal_mod.SIGTERM, _on_sigterm)

    def _status(**extra):
        if status_path is None:
            return
        blob = {"host": membership.host, "generation": et.generation,
                "step": step, "dp": et.dp,
                "n_hosts": len(et.view.hosts) if et.view else 0,
                "losses": losses[-5:], "resizes": resizes,
                "time": round(time.time(), 3)}
        blob.update(extra)
        tmp = status_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(blob, f)
        os.replace(tmp, status_path)

    et = ElasticTrainer(membership, build_fn, ckpt_root, local=local,
                        devices_per_host=devices_per_host,
                        zero_stage=zero_stage, rules=rules,
                        device=device)
    losses, resizes = [], []
    step = 0
    try:
        if not membership.alive:
            membership.join()
        et.wait_until_ready(n_hosts=min_hosts, timeout=ready_timeout)
        step = et.restored_step
        while step < int(steps):
            # the chaos harness's kill switch: a planned preempt here
            # delivers a REAL SIGTERM to this process mid-run
            faults_mod.check("elastic/step", step=step)
            if preempted.is_set():
                et.save(step)
                membership.leave()
                _status(preempted=True, done=False)
                return {"host": membership.host, "steps": step,
                        "generation": et.generation, "losses": losses,
                        "resizes": resizes, "preempted": True}
            if not membership.alive:
                # our lease lapsed (the fleet presumed us dead): the
                # rejoin path — register again, the leader grows the
                # view back and the next resize turn rebinds us
                membership.join()
            resize = et.maybe_resize(save_step=step)
            if resize is not None:
                resizes.append(resize)
                step = max(step, et.restored_step)
                if step >= int(steps):
                    break
            start, stop = feed_slice(membership.host, et.view.hosts,
                                     global_batch)
            loss = _loss_of(et.step(make_feeds(step, start, stop)))
            losses.append(loss)
            step += 1
            if save_every and step % int(save_every) == 0:
                et.save(step)
            _status(done=False)
            if step_sleep:
                time.sleep(step_sleep)
        et.save(step)
        _status(done=True)
        return {"host": membership.host, "steps": step,
                "generation": et.generation, "losses": losses,
                "resizes": resizes, "preempted": False}
    finally:
        if old_handler is not None:
            try:
                signal_mod.signal(signal_mod.SIGTERM, old_handler)
            except (ValueError, TypeError):
                pass
