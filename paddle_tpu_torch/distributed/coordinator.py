"""Pserver coordination: an elastic service registry over the native
master, and the job's process count and index.

Counterpart of paddle_tpu/distributed/coordinator.py, its pserver half.
The reference coordinates pservers through etcd: TTL-lease slot
registration with keep-alive, desired-count rendezvous, and trainer-side
re-discovery (reference: go/pserver/etcd_client.go:31-97 registration,
client/etcd_client.go discovery, go/master/etcd_client.go leader lock).
Here the native master carries an equivalent TTL-lease registry
(native/master.cc kRegister/kKeepAlive/kList), and ElasticRegistry /
ServiceLease below are the client surface: a pserver registers its
endpoint under /ps/<slot> and heartbeats; when it dies, the lease
lapses, discovery stops returning it, and a replacement can claim the
slot and restore from checkpoint.

The JAX package's dense collective half (`init_multihost`,
`global_mesh`) waits with the port's mesh (ROADMAP A9), and the fleet
reporter (`start_fleet_reporter`, `stop_fleet_reporter`) with
`obs/fleet.py` (A10): each raises NotImplementedError naming its item.

Fault points (resilience/faults.py, io_error): coordinator/register,
coordinator/discover, coordinator/heartbeat.  The JAX side's
`lease_expiry` drill waits with the port's other fault kinds (A10).

Env protocol (set by tools/cluster_launch.py or any scheduler):
    PADDLE_MASTER          host:port of the registry's master
    PADDLE_PSERVER_COUNT   the pservers a trainer waits for
"""

import os
import threading
import time

import torch

from .. import native
from ..obs import registry as registry_mod
from ..resilience import faults as faults_mod
from ..resilience.retry import RetryPolicy

# keep-alive RPC latency buckets: sub-ms loopback beats up to the
# multi-second stalls that lapse a lease
HEARTBEAT_SECONDS_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01,
                             0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                             5.0)


def _heartbeat_hist():
    return registry_mod.get_registry().histogram(
        "coordinator_heartbeat_seconds", HEARTBEAT_SECONDS_BUCKETS,
        "lease keep-alive RPC latency (per attempt, including "
        "injected faults)")


def _heartbeat_failures():
    return registry_mod.get_registry().counter(
        "coordinator_heartbeat_failures_total",
        "keep-alive attempts that raised (retried within the beat "
        "budget before the lease lapses)")


__all__ = ["init_multihost", "global_mesh", "process_count",
           "process_index", "ElasticRegistry", "ServiceLease",
           "discover_pservers", "start_fleet_reporter",
           "stop_fleet_reporter"]


def discover_pservers(count=None, timeout=60.0, master=None):
    """Trainer-side pserver discovery through the registry (reference:
    go/pserver/client/etcd_client.go — trainers watch etcd for the
    pserver set).  Reads PADDLE_MASTER (host:port) and
    PADDLE_PSERVER_COUNT when args are omitted; returns endpoints
    ordered by slot after the desired-count rendezvous."""
    master = master or os.environ["PADDLE_MASTER"]
    if count is None:
        count = int(os.environ["PADDLE_PSERVER_COUNT"])
    host, port = master.rsplit(":", 1)
    reg = ElasticRegistry(host, int(port))
    try:
        return reg.wait_for_pservers(count, timeout=timeout)
    finally:
        reg.close()


def _waiting(name, item, what):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            "distributed.%s needs %s, which the port does not have yet "
            "(ROADMAP %s)" % (name, what, item))

    fn.__name__ = name
    return fn


init_multihost = _waiting("init_multihost", "A9",
                          "the multi-GPU runtime and its mesh")
global_mesh = _waiting("global_mesh", "A9", "the port's device mesh")
start_fleet_reporter = _waiting("start_fleet_reporter", "A10",
                                "obs/fleet.py")
stop_fleet_reporter = _waiting("stop_fleet_reporter", "A10",
                               "obs/fleet.py")


def process_count():
    """The job's processes: torch.distributed's world size once a
    process group is up, else 1 (as jax.process_count() is before
    jax.distributed.initialize)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index():
    """This process's rank in the job (0 without a process group)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class ServiceLease:
    """A held registration: renews its TTL lease on a daemon thread
    until released (the reference pserver's etcd keep-alive loop,
    go/pserver/etcd_client.go).  `lapsed` flips if a renewal finds the
    lease expired (e.g. the process stalled past the TTL) — the holder
    must re-register.

    `client` must be a connection DEDICATED to this lease: the
    heartbeat runs on its own thread and the framed transport is not
    thread-safe."""

    def __init__(self, client, lease_id, ttl_ms, retry=None,
                 reconnect=None):
        self._client = client
        self._lease = lease_id
        self._ttl_ms = ttl_ms
        # `reconnect` (zero-arg -> fresh dedicated client): the native
        # transport never recovers a failed fd, so a retried beat MUST
        # run on a new connection or the retry is dead weight
        self._reconnect = reconnect
        # transient connection blips within ONE beat retry quickly
        # instead of dropping the slot; the whole retry budget, slow
        # attempts included, stays under one beat interval, so a
        # genuinely dead master still lapses the lease before the TTL
        # reclaims it.  Renew at 1/3 TTL so one missed beat doesn't
        # drop the slot.
        self._beat_interval = max(0.01, ttl_ms / 3000.0)
        self._retry = retry or RetryPolicy(
            max_attempts=3, base_delay=0.01,
            max_delay=self._beat_interval / 4,
            deadline=self._beat_interval * 0.9,
            retryable=(ConnectionError, OSError),
            name="lease_heartbeat")
        self.lapsed = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._beat, daemon=True)
        self._thread.start()

    def _one_beat(self):
        # timed per ATTEMPT (fault sleeps included): the histogram is
        # how an operator sees a master getting slow BEFORE leases
        # start lapsing — renewals run at 1/3 TTL, so p99 creeping
        # toward the beat interval is the early warning
        t0 = time.perf_counter()
        try:
            faults_mod.check("coordinator/heartbeat")
            alive = self._client.keep_alive(self._lease)
        except (ConnectionError, OSError):
            _heartbeat_failures().inc()
            _heartbeat_hist().observe(time.perf_counter() - t0)
            if self._reconnect is not None:
                try:
                    self._client.close()
                except Exception:
                    pass
                self._client = self._reconnect()
            raise
        _heartbeat_hist().observe(time.perf_counter() - t0)
        return alive

    def _beat(self):
        while not self._stop.wait(self._beat_interval):
            try:
                if not self._retry.call(self._one_beat):
                    self.lapsed = True
                    return
            except (ConnectionError, OSError):
                self.lapsed = True
                return

    def release(self):
        self._stop.set()
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            # heartbeat wedged inside a blocking call: the transport is
            # not thread-safe, so leak the connection rather than race
            # an in-flight keep_alive; the TTL reclaims the slot
            return
        try:
            self._client.unregister(self._lease)
        except ConnectionError:
            pass
        self._client.close()


class ElasticRegistry:
    """Service registration/discovery over the native master's
    TTL-lease store — the etcd-equivalent for pserver elasticity."""

    PS_PREFIX = "/ps/"

    def __init__(self, host, port, retry=None):
        self._host, self._port = host, port
        # registry RPCs retry transient connection failures (master
        # restarting, dropped frames) before surfacing them
        self._retry = retry or RetryPolicy(
            max_attempts=3, base_delay=0.05, max_delay=0.5)
        self._client = native.MasterClient(host, port)

    # -- registration ---------------------------------------------------
    def _register_rpc(self, key, value, ttl_ms):
        """One register attempt over a FRESH dedicated connection (a
        retried attempt must not reuse a connection whose framing died
        mid-RPC).  NOTE a retry after a lost reply can find the key
        held by our own orphaned lease — the TTL reclaims it within
        one `ttl_ms`, exactly like the reference's etcd CAS loop."""
        faults_mod.check("coordinator/register", key=key)
        client = native.MasterClient(self._host, self._port)
        try:
            lease = client.register(key, value, ttl_ms)
        except BaseException:
            client.close()
            raise
        if lease is None:
            client.close()
            return None
        return client, lease

    def register(self, key, value, ttl_ms=2000):
        """Claim `key`; returns a ServiceLease, or None if a live lease
        holds the key.  The lease heartbeats over its own dedicated
        connection (the framed transport is not thread-safe)."""
        got = self._retry.call(self._register_rpc, key, value, ttl_ms)
        if got is None:
            return None
        client, lease = got

        def fresh_client():
            return native.MasterClient(self._host, self._port)

        return ServiceLease(client, lease, ttl_ms,
                            reconnect=fresh_client)

    def register_pserver(self, endpoint, desired_count, ttl_ms=2000,
                         timeout=30.0):
        """Claim the first free pserver slot /ps/0../ps/N-1 (the
        reference's index-slot CAS loop, etcd_client.go:57-83),
        retrying until a slot frees up or `timeout` lapses.
        Returns (slot, ServiceLease)."""
        deadline = time.time() + timeout
        while True:
            for slot in range(desired_count):
                lease = self.register("%s%d" % (self.PS_PREFIX, slot),
                                      endpoint, ttl_ms=ttl_ms)
                if lease is not None:
                    return slot, lease
            if time.time() >= deadline:
                raise TimeoutError(
                    "no free pserver slot of %d within %.1fs"
                    % (desired_count, timeout))
            time.sleep(min(0.05, ttl_ms / 1000.0))

    # -- discovery ------------------------------------------------------
    def _list_rpc(self, prefix):
        faults_mod.check("coordinator/discover")
        try:
            return self._client.list_prefix(prefix)
        except (ConnectionError, OSError):
            # the native transport never recovers a failed fd: swap in
            # a fresh connection so the NEXT retry attempt can succeed
            try:
                self._client.close()
            except Exception:
                pass
            self._client = native.MasterClient(self._host, self._port)
            raise

    def list(self, prefix):
        """{key: value} of unexpired leases under any `prefix`, with the
        same retry and `coordinator/discover` fault point as pserver
        discovery."""
        return self._retry.call(self._list_rpc, prefix)

    def pservers(self):
        """{slot: endpoint} of live pservers."""
        entries = self.list(self.PS_PREFIX)
        return {int(k[len(self.PS_PREFIX):]): v
                for k, v in entries.items()}

    def wait_for_pservers(self, count, timeout=60.0):
        """Desired-count rendezvous: block until `count` live pservers
        are registered (reference: etcd_client.go desired-count wait);
        returns endpoints ordered by slot."""
        deadline = time.time() + timeout
        while True:
            live = self.pservers()
            if len(live) >= count:
                return [live[s] for s in sorted(live)]
            if time.time() >= deadline:
                raise TimeoutError(
                    "only %d of %d pservers registered within %.1fs"
                    % (len(live), count, timeout))
            time.sleep(0.05)

    def close(self):
        self._client.close()
