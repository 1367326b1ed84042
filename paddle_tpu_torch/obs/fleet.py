"""Fleet-wide metric aggregation: per-host registry snapshots merged
into one view, with step-time straggler detection.

Counterpart of paddle_tpu/obs/fleet.py.  A multi-host job's medians hide
the one host that drags the whole synchronous step.  This module closes
that gap over the coordination channel that already exists — the native
master's TTL-lease registry (`distributed/coordinator.py`):

  * `FleetReporter` — a worker-side daemon thread that periodically
    publishes this process's `telemetry.snapshot()` (flat
    {metric{labels}: value}) as JSON under `/obs/<host>` in the
    master's lease store.  Each push re-registers the key, so the TTL
    doubles as staleness: a dead worker's snapshot expires instead of
    lying forever.  With `span_window` > 0 it also pushes the process's
    recent trace events (`obs.comm.span_window_payload`) under
    `/obsspan/<host>`.
  * `FleetAggregator` — pulls every `/obs/*` snapshot (or `ingest()`s
    them directly), relabels each sample with `host=`, and computes
    per-host mean step time off the standard
    `trainer_step_seconds{trainer=}` histogram sums.  `stragglers()`
    flags hosts whose step time exceeds `straggler_factor` × the
    fleet median and publishes `fleet_straggler{host=}` /
    `fleet_host_step_ms{host=}` / `fleet_snapshot_age_seconds{host=}` /
    `fleet_hosts` gauges into the default registry, so one scrape of ANY
    aggregating process answers "which host is dragging the job".

`python -m paddle_tpu_torch.tools.fleet_cli --aggregate --master
host:port` prints the merged view (tools/cluster_launch.py surfaces it
after an elastic run); `--push` is the worker entry point.  Payloads
and keys are the JAX package's, so either package's aggregator reads
either package's reporters.
"""

import argparse
import json
import os
import socket
import sys
import threading
import time

from . import registry as registry_mod
from . import telemetry as telemetry_mod

__all__ = ["OBS_PREFIX", "host_id", "snapshot_payload", "FleetReporter",
           "FleetAggregator", "DEFAULT_STRAGGLER_FACTOR", "main"]

OBS_PREFIX = "/obs/"
DEFAULT_STRAGGLER_FACTOR = 1.5

# default metric-name prefixes a reporter pushes.  The aggregation
# pull path reads ALL /obs/* values through the native client's fixed
# 1MB list buffer, so per-host payloads must stay small at fleet
# scale: the default keeps the step/throughput/serving signals the
# aggregator consumes (a few KB) and drops the long tail (per-bucket
# histogram families, per-segment xla_* gauges).  Pass prefixes=None
# to push everything (single-host debugging).
DEFAULT_PUSH_PREFIXES = (
    "trainer_", "executor_runs_total", "executor_jit_traces_total",
    "executor_transfer_bytes_total", "serving_requests_total",
    "serving_responses_total", "serving_errors_total",
    "serving_total_seconds", "slo_burn_rate",
    "coordinator_heartbeat_", "supervisor_restarts_total",
    "numerics_nonfinite_total", "fleet_snapshots_", "elastic_")

# env var a launcher sets to have workers report (cluster_launch.py
# elastic mode exports it; coordinator.init_multihost honors it)
MASTER_ENV = "PADDLE_OBS_MASTER"
HOST_ENV = "PADDLE_FLEET_HOST"


def host_id():
    """Stable-ish identity for this worker's snapshots: the launcher's
    PADDLE_FLEET_HOST, else rank (PADDLE_PROCESS_ID / TRAINER_ID),
    else hostname-pid."""
    explicit = os.environ.get(HOST_ENV)
    if explicit:
        return explicit
    for var in ("PADDLE_PROCESS_ID", "TRAINER_ID"):
        rank = os.environ.get(var)
        if rank is not None:
            return "host%s" % rank
    return "%s-%d" % (socket.gethostname(), os.getpid())


def snapshot_payload(host=None, prefixes=None):
    """This process's registry as one JSON-able push: flat
    `telemetry.snapshot()` samples (optionally filtered to metric-name
    `prefixes` to bound the payload) plus identity + wall clock."""
    metrics = telemetry_mod.snapshot()
    if prefixes:
        prefixes = tuple(prefixes)
        metrics = {k: v for k, v in metrics.items()
                   if k.startswith(prefixes)}
    return {"host": host or host_id(), "ts": round(time.time(), 3),
            "metrics": metrics}


class FleetReporter:
    """Worker-side snapshot pusher over the master TTL-lease store.

    Every `interval_s` the reporter re-registers `/obs/<host>` with a
    fresh snapshot (the lease value is immutable, so an update IS
    unregister + register on a fresh dedicated connection — the framed
    transport is not thread-safe, and a connection per push keeps the
    daemon thread off everyone else's sockets).  The TTL is a multiple
    of the interval so one missed push doesn't expire the snapshot but
    a dead worker's does.

    `prefixes` bounds the pushed payload (DEFAULT_PUSH_PREFIXES keeps
    it a few KB per host — the pull path's list buffer is finite);
    prefixes=None pushes the full registry.

    `span_window` > 0 additionally publishes this process's recent
    trace events (`obs.comm.span_window_payload`, bounded to that
    many events) under `/obsspan/<host>` on every push, so
    `pcomm merge` can stitch a fleet-wide comm timeline without any
    extra worker-side daemon."""

    def __init__(self, master, host=None, interval_s=2.0,
                 prefixes=DEFAULT_PUSH_PREFIXES, ttl_factor=3,
                 span_window=0):
        mhost, mport = str(master).rsplit(":", 1)
        self._master = (mhost, int(mport))
        self.host = host or host_id()
        self.interval_s = float(interval_s)
        self.prefixes = prefixes
        self.span_window = int(span_window)
        self.ttl_ms = max(1000, int(self.interval_s * 1000 * ttl_factor))
        self._lease = None
        self._span_lease = None
        self._stop = threading.Event()
        self._thread = None
        reg = registry_mod.get_registry()
        self._pushed = reg.counter(
            "fleet_snapshots_pushed_total",
            "registry snapshots this worker published to the fleet "
            "store")
        self._push_errors = reg.counter(
            "fleet_snapshot_push_errors_total",
            "snapshot pushes that failed (master unreachable / key "
            "held)")

    def push_once(self):
        """One push: unregister the previous lease, register the fresh
        snapshot.  Returns True on success."""
        from .. import native

        payload = json.dumps(snapshot_payload(host=self.host,
                                              prefixes=self.prefixes),
                             sort_keys=True)
        try:
            client = native.MasterClient(*self._master)
        except (ConnectionError, OSError):
            self._push_errors.inc()
            return False
        try:
            if self._lease is not None:
                try:
                    client.unregister(self._lease)
                except (ConnectionError, OSError):
                    pass
                self._lease = None
            lease = client.register(OBS_PREFIX + self.host, payload,
                                    self.ttl_ms)
        except (ConnectionError, OSError):
            self._push_errors.inc()
            return False
        finally:
            client.close()
        if lease is None:
            # a foreign live lease holds our key (e.g. a restarted
            # worker racing its predecessor's TTL): skip this push,
            # the store reclaims the key within one ttl_ms
            self._push_errors.inc()
            return False
        self._lease = lease
        self._pushed.inc()
        if self.span_window > 0:
            from . import comm as comm_mod

            self._span_lease = comm_mod.push_span_window(
                "%s:%d" % self._master, host=self.host,
                limit=self.span_window, ttl_ms=self.ttl_ms,
                lease_prev=self._span_lease)
        return True

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self.push_once()

    def start(self):
        if self._thread is None:
            self.push_once()
            self._thread = threading.Thread(
                target=self._loop, name="fleet-reporter", daemon=True)
            self._thread.start()
        return self

    def stop(self, unregister=True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        leases = [l for l in (self._lease, self._span_lease)
                  if l is not None]
        if unregister and leases:
            from .. import native

            try:
                client = native.MasterClient(*self._master)
                try:
                    for lease in leases:
                        try:
                            client.unregister(lease)
                        except (ConnectionError, OSError):
                            pass
                finally:
                    client.close()
            except (ConnectionError, OSError):
                pass  # TTL reclaims them
        self._lease = None
        self._span_lease = None


class FleetAggregator:
    """Merge per-host snapshots; compute skew; flag stragglers."""

    def __init__(self, straggler_factor=DEFAULT_STRAGGLER_FACTOR):
        self.straggler_factor = float(straggler_factor)
        self._hosts = {}
        self._collected = set()   # hosts sourced from the lease store
        self._published = set()   # hosts with live per-host gauges
        self._age_published = set()  # hosts with a live age gauge
        self._lock = threading.Lock()

    # -- intake --------------------------------------------------------------
    def ingest(self, payload):
        """Accept one snapshot payload (push path / tests); newest per
        host wins."""
        host = payload.get("host")
        if not host or not isinstance(payload.get("metrics"), dict):
            raise ValueError("snapshot payload needs host + metrics")
        with self._lock:
            prev = self._hosts.get(host)
            if prev is None or payload.get("ts", 0) >= prev.get("ts", 0):
                self._hosts[host] = payload
        return host

    def collect(self, master):
        """Pull every `/obs/*` snapshot from the master's lease store
        (the pull path); returns the number ingested.  Unparsable
        values are skipped — one corrupt push must not blind the
        aggregator to the rest of the fleet.  Store-sourced hosts
        ABSENT from this listing are dropped: their lease expired
        with the worker, and the merged view must honor the 'a dead
        worker's snapshot expires instead of lying forever' contract
        (directly-ingest()ed hosts are the caller's to manage)."""
        from .. import native

        mhost, mport = str(master).rsplit(":", 1)
        client = native.MasterClient(mhost, int(mport))
        try:
            entries = client.list_prefix(OBS_PREFIX)
        finally:
            client.close()
        n = 0
        seen = set()
        for key, value in entries.items():
            try:
                payload = json.loads(value)
                if not isinstance(payload, dict):
                    continue  # truncated/corrupt push ("42", "[]")
                payload.setdefault("host", key[len(OBS_PREFIX):])
                seen.add(self.ingest(payload))
                n += 1
            except (ValueError, TypeError):
                continue
        with self._lock:
            for host in self._collected - seen:
                self._hosts.pop(host, None)
            self._collected = seen
        return n

    # -- merged views --------------------------------------------------------
    def hosts(self):
        with self._lock:
            return sorted(self._hosts)

    def snapshots(self):
        with self._lock:
            return dict(self._hosts)

    @staticmethod
    def _relabel(key, host):
        """`name` / `name{a=b}` -> `name{host=h[,a=b]}`."""
        if "{" in key:
            name, rest = key.split("{", 1)
            return "%s{host=%s,%s" % (name, host, rest)
        return "%s{host=%s}" % (key, host)

    def merged_samples(self):
        """One flat {metric{host=...}: value} dict over every host's
        latest snapshot."""
        out = {}
        for host, payload in sorted(self.snapshots().items()):
            for key, value in payload["metrics"].items():
                out[self._relabel(key, host)] = value
        return out

    def render_text(self):
        """The merged view as exposition-style lines (host-labeled),
        prefixed with one comment line per host naming its snapshot
        age."""
        now = time.time()
        lines = []
        for host, payload in sorted(self.snapshots().items()):
            lines.append("# fleet host %s (snapshot %.1fs old)"
                         % (host, now - payload.get("ts", now)))
        for key, value in sorted(self.merged_samples().items()):
            lines.append("%s %g" % (key, value))
        return "\n".join(lines) + "\n"

    # -- skew / stragglers ---------------------------------------------------
    @staticmethod
    def _step_ms(metrics):
        """Mean step wall ms from the standard step-telemetry
        histogram samples (`trainer_step_seconds{trainer=..}_sum` /
        `_count`, summed across trainers); None without step data."""
        total_s = total_n = 0.0
        for key, value in metrics.items():
            if not key.startswith("trainer_step_seconds{"):
                continue
            if key.endswith("_sum"):
                total_s += value
            elif key.endswith("_count"):
                total_n += value
        if total_n <= 0:
            return None
        return total_s / total_n * 1e3

    def step_times(self):
        """{host: mean step ms} for hosts that reported step data."""
        out = {}
        for host, payload in self.snapshots().items():
            ms = self._step_ms(payload["metrics"])
            if ms is not None:
                out[host] = ms
        return out

    def stragglers(self, factor=None, publish=True):
        """Flag hosts whose mean step time exceeds `factor` × the
        fleet median.  Returns {"step_ms": {host: ms}, "median_ms",
        "factor", "flagged": [hosts]} and (by default) publishes
        `fleet_host_step_ms{host=}`, `fleet_straggler{host=}` and
        `fleet_hosts` into the default registry."""
        factor = self.straggler_factor if factor is None else \
            float(factor)
        step_ms = self.step_times()
        ordered = sorted(step_ms.values())
        median = None
        if ordered:
            n = len(ordered)
            median = (ordered[n // 2] if n % 2 else
                      (ordered[n // 2 - 1] + ordered[n // 2]) / 2.0)
        flagged = sorted(h for h, ms in step_ms.items()
                         if median and ms > factor * median)
        report = {"step_ms": {h: round(ms, 3)
                              for h, ms in sorted(step_ms.items())},
                  "median_ms": None if median is None
                  else round(median, 3),
                  "factor": factor, "flagged": flagged}
        if publish:
            reg = registry_mod.get_registry()
            host_ms = reg.gauge(
                "fleet_host_step_ms",
                "per-host mean train-step wall ms (fleet aggregation)",
                labelnames=("host",))
            straggler = reg.gauge(
                "fleet_straggler",
                "1 when the host's step time exceeds "
                "straggler_factor x fleet median",
                labelnames=("host",))
            for host, ms in step_ms.items():
                host_ms.labels(host=host).set(round(ms, 3))
                straggler.labels(host=host).set(
                    1 if host in flagged else 0)
            # retire gauges of hosts that left the fleet (lease
            # expired and collect() dropped them): a frozen last
            # value would read as a live host forever
            with self._lock:
                departed = self._published - set(step_ms)
                self._published = set(step_ms)
            for host in departed:
                host_ms.remove(host=host)
                straggler.remove(host=host)
            # snapshot age covers EVERY host with a snapshot, not just
            # the ones reporting step data — a host whose last push is
            # aging toward its TTL is the earliest straggler signal
            age_gauge = reg.gauge(
                "fleet_snapshot_age_seconds",
                "seconds since the host's last fleet snapshot push",
                labelnames=("host",))
            now = time.time()
            snaps = self.snapshots()
            for host, payload in snaps.items():
                age_gauge.labels(host=host).set(
                    round(max(0.0, now - payload.get("ts", now)), 3))
            with self._lock:
                age_departed = self._age_published - set(snaps)
                self._age_published = set(snaps)
            for host in age_departed:
                age_gauge.remove(host=host)
            reg.gauge("fleet_hosts",
                      "hosts with a live fleet snapshot") \
               .set(len(self.hosts()))
        return report


# ---------------------------------------------------------------------------
# CLI: worker push / operator aggregate
# ---------------------------------------------------------------------------

def _simulate_steps(steps, step_ms):
    """Drive `steps` fake trainer steps of ~step_ms each through the
    real telemetry path (the dryrun worker's workload: the aggregator
    must read standard step telemetry, not a bespoke channel)."""
    for _ in range(int(steps)):
        with telemetry_mod.step("fleet_dryrun", examples=1):
            time.sleep(step_ms / 1e3)


def main(argv=None):
    p = argparse.ArgumentParser(prog="paddle_fleet", description=(
        "fleet metric aggregation over the coordinator's TTL-lease "
        "store"))
    p.add_argument("--master", required=True, help="master host:port")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--push", action="store_true",
                      help="publish this process's registry snapshot")
    mode.add_argument("--aggregate", action="store_true",
                      help="pull every /obs/* snapshot, print the "
                           "merged host-labeled view + stragglers")
    p.add_argument("--host", default=None,
                   help="host label for --push (default: env/hostname)")
    p.add_argument("--steps", type=int, default=0,
                   help="--push: simulate N trainer steps first "
                        "(dryrun workload)")
    p.add_argument("--step-ms", type=float, default=5.0,
                   help="--push: simulated step duration")
    p.add_argument("--ttl-ms", type=int, default=30000,
                   help="--push: snapshot lease TTL")
    p.add_argument("--all-metrics", action="store_true",
                   help="--push: push the FULL registry instead of "
                        "the bounded default prefix set (payloads "
                        "must stay under the pull path's list "
                        "buffer at fleet scale)")
    p.add_argument("--straggler-factor", type=float,
                   default=DEFAULT_STRAGGLER_FACTOR)
    p.add_argument("--json", action="store_true",
                   help="--aggregate: machine-readable output")
    args = p.parse_args(argv)

    if args.push:
        if args.steps:
            _simulate_steps(args.steps, args.step_ms)
        reporter = FleetReporter(
            args.master, host=args.host, ttl_factor=1,
            prefixes=None if args.all_metrics
            else DEFAULT_PUSH_PREFIXES)
        reporter.ttl_ms = int(args.ttl_ms)
        ok = reporter.push_once()
        print("[fleet] %s: pushed snapshot as %s (ttl %dms)"
              % ("ok" if ok else "FAILED", reporter.host,
                 reporter.ttl_ms), flush=True)
        return 0 if ok else 1

    agg = FleetAggregator(straggler_factor=args.straggler_factor)
    n = agg.collect(args.master)
    report = agg.stragglers()
    if args.json:
        print(json.dumps({"hosts": agg.hosts(), "snapshots": n,
                          "straggler_report": report,
                          "samples": agg.merged_samples()},
                         sort_keys=True))
        return 0
    sys.stdout.write(agg.render_text())
    print("[fleet] %d host snapshot(s); step_ms=%s median=%s "
          "stragglers=%s" % (n, report["step_ms"], report["median_ms"],
                             report["flagged"] or "none"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
