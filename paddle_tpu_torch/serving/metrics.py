"""Serving metrics: counters, gauges, per-stage latency histograms and
the latency SLO's burn rate.

Counterpart of paddle_tpu/serving/metrics.py, built the same way on the
port's `obs.registry`: the metric classes and `DEFAULT_LATENCY_BUCKETS`
are the registry's (labeled metrics, exemplars), and `ServingMetrics`
keeps its fixed metric set in a registry of its own that it also mounts
into the process-wide default registry, so `/metrics` serves executor,
trainer, numerics, tail and serving metrics from one surface, with the
JAX package's family names and labels.

Every latency observation is also mirrored into `fluid.profiler`'s
table (`serving/<stage>` rows), so `fluid.profiler.profiler()` around a
serving run shows the queue, pad and compute stages beside the ops.
"""

import threading

from ..fluid import profiler as profiler_mod
from ..obs.registry import (DEFAULT_LATENCY_BUCKETS, Counter, Gauge,
                            Histogram, MetricsRegistry, get_registry)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "ServingMetrics", "SLOTracker", "DEFAULT_LATENCY_BUCKETS"]


class ServingMetrics:
    """The fixed metric set one server instance exposes."""

    def __init__(self):
        reg = self.registry = MetricsRegistry()
        self.requests_total = reg.counter(
            "serving_requests_total", "requests admitted to the queue")
        self.responses_total = reg.counter(
            "serving_responses_total", "requests answered successfully")
        self.rejected_queue_full = reg.counter(
            "serving_rejected_queue_full_total",
            "requests shed because the admission queue was full")
        self.rejected_deadline = reg.counter(
            "serving_rejected_deadline_total",
            "requests dropped because their deadline expired")
        self.rejected_draining = reg.counter(
            "serving_rejected_draining_total",
            "requests refused during shutdown drain")
        self.errors_total = reg.counter(
            "serving_errors_total", "requests failed with an error")
        self.cache_hit_total = reg.counter(
            "serving_compile_cache_hit_total",
            "batches whose padded bucket had run before")
        self.cache_miss_total = reg.counter(
            "serving_compile_cache_miss_total",
            "batches that were the first run of their padded bucket")
        self.queue_depth = reg.gauge(
            "serving_queue_depth",
            "requests waiting in the admission queue")
        # a scrape between enqueue/dequeue samples misses transient
        # saturation; the high-watermark gauge keeps the worst depth
        # seen since the last /metrics render (reset on scrape)
        self.queue_depth_peak = reg.gauge(
            "serving_queue_depth_peak",
            "max admission-queue depth since the last scrape")
        self.inflight = reg.gauge(
            "serving_inflight_batches", "batches currently executing")
        self.batch_occupancy = reg.histogram(
            "serving_batch_occupancy",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
            help_text="requests coalesced per executed batch")
        self.batch_rows = reg.histogram(
            "serving_batch_rows",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
            help_text="sample rows per executed batch (pre-padding)")
        self.queue_seconds = reg.histogram(
            "serving_queue_seconds",
            help_text="submit -> batch-assembly latency")
        self.pad_seconds = reg.histogram(
            "serving_pad_seconds",
            help_text="merge + bucket-padding latency")
        self.compute_seconds = reg.histogram(
            "serving_compute_seconds",
            help_text="device execution latency (blocked on results)")
        self.total_seconds = reg.histogram(
            "serving_total_seconds",
            help_text="submit -> response latency")
        # newest instance owns the unified registry's "serving" group
        # (each keeps its own `registry` intact either way)
        get_registry().attach("serving", reg)
        self._depth_lock = threading.Lock()

    def note_queue_depth(self, depth):
        """Publish the live queue depth AND raise the high-watermark,
        at every depth transition (enqueue, dequeue, the shed path)."""
        depth = int(depth)
        with self._depth_lock:
            self.queue_depth.set(depth)
            if depth > self.queue_depth_peak.value:
                self.queue_depth_peak.set(depth)

    def observe_stage(self, stage, seconds, exemplar=None):
        """Record a per-stage latency in both systems: the histogram
        for /metrics scrapes and fluid.profiler for its table.
        `exemplar` (a trace id or label dict) is retained on the
        histogram bucket and rendered in OpenMetrics exemplar syntax,
        so a latency bucket links to a concrete trace."""
        getattr(self, stage + "_seconds").observe(seconds,
                                                  exemplar=exemplar)
        profiler_mod.record("serving/" + stage, seconds)

    def render_text(self, exemplars=False):
        """The unified exposition: the default registry's metrics plus
        this instance's serving metrics (overriding whatever instance
        currently holds the "serving" mount).  `exemplars=True` is for
        OpenMetrics-negotiated scrapes only; restarts the peak-depth
        window."""
        text = get_registry().render_text(
            override_groups={"serving": self.registry},
            exemplars=exemplars)
        with self._depth_lock:
            self.queue_depth_peak.set(self.queue_depth.value)
        return text


class SLOTracker:
    """Latency-objective burn rate over the request-latency histogram
    (`serving_total_seconds`) — no second timing path.

    The objective is "`target` of requests answer within
    `objective_ms`"; the error budget is the allowed violating fraction
    (1 - target).  Each `update()` reads the histogram's cumulative
    (count, count-below-objective) pair, diffs it against the previous
    update, and publishes

        burn = violating_fraction_in_window / (1 - target)

    into the default registry as `slo_burn_rate{model=...}`: 1.0 means
    the budget is consumed exactly as provisioned, > 1 that the SLO
    fails if the window's behavior persists.  The window IS the update
    cadence (/healthz polls define it).  A window with no traffic burns
    nothing (0.0).  The within-objective count interpolates linearly
    inside the bucket holding the objective
    (registry.Histogram.count_and_below)."""

    def __init__(self, metrics, objective_ms, target=0.99,
                 model="default"):
        if not 0.0 < float(target) < 1.0:
            raise ValueError("slo target must be in (0, 1); got %r"
                             % (target,))
        self.objective_s = float(objective_ms) / 1e3
        self.target = float(target)
        self.model = str(model)
        self._hist = metrics.total_seconds
        if self.objective_s > self._hist.bounds[-1]:
            # beyond the largest finite bucket every violation would
            # count as within objective and the burn could never rise
            raise ValueError(
                "slo objective %gms exceeds the latency histogram's "
                "largest finite bucket (%gs); violations beyond it "
                "are unmeasurable" % (float(objective_ms),
                                      self._hist.bounds[-1]))
        self._lock = threading.Lock()  # /healthz probes are threaded
        self._prev = (0, 0.0)  # cumulative (count, count_below)
        self._gauge = get_registry().gauge(
            "slo_burn_rate",
            "latency-SLO error-budget burn rate per model "
            "(violating fraction / allowed fraction, over the "
            "window between updates)", labelnames=("model",)) \
            .labels(model=self.model)
        self._gauge.set(0.0)

    def update(self):
        """Recompute the burn over the window since the last update;
        publishes and returns it.  Locked: concurrent probes must
        window against disjoint `_prev` states."""
        with self._lock:
            count, good = self._hist.count_and_below(self.objective_s)
            prev_count, prev_good = self._prev
            self._prev = (count, good)
        d_count = count - prev_count
        if d_count <= 0:
            burn = 0.0
        else:
            bad_frac = max(0.0, 1.0 - (good - prev_good) / d_count)
            burn = bad_frac / (1.0 - self.target)
        burn = round(burn, 6)
        self._gauge.set(burn)
        return burn
