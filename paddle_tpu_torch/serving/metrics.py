"""Serving metrics: counters, gauges and latency histograms, rendered as
Prometheus text for `/metrics`.

Counterpart of paddle_tpu/serving/metrics.py, with the same metric
names and the same text format, kept in this package: the JAX side's
process-wide registry, profiler mirror, exemplars and SLO tracker come
with the observability slice.
"""

import threading

__all__ = ["Counter", "Gauge", "Histogram", "ServingMetrics",
           "DEFAULT_LATENCY_BUCKETS"]

DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0)


class _Metric:
    kind = None

    def __init__(self, name, help_text=""):
        self.name = name
        self.help_text = help_text
        self._lock = threading.Lock()

    def render(self):
        lines = []
        if self.help_text:
            lines.append("# HELP %s %s" % (self.name, self.help_text))
        lines.append("# TYPE %s %s" % (self.name, self.kind))
        lines.extend(self._samples())
        return lines


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_text=""):
        super().__init__(name, help_text)
        self._value = 0

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError("counter %s cannot decrease" % self.name)
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value

    def _samples(self):
        return ["%s %g" % (self.name, self.value)]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help_text=""):
        super().__init__(name, help_text)
        self._value = 0

    def set(self, value):
        with self._lock:
            self._value = value

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        with self._lock:
            self._value -= amount

    @property
    def value(self):
        with self._lock:
            return self._value

    def _samples(self):
        return ["%s %g" % (self.name, self.value)]


class Histogram(_Metric):
    """Cumulative-bucket histogram: a bucket `le` counts every
    observation <= its bound, plus +Inf."""

    kind = "histogram"

    def __init__(self, name, buckets=DEFAULT_LATENCY_BUCKETS,
                 help_text=""):
        super().__init__(name, help_text)
        self.bounds = tuple(sorted(buckets))
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._total = 0

    def observe(self, value):
        value = float(value)
        i = 0
        while i < len(self.bounds) and value > self.bounds[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._total += 1

    @property
    def count(self):
        with self._lock:
            return self._total

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def _samples(self):
        lines = []
        with self._lock:
            cum = 0
            for bound, n in zip(self.bounds, self._counts):
                cum += n
                lines.append('%s_bucket{le="%g"} %d'
                             % (self.name, bound, cum))
            cum += self._counts[-1]
            lines.append('%s_bucket{le="+Inf"} %d' % (self.name, cum))
            lines.append("%s_sum %g" % (self.name, self._sum))
            lines.append("%s_count %d" % (self.name, self._total))
        return lines


class ServingMetrics:
    """The fixed metric set one server instance exposes."""

    def __init__(self):
        self._metrics = []
        self.requests_total = self._add(Counter(
            "serving_requests_total", "requests admitted to the queue"))
        self.responses_total = self._add(Counter(
            "serving_responses_total", "requests answered successfully"))
        self.rejected_queue_full = self._add(Counter(
            "serving_rejected_queue_full_total",
            "requests shed because the admission queue was full"))
        self.rejected_deadline = self._add(Counter(
            "serving_rejected_deadline_total",
            "requests dropped because their deadline expired"))
        self.rejected_draining = self._add(Counter(
            "serving_rejected_draining_total",
            "requests refused during shutdown drain"))
        self.errors_total = self._add(Counter(
            "serving_errors_total", "requests failed with an error"))
        self.cache_hit_total = self._add(Counter(
            "serving_compile_cache_hit_total",
            "batches whose padded bucket had run before"))
        self.cache_miss_total = self._add(Counter(
            "serving_compile_cache_miss_total",
            "batches that were the first run of their padded bucket"))
        self.queue_depth = self._add(Gauge(
            "serving_queue_depth",
            "requests waiting in the admission queue"))
        self.queue_depth_peak = self._add(Gauge(
            "serving_queue_depth_peak",
            "max admission-queue depth since the last scrape"))
        self.inflight = self._add(Gauge(
            "serving_inflight_batches", "batches currently executing"))
        self.batch_occupancy = self._add(Histogram(
            "serving_batch_occupancy",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
            help_text="requests coalesced per executed batch"))
        self.batch_rows = self._add(Histogram(
            "serving_batch_rows",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
            help_text="sample rows per executed batch (pre-padding)"))
        self.queue_seconds = self._add(Histogram(
            "serving_queue_seconds",
            help_text="submit -> batch-assembly latency"))
        self.pad_seconds = self._add(Histogram(
            "serving_pad_seconds",
            help_text="merge + bucket-padding latency"))
        self.compute_seconds = self._add(Histogram(
            "serving_compute_seconds",
            help_text="device execution latency (blocked on results)"))
        self.total_seconds = self._add(Histogram(
            "serving_total_seconds",
            help_text="submit -> response latency"))
        self._depth_lock = threading.Lock()

    def _add(self, metric):
        self._metrics.append(metric)
        return metric

    def note_queue_depth(self, depth):
        """Publish the live queue depth and raise the high-watermark."""
        depth = int(depth)
        with self._depth_lock:
            self.queue_depth.set(depth)
            if depth > self.queue_depth_peak.value:
                self.queue_depth_peak.set(depth)

    def observe_stage(self, stage, seconds):
        getattr(self, stage + "_seconds").observe(seconds)

    def render_text(self):
        """Prometheus text exposition; restarts the peak-depth window."""
        lines = []
        for m in self._metrics:
            lines.extend(m.render())
        with self._depth_lock:
            self.queue_depth_peak.set(self.queue_depth.value)
        return "\n".join(lines) + "\n"
