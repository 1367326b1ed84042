"""Central metrics registry: counters, gauges, histograms — optionally
labeled — with Prometheus-text and JSONL export (a copy of
paddle_tpu/obs/registry.py).

In the port it holds the v2 trainer's metrics (obs/telemetry.py); the
port's serving keeps its own `serving/metrics.py`.

Label semantics follow prometheus_client: a metric constructed with
`labelnames` is a *family* — call `.labels(k=v)` to get (and cache)
the child that actually counts; the family renders every child under
one `# TYPE` header.  Unlabeled metrics count directly, exactly like
the pre-obs serving classes.

Registries compose: `attach(name, registry)` mounts another registry
as a named group rendered after the owner's own metrics.  The default
registry (`get_registry()`) is the process-wide table.
"""

import bisect
import json
import threading
import time

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_LATENCY_BUCKETS", "get_registry", "reset_registry"]

# seconds; spans sub-ms CPU-cache hits to multi-second cold compiles
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0)


def _escape(value):
    return str(value).replace("\\", "\\\\").replace('"', '\\"') \
                     .replace("\n", "\\n")


def _label_str(labels, extra=()):
    """Render ((k, v), ...) label pairs as a `{k="v",...}` suffix;
    empty string when there are none."""
    pairs = tuple(labels) + tuple(extra)
    if not pairs:
        return ""
    return "{%s}" % ",".join('%s="%s"' % (k, _escape(v))
                             for k, v in pairs)


class _Metric:
    """Shared family/child plumbing.  A metric with `labelnames` is a
    family: observations go through `.labels(...)` children; one
    without counts directly."""

    kind = "untyped"

    def __init__(self, name, help_text="", labelnames=()):
        self.name = name
        self.help_text = help_text
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children = {} if self.labelnames else None
        self._labels = ()  # ((k, v), ...) on children, () on roots

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **kv):
        if self._children is None:
            raise ValueError("metric %s has no labelnames" % self.name)
        if set(kv) != set(self.labelnames):
            raise ValueError(
                "metric %s expects labels %s, got %s"
                % (self.name, sorted(self.labelnames), sorted(kv)))
        key = tuple(str(kv[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                child._labels = tuple(zip(self.labelnames, key))
                self._children[key] = child
            return child

    def remove(self, **kv):
        """Drop one labeled child from the family so it stops
        rendering (prometheus_client's `remove()`): how publishers of
        per-entity gauges (fleet per-host metrics) retire an entity
        instead of freezing its last value forever.  No-op when the
        child doesn't exist."""
        if self._children is None:
            raise ValueError("metric %s has no labelnames" % self.name)
        if set(kv) != set(self.labelnames):
            raise ValueError(
                "metric %s expects labels %s, got %s"
                % (self.name, sorted(self.labelnames), sorted(kv)))
        key = tuple(str(kv[k]) for k in self.labelnames)
        with self._lock:
            self._children.pop(key, None)

    def _check_leaf(self):
        if self._children is not None:
            raise ValueError(
                "metric %s is a labeled family; use .labels(...)"
                % self.name)

    def _leaves(self):
        if self._children is None:
            return [self]
        with self._lock:
            return list(self._children.values())

    def family_name(self, openmetrics=False):
        """The family name for TYPE/HELP lines.  OpenMetrics requires
        counter FAMILIES named without the `_total` suffix (samples
        keep it) — a strict OM parser rejects `# TYPE foo_total
        counter`, and the OM exposition is the only one that carries
        exemplars, so the negotiated render must comply."""
        if openmetrics and self.kind == "counter" \
                and self.name.endswith("_total"):
            return self.name[:-len("_total")]
        return self.name

    def render(self, exemplars=False):
        """`exemplars=True` means "render for an OpenMetrics scrape":
        exemplar suffixes on histogram buckets AND OM-compliant
        counter family names."""
        lines = ["# TYPE %s %s" % (self.family_name(exemplars),
                                   self.kind)]
        for leaf in self._leaves():
            lines.extend(leaf._render_samples(exemplars=exemplars))
        return lines

    def samples(self):
        """JSON-able sample dicts (one per child for families)."""
        out = []
        for leaf in self._leaves():
            s = leaf._sample_value()
            s["name"] = self.name
            s["type"] = self.kind
            if leaf._labels:
                s["labels"] = dict(leaf._labels)
            out.append(s)
        return out


class Counter(_Metric):
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name, help_text="", labelnames=()):
        super().__init__(name, help_text, labelnames)
        self._value = 0

    def _new_child(self):
        return Counter(self.name, self.help_text)

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError("counter %s cannot decrease" % self.name)
        self._check_leaf()
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value

    def _render_samples(self, exemplars=False):
        return ["%s%s %g" % (self.name, _label_str(self._labels),
                             self.value)]

    def _sample_value(self):
        return {"value": self.value}


class Gauge(_Metric):
    """Instantaneous value (queue depth, in-flight requests, loss)."""

    kind = "gauge"

    def __init__(self, name, help_text="", labelnames=()):
        super().__init__(name, help_text, labelnames)
        self._value = 0

    def _new_child(self):
        return Gauge(self.name, self.help_text)

    def set(self, value):
        self._check_leaf()
        with self._lock:
            self._value = value

    def inc(self, amount=1):
        self._check_leaf()
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        self._check_leaf()
        with self._lock:
            self._value -= amount

    @property
    def value(self):
        with self._lock:
            return self._value

    def _render_samples(self, exemplars=False):
        return ["%s%s %g" % (self.name, _label_str(self._labels),
                             self.value)]

    def _sample_value(self):
        return {"value": self.value}


class Histogram(_Metric):
    """Cumulative-bucket histogram (prometheus semantics: bucket `le`
    counts include every observation <= bound, plus +Inf).

    `observe(value, exemplar=...)` additionally retains the LAST
    exemplar per bucket — a small label dict (canonically
    `{"trace_id": ...}`) naming one concrete observation that landed
    there — rendered in OpenMetrics exemplar syntax
    (`..._bucket{le="0.25"} 7 # {trace_id="ab12"} 0.21 <ts>`), so a
    p99 latency bucket in /metrics links directly to a captured
    trace instead of being an anonymous count."""

    kind = "histogram"

    def __init__(self, name, buckets=DEFAULT_LATENCY_BUCKETS,
                 help_text="", labelnames=()):
        super().__init__(name, help_text, labelnames)
        self.bounds = tuple(sorted(buckets))
        self._counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self._exemplars = [None] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._total = 0
        self._max = 0.0

    def _new_child(self):
        return Histogram(self.name, self.bounds, self.help_text)

    def observe(self, value, exemplar=None):
        self._check_leaf()
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._total += 1
            if value > self._max:
                self._max = value
            if exemplar is not None:
                if not isinstance(exemplar, dict):
                    exemplar = {"trace_id": str(exemplar)}
                self._exemplars[idx] = (exemplar, value, time.time())

    def exemplars(self):
        """{le_bound_string: (labels, value, unix_ts)} for buckets that
        hold one (`"+Inf"` keys the overflow bucket)."""
        with self._lock:
            out = {}
            for bound, ex in zip(self.bounds, self._exemplars):
                if ex is not None:
                    out["%g" % bound] = ex
            if self._exemplars[-1] is not None:
                out["+Inf"] = self._exemplars[-1]
            return out

    @property
    def count(self):
        with self._lock:
            return self._total

    @property
    def sum(self):
        with self._lock:
            return self._sum

    @property
    def max(self):
        with self._lock:
            return self._max

    def _count_below_locked(self, value):
        total = 0.0
        lo = 0.0
        for bound, n in zip(self.bounds, self._counts):
            if value >= bound:
                total += n
                lo = bound
            else:
                if bound > lo and value > lo:
                    total += n * (value - lo) / (bound - lo)
                return total
        if value > lo:
            total += self._counts[-1]
        return total

    def count_below(self, value):
        """Estimated observations <= `value`, interpolating linearly
        inside the bucket containing it (prometheus histogram_quantile
        semantics, inverted).  Observations in the +Inf bucket only
        count when `value` is beyond the largest finite bound — their
        true positions are unknowable.  The SLO burn tracker reads its
        'requests within objective' numerator off this."""
        with self._lock:
            return self._count_below_locked(value)

    def count_and_below(self, value):
        """`(count, count_below(value))` as ONE consistent snapshot —
        two separate reads could straddle a concurrent observe(),
        yielding below > count and corrupting windowed ratios (the
        SLO burn tracker's failure mode)."""
        with self._lock:
            return self._total, self._count_below_locked(value)

    def fraction_below(self, value):
        """`count_below(value) / count` — 1.0 on an empty histogram
        (no observations violate any objective)."""
        with self._lock:
            total = self._total
            below = self._count_below_locked(value)
        if total == 0:
            return 1.0
        return min(1.0, below / total)

    @staticmethod
    def _exemplar_suffix(ex):
        """OpenMetrics exemplar rendering: ` # {labels} value ts`."""
        if ex is None:
            return ""
        labels, value, ts = ex
        return " # %s %g %.3f" % (
            _label_str(tuple(sorted(labels.items()))) or "{}", value, ts)

    def _render_samples(self, exemplars=False):
        """`exemplars=True` appends OpenMetrics exemplar suffixes to
        bucket lines — syntax stock text-format-0.0.4 scrapers reject,
        so the caller must only ask for it on a negotiated
        `application/openmetrics-text` exposition (the serving
        /metrics endpoint does the negotiation)."""
        lines = []
        base = tuple(self._labels)
        with self._lock:
            cum = 0
            for bound, n, ex in zip(self.bounds, self._counts,
                                    self._exemplars):
                cum += n
                lines.append("%s_bucket%s %d%s" % (
                    self.name, _label_str(base, (("le", "%g" % bound),)),
                    cum,
                    self._exemplar_suffix(ex) if exemplars else ""))
            cum += self._counts[-1]
            lines.append("%s_bucket%s %d%s" % (
                self.name, _label_str(base, (("le", "+Inf"),)), cum,
                self._exemplar_suffix(self._exemplars[-1])
                if exemplars else ""))
            lines.append("%s_sum%s %g" % (self.name, _label_str(base),
                                          self._sum))
            lines.append("%s_count%s %d" % (self.name, _label_str(base),
                                            self._total))
        return lines

    def _sample_value(self):
        with self._lock:
            cum, buckets = 0, {}
            for bound, n in zip(self.bounds, self._counts):
                cum += n
                buckets["%g" % bound] = cum
            buckets["+Inf"] = cum + self._counts[-1]
            return {"count": self._total, "sum": self._sum,
                    "max": self._max, "buckets": buckets}


class MetricsRegistry:
    """Ordered metric collection + named sub-registries.

    `counter`/`gauge`/`histogram` are get-or-create: asking for an
    existing name returns the existing metric (type and labelnames
    must match), so module-level telemetry can look metrics up by name
    on every step without caching object references."""

    def __init__(self):
        self._metrics = []
        self._by_name = {}
        self._groups = {}
        self._lock = threading.Lock()

    def register(self, metric):
        with self._lock:
            existing = self._by_name.get(metric.name)
            if existing is not None:
                return existing
            self._by_name[metric.name] = metric
            self._metrics.append(metric)
        return metric

    def _get_or_create(self, cls, name, kwargs, labelnames):
        with self._lock:
            m = self._by_name.get(name)
            if m is not None:
                if not isinstance(m, cls) \
                        or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        "metric %r already registered with different "
                        "type/labels" % name)
                want_buckets = kwargs.get("buckets")
                if want_buckets is not None \
                        and m.bounds != tuple(sorted(want_buckets)):
                    raise ValueError(
                        "histogram %r already registered with buckets "
                        "%s (asked for %s)" % (name, m.bounds,
                                               tuple(want_buckets)))
                return m
            m = cls(name, labelnames=tuple(labelnames), **kwargs)
            self._by_name[name] = m
            self._metrics.append(m)
            return m

    def counter(self, name, help_text="", labelnames=()):
        return self._get_or_create(Counter, name,
                                   {"help_text": help_text}, labelnames)

    def gauge(self, name, help_text="", labelnames=()):
        return self._get_or_create(Gauge, name,
                                   {"help_text": help_text}, labelnames)

    def histogram(self, name, buckets=DEFAULT_LATENCY_BUCKETS,
                  help_text="", labelnames=()):
        return self._get_or_create(
            Histogram, name, {"buckets": buckets, "help_text": help_text},
            labelnames)

    def attach(self, name, registry):
        """Mount `registry` as a named group (replacing any previous
        mount under that name — e.g. each new ServingMetrics instance
        takes over the "serving" slot)."""
        with self._lock:
            self._groups[name] = registry
        return registry

    def detach(self, name):
        with self._lock:
            return self._groups.pop(name, None)

    def render_text(self, override_groups=None, exemplars=False):
        """Prometheus text exposition.  `exemplars=True` adds
        OpenMetrics exemplar suffixes on histogram buckets — only
        valid on a scrape that negotiated
        `application/openmetrics-text` (plain 0.0.4 scrapers reject
        the syntax), so it defaults off."""
        with self._lock:
            metrics = list(self._metrics)
            groups = dict(self._groups)
        if override_groups:
            groups.update(override_groups)
        lines = []
        for m in metrics:
            if m.help_text:
                lines.append("# HELP %s %s"
                             % (m.family_name(exemplars), m.help_text))
            lines.extend(m.render(exemplars=exemplars))
        for key in sorted(groups):
            sub = groups[key].render_text(exemplars=exemplars)
            lines.extend(sub.rstrip("\n").splitlines())
        return "\n".join(lines) + "\n"

    def to_dict(self):
        with self._lock:
            metrics = list(self._metrics)
            groups = dict(self._groups)
        samples = []
        for m in metrics:
            samples.extend(m.samples())
        for key in sorted(groups):
            for s in groups[key].to_dict()["metrics"]:
                s = dict(s, group=key)
                samples.append(s)
        return {"metrics": samples}

    def render_jsonl(self):
        """One JSON object per metric sample — the format mega_bench
        embeds into BENCH records and obs_dump writes with
        --format jsonl."""
        return "\n".join(json.dumps(s, sort_keys=True)
                         for s in self.to_dict()["metrics"]) + "\n"


_default_registry = MetricsRegistry()


def get_registry():
    """The process-wide registry every subsystem reports into."""
    return _default_registry


def reset_registry():
    """Swap in a fresh default registry (test isolation); returns it."""
    global _default_registry
    _default_registry = MetricsRegistry()
    return _default_registry
