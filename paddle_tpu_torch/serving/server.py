"""Threaded HTTP front end over the engine and the micro-batcher.

Counterpart of paddle_tpu/serving/server.py.  Endpoints:
  POST /v1/infer   {"inputs": {name: nested lists}, "timeout_ms": n}
                   -> {"outputs": {fetch: nested lists}, "batch": B}
                   (a ragged input or output is a list of sequences,
                   each a nested list of its rows)
  GET  /metrics    Prometheus text exposition (OpenMetrics, with
                   exemplars, when the scraper asks for it)
  GET  /healthz    {"status": "ok" | "draining", plus registry-derived
                   signals: queue depth, error and shed totals, nonfinite
                   counts, bucket first runs, and the SLO's burn}
  GET  /debug/tail the tail recorder's ring: the span trees of the slow
                   and errored requests

Rejection contract: a full admission queue answers 429 (with a
Retry-After hint), an expired deadline 504, a draining server 503 — a
request is never silently hung.  `shutdown()` stops admission, drains
what was already queued, then closes the listener.

Every request gets a trace context (`obs.context`): it continues the
caller's W3C `traceparent` when one is sent, and every reply echoes it
with an `x-request-id`.  The JAX server's `memory` section of /healthz
reads its compiled executables' memory capture (`obs/mem.py`), which
the port does not have yet (ROADMAP A2).
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..core.ragged import RaggedTensor, ragged_to_sequences
from ..obs import context as obs_context
from ..obs import flight as obs_flight
from ..obs import registry as obs_registry
from ..obs import tail as obs_tail
from .batcher import (BatcherConfig, DeadlineExceededError, MicroBatcher,
                      QueueFullError, ShuttingDownError)
from .metrics import ServingMetrics, SLOTracker

__all__ = ["ServerConfig", "InferenceServer"]


class ServerConfig:
    """slo_ms / slo_target / model_name declare this server's latency
    objective ("slo_target of requests answer within slo_ms"): the
    request-latency histogram is folded into a
    `slo_burn_rate{model=model_name}` gauge surfaced in /metrics and
    /healthz.  slo_ms=None (the default) disables SLO tracking.

    tail_slow_ms / tail_capacity bound the tail recorder: requests
    slower than tail_slow_ms (default: slo_ms) or answered >= 500 keep
    their full span tree, retrievable via GET /debug/tail.

    access_log: path of an opt-in JSONL access log — one line per
    request (request_id, trace_id, status, latency_ms, batch, bucket).
    None (the default) logs nothing.

    retry_after_s: the backoff a 429 reply advertises in its
    Retry-After header, in whole seconds on the wire (at least 1)."""

    def __init__(self, host="127.0.0.1", port=8500, max_batch=32,
                 max_wait_ms=5.0, queue_size=64, default_timeout_ms=None,
                 warmup=True, slo_ms=None, slo_target=0.99,
                 model_name="default", tail_slow_ms=None,
                 tail_capacity=64, access_log=None, retry_after_s=1.0):
        self.host = host
        self.port = int(port)
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.queue_size = int(queue_size)
        self.default_timeout_ms = default_timeout_ms
        self.warmup = bool(warmup)
        self.slo_ms = None if slo_ms is None else float(slo_ms)
        self.slo_target = float(slo_target)
        self.model_name = str(model_name)
        self.tail_slow_ms = (self.slo_ms if tail_slow_ms is None
                             else float(tail_slow_ms))
        self.tail_capacity = int(tail_capacity)
        self.access_log = access_log
        self.retry_after_s = float(retry_after_s)


def _to_list(arr):
    arr = np.asarray(arr)
    if arr.dtype.kind not in "biuf" or arr.dtype.name == "float16":
        arr = arr.astype(np.float32)
    return arr.tolist()


def _jsonable(value):
    """A fetch as JSON: nested lists, a ragged one as a list of its
    sequences."""
    if isinstance(value, RaggedTensor):
        return [_to_list(s) for s in ragged_to_sequences(value)]
    return _to_list(value)


class _Handler(BaseHTTPRequestHandler):
    # one handler thread per connection; all state lives on
    # self.server.owner
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _reply(self, status, body, content_type="application/json",
               headers=None):
        data = (json.dumps(body) if content_type == "application/json"
                else body).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        owner = self.server.owner
        if self.path == "/metrics":
            # exemplars are OpenMetrics-only syntax: a 0.0.4 text
            # scraper would reject the whole exposition
            if "application/openmetrics-text" in \
                    (self.headers.get("Accept") or ""):
                self._reply(
                    200,
                    owner.metrics.render_text(exemplars=True) + "# EOF\n",
                    content_type="application/openmetrics-text; "
                                 "version=1.0.0; charset=utf-8")
            else:
                self._reply(200, owner.metrics.render_text(),
                            content_type="text/plain; version=0.0.4")
        elif self.path == "/healthz":
            self._reply(200, owner.health_signals())
        elif self.path == "/debug/tail":
            self._reply(200, owner.tail.to_dict())
        else:
            self._reply(404, {"error": "not found"})

    def do_POST(self):
        owner = self.server.owner
        if self.path not in ("/v1/infer", "/infer"):
            self._reply(404, {"error": "not found"})
            return
        # mint/continue the trace context BEFORE parsing: even a 400
        # reply carries a request_id and echoes the trace
        ctx = obs_context.new_context(self.headers.get("traceparent"))
        echo = {"traceparent": ctx.traceparent(),
                "x-request-id": ctx.request_id}
        try:
            length = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, TypeError) as exc:
            self._reply(400, {"error": "bad json: %s" % exc,
                              "request_id": ctx.request_id},
                        headers=echo)
            return
        status, body = owner.handle_infer(payload, ctx=ctx)
        if status == 429:
            # a shed request is told when to come back
            echo["Retry-After"] = "%d" % max(
                1, int(round(owner.config.retry_after_s)))
        self._reply(status, body, headers=echo)


class _ThreadingHTTPServer(ThreadingHTTPServer):
    # the stdlib accept backlog (5) resets connection bursts; admission
    # control belongs to the batcher queue (429)
    request_queue_size = 128


class InferenceServer:
    """Owns the engine, batcher, metrics and the HTTP listener."""

    def __init__(self, engine, config=None, metrics=None):
        self.engine = engine
        self.config = config or ServerConfig()
        self.metrics = metrics or ServingMetrics()
        if engine.metrics is None:
            engine.metrics = self.metrics
        self.batcher = MicroBatcher(
            engine,
            BatcherConfig(max_batch=self.config.max_batch,
                          max_wait_ms=self.config.max_wait_ms,
                          queue_size=self.config.queue_size,
                          default_timeout_ms=self.config.default_timeout_ms),
            metrics=self.metrics)
        self.slo = (None if self.config.slo_ms is None
                    else SLOTracker(self.metrics, self.config.slo_ms,
                                    target=self.config.slo_target,
                                    model=self.config.model_name))
        # always on and bounded: only slow or errored requests write
        self.tail = obs_tail.TailRecorder(
            capacity=self.config.tail_capacity,
            slow_ms=self.config.tail_slow_ms)
        self.draining = False
        self._httpd = None
        self._http_thread = None
        self._access_log = None
        self._access_lock = threading.Lock()
        if self.config.access_log:
            self._access_log = open(self.config.access_log, "a")

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self.config.warmup:
            self.engine.warmup()
        self.batcher.start()
        self._httpd = _ThreadingHTTPServer(
            (self.config.host, self.config.port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.owner = self
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="serving-http",
            daemon=True)
        self._http_thread.start()
        return self

    @property
    def address(self):
        if self._httpd is None:
            return (self.config.host, self.config.port)
        return self._httpd.server_address[:2]

    def shutdown(self, timeout=30.0):
        """Graceful drain: refuse new work, answer everything already
        admitted, then close the listener."""
        self.draining = True
        self.batcher.close(timeout=timeout)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._http_thread.join(timeout=timeout)
            self._httpd.server_close()
        with self._access_lock:
            if self._access_log is not None:
                self._access_log.close()
                self._access_log = None

    def health_signals(self):
        """The /healthz body: liveness signals read from the metrics
        (direct reads, not a registry snapshot: probes come often)."""
        nonfinite = obs_registry.get_registry().counter(
            "numerics_nonfinite_total",
            "NaN/Inf elements observed in watched tensors",
            labelnames=("tensor",))
        m = self.metrics
        body = {
            "status": "draining" if self.draining else "ok",
            "queue_depth": m.queue_depth.value,
            "inflight_batches": m.inflight.value,
            "requests_total": m.requests_total.value,
            "responses_total": m.responses_total.value,
            "errors_total": m.errors_total.value,
            "shed_total": (m.rejected_queue_full.value
                           + m.rejected_deadline.value
                           + m.rejected_draining.value),
            "compile_cache_miss_total": m.cache_miss_total.value,
            "numerics_nonfinite_total": sum(
                s["value"] for s in nonfinite.samples()),
        }
        if self.slo is not None:
            # the probe cadence defines the burn window (SLOTracker)
            body["slo_burn_rate"] = self.slo.update()
            body["slo"] = {"model": self.config.model_name,
                           "objective_ms": self.config.slo_ms,
                           "target": self.config.slo_target}
        return body

    # -- request handling ---------------------------------------------------
    def _parse_inputs(self, payload):
        inputs = payload.get("inputs")
        if not isinstance(inputs, dict):
            raise ValueError('payload needs an "inputs" object')
        feeds = {}
        for name in self.engine.feed_names:
            if name not in inputs:
                raise ValueError("missing input %r (expected %s)"
                                 % (name, self.engine.feed_names))
            meta = self.engine._feed_meta[name]
            if meta["lod_level"] > 0:
                feeds[name] = [np.asarray(s, dtype=meta["dtype"])
                               for s in inputs[name]]
                for s in feeds[name]:
                    self._check_tail(name, s.shape[1:], meta)
            else:
                feeds[name] = np.asarray(inputs[name], dtype=meta["dtype"])
                self._check_tail(name, feeds[name].shape[1:], meta)
        return feeds

    @staticmethod
    def _check_tail(name, tail, meta):
        """Reject shape mismatches at admission: a malformed request
        that reached the batcher would fail the merge and take every
        co-batched request down with it."""
        want = list(meta["shape"][1:])
        if len(tail) != len(want) or any(
                w >= 0 and t != w for t, w in zip(tail, want)):
            raise ValueError("input %r has per-sample shape %s, model "
                             "expects %s" % (name, list(tail), want))

    def _write_access_log(self, ctx, status, latency_ms, batch, bucket):
        """One JSONL line per request (opt-in, ServerConfig.access_log).
        A logging failure never fails the request."""
        if self._access_log is None:
            return
        line = json.dumps({
            "t": round(time.time(), 3),
            "request_id": ctx.request_id,
            "trace_id": ctx.trace_id,
            "status": status,
            "latency_ms": round(latency_ms, 3),
            "batch": batch,
            "bucket": bucket,
        }, sort_keys=True)
        try:
            with self._access_lock:
                if self._access_log is not None:
                    self._access_log.write(line + "\n")
                    self._access_log.flush()
        except (OSError, ValueError):
            pass

    def handle_infer(self, payload, ctx=None):
        """(status, json body) for one inference payload, shared by the
        HTTP handler and in-process callers.  Every reply body carries
        the request's `request_id`; its span tree (admission, queue
        wait, batch assembly, pad, device run, split, serialize)
        accumulates on `ctx`, and slow or errored requests keep theirs
        in the tail ring."""
        if ctx is None:
            ctx = obs_context.new_context()
        t0 = time.perf_counter()
        wall0 = time.time()
        batch = bucket = error = None
        # drain and shed replies are not tail-worthy: under overload
        # their empty trees would evict the captures that matter
        tail_capture = True
        with obs_context.use(ctx):
            if self.draining:
                self.metrics.rejected_draining.inc()
                status, body = 503, {"error": "draining"}
                tail_capture = False
            else:
                try:
                    with obs_context.span("serving/admission",
                                          cat="serving"):
                        feeds = self._parse_inputs(payload)
                        batch = self.engine.batch_size(feeds)
                        bucket = self.engine.config.bucket_for(batch)
                    outs = self.batcher.submit_and_wait(
                        feeds, timeout_ms=payload.get("timeout_ms"),
                        ctx=ctx)
                    with obs_context.span("serving/serialize",
                                          cat="serving"):
                        outputs = {name: _jsonable(val) for name, val in
                                   zip(self.engine.fetch_names, outs)}
                    status, body = 200, {"outputs": outputs,
                                         "batch": batch}
                except QueueFullError as exc:
                    status, body, error = 429, {"error": str(exc)}, exc
                    tail_capture = False
                except DeadlineExceededError as exc:
                    status, body, error = 504, {"error": str(exc)}, exc
                except ShuttingDownError as exc:
                    status, body, error = 503, {"error": str(exc)}, exc
                    tail_capture = False
                except (ValueError, KeyError, TypeError) as exc:
                    status, body = 400, {"error": str(exc)}
                except Exception as exc:  # noqa: BLE001 — must answer
                    obs_flight.on_crash(exc, origin="serving/http",
                                        request_id=ctx.request_id,
                                        trace_id=ctx.trace_id)
                    status, body, error = 500, {
                        "error": "%s: %s" % (type(exc).__name__, exc)}, \
                        exc
        dur_s = time.perf_counter() - t0
        # the request's root span closes the tree
        ctx.record("serving/request", wall0, dur_s, span_id=ctx.span_id,
                   parent_span_id=ctx.parent_span_id, cat="serving",
                   args={"status": status, "batch": batch})
        latency_ms = dur_s * 1e3
        if tail_capture:
            self.tail.offer(ctx, latency_ms, status=status, error=error)
        self._write_access_log(ctx, status, latency_ms, batch, bucket)
        body["request_id"] = ctx.request_id
        return status, body
