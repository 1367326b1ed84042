"""Threaded HTTP front end over the engine and the micro-batcher.

Counterpart of paddle_tpu/serving/server.py.  Endpoints:
  POST /v1/infer   {"inputs": {name: nested lists}, "timeout_ms": n}
                   -> {"outputs": {fetch: nested lists}, "batch": B}
                   (a ragged input or output is a list of sequences,
                   each a nested list of its rows)
  GET  /metrics    Prometheus text exposition
  GET  /healthz    {"status": "ok" | "draining", queue depth, totals}

Rejection contract: a full admission queue answers 429 (with a
Retry-After hint), an expired deadline 504, a draining server 503 — a
request is never silently hung.  `shutdown()` stops admission, drains
what was already queued, then closes the listener.  The SLO tracker,
tail recorder, traceparent echo and access log come with the
observability slice.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..core.ragged import RaggedTensor, ragged_to_sequences
from .batcher import (BatcherConfig, DeadlineExceededError, MicroBatcher,
                      QueueFullError, ShuttingDownError)
from .metrics import ServingMetrics

__all__ = ["ServerConfig", "InferenceServer"]

RETRY_AFTER_S = "1"  # the backoff a 429 reply advertises, in seconds


class ServerConfig:
    def __init__(self, host="127.0.0.1", port=8500, max_batch=32,
                 max_wait_ms=5.0, queue_size=64, default_timeout_ms=None,
                 warmup=True):
        self.host = host
        self.port = int(port)
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.queue_size = int(queue_size)
        self.default_timeout_ms = default_timeout_ms
        self.warmup = bool(warmup)


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
            self._reply(200, owner.metrics.render_text(),
                        content_type="text/plain; version=0.0.4")
        elif self.path == "/healthz":
            self._reply(200, owner.health_signals())
        else:
            self._reply(404, {"error": "not found"})

    def do_POST(self):
        owner = self.server.owner
        if self.path not in ("/v1/infer", "/infer"):
            self._reply(404, {"error": "not found"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, TypeError) as exc:
            self._reply(400, {"error": "bad json: %s" % exc})
            return
        status, body = owner.handle_infer(payload)
        # a shed request is told when to come back
        headers = {"Retry-After": RETRY_AFTER_S} if status == 429 else None
        self._reply(status, body, headers=headers)


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
        self.draining = False
        self._httpd = None
        self._http_thread = None

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

    def health_signals(self):
        m = self.metrics
        return {
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
        }

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

    def handle_infer(self, payload):
        """(status, json body) for one inference payload, shared by the
        HTTP handler and in-process callers."""
        if self.draining:
            self.metrics.rejected_draining.inc()
            return 503, {"error": "draining"}
        try:
            feeds = self._parse_inputs(payload)
            batch = self.engine.batch_size(feeds)
            outs = self.batcher.submit_and_wait(
                feeds, timeout_ms=payload.get("timeout_ms"))
            outputs = {name: _jsonable(val) for name, val in
                       zip(self.engine.fetch_names, outs)}
            return 200, {"outputs": outputs, "batch": batch}
        except QueueFullError as exc:
            return 429, {"error": str(exc)}
        except DeadlineExceededError as exc:
            return 504, {"error": str(exc)}
        except ShuttingDownError as exc:
            return 503, {"error": str(exc)}
        except (ValueError, KeyError, TypeError) as exc:
            return 400, {"error": str(exc)}
        except Exception as exc:  # noqa: BLE001 — must answer
            return 500, {"error": "%s: %s" % (type(exc).__name__, exc)}
