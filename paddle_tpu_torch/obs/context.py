"""Request-scoped trace context: W3C-traceparent ids + a per-request
span recorder (a copy of paddle_tpu/obs/context.py).

The span tracer (`obs.trace`) answers "where did THIS PROCESS's wall
time go"; production serving needs the orthogonal question — "where
did THIS REQUEST's latency go" — answered per request, across the
thread hop from the HTTP handler into the micro-batcher's worker.
This module carries exactly that:

  * `TraceContext` — a `trace_id`/`span_id` pair in the W3C trace
    context format (`00-<32 hex>-<16 hex>-<flags>`, parsed from /
    rendered to a `traceparent` header) plus a minted `request_id`,
    and a bounded, lock-protected list of span records.  The context
    object travels WITH the request (the batcher's `_Request` carries
    it), so spans recorded on the worker thread land in the right
    request's tree no matter how requests interleave.
  * a thread-local *current* context (`current()` / `use(ctx)`), so
    layers that can't be handed the object explicitly (the flight
    recorder's crash path, the executor under a request) can still
    name the request they were serving.
  * `span(name)` — a context manager that times a region into BOTH
    sinks: the current request's span list (always, when a context is
    bound) and the global `obs.trace` buffer (when tracing is
    enabled), with `trace_id`/`span_id` stamped into the trace-event
    args so a Perfetto timeline links back to the request.  Nesting on
    one thread parents spans automatically; cross-thread stages record
    against the request's root span via `TraceContext.record`.

A request's finished tree is rendered by `span_tree()`; the tail
recorder (`obs.tail`) keeps whole trees for slow/errored requests and
`Histogram.observe(..., exemplar=...)` links latency buckets to
trace ids in `/metrics`.
"""

import binascii
import os
import threading
import time

from . import trace as trace_mod

__all__ = ["TraceContext", "new_trace_id", "new_span_id",
           "from_traceparent", "new_context", "current", "use",
           "span", "record"]

TRACEPARENT_VERSION = "00"

_UNSET = object()   # record()'s "default the parent to the root" mark

_tls = threading.local()


def _rand_hex(nbytes):
    return binascii.hexlify(os.urandom(nbytes)).decode("ascii")


def new_trace_id():
    """32 lowercase hex chars (128-bit), never all-zero."""
    tid = _rand_hex(16)
    return tid if int(tid, 16) else new_trace_id()


def new_span_id():
    """16 lowercase hex chars (64-bit), never all-zero."""
    sid = _rand_hex(8)
    return sid if int(sid, 16) else new_span_id()


class TraceContext:
    """One request's identity + its recorded spans.

    `span_id` is the request's ROOT span; spans recorded through
    `record`/`span()` parent into it (or into each other via the
    thread-local nesting in `span()`).  The record list is bounded
    (`max_spans`); overflow increments `dropped_spans` instead of
    growing without limit — a pathological retry loop inside one
    request must not eat the heap."""

    __slots__ = ("trace_id", "span_id", "parent_span_id", "request_id",
                 "sampled", "max_spans", "dropped_spans", "_lock",
                 "_spans")

    def __init__(self, trace_id=None, span_id=None, parent_span_id=None,
                 request_id=None, sampled=True, max_spans=256):
        self.trace_id = (trace_id or new_trace_id()).lower()
        self.span_id = (span_id or new_span_id()).lower()
        self.parent_span_id = parent_span_id
        self.request_id = request_id or new_span_id()
        self.sampled = bool(sampled)
        self.max_spans = int(max_spans)
        self.dropped_spans = 0
        self._lock = threading.Lock()
        self._spans = []

    def traceparent(self):
        """The context as a W3C `traceparent` header value."""
        return "%s-%s-%s-%s" % (TRACEPARENT_VERSION, self.trace_id,
                                self.span_id,
                                "01" if self.sampled else "00")

    def ids(self):
        """{trace_id, span_id, request_id} — the identity block crash
        bundles and access-log lines embed."""
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "request_id": self.request_id}

    # -- span recording ------------------------------------------------------
    def record(self, name, t0_wall, dur_s, span_id=None,
               parent_span_id=_UNSET, cat="request", args=None):
        """Append one already-measured span record.  `t0_wall` is a
        time.time() start; by default the span parents under the
        request's root (pass parent_span_id=None to record a root —
        the server does for the request span itself).  Returns the
        span id used (so callers can parent further records under
        it)."""
        sid = span_id or new_span_id()
        rec = {"name": name, "cat": cat, "span_id": sid,
               "parent_span_id": (self.span_id
                                  if parent_span_id is _UNSET
                                  else parent_span_id),
               "ts": round(t0_wall, 6),
               "dur_ms": round(dur_s * 1e3, 3)}
        if args:
            rec["args"] = dict(args)
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped_spans += 1
            else:
                self._spans.append(rec)
        return sid

    def span_records(self):
        """Flat copy of the recorded spans (record dicts shared — do
        not mutate)."""
        with self._lock:
            return list(self._spans)

    def span_tree(self):
        """The records as a nested tree: a list of root nodes, each
        `{name, span_id, dur_ms, ts, [args,] children: [...]}`.  A span
        whose parent was dropped (bounded list) or recorded out of
        band roots itself rather than vanishing."""
        records = self.span_records()
        nodes = {}
        for rec in records:
            node = dict(rec)
            node["children"] = []
            nodes[rec["span_id"]] = node
        roots = []
        for rec in records:
            node = nodes[rec["span_id"]]
            parent = nodes.get(rec.get("parent_span_id"))
            if parent is not None and parent is not node:
                parent["children"].append(node)
            else:
                roots.append(node)
        for node in nodes.values():
            node["children"].sort(key=lambda n: n.get("ts", 0))
        roots.sort(key=lambda n: n.get("ts", 0))
        return roots

    def to_dict(self):
        """JSON-able summary: identity + the span tree (what the tail
        recorder stores per captured request)."""
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_span_id": self.parent_span_id,
                "request_id": self.request_id,
                "dropped_spans": self.dropped_spans,
                "spans": self.span_tree()}


def from_traceparent(header, request_id=None, max_spans=256):
    """Parse a W3C `traceparent` header into a TraceContext that
    CONTINUES the caller's trace: same trace_id, the header's span_id
    as parent, a fresh span_id for our server-side root.  Returns None
    for a malformed header (the caller mints a fresh context instead —
    a bad header must never fail the request)."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], \
        parts[3]
    # strict hex charset: int(x, 16) also accepts '_' and '+', which
    # would echo a non-W3C id into headers/exemplars downstream
    hexdigits = set("0123456789abcdef")
    for field in (version, trace_id, span_id, flags):
        if not field or not set(field) <= hexdigits:
            return None
    if len(version) != 2 or version == "ff":
        return None
    if len(trace_id) != 32 or int(trace_id, 16) == 0:
        return None
    if len(span_id) != 16 or int(span_id, 16) == 0:
        return None
    if len(flags) != 2:
        return None
    return TraceContext(trace_id=trace_id, parent_span_id=span_id,
                        request_id=request_id,
                        sampled=bool(int(flags, 16) & 1),
                        max_spans=max_spans)


def new_context(traceparent=None, request_id=None, max_spans=256):
    """A context for one incoming request: continue the caller's trace
    when a valid `traceparent` is given, mint a fresh one otherwise."""
    ctx = from_traceparent(traceparent, request_id=request_id,
                           max_spans=max_spans)
    if ctx is None:
        ctx = TraceContext(request_id=request_id, max_spans=max_spans)
    return ctx


# ---------------------------------------------------------------------------
# thread-local current context
# ---------------------------------------------------------------------------

def current():
    """The context bound to this thread (None outside a request)."""
    return getattr(_tls, "ctx", None)


class _Use:
    __slots__ = ("_ctx", "_prev", "_prev_sid")

    def __init__(self, ctx):
        self._ctx = ctx

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        self._prev_sid = getattr(_tls, "span_id", None)
        _tls.ctx = self._ctx
        _tls.span_id = None if self._ctx is None else self._ctx.span_id
        return self._ctx

    def __exit__(self, *exc):
        _tls.ctx = self._prev
        _tls.span_id = self._prev_sid
        return False


def use(ctx):
    """`with context.use(ctx): ...` — bind `ctx` as this thread's
    current context for the body (restores the previous binding on
    exit; `use(None)` masks any binding)."""
    return _Use(ctx)


# ---------------------------------------------------------------------------
# dual-sink spans
# ---------------------------------------------------------------------------

class _CtxSpan:
    """Times one region into the current request's span list and
    (when tracing is on) the global trace buffer, with request ids in
    the trace-event args."""

    __slots__ = ("name", "cat", "args", "_ctx", "_sid", "_parent",
                 "_t0", "_wall0", "_tspan")

    def __init__(self, name, cat, args):
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **args):
        if self.args is None:
            self.args = args
        else:
            self.args.update(args)
        return self

    def __enter__(self):
        self._ctx = current()
        if self._ctx is not None:
            self._sid = new_span_id()
            self._parent = getattr(_tls, "span_id", None) \
                or self._ctx.span_id
            _tls.span_id = self._sid
        self._tspan = None
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        ctx = self._ctx
        if ctx is not None:
            _tls.span_id = self._parent
            ctx.record(self.name, self._wall0, dur, span_id=self._sid,
                       parent_span_id=self._parent, cat=self.cat,
                       args=self.args)
        if trace_mod.is_enabled():
            targs = dict(self.args or ())
            if ctx is not None:
                targs.update(ctx.ids())
            trace_mod.emit_span(self.name, self._t0, dur,
                                cat=self.cat, args=targs or None)
        return False


def span(name, cat="request", **args):
    """Context manager timing one request-scoped region.  With no
    current context and tracing disabled the cost is one thread-local
    read + two clock reads — fine for the request path it lives on."""
    return _CtxSpan(name, cat, args or None)


def record(name, t0_wall, dur_s, ctx=None, parent_span_id=_UNSET,
           cat="request", args=None):
    """Record an already-measured region against `ctx` (or the current
    context).  Used by the batcher, which times batch-level stages
    once and attributes them to every co-batched request's tree.
    No-op (returns None) without a context."""
    ctx = ctx if ctx is not None else current()
    if ctx is None:
        return None
    return ctx.record(name, t0_wall, dur_s,
                      parent_span_id=parent_span_id, cat=cat, args=args)
