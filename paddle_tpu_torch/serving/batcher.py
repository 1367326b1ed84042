"""Dynamic micro-batcher: coalesce concurrent requests into one device
run, split the results back per request.

Counterpart of paddle_tpu/serving/batcher.py.  Ragged (LoD) requests
of different lengths merge into one list of sequences (the engine pads
it), and a ragged fetch splits back into each request's sequences.  One
consumer thread drains a bounded admission queue: it takes the first
waiting request, then gathers until `max_batch` rows are assembled or
`max_wait_ms` has passed since the first.  A request whose deadline has
passed is completed with `DeadlineExceededError` instead of taking a
device slot; a full queue rejects at submit (`QueueFullError`, HTTP
429); `close()` drains what was admitted before the thread exits.
Each request carries its trace context (`obs.context`) across the queue
hop, and the worker records the batch's stages (queue wait, assembly,
pad, device run, split) into every co-batched request's span tree.
"""

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from ..core.ragged import RaggedTensor, ragged_to_sequences
from ..obs import context as obs_context
from ..obs import trace as obs_trace

__all__ = ["BatcherConfig", "MicroBatcher", "ServingError",
           "QueueFullError", "DeadlineExceededError",
           "ShuttingDownError"]


class ServingError(Exception):
    """Base class for request-rejection errors (each maps to an HTTP
    status in server.py)."""


class QueueFullError(ServingError):
    pass


class DeadlineExceededError(ServingError):
    pass


class ShuttingDownError(ServingError):
    pass


class BatcherConfig:
    """max_batch: sample-row budget per device run (a bigger request
    still runs, alone).  max_wait_ms: how long the first request of a
    batch may wait for company.  queue_size: admission-queue bound.
    default_timeout_ms: deadline for requests that carry none (None =
    no deadline)."""

    def __init__(self, max_batch=32, max_wait_ms=5.0, queue_size=64,
                 default_timeout_ms=None):
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.queue_size = int(queue_size)
        self.default_timeout_ms = default_timeout_ms


class _Request:
    __slots__ = ("feeds", "batch", "deadline", "future", "submitted",
                 "submitted_wall", "ctx")

    def __init__(self, feeds, batch, deadline, ctx=None):
        self.feeds = feeds
        self.batch = batch
        self.deadline = deadline
        # the request's trace context rides the queue hop WITH the
        # request, so the worker's stage records land in its tree
        self.ctx = ctx
        self.future = Future()
        self.submitted = time.monotonic()
        self.submitted_wall = time.time()

    def expired(self, now=None):
        return (self.deadline is not None
                and (now or time.monotonic()) > self.deadline)


_POISON = object()


class MicroBatcher:
    def __init__(self, engine, config=None, metrics=None):
        self.engine = engine
        self.config = config or BatcherConfig()
        self.metrics = metrics
        self._queue = queue.Queue(maxsize=self.config.queue_size)
        self._carry = None  # request that did not fit the last batch
        self._draining = False
        self._thread = None
        self._lock = threading.Lock()

    # -- client side --------------------------------------------------------
    def start(self):
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._worker, name="micro-batcher", daemon=True)
                self._thread.start()
        return self

    def submit(self, feeds, timeout_ms=None, ctx=None):
        """Enqueue one request; returns a Future resolving to its fetch
        list.  Raises instead of queueing when draining or full.  `ctx`
        (a TraceContext; default: the thread's current one) is carried
        to the worker, which records its stages into it."""
        if self._draining:
            if self.metrics:
                self.metrics.rejected_draining.inc()
            raise ShuttingDownError("server is draining")
        batch = self.engine.batch_size(feeds)
        if timeout_ms is None:
            timeout_ms = self.config.default_timeout_ms
        deadline = (time.monotonic() + float(timeout_ms) / 1000.0
                    if timeout_ms is not None else None)
        if ctx is None:
            ctx = obs_context.current()
        req = _Request(feeds, batch, deadline, ctx=ctx)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            if self.metrics:
                self.metrics.rejected_queue_full.inc()
                self.metrics.note_queue_depth(self._queue.qsize())
            raise QueueFullError("admission queue full (%d waiting)"
                                 % self.config.queue_size)
        if self.metrics:
            self.metrics.requests_total.inc()
            self.metrics.note_queue_depth(self._queue.qsize())
        return req.future

    def submit_and_wait(self, feeds, timeout_ms=None, ctx=None):
        fut = self.submit(feeds, timeout_ms=timeout_ms, ctx=ctx)
        # a backstop over the request deadline; the worker completes
        # expired requests itself
        wait = (float(timeout_ms) / 1000.0 + 30.0
                if timeout_ms is not None else None)
        return fut.result(timeout=wait)

    def close(self, timeout=30.0):
        """Stop admitting, finish everything already admitted, join the
        worker."""
        self._draining = True
        if self._thread is None:
            return
        self._queue.put(_POISON)
        self._thread.join(timeout=timeout)
        # a submit() that passed the draining check but enqueued after
        # the worker exited would hang its client: fail stragglers
        leftovers = [self._carry] if self._carry is not None else []
        self._carry = None
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _POISON:
                leftovers.append(item)
        for req in leftovers:
            if not req.future.done():
                if self.metrics:
                    self.metrics.rejected_draining.inc()
                req.future.set_exception(
                    ShuttingDownError("server is draining"))

    # -- worker side --------------------------------------------------------
    def _take(self, block_s):
        """One request from carry-over or the queue; None on timeout or
        empty, _POISON on shutdown.  block_s: None blocks, 0 does not,
        > 0 is a timeout."""
        if self._carry is not None:
            req, self._carry = self._carry, None
            return req
        try:
            if block_s is None:
                item = self._queue.get()
            elif block_s <= 0:
                item = self._queue.get_nowait()
            else:
                item = self._queue.get(timeout=block_s)
        except queue.Empty:
            return None
        if self.metrics:
            self.metrics.note_queue_depth(self._queue.qsize())
        return item

    def _assemble(self, first):
        """Gather up to max_batch rows, waiting at most max_wait_ms past
        the first request."""
        batch = [first]
        rows = first.batch
        wait_until = time.monotonic() + self.config.max_wait_ms / 1000.0
        stop = False
        while rows < self.config.max_batch:
            remaining = wait_until - time.monotonic()
            if remaining <= 0:
                break
            nxt = self._take(remaining)
            if nxt is None:
                break
            if nxt is _POISON:
                stop = True
                break
            if rows + nxt.batch > self.config.max_batch:
                self._carry = nxt
                break
            batch.append(nxt)
            rows += nxt.batch
        return batch, rows, stop

    def _worker(self):
        stop = False
        while True:
            first = self._take(0.0 if stop else None)
            if first is None:
                if stop:
                    return
                continue
            if first is _POISON:
                stop = True
                continue
            group, rows, saw_poison = self._assemble(first)
            stop = stop or saw_poison
            self._run_batch(group)
            if stop and self._carry is None and self._queue.empty():
                return

    def _merge_feeds(self, group):
        """One feed dict of the group's requests in order: dense feeds
        concatenated, ragged ones (lists of sequences or RaggedTensors)
        as one list of every request's sequences."""
        merged = {}
        for name in self.engine.feed_names:
            meta = self.engine._feed_meta[name]
            parts = [req.feeds[name] for req in group]
            if meta["lod_level"] > 0 or any(
                    isinstance(p, (RaggedTensor, list, tuple))
                    for p in parts):
                merged[name] = [
                    s for p in parts
                    for s in (ragged_to_sequences(p)
                              if isinstance(p, RaggedTensor) else
                              [np.asarray(x, meta["dtype"]) for x in p])]
            else:
                merged[name] = np.concatenate(
                    [np.asarray(p, meta["dtype"]) for p in parts], axis=0)
        return merged

    @staticmethod
    def _split_fetch(value, offsets, group):
        """Per-request views of one engine fetch value: a ragged fetch
        as a RaggedTensor of each request's sequences."""
        if isinstance(value, RaggedTensor):
            seqs = ragged_to_sequences(value)
            return [RaggedTensor.from_sequences(seqs[off:off + req.batch])
                    if req.batch else None
                    for req, off in zip(group, offsets)]
        total = offsets[-1] + group[-1].batch
        if value.ndim and value.shape[0] == total:
            return [value[off:off + req.batch]
                    for req, off in zip(group, offsets)]
        # not batch-major (scalar summaries): every request gets it
        return [value for _ in group]

    @staticmethod
    def _record_stages(live, now_wall, assemble_s, split_s, timings,
                       rows):
        """Attribute the batch-level stage timings (measured once) to
        every co-batched request's span tree: queue wait, batch
        assembly, pad/bucket, device run, split."""
        pad_s = timings.get("pad", 0.0)
        compute_s = timings.get("compute", 0.0)
        # reconstruct wall starts backwards from the post-split clock
        t_split0 = now_wall - split_s
        t_exec0 = t_split0 - compute_s
        t_pad0 = t_exec0 - pad_s
        t_asm0 = t_pad0 - assemble_s
        for req in live:
            ctx = req.ctx
            if ctx is None:
                continue
            ctx.record("serving/queue_wait", req.submitted_wall,
                       max(0.0, t_asm0 - req.submitted_wall))
            ctx.record("serving/batch_assemble", t_asm0, assemble_s,
                       args={"occupancy": len(live), "rows": rows})
            ctx.record("serving/pad_bucket", t_pad0, pad_s,
                       args={"bucket": timings.get("bucket")})
            ctx.record("serving/device_execute", t_exec0, compute_s,
                       args={"compiled": timings.get("compiled")})
            ctx.record("serving/split_serialize", t_split0, split_s)

    def _run_batch(self, group):
        now = time.monotonic()
        live = []
        for req in group:
            if req.expired(now):
                if self.metrics:
                    self.metrics.rejected_deadline.inc()
                req.future.set_exception(DeadlineExceededError(
                    "deadline expired after %.0f ms in queue"
                    % ((now - req.submitted) * 1000.0)))
            else:
                live.append(req)
        if not live:
            return
        rows = sum(r.batch for r in live)
        if self.metrics:
            for req in live:
                self.metrics.observe_stage("queue", now - req.submitted)
            self.metrics.batch_occupancy.observe(len(live))
            self.metrics.batch_rows.observe(rows)
            self.metrics.inflight.inc()
        try:
            timings = {}
            with obs_trace.span("serving/batch", cat="serving",
                                occupancy=len(live), rows=rows):
                t0 = time.perf_counter()
                merged = self._merge_feeds(live)
                t1 = time.perf_counter()
                outs = self.engine.run(merged, timings=timings)
            t2 = time.perf_counter()
            offsets = np.cumsum([0] + [r.batch for r in live])[:-1]
            per_fetch = [self._split_fetch(o, offsets, live) for o in outs]
            self._record_stages(live, time.time(), t1 - t0,
                                time.perf_counter() - t2, timings, rows)
            for i, req in enumerate(live):
                req.future.set_result([pf[i] for pf in per_fetch])
                if self.metrics:
                    self.metrics.responses_total.inc()
                    # the exemplar links this latency bucket to the
                    # request's trace in /metrics
                    self.metrics.observe_stage(
                        "total", time.monotonic() - req.submitted,
                        exemplar=req.ctx.trace_id if req.ctx else None)
        # fail the requests, not the server
        except Exception as exc:  # noqa: BLE001
            if self.metrics:
                self.metrics.errors_total.inc(len(live))
            for req in live:
                if not req.future.done():
                    req.future.set_exception(exc)
        finally:
            if self.metrics:
                self.metrics.inflight.dec()
