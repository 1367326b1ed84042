"""Composable reader decorators.

Counterpart of paddle_tpu/reader/decorator.py (reference:
python/paddle/v2/reader/decorator.py, minibatch.py), pure Python and
the same code: a "reader" is a zero-argument callable returning an
iterable of samples.  The synchronous decorators compose generators;
the threaded ones (`buffered`, `xmap_readers`) run queue-fed stages on
daemon threads whose failures re-raise in the consumer.  `shuffle`
draws from Python's `random` module, so a `random.seed` makes both
packages shuffle alike.
"""

import heapq
import itertools
import random
import threading
from queue import Queue

__all__ = ["map_readers", "buffered", "compose", "chain", "shuffle",
           "firstn", "xmap_readers", "cache", "batch"]

# unique end-of-stream marker for queue-based stages (identity compare)
_STOP = object()


class _Failure:
    """An exception captured in a pipeline stage, to be re-raised in
    the consumer (a dead daemon thread would otherwise leave the
    consumer blocked on q.get() forever, with no traceback)."""

    def __init__(self, exc):
        self.exc = exc


def _spawn_stage(target, *args, fail_q):
    """Run `target(*args)` on a daemon thread (a pipeline stage);
    failures are forwarded to `fail_q`, the queue the consumer drains."""

    def guarded():
        try:
            target(*args)
        except BaseException as exc:  # noqa: BLE001 — forwarded, not dropped
            fail_q.put(_Failure(exc))

    t = threading.Thread(target=guarded, daemon=True)
    t.start()
    return t


def _drain(q):
    """Yield items from queue `q` until the _STOP marker arrives;
    re-raise any stage failure here, in the consuming thread."""
    while True:
        item = q.get()
        if item is _STOP:
            return
        if isinstance(item, _Failure):
            raise item.exc
        yield item


def map_readers(func, *readers):
    """Reader yielding func(a, b, ...) over parallel-zipped readers."""

    def mapped():
        return map(func, *(r() for r in readers))

    return mapped


def shuffle(reader, buf_size):
    """Shuffle within a sliding window of `buf_size` samples."""

    def shuffled():
        window = []
        for sample in reader():
            window.append(sample)
            if len(window) >= buf_size:
                random.shuffle(window)
                yield from window
                window.clear()
        random.shuffle(window)
        yield from window

    return shuffled


def chain(*readers):
    """Concatenate readers end to end."""

    def chained():
        return itertools.chain.from_iterable(r() for r in readers)

    return chained


class ComposeNotAligned(ValueError):
    """Raised when composed readers yield different sample counts."""


def compose(*readers, **kwargs):
    """Zip readers into flat tuples: (a, (b, c)) -> (a, b, c).

    With check_alignment (default), unequal lengths raise
    ComposeNotAligned; otherwise the longest-exhausted prefix is used.
    """
    check_alignment = kwargs.pop("check_alignment", True)

    def as_tuple(sample):
        return sample if isinstance(sample, tuple) else (sample,)

    def composed():
        iters = [r() for r in readers]
        if check_alignment:
            rows = itertools.zip_longest(*iters, fillvalue=_STOP)
        else:
            rows = zip(*iters)
        for row in rows:
            # identity check: samples may be numpy arrays, where ==
            # broadcasts and `in` would raise
            if any(s is _STOP for s in row):
                raise ComposeNotAligned(
                    "outputs of readers are not aligned")
            yield tuple(itertools.chain.from_iterable(map(as_tuple, row)))

    return composed


def buffered(reader, size):
    """Decouple production from consumption via a bounded queue."""

    def produce(src, q):
        for sample in src:
            q.put(sample)
        q.put(_STOP)

    def buffered_reader():
        q = Queue(maxsize=size)
        _spawn_stage(produce, reader(), q, fail_q=q)
        yield from _drain(q)

    return buffered_reader


def firstn(reader, n):
    """Truncate a reader to its first n samples."""

    def truncated():
        return itertools.islice(reader(), n)

    return truncated


def cache(reader):
    """Materialize the reader once; replay from memory thereafter."""
    samples = tuple(reader())

    def replay():
        return iter(samples)

    return replay


class _OrderedEmitter:
    """Re-serialize (seq, value) pairs from racing workers.

    Workers hand results in any order; emit() releases them to the
    output queue strictly by sequence number, parking early arrivals
    in a heap.  A worker that has raced more than `bound` results
    ahead of the release point blocks until the head of line moves —
    without this, one slow sample would let the heap buffer the whole
    mapped dataset (the bounded queues give no backpressure while the
    output queue stays empty)."""

    def __init__(self, out_queue, bound):
        self._out = out_queue
        self._bound = max(int(bound), 1)
        self._next = 0
        self._parked = []
        self._cv = threading.Condition()

    def emit(self, seq, value):
        with self._cv:
            # the worker holding the next-needed seq never waits
            while seq - self._next >= self._bound and seq != self._next:
                self._cv.wait()
            heapq.heappush(self._parked, (seq, value))
            released = False
            while self._parked and self._parked[0][0] == self._next:
                _, ready = heapq.heappop(self._parked)
                self._out.put(ready)
                self._next += 1
                released = True
            if released:
                self._cv.notify_all()


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Apply `mapper` to samples on `process_num` worker threads.

    With order=True, output order matches input order (at the cost of
    head-of-line buffering); otherwise results stream as completed.
    """

    def feed(src, in_q):
        for seq, sample in enumerate(src):
            in_q.put((seq, sample))
        for _ in range(process_num):
            in_q.put(_STOP)  # one stop marker per worker

    def work(in_q, out_q, emitter, done):
        for seq, sample in _drain(in_q):
            result = mapper(sample)
            if emitter is not None:
                emitter.emit(seq, result)
            else:
                out_q.put(result)
        with done["lock"]:
            done["count"] += 1
            if done["count"] == process_num:
                out_q.put(_STOP)

    def xmapped():
        in_q = Queue(buffer_size)
        out_q = Queue(buffer_size)
        emitter = _OrderedEmitter(out_q, buffer_size) if order else None
        done = {"lock": threading.Lock(), "count": 0}
        # failures (reader or mapper) surface on out_q: the consumer
        # re-raises; remaining daemon workers are abandoned
        _spawn_stage(feed, reader(), in_q, fail_q=out_q)
        for _ in range(process_num):
            _spawn_stage(work, in_q, out_q, emitter, done, fail_q=out_q)
        yield from _drain(out_q)

    return xmapped


def batch(reader, batch_size, drop_last=True):
    """Group samples into lists of `batch_size`.

    drop_last defaults True, as on the JAX side, where a short tail
    batch changes the feed's shape and costs a compile.
    """

    def batched():
        it = iter(reader())
        while True:
            group = list(itertools.islice(it, batch_size))
            if len(group) == batch_size:
                yield group
            else:
                if group and not drop_last:
                    yield group
                return

    return batched
