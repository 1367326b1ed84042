"""Feed prefetching: prepare the next batches while the step runs.

Counterpart of paddle_tpu/reader/prefetch.py (reference:
paddle/gserver/dataproviders/DataProvider.h DoubleBuffer).
`host_prefetch` runs a reader on a daemon thread `depth` items ahead of
the consumer.  `device_prefetch` also moves each batch to the place's
device on that thread.

On a CUDA place the worker runs the reader under a side stream of its
own, so the copies it makes (its own, and those of a `DataFeeder.feed`
called inside the reader) overlap the steps on the consumer's stream.
Numpy arrays go through pinned host memory with non-blocking copies;
the caching host allocator keeps a pinned block from reuse until the
copy that reads it has finished.  Each batch carries an event recorded
on the side stream after its copies: before the consumer sees the
batch, its current stream waits on that event, and every tensor of the
batch is recorded on that stream, so the side stream's allocator does
not hand the memory out again while a step still reads it.  int64
arrays stay on the host, as on the JAX side: the executor narrows them
to int32 after its overflow check.  A RaggedTensor or SelectedRows
passes as it is, as on the JAX side: the executor moves it.
"""

import queue
import threading

import numpy as np
import torch

from ..core.types import tensor_from_numpy
from ..resilience import faults as faults_mod

__all__ = ["device_prefetch", "host_prefetch"]

_END = object()


class _Failure:
    def __init__(self, exc):
        self.exc = exc


def _pump(reader_fn, q, transform, stop):
    def offer(item):
        # a bounded put that gives up once the consumer abandoned the
        # generator, instead of blocking here forever
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    try:
        for item in reader_fn():
            faults_mod.check("reader/pump")
            if not offer(transform(item) if transform else item):
                return
        offer(_END)
    except BaseException as e:  # re-raised on the consumer side
        offer(_Failure(e))


def _prefetched(reader, depth, transform, pump=_pump, receive=None):
    def prefetched():
        q = queue.Queue(maxsize=depth)
        stop = threading.Event()
        t = threading.Thread(target=pump, args=(reader, q, transform, stop),
                             daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, _Failure):
                    raise item.exc
                yield receive(item) if receive is not None else item
        finally:
            stop.set()
            while True:  # unblock a pending put and free its payload
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5)

    return prefetched


def host_prefetch(reader, depth=2, transform=None):
    """A reader whose items a background thread prepares `depth` ahead
    (`transform` applied there).  Abandoning the iterator early stops
    the worker and drops the buffered items."""
    return _prefetched(reader, depth, transform)


def _map_batch(fn, batch):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(fn(v) for v in batch)
    return fn(batch)


def _tensors(batch):
    if isinstance(batch, dict):
        batch = batch.values()
    elif not isinstance(batch, (list, tuple)):
        batch = [batch]
    return [t for t in batch if isinstance(t, torch.Tensor)]


def device_prefetch(reader, place=None, depth=2):
    """`host_prefetch` that also moves each batch (a dict of arrays, the
    executor's feed, or a tuple or list of them) to `place`'s device on
    the worker thread; default place CUDAPlace(0).  Tensors already on
    the device, int64 arrays, RaggedTensors and SelectedRows pass as
    they are, and so does anything that is not an array."""
    if place is None:
        from ..fluid.executor import CUDAPlace

        place = CUDAPlace(0)
    device = place.device()

    def put(x):
        if isinstance(x, torch.Tensor):
            return x.to(device, non_blocking=True)
        try:
            arr = np.asarray(x)
        except (TypeError, ValueError):
            return x
        if arr.dtype == np.int64 or arr.dtype.kind not in "biuf":
            return x
        if device.type != "cuda":
            return tensor_from_numpy(arr, device)
        return tensor_from_numpy(arr, "cpu").pin_memory().to(
            device, non_blocking=True)

    if device.type != "cuda":
        return _prefetched(reader, depth, lambda b: _map_batch(put, b))

    side = torch.cuda.Stream(device)

    def pump(reader_fn, q, transform, stop):
        def on_side():
            for item in reader_fn():
                item = _map_batch(put, item)
                done = torch.cuda.Event()
                done.record(side)
                yield item, done

        with torch.cuda.device(device), torch.cuda.stream(side):
            _pump(on_side, q, None, stop)

    def receive(item):
        batch, done = item
        current = torch.cuda.current_stream(device)
        current.wait_event(done)
        for t in _tensors(batch):
            if t.device == device:
                t.record_stream(current)
        return batch

    return _prefetched(reader, depth, None, pump=pump, receive=receive)
