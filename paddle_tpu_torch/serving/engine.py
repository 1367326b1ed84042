"""Inference engine: a pruned program behind bucket-padded batches.

Counterpart of paddle_tpu/serving/engine.py.  Every batch pads up to a
configured batch bucket and the fetches are sliced back to the true
batch, so the set of shapes the card sees is small and known in
advance, and `warmup()` runs each of them once at start-up.  A ragged
(LoD) feed, given as a list of per-sequence arrays or as a
RaggedTensor, pads to the batch bucket with one-row zero sequences and
its flat rows to a multiple of `token_bucket`, as DataFeeder pads them;
a ragged fetch comes back as a host RaggedTensor of the true batch's
sequences.  On the JAX side a bucket's first run is an XLA compile;
here it is the first run of that shape (allocator growth, kernel build
and library load), and the `serving_compile_cache_*` counters count a
bucket's first run as its miss.  With `check_numerics` the fetched
outputs are scanned for NaN/Inf on the host (`obs.health.scan_outputs`);
a failing run reaches `obs.flight.on_crash` before it propagates.  Each
`run` passes the `serving/run` fault point (resilience/faults.py).
"""

import threading
import time

import numpy as np
import torch

from ..core.ragged import (RaggedTensor, ragged_to_sequences,
                           slice_ragged)
from ..core.scope import Scope, global_scope
from ..core.types import np_dtype
from ..fluid import executor as executor_mod
from ..fluid import io as fluid_io
from ..fluid.data_feeder import DEFAULT_RAGGED_BUCKET
from ..obs import flight as obs_flight
from ..obs import health as obs_health
from ..obs import trace as obs_trace
from ..resilience import faults as faults_mod

__all__ = ["EngineConfig", "InferenceEngine", "DEFAULT_BATCH_BUCKETS",
           "slice_ragged"]

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


class EngineConfig:
    """batch_buckets: ascending batch sizes to pad up to; None disables
    padding (exact-shape execution).  Batches beyond the largest bucket
    round up to a multiple of it.
    token_bucket: the multiple a ragged feed's flat rows pad up to.
    warmup_ragged: whether `warmup()` runs a program with ragged feeds
    (each batch bucket once, with one-row sequences).
    check_numerics: scan the fetched outputs for NaN/Inf on the host
    after each run, feeding `numerics_nonfinite_total{tensor=}` (the
    /healthz nonfinite signal).  Off by default: one host pass over the
    outputs, which the JSON path reads again anyway."""

    def __init__(self, batch_buckets=DEFAULT_BATCH_BUCKETS,
                 token_bucket=DEFAULT_RAGGED_BUCKET, warmup_ragged=True,
                 check_numerics=False):
        if batch_buckets is not None:
            batch_buckets = tuple(sorted(set(int(b) for b in
                                             batch_buckets)))
            if not batch_buckets or batch_buckets[0] < 1:
                raise ValueError("batch_buckets must be positive ints")
        self.batch_buckets = batch_buckets
        self.token_bucket = int(token_bucket)
        self.warmup_ragged = bool(warmup_ragged)
        self.check_numerics = bool(check_numerics)

    def bucket_for(self, batch):
        """Smallest configured bucket >= batch (multiples of the largest
        bucket beyond it)."""
        if self.batch_buckets is None:
            return batch
        for b in self.batch_buckets:
            if batch <= b:
                return b
        top = self.batch_buckets[-1]
        return -(-batch // top) * top


class InferenceEngine:
    """A pruned inference program (ProgramDesc, fetches by var name)
    wrapped into a bucket-padded callable with its own executor.

    Feeds accepted by `run()` (all batch-major): dense numpy arrays or
    tensors `[B, ...]`; ragged ones as a list of per-sequence arrays or
    a lod-level-1 RaggedTensor (rebucketed while padding is on).
    Returns the fetches sliced back to the true batch: dense ones as
    numpy arrays, ragged ones as host RaggedTensors of B sequences;
    fetches without a batch-major leading dim pass through.  The place
    defaults to CUDAPlace(0), which raises RuntimeError when no CUDA
    device is present."""

    def __init__(self, program, feed_names, fetch_list, place=None,
                 config=None, scope=None, metrics=None, feed_meta=None):
        self.program = program
        self.feed_names = list(feed_names)
        # Variables or names, as on the JAX side
        self.fetch_names = [getattr(f, "name", f) for f in fetch_list]
        self.place = place if place is not None \
            else executor_mod.CUDAPlace(0)
        self.config = config or EngineConfig()
        # scope=None reads the *current* global scope at each run; pass
        # an explicit Scope for an isolated parameter store
        # (from_saved_model does)
        self.scope = scope
        self.metrics = metrics
        self._exe = executor_mod.Executor(self.place)
        self._lock = threading.Lock()
        self._seen_buckets = set()
        self.last_warmup_stats = None
        exported = feed_meta or {}
        self._feed_meta = {}
        for n in self.feed_names:
            m = exported.get(n)
            if m and m.get("dtype"):
                self._feed_meta[n] = {
                    "shape": list(m["shape"]),
                    "dtype": np.dtype(m["dtype"]),
                    "lod_level": int(m["lod_level"])}
            else:
                self._feed_meta[n] = self._var_meta(n)

    @classmethod
    def from_saved_model(cls, dirname, place=None, config=None,
                         metrics=None, model_filename="__model__"):
        """Load a `save_inference_model` export (from either package)
        into a fresh scope on `place` (default CUDAPlace(0)).  Bucket
        hints recorded at export time seed the config unless the caller
        passes one."""
        place = place if place is not None else executor_mod.CUDAPlace(0)
        scope = Scope()
        exe = executor_mod.Executor(place)
        with executor_mod.scope_guard(scope):
            program, feed_names, fetch_names, extra = \
                fluid_io.load_inference_model(
                    dirname, exe, model_filename=model_filename,
                    return_meta=True)
        if config is None:
            hints = extra.get("bucket_hints") or {}
            config = EngineConfig(
                batch_buckets=hints.get("batch_buckets",
                                        DEFAULT_BATCH_BUCKETS),
                token_bucket=hints.get("token_bucket",
                                       DEFAULT_RAGGED_BUCKET))
        return cls(program, feed_names, fetch_names, place=place,
                   config=config, scope=scope, metrics=metrics,
                   feed_meta=extra.get("feed_meta"))

    def _var_meta(self, name):
        var = self.program.block(0).var(name)
        return {"shape": list(var.shape), "dtype": np_dtype(var.dtype),
                "lod_level": var.lod_level}

    # -- padding ------------------------------------------------------------
    @staticmethod
    def _batch_of(value):
        if isinstance(value, RaggedTensor):
            return value.nseq(0)
        if hasattr(value, "shape"):
            return int(value.shape[0])
        return len(value)

    def batch_size(self, feeds):
        sizes = {n: self._batch_of(feeds[n])
                 for n in self.feed_names if n in feeds}
        if not sizes:
            raise ValueError("feeds name none of %s" % self.feed_names)
        if len(set(sizes.values())) != 1:
            raise ValueError("inconsistent feed batch sizes: %r" % sizes)
        return next(iter(sizes.values()))

    @staticmethod
    def _pad_dense(arr, target):
        if arr.shape[0] == target:
            return arr
        pad = np.zeros((target - arr.shape[0],) + arr.shape[1:], arr.dtype)
        return np.concatenate([arr, pad], axis=0)

    def _pad_ragged(self, value, target, dtype):
        """A RaggedTensor of `value`'s sequences and, up to `target`,
        one-row zero sequences (not empty ones: pooling divides by a
        length), its flat rows padded to a multiple of token_bucket."""
        seqs = (ragged_to_sequences(value)
                if isinstance(value, RaggedTensor) else
                [np.asarray(s, dtype=dtype) for s in value])
        trailing = seqs[0].shape[1:] if seqs else ()
        seqs = [s.astype(dtype, copy=False) for s in seqs] + [
            np.zeros((1,) + tuple(trailing), dtype)
            for _ in range(target - len(seqs))]
        return RaggedTensor.from_sequences(
            seqs, dtype=dtype, bucket=self.config.token_bucket)

    def pad_feeds(self, feeds, true_batch=None):
        """Pad every feed up to the bucket for `true_batch`; returns
        (padded_feed_dict, true_batch, bucket)."""
        if true_batch is None:
            true_batch = self.batch_size(feeds)
        bucket = self.config.bucket_for(true_batch)
        padded = {}
        for name in self.feed_names:
            if name not in feeds:
                raise KeyError("missing feed %r (program expects %s)"
                               % (name, self.feed_names))
            value = feeds[name]
            meta = self._feed_meta[name]
            ragged = meta["lod_level"] > 0 or isinstance(
                value, (RaggedTensor, list, tuple))
            if self.config.batch_buckets is None:
                # exact shapes; a list of sequences still becomes ragged
                if isinstance(value, (list, tuple)):
                    value = self._pad_ragged(value, len(value),
                                             meta["dtype"])
                padded[name] = value
            elif ragged:
                padded[name] = self._pad_ragged(value, bucket,
                                                meta["dtype"])
            else:
                padded[name] = self._pad_dense(
                    np.asarray(value, dtype=meta["dtype"]), bucket)
        return padded, true_batch, bucket

    @staticmethod
    def _slice_fetch(value, true_batch, bucket):
        if isinstance(value, RaggedTensor):
            n = value.nseq(0)
            return slice_ragged(value, true_batch if n == bucket else n)
        arr = executor_mod.fetch_to_host(value)
        if arr.ndim and arr.shape[0] == bucket and true_batch < bucket:
            return arr[:true_batch]
        return arr

    # -- execution ----------------------------------------------------------
    def run(self, feeds, timings=None):
        """Pad, execute, slice.  `timings`, when given, receives pad and
        compute seconds, whether this was the bucket's first run, and
        the bucket."""
        # chaos hook: an injected transient IOError or latency on the
        # request path (one None check when no fault plan is active)
        faults_mod.check("serving/run")
        with self._lock, obs_trace.span("serving/engine_run",
                                        cat="serving") as run_span:
            t0 = time.perf_counter()
            padded, true_batch, bucket = self.pad_feeds(feeds)
            t1 = time.perf_counter()
            scope = self.scope if self.scope is not None else global_scope()
            try:
                outs = self._exe.run(self.program, feed=padded,
                                     fetch_list=self.fetch_names,
                                     scope=scope, return_numpy=False)
                if self._exe.device.type == "cuda":
                    torch.cuda.synchronize(self._exe.device)
            except Exception as exc:
                obs_flight.on_crash(exc, origin="serving/engine",
                                    batch=true_batch, bucket=bucket)
                raise
            t2 = time.perf_counter()
            first = bucket not in self._seen_buckets
            self._seen_buckets.add(bucket)
            run_span.set(batch=true_batch, bucket=bucket, compiled=first)
        if self.metrics is not None:
            (self.metrics.cache_miss_total if first
             else self.metrics.cache_hit_total).inc()
            self.metrics.observe_stage("pad", t1 - t0)
            self.metrics.observe_stage("compute", t2 - t1)
        if timings is not None:
            timings.update(pad=t1 - t0, compute=t2 - t1, compiled=first,
                           bucket=bucket)
        sliced = [self._slice_fetch(o, true_batch, bucket) for o in outs]
        if self.config.check_numerics:
            obs_health.scan_outputs(zip(self.fetch_names, sliced))
        return sliced

    # -- warmup -------------------------------------------------------------
    @staticmethod
    def _synthetic_feed(meta, batch):
        """Zeros of one bucket's feed shape; for a ragged feed, `batch`
        one-row sequences of the row shape (the non-negative dims).

        A feed whose exported shape has a negative dim (fluid's
        append_batch_size=True gives [-1, ...]) keeps its non-negative
        dims as the per-sample shape, as on the JAX side.  A shape with
        no negative dim was declared batch-major with
        append_batch_size=False, e.g. the transformer's
        `tokens [batch, seq_len]`: its leading dim is the batch and is
        replaced by the bucket.  This differs from the JAX side
        (paddle_tpu/serving/engine.py `_synthetic_feed`), which puts a
        second batch dim in front of such a shape, so its warmup fails
        on the transformer export."""
        shape = list(meta["shape"])
        if meta["lod_level"] > 0:
            row = tuple(s for s in shape if s >= 0)
            return [np.zeros((1,) + row, meta["dtype"])
                    for _ in range(batch)]
        if any(s < 0 for s in shape):
            sample = tuple(s for s in shape if s >= 0)
        else:
            sample = tuple(shape[1:])
        return np.zeros((batch,) + sample, meta["dtype"])

    def warmup(self):
        """Run every batch bucket once with synthetic zero feeds, so no
        in-bucket request is a bucket's first run.  Returns the number
        of buckets warmed; `last_warmup_stats` records buckets and
        seconds.  A program with a ragged feed warms only with
        `warmup_ragged`."""
        if self.config.batch_buckets is None:
            return 0
        if not self.config.warmup_ragged and any(
                m["lod_level"] > 0 for m in self._feed_meta.values()):
            return 0
        # warmup is start-up cost, not traffic: keep it out of the
        # request-path histograms and hit/miss counters
        saved_metrics, self.metrics = self.metrics, None
        t0 = time.perf_counter()
        try:
            for bucket in self.config.batch_buckets:
                self.run({n: self._synthetic_feed(m, bucket)
                          for n, m in self._feed_meta.items()})
        finally:
            self.metrics = saved_metrics
        self.last_warmup_stats = {
            "buckets": len(self.config.batch_buckets),
            "seconds": time.perf_counter() - t0}
        return len(self.config.batch_buckets)
