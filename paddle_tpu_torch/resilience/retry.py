"""Bounded retries with exponential backoff and full jitter.

Counterpart of paddle_tpu/resilience/retry.py `RetryPolicy`:

    policy = RetryPolicy(max_attempts=3, base_delay=0.05,
                         deadline=30.0, name="dataset_download")
    data = policy.call(fetch, url)

  * `max_attempts`    total tries (first call included).
  * `retryable`       exception classes (or a predicate) that trigger a
                      retry; anything else propagates at once.  The
                      default is an IOError, OSError, ConnectionError or
                      TimeoutError: ValueError, KeyError and friends are
                      bugs and are never retried.
  * `attempt_timeout` per-attempt wall budget: the attempt runs on a
                      daemon worker thread and overrunning it raises
                      `AttemptTimeout` (retryable: a hung RPC behaves
                      like a failed one).  The overrun thread is
                      abandoned, so use this only around I/O-bound
                      calls that cannot corrupt shared state.
  * `deadline`        overall wall budget across all attempts and
                      sleeps; once a sleep would exceed it, the last
                      error is raised rather than sleeping past it.

Each delay is uniform in [0, min(max_delay, base_delay * 2^(attempt -
1))] (the cap itself with jitter=False).  Every retry lands in
`retries_total{op}` and every exhausted policy in
`retry_exhausted_total{op}` of the port's `obs.registry`, `op` being
the policy's `name` or the function's.  Callers: the checkpoint writer,
the dataset download, and the coordinator's lease heartbeat and
registry RPCs.  The JAX module's `CircuitBreaker` waits with the rest
of resilience/ (ROADMAP A10).
"""

import random
import threading
import time

from ..obs import registry as registry_mod

__all__ = ["RetryPolicy", "AttemptTimeout", "DEFAULT_RETRYABLE"]

# transient failures: disk and network hiccups, timeouts
DEFAULT_RETRYABLE = (IOError, OSError, ConnectionError, TimeoutError)


class AttemptTimeout(TimeoutError):
    """An attempt overran its per-attempt wall budget."""


def _reg():
    return registry_mod.get_registry()


class RetryPolicy:
    """Bounded retries with exponential backoff + full jitter."""

    def __init__(self, max_attempts=3, base_delay=0.05, max_delay=2.0,
                 jitter=True, attempt_timeout=None, deadline=None,
                 retryable=DEFAULT_RETRYABLE, name=None,
                 sleep=time.sleep, rng=None):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.jitter = bool(jitter)
        self.attempt_timeout = attempt_timeout
        self.deadline = deadline
        self.retryable = retryable
        self.name = name
        self._sleep = sleep
        self._rng = rng or random.Random()

    def is_retryable(self, exc):
        if callable(self.retryable) \
                and not isinstance(self.retryable, type):
            return bool(self.retryable(exc))
        return isinstance(exc, self.retryable)

    def backoff(self, attempt):
        """Delay before retry number `attempt` (1-based: the delay
        after the first failure is backoff(1))."""
        cap = min(self.max_delay, self.base_delay * (2 ** (attempt - 1)))
        if not self.jitter:
            return cap
        return self._rng.uniform(0, cap)

    def _run_attempt(self, fn, args, kwargs):
        if self.attempt_timeout is None:
            return fn(*args, **kwargs)
        box = {}

        def target():
            try:
                box["value"] = fn(*args, **kwargs)
            except BaseException as e:
                box["error"] = e

        t = threading.Thread(target=target, daemon=True)
        t.start()
        t.join(self.attempt_timeout)
        if t.is_alive():
            raise AttemptTimeout(
                "%s overran its %.3fs attempt budget"
                % (self._op_label(fn), self.attempt_timeout))
        if "error" in box:
            raise box["error"]
        return box.get("value")

    def _op_label(self, fn):
        return self.name or getattr(fn, "__name__", "call")

    def call(self, fn, *args, **kwargs):
        """Run `fn` under the policy; its value, or the final error."""
        op = self._op_label(fn)
        start = time.monotonic()
        attempt = 0
        while True:
            attempt += 1
            try:
                return self._run_attempt(fn, args, kwargs)
            except BaseException as exc:
                if not self.is_retryable(exc):
                    raise
                elapsed = time.monotonic() - start
                delay = self.backoff(attempt)
                if attempt >= self.max_attempts or (
                        self.deadline is not None
                        and elapsed + delay > self.deadline):
                    _reg().counter(
                        "retry_exhausted_total",
                        "retry policies that gave up",
                        labelnames=("op",)).labels(op=op).inc()
                    raise
                _reg().counter(
                    "retries_total",
                    "individual retries performed by RetryPolicy",
                    labelnames=("op",)).labels(op=op).inc()
                if delay > 0:
                    self._sleep(delay)
