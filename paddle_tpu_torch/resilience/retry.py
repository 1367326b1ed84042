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
registry RPCs.

`CircuitBreaker` guards a dependency that is failing persistently:
after `failure_threshold` consecutive failures the circuit opens and
calls fail fast with `CircuitOpenError` (no load on the sick backend);
after `reset_timeout` one probe call is let through (half-open), and a
success closes the circuit again.  Its state is the gauge
`circuit_state{breaker}` (0 closed, 1 half-open, 2 open), and every
opening counts into `circuit_opened_total{breaker}`, the JAX module's
names and values.
"""

import functools
import random
import threading
import time

from ..obs import registry as registry_mod

__all__ = ["RetryPolicy", "CircuitBreaker", "AttemptTimeout",
           "CircuitOpenError", "DEFAULT_RETRYABLE"]

# transient failures: disk and network hiccups, dropped registry
# connections, timeouts.  ValueError, KeyError and friends are bugs,
# never retried by default.
DEFAULT_RETRYABLE = (IOError, OSError, ConnectionError, TimeoutError)


class AttemptTimeout(TimeoutError):
    """An attempt overran its per-attempt wall budget."""


class CircuitOpenError(RuntimeError):
    """Fast-fail: the breaker is open and the call was not attempted."""


def _reg():
    return registry_mod.get_registry()


class RetryPolicy:
    """Bounded retries with exponential backoff + full jitter."""

    def __init__(self, max_attempts=3, base_delay=0.05, max_delay=2.0,
                 jitter=True, attempt_timeout=None, deadline=None,
                 retryable=DEFAULT_RETRYABLE, name=None,
                 sleep=time.sleep, rng=None, on_retry=None):
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
        self._on_retry = on_retry

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
        """Run `fn` under the policy; returns its value or re-raises
        the final error."""
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
                out_of_budget = (
                    attempt >= self.max_attempts
                    or (self.deadline is not None
                        and elapsed + delay > self.deadline))
                if out_of_budget:
                    _reg().counter(
                        "retry_exhausted_total",
                        "retry policies that gave up",
                        labelnames=("op",)).labels(op=op).inc()
                    raise
                _reg().counter(
                    "retries_total",
                    "individual retries performed by RetryPolicy",
                    labelnames=("op",)).labels(op=op).inc()
                if self._on_retry is not None:
                    self._on_retry(attempt, exc, delay)
                if delay > 0:
                    self._sleep(delay)

    def wrap(self, fn):
        """Decorator form: `guarded = policy.wrap(fetch)`."""

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        return wrapped


class CircuitBreaker:
    """Consecutive-failure circuit breaker (closed -> open ->
    half-open -> closed).

    State is exported as `circuit_state{breaker=}` (0 closed, 1
    half-open, 2 open) and every open transition counts into
    `circuit_opened_total{breaker=}`.
    """

    CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
    _STATE_VALUE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def __init__(self, failure_threshold=5, reset_timeout=30.0,
                 name="default", clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout = float(reset_timeout)
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = None
        self._publish()

    @property
    def state(self):
        with self._lock:
            return self._probe_state()

    def _probe_state(self):
        # lock held: open flips to half-open once the cooldown lapses
        if self._state == self.OPEN \
                and self._clock() - self._opened_at >= self.reset_timeout:
            self._state = self.HALF_OPEN
        return self._state

    def _publish(self):
        _reg().gauge("circuit_state",
                     "circuit breaker state (0 closed, 1 half-open, "
                     "2 open)", labelnames=("breaker",)) \
            .labels(breaker=self.name) \
            .set(self._STATE_VALUE[self._state])

    def allow(self):
        """May a call proceed right now?  A half-open breaker admits
        exactly one probe (it re-opens or closes on its outcome)."""
        with self._lock:
            state = self._probe_state()
            if state == self.OPEN:
                return False
            if state == self.HALF_OPEN:
                # admit one probe; re-arming the open timer holds the
                # others out until the probe reports back
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._publish()
                return True
            return True

    def record_success(self):
        with self._lock:
            self._state = self.CLOSED
            self._failures = 0
            self._opened_at = None
            self._publish()

    def record_failure(self):
        with self._lock:
            self._failures += 1
            if self._state != self.OPEN \
                    and self._failures >= self.failure_threshold:
                self._state = self.OPEN
                self._opened_at = self._clock()
                _reg().counter("circuit_opened_total",
                               "circuit breaker open transitions",
                               labelnames=("breaker",)) \
                    .labels(breaker=self.name).inc()
            elif self._state == self.OPEN:
                self._opened_at = self._clock()  # failed probe: re-arm
            self._publish()

    def call(self, fn, *args, **kwargs):
        """Run `fn` through the breaker; raises CircuitOpenError
        without calling when open."""
        if not self.allow():
            raise CircuitOpenError(
                "circuit %r is open (%d consecutive failures)"
                % (self.name, self._failures))
        try:
            result = fn(*args, **kwargs)
        except BaseException:
            self.record_failure()
            raise
        self.record_success()
        return result
