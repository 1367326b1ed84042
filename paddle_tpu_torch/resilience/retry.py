"""Bounded retries with exponential backoff and full jitter.

Counterpart of paddle_tpu/resilience/retry.py `RetryPolicy`, with the
options the port's callers use (the checkpoint writer and the dataset
download): `max_attempts` counts every try; an IOError, OSError,
ConnectionError or TimeoutError is retried, anything else propagates at
once; each delay is uniform in [0, min(max_delay, base_delay *
2^(attempt - 1))].  The JAX side's per-attempt timeout, overall
deadline, metrics and circuit breaker have no caller in the port.
"""

import random
import time

__all__ = ["RetryPolicy", "RETRYABLE"]

# transient failures: disk and network hiccups, timeouts.  ValueError,
# KeyError and friends are bugs and are never retried.
RETRYABLE = (IOError, OSError, ConnectionError, TimeoutError)


class RetryPolicy:
    """Bounded retries with exponential backoff + full jitter."""

    def __init__(self, max_attempts=3, base_delay=0.05, max_delay=2.0):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self._rng = random.Random()

    def backoff(self, attempt):
        """Delay before retry number `attempt` (1-based)."""
        return self._rng.uniform(0, min(
            self.max_delay, self.base_delay * (2 ** (attempt - 1))))

    def call(self, fn, *args, **kwargs):
        """Run `fn` under the policy; its value, or the final error."""
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except RETRYABLE:
                if attempt == self.max_attempts:
                    raise
                time.sleep(self.backoff(attempt))
