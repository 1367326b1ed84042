"""Fault injection and retries: the parts of paddle_tpu/resilience that
the checkpoint saver, the prefetching readers and the dataset
downloads call (`faults.check`, `RetryPolicy`)."""

from . import faults, retry
from .retry import RetryPolicy

__all__ = ["RetryPolicy", "faults", "retry"]
