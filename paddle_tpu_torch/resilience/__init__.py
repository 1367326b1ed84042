"""Fault injection and retries: the parts of paddle_tpu/resilience that
the checkpoint saver, the prefetching readers, the dataset downloads,
the coordinator and the serving engine call (`faults.check`,
`RetryPolicy`)."""

from . import faults, retry
from .retry import AttemptTimeout, RetryPolicy

__all__ = ["AttemptTimeout", "RetryPolicy", "faults", "retry"]
