"""paddle_tpu_torch.resilience — fault injection, retry policies and the
preemption-safe training supervisor.

Counterpart of paddle_tpu/resilience without its elastic membership
(`elastic`, whose trainer is an SPMD trainer: ROADMAP A9, second
part, slice 22):

  * `faults`      a seeded, deterministic fault-injection registry with
                  named points through the executor's run path, the
                  checkpoint writes, the reader pumps, the dataset
                  downloads, the coordinator's RPCs, the serving engine
                  and the supervised step; every fired fault counts into
                  `faults_injected_total{point,kind}`.
  * `retry`       `RetryPolicy` (bounded attempts, backoff with full
                  jitter, per-attempt timeout, deadline) and
                  `CircuitBreaker`.
  * `supervisor`  `TrainingSupervisor`: SIGTERM/SIGINT preemption hooks
                  with an urgent synchronous checkpoint, auto-resume
                  with batch skip, bounded restarts, and nonfinite-loss
                  rollback.

`python -m paddle_tpu_torch.tools.chaos_cli --selftest` drives the
whole loop: a supervised run under an injected read error, a real
SIGTERM and a nonfinite step must end with a fault-free run's
parameters.
"""

from . import faults
from . import retry
from .retry import (AttemptTimeout, CircuitBreaker, CircuitOpenError,
                    RetryPolicy)

__all__ = ["faults", "retry", "supervisor", "AttemptTimeout",
           "RetryPolicy", "CircuitBreaker", "CircuitOpenError",
           "TrainingSupervisor"]


def __getattr__(name):
    # `supervisor` imports fluid.checkpoint, which imports this package
    # back for retry and faults: resolve it when first asked for
    if name in ("supervisor", "TrainingSupervisor"):
        import importlib

        mod = importlib.import_module(".supervisor", __name__)
        globals()["supervisor"] = mod
        globals()["TrainingSupervisor"] = mod.TrainingSupervisor
        return globals()[name]
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
