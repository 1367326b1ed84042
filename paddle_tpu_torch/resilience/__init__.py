"""paddle_tpu_torch.resilience — fault injection, retry policies and the
preemption-safe training supervisor.

Counterpart of paddle_tpu/resilience:

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
  * `elastic`     the generation-numbered cluster-view protocol over the
                  native master (`ElasticMembership`, `ClusterView`) and
                  `ElasticTrainer`, which rebinds an SPMD trainer to
                  every committed view: a lost host shrinks dp, a
                  rejoining one grows it back.

`python -m paddle_tpu_torch.tools.chaos_cli --selftest` drives the
whole loop: a supervised run under an injected read error, a real
SIGTERM and a nonfinite step must end with a fault-free run's
parameters.
"""

from . import faults
from . import retry
from .retry import (AttemptTimeout, CircuitBreaker, CircuitOpenError,
                    RetryPolicy)

__all__ = ["faults", "retry", "supervisor", "elastic", "AttemptTimeout",
           "RetryPolicy", "CircuitBreaker", "CircuitOpenError",
           "TrainingSupervisor", "ElasticMembership", "ElasticTrainer",
           "ClusterView"]

_LAZY = {
    # `supervisor` imports fluid.checkpoint, which imports this package
    # back for retry and faults; `elastic` pulls in the spmd stack the
    # same way: resolve them when first asked for
    "supervisor": ("supervisor", None),
    "TrainingSupervisor": ("supervisor", "TrainingSupervisor"),
    "elastic": ("elastic", None),
    "ElasticMembership": ("elastic", "ElasticMembership"),
    "ElasticTrainer": ("elastic", "ElasticTrainer"),
    "ClusterView": ("elastic", "ClusterView"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        modname, attr = _LAZY[name]
        mod = importlib.import_module("." + modname, __name__)
        globals()[modname] = mod
        value = mod if attr is None else getattr(mod, attr)
        globals()[name] = value
        return value
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
