"""The port's observability layer: copies of the JAX package's
pure-Python `obs` modules the v2 trainer reports through.

  * `trace`     — the span tracer (Chrome trace-event JSON export);
  * `registry`  — the counter, gauge and histogram registry (Prometheus
                  text and JSONL export);
  * `telemetry` — the step span, examples/s and the loss gauge
                  (`step`, `set_gauge`) over the two above.

They are copies, not imports: the port imports nothing of the JAX
package.  The numerics monitor (`obs/health.py`) and the flight recorder
(`obs/flight.py`) wait with ROADMAP A8; the port's serving keeps its own
`serving/metrics.py`.
"""

from . import registry, telemetry, trace  # noqa: F401

__all__ = ["registry", "telemetry", "trace"]
