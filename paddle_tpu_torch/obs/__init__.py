"""The port's observability layer: copies of the JAX package's
pure-Python `obs` modules, reading torch tensors where they touch
values.

  * `trace`     — the span tracer (Chrome trace-event JSON export);
  * `registry`  — the counter, gauge and histogram registry with
                  labeled metrics (Prometheus text and JSONL export);
                  the serving `/metrics` endpoint renders it;
  * `telemetry` — the executor-run counter, the step span, examples/s
                  and the loss gauge (`step`, `set_gauge`), and the
                  registry snapshots the flight recorder's records carry;
  * `health`    — numerics health: on-device NaN/Inf and grad-norm
                  monitoring (`NumericsMonitor`), the replay that names
                  the first nonfinite op (`locate_nonfinite`) and the
                  serving outputs' scan (`scan_outputs`);
  * `flight`    — the crash flight recorder: a bounded ring of step
                  records dumped as a JSON bundle from the executor's,
                  the v2 trainer's and serving's exception paths and an
                  excepthook;
  * `context`   — request-scoped trace context: W3C-traceparent ids, a
                  thread-local current binding, and per-request spans
                  that survive the serving batcher's thread hop;
  * `tail`      — tail-latency capture: the full span tree of slow or
                  errored requests in a bounded ring (`/debug/tail`).

They are copies, not imports: the port imports nothing of the JAX
package.  The JAX package's `perf`, `mem`, `comm`, `fleet` and `load`
have no port yet (ROADMAP A2, A9, A10).

Everything is off by default and cheap when off: a span with tracing
disabled is one check, the health and flight hooks start with one
flag or None check.
"""

from . import registry, telemetry, trace  # noqa: F401
from . import context, flight, health, tail  # noqa: F401

__all__ = ["context", "flight", "health", "registry", "tail", "telemetry",
           "trace"]
