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
                  errored requests in a bounded ring (`/debug/tail`);
  * `perf`      — the step profiler (a device/input/host split of
                  sampled steps, the device part the card's busy time),
                  the bottleneck classifier over the roofline, and the
                  perf-history regression gate;
  * `load`      — the load generator (open and closed loop, access-log
                  replay, the tail and exemplar joins); a submodule
                  imported by name (`paddle_tpu_torch.obs.load`), not
                  listed here, as in the JAX package;
  * `comm`      — the collectives' observability: the bucket
                  schedule's spans, per-bucket ring timing against the
                  analytic floor, the overlap split of the data-parallel
                  step, the calibration blob, and across hosts the span
                  windows, the clock-offset exchange and the merged
                  trace; imported by name, as in the JAX package;
  * `fleet`     — this worker's identity (`host_id`), which the SPMD
                  trainer stamps into the flight recorder, and the
                  per-host metric snapshots pushed into the master's
                  lease store (`FleetReporter`) with their merged view
                  and straggler verdict (`FleetAggregator`);
  * `mem`       — memory observability: the static liveness timeline
                  against the captured graphs' pool bytes (the drift
                  report and its calibration blob), the donation audit,
                  the FLAGS_mem_budget_gb pre-flight and the OOM
                  post-mortem.

They are copies, not imports: the port imports nothing of the JAX
package.

Everything is off by default and cheap when off: a span with tracing
disabled is one check, the health and flight hooks start with one
flag or None check.
"""

from . import registry, telemetry, trace  # noqa: F401
from . import context, fleet, flight, health, mem, perf, tail  # noqa: F401

__all__ = ["context", "fleet", "flight", "health", "mem", "perf",
           "registry", "tail", "telemetry", "trace"]
