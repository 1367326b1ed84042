"""paddle_tpu_torch.analysis — static analysis over the Program IR.

Counterpart of paddle_tpu/analysis, with its three single-device
layers (each diagnostic code means what it means there):

  * `verifier`  structural well-formedness: registry membership,
    def-before-use per block, BlockRef scoping, attr serializability
    and, at `level="full"`, dtype and shape re-derived through the
    registry (V0xx codes).
  * `dataflow`  def-use chains and liveness, dead ops and vars, and the
    write-write and in-place alias hazards (D0xx, H0xx codes).
  * `lints`     dynamic dims into matrix products, host ops between
    device ops, unseeded random ops, AMP dtype mixes, grad orphans
    (L0xx codes).

the donation layer:

  * `alias`     may-alias and last-use donation safety: which buffers
    each segment of the executor can donate, and why the rest are
    refused (A0xx codes); the executor's FLAGS_donation plan.

and the sharding layer:

  * `shard`     static SPMD analysis: spec propagation against a mesh
    description, divisibility, conflict and schedule checks, the
    per-device peak-memory estimate (S0xx codes), with `costmodel`
    pricing the collectives the layout implies
    (`shard_comm_bytes_total{collective}`).

`check_program` runs all three and publishes the finding counters
(`analysis_diagnostics_total{code,severity}`) into the obs registry; the
roofline cost analysis lives in `fluid/analysis.py`.

Verification runs at the trust boundaries, as on the JAX side: the
executor's FLAGS_verify_program gate, `fluid.io.load_inference_model`
(a structural check on load), the serving engine's warmup (the full
check), the rewrite passes (around each pass) and the
DistributeTranspiler; the sharding analyzer at the mesh's
(`FLAGS_verify_sharding`, `lint_cli --mesh`), the donation analysis at
the executor's planning of a program and `lint_cli --donation`.
"""

from .diagnostics import (Diagnostic, ProgramVerificationError, Report,
                          Severity)
from .dataflow import Liveness, analyze_dataflow
from .lints import lint_program
from .verifier import verify_program
from .shard import (analyze_sharding, check_moe, check_pipeline,
                    check_ring, mesh_axis_sizes, ShardingPlan)
from .costmodel import CommCostReport
from .alias import (DonationPlan, analyze_donation, donation_mode,
                    state_donation)

__all__ = ["Diagnostic", "Severity", "Report", "ProgramVerificationError",
           "Liveness", "verify_program", "analyze_dataflow",
           "lint_program", "check_program", "analyze_sharding",
           "check_pipeline", "check_moe", "check_ring", "mesh_axis_sizes",
           "ShardingPlan", "CommCostReport", "DonationPlan",
           "analyze_donation", "donation_mode", "state_donation"]


def check_program(program, level="full", fetches=None, bucket_hints=None,
                  suppress=(), publish=True, origin="analysis"):
    """Run the verifier, the dataflow pass and the lints over `program`
    (a Program or ProgramDesc); returns one merged `Report`.

    level: "structural" skips the shape re-derivation (V005-007), cheap
        enough for every program load.
    fetches: the run's fetch names; enables dead-op detection (a fetch
        is a by-name scope lookup, invisible to the IR without this).
    bucket_hints: the serving export's bucket config; demotes the
        dynamic batch-dim finding to a covered advisory.
    suppress: diagnostic suppressions ("H002", "H002@scale",
        "H002@var:name").
    publish: count the findings into the obs registry
        (`analysis_diagnostics_total{code,severity}`).
    """
    report = Report(suppress=suppress)
    verify_program(program, level=level, report=report)
    analyze_dataflow(program, fetches=fetches, report=report)
    lint_program(program, bucket_hints=bucket_hints, report=report)
    if publish:
        report.publish(origin=origin)
    return report
