"""paddle_tpu_torch.analysis — static analysis over the Program IR.

Counterpart of paddle_tpu/analysis, with its structural layer: the
`verifier` (registry membership, def-before-use per block, BlockRef
scoping, attr serializability and, at `level="full"`, dtype and shape
re-derived through the registry; V0xx codes, `diagnostics`).  The
DistributeTranspiler verifies the program it rewrites before it
returns.  The JAX package's `dataflow`, `lints`, `shard` and `costmodel`
passes and `check_program` wait with ROADMAP A10, `alias` with A2's
buffer donation.
"""

from .diagnostics import (Diagnostic, ProgramVerificationError, Report,
                          Severity)
from .verifier import verify_program

__all__ = ["Diagnostic", "Severity", "Report", "ProgramVerificationError",
           "verify_program"]
