"""paddle_tpu_torch.compile — the program rewrite pipeline and program
fingerprints.

Counterpart of paddle_tpu/compile without its persistent executable
cache (`pcache`, which waits with ROADMAP A2):

  * `fingerprint`  canonical, content-addressed fingerprints of
    programs (the same digest as the JAX package's for the same
    program) and of run-time value signatures.
  * `passes` and `opt_passes`  Program-level IR rewrite passes over the
    analysis package's def-use and liveness machinery: the cleanup set
    (dead-op and dead-var elimination, shape and fill constant folding,
    pure-op CSE) and the cost-model-guided passes (`layout`, `fuse`,
    `auto_remat`), run by a `PassManager` that verifies the IR around
    every pass.  The executor runs the pipeline under
    FLAGS_compile_passes.
"""

from . import fingerprint
from . import passes
from . import opt_passes
from .passes import PassManager, optimize_program

__all__ = ["fingerprint", "passes", "opt_passes", "PassManager",
           "optimize_program"]
