"""paddle_tpu_torch.compile — the program rewrite pipeline, program
fingerprints and the persistent plan cache.

Counterpart of paddle_tpu/compile:

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
  * `pcache`  the persistent on-disk cache of the executor's program
    plans (FLAGS_compile_cache_dir): the pass-rewritten clone, its
    segment plan, its donation plan and the verifier's verdict, which a
    restarted process reloads; a captured CUDA graph cannot be saved,
    so each capture stores a stub.
"""

from . import fingerprint
from . import passes
from . import opt_passes
from . import pcache
from .passes import PassManager, optimize_program
from .pcache import PersistentCache

__all__ = ["fingerprint", "pcache", "passes", "opt_passes",
           "PassManager", "optimize_program", "PersistentCache"]
