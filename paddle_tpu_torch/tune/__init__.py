"""paddle_tpu_torch.tune — the offline autotuner.

Counterpart of paddle_tpu/tune.  Answers "what config do I launch this
model with on N cards" without spending the cards on the question.
Four stages, each riding a subsystem of the port:

  * `space`   — declarative search space over mesh shape x pass
    pipeline x batch x micro-batch, with per-knob constraints so
    invalid points are never enumerated.
  * `rank`    — static scoring with ZERO devices: the sharding analyzer
    rejects S001–S005-erroring candidates, the costmodel prices their
    wire bytes, the roofline floors (the card's peaks) predict their
    step time, and the per-device memory estimate enforces the budget.
  * `measure` — only the top-K survivors ever touch a card, each as a
    child process of the single-card measurement leg (`leg`), landing
    tagged records (leg `ptune:<tag>` + a `"config"` blob) in
    `perf_history.jsonl`.
  * `fit`     — a least-squares per-term correction of predicted vs
    measured step time over that history, so the ranking improves
    with every run.

Operator surface: `python -m paddle_tpu_torch.tools.tune_cli` ("ptune")
with plan / measure / fit / report / --selftest.
"""

from . import space
from . import rank
from . import measure
from . import fit
from . import models
from .space import Candidate, SearchSpace, mesh_shapes_for
from .rank import Calibration, RankedPlan, rank as rank_candidates
from .measure import measure_plan
from .fit import fit_calibration, join_history

__all__ = ["space", "rank", "measure", "fit", "models",
           "Candidate", "SearchSpace", "mesh_shapes_for",
           "Calibration", "RankedPlan", "rank_candidates",
           "measure_plan", "fit_calibration", "join_history"]
