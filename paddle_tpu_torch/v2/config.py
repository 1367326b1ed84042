"""v2 process-level config state (reference: the gflags handled by
python/paddle/v2/__init__.py init).

Unlike the JAX package, whose `init()` runs on the CPU unless asked for
the TPU, the port runs on the card: `init()` and `_place()` give
`CUDAPlace(0)` unless the caller passes `use_gpu=False` (the CPU tests
do).  Without a CUDA device, a run on `CUDAPlace(0)` raises.
"""

_state = {"initialized": False, "use_gpu": True, "trainer_count": 1}


def init(use_gpu=True, trainer_count=1, **kwargs):
    """use_gpu: run the v2 API on CUDAPlace(0) (the default) or, with
    False, on the CPU.  `trainer_count` is recorded; the trainer runs one
    card."""
    _state["initialized"] = True
    _state["use_gpu"] = bool(use_gpu)
    _state["trainer_count"] = trainer_count


def _place():
    from .. import fluid

    if _state["use_gpu"]:
        return fluid.CUDAPlace(0)
    return fluid.CPUPlace()
