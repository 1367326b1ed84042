"""paddle_tpu_torch.v2 — the legacy "v2" user API over the port's fluid
stack (reference: python/paddle/v2/__init__.py).

The port's counterpart of paddle_tpu.v2: the same `paddle.layer.*`
builders, `paddle.trainer.SGD` event loop,
`paddle.parameters.Parameters` (tar files that cross between the
packages) and `paddle.infer`, building a fluid Program underneath.  It
runs on CUDAPlace(0) unless `init(use_gpu=False)` asks for the CPU
(v2/config.py).
"""

from .config import init, _place  # noqa: F401

from . import activation
from . import attr
from . import data_type
from . import evaluator
from . import event
from . import image
from . import inference
from . import layer
from . import networks
from . import optimizer
from . import parameters
from . import plot
from . import pooling
from . import trainer

from .. import dataset
from .. import reader
from ..reader.decorator import batch as minibatch

batch = minibatch
infer = inference.infer

__all__ = [
    "init", "activation", "attr", "data_type", "event", "inference",
    "layer", "networks", "optimizer", "parameters", "pooling", "trainer",
    "dataset", "reader", "batch", "minibatch", "infer", "evaluator",
    "image", "plot",
]
