"""Op kernels over torch tensors; importing the package registers them
all."""

from . import registry  # noqa: F401
from . import math  # noqa: F401
from . import tensor_ops  # noqa: F401
from . import activation  # noqa: F401
from . import sparse  # noqa: F401
from . import norm  # noqa: F401
from . import conv  # noqa: F401
from . import attention  # noqa: F401
from . import loss  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import random  # noqa: F401
from . import metrics  # noqa: F401
from . import sequence  # noqa: F401
from . import control_flow  # noqa: F401
from . import crf  # noqa: F401
from . import ctc  # noqa: F401
from . import io_ops  # noqa: F401
from . import beam  # noqa: F401
from . import dist  # noqa: F401
from . import nn  # noqa: F401
from . import v2_extra  # noqa: F401
from . import detection  # noqa: F401
