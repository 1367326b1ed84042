"""The layers namespace (reference: python/paddle/v2/fluid/layers/
__init__.py): the subset of the JAX package's layers whose ops the port
has.  Importing it installs the arithmetic operators on Variable."""

from . import math_op_patch  # noqa: F401  (Variable arithmetic)
from .control_flow import *  # noqa: F401,F403
from .device import *        # noqa: F401,F403
from .io import *            # noqa: F401,F403
from .nn import *            # noqa: F401,F403
from .ops import *           # noqa: F401,F403
from .tensor import *        # noqa: F401,F403

from . import control_flow, device, io, nn, ops, tensor

__all__ = (control_flow.__all__ + device.__all__ + io.__all__ + nn.__all__
           + ops.__all__ + tensor.__all__)
