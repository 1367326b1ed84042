"""The fluid surface of the port: places, the executor, the backward
and the optimizer over descs, inference export and load."""

from . import backward, io, optimizer
from .backward import append_backward
from .executor import (CPUPlace, CUDAPlace, ExecContext, Executor, Place,
                       scope_guard)
from .optimizer import MomentumOptimizer
from ..core.scope import Scope, global_scope

__all__ = ["CPUPlace", "CUDAPlace", "ExecContext", "Executor",
           "MomentumOptimizer", "Place", "Scope", "append_backward",
           "backward", "global_scope", "io", "optimizer", "scope_guard"]
