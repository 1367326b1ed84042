"""The fluid surface of the port: places, the executor, inference
export and load."""

from . import io
from .executor import (CPUPlace, CUDAPlace, ExecContext, Executor, Place,
                       scope_guard)
from ..core.scope import Scope, global_scope

__all__ = ["CPUPlace", "CUDAPlace", "ExecContext", "Executor", "Place",
           "Scope", "global_scope", "io", "scope_guard"]
