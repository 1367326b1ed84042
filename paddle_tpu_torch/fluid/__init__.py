"""The fluid surface of the port: the program builder (framework,
layers, initializers, parameter attributes), places, the executor, the
backward and the optimizers, AMP, pruning and inference export and
load."""

from . import (amp, backward, framework, initializer, io, layers,
               optimizer, param_attr)
from .backward import append_backward
from .executor import (CPUPlace, CUDAPlace, ExecContext, Executor, Place,
                       scope_guard)
from .framework import (Operator, Parameter, Program, Variable,
                        default_main_program, default_startup_program,
                        program_guard, unique_name)
from .layer_helper import LayerHelper
from .optimizer import (SGD, Momentum, MomentumOptimizer, Optimizer,
                        SGDOptimizer)
from .param_attr import ParamAttr
from ..core.scope import Scope, global_scope

__all__ = ["CPUPlace", "CUDAPlace", "ExecContext", "Executor",
           "LayerHelper", "Momentum", "MomentumOptimizer", "Operator",
           "Optimizer", "ParamAttr", "Parameter", "Place", "Program", "SGD",
           "SGDOptimizer", "Scope", "Variable", "amp", "append_backward",
           "backward", "default_main_program", "default_startup_program",
           "framework", "global_scope", "initializer", "io", "layers",
           "optimizer", "param_attr", "program_guard", "scope_guard",
           "unique_name"]
