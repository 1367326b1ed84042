"""The fluid surface of the port: the program builder (framework,
layers, nets, initializers, parameter attributes), places, the
executor, the backward and the optimizers, AMP, feeding
(`DataFeeder`), saving and loading variables, training checkpoints,
pruning and inference export and load, generation over a step program
(`ProgramDecoder`), and the sparse grad value (`SelectedRows`)."""

from . import (amp, backward, framework, initializer, io, layers, nets,
               optimizer, param_attr)
from .backward import append_backward
from .executor import (CPUPlace, CUDAPlace, ExecContext, Executor, Place,
                       scope_guard)
from .framework import (Operator, Parameter, Program, Variable,
                        default_main_program, default_startup_program,
                        program_guard, unique_name)
from .layer_helper import LayerHelper
from . import checkpoint, data_feeder
from .data_feeder import DataFeeder
from .optimizer import (SGD, Adam, AdamOptimizer, Momentum,
                        MomentumOptimizer, Optimizer, SGDOptimizer)
from .param_attr import ParamAttr
from ..core.ragged import SelectedRows
from ..core.scope import Scope, global_scope
# last: it builds on the executor, and jit imports this package
from .fast_decode import ProgramDecoder

__all__ = ["Adam", "AdamOptimizer", "CPUPlace", "CUDAPlace", "DataFeeder",
           "ExecContext", "Executor", "LayerHelper", "Momentum",
           "MomentumOptimizer",
           "Operator", "Optimizer", "ParamAttr", "Parameter", "Place",
           "Program", "ProgramDecoder", "SGD",
           "SGDOptimizer", "Scope", "SelectedRows", "Variable", "amp",
           "append_backward",
           "backward", "checkpoint", "data_feeder", "default_main_program",
           "default_startup_program", "framework", "global_scope",
           "initializer", "io", "layers", "nets", "optimizer",
           "param_attr", "program_guard", "scope_guard", "unique_name"]
