"""The fluid surface of the port: the program builder (framework,
layers, nets, initializers, parameter attributes), places (`CUDAPlace`,
the default, with `TPUPlace` its alias for scripts written for the JAX
package, and `CPUPlace`), the executor, the backward and the
optimizers with gradient clipping (`clip`), learning-rate schedules
(`lr_schedules`) and fused updates (`fusion`), streaming metrics
(`evaluator`), AMP with its loss scaler, feeding (`DataFeeder`),
weight-decay regularizers, saving and loading variables, training
checkpoints, pruning and inference export and load, generation over a
step program (`ProgramDecoder`), the ragged value and the sparse grad
value (`RaggedTensor`, `SelectedRows`), the per-op profiler
(`profiler`), the NHWC relayout (`data_transform.convert_layout`), and
the memory passes: activation recomputation (`recompute_program`,
`RecomputeOptimizer`) and slot reuse (`memory_optimize`)."""

from . import (amp, backward, clip, framework, fusion, initializer, io,
               layers, lr_schedules, nets, optimizer, param_attr,
               regularizer)
from .backward import append_backward, calc_gradient
from .executor import (CPUPlace, CUDAPlace, ExecContext, Executor, Place,
                       TPUPlace, fetch_var, scope_guard)
from .framework import (Block, Operator, Parameter, Program, Variable,
                        default_main_program, default_startup_program,
                        program_guard, switch_main_program,
                        switch_startup_program, unique_name)
from .layer_helper import LayerHelper
from . import checkpoint, data_feeder, evaluator, profiler
from . import data_transform
from .data_transform import convert_layout
from . import memory_optimization_transpiler
from .memory_optimization_transpiler import memory_optimize
from . import recompute
from .recompute import RecomputeOptimizer, recompute_program
from .data_feeder import DataFeeder
from .optimizer import (SGD, Adam, AdamOptimizer, Momentum,
                        MomentumOptimizer, Optimizer, SGDOptimizer)
from .param_attr import ParamAttr
from ..core.ragged import RaggedTensor, SelectedRows
from ..core.scope import Scope, global_scope
# last: it builds on the executor, and jit imports this package
from .fast_decode import ProgramDecoder

__all__ = ["Adam", "AdamOptimizer", "Block", "CPUPlace", "CUDAPlace",
           "DataFeeder",
           "ExecContext", "Executor", "LayerHelper", "Momentum",
           "MomentumOptimizer",
           "Operator", "Optimizer", "ParamAttr", "Parameter", "Place",
           "Program", "ProgramDecoder", "RaggedTensor",
           "RecomputeOptimizer", "SGD",
           "SGDOptimizer", "Scope", "SelectedRows", "TPUPlace", "Variable",
           "amp",
           "append_backward", "backward", "calc_gradient", "checkpoint",
           "clip", "convert_layout", "data_feeder", "data_transform",
           "default_main_program",
           "default_startup_program", "evaluator", "fetch_var",
           "framework", "fusion", "global_scope", "initializer", "io",
           "layers", "lr_schedules", "memory_optimization_transpiler",
           "memory_optimize", "nets", "optimizer", "param_attr",
           "profiler", "program_guard", "recompute", "recompute_program",
           "regularizer", "scope_guard",
           "switch_main_program", "switch_startup_program",
           "unique_name"]
