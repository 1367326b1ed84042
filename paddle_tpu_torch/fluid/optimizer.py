"""Optimizers over ProgramDescs: `MomentumOptimizer`.

Counterpart of paddle_tpu/fluid/optimizer.py (reference:
python/paddle/v2/fluid/optimizer.py minimize:204, Momentum).  The port
has no framework.Program yet (ROADMAP A3), so `minimize` takes the
loss var's name and the main and startup descs: it appends the
backward (fluid/backward.py), then per parameter, in name order, a
velocity accumulator and one `momentum` op, with the learning rate in a
shared var.  Each new persistable var is declared in both descs and
initialised by a `fill_constant` in the startup desc.  Names, op order
and attrs are the JAX side's (`learning_rate_0`, `<param>_velocity_0`),
so both descs equal the JAX package's through `to_dict()`.  Clipping,
regularization, fused updates and the other optimizers come with
ROADMAP A3.
"""

from ..core.desc import OpDesc, VarDesc
from .backward import append_backward

__all__ = ["MomentumOptimizer"]


def _unique_name(block, prefix):
    """`prefix_N` for the first N not yet declared in `block` (the JAX
    side's per-program unique_name counter, for a desc holding no
    other var of that prefix)."""
    n = 0
    while "%s_%d" % (prefix, n) in block.vars:
        n += 1
    return "%s_%d" % (prefix, n)


class MomentumOptimizer:
    op_type = "momentum"

    def __init__(self, learning_rate, momentum, use_nesterov=False):
        if not isinstance(learning_rate, float):
            raise TypeError("learning_rate should be a float")
        self._learning_rate = learning_rate
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    @staticmethod
    def _persistable(main, startup, prefix, shape, dtype, value):
        """A new persistable var in both descs, filled with `value` by
        the startup desc; returns its name."""
        block = main.block(0)
        name = _unique_name(block, prefix)
        for b in (block, startup.block(0)):
            b.vars[name] = VarDesc(name, dtype=dtype, shape=shape,
                                   persistable=True)
        startup.block(0).ops.append(OpDesc(
            "fill_constant", {}, {"Out": [name]},
            {"shape": list(shape), "dtype": dtype, "value": float(value)}))
        return name

    def minimize(self, loss_name, main, startup):
        """Append the backward and the update ops to `main` and the
        state's initialisers to `startup`; returns the appended update
        ops and [(param name, grad name)] sorted by param name."""
        params_grads = sorted(append_backward(main, loss_name))
        block = main.block(0)
        lr = self._persistable(main, startup, "learning_rate", [1],
                               "float32", self._learning_rate)
        ops = []
        for p, g in params_grads:
            pv = block.var(p)
            velocity = self._persistable(main, startup,
                                         "%s_velocity" % p, pv.shape,
                                         pv.dtype, 0.0)
            op = OpDesc(self.op_type,
                        {"Param": [p], "Grad": [g], "LearningRate": [lr],
                         "Velocity": [velocity]},
                        {"ParamOut": [p], "VelocityOut": [velocity]},
                        {"mu": self._momentum,
                         "use_nesterov": self._use_nesterov})
            block.ops.append(op)
            ops.append(op)
        return ops, params_grads
