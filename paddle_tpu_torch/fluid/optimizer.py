"""Optimizers at the Program level: `SGDOptimizer`, `MomentumOptimizer`,
`AdamOptimizer`.

Counterpart of paddle_tpu/fluid/optimizer.py (reference:
python/paddle/v2/fluid/optimizer.py minimize:204, SGD, Momentum, Adam).
An optimizer declares its update: the op type, its per-parameter state
slots, its shared scalars and its hyperparameter attrs; `minimize`
appends the backward (fluid/backward.py), then per parameter, in name
order, the state (`<param>_velocity_0`, `<param>_moment1_0`, ...) and
one update op, with the learning rate in a shared persistable var
(`learning_rate_0`) and the shared scalars (Adam's `beta1_pow_acc_0`,
`beta2_pow_acc_0`) read by every update op and advanced by one in-place
`scale` each per step.  Each new persistable is declared in the main and
startup programs and initialised by a `fill_constant` in the startup,
so both programs equal the JAX package's (with `fuse_optimizer` off,
its default) through `to_dict()`.  The other optimizers, clipping,
regularization and fused updates wait (ROADMAP A5).
"""

from collections import namedtuple

from .backward import append_backward
from .framework import Program, Variable, unique_name
from .initializer import Constant
from .layer_helper import LayerHelper

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum",
           "MomentumOptimizer", "Adam", "AdamOptimizer"]

# a per-parameter accumulator: a variable `{param}_{name}_N`, wired into
# the update op at in_key and written back at out_key, starting at fill
StateSlot = namedtuple("StateSlot", ["name", "in_key", "out_key", "fill"])

# a cross-parameter scalar (e.g. beta1^t): initialised to `init`, read by
# every update op at in_key, multiplied by step_factor once per step
SharedScalar = namedtuple("SharedScalar",
                          ["name", "in_key", "init", "step_factor"])


class Optimizer:
    """The engine over a declared update rule."""

    op_type = None
    state_slots = ()
    shared_scalars = ()

    def __init__(self, learning_rate):
        if not isinstance(learning_rate, (float, Variable)):
            raise TypeError("learning_rate should be float or Variable")
        self._learning_rate = learning_rate

    def _hyper_attrs(self):
        return {}

    def _lr_var(self, program, helper):
        if isinstance(self._learning_rate, Variable):
            return self._learning_rate
        var = program.global_block().create_var(
            name=unique_name("learning_rate", program=program), shape=[1],
            dtype="float32", persistable=True)
        helper.set_variable_initializer(
            var, Constant(float(self._learning_rate)))
        return var

    def _param_lr(self, helper, lr, param):
        """The learning rate scaled by the parameter's own
        `learning_rate` (a `scale` op) where that is not 1."""
        scale = param.optimize_attr.get("learning_rate", 1.0)
        if scale == 1.0:
            return lr
        out = helper.create_tmp_variable("float32", stop_gradient=True)
        helper.append_op(type="scale", inputs={"X": [lr]},
                         outputs={"Out": [out]},
                         attrs={"scale": float(scale)})
        return out

    @staticmethod
    def _shared_var(block, helper, spec):
        var = block.create_var(
            name=unique_name(spec.name, program=block.program), shape=[1],
            dtype="float32", persistable=True)
        helper.set_variable_initializer(var, Constant(spec.init))
        return var

    def create_optimization_pass(self, parameters_and_grads, loss,
                                 startup_program=None):
        """The state and one update op per parameter with a grad
        (reference: optimizer.py:151), then one `scale` per shared
        scalar; returns the update Operators."""
        program = loss.block.program
        block = program.global_block()
        helper = LayerHelper(type(self).__name__, main_program=program,
                             startup_program=startup_program)
        lr = self._lr_var(program, helper)
        shared = [(spec, self._shared_var(block, helper, spec))
                  for spec in self.shared_scalars]
        ops = []
        for param, grad in parameters_and_grads:
            if grad is None or not param.trainable:
                continue
            ins = {"Param": [param], "Grad": [grad],
                   "LearningRate": [self._param_lr(helper, lr, param)]}
            outs = {"ParamOut": [param]}
            for spec in self.state_slots:
                var = block.create_var(
                    name=unique_name("%s_%s" % (param.name, spec.name),
                                     program=program),
                    shape=list(param.shape), dtype=param.dtype,
                    persistable=True)
                helper.set_variable_initializer(var, Constant(spec.fill))
                ins[spec.in_key] = [var]
                outs[spec.out_key] = [var]
            for spec, var in shared:
                ins[spec.in_key] = [var]
            ops.append(block.append_op(type=self.op_type, inputs=ins,
                                       outputs=outs,
                                       attrs=self._hyper_attrs()))
        # advance the shared scalars once per step (beta1^t *= beta1)
        for spec, var in shared:
            block.append_op(type="scale", inputs={"X": [var]},
                            outputs={"Out": [var]},
                            attrs={"scale": spec.step_factor})
        return ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Append the backward and the updates; returns (update
        Operators, [(Parameter, grad Variable)] sorted by name)
        (reference: optimizer.py:204).

        The desc form `minimize(loss_name, main_desc, startup_desc)`
        works on ProgramDescs built without the layers (it wraps them
        with `Program.from_desc`) and returns (update OpDescs, [(param
        name, grad name)])."""
        if isinstance(loss, str):
            main = Program.from_desc(startup_program)
            ops, pairs = self.minimize(main.global_block().var(loss),
                                       Program.from_desc(parameter_list))
            return [op.desc for op in ops], \
                [(p.name, g.name) for p, g in pairs]
        params_grads = sorted(
            append_backward(loss, parameter_list, no_grad_set),
            key=lambda pg: pg[0].name)
        return self.create_optimization_pass(params_grads, loss,
                                             startup_program), params_grads


class SGDOptimizer(Optimizer):
    op_type = "sgd"


class MomentumOptimizer(Optimizer):
    op_type = "momentum"
    state_slots = (StateSlot("velocity", "Velocity", "VelocityOut", 0.0),)

    def __init__(self, learning_rate, momentum, use_nesterov=False):
        super().__init__(learning_rate)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _hyper_attrs(self):
        return {"mu": self._momentum, "use_nesterov": self._use_nesterov}


class AdamOptimizer(Optimizer):
    op_type = "adam"
    state_slots = (StateSlot("moment1", "Moment1", "Moment1Out", 0.0),
                   StateSlot("moment2", "Moment2", "Moment2Out", 0.0))

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        super().__init__(learning_rate)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self.shared_scalars = (
            SharedScalar("beta1_pow_acc", "Beta1Pow", beta1, beta1),
            SharedScalar("beta2_pow_acc", "Beta2Pow", beta2, beta2))

    def _hyper_attrs(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon}


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
