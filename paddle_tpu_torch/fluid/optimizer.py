"""Optimizers at the Program level: `SGDOptimizer`, `MomentumOptimizer`,
`AdagradOptimizer`, `AdamOptimizer`, `AdamaxOptimizer`,
`DecayedAdagradOptimizer`, `AdadeltaOptimizer`, `RMSPropOptimizer` and
`FtrlOptimizer`, each with its short alias (`SGD`, `Adagrad`, ...).

Counterpart of paddle_tpu/fluid/optimizer.py (reference:
python/paddle/v2/fluid/optimizer.py minimize:204, :228-550).
An optimizer declares its update: the op type, its per-parameter state
slots, its shared scalars and its hyperparameter attrs; `minimize`
appends the backward (fluid/backward.py), then per parameter, in name
order, the state (`<param>_velocity_0`, `<param>_moment1_0`, ...) and
one update op, with the learning rate in a shared persistable var
(`learning_rate_0`) and the shared scalars (Adam's `beta1_pow_acc_0`,
`beta2_pow_acc_0`; Adamax's one `beta1_pow_acc_0`) read by every
update op and advanced by one in-place `scale` each per step.  Adadelta
takes no learning rate (`uses_lr = False`): its ops have no
LearningRate input, though the program still declares
`learning_rate_0`, as the JAX side's does.  Each new persistable is
declared in the main and startup programs and initialised by a
`fill_constant` in the startup, so both programs equal the JAX
package's (with `fuse_optimizer` off, its default) through `to_dict()`.
A sparse (SelectedRows) grad goes to the update op as it is.  Every
constructor takes `regularization` (fluid/regularizer.py: its ops are
appended to the sorted grads before the updates, a parameter's own
`regularizer` first) and `global_step` (a var one `increment` op
advances after the updates).  Clipping and fused updates wait with
ROADMAP A5.
"""

from collections import namedtuple

from .backward import append_backward
from .framework import Program, Variable, unique_name
from .initializer import Constant
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum",
           "MomentumOptimizer", "Adagrad", "AdagradOptimizer", "Adam",
           "AdamOptimizer", "Adamax", "AdamaxOptimizer", "DecayedAdagrad",
           "DecayedAdagradOptimizer", "Adadelta", "AdadeltaOptimizer",
           "RMSProp", "RMSPropOptimizer", "Ftrl", "FtrlOptimizer"]

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
    uses_lr = True  # adadelta's rule derives its step size from state

    def __init__(self, learning_rate, regularization=None, global_step=None):
        if not isinstance(learning_rate, (float, Variable)):
            raise TypeError("learning_rate should be float or Variable")
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._global_step = global_step

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
            ins = {"Param": [param], "Grad": [grad]}
            if self.uses_lr:
                ins["LearningRate"] = [self._param_lr(helper, lr, param)]
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
        if self._global_step is not None:
            from .layers import tensor as tensor_layers

            tensor_layers.increment(self._global_step, value=1.0,
                                    in_place=True)
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
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        return self.create_optimization_pass(params_grads, loss,
                                             startup_program), params_grads


class SGDOptimizer(Optimizer):
    op_type = "sgd"


class MomentumOptimizer(Optimizer):
    op_type = "momentum"
    state_slots = (StateSlot("velocity", "Velocity", "VelocityOut", 0.0),)

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _hyper_attrs(self):
        return {"mu": self._momentum, "use_nesterov": self._use_nesterov}


class AdagradOptimizer(Optimizer):
    op_type = "adagrad"
    state_slots = (StateSlot("moment", "Moment", "MomentOut", 0.0),)

    def __init__(self, learning_rate, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon

    def _hyper_attrs(self):
        return {"epsilon": self._epsilon}


class AdamOptimizer(Optimizer):
    op_type = "adam"
    state_slots = (StateSlot("moment1", "Moment1", "Moment1Out", 0.0),
                   StateSlot("moment2", "Moment2", "Moment2Out", 0.0))

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self.shared_scalars = (
            SharedScalar("beta1_pow_acc", "Beta1Pow", beta1, beta1),
            SharedScalar("beta2_pow_acc", "Beta2Pow", beta2, beta2))

    def _hyper_attrs(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon}


class AdamaxOptimizer(Optimizer):
    op_type = "adamax"
    state_slots = (StateSlot("moment", "Moment", "MomentOut", 0.0),
                   StateSlot("inf_norm", "InfNorm", "InfNormOut", 0.0))

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self.shared_scalars = (
            SharedScalar("beta1_pow_acc", "Beta1Pow", beta1, beta1),)

    def _hyper_attrs(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon}


class DecayedAdagradOptimizer(Optimizer):
    op_type = "decayed_adagrad"
    state_slots = (StateSlot("moment", "Moment", "MomentOut", 0.0),)

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._decay = decay
        self._epsilon = epsilon

    def _hyper_attrs(self):
        return {"decay": self._decay, "epsilon": self._epsilon}


class AdadeltaOptimizer(Optimizer):
    op_type = "adadelta"
    uses_lr = False
    state_slots = (
        StateSlot("avg_squared_grad", "AvgSquaredGrad",
                  "AvgSquaredGradOut", 0.0),
        StateSlot("avg_squared_update", "AvgSquaredUpdate",
                  "AvgSquaredUpdateOut", 0.0))

    def __init__(self, learning_rate=1.0, epsilon=1e-6, rho=0.95,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._rho = rho

    def _hyper_attrs(self):
        return {"epsilon": self._epsilon, "rho": self._rho}


class RMSPropOptimizer(Optimizer):
    op_type = "rmsprop"
    state_slots = (StateSlot("mean_square", "MeanSquare",
                             "MeanSquareOut", 0.0),
                   StateSlot("moment", "Moment", "MomentOut", 0.0))

    def __init__(self, learning_rate, decay=0.9, epsilon=1e-6,
                 momentum=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._decay = decay
        self._epsilon = epsilon
        self._momentum = momentum

    def _hyper_attrs(self):
        return {"decay": self._decay, "epsilon": self._epsilon,
                "momentum": self._momentum}


class FtrlOptimizer(Optimizer):
    op_type = "ftrl"
    state_slots = (StateSlot("squared", "SquaredAccumulator",
                             "SquaredAccumOut", 0.0),
                   StateSlot("linear", "LinearAccumulator",
                             "LinearAccumOut", 0.0))

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _hyper_attrs(self):
        return {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power}


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
