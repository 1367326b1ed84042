"""v2 optimizer configs (reference: python/paddle/v2/optimizer.py —
thin configs handed to the trainer; here they carry a fluid optimizer
factory).  The port's copy of paddle_tpu/v2/optimizer.py: a
`regularization_rate` becomes the fluid optimizer's L2Decay."""

from ..fluid import optimizer as fluid_opt
from ..fluid import regularizer as fluid_reg

__all__ = ["Optimizer", "Momentum", "Adam", "Adamax", "AdaGrad",
           "DecayedAdaGrad", "AdaDelta", "RMSProp"]


def _regularization(rate):
    return fluid_reg.L2Decay(rate) if rate else None


class Optimizer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def to_fluid(self):
        raise NotImplementedError

    # v2 API compat (learning-rate schedules folded into the config)
    def enable_types(self):
        return []


class Momentum(Optimizer):
    def __init__(self, momentum=None, sparse=False, learning_rate=1e-3,
                 regularization_rate=0.0, **kw):
        Optimizer.__init__(self, **kw)
        self.momentum = momentum or 0.0
        self.learning_rate = learning_rate
        self.regularization_rate = regularization_rate

    def to_fluid(self):
        return fluid_opt.Momentum(
            learning_rate=self.learning_rate, momentum=self.momentum,
            regularization=_regularization(self.regularization_rate))


class Adam(Optimizer):
    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 learning_rate=1e-3, regularization_rate=0.0, **kw):
        Optimizer.__init__(self, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.learning_rate = learning_rate
        self.regularization_rate = regularization_rate

    def to_fluid(self):
        return fluid_opt.Adam(
            learning_rate=self.learning_rate, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon,
            regularization=_regularization(self.regularization_rate))


class Adamax(Optimizer):
    def __init__(self, beta1=0.9, beta2=0.999, learning_rate=1e-3, **kw):
        Optimizer.__init__(self, **kw)
        self.beta1, self.beta2 = beta1, beta2
        self.learning_rate = learning_rate

    def to_fluid(self):
        return fluid_opt.Adamax(learning_rate=self.learning_rate,
                                beta1=self.beta1, beta2=self.beta2)


class AdaGrad(Optimizer):
    def __init__(self, learning_rate=1e-3, **kw):
        Optimizer.__init__(self, **kw)
        self.learning_rate = learning_rate

    def to_fluid(self):
        return fluid_opt.Adagrad(learning_rate=self.learning_rate)


class DecayedAdaGrad(Optimizer):
    def __init__(self, rho=0.95, epsilon=1e-6, learning_rate=1e-3, **kw):
        Optimizer.__init__(self, **kw)
        self.rho, self.epsilon = rho, epsilon
        self.learning_rate = learning_rate

    def to_fluid(self):
        return fluid_opt.DecayedAdagrad(
            learning_rate=self.learning_rate, decay=self.rho,
            epsilon=self.epsilon)


class AdaDelta(Optimizer):
    def __init__(self, rho=0.95, epsilon=1e-6, learning_rate=1.0, **kw):
        Optimizer.__init__(self, **kw)
        self.rho, self.epsilon = rho, epsilon
        self.learning_rate = learning_rate

    def to_fluid(self):
        return fluid_opt.Adadelta(
            learning_rate=self.learning_rate, rho=self.rho,
            epsilon=self.epsilon)


class RMSProp(Optimizer):
    def __init__(self, rho=0.95, epsilon=1e-6, learning_rate=1e-3, **kw):
        Optimizer.__init__(self, **kw)
        self.rho, self.epsilon = rho, epsilon
        self.learning_rate = learning_rate

    def to_fluid(self):
        return fluid_opt.RMSProp(
            learning_rate=self.learning_rate, decay=self.rho,
            epsilon=self.epsilon)
