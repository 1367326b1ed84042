"""v2 activation objects (reference: python/paddle/v2/activation.py over
trainer_config_helpers/activations.py).  A copy of
paddle_tpu/v2/activation.py."""

__all__ = ["Tanh", "Sigmoid", "Softmax", "Identity", "Linear", "Relu",
           "BRelu", "SoftRelu", "STanh", "Abs", "Square", "Exp", "Log",
           "SquareActivation"]


class BaseActivation:
    name = None

    def __repr__(self):
        return "activation.%s" % type(self).__name__


def _make(cls_name, act_name):
    cls = type(cls_name, (BaseActivation,), {"name": act_name})
    return cls


Tanh = _make("Tanh", "tanh")
Sigmoid = _make("Sigmoid", "sigmoid")
Softmax = _make("Softmax", "softmax")
Identity = _make("Identity", None)
Linear = Identity
Relu = _make("Relu", "relu")
BRelu = _make("BRelu", "brelu")
SoftRelu = _make("SoftRelu", "soft_relu")
STanh = _make("STanh", "stanh")
Abs = _make("Abs", "abs")
Square = _make("Square", "square")
SquareActivation = Square
Exp = _make("Exp", "exp")
Log = _make("Log", "log")
