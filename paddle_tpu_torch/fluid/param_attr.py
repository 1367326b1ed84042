"""ParamAttr: per-parameter configuration.

Counterpart of paddle_tpu/fluid/param_attr.py (reference:
python/paddle/v2/fluid/param_attr.py): a name, an initializer, a
learning-rate scale, a regularizer (fluid/regularizer.py; it overrides
the optimizer's `regularization` for this parameter) and `trainable`.
Gradient clips wait with `clip.py` (ROADMAP A5).
"""

from .initializer import Constant, Initializer, Xavier

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable

    def set_default_initializer(self, initializer):
        if self.initializer is None:
            self.initializer = initializer

    def set_default_param_initializer(self):
        self.set_default_initializer(Xavier())

    def set_default_bias_initializer(self):
        self.set_default_initializer(Constant(0.0))

    @staticmethod
    def to_attr(arg):
        """A ParamAttr from None, a ParamAttr, a name, an Initializer or
        a list of them; False (no bias) gives None."""
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr.to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, bool):
            return ParamAttr() if arg else None
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError("cannot make ParamAttr from %r" % (arg,))

    def to_kwargs(self):
        return {"name": self.name,
                "optimize_attr": {"learning_rate": self.learning_rate},
                "regularizer": self.regularizer,
                "trainable": self.trainable}
