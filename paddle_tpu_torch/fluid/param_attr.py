"""ParamAttr: per-parameter configuration.

Counterpart of paddle_tpu/fluid/param_attr.py (reference:
python/paddle/v2/fluid/param_attr.py): a name, an initializer, a
learning-rate scale, a regularizer (fluid/regularizer.py; it overrides
the optimizer's `regularization` for this parameter), `trainable`, and
a gradient clip (fluid/clip.py; `clip` and `gradient_clip` name the
same field), which the parameter carries as `gradient_clip_attr`.
"""

from .initializer import Constant, Initializer, Xavier

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, clip=None,
                 gradient_clip=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip if gradient_clip is not None \
            else clip

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
                "trainable": self.trainable,
                "gradient_clip_attr": self.gradient_clip}
