"""v2 parameter/extra attributes (reference: python/paddle/v2/attr.py
over trainer_config_helpers/attrs.py).  The port's copy of
paddle_tpu/v2/attr.py."""

from ..fluid.param_attr import ParamAttr

__all__ = ["Param", "ParamAttr", "Extra", "ExtraAttr"]


def Param(name=None, initial_std=None, initial_mean=None, is_static=False,
          learning_rate=None, l2_rate=None, sparse_update=False, **kw):
    from ..fluid import initializer, regularizer

    init = None
    if initial_std is not None or initial_mean is not None:
        init = initializer.Normal(loc=initial_mean or 0.0,
                                  scale=initial_std
                                  if initial_std is not None else 0.01)
    reg = regularizer.L2Decay(l2_rate) if l2_rate else None
    return ParamAttr(name=name, initializer=init,
                     learning_rate=learning_rate
                     if learning_rate is not None else 1.0,
                     regularizer=reg,
                     trainable=not is_static)


class ExtraAttr:
    def __init__(self, drop_rate=None, device=None, **kw):
        self.drop_rate = drop_rate
        self.device = device


Extra = ExtraAttr
