"""Parameter initializers as startup-program ops.

Counterpart of paddle_tpu/fluid/initializer.py (reference:
python/paddle/v2/fluid/initializer.py — Constant, Uniform, Normal,
Xavier, MSRA).  Each call appends its init op (`fill_constant`,
`uniform_random`, `gaussian_random`) to the startup block with the JAX
package's attrs, so the startup programs are equal; the values drawn
differ (torch's generator is not JAX's PRNG).
"""

import math

__all__ = ["Constant", "Uniform", "Normal", "Xavier", "MSRA",
           "ConstantInitializer", "UniformInitializer", "NormalInitializer",
           "XavierInitializer", "MSRAInitializer", "Initializer"]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _fan_in_out(var):
        """(fan_in, fan_out): a conv weight [out_c, in_c, kh, kw] counts
        its first two dims times the receptive field."""
        shape = var.shape
        if len(shape) < 2:
            return (1, shape[0] if shape else 1)
        receptive = 1
        for d in shape[2:]:
            receptive *= d
        return shape[1] * receptive, shape[0] * receptive


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            type="fill_constant", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            type="uniform_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "min": float(self.low), "max": float(self.high),
                   "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            type="gaussian_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": float(self.loc), "std": float(self.scale),
                   "seed": self.seed})


class XavierInitializer(Initializer):
    """Glorot & Bengio 2010: U(±sqrt(6 / (fan_in + fan_out))) or
    N(0, sqrt(2 / (fan_in + fan_out)))."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = \
            uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fan_in, fan_out = self._fan_in_out(var)
        fan_in = self.fan_in if self.fan_in is not None else fan_in
        fan_out = self.fan_out if self.fan_out is not None else fan_out
        if self.uniform:
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fan_in + fan_out))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """He et al. 2015: U(±sqrt(6 / fan_in)) or N(0, sqrt(2 / fan_in))."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fan_in, _ = self._fan_in_out(var)
        fan_in = self.fan_in if self.fan_in is not None else fan_in
        if self.uniform:
            limit = math.sqrt(6.0 / fan_in)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / fan_in)
            NormalInitializer(0.0, std, self.seed)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
