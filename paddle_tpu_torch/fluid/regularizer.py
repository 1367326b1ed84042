"""Weight-decay regularizers, appended as ops to the grads.

Counterpart of paddle_tpu/fluid/regularizer.py (reference:
python/paddle/v2/fluid/regularizer.py — append_regularization_ops,
L1DecayRegularizer, L2DecayRegularizer).  A regularizer appends its
decay term of a parameter (`scale` of the parameter; L1 a `scale` of its
`sign`) to the grad's block, and `append_regularization_ops` sums it
into the grad (`sum`), so the update ops read `grad + coeff * term`.  A
parameter's own `regularizer` (its ParamAttr's) overrides the
optimizer's `regularization`.  The ops and names are the JAX package's.
"""

from . import framework

__all__ = ["append_regularization_ops", "L1Decay", "L2Decay",
           "L1DecayRegularizer", "L2DecayRegularizer"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(
            name=framework.unique_name(param.name + "_l2_decay"),
            dtype=param.dtype, shape=param.shape)
        block.append_op(type="scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._regularization_coeff})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(
            name=framework.unique_name(param.name + "_sign"),
            dtype=param.dtype, shape=param.shape)
        block.append_op(type="sign", inputs={"X": [param]},
                        outputs={"Out": [sign]})
        decay = block.create_var(
            name=framework.unique_name(param.name + "_l1_decay"),
            dtype=param.dtype, shape=param.shape)
        block.append_op(type="scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._regularization_coeff})
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    """[(param, grad)] with each regularized grad replaced by a new var
    holding `grad + term` (reference: regularizer.py
    append_regularization_ops)."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        reg = getattr(param, "regularizer", None) or regularization
        term = reg(param, grad, grad.block) \
            if grad is not None and reg is not None else None
        if term is None:
            params_and_grads.append((param, grad))
            continue
        block = grad.block
        new_grad = block.create_var(
            name=framework.unique_name(grad.name + "_reg"),
            dtype=grad.dtype, shape=grad.shape)
        block.append_op(type="sum", inputs={"X": [grad, term]},
                        outputs={"Out": [new_grad]})
        params_and_grads.append((param, new_grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
