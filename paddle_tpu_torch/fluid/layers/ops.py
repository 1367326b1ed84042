"""Unary and elementwise layers, generated from op lists.

Counterpart of paddle_tpu/fluid/layers/ops.py (reference:
layers/ops.py, generated from the OpProtos): one layer per activation
op of the JAX package's list (ops/activation.py; a keyword argument of
the layer becomes an attr of its op), `mean`, `scale`, `sign` and the
`elementwise_*` family.
"""

from ..layer_helper import LayerHelper

__act_ops__ = [
    "sigmoid", "logsigmoid", "exp", "relu", "tanh", "tanh_shrink",
    "softshrink", "hard_shrink", "sqrt", "abs", "ceil", "floor", "round",
    "reciprocal", "log", "square", "softplus", "softsign", "brelu",
    "leaky_relu", "soft_relu", "elu", "relu6", "pow", "stanh",
    "thresholded_relu", "hard_sigmoid", "swish",
]

__all__ = __act_ops__ + ["mean", "scale", "sign"]


def _make_unary(op_type):
    def layer(x=None, **kwargs):
        if x is None:
            x = kwargs.pop("input")
        attrs = {k: v for k, v in kwargs.items()
                 if k not in ("name", "main_program", "startup_program")}
        helper = LayerHelper(op_type, name=kwargs.get("name"))
        out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    layer.__name__ = op_type
    return layer


for _op in __act_ops__ + ["sign"]:
    globals()[_op] = _make_unary(_op)


def mean(x=None, **kwargs):
    if x is None:
        x = kwargs.pop("input")
    helper = LayerHelper("mean", name=kwargs.get("name"))
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def scale(x=None, scale=1.0, **kwargs):
    if x is None:
        x = kwargs.pop("input")
    helper = LayerHelper("scale", name=kwargs.get("name"))
    out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
    helper.append_op(type="scale", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"scale": scale})
    return out


def _make_elementwise(op_type):
    def layer(x, y, axis=-1, act=None, name=None, **kwargs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        if act is None:
            return out
        tmp = helper.create_tmp_variable(out.dtype, lod_level=out.lod_level)
        helper.append_op(type=act, inputs={"X": [out]},
                         outputs={"Out": [tmp]})
        return tmp

    layer.__name__ = op_type
    return layer


for _op in ("elementwise_add", "elementwise_sub", "elementwise_mul",
            "elementwise_div", "elementwise_max", "elementwise_min",
            "elementwise_pow"):
    globals()[_op] = _make_elementwise(_op)
    __all__.append(_op)
