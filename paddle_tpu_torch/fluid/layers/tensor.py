"""Tensor layers (reference: python/paddle/v2/fluid/layers/tensor.py):
the subset whose ops the port has."""

import numpy as np

from ..framework import Variable
from ..initializer import Constant
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["create_tensor", "create_parameter", "create_global_var", "cast",
           "concat", "sums", "assign", "fill_constant",
           "fill_constant_batch_size_like", "ones", "zeros", "reshape",
           "increment"]


def create_tensor(dtype, name=None, persistable=False, **kwargs):
    helper = LayerHelper("create_tensor", name=name, **kwargs)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


def create_parameter(shape, dtype, attr=None, is_bias=False,
                     default_initializer=None, **kwargs):
    helper = LayerHelper("create_parameter", **kwargs)
    return helper.create_parameter(ParamAttr.to_attr(attr), shape, dtype,
                                   is_bias, default_initializer)


def create_global_var(shape, value, dtype, persistable=False, name=None,
                      **kwargs):
    helper = LayerHelper("global_var", name=name, **kwargs)
    var = helper.create_global_variable(
        dtype=dtype, shape=shape, persistable=persistable, name=name)
    helper.set_variable_initializer(var, Constant(value))
    return var


def cast(x, dtype, **kwargs):
    helper = LayerHelper("cast", **kwargs)
    out = helper.create_tmp_variable(dtype, lod_level=x.lod_level)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


def concat(input, axis=0, **kwargs):
    """The inputs joined along `axis` (ragged inputs along a feature
    axis stay ragged).  The output's dtype is inferred, as on the JAX
    side."""
    helper = LayerHelper("concat", **kwargs)
    out = helper.create_tmp_variable(helper.input_dtype)
    helper.append_op(type="concat", inputs={"X": input},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def sums(input, out=None, **kwargs):
    helper = LayerHelper("sum", **kwargs)
    if out is None:
        out = helper.create_tmp_variable(input[0].dtype)
    helper.append_op(type="sum", inputs={"X": input},
                     outputs={"Out": [out]})
    return out


def assign(input, output, **kwargs):
    """`output` = `input`: a Variable by an `assign` op, an array (or
    anything numpy takes) by an `assign_value` op holding its values."""
    helper = LayerHelper("assign", **kwargs)
    if isinstance(input, Variable):
        helper.append_op(type="assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
    else:
        arr = np.asarray(input)
        helper.append_op(
            type="assign_value", outputs={"Out": [output]},
            attrs={"shape": list(arr.shape), "dtype": str(arr.dtype),
                   "values": arr.reshape(-1).tolist()})
    return output


def fill_constant(shape, dtype, value, out=None, **kwargs):
    helper = LayerHelper("fill_constant", **kwargs)
    if out is None:
        out = helper.create_tmp_variable(dtype, stop_gradient=True)
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape],
                            "dtype": dtype, "value": float(value)})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0,
                                  **kwargs):
    """`value` in a tensor of `shape` whose dim `output_dim_idx` is dim
    `input_dim_idx` of `input` at run time (the batch)."""
    helper = LayerHelper("fill_constant_batch_size_like", **kwargs)
    out = helper.create_tmp_variable(dtype, stop_gradient=True)
    helper.append_op(
        type="fill_constant_batch_size_like",
        inputs={"Input": [input]}, outputs={"Out": [out]},
        attrs={"shape": [int(s) for s in shape], "dtype": dtype,
               "value": float(value), "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx})
    return out


def ones(shape, dtype, **kwargs):
    return fill_constant(shape=shape, dtype=dtype, value=1.0, **kwargs)


def zeros(shape, dtype, **kwargs):
    return fill_constant(shape=shape, dtype=dtype, value=0.0, **kwargs)


def reshape(x, shape, act=None, **kwargs):
    helper = LayerHelper("reshape", **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="reshape", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape]})
    if act:
        tmp = helper.create_tmp_variable(out.dtype)
        helper.append_op(type=act, inputs={"X": [out]},
                         outputs={"Out": [tmp]})
        return tmp
    return out


def increment(x, value=1.0, in_place=True, **kwargs):
    """x + value in x's dtype, into x itself or, with in_place=False, a
    new variable."""
    helper = LayerHelper("increment", **kwargs)
    out = x if in_place else helper.create_tmp_variable(x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out
