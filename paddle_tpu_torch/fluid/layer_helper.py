"""LayerHelper: what every `fluid.layers` function builds through.

Counterpart of paddle_tpu/fluid/layer_helper.py (reference:
python/paddle/v2/fluid/layer_helper.py:24): the layer's unique name,
its parameters (declared in the main program, initialised once in the
startup program), temporaries, global variables, the bias add and the
activation.
"""

from .framework import (Variable, default_main_program,
                        default_startup_program, unique_name)
from .param_attr import ParamAttr

__all__ = ["LayerHelper"]


def _broadcast_attrs(attr, n):
    """One ParamAttr (or a list) as exactly n entries: each extra entry
    a fresh unnamed copy of the first's settings."""
    attrs = [attr] if isinstance(attr, ParamAttr) else list(attr)
    if len(attrs) == n:
        return attrs
    if len(attrs) == 1:
        a = attrs[0]
        return attrs + [ParamAttr(initializer=a.initializer,
                                  learning_rate=a.learning_rate,
                                  regularizer=a.regularizer,
                                  trainable=a.trainable)
                        for _ in range(n - 1)]
    raise ValueError("got %d param_attr entries for %d inputs"
                     % (len(attrs), n))


class LayerHelper:
    """One per layer call; `args` are that call's keyword arguments."""

    def __init__(self, layer_type, **args):
        self.layer_type = layer_type
        if not args.get("name"):
            args["name"] = unique_name(layer_type,
                                       program=args.get("main_program"))
        self.kwargs = args

    @property
    def name(self):
        return self.kwargs["name"]

    @property
    def main_program(self):
        return self.kwargs.get("main_program") or default_main_program()

    @property
    def startup_program(self):
        return self.kwargs.get("startup_program") or \
            default_startup_program()

    def _uniq(self, suffix):
        return unique_name("%s.%s" % (self.name, suffix),
                           program=self.kwargs.get("main_program"))

    def multiple_input(self, input_param_name="input"):
        given = self.kwargs.get(input_param_name, [])
        return [given] if isinstance(given, Variable) else list(given)

    @property
    def input_dtype(self):
        dtypes = {v.dtype for v in self.multiple_input()}
        if len(dtypes) > 1:
            raise ValueError("mixed input dtypes in %s: %s"
                             % (self.layer_type, sorted(dtypes)))
        return dtypes.pop() if dtypes else None

    @property
    def param_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("bias_attr"))

    def iter_inputs_and_params(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        return zip(inputs, _broadcast_attrs(self.param_attr, len(inputs)))

    def _declare_initialized(self, name, shape, dtype, initializer):
        """Declare `name` persistable in the startup program and append
        its init op there."""
        block = self.startup_program.global_block()
        svar = block.create_var(name=name, shape=shape, dtype=dtype,
                                persistable=True)
        initializer(svar, block)
        return svar

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        if attr.name is None:
            attr.name = self._uniq("w")
        if default_initializer is not None:
            attr.set_default_initializer(default_initializer)
        elif is_bias:
            attr.set_default_bias_initializer()
        else:
            attr.set_default_param_initializer()
        shape = [int(s) for s in shape]
        kwargs = attr.to_kwargs()
        kwargs.pop("name")
        param = self.main_program.global_block().create_parameter(
            shape=shape, dtype=dtype, name=attr.name, **kwargs)
        self._declare_initialized(attr.name, shape, dtype,
                                  attr.initializer)
        return param

    def set_variable_initializer(self, var, initializer):
        self._declare_initialized(var.name, var.shape, var.dtype,
                                  initializer)
        return var

    def create_tmp_variable(self, dtype, stop_gradient=False,
                            lod_level=None, shape=None):
        kwargs = {} if shape is None else {"shape": list(shape)}
        return self.main_program.current_block().create_var(
            name=self._uniq("tmp"), dtype=dtype,
            stop_gradient=stop_gradient, lod_level=lod_level, **kwargs)

    def create_variable(self, *args, **kwargs):
        return self.main_program.current_block().create_var(
            *args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs)

    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        """input + b, b shaped like dims [dim_start, dim_end) of the
        input; the input itself when the layer has bias_attr=False."""
        attr = self.bias_attr
        if attr is None:
            return input_var
        bias = self.create_parameter(
            attr, shape=list(input_var.shape[dim_start:dim_end]),
            dtype=input_var.dtype, is_bias=True)
        out = self.create_tmp_variable(dtype=input_var.dtype,
                                       lod_level=input_var.lod_level)
        self.append_op(type="elementwise_add",
                       inputs={"X": [input_var], "Y": [bias]},
                       outputs={"Out": [out]}, attrs={"axis": dim_start})
        return out

    def append_activation(self, input_var):
        """The layer's `act` ('relu' or {'type': ..., attrs}) applied to
        `input_var`; the input itself when there is none."""
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        attrs = dict({"type": act} if isinstance(act, str) else act)
        act_type = attrs.pop("type")
        out = self.create_tmp_variable(dtype=input_var.dtype,
                                       lod_level=input_var.lod_level)
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [out]}, attrs=attrs)
        return out
