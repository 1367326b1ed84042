"""Arithmetic operators on graph Variables.

Counterpart of paddle_tpu/fluid/layers/math_op_patch.py (reference:
layers/math_op_patch.py): `x + y`, `x - 2.0`, `x / y` ... append the
`elementwise_*` op to the variable's block, a python number lifted into
a shape-[1] `fill_constant`; `x.astype(dtype)` appends a `cast`.
"""

from ..framework import Variable, unique_name

__all__ = ["install_variable_arithmetic"]


def _fresh_out(block, dtype, lod_level=0):
    return block.create_var(name=unique_name("tmp"), dtype=dtype,
                            lod_level=lod_level)


def _lift_scalar(value, block, dtype):
    out = block.create_var(name=unique_name("tmp"), shape=[1], dtype=dtype,
                           stop_gradient=True)
    block.append_op(type="fill_constant", outputs={"Out": [out]},
                    attrs={"dtype": dtype, "shape": [1],
                           "value": float(value)})
    return out


def _cast_to(self, dtype):
    out = _fresh_out(self.block, dtype)
    self.block.append_op(type="cast", inputs={"X": [self]},
                         outputs={"Out": [out]},
                         attrs={"in_dtype": self.dtype, "out_dtype": dtype})
    return out


# (dunder, op type, swap operands): swap only for the r-variants of the
# non-commutative ops
_BINARY_SPECS = (
    ("__add__", "elementwise_add", False),
    ("__radd__", "elementwise_add", False),
    ("__sub__", "elementwise_sub", False),
    ("__rsub__", "elementwise_sub", True),
    ("__mul__", "elementwise_mul", False),
    ("__rmul__", "elementwise_mul", False),
    ("__truediv__", "elementwise_div", False),
    ("__rtruediv__", "elementwise_div", True),
    ("__pow__", "elementwise_pow", False),
)


def _binary_dunder(op_type, swap):
    def method(self, other):
        block, dtype = self.block, self.dtype
        if not isinstance(other, Variable):
            other = _lift_scalar(other, block, dtype)
        x, y = (other, self) if swap else (self, other)
        out = _fresh_out(block, dtype, lod_level=self.lod_level)
        block.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                        outputs={"Out": [out]}, attrs={"axis": -1})
        return out

    return method


def install_variable_arithmetic():
    for name, op_type, swap in _BINARY_SPECS:
        method = _binary_dunder(op_type, swap)
        method.__name__ = name
        setattr(Variable, name, method)
    Variable.astype = _cast_to


install_variable_arithmetic()
