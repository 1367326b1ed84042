"""Data layers (reference: python/paddle/v2/fluid/layers/io.py)."""

from ...core.types import VarType
from ..layer_helper import LayerHelper

__all__ = ["data"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=VarType.DENSE_TENSOR, stop_gradient=True, **kwargs):
    """A feed variable; with `append_batch_size` its leading dim is -1
    (any batch)."""
    helper = LayerHelper("data", name=name, **kwargs)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.create_global_variable(
        name=name, shape=shape, dtype=dtype, type=type,
        stop_gradient=stop_gradient, lod_level=lod_level)
