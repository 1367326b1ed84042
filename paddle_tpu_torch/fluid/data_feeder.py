"""DataFeeder: reader rows to feed tensors on the place's device.

Counterpart of paddle_tpu/fluid/data_feeder.py (reference:
python/paddle/v2/fluid/data_feeder.py), dense slots only: each slot of
a batch of reader rows is stacked into one array of the slot's declared
dtype, reshaped to [-1] + the sample shape, and converted as the
executor converts a feed (`executor.prepare_feed`: int64 ids are
range-checked, then run as int32).  A slot with lod_level > 0 raises:
ragged feeds come with ROADMAP A7.
"""

import numpy as np

from ..core.types import (canonical_dtype, guard_int64_narrowing,
                          tensor_from_numpy)
from .framework import Variable, default_main_program

__all__ = ["DataFeeder"]


def _sample_shape(shape):
    """The shape of one sample of a slot: the var's shape without its
    leading dim when that is the dynamic batch dim; a var made with
    append_batch_size=False keeps its static dims."""
    if shape and shape[0] < 0:
        return list(shape[1:])
    return [s for s in shape if s >= 0] or None


class DataFeeder:
    """feed(rows) -> {name: tensor on `place`'s device} for the
    Variables (or names, looked up in `program`) of `feed_list`, one
    per slot of a row."""

    def __init__(self, feed_list, place, program=None):
        if program is None:
            program = default_main_program()
        self.feed_names, self.feed_dtypes, self.feed_shapes = [], [], []
        for var in feed_list:
            if isinstance(var, str):
                var = program.global_block().var(var)
            if not isinstance(var, Variable):
                raise TypeError("feed_list should contain Variables")
            if var.lod_level:
                raise NotImplementedError(
                    "DataFeeder: %r has lod_level %d; ragged feeds come "
                    "with ROADMAP A7" % (var.name, var.lod_level))
            self.feed_names.append(var.name)
            self.feed_dtypes.append(np.dtype(canonical_dtype(var.dtype)))
            self.feed_shapes.append(_sample_shape(var.shape))
        self.place = place
        self.device = place.device()

    def feed(self, iterable):
        columns = [[] for _ in self.feed_names]
        for row in iterable:
            if len(row) != len(columns):
                raise ValueError("reader row has %d slots, feed_list "
                                 "expects %d" % (len(row), len(columns)))
            for column, value in zip(columns, row):
                column.append(value)
        out = {}
        for name, column, dtype, shape in zip(
                self.feed_names, columns, self.feed_dtypes,
                self.feed_shapes):
            arr = np.array(column, dtype=dtype)
            if shape is not None:
                arr = arr.reshape([-1] + list(shape))
            guard_int64_narrowing(arr, name)
            out[name] = tensor_from_numpy(arr, self.device)
        return out
