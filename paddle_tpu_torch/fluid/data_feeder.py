"""DataFeeder: reader rows to feed tensors on the place's device.

Counterpart of paddle_tpu/fluid/data_feeder.py (reference:
python/paddle/v2/fluid/data_feeder.py).  A dense slot of a batch of
reader rows is stacked into one array of the slot's declared dtype,
reshaped to [-1] + the sample shape.  A ragged slot (lod_level > 0)
becomes a RaggedTensor: its row splits come from a level-by-level
flatten of the nested samples, its flat rows are padded with zeros up
to a multiple of `ragged_bucket` (DEFAULT_RAGGED_BUCKET, so the flat
lengths the card sees are few), `nvalid` counts the real rows and
`max_seqlen` is the innermost level's longest sequence bucketed by
`bucket_max_seqlen`.  Either way int64 ids are range-checked, then run
as int32, as the executor converts a feed.  Each array placed on the
device counts its bytes as h2d (`obs.telemetry.on_transfer`; a ragged
slot its values), as the JAX feeder counts its device_put: the
executor then counts nothing for the feed that is already there.
"""

import numpy as np

from ..core.ragged import RaggedTensor, bucket_max_seqlen
from ..core.types import (canonical_dtype, guard_int64_narrowing,
                          tensor_from_numpy)
from ..obs import telemetry as obs_tele
from .framework import Variable, default_main_program

__all__ = ["DataFeeder", "DEFAULT_RAGGED_BUCKET"]

# the flat row count of a ragged feed pads up to a multiple of this
DEFAULT_RAGGED_BUCKET = 64


def _sample_shape(shape, lod_level=0):
    """The shape of one sample (a dense slot) or of one row of values (a
    ragged slot).  A dense slot drops its leading dim when that is the
    dynamic batch dim, and a var made with append_batch_size=False keeps
    its static dims; a ragged slot keeps the non-negative dims."""
    if lod_level:
        return [s for s in shape if s >= 0]
    if shape and shape[0] < 0:
        return list(shape[1:])
    return [s for s in shape if s >= 0] or None


def _nested_row_splits(batch, depth):
    """(splits, rows): `depth` levels of nesting flattened one level per
    sweep, each level's int32 offsets partitioning the next level's
    rows; the innermost rows are the values."""
    splits = []
    rows = list(batch)
    for _ in range(depth):
        lengths = [len(group) for group in rows]
        splits.append(np.cumsum([0] + lengths).astype(np.int32))
        rows = [item for group in rows for item in group]
    return splits, rows


def _round_up(n, multiple):
    return max(multiple, -(-n // multiple) * multiple)


class DataFeeder:
    """feed(rows) -> {name: tensor or RaggedTensor on `place`'s device}
    for the Variables (or names, looked up in `program`) of `feed_list`,
    one per slot of a row."""

    def __init__(self, feed_list, place, program=None,
                 ragged_bucket=DEFAULT_RAGGED_BUCKET):
        if program is None:
            program = default_main_program()
        self.feed_names, self.feed_dtypes, self.feed_shapes = [], [], []
        self.feed_lod_level = []
        self.ragged_bucket = ragged_bucket
        for var in feed_list:
            if isinstance(var, str):
                var = program.global_block().var(var)
            if not isinstance(var, Variable):
                raise TypeError("feed_list should contain Variables")
            self.feed_names.append(var.name)
            self.feed_dtypes.append(np.dtype(canonical_dtype(var.dtype)))
            self.feed_lod_level.append(var.lod_level)
            self.feed_shapes.append(_sample_shape(var.shape, var.lod_level))
        self.place = place
        self.device = place.device()

    def _ragged(self, name, samples, lod_level, shape, dtype):
        splits, rows = _nested_row_splits(samples, lod_level)
        shape = tuple(shape)
        rows = [np.asarray(r, dtype=dtype) for r in rows]
        rows = [r.reshape(shape) if shape and r.shape != shape else r
                for r in rows]
        values = (np.stack(rows, 0) if rows
                  else np.zeros((0,) + shape, dtype))
        total = values.shape[0]
        if self.ragged_bucket:
            pad = _round_up(total, self.ragged_bucket) - total
            if pad:
                values = np.concatenate(
                    [values, np.zeros((pad,) + values.shape[1:],
                                      values.dtype)], 0)
        guard_int64_narrowing(values, name)
        inner = splits[-1]
        obs_tele.on_transfer("h2d", values.nbytes)
        return RaggedTensor(
            tensor_from_numpy(values, self.device),
            [tensor_from_numpy(s, self.device) for s in splits],
            nvalid=total,
            max_seqlen=bucket_max_seqlen(inner[1:] - inner[:-1]))

    def feed(self, iterable):
        columns = [[] for _ in self.feed_names]
        for row in iterable:
            if len(row) != len(columns):
                raise ValueError("reader row has %d slots, feed_list "
                                 "expects %d" % (len(row), len(columns)))
            for column, value in zip(columns, row):
                column.append(value)
        out = {}
        for name, column, dtype, shape, lod_level in zip(
                self.feed_names, columns, self.feed_dtypes,
                self.feed_shapes, self.feed_lod_level):
            if lod_level:
                out[name] = self._ragged(name, column, lod_level, shape,
                                         dtype)
                continue
            arr = np.array(column, dtype=dtype)
            if shape is not None:
                arr = arr.reshape([-1] + list(shape))
            guard_int64_narrowing(arr, name)
            obs_tele.on_transfer("h2d", arr.nbytes)
            out[name] = tensor_from_numpy(arr, self.device)
        return out
