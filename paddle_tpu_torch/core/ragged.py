"""Ragged (LoD) tensors over torch tensors.

Counterpart of paddle_tpu/core/ragged.py (reference: paddle/framework/
lod_tensor.h:43-58, a dense tensor plus per-level offset vectors).  A
`RaggedTensor` holds the flat `values` [T, ...] of every sequence of its
last level, one int32 offset tensor per level in `row_splits` (the
reference's LoD offsets, outer to inner), `nvalid`, an int32 scalar
tensor counting the valid rows of `values` (rows past it pad the flat
length to a bucket), and `max_seqlen`, a static Python int bounding any
one sequence's length.  Kernels reach the structure through tensors on
the values' device (`segment_ids`, `valid_mask`, `seq_lengths`) and the
host ints `nseq` and `max_seqlen`, so no kernel waits on the device to
learn a shape.

`RaggedTensor` is a torch pytree node (its tensors the leaves, its lod
level and `max_seqlen` the context), so `torch.utils._pytree` maps over
it, as the executor does to move a fed value to the card.
`torch.func.vjp` cannot take one as a primal (its int leaves cannot
require grad), so the generic grad differentiates its values and
rebuilds it around them (ops/registry.py).

`SelectedRows` is the sparse gradient of `lookup_table(is_sparse=True)`
(reference: paddle/framework/selected_rows.h:19): `rows`, the int32 ids
of its rows (they may repeat, and they are the raw ids, not wrapped),
`values` [nrows, ...], and `height`, the static row count of the dense
tensor it stands for.  Its rows index as the JAX side's scatter does
(`row_index`): a negative id in [-height, 0) counts from the end, and
the rows of any other id outside [0, height) add nothing.  It is a
torch pytree node too, `height` its context.
"""

import numpy as np
import torch
import torch.utils._pytree as pytree

from .types import guard_int64_narrowing, tensor_from_numpy

__all__ = ["RaggedTensor", "SelectedRows", "add_rows_",
           "bucket_max_seqlen", "host_copy", "ragged_to_sequences",
           "row_index", "slice_ragged", "sum_rows"]


def bucket_max_seqlen(lengths):
    """Static per-sequence length bound: the longest of `lengths`
    rounded up to the next power of two (at least 8), so the number of
    distinct padded extents stays logarithmic in the length."""
    m = max([int(x) for x in lengths] or [1])
    b = 8
    while b < m:
        b *= 2
    return b


class RaggedTensor:
    """values: [T, ...] flat over all sequences of the last level.
    row_splits: list (outer to inner) of int32 offset tensors, each
    [N_i + 1].  nvalid: int32 scalar tensor, the valid rows of values
    (default: the last offset).  max_seqlen: a static Python int bound on
    any one sequence's length, or None (then a densified time axis must
    take all T rows)."""

    def __init__(self, values, row_splits, nvalid=None, max_seqlen=None):
        self.values = values
        dev = values.device
        self.row_splits = [torch.as_tensor(rs, dtype=torch.int32,
                                           device=dev)
                           for rs in row_splits]
        if nvalid is None:
            nvalid = (self.row_splits[-1][-1] if self.row_splits
                      else values.shape[0])
        # a host count is filled in on the device, no host data copied
        # (a CUDA graph capture allows no such copy)
        self.nvalid = torch.as_tensor(nvalid, dtype=torch.int32,
                                      device=dev) \
            if isinstance(nvalid, torch.Tensor) else \
            torch.full((), int(nvalid), dtype=torch.int32, device=dev)
        self.max_seqlen = None if max_seqlen is None else int(max_seqlen)

    # -- structure ------------------------------------------------------------
    @property
    def lod_level(self):
        return len(self.row_splits)

    def nseq(self, level=0):
        """The number of sequences at `level` (static)."""
        return self.row_splits[level].shape[0] - 1

    def last_splits(self):
        return self.row_splits[-1]

    def lod(self):
        """A host copy in the reference's LoD format (offset lists)."""
        return [rs.cpu().tolist() for rs in self.row_splits]

    # -- the kernels' bridge --------------------------------------------------
    def segment_ids(self, level=-1):
        """int32 [T]: the sequence (at `level`) of each row of values;
        padding rows get `nseq`, one past the last, so a segment
        reduction over nseq segments drops them."""
        rs = self.row_splits[level]
        nseq = rs.shape[0] - 1
        pos = torch.arange(self.values.shape[0], dtype=torch.int32,
                           device=rs.device)
        seg = torch.searchsorted(rs, pos, right=True, out_int32=True) - 1
        return torch.where(pos < self.nvalid, seg.clamp(0, nseq - 1),
                           nseq).to(torch.int32)

    def valid_mask(self):
        pos = torch.arange(self.values.shape[0], dtype=torch.int32,
                           device=self.values.device)
        return pos < self.nvalid

    def seq_lengths(self, level=-1):
        rs = self.row_splits[level]
        return rs[1:] - rs[:-1]

    def with_values(self, values):
        """The same structure over new values (same lengths, so the
        `max_seqlen` hint carries over)."""
        return RaggedTensor(values, self.row_splits, self.nvalid,
                            max_seqlen=self.max_seqlen)

    def to(self, device):
        """Every tensor moved to `device`."""
        return pytree.tree_map(lambda t: t.to(device), self)

    # -- construction ---------------------------------------------------------
    @staticmethod
    def from_sequences(seqs, dtype=None, bucket=None):
        """Lod level 1 from a list of per-sequence arrays (or lists), as
        CPU tensors of their execution dtype (int64 ids range-checked,
        then int32).  `bucket` pads the flat length up to a multiple of
        it, at least one bucket."""
        arrs = [np.asarray(s, dtype=dtype) for s in seqs]
        lengths = [a.shape[0] for a in arrs]
        splits = np.zeros(len(arrs) + 1, np.int32)
        np.cumsum(lengths, out=splits[1:])
        total = int(splits[-1])
        flat = (np.concatenate(arrs, axis=0) if total > 0 else
                np.zeros((0,) + tuple(arrs[0].shape[1:]), arrs[0].dtype))
        if bucket:
            padded_t = max(bucket,
                           int(np.ceil(max(total, 1) / bucket)) * bucket)
            if padded_t > total:
                flat = np.concatenate(
                    [flat, np.zeros((padded_t - total,) + flat.shape[1:],
                                    flat.dtype)], 0)
        guard_int64_narrowing(flat, "from_sequences")
        return RaggedTensor(tensor_from_numpy(flat, "cpu"),
                            [torch.from_numpy(splits)], nvalid=total,
                            max_seqlen=bucket_max_seqlen(lengths))

    def __repr__(self):
        return "RaggedTensor(values=%s %s, lod_level=%d, nseq=%d)" % (
            tuple(self.values.shape), self.values.dtype, self.lod_level,
            self.nseq(0) if self.row_splits else 0)


def row_index(rows, height):
    """(index, valid): `rows` with a negative id counted from the end,
    clamped into [0, height) so that it can index on the card, and the
    mask of the ids that were in [-height, height).  A scatter adds
    nothing at an invalid id when it adds -0.0 there, the one addend
    that leaves every float, -0.0 included, as it is."""
    rows = rows.reshape(-1)
    wrapped = torch.where(rows < 0, rows + height, rows)
    valid = (wrapped >= 0) & (wrapped < height)
    return wrapped.clamp(0, height - 1), valid


def sum_rows(index, values):
    """(ids [N], sums [N, ...]): the rows of `values` summed by `index`
    (ids into a table, each in range) in an order fixed by the data
    alone.  The ids are sorted stably, and each run of equal ids is
    summed in row order by one segment reduction (`segment_reduce`, a
    loop over the run per output element), so the same inputs give the
    same bits on every run, where `index_add_`'s atomic adds on the card
    sum a repeated id in a varying order.  Run k's id is ids[k] and its
    sum sums[k]; the N - nruns entries past the last run repeat the
    last id with sums of -0.0, the one addend that leaves every float
    as it is, so no host sync learns the run count.  A sum starts from
    -0.0 for the same reason: a run whose rows are all -0.0 adds
    nothing."""
    n = index.shape[0]
    sorted_ids, perm = torch.sort(index, stable=True)
    starts = torch.ones(n, dtype=torch.bool, device=index.device)
    starts[1:] = sorted_ids[1:] != sorted_ids[:-1]
    run_of_row = torch.cumsum(starts, 0) - 1
    offsets = torch.searchsorted(
        run_of_row, torch.arange(n + 1, device=index.device))
    sums = torch.segment_reduce(values[perm], "sum", offsets=offsets,
                                axis=0, unsafe=True, initial=-0.0)
    return sorted_ids[offsets[:-1].clamp(max=n - 1)], sums


def add_rows_(x, rows, values):
    """`x` with the rows of `values` added in place at the SelectedRows
    ids `rows`, as the JAX side's `x.at[rows].add(values)` adds them:
    negative ids wrap, and the rows of ids outside the table add -0.0.
    Repeated ids are summed first in a fixed order (`sum_rows`), so
    `index_add_` adds at most one addend other than -0.0 at any row and
    the result repeats bit for bit on the card.  Returns `x`."""
    if rows.numel() == 0:
        return x
    index, valid = row_index(rows, x.shape[0])
    mask = valid.reshape((-1,) + (1,) * (values.dim() - 1))
    values = torch.where(mask, values.to(x.dtype),
                         torch.full((), -0.0, dtype=x.dtype,
                                    device=x.device))
    ids, sums = sum_rows(index, values)
    return x.index_add_(0, ids, sums)


class SelectedRows:
    """rows: int32 [nrows] ids, which may repeat.  values: [nrows, ...].
    height: a static Python int, the dense tensor's row count."""

    def __init__(self, rows, values, height):
        self.rows = torch.as_tensor(rows, dtype=torch.int32,
                                    device=values.device)
        self.values = values
        self.height = int(height)

    @property
    def shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    @property
    def dtype(self):
        return self.values.dtype

    def to_dense(self):
        """The dense [height, ...] tensor: each row's values added at its
        id, so rows that repeat sum (`add_rows_`)."""
        return add_rows_(torch.zeros(self.shape, dtype=self.values.dtype,
                                     device=self.values.device),
                         self.rows, self.values)

    def to(self, device):
        """Rows and values moved to `device`."""
        return pytree.tree_map(lambda t: t.to(device), self)

    def __repr__(self):
        return "SelectedRows(nrows=%d, height=%d, values=%s %s)" % (
            self.rows.shape[0], self.height, tuple(self.values.shape),
            self.values.dtype)


def host_copy(r):
    """`r` (a RaggedTensor or SelectedRows) with every tensor on the CPU
    and bf16 values widened to f32: a fetch as the executor returns it
    (numpy holds no bf16)."""
    values = r.values.detach()
    if values.dtype == torch.bfloat16:
        values = values.float()
    if isinstance(r, SelectedRows):
        return SelectedRows(r.rows, values, r.height).to("cpu")
    return r.with_values(values).to("cpu")


def ragged_to_sequences(r):
    """The per-sequence value arrays of a lod-level-1 RaggedTensor on
    the host, its padding rows dropped (the inverse of
    `RaggedTensor.from_sequences`)."""
    if r.lod_level != 1:
        raise ValueError("ragged_to_sequences takes lod_level-1 values; got "
                         "lod_level=%d" % r.lod_level)
    r = host_copy(r)
    splits = r.row_splits[0].numpy()
    values = r.values.numpy()
    return [values[splits[i]:splits[i + 1]]
            for i in range(len(splits) - 1)]


def slice_ragged(r, nseq):
    """The first `nseq` level-0 sequences of a RaggedTensor, as a host
    copy; the rows past them, padding included, are dropped."""
    r = host_copy(r)
    take = int(nseq)
    out_splits = []
    for rs in r.row_splits:
        out_splits.append(rs[:take + 1].clone())
        take = int(rs[take])
    return RaggedTensor(r.values[:take].clone(), out_splits, nvalid=take)


def _flatten(rt):
    return ([rt.values] + list(rt.row_splits) + [rt.nvalid],
            (rt.lod_level, rt.max_seqlen))


def _unflatten(children, context):
    lod_level, max_seqlen = context
    rt = object.__new__(RaggedTensor)
    rt.values = children[0]
    rt.row_splits = list(children[1:1 + lod_level])
    rt.nvalid = children[1 + lod_level]
    rt.max_seqlen = max_seqlen
    return rt


pytree.register_pytree_node(
    RaggedTensor, _flatten, _unflatten,
    serialized_type_name="paddle_tpu_torch.core.ragged.RaggedTensor")


def _flatten_rows(sr):
    return [sr.rows, sr.values], sr.height


def _unflatten_rows(children, height):
    sr = object.__new__(SelectedRows)
    sr.rows, sr.values = children
    sr.height = height
    return sr


pytree.register_pytree_node(
    SelectedRows, _flatten_rows, _unflatten_rows,
    serialized_type_name="paddle_tpu_torch.core.ragged.SelectedRows")
