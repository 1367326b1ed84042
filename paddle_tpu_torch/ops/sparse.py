"""Embedding op kernels: `lookup_table` and its grad, dense or sparse.

Counterpart of paddle_tpu/ops/sparse.py (reference:
lookup_table_op.cc, the CTR workload's sparse-update path).  Ids are
dense or ragged (LoD): ragged ids give ragged rows over their splits,
and the rows that pad them to a bucket add nothing to the grad.  With
`is_sparse` the grad is a SelectedRows of one row per id, which the
optimizer update ops apply row by row.  `split_selected_rows` shards
such a grad by row range (reference: split_selected_rows_op.cc), as a
parameter-server layout that splits a table by rows would ship it.
"""

import torch

from ..core.ragged import RaggedTensor, SelectedRows, add_rows_
from .registry import like, register_grad_kernel, register_op, values_of


def _flat_ids(ids, vocab):
    """(raw, wrapped, valid): the ids flattened, negative ones counted
    from the end as jnp.take does, and the mask of those in range."""
    raw = ids.reshape(-1)
    flat = torch.where(raw < 0, raw + vocab, raw)
    return raw, flat, (flat >= 0) & (flat < vocab)


@register_op("lookup_table", nondiff_inputs=("Ids",),
             sparse_grad_slots=lambda attrs:
                 ("W",) if attrs.get("is_sparse") else ())
def lookup_table(ctx, ins, attrs):
    """Rows of W at Ids.  `padding_idx` rows come out zero.  A trailing
    size-1 ids dim is squeezed ([B, T, 1] ids give [B, T, d]), the
    reference convention the cached decode step relies on; [B, T] ids
    keep their shape.  Ids index as jnp.take does on the JAX side: a
    negative id counts from the end, and one outside [-vocab, vocab)
    gives a NaN row rather than a device-side assert.  Ragged ids give
    ragged rows [T, d] over their splits."""
    w = ins["W"][0]
    ids = values_of(ins["Ids"][0])
    vocab = w.shape[0]
    raw, flat, valid = _flat_ids(ids, vocab)
    out = w.index_select(0, flat.clamp(0, vocab - 1))
    out = torch.where(valid[:, None], out,
                      torch.full((), float("nan"), dtype=w.dtype,
                                 device=w.device))
    padding_idx = int(attrs.get("padding_idx", -1))
    if padding_idx >= 0:
        out = torch.where((raw == padding_idx)[:, None],
                          torch.zeros((), dtype=w.dtype, device=w.device),
                          out)
    if isinstance(ins["Ids"][0], RaggedTensor):
        return {"Out": [like(ins["Ids"][0], out)]}
    lead = tuple(ids.shape[:-1]) if ids.dim() > 1 and ids.shape[-1] == 1 \
        else tuple(ids.shape)
    return {"Out": [out.reshape(lead + (w.shape[1],))]}


@register_grad_kernel("lookup_table")
def lookup_table_grad(ctx, ins, attrs):
    """W@GRAD.  Dense: OG@Out's rows added into zeros at their ids
    (`core.ragged.add_rows_`: the rows of a repeated id are summed in a
    fixed order, so the grad repeats bit for bit on the card).  Rows of
    `padding_idx` ids add nothing;
    ids index as in the forward, and those outside [-vocab, vocab) add
    nothing, as the JAX side's scatter drops them; so do the rows that
    pad ragged ids to a bucket.

    With `is_sparse`: a SelectedRows of height vocab, one row per id in
    order, the raw ids (not wrapped: its consumers index as the JAX
    side's scatter does, `core.ragged.row_index`) and OG@Out's rows in
    its dtype, those of `padding_idx` ids and of ragged padding zero."""
    if attrs.get("is_sparse", False):
        return {"W@GRAD": [_sparse_grad(ins, attrs)]}
    w = ins["W"][0]
    vocab = w.shape[0]
    ids = ins["Ids"][0]
    raw, flat, valid = _flat_ids(values_of(ids), vocab)
    g = values_of(ins["OG@Out"][0]).reshape(-1, w.shape[1])
    padding_idx = int(attrs.get("padding_idx", -1))
    keep = valid & (raw != padding_idx) if padding_idx >= 0 else valid
    if isinstance(ids, RaggedTensor):
        keep = keep & ids.valid_mask()
    g = torch.where(keep[:, None], g.to(w.dtype),
                    torch.zeros((), dtype=w.dtype, device=w.device))
    return {"W@GRAD": [add_rows_(torch.zeros_like(w),
                                 flat.clamp(0, vocab - 1), g)]}


def _sparse_grad(ins, attrs):
    w = ins["W"][0]
    ids = ins["Ids"][0]
    raw = values_of(ids).reshape(-1).to(torch.int32)
    g = values_of(ins["OG@Out"][0]).reshape(-1, w.shape[1])
    keep = None
    padding_idx = int(attrs.get("padding_idx", -1))
    if padding_idx >= 0:
        keep = raw != padding_idx
    if isinstance(ids, RaggedTensor):
        keep = ids.valid_mask() if keep is None else keep & ids.valid_mask()
    if keep is not None:
        g = torch.where(keep[:, None], g,
                        torch.zeros((), dtype=g.dtype, device=g.device))
    return SelectedRows(raw, g, w.shape[0])


@register_op("split_selected_rows", stop_gradient_op=True)
def split_selected_rows(ctx, ins, attrs):
    """Out: one SelectedRows per section of `height_sections`, each of
    every row of X at a static shape: a row in the section's range
    rebased to it with its values, any other pointing at row 0 with
    zero values, as on the JAX side."""
    x = ins["X"][0]
    outs = []
    start = 0
    for h in attrs["height_sections"]:
        in_range = (x.rows >= start) & (x.rows < start + h)
        rows = torch.where(in_range, x.rows - start, 0)
        mask = in_range.reshape((-1,) + (1,) * (x.values.dim() - 1))
        values = torch.where(mask, x.values,
                             torch.zeros((), dtype=x.values.dtype,
                                         device=x.values.device))
        outs.append(SelectedRows(rows, values, h))
        start += h
    return {"Out": outs}
