"""Embedding op kernels: the forward of `lookup_table`, dense ids.

Counterpart of paddle_tpu/ops/sparse.py (reference:
lookup_table_op.cc).  Ragged (LoD) ids and the SelectedRows gradient
come with later slices.
"""

import torch

from .registry import register_op


@register_op("lookup_table")
def lookup_table(ctx, ins, attrs):
    """Rows of W at Ids.  `padding_idx` rows come out zero.  A trailing
    size-1 ids dim is squeezed ([B, T, 1] ids give [B, T, d]), the
    reference convention the cached decode step relies on; [B, T] ids
    keep their shape.  Ids index as jnp.take does on the JAX side: a
    negative id counts from the end, and one outside [-vocab, vocab)
    gives a NaN row rather than a device-side assert."""
    w = ins["W"][0]
    ids = ins["Ids"][0]
    vocab = w.shape[0]
    raw = ids.reshape(-1)
    flat = torch.where(raw < 0, raw + vocab, raw)
    valid = (flat >= 0) & (flat < vocab)
    out = w.index_select(0, flat.clamp(0, vocab - 1))
    out = torch.where(valid[:, None], out,
                      torch.full((), float("nan"), dtype=w.dtype,
                                 device=w.device))
    padding_idx = int(attrs.get("padding_idx", -1))
    if padding_idx >= 0:
        out = torch.where((raw == padding_idx)[:, None],
                          torch.zeros((), dtype=w.dtype, device=w.device),
                          out)
    lead = tuple(ids.shape[:-1]) if ids.dim() > 1 and ids.shape[-1] == 1 \
        else tuple(ids.shape)
    return {"Out": [out.reshape(lead + (w.shape[1],))]}
