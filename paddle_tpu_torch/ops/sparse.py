"""Embedding op kernels: `lookup_table` and its dense grad, dense ids.

Counterpart of paddle_tpu/ops/sparse.py (reference:
lookup_table_op.cc).  Ragged (LoD) ids and the SelectedRows gradient
(`is_sparse`) come with ROADMAP A7.
"""

import torch

from .registry import register_grad_kernel, register_op


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
    gives a NaN row rather than a device-side assert."""
    w = ins["W"][0]
    ids = ins["Ids"][0]
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
    lead = tuple(ids.shape[:-1]) if ids.dim() > 1 and ids.shape[-1] == 1 \
        else tuple(ids.shape)
    return {"Out": [out.reshape(lead + (w.shape[1],))]}


@register_grad_kernel("lookup_table")
def lookup_table_grad(ctx, ins, attrs):
    """The dense W@GRAD: OG@Out's rows added into zeros at their ids
    (`index_add_`; on the card the adds are atomic, so rows hit twice
    sum in a varying order).  Rows of `padding_idx` ids add nothing;
    ids index as in the forward, and those outside [-vocab, vocab) add
    nothing, as the JAX side's scatter drops them."""
    if attrs.get("is_sparse", False):
        raise NotImplementedError(
            "lookup_table_grad with is_sparse=True gives a SelectedRows "
            "gradient, which comes with ROADMAP A7")
    w = ins["W"][0]
    vocab = w.shape[0]
    raw, flat, valid = _flat_ids(ins["Ids"][0], vocab)
    g = ins["OG@Out"][0].reshape(-1, w.shape[1])
    padding_idx = int(attrs.get("padding_idx", -1))
    keep = valid & (raw != padding_idx) if padding_idx >= 0 else valid
    g = torch.where(keep[:, None], g.to(w.dtype),
                    torch.zeros((), dtype=w.dtype, device=w.device))
    dense = torch.zeros_like(w).index_add_(0, flat.clamp(0, vocab - 1), g)
    return {"W@GRAD": [dense]}
