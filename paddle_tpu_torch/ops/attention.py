"""Attention ops: the flash-attention kernel as a registered op.

Counterpart of paddle_tpu/ops/attention.py.  The op splits heads, runs
kernels/flash_attention.py (the CUDA kernel on the card, its plain
version on the CPU) and merges heads.  Ring and Ulysses sequence
parallelism and `cached_attention` come with later slices.
"""

from ..kernels.flash_attention import flash_attention
from .registry import register_op


def _split_heads(x, num_heads):
    """[B, T, H*Dh] -> [B, H, T, Dh], contiguous for the kernel."""
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads) \
        .permute(0, 2, 1, 3).contiguous()


def _merge_heads(x):
    """[B, H, T, Dh] -> [B, T, H*Dh]."""
    b, h, t, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * dh)


@register_op("flash_attention")
def flash_attention_op(ctx, ins, attrs):
    """Q, K, V: [batch, seq, dim]; Out: [batch, seq_q, dim] in Q's dtype.
    `sm_scale` 0.0 means Dh^-0.5; `block_size` sets the plain version's
    tiles (the CUDA kernel has its own)."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    num_heads = int(attrs.get("num_heads", 1))
    causal = bool(attrs.get("causal", False))
    sm_scale = float(attrs.get("sm_scale", 0.0)) or None
    if attrs.get("sequence_parallel_axis", ""):
        raise NotImplementedError(
            "flash_attention: sequence_parallel_axis=%r — ring and Ulysses "
            "attention are not ported yet"
            % attrs["sequence_parallel_axis"])
    for name, t in (("Q", q), ("K", k), ("V", v)):
        if t.dim() != 3:
            raise ValueError("flash_attention %s must be 3-D "
                             "[batch, seq, dim], got %s"
                             % (name, tuple(t.shape)))
        if t.shape[-1] % num_heads:
            raise ValueError("hidden size %d must divide num_heads %d"
                             % (t.shape[-1], num_heads))
    block = int(attrs.get("block_size", 128))
    out = flash_attention(_split_heads(q, num_heads),
                          _split_heads(k, num_heads),
                          _split_heads(v, num_heads), sm_scale, causal,
                          block_q=block, block_k=block)
    return {"Out": [_merge_heads(out).to(q.dtype)]}
