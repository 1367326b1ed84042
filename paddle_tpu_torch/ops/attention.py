"""Attention ops: the flash-attention kernel as a registered op.

Counterpart of paddle_tpu/ops/attention.py.  The op views q, k and v as
[B, T, H, Dh] where they lie (the `split` op leaves them as strided
views of the fc output), runs kernels/flash_attention.py on those views
(the CUDA kernel on the card, its plain version on the CPU) and has it
write O straight into a [B, T, H*Dh] tensor: no head-split or merge
copy.  It goes through `FlashAttentionFunction`, so the generic grad of
`flash_attention_grad` runs the forward kernel again and then
`flash_attention_bwd`, as the JAX side's vjp runs its custom_vjp rules.

`cached_attention` is one KV-cached decode step.  On the JAX side it is
plain XLA (einsums), not a Pallas kernel, so its port is PyTorch: the
caches updated out of place, scores in f32, the mask and the write slot
read from the position tensor on the device (no host sync per layer per
token).
"""

import torch

from ..kernels.flash_attention import FlashAttentionFunction
from .registry import register_op


def _infer_flash_attention(ins, attrs):
    """Out has Q's shape and dtype (the kernel launch needs real
    pointers, so shape inference does not run it)."""
    return {"Out": [torch.empty_like(ins["Q"][0])]}


@register_op("flash_attention", infer_shape=_infer_flash_attention)
def flash_attention_op(ctx, ins, attrs):
    """Q, K, V: [batch, seq, dim]; Out: [batch, seq_q, dim] in Q's dtype.
    `sm_scale` 0.0 means Dh^-0.5; `block_size` sets the plain version's
    tiles (the CUDA kernel has its own)."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    num_heads = int(attrs.get("num_heads", 1))
    causal = bool(attrs.get("causal", False))
    sm_scale = float(attrs.get("sm_scale", 0.0)) or None
    for name, t in (("Q", q), ("K", k), ("V", v)):
        if t.dim() != 3:
            raise ValueError("flash_attention %s must be 3-D "
                             "[batch, seq, dim], got %s"
                             % (name, tuple(t.shape)))
        if t.shape[-1] % num_heads:
            raise ValueError("hidden size %d must divide num_heads %d"
                             % (t.shape[-1], num_heads))
    # A `sequence_parallel_axis` runs ring or Ulysses attention (by
    # `sequence_parallel_mode`) only under a device mesh that names the
    # axis, as on the JAX side; the port has no mesh yet, so such a
    # program runs the local kernel.  Ring and Ulysses arrive with
    # ROADMAP A9, together with a DeviceMesh.
    block = int(attrs.get("block_size", 128))
    heads = [t.unflatten(-1, (num_heads, t.shape[-1] // num_heads))
             for t in (q, k, v)]
    o, _, _ = FlashAttentionFunction.apply(*heads, sm_scale, causal, 0,
                                           block, block)
    return {"Out": [o.flatten(2)]}


def _heads(x, num_heads):
    """[B, T, H*Dh] -> [B, H, T, Dh], a view."""
    return x.unflatten(-1, (num_heads, x.shape[-1] // num_heads)) \
        .transpose(1, 2)


@register_op("cached_attention", stop_gradient_op=True)
def cached_attention_op(ctx, ins, attrs):
    """One autoregressive decode step with a KV cache.

    Q/KNew/VNew: [batch, 1, dim], this token's projections;
    KCache/VCache: [batch, heads, max_len, head_dim]; Position: int [1]
    or [batch] (rows advance in lockstep: the first entry is the slot
    this step writes, and keys 0..Position attend).  Out is the context
    [batch, 1, dim] in Q's dtype; KCacheOut/VCacheOut are new caches in
    the caches' dtype (the fed ones are not written), as
    `dynamic_update_slice` gives them, with the slot clamped into the
    cache as it clamps.  Scores in f32, -1e30 past the position."""
    q, k_new, v_new = ins["Q"][0], ins["KNew"][0], ins["VNew"][0]
    k_cache, v_cache = ins["KCache"][0], ins["VCache"][0]
    # kept on the device: reading it on the host would sync per layer
    pos = ins["Position"][0].reshape(-1)[:1]
    num_heads = int(attrs.get("num_heads", 1))
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k_new, v_new))
    sm_scale = float(attrs.get("sm_scale", 0.0)) or qh.shape[-1] ** -0.5
    T = k_cache.shape[2]
    slot = pos.long().clamp(0, T - 1)
    k_cache = k_cache.index_copy(2, slot, kh.to(k_cache.dtype))
    v_cache = v_cache.index_copy(2, slot, vh.to(v_cache.dtype))
    s = torch.matmul(qh.float(), k_cache.float().transpose(-1, -2)) \
        * sm_scale
    valid = torch.arange(T, device=pos.device) <= pos
    p = torch.softmax(s.masked_fill(~valid, -1e30), dim=-1)
    out = torch.matmul(p, v_cache.float())
    return {"Out": [out.transpose(1, 2).flatten(2).to(q.dtype)],
            "KCacheOut": [k_cache], "VCacheOut": [v_cache]}
