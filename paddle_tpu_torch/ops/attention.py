"""Attention ops: the flash-attention kernel as a registered op.

Counterpart of paddle_tpu/ops/attention.py.  Under a device mesh (the
ambient mesh `parallel.ParallelTrainer.step` enters) the op runs per rank
on local shards: ring or Ulysses attention (parallel/ring.py) where its
`sequence_parallel_axis` names a mesh axis of size above 1, as the JAX op
does, else the kernel on each rank's batch and head shard.  Otherwise:
the op views q, k and v as
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
    block = int(attrs.get("block_size", 128))
    from ..parallel.mesh import ambient_mesh

    mesh = ambient_mesh()
    if mesh is not None:
        return {"Out": [_on_mesh(mesh, q, k, v, num_heads, causal, sm_scale,
                                 block, attrs)]}
    heads = [t.unflatten(-1, (num_heads, t.shape[-1] // num_heads))
             for t in (q, k, v)]
    o, _, _ = FlashAttentionFunction.apply(*heads, sm_scale, causal, 0,
                                           block, block)
    return {"Out": [o.flatten(2)]}


def _on_mesh(mesh, q, k, v, num_heads, causal, sm_scale, block, attrs):
    """The op under a device mesh (`parallel.ParallelTrainer.step`), q,
    k and v [B, T, H*Dh] DTensors (or full values).  Where the mesh
    names `sequence_parallel_axis` with a size above 1, ring or Ulysses
    attention (`sequence_parallel_mode`) over that axis, as the JAX op
    runs them; otherwise the kernel on each rank's local shard.  Either
    way the batch shards over dp and the heads over mp where the mesh
    has those axes (and mp divides the heads), and the per-rank code
    gets plain local tensors."""
    from ..parallel import ring
    from ..parallel.mesh import mesh_shape
    from ..parallel.sharding import P, shard_map_norep

    axes = mesh_shape(mesh)
    sp_axis = attrs.get("sequence_parallel_axis", "")
    sp_mode = attrs.get("sequence_parallel_mode", "ring")
    sp = bool(sp_axis) and axes.get(sp_axis, 1) > 1
    if sp and sp_mode not in ("ring", "ulysses"):
        raise ValueError("sequence_parallel_mode must be ring or ulysses, "
                         "got %r" % sp_mode)
    mp = axes.get("mp", 1)
    spec = P("dp" if "dp" in axes else None, sp_axis if sp else None,
             "mp" if "mp" in axes and num_heads % mp == 0 else None)
    heads_local = num_heads // mp if spec[2] else num_heads

    def local(q, k, v):
        qh, kh, vh = (t.unflatten(-1, (heads_local,
                                       t.shape[-1] // heads_local))
                      for t in (q, k, v))
        if not sp:
            o, _, _ = FlashAttentionFunction.apply(qh, kh, vh, sm_scale,
                                                   causal, 0, block, block)
            return o.flatten(2)
        qh, kh, vh = (t.transpose(1, 2) for t in (qh, kh, vh))
        if sp_mode == "ring":
            o = ring.ring_attention(qh, kh, vh, sp_axis, sm_scale, causal)
        else:
            o = ring.ulysses_attention(qh, kh, vh, sp_axis, sm_scale,
                                       causal)
        return o.transpose(1, 2).flatten(2).to(q.dtype)

    return shard_map_norep(local, mesh, in_specs=(spec, spec, spec),
                           out_specs=spec)(q, k, v)


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
