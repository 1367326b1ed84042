"""Sequence/context parallelism: ring attention and Ulysses all-to-all.

Counterpart of paddle_tpu/parallel/ring.py.  The sequence axis shards
over a mesh axis ("sp"); in ring attention each rank's query block
attends the K/V shard it holds, then K/V hop to the next rank
(`collectives.ppermute`, the reverse ring in the backward) and each hop
folds into a running online-softmax accumulator, so the full sequence
never lies on one rank.  `_block_attend` and `_merge` are plain PyTorch,
as the JAX code is plain XLA.

Ulysses all-to-all trades the sequence shard for a head shard instead:
one tiled all-to-all before, attention over full sequences for 1/sp of
the heads (the hand-written flash kernel through `flash_attention_bhtd`
with `use_flash`, else `reference_attention`), one all-to-all after.

`ring_attention` and `ulysses_attention` are per-rank functions: call
them inside `sp_shard_map` (or `sharding.shard_map_norep`).
`bucketed_allreduce` runs `ring_allreduce` once per bucket of
gradients (the overlapped data-parallel step's reduction,
spmd/overlap.py) and records its schedule in `obs/comm.py`.
"""

import torch

from ..kernels.flash_attention import (NEG_INF, flash_attention_bhtd,
                                       reference_attention)
from . import collectives as C
from .mesh import mesh_shape
from .sharding import P, shard_map_norep

__all__ = ["ring_attention", "ulysses_attention", "sp_shard_map",
           "sp_axis_info", "ring_allreduce", "grad_buckets",
           "bucketed_allreduce"]


def sp_axis_info(mesh, seq_len=None, n_heads=None, axis_name="sp",
                 mode="ring"):
    """Static introspection of a sequence-parallel layout over `mesh`
    (or any axis->size mapping): shard extent and the divisibility
    requirements the schedule imposes."""
    shape = dict(mesh_shape(mesh))
    sp = int(shape.get(axis_name, 0))
    info = {"axis": axis_name, "sp": sp, "mode": mode,
            "requires": ["seq_len %% %d == 0" % sp] if sp else []}
    if mode == "ulysses" and sp:
        info["requires"].append("n_heads %% %d == 0" % sp)
    if seq_len is not None and sp:
        info["local_seq"] = (seq_len // sp if seq_len % sp == 0
                             else None)
    if n_heads is not None and sp and mode == "ulysses":
        info["local_heads"] = (n_heads // sp if n_heads % sp == 0
                               else None)
    return info


def _block_attend(q, k, v, sm_scale, causal, q_start, k_start):
    """Unnormalized blockwise attention: (acc, m, l) where out = acc / l
    after all blocks merge.  q: [B, H, Tq, D]."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        Tq, Tk = q.shape[2], k.shape[2]
        dev = q.device
        q_pos = q_start + torch.arange(Tq, device=dev)
        k_pos = k_start + torch.arange(Tk, device=dev)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                        torch.full((), NEG_INF, device=dev))
    m = s.amax(dim=-1)                           # [B, H, Tq]
    # fully-masked rows: exp(NEG_INF - NEG_INF) = 1 would pollute l
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m[..., None]),
                    torch.zeros((), device=q.device))
    l = p.sum(dim=-1)
    acc = torch.matmul(p, v.float())
    return acc, m, l


def _merge(acc1, m1, l1, acc2, m2, l2):
    """Merge two online-softmax partials."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return (acc1 * a1[..., None] + acc2 * a2[..., None],
            m, l1 * a1 + l2 * a2)


def ring_attention(q, k, v, axis_name="sp", sm_scale=None, causal=False):
    """Attention with q/k/v the local [B, H, T/sp, D] shards along
    `axis_name`.  Call inside sp_shard_map.  The locally held shard
    first (no communication), then sp - 1 hops: k/v move to the next
    rank and the local queries attend what arrived, the partials merged
    by online softmax.  Differentiable (the hops' gradient is the
    reverse ring)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    sp = C.axis_size(axis_name)
    my = C.axis_index(axis_name)
    t_local = q.shape[2]
    q_start = my * t_local
    perm = [(i, (i + 1) % sp) for i in range(sp)]

    acc, m, l = _block_attend(q, k, v, sm_scale, causal, q_start,
                              my * t_local)
    k_cur, v_cur = k, v
    for i in range(1, sp):
        k_cur = C.ppermute(k_cur, axis_name, perm)
        v_cur = C.ppermute(v_cur, axis_name, perm)
        # after i hops this rank holds shard (my - i) mod sp
        src = (my - i) % sp
        a, bm, bl = _block_attend(q, k_cur, v_cur, sm_scale, causal,
                                  q_start, src * t_local)
        acc, m, l = _merge(acc, m, l, a, bm, bl)
    safe_l = torch.where(l > 0, l, torch.ones((), device=l.device))
    return (acc / safe_l[..., None]).to(q.dtype)


def ulysses_attention(q, k, v, axis_name="sp", sm_scale=None,
                      causal=False, use_flash=True):
    """All-to-all sequence parallelism: swap the sharded axis from
    sequence to heads, attend full sequences locally, swap back.  q/k/v
    local: [B, H, T/sp, D]; H must divide by sp."""
    sp = C.axis_size(axis_name)
    if q.shape[1] % sp:
        raise ValueError(
            "ulysses attention needs the head count (%d) divisible by "
            "the sp axis size (%d)" % (q.shape[1], sp))

    def seq2head(x):
        # [B, H, t, D] -> [B, H/sp, T, D]
        return C.all_to_all(x, axis_name, split_axis=1, concat_axis=2,
                            tiled=True)

    def head2seq(x):
        # [B, H/sp, T, D] -> [B, H, t, D]
        return C.all_to_all(x, axis_name, split_axis=2, concat_axis=1,
                            tiled=True)

    qh, kh, vh = seq2head(q), seq2head(k), seq2head(v)
    if use_flash:
        oh = flash_attention_bhtd(qh, kh, vh, sm_scale, causal)
    else:
        oh = reference_attention(qh, kh, vh, sm_scale, causal)
    return head2seq(oh)


def ring_allreduce(x, axis_name="dp", mean=False):
    """All-reduce `x` over `axis_name` as an explicit ring: a
    reduce-scatter pass then an all-gather pass, each p - 1 neighbor
    hops of 1/p of the payload over `collectives.ppermute`.  Call inside
    shard_map_norep."""
    p = C.axis_size(axis_name)
    if p == 1:
        return x
    idx = C.axis_index(axis_name)
    perm = [(i, (i + 1) % p) for i in range(p)]
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1)
    n = flat.numel()
    m = -(-n // p)  # chunk size, padded up to a multiple of p
    if m * p != n:
        flat = torch.nn.functional.pad(flat, (0, m * p - n))
    chunks = list(flat.reshape(p, m).unbind(0))

    # reduce-scatter: after p - 1 hops rank i owns the fully reduced
    # chunk (i + 1) mod p
    buf = chunks[idx]
    for s in range(1, p):
        buf = C.ppermute(buf, axis_name, perm)
        j = (idx - s) % p
        buf = buf + chunks[j]
        chunks[j] = buf
    # all-gather: circulate the reduced chunks the rest of the way
    for s in range(1, p):
        buf = C.ppermute(buf, axis_name, perm)
        chunks[(idx - s + 1) % p] = buf
    out = torch.stack(chunks).reshape(-1)[:n]
    if mean:
        out = out / p
    return out.reshape(shape).to(dtype)


def grad_buckets(sized_names, bucket_bytes):
    """Group (name, nbytes) pairs into reduction buckets of at most
    `bucket_bytes` each (always at least one name per bucket), in input
    order."""
    buckets, cur, cur_bytes = [], [], 0
    for name, nbytes in sized_names:
        if cur and cur_bytes + nbytes > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(name)
        cur_bytes += int(nbytes)
    if cur:
        buckets.append(cur)
    return buckets


def bucketed_allreduce(grads, bucket_bytes, axis_name="dp", mean=True,
                       order=None):
    """Ring-allreduce a dict of per-rank gradient shards in buckets.

    Each bucket flattens and concatenates its members into one f32
    vector, runs ONE `ring_allreduce` over it, and splits the result
    back — one collective chain per bucket instead of one per tensor
    (tiny grads amortize) or one for everything.  `order` (default:
    reversed dict order) fixes which grads reduce first.  Call inside
    shard_map_norep.  The schedule (buckets, names, bytes) is recorded
    through obs/comm.py on every call, with a `comm/bucketed_allreduce`
    span nesting one `comm/bucket` span per bucket.
    """
    from ..obs import comm as obs_comm

    if not grads:
        return grads
    names = list(order) if order is not None \
        else list(reversed(list(grads)))
    sized = [(n, grads[n].numel() * grads[n].element_size())
             for n in names]
    size_of = dict(sized)
    buckets = grad_buckets(sized, bucket_bytes)
    sched = obs_comm.record_schedule(
        "allreduce", axis_name,
        [{"bucket": i, "names": list(b),
          "bytes": int(sum(size_of[n] for n in b))}
         for i, b in enumerate(buckets)], mean=mean)
    out = dict(grads)
    with obs_comm.schedule_span(sched):
        for i, bucket in enumerate(buckets):
            with obs_comm.bucket_span(sched, i):
                parts = [grads[n].to(torch.float32).reshape(-1)
                         for n in bucket]
                flat = parts[0] if len(parts) == 1 else torch.cat(parts)
                flat = ring_allreduce(flat, axis_name, mean=mean)
                off = 0
                for n in bucket:
                    size = grads[n].numel()
                    out[n] = flat[off:off + size].reshape(
                        grads[n].shape).to(grads[n].dtype)
                    off += size
    return out


def sp_shard_map(fn, mesh, axis_name="sp", dp_axis="dp", mp_axis="mp"):
    """Wrap `fn(q, k, v)` over [B, H, T, D] tensors in shard_map_norep:
    T shards along `axis_name`, and batch/heads stay sharded along
    dp/mp when those axes exist."""
    axes = mesh_shape(mesh)
    batch = dp_axis if dp_axis in axes else None
    heads = mp_axis if mp_axis in axes else None
    spec = P(batch, heads, axis_name, None)
    return shard_map_norep(fn, mesh, in_specs=(spec, spec, spec),
                           out_specs=spec)
