"""Transformer language model as plain functions over a dict of tensors.

Counterpart of paddle_tpu/models/transformer.py: a GPT-style decoder
whose attention runs dense (`reference_attention`), flash (the
hand-written kernel through `FlashAttentionFunction`, its plain version
on the CPU), ring (sequence-parallel over a mesh axis) or Ulysses
(all-to-all), with weights laid out for dp x mp x sp meshes by
`transformer_param_specs`.

The functions take plain tensors, or DTensors on a mesh (the params
distributed by `transformer_param_specs`, say); with `mesh=` given they
run under `sharding.replicating()`, so plain tensors mix with DTensors.
Gradients come from torch.autograd.

`transformer_params_from_numpy` carries the JAX package's params dict
(numpy arrays and its TransformerMeta) across as this module's.
"""

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.flash_attention import (flash_attention_bhtd,
                                       reference_attention)
from ..parallel.ring import ring_attention, sp_shard_map, ulysses_attention
from ..parallel.sharding import P, distribute, replicating

__all__ = ["init_transformer", "transformer_forward", "transformer_loss",
           "transformer_param_specs", "TransformerMeta",
           "transformer_params_from_numpy"]


@functools.total_ordering
class TransformerMeta:
    """Static model config carried inside the params dict."""

    def __init__(self, n_layer, n_head, d_model):
        self.n_layer = n_layer
        self.n_head = n_head
        self.d_model = d_model

    def _key(self):
        return (self.n_layer, self.n_head, self.d_model)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, TransformerMeta) and \
            self._key() == other._key()

    def __lt__(self, other):
        return self._key() < other._key()

    def __getitem__(self, k):  # dict-style access
        return getattr(self, k)


def init_transformer(rng, vocab_size, n_layer=2, n_head=4, d_model=128,
                     d_ff=None, max_len=2048, dtype=np.float32):
    """Returns a params dict of numpy arrays (the JAX function's draws
    from the same seed)."""
    if d_ff is None:
        d_ff = 4 * d_model
    rs = np.random.RandomState(rng) if isinstance(rng, int) else rng
    sd = 0.02

    def w(*shape):
        return (rs.randn(*shape) * sd).astype(dtype)

    params = {
        "wte": w(vocab_size, d_model),
        "wpe": w(max_len, d_model),
        "ln_f.g": np.ones(d_model, dtype),
        "ln_f.b": np.zeros(d_model, dtype),
    }
    for i in range(n_layer):
        p = "h%d." % i
        params.update({
            p + "ln1.g": np.ones(d_model, dtype),
            p + "ln1.b": np.zeros(d_model, dtype),
            p + "qkv.w": w(d_model, 3 * d_model),
            p + "qkv.b": np.zeros(3 * d_model, dtype),
            p + "proj.w": w(d_model, d_model),
            p + "proj.b": np.zeros(d_model, dtype),
            p + "ln2.g": np.ones(d_model, dtype),
            p + "ln2.b": np.zeros(d_model, dtype),
            p + "fc.w": w(d_model, d_ff),
            p + "fc.b": np.zeros(d_ff, dtype),
            p + "out.w": w(d_ff, d_model),
            p + "out.b": np.zeros(d_model, dtype),
        })
    params["_meta"] = TransformerMeta(n_layer=n_layer, n_head=n_head,
                                      d_model=d_model)
    return params


def transformer_params_from_numpy(params, device):
    """A params dict of numpy arrays (this module's `init_transformer`,
    or the JAX package's, whose `_meta` carries n_layer, n_head and
    d_model) as this module's: tensors on `device` and a
    TransformerMeta."""
    out = {}
    for name, v in params.items():
        if name == "_meta":
            out[name] = TransformerMeta(int(v.n_layer), int(v.n_head),
                                        int(v.d_model))
        else:
            out[name] = torch.from_numpy(np.array(v, copy=True)).to(device)
    return out


def transformer_param_specs(params, mp_axis="mp"):
    """Specs for tensor parallelism: qkv/fc shard columns (heads / ff)
    over mp, proj/out shard rows — the Megatron layout."""
    specs = {}
    for name in params:
        if name == "_meta":
            continue
        spec = P()
        if name.endswith(("qkv.w", "fc.w")):
            spec = P(None, mp_axis)
        elif name.endswith(("qkv.b", "fc.b")):
            spec = P(mp_axis)
        elif name.endswith(("proj.w", "out.w")):
            spec = P(mp_axis, None)
        elif name == "wte":
            spec = P(mp_axis, None)
        specs[name] = spec
    return specs


def _ln(x, g, b, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _attend(q, k, v, attn_impl, mesh, causal, sp_axis="sp"):
    """q, k, v: [B, H, T, D] (T whole; sharded over sp inside)."""
    if attn_impl == "dense":
        return reference_attention(q, k, v, None, causal)
    if attn_impl == "flash":
        return flash_attention_bhtd(q, k, v, None, causal)
    if attn_impl == "ring":
        fn = sp_shard_map(
            lambda q, k, v: ring_attention(q, k, v, sp_axis, None, causal),
            mesh, axis_name=sp_axis)
    elif attn_impl == "ulysses":
        fn = sp_shard_map(
            lambda q, k, v: ulysses_attention(q, k, v, sp_axis, None,
                                              causal), mesh,
            axis_name=sp_axis)
    else:
        raise ValueError("unknown attn_impl %r" % attn_impl)
    # whole over sp again (batch and heads keep their shards): the
    # products after it view [B, T, d] as [B*T, d]
    out = fn(q, k, v)
    from torch.distributed.tensor import Replicate

    pl = list(out.placements)
    pl[mesh.mesh_dim_names.index(sp_axis)] = Replicate()
    return out.redistribute(mesh, pl)


def _forward(params, tokens, attn_impl, mesh, causal, sp_axis):
    meta = params["_meta"]
    H = meta["n_head"]
    d = meta["d_model"]
    B, T = tokens.shape

    if mesh is not None:
        # a DTensor, so the embedding's backward finds no plain tensor
        tokens = distribute(tokens, mesh, P(), src_data_rank=None)
    # the residual stream stays whole over sp, where the JAX model lays
    # it out over the axis: DTensor (torch 2.11) cannot view a
    # sequence-sharded [B, T, d] as the [B*T, d] of a product.  The
    # attention shards q, k and v over sp itself (sp_shard_map) and
    # gathers its output
    x = F.embedding(tokens, params["wte"]) + params["wpe"][:T]

    for i in range(meta["n_layer"]):
        p = "h%d." % i
        h = _ln(x, params[p + "ln1.g"], params[p + "ln1.b"])
        qkv = h @ params[p + "qkv.w"] + params[p + "qkv.b"]
        q, k, v = torch.split(qkv, d, dim=-1)

        def heads(t):  # [B, T, d] -> [B, H, T, hd]
            return t.reshape(B, T, H, d // H).transpose(1, 2)

        o = _attend(heads(q), heads(k), heads(v), attn_impl, mesh, causal,
                    sp_axis=sp_axis)
        o = o.transpose(1, 2).reshape(B, T, d)
        x = x + o @ params[p + "proj.w"] + params[p + "proj.b"]

        h = _ln(x, params[p + "ln2.g"], params[p + "ln2.b"])
        h = F.gelu(h @ params[p + "fc.w"] + params[p + "fc.b"],
                   approximate="tanh")
        x = x + h @ params[p + "out.w"] + params[p + "out.b"]

    x = _ln(x, params["ln_f.g"], params["ln_f.b"])
    return x @ params["wte"].t()


def transformer_forward(params, tokens, attn_impl="flash", mesh=None,
                        causal=True, sp_axis="sp"):
    """tokens: int [B, T] -> logits [B, T, vocab] (a DTensor on `mesh`
    where one is given and the inputs were DTensors or the attention
    ran over it)."""
    if mesh is None:
        return _forward(params, tokens, attn_impl, mesh, causal, sp_axis)
    with replicating():
        return _forward(params, tokens, attn_impl, mesh, causal, sp_axis)


def transformer_loss(params, tokens, targets, attn_impl="flash",
                     mesh=None):
    """The mean next-token negative log-likelihood of `targets`."""
    logits = transformer_forward(params, tokens, attn_impl=attn_impl,
                                 mesh=mesh)
    with replicating() if mesh is not None else contextlib.nullcontext():
        logp = torch.log_softmax(logits.float(), dim=-1)
        idx = targets.long()[..., None]
        if mesh is not None:
            # a DTensor, so the gather's backward finds no plain tensor
            idx = distribute(idx, mesh, P(), src_data_rank=None)
        ll = torch.gather(logp, -1, idx)
        return -ll.mean()
