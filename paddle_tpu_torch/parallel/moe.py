"""Expert parallelism: Switch-style top-1 mixture-of-experts over an
"ep" mesh axis.

Counterpart of paddle_tpu/parallel/moe.py: tokens pick an expert by
router argmax, are packed into per-expert capacity slots, shipped to
the expert's owner rank with `collectives.all_to_all`, transformed by
the expert FFN, shipped back, and combined weighted by the router
probability.  Routing is not differentiable (argmax); gradients flow
through the combine weights and the expert FFN, with the Switch
load-balancing auxiliary loss.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from . import collectives as C
from .mesh import mesh_shape
from .sharding import P, shard_map_norep

__all__ = ["switch_moe", "moe_shard_map", "init_moe_params",
           "expert_capacity", "moe_axis_info"]


def expert_capacity(tokens, n_experts, capacity_factor):
    """Per-expert capacity slots for `tokens` local tokens."""
    return max(1, int(capacity_factor * tokens / max(n_experts, 1)))


def moe_axis_info(mesh, n_experts, axis_name="ep", batch_axis="dp",
                  capacity_factor=1.25, tokens=None):
    """Static introspection of an MoE layout over `mesh` (or any
    axis->size mapping): expert ownership, token sharding, and
    capacity."""
    shape = dict(mesh_shape(mesh))
    ep = int(shape.get(axis_name, 1))
    dp = int(shape.get(batch_axis, 1))
    info = {"axis": axis_name, "ep": ep, "batch_axis": batch_axis,
            "n_experts": n_experts, "experts_per_device":
            (n_experts // ep if ep and n_experts % ep == 0 else None),
            "token_shards": ep * dp}
    if tokens is not None and info["token_shards"] \
            and tokens % info["token_shards"] == 0:
        local = tokens // info["token_shards"]
        info["local_tokens"] = local
        info["capacity"] = expert_capacity(local, n_experts,
                                           capacity_factor)
    return info


def init_moe_params(key, d_model, d_hidden, n_experts,
                    dtype=torch.float32, device="cpu"):
    """Router + stacked expert FFN weights (numpy's normal draws from
    the seed `key`).  The leading n_experts axis of w1/b1/w2/b2 is the
    one to shard over "ep"."""
    rs = np.random.RandomState(key)
    s1 = (2.0 / d_model) ** 0.5
    s2 = (2.0 / d_hidden) ** 0.5

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(
            device=device, dtype=dtype)

    return {
        "gate_w": t(rs.randn(d_model, n_experts) * s1),
        "w1": t(rs.randn(n_experts, d_model, d_hidden) * s1),
        "b1": t(np.zeros((n_experts, d_hidden))),
        "w2": t(rs.randn(n_experts, d_hidden, d_model) * s2),
        "b2": t(np.zeros((n_experts, d_model))),
    }


def switch_moe(params, x, axis_name="ep", capacity_factor=1.25,
               batch_axes=(), expert_fn=None):
    """Per-rank MoE layer; call inside shard_map_norep.

    params: gate_w [d, E] (the same on every rank); expert weights with
    the expert axis "ep"-sharded (local leading dim E/ep): either the
    built-in FFN's w1/b1/w2/b2, or, with `expert_fn`, an "experts" dict
    of any structure.  expert_fn(local_expert_params, xin) maps
    [e_loc, tokens, d] -> [e_loc, tokens, d].  x: [b, d] local tokens.
    batch_axes: further mesh axes the tokens shard over (e.g. ("dp",)),
    so the aux statistics average over all token shards.  Returns
    (y [b, d], aux): aux is the Switch load-balancing loss
    (E * sum(fraction_routed * mean_router_prob); ~1 when balanced)."""
    ep = C.axis_size(axis_name)
    if expert_fn is None:
        e_loc = params["w1"].shape[0]
    else:
        e_loc = pytree.tree_leaves(params["experts"])[0].shape[0]
    n_expert = e_loc * ep
    b, d = x.shape

    # route (f32 softmax; tokens keep their activation dtype)
    logits = x.float() @ params["gate_w"].float()
    probs = torch.softmax(logits, dim=-1)                # [b, E]
    gate = probs.amax(dim=-1)                            # [b]
    expert = probs.argmax(dim=-1)                        # [b]
    onehot = F.one_hot(expert, n_expert).float()         # [b, E]

    # pack into capacity slots (per source rank, per expert)
    capacity = expert_capacity(b, n_expert, capacity_factor)
    pos = torch.cumsum(onehot, dim=0) - 1.0              # queue position
    in_cap = (pos < capacity).float() * onehot           # dropped past C
    # dispatch is the one place capacity masking happens: the one-hot of
    # a dropped token's slot is zeroed here and nowhere else (the slot
    # is clamped into range only where in_cap is 0)
    slot = pos.long().clamp(0, capacity - 1)
    dispatch = F.one_hot(slot, capacity).float() * in_cap[..., None]
    combine = dispatch * gate[:, None, None]

    # dispatch: [b, d] -> [E, C, d] -> the experts' owners
    xin = torch.einsum("bd,bec->ecd", x.float(), dispatch)
    xin = xin.reshape(ep, e_loc, capacity, d)
    # -> [ep_src, e_loc, C, d]
    xin = C.all_to_all(xin, axis_name, split_axis=0, concat_axis=0,
                       tiled=False)
    xin = xin.permute(1, 0, 2, 3).reshape(e_loc, ep * capacity, d)

    # the expert FFN over the local experts
    if expert_fn is None:
        h = torch.relu(torch.einsum("ecd,edh->ech", xin, params["w1"])
                       + params["b1"][:, None, :])
        out = torch.einsum("ech,ehd->ecd", h, params["w2"]) \
            + params["b2"][:, None, :]                   # [e_loc, ep*C, d]
    else:
        out = expert_fn(params["experts"], xin)          # [e_loc, ep*C, d]

    # ship results back and combine
    out = out.reshape(e_loc, ep, capacity, d).permute(1, 0, 2, 3)
    # -> [ep_owner, e_loc, C, d]
    out = C.all_to_all(out, axis_name, split_axis=0, concat_axis=0,
                       tiled=False)
    out = out.reshape(n_expert, capacity, d)
    y = torch.einsum("ecd,bec->bd", out, combine).to(x.dtype)

    # Switch aux loss: balance fraction routed against router mass,
    # averaged over every axis the tokens shard across (ep + dp), so the
    # value is the same on all ranks
    stat_axes = (axis_name,) + tuple(batch_axes)
    frac = C.pmean(onehot.mean(dim=0), stat_axes)        # [E]
    mass = C.pmean(probs.mean(dim=0), stat_axes)         # [E]
    aux = n_expert * torch.sum(frac * mass)
    return y, aux


def moe_shard_map(mesh, axis_name="ep", batch_axis="dp",
                  capacity_factor=1.25, expert_fn=None,
                  expert_param_template=None):
    """Wrap switch_moe for `mesh`: tokens shard over (dp, ep) jointly,
    expert weights shard over ep, the router replicates.

    With `expert_fn`, params must be {"gate_w": ..., "experts": dict}
    where every experts tensor has a leading [E] axis (sharded over ep);
    pass that dict (or one with the same structure) as
    expert_param_template so the specs can be derived.

    Returns fn(params, x[B, d]) -> (y[B, d], aux), DTensors on `mesh`."""
    axes_present = mesh_shape(mesh)
    axes = tuple(a for a in (batch_axis, axis_name) if a in axes_present)
    x_spec = P(axes if len(axes) > 1 else (axes[0] if axes else None))
    if expert_fn is None:
        param_specs = {
            "gate_w": P(), "w1": P(axis_name), "b1": P(axis_name),
            "w2": P(axis_name), "b2": P(axis_name),
        }
    else:
        if expert_param_template is None:
            raise ValueError(
                "expert_fn needs expert_param_template to derive specs")
        param_specs = {"gate_w": P(),
                       "experts": pytree.tree_map(lambda _: P(axis_name),
                                                  expert_param_template)}
    fn = functools.partial(
        switch_moe, axis_name=axis_name, capacity_factor=capacity_factor,
        batch_axes=tuple(a for a in axes if a != axis_name),
        expert_fn=expert_fn)
    return shard_map_norep(fn, mesh, in_specs=(param_specs, x_spec),
                           out_specs=(x_spec, P()))
