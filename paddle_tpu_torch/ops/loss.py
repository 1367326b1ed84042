"""Loss op kernels: `cross_entropy`, `softmax_with_cross_entropy`,
`sigmoid_cross_entropy_with_logits` and `smooth_l1_loss`.

Counterpart of paddle_tpu/ops/loss.py (reference: cross_entropy_op.cc,
softmax_with_cross_entropy_op.cc,
sigmoid_cross_entropy_with_logits_op.cc, smooth_l1_loss_op.cc).  The
first two take hard or soft labels; they and `smooth_l1_loss` compute
in f32, a bf16 input upcast first, as on the JAX side; the sigmoid loss
computes in its input's dtype, as the JAX side's does.
"""

import torch

from .activation import jnp_abs
from .registry import like, register_op, values_of


def _f32(x):
    x = values_of(x)
    return x.float() if x.dtype == torch.bfloat16 else x


def _hard_ids(label, n):
    """(ids, valid): Label's class ids as a [N, 1] int64 column, a
    negative id counted from the end, and the mask of those in [0, n)
    after that (jnp.take_along_axis's indexing on the JAX side)."""
    raw = label.reshape(-1, 1).long()
    ids = torch.where(raw < 0, raw + n, raw)
    return ids.clamp(0, n - 1), (ids >= 0) & (ids < n)


def _nan_where_invalid(valid, vals):
    return torch.where(valid, vals, torch.full((), float("nan"),
                                               dtype=vals.dtype,
                                               device=vals.device))


@register_op("cross_entropy", nondiff_inputs=("Label",))
def cross_entropy(ctx, ins, attrs):
    """Y [N, 1] = -log(X[label] + 1e-8) of probabilities X [N, C] against
    hard labels (any shape with N entries), or -sum(label * log(X +
    1e-8)) against soft labels [N, C].  A ragged X gives a ragged Y
    over its splits (a loss per row)."""
    x = _f32(ins["X"][0])
    label = values_of(ins["Label"][0])
    eps = 1e-8
    if attrs.get("soft_label", False):
        y = -(_f32(label) * torch.log(x + eps)).sum(dim=-1, keepdim=True)
    else:
        ids, valid = _hard_ids(label, x.shape[-1])
        y = _nan_where_invalid(valid, -torch.log(x.gather(-1, ids) + eps))
    return {"Y": [like(ins["X"][0], y)]}


@register_op("softmax_with_cross_entropy", nondiff_inputs=("Label",))
def softmax_with_cross_entropy(ctx, ins, attrs):
    """Softmax [N, C] and Loss [N, 1] of Logits [N, C] against hard
    labels, or with `soft_label` against a distribution Label [N, C]
    (-sum(label * log_softmax), the label-smoothed loss).  Hard labels
    hold class ids, any shape with N entries (int32 as fed; cast to
    int64 for the gather).  They index as jnp.take_along_axis does on
    the JAX side: a negative id counts from the end, one outside
    [-C, C) gives a NaN loss."""
    logits = _f32(ins["Logits"][0])
    logp = torch.log_softmax(logits, dim=-1)
    if attrs.get("soft_label", False):
        loss = -(_f32(ins["Label"][0]) * logp).sum(dim=-1, keepdim=True)
        return {"Softmax": [torch.exp(logp)], "Loss": [loss]}
    ids, valid = _hard_ids(ins["Label"][0], logp.shape[-1])
    loss = _nan_where_invalid(valid, -logp.gather(-1, ids))
    return {"Softmax": [torch.exp(logp)], "Loss": [loss]}


@register_op("sigmoid_cross_entropy_with_logits")
def sigmoid_cross_entropy_with_logits(ctx, ins, attrs):
    """Out = max(x, 0) - x * z + log(1 + exp(-|x|)), elementwise over
    logits X and labels Z (cast to X's dtype): the stable form of
    -z log(sigmoid(x)) - (1 - z) log(1 - sigmoid(x)).  Its grad is the
    generic one, |x|'s at 0 that of `jnp.abs` (1), as on the JAX side."""
    x = values_of(ins["X"][0])
    label = values_of(ins["Label"][0]).to(x.dtype)
    # torch.maximum, not clamp: its grad splits a tie at x == 0 evenly,
    # as jnp.maximum's does
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    loss = torch.maximum(x, zero) - x * label \
        + torch.log1p(torch.exp(-jnp_abs(x)))
    return {"Out": [loss]}


@register_op("smooth_l1_loss")
def smooth_l1_loss(ctx, ins, attrs):
    """d = (X - Y) * InsideWeight; Out [N, 1] sums over all but the
    first dim of 0.5 sigma^2 d^2 where |d| < 1 / sigma^2, else
    |d| - 0.5 / sigma^2, each times OutsideWeight; Diff is d."""
    x, y = _f32(ins["X"][0]), _f32(ins["Y"][0])
    sigma2 = attrs.get("sigma", 1.0) ** 2
    d = x - y
    inside, outside = (ins.get(slot, [None])[0]
                       for slot in ("InsideWeight", "OutsideWeight"))
    if inside is not None:
        d = d * _f32(inside)
    ad = jnp_abs(d)
    val = torch.where(ad < 1.0 / sigma2, 0.5 * sigma2 * d * d,
                      ad - 0.5 / sigma2)
    if outside is not None:
        val = val * _f32(outside)
    out = torch.sum(val, dim=tuple(range(1, val.dim())))
    return {"Diff": [d], "Out": [out.reshape(-1, 1)]}
