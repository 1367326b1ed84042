"""Normalisation op kernels: `layer_norm` and its closed-form grad.

Counterpart of paddle_tpu/ops/norm.py (reference: layer_norm_op.cc).
"""

import torch

from .registry import register_grad_kernel, register_op


def _slot0(ins, slot):
    """First entry of an optional grad-op slot, or None (a slot that is
    missing, empty or `@EMPTY@`)."""
    vs = ins.get(slot)
    return vs[0] if vs else None


@register_op("layer_norm")
def layer_norm(ctx, ins, attrs):
    """Normalise over dims [begin_norm_axis:].  Statistics in float32,
    population variance, eps default 1e-5; outputs Y (X's dtype) and
    the per-row Mean and Variance, shape [prod(X.shape[:begin])]."""
    x = ins["X"][0]
    begin = int(attrs.get("begin_norm_axis", 1))
    eps = attrs.get("epsilon", 1e-5)
    lead = 1
    for d in x.shape[:begin]:
        lead *= d
    x2 = x.reshape(lead, -1).float()
    m = x2.mean(dim=1, keepdim=True)
    v = x2.var(dim=1, unbiased=False, keepdim=True)
    norm = ((x2 - m) * torch.rsqrt(v + eps)).to(x.dtype)
    if "Scale" in ins:
        norm = norm * ins["Scale"][0].reshape(1, -1).to(x.dtype)
    if "Bias" in ins:
        norm = norm + ins["Bias"][0].reshape(1, -1).to(x.dtype)
    return {"Y": [norm.reshape(x.shape)], "Mean": [m.reshape(lead)],
            "Variance": [v.reshape(lead)]}


@register_grad_kernel("layer_norm")
def layer_norm_grad(ctx, ins, attrs):
    """Closed-form layer_norm backward, transcribed from the JAX side's
    (reference: layer_norm_op.cc grad kernels): the full-size math runs
    in x's dtype with per-row f32 coefficients.

        dy' = dy * scale;  g1 = sum_j dy';  g2 = sum_j dy' (x - m)
        dx = dy' inv + x B + D,  B = -inv^3 g2 / N,  D = -inv g1 / N - B m
        dscale_j = sum_r dy (x - m) inv;  dbias_j = sum_r dy

    The forward's saved O@Mean/O@Variance are used when present, else
    recomputed; OG@Mean/OG@Variance fold into B and D."""
    x = ins["X"][0]
    dy = _slot0(ins, "OG@Y")
    begin = int(attrs.get("begin_norm_axis", 1))
    eps = attrs.get("epsilon", 1e-5)
    lead = 1
    for d in x.shape[:begin]:
        lead *= d
    x2 = x.reshape(lead, -1)
    n = x2.shape[1]

    xs = x2.float()
    sm = _slot0(ins, "O@Mean")
    sv = _slot0(ins, "O@Variance")
    if sm is not None and sv is not None:
        m = sm.reshape(lead, 1).float()
        v = sv.reshape(lead, 1).float()
    else:
        m = xs.mean(dim=1, keepdim=True)
        v = xs.var(dim=1, unbiased=False, keepdim=True)
    inv = torch.rsqrt(v + eps)
    xc = xs - m

    scale = _slot0(ins, "Scale")
    if scale is not None:
        scale = scale.reshape(1, -1)
    if dy is None:
        g1 = g2 = torch.zeros((lead, 1), dtype=torch.float32,
                              device=x.device)
    else:
        dy2 = dy.reshape(lead, -1)
        dys = dy2.float()
        dyp = dys * scale if scale is not None else dys
        g1 = dyp.sum(dim=1, keepdim=True)
        g2 = (dyp * xc).sum(dim=1, keepdim=True)

    b = -inv.pow(3) * g2 / n
    d = -inv * g1 / n - b * m
    dm = _slot0(ins, "OG@Mean")
    dv = _slot0(ins, "OG@Variance")
    if dv is not None:
        dv = dv.reshape(lead, 1).float()
        b = b + 2.0 * dv / n
        d = d - 2.0 * dv * m / n
    if dm is not None:
        d = d + dm.reshape(lead, 1).float() / n
    dx2 = x2 * b.to(x2.dtype) + d.to(x2.dtype)
    if dy is not None:
        dyp_lowp = dy2 * scale.to(dy2.dtype) if scale is not None else dy2
        dx2 = dx2 + dyp_lowp * inv.to(dy2.dtype)
    out = {"X@GRAD": [dx2.reshape(x.shape)]}
    if scale is not None:
        out["Scale@GRAD"] = [(dys * xc * inv).sum(dim=0) if dy is not None
                             else torch.zeros(n, device=x.device)]
    if _slot0(ins, "Bias") is not None:
        out["Bias@GRAD"] = [dys.sum(dim=0) if dy is not None
                            else torch.zeros(n, device=x.device)]
    return out
