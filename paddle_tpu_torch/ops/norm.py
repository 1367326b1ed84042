"""Normalisation op kernels: the forward of `layer_norm`.

Counterpart of paddle_tpu/ops/norm.py (reference: layer_norm_op.cc).
"""

import torch

from .registry import register_op


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
