"""Loss op kernels: `softmax_with_cross_entropy`.

Counterpart of paddle_tpu/ops/loss.py (reference:
softmax_with_cross_entropy_op.cc).  Losses compute in f32: a bf16 input
is upcast first, as on the JAX side.
"""

import torch

from .registry import register_op


def _f32(x):
    return x.float() if x.dtype == torch.bfloat16 else x


@register_op("softmax_with_cross_entropy", nondiff_inputs=("Label",))
def softmax_with_cross_entropy(ctx, ins, attrs):
    """Softmax [N, C] and Loss [N, 1] of Logits [N, C] against hard
    labels: Label holds class ids, any shape with N entries (int32 as
    fed; cast to int64 for the gather).  They index as
    jnp.take_along_axis does on the JAX side: a negative id counts from
    the end, one outside [-C, C) gives a NaN loss."""
    if attrs.get("soft_label", False):
        raise NotImplementedError(
            "softmax_with_cross_entropy: soft labels are not ported yet "
            "(hard labels only)")
    logits = _f32(ins["Logits"][0])
    logp = torch.log_softmax(logits, dim=-1)
    n = logp.shape[-1]
    raw = ins["Label"][0].reshape(-1, 1).long()
    ids = torch.where(raw < 0, raw + n, raw)
    valid = (ids >= 0) & (ids < n)
    picked = logp.gather(-1, ids.clamp(0, n - 1))
    loss = torch.where(valid, -picked,
                       torch.full((), float("nan"), dtype=logp.dtype,
                                  device=logp.device))
    return {"Softmax": [torch.exp(logp)], "Loss": [loss]}
