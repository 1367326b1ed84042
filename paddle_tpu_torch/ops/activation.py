"""Activation op kernels: `relu`.

Counterpart of paddle_tpu/ops/activation.py (reference:
activation_op.cc).
"""

import torch

from .registry import register_op


@register_op("relu")
def relu(ctx, ins, attrs):
    return {"Out": [torch.relu(ins["X"][0])]}
