"""Metric op kernels: `accuracy`.

Counterpart of paddle_tpu/ops/metrics.py (reference: accuracy_op.cc),
dense inputs only: ragged (LoD) ones come with ROADMAP A7.
"""

import torch

from .registry import dense, register_op


@register_op("accuracy", stop_gradient_op=True,
             nondiff_inputs=("Out", "Indices", "Label"))
def accuracy(ctx, ins, attrs):
    """The share of rows whose label is among their top-k `Indices`
    ([N, k]; Label [N, 1]): Accuracy f32 [1], Correct and Total int32
    [1] (reference accuracy_op.h AccuracyKernel)."""
    indices = dense(ins["Indices"][0], "accuracy").to(torch.int32)
    label = dense(ins["Label"][0], "accuracy").to(torch.int32)
    hit = (indices == label.reshape(-1, 1)).any(dim=1)
    correct = hit.sum(dtype=torch.int32).reshape(1)
    total = indices.shape[0]
    acc = correct.to(torch.float32) / float(max(total, 1))
    return {"Accuracy": [acc],
            "Correct": [correct],
            "Total": [torch.full((1,), total, dtype=torch.int32,
                                 device=indices.device)]}
