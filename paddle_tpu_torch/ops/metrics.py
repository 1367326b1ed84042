"""Metric op kernels: `accuracy`.

Counterpart of paddle_tpu/ops/metrics.py (reference: accuracy_op.cc).
Ragged (LoD) inputs count their valid rows only, as on the JAX side.
"""

import torch

from ..core.ragged import RaggedTensor
from .registry import dense, register_op


@register_op("accuracy", stop_gradient_op=True,
             nondiff_inputs=("Out", "Indices", "Label"))
def accuracy(ctx, ins, attrs):
    """The share of rows whose label is among their top-k `Indices`
    ([N, k]; Label [N, 1]): Accuracy f32 [1], Correct and Total int32
    [1] (reference accuracy_op.h AccuracyKernel).  Where Indices or
    Label is ragged, the rows past its `nvalid` (padding to a bucket)
    count neither as hits nor in the total."""
    ind_in, lab_in = ins["Indices"][0], ins["Label"][0]
    indices, label = [
        (v.values if isinstance(v, RaggedTensor)
         else dense(v, "accuracy")).to(torch.int32) for v in (ind_in, lab_in)]
    hit = (indices == label.reshape(-1, 1)).any(dim=1)
    ragged = next((v for v in (ind_in, lab_in)
                   if isinstance(v, RaggedTensor)), None)
    if ragged is not None:
        hit = hit & ragged.valid_mask()
        num = ragged.nvalid.to(torch.int32).reshape(1)
        correct = hit.sum(dtype=torch.int32).reshape(1)
        acc = correct.to(torch.float32) / num.clamp(min=1).to(torch.float32)
        return {"Accuracy": [acc], "Correct": [correct], "Total": [num]}
    correct = hit.sum(dtype=torch.int32).reshape(1)
    total = indices.shape[0]
    acc = correct.to(torch.float32) / float(max(total, 1))
    return {"Accuracy": [acc],
            "Correct": [correct],
            "Total": [torch.full((1,), total, dtype=torch.int32,
                                 device=indices.device)]}
