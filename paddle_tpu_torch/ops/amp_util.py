"""The bf16 dtype policy of the heavy ops (see fluid/amp.py).

Counterpart of paddle_tpu/ops/amp_util.py.  Under `amp_bf16` the
`mul` and `conv2d` kernels cast their f32 operands to bf16; on the card
cuBLAS and cuDNN accumulate a bf16 product in f32 and round the result
to bf16, as the JAX side's f32-accumulated product rounded by
`amp_result`.  Under `amp_bf16_act` (on by default) the result stays
bf16, so the elementwise and norm chains after it read and write half
the bytes; `amp_harmonize` keeps a binary elementwise op over a bf16
activation and an f32 side input (a bias) in bf16.  Statistics, losses
and master weights stay f32.
"""

import torch

from ..utils import flags

__all__ = ["mxu_operands", "amp_result", "amp_harmonize", "keep_bf16_acts"]


def keep_bf16_acts():
    return flags.get_flag("amp_bf16") and flags.get_flag("amp_bf16_act")


def mxu_operands(*tensors):
    """Under `amp_bf16`, the f32 operands of a product cast to bf16;
    else the operands unchanged."""
    if not flags.get_flag("amp_bf16"):
        return tensors
    return tuple(t.to(torch.bfloat16) if t.dtype == torch.float32 else t
                 for t in tensors)


def amp_result(out, ref_dtype):
    """A heavy op's result in its reference dtype, unless the
    bf16-activation policy keeps an f32-reference result bf16."""
    if keep_bf16_acts() and ref_dtype == torch.float32:
        return out.to(torch.bfloat16)
    return out.to(ref_dtype)


def amp_harmonize(x, y):
    """Under the bf16-activation policy, a (bf16, f32) operand pair of a
    binary elementwise op computes in bf16 (torch would promote the
    bf16 activation to f32); else the pair unchanged."""
    if not keep_bf16_acts():
        return x, y
    if x.dtype == torch.bfloat16 and y.dtype == torch.float32:
        return x, y.to(torch.bfloat16)
    if x.dtype == torch.float32 and y.dtype == torch.bfloat16:
        return x.to(torch.bfloat16), y
    return x, y
