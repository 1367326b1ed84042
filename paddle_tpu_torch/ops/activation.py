"""Activation op kernels: the unary activations and `softmax`.

Counterpart of paddle_tpu/ops/activation.py (reference:
activation_op.cc, softmax_op.cc).  Each unary activation is one torch
expression on X (on its values when X is ragged, the result ragged over
X's splits); grads come from the generic vjp.
"""

import torch

from .registry import like, register_op, values_of

UNARY = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "exp": torch.exp,
    "sqrt": torch.sqrt,
    "abs": torch.abs,
    "log": torch.log,
    "square": torch.square,
}


def _unary(name, fn):
    @register_op(name)
    def kernel(ctx, ins, attrs):
        return {"Out": [like(ins["X"][0], fn(values_of(ins["X"][0])))]}

    kernel.__name__ = name
    return kernel


for _name, _fn in UNARY.items():
    _unary(_name, _fn)


@register_op("softmax")
def softmax(ctx, ins, attrs):
    """Softmax over the last dim; a bf16 input exponentiates in f32 and
    gives its probabilities back in bf16."""
    x = values_of(ins["X"][0])
    if x.dtype == torch.bfloat16:
        out = torch.softmax(x.float(), dim=-1).to(x.dtype)
    else:
        out = torch.softmax(x, dim=-1)
    return {"Out": [like(ins["X"][0], out)]}
