"""Optimizer update ops: `sgd`, `momentum` and `adam`, dense grads.

Counterpart of paddle_tpu/ops/optimizer_ops.py (reference: sgd_op.cc,
momentum_op.cc, adam_op.cc).  An update is a pure function of its
inputs; the executor writes ParamOut and the state outputs, which name
the same variables as Param and the state inputs (`in_place_outputs`),
back to the scope after the run.  The other optimizers wait (ROADMAP
A3).
"""

import torch

from .registry import register_op


def _lr(ins):
    """The shape-(1,) LearningRate, kept 1-D: it broadcasts against any
    parameter and, unlike a 0-d torch tensor, takes part in type
    promotion as the JAX side's 0-d array does (a bf16 parameter or
    velocity updates its parameter to f32 on both sides)."""
    return ins["LearningRate"][0]


@register_op("sgd", stop_gradient_op=True, in_place_outputs=("ParamOut",))
def sgd(ctx, ins, attrs):
    """p' = p - lr * g."""
    p, g = ins["Param"][0], ins["Grad"][0]
    return {"ParamOut": [p - _lr(ins) * g]}


@register_op("momentum", stop_gradient_op=True,
             in_place_outputs=("ParamOut", "VelocityOut"))
def momentum(ctx, ins, attrs):
    """v' = mu * v + g;  p' = p - lr * v', or with `use_nesterov`
    p' = p - (g + mu * v') * lr."""
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    lr = _lr(ins)
    mu = attrs["mu"]
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


@register_op("adam", stop_gradient_op=True,
             in_place_outputs=("ParamOut", "Moment1Out", "Moment2Out"))
def adam(ctx, ins, attrs):
    """m1' = b1 m1 + (1 - b1) g;  m2' = b2 m2 + (1 - b2) g^2;
    p' = p - lr sqrt(1 - b2^t) / (1 - b1^t) * m1' / (sqrt(m2') + eps),
    with b1^t and b2^t the shared Beta1Pow and Beta2Pow, which the
    optimizer's `scale` ops advance once per step."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p = ins["Beta1Pow"][0].reshape(())
    b2p = ins["Beta2Pow"][0].reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * torch.square(g)
    lr_t = _lr(ins) * torch.sqrt(1 - b2p) / (1 - b1p)
    p_out = p - lr_t * m1_out / (torch.sqrt(m2_out) + eps)
    return {"ParamOut": [p_out], "Moment1Out": [m1_out],
            "Moment2Out": [m2_out]}
