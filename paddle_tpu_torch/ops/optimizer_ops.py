"""Optimizer update ops: `sgd` and `momentum`.

Counterpart of paddle_tpu/ops/optimizer_ops.py (reference: sgd_op.cc,
momentum_op.cc).  An update is a pure function of its inputs; the
executor writes ParamOut and VelocityOut, which name the same variables
as Param and Velocity (`in_place_outputs`), back to the scope after the
run.  The other optimizers wait (ROADMAP A).
"""

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
