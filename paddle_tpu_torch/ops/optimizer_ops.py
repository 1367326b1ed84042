"""Optimizer update ops: `momentum`.

Counterpart of paddle_tpu/ops/optimizer_ops.py (reference:
momentum_op.cc).  An update is a pure function of its inputs; the
executor writes ParamOut and VelocityOut, which name the same variables
as Param and Velocity (`in_place_outputs`), back to the scope after the
run.  The other optimizers come with ROADMAP A3.
"""

from .registry import register_op


@register_op("momentum", stop_gradient_op=True,
             in_place_outputs=("ParamOut", "VelocityOut"))
def momentum(ctx, ins, attrs):
    """v' = mu * v + g;  p' = p - lr * v', or with `use_nesterov`
    p' = p - (g + mu * v') * lr.  LearningRate is a shape-(1,) tensor."""
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    lr = ins["LearningRate"][0].reshape(())
    mu = attrs["mu"]
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}
