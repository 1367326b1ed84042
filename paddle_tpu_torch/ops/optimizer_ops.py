"""Optimizer update ops: `sgd`, `momentum`, `adam`, `adamax`, `adagrad`,
`decayed_adagrad`, `adadelta`, `rmsprop`, `ftrl`, `proximal_gd` and
`proximal_adagrad`, each over a dense or a SelectedRows grad, and
`fused_update`, one recipe over a stack of parameters.

Counterpart of paddle_tpu/ops/optimizer_ops.py (reference: sgd_op.cc,
momentum_op.cc, adam_op.cc, adamax_op.cc, adagrad_op.cc,
decayed_adagrad_op.cc, adadelta_op.cc, rmsprop_op.cc, ftrl_op.cc,
proximal_gd_op.cc, proximal_adagrad_op.cc).  An update is a pure
function of its inputs; the executor writes ParamOut and the state
outputs, which name the same variables as Param and the state inputs
(`in_place_outputs`), back to the scope after the run.

A SelectedRows grad (`lookup_table(is_sparse=True)`) takes the JAX
side's semantics exactly.  `sgd` and `adagrad` update by rows
(`core.ragged.add_rows_`: the rows of a repeated id summed in a fixed
order, then one `index_add_` at the grad's ids), so rows outside the
batch keep their bits and the update repeats bit for bit on the card.
Every other op densifies the grad first (`SelectedRows.to_dense`), so
under Adam a row outside the batch still moves once its moments are
nonzero; a "lazy" sparse Adam is not the JAX side's function.

Donation: where the executor donates a state tensor (fluid/executor.py,
FLAGS_donation), it names the update op's in-place output slots in
`ctx.in_place`, and `sgd`, `momentum`, `adam` and `adagrad` write those
outputs into their inputs' storage: the last elementwise op of each
takes `out=` (the same kernel, so the same bits), and a by-rows update
adds into the table itself instead of a copy of it, as the JAX
executor's donated scatter does.  Without donation (an eager run,
FLAGS_donation=off, or a result of another dtype than the state's, as
a bf16 state updated in f32) every output is a new tensor.
"""

import numpy as np
import torch

from ..core.ragged import SelectedRows, add_rows_, row_index
from .registry import get_op_info, register_op


def _lr(ins):
    """The shape-(1,) LearningRate, kept 1-D: it broadcasts against any
    parameter and, unlike a 0-d torch tensor, takes part in type
    promotion as the JAX side's 0-d array does (a bf16 parameter or
    velocity updates its parameter to f32 on both sides)."""
    return ins["LearningRate"][0]


def _scalar(ins, slot):
    return ins[slot][0].reshape(())


def _dense_grad(ins):
    g = ins["Grad"][0]
    return g.to_dense() if isinstance(g, SelectedRows) else g


def _scatter_add(x, rows, values, in_place=False):
    """x with `values` added at the SelectedRows ids `rows`
    (`core.ragged.add_rows_`): into x itself when the executor donated
    it, else into a copy."""
    return add_rows_(x if in_place else x.clone(), rows, values)


def _donated(ctx, slot):
    """Whether the executor donated output `slot` (ctx.in_place; a
    shape-inference context donates nothing)."""
    return slot in getattr(ctx, "in_place", ())


def _into(ctx, slot, dst, fn, a, b):
    """fn(a, b), written into `dst` when the executor donated `slot`
    and the result has dst's shape and dtype: the same kernel with
    `out=dst`, so the same bits as the new tensor."""
    if _donated(ctx, slot) and dst.dtype == torch.result_type(a, b) \
            and dst.shape == torch.broadcast_shapes(a.shape, b.shape):
        return fn(a, b, out=dst)
    return fn(a, b)


@register_op("sgd", stop_gradient_op=True, in_place_outputs=("ParamOut",))
def sgd(ctx, ins, attrs):
    """p' = p - lr * g; a SelectedRows g adds -lr * values at its rows
    (reference sgd_op.cc, the SelectedRows path)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    if isinstance(g, SelectedRows):
        return {"ParamOut": [_scatter_add(p, g.rows, -_lr(ins) * g.values,
                                          _donated(ctx, "ParamOut"))]}
    return {"ParamOut": [_into(ctx, "ParamOut", p, torch.sub, p,
                               _lr(ins) * g)]}


@register_op("momentum", stop_gradient_op=True,
             in_place_outputs=("ParamOut", "VelocityOut"))
def momentum(ctx, ins, attrs):
    """v' = mu * v + g;  p' = p - lr * v', or with `use_nesterov`
    p' = p - (g + mu * v') * lr."""
    p, v = ins["Param"][0], ins["Velocity"][0]
    g = _dense_grad(ins)
    lr = _lr(ins)
    mu = attrs["mu"]
    v_out = _into(ctx, "VelocityOut", v, torch.add, mu * v, g)
    if attrs.get("use_nesterov", False):
        p_out = _into(ctx, "ParamOut", p, torch.sub, p,
                      (g + mu * v_out) * lr)
    else:
        p_out = _into(ctx, "ParamOut", p, torch.sub, p, lr * v_out)
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


@register_op("adam", stop_gradient_op=True,
             in_place_outputs=("ParamOut", "Moment1Out", "Moment2Out"))
def adam(ctx, ins, attrs):
    """m1' = b1 m1 + (1 - b1) g;  m2' = b2 m2 + (1 - b2) g^2;
    p' = p - lr sqrt(1 - b2^t) / (1 - b1^t) * m1' / (sqrt(m2') + eps),
    with b1^t and b2^t the shared Beta1Pow and Beta2Pow, which the
    optimizer's `scale` ops advance once per step."""
    p, g = ins["Param"][0], _dense_grad(ins)
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = _scalar(ins, "Beta1Pow"), _scalar(ins, "Beta2Pow")
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m1_out = _into(ctx, "Moment1Out", m1, torch.add, b1 * m1,
                   (1 - b1) * g)
    m2_out = _into(ctx, "Moment2Out", m2, torch.add, b2 * m2,
                   (1 - b2) * torch.square(g))
    lr_t = _lr(ins) * torch.sqrt(1 - b2p) / (1 - b1p)
    p_out = _into(ctx, "ParamOut", p, torch.sub, p,
                  lr_t * m1_out / (torch.sqrt(m2_out) + eps))
    return {"ParamOut": [p_out], "Moment1Out": [m1_out],
            "Moment2Out": [m2_out]}


@register_op("adamax", stop_gradient_op=True,
             in_place_outputs=("ParamOut", "MomentOut", "InfNormOut"))
def adamax(ctx, ins, attrs):
    """m' = b1 m + (1 - b1) g;  u' = max(b2 u, |g|);
    p' = p - lr / (1 - b1^t) * m' / (u' + eps)."""
    p, g = ins["Param"][0], _dense_grad(ins)
    m, inf = ins["Moment"][0], ins["InfNorm"][0]
    b1p = _scalar(ins, "Beta1Pow")
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_out = b1 * m + (1 - b1) * g
    inf_out = torch.maximum(b2 * inf, torch.abs(g))
    lr_t = _lr(ins) / (1 - b1p)
    p_out = p - lr_t * m_out / (inf_out + eps)
    return {"ParamOut": [p_out], "MomentOut": [m_out],
            "InfNormOut": [inf_out]}


@register_op("adagrad", stop_gradient_op=True,
             in_place_outputs=("ParamOut", "MomentOut"))
def adagrad(ctx, ins, attrs):
    """mom' = mom + g^2;  p' = p - lr * g / (sqrt(mom') + eps).  A
    SelectedRows g (reference adagrad_op's SelectedRows path) adds each
    row's own values^2 into the moment, then each row, repeated ones
    each on their own, adds -lr * values / (sqrt(mom'[row]) + eps): with
    repeated ids this is not the dense update of the summed grad."""
    p, g, lr = ins["Param"][0], ins["Grad"][0], _lr(ins)
    mom = ins["Moment"][0]
    eps = attrs.get("epsilon", 1e-6)
    if isinstance(g, SelectedRows):
        mom_out = _scatter_add(mom, g.rows, torch.square(g.values),
                               _donated(ctx, "MomentOut"))
        index, _ = row_index(g.rows, p.shape[0])
        p_out = _scatter_add(
            p, g.rows, -lr * g.values / (torch.sqrt(mom_out[index]) + eps),
            _donated(ctx, "ParamOut"))
        return {"ParamOut": [p_out], "MomentOut": [mom_out]}
    mom_out = mom + torch.square(g)
    p_out = p - lr * g / (torch.sqrt(mom_out) + eps)
    return {"ParamOut": [p_out], "MomentOut": [mom_out]}


@register_op("decayed_adagrad", stop_gradient_op=True,
             in_place_outputs=("ParamOut", "MomentOut"))
def decayed_adagrad(ctx, ins, attrs):
    """mom' = decay mom + (1 - decay) g^2;
    p' = p - lr * g / (sqrt(mom') + eps)."""
    p, g, lr = ins["Param"][0], _dense_grad(ins), _lr(ins)
    mom = ins["Moment"][0]
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mom_out = decay * mom + (1 - decay) * torch.square(g)
    p_out = p - lr * g / (torch.sqrt(mom_out) + eps)
    return {"ParamOut": [p_out], "MomentOut": [mom_out]}


@register_op("adadelta", stop_gradient_op=True,
             in_place_outputs=("ParamOut", "AvgSquaredGradOut",
                               "AvgSquaredUpdateOut"))
def adadelta(ctx, ins, attrs):
    """E[g^2]' = rho E[g^2] + (1 - rho) g^2;
    d = -sqrt((E[d^2] + eps) / (E[g^2]' + eps)) * g;
    E[d^2]' = rho E[d^2] + (1 - rho) d^2;  p' = p + d.  No learning
    rate."""
    p, g = ins["Param"][0], _dense_grad(ins)
    avg_sq_g = ins["AvgSquaredGrad"][0]
    avg_sq_u = ins["AvgSquaredUpdate"][0]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    asg_out = rho * avg_sq_g + (1 - rho) * torch.square(g)
    update = -torch.sqrt((avg_sq_u + eps) / (asg_out + eps)) * g
    asu_out = rho * avg_sq_u + (1 - rho) * torch.square(update)
    return {"ParamOut": [p + update], "AvgSquaredGradOut": [asg_out],
            "AvgSquaredUpdateOut": [asu_out]}


@register_op("rmsprop", stop_gradient_op=True,
             in_place_outputs=("ParamOut", "MomentOut", "MeanSquareOut"))
def rmsprop(ctx, ins, attrs):
    """ms' = decay ms + (1 - decay) g^2;
    mom' = momentum mom + lr * g / sqrt(ms' + eps);  p' = p - mom'."""
    p, g, lr = ins["Param"][0], _dense_grad(ins), _lr(ins)
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    rho = attrs.get("decay", 0.9)
    eps = attrs.get("epsilon", 1e-10)
    mu = attrs.get("momentum", 0.0)
    ms_out = rho * ms + (1 - rho) * torch.square(g)
    mom_out = mu * mom + lr * g / torch.sqrt(ms_out + eps)
    return {"ParamOut": [p - mom_out], "MomentOut": [mom_out],
            "MeanSquareOut": [ms_out]}


def _lr_pow(x, lr_power):
    return torch.sqrt(x) if lr_power == -0.5 else torch.pow(x, -lr_power)


@register_op("ftrl", stop_gradient_op=True,
             in_place_outputs=("ParamOut", "SquaredAccumOut",
                               "LinearAccumOut"))
def ftrl(ctx, ins, attrs):
    """FTRL-proximal: n' = n + g^2;  sigma = (n'^-p - n^-p) / lr;
    z' = z + g - sigma * w;  w' = (l1 sign(z') - z') / (n'^-p / lr +
    2 l2) where |z'| > l1, else 0 (p the `lr_power`, -0.5 by
    default)."""
    p, g, lr = ins["Param"][0], _dense_grad(ins), _lr(ins)
    sq_accum = ins["SquaredAccumulator"][0]
    lin_accum = ins["LinearAccumulator"][0]
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    new_accum = sq_accum + torch.square(g)
    new_pow = _lr_pow(new_accum, lr_power)
    sigma = (new_pow - _lr_pow(sq_accum, lr_power)) / lr
    lin_out = lin_accum + g - sigma * p
    denom = new_pow / lr + 2 * l2
    pre_shrink = (l1 * torch.sign(lin_out) - lin_out) / denom
    p_out = torch.where(torch.abs(lin_out) > l1, pre_shrink,
                        torch.zeros_like(p))
    return {"ParamOut": [p_out], "SquaredAccumOut": [new_accum],
            "LinearAccumOut": [lin_out]}


def _shrink(prox, lr_t, l1, l2):
    return (torch.sign(prox) / (1.0 + lr_t * l2)
            * torch.clamp(torch.abs(prox) - lr_t * l1, min=0.0))


@register_op("proximal_gd", stop_gradient_op=True,
             in_place_outputs=("ParamOut",))
def proximal_gd(ctx, ins, attrs):
    """prox = p - lr * g;
    p' = sign(prox) / (1 + lr l2) * max(|prox| - lr l1, 0)."""
    p, g, lr = ins["Param"][0], _dense_grad(ins), _lr(ins)
    return {"ParamOut": [_shrink(p - lr * g, lr, attrs.get("l1", 0.0),
                                 attrs.get("l2", 0.0))]}


@register_op("proximal_adagrad", stop_gradient_op=True,
             in_place_outputs=("ParamOut", "MomentOut"))
def proximal_adagrad(ctx, ins, attrs):
    """mom' = mom + g^2;  lr_t = lr / sqrt(mom');  prox = p - lr_t * g;
    p' = sign(prox) / (1 + lr_t l2) * max(|prox| - lr_t l1, 0)."""
    p, g, lr = ins["Param"][0], _dense_grad(ins), _lr(ins)
    mom_out = ins["Moment"][0] + torch.square(g)
    lr_t = lr / torch.sqrt(mom_out)
    return {"ParamOut": [_shrink(p - lr_t * g, lr_t, attrs.get("l1", 0.0),
                                 attrs.get("l2", 0.0))],
            "MomentOut": [mom_out]}


# the attrs fluid/fusion.py adds to the inner recipe's own
FUSION_ATTRS = ("inner_type", "stacked_slots")


@register_op("fused_update", stop_gradient_op=True,
             in_place_outputs=("ParamOut",))
def fused_update(ctx, ins, attrs):
    """One update recipe (`inner_type`) over a stack of parameters
    (fluid/fusion.py `fuse_update_ops`): each slot of `stacked_slots`
    holds one tensor per parameter, flattened and concatenated; the
    inner kernel runs once over the concatenation; each output splits
    back into the parameters' shapes.  The other slots (the learning
    rate, Adam's beta powers) are shared.  Every recipe is elementwise
    per parameter, so each element takes the same operations on the
    same operands as in the unfused op: the same bits.  A SelectedRows
    grad among them indexes rows of its own parameter, so the recipe
    then runs per parameter, as on the JAX side."""
    inner = get_op_info(attrs["inner_type"]).kernel
    stacked = set(attrs["stacked_slots"])
    inner_attrs = {k: v for k, v in attrs.items() if k not in FUSION_ATTRS}
    params = ins["Param"]
    if any(isinstance(g, SelectedRows) for g in ins["Grad"]):
        outs = {}
        for i in range(len(params)):
            one = {k: [v[i]] if k in stacked else v for k, v in ins.items()}
            for k, v in inner(ctx, one, inner_attrs).items():
                outs.setdefault(k, []).append(v[0])
        return outs
    shapes = [p.shape for p in params]
    sizes = [int(np.prod(s)) for s in shapes]
    res = inner(ctx, {k: [torch.cat([t.reshape(-1) for t in v])]
                      if k in stacked else v for k, v in ins.items()},
                inner_attrs)
    return {k: [piece.reshape(s) for piece, s in
                zip(torch.split(v[0], sizes), shapes)]
            for k, v in res.items()}
