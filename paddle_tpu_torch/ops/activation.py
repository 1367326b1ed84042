"""Activation op kernels: the unary activations, `prelu` and `softmax`.

Counterpart of paddle_tpu/ops/activation.py (reference:
activation_op.cc, softmax_op.cc).  Each unary activation is one torch
expression on X (on its values when X is ragged, the result ragged over
X's splits) and its attrs; grads come from the generic vjp.  Where the
JAX side's expression has a tie, the torch one is chosen to take the
same grad there: `jnp.clip` (`brelu`, `relu6`, `hard_sigmoid`,
`soft_relu`) is `minimum(maximum(x, lo), hi)`, whose grad is half at a
bound, where `torch.clamp`'s is whole, and 0 times dOut at a NaN x,
where `torch.maximum`'s passes dOut; `jnp.abs`'s grad at 0 is 1, where
`torch.abs`'s is 0.  `relu` has a grad kernel of its own: `jax.nn.relu`'s
grad selects (dOut where X > 0, else 0), so a NaN X takes 0, where
`torch.relu`'s passes dOut through.
"""

import torch

from .registry import like, register_grad_kernel, register_op, values_of


def jnp_abs(x):
    """|x| with `jnp.abs`'s grad: 1 at 0 and at -0.0 (`torch.abs`'s is
    0).  x + 0.0 turns -0.0 into +0.0 and leaves every other x as it
    is, so the value is `torch.abs`'s."""
    return torch.where(x >= 0, x + 0.0, -x)


class _JnpBound(torch.autograd.Function):
    """`jnp.maximum(x, bound)` (greater) or `jnp.minimum(x, bound)` of x
    and a 0-d bound, with JAX's value and grad.  The value is NaN at a
    NaN x and +0.0 at a tie of zeros.  The grad is dOut times JAX's
    `_balanced_eq`: 1 where x alone is the result, 1/2 at a tie, 0 where
    the bound wins or x is NaN (NaN equals no result), so a NaN dOut
    stays NaN there; torch.maximum's passes dOut whole at a NaN x."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, bound, greater):
        wins = x > bound if greater else x < bound
        rest = torch.where(torch.isnan(x), x, bound)
        return torch.where(wins, x, torch.where(x == bound,
                                                (x + bound) * 0.5, rest))

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, bound, _ = inputs
        ctx.save_for_backward(x, bound, output)

    @staticmethod
    def backward(ctx, grad):
        x, bound, out = ctx.saved_tensors
        one = torch.ones((), dtype=grad.dtype, device=grad.device)
        zero = torch.zeros((), dtype=grad.dtype, device=grad.device)
        share = torch.where(x == out, one, zero) / torch.where(
            bound == out, one + one, one)
        return grad * share, None, None


def jnp_clip(x, lo, hi):
    """`jnp.clip(x, lo, hi)` with its grad: half at a bound, as
    `jnp.maximum` and `jnp.minimum` split a tie, and 0 times dOut at a
    NaN x (`_JnpBound`; the scalar bounds become 0-d tensors, filled on
    the device without a copy from the host: `torch.clamp` would give
    the whole grad there)."""
    lo = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi = torch.full((), hi, dtype=x.dtype, device=x.device)
    return _JnpBound.apply(_JnpBound.apply(x, lo, True), hi, False)


# the activations without attrs
UNARY = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "exp": torch.exp,
    "sqrt": torch.sqrt,
    "abs": jnp_abs,
    "log": torch.log,
    "square": torch.square,
}


def _softplus(x):
    # jax.nn.softplus is jnp.logaddexp(x, 0), whose grad is
    # exp(x - out), as torch.logaddexp's
    return torch.logaddexp(x, torch.zeros_like(x))


def _where0(cond, x):
    return torch.where(cond, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


# the activations with attrs, each fn(x, attrs), with the JAX side's
# defaults
ACTIVATIONS = {
    "logsigmoid": lambda x, a: -_softplus(-x),
    "tanh_shrink": lambda x, a: x - torch.tanh(x),
    "softshrink": lambda x, a: torch.where(
        x > a.get("lambda", 0.5), x - a.get("lambda", 0.5),
        _where0(x < -a.get("lambda", 0.5), x + a.get("lambda", 0.5))),
    "hard_shrink": lambda x, a: _where0(
        jnp_abs(x) > a.get("threshold", 0.5), x),
    "ceil": lambda x, a: torch.ceil(x),
    "floor": lambda x, a: torch.floor(x),
    "round": lambda x, a: torch.round(x),
    "reciprocal": lambda x, a: 1.0 / x,
    "softplus": lambda x, a: _softplus(x),
    "softsign": lambda x, a: x / (1 + jnp_abs(x)),
    "brelu": lambda x, a: jnp_clip(x, a.get("t_min", 0.0),
                                   a.get("t_max", 24.0)),
    "leaky_relu": lambda x, a: torch.where(x >= 0, x,
                                           x * a.get("alpha", 0.02)),
    "soft_relu": lambda x, a: torch.log(1 + torch.exp(jnp_clip(
        x, -a.get("threshold", 40.0), a.get("threshold", 40.0)))),
    "elu": lambda x, a: torch.where(
        x >= 0, x, a.get("alpha", 1.0) * (torch.exp(x) - 1)),
    "relu6": lambda x, a: jnp_clip(x, 0.0, a.get("threshold", 6.0)),
    "pow": lambda x, a: torch.pow(x, a.get("factor", 1.0)),
    "stanh": lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
        a.get("scale_a", 2.0 / 3.0) * x),
    "thresholded_relu": lambda x, a: _where0(
        x > a.get("threshold", 1.0), x),
    "hard_sigmoid": lambda x, a: jnp_clip(
        a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0),
    "swish": lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x),
}


def _unary(name, fn):
    @register_op(name)
    def kernel(ctx, ins, attrs):
        return {"Out": [like(ins["X"][0], fn(values_of(ins["X"][0]),
                                             attrs))]}

    kernel.__name__ = name
    return kernel


for _name, _fn in UNARY.items():
    _unary(_name, lambda x, a, fn=_fn: fn(x))
for _name, _fn in ACTIVATIONS.items():
    _unary(_name, _fn)


@register_grad_kernel("relu")
def relu_grad(ctx, ins, attrs):
    """dX = dOut where X > 0, else 0 (`jax.nn.relu`'s select; for every X
    but NaN the bits of torch.relu's backward); ragged over a ragged X's
    splits."""
    x = ins["X"][0]
    xv = values_of(x)
    og = values_of(ins["OG@Out"][0]).to(xv.dtype).reshape(xv.shape)
    zero = torch.zeros((), dtype=xv.dtype, device=xv.device)
    return {"X@GRAD": [like(x, torch.where(xv > 0, og, zero))]}


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


@register_op("prelu")
def prelu(ctx, ins, attrs):
    """x where x >= 0, else x * Alpha: one Alpha for all of X, or one
    per column of a [N, C] X."""
    x, alpha = ins["X"][0], ins["Alpha"][0]
    slope = alpha.reshape(1, -1) if alpha.numel() > 1 else alpha
    return {"Out": [torch.where(x >= 0, x, x * slope)]}
