"""Normalisation op kernels: `batch_norm` and `layer_norm`, each with
its closed-form grad, `norm` (L2 normalisation along an axis) and
`one_hot`.

Counterpart of paddle_tpu/ops/norm.py (reference: batch_norm_op.cc,
layer_norm_op.cc, norm_op.cc, one_hot_op.cc).  The port keeps the JAX side's conventions, which
torch's native batch norm does not share: one-pass f32 statistics
E[x^2] - E[x]^2 clamped at 0 (or the shifted form under
`bn_shifted_stats`); `SavedVariance` is the raw batch variance, not an
inverse std; the running stats come out as `MeanOut`/`VarianceOut`,
which name the running-stat variables themselves, so the executor's
persistable write-back stores them.
"""

import torch

from ..utils import flags
from .registry import like, register_grad_kernel, register_op, values_of


def _slot0(ins, slot):
    """First entry of an optional grad-op slot, or None (a slot that is
    missing, empty or `@EMPTY@`)."""
    vs = ins.get(slot)
    return vs[0] if vs else None


def _stat_cotangent(ins, saved_slot, out_slot, momentum):
    """The f32 cotangent reaching a batch statistic exposed both directly
    (Saved*) and blended into the running stat (*Out) at weight
    (1 - momentum); None when neither carries a grad."""
    g = _slot0(ins, saved_slot)
    total = None if g is None else g.float()
    g = _slot0(ins, out_slot)
    if g is not None:
        g = (1.0 - momentum) * g.float()
        total = g if total is None else total + g
    return total


def _bn_axes(x, layout):
    """(reduced dims, shape a per-channel vector broadcasts as)."""
    if layout == "NCHW":
        return (tuple(i for i in range(x.dim()) if i != 1),
                (1, -1) + (1,) * (x.dim() - 2))
    if layout == "NHWC":
        return tuple(range(x.dim() - 1)), (1,) * (x.dim() - 1) + (-1,)
    raise ValueError("unsupported data_layout %r" % (layout,))


def _bn_stats(x, axes):
    """Batch mean and variance in f32, one pass: E[x^2] - E[x]^2 clamped
    at 0; under `bn_shifted_stats`, shifted by each channel's first
    element (free of the cancellation where |mean| >> std)."""
    xs = x.float()
    if not flags.get_flag("bn_shifted_stats"):
        m = xs.mean(dim=axes)
        msq = xs.square().mean(dim=axes)
        return m, (msq - m.square()).clamp_min(0.0)
    first = tuple(slice(0, 1) if i in axes else slice(None)
                  for i in range(x.dim()))
    shift = xs[first].detach()
    d = xs - shift
    dm = d.mean(dim=axes)
    var = (d.square().mean(dim=axes) - dm.square()).clamp_min(0.0)
    return dm + shift.reshape(dm.shape), var


def _bn_normalize(x, scale, bias, m, v, eps, bshape):
    inv = torch.rsqrt(v + eps)
    if x.dtype == torch.bfloat16:
        # the f32 statistics fold into one per-channel affine applied in
        # bf16: the activation is read and written at 2 bytes an element
        a = scale * inv
        b = bias - m * a
        return x * a.reshape(bshape).to(x.dtype) \
            + b.reshape(bshape).to(x.dtype)
    return (x - m.reshape(bshape)) * inv.reshape(bshape) \
        * scale.reshape(bshape) + bias.reshape(bshape)


@register_op("batch_norm", nondiff_inputs=("Mean", "Variance"))
def batch_norm(ctx, ins, attrs):
    """Training mode normalises by the batch statistics and blends them
    into the running stats with `momentum`; `is_test` normalises by the
    running stats."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, variance = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    axes, bshape = _bn_axes(x, attrs.get("data_layout", "NCHW"))
    if attrs.get("is_test", False):
        use_mean, use_var = mean, variance
        mean_out, var_out = mean, variance
    else:
        use_mean, use_var = _bn_stats(x, axes)
        mean_out = momentum * mean + (1 - momentum) * use_mean
        var_out = momentum * variance + (1 - momentum) * use_var
    y = _bn_normalize(x, scale, bias, use_mean, use_var, eps, bshape)
    return {"Y": [y], "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [use_mean], "SavedVariance": [use_var]}


@register_grad_kernel("batch_norm")
def batch_norm_grad(ctx, ins, attrs):
    """Closed-form batch-norm backward, transcribed from the JAX side's
    (reference: batch_norm_op.cc BatchNormGradKernel), not the generic
    vjp: the full-size operands stay in x's dtype, the two reductions
    accumulate in f32, and dx is one affine A dy + B x + D whose
    per-channel f32 coefficients fold every statistic.

        g1 = sum(dy);  g2 = sum(dy (x - m));  inv = rsqrt(v + eps)
        A = scale inv;  B = -A inv^2 g2 / N;  D = -A g1 / N - B m
        dscale = inv g2;  dbias = g1          (is_test: B = D = 0)

    The batch statistics are the forward's O@SavedMean/O@SavedVariance
    (the raw variance) when present, else recomputed; the cotangents of
    SavedMean/SavedVariance and MeanOut/VarianceOut fold into B and D."""
    x = ins["X"][0]
    scale = ins["Scale"][0]
    dy = _slot0(ins, "OG@Y")
    eps = attrs.get("epsilon", 1e-5)
    is_test = attrs.get("is_test", False)
    momentum = attrs.get("momentum", 0.9)
    axes, bshape = _bn_axes(x, attrs.get("data_layout", "NCHW"))
    if is_test:
        m, v = ins["Mean"][0].float(), ins["Variance"][0].float()
    else:
        sm = _slot0(ins, "O@SavedMean")
        sv = _slot0(ins, "O@SavedVariance")
        if sm is not None and sv is not None:
            m, v = sm.float(), sv.float()
        else:
            m, v = _bn_stats(x, axes)
    inv = torch.rsqrt(v + eps)
    if dy is None:
        g1 = g2 = torch.zeros_like(m)
    else:
        dys = dy.float()
        g1 = dys.sum(dim=axes)
        g2 = (dys * (x.float() - m.reshape(bshape))).sum(dim=axes)
    a = scale * inv
    n = 1
    for ax in axes:
        n *= x.shape[ax]
    if is_test:
        # the running stats are nondiff inputs: only Y carries a grad
        dx = torch.zeros_like(x) if dy is None \
            else dy * a.reshape(bshape).to(dy.dtype)
        return {"X@GRAD": [dx], "Scale@GRAD": [inv * g2],
                "Bias@GRAD": [g1]}
    b = -a * inv.square() * g2 / n
    d = -(a * g1) / n - b * m
    dm = _stat_cotangent(ins, "OG@SavedMean", "OG@MeanOut", momentum)
    dv = _stat_cotangent(ins, "OG@SavedVariance", "OG@VarianceOut",
                         momentum)
    if dv is not None:
        b = b + 2.0 * dv / n
        d = d - 2.0 * dv * m / n
    if dm is not None:
        d = d + dm / n
    xb, xd = x * b.reshape(bshape).to(x.dtype), d.reshape(bshape).to(x.dtype)
    if dy is None:
        dx = xb + xd
    else:
        dx = dy * a.reshape(bshape).to(dy.dtype) + xb + xd
    return {"X@GRAD": [dx], "Scale@GRAD": [inv * g2], "Bias@GRAD": [g1]}


@register_op("layer_norm")
def layer_norm(ctx, ins, attrs):
    """Normalise over dims [begin_norm_axis:].  Statistics in float32,
    population variance, eps default 1e-5; outputs Y (X's dtype) and
    the per-row Mean and Variance, shape [prod(X.shape[:begin])]."""
    x = ins["X"][0]
    begin = int(attrs.get("begin_norm_axis", 1))
    eps = attrs.get("epsilon", 1e-5)
    lead = 1
    for d in x.shape[:begin]:
        lead *= d
    x2 = x.reshape(lead, -1).float()
    m = x2.mean(dim=1, keepdim=True)
    v = x2.var(dim=1, unbiased=False, keepdim=True)
    norm = ((x2 - m) * torch.rsqrt(v + eps)).to(x.dtype)
    if "Scale" in ins:
        norm = norm * ins["Scale"][0].reshape(1, -1).to(x.dtype)
    if "Bias" in ins:
        norm = norm + ins["Bias"][0].reshape(1, -1).to(x.dtype)
    return {"Y": [norm.reshape(x.shape)], "Mean": [m.reshape(lead)],
            "Variance": [v.reshape(lead)]}


@register_grad_kernel("layer_norm")
def layer_norm_grad(ctx, ins, attrs):
    """Closed-form layer_norm backward, transcribed from the JAX side's
    (reference: layer_norm_op.cc grad kernels): the full-size math runs
    in x's dtype with per-row f32 coefficients.

        dy' = dy * scale;  g1 = sum_j dy';  g2 = sum_j dy' (x - m)
        dx = dy' inv + x B + D,  B = -inv^3 g2 / N,  D = -inv g1 / N - B m
        dscale_j = sum_r dy (x - m) inv;  dbias_j = sum_r dy

    The forward's saved O@Mean/O@Variance are used when present, else
    recomputed; OG@Mean/OG@Variance fold into B and D."""
    x = ins["X"][0]
    dy = _slot0(ins, "OG@Y")
    begin = int(attrs.get("begin_norm_axis", 1))
    eps = attrs.get("epsilon", 1e-5)
    lead = 1
    for d in x.shape[:begin]:
        lead *= d
    x2 = x.reshape(lead, -1)
    n = x2.shape[1]

    xs = x2.float()
    sm = _slot0(ins, "O@Mean")
    sv = _slot0(ins, "O@Variance")
    if sm is not None and sv is not None:
        m = sm.reshape(lead, 1).float()
        v = sv.reshape(lead, 1).float()
    else:
        m = xs.mean(dim=1, keepdim=True)
        v = xs.var(dim=1, unbiased=False, keepdim=True)
    inv = torch.rsqrt(v + eps)
    xc = xs - m

    scale = _slot0(ins, "Scale")
    if scale is not None:
        scale = scale.reshape(1, -1)
    if dy is None:
        g1 = g2 = torch.zeros((lead, 1), dtype=torch.float32,
                              device=x.device)
    else:
        dy2 = dy.reshape(lead, -1)
        dys = dy2.float()
        dyp = dys * scale if scale is not None else dys
        g1 = dyp.sum(dim=1, keepdim=True)
        g2 = (dyp * xc).sum(dim=1, keepdim=True)

    b = -inv.pow(3) * g2 / n
    d = -inv * g1 / n - b * m
    dm = _slot0(ins, "OG@Mean")
    dv = _slot0(ins, "OG@Variance")
    if dv is not None:
        dv = dv.reshape(lead, 1).float()
        b = b + 2.0 * dv / n
        d = d - 2.0 * dv * m / n
    if dm is not None:
        d = d + dm.reshape(lead, 1).float() / n
    dx2 = x2 * b.to(x2.dtype) + d.to(x2.dtype)
    if dy is not None:
        dyp_lowp = dy2 * scale.to(dy2.dtype) if scale is not None else dy2
        dx2 = dx2 + dyp_lowp * inv.to(dy2.dtype)
    out = {"X@GRAD": [dx2.reshape(x.shape)]}
    if scale is not None:
        out["Scale@GRAD"] = [(dys * xc * inv).sum(dim=0) if dy is not None
                             else torch.zeros(n, device=x.device)]
    if _slot0(ins, "Bias") is not None:
        out["Bias@GRAD"] = [dys.sum(dim=0) if dy is not None
                            else torch.zeros(n, device=x.device)]
    return out


@register_op("norm")
def norm(ctx, ins, attrs):
    """X / sqrt(sum(X^2 along `axis`) + epsilon), computed in f32 and
    given back in X's dtype."""
    x = ins["X"][0]
    axis = int(attrs.get("axis", -1))
    eps = attrs.get("epsilon", 1e-12)
    xs = x if x.dtype == torch.float32 else x.float()
    n = torch.sqrt(torch.sum(torch.square(xs), dim=axis, keepdim=True) + eps)
    return {"Out": [(xs / n).to(x.dtype)]}


@register_op("one_hot", stop_gradient_op=True, nondiff_inputs=("X",))
def one_hot(ctx, ins, attrs):
    """[N, depth] f32 rows, one per id of X (flattened; ragged ids give
    rows ragged over their splits): 1 at the id, and a zero row for an
    id outside [0, depth), as `jax.nn.one_hot` gives (`F.one_hot` raises
    on one)."""
    x = ins["X"][0]
    ids = values_of(x).reshape(-1, 1)
    depth = int(attrs["depth"])
    classes = torch.arange(depth, dtype=ids.dtype, device=ids.device)
    return {"Out": [like(x, (ids == classes).to(torch.float32))]}
