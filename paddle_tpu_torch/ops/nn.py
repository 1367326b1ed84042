"""Misc NN op kernels: `lstm_unit`, `nce`, `bilinear_tensor_product`,
`conv_shift` and `cast_embedding_ids`.

Counterpart of paddle_tpu/ops/nn.py (reference: lstm_unit_op.cc,
nce_op.cc, bilinear_tensor_product_op.cc, conv_shift_op.cc).  `nce`
draws its negative classes from the executor's random stream, uniform
over [0, num_total_classes) as on the JAX side, where the generator
differs (ROADMAP's conventions: random ops are held statistically); its
cost given the samples is `nce_cost`, which both the op and its grad
run, so a test can hold the port's cost and grad against the JAX op's
from the JAX op's own `SampleLabels`.  The grad adds the sampled
weight and bias rows back through `core.ragged.add_rows_` (a fixed
order, so it repeats bit for bit on the card).  `conv_shift` sums the
M circular shifts of X (`torch.roll`) in shift order, so its grad has
no gather that reads an element twice.  The other grads are the
generic vjp, as on the JAX side.
"""

import torch

from ..core.ragged import add_rows_
from .registry import register_grad_kernel, register_op


@register_op("lstm_unit")
def lstm_unit(ctx, ins, attrs):
    """One fused LSTM cell step: X [N, 4D] holds the pre-activation
    gates [i f o g]; C = sigmoid(f + forget_bias) * C_prev + sigmoid(i)
    * tanh(g), H = sigmoid(o) * tanh(C)."""
    x, c_prev = ins["X"][0], ins["C_prev"][0]
    d = c_prev.shape[1]
    i = torch.sigmoid(x[:, :d])
    f = torch.sigmoid(x[:, d:2 * d] + attrs.get("forget_bias", 0.0))
    o = torch.sigmoid(x[:, 2 * d:3 * d])
    g = torch.tanh(x[:, 3 * d:])
    c = f * c_prev + i * g
    return {"C": [c], "H": [o * torch.tanh(c)]}


def _nce_from_rows(x, sw, sb, num_classes, num_true):
    """(cost [N, 1], logits [N, T + S]) from the sampled weight rows sw
    [N, T + S, D] and bias entries sb [N, T + S] (or None)."""
    logits = torch.einsum("nd,nsd->ns", x, sw)
    if sb is not None:
        logits = logits + sb
    p_model = torch.sigmoid(logits)
    p_noise = 1.0 / num_classes
    true_p = p_model[:, :num_true]
    true_cost = -torch.log(true_p / (true_p + num_true * p_noise) + 1e-12)
    neg_p = p_model[:, num_true:]
    neg_cost = -torch.log(num_true * p_noise
                          / (neg_p + num_true * p_noise) + 1e-12)
    cost = true_cost.sum(1, keepdim=True) + neg_cost.sum(1, keepdim=True)
    return cost, logits


def _gather_rows(w, b, samples):
    n = samples.shape[0]
    flat = samples.reshape(-1).long()
    sw = w.index_select(0, flat).reshape(n, -1, w.shape[1])
    sb = None if b is None else \
        b.reshape(-1).index_select(0, flat).reshape(n, -1)
    return sw, sb


def nce_cost(x, w, b, samples, num_classes, num_true):
    """(cost [N, 1], logits [N, T + S]) of the NCE loss of inputs x
    [N, D] against the samples [N, T + S] (the T true labels, then the S
    negatives) under weight w [C, D] and bias b [C, 1] (or None)."""
    sw, sb = _gather_rows(w, b, samples)
    return _nce_from_rows(x, sw, sb, num_classes, num_true)


def _nce_infer(ins, attrs):
    x = ins["Input"][0]
    n = x.shape[0]
    num_true = ins["Label"][0].reshape(n, -1).shape[1]
    width = num_true + int(attrs.get("num_neg_samples", 10))
    samples = torch.zeros((n, width), dtype=torch.int32, device=x.device)
    cost, logits = _nce_from_rows(
        x, torch.empty((n, width, x.shape[1]), dtype=x.dtype,
                       device=x.device),
        None, int(attrs["num_total_classes"]), num_true)
    return {"Cost": [cost], "SampleLogits": [logits],
            "SampleLabels": [samples]}


@register_op("nce", uses_rng=True, nondiff_inputs=("Label",),
             infer_shape=_nce_infer)
def nce(ctx, ins, attrs):
    """Noise-contrastive estimation (reference: nce_op.cc/.h): Cost
    [N, 1], SampleLogits and SampleLabels [N, T + S] int32, the negatives
    drawn uniformly (the reference Sampler's default)."""
    x, w = ins["Input"][0], ins["Weight"][0]
    b = ins["Bias"][0] if ins.get("Bias") else None
    num_classes = int(attrs["num_total_classes"])
    num_neg = int(attrs.get("num_neg_samples", 10))
    n = x.shape[0]
    label = ins["Label"][0].reshape(n, -1).to(torch.int32)
    neg = torch.randint(0, num_classes, (n, num_neg),
                        generator=ctx.next_rng(), dtype=torch.int32,
                        device=x.device)
    samples = torch.cat([label, neg], dim=1)
    cost, logits = nce_cost(x, w, b, samples, num_classes, label.shape[1])
    return {"Cost": [cost], "SampleLogits": [logits],
            "SampleLabels": [samples]}


@register_grad_kernel("nce")
def nce_grad(ctx, ins, attrs):
    """Replays the saved samples (O@SampleLabels) instead of the random
    stream, as the JAX side's grad kernel does."""
    x, w = ins["Input"][0], ins["Weight"][0]
    b = ins["Bias"][0] if ins.get("Bias") else None
    samples = ins["O@SampleLabels"][0]
    n = x.shape[0]
    num_true = ins["Label"][0].reshape(n, -1).shape[1]
    og = ins["OG@Cost"][0]
    sw, sb = _gather_rows(w, b, samples)
    primals = (x, sw) if sb is None else (x, sw, sb)

    def f(x_, sw_, sb_=None):
        return _nce_from_rows(x_, sw_, sb_, int(attrs["num_total_classes"]),
                              num_true)[0]

    cost, vjp = torch.func.vjp(f, *primals)
    grads = vjp(og.to(cost.dtype).reshape(cost.shape))
    flat = samples.reshape(-1).long()
    out = {"Input@GRAD": [grads[0]],
           "Weight@GRAD": [add_rows_(torch.zeros_like(w), flat,
                                     grads[1].reshape(-1, w.shape[1]))]}
    if b is not None:
        out["Bias@GRAD"] = [add_rows_(torch.zeros_like(b).reshape(-1, 1),
                                      flat, grads[2].reshape(-1, 1))
                            .reshape(b.shape)]
    return out


@register_op("bilinear_tensor_product")
def bilinear_tensor_product(ctx, ins, attrs):
    """Out[n, k] = X[n] Weight[k] Y[n]^T (+ Bias [1, K])."""
    out = torch.einsum("nd,kde,ne->nk", ins["X"][0], ins["Weight"][0],
                       ins["Y"][0])
    if ins.get("Bias"):
        out = out + ins["Bias"][0].reshape(1, -1)
    return {"Out": [out]}


@register_op("conv_shift")
def conv_shift(ctx, ins, attrs):
    """Circular correlation: Out[i, j] = sum_k X[i, (j + k - M // 2) % D]
    * Y[i, k] for Y [N, M], M odd."""
    x, y = ins["X"][0], ins["Y"][0]
    half = y.shape[1] // 2
    out = None
    for k in range(y.shape[1]):
        term = torch.roll(x, shifts=half - k, dims=1) * y[:, k:k + 1]
        out = term if out is None else out + term
    return {"Out": [out]}


@register_op("cast_embedding_ids", stop_gradient_op=True)
def cast_embedding_ids(ctx, ins, attrs):
    """Ids as int32 (a helper op of the JAX package, not the
    reference's)."""
    return {"Out": [ins["X"][0].to(torch.int32)]}
