"""The kernels that complete the v2 layer zoo: `bilinear_interp`,
`hsigmoid`, `sampling_id`, `kmax_seq_score`, `sub_nested_seq`,
`scale_sub_region`, `lambda_cost`, `cross_entropy_selfnorm`,
`multi_binary_label_cross_entropy`, `rotate`, `out_prod` and
`linear_comb`.

Counterpart of paddle_tpu/ops/v2_extra.py (reference:
paddle/gserver/layers/*.cpp through trainer_config_helpers/layers.py).
`bilinear_interp` is the JAX side's `jax.image.resize(method=
"bilinear")`: half-pixel centres, and a triangle filter widened by the
scale when it downsamples (antialiasing); the port builds the same
per-axis weight matrices on the host (`resize_weights`) and applies
them as two products, so it agrees with the JAX op down and up, where
F.interpolate without antialiasing does not.  `hsigmoid` walks each
label's path in a complete binary tree; its grad is its own kernel, the
weight and bias rows added back in an order fixed by the data
(`core.ragged.add_rows_`), so every row reading the root node does not
make the card's atomic adds, and the step repeats bit for bit.
`sampling_id` draws from the executor's random stream (held
statistically, as the random ops are).  `kmax_seq_score` and
`sub_nested_seq` restructure the lod on the host, as on the JAX side.
`lambda_cost` is the JAX op's approximate LambdaRank over the [T, T]
pairs of the batch, not LambdaCost.cpp.  The other grads are the
generic vjp.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..core.ragged import RaggedTensor, add_rows_
from .registry import (keep_declared, register_grad_kernel, register_op,
                       values_of)
from .sequence import _seg_pos


def resize_weights(in_size, out_size):
    """[in_size, out_size] float32: jax.image's `compute_weight_mat` for
    the triangle kernel with antialiasing, scale out / in and no
    translation, in its f32 arithmetic."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.0) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= f32(in_size - 0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


# (in size, out size, dtype, device) -> resize_weights on the device:
# made once (a host-to-card copy waits for the card's queued work)
_WEIGHTS = {}


def _weights(in_size, out_size, like):
    key = (in_size, out_size, like.dtype, str(like.device))
    if key not in _WEIGHTS:
        w = torch.as_tensor(resize_weights(in_size, out_size),
                            device=like.device).to(like.dtype)
        if like.device.type == "meta":
            return w
        _WEIGHTS[key] = w
    return _WEIGHTS[key]


@register_op("bilinear_interp")
def bilinear_interp(ctx, ins, attrs):
    """reference: bilinear_interp_op.cc.  NCHW X resized to [out_h,
    out_w] by the per-axis weights of `resize_weights`: an axis whose
    size is unchanged is left as it is, as jax.image.resize leaves it."""
    x = ins["X"][0]
    out_h, out_w = int(attrs["out_h"]), int(attrs["out_w"])
    out = x
    if out_w != x.shape[3]:
        out = torch.matmul(out, _weights(x.shape[3], out_w, x))
    if out_h != x.shape[2]:
        out = torch.matmul(_weights(x.shape[2], out_h, x).t(), out)
    return {"Out": [out]}


def hsigmoid_paths(num_classes, labels):
    """(node index [B, L], bit [B, L] float32, mask [B, L] float32) of
    each label's path in the complete binary tree of `num_classes`
    leaves (reference: MatrixBitCodeFunctor), L the longest path: the
    leaf code label + num_classes read from its top bit down."""
    code = labels.to(torch.int64) + num_classes
    max_len = int(np.ceil(np.log2(max(num_classes, 2))))
    lengths = torch.floor(torch.log2(code.to(torch.float32))).to(
        torch.int64)
    js = torch.arange(max_len, dtype=torch.int64, device=labels.device)
    valid = js[None, :] < lengths[:, None]
    shift = lengths[:, None] - js[None, :]
    idx = (code[:, None] >> torch.clamp(shift, min=1)) - 1
    bit = (code[:, None] >> torch.clamp(shift - 1, min=0)) & 1
    idx = torch.clamp(idx, 0, num_classes - 2)
    return idx, bit.to(torch.float32), valid.to(torch.float32)


def _hsigmoid_logits(x, w, bias, idx):
    logits = torch.einsum("bld,bd->bl", w[idx], x)
    if bias is not None:
        logits = logits + bias.reshape(-1)[idx]
    return logits


@register_op("hsigmoid", nondiff_inputs=("Label",))
def hsigmoid(ctx, ins, attrs):
    """Hierarchical sigmoid cost (reference: HierarchicalSigmoidLayer.cpp):
    Out [B, 1] = the sum over the label's path of softplus(z) - bit * z,
    z the node's row of W [num_classes - 1, D] times X [B, D] (plus its
    Bias [1, num_classes - 1] entry)."""
    x, w = ins["X"][0], ins["W"][0]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    label = ins["Label"][0].reshape(-1)
    idx, bit, mask = hsigmoid_paths(int(attrs["num_classes"]), label)
    logits = _hsigmoid_logits(x, w, bias, idx)
    cost = (torch.logaddexp(logits, torch.zeros_like(logits))
            - bit.to(x.dtype) * logits) * mask.to(x.dtype)
    return {"Out": [cost.sum(dim=1, keepdim=True)]}


@register_grad_kernel("hsigmoid")
def hsigmoid_grad(ctx, ins, attrs):
    """The closed form: dz = (sigmoid(z) - bit) * mask * the output
    grad; X's grad sums dz times the path's rows of W; W's and Bias's
    grads add dz times X (and dz) into the path's rows by `add_rows_`."""
    x, w = ins["X"][0], ins["W"][0]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    label = ins["Label"][0].reshape(-1)
    og = ins["OG@Out"][0].to(x.dtype).reshape(-1, 1)
    idx, bit, mask = hsigmoid_paths(int(attrs["num_classes"]), label)
    logits = _hsigmoid_logits(x, w, bias, idx)
    dz = (torch.sigmoid(logits) - bit.to(x.dtype)) * mask.to(x.dtype) * og
    rows = idx.reshape(-1).to(torch.int32)
    out = {"X@GRAD": [torch.einsum("bl,bld->bd", dz, w[idx])],
           "W@GRAD": [add_rows_(torch.zeros_like(w), rows,
                                (dz[:, :, None] * x[:, None, :]).reshape(
                                    -1, w.shape[1]))]}
    if bias is not None:
        out["Bias@GRAD"] = [add_rows_(
            torch.zeros(bias.numel(), 1, dtype=bias.dtype,
                        device=bias.device), rows,
            dz.reshape(-1, 1)).reshape(bias.shape)]
    return out


def _sampling_id_infer(ins, attrs):
    p = ins["X"][0]
    return {"Out": [torch.empty(p.shape[:1], dtype=torch.int32,
                                device=p.device)]}


@register_op("sampling_id", stop_gradient_op=True, uses_rng=True,
             infer_shape=_sampling_id_infer)
def sampling_id(ctx, ins, attrs):
    """One id per row of the probabilities X, drawn in proportion to
    max(p, 1e-30) from the executor's random stream (reference:
    SamplingIdLayer.cpp); int32, as the JAX op's int64 executes."""
    p = ins["X"][0]
    probs = torch.clamp(p.float(), min=1e-30)
    ids = torch.multinomial(probs, 1, generator=ctx.next_rng())[:, 0]
    return {"Out": [ids.to(torch.int32)]}


def _host(v):
    return values_of(v).detach().cpu().numpy()


def _ragged(flat, splits, device):
    return RaggedTensor(torch.from_numpy(flat).to(device),
                        [torch.from_numpy(np.asarray(splits, np.int32))])


@register_op("kmax_seq_score", jittable=False, stop_gradient_op=True,
             infer_desc=keep_declared)
def kmax_seq_score(ctx, ins, attrs):
    """reference: KmaxSeqScoreLayer.cpp.  Per sequence of X [T, 1], the
    in-sequence indices of its `beam_size` highest scores (fewer in a
    shorter sequence), highest first, ties in order (a stable sort), as
    an int32 [K, 1] sequence; on the host."""
    x = ins["X"][0]
    k = int(attrs["beam_size"])
    vals = _host(x).reshape(-1)
    splits = x.last_splits().cpu().numpy()
    rows, out_splits = [], [0]
    for i in range(len(splits) - 1):
        seg = vals[splits[i]:splits[i + 1]]
        top = np.argsort(-seg, kind="stable")[:min(k, len(seg))]
        rows.append(top.astype(np.int32))
        out_splits.append(out_splits[-1] + len(top))
    flat = (np.concatenate(rows) if rows
            else np.zeros((0,), np.int32)).reshape(-1, 1)
    return {"Out": [_ragged(flat, out_splits, values_of(x).device)]}


@register_op("sub_nested_seq", jittable=False, stop_gradient_op=True,
             infer_desc=keep_declared)
def sub_nested_seq(ctx, ins, attrs):
    """reference: SubNestedSequenceLayer.cpp.  The inner sequences of the
    lod-level-2 X that S (a sequence of indices per outer sequence)
    picks, in S's order, as a lod-level-1 sequence; on the host."""
    x, sel = ins["X"][0], ins["S"][0]
    outer = x.row_splits[0].cpu().numpy()
    inner = x.row_splits[-1].cpu().numpy()
    vals = _host(x)
    picks_all = _host(sel).reshape(-1).astype(np.int64)
    sel_splits = sel.last_splits().cpu().numpy()
    segs, splits = [], [0]
    for b in range(len(outer) - 1):
        for j in picks_all[sel_splits[b]:sel_splits[b + 1]]:
            ii = outer[b] + int(j)
            seg = vals[inner[ii]:inner[ii + 1]]
            segs.append(seg)
            splits.append(splits[-1] + len(seg))
    flat = np.concatenate(segs, 0) if segs else vals[:0]
    return {"Out": [_ragged(np.ascontiguousarray(flat), splits,
                            values_of(x).device)]}


@register_op("scale_sub_region", nondiff_inputs=("Indices",))
def scale_sub_region(ctx, ins, attrs):
    """reference: ScaleSubRegionLayer.cpp.  X [B, C, H, W] times `value`
    inside each sample's region, Indices' row [c0, c1, h0, h1, w0, w1]
    of 1-based inclusive ranges; as it is outside."""
    x = ins["X"][0]
    idx = ins["Indices"][0].to(torch.int32)
    value = float(attrs.get("value", 1.0))
    _, c, h, w = x.shape

    def inside(n, k):
        r = torch.arange(n, dtype=torch.int32, device=x.device)[None, :]
        return (r >= idx[:, k:k + 1] - 1) & (r <= idx[:, k + 1:k + 2] - 1)

    mask = (inside(c, 0)[:, :, None, None] & inside(h, 2)[:, None, :, None]
            & inside(w, 4)[:, None, None, :])
    return {"Out": [torch.where(mask, x * value, x)]}


@register_op("lambda_cost", nondiff_inputs=("Label",))
def lambda_cost(ctx, ins, attrs):
    """The JAX op's listwise cost over each sequence: for each pair (i,
    j) of one sequence with label i above label j, softplus(s_j - s_i)
    weighted by |2^y_i - 2^y_j| times the difference of their position
    discounts 1 / log2(2 + position), a position past NDCG_num
    discounting 0; Out [T, 1] sums each row's pairs, ragged as Score."""
    score, label = ins["Score"][0], ins["Label"][0]
    ndcg_num = int(attrs.get("NDCG_num", 5))
    s = score.values.reshape(-1)
    y = label.values.reshape(-1).to(torch.float32)
    seg, inseq, valid = _seg_pos(score)
    same = (seg[:, None] == seg[None, :]) & valid[:, None] & valid[None, :]
    gain = torch.pow(2.0, y) - 1.0
    disc = 1.0 / torch.log2(2.0 + inseq.to(torch.float32))
    dcg_w = torch.where(inseq < ndcg_num, disc, torch.zeros_like(disc))
    dw = torch.abs(gain[:, None] - gain[None, :]) \
        * torch.abs(dcg_w[:, None] - dcg_w[None, :])
    diff = s[:, None] - s[None, :]
    pair = F.softplus(-diff)
    rel = (y[:, None] > y[None, :]) & same
    loss = torch.where(rel, dw * pair, torch.zeros_like(pair))
    return {"Out": [score.with_values(loss.sum(dim=1, keepdim=True))]}


def _rows(v):
    return v.values if isinstance(v, RaggedTensor) else v


def _like(x, out):
    return x.with_values(out) if isinstance(x, RaggedTensor) else out


@register_op("cross_entropy_selfnorm", nondiff_inputs=("Label",))
def cross_entropy_selfnorm(ctx, ins, attrs):
    """reference: CostLayer.cpp CrossEntropyWithSelfNorm.  Out [T, 1] =
    -log(p_label / Z) + alpha * log(Z)^2 over the unnormalised
    probabilities X, Z the row sum (each floored at 1e-30)."""
    p = ins["X"][0]
    pv = _rows(p)
    lv = _rows(ins["Label"][0]).reshape(-1, 1).to(torch.int64)
    alpha = float(attrs.get("softmax_selfnorm_alpha", 0.1))
    z = pv.sum(dim=1)
    picked = torch.gather(pv, 1, lv)[:, 0]
    logz = torch.log(torch.clamp(z, min=1e-30))
    cost = -torch.log(torch.clamp(picked / torch.clamp(z, min=1e-30),
                                  min=1e-30)) + alpha * torch.square(logz)
    return {"Out": [_like(p, cost[:, None])]}


@register_op("multi_binary_label_cross_entropy", nondiff_inputs=("Label",))
def multi_binary_label_cross_entropy(ctx, ins, attrs):
    """reference: CostLayer.cpp MultiBinaryLabelCrossEntropy.  Out [T, 1]
    sums -(y log(p + 1e-8) + (1 - y) log(1 - p + 1e-8)) over each row."""
    p = ins["X"][0]
    pv = _rows(p)
    yv = _rows(ins["Label"][0]).to(pv.dtype)
    eps = 1e-8
    cost = -(yv * torch.log(pv + eps) + (1 - yv) * torch.log(1 - pv + eps))
    return {"Out": [_like(p, cost.sum(dim=1, keepdim=True))]}


@register_op("rotate")
def rotate(ctx, ins, attrs):
    """reference: RotateLayer.cpp.  Each [C, H, W] map of the flat rows
    X [B, C * H * W] turned 90 degrees counter-clockwise."""
    x = ins["X"][0]
    c, h, w = (int(attrs["channels"]), int(attrs["height"]),
               int(attrs["width"]))
    maps = x.reshape(-1, c, h, w)
    rot = torch.flip(maps.transpose(2, 3), dims=(2,))
    return {"Out": [rot.reshape(x.shape[0], -1)]}


@register_op("out_prod")
def out_prod(ctx, ins, attrs):
    """reference: OuterProdLayer.cpp.  Row b: the flat outer product of
    X[b] and Y[b]."""
    a, b = ins["X"][0], ins["Y"][0]
    return {"Out": [torch.einsum("bi,bj->bij", a, b).reshape(a.shape[0],
                                                             -1)]}


@register_op("linear_comb")
def linear_comb(ctx, ins, attrs):
    """reference: ConvexCombinationLayer.cpp.  Out[b] = sum_k W[b, k] *
    X[b, k * size:(k + 1) * size]."""
    x, w = ins["X"][0], ins["W"][0]
    size = int(attrs["size"])
    xs = x.reshape(x.shape[0], w.shape[1], size)
    return {"Out": [torch.einsum("bk,bks->bs", w, xs)]}
