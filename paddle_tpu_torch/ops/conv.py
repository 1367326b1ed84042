"""Convolution, pooling and local response normalisation op kernels:
`conv2d`, `conv2d_transpose`, `pool2d`, `lrn`, and `im2sequence`.

Counterpart of paddle_tpu/ops/conv.py (reference: conv_op.cc,
conv_cudnn_op.cu.cc, conv_transpose_op.cc, pool_op.cc, lrn_op.cc,
im2sequence_op.cc).  `conv2d_transpose` is
torch.nn.functional.conv_transpose2d, its filter [in_c, out_c, kh, kw]
as the reference lays it out, under the same AMP policy.  `conv2d` is
torch.nn.functional.conv2d, which is cuDNN on the card; under the bf16
policy its operands and result are bf16 (ops/amp_util.py).  `pool2d` is
max pooling, or average pooling with the JAX side's counts: the window
sum over the zero-padded input divided by the window's size, or, with
`exclusive` (the default) and padding, by the count of the window's
elements that lie inside the input (`_np_pool_counts`).  Images are NCHW
or NHWC (`data_layout`) with OIHW weights in both; an NHWC `conv2d`
hands cuDNN its input and weight in channels-last memory, so cuDNN runs
NHWC kernels rather than transposing around NCHW ones (an input that
is an NHWC view of NCHW memory, as a `transpose` op leaves it, is
copied once).  `ceil_mode` is
recorded and ignored, as on the JAX side.  Both grads are the generic
vjp, as on the JAX side; a max-pool window's grad goes to its first
largest element in row-major order on both sides.  `lrn` divides by
(k + alpha * the sum of squares over a window of `n` channels) ** beta,
the window sum added in the JAX side's order; its grad is the generic
vjp there too.  `im2sequence` is `F.unfold` over the padded image,
whose patch features run (C, kh, kw) as `conv_general_dilated_patches`
orders them on the JAX side.  `conv2d`, `conv2d_transpose` and their
grads run with cuDNN held to deterministic algorithms (ops/registry.py
`deterministic_cudnn`).
"""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from ..core.ragged import RaggedTensor
from .amp_util import amp_result, mxu_operands
from .registry import deterministic_cudnn, get_op_info, register_op


def _to_nchw(x, attrs):
    """(x as an NCHW view, spatial dims of the layout): NHWC images are
    permuted into NCHW views (channels-last memory, which cuDNN takes as
    it is) and permuted back by `_from_nchw`."""
    layout = attrs.get("data_layout", "NCHW")
    if layout == "NHWC":
        return x.permute(0, 3, 1, 2), (1, 2)
    if layout == "NCHW":
        return x, (2, 3)
    raise ValueError("unsupported data_layout %r" % (layout,))


def _from_nchw(out, attrs):
    if attrs.get("data_layout", "NCHW") == "NHWC":
        return out.permute(0, 2, 3, 1)
    return out


def _check_spatial(out, opname, x, sdims):
    """A kernel/stride larger than the input gives a zero-sized spatial
    dim: fail here, with the shapes, not far downstream."""
    if any(out.shape[d] == 0 for d in sdims):
        raise ValueError(
            "%s produced an empty output %s from input %s — the input "
            "spatial size is too small for this kernel/stride/padding"
            % (opname, tuple(out.shape), tuple(x.shape)))
    return out


@register_op("conv2d", deterministic=True)
def conv2d(ctx, ins, attrs):
    """cuDNN's convolution under `deterministic_cudnn` while the op's
    registration asks for it (its default; the generic grad's backward
    takes the same scope), so a training step repeats bit for bit."""
    x, w = ins["Input"][0], ins["Filter"][0]
    xm, wm = mxu_operands(x, w)
    xm, _ = _to_nchw(xm, attrs)
    if attrs.get("data_layout", "NCHW") == "NHWC":
        # both operands channels-last, or torch picks NCHW for the call
        xm = xm.contiguous(memory_format=torch.channels_last)
        wm = wm.contiguous(memory_format=torch.channels_last)
    scoped = deterministic_cudnn() if get_op_info("conv2d").deterministic \
        else contextlib.nullcontext()
    with scoped:
        out = F.conv2d(xm, wm, stride=tuple(attrs.get("strides", [1, 1])),
                       padding=tuple(attrs.get("paddings", [0, 0])),
                       dilation=tuple(attrs.get("dilations", [1, 1])),
                       groups=int(attrs.get("groups", 1) or 1))
    out = _from_nchw(out, attrs)
    _check_spatial(out, "conv2d", x, _to_nchw(x, attrs)[1])
    return {"Output": [amp_result(out, x.dtype)]}


@register_op("conv2d_transpose", deterministic=True)
def conv2d_transpose(ctx, ins, attrs):
    """The transposed convolution (the gradient of conv2d with respect
    to its input) of Input by Filter [in_c, out_c, kh, kw]:
    F.conv_transpose2d, cuDNN on the card, held to deterministic
    algorithms as `conv2d` is, its generic grad too.  The output's
    spatial size is (in - 1) * stride - 2 * padding + dilation * (k - 1)
    + 1, the JAX side's input-dilated convolution by the flipped
    filter."""
    x, w = ins["Input"][0], ins["Filter"][0]
    xm, wm = mxu_operands(x, w)
    xm, _ = _to_nchw(xm, attrs)
    scoped = deterministic_cudnn() \
        if get_op_info("conv2d_transpose").deterministic \
        else contextlib.nullcontext()
    with scoped:
        out = F.conv_transpose2d(
            xm, wm, stride=tuple(attrs.get("strides", [1, 1])),
            padding=tuple(attrs.get("paddings", [0, 0])),
            dilation=tuple(attrs.get("dilations", [1, 1])))
    out = _from_nchw(out, attrs)
    _check_spatial(out, "conv2d_transpose", x, _to_nchw(x, attrs)[1])
    return {"Output": [amp_result(out, x.dtype)]}


def _np_pool_counts(hw, ksize, strides, paddings):
    """counts[i, j]: the elements of window (i, j) that lie inside the
    input; the count factorizes per axis, rows[i] * cols[j]."""
    def axis_counts(n, k, s, p):
        ones = np.pad(np.ones(n, np.float32), (p, p))
        return np.array([ones[i * s:i * s + k].sum()
                         for i in range((n + 2 * p - k) // s + 1)],
                        np.float32)

    return np.outer(
        axis_counts(hw[0], ksize[0], strides[0], paddings[0]),
        axis_counts(hw[1], ksize[1], strides[1], paddings[1]))


def _pad(x, paddings, ksize, value):
    """(x, paddings for torch): torch pads a pooling window by at most
    half the kernel itself; a larger padding is applied here, with
    `value`."""
    if all(2 * p <= k for p, k in zip(paddings, ksize)):
        return x, paddings
    ph, pw = paddings
    return F.pad(x, (pw, pw, ph, ph), value=value), [0, 0]


@register_op("pool2d")
def pool2d(ctx, ins, attrs):
    x = ins["X"][0]
    xs, sdims = _to_nchw(x, attrs)
    ksize = list(attrs.get("ksize", [2, 2]))
    strides = list(attrs.get("strides", [1, 1]))
    paddings = list(attrs.get("paddings", [0, 0]))
    if attrs.get("global_pooling", False):
        ksize = list(xs.shape[2:])
        strides = [1, 1]
        paddings = [0, 0]
    if attrs.get("pooling_type", "max") == "max":
        xp, pads = _pad(xs, paddings, ksize, float("-inf"))
        out = F.max_pool2d(xp, ksize, strides, pads)
    else:
        xp, pads = _pad(xs, paddings, ksize, 0.0)
        summed = F.avg_pool2d(xp, ksize, strides, pads, divisor_override=1)
        if attrs.get("exclusive", True) and (paddings[0] or paddings[1]):
            counts = _np_pool_counts(tuple(xs.shape[2:]), ksize, strides,
                                     paddings)
            out = summed / torch.as_tensor(counts, dtype=summed.dtype,
                                           device=summed.device)
        else:
            out = summed / (ksize[0] * ksize[1])
    out = _from_nchw(out, attrs)
    return {"Out": [_check_spatial(out, "pool2d", x, sdims)]}


@register_op("lrn")
def lrn(ctx, ins, attrs):
    """Local response normalisation across the channels of NCHW X:
    MidOut = k + alpha * (the sum of X^2 over `n` channels centred on
    each, zero-padded at the ends), Out = X / MidOut ** beta."""
    x = ins["X"][0]
    n = int(attrs.get("n", 5))
    k = attrs.get("k", 2.0)
    alpha = attrs.get("alpha", 1e-4)
    beta = attrs.get("beta", 0.75)
    half = n // 2
    padded = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
    channels = x.shape[1]
    window_sum = sum(padded[:, i:i + channels] for i in range(n))
    mid = k + alpha * window_sum
    return {"Out": [x / torch.pow(mid, beta)], "MidOut": [mid]}


@register_op("im2sequence")
def im2sequence(ctx, ins, attrs):
    """reference: im2sequence_op.cc.  Each image's patches as one
    sequence, a step per patch position in row-major order, a step's
    C * kh * kw features ordered (C, kh, kw).  paddings are [top, left,
    bottom, right].  Every sequence has oh * ow steps: that is the
    output's `max_seqlen`, so a recurrence over it runs oh * ow steps,
    not one per flat row.  Its grad is the generic vjp (F.fold sums the
    overlapping patches)."""
    x = ins["X"][0]
    kh, kw = attrs.get("kernels", [1, 1])
    sh, sw = attrs.get("strides", [1, 1])
    top, left, bottom, right = attrs.get("paddings", [0, 0, 0, 0])
    xp = F.pad(x, (left, right, top, bottom))
    n, c = x.shape[0], x.shape[1]
    oh = (xp.shape[2] - kh) // sh + 1
    ow = (xp.shape[3] - kw) // sw + 1
    patches = F.unfold(xp, (kh, kw), stride=(sh, sw))  # [n, c*kh*kw, L]
    seq = patches.transpose(1, 2).reshape(n * oh * ow, c * kh * kw)
    splits = torch.arange(n + 1, dtype=torch.int32,
                          device=x.device) * (oh * ow)
    return {"Out": [RaggedTensor(seq, [splits], max_seqlen=oh * ow)]}
