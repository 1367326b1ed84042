"""Convolution, pooling and local response normalisation op kernels:
`conv2d`, `conv2d_transpose`, `conv3d`, `conv3d_transpose`, `pool2d`,
`pool3d`, `max_pool2d_with_index`, `max_pool3d_with_index`, `unpool`,
`maxout`, `spp`, `roi_pool`, `conv2d_dynamic_filter`, `lrn` and
`im2sequence`.

Counterpart of paddle_tpu/ops/conv.py (reference: conv_op.cc,
conv_cudnn_op.cu.cc, conv_transpose_op.cc, pool_op.cc,
pool_with_index_op.cc, unpool_op.cc, maxout_op.cc, spp_op.cc,
roi_pool_op.cc, lrn_op.cc, im2sequence_op.cc).  The convolutions
(`conv2d`, `conv3d`, the transposed ones with their filters [in_c, out_c,
k...] as the reference lays them out, and `conv2d_dynamic_filter`, one
grouped convolution over the batch) are torch.nn.functional's, cuDNN on
the card, under the bf16 policy (ops/amp_util.py) and, with their
grads, held to deterministic cuDNN algorithms (ops/registry.py
`deterministic_cudnn`).  `conv2d` takes NCHW or NHWC (`data_layout`)
with OIHW weights in both; an NHWC `conv2d` hands cuDNN its input and
weight in channels-last memory, so cuDNN runs NHWC kernels rather than
transposing around NCHW ones (an input that is an NHWC view of NCHW
memory, as a `transpose` op leaves it, is copied once).  `pool2d` and
`pool3d` are max pooling over -inf padding, or average pooling with the
JAX side's divisors: `pool2d`'s window sum over the zero-padded input
divided by the window's size or, with `exclusive` (the default) and
padding, by the count of the window's elements inside the input
(`_np_pool_counts`); `pool3d`'s always by the window's size; `pool3d`'s and
`max_pool3d_with_index`'s grads are their own kernels, which add
overlapping windows' grads in an order fixed by the data (`_add_at`),
where the CUDA backwards of F.max_pool3d and F.avg_pool3d add them
atomically.
`ceil_mode` is recorded and ignored, as on the JAX side.  A max-pool
window's grad goes to its first largest element in row-major order on
both sides.  The pools with an index return the flat index of that
element within one image as the JAX side's reduction over (value,
index) pairs finds it (`_window_argmax`: NaN never wins, a window with
nothing above -inf gives 0), where F.max_pool2d's own indices differ.
`unpool` adds each value at its index (repeated indices sum, as
`.at[i].add` does, where F.max_unpool2d keeps one) in an order fixed by
the data (`core.ragged.add_rows_`), and its grad is its own kernel, a
gather.  `maxout` is torch.amax, whose grad splits among ties as
jnp.max's does.  `roi_pool` takes each ROI's crop of its image and the
max over each bin, separably (rows, then columns), so no [ROIs, bins,
C, H, W] mask is made; its grad is its own kernel, a bin at a time,
splitting among ties as jnp.max's vjp does, and the ROIs' image grads
added into their images by `add_rows_`.  `lrn` divides by (k + alpha *
the sum of squares over a window of `n` channels) ** beta, the window
sum added in the JAX side's order.  `im2sequence` is `F.unfold` over the
padded image, whose patch features run (C, kh, kw) as
`conv_general_dilated_patches` orders them on the JAX side.  The other
grads are the generic vjp, as on the JAX side.
"""

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..core.ragged import RaggedTensor, add_rows_
from .amp_util import amp_result, mxu_operands
from .registry import (deterministic_cudnn, get_op_info,
                       register_grad_kernel, register_op,
                       values_of)


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


def _cudnn_scope(op_type):
    """cuDNN held to deterministic algorithms while the op's
    registration asks for it (`deterministic_cudnn`), else no scope."""
    if get_op_info(op_type).deterministic:
        return deterministic_cudnn()
    return contextlib.nullcontext()


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
    with _cudnn_scope("conv2d"):
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
    with _cudnn_scope("conv2d_transpose"):
        out = F.conv_transpose2d(
            xm, wm, stride=tuple(attrs.get("strides", [1, 1])),
            padding=tuple(attrs.get("paddings", [0, 0])),
            dilation=tuple(attrs.get("dilations", [1, 1])))
    out = _from_nchw(out, attrs)
    _check_spatial(out, "conv2d_transpose", x, _to_nchw(x, attrs)[1])
    return {"Output": [amp_result(out, x.dtype)]}


@functools.lru_cache(maxsize=256)
def _pool_counts(hw, ksize, strides, paddings, dtype, device, inference):
    """`_np_pool_counts` as a tensor on `device`, made once per shape and
    reused: a read-only constant, so a captured segment (which may copy
    no host data to the device) reads the one its warmup made.  One is
    kept per inference mode: a grad cannot save an inference tensor."""
    return torch.as_tensor(_np_pool_counts(hw, ksize, strides, paddings),
                           dtype=dtype, device=device)


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
    `value`, over the trailing len(paddings) dims."""
    if all(2 * p <= k for p, k in zip(paddings, ksize)):
        return x, paddings
    widths = []
    for p in reversed(paddings):
        widths += [p, p]
    return F.pad(x, tuple(widths), value=value), [0] * len(paddings)


def _pool2d_impl(x, attrs):
    """pool2d's output for NCHW or NHWC x under `attrs`."""
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
            out = summed / _pool_counts(
                tuple(xs.shape[2:]), tuple(ksize), tuple(strides),
                tuple(paddings), summed.dtype, summed.device,
                torch.is_inference_mode_enabled())
        else:
            out = summed / (ksize[0] * ksize[1])
    out = _from_nchw(out, attrs)
    return _check_spatial(out, "pool2d", x, sdims)


@register_op("pool2d")
def pool2d(ctx, ins, attrs):
    return {"Out": [_pool2d_impl(ins["X"][0], attrs)]}


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


# -- the rest of the JAX module: 3-D convolution and pooling, the pools
#    with an index and their unpool, maxout, spp, roi_pool and the
#    per-sample dynamic-filter convolution

def _triple(attrs, key, default):
    return tuple(attrs.get(key, [default] * 3))


@register_op("conv3d", deterministic=True)
def conv3d(ctx, ins, attrs):
    """The 3-D convolution of NCDHW Input by Filter [out_c, in_c / groups,
    kd, kh, kw]: F.conv3d, cuDNN on the card, under the AMP policy and
    deterministic algorithms as `conv2d`."""
    x, w = ins["Input"][0], ins["Filter"][0]
    xm, wm = mxu_operands(x, w)
    with _cudnn_scope("conv3d"):
        out = F.conv3d(xm, wm, stride=_triple(attrs, "strides", 1),
                       padding=_triple(attrs, "paddings", 0),
                       dilation=_triple(attrs, "dilations", 1),
                       groups=int(attrs.get("groups", 1) or 1))
    _check_spatial(out, "conv3d", x, (2, 3))
    return {"Output": [amp_result(out, x.dtype)]}


@register_op("conv3d_transpose", deterministic=True)
def conv3d_transpose(ctx, ins, attrs):
    """The 3-D transposed convolution of Input by Filter [in_c, out_c,
    kd, kh, kw]: F.conv_transpose3d, its output (in - 1) * stride - 2 *
    padding + dilation * (k - 1) + 1 per dim, as the JAX side's
    input-dilated convolution by the flipped filter gives."""
    x, w = ins["Input"][0], ins["Filter"][0]
    xm, wm = mxu_operands(x, w)
    with _cudnn_scope("conv3d_transpose"):
        out = F.conv_transpose3d(xm, wm,
                                 stride=_triple(attrs, "strides", 1),
                                 padding=_triple(attrs, "paddings", 0),
                                 dilation=_triple(attrs, "dilations", 1))
    _check_spatial(out, "conv3d_transpose", x, (2, 3))
    return {"Output": [amp_result(out, x.dtype)]}


def _pool_window(x, attrs, nd):
    """(ksize, strides, paddings) of an nd-dimensional pool of x, the
    whole volume under `global_pooling`."""
    ksize = list(attrs.get("ksize", [2] * nd))
    strides = list(attrs.get("strides", [1] * nd))
    paddings = list(attrs.get("paddings", [0] * nd))
    if attrs.get("global_pooling", False):
        return list(x.shape[2:]), [1] * nd, [0] * nd
    return ksize, strides, paddings


def _max_pool3d(x, ksize, strides, paddings):
    xp, pads = _pad(x, paddings, ksize, float("-inf"))
    return F.max_pool3d(xp, ksize, strides, pads)


@register_op("pool3d")
def pool3d(ctx, ins, attrs):
    """Max pooling over -inf padding, or average pooling: the window sum
    over the zero-padded input divided by the window's size (padding
    counted, as on the JAX side)."""
    x = ins["X"][0]
    ksize, strides, paddings = _pool_window(x, attrs, 3)
    if attrs.get("pooling_type", "max") == "max":
        out = _max_pool3d(x, ksize, strides, paddings)
    else:
        xp, pads = _pad(x, paddings, ksize, 0.0)
        out = F.avg_pool3d(xp, ksize, strides, pads, divisor_override=1) \
            / int(np.prod(ksize))
    return {"Out": [_check_spatial(out, "pool3d", x, (2, 3))]}


@register_grad_kernel("pool3d")
def pool3d_grad(ctx, ins, attrs):
    x = ins["X"][0]
    return {"X@GRAD": [_pool3d_grad(x, ins["OG@Out"][0], attrs,
                                    attrs.get("pooling_type", "max"))]}


def _windows(v, ksize, strides, paddings, fill):
    """[N, C, *out, K]: the pooling windows of v [N, C, *spatial] over
    its padding by `fill`, each window's K elements in row-major order;
    and the same windows of the flat index map [*out, K] (-1 in the
    padding)."""
    nd = len(ksize)
    spatial = tuple(v.shape[2:])
    flat = torch.arange(int(np.prod(spatial)), dtype=torch.int32,
                        device=v.device).reshape(spatial)
    widths = []
    for p in reversed(paddings):
        widths += [p, p]
    v = F.pad(v, tuple(widths), value=fill)
    flat = F.pad(flat, tuple(widths), value=-1)
    for d in range(nd):
        v = v.unfold(2 + d, ksize[d], strides[d])
        flat = flat.unfold(d, ksize[d], strides[d])
    out_shape = v.shape[:2 + nd]
    return v.reshape(out_shape + (-1,)), flat.reshape(out_shape[2:] + (-1,))


def _first_max(v, flat):
    """(flat index [N, C, *out], the window max) of each window's first
    largest element in row-major order (a later element takes the window
    only if strictly larger), over windows `v` and their index map."""
    top = v.amax(-1, keepdim=True)
    first = (v == top).to(torch.int32).argmax(-1, keepdim=True)
    idx = torch.gather(flat.expand(v.shape), -1, first)[..., 0]
    return idx, top[..., 0]


def _window_argmax(x, ksize, strides, paddings):
    """int32 [N, C, *out]: for each pooling window of x, the flat index
    (within one unpadded image or volume) of its first largest element
    in row-major window order, as the JAX side's reduction over (value,
    index) pairs keeps it: a later element wins only if strictly larger,
    so NaN never wins, and a window with nothing above -inf (all
    padding, -inf or NaN) gives 0."""
    v = x.detach()
    v = torch.where(torch.isnan(v), torch.full((), float("-inf"),
                                               dtype=v.dtype,
                                               device=v.device), v)
    idx, top = _first_max(*_windows(v, ksize, strides, paddings,
                                    float("-inf")))
    return torch.where(top > float("-inf"), idx,
                       torch.zeros((), dtype=torch.int32, device=x.device))


def _add_at(shape, idx, vals):
    """Zeros of `shape` [N, C, *spatial] with vals [N, C, ...] added at
    the flat indices idx [N, C, ...] (within each image; -1 adds nothing)
    in an order fixed by the data (`add_rows_`)."""
    n, c = shape[:2]
    size = int(np.prod(shape[2:]))
    idx = idx.reshape(n * c, -1).to(torch.int64)
    rows = torch.arange(n * c, dtype=torch.int64, device=vals.device)[
        :, None] * size + idx.clamp(min=0)
    vals = torch.where(idx >= 0, vals.reshape(n * c, -1),
                       torch.full((), -0.0, dtype=vals.dtype,
                                  device=vals.device))
    out = torch.zeros(n * c * size, 1, dtype=vals.dtype, device=vals.device)
    add_rows_(out, rows.reshape(-1).to(torch.int32), vals.reshape(-1, 1))
    return out.reshape(shape)


def _pool3d_grad(x, og, attrs, ptype):
    """X's grad of a 3-D pool: a max window's grad to its first largest
    element (none to a window of nothing above -inf), an average
    window's spread over its elements, divided by the window's size;
    added by `_add_at`, where F.max_pool3d's and F.avg_pool3d's CUDA
    backwards add overlapping windows atomically and do not repeat."""
    ksize, strides, paddings = _pool_window(x, attrs, 3)
    og = og.to(x.dtype)
    if ptype == "max":
        v, flat = _windows(x.detach(), ksize, strides, paddings,
                           float("-inf"))
        idx, top = _first_max(v, flat)
        idx = torch.where(top > float("-inf"), idx,
                          torch.full((), -1, dtype=idx.dtype,
                                     device=x.device))
        return _add_at(x.shape, idx, og.reshape(idx.shape))
    _, flat = _windows(x[:1, :1].detach(), ksize, strides, paddings, 0.0)
    k = flat.shape[-1]
    idx = flat.expand(x.shape[:2] + flat.shape)
    vals = (og / int(np.prod(ksize)))[..., None].expand(idx.shape)
    return _add_at(x.shape, idx, vals) if k else torch.zeros_like(x)


@register_op("max_pool2d_with_index")
def max_pool2d_with_index(ctx, ins, attrs):
    """reference: pool_with_index_op.cc.  Out: pool2d's max pooling (its
    grad to each window's first largest element); Mask: int32, the flat
    h * w index of the element each window took (`_window_argmax`)."""
    x = ins["X"][0]
    out = _pool2d_impl(x, dict(attrs, pooling_type="max"))
    ksize, strides, paddings = _pool_window(x, attrs, 2)
    return {"Out": [out],
            "Mask": [_window_argmax(x, ksize, strides, paddings)]}


@register_op("max_pool3d_with_index")
def max_pool3d_with_index(ctx, ins, attrs):
    """The 3-D pool with an index: Mask holds d * h * w flat indices."""
    x = ins["X"][0]
    ksize, strides, paddings = _pool_window(x, attrs, 3)
    out = _max_pool3d(x, ksize, strides, paddings)
    _check_spatial(out, "max_pool3d_with_index", x, (2, 3))
    return {"Out": [out],
            "Mask": [_window_argmax(x, ksize, strides, paddings)]}


@register_grad_kernel("max_pool3d_with_index")
def max_pool3d_with_index_grad(ctx, ins, attrs):
    x = ins["X"][0]
    return {"X@GRAD": [_pool3d_grad(x, ins["OG@Out"][0], attrs, "max")]}


def _unpool_index(x, idx, attrs):
    """(Indices as flat positions [N * C, h * w] within one output
    image, -1 where outside it; the output's shape): an index in
    [-oh * ow, 0) counts from the end, as `.at[i]` takes it."""
    n, c, h, w = x.shape
    size = attrs.get("unpooling_size") or attrs.get("ksize", [2, 2])
    oh, ow = h * size[0], w * size[1]
    i = idx.reshape(n * c, -1).to(torch.int64)
    i = torch.where(i < 0, i + oh * ow, i)
    return torch.where((i >= 0) & (i < oh * ow), i,
                       torch.full((), -1, dtype=i.dtype, device=i.device)), \
        (n, c, oh, ow)


@register_op("unpool", nondiff_inputs=("Indices",))
def unpool(ctx, ins, attrs):
    """reference: unpool_op.cc.  Each value of X added at its index in
    its image of the [N, C, h * uh, w * uw] output, as the JAX side's
    `.at[i].add`: repeated indices (overlapping windows) sum, an index
    outside the image adds nothing.  The sums run in an order fixed by
    the data (`_add_at`), so the card repeats its bits."""
    x = ins["X"][0]
    idx, shape = _unpool_index(x, ins["Indices"][0], attrs)
    return {"Out": [_add_at(shape, idx, x)]}


@register_grad_kernel("unpool")
def unpool_grad(ctx, ins, attrs):
    """X's grad: the output grad read at each value's index (0 where the
    index lies outside the image)."""
    x = ins["X"][0]
    idx, shape = _unpool_index(x, ins["Indices"][0], attrs)
    og = ins["OG@Out"][0].to(x.dtype).reshape(idx.shape[0], -1)
    g = torch.where(idx >= 0, torch.gather(og, 1, idx.clamp(min=0)),
                    torch.zeros((), dtype=x.dtype, device=x.device))
    return {"X@GRAD": [g.reshape(x.shape)]}


@register_op("maxout")
def maxout(ctx, ins, attrs):
    """reference: maxout_op.cc.  The max over each group of `groups`
    consecutive channels; torch.amax, whose grad splits evenly among
    ties as jnp.max's does."""
    x = ins["X"][0]
    groups = int(attrs["groups"])
    n, c, h, w = x.shape
    return {"Out": [torch.amax(x.reshape(n, c // groups, groups, h, w),
                               dim=2)]}


@register_op("spp")
def spp(ctx, ins, attrs):
    """Spatial pyramid pooling (reference: spp_op.cc): level l pools
    the image into 2^l x 2^l bins with pool2d (its window ceil(h / 2^l),
    padded to cover the image), the levels flattened and
    concatenated."""
    x = ins["X"][0]
    levels = int(attrs.get("pyramid_height", 3))
    ptype = attrs.get("pooling_type", "max")
    n, _, h, w = x.shape
    outs = []
    for level in range(levels):
        bins = 2 ** level
        kh, kw = int(np.ceil(h / bins)), int(np.ceil(w / bins))
        ph, pw = int((kh * bins - h + 1) / 2), int((kw * bins - w + 1) / 2)
        pooled = _pool2d_impl(x, {"pooling_type": ptype, "ksize": [kh, kw],
                                  "strides": [kh, kw],
                                  "paddings": [ph, pw]})
        outs.append(pooled.reshape(n, -1))
    return {"Out": [torch.cat(outs, dim=1)]}


def _roi_masks(x, rois, attrs):
    """(batch id [R] int64, row masks [R, PH, H], column masks [R, PW,
    W]) of ROIs [R, 5] (batch id, x1, y1, x2, y2 in image pixels): the
    corners scaled and rounded half to even, the ROI at least 1 x 1,
    bin (i, j) rows [y1 + floor(i h / PH), y1 + ceil((i + 1) h / PH))
    and the like for columns, cut to the feature map."""
    ph_n, pw_n = int(attrs["pooled_height"]), int(attrs["pooled_width"])
    scale = attrs.get("spatial_scale", 1.0)
    r = values_of(rois).to(x.dtype)
    bid = r[:, 0].to(torch.int32).to(torch.int64)
    x1, y1, x2, y2 = (torch.round(r[:, k] * scale).to(torch.int64)
                      for k in (1, 2, 3, 4))
    roi_h = torch.clamp(y2 - y1 + 1, min=1)
    roi_w = torch.clamp(x2 - x1 + 1, min=1)

    def masks(start, extent, bins, size):
        i = torch.arange(bins, device=x.device)[None, :]
        lo = start[:, None] + torch.div(i * extent[:, None], bins,
                                        rounding_mode="floor")
        hi = start[:, None] + torch.div((i + 1) * extent[:, None] + bins
                                        - 1, bins, rounding_mode="floor")
        pos = torch.arange(size, device=x.device)[None, None, :]
        return (pos >= lo[..., None]) & (pos < hi[..., None])

    return bid, masks(y1, roi_h, ph_n, x.shape[2]), \
        masks(x1, roi_w, pw_n, x.shape[3])


def _roi_max(img, rows, cols):
    """[R, C, PH, PW]: the max of each ROI's image over each bin, -inf
    where the bin is empty; separable, the rows' max first, so no
    [R, bins, C, H, W] mask is made."""
    neg = torch.full((), float("-inf"), dtype=img.dtype, device=img.device)
    out = []
    for i in range(rows.shape[1]):
        band = torch.where(rows[:, i, None, :, None], img, neg).amax(2)
        out.append(torch.where(cols[:, None, :, :], band[:, :, None, :],
                               neg).amax(-1))
    return torch.stack(out, dim=2)


@register_op("roi_pool", nondiff_inputs=("ROIs",))
def roi_pool(ctx, ins, attrs):
    """reference: roi_pool_op.cc.  Out [R, C, PH, PW]: the max of each
    bin of each ROI (`_roi_masks`), 0 where the bin is empty or its max
    not finite; Argmax int32 zeros, as on the JAX side.  The grad is
    its own kernel."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    bid, rows, cols = _roi_masks(x, rois, attrs)
    m = _roi_max(x[bid], rows, cols)
    out = torch.where(torch.isfinite(m), m, torch.zeros((), dtype=m.dtype,
                                                        device=m.device))
    return {"Out": [out], "Argmax": [torch.zeros(out.shape,
                                                 dtype=torch.int32,
                                                 device=out.device)]}


@register_grad_kernel("roi_pool")
def roi_pool_grad(ctx, ins, attrs):
    """X's grad as jnp.max's vjp gives it: each finite bin's output grad
    split evenly among the bin's elements equal to its max, a bin at a
    time; then each ROI's image grad added into its batch image in an
    order fixed by the data (`add_rows_`), so the card repeats its
    bits."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    og = ins["OG@Out"][0].to(x.dtype)
    bid, rows, cols = _roi_masks(x, rois, attrs)
    img = x.detach()[bid]
    m = _roi_max(img, rows, cols)
    g = torch.zeros_like(img)
    for i in range(rows.shape[1]):
        for j in range(cols.shape[1]):
            mask = rows[:, i, None, :, None] & cols[:, j, None, None, :]
            hit = (img == m[:, :, i, j, None, None]) & mask
            share = torch.where(torch.isfinite(m[:, :, i, j]),
                                og[:, :, i, j], torch.zeros(
                                    (), dtype=x.dtype, device=x.device)) \
                / hit.sum((2, 3)).clamp(min=1)
            g = g + hit * share[:, :, None, None]
    out = torch.zeros(x.shape[0], x[0].numel(), dtype=x.dtype,
                      device=x.device)
    add_rows_(out, bid.to(torch.int32), g.reshape(g.shape[0], -1))
    return {"X@GRAD": [out.reshape(x.shape)]}


@register_op("conv2d_dynamic_filter", deterministic=True)
def conv2d_dynamic_filter(ctx, ins, attrs):
    """Each image of Input [B, C, H, W] convolved with its own filters,
    row b of Filter [B, F * C * kh * kw] (reference: ConvOperator.cpp):
    one grouped convolution of [1, B * C, H, W] by [B * F, C, kh, kw]
    with B groups, cuDNN on the card under deterministic algorithms and
    the AMP policy."""
    x, w = ins["Input"][0], ins["Filter"][0]
    f = int(attrs["num_filters"])
    kh, kw = attrs.get("ksize", [3, 3])
    b, c, h, wd = x.shape
    xm, wm = mxu_operands(x, w)
    with _cudnn_scope("conv2d_dynamic_filter"):
        out = F.conv2d(xm.reshape(1, b * c, h, wd),
                       wm.reshape(b * f, c, kh, kw),
                       stride=tuple(attrs.get("strides", [1, 1])),
                       padding=tuple(attrs.get("paddings", [0, 0])),
                       groups=b)
    out = out.reshape(b, f, out.shape[2], out.shape[3])
    _check_spatial(out, "conv2d_dynamic_filter", x, (2, 3))
    return {"Output": [amp_result(out, x.dtype)]}
