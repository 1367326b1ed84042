"""Flash attention: the CUDA forward kernel's wrapper and its plain
PyTorch version, and the gradient.

Counterpart of paddle_tpu/kernels/flash_attention.py, whose Pallas
kernel `_fwd_kernel` is the TPU kernel this module replaces.  The CUDA
C++ source is csrc/flash_attention_fwd.cu (its head comment says what
bounds it on the H100 and what its design does about that); it is built
at first use and bound with ctypes.

`flash_attention_fwd` ([B, H, T, D], the JAX side's layout) and
`flash_attention_bthd` ([B, T, H, D] views, as the split op leaves q, k
and v, with O written into a given [B, T, H*D] tensor) are the wrappers:
for a tensor on the CPU they run `flash_attention_plain`, a blockwise
online-softmax transcription of `_fwd_kernel` with `_fwd`'s block
halving; for a CUDA tensor they launch the kernel on the views where
they lie, or raise.  They never fall back from the card to the plain
version.  `check_kernel_args` is the pure check of what the kernel
takes.  `flash_attention_fwd.launches` counts kernel launches and
nothing else; `flash_attention_fwd.route_launches` splits that count by
the kernel's route (`kernel_route`: the dtype, and head dims up to 128 or
129..256, which run other tilings).

The gradient: `FlashAttentionFunction` is a torch.autograd.Function
whose forward is `flash_attention_bthd` (on the card, the CUDA kernel on
the views) and whose backward is `flash_attention_bwd`, a PyTorch
transcription of the JAX side's `_flash_bwd_rule`, which is plain XLA
there too.  It is written in the form torch.func transforms (`forward`
without ctx, `setup_context`), so the executor's generic grad, a
`torch.func.vjp` of the op, reaches the kernel with plain tensors whose
`data_ptr()` the ctypes launch can read.
"""

import ctypes

import torch

from . import _build

__all__ = ["MAX_HEAD_DIM", "NEG_INF", "ROUTES", "FlashAttentionFunction",
           "check_kernel_args", "flash_attention", "flash_attention_bthd",
           "flash_attention_bwd", "flash_attention_fwd",
           "flash_attention_plain", "kernel_route", "reference_attention"]

NEG_INF = -1e30

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16"}

# the largest head dim the kernel takes: above it, one 64-row q tile and
# a two-stage K/V ring no longer fit the 227 KB of shared memory
MAX_HEAD_DIM = 256

# the kernel's routes: head dims 1..128 and 129..256 run other tilings
# (csrc/flash_attention_fwd.cu, head comment)
ROUTES = tuple("%s%s" % (tag, suffix) for suffix in ("", "_d256")
               for tag in ("f32", "bf16", "f16"))


def _scaled_q(q, sm_scale):
    """q * sm_scale in q's dtype (the scale rounded to it first), as the
    JAX kernel multiplies a bf16 or f32 block by a weakly typed
    python float."""
    return q * torch.tensor(sm_scale, dtype=q.dtype, device=q.device)


def _halve(block, t):
    b = min(block, t)
    while t % b:
        b //= 2
    return max(b, 1)


def flash_attention_plain(q, k, v, sm_scale=None, causal=False,
                          block_q=128, block_k=128, q_offset=0):
    """The kernel's function in plain PyTorch: (o, m, l).

    q [B, H, Tq, D], k/v [B, H, Tk, D], f32, bf16 or f16, any strides.  K/V
    stream in `block_k` tiles (halved until they divide Tk, as `_fwd`
    does) with an online softmax in f32; masked scores are the finite
    -1e30.  The query blocks are independent, so all of them run at
    once: `block_q` changes nothing in the result."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    # strided views (the split op's) take the contiguous call's arithmetic
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    bk = _halve(block_k, Tk)
    qs = _scaled_q(q, sm_scale).float()
    kf, vf = k.float(), v.float()
    dev = q.device
    m = torch.full((B, H, Tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=dev)
    q_pos = q_offset + torch.arange(Tq, device=dev)
    for i in range(Tk // bk):
        k_blk = kf[:, :, i * bk:(i + 1) * bk]
        v_blk = vf[:, :, i * bk:(i + 1) * bk]
        s = torch.matmul(qs, k_blk.transpose(-1, -2))
        if causal:
            k_pos = i * bk + torch.arange(bk, device=dev)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                            torch.full((), NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(
            p.to(v.dtype).float(), v_blk)
        m = m_new
    safe_l = torch.where(l > 0, l, torch.ones((), device=dev))
    return (acc / safe_l[..., None]).to(q.dtype), m, l


class _Unaligned(ValueError):
    """A view the kernel's TMA loads cannot walk as it lies."""


_NAMES = ("q", "k", "v", "o")


def check_kernel_args(q, k, v, o):
    """Raise unless the kernel can read q, k, v and write o as they are
    (the head dim and dtype through `kernel_route`, which picks the
    kernel's route); return their 12 element strides, (batch, row, head)
    of q, k, v, o.

    Each is a [B, T, H, D] view (q and o [B, Tq, H, D], k and v
    [B, Tk, H, D]) of one dtype, float32, bfloat16 or float16, with D in
    1..256.
    The kernel's TMA loads walk the rows of one head, so each view needs
    a unit stride in D, a 16-byte-aligned base pointer, and batch, row
    and head strides that are multiples of 16 bytes.  Looks at shapes,
    strides and pointers only, never at the device.  It runs on every
    launch, so the common case takes one pass."""
    ts = (q, k, v, o)
    dtype = q.dtype
    for name, t in zip(_NAMES, ts):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError("flash_attention: %s has dtype %s; the kernel "
                            "takes float16, float32 or bfloat16"
                            % (name, t.dtype))
        if t.dtype != dtype:
            raise TypeError("flash_attention: q, k, v, o differ in dtype")
    shapes = [tuple(t.shape) for t in ts]
    for name, shape in zip(_NAMES, shapes):
        if len(shape) != 4:
            raise ValueError("flash_attention: %s must be [B, T, H, D], "
                             "got %s" % (name, shape))
    B, Tq, H, D = shapes[0]
    Tk = shapes[1][1]
    if shapes[1] != (B, Tk, H, D) or shapes[2] != shapes[1] \
            or shapes[3] != shapes[0]:
        raise ValueError("flash_attention: shapes q %s, k %s, v %s, o %s do "
                         "not match" % tuple(shapes))
    kernel_route(dtype, D)
    if min(B, H, Tq, Tk) <= 0:
        raise ValueError("flash_attention: empty input %s" % (shapes[0],))
    strides = [t.stride() for t in ts]
    ptrs = [t.data_ptr() for t in ts]
    size = q.element_size()
    outer = [st[i] for st in strides for i in (0, 1, 2)]
    if any(st[3] != 1 for st in strides) or any(p % 16 for p in ptrs) \
            or any((x * size) % 16 for x in outer):
        for name, st, ptr in zip(_NAMES, strides, ptrs):
            if st[3] != 1:
                raise _Unaligned(
                    "flash_attention: %s has stride %d in its last "
                    "dimension; the kernel needs unit stride"
                    % (name, st[3]))
            if ptr % 16:
                raise _Unaligned("flash_attention: %s's base pointer is not "
                                 "16-byte aligned" % name)
            for x, what in zip(st[:3], ("batch", "row", "head")):
                if (x * size) % 16:
                    raise _Unaligned(
                        "flash_attention: %s's %s stride of %d bytes is "
                        "not a multiple of 16" % (name, what, x * size))
    return outer


def kernel_route(dtype, d):
    """The kernel's route for `dtype` at head dim `d`: "f32", "bf16" or
    "f16" for d in 1..128, with "_d256" for d in 129..256 (one consumer
    warpgroup over 16-key tiles in f32, a two-stage ring of 64-key tiles
    in bf16 and f16).  Raises for any other dtype or head dim."""
    if dtype not in _DTYPE_TAG:
        raise TypeError("flash_attention: dtype %s; the kernel takes "
                        "float16, float32 or bfloat16" % (dtype,))
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError("flash_attention: head dim %d; the kernel takes "
                         "1..%d" % (d, MAX_HEAD_DIM))
    return _DTYPE_TAG[dtype] + ("" if d <= 128 else "_d256")


def _padded(q, k, v):
    """Contiguous copies of q, k, v with D padded with zeros to a
    multiple of 16 bytes: zero columns change no score, and give zero
    columns of o."""
    pad = -q.shape[3] % (16 // q.element_size())
    return tuple(torch.nn.functional.pad(t, (0, pad)).contiguous()
                 for t in (q, k, v))


_fn = None


def _kernel():
    """The C entry point, its argument types set once."""
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention_fwd").flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(q, k, v, sm_scale, causal, q_offset, out=None):
    """Launch the kernel on [B, T, H, D] views; (o, m, l) with o the view
    `out` (allocated when None) and m, l [B, H, Tq] float32.  Views the
    TMA loads cannot walk (a misaligned pointer or stride, a strided D)
    are copied, with D padded, first."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        bad = [(n, t) for n, t in (("q", q), ("k", k), ("v", v))
               if t.device.type != "cuda"]
        if bad:
            raise ValueError("flash_attention: %s is on %s, the kernel "
                             "needs CUDA tensors" % (bad[0][0],
                                                     bad[0][1].device))
        raise ValueError("flash_attention: q, k, v lie on different "
                         "devices")
    if out is not None and out.device != dev:
        raise ValueError("flash_attention: out lies on another device")
    d_in = q.shape[3]
    o = torch.empty(q.shape, dtype=q.dtype, device=dev) if out is None \
        else out
    try:
        strides = check_kernel_args(q, k, v, o)
    except _Unaligned:
        q, k, v = _padded(q, k, v)
        o = torch.empty(q.shape, dtype=q.dtype, device=dev)
        strides = check_kernel_args(q, k, v, o)
    B, Tq, H, D = q.shape
    # m and l in one allocation, l right after m
    ml = torch.empty((2, B, H, Tq), dtype=torch.float32, device=dev)
    m_ptr = ml.data_ptr()
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    m_ptr, m_ptr + 4 * B * H * Tq, B, H, Tq, k.shape[1], D,
                    (ctypes.c_longlong * 12)(*strides), float(sm_scale),
                    bool(causal), int(q_offset), _DTYPE_CODE[q.dtype],
                    # the current stream's raw handle, by the private call
                    # inductor uses: torch.cuda.current_stream() costs
                    # several microseconds of host time per launch
                    torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError("flash_attention_fwd kernel launch failed: "
                           "cudaError %d" % err)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.route_launches[kernel_route(q.dtype, D)] += 1
    if out is None:
        out = o[..., :d_in]
    elif o is not out:
        out.copy_(o[..., :d_in])
    m, l = ml
    return out, m, l


def flash_attention_bthd(q, k, v, sm_scale=None, causal=False, q_offset=0,
                         out=None, block_q=128, block_k=128):
    """(o, m, l) of the attention forward on [B, T, H, D] views, as the
    `split` op leaves q, k and v; o [B, Tq, H, D] is written into `out`
    when given (a view of a [B, Tq, H*D] tensor), m and l are
    [B, H, Tq].  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel on the views where they lie."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        o, m, l = flash_attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            sm_scale, causal, block_q, block_k, q_offset)
        o = o.transpose(1, 2)
        if out is None:
            return o, m, l
        return out.copy_(o), m, l
    return _launch(q, k, v, sm_scale, causal, q_offset, out)


def flash_attention_fwd(q, k, v, sm_scale=None, causal=False, block_q=128,
                        block_k=128, q_offset=0):
    """(o, m, l) of the attention forward, the counterpart of `_fwd`;
    q [B, H, Tq, D], k/v [B, H, Tk, D], any strides.

    A CPU tensor takes the plain version (with `block_q`/`block_k`); a
    CUDA tensor launches the kernel, which has its own tiles and ignores
    the block sizes."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sm_scale, causal, block_q,
                                     block_k, q_offset)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _, m, l = _launch(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), sm_scale, causal, q_offset,
                      out.transpose(1, 2))
    return out, m, l


flash_attention_fwd.launches = 0
flash_attention_fwd.route_launches = dict.fromkeys(ROUTES, 0)


def flash_attention(q, k, v, sm_scale=None, causal=False, block_q=128,
                    block_k=128, q_offset=0):
    """softmax(q k^T * scale [+ causal mask]) v without materializing the
    score matrix; q, k, v: [B, H, T, D].  `q_offset` shifts the query
    positions of the causal mask."""
    return flash_attention_fwd(q, k, v, sm_scale, causal, block_q,
                               block_k, q_offset)[0]


def flash_attention_bwd(q, k, v, o, m, l, do, sm_scale=None, causal=False,
                        block_k=128, q_offset=0):
    """(dq, dk, dv) of the attention forward, from its residuals: the
    blockwise recompute backward of `_flash_bwd_rule`, in its order.

    q, o, do [B, H, Tq, D], k/v [B, H, Tk, D] (any strides), m and l
    [B, H, Tq] from the forward.  Over key blocks of `block_k` (halved
    until they divide Tk): p = exp(s - m) / safe_l with the finite
    -1e30 causal mask, dv = p^T do, dp = do v^T, ds = p (dp - delta)
    with delta = rowsum(do o), dq += ds k * scale, dk = ds^T q*scale.
    All in f32 (q scaled in f32); the grads come back in the inputs'
    dtypes.  The same code runs on the card and on the CPU."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    Tq, Tk = q.shape[2], k.shape[2]
    bk = _halve(block_k, Tk)
    dev = q.device
    safe_l = torch.where(l > 0, l, torch.ones((), device=dev))
    dof = do.float()
    delta = (dof * o.float()).sum(dim=-1)
    qs = q.float() * sm_scale
    q_pos = q_offset + torch.arange(Tq, device=dev)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for i in range(Tk // bk):
        k_blk = k[:, :, i * bk:(i + 1) * bk].float()
        v_blk = v[:, :, i * bk:(i + 1) * bk].float()
        s = torch.matmul(qs, k_blk.transpose(-1, -2))
        if causal:
            k_pos = i * bk + torch.arange(bk, device=dev)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                            torch.full((), NEG_INF, device=dev))
        p = torch.exp(s - m[..., None]) / safe_l[..., None]
        dvs.append(torch.matmul(p.transpose(-1, -2), dof))
        dp = torch.matmul(dof, v_blk.transpose(-1, -2))
        ds = p * (dp - delta[..., None])
        dq = dq + torch.matmul(ds, k_blk) * sm_scale
        dks.append(torch.matmul(ds.transpose(-1, -2), qs))
    dk = torch.cat(dks, dim=2)
    dv = torch.cat(dvs, dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFunction(torch.autograd.Function):
    """Attention on [B, T, H, D] views with its gradient: apply(q, k, v,
    sm_scale, causal, q_offset, block_q, block_k) -> (o, m, l).

    o [B, Tq, H, D] is a view of a fresh [B, Tq, H*D] tensor, so
    `o.flatten(2)` is the op's output without a copy; m and l carry no
    gradient.  The residuals (q, k, v, o, m, l) are what the JAX side's
    `_flash_fwd_rule` keeps."""

    @staticmethod
    def forward(q, k, v, sm_scale, causal, q_offset, block_q, block_k):
        B, Tq, H, D = q.shape
        out = torch.empty((B, Tq, H * D), dtype=q.dtype, device=q.device)
        return flash_attention_bthd(q, k, v, sm_scale, causal, q_offset,
                                    out=out.unflatten(-1, (H, D)),
                                    block_q=block_q, block_k=block_k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, sm_scale, causal, q_offset, _, block_k = inputs
        o, m, l = output
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.mark_non_differentiable(m, l)
        ctx.args = (sm_scale, causal, block_k, q_offset)

    @staticmethod
    def backward(ctx, do, _dm, _dl):
        q, k, v, o, m, l = (t.transpose(1, 2) if t.dim() == 4 else t
                            for t in ctx.saved_tensors)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, m, l,
                                         do.transpose(1, 2), *ctx.args)
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None, None, None, None)


def reference_attention(q, k, v, sm_scale=None, causal=False, q_offset=0):
    """Dense attention that materializes the [Tq, Tk] scores, in f32."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        Tq, Tk = q.shape[2], k.shape[2]
        dev = q.device
        mask = (q_offset + torch.arange(Tq, device=dev))[:, None] \
            >= torch.arange(Tk, device=dev)
        s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)
