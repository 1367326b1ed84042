"""Flash-attention forward: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of paddle_tpu/kernels/flash_attention.py, whose Pallas
kernel `_fwd_kernel` is the TPU kernel this module replaces.  The CUDA
C++ source is csrc/flash_attention_fwd.cu (its head comment says what
bounds it on the H100 and what its design does about that); it is built
at first use and bound with ctypes.

`flash_attention_fwd` is the wrapper: for a tensor on the CPU it runs
`flash_attention_plain`, a blockwise online-softmax transcription of
`_fwd_kernel` with `_fwd`'s block halving; for a CUDA tensor it launches
the kernel, or raises.  It never falls back from the card to the plain
version.  `flash_attention_fwd.launches` counts kernel launches and
nothing else.

The backward (`_flash_bwd_rule` on the JAX side) comes with the training
slice.
"""

import ctypes

import torch

from . import _build

__all__ = ["NEG_INF", "flash_attention", "flash_attention_fwd",
           "flash_attention_plain", "reference_attention"]

NEG_INF = -1e30

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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

    q [B, H, Tq, D], k/v [B, H, Tk, D], f32 or bf16.  K/V stream in
    `block_k` tiles (halved until they divide Tk, as `_fwd` does) with
    an online softmax in f32; masked scores are the finite -1e30.  The
    query blocks are independent, so all of them run at once: `block_q`
    changes nothing in the result."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
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


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError("flash_attention: %s is on %s, the kernel "
                             "needs CUDA tensors" % (name, t.device))
        if t.device != q.device:
            raise ValueError("flash_attention: q, k, v lie on different "
                             "devices")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError("flash_attention: %s has dtype %s; the kernel "
                            "takes float32 or bfloat16" % (name, t.dtype))
        if t.dtype != q.dtype:
            raise TypeError("flash_attention: q, k, v differ in dtype")
        if t.dim() != 4:
            raise ValueError("flash_attention: %s must be [B, H, T, D], "
                             "got %s" % (name, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("flash_attention: %s must be contiguous"
                             % name)
    B, H, Tq, D = q.shape
    if tuple(k.shape[:2]) != (B, H) or k.shape[3] != D \
            or tuple(v.shape) != tuple(k.shape):
        raise ValueError("flash_attention: shapes q %s, k %s, v %s do not "
                         "match" % (tuple(q.shape), tuple(k.shape),
                                    tuple(v.shape)))
    if not 0 < D <= 128:
        raise ValueError("flash_attention: head dim %d; the kernel takes "
                         "1..128" % D)
    if min(B * H, Tq, k.shape[2]) <= 0:
        raise ValueError("flash_attention: empty input %s"
                         % (tuple(q.shape),))


def _launch(q, k, v, sm_scale, causal, q_offset):
    _check(q, k, v)
    lib = _build.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    o = torch.empty_like(q)
    m = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             m.data_ptr(), l.data_ptr(), B * H, Tq, Tk, D,
             float(sm_scale), int(bool(causal)), int(q_offset),
             _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError("flash_attention_fwd kernel launch failed: "
                           "cudaError %d" % err)
    flash_attention_fwd.launches += 1
    return o, m, l


def flash_attention_fwd(q, k, v, sm_scale=None, causal=False, block_q=128,
                        block_k=128, q_offset=0):
    """(o, m, l) of the attention forward, the counterpart of `_fwd`.

    A CPU tensor takes the plain version (with `block_q`/`block_k`); a
    CUDA tensor launches the kernel, which has its own tiles and ignores
    the block sizes."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sm_scale, causal, block_q,
                                     block_k, q_offset)
    return _launch(q, k, v, sm_scale, causal, q_offset)


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, sm_scale=None, causal=False, block_q=128,
                    block_k=128, q_offset=0):
    """softmax(q k^T * scale [+ causal mask]) v without materializing the
    score matrix; q, k, v: [B, H, T, D].  `q_offset` shifts the query
    positions of the causal mask."""
    return flash_attention_fwd(q, k, v, sm_scale, causal, block_q,
                               block_k, q_offset)[0]


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
