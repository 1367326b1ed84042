#!/usr/bin/env python3
"""Drive the paddle_tpu_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing its lines; any failure exits non-zero and prints
no result line:
  1. device: the card's name and power limit (fails without CUDA);
  2. build: every CUDA kernel of the package, from csrc/, with nvcc, and
     the count of tensor-core instructions (HGMMA, HMMA) in the flash
     kernel's SASS, which must not be 0;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the served shapes (also as strided views of the fc output, as
     the split op hands them over) and at edge cases, with kernel, plain
     and library (scaled_dot_product_attention) times and the bound of
     the same work on this card by the kernel's arithmetic.  Every route
     of the flash kernel is a case: f32, bf16 and f16 at the served
     shape [16, 8, 512, 64], and the head-dim-256 routes at
     [16, 2, 512, 256] (the transformer at bench.py's width with 2
     heads), causal and not, as split views, and at head dim 192.  Kernel and
     library times are device times (CUDA graph replay, so the host's
     launch cost is out); the plain version's are CUDA events around
     eager calls;
     The gradient case: FlashAttentionFunction's dq, dk, dv at the path
     shape (split views of the fc output) against the same backward
     (`flash_attention_bwd`) fed by the plain forward on the card, and
     the backward's device time beside the library's backward
     (scaled_dot_product_attention forward and backward, less its
     forward);
  4. slice: the full-width transformer (batch 16, seq 512, d_model 512,
     6 layers, 8 heads, vocab 8192, random weights from a seed) exported,
     loaded by InferenceEngine on the card and served by InferenceServer:
     3 concurrent POST /v1/infer of one row each, then one 16-row
     engine.run.  Launch counters, reset just before, show the path went
     through the kernels; the logits are checked against the port's plain
     path on the CPU.
  5. train: the same model's training program (momentum 0.9 at lr 0.01,
     bench.py's transformer training step) built by the port, its startup
     run on the card, 3 steps on the card, in which the flash kernel must
     run 12 times per step (the forward op, and again in the generic grad
     of flash_attention_grad), counted from 0 just before, with their
     peak memory; the step's time (median of 10 after 2 warm), tokens/s
     and a profile of one step: device time by kernel and by op type,
     the generic grads' recompute, host time by op type, the device's
     idle share.  Then the same 3 steps from the same state again on the
     card (the floor the atomic adds leave) and through the port's plain
     CPU path: each step's loss and every parameter and velocity after
     them must agree with the card's.  Then the configurations that
     reach the kernel's other routes (`phase_wide`): the transformer at
     2 heads (head dim 256), depth cut to 2 layers, one step in f32
     (against the CPU plain path from the same state) and one under bf16
     AMP, the same at 8 heads under AMP, and a program of one
     flash_attention op over float16 feeds at 2 and 8 heads against the
     CPU plain path, each counting its route's launches.
  6. resnet: ResNet-50 built through the port's fluid layers as bench.py
     builds it (its default model: `__graft_entry__._build_model`, batch
     128 at 224x224, 1000 classes, momentum 0.9 at lr 0.01), its op
     count, op types and parameter count.  At batch 8: 3 steps on the
     CPU plain path, each step again on the card from the CPU's state
     before it (loss, the step's change of parameters, velocities and
     running statistics gated), then the card's own 3 steps.  At batch
     128, f32 and then bf16 AMP (`fluid.amp.bf16_guard()`), each from
     the same state: 3 steps with their peak memory, the step's time
     (median of 10 after 2 warm, feeds on the card), images/s and a
     profile of one step; the AMP losses against the f32 ones.  The
     batch-16 inference clone (`clone(for_test=True)`): its forward time
     and its logits against the CPU plain path.  ResNet-50 runs no
     hand-written kernel (conv2d is cuDNN, the rest ATen).
  7. decode: generation at the transformer's full width (batch 16, 512
     positions).  The training program with Adam (lr 1e-3, as
     examples/transformer_lm.py trains the LM it generates from): its
     startup and 3 steps on the card, the first against the CPU plain
     path from the same state (loss, and the step's change of the
     parameters and both moments in relative L2).  From the scope they
     leave, fluid.ProgramDecoder over the KV-cached step: greedy with a
     128-token prefill to the cache's extent (385 tokens, 512
     positions), each generated token's logit within ARGMAX_ATOL of its
     position's largest in the full forward teacher-forced on the
     result, the step logits at 3 positions against it, and one token
     more raising before any step; the prefill's and the step's latency
     (median of 64 synchronised steps), the step's bound (its weights and
     caches over HBM bandwidth) and a profile of one step;
     cached_attention alone at [16, 8, 512, 64] against
     scaled_dot_product_attention.  Then the sliding-window step, 32
     tokens over a 512-token window, in which the flash kernel must run
     6 times per step, counted from 0 just before: each step's logits
     against the full forward's last position, the first 2 against the
     port's plain CPU path, its latency.  Beam: beam(1) equal to greedy;
     beam 4 at batch 4 (the step's 16 rows) best first, the best score
     against its log-probability through the full forward.  Sampling:
     temperature 1e-5 and top_k=1 equal greedy, a seed repeats.  Last,
     greedy, sampling and beam loops and window steps run with CUDA's
     synchronizing calls made errors: no step waits for the device.
  8. image: bench.py's alexnet and vgg16 at its training shape (batch
     128 at 224x224, 1000 classes, momentum 0.9 at lr 0.01, f32 with
     TF32 off): 3 steps with their peak memory, the step's time (median
     of 10 after 2 warm), images/s and a profiled step.  At batch 8 one
     vgg16 and one smallnet step on the card against the CPU plain path
     from the same state; alexnet's dropout keep rates and its is_test
     clone's logits against the CPU.  Then
     examples/train_image_classification.py's flow: smallnet on the
     synthetic CIFAR-10 reader at batch 64 under bf16 AMP, fed by
     DataFeeder through batch(shuffle(...)) and device_prefetch, with
     layers.accuracy; a CheckpointSaver snapshot after step 8 restored
     by load_checkpoint into a fresh scope and executor gives step 9 the
     loss and accuracy of the run that was not interrupted, and a later
     snapshot torn by injected faults is skipped.  The image models run
     no hand-written kernel.
The kernels line lists each route of the flash kernel with its launches
over every main path, and the numbers of its first case in phase 3.
The last line is {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the paddle_tpu package.
"""

import collections
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

SEED = 0
# the served model: bench.py's BENCH_MODEL=transformer configuration
BATCH, SEQ, D_MODEL, N_LAYER, N_HEAD, VOCAB = 16, 512, 512, 6, 8, 8192
BUCKETS = [1, 2, 4, 8, 16]

# H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12      # TF32 tensor cores
BF16_FLOPS = 989e12      # bf16 tensor cores
FP16_FLOPS = 989e12      # fp16 tensor cores
F32_CORE_FLOPS = 67e12   # f32 outside the tensor cores, for comparison
# the kernel's arithmetic by dtype: f32 runs each product as split TF32
# (three TF32 products per f32 product), bf16 and f16 as one product of
# their type
ROUTE = {"float32": ("split TF32", 3, TF32_FLOPS),
         "bfloat16": ("bf16", 1, BF16_FLOPS),
         "float16": ("f16", 1, FP16_FLOPS)}

# kernel against plain version: (O atol, m atol, l rtol) by dtype.  Both
# compute the same f32 sums in other orders (the kernel in 16-key chunks,
# the plain version in 128-key tiles); bf16 and f16 O also round p and O
# to their type at points that differ by a chunk, up to an ulp (2^-8
# relative for bf16, 2^-11 for f16) of outputs up to about 2.
TOL = {"float32": (2e-5, 1e-4, 1e-4), "bfloat16": (2e-2, 1e-4, 1e-4),
       "float16": (2e-3, 1e-4, 1e-4)}
# the kernel's routes at head dims 129..256 run at [16, 2, 512, 256]: the
# transformer at bench.py's width with 2 heads (d_model 512 / 2)
WIDE_HEADS, WIDE_D = 2, 256
# served logits, card against the port's plain CPU path: float32 on both
# sides, sums in other orders (cuBLAS and the CUDA kernel against CPU BLAS
# and the plain attention) through 6 layers of reductions up to 2048 long
LOGITS_ATOL = 2e-3
# the flash gradient at the path shape, fed the kernel's forward against
# fed the plain forward: the kernel's O (within 2e-5), m and l move p and
# delta = rowsum(do o), which the backward multiplies into dq, dk, dv
# (entries up to about 5 for randn inputs); perturbing O, m and l by the
# kernel's errors moves them by up to 9e-5 on the CPU
GRAD_ATOL = 5e-4
# training: bench.py's optimizer, steps checked against the CPU plain path
LR, MOMENTUM, TRAIN_STEPS = 0.01, 0.9, 3
# losses (about ln 8192 = 9.0) at atol 1e-4: f32 on both sides, sums in
# other orders.  Parameters and velocities after the steps: the largest
# difference, less 2 ulps of the largest entry (stored parameters round:
# a layer_norm scale near 1.0 moves by about 1e-5 in 3 steps, and an ulp
# of 1.0 is 1.2e-7), over the largest entry of what the steps made
# (p - p0, and v), at 2e-2.  At init a grad is a sum over 8192 tokens of
# terms of both signs, so its relative error is the terms' (about 1e-5,
# from the flash kernel's split TF32 and other sum orders) times their
# cancellation, and behind a relu the mask flips wherever a
# pre-activation lies within that difference of 0: the feed-forward
# blocks' first fc differs most, by up to 9e-3 on an H100.  The card
# against itself from the same state differs by 1e-5 to 2e-3 from run to
# run.  A wrong grad gives order 1.
LOSS_ATOL = 1e-4
STATE_RTOL = 2e-2
STATE_ULPS = 2

# ResNet-50 as bench.py trains it (BENCH_MODEL=resnet50, its default):
# batch 128 at 224x224, 1000 classes, momentum 0.9 at lr 0.01; BENCH_AMP
# (on by default there) is bf16 AMP here
RN_BATCH, RN_HW, RN_CLASSES = 128, 224, 1000
RN_CHECK_BATCH = 8     # the card-against-CPU check
RN_INFER_BATCH = 16    # BENCH_MODE=infer's batch
# card against the CPU plain path at batch 8: each of 3 steps from the
# same state (the CPU's state before it).  Training from this
# initialisation at batch 8 is chaotic: on the CPU, 1 thread against 6
# (sums in other orders) gives the same first loss to 1e-6 and grads
# within 0.7 % (relative L2 norm), yet after 3 free-running steps losses
# 0.077 apart and velocities 100 % apart; one step from the same state
# stays within 1e-6 in the loss, 1.2 % in the step's change of the
# velocities, 0.9 % of the parameters and 1e-6 of the running statistics.
# cuDNN with TF32 off picks other algorithms than oneDNN (FFT among them)
# and accumulates some weight grads with atomic adds: on an H100 the card
# read 1e-5 in the losses, 1.6 to 3.0 % in the changes and 7e-6 in the
# running statistics.  The gates: losses at atol 5e-4, the step's change
# of the parameters and of the velocities at relative L2 0.1, of the
# batch-norm running statistics at 1e-3 (f32 on both sides; a wrong grad
# reads order 1).  The free-running trajectories are printed, not gated.
RN_LOSS_ATOL = 5e-4
RN_CHANGE_RL2 = 0.1
RN_STATS_RL2 = 1e-3
# bf16 AMP against f32 from the same state, each of 3 steps' losses
# (about 7.5): bf16 rounds every activation to 2^-9 relative through 50
# layers, and the steps' updates differ by the bf16 grads; the port's CPU
# path at batch 32 shows 0.036 and 0.045 over 2 steps.  0.15 (2 % of the
# loss) holds that and catches a policy that diverges or overflows
RN_AMP_LOSS_ATOL = 0.15
# the inference clone's logits, card against CPU, at 1e-3 of the largest
# logit: 3 steps leave the running statistics near their start (mean 0,
# variance 1), so the test clone barely normalises and the activations
# grow through the 16 residual additions; f32 through 50 layers, sums in
# other orders
RN_LOGITS_RTOL = 1e-3

# the transformer at 2 heads (head dim 256) and at 8 heads under bf16
# AMP, depth cut to 2 layers: one momentum step each.  AMP against f32
# from the same state: the port's CPU path at batch 2, seq 128 read
# 8.7e-5 (2 heads) and 1.0e-4 (8 heads) on losses of 9.08; 1e-2 is 100
# times that, and a policy that overflows or a wrong route reads order 1
WIDE_LAYERS = 2
WIDE_AMP_LOSS_ATOL = 1e-2

# phase 8, image classification: bench.py's alexnet and vgg16 at its
# training shape (RN_BATCH, RN_HW, RN_CLASSES, momentum 0.9 at lr 0.01,
# f32 with TF32 off); vgg16 and smallnet at batch 8, card against the
# CPU plain path, one step from the same state
IMG_MODELS = ("alexnet", "vgg16")
IMG_CHECK_BATCH = 8
# the loss (about ln 1000 = 6.9 and ln 10) at atol 5e-4, as ResNet-50's:
# f32 on both sides, sums in other orders.  The step's change (from the
# initial state, the velocity is the grad and the parameters move by lr
# times it) in relative L2 at 2e-2: without batch norm the grads differ
# only by the convolutions' and products' sum orders (cuDNN's FFT and
# Winograd algorithms round differently from oneDNN's), expected near
# 1e-4 to 1e-3; a wrong grad reads order 1
IMG_LOSS_ATOL = 5e-4
IMG_CHANGE_RL2 = 2e-2
# alexnet's is_test clone, card against CPU, at 1e-3 of the largest
# logit: f32 through 8 layers, sums in other orders
IMG_LOGITS_RTOL = 1e-3
# examples/train_image_classification.py's flow: batch 64, bf16 AMP; a
# snapshot after step 8 of the 16 of one pass.  The resumed step runs the
# same ops on the same state and feed in the same process: its loss is
# expected equal, and the gate of 1e-5 leaves room for a kernel whose
# sums are not deterministic; the accuracy must be equal
EX_BATCH, EX_SAVE_AT = 64, 8
EX_RESUME_ATOL = 1e-5

# phase 7, generation: the transformer trained with Adam, as
# examples/transformer_lm.py trains the LM it generates from
ADAM_LR = 1e-3
PROMPT_LEN = 128        # the cached path: 128 + 385 - 1 = 512 positions
WINDOW_STEPS = 32       # tokens of the sliding-window path
BEAM_BATCH, BEAM_SIZE, BEAM_LEN = 4, 4, 32   # 16 rows, the step's batch
# Adam's first step against the CPU plain path from the same state, in
# relative L2 of what the step made.  The moments are linear (m1) and
# quadratic (m2) in the grad, so they differ as the grads do; the
# parameters move by lr * m1 / (sqrt(m2) + eps), about lr * sign(g), so
# an entry whose grad lies within the card-CPU difference of 0 (the K
# projection's bias has an identically zero grad: softmax ignores a shift
# common to every key) moves by up to 2 lr between them, and the
# parameters differ more than the grads.  An H100 read 6.7e-4 (m1),
# 1.2e-3 (m2) and 5.3e-3 (parameters); the gates are about 10 times
# that, and a wrong grad or update rule reads order 1
ADAM_MOMENT_RL2 = 1e-2
ADAM_PARAM_RL2 = 5e-2
# teacher forcing: each generated token's logit in the full forward lies
# within this of that position's largest logit (argmax equality that
# survives near-ties between two logits the card computes in other orders)
ARGMAX_ATOL = 1e-3
# the best beam's score against its log-probability recomputed through
# the full forward: 32 f32 log-softmaxes summed (about -9 each)
BEAM_SCORE_ATOL = 1e-3


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def route_entry(route):
    """The kernels-line name of the flash kernel's `route`."""
    return "flash_attention_fwd[%s]" % route


def reset_launches():
    """Every launch count to 0: each kernel's, and the flash kernel's by
    route."""
    from paddle_tpu_torch.kernels import KERNELS
    from paddle_tpu_torch.kernels import flash_attention as fa

    for w in KERNELS.values():
        w.launches = 0
    for route in fa.ROUTES:
        fa.flash_attention_fwd.route_launches[route] = 0


def read_launches():
    """{name: launches} of each kernel, and of the flash kernel by route
    (`route_entry`)."""
    from paddle_tpu_torch.kernels import KERNELS
    from paddle_tpu_torch.kernels import flash_attention as fa

    counts = {n: w.launches for n, w in KERNELS.items()}
    counts.update({route_entry(r): n for r, n in
                   fa.flash_attention_fwd.route_launches.items()})
    return counts


def cuda_ms(fn, iters=20, warm=3):
    """Mean milliseconds of fn() on the card, by CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, launches=20, replays=5):
    """Mean milliseconds of fn() on the card with the host taken out:
    `launches` calls captured into one CUDA graph, replayed `replays`
    times between CUDA events.  The warm-up calls run on a side stream,
    as PyTorch's graph capture asks of work that runs autograd."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * launches)
    del graph
    return ms


def timed_steps(step, runs=10, warm=2):
    """Host milliseconds of `runs` calls of step() that each end in a
    synchronize, after `warm` calls."""
    import torch

    for _ in range(warm):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def attention_bound(B, H, Tq, Tk, D, causal, q_offset, dtype):
    """(ms, "bytes" | "operations", f32 CUDA-core ms): the least time the
    card needs for the attention forward on these inputs by the kernel's
    route — q, k, v read once, o, m, l written once, and 4*D operations
    per (query, key) pair this run's mask keeps, each f32 one costing
    three TF32 operations — and, for comparison, the operations on the
    f32 CUDA cores."""
    itemsize = 4 if dtype == "float32" else 2
    if causal:
        keys = np.clip(q_offset + np.arange(Tq) + 1, 0, Tk).sum()
    else:
        keys = Tq * Tk
    flops = 4.0 * D * B * H * float(keys)
    nbytes = B * H * ((2 * Tq + 2 * Tk) * D * itemsize + 2 * Tq * 4)
    _, per_product, peak = ROUTE[dtype]
    t_ops = flops * per_product / peak
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes", \
        max(flops / F32_CORE_FLOPS, t_bytes) * 1e3


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    print("device: %s, count %d, torch %s, cuda %s"
          % (torch.cuda.get_device_name(0), torch.cuda.device_count(),
             torch.__version__, torch.version.cuda), flush=True)
    print("nvidia-smi: %s" % nvidia_smi_line(), flush=True)


def sass_opcodes(library):
    """Counter of the base opcodes (HGMMA, HMMA, FFMA, ...) in the SASS
    of a shared library, by cuobjdump."""
    import collections
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    # "/*0150*/  @!P0 HMMA.1688.F32.TF32 R4, ..." -> HMMA
    opcode = re.compile(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_]*)")
    ops = collections.Counter()
    for line in sass.splitlines():
        m = opcode.match(line)
        if m:
            ops[m.group(1)] += 1
    return ops


def phase_build():
    from paddle_tpu_torch.kernels import _build

    seconds = _build.build_all()
    print("build: %d kernel libraries in %.1f s"
          % (len(_build.SOURCES), seconds), flush=True)
    for name in _build.SOURCES:
        log = _build.build_log(name) or "(already built)"
        print("build %s:\n%s" % (name, log.strip()), flush=True)
    ops = sass_opcodes(_build.library_path("flash_attention_fwd"))
    hgmma, hmma = ops["HGMMA"], ops["HMMA"]
    print("build: flash_attention_fwd SASS holds %d HGMMA and %d HMMA "
          "tensor-core instructions (%d FFMA)" % (hgmma, hmma, ops["FFMA"]),
          flush=True)
    if hgmma == 0:
        raise SystemExit("chip_smoke: the flash kernel's SASS holds no "
                         "HGMMA: it is not on the tensor cores")


def _library_call(q, k, v, scale, causal, q_offset):
    """scaled_dot_product_attention on the same inputs and mask ([B, H,
    T, D] views), the yardstick; no row here is fully masked, where the
    two would differ."""
    import torch
    import torch.nn.functional as F

    Tq, Tk = q.shape[2], k.shape[2]
    if not causal:
        return lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
    if q_offset == 0 and Tq == Tk:
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale)
    mask = (q_offset + torch.arange(Tq, device=q.device))[:, None] \
        >= torch.arange(Tk, device=q.device)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=scale)


def phase_kernels():
    """The flash-attention kernel against its plain version; returns,
    for each route, the numbers of its first case for the kernels
    line."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, H, T, D = BATCH, N_HEAD, SEQ, D_MODEL // N_HEAD
    # bring the card up to its clocks before the first timing
    a = torch.randn(4096, 4096, device="cuda", generator=gen)
    t_end = time.perf_counter() + 0.5
    while time.perf_counter() < t_end:
        a @ a
        torch.cuda.synchronize()
    del a
    # the first case of each route is the one its kernels-line entry
    # reports
    cases = [  # name, Tq, Tk, heads, head dim, dtype, causal, q_offset, split
        ("path f32 causal", T, T, H, D, "float32", True, 0, False),
        ("path bf16 causal", T, T, H, D, "bfloat16", True, 0, False),
        ("path f16 causal", T, T, H, D, "float16", True, 0, False),
        ("D=256 f32 causal", T, T, WIDE_HEADS, WIDE_D, "float32", True, 0,
         False),
        ("D=256 bf16 causal", T, T, WIDE_HEADS, WIDE_D, "bfloat16", True,
         0, False),
        ("D=256 f16 causal", T, T, WIDE_HEADS, WIDE_D, "float16", True, 0,
         False),
        ("D=256 f32 non-causal", T, T, WIDE_HEADS, WIDE_D, "float32",
         False, 0, False),
        ("D=256 bf16 non-causal", T, T, WIDE_HEADS, WIDE_D, "bfloat16",
         False, 0, False),
        ("D=256 f32 causal, split views", T, T, WIDE_HEADS, WIDE_D,
         "float32", True, 0, True),
        ("D=192 bf16 causal T=200", 200, 200, WIDE_HEADS, 192, "bfloat16",
         True, 0, False),
        ("path f32 causal, split views", T, T, H, D, "float32", True, 0,
         True),
        ("path f32 non-causal", T, T, H, D, "float32", False, 0, False),
        ("path f32 causal q_offset=64", T, T, H, D, "float32", True, 64,
         False),
        ("T=200 f32 causal", 200, 200, H, D, "float32", True, 0, False),
        ("Tq=64 Tk=512 q_offset=448 f32 causal", 64, T, H, D, "float32",
         True, 448, False),
        ("D=32 f32 causal", T, T, H, 32, "float32", True, 0, False),
        ("D=128 f32 causal", T, T, H, 128, "float32", True, 0, False),
        ("D=128 bf16 causal", T, T, H, 128, "bfloat16", True, 0, False),
    ]
    measured = {}
    for name, tq, tk, H, d, dtype, causal, q_offset, split in cases:
        tdt = getattr(torch, dtype)
        scale = d ** -0.5
        if split:
            # q, k, v as the split op leaves the [B, T, 3*H*d] fc output,
            # O written into a [B, T, H*d] tensor
            x = torch.randn(B, tq, 3 * H * d, device="cuda",
                            generator=gen).to(tdt)
            qs, ks, vs = (t.unflatten(-1, (H, d))
                          for t in x.split(H * d, dim=-1))
            out = torch.empty(B, tq, H * d, device="cuda", dtype=tdt)
            o4 = out.unflatten(-1, (H, d))

            def kernel():
                return fa.flash_attention_bthd(qs, ks, vs, scale, causal,
                                               q_offset, out=o4)

            o, m, l = kernel()
            if o.data_ptr() != out.data_ptr():
                raise SystemExit("chip_smoke: the kernel did not write O "
                                 "into the [B, T, H*D] tensor")
            o = o.transpose(1, 2)
            q, k, v = qs.transpose(1, 2), ks.transpose(1, 2), \
                vs.transpose(1, 2)
        else:
            q = torch.randn(B, H, tq, d, device="cuda", generator=gen) \
                .to(tdt)
            k, v = [torch.randn(B, H, tk, d, device="cuda", generator=gen)
                    .to(tdt) for _ in range(2)]

            def kernel():
                return fa.flash_attention_fwd(q, k, v, scale, causal,
                                              q_offset=q_offset)

            o, m, l = kernel()
        po, pm, pl = fa.flash_attention_plain(q, k, v, scale, causal,
                                              q_offset=q_offset)
        torch.cuda.synchronize()
        err_o = (o.float() - po.float()).abs().max().item()
        err_m = (m - pm).abs().max().item()
        err_l = ((l - pl).abs() / pl.abs().clamp_min(1e-30)).max().item()
        tol_o, tol_m, tol_l = TOL[dtype]
        ok = err_o <= tol_o and err_m <= tol_m and err_l <= tol_l \
            and bool(torch.isfinite(o.float()).all())
        k_ms = device_ms(kernel)
        eager_ms = cuda_ms(kernel)
        p_ms = cuda_ms(lambda: fa.flash_attention_plain(
            q, k, v, scale, causal, q_offset=q_offset), iters=5)
        lib_ms = device_ms(_library_call(q, k, v, scale, causal, q_offset))
        bound_ms, bound_by, core_ms = attention_bound(
            B, H, tq, tk, d, causal, q_offset, dtype)
        print("kernel flash_attention_fwd [%s] q %s k %s: max_abs_err O "
              "%.3g (atol %g) m %.3g (atol %g) l rel %.3g (rtol %g); "
              "kernel %.4f ms (eager calls %.4f ms), plain %.4f ms, library "
              "scaled_dot_product_attention %.4f ms, bound %.4f ms (%s, "
              "%s route; on the f32 CUDA cores %.4f ms)"
              % (name, list(q.shape), list(k.shape), err_o, tol_o, err_m,
                 tol_m, err_l, tol_l, k_ms, eager_ms, p_ms, lib_ms,
                 bound_ms, bound_by, ROUTE[dtype][0], core_ms), flush=True)
        if not ok:
            raise SystemExit("chip_smoke: flash_attention_fwd disagrees "
                             "with its plain version on %s" % name)
        measured.setdefault(fa.kernel_route(tdt, d), {
            "max_abs_err": err_o, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms})
        del q, k, v, o, m, l, po, pm, pl
    if set(measured) != set(fa.ROUTES):
        raise SystemExit("chip_smoke: no kernel case for the routes %s"
                         % sorted(set(fa.ROUTES) - set(measured)))
    flash_gradient(gen)
    print("kernels: %s" % json.dumps(read_launches()), flush=True)
    return {route_entry(r): m for r, m in measured.items()}


def backward_bound(B, H, T, D):
    """(ms, "bytes" | "operations", f32 CUDA-core ms) of the causal
    attention backward at [B, H, T, D]: q, k, v, o, do read once, m and l
    read, dq, dk, dv written once; 10*D operations per kept (query, key)
    pair (the products s, dv, dp, dq, dk), each f32 one as three TF32
    operations, the route a hand-written kernel would take; and the same
    operations on the f32 CUDA cores, the route of the PyTorch
    transcription with TF32 off."""
    keys = float(np.arange(1, T + 1).sum())
    flops = 10.0 * D * B * H * keys
    nbytes = B * H * (8 * T * D * 4 + 2 * T * 4)
    t_ops = flops * 3 / TF32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes", \
        max(flops / F32_CORE_FLOPS, t_bytes) * 1e3


def flash_gradient(gen):
    """The gradient case: FlashAttentionFunction under torch.func.vjp on
    the split views of a [16, 512, 1536] fc output (what the generic grad
    of flash_attention_grad runs: the CUDA forward, then
    flash_attention_bwd), against flash_attention_bwd fed the plain
    forward on the card; then the backward's device time beside the
    library's."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa

    B, H, T, D = BATCH, N_HEAD, SEQ, D_MODEL // N_HEAD
    scale = D ** -0.5
    x = torch.randn(B, T, 3 * H * D, device="cuda", generator=gen)
    qs, ks, vs = (t.unflatten(-1, (H, D)) for t in x.split(H * D, dim=-1))
    do = torch.randn(B, T, H, D, device="cuda", generator=gen)
    launches = fa.flash_attention_fwd.launches
    o, vjp_fn = torch.func.vjp(
        lambda q, k, v: fa.FlashAttentionFunction.apply(
            q, k, v, scale, True, 0, 128, 128)[0], qs, ks, vs)
    got = vjp_fn(do)
    if fa.flash_attention_fwd.launches != launches + 1:
        raise SystemExit("chip_smoke: the Function did not launch the "
                         "flash kernel")
    # [B, H, T, D] views, the layout of the backward
    q, k, v, doh = (t.transpose(1, 2) for t in (qs, ks, vs, do))
    po, pm, pl = fa.flash_attention_plain(q, k, v, scale, True)
    want = fa.flash_attention_bwd(q, k, v, po, pm, pl, doh, scale, True)
    torch.cuda.synchronize()
    errs = [(g.transpose(1, 2) - w).abs().max().item()
            for g, w in zip(got, want)]
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    ko, km, kl = fa.flash_attention_fwd(q, k, v, scale, True)
    bwd_ms = device_ms(lambda: fa.flash_attention_bwd(
        q, k, v, ko, km, kl, doh, scale, True), launches=5)
    # the library: scaled_dot_product_attention forward and backward,
    # less its forward (with inputs that require grad, as the backward's)
    lq, lk, lv = (t.detach().contiguous().requires_grad_()
                  for t in (q, k, v))
    ldo = doh.contiguous()

    def lib_fwd():
        return F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                              scale=scale)

    lib_fb_ms = device_ms(lambda: torch.autograd.grad(
        lib_fwd(), (lq, lk, lv), ldo), launches=5)
    lib_f_ms = device_ms(lib_fwd, launches=5)
    bound_ms, bound_by, core_ms = backward_bound(B, H, T, D)
    print("gradient flash_attention_bwd [path f32 causal, split views of "
          "[%d, %d, %d]]: max_abs_err dq %.3g dk %.3g dv %.3g (atol %g) "
          "against the backward fed by the plain forward; backward %.4f "
          "ms, library scaled_dot_product_attention backward %.4f ms "
          "(forward and backward %.4f, forward %.4f), bound %.4f ms (%s, "
          "split TF32 route; on the f32 CUDA cores %.4f ms)"
          % (B, T, 3 * H * D, errs[0], errs[1], errs[2], GRAD_ATOL, bwd_ms,
             lib_fb_ms - lib_f_ms, lib_fb_ms, lib_f_ms, bound_ms, bound_by,
             core_ms), flush=True)
    if max(errs) > GRAD_ATOL or not finite:
        raise SystemExit("chip_smoke: the flash gradient disagrees with "
                         "the backward fed by the plain forward")


def _post(url, payload):
    t0 = time.perf_counter()
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        status = resp.status
        body = json.loads(resp.read())
    return status, body, (time.perf_counter() - t0) * 1e3


def device_kernels(events, labels):
    """(name, device us, launches) of each kernel in a profile's
    key_averages(), leaving out the device side of the profiler ranges
    named in `labels` (the executor's per-op ranges)."""
    import torch

    return [(e.key, e.self_device_time_total, e.count) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and e.key not in labels]


def profile_forward(forward, labels, runs=3, attempts=2):
    """Device time by kernel over `runs` 16-row forwards, from
    torch.profiler's CUDA activity: the busy share of the wall window and
    the kernels that take the most time.  A profile counts only when it
    is complete: 6 flash launches per forward and every kernel launched
    the same number of times in each forward; else a fresh session tries
    again, and the shares are reported as not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(runs):
                forward()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = device_kernels(prof.key_averages(), labels)
        flash = sum(k[2] for k in kernels if "flash_fwd_kernel" in k[0])
        uneven = [k for k in kernels if k[2] % runs]
        if flash == 6 * runs and not uneven:
            break
        print("profile: attempt %d incomplete: %d flash launches of %d, "
              "%d kernels launched unevenly across %d forwards"
              % (attempt, flash, 6 * runs, len(uneven), runs), flush=True)
    else:
        print("profile: no complete profile: device busy share not "
              "measured", flush=True)
        return
    busy_us = sum(k[1] for k in kernels)
    print("profile: %d forwards, wall %.3f ms, device busy %.3f ms (%.1f "
          "%%), %d launches per forward"
          % (runs, wall_us / 1e3, busy_us / 1e3, 100.0 * busy_us / wall_us,
             sum(k[2] for k in kernels) // runs), flush=True)
    for name, us, count in sorted(kernels, key=lambda k: -k[1])[:10]:
        print("profile: %6.1f %% %9.3f ms per forward  %4d launches  %s"
              % (100.0 * us / busy_us, us / 1e3 / runs, count,
                 name[:110]), flush=True)
    copies = [k for k in kernels if "copy" in k[0].lower()]
    print("profile: copy kernels %d launches, %.3f ms per forward"
          % (sum(k[2] for k in copies) // runs,
             sum(k[1] for k in copies) / 1e3 / runs), flush=True)


def phase_slice():
    """Serve the full-width transformer; returns the launch counts of
    this run."""
    import torch
    from paddle_tpu_torch.fluid import CPUPlace, Scope, io
    from paddle_tpu_torch.kernels import KERNELS
    from paddle_tpu_torch.models import transformer_program as tp
    from paddle_tpu_torch.serving import (EngineConfig, InferenceEngine,
                                          InferenceServer, ServerConfig)

    fa_fwd = KERNELS["flash_attention_fwd"]
    logits = tp.logits_name(N_LAYER)
    feeds = tp.transformer_feeds(BATCH, SEQ, VOCAB, seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        prog = tp.build_transformer_inference_program(
            BATCH, SEQ, VOCAB, n_layer=N_LAYER, n_head=N_HEAD,
            d_model=D_MODEL)
        params = tp.init_transformer_params(prog, seed=SEED)
        scope = Scope()
        io.params_from_numpy(scope, params, "cpu")
        io.save_inference_model(tmp, ["tokens", "positions"], [logits],
                                scope, prog,
                                bucket_hints={"batch_buckets": BUCKETS})
        n_params = sum(p.size for p in params.values())
        print("slice: %d ops, %d parameters, exported in %.1f s"
              % (len(prog.block(0).ops), n_params,
                 time.perf_counter() - t0), flush=True)

        engine = InferenceEngine.from_saved_model(tmp)
        if engine.place.device().type != "cuda":
            raise SystemExit("chip_smoke: the engine is not on the card")
        server = InferenceServer(engine, ServerConfig(
            port=0, max_batch=BATCH, max_wait_ms=50.0, warmup=True))
        reset_launches()
        forwards = 0
        try:
            t0 = time.perf_counter()
            server.start()
            forwards += len(BUCKETS)
            print("slice: server up with warmup of %d buckets in %.2f s"
                  % (len(BUCKETS), time.perf_counter() - t0), flush=True)
            if fa_fwd.launches != 6 * forwards:
                raise SystemExit("chip_smoke: %d flash launches after %d "
                                 "warmup forwards" % (fa_fwd.launches,
                                                      forwards))
            host, port = server.address
            url = "http://%s:%d/v1/infer" % (host, port)
            replies = [None] * 3

            def client(i):
                replies[i] = _post(url, {"inputs": {
                    n: v[i:i + 1].tolist() for n, v in feeds.items()}})

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(3)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=900)
            if any(r is None for r in replies):
                raise SystemExit("chip_smoke: an HTTP request got no reply")
            batches = server.metrics.batch_occupancy.count
            forwards += batches
            print("slice: 3 requests answered in %d batch(es); latencies "
                  "%s ms" % (batches, ", ".join(
                      "%.1f" % r[2] for r in replies)), flush=True)
            if fa_fwd.launches != 6 * forwards:
                raise SystemExit("chip_smoke: %d flash launches after %d "
                                 "forwards" % (fa_fwd.launches, forwards))
            out16 = engine.run(feeds)[0]
            forwards += 1
            # the main path ends here: read the counts
            launches = read_launches()
            if launches["flash_attention_fwd"] != 6 * forwards:
                raise SystemExit("chip_smoke: %d flash launches after %d "
                                 "forwards" % (fa_fwd.launches, forwards))
            print("slice: main path ran %d forwards, launches %s"
                  % (forwards, json.dumps(launches)), flush=True)

            # forward time of the 16-row batch on the card (feeds already
            # on the device, logits left there)
            dev = engine.place.device()
            dev_feeds = {n: torch.from_numpy(v.astype(np.int32)).to(dev)
                         for n, v in feeds.items()}

            def forward():
                return engine._exe.run(engine.program, feed=dev_feeds,
                                       fetch_list=[logits],
                                       scope=engine.scope,
                                       return_numpy=False)

            times = timed_steps(forward)
            run_times = []
            for _ in range(3):
                t0 = time.perf_counter()
                engine.run(feeds)
                run_times.append((time.perf_counter() - t0) * 1e3)
            print("slice: 16-row forward %.3f ms (mean of 10 after 2 warm; "
                  "median %.3f, min %.3f, max %.3f); engine.run of 16 rows "
                  "with the logits copied to the host %.1f ms (mean of 3)"
                  % (np.mean(times), np.median(times), min(times),
                     max(times), np.mean(run_times)), flush=True)
            profile_forward(forward, {op.type for op in
                                      engine.program.block(0).ops})
        finally:
            server.shutdown()

        # the port's plain path on the CPU, same export, rows 0..2
        t0 = time.perf_counter()
        cpu = InferenceEngine.from_saved_model(
            tmp, place=CPUPlace(), config=EngineConfig(batch_buckets=None))
        ref = cpu.run({n: v[:3] for n, v in feeds.items()})[0]
        print("slice: CPU reference of 3 rows in %.1f s"
              % (time.perf_counter() - t0), flush=True)

    errs = []
    for i, (status, body, _) in enumerate(replies):
        if status != 200:
            raise SystemExit("chip_smoke: HTTP %d: %s" % (status, body))
        got = np.asarray(body["outputs"][logits], np.float32)
        if got.shape != (1, SEQ, VOCAB):
            raise SystemExit("chip_smoke: reply logits shape %s"
                             % (got.shape,))
        errs.append(float(np.abs(got[0] - ref[i]).max()))
    if out16.shape != (BATCH, SEQ, VOCAB) or not np.isfinite(out16).all():
        raise SystemExit("chip_smoke: 16-row logits %s, finite %s"
                         % (out16.shape, np.isfinite(out16).all()))
    errs.append(float(np.abs(out16[:2] - ref[:2]).max()))
    print("slice: logits max_abs_err against the CPU plain path: HTTP "
          "rows %s, engine.run rows 0-1 %.3g (atol %g)"
          % (", ".join("%.3g" % e for e in errs[:3]), errs[3],
             LOGITS_ATOL), flush=True)
    if max(errs) > LOGITS_ATOL:
        raise SystemExit("chip_smoke: served logits disagree with the CPU "
                         "plain path")
    return launches


KERNEL_FAMILIES = (  # (family, name fragments), first match wins
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("copies", ("copy",)),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
    ("flash forward", ("flash_fwd_kernel",)),
    ("convolutions and products", ("xmma", "cutlass", "cudnn", "gemm",
                                   "wgrad", "dgrad", "fft", "sm80_",
                                   "sm90_")),
)


def kernel_family(name):
    for family, fragments in KERNEL_FAMILIES:
        if any(f in name for f in fragments):
            return family
    return "other"


def profile_step(step, op_types, flash_launches, step_ms, attempts=2,
                 what="one training step"):
    """Device time of one step (`what`) by kernel, from torch.profiler's
    CUDA activity, with the busy share of the profiled window and of the
    unprofiled step (`step_ms`); and by op type, from the executor's
    per-op profiler ranges ("recompute" is the generic grads' recompute of
    the forward, inside their grad ops): the device time of the kernels
    launched from the executor's thread in each range, and the host time
    of that thread in it.  The backward half of a generic grad runs on
    the autograd engine's device thread, outside any range: its kernels
    count in the kernel table and the busy time, in no op's row.  The
    profile counts only when it is complete: the step's `flash_launches`
    flash launches in it; else a fresh session tries again, and the
    shares are reported as not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        kernels = device_kernels(events, op_types | {"recompute"})
        flash = sum(k[2] for k in kernels if "flash_fwd_kernel" in k[0])
        if flash == flash_launches and kernels:
            break
        print("profile: attempt %d incomplete: %d flash launches of %d"
              % (attempt, flash, flash_launches), flush=True)
    else:
        print("profile: no complete profile: device busy share not "
              "measured", flush=True)
        return
    busy_us = sum(k[1] for k in kernels)
    print("profile: %s, wall %.3f ms, device busy %.3f ms "
          "(%.1f %% of the profiled window, idle %.1f %%; %.1f %% of the "
          "unprofiled median step, idle %.1f %%), %d launches"
          % (what, wall_us / 1e3, busy_us / 1e3, 100.0 * busy_us / wall_us,
             100.0 - 100.0 * busy_us / wall_us,
             100.0 * busy_us / 1e3 / step_ms,
             100.0 - 100.0 * busy_us / 1e3 / step_ms,
             sum(k[2] for k in kernels)), flush=True)
    for name, us, count in sorted(kernels, key=lambda k: -k[1])[:15]:
        print("profile: kernel %6.1f %% %9.3f ms %5d launches  %s"
              % (100.0 * us / busy_us, us / 1e3, count, name[:110]),
              flush=True)
    families = collections.Counter()
    for name, us, _ in kernels:
        families[kernel_family(name)] += us
    print("profile: by family: %s" % ", ".join(
        "%s %.3f ms" % (f, us / 1e3) for f, us in families.most_common()),
        flush=True)
    spans = [(e.key, e.device_time_total, e.cpu_time_total, e.count)
             for e in events
             if e.device_type == torch.autograd.DeviceType.CPU
             and (e.key in op_types or e.key == "recompute")]
    for name, us, host_us, count in sorted(spans, key=lambda k: -k[2]):
        print("profile: op %-34s device %9.3f ms (%5.1f %% of busy), host "
              "%9.3f ms (%5.1f %% of the window), %4d ops"
              % (name, us / 1e3, 100.0 * us / busy_us, host_us / 1e3,
                 100.0 * host_us / wall_us, count), flush=True)


def run_from_state(executor, main, loss, state, feeds):
    """(losses, the state after, seconds): the steps of `feeds` through
    `main` from `state` ({name: ndarray}) in a fresh scope on the
    executor's device; the state after has the names of `state`."""
    from paddle_tpu_torch.fluid import Scope, io

    s = Scope()
    io.params_from_numpy(s, state, executor.device)
    t0 = time.perf_counter()
    losses = [float(executor.run(main, feed=f, fetch_list=[loss],
                                 scope=s)[0][0]) for f in feeds]
    return losses, {n: s.get(n).cpu().numpy() for n in state}, \
        time.perf_counter() - t0


def state_errors(got, ref, bases):
    """{name: largest difference, less STATE_ULPS ulps of the largest
    entry (the rounding of stored values), over the largest entry of the
    steps' change from bases[name]} for each name of `bases`."""
    out = {}
    for name, base in bases.items():
        d = float(np.abs(got[name] - ref[name]).max())
        ulps = STATE_ULPS * float(np.spacing(
            np.abs(ref[name]).max().astype(np.float32)))
        out[name] = max(d - ulps, 0.0) / max(
            float(np.abs(ref[name] - base).max()), 1e-30)
    return out


def change_rl2(got, ref, before, names):
    """||got - ref|| / ||ref - before|| over the tensors `names`: the
    error of a step's change in relative L2 norm."""
    num = sum(float(((got[n] - ref[n]).astype(np.float64) ** 2).sum())
              for n in names)
    den = sum(float(((ref[n] - before[n]).astype(np.float64) ** 2).sum())
              for n in names)
    return (num / max(den, 1e-300)) ** 0.5


def report(tag, what, ref_losses, losses, errs, rtol):
    print("%s: %s: loss max_abs_err %.3g; state error (rtol %g, %d ulps): "
          "median %.3g, worst %s"
          % (tag, what, max(abs(a - b) for a, b in zip(ref_losses, losses)),
             rtol, STATE_ULPS, float(np.median(list(errs.values()))),
             ", ".join("%s %.3g" % (n, errs[n]) for n in sorted(
                 errs, key=lambda n: -errs[n])[:5])), flush=True)


def phase_train():
    """Train the full-width transformer on the card and check 3 steps
    against the port's plain CPU path; returns the launch counts of those
    3 steps."""
    import torch
    from paddle_tpu_torch.fluid import (CPUPlace, Executor,
                                        MomentumOptimizer, Scope)
    from paddle_tpu_torch.models import transformer_program as tp

    t0 = time.perf_counter()
    main, startup, loss, _ = tp.build_transformer_program(
        BATCH, SEQ, VOCAB, n_layer=N_LAYER, n_head=N_HEAD, d_model=D_MODEL)
    MomentumOptimizer(LR, MOMENTUM).minimize(loss, main, startup)
    block = main.block(0)
    op_types = {op.type for op in block.ops}
    persist = [n for n, v in block.vars.items() if v.persistable]
    params = [n for n in persist if n + "_velocity_0" in block.vars]
    print("train: main %d ops of %d types, startup %d ops, %d parameters "
          "(%d values), built in %.1f s"
          % (len(block.ops), len(op_types), len(startup.block(0).ops),
             len(params), sum(int(np.prod(block.var(n).shape))
                              for n in params),
             time.perf_counter() - t0), flush=True)

    exe = Executor()
    if exe.device.type != "cuda":
        raise SystemExit("chip_smoke: the executor is not on the card")
    scope = Scope()
    exe.run(startup, scope=scope)
    init = {n: scope.get(n).cpu().numpy() for n in persist}
    feeds = [tp.transformer_feeds(BATCH, SEQ, VOCAB, seed=SEED + i,
                                  targets=True)
             for i in range(TRAIN_STEPS)]

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    card = [float(exe.run(main, feed=f, fetch_list=[loss],
                          scope=scope)[0][0]) for f in feeds]
    card_s = time.perf_counter() - t0
    # the main path ends here: read the counts
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    print("train: %d steps on the card in %.2f s, losses %s; launches %s; "
          "peak memory %.3f GB"
          % (TRAIN_STEPS, card_s, ", ".join("%.6f" % x for x in card),
             json.dumps(launches), peak / 1e9), flush=True)
    # per layer, the forward op and the generic grad's recompute
    per_step = 2 * N_LAYER
    if launches["flash_attention_fwd"] != per_step * TRAIN_STEPS:
        raise SystemExit("chip_smoke: %d flash launches in %d training "
                         "steps, designed %d per step"
                         % (launches["flash_attention_fwd"], TRAIN_STEPS,
                            per_step))
    after = {n: scope.get(n).cpu().numpy() for n in persist}

    # the step's time on the card, feeds already there (training goes on
    # in `scope`; the state after the 3 steps is kept above)
    dev_feed = {n: torch.from_numpy(v.astype(np.int32)).to(exe.device)
                for n, v in feeds[0].items()}

    def step():
        return exe.run(main, feed=dev_feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)

    times = timed_steps(step)
    med = float(np.median(times))
    print("train: step %.3f ms (median of 10 after 2 warm; mean %.3f, min "
          "%.3f, max %.3f), %.0f tokens/s"
          % (med, np.mean(times), min(times), max(times),
             BATCH * SEQ / med * 1e3), flush=True)
    profile_step(step, op_types, per_step, med)

    bases = dict({n: init[n] for n in params},
                 **{n + "_velocity_0": 0.0 for n in params})
    # the card against itself from the same state: the floor that its
    # nondeterminism (the embedding grads' atomic adds) leaves
    again, again_state, _ = run_from_state(exe, main, loss, init, feeds)
    report("train", "card against the card again", card, again,
           state_errors(again_state, after, bases), STATE_RTOL)
    # the same steps from the same state through the plain CPU path
    cpu, cpu_state, cpu_s = run_from_state(Executor(CPUPlace()), main,
                                           loss, init, feeds)
    print("train: the same %d steps on the CPU plain path in %.1f s, "
          "losses %s" % (TRAIN_STEPS, cpu_s,
                         ", ".join("%.6f" % x for x in cpu)), flush=True)
    errs = state_errors(after, cpu_state, bases)
    report("train", "card against CPU", card, cpu, errs, STATE_RTOL)
    loss_err = max(abs(a - b) for a, b in zip(card, cpu))
    finite = all(np.isfinite(v).all() for v in after.values()) \
        and all(np.isfinite(card))
    if loss_err > LOSS_ATOL or max(errs.values()) > STATE_RTOL \
            or not finite:
        raise SystemExit("chip_smoke: training on the card disagrees with "
                         "the CPU plain path (loss atol %g, state rtol %g)"
                         % (LOSS_ATOL, STATE_RTOL))
    return launches


def phase_wide():
    """The configurations that reach the flash kernel's other routes,
    through the entry points a user calls: the transformer at bench.py's
    width with 2 heads (head dim 256), depth cut to WIDE_LAYERS, one
    momentum step in f32 (against the CPU plain path from the same state)
    and one under bf16 AMP; the same at 8 heads under AMP (bench.py's
    default BENCH_AMP=1 transformer step); and a fluid program of one
    flash_attention op over float16 feeds at 2 and 8 heads against the
    CPU plain path.  Returns the launch counts of these runs."""
    import contextlib

    import torch
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import io
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import transformer_program as tp

    counts = collections.Counter()
    feed = tp.transformer_feeds(BATCH, SEQ, VOCAB, seed=SEED + 20,
                                targets=True)
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    for heads in (WIDE_HEADS, N_HEAD):
        main, startup, loss, _ = tp.build_transformer_program(
            BATCH, SEQ, VOCAB, n_layer=WIDE_LAYERS, n_head=heads,
            d_model=D_MODEL)
        fluid.MomentumOptimizer(LR, MOMENTUM).minimize(loss, main, startup)
        persist = [n for n, v in main.block(0).vars.items()
                   if v.persistable]
        exe = fluid.Executor()
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        init = {n: scope.get(n).cpu().numpy() for n in persist}
        del scope
        losses = {}
        for amp in (False, True):
            scope = fluid.Scope()
            io.params_from_numpy(scope, init, exe.device)
            reset_launches()
            with fluid.amp.bf16_guard() if amp else \
                    contextlib.nullcontext():
                losses[amp] = float(exe.run(main, feed=feed,
                                            fetch_list=[loss],
                                            scope=scope)[0][0])
            got = read_launches()
            counts.update(got)
            route = fa.kernel_route(torch.bfloat16 if amp else
                                    torch.float32, D_MODEL // heads)
            # per layer, the forward op and the generic grad's recompute
            print("wide: %d layers, %d heads (head dim %d), one step %s: "
                  "loss %.6f; launches %s"
                  % (WIDE_LAYERS, heads, D_MODEL // heads,
                     "under bf16 AMP" if amp else "in f32", losses[amp],
                     json.dumps({n: c for n, c in got.items() if c})),
                  flush=True)
            if got[route_entry(route)] != 2 * WIDE_LAYERS \
                    or not np.isfinite(losses[amp]):
                raise SystemExit("chip_smoke: the %d-head step ran the "
                                 "%s route %d times, designed %d"
                                 % (heads, route, got[route_entry(route)],
                                    2 * WIDE_LAYERS))
            del scope
        amp_err = abs(losses[True] - losses[False])
        checks = ["bf16 AMP against f32 %.3g (atol %g)"
                  % (amp_err, WIDE_AMP_LOSS_ATOL)]
        ok = amp_err <= WIDE_AMP_LOSS_ATOL
        if heads == WIDE_HEADS:
            (cpu_loss,), _, cpu_s = run_from_state(cpu_exe, main, loss,
                                                   init, [feed])
            checks.append("f32 against the CPU plain path (%.1f s) %.3g "
                          "(atol %g)" % (cpu_s, abs(losses[False] - cpu_loss),
                                         LOSS_ATOL))
            ok = ok and abs(losses[False] - cpu_loss) <= LOSS_ATOL
        print("wide: %d heads: loss %s" % (heads, "; ".join(checks)),
              flush=True)
        if not ok:
            raise SystemExit("chip_smoke: the %d-head step disagrees"
                             % heads)
        del init
        torch.cuda.empty_cache()

    # float16: a program of one flash_attention op over f16 feeds
    rs = np.random.RandomState(SEED + 21)
    qkv = {n: rs.randn(BATCH, SEQ, D_MODEL).astype(np.float16)
           for n in "qkv"}
    for heads in (WIDE_HEADS, N_HEAD):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            q, k, v = (fluid.layers.data(
                name=n, shape=[BATCH, SEQ, D_MODEL], dtype="float16",
                append_batch_size=False) for n in "qkv")
            out = fluid.layers.flash_attention(q, k, v, num_heads=heads,
                                               causal=True)
        reset_launches()
        got_out = fluid.Executor().run(main, feed=qkv, fetch_list=[out],
                                       scope=fluid.Scope())[0]
        got = read_launches()
        counts.update(got)
        ref = cpu_exe.run(main, feed=qkv, fetch_list=[out],
                          scope=fluid.Scope())[0]
        err = float(np.abs(got_out.astype(np.float32)
                           - ref.astype(np.float32)).max())
        route = fa.kernel_route(torch.float16, D_MODEL // heads)
        print("wide: float16 flash_attention program, %d heads (head dim "
              "%d): output %s %s, against the CPU plain path max_abs_err "
              "%.3g (atol %g); %s launches %d"
              % (heads, D_MODEL // heads, list(got_out.shape), got_out.dtype,
                 err, TOL["float16"][0], route, got[route_entry(route)]),
              flush=True)
        if got_out.dtype != np.float16 or err > TOL["float16"][0] \
                or got[route_entry(route)] != 1:
            raise SystemExit("chip_smoke: the float16 program disagrees "
                             "with the CPU plain path")
    return dict(counts)


def build_model(model, batch, hw, classes, channels=3, train=True):
    """`__graft_entry__._build_model`'s program of `model` through the
    port's fluid layers: (main, startup, logits, avg_loss or None)."""
    import paddle_tpu_torch.fluid as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        image = fluid.layers.data(name="image",
                                  shape=[batch, channels, hw, hw],
                                  dtype="float32", append_batch_size=False)
        logits = model(image, class_dim=classes)
        if not train:
            return main, startup, logits, None
        label = fluid.layers.data(name="label", shape=[batch, 1],
                                  dtype="int64", append_batch_size=False)
        avg_loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.MomentumOptimizer(LR, MOMENTUM).minimize(avg_loss)
    return main, startup, logits, avg_loss


def build_resnet50(batch, train=True):
    from paddle_tpu_torch.models.image import resnet50

    return build_model(resnet50, batch, RN_HW, RN_CLASSES, train=train)


def image_feeds(batch, steps, seed, hw, classes, channels=3):
    rs = np.random.RandomState(seed)
    return [{"image": rs.randn(batch, channels, hw, hw).astype(np.float32),
             "label": rs.randint(0, classes, (batch, 1)).astype(np.int64)}
            for _ in range(steps)]


def resnet_feeds(batch, steps, seed):
    return image_feeds(batch, steps, seed, RN_HW, RN_CLASSES)


def forward_flops(block):
    """Operations of one forward of the program's conv2d and mul ops,
    from its VarDesc shapes (2 per multiply-add)."""
    total = 0
    for op in block.ops:
        if op.type == "conv2d":
            w = block.vars[op.input("Filter")[0]].shape
            out = block.vars[op.output("Output")[0]].shape
            total += 2 * int(np.prod(out)) * int(np.prod(w[1:]))
        elif op.type == "mul":
            x = block.vars[op.input("X")[0]].shape
            w = block.vars[op.input("Y")[0]].shape
            total += 2 * x[0] * int(np.prod(w))
    return total


def phase_resnet():
    """ResNet-50 built through the port's fluid layers, as bench.py
    builds it: 3 steps at batch 8 on the card against the CPU plain path;
    at batch 128, f32 and then bf16 AMP (each from the same state): 3
    steps with their peak memory, the step time and a profiled step, the
    AMP losses against the f32 ones; the batch-16 inference clone against
    the CPU.  Returns the launch counts of the f32 batch-128 steps."""
    import contextlib

    import torch
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import io

    t0 = time.perf_counter()
    main, _, _, loss = build_resnet50(RN_BATCH)
    block = main.desc.block(0)
    counts = collections.Counter(op.type for op in block.ops)
    n_values = sum(int(np.prod(v.shape)) for v in block.vars.values()
                   if v.is_parameter)
    flops = forward_flops(block)
    print("resnet: main %d ops of %d types (%s), %d parameter values "
          "(%.2f M); forward %.2f GFLOP per image; built in %.1f s"
          % (len(block.ops), len(counts), ", ".join(
              "%s %d" % kv for kv in sorted(counts.items())), n_values,
             n_values / 1e6, flops / RN_BATCH / 1e9,
             time.perf_counter() - t0), flush=True)
    if abs(n_values - 25.6e6) > 0.1e6:
        raise SystemExit("chip_smoke: ResNet-50 has %d parameter values"
                         % n_values)

    # batch 8: the CPU's 3 steps, and each step on the card from the
    # CPU's state before it; then the card's own 3 steps from the start
    check, check_startup, _, check_loss = build_resnet50(RN_CHECK_BATCH)
    exe = fluid.Executor()
    if exe.device.type != "cuda":
        raise SystemExit("chip_smoke: the executor is not on the card")
    scope = fluid.Scope()
    exe.run(check_startup, scope=scope)
    cblock = check.desc.block(0)
    persist = [n for n, v in cblock.vars.items() if v.persistable]
    init = {n: scope.get(n).cpu().numpy() for n in persist}
    del scope
    groups = {
        "parameters": [n for n, v in cblock.vars.items() if v.is_parameter],
        "velocities": [n for n in persist if n.endswith("_velocity_0")],
        "running statistics": [n for op in cblock.ops
                               if op.type == "batch_norm"
                               for n in op.input("Mean")
                               + op.input("Variance")]}
    feeds = resnet_feeds(RN_CHECK_BATCH, TRAIN_STEPS, SEED)
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    t0 = time.perf_counter()
    states, cpu = [init], []
    for f in feeds:
        loss_k, state, _ = run_from_state(cpu_exe, check, check_loss,
                                          states[-1], [f])
        cpu += loss_k
        states.append(state)
    print("resnet: %d steps at batch %d on the CPU plain path in %.1f s, "
          "losses %s" % (TRAIN_STEPS, RN_CHECK_BATCH,
                         time.perf_counter() - t0,
                         ", ".join("%.6f" % x for x in cpu)), flush=True)
    ok = True
    for k, f in enumerate(feeds):
        (loss_k,), got, _ = run_from_state(exe, check, check_loss,
                                           states[k], [f])
        errs = {g: change_rl2(got, states[k + 1], states[k], names)
                for g, names in groups.items()}
        print("resnet: step %d on the card from the CPU's state: loss "
              "%.6f, max_abs_err %.3g (atol %g); the step's change, "
              "relative L2 error: %s (parameters and velocities %g, "
              "running statistics %g)"
              % (k + 1, loss_k, abs(loss_k - cpu[k]), RN_LOSS_ATOL,
                 ", ".join("%s %.3g" % kv for kv in errs.items()),
                 RN_CHANGE_RL2, RN_STATS_RL2), flush=True)
        ok = ok and abs(loss_k - cpu[k]) <= RN_LOSS_ATOL \
            and errs["parameters"] <= RN_CHANGE_RL2 \
            and errs["velocities"] <= RN_CHANGE_RL2 \
            and errs["running statistics"] <= RN_STATS_RL2 \
            and all(np.isfinite(v).all() for v in got.values())
    card, after, card_s = run_from_state(exe, check, check_loss, init,
                                         feeds)
    print("resnet: the card's own %d steps from the start in %.2f s, losses "
          "%s; against the CPU's trajectory, relative L2: %s (not gated: "
          "the trajectories separate)"
          % (TRAIN_STEPS, card_s, ", ".join("%.6f" % x for x in card),
             ", ".join("%s %.3g" % (g, change_rl2(after, states[-1], init,
                                                  names))
                       for g, names in groups.items())), flush=True)
    if not ok or not np.isfinite(card).all():
        raise SystemExit("chip_smoke: ResNet-50 steps on the card disagree "
                         "with the CPU plain path")

    # batch 128, f32 and then bf16 AMP, each from the same state
    dev_feeds = [{n: torch.from_numpy(v).to(exe.device) for n, v in f.items()}
                 for f in resnet_feeds(RN_BATCH, TRAIN_STEPS, SEED + 1)]
    op_types = set(counts)
    losses, launches, trained = {}, None, None
    for amp in (False, True):
        tag = "bf16 AMP" if amp else "f32"
        scope = fluid.Scope()
        io.params_from_numpy(scope, init, exe.device)
        with fluid.amp.bf16_guard() if amp else contextlib.nullcontext():
            reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            losses[amp] = [float(exe.run(main, feed=f, fetch_list=[loss],
                                         scope=scope)[0][0])
                           for f in dev_feeds]
            seconds = time.perf_counter() - t0
            if not amp:
                # the main path ends here: read the counts
                launches = read_launches()
                trained = {n: scope.get(n).cpu().numpy() for n in persist}
            peak = torch.cuda.max_memory_allocated()
            print("resnet %s: %d steps at batch %d in %.2f s, losses %s; "
                  "peak memory %.3f GB; hand-written kernel launches %s"
                  % (tag, TRAIN_STEPS, RN_BATCH, seconds,
                     ", ".join("%.6f" % x for x in losses[amp]),
                     peak / 1e9,
                     json.dumps(read_launches())),
                  flush=True)

            def step():
                return exe.run(main, feed=dev_feeds[0], fetch_list=[loss],
                               scope=scope, return_numpy=False)

            times = timed_steps(step)
            med = float(np.median(times))
            print("resnet %s: step %.3f ms (median of 10 after 2 warm; mean "
                  "%.3f, min %.3f, max %.3f), %.1f images/s, %.1f TFLOP/s "
                  "of forward and backward products"
                  % (tag, med, np.mean(times), min(times), max(times),
                     RN_BATCH / med * 1e3, 3 * flops / med / 1e9),
                  flush=True)
            profile_step(step, op_types, 0, med)
        del scope
        torch.cuda.empty_cache()
    amp_err = max(abs(a - b) for a, b in zip(losses[True], losses[False]))
    print("resnet: bf16 AMP losses against f32 from the same state: max "
          "abs difference %.4g (atol %g)" % (amp_err, RN_AMP_LOSS_ATOL),
          flush=True)
    if amp_err > RN_AMP_LOSS_ATOL or not np.isfinite(losses[True]).all():
        raise SystemExit("chip_smoke: the bf16 AMP steps disagree with the "
                         "f32 steps")

    # the inference clone at batch 16, on the state of the 3 f32 steps
    fwd, _, logits, _ = build_resnet50(RN_INFER_BATCH, train=False)
    infer = fwd.clone(for_test=True)
    if not all(op.attrs["is_test"] for op in infer.desc.block(0).ops
               if op.type == "batch_norm"):
        raise SystemExit("chip_smoke: the test clone trains its batch norms")
    state = {n: v for n, v in trained.items()
             if n in infer.desc.block(0).vars}
    image = resnet_feeds(RN_INFER_BATCH, 1, SEED + 2)[0]["image"]
    scope = fluid.Scope()
    io.params_from_numpy(scope, state, exe.device)
    dev_image = torch.from_numpy(image).to(exe.device)

    def forward():
        return exe.run(infer, feed={"image": dev_image}, fetch_list=[logits],
                       scope=scope, return_numpy=False)[0]

    times = timed_steps(forward)
    out = forward().cpu().numpy()
    cpu_scope = fluid.Scope()
    io.params_from_numpy(cpu_scope, state, "cpu")
    t0 = time.perf_counter()
    ref = fluid.Executor(fluid.CPUPlace()).run(
        infer, feed={"image": image}, fetch_list=[logits],
        scope=cpu_scope)[0]
    err = float(np.abs(out - ref).max())
    top = float(np.abs(ref).max())
    print("resnet: inference clone at batch %d: forward %.3f ms (median of "
          "10 after 2 warm; mean %.3f, min %.3f, max %.3f), %.1f images/s; "
          "logits %s, max abs %.4g, against the CPU plain path (%.1f s) "
          "max_abs_err %.3g (%.3g of the largest; rtol %g)"
          % (RN_INFER_BATCH, np.median(times), np.mean(times), min(times),
             max(times), RN_INFER_BATCH / np.median(times) * 1e3,
             list(out.shape), top, time.perf_counter() - t0, err,
             err / top, RN_LOGITS_RTOL), flush=True)
    if out.shape != (RN_INFER_BATCH, RN_CLASSES) \
            or err > RN_LOGITS_RTOL * top or not np.isfinite(out).all():
        raise SystemExit("chip_smoke: the inference clone's logits disagree "
                         "with the CPU plain path")
    unchanged = all(np.array_equal(scope.get(n).cpu().numpy(), v)
                    for n, v in state.items())
    if not unchanged:
        raise SystemExit("chip_smoke: the test clone changed its state")
    return launches


class StepRecorder:
    """Stands in for a ProgramDecoder's step and keeps a copy, on the
    card, of the logits of the calls numbered in `keep` (all with None);
    counts the calls."""

    def __init__(self, decoder, keep=None):
        self.step = decoder._step
        self.keep = keep
        self.calls = 0
        self.logits = {}
        decoder._step = self

    def __call__(self, state, tok):
        logits, state = self.step(state, tok)
        if self.keep is None or self.calls in self.keep:
            self.logits[self.calls] = logits.clone()
        self.calls += 1
        return logits, state


def phase_decode():
    """Train the full-width transformer with Adam on the card (its first
    step against the CPU plain path), then generate from the scope it
    leaves through fluid.ProgramDecoder: cached greedy with a prefill,
    teacher-forced against the full forward; the sliding-window step,
    each step against the full forward's last position, the first two
    against the CPU plain path; beam (1 against greedy, 4 against the
    full forward's log-probabilities) and sampling.  Returns the launch
    counts of the sliding-window path, the one of the decode paths that
    runs the flash kernel."""
    import torch
    import torch.nn.functional as F
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import transformer_program as tp
    from paddle_tpu_torch.models.decode import prefill
    from paddle_tpu_torch.ops.registry import get_op_info

    arch = dict(n_layer=N_LAYER, n_head=N_HEAD, d_model=D_MODEL)
    d_head = D_MODEL // N_HEAD
    main, startup, loss, _ = tp.build_transformer_program(BATCH, SEQ, VOCAB,
                                                          **arch)
    fluid.Adam(ADAM_LR).minimize(loss, main, startup)
    block = main.block(0)
    persist = [n for n, v in block.vars.items() if v.persistable]
    params = [n for n in persist if n + "_moment1_0" in block.vars]
    exe = fluid.Executor()
    dev = exe.device
    if dev.type != "cuda":
        raise SystemExit("chip_smoke: the executor is not on the card")
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    init = {n: scope.get(n).cpu().numpy() for n in persist}
    feeds = [tp.transformer_feeds(BATCH, SEQ, VOCAB, seed=SEED + 10 + i,
                                  targets=True)
             for i in range(TRAIN_STEPS)]
    card, after1 = [], None
    t0 = time.perf_counter()
    for f in feeds:
        card.append(float(exe.run(main, feed=f, fetch_list=[loss],
                                  scope=scope)[0][0]))
        if after1 is None:
            after1 = {n: scope.get(n).cpu().numpy() for n in persist}
    print("decode: %d Adam steps (lr %g) on the card in %.2f s, losses %s"
          % (TRAIN_STEPS, ADAM_LR, time.perf_counter() - t0,
             ", ".join("%.6f" % x for x in card)), flush=True)
    (cpu_loss,), cpu1, cpu_s = run_from_state(
        fluid.Executor(fluid.CPUPlace()), main, loss, init, feeds[:1])
    errs = {"parameters": change_rl2(after1, cpu1, init, params),
            "moment1": change_rl2(after1, cpu1, init,
                                  [n + "_moment1_0" for n in params]),
            "moment2": change_rl2(after1, cpu1, init,
                                  [n + "_moment2_0" for n in params])}
    pows = max(abs(float(after1[n][0]) - float(cpu1[n][0]))
               for n in ("beta1_pow_acc_0", "beta2_pow_acc_0"))
    print("decode: Adam step 1 on the card against the CPU plain path "
          "(%.1f s): loss max_abs_err %.3g (atol %g); the step's change, "
          "relative L2 error: %s (parameters %g, moments %g); beta powers "
          "%.3g" % (cpu_s, abs(card[0] - cpu_loss), LOSS_ATOL,
                    ", ".join("%s %.3g" % kv for kv in errs.items()),
                    ADAM_PARAM_RL2, ADAM_MOMENT_RL2, pows), flush=True)
    if abs(card[0] - cpu_loss) > LOSS_ATOL \
            or errs["parameters"] > ADAM_PARAM_RL2 \
            or max(errs["moment1"], errs["moment2"]) > ADAM_MOMENT_RL2 \
            or pows > 1e-7 or not np.isfinite(card).all():
        raise SystemExit("chip_smoke: the Adam step on the card disagrees "
                         "with the CPU plain path")
    del init, after1, cpu1

    # the full forward: the training program's test clone, on the card
    fwd_main, _, _, fwd_logits = tp.build_transformer_program(
        BATCH, SEQ, VOCAB, **arch)
    fwd = fluid.Program.from_desc(fwd_main).clone(for_test=True)
    positions = np.tile(np.arange(SEQ, dtype=np.int64), (BATCH, 1))
    no_targets = np.zeros((BATCH, SEQ, 1), np.int64)

    def full_logits(tokens):
        return exe.run(fwd, feed={"tokens": tokens, "positions": positions,
                                  "targets": no_targets},
                       fetch_list=[fwd_logits], scope=scope,
                       return_numpy=False)[0]

    def cache_state(rows):
        st = {"pos": torch.zeros(rows, dtype=torch.int32, device=dev)}
        for i in range(N_LAYER):
            for kv in "kv":
                st["%s_cache_%d" % (kv, i)] = torch.zeros(
                    rows, N_HEAD, SEQ, d_head, device=dev)
        return st

    # cached greedy with a prefill, to the cache's extent
    cached, _, c_logits, pairs = tp.build_transformer_cached_step_program(
        BATCH, SEQ, VOCAB, **arch)
    cached = cached.clone(for_test=True)
    cdec = fluid.ProgramDecoder(cached, token_name="tok",
                                logits_name=c_logits.name,
                                state_pairs=pairs, scope=scope,
                                max_positions=SEQ)
    rs = np.random.RandomState(SEED + 20)
    prompt = rs.randint(0, VOCAB, (BATCH, PROMPT_LEN)).astype(np.int64)
    gen_len = SEQ - PROMPT_LEN + 1
    checked = (0, gen_len // 2, gen_len - 1)
    rec = StepRecorder(cdec, keep={PROMPT_LEN - 1 + t for t in checked})
    try:
        cdec.greedy(bos=0, eos=VOCAB + 1, max_len=gen_len + 1,
                    init_state=cache_state(BATCH), prompt=prompt)
    except ValueError as err:
        if "extent" not in str(err) or rec.calls:
            raise
        print("decode: max_len %d raised before any step: %s"
              % (gen_len + 1, err), flush=True)
    else:
        raise SystemExit("chip_smoke: decoding past the cache's extent "
                         "did not raise")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, lengths = cdec.greedy(bos=0, eos=VOCAB + 1, max_len=gen_len,
                                init_state=cache_state(BATCH),
                                prompt=prompt)
    greedy_s = time.perf_counter() - t0
    print("decode: cached greedy, batch %d, prompt %d, %d tokens in %.3f "
          "s (%d steps, %.3f ms per step with the result's one copy to the "
          "host)" % (BATCH, PROMPT_LEN, gen_len, greedy_s, rec.calls,
                     greedy_s / rec.calls * 1e3), flush=True)
    if toks.shape != (BATCH, gen_len) or (lengths != gen_len).any() \
            or rec.calls != SEQ:
        raise SystemExit("chip_smoke: cached greedy gave %s tokens in %d "
                         "steps" % (toks.shape, rec.calls))
    seq = np.concatenate([prompt, toks[:, :-1]], axis=1)
    logits = full_logits(seq)[:, PROMPT_LEN - 1:]
    dev_toks = torch.from_numpy(toks.astype(np.int64)).to(dev)
    gap = (logits.max(-1).values
           - logits.gather(-1, dev_toks[:, :, None])[..., 0]).max().item()
    step_errs = [(rec.logits[PROMPT_LEN - 1 + t] - logits[:, t])
                 .abs().max().item() for t in checked]
    print("decode: teacher-forced through the full forward: each generated "
          "token's logit within %.3g of its position's largest (atol %g); "
          "step logits at generated positions %s against the full "
          "forward's: max_abs_err %s (atol %g)"
          % (gap, ARGMAX_ATOL, list(checked),
             ", ".join("%.3g" % e for e in step_errs), LOGITS_ATOL),
          flush=True)
    if gap > ARGMAX_ATOL or max(step_errs) > LOGITS_ATOL:
        raise SystemExit("chip_smoke: cached greedy disagrees with the "
                         "full forward")
    del logits, rec, cdec._step   # the decoder's own step again

    # the cached step's latency: prefill, then steps each ending in a
    # synchronize, feeds and state on the card
    step = cdec._step
    dev_prompt = torch.from_numpy(prompt.astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        state, tok = prefill(step, cache_state(BATCH), dev_prompt)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    times = []
    with torch.inference_mode():
        for _ in range(64):
            t0 = time.perf_counter()
            logits_t, state = step(state, tok)
            tok = logits_t.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(times))
    print("decode: cached prefill %.3f ms for %d prompt tokens (%.3f ms per "
          "prompt token, batch %d); decode step %.3f ms per token (median "
          "of 64 at positions %d-%d; min %.3f, max %.3f), %.0f tokens/s at "
          "batch %d" % (prefill_ms, PROMPT_LEN, prefill_ms / PROMPT_LEN,
                        BATCH, med, PROMPT_LEN, PROMPT_LEN + 63, min(times),
                        max(times), BATCH / med * 1e3, BATCH), flush=True)
    weights = sum(4 * int(np.prod(v.shape))
                  for v in cached.desc.block(0).vars.values()
                  if v.is_parameter)

    def cache_bytes(p):   # K and V prefixes read, this token's rows written
        return 2 * N_LAYER * BATCH * N_HEAD * (p + 2) * d_head * 4

    for p in (PROMPT_LEN + 32, SEQ - 1):
        print("decode: cached step bound at position %d: weights %.1f MB + "
              "caches %.1f MB over %.2f TB/s = %.4f ms"
              % (p, weights / 1e6, cache_bytes(p) / 1e6,
                 HBM_BYTES_PER_S / 1e12,
                 (weights + cache_bytes(p)) / HBM_BYTES_PER_S * 1e3),
              flush=True)
    with torch.inference_mode():
        profile_step(lambda: step(state, tok),
                     {op.type for op in cached.desc.block(0).ops}, 0, med,
                     what="one cached decode step")
    del state

    # cached_attention alone at [16, 8, 512, 64], the last position
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, kn, vn = (torch.randn(BATCH, 1, D_MODEL, device=dev, generator=gen)
                 for _ in range(3))
    kc, vc = (torch.randn(BATCH, N_HEAD, SEQ, d_head, device=dev,
                          generator=gen) for _ in range(2))
    ins = {"Q": [q], "KNew": [kn], "VNew": [vn], "KCache": [kc],
           "VCache": [vc], "Position": [torch.tensor([SEQ - 1],
                                                     dtype=torch.int32,
                                                     device=dev)]}
    attrs = {"num_heads": N_HEAD}
    op = get_op_info("cached_attention").kernel
    with torch.inference_mode():
        out = op(None, ins, attrs)
        heads = [t.unflatten(-1, (N_HEAD, d_head)).transpose(1, 2)
                 for t in (q, kn, vn)]
        kc2, vc2 = kc.clone(), vc.clone()
        kc2[:, :, -1:], vc2[:, :, -1:] = heads[1], heads[2]
        ref = F.scaled_dot_product_attention(heads[0], kc2, vc2)
        err = max((out["Out"][0] - ref.transpose(1, 2).flatten(2))
                  .abs().max().item(),
                  (out["KCacheOut"][0] - kc2).abs().max().item())
        op_ms = device_ms(lambda: op(None, ins, attrs))
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            heads[0], kc2, vc2))
    nbytes = 4 * (3 * BATCH * D_MODEL + 4 * kc.numel() + BATCH * D_MODEL)
    print("decode: cached_attention at %s, position %d: %.4f ms per launch "
          "(device, CUDA graph replay), bound %.4f ms (bytes: q, k, v and "
          "both caches read, both caches and the output written), library "
          "scaled_dot_product_attention over the same cache %.4f ms; "
          "against it max_abs_err %.3g"
          % (list(kc.shape), SEQ - 1, op_ms,
             nbytes / HBM_BYTES_PER_S * 1e3, lib_ms, err), flush=True)
    if err > 1e-5:
        raise SystemExit("chip_smoke: cached_attention disagrees with "
                         "scaled_dot_product_attention")
    del q, kn, vn, kc, vc, kc2, vc2, ins, out, ref

    # the sliding-window step: one causal forward per token
    wprog, _, w_logits, new_window = tp.build_transformer_step_program(
        BATCH, SEQ, VOCAB, **arch)
    wprog = wprog.clone(for_test=True)
    wkw = dict(token_name="tok", logits_name=w_logits.name,
               state_pairs=[("window", new_window.name),
                            ("positions", "positions")], scope=scope)
    wdec = fluid.ProgramDecoder(wprog, **wkw)
    wseq = rs.randint(0, VOCAB, (BATCH, SEQ + 1)).astype(np.int64)
    wrec = StepRecorder(wdec)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wtoks, _ = wdec.greedy(bos=wseq[:, SEQ], eos=VOCAB + 1,
                           max_len=WINDOW_STEPS,
                           init_state={"window": wseq[:, :SEQ],
                                       "positions": positions})
    window_s = time.perf_counter() - t0
    # the main path ends here: read the counts
    launches = read_launches()
    print("decode: sliding-window greedy, batch %d, window %d, %d tokens in "
          "%.3f s (%.3f ms per token); launches %s"
          % (BATCH, SEQ, WINDOW_STEPS, window_s,
             window_s / WINDOW_STEPS * 1e3, json.dumps(launches)),
          flush=True)
    if launches["flash_attention_fwd"] != N_LAYER * WINDOW_STEPS:
        raise SystemExit("chip_smoke: %d flash launches in %d window steps, "
                         "designed %d per step"
                         % (launches["flash_attention_fwd"], WINDOW_STEPS,
                            N_LAYER))
    seq = np.concatenate([wseq, wtoks], axis=1)
    werrs = [(wrec.logits[s] - full_logits(seq[:, s + 1:s + 1 + SEQ])[:, -1])
             .abs().max().item() for s in range(WINDOW_STEPS)]
    cpu_dec = fluid.ProgramDecoder(wprog, place=fluid.CPUPlace(), **wkw)
    cpu_errs = []
    t0 = time.perf_counter()
    for s in range(2):
        win = torch.from_numpy(seq[:, s:s + SEQ].astype(np.int32))
        got, _ = cpu_dec._step({"window": win, "positions": torch.from_numpy(
            positions.astype(np.int32))}, torch.from_numpy(
                seq[:, s + SEQ].astype(np.int32)))
        cpu_errs.append((wrec.logits[s].cpu() - got).abs().max().item())
    print("decode: window step logits against the full forward's last "
          "position, max_abs_err %.3g over %d steps; steps 0-1 against the "
          "CPU plain path (%.1f s) %s (atol %g)"
          % (max(werrs), WINDOW_STEPS, time.perf_counter() - t0,
             ", ".join("%.3g" % e for e in cpu_errs), LOGITS_ATOL),
          flush=True)
    if max(werrs + cpu_errs) > LOGITS_ATOL:
        raise SystemExit("chip_smoke: the window step disagrees with the "
                         "full forward or the CPU plain path")
    del wrec, cpu_dec, wdec._step
    # the window step's latency, each step ending in a synchronize
    state = {"window": torch.from_numpy(wseq[:, :SEQ].astype(np.int32))
             .to(dev), "positions": torch.from_numpy(
                 positions.astype(np.int32)).to(dev)}
    tok = torch.from_numpy(wseq[:, SEQ].astype(np.int32)).to(dev)
    times = []
    with torch.inference_mode():
        for _ in range(10):
            t0 = time.perf_counter()
            logits_t, state = wdec._step(state, tok)
            tok = logits_t.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    print("decode: window step %.3f ms per token (median of 10; min %.3f, "
          "max %.3f), %.0f tokens/s at batch %d"
          % (np.median(times), min(times), max(times),
             BATCH / np.median(times) * 1e3, BATCH), flush=True)
    del state

    # beam: 1 is greedy; 4 at batch 4 fills the step's 16 rows
    greedy, _ = cdec.greedy(bos=1, eos=VOCAB + 1, max_len=BEAM_LEN,
                            init_state=cache_state(BATCH))
    seqs1, _ = cdec.beam(beam_size=1, bos=1, eos=VOCAB + 1,
                         max_len=BEAM_LEN, init_state=cache_state(BATCH))
    if not np.array_equal(seqs1[:, 0], greedy):
        raise SystemExit("chip_smoke: beam(1) differs from greedy")
    # a bos per row, so the rows search apart
    bos = np.arange(1, BEAM_BATCH + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seqs, scores = cdec.beam(beam_size=BEAM_SIZE, bos=bos, eos=VOCAB + 1,
                             max_len=BEAM_LEN,
                             init_state=cache_state(BEAM_BATCH))
    beam_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    best = np.concatenate([bos[:, None], seqs[:, 0, :-1]], axis=1)
    tokens = np.zeros((BATCH, SEQ), np.int64)
    tokens[:BEAM_BATCH, :BEAM_LEN] = best
    logp = torch.log_softmax(
        full_logits(tokens)[:BEAM_BATCH, :BEAM_LEN].double(), dim=-1)
    want = logp.gather(-1, torch.from_numpy(seqs[:, 0]).to(dev)
                       .long()[:, :, None])[..., 0].sum(-1).cpu().numpy()
    score_err = float(np.abs(scores[:, 0] - want).max())
    print("decode: beam %d at batch %d (%d rows), %d steps in %.3f s (%.3f "
          "ms per step), peak memory %.3f GB; best scores %s, against their "
          "log-probabilities through the full forward max_abs_err %.3g "
          "(atol %g); beam(1) equals greedy"
          % (BEAM_SIZE, BEAM_BATCH, BEAM_BATCH * BEAM_SIZE, BEAM_LEN,
             beam_s, beam_s / BEAM_LEN * 1e3, peak / 1e9,
             ", ".join("%.4f" % x for x in scores[:, 0]), score_err,
             BEAM_SCORE_ATOL), flush=True)
    if seqs.shape != (BEAM_BATCH, BEAM_SIZE, BEAM_LEN) \
            or not np.isfinite(scores).all() \
            or (np.diff(scores, axis=1) > 0).any() \
            or score_err > BEAM_SCORE_ATOL:
        raise SystemExit("chip_smoke: beam search is not best first or its "
                         "scores disagree with the full forward")

    # sampling: the limits that are greedy, and a seed that repeats
    kw = dict(bos=1, eos=VOCAB + 1, max_len=BEAM_LEN)
    cold, _ = cdec.sample(init_state=cache_state(BATCH), temperature=1e-5,
                          **kw)
    top1, _ = cdec.sample(init_state=cache_state(BATCH), top_k=1, **kw)
    a, _ = cdec.sample(init_state=cache_state(BATCH), seed=5, **kw)
    b, _ = cdec.sample(init_state=cache_state(BATCH), seed=5, **kw)
    print("decode: sampling: temperature 1e-5 equals greedy %s, top_k=1 "
          "equals greedy %s, seed 5 twice equal %s (%d of %d tokens differ "
          "from greedy at temperature 1)"
          % (np.array_equal(cold, greedy), np.array_equal(top1, greedy),
             np.array_equal(a, b), int((a != greedy).sum()), a.size),
          flush=True)
    if not (np.array_equal(cold, greedy) and np.array_equal(top1, greedy)
            and np.array_equal(a, b)):
        raise SystemExit("chip_smoke: sampling broke its limits")

    # no step waits for the device: the decode loops and the window step
    # run with CUDA's synchronizing calls turned into errors (a decoder's
    # one sync is the copy of its result to the host, after the loop)
    from paddle_tpu_torch.models.decode import (beam_search_decode_dense,
                                                greedy_decode, sample_decode)

    with torch.inference_mode():
        states = [cache_state(BATCH), cache_state(BATCH),
                  cache_state(BEAM_BATCH)]
        bos = torch.ones(BATCH, dtype=torch.int32, device=dev)
        wstate = {"window": torch.from_numpy(wseq[:, :SEQ].astype(np.int32))
                  .to(dev), "positions": torch.from_numpy(
                      positions.astype(np.int32)).to(dev)}
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            greedy_decode(step, states[0], bos=bos, eos=VOCAB + 1,
                          max_len=8, batch_size=BATCH, device=dev)
            sample_decode(step, states[1], bos=bos, eos=VOCAB + 1,
                          max_len=8, batch_size=BATCH, generator=gen,
                          top_k=5, device=dev)
            beam_search_decode_dense(
                step, states[2], bos=bos[:BEAM_BATCH], eos=VOCAB + 1,
                beam_size=BEAM_SIZE, max_len=8, batch_size=BEAM_BATCH,
                device=dev)
            for _ in range(2):
                _, wstate = wdec._step(wstate, bos)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    print("decode: no synchronizing call in 8 steps each of greedy, "
          "sampling (top_k 5) and beam over the cached step, nor in 2 "
          "window steps", flush=True)
    return launches


def phase_image():
    """bench.py's other image models and the image-classification
    example, through the port's fluid layers.  Returns the launch counts
    of the batch-128 steps (no hand-written kernel runs on this path)."""
    import random

    import torch
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import models
    from paddle_tpu_torch.fluid.checkpoint import (CheckpointSaver,
                                                   load_checkpoint)
    from paddle_tpu_torch.reader import device_prefetch
    from paddle_tpu_torch.resilience import faults

    exe = fluid.Executor()
    if exe.device.type != "cuda":
        raise SystemExit("chip_smoke: the executor is not on the card")
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    counts = collections.Counter()

    # alexnet and vgg16 at bench.py's training shape, f32, TF32 off
    for name in IMG_MODELS:
        t0 = time.perf_counter()
        main, startup, _, loss = build_model(getattr(models, name),
                                             RN_BATCH, RN_HW, RN_CLASSES)
        block = main.desc.block(0)
        op_types = {op.type for op in block.ops}
        n_values = sum(int(np.prod(v.shape)) for v in block.vars.values()
                       if v.is_parameter)
        flops = forward_flops(block)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        print("image %s: main %d ops of %d types, %.2f M parameter values, "
              "forward %.2f GFLOP per image; built and initialised on the "
              "card in %.1f s"
              % (name, len(block.ops), len(op_types), n_values / 1e6,
                 flops / RN_BATCH / 1e9, time.perf_counter() - t0),
              flush=True)
        dev_feeds = [{n: torch.from_numpy(v).to(exe.device)
                      for n, v in f.items()}
                     for f in resnet_feeds(RN_BATCH, TRAIN_STEPS, SEED + 30)]
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)[0][0]) for f in dev_feeds]
        seconds = time.perf_counter() - t0
        got = read_launches()
        counts.update(got)
        peak = torch.cuda.max_memory_allocated()
        print("image %s: %d steps at batch %d in %.2f s, losses %s; peak "
              "memory %.3f GB; hand-written kernel launches %s"
              % (name, TRAIN_STEPS, RN_BATCH, seconds,
                 ", ".join("%.6f" % x for x in losses), peak / 1e9,
                 json.dumps(got)), flush=True)
        # from this initialisation at lr 0.01 vgg16 diverges within 3
        # steps (it does on the CPU plain path too, 8.65, 1029, 8.0e9 at
        # batch 2): the first loss is gated, the step's correctness at
        # batch 8 below
        if not np.isfinite(losses[0]):
            raise SystemExit("chip_smoke: %s's first loss is not finite"
                             % name)

        def step():
            return exe.run(main, feed=dev_feeds[0], fetch_list=[loss],
                           scope=scope, return_numpy=False)

        times = timed_steps(step)
        med = float(np.median(times))
        print("image %s: step %.3f ms (median of 10 after 2 warm; mean "
              "%.3f, min %.3f, max %.3f), %.1f images/s, %.1f TFLOP/s of "
              "forward and backward products"
              % (name, med, np.mean(times), min(times), max(times),
                 RN_BATCH / med * 1e3, 3 * flops / med / 1e9), flush=True)
        profile_step(step, op_types, 0, med)
        del scope, dev_feeds
        torch.cuda.empty_cache()

    # card against the CPU plain path at batch 8: one step from the same
    # state (vgg16 at its default drop_rate 0 and smallnet draw no random
    # numbers)
    for name, hw, classes in (("vgg16", RN_HW, RN_CLASSES),
                              ("smallnet_mnist_cifar", 32, 10)):
        main, startup, _, loss = build_model(getattr(models, name),
                                             IMG_CHECK_BATCH, hw, classes)
        block = main.desc.block(0)
        persist = [n for n, v in block.vars.items() if v.persistable]
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        init = {n: scope.get(n).cpu().numpy() for n in persist}
        del scope
        groups = {"parameters": [n for n, v in block.vars.items()
                                 if v.is_parameter],
                  "velocities": [n for n in persist
                                 if n.endswith("_velocity_0")]}
        feed = image_feeds(IMG_CHECK_BATCH, 1, SEED + 31, hw, classes)
        (cpu_loss,), cpu_state, cpu_s = run_from_state(cpu_exe, main, loss,
                                                       init, feed)
        (card_loss,), card_state, _ = run_from_state(exe, main, loss, init,
                                                     feed)
        errs = {g: change_rl2(card_state, cpu_state, init, names)
                for g, names in groups.items()}
        print("image %s: one step at batch %d on the card against the CPU "
              "plain path (%.1f s) from the same state: loss %.6f, "
              "max_abs_err %.3g (atol %g); the step's change, relative L2 "
              "error: %s (%g)"
              % (name, IMG_CHECK_BATCH, cpu_s, card_loss,
                 abs(card_loss - cpu_loss), IMG_LOSS_ATOL,
                 ", ".join("%s %.3g" % kv for kv in errs.items()),
                 IMG_CHANGE_RL2), flush=True)
        if abs(card_loss - cpu_loss) > IMG_LOSS_ATOL \
                or max(errs.values()) > IMG_CHANGE_RL2 \
                or not all(np.isfinite(v).all()
                           for v in card_state.values()):
            raise SystemExit("chip_smoke: %s's step on the card disagrees "
                             "with the CPU plain path" % name)
        del init, cpu_state, card_state

    # alexnet at batch 8: its dropout masks differ between devices, so
    # the gates are their keep rate and the is_test clone's logits
    main, startup, _, loss = build_model(models.alexnet, IMG_CHECK_BATCH,
                                         RN_HW, RN_CLASSES)
    masks = [op.output("Mask")[0] for op in main.desc.block(0).ops
             if op.type == "dropout"]
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    persist = [n for n, v in main.desc.block(0).vars.items()
               if v.persistable]
    init = {n: scope.get(n).cpu().numpy() for n in persist}
    feed = image_feeds(IMG_CHECK_BATCH, 1, SEED + 32, RN_HW, RN_CLASSES)[0]
    outs = exe.run(main, feed=feed, fetch_list=[loss] + masks, scope=scope)
    rates = [float(m.mean()) for m in outs[1:]]
    se = (0.25 / outs[1].size) ** 0.5
    fwd, _, logits, _ = build_model(models.alexnet, IMG_CHECK_BATCH, RN_HW,
                                    RN_CLASSES, train=False)
    infer = fwd.clone(for_test=True)
    state = {n: v for n, v in init.items() if n in infer.desc.block(0).vars}
    got = fluid.Executor().run(infer, feed={"image": feed["image"]},
                               fetch_list=[logits],
                               scope=params_scope(state, exe.device))[0]
    ref = cpu_exe.run(infer, feed={"image": feed["image"]},
                      fetch_list=[logits],
                      scope=params_scope(state, "cpu"))[0]
    err, top = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    print("image alexnet: one step at batch %d on the card: loss %.6f; "
          "dropout keep rates %s (p 0.5, %d values each: 5 standard errors "
          "%.4f); the is_test clone's logits against the CPU plain path "
          "max_abs_err %.3g of max %.4g (%.3g; rtol %g)"
          % (IMG_CHECK_BATCH, float(outs[0][0]),
             ", ".join("%.4f" % r for r in rates), outs[1].size, 5 * se,
             err, top, err / top, IMG_LOGITS_RTOL), flush=True)
    if len(rates) != 2 or any(abs(r - 0.5) > 5 * se for r in rates) \
            or np.array_equal(outs[1], outs[2]) \
            or err > IMG_LOGITS_RTOL * top or not np.isfinite(got).all():
        raise SystemExit("chip_smoke: alexnet's dropout or test clone "
                         "disagrees")
    del scope, init, state

    # the example's flow: examples/train_image_classification.py's smallnet
    # on synthetic CIFAR-10 under bf16 AMP, fed by DataFeeder through
    # batch(shuffle(...)) and device_prefetch, with layers.accuracy;
    # a checkpoint after step EX_SAVE_AT restored into a fresh scope and
    # executor, and a snapshot torn by a fault
    main, startup = fluid.Program(), fluid.Program()
    with fluid.amp.bf16_guard(), fluid.program_guard(main, startup):
        image = fluid.layers.data(name="image", shape=[3, 32, 32],
                                  dtype="float32")
        out = models.smallnet_mnist_cifar(image, class_dim=10)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss = fluid.layers.mean(x=fluid.layers.softmax_with_cross_entropy(
            logits=out, label=label))
        acc = fluid.layers.accuracy(input=fluid.layers.softmax(out),
                                    label=label)
        fluid.optimizer.MomentumOptimizer(
            learning_rate=LR, momentum=MOMENTUM).minimize(loss)
    op_types = {op.type for op in main.desc.block(0).ops}
    place = fluid.CUDAPlace(0)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feeder = fluid.DataFeeder(place=place, feed_list=[image, label],
                              program=main)
    random.seed(SEED)
    train_reader = paddle.batch(paddle.reader.shuffle(
        paddle.dataset.cifar.train10(), buf_size=2048), batch_size=EX_BATCH)
    feeds = device_prefetch(lambda: (feeder.feed(d) for d in train_reader()),
                            place=place)
    with tempfile.TemporaryDirectory() as root:
        saver = CheckpointSaver(root, main_program=main)
        fetched, times, kept = [], [], None
        with fluid.amp.bf16_guard():
            t_loop = time.perf_counter()
            t0 = t_loop
            for feed in feeds():
                fetched.append(exe.run(main, feed=feed,
                                       fetch_list=[loss, acc], scope=scope))
                times.append((time.perf_counter() - t0) * 1e3)
                if len(fetched) == EX_SAVE_AT:
                    saver.save(EX_SAVE_AT, scope)
                    saver.wait()
                elif len(fetched) == EX_SAVE_AT + 1:
                    kept = feed
                t0 = time.perf_counter()
            loop_s = time.perf_counter() - t_loop
        steps = len(fetched)
        losses = [float(f[0][0]) for f in fetched]
        accs = [float(f[1][0]) for f in fetched]
        med = float(np.median(times))
        print("example: %d steps of batch %d (one pass of the synthetic "
              "CIFAR-10 reader) in %.2f s: step %.3f ms (median, host clock "
              "from one fetched result to the next, feeding included; min "
              "%.3f, max %.3f), %.1f images/s; losses %.4f -> %.4f, "
              "accuracy %.3f -> %.3f"
              % (steps, EX_BATCH, loop_s, med, min(times), max(times),
                 EX_BATCH / med * 1e3, losses[0], losses[-1], accs[0],
                 accs[-1]), flush=True)
        if kept is None or not np.isfinite(losses).all() \
                or not all(0.0 <= a <= 1.0 for a in accs) \
                or kept["image"].device != exe.device:
            raise SystemExit("chip_smoke: the example's training loop "
                             "failed")
        exe2, scope2 = fluid.Executor(place), fluid.Scope()
        exe2.run(startup, scope=scope2)
        step = load_checkpoint(root, scope2)
        with fluid.amp.bf16_guard():
            resumed = exe2.run(main, feed=kept, fetch_list=[loss, acc],
                               scope=scope2)
        loss_err = abs(float(resumed[0][0]) - losses[EX_SAVE_AT])
        print("example: resumed from the step-%d checkpoint in a fresh "
              "scope and executor: step %d loss %.6f, accuracy %.4f; the "
              "run that was not interrupted: %.6f, %.4f (loss atol %g, "
              "accuracy equal)"
              % (step, EX_SAVE_AT + 1, float(resumed[0][0]),
                 float(resumed[1][0]), losses[EX_SAVE_AT],
                 accs[EX_SAVE_AT], EX_RESUME_ATOL), flush=True)
        if step != EX_SAVE_AT or loss_err > EX_RESUME_ATOL \
                or float(resumed[1][0]) != accs[EX_SAVE_AT]:
            raise SystemExit("chip_smoke: the resumed step disagrees with "
                             "the uninterrupted run")
        # a later snapshot torn before its manifest: loading skips it
        faults.enable(seed=SEED)
        try:
            spec = faults.inject("checkpoint/manifest", "io_error",
                                 times=None)
            saver.save(steps, scope)
            try:
                saver.wait()
                raise SystemExit("chip_smoke: the injected fault did not "
                                 "fail the snapshot")
            except faults.InjectedIOError:
                pass
        finally:
            faults.disable()
        snaps = sorted(os.listdir(root))
        step = load_checkpoint(root, fluid.Scope())
        print("example: snapshot %d torn by %d injected faults before its "
              "manifest (snapshots %s): load_checkpoint restored step %d"
              % (steps, spec.fired, snaps, step), flush=True)
        if step != EX_SAVE_AT or len(snaps) != 2:
            raise SystemExit("chip_smoke: the torn snapshot was not skipped")

    def one_step():
        with fluid.amp.bf16_guard():
            return exe.run(main, feed=kept, fetch_list=[loss], scope=scope,
                           return_numpy=False)

    times = timed_steps(one_step)
    med = float(np.median(times))
    print("example: one step with its feed on the card %.3f ms (median of 10 "
          "after 2 warm; min %.3f, max %.3f), %.1f images/s"
          % (med, min(times), max(times), EX_BATCH / med * 1e3), flush=True)
    profile_step(one_step, op_types, 0, med)
    return dict(counts)


def params_scope(arrays, device):
    """A fresh Scope holding `arrays` ({name: ndarray}) on `device`."""
    from paddle_tpu_torch.fluid import Scope, io

    scope = Scope()
    io.params_from_numpy(scope, arrays, device)
    return scope


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    measured = phase_kernels()
    launches = phase_slice()
    train_launches = phase_train()
    wide_launches = phase_wide()
    resnet_launches = phase_resnet()
    decode_launches = phase_decode()
    image_launches = phase_image()
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels._build import SOURCES

    # ResNet-50 and the image models run no hand-written kernel: conv2d
    # is cuDNN and the rest ATen, as the JAX package leaves them to XLA
    for what, got in (("ResNet-50", resnet_launches),
                      ("the image models", image_launches)):
        if any(got.values()):
            raise SystemExit("chip_smoke: %s launched %s"
                             % (what, json.dumps(got)))
    # the f32 route on each of the transformer's main paths
    f32 = route_entry("f32")
    paths = (launches[f32], train_launches[f32], decode_launches[f32])
    if min(paths) < 1:
        raise SystemExit("chip_smoke: the f32 route was never launched on "
                         "a main path (served, trained, decoded: %s)"
                         % (paths,))
    kernels = []
    for route in fa.ROUTES:
        name = route_entry(route)
        total = sum(c.get(name, 0) for c in (
            launches, train_launches, wide_launches, resnet_launches,
            decode_launches, image_launches))
        if total < 1:
            raise SystemExit("chip_smoke: %s was never launched on a main "
                             "path" % name)
        # the TPU kernel it ports: file:line of the Pallas kernel body
        kernels.append(dict({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/"
                      + SOURCES["flash_attention_fwd"],
            "replaces": "paddle_tpu/kernels/flash_attention.py:27",
            "launches": total}, **measured[name]))
    print(json.dumps({"kernels": kernels}))
    print("chip_smoke: all phases passed in %.1f s"
          % (time.perf_counter() - t_start))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
