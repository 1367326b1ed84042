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
  9. sequence: bench.py's stacked-LSTM classifier (BENCH_MODEL=lstm:
     dict 10,000, embedding 128, hidden 256, 2 layers with peepholes,
     Adam at lr 1e-3) built through the port's layers as bench.py's
     `_build_lstm` builds it, its op count, op types and parameter
     count.  At batch 8 with lengths 1..100 from the seed, padded to a
     64-row bucket: 3 steps on the CPU plain path, each again on the
     card from the CPU's state before it (loss, the step's change of the
     parameters and both moments gated).  At bench.py's 128 sequences of
     100 ids (128 recurrence steps), f32 and bf16 AMP from the same
     state: 3 steps with their peak memory, the step's time (median of
     10 after 2 warm, feeds on the card), samples/s and a profiled step;
     the AMP losses against the f32 ones.  The lstm op alone at that
     shape (forward and generic grad, device time by graph replay, and
     eager) beside its bound and cuDNN's LSTM (a different function: no
     peepholes).  One forward with CUDA's synchronizing calls made
     errors.  The inference export, loaded by InferenceEngine on the card
     and served by InferenceServer: 3 concurrent POST /v1/infer of 1, 2
     and 3 sequences of different lengths, then one engine.run of 16,
     against the CPU plain path.  No hand-written kernel runs here.
  10. ctr: examples/ctr_deepfm_sparse.py's local loop at its defaults
     (DeepFM over 10,000 features in 16 fields, embedding 16, hidden
     (128, 64), both tables `is_sparse`, Adam at lr 1e-2, batch 256)
     built through the port: exactly two SELECTED_ROWS grads; 3 Adam
     steps on the card against the CPU plain path from one state (loss,
     and the steps' change of the parameters and both moments); 60 Adam
     steps on one batch below 0.7 of the first loss (the JAX test's
     criterion); the example's 60 steps over its reader through
     DataFeeder and device_prefetch, the loss every 10; one SGD and one
     Adagrad step, each from a fresh state, that leave every row the
     batch did not touch bit-for-bit unchanged and change every touched
     one; the export served by InferenceEngine and InferenceServer (3
     concurrent requests of 1, 5 and 32 rows) against the CPU plain
     path.  Then under Adam, SGD and Adagrad at 10,000 and 10,000,000
     features: the step's time, samples/s, peak memory, a profiled step
     and the update ops' device time beside their bound by bytes; at
     10,000,000 the update op alone on the 640 MB table (and, for SGD,
     the in-place `index_add_` that a donated buffer would allow).  No
     hand-written kernel runs here.
  11. seq2seq: tests/test_machine_translation.py's book program
     (models/text.py seq2seq: an LSTM encoder, a DynamicRNN decoder
     whose step block runs the 30,000-wide projection and softmax once
     per step, through the `recurrent` op) at dict 30,000, embedding 32,
     hidden 32, Adam at lr 0.02: its 2 blocks, 42 + 8 ops and 2,920,624
     parameter values; 3 Adam steps at batch 8 over the wmt14 reader's
     first batches (DataFeeder, three ragged slots) on the card against
     the CPU plain path from one state (loss, each tensor's change in
     relative L2); the JAX test's loop on the card (dict 1,000, batch
     8, 60 steps) from 5 initial states: its criterion printed for each,
     and the gate, the first 6 batches' loss after the steps below the
     losses recorded on them on average; one step run twice from one
     state without torch's deterministic algorithms, whose grads and
     state must repeat bit for bit; one training step with CUDA's synchronizing calls made errors; the
     export of `prob` served by InferenceEngine and InferenceServer (3
     concurrent requests of 1, 2 and 3 sentence pairs, then 8 pairs in
     one engine.run) against the CPU plain path; at batch 8 and 128 the
     step's time, target tokens/s, peak memory and a profiled step; the
     `recurrent` op alone at batch 128 (forward and generic grad,
     device time by graph replay, and eager) beside its bound and
     cuDNN's RNN (a different function).  No hand-written kernel runs
     here.
  12. book: the Fluid book's chapters of the sequence-op slice.  Each of
     the 15 op types it added (cos_sim, sequence_conv, linear_chain_crf,
     crf_decoding with and without Label, chunk_eval, sequence_softmax,
     row_conv, sequence_expand, sequence_concat, sequence_reshape,
     sequence_slice, sequence_reverse, lod_reset, gru, gru_unit) on the
     card against its CPU run on seeded ragged inputs with an empty and
     a length-1 sequence, forward and generic grad, and whether each
     grad repeats bit for bit (reported).  The main path: the sentiment
     chapter's conv model (tests/test_understand_sentiment.py,
     models/text.py conv_text_classifier at its own widths: embedding
     128, hidden 128, filters 3 and 4, the 5,147-word imdb dictionary, 2
     classes, Adam at lr 0.05; 774,274 parameter values): 3 steps at
     batch 16 on the card against the CPU plain path from one state,
     one step run twice (grads and state bit for bit), at batch 128 and
     16 one pass over the imdb reader through DataFeeder,
     device_prefetch and Executor.run (peak memory of 3 steps), the
     step's median, samples/s and a profiled step, and the export
     served by InferenceEngine and InferenceServer (3 concurrent
     requests of 1, 2 and 3 sequences) against the CPU plain path.
     Then the SRL (two LSTMs, linear_chain_crf and crf_decoding sharing
     `crfw`, SGD) at batch 8 and 128, word2vec at 64, the recommender
     at 64 and fit-a-line at 20, as their JAX tests build them: 3 steps
     on the card against the CPU from one state, the SRL's Viterbi paths
     and chunk_eval over them equal, and each step's time.  Last, the
     device times of sequence_conv (beside F.conv1d over the
     zero-padded batch), linear_chain_crf and its grad, crf_decoding,
     and gru and its grad (beside cuDNN's GRU, a different function),
     each beside its bound.  No hand-written kernel runs here.
  13. ctc: loops, conditionals, tensor arrays, rank tables and CTC.
     (a) At the JAX tests' sizes, on the card against the port's plain
     CPU path: a bounded While (a masked loop carrying a tensor, a
     counter, its condition and a TensorArray) and its generic grad, the
     same loop unbounded (a host read a step), IfElse routing rows,
     split_lod_tensor and merge_lod_tensor of a ragged value, and the
     rank-table round trip and reorder, flat and lod-level-2; exact where
     the output is an integer or a permutation, else at CTC_LOOP_ATOL.
     The bounded while op's device time.  (b) tests/test_ctc_training.py's
     flow (its program, seed and data): the first step against the CPU
     plain path, 200 SGD steps to its criterion, the greedy decode equal
     to the targets.  (c) CRNN-CTC (PaddlePaddle/models
     fluid/ocr_recognition crnn_ctc_model.py) at its own widths, batch
     32 of 1 x 48 x 512 images, every parameter with ctc_train.py's L2
     decay and value clip: its op count, op types and parameter
     count; 2 Momentum steps on the card against the CPU plain path from
     one state (the loss, and the change of the parameters, velocities
     and batch-norm statistics); peak memory over 3 steps; one training
     step with CUDA's synchronizing calls made errors; the step's median
     of 10 after 2 warm (feeds on the card), images/s, labels/s and a
     profiled step; one step run twice from one state without torch's
     deterministic algorithms: every grad bit for bit, warpctc's logits',
     the GRUs', the fcs' and the 32 of the convolutions and batch norms
     (conv2d and its grad run under deterministic cuDNN algorithms, the
     op's registration; the step's median is also timed with them
     free); the greedy decode and edit distance on the card equal to
     the CPU's; the export (image -> ids) served to 3
     concurrent requests, the ids equal to the card engine's and the
     CPU's.  (d) warpctc alone at CRNN's shape (B 32, T 32, C 96),
     forward and generic grad, beside F.ctc_loss over log_softmax and
     the bound by bytes.  No hand-written kernel runs here.
  14. v2: the v2 API (`paddle_tpu_torch.v2`) and the book's attention
     NMT.  (a) The nested-sequence ops (seq_unnest, seq_outer_expand and
     its grad, seq_renest), print, the ragged inputs of concat,
     increment, reduce_*, dropout (and its grad) and accuracy, sign,
     beam_search and beam_search_decode on the card against the CPU
     plain path: exact, sums and means within V2_OP_RTOL.  (b)
     tests/test_v2_api.py's fit-a-line through v2.trainer.SGD on the
     card (12 passes; the cost must fall), test() and infer().  (c) The
     Paddle book's machine_translation `seq_to_seq_net` (BASELINE.json
     configs[3], `build_nmt`) at its widths (dictionaries of 30,000, 512
     wide, Adam at 5e-5 with L2 8e-4), batch 64 of the wmt14 reader: 2
     steps through SGD.train on the card against the same 2 on the CPU
     plain path from one state (loss, each group's change in relative
     L2), one step run twice (every grad and Adam moment bit for bit),
     peak memory, the step's median, target tokens/s, the synchronizing
     calls of a step and where they are, a profiled step.  (d) Beam 3 to
     at most 250 tokens over 4 sentences through v2.infer on a
     generation topology, from `nmt_decode_state`, on the card and the
     CPU: ids equal, scores within NMT_SCORE_ATOL, ms per generated
     token and the steps run.  (e) The nested SubsequenceInput groups of
     tests/test_v2_recurrent.py:281-380 on the card against the CPU.
     No hand-written kernel runs here.
  15. stack: the rest of the optimizer and layer stack.  (a) Each case
     of `stack_op_cases` (the slice's 43 op types besides fused_update:
     the activations at their ties, matmul transposed, batched and 1-D,
     gather, scatter and multiplex with negative, repeated and
     out-of-range ids, one_hot's zero rows, soft labels, smooth_l1 at its
     bound, ...) on the card against the CPU plain path, forward and
     grad: bit for bit where the op only moves or makes values, else
     within STACK_OP_RTOL; gather's grad twice on the card bit for bit;
     fused_update against the unfused Adam, Momentum and SGD, dense and
     with a SelectedRows grad, bit for bit.  (b)
     nets.scaled_dot_product_attention at [16, 512, 512] with 8 heads:
     the dense route (matmul, softmax) against use_flash (the f32 route
     of the flash kernel, launched at least once), and the dense route's
     forward and grads on the card against the CPU.  (c) The transformer
     at bench.py's width trained as its users train it (`build_stack`:
     label smoothing 0.1 through one_hot and soft labels, one
     GradientClipByGlobalNorm(1.0) on every parameter,
     piecewise_decay([2, 4], [1e-3, 5e-4, 2.5e-4]), Adam with fused
     updates at the default cap): its op count and types; 2 steps on
     the card against the CPU plain path from one state (the loss, the
     global norm, the learning rate, each group's change), with 12
     flash launches a step counted from 0 just before, whether the clip
     bound (if not, one step at half the first norm, gated the same);
     one step fused and one unfused from one state, bit for bit; the
     repeat gate; peak memory, and fused and unfused each: the step's
     median, tokens/s, launches a step and the busy share of a profiled
     step.
  16. obs: numerics health, the flight recorder, the profiler, request
     tracing and the NHWC relayout.  (a) isfinite and count_nonfinite in
     f32, bf16 and f16 on 2^20 + 7 values with NaN, +Inf and -Inf planted
     at seeded places, equal to the CPU plain path exactly; the served
     transformer's forward with an Inf planted in layer 1's q/k/v weight
     under FLAGS_check_nan_inf raises the same NonfiniteError (op type,
     index, slot, var, count) on the card and the CPU.  (b) The
     transformer at bench.py's width under bf16_guard() with Adam,
     obs.health.NumericsMonitor.for_train_program and a LossScaler, 3
     steps, the bf16 flash route 12 times a step counted from 0 just
     before; the first step again on the CPU plain path from the same
     state (nonfinite counts, the grad global norm within
     OBS_NORM_RTOL, the cost's max-abs within OBS_AMP_LOSS_ATOL, the
     scale); the step's median with the monitor and without it, with
     fluid.profiler's table and with FLAGS_check_nan_inf, the launches
     and the bf16 flash route's device ms of a profiled step; then an Inf
     planted in a weight: locate_nonfinite names the CPU's op, the scope
     is bit for bit as before the replay, and the step finds it and
     halves the loss scale (the amp_loss_scale gauge reads 2^14).  (c)
     The flight recorder around (b)'s steps, the obs trace on: a feed of
     the wrong shape leaves a bundle with the step records, the feeds'
     shapes and dtypes, the exception and the span tail; record_step's
     cost a step.  (d) obs.health.enable() and obs.flight.install()
     around 2 steps of phase 14's NMT at batch 16 through v2's
     step_runner, on the card and the CPU from one state: the trainer
     installs the monitor, whose norms agree.  (e) Phase 3's transformer
     exported with its logits' top 2 per position, served with the SLO,
     the tail recorder, the access log, Retry-After 2 and check_numerics:
     64 requests of one row from 4 threads, each with a traceparent,
     against the same server without them (p50, p99, the answers); every
     reply echoes its trace id, the access log has the 64 lines, the
     tail holds exactly the requests at or above tail_slow_ms, /healthz
     has the SLO section and no nonfinite output, a burst past the queue
     with the engine held gets 429 with Retry-After: 2.  (f) ResNet-50 at
     bench.py's width under bf16 AMP, converted by fluid.convert_layout
     before minimize, against NCHW from one state: 2 Momentum steps
     each, the first loss and the first step's change gated, step ms,
     launches and cuDNN's layout-transposing kernels' device ms in each.
The kernels line lists each route of the flash kernel with its launches
over every main path, and the numbers of its first case in phase 3.
The last line is {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the paddle_tpu package.  The
whole script prints its time on the line before the card's.
"""

import collections
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
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

# phase 9, sequence: bench.py's BENCH_MODEL=lstm (bench.py:106-132): the
# stacked-LSTM classifier at dict 10,000, embedding 128, hidden 256 (the
# lstm op's size 1024), 2 layers, 2 classes, peepholes, Adam at lr 1e-3,
# fed 128 sequences of 100 ids (max_seqlen 100 buckets to 128 steps)
SEQ_DICT, SEQ_EMB, SEQ_HID, SEQ_CLASSES = 10000, 128, 256, 2
SEQ_BATCH, SEQ_LEN = 128, 100
SEQ_CHECK_BATCH = 8        # the card-against-CPU check, lengths 1..100
SEQ_SERVE = 16             # one engine.run of 16 sequences
SEQ_BUCKETS = [1, 2, 4, 8, 16]
# the card against the CPU at batch 8: f32 on both sides, TF32 off, sums
# in other orders through 2 recurrences of up to 100 steps.  An H100
# read the loss (about ln 2 = 0.69) within 5.96e-8, and the step's
# change in relative L2 within 3.77e-6 (parameters) and 4.45e-7
# (moments): no entry's grad lies near enough to 0 for the card and the
# CPU to step it apart (phase 7's Adam reasoning).  The gates are 17
# and 26-225 times those readings.  By estimate (Adam's first step
# moves each entry that has a grad by about lr; about 2 M entries have
# one), a step that leaves only the 2-entry output bias unchanged reads
# about 1e-3 in the parameters, 10 times their gate
SEQ_LOSS_ATOL = 1e-6
SEQ_STATE_RL2 = 1e-4
# bf16 AMP against f32 from the same state at 128 x 100, 3 steps: bf16
# products and inputs (a rounding of 2^-9 each) through 2 recurrences
# of 128 steps.  An H100 read 2.72e-4; the gate is 18 times that.  What
# a wrong policy reads was not measured
SEQ_AMP_LOSS_ATOL = 5e-3
# served probabilities (2 classes) against the CPU plain path, f32
SEQ_PROB_ATOL = 1e-4

# phase 10, ctr: examples/ctr_deepfm_sparse.py's local loop at its
# defaults (DeepFM over 10,000 features in 16 fields, embedding 16,
# hidden (128, 64), both tables is_sparse, mean sigmoid cross entropy,
# Adam at lr 1e-2, batch 256, 60 steps of its synthetic reader from seed
# 0), and the same model timed at 10,000,000 features (a Criteo-scale
# hashed table: 640 MB for the second-order table in f32)
CTR_FEATURES, CTR_FIELDS, CTR_EMBED = 10000, 16, 16
CTR_HIDDEN = (128, 64)
CTR_BATCH, CTR_STEPS, CTR_LR = 256, 60, 1e-2
CTR_BIG_FEATURES = 10_000_000
CTR_TIMED = ("Adam", "SGD", "Adagrad")
CTR_SERVE = (1, 5, 32)          # rows of the 3 concurrent requests
CTR_BUCKETS = [1, 8, 32]
CTR_CONVERGE = 0.7              # tests/test_ctr_deepfm.py's criterion
# the card against the CPU, 3 Adam steps at batch 256 from one state: f32
# on both sides (TF32 off); the scatter-adds of repeated ids (256
# samples over 625 ids a field) sum in a varying order on the card.  An
# H100 read the loss (about ln 2) within 5.96e-8 and the steps' change
# in relative L2 within 1.83e-6 (parameters) and 2.47e-7 (moments); the
# gates are 17 and 55-480 times those.  By estimate (Adam's first step
# moves each entry that has a grad by about lr: about 99,000 entries,
# 57,800 of them in the 3,398 touched rows of the two tables), one
# touched table row left unchanged reads about 1.3e-2 in the
# parameters, the first-order table left unchanged about 0.19
CTR_LOSS_ATOL = 1e-6
CTR_STATE_RL2 = 1e-4
# served probabilities against the CPU plain path, f32: an H100 read
# 5.96e-8 (one ulp of a probability near 0.5); the gate is 17 times that
CTR_PROB_ATOL = 1e-6

# phase 11, seq2seq: tests/test_machine_translation.py's program
# (models/text.py seq2seq: an LSTM encoder and a DynamicRNN decoder
# whose step runs the 30,000-wide projection and softmax) at the
# model's own widths and wmt14's default dictionary (embedding 32,
# hidden 32, dict 30,000), mean cross entropy, Adam at lr 0.02, batch 8
# from dataset.wmt14's reader (sources of 3-19 ids, targets of 4-20,
# padded to 32 decoder steps); timed also at batch 128.  The
# convergence check runs the JAX test's loop: dict 1,000, batch 8, 60
# steps (its criterion: below)
S2S_DICT, S2S_EMB, S2S_HID, S2S_LR = 30000, 32, 32, 0.02
S2S_CHECK_BATCH = 8
S2S_TIMED = (8, 128)
S2S_CONV_DICT, S2S_CONV_STEPS = 1000, 60
# The JAX test's criterion (the mean of the last 6 losses below that of
# the first 6) compares different batches, and one run's outcome turns
# on its initial state and on the order of its f32 sums: on the CPU the
# JAX package's own loop rises from 1 of 8 initial states (random_seed
# 4: 6.8686 -> 6.9146), the port from 6 of 16 (`PYTHONPATH=. python
# tests/test_torch_seq2seq.py` prints both), and on an H100 the port
# rose from its seed-0 and seed-2 states.  The card repeats a run bit
# for bit since lookup_table_grad sums the rows of a repeated id (every
# target starts with id 0) in a fixed order (core/ragged.py sum_rows);
# before, its atomic adds summed them in a varying order and 60 Adam
# steps at lr 0.02 grew those rounding differences (the seed-0 state's
# last-6 mean read 6.8962, 6.9566, 6.8635 and 6.8757 on four H100
# runs).  So the criterion is printed for each
# state, and the gate makes the same comparison on fixed batches: the
# loss of the first 6 batches after the 60 steps against the losses
# recorded on them, averaged over S2S_CONV_INITS initial states
# (random_seed 0-4), must fall by S2S_CONV_FALL.  16 states of the port
# on the CPU read falls of -0.002 to 0.310 (mean 0.217, standard
# deviation 0.077, so the 5-state mean varies by about 0.034), the JAX
# package's 8 states 0.100-0.431 (mean 0.278); an H100 read 0.137-0.353
# (mean 0.271), and the seed-0 state 0.210 and 0.188 in two runs.  A
# model that learned nothing reads 0: the gate is about 3 deviations of
# the mean above 0 and 3 below what the states read.  The seed-0 state
# runs twice: its two runs print alike now that a step repeats
S2S_CONV_INITS = 5
S2S_CONV_FALL = 0.1
S2S_SERVE = 8                   # one engine.run of 8 sentence pairs
S2S_BUCKETS = [1, 2, 4, 8]
S2S_PARAMS = 2920624
S2S_STEP_OPS = sorted(["mul"] * 3 + ["elementwise_add"] * 2
                      + ["sum", "tanh", "softmax"])
# the card against the CPU, 3 Adam steps at batch 8 from one state: f32
# on both sides (TF32 off), sums in other orders through the encoder's
# lstm and the decoder's 32-step recurrence.  An H100 read the losses
# (about ln 30000 = 10.3, where one ulp is 9.5e-7) equal, and each
# tensor's change in relative L2 within 4.69e-6 and 4.35e-6
# (parameters, the target embedding) and 6.39e-6 and 6.26e-6 (moments)
# in two runs.  The gates are 10 ulps of
# the loss, 21 and 16 times the readings: Adam divides each grad by its
# own root, so an entry whose grad is at the f32 rounding floor moves
# by a different share of lr on each side (the CPU against the JAX
# package reads 3.3e-5 in the embeddings, tests/test_torch_seq2seq.py)
S2S_LOSS_ATOL = 1e-5
S2S_PARAM_RL2 = 1e-4
S2S_MOMENT_RL2 = 1e-4
# served probabilities (30,000 classes, each near 3.3e-5, where one ulp
# is 3.6e-12) against the CPU plain path, f32: an H100 read 7.28e-11
# (the softmax's sums in another order); the gate is 14 times that
S2S_PROB_ATOL = 1e-9


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
        return None
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
                                   "sm90_", "nvjet")),
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
    shares are reported as not measured (None is returned).  Returns
    {"busy_ms", "wall_ms", "launches", "families": {family: device ms},
    "flash": (the flash kernel's device ms, its launches), "ops": {op
    type: (device ms, host ms, ops)}}."""
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
        return None
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
    flash = [k for k in kernels if "flash_fwd_kernel" in k[0]]
    return {"busy_ms": busy_us / 1e3, "wall_ms": wall_us / 1e3,
            "launches": sum(k[2] for k in kernels),
            "families": {f: us / 1e3 for f, us in families.items()},
            "flash": (sum(k[1] for k in flash) / 1e3,
                      sum(k[2] for k in flash)),
            "ops": {name: (us / 1e3, host_us / 1e3, count)
                    for name, us, host_us, count in spans}}


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


def build_lstm():
    """bench.py's `_build_lstm` through the port's fluid layers: (main,
    startup, loss, probs)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models.text import stacked_lstm_text_classifier

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        data = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                 lod_level=1)
        probs = stacked_lstm_text_classifier(data, SEQ_DICT,
                                             hid_dim=SEQ_HID)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=probs, label=label))
        fluid.optimizer.Adam(learning_rate=ADAM_LR).minimize(loss)
    return main, startup, loss, probs


def lstm_sequences(lengths, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, SEQ_DICT, size=(int(n), 1)).astype(np.int64)
            for n in lengths]


def lstm_feed(seqs, seed, bucket=None):
    """{"words": RaggedTensor, "label": [B, 1]} as bench.py's
    `_lstm_feeds` makes them (`bucket` pads the flat rows, as DataFeeder
    does)."""
    from paddle_tpu_torch.core.ragged import RaggedTensor

    rs = np.random.RandomState(seed)
    return {"words": RaggedTensor.from_sequences(seqs, bucket=bucket),
            "label": rs.randint(0, SEQ_CLASSES,
                                size=(len(seqs), 1)).astype(np.int64)}


def feed_to(feed, device):
    """A feed of `lstm_feed` on `device`, ids as int32."""
    import torch

    return {n: (v.to(device) if hasattr(v, "lod_level")
                else torch.from_numpy(v.astype(np.int32)).to(device))
            for n, v in feed.items()}


def lstm_bound(batch, steps, rows, hidden, itemsize, flops_per_s,
               grad=False):
    """(ms, "bytes" | "operations") of the lstm op's least time: the
    forward reads the [rows, 4H] input, the weight and bias once and
    writes hidden and cell [rows, H]; its products are 2 * batch * H *
    4H operations a step over the `steps` this run's lengths need.  The
    grad reads the input, weight, bias and both outputs' grads, writes
    the input's, weight's and bias's grads, and does the forward's
    products again (the recompute) and twice more (the two grads of the
    recurrent product)."""
    H = hidden
    params = (H * 4 * H + 7 * H) * itemsize
    if grad:
        nbytes = (rows * 4 * H * 2 + rows * H * 2) * itemsize + 2 * params
        flops = 3 * 2.0 * batch * H * 4 * H * steps
    else:
        nbytes = (rows * 4 * H + rows * H * 2) * itemsize + params
        flops = 2.0 * batch * H * 4 * H * steps
    t_ops, t_bytes = flops / flops_per_s, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def graph_times(tag, forward, grad, library, library_grad):
    """{name: ms} of a recurrent op's `forward` and `grad` and of the
    library's `library` and `library_grad`: device ms by CUDA graph
    replay (None where capture failed), and as "plain" and "plain_grad"
    the op's eager ms by CUDA events."""
    import torch

    times = {}
    for name, fn in (("forward", forward), ("grad", grad),
                     ("cudnn", library), ("cudnn_grad", library_grad)):
        try:
            times[name] = device_ms(fn, launches=2, replays=3)
        except RuntimeError as exc:
            print("%s: %s under CUDA graph capture failed (%s): its device "
                  "ms not measured" % (tag, name, exc), flush=True)
            times[name] = None
            torch.cuda.synchronize()
    times["plain"] = cuda_ms(forward, iters=5, warm=1)
    times["plain_grad"] = cuda_ms(grad, iters=3, warm=1)
    return times


def lstm_op_times(exe, x, w, b, amp):
    """The lstm op alone at the path's shape on the card, and cuDNN's
    LSTM (a different function: no peepholes, and its own input product)
    at the same batch, steps and width: {name: ms}.  Device ms by CUDA
    graph replay (None where capture failed); the plain op's eager ms by
    CUDA events."""
    import contextlib

    import torch
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.ops.registry import get_op_info, run_generic_grad

    kernel = get_op_info("lstm").kernel
    ins = {"Input": [x], "Weight": [w], "Bias": [b]}
    attrs = {"use_peepholes": True, "is_reverse": False,
             "gate_activation": "sigmoid", "cell_activation": "tanh",
             "candidate_activation": "tanh"}
    out = kernel(None, ins, attrs)
    og = {"OG@Hidden": [out["Hidden"][0].with_values(
        torch.ones_like(out["Hidden"][0].values))]}
    guard = fluid.amp.bf16_guard() if amp else contextlib.nullcontext()

    def forward():
        with torch.no_grad():
            return kernel(None, ins, attrs)

    def grad():
        with torch.no_grad():
            return run_generic_grad(None, "lstm", dict(ins, **og), attrs)

    B, T = x.nseq(), min(x.values.shape[0], x.max_seqlen)
    cudnn = torch.nn.LSTM(SEQ_HID, SEQ_HID, batch_first=True).to(
        x.values.device, torch.bfloat16 if amp else torch.float32)
    seq = torch.randn(B, T, SEQ_HID, device=x.values.device,
                      dtype=torch.bfloat16 if amp else torch.float32,
                      requires_grad=True)

    def library():
        with torch.no_grad():
            return cudnn(seq)

    def library_grad():
        out, _ = cudnn(seq)
        out.backward(torch.ones_like(out))

    with guard:
        return graph_times("sequence", forward, grad, library, library_grad)


def phase_sequence():
    """bench.py's stacked-LSTM classifier through the port's fluid
    layers (phase 9): its build and counts; 3 Adam steps at batch 8 with
    lengths 1..100 on the CPU plain path, each step again on the card
    from the CPU's state before it; at bench.py's 128 x 100, f32 (TF32
    off) and bf16 AMP from the same state: 3 steps with their peak
    memory, the step time, a profiled step, the AMP losses against the
    f32 ones; the lstm op alone beside cuDNN's LSTM; one forward with
    CUDA's synchronizing calls made errors; the inference export served
    with ragged requests against the CPU plain path.  Returns the launch
    counts of the f32 steps (no hand-written kernel runs here)."""
    import contextlib

    import torch
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import io
    from paddle_tpu_torch.serving import (EngineConfig, InferenceEngine,
                                          InferenceServer, ServerConfig)

    t0 = time.perf_counter()
    main, startup, loss, probs = build_lstm()
    block = main.desc.block(0)
    counts = collections.Counter(op.type for op in block.ops)
    n_values = sum(int(np.prod(v.shape)) for v in block.vars.values()
                   if v.is_parameter)
    print("sequence: main %d ops of %d types (%s), %d parameter values "
          "(%.3f M); built in %.1f s"
          % (len(block.ops), len(counts), ", ".join(
              "%s %d" % kv for kv in sorted(counts.items())), n_values,
             n_values / 1e6, time.perf_counter() - t0), flush=True)
    # embedding, fc 128 -> 4H, 2 lstm (weight and peephole bias), fc over
    # [4H, H] -> 4H, the softmax fc over the two pooled [4H, H]
    H4 = 4 * SEQ_HID
    want = SEQ_DICT * SEQ_EMB + (SEQ_EMB * H4 + H4) \
        + 2 * (SEQ_HID * H4 + 7 * SEQ_HID) \
        + ((H4 + SEQ_HID) * H4 + H4) \
        + ((H4 + SEQ_HID) * SEQ_CLASSES + SEQ_CLASSES)
    if n_values != want or counts["lstm"] != 2 \
            or counts["sequence_pool"] != 2:
        raise SystemExit("chip_smoke: the lstm program has %d parameter "
                         "values (want %d) and ops %s"
                         % (n_values, want, dict(counts)))
    exe = fluid.Executor()
    if exe.device.type != "cuda":
        raise SystemExit("chip_smoke: the executor is not on the card")
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    persist = [n for n, v in block.vars.items() if v.persistable]
    init = {n: scope.get(n).cpu().numpy() for n in persist}
    del scope
    params = [n for n in persist if n + "_moment1_0" in block.vars]
    groups = {"parameters": params,
              "moment1": [n + "_moment1_0" for n in params],
              "moment2": [n + "_moment2_0" for n in params]}

    # batch 8, lengths 1..100: the CPU's 3 steps, each again on the card
    rs = np.random.RandomState(SEED + 40)
    lengths = rs.randint(1, SEQ_LEN + 1, size=SEQ_CHECK_BATCH)
    feeds = [lstm_feed(lstm_sequences(lengths, SEED + 41 + k), SEED + 50 + k,
                       bucket=64) for k in range(TRAIN_STEPS)]
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    t0 = time.perf_counter()
    states, cpu = [init], []
    for f in feeds:
        loss_k, state, _ = run_from_state(cpu_exe, main, loss, states[-1],
                                          [f])
        cpu += loss_k
        states.append(state)
    print("sequence: %d steps at batch %d (lengths %s, flat rows %d of %d "
          "valid) on the CPU plain path in %.1f s, losses %s"
          % (TRAIN_STEPS, SEQ_CHECK_BATCH, lengths.tolist(),
             feeds[0]["words"].values.shape[0], int(lengths.sum()),
             time.perf_counter() - t0, ", ".join("%.6f" % x for x in cpu)),
          flush=True)
    ok = True
    for k, f in enumerate(feeds):
        (loss_k,), got, _ = run_from_state(exe, main, loss, states[k], [f])
        errs = {g: change_rl2(got, states[k + 1], states[k], names)
                for g, names in groups.items()}
        print("sequence: step %d on the card from the CPU's state: loss "
              "%.6f, max_abs_err %.3g (atol %g); the step's change, "
              "relative L2 error: %s (limit %g)"
              % (k + 1, loss_k, abs(loss_k - cpu[k]), SEQ_LOSS_ATOL,
                 ", ".join("%s %.3g" % kv for kv in errs.items()),
                 SEQ_STATE_RL2), flush=True)
        ok = ok and abs(loss_k - cpu[k]) <= SEQ_LOSS_ATOL \
            and max(errs.values()) <= SEQ_STATE_RL2 \
            and all(np.isfinite(v).all() for v in got.values())
    if not ok:
        raise SystemExit("chip_smoke: lstm steps on the card disagree "
                         "with the CPU plain path")

    # bench.py's 128 x 100, f32 and then bf16 AMP, each from `init`
    full = lstm_feed(lstm_sequences([SEQ_LEN] * SEQ_BATCH, SEED + 60),
                     SEED + 61)
    dev_feed = feed_to(full, exe.device)
    steps_run = min(dev_feed["words"].values.shape[0],
                    dev_feed["words"].max_seqlen)
    print("sequence: bench.py's feed: %d sequences of %d ids, max_seqlen "
          "%d, so the recurrence runs %d steps"
          % (SEQ_BATCH, SEQ_LEN, dev_feed["words"].max_seqlen, steps_run),
          flush=True)
    op_types = set(counts)
    losses, launches, trained, prof = {}, None, None, {}
    for amp in (False, True):
        tag = "bf16 AMP" if amp else "f32"
        scope = fluid.Scope()
        io.params_from_numpy(scope, init, exe.device)
        with fluid.amp.bf16_guard() if amp else contextlib.nullcontext():
            reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            losses[amp] = [float(exe.run(main, feed=dev_feed,
                                         fetch_list=[loss],
                                         scope=scope)[0][0])
                           for _ in range(TRAIN_STEPS)]
            seconds = time.perf_counter() - t0
            if not amp:
                # the main path ends here: read the counts
                launches = read_launches()
                trained = {n: scope.get(n).cpu().numpy() for n in persist}
            peak = torch.cuda.max_memory_allocated()
            print("sequence %s: %d steps at %d x %d in %.2f s, losses %s; "
                  "peak memory %.3f GB; hand-written kernel launches %s"
                  % (tag, TRAIN_STEPS, SEQ_BATCH, SEQ_LEN, seconds,
                     ", ".join("%.6f" % x for x in losses[amp]),
                     peak / 1e9, json.dumps(read_launches())), flush=True)

            def step():
                return exe.run(main, feed=dev_feed, fetch_list=[loss],
                               scope=scope, return_numpy=False)

            times = timed_steps(step)
            med = float(np.median(times))
            print("sequence %s: step %.3f ms (median of 10 after 2 warm; "
                  "mean %.3f, min %.3f, max %.3f), %.1f samples/s"
                  % (tag, med, np.mean(times), min(times), max(times),
                     SEQ_BATCH / med * 1e3), flush=True)
            prof[amp] = profile_step(step, op_types, 0, med)
        del scope
        torch.cuda.empty_cache()
    amp_err = max(abs(a - b) for a, b in zip(losses[True], losses[False]))
    print("sequence: bf16 AMP losses against f32 from the same state: max "
          "abs difference %.4g (atol %g)" % (amp_err, SEQ_AMP_LOSS_ATOL),
          flush=True)
    if amp_err > SEQ_AMP_LOSS_ATOL or not np.isfinite(losses[True]).all() \
            or not np.isfinite(losses[False]).all():
        raise SystemExit("chip_smoke: the lstm's bf16 AMP steps disagree "
                         "with its f32 steps")

    # the lstm op alone at the path's shape: the first layer's input
    from paddle_tpu_torch.ops.registry import get_op_info

    scope = fluid.Scope()
    io.params_from_numpy(scope, trained, exe.device)
    words = dev_feed["words"]
    with torch.no_grad():
        emb = get_op_info("lookup_table").kernel(
            None, {"Ids": [words], "W": [scope.get("embedding_0.w_0")]},
            {"padding_idx": -1})["Out"][0]
        x = emb.with_values(emb.values @ scope.get("fc_0.w_0")
                            + scope.get("fc_0.w_1"))
    rows = int(words.nvalid)
    for amp in (False, True):
        tag = "bf16" if amp else "f32"
        xa = x.with_values(x.values.to(torch.bfloat16)) if amp else x
        t = lstm_op_times(exe, xa, scope.get("lstm_0.w_0"),
                          scope.get("lstm_0.w_1"), amp)
        itemsize = 2 if amp else 4
        peak = BF16_FLOPS if amp else F32_CORE_FLOPS
        fb, fby = lstm_bound(SEQ_BATCH, SEQ_LEN, rows, SEQ_HID, itemsize,
                             peak)
        gb, gby = lstm_bound(SEQ_BATCH, SEQ_LEN, rows, SEQ_HID, itemsize,
                             peak, grad=True)

        def fmt(v):
            return "not measured" if v is None else "%.4f" % v

        print("sequence: lstm op %s at [%d x %d steps, 4 x %d]: forward "
              "device %s ms (graph replay), eager %.4f ms, bound %.4f ms "
              "by %s; grad (generic vjp) device %s ms, eager %.4f ms, "
              "bound %.4f ms by %s; cuDNN LSTM (no peepholes, its own "
              "input product; a different function) forward %s ms, "
              "forward and backward %s ms"
              % (tag, SEQ_BATCH, steps_run, SEQ_HID, fmt(t["forward"]),
                 t["plain"], fb, fby, fmt(t["grad"]), t["plain_grad"], gb,
                 gby, fmt(t["cudnn"]), fmt(t["cudnn_grad"])), flush=True)
        p = prof.get(amp)
        if p is not None:
            print("sequence: lstm in the profiled %s step: lstm %.3f device "
                  "ms, %.3f host ms, %d ops; lstm_grad %.3f device ms "
                  "(its recompute; the backward half runs on autograd's "
                  "thread), %.3f host ms, %d ops"
                  % ((tag,) + p["ops"].get("lstm", (0, 0, 0))
                     + p["ops"].get("lstm_grad", (0, 0, 0))), flush=True)
    del scope

    # one forward of the recurrence with synchronizing calls made errors
    infer = io.prune_program(main, [probs])
    scope = fluid.Scope()
    io.params_from_numpy(scope, trained, exe.device)
    exe.run(infer, feed=dev_feed, fetch_list=[probs], scope=scope,
            return_numpy=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = exe.run(infer, feed={"words": dev_feed["words"]},
                      fetch_list=[probs], scope=scope,
                      return_numpy=False)[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if tuple(out.shape) != (SEQ_BATCH, SEQ_CLASSES) \
            or not torch.isfinite(out).all():
        raise SystemExit("chip_smoke: the lstm forward gave %s"
                         % (tuple(out.shape),))
    print("sequence: no synchronizing call in one forward of the %d-step "
          "recurrence (%d sequences)" % (steps_run, SEQ_BATCH), flush=True)
    del scope

    # the inference export served with ragged requests
    rs = np.random.RandomState(SEED + 70)
    served = lstm_sequences(rs.randint(1, SEQ_LEN + 1, size=SEQ_SERVE),
                            SEED + 71)
    requests = [served[0:1], served[1:3], served[3:6]]
    with tempfile.TemporaryDirectory() as tmp:
        with fluid.scope_guard(params_scope(trained, "cpu")):
            io.save_inference_model(
                tmp, ["words"], [probs], fluid.Executor(fluid.CPUPlace()),
                main, bucket_hints={"batch_buckets": SEQ_BUCKETS})
        engine = InferenceEngine.from_saved_model(tmp)
        if engine.place.device().type != "cuda":
            raise SystemExit("chip_smoke: the engine is not on the card")
        server = InferenceServer(engine, ServerConfig(
            port=0, max_batch=SEQ_SERVE, max_wait_ms=50.0, warmup=True))
        try:
            t0 = time.perf_counter()
            server.start()
            print("sequence: server up with warmup of %d buckets in %.2f s"
                  % (len(SEQ_BUCKETS), time.perf_counter() - t0),
                  flush=True)
            host, port = server.address
            url = "http://%s:%d/v1/infer" % (host, port)
            replies = [None] * len(requests)

            def client(i):
                replies[i] = _post(url, {"inputs": {"words": [
                    s.tolist() for s in requests[i]]}})

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(requests))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            if any(r is None for r in replies):
                raise SystemExit("chip_smoke: an HTTP request got no reply")
            print("sequence: %d requests of %s sequences (lengths %s) "
                  "answered in %d batch(es); latencies %s ms"
                  % (len(requests), [len(r) for r in requests],
                     [[len(s) for s in r] for r in requests],
                     server.metrics.batch_occupancy.count,
                     ", ".join("%.1f" % r[2] for r in replies)), flush=True)
            t0 = time.perf_counter()
            out16 = engine.run({"words": served})[0]
            print("sequence: engine.run of %d sequences (lengths %d..%d) in "
                  "%.1f ms" % (SEQ_SERVE, min(map(len, served)),
                               max(map(len, served)),
                               (time.perf_counter() - t0) * 1e3),
                  flush=True)
        finally:
            server.shutdown()
        t0 = time.perf_counter()
        cpu = InferenceEngine.from_saved_model(
            tmp, place=fluid.CPUPlace(),
            config=EngineConfig(batch_buckets=None))
        ref = cpu.run({"words": served})[0]
        print("sequence: CPU reference of %d sequences in %.1f s"
              % (SEQ_SERVE, time.perf_counter() - t0), flush=True)
    errs, lo = [], 0
    fetch = engine.fetch_names[0]
    for (status, body, _), req in zip(replies, requests):
        if status != 200:
            raise SystemExit("chip_smoke: HTTP %d: %s" % (status, body))
        got = np.asarray(body["outputs"][fetch], np.float32)
        if got.shape != (len(req), SEQ_CLASSES):
            raise SystemExit("chip_smoke: reply shape %s" % (got.shape,))
        errs.append(float(np.abs(got - ref[lo:lo + len(req)]).max()))
        lo += len(req)
    if out16.shape != (SEQ_SERVE, SEQ_CLASSES) \
            or not np.isfinite(out16).all():
        raise SystemExit("chip_smoke: engine.run gave %s" % (out16.shape,))
    errs.append(float(np.abs(out16 - ref).max()))
    print("sequence: served probabilities max_abs_err against the CPU "
          "plain path: HTTP requests %s, engine.run %.3g (atol %g)"
          % (", ".join("%.3g" % e for e in errs[:-1]), errs[-1],
             SEQ_PROB_ATOL), flush=True)
    if max(errs) > SEQ_PROB_ATOL:
        raise SystemExit("chip_smoke: served probabilities disagree with "
                         "the CPU plain path")
    return launches


def ctr_reader(features, seed=0):
    """examples/ctr_deepfm_sparse.py's `synthetic_ctr_reader` (a copy:
    this script imports nothing of the JAX package's tree) at `features`
    features in CTR_FIELDS fields and batches of CTR_BATCH: (ids [B,
    fields] int64, label [B, 1] f32) batches, the click driven by a
    linear and one pairwise signal."""
    rs = np.random.RandomState(seed)
    per_field = features // CTR_FIELDS
    w = rs.randn(features) * 0.5
    latent = rs.randn(features, 4)
    while True:
        ids = np.stack(
            [rs.randint(f * per_field, (f + 1) * per_field, size=CTR_BATCH)
             for f in range(CTR_FIELDS)], axis=1).astype(np.int64)
        logit = w[ids].sum(axis=1)
        logit += np.einsum("nd,nd->n", latent[ids[:, 0]],
                           latent[ids[:, 1]])
        label = (rs.rand(CTR_BATCH) < 1 / (1 + np.exp(-logit)))
        yield ids, label.astype(np.float32).reshape(-1, 1)


def build_ctr(features, opt="Adam"):
    """The example's program through the port's layers (its :48-60):
    (main, startup, loss, predict, params_grads), the optimizer `opt` at
    lr CTR_LR."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models.ctr import deepfm_ctr

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[CTR_FIELDS],
                                dtype="int64")
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        loss, predict = deepfm_ctr(ids, label, features, CTR_FIELDS,
                                   embed_dim=CTR_EMBED,
                                   hidden_sizes=CTR_HIDDEN)
        _, params_grads = getattr(fluid.optimizer, opt)(
            learning_rate=CTR_LR).minimize(loss)
    return main, startup, loss, predict, params_grads


def ctr_feed(batch, device):
    """A reader batch as the executor's feed on `device` (ids as int32,
    the execution dtype of their int64 var)."""
    import torch

    ids, label = batch
    return {"ids": torch.from_numpy(ids.astype(np.int32)).to(device),
            "label": torch.from_numpy(label).to(device)}


CTR_TABLES = ("embedding_0.w_0", "embedding_1.w_0")
CTR_OPS = {"Adam": "adam", "SGD": "sgd", "Adagrad": "adagrad"}


def ctr_update_bytes(opt, shapes, nrows, unique):
    """The bytes one step's update ops must move, each input read once
    and each output written once: a dense grad's parameter (and state)
    whole; a table's SelectedRows grad (nrows ids and rows of values)
    and, for the row updates of sgd and adagrad, only the `unique` rows
    it names of the table (and of adagrad's moment), read and written;
    adam densifies, so it reads and writes its table and both moments
    whole.  `shapes`: {param name: shape}."""
    total = 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        if name in CTR_TABLES:
            width = int(np.prod(shape[1:]))
            rows = {"Adam": 6 * n, "SGD": 2 * unique * width,
                    "Adagrad": 4 * unique * width}[opt]
            total += nrows * (width * 4 + 4) + 4 * rows
        else:
            total += 4 * n * {"Adam": 7, "SGD": 3, "Adagrad": 5}[opt]
    return total


def ctr_op_times(scope, opt, batch, height):
    """The update op of `opt` alone on the second-order table ([height,
    CTR_EMBED], its state from `scope`) with a SelectedRows grad of one
    batch's ids (random values): (device ms by graph replay, bound ms by
    bytes, and for sgd the device ms of the in-place `index_add_` that
    a donated buffer would allow: the same rows written, where the op
    writes a new table)."""
    import torch
    from paddle_tpu_torch.core.ragged import SelectedRows
    from paddle_tpu_torch.ops.registry import get_op_info

    device = torch.device("cuda")
    name = CTR_TABLES[0]
    p = scope.get(name)
    ids = torch.from_numpy(batch[0].reshape(-1).astype(np.int32)).to(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    values = torch.randn(ids.shape[0], CTR_EMBED, device=device,
                         generator=gen) * 1e-3
    lr = torch.full((1,), CTR_LR, device=device)
    ins = {"Param": [p], "Grad": [SelectedRows(ids, values, height)],
           "LearningRate": [lr]}
    if opt == "Adam":
        ins.update(Moment1=[scope.get(name + "_moment1_0")],
                   Moment2=[scope.get(name + "_moment2_0")],
                   Beta1Pow=[torch.full((1,), 0.9, device=device)],
                   Beta2Pow=[torch.full((1,), 0.999, device=device)])
    elif opt == "Adagrad":
        ins["Moment"] = [scope.get(name + "_moment_0")]
    kernel = get_op_info(CTR_OPS[opt]).kernel

    def run():
        with torch.no_grad():
            return kernel(None, ins, {})

    ms = device_ms(run, launches=5, replays=3)
    unique = int(np.unique(batch[0]).size)
    bound = ctr_update_bytes(opt, {name: tuple(p.shape)}, ids.numel(),
                             unique) / HBM_BYTES_PER_S * 1e3
    library = None
    if opt == "SGD":
        target, upd = p.clone(), -lr * values

        def in_place():
            target.index_add_(0, ids, upd)

        library = device_ms(in_place, launches=5, replays=3)
    return ms, bound, library


def ctr_row_check(exe, opt, fixed, touched):
    """One `opt` step from a fresh startup state on `fixed`: the two
    tables' (and Adagrad's moments') rows that the batch did not touch
    must keep their bits, and every touched row must change.  Returns
    the report."""
    import paddle_tpu_torch.fluid as fluid

    main, startup, loss, _, _ = build_ctr(CTR_FEATURES, opt)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    names = list(CTR_TABLES)
    if opt == "Adagrad":
        names += [t + "_moment_0" for t in CTR_TABLES]
    before = {n: scope.get(n).cpu().numpy() for n in names}
    exe.run(main, feed=fixed, fetch_list=[loss], scope=scope)
    lines = []
    for n in names:
        after = scope.get(n).cpu().numpy()
        kept = after[~touched].tobytes() == before[n][~touched].tobytes()
        changed = (after[touched] != before[n][touched]).reshape(
            int(touched.sum()), -1).any(axis=1)
        lines.append("%s: %d untouched rows %s, %d of %d touched rows "
                     "changed" % (n, int((~touched).sum()),
                                  "bit-for-bit unchanged" if kept
                                  else "CHANGED", int(changed.sum()),
                                  int(touched.sum())))
        if not kept or not changed.all():
            raise SystemExit("chip_smoke: a %s step is not row-sparse: %s"
                             % (opt, lines[-1]))
    return "; ".join(lines)


def ctr_serve(trained, main, predict):
    """The export of `predict` from the `ids` feed, with the `trained`
    state, loaded by InferenceEngine on the card behind InferenceServer:
    3 concurrent requests of CTR_SERVE rows against the CPU plain path.
    Returns the largest error."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import io
    from paddle_tpu_torch.serving import (EngineConfig, InferenceEngine,
                                          InferenceServer, ServerConfig)

    rows = next(ctr_reader(CTR_FEATURES, seed=SEED + 81))[0]
    parts = np.cumsum([0] + list(CTR_SERVE))
    served = rows[:parts[-1]]
    requests = [served[lo:hi] for lo, hi in zip(parts[:-1], parts[1:])]
    with tempfile.TemporaryDirectory() as tmp:
        with fluid.scope_guard(params_scope(trained, "cpu")):
            io.save_inference_model(
                tmp, ["ids"], [predict], fluid.Executor(fluid.CPUPlace()),
                main, bucket_hints={"batch_buckets": CTR_BUCKETS})
        engine = InferenceEngine.from_saved_model(tmp)
        if engine.place.device().type != "cuda":
            raise SystemExit("chip_smoke: the engine is not on the card")
        server = InferenceServer(engine, ServerConfig(
            port=0, max_batch=max(CTR_BUCKETS), max_wait_ms=50.0,
            warmup=True))
        try:
            server.start()
            host, port = server.address
            url = "http://%s:%d/v1/infer" % (host, port)
            replies = [None] * len(requests)

            def client(i):
                replies[i] = _post(url, {"inputs": {
                    "ids": requests[i].tolist()}})

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(requests))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            if any(r is None for r in replies):
                raise SystemExit("chip_smoke: an HTTP request got no reply")
            print("ctr: %d requests of %s rows answered in %d batch(es); "
                  "latencies %s ms"
                  % (len(requests), list(CTR_SERVE),
                     server.metrics.batch_occupancy.count,
                     ", ".join("%.1f" % r[2] for r in replies)), flush=True)
        finally:
            server.shutdown()
        ref = InferenceEngine.from_saved_model(
            tmp, place=fluid.CPUPlace(),
            config=EngineConfig(batch_buckets=None)).run({"ids": served})[0]
    errs, fetch = [], engine.fetch_names[0]
    for (status, body, _), lo, hi in zip(replies, parts[:-1], parts[1:]):
        if status != 200:
            raise SystemExit("chip_smoke: HTTP %d: %s" % (status, body))
        got = np.asarray(body["outputs"][fetch], np.float32)
        if got.shape != (hi - lo, 1) or not np.isfinite(got).all():
            raise SystemExit("chip_smoke: reply shape %s" % (got.shape,))
        errs.append(float(np.abs(got - ref[lo:hi]).max()))
    print("ctr: served probabilities max_abs_err against the CPU plain "
          "path: %s (atol %g)" % (", ".join("%.3g" % e for e in errs),
                                  CTR_PROB_ATOL), flush=True)
    return max(errs)


def ctr_timing(exe, features, opt, smi):
    """The step of `opt` at `features` features on the card, its feed
    there: at CTR_BIG_FEATURES under Adam and SGD first one step run
    twice from one state (`repeat_gate`), then 3 steps with their peak
    memory, the median of 10 after 2 warm,
    samples/s, a profiled step (busy share, launches, the update ops'
    device ms beside their bound by bytes) and, at CTR_BIG_FEATURES,
    the update op alone on the table."""
    import torch
    import paddle_tpu_torch.fluid as fluid

    batch = next(ctr_reader(features))
    feed = ctr_feed(batch, exe.device)
    unique = int(np.unique(batch[0]).size)
    main, startup, loss, _, _ = build_ctr(features, opt)
    block = main.desc.block(0)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    if features == CTR_BIG_FEATURES and opt in ("Adam", "SGD"):
        repeat_gate("ctr %s at %d features" % (opt, features), exe, main,
                    feed, {n: scope.get(n) for n, v in block.vars.items()
                           if v.persistable})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = [float(exe.run(main, feed=feed, fetch_list=[loss],
                           scope=scope)[0][0]) for _ in range(TRAIN_STEPS)]
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(first).all():
        raise SystemExit("chip_smoke: ctr %s at %d features gave losses %s"
                         % (opt, features, first))

    def step():
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)

    times = timed_steps(step)
    med = float(np.median(times))
    print("ctr %s at %d features: step %.3f ms (median of 10 after 2 warm; "
          "mean %.3f, min %.3f, max %.3f), %.1f samples/s, peak memory "
          "%.3f GB, losses %s [%s]"
          % (opt, features, med, np.mean(times), min(times), max(times),
             CTR_BATCH / med * 1e3, peak / 1e9,
             ", ".join("%.4f" % x for x in first), smi), flush=True)
    prof = profile_step(step, {op.type for op in block.ops}, 0, med,
                        what="one %s step at %d features" % (opt, features))
    shapes = {n: v.shape for n, v in block.vars.items() if v.is_parameter}
    bound = ctr_update_bytes(opt, shapes, CTR_BATCH * CTR_FIELDS,
                             unique) / HBM_BYTES_PER_S * 1e3
    op = CTR_OPS[opt]
    print("ctr %s at %d features: the %d %s ops of the profiled step: "
          "device %s ms, bound %.4f ms by bytes (%d unique ids of %d) [%s]"
          % (opt, features, len(shapes), op,
             "not measured" if prof is None
             else "%.4f" % prof["ops"].get(op, (0.0,))[0], bound, unique,
             CTR_BATCH * CTR_FIELDS, smi), flush=True)
    if features == CTR_BIG_FEATURES:
        ms, op_bound, library = ctr_op_times(scope, opt, batch, features)
        print("ctr %s at %d features: %s alone on the [%d, %d] table with "
              "one batch's SelectedRows grad: device %.4f ms (graph "
              "replay), bound %.4f ms by bytes%s [%s]"
              % (opt, features, op, features, CTR_EMBED, ms, op_bound,
                 "" if library is None else "; the in-place index_add_ "
                 "(no copy of the table) %.4f ms" % library, smi),
              flush=True)


def phase_ctr():
    """examples/ctr_deepfm_sparse.py's local loop through the port
    (phase 10): the program's sparse typing; 3 Adam steps on the card
    against the CPU plain path from one state; the JAX test's
    convergence criterion; the example's 60 steps through DataFeeder and
    device_prefetch; the rows one SGD and one Adagrad step leave alone;
    the export served against the CPU; and the step's time, busy share,
    launches, peak memory and update ops' device time under Adam, SGD
    and Adagrad at 10,000 and 10,000,000 features.  Returns the launch
    counts of the example's loop (no hand-written kernel runs here)."""
    import torch
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.types import VarType
    from paddle_tpu_torch.reader import device_prefetch

    t0 = time.perf_counter()
    main, startup, loss, predict, params_grads = build_ctr(CTR_FEATURES)
    block = main.desc.block(0)
    counts = collections.Counter(op.type for op in block.ops)
    sparse = [g.name for _, g in params_grads
              if g.type == VarType.SELECTED_ROWS]
    n_values = sum(int(np.prod(v.shape)) for v in block.vars.values()
                   if v.is_parameter)
    print("ctr: main %d ops of %d types (%s), %d parameter values (%.3f "
          "M), SELECTED_ROWS grads %s; built in %.1f s"
          % (len(block.ops), len(counts), ", ".join(
              "%s %d" % kv for kv in sorted(counts.items())), n_values,
             n_values / 1e6, sparse, time.perf_counter() - t0), flush=True)
    # the two tables, then fc 256 -> 128 -> 64 -> 1 with biases
    width = CTR_FIELDS * CTR_EMBED
    want = CTR_FEATURES * (CTR_EMBED + 1) + (width * 128 + 128) \
        + (128 * 64 + 64) + (64 + 1)
    if sparse != [t + "@GRAD" for t in CTR_TABLES] or n_values != want:
        raise SystemExit("chip_smoke: the ctr program has SELECTED_ROWS "
                         "grads %s (want the 2 tables') and %d parameter "
                         "values (want %d)" % (sparse, n_values, want))
    exe = fluid.Executor()
    if exe.device.type != "cuda":
        raise SystemExit("chip_smoke: the executor is not on the card")
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    persist = [n for n, v in block.vars.items() if v.persistable]
    init = {n: scope.get(n).cpu().numpy() for n in persist}
    del scope
    params = [n for n in persist if n + "_moment1_0" in block.vars]
    groups = {"parameters": params,
              "moment1": [n + "_moment1_0" for n in params],
              "moment2": [n + "_moment2_0" for n in params]}
    reader = ctr_reader(CTR_FEATURES)
    batches = [next(reader) for _ in range(TRAIN_STEPS)]
    feeds = [{"ids": ids, "label": label} for ids, label in batches]

    # 3 Adam steps from one state: the CPU plain path, then the card
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu, cpu_state, cpu_s = run_from_state(cpu_exe, main, loss, init, feeds)
    card, card_state, _ = run_from_state(exe, main, loss, init, feeds)
    errs = {g: change_rl2(card_state, cpu_state, init, names)
            for g, names in groups.items()}
    loss_err = max(abs(a - b) for a, b in zip(card, cpu))
    print("ctr: %d Adam steps at batch %d from one state: CPU plain path "
          "(%.1f s) losses %s; card %s; loss max_abs_err %.3g (atol %g); "
          "the steps' change, relative L2 error: %s (limit %g)"
          % (TRAIN_STEPS, CTR_BATCH, cpu_s, ", ".join(
              "%.6f" % x for x in cpu), ", ".join("%.6f" % x for x in card),
             loss_err, CTR_LOSS_ATOL, ", ".join(
                 "%s %.3g" % kv for kv in errs.items()), CTR_STATE_RL2),
          flush=True)
    if loss_err > CTR_LOSS_ATOL or max(errs.values()) > CTR_STATE_RL2 \
            or not all(np.isfinite(v).all() for v in card_state.values()):
        raise SystemExit("chip_smoke: ctr steps on the card disagree with "
                         "the CPU plain path")

    # the JAX test's criterion: 60 Adam steps on one batch
    scope = params_scope(init, exe.device)
    fixed = ctr_feed(batches[0], exe.device)
    fit = [float(exe.run(main, feed=fixed, fetch_list=[loss],
                         scope=scope)[0][0]) for _ in range(CTR_STEPS)]
    print("ctr: %d Adam steps on one batch: loss %.6f -> %.6g (limit %g of "
          "the first)" % (CTR_STEPS, fit[0], fit[-1], CTR_CONVERGE),
          flush=True)
    if not np.isfinite(fit).all() or not fit[-1] < CTR_CONVERGE * fit[0]:
        raise SystemExit("chip_smoke: ctr training did not converge on "
                         "one batch")
    del scope

    # the example's loop: its reader through DataFeeder and
    # device_prefetch, 60 steps from the startup state
    place = fluid.CUDAPlace(0)
    gblock = main.global_block()
    feeder = fluid.DataFeeder(place=place, feed_list=[gblock.var("ids"),
                                                      gblock.var("label")],
                              program=main)

    def example_batches():
        r = ctr_reader(CTR_FEATURES)
        for _ in range(CTR_STEPS):
            ids, label = next(r)
            yield feeder.feed([(ids[i], label[i])
                               for i in range(CTR_BATCH)])

    scope = params_scope(init, exe.device)
    losses, times = [], []
    reset_launches()
    torch.cuda.synchronize()
    t_loop = t0 = time.perf_counter()
    for step, feed in enumerate(device_prefetch(example_batches,
                                                place=place)()):
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        losses.append(float(np.asarray(out).reshape(-1)[0]))
        times.append((time.perf_counter() - t0) * 1e3)
        if step % 10 == 0 or step == CTR_STEPS - 1:
            print("ctr: step %3d  logloss %.4f" % (step, losses[-1]),
                  flush=True)
        t0 = time.perf_counter()
    loop_s = time.perf_counter() - t_loop
    launches = read_launches()
    med = float(np.median(times))
    print("ctr: the example's loop, %d steps in %.2f s: step %.3f ms "
          "(median, host clock from one fetched loss to the next, feeding "
          "included; min %.3f, max %.3f), %.1f samples/s; hand-written "
          "kernel launches %s"
          % (len(losses), loop_s, med, min(times), max(times),
             CTR_BATCH / med * 1e3, json.dumps(launches)), flush=True)
    if len(losses) != CTR_STEPS or not np.isfinite(losses).all():
        raise SystemExit("chip_smoke: the ctr example's loop gave losses "
                         "%s" % losses)
    trained = {n: scope.get(n).cpu().numpy() for n in persist}
    del scope

    # one SGD and one Adagrad step, each from a fresh state
    touched = np.zeros(CTR_FEATURES, bool)
    touched[np.unique(batches[0][0])] = True
    for opt in ("SGD", "Adagrad"):
        print("ctr: one %s step: %s"
              % (opt, ctr_row_check(exe, opt, fixed, touched)), flush=True)

    if ctr_serve(trained, main, predict) > CTR_PROB_ATOL:
        raise SystemExit("chip_smoke: served ctr probabilities disagree "
                         "with the CPU plain path")

    smi = nvidia_smi_line()
    for features in (CTR_FEATURES, CTR_BIG_FEATURES):
        for opt in CTR_TIMED:
            ctr_timing(exe, features, opt, smi)
            torch.cuda.empty_cache()
    return launches


# -- phase 11: the seq2seq translation model ---------------------------------

S2S_FEEDS = ("src_word_id", "target_language_word",
             "target_language_next_word")


def build_seq2seq(dict_size):
    """tests/test_machine_translation.py's program through the port's
    layers: (main, startup, loss, prob, feed vars)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models.text import seq2seq

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        fvars = [fluid.layers.data(name=n, shape=[1], dtype="int64",
                                   lod_level=1) for n in S2S_FEEDS]
        prob = seq2seq(fvars[0], fvars[1], dict_size, dict_size,
                       emb_dim=S2S_EMB, hidden_dim=S2S_HID)
        loss = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=prob, label=fvars[2]))
        fluid.optimizer.Adam(learning_rate=S2S_LR).minimize(loss)
    return main, startup, loss, prob, fvars


def s2s_batches(dict_size, batch, n):
    """The first `n` full batches of `batch` samples of
    dataset.wmt14.train(dict_size)."""
    import paddle_tpu_torch as paddle

    out = []
    for b in paddle.batch(paddle.dataset.wmt14.train(dict_size),
                          batch_size=batch)():
        if len(b) == batch:
            out.append(b)
        if len(out) == n:
            break
    return out


def s2s_feed(fvars, batch, device=None):
    """DataFeeder's feed of `batch` (three ragged slots), on the host, or
    on `device` with the ids as int32."""
    import torch
    import paddle_tpu_torch.fluid as fluid

    feed = fluid.DataFeeder(feed_list=fvars, place=fluid.CPUPlace()).feed(
        batch)
    if device is None:
        return feed
    return {n: v.with_values(v.values.to(torch.int32)).to(device)
            for n, v in feed.items()}


def recurrent_bound(T, B, valid, hid, vocab, emb, grad=False):
    """(ms, "bytes" | "operations") of the `recurrent` op's least time
    at the seq2seq's step (fc over [emb + hid] -> hid, tanh, fc hid ->
    vocab, softmax): the forward reads the step inputs [T, B, emb], the
    boot, the mask and the weights once and writes the step outputs [T,
    B, vocab] and the final memory; its operations are the products (2
    per multiply-add) and about 5 per softmax entry, at the `valid` (t,
    b) positions this run's mask keeps, on the f32 cores (TF32 off).
    The grad reads the inputs and the step outputs' grad and writes the
    inputs' grads; it does the forward again (the recompute) and its
    products twice more, and the softmax's grad (3 an entry)."""
    weights = emb * hid + hid * hid + hid + hid * vocab + vocab
    inputs = T * B * emb + B * hid + T * B + weights
    products = 2.0 * (emb * hid + hid * hid + hid * vocab)
    fwd_ops = valid * (products + 5.0 * vocab)
    if grad:
        nbytes = 4 * (inputs + T * B * vocab + inputs - T * B)
        flops = 3 * valid * products + valid * 8.0 * vocab
    else:
        nbytes = 4 * (inputs + T * B * vocab + B * hid)
        flops = fwd_ops
    t_ops, t_bytes = flops / F32_CORE_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def recurrent_op_times(main, env, og):
    """The `recurrent` op alone on the card with the inputs `env` gives
    it, and cuDNN's `nn.RNN(nonlinearity="tanh")` over the same hidden
    recurrence (a different function: no per-step projection or
    softmax): {name: ms}.  Device ms by CUDA graph replay (None where
    capture failed); eager ms by CUDA events."""
    import torch
    from paddle_tpu_torch.fluid.executor import ExecContext
    from paddle_tpu_torch.ops.registry import get_op_info, run_generic_grad

    rec = next(op for op in main.desc.block(0).ops
               if op.type == "recurrent")
    ins = {slot: [env[n] for n in names]
           for slot, names in rec.inputs.items()}
    device = og.device
    ctx = ExecContext(main.desc, 0, {}, device=device)
    kernel = get_op_info("recurrent").kernel

    def forward():
        with torch.no_grad():
            return kernel(ctx, ins, rec.attrs)

    def grad():
        with torch.no_grad():
            return run_generic_grad(ctx, "recurrent",
                                    dict(ins, **{"OG@StepOutputs": [og]}),
                                    rec.attrs)

    T, B = og.shape[0], og.shape[1]
    cudnn = torch.nn.RNN(S2S_HID, S2S_HID, nonlinearity="tanh",
                         batch_first=True).to(device)
    seq = torch.randn(B, T, S2S_HID, device=device, requires_grad=True)

    def library():
        with torch.no_grad():
            return cudnn(seq)

    def library_grad():
        out, _ = cudnn(seq)
        out.backward(torch.ones_like(out))

    return graph_times("seq2seq", forward, grad, library, library_grad)


def s2s_valid_rows(rt):
    """Each sequence's rows of a host ragged fetch."""
    values = rt.values.numpy()
    splits = rt.lod()[-1]
    return [values[a:b] for a, b in zip(splits[:-1], splits[1:])]


def s2s_serve(trained, main, prob, pairs):
    """The export of `prob` served on the card: 3 concurrent POST
    /v1/infer of 1, 2 and 3 of `pairs`, then one engine.run of all of
    them, each sequence's rows against the CPU plain path."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import io
    from paddle_tpu_torch.serving import (EngineConfig, InferenceEngine,
                                          InferenceServer, ServerConfig)

    feeds = list(S2S_FEEDS[:2])

    def feed_of(ps):
        return {feeds[0]: [p[0] for p in ps], feeds[1]: [p[1] for p in ps]}

    requests = [pairs[0:1], pairs[1:3], pairs[3:6]]
    with tempfile.TemporaryDirectory() as tmp:
        with fluid.scope_guard(params_scope(trained, "cpu")):
            io.save_inference_model(
                tmp, feeds, [prob], fluid.Executor(fluid.CPUPlace()), main,
                bucket_hints={"batch_buckets": S2S_BUCKETS})
        engine = InferenceEngine.from_saved_model(tmp)
        if engine.place.device().type != "cuda":
            raise SystemExit("chip_smoke: the engine is not on the card")
        if len(engine.program.blocks) != 2:
            raise SystemExit("chip_smoke: the export lost its step block")
        server = InferenceServer(engine, ServerConfig(
            port=0, max_batch=max(S2S_BUCKETS), max_wait_ms=50.0,
            warmup=True))
        try:
            t0 = time.perf_counter()
            server.start()
            print("seq2seq: server up with warmup of %d buckets in %.2f s"
                  % (len(S2S_BUCKETS), time.perf_counter() - t0),
                  flush=True)
            host, port = server.address
            url = "http://%s:%d/v1/infer" % (host, port)
            replies = [None] * len(requests)

            def client(i):
                replies[i] = _post(url, {"inputs": {
                    n: [p[k].tolist() for p in requests[i]]
                    for k, n in enumerate(feeds)}})

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(requests))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            if any(r is None for r in replies):
                raise SystemExit("chip_smoke: an HTTP request got no reply")
            print("seq2seq: %d requests of %s sentence pairs (target "
                  "lengths %s) answered in %d batch(es); latencies %s ms"
                  % (len(requests), [len(r) for r in requests],
                     [[len(p[1]) for p in r] for r in requests],
                     server.metrics.batch_occupancy.count,
                     ", ".join("%.1f" % r[2] for r in replies)), flush=True)
            t0 = time.perf_counter()
            out = engine.run(feed_of(pairs))[0]
            print("seq2seq: engine.run of %d sentence pairs (target lengths "
                  "%d..%d) in %.1f ms"
                  % (len(pairs), min(len(p[1]) for p in pairs),
                     max(len(p[1]) for p in pairs),
                     (time.perf_counter() - t0) * 1e3), flush=True)
        finally:
            server.shutdown()
        t0 = time.perf_counter()
        cpu = InferenceEngine.from_saved_model(
            tmp, place=fluid.CPUPlace(),
            config=EngineConfig(batch_buckets=None))
        ref = s2s_valid_rows(cpu.run(feed_of(pairs))[0])
        print("seq2seq: CPU reference of %d sentence pairs in %.1f s"
              % (len(pairs), time.perf_counter() - t0), flush=True)
    got = s2s_valid_rows(out)
    fetch = engine.fetch_names[0]
    errs, lo = [], 0
    for (status, body, _), req in zip(replies, requests):
        if status != 200:
            raise SystemExit("chip_smoke: HTTP %d: %s" % (status, body))
        seqs = body["outputs"][fetch]
        if len(seqs) != len(req):
            raise SystemExit("chip_smoke: a reply of %d sequences"
                             % len(seqs))
        err = 0.0
        for k, s in enumerate(seqs):
            s = np.asarray(s, np.float32)
            if s.shape != ref[lo + k].shape:
                raise SystemExit("chip_smoke: reply shape %s, want %s"
                                 % (s.shape, ref[lo + k].shape))
            err = max(err, float(np.abs(s - ref[lo + k]).max()))
        errs.append(err)
        lo += len(req)
    if [g.shape for g in got] != [r.shape for r in ref] \
            or not all(np.isfinite(g).all() for g in got):
        raise SystemExit("chip_smoke: engine.run gave %s"
                         % ([g.shape for g in got],))
    errs.append(max(float(np.abs(g - r).max()) for g, r in zip(got, ref)))
    print("seq2seq: served probabilities (valid rows) max_abs_err against "
          "the CPU plain path: HTTP requests %s, engine.run %.3g (atol %g)"
          % (", ".join("%.3g" % e for e in errs[:-1]), errs[-1],
             S2S_PROB_ATOL), flush=True)
    if max(errs) > S2S_PROB_ATOL:
        raise SystemExit("chip_smoke: served probabilities disagree with "
                         "the CPU plain path")


def s2s_convergence(exe):
    """tests/test_machine_translation.py's loop on the card (dict 1,000,
    batch 8, 60 Adam steps at lr 0.02): every loss finite; from each of
    S2S_CONV_INITS initial states the JAX test's criterion (printed) and
    the fall of the first 6 batches' loss after the steps against the
    losses recorded on them, whose mean over the states is the gate
    (S2S_CONV_FALL).  The seed-0 state runs twice.  Before that, one
    step from one state and feed, twice, without PyTorch's deterministic
    algorithms: no grad and no state tensor may differ bit for bit
    (`repeat_gate`)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import io

    main, startup, loss, _, fvars = build_seq2seq(S2S_CONV_DICT)
    block = main.desc.blocks[0]
    feeds = [s2s_feed(fvars, b) for b in s2s_batches(
        S2S_CONV_DICT, S2S_CHECK_BATCH, S2S_CONV_STEPS)]
    evaluate = io.prune_program(main, [loss.name])
    persist = [n for n, v in block.vars.items() if v.persistable]

    def state(seed):
        scope = fluid.Scope()
        startup.random_seed = seed
        exe.run(startup, scope=scope)
        return {n: scope.get(n).cpu().numpy() for n in persist}

    # one step from one state and feed, twice: the same bits
    init = params_scope(state(0), exe.device)
    repeat_gate("seq2seq", exe, main, feeds[0],
                {n: init.get(n) for n in persist})
    del init

    t0 = time.perf_counter()
    rows = []
    for seed in list(range(S2S_CONV_INITS)) + [0]:
        scope = params_scope(state(seed), exe.device)
        losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)[0][0]) for f in feeds]
        after = [float(exe.run(evaluate, feed=f, fetch_list=[loss],
                               scope=scope)[0][0]) for f in feeds[:6]]
        if not np.isfinite(losses + after).all():
            raise SystemExit("chip_smoke: the seq2seq book loop gave "
                             "non-finite losses from state %d" % seed)
        rows.append((seed, np.mean(losses[:6]), np.mean(losses[-6:]),
                     np.mean(losses[:6]) - np.mean(after)))
        del scope
    for seed, first, last, fall in rows:
        print("seq2seq: book loop from state %d: the JAX test's criterion "
              "%.4f -> %.4f (%s); the first 6 batches after the steps "
              "%.4f lower" % (seed, first, last,
                              "holds" if last < first else "fails", fall),
              flush=True)
    falls = [r[3] for r in rows[:S2S_CONV_INITS]]
    print("seq2seq: the book loop at dict %d, batch %d, %d Adam steps from "
          "%d states (and state 0 again) in %.1f s: the JAX test's "
          "criterion holds from %d of %d; state 0 twice: last-6 means "
          "%.4f, %.4f, falls %.4f, %.4f; the mean fall of the first 6 "
          "batches %.4f (standard deviation %.4f; gate > %g)"
          % (S2S_CONV_DICT, S2S_CHECK_BATCH, S2S_CONV_STEPS,
             S2S_CONV_INITS, time.perf_counter() - t0,
             sum(r[2] < r[1] for r in rows[:S2S_CONV_INITS]),
             S2S_CONV_INITS, rows[0][2], rows[-1][2], rows[0][3],
             rows[-1][3], np.mean(falls), np.std(falls), S2S_CONV_FALL),
          flush=True)
    if not np.mean(falls) > S2S_CONV_FALL:
        raise SystemExit("chip_smoke: the seq2seq book loop did not "
                         "converge")


def phase_seq2seq():
    """tests/test_machine_translation.py's seq2seq through the port's
    layers (phase 11): its two blocks, op counts and parameter count at
    the full dictionary; 3 Adam steps at batch 8 on the card against the
    CPU plain path from one state; the book loop's convergence on the
    card (`s2s_convergence`); one step with CUDA's synchronizing calls made errors;
    the export served against the CPU; the step's time, target tokens/s,
    peak memory, launches and busy share at batch 8 and 128; the
    `recurrent` op alone beside its bound and cuDNN's RNN.  Returns the
    launch counts of the batch-8 steps (no hand-written kernel runs
    here)."""
    import torch
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import io

    t0 = time.perf_counter()
    main, startup, loss, prob, fvars = build_seq2seq(S2S_DICT)
    blocks = main.desc.blocks
    counts = collections.Counter(op.type for op in blocks[0].ops)
    step_types = sorted(op.type for op in blocks[1].ops)
    n_values = sum(int(np.prod(v.shape)) for v in blocks[0].vars.values()
                   if v.is_parameter)
    print("seq2seq: %d blocks; block 0 %d ops of %d types (%s); block 1 "
          "(the decoder step) %d ops: %s; %d parameter values; built in "
          "%.1f s"
          % (len(blocks), len(blocks[0].ops), len(counts), ", ".join(
              "%s %d" % kv for kv in sorted(counts.items())),
             len(blocks[1].ops) if len(blocks) > 1 else 0,
             ", ".join(step_types), n_values, time.perf_counter() - t0),
          flush=True)
    if len(blocks) != 2 or len(blocks[0].ops) != 42 \
            or step_types != S2S_STEP_OPS or n_values != S2S_PARAMS:
        raise SystemExit("chip_smoke: the seq2seq program is not the JAX "
                         "package's (2 blocks, 42 + 8 ops, %d parameter "
                         "values)" % S2S_PARAMS)
    exe = fluid.Executor()
    if exe.device.type != "cuda":
        raise SystemExit("chip_smoke: the executor is not on the card")
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    block = blocks[0]
    persist = [n for n, v in block.vars.items() if v.persistable]
    init = {n: scope.get(n).cpu().numpy() for n in persist}
    del scope
    params = [n for n in persist if n + "_moment1_0" in block.vars]
    groups = {"parameters": params,
              "moment1": [n + "_moment1_0" for n in params],
              "moment2": [n + "_moment2_0" for n in params]}

    # 3 Adam steps at batch 8 from one state, on the CPU and on the card
    batches = s2s_batches(S2S_DICT, S2S_CHECK_BATCH, TRAIN_STEPS)
    feeds = [s2s_feed(fvars, b) for b in batches]
    cpu, cpu_state, secs = run_from_state(
        fluid.Executor(fluid.CPUPlace()), main, loss, init, feeds)
    print("seq2seq: %d steps at batch %d (target rows %s, padded to %s "
          "steps) on the CPU plain path in %.1f s, losses %s"
          % (TRAIN_STEPS, S2S_CHECK_BATCH,
             [int(f[S2S_FEEDS[2]].nvalid) for f in feeds],
             [f[S2S_FEEDS[1]].max_seqlen for f in feeds], secs,
             ", ".join("%.6f" % x for x in cpu)), flush=True)
    reset_launches()
    card, card_state, secs = run_from_state(exe, main, loss, init, feeds)
    launches = read_launches()
    loss_err = max(abs(a - b) for a, b in zip(card, cpu))
    errs = {n: change_rl2(card_state, cpu_state, init, [n])
            for names in groups.values() for n in names}
    worst = {g: max(errs[n] for n in names) for g, names in groups.items()}
    print("seq2seq: the same %d steps on the card in %.1f s: losses %s, "
          "max_abs_err %.3g (atol %g); each tensor's change over the steps, "
          "relative L2 error, worst: %s (limits %g, %g); hand-written kernel "
          "launches %s"
          % (TRAIN_STEPS, secs, ", ".join("%.6f" % x for x in card),
             loss_err, S2S_LOSS_ATOL,
             ", ".join("%s %.3g (%s)" % (g, v, max(
                 groups[g], key=lambda n: errs[n])) for g, v in
                 worst.items()), S2S_PARAM_RL2, S2S_MOMENT_RL2,
             json.dumps(launches)), flush=True)
    if loss_err > S2S_LOSS_ATOL or worst["parameters"] > S2S_PARAM_RL2 \
            or max(worst["moment1"], worst["moment2"]) > S2S_MOMENT_RL2 \
            or not all(np.isfinite(v).all() for v in card_state.values()):
        raise SystemExit("chip_smoke: seq2seq steps on the card disagree "
                         "with the CPU plain path")

    # the book loop's convergence, on the card (see S2S_CONV_INITS)
    s2s_convergence(exe)

    # one training step with synchronizing calls made errors
    scope = params_scope(cpu_state, exe.device)
    dev_feed = s2s_feed(fvars, batches[0], exe.device)
    exe.run(main, feed=dev_feed, fetch_list=[loss], scope=scope,
            return_numpy=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = exe.run(main, feed=dev_feed, fetch_list=[loss], scope=scope,
                      return_numpy=False)[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise SystemExit("chip_smoke: the seq2seq step gave %s" % out)
    print("seq2seq: no synchronizing call in one training step (the %d-step "
          "decoder recurrence and its generic grad)"
          % dev_feed[S2S_FEEDS[1]].max_seqlen, flush=True)
    del scope

    # served: 3 requests of 1, 2 and 3 pairs, then 8 in one engine.run
    import paddle_tpu_torch as paddle

    pairs = []
    for src, trg_in, _ in paddle.dataset.wmt14.test(S2S_DICT)():
        pairs.append((np.asarray(src, np.int64).reshape(-1, 1),
                      np.asarray(trg_in, np.int64).reshape(-1, 1)))
        if len(pairs) == S2S_SERVE:
            break
    s2s_serve(cpu_state, main, prob, pairs)

    # the step's time at batch 8 and 128, feeds on the card
    op_types = set(counts)
    env = None
    for batch in S2S_TIMED:
        b = s2s_batches(S2S_DICT, batch, 1)[0]
        dev_feed = s2s_feed(fvars, b, exe.device)
        tokens = int(dev_feed[S2S_FEEDS[2]].nvalid)
        scope = params_scope(init, exe.device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = [float(exe.run(main, feed=dev_feed, fetch_list=[loss],
                                scope=scope)[0][0])
                  for _ in range(TRAIN_STEPS)]
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        print("seq2seq batch %d: %d steps (%d target tokens, decoder %d "
              "steps) in %.2f s, losses %s; peak memory %.3f GB"
              % (batch, TRAIN_STEPS, tokens,
                 dev_feed[S2S_FEEDS[1]].max_seqlen, seconds,
                 ", ".join("%.6f" % x for x in losses), peak / 1e9),
              flush=True)
        if not np.isfinite(losses).all():
            raise SystemExit("chip_smoke: seq2seq losses %s" % losses)

        def step():
            return exe.run(main, feed=dev_feed, fetch_list=[loss],
                           scope=scope, return_numpy=False)

        times = timed_steps(step)
        med = float(np.median(times))
        print("seq2seq batch %d: step %.3f ms (median of 10 after 2 warm; "
              "mean %.3f, min %.3f, max %.3f), %.1f target tokens/s, %.1f "
              "sentence pairs/s"
              % (batch, med, np.mean(times), min(times), max(times),
                 tokens / med * 1e3, batch / med * 1e3), flush=True)
        p = profile_step(step, op_types, 0, med)
        if p is not None:
            print("seq2seq batch %d: in the profiled step recurrent %.3f "
                  "device ms, %.3f host ms; recurrent_grad %.3f device ms "
                  "(its recompute; the backward half runs on autograd's "
                  "thread), %.3f host ms"
                  % ((batch,) + p["ops"].get("recurrent", (0, 0, 0))[:2]
                     + p["ops"].get("recurrent_grad", (0, 0, 0))[:2]),
                  flush=True)
        if batch == max(S2S_TIMED):
            rec = next(op for op in block.ops if op.type == "recurrent")
            names = [n for names in rec.inputs.values() for n in names]
            probe = io.prune_program(main, [n for n in names
                                            if n not in init])
            outs = exe.run(probe, feed=dev_feed, fetch_list=[
                n for n in names if n not in init], scope=scope,
                return_numpy=False)
            env = dict(zip([n for n in names if n not in init], outs))
            env.update({n: scope.get(n) for n in names if n in init})
            mask = env[rec.input("Mask")[0]]
        del scope
        torch.cuda.empty_cache()

    # the recurrent op alone at batch 128
    T, B = mask.shape[0], mask.shape[1]
    og = torch.randn(T, B, S2S_DICT, device=exe.device,
                     generator=torch.Generator(exe.device).manual_seed(SEED))
    t = recurrent_op_times(main, env, og)
    valid = int(mask.sum().item())
    fb, fby = recurrent_bound(T, B, valid, S2S_HID, S2S_DICT, S2S_EMB)
    gb, gby = recurrent_bound(T, B, valid, S2S_HID, S2S_DICT, S2S_EMB,
                              grad=True)

    def fmt(v):
        return "not measured" if v is None else "%.4f" % v

    print("seq2seq: recurrent op at [%d steps x %d, %d valid; hidden %d, "
          "projection %d]: forward device %s ms (graph replay), eager "
          "%.4f ms, bound %.4f ms by %s; grad (generic vjp) device %s ms, "
          "eager %.4f ms, bound %.4f ms by %s; cuDNN nn.RNN(tanh) over the "
          "same hidden recurrence (no per-step projection or softmax; a "
          "different function) forward %s ms, forward and backward %s ms"
          % (T, B, valid, S2S_HID, S2S_DICT, fmt(t["forward"]), t["plain"],
             fb, fby, fmt(t["grad"]), t["plain_grad"], gb, gby,
             fmt(t["cudnn"]), fmt(t["cudnn_grad"])), flush=True)
    return launches


# -- the repeat gates (phases 10-12) -----------------------------------------

def same_bits(a, b):
    """Whether two values (tensors, or RaggedTensors and SelectedRows:
    their ids and values) hold the same bits."""
    import torch
    from paddle_tpu_torch.core.ragged import RaggedTensor, SelectedRows

    if isinstance(a, SelectedRows):
        return isinstance(b, SelectedRows) and a.height == b.height \
            and same_bits(a.rows, b.rows) and same_bits(a.values, b.values)
    if isinstance(a, RaggedTensor):
        return isinstance(b, RaggedTensor) and a.lod() == b.lod() \
            and same_bits(a.values, b.values)
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.detach().reshape(-1).view(torch.uint8),
        b.detach().reshape(-1).view(torch.uint8))


def repeat_step(exe, main, feed, state):
    """One step of `main` on `feed`, twice, each from a copy of `state`
    ({name: tensor on the card}) in a fresh scope, without PyTorch's
    deterministic algorithms: the names of the grads (every parameter's
    @GRAD, fetched) and of the tensors of `state` after the step that
    differ bit for bit between the two runs, and the count compared."""
    import torch
    from paddle_tpu_torch.fluid import Scope

    if torch.are_deterministic_algorithms_enabled():
        raise SystemExit("chip_smoke: torch's deterministic mode is on")
    grads = [p.name + "@GRAD" for p in main.global_block().all_parameters()]
    runs = []
    for _ in range(2):
        scope = Scope()
        for n, t in state.items():
            scope.set(n, t.clone())
        fetched = exe.run(main, feed=feed, fetch_list=grads, scope=scope,
                          return_numpy=False)
        runs.append((fetched, {n: scope.get(n) for n in state}))
        del scope
    differ = [g for g, a, b in zip(grads, runs[0][0], runs[1][0])
              if not same_bits(a, b)]
    differ += [n for n in state
               if not same_bits(runs[0][1][n], runs[1][1][n])]
    return differ, len(grads) + len(state)


def repeat_gate(tag, exe, main, feed, state):
    """`repeat_step`, printed; the gate: nothing may differ."""
    differ, n = repeat_step(exe, main, feed, state)
    print("%s: one step from one state and feed, run twice without torch's "
          "deterministic algorithms: %s of %d grads and state tensors "
          "differ bit for bit%s"
          % (tag, len(differ), n, (" (%s)" % ", ".join(differ))
             if differ else ""), flush=True)
    if differ:
        raise SystemExit("chip_smoke: %s: a step run twice differs in %s"
                         % (tag, differ))


# -- phase 12: the Fluid book's chapters --------------------------------------

# sentiment (tests/test_understand_sentiment.py's conv net,
# models/text.py conv_text_classifier) at the model's own widths:
# embedding 128, hidden 128, filters 3 and 4, over the 5,147-word imdb
# dictionary (the cutoff-150 dictionary's size; the synthetic reader's
# 512 sequences of 8-60 ids), 2 classes, Adam at lr 0.05 as the JAX test
# trains it; 774,274 parameter values
BOOK_DICT, BOOK_EMB, BOOK_HID, BOOK_CLASSES = 5147, 128, 128, 2
BOOK_LR = 0.05
BOOK_BATCHES = (128, 16)   # timed; 16 is the JAX test's batch
BOOK_PARAMS = BOOK_DICT * BOOK_EMB + (3 + 4) * BOOK_EMB * BOOK_HID \
    + 2 * BOOK_HID + 2 * BOOK_HID * BOOK_CLASSES + BOOK_CLASSES
BOOK_SERVE = (1, 2, 3)     # sequences in the 3 concurrent requests
BOOK_BUCKETS = [1, 2, 4, 8]
# the card against the CPU, 3 Adam steps at batch 16 from one state: f32
# on both sides (TF32 off), sums in other orders (cuBLAS against CPU
# BLAS, 128-wide products).  The loss (about ln 2) at 1e-5, 170 ulps;
# the steps' change in relative L2 at 1e-4 (parameters: Adam moves an
# entry by about lr times the sign of its grad, so an embedding entry
# whose grad lies at the rounding floor steps apart on the two sides)
# and 1e-5 (moments, which follow the grads' values).  An embedding row
# or a filter left unchanged reads order 1e-2 in the parameters
BOOK_LOSS_ATOL = 1e-5
BOOK_PARAM_RL2 = 1e-4
BOOK_MOMENT_RL2 = 1e-5
# served probabilities against the CPU plain path, f32 (one ulp of a
# probability near 0.5 is 6e-8)
BOOK_PROB_ATOL = 1e-6
# the other chapters at their JAX tests' programs and batches: SRL
# (tests/test_label_semantic_roles.py: embeddings of 16, two
# dynamic_lstm of hidden 32, the second reversed, linear_chain_crf and
# crf_decoding sharing `crfw`, SGD at lr 0.01) at batch 8 and 128;
# word2vec (test_word2vec.py, SGD at 0.1) at 64; the recommender
# (test_recommender_system.py, SGD at 0.2) at 64; fit-a-line
# (test_fit_a_line.py, SGD at 0.01) at 20
BOOK_CHAPTERS = (("srl", 8), ("srl", 128), ("word2vec", 64),
                 ("recommender", 64), ("fit_a_line", 20))
# their 3 steps on the card against the CPU from one state: f32 on both
# sides, sums in other orders.  The loss within 1e-5 of its magnitude
# (the SRL's summed CRF likelihood is about 100, where one ulp is
# 7.6e-6), and the steps' change of the parameters in relative L2 at
# 1e-4 (SGD moves each entry by lr times its grad, whose relative error
# is that of the sums, about 1e-6; a parameter left unchanged reads 1)
BOOK_STEP_RTOL = 1e-5
BOOK_STEP_RL2 = 1e-4
# each op on the card against its CPU run, forward and generic grad:
# f32 sums in other orders over at most a few hundred terms, at 1e-5
# of the larger of 1 and the output's largest magnitude; integer
# outputs, Viterbi paths and chunk counts exactly
BOOK_OP_RTOL = 1e-5
# H100 SXM float64 outside the tensor cores (NVIDIA data sheet, 700 W):
# crf_decoding's rate
F64_CORE_FLOPS = 34e12


def book_ragged(lengths, width, seed, hi=None, pad=3):
    """A lod-level-1 RaggedTensor on the CPU: `lengths` rows of `width`
    values (randn, or ints in [0, hi)), then `pad` padding rows, with
    the length hint; from the seed."""
    import torch
    from paddle_tpu_torch.core.ragged import RaggedTensor, bucket_max_seqlen

    rs = np.random.RandomState(seed)
    total = int(sum(lengths))
    if hi is None:
        vals = rs.randn(total + pad, width).astype(np.float32)
    else:
        vals = rs.randint(0, hi, size=(total + pad, width)).astype(np.int32)
    vals[total:] = 0
    splits = np.cumsum([0] + list(lengths)).astype(np.int32)
    return RaggedTensor(torch.from_numpy(vals), [torch.from_numpy(splits)],
                        nvalid=total, max_seqlen=bucket_max_seqlen(lengths))


def book_op_cases():
    """(op, ins {slot: [(name, CPU value)]}, outs {slot: [names]}, attrs,
    differentiated input slots, output grads {slot: value}) for each of
    the 15 op types of the sequence-op slice, from the seed, with an
    empty and a length-1 sequence among mixed lengths."""
    import torch

    lengths = [7, 0, 12, 1, 30, 5, 19, 2]
    B, T = len(lengths), sum(lengths) + 3
    rs = np.random.RandomState(SEED + 120)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(
            np.float32))

    def og_like(x, width):
        return x.with_values(t(x.values.shape[0], width))

    x128 = book_ragged(lengths, 128, SEED + 121)
    x16 = book_ragged(lengths, 16, SEED + 122)
    x1 = book_ragged(lengths, 1, SEED + 123)
    emis = book_ragged(lengths, 59, SEED + 124)
    tags = book_ragged(lengths, 1, SEED + 125, hi=59)
    gx = book_ragged(lengths, 96, SEED + 126)
    gx.values.mul_(0.5)
    other = book_ragged([3, 2, 0, 1, 4, 0, 2, 5], 16, SEED + 127)
    inf_tags = tags.with_values(torch.where(
        torch.from_numpy(rs.rand(T, 1) < 0.7), tags.values,
        torch.from_numpy(rs.randint(0, 59, size=(T, 1)).astype(np.int32))))
    cases = [
        ("cos_sim", {"X": [("x", t(256, 200))], "Y": [("y", t(256, 200))]},
         {"Out": ["o"], "XNorm": ["xn"], "YNorm": ["yn"]}, {},
         ["X", "Y"], {"Out": t(256, 1)}),
        ("sequence_conv", {"X": [("x", x128)],
                           "Filter": [("f", t(4 * 128, 128, scale=0.05))]},
         {"Out": ["o"]}, {"contextStart": -2, "contextLength": 4,
                          "contextStride": 1},
         ["X", "Filter"], {"Out": og_like(x128, 128)}),
        ("linear_chain_crf", {"Emission": [("e", emis)],
                              "Transition": [("tr", t(61, 59, scale=0.5))],
                              "Label": [("l", tags)]},
         {"Alpha": ["al"], "EmissionExps": ["ee"], "TransitionExps": ["te"],
          "LogLikelihood": ["ll"]}, {}, ["Emission", "Transition"],
         {"LogLikelihood": t(B, 1)}),
        ("crf_decoding", {"Emission": [("e", emis)],
                          "Transition": [("tr", t(61, 59, scale=0.5))]},
         {"ViterbiPath": ["p"]}, {}, [], None),
        ("crf_decoding", {"Emission": [("e", emis)],
                          "Transition": [("tr", t(61, 59, scale=0.5))],
                          "Label": [("l", tags)]},
         {"ViterbiPath": ["p"]}, {}, [], None),
        ("chunk_eval", {"Inference": [("i", inf_tags)],
                        "Label": [("l", tags)]},
         {s: [s.lower()] for s in ("Precision", "Recall", "F1-Score",
                                   "NumInferChunks", "NumLabelChunks",
                                   "NumCorrectChunks")},
         {"num_chunk_types": 29, "chunk_scheme": "IOB",
          "excluded_chunk_types": []}, [], None),
        ("sequence_softmax", {"X": [("x", x1)]}, {"Out": ["o"]}, {}, ["X"],
         {"Out": og_like(x1, 1)}),
        ("row_conv", {"X": [("x", x16)], "Filter": [("f", t(3, 16))]},
         {"Out": ["o"]}, {}, ["X", "Filter"], {"Out": og_like(x16, 16)}),
        ("sequence_expand", {"X": [("x", t(B, 16))], "Y": [("y", x16)]},
         {"Out": ["o"]}, {}, ["X"], {"Out": og_like(x16, 16)}),
        ("sequence_concat", {"X": [("a", x16), ("b", other)]},
         {"Out": ["o"]}, {"axis": 0}, ["X"], None),
        ("sequence_reshape", {"X": [("x", x16)]}, {"Out": ["o"]},
         {"new_dim": 8}, ["X"], None),
        ("sequence_slice", {"X": [("x", x16)],
                            "Offset": [("off", torch.tensor(
                                [[2], [0], [5], [0], [10], [1], [0], [1]],
                                dtype=torch.int32))],
                            "Length": [("len", torch.tensor(
                                [[3], [0], [6], [1], [15], [4], [19], [1]],
                                dtype=torch.int32))]},
         {"Out": ["o"]}, {}, ["X"], None),
        ("sequence_reverse", {"X": [("x", x16)]}, {"Y": ["y"]}, {}, ["X"],
         {"Y": og_like(x16, 16)}),
        ("lod_reset", {"X": [("x", t(T, 16))]}, {"Out": ["o"]},
         {"target_lod": [0, 40, T]}, ["X"], None),
        ("gru", {"Input": [("x", gx)], "Weight": [("w", t(32, 96,
                                                          scale=0.3))],
                 "Bias": [("b", t(1, 96, scale=0.3))]},
         {"Hidden": ["h"], "BatchGate": ["bg"],
          "BatchResetHiddenPrev": ["br"], "BatchHidden": ["bh"]},
         {"is_reverse": True}, ["Input", "Weight", "Bias"],
         {"Hidden": og_like(gx, 32)}),
        ("gru_unit", {"Input": [("x", t(64, 96, scale=0.5))],
                      "HiddenPrev": [("h", t(64, 32))],
                      "Weight": [("w", t(32, 96, scale=0.3))],
                      "Bias": [("b", t(1, 96, scale=0.3))]},
         {"Gate": ["g"], "ResetHiddenPrev": ["r"], "Hidden": ["o"]}, {},
         ["Input", "HiddenPrev", "Weight", "Bias"],
         {"Hidden": t(64, 32), "Gate": t(64, 96)}),
    ]
    return cases


def book_run_op(op_type, ins, outs, attrs, device):
    """Op `op_type` through the executor's `apply_op` on `device` (its
    inputs moved there): {output name: value}."""
    from paddle_tpu_torch.core.desc import OpDesc
    from paddle_tpu_torch.fluid import executor as ex

    env = {n: v.to(device) for vals in ins.values() for n, v in vals
           if v is not None}
    names = {s: [n if v is not None else ex.EMPTY for n, v in vals]
             for s, vals in ins.items()}
    ctx = ex.ExecContext(None, 0, env, device=device)
    ex.apply_op(ctx, OpDesc(op_type, names, outs, attrs))
    return {n: ctx.env[n] for ns in outs.values() for n in ns}


def book_grad_ins(ins, outs, out_grads, fwd_env):
    """A generic grad op's inputs as the backward builder lays them out:
    the forward's inputs, its outputs (O@ slots, unread) and the output
    grads (OG@ slots; absent ones get zeros like the output)."""
    import torch
    from paddle_tpu_torch.core.ragged import RaggedTensor

    g = dict(ins)
    for slot, names in outs.items():
        g["O@" + slot] = [(n, None) for n in names]
        grads = []
        for n in names:
            v = (out_grads or {}).get(slot)
            if v is None:
                like = fwd_env[n]
                if isinstance(like, RaggedTensor):
                    v = like.with_values(torch.zeros(
                        like.values.shape, dtype=torch.float32))
                else:
                    v = torch.zeros(like.shape, dtype=torch.float32)
            grads.append((n + "@GRAD", v.to("cpu")))
        g["OG@" + slot] = grads
    return g


def book_host(v):
    """(values as an ndarray, lod or None) of an op's output."""
    from paddle_tpu_torch.core.ragged import RaggedTensor

    lod = v.lod() if isinstance(v, RaggedTensor) else None
    v = v.values if isinstance(v, RaggedTensor) else v
    return v.detach().float().cpu().numpy() if v.is_floating_point() \
        else v.cpu().numpy(), lod


def book_compare(tag, got, ref):
    """The largest error of each output of `got` (card) against `ref`
    (CPU): floats relative to the larger of 1 and the reference's
    magnitude, the rest exactly (an integer mismatch reads inf); lods
    must be equal."""
    worst = 0.0
    for n, r in ref.items():
        (gv, glod), (rv, rlod) = book_host(got[n]), book_host(r)
        if glod != rlod or gv.shape != rv.shape:
            raise SystemExit("chip_smoke: %s: %s has lod %s shape %s on the "
                             "card, %s %s on the CPU"
                             % (tag, n, glod, gv.shape, rlod, rv.shape))
        if gv.size == 0:
            continue
        if not np.issubdtype(rv.dtype, np.floating):
            worst = max(worst, 0.0 if np.array_equal(gv, rv) else np.inf)
            continue
        worst = max(worst, float(np.abs(gv - rv).max()) / max(
            1.0, float(np.abs(rv).max())))
    return worst


def book_ops(device):
    """Each op of the slice on the card against its CPU run, forward and
    generic grad (gate BOOK_OP_RTOL; integers exact), and whether each
    grad repeats bit for bit on the card (reported)."""
    import torch

    cpu = torch.device("cpu")
    repeats_not = []
    for op, ins, outs, attrs, diff, out_grads in book_op_cases():
        ref = book_run_op(op, ins, outs, attrs, cpu)
        got = book_run_op(op, ins, outs, attrs, device)
        fwd_err = book_compare(op, got, ref)
        line = "book: op %s on the card against the CPU: forward %.3g" \
            % (op + (" (with Label)" if op == "crf_decoding"
                     and "Label" in ins else ""), fwd_err)
        grad_err = 0.0
        if diff:
            gins = book_grad_ins(ins, outs, out_grads, ref)
            gouts = {s + "@GRAD": ["%s@GRAD" % n for n, _ in ins[s]]
                     for s in diff}
            gref = book_run_op(op + "_grad", gins, gouts, attrs, cpu)
            ggot = book_run_op(op + "_grad", gins, gouts, attrs, device)
            grad_err = book_compare(op + "_grad", ggot, gref)
            again = book_run_op(op + "_grad", gins, gouts, attrs, device)
            same = all(same_bits(ggot[n], again[n]) for n in ggot)
            if not same:
                repeats_not.append(op + "_grad")
            line += ", generic grad %.3g (%s); the grad twice on the " \
                "card: %s" % (grad_err, ", ".join(diff),
                              "the same bits" if same else "DIFFERS")
        print(line + " (gate %g of the larger of 1 and the magnitude; "
              "integers exact)" % BOOK_OP_RTOL, flush=True)
        if not fwd_err <= BOOK_OP_RTOL or not grad_err <= BOOK_OP_RTOL:
            raise SystemExit("chip_smoke: op %s on the card disagrees with "
                             "the CPU" % op)
    print("book: generic grads that differ bit for bit when run twice on "
          "the card: %s" % (", ".join(repeats_not) or "none"), flush=True)


def build_book(chapter, **kwargs):
    """A chapter's program through the port's layers, as its JAX test
    builds it: (main, startup, loss, feed vars, the chapter's output,
    reader).  Chapters: "sentiment" (kwargs emb, hid), "srl",
    "word2vec", "recommender", "fit_a_line"."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import models

    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        if chapter == "sentiment":
            data = L.data(name="words", shape=[1], dtype="int64",
                          lod_level=1)
            label = L.data(name="label", shape=[1], dtype="int64")
            out = models.conv_text_classifier(
                data, len(paddle.dataset.imdb.word_dict()),
                class_dim=BOOK_CLASSES, emb_dim=kwargs.get("emb", BOOK_EMB),
                hid_dim=kwargs.get("hid", BOOK_HID))
            loss = L.mean(x=L.cross_entropy(input=out, label=label))
            L.accuracy(input=out, label=label)
            fluid.optimizer.Adam(learning_rate=BOOK_LR).minimize(loss)
            fvars, reader = [data, label], paddle.dataset.imdb.train()
        elif chapter == "srl":
            words, verbs, labels = paddle.dataset.conll05.get_dict()
            fvars = [L.data(name=n, shape=[1], dtype="int64", lod_level=1)
                     for n in ("word_data", "verb_data", "mark_data",
                               "target")]
            embs = [L.embedding(input=v, size=[n, 16]) for v, n in zip(
                fvars[:3], (len(words), len(verbs), 2))]
            hidden0 = L.fc(input=embs, size=128, act="tanh")
            lstm0, _ = L.dynamic_lstm(input=hidden0, size=128)
            fc1 = L.fc(input=[hidden0, lstm0], size=128, act="tanh")
            lstm1, _ = L.dynamic_lstm(input=fc1, size=128, is_reverse=True)
            feature = L.fc(input=[fc1, lstm1], size=len(labels), act=None)
            loss = L.mean(x=L.linear_chain_crf(
                input=feature, label=fvars[3],
                param_attr=fluid.ParamAttr(name="crfw")))
            fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
            out = L.crf_decoding(input=feature,
                                 param_attr=fluid.ParamAttr(name="crfw"))
            reader = paddle.reader.map_readers(
                lambda s: (s[0], s[6], s[7], s[8]),
                paddle.dataset.conll05.test())
        elif chapter == "word2vec":
            fvars = [L.data(name=n, shape=[1], dtype="int64")
                     for n in ("firstw", "secondw", "thirdw", "forthw",
                               "nextw")]
            n_words = len(paddle.dataset.imikolov.build_dict())
            out = models.word2vec_ngram(fvars[:4], n_words, emb_dim=32,
                                        hidden_size=256)
            loss = L.mean(x=L.cross_entropy(input=out, label=fvars[4]))
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
            reader = paddle.dataset.imikolov.train()
        elif chapter == "recommender":
            ml = paddle.dataset.movielens
            names = ("user_id", "gender_id", "age_id", "job_id", "movie_id")
            sizes = (ml.max_user_id() + 1, 2, len(ml.age_table),
                     ml.max_job_id() + 1, ml.max_movie_id() + 1)
            widths = (32, 16, 16, 16, 32)
            tables = ("user_table", "gender_table", "age_table",
                      "job_table", "movie_table")
            fvars = [L.data(name=n, shape=[1], dtype="int64") for n in names]
            fcs = [L.fc(input=L.embedding(input=v, size=[n, w],
                                          param_attr=tab), size=w)
                   for v, n, w, tab in zip(fvars, sizes, widths, tables)]
            usr = L.fc(input=fcs[:4], size=200, act="tanh")
            cat = L.data(name="category_id", shape=[1], dtype="int64",
                         lod_level=1)
            title = L.data(name="movie_title", shape=[1], dtype="int64",
                           lod_level=1)
            pools = [L.sequence_pool(input=L.embedding(input=v, size=[n,
                                                                      32]),
                                     pool_type="sum")
                     for v, n in ((cat, len(ml.movie_categories())),
                                  (title, 5000))]
            mov = L.fc(input=[fcs[4]] + pools, size=200, act="tanh")
            out = L.scale(x=L.cos_sim(X=usr, Y=mov), scale=5.0)
            score = L.data(name="score", shape=[1], dtype="float32")
            loss = L.mean(x=L.square_error_cost(input=out, label=score))
            fluid.optimizer.SGD(learning_rate=0.2).minimize(loss)
            fvars += [cat, title, score]
            reader = ml.train()
        elif chapter == "fit_a_line":
            x = L.data(name="x", shape=[13], dtype="float32")
            y = L.data(name="y", shape=[1], dtype="float32")
            out = L.fc(input=x, size=1, act=None)
            loss = L.mean(x=L.square_error_cost(input=out, label=y))
            fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
            fvars, reader = [x, y], paddle.dataset.uci_housing.train()
        else:
            raise ValueError("unknown chapter %r" % chapter)
    return main, startup, loss, fvars, out, reader


def book_batches(reader, batch, n):
    """The first `n` batches of `batch` samples of `reader`, taken again
    from its start when it runs out."""
    import paddle_tpu_torch as paddle

    out = []
    while len(out) < n:
        for b in paddle.batch(reader, batch_size=batch)():
            out.append(b)
            if len(out) == n:
                break
    return out


def book_feeds(main, fvars, batches, device=None):
    """DataFeeder's feeds of `batches` on the host, or moved to
    `device`."""
    import torch.utils._pytree as pytree
    import paddle_tpu_torch.fluid as fluid

    feeder = fluid.DataFeeder(feed_list=fvars, place=fluid.CPUPlace(),
                              program=main)
    feeds = [feeder.feed(b) for b in batches]
    if device is None:
        return feeds
    return [pytree.tree_map(lambda t: t.to(device), f) for f in feeds]


def book_state(exe, startup, main):
    """The persistables after `startup` on the executor's device, as
    host arrays."""
    import paddle_tpu_torch.fluid as fluid

    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    persist = [n for n, v in main.desc.block(0).vars.items()
               if v.persistable]
    return {n: scope.get(n).cpu().numpy() for n in persist}


def book_chapter(exe, chapter, batch, smi):
    """A chapter's 3 steps at `batch` on the card against the CPU plain
    path from one state (the loss within BOOK_STEP_RTOL of its size, the
    parameters' change within BOOK_STEP_RL2); for SRL the Viterbi paths
    of the first step and chunk_eval over them equal the CPU's; the
    step's time (median of 10 after 2 warm, feeds on the card)."""
    import torch
    import paddle_tpu_torch.fluid as fluid

    main, startup, loss, fvars, out, reader = build_book(chapter)
    batches = book_batches(reader, batch, TRAIN_STEPS)
    feeds = book_feeds(main, fvars, batches)
    init = book_state(exe, startup, main)
    params = [p.name for p in main.global_block().all_parameters()]
    decode = chapter == "srl"
    runs = {}
    for name, ex in (("cpu", fluid.Executor(fluid.CPUPlace())),
                     ("card", exe)):
        scope = params_scope(init, ex.device)
        t0 = time.perf_counter()
        losses, paths = [], []
        for f in feeds:
            outs = ex.run(main, feed=f, fetch_list=[loss] + (
                [out] if decode else []), scope=scope)
            losses.append(float(np.asarray(outs[0]).reshape(-1)[0]))
            if decode:
                paths.append(outs[1])
        runs[name] = (losses, paths, {n: scope.get(n).cpu().numpy()
                                      for n in params},
                      time.perf_counter() - t0)
    (cl, cp, cs, csec), (gl, gp, gs, gsec) = runs["cpu"], runs["card"]
    loss_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(gl, cl))
    errs = {n: change_rl2(gs, cs, init, [n]) for n in params}
    worst = max(errs, key=lambda n: errs[n])
    line = ("book %s batch %d: %d steps, CPU %.1f s, card %.1f s: losses "
            "%s (CPU %s), error %.3g of the loss (gate %g); the "
            "parameters' change, relative L2 error, worst %.3g (%s; gate "
            "%g)" % (chapter, batch, TRAIN_STEPS, csec, gsec, ", ".join(
                "%.6f" % x for x in gl), ", ".join("%.6f" % x for x in cl),
                loss_err, BOOK_STEP_RTOL, errs[worst], worst, BOOK_STEP_RL2))
    ok = loss_err <= BOOK_STEP_RTOL and errs[worst] <= BOOK_STEP_RL2 \
        and np.isfinite(gl).all()
    if decode:
        from paddle_tpu_torch.ops.crf import chunk_eval

        same = gp[0].lod() == cp[0].lod() and np.array_equal(
            gp[0].values.numpy(), cp[0].values.numpy())
        target = feeds[0]["target"]
        counts = []
        for p, dev in ((gp[0], exe.device), (cp[0], torch.device("cpu"))):
            ce = chunk_eval(None, {
                "Inference": [p.to(dev)], "Label": [target.to(dev)]},
                {"num_chunk_types": 29, "chunk_scheme": "IOB"})
            counts.append([float(ce[k][0][0]) for k in (
                "NumInferChunks", "NumLabelChunks", "NumCorrectChunks",
                "F1-Score")])
        line += ("; the first step's Viterbi paths (%d tags) %s the CPU's; "
                 "chunk_eval over them (IOB, 29 types) %s on the card, %s "
                 "on the CPU" % (int(target.nvalid), "equal" if same
                                 else "DIFFER FROM", counts[0], counts[1]))
        ok = ok and same and counts[0] == counts[1]
    print(line, flush=True)
    if not ok:
        raise SystemExit("chip_smoke: book %s at batch %d on the card "
                         "disagrees with the CPU plain path" % (chapter,
                                                                batch))
    scope = params_scope(init, exe.device)
    dev_feed = book_feeds(main, fvars, batches[:1], exe.device)[0]

    def step():
        return exe.run(main, feed=dev_feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)

    times = timed_steps(step)
    med = float(np.median(times))
    print("book %s batch %d: step %.3f ms (median of 10 after 2 warm; min "
          "%.3f, max %.3f), %.1f samples/s [%s]"
          % (chapter, batch, med, min(times), max(times), batch / med * 1e3,
             smi), flush=True)
    del scope


def seq_conv_bound(rows, d, k, m):
    """(ms, "bytes" | "operations") of sequence_conv's least time: X
    [rows, d], the filter [k d, m] read once, the output [rows, m]
    written once; 2 k d m operations a row on the f32 cores (TF32
    off)."""
    t_ops = 2.0 * rows * k * d * m / F32_CORE_FLOPS
    t_bytes = 4.0 * (rows * d + k * d * m + rows * m) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def crf_bound(lengths, d, grad=False):
    """(ms, "bytes" | "operations") of linear_chain_crf's least time on
    these lengths: the emission [T, d], the transition [d + 2, d] and
    the labels read once; Alpha and EmissionExps [T, d], TransitionExps
    and the likelihoods written once; 4 d^2 f32 operations a step after
    the first (alpha + w, the max's subtraction, the exponential, the
    sum) on the f32 cores.  The grad reads the same inputs and the
    likelihoods' grad and writes the emission's and transition's grads;
    it does the forward again and its backward, counted as twice the
    forward's operations."""
    T, B = int(sum(lengths)), len(lengths)
    steps = sum(max(n - 1, 0) for n in lengths)
    flops = 4.0 * d * d * steps
    ins = T * d + (d + 2) * d + T
    if grad:
        nbytes, flops = 4.0 * (ins + B + T * d + (d + 2) * d), 3 * flops
    else:
        nbytes = 4.0 * (ins + 2 * T * d + (d + 2) * d + B)
    t_ops, t_bytes = flops / F32_CORE_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def viterbi_bound(lengths, d):
    """(ms, "bytes" | "operations") of crf_decoding's least time: the f32
    emission [T, d] and the transition read once, the int32 path [T]
    written once; 2 d^2 float64 operations a step after the first (the
    additions and the comparisons of the max) at the f64 rate."""
    T = int(sum(lengths))
    steps = sum(max(n - 1, 0) for n in lengths)
    t_ops = 2.0 * d * d * steps / F64_CORE_FLOPS
    t_bytes = 4.0 * (T * d + (d + 2) * d + T) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def gru_bound(lengths, d, grad=False):
    """(ms, "bytes" | "operations") of gru's least time: the input [T,
    3d], the weight [d, 3d] and the bias read once, the hidden [T, d]
    written once; 6 d^2 operations of products a valid step (h W_ur, (r
    h) W_c) on the f32 cores (TF32 off).  The grad reads the inputs and
    the hidden's grad and writes the input's, weight's and bias's
    grads; the forward again and the products' two backward products:
    3 times the forward's."""
    T = int(sum(lengths))
    flops = 6.0 * d * d * T
    ins = 3 * T * d + 3 * d * d + 3 * d
    if grad:
        nbytes, flops = 4.0 * (2 * ins + T * d), 3 * flops
    else:
        nbytes = 4.0 * (ins + T * d)
    t_ops, t_bytes = flops / F32_CORE_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def book_op_times(device, smi):
    """Device ms (CUDA graph replay) of sequence_conv at the sentiment
    step's batch-128 shape beside F.conv1d over the zero-padded batch
    (the same function for contextStart -(k // 2)), of
    linear_chain_crf (forward and generic grad) and crf_decoding at the
    SRL's batch-128 shape, and of gru (forward and generic grad) over
    the sentiment's 128 sequences at hidden 128 beside cuDNN's nn.GRU (a
    different function: its reset gate multiplies after the product),
    each beside its bound."""
    import torch
    import torch.nn.functional as F
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.ragged import RaggedTensor, bucket_max_seqlen
    from paddle_tpu_torch.ops.registry import get_op_info, run_generic_grad
    from paddle_tpu_torch.ops.sequence import ragged_to_padded

    gen = torch.Generator(device=device).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=device, generator=gen) * scale

    def ragged(lengths, width, scale=1.0):
        splits = torch.tensor(np.cumsum([0] + list(lengths)),
                              dtype=torch.int32, device=device)
        return RaggedTensor(randn(int(sum(lengths)), width, scale=scale),
                            [splits], max_seqlen=bucket_max_seqlen(lengths))

    def fmt(v):
        return "not measured" if v is None else "%.4f" % v

    def replay(fn):
        try:
            return device_ms(fn, launches=5, replays=3)
        except RuntimeError as err:  # a capture the graph refused
            print("book: graph capture failed: %s" % str(err)[:200],
                  flush=True)
            return None

    def kernel(op):
        k = get_op_info(op).kernel

        def run(ins, attrs):
            with torch.no_grad():
                return k(None, ins, attrs)
        return run

    imdb = [len(s) for s, _ in book_batches(paddle.dataset.imdb.train(),
                                            128, 1)[0]]
    srl = [len(b[0]) for b in book_batches(paddle.dataset.conll05.test(),
                                           128, 1)[0]]
    rows = {}

    # sequence_conv, filter 4 (the wider branch), emb 128 -> hid 128
    k, d, m = 4, BOOK_EMB, BOOK_HID
    x = ragged(imdb, d)
    filt = randn(k * d, m, scale=0.05)
    attrs = {"contextStart": -(k // 2), "contextLength": k}
    conv = kernel("sequence_conv")
    ms = replay(lambda: conv({"X": [x], "Filter": [filt]}, attrs))
    plain = cuda_ms(lambda: conv({"X": [x], "Filter": [filt]}, attrs),
                    iters=10)
    padded, _ = ragged_to_padded(x)
    xp = F.pad(padded.transpose(1, 2), (k // 2, k - 1 - k // 2))
    w = filt.reshape(k, d, m).permute(2, 1, 0).contiguous()
    lib = replay(lambda: F.conv1d(xp, w))
    bound = seq_conv_bound(sum(imdb), d, k, m)
    rows["sequence_conv"] = (ms, plain, bound, lib)
    print("book: sequence_conv at [%d rows of %d sequences, %d -> %d, "
          "filter %d]: device %s ms (graph replay), eager %.4f ms, bound "
          "%.4f ms by %s; F.conv1d over the zero-padded [%d, %d, %d] batch "
          "(the same function) %s ms [%s]"
          % (sum(imdb), len(imdb), d, m, k, fmt(ms), plain, bound[0],
             bound[1], xp.shape[0], xp.shape[1], xp.shape[2], fmt(lib),
             smi), flush=True)

    # linear_chain_crf and its generic grad, crf_decoding: the SRL's
    # emission at batch 128 over its 59 labels
    d = 59
    e = ragged(srl, d)
    label = RaggedTensor(torch.randint(0, d, (int(sum(srl)), 1),
                                       device=device, generator=gen,
                                       dtype=torch.int32),
                         e.row_splits, max_seqlen=e.max_seqlen)
    trans = randn(d + 2, d, scale=0.5)
    crf = kernel("linear_chain_crf")
    ins = {"Emission": [e], "Transition": [trans], "Label": [label]}
    ms = replay(lambda: crf(ins, {}))
    plain = cuda_ms(lambda: crf(ins, {}), iters=5)
    og = randn(len(srl), 1)
    gins = dict(ins, **{"OG@LogLikelihood": [og]})

    def crf_grad():
        return run_generic_grad(None, "linear_chain_crf", gins, {})

    gms = replay(crf_grad)
    gplain = cuda_ms(crf_grad, iters=5)
    bound, gbound = crf_bound(srl, d), crf_bound(srl, d, grad=True)
    rows["linear_chain_crf"] = (ms, plain, bound, None)
    rows["linear_chain_crf_grad"] = (gms, gplain, gbound, None)
    dec = kernel("crf_decoding")
    dms = replay(lambda: dec({"Emission": [e], "Transition": [trans]}, {}))
    dplain = cuda_ms(lambda: dec({"Emission": [e], "Transition": [trans]},
                                 {}), iters=5)
    dbound = viterbi_bound(srl, d)
    rows["crf_decoding"] = (dms, dplain, dbound, None)
    print("book: linear_chain_crf at [%d rows of %d sequences (%d..%d "
          "steps), %d tags]: forward device %s ms, eager %.4f ms, bound "
          "%.4f ms by %s; grad (generic vjp) device %s ms, eager %.4f ms, "
          "bound %.4f ms by %s; crf_decoding (float64) device %s ms, eager "
          "%.4f ms, bound %.4f ms by %s; no one PyTorch call computes "
          "either [%s]"
          % (sum(srl), len(srl), min(srl), max(srl), d, fmt(ms), plain,
             bound[0], bound[1], fmt(gms), gplain, gbound[0], gbound[1],
             fmt(dms), dplain, dbound[0], dbound[1], smi), flush=True)

    # gru over the sentiment's 128 sequences, hidden 128
    h = BOOK_HID
    gx = ragged(imdb, 3 * h, scale=0.5)
    w, b = randn(h, 3 * h, scale=0.1), randn(1, 3 * h, scale=0.1)
    gru = kernel("gru")
    gins = {"Input": [gx], "Weight": [w], "Bias": [b]}
    ms = replay(lambda: gru(gins, {}))
    plain = cuda_ms(lambda: gru(gins, {}), iters=5)
    ogh = gx.with_values(randn(int(sum(imdb)), h))
    grad_ins = dict(gins, **{"OG@Hidden": [ogh]})

    def gru_grad():
        return run_generic_grad(None, "gru", grad_ins, {})

    gms = replay(gru_grad)
    gplain = cuda_ms(gru_grad, iters=3)
    bound, gbound = gru_bound(imdb, h), gru_bound(imdb, h, grad=True)
    rows["gru"] = (ms, plain, bound, None)
    rows["gru_grad"] = (gms, gplain, gbound, None)
    cudnn = torch.nn.GRU(3 * h, h, batch_first=True).to(device)
    xin = ragged_to_padded(gx)[0]
    c_ms = replay(lambda: cudnn(xin))
    xg = xin.clone().requires_grad_(True)

    def cudnn_fb():
        out, _ = cudnn(xg)
        out.sum().backward()

    c_fb = replay(cudnn_fb)
    print("book: gru at [%d sequences, %d rows (%d..%d steps, padded to "
          "%d), hidden %d]: forward device %s ms, eager %.4f ms, bound "
          "%.4f ms by %s; grad (generic vjp) device %s ms, eager %.4f ms, "
          "bound %.4f ms by %s; no one PyTorch call computes it: cuDNN's "
          "nn.GRU over the same padded input (its reset gate multiplies "
          "after the product, its own input product: a different "
          "function) forward %s ms, forward and backward %s ms [%s]"
          % (len(imdb), sum(imdb), min(imdb), max(imdb), gx.max_seqlen, h,
             fmt(ms), plain, bound[0], bound[1], fmt(gms), gplain,
             gbound[0], gbound[1], fmt(c_ms), fmt(c_fb), smi), flush=True)
    return rows


def book_serve(trained, main, prob, seqs):
    """The export of `prob` from the `words` feed, with the `trained`
    state, loaded by InferenceEngine on the card behind InferenceServer
    (its MicroBatcher): 3 concurrent requests of BOOK_SERVE ragged
    sequences against the CPU plain path.  Returns the largest error."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import io
    from paddle_tpu_torch.serving import (EngineConfig, InferenceEngine,
                                          InferenceServer, ServerConfig)

    parts = np.cumsum([0] + list(BOOK_SERVE))
    served = seqs[:parts[-1]]
    requests = [served[lo:hi] for lo, hi in zip(parts[:-1], parts[1:])]
    with tempfile.TemporaryDirectory() as tmp:
        with fluid.scope_guard(params_scope(trained, "cpu")):
            io.save_inference_model(
                tmp, ["words"], [prob], fluid.Executor(fluid.CPUPlace()),
                main, bucket_hints={"batch_buckets": BOOK_BUCKETS})
        engine = InferenceEngine.from_saved_model(tmp)
        if engine.place.device().type != "cuda":
            raise SystemExit("chip_smoke: the engine is not on the card")
        server = InferenceServer(engine, ServerConfig(
            port=0, max_batch=max(BOOK_BUCKETS), max_wait_ms=50.0,
            warmup=True))
        try:
            server.start()
            host, port = server.address
            url = "http://%s:%d/v1/infer" % (host, port)
            replies = [None] * len(requests)

            def client(i):
                replies[i] = _post(url, {"inputs": {"words": [
                    s.tolist() for s in requests[i]]}})

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(requests))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            if any(r is None for r in replies):
                raise SystemExit("chip_smoke: an HTTP request got no reply")
            print("book sentiment: %d requests of %s sequences (lengths %s) "
                  "answered in %d batch(es); latencies %s ms"
                  % (len(requests), list(BOOK_SERVE),
                     [[len(s) for s in r] for r in requests],
                     server.metrics.batch_occupancy.count,
                     ", ".join("%.1f" % r[2] for r in replies)), flush=True)
        finally:
            server.shutdown()
        ref = InferenceEngine.from_saved_model(
            tmp, place=fluid.CPUPlace(),
            config=EngineConfig(batch_buckets=None)).run(
                {"words": served})[0]
    errs, fetch = [], engine.fetch_names[0]
    for (status, body, _), lo, hi in zip(replies, parts[:-1], parts[1:]):
        if status != 200:
            raise SystemExit("chip_smoke: HTTP %d: %s" % (status, body))
        got = np.asarray(body["outputs"][fetch], np.float32)
        if got.shape != (hi - lo, BOOK_CLASSES) or not np.isfinite(got).all():
            raise SystemExit("chip_smoke: reply shape %s" % (got.shape,))
        errs.append(float(np.abs(got - ref[lo:hi]).max()))
    print("book sentiment: served probabilities max_abs_err against the CPU "
          "plain path: %s (atol %g)" % (", ".join("%.3g" % e for e in errs),
                                        BOOK_PROB_ATOL), flush=True)
    return max(errs)


def book_sentiment(exe, smi):
    """The sentiment chapter's conv model at full width (the phase's main
    path): its op counts and parameter count; 3 Adam steps at batch 16
    on the card against the CPU plain path from one state; the repeat
    gate; at each of BOOK_BATCHES one pass over the imdb reader through
    DataFeeder, device_prefetch and Executor.run (its first 3 steps'
    peak memory, the host time from one fetched loss to the next), the
    step's median on a fed batch, samples/s and a profiled step (busy
    share, launches); the export served.  Returns the launch counts of
    the checked steps."""
    import torch
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.reader import device_prefetch

    t0 = time.perf_counter()
    main, startup, loss, fvars, prob, reader = build_book("sentiment")
    block = main.desc.block(0)
    counts = collections.Counter(op.type for op in block.ops)
    n_values = sum(int(np.prod(v.shape)) for v in block.vars.values()
                   if v.is_parameter)
    print("book sentiment: main %d ops of %d types (%s), %d parameter "
          "values (%.3f M); built in %.1f s"
          % (len(block.ops), len(counts), ", ".join(
              "%s %d" % kv for kv in sorted(counts.items())), n_values,
             n_values / 1e6, time.perf_counter() - t0), flush=True)
    if n_values != BOOK_PARAMS or counts["sequence_conv"] != 2 \
            or counts["sequence_conv_grad"] != 2:
        raise SystemExit("chip_smoke: the sentiment program is not the JAX "
                         "package's (%d parameter values, two "
                         "sequence_conv)" % BOOK_PARAMS)
    init = book_state(exe, startup, main)
    params = [n for n in init if n + "_moment1_0" in block.vars]
    groups = {"parameters": params,
              "moment1": [n + "_moment1_0" for n in params],
              "moment2": [n + "_moment2_0" for n in params]}

    # 3 Adam steps at the JAX test's batch from one state
    batches = book_batches(reader, 16, TRAIN_STEPS)
    feeds = book_feeds(main, fvars, batches)
    cpu, cpu_state, secs = run_from_state(
        fluid.Executor(fluid.CPUPlace()), main, loss, init, feeds)
    reset_launches()
    card, card_state, csecs = run_from_state(exe, main, loss, init, feeds)
    launches = read_launches()
    loss_err = max(abs(a - b) for a, b in zip(card, cpu))
    errs = {g: change_rl2(card_state, cpu_state, init, names)
            for g, names in groups.items()}
    print("book sentiment: %d Adam steps at batch 16 from one state: CPU "
          "plain path (%.1f s) losses %s; card (%.1f s) %s; loss "
          "max_abs_err %.3g (atol %g); the steps' change, relative L2 "
          "error: %s (limits %g parameters, %g moments); hand-written "
          "kernel launches %s"
          % (TRAIN_STEPS, secs, ", ".join("%.6f" % x for x in cpu), csecs,
             ", ".join("%.6f" % x for x in card), loss_err, BOOK_LOSS_ATOL,
             ", ".join("%s %.3g" % kv for kv in errs.items()),
             BOOK_PARAM_RL2, BOOK_MOMENT_RL2, json.dumps(launches)),
          flush=True)
    if loss_err > BOOK_LOSS_ATOL or errs["parameters"] > BOOK_PARAM_RL2 \
            or max(errs["moment1"], errs["moment2"]) > BOOK_MOMENT_RL2 \
            or not all(np.isfinite(v).all() for v in card_state.values()):
        raise SystemExit("chip_smoke: sentiment steps on the card disagree "
                         "with the CPU plain path")

    # one step twice, at the timed batch
    scope = params_scope(init, exe.device)
    repeat_gate("book sentiment", exe, main, book_feeds(
        main, fvars, book_batches(reader, BOOK_BATCHES[0], 1),
        exe.device)[0], {n: scope.get(n) for n in init})
    del scope

    place = fluid.CUDAPlace(0)
    op_types = set(counts)
    for batch in BOOK_BATCHES:
        feeder = fluid.DataFeeder(place=place, feed_list=fvars, program=main)

        def book_loop():
            for b in paddle.batch(reader, batch_size=batch)():
                yield feeder.feed(b)

        scope = params_scope(init, exe.device)
        losses, times = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_loop = t0 = time.perf_counter()
        for feed in device_prefetch(book_loop, place=place)():
            out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            losses.append(float(np.asarray(out).reshape(-1)[0]))
            times.append((time.perf_counter() - t0) * 1e3)
            if len(losses) == TRAIN_STEPS:
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
            t0 = time.perf_counter()
        loop_s = time.perf_counter() - t_loop
        if not np.isfinite(losses).all():
            raise SystemExit("chip_smoke: sentiment losses %s" % losses)
        print("book sentiment batch %d: one pass of %d steps through "
              "DataFeeder, device_prefetch and Executor.run in %.2f s: step "
              "%.3f ms (median, host clock from one fetched loss to the "
              "next, feeding included; min %.3f, max %.3f), %.1f samples/s; "
              "losses %.4f -> %.4f; peak memory of the first %d steps %.3f "
              "GB [%s]"
              % (batch, len(losses), loop_s, float(np.median(times)),
                 min(times), max(times),
                 batch / float(np.median(times)) * 1e3, losses[0],
                 losses[-1], TRAIN_STEPS, peak / 1e9, smi), flush=True)
        dev_feed = book_feeds(main, fvars, book_batches(reader, batch, 1),
                              exe.device)[0]

        def step():
            return exe.run(main, feed=dev_feed, fetch_list=[loss],
                           scope=scope, return_numpy=False)

        times = timed_steps(step)
        med = float(np.median(times))
        rows = int(dev_feed["words"].nvalid)
        print("book sentiment batch %d: step %.3f ms (median of 10 after 2 "
              "warm, feeds on the card; mean %.3f, min %.3f, max %.3f), "
              "%.1f samples/s, %.1f words/s (%d words) [%s]"
              % (batch, med, np.mean(times), min(times), max(times),
                 batch / med * 1e3, rows / med * 1e3, rows, smi), flush=True)
        profile_step(step, op_types, 0, med,
                     what="one sentiment step at batch %d" % batch)
        trained = {n: scope.get(n).cpu().numpy() for n in init}
        del scope
        torch.cuda.empty_cache()

    seqs = [np.asarray(s, np.int64).reshape(-1, 1)
            for s, _ in paddle.dataset.imdb.test()()]
    if book_serve(trained, main, prob, seqs) > BOOK_PROB_ATOL:
        raise SystemExit("chip_smoke: served sentiment probabilities "
                         "disagree with the CPU plain path")
    return launches


def phase_book():
    """The Fluid book's chapters of the sequence-op slice (phase 12):
    each of its 15 op types on the card against the CPU; the sentiment
    conv model at full width, its main path (`book_sentiment`); the SRL,
    word2vec, recommender and fit-a-line programs' 3 steps on the card
    against the CPU and their step times (`book_chapter`); the ops'
    device times beside their bounds (`book_op_times`).  Returns the
    launch counts of the sentiment's checked steps (no hand-written
    kernel runs here)."""
    import paddle_tpu_torch.fluid as fluid

    t0 = time.perf_counter()
    exe = fluid.Executor()
    if exe.device.type != "cuda":
        raise SystemExit("chip_smoke: the executor is not on the card")
    smi = nvidia_smi_line()
    book_ops(exe.device)
    launches = book_sentiment(exe, smi)
    for chapter, batch in BOOK_CHAPTERS:
        book_chapter(exe, chapter, batch, smi)
    book_op_times(exe.device, smi)
    print("book: phase 12 in %.1f s" % (time.perf_counter() - t0),
          flush=True)
    return launches


# -- phase 13: loops, conditionals, tensor arrays, rank tables and CTC --------

# 13a: the loop machinery at the JAX tests' sizes, on the card against the
# port's plain CPU path.  Integer outputs, permutations and row copies
# exactly; float ones (the bounded loop's carries and grads: a 4-wide
# product and tanh, 3 steps) within CTC_LOOP_ATOL of the larger of 1 and
# their largest magnitude, the f32 arithmetic of two libraries
CTC_LOOP_ATOL = 1e-5
CTC_LOOP_LIMIT, CTC_LOOP_STEPS = 3, 5     # the loop's bound and max_steps
# 13b: tests/test_ctc_training.py's flow (V classes and a blank, FEAT
# features, 4 sequences from RandomState(0), fc -> warpctc -> mean, SGD
# at 0.5, 200 steps; its criterion: the last loss below a tenth of the
# first, the greedy decode the targets).  Its first step on the card
# against the CPU: f32 at 1e-5 of the loss and of each parameter
CTC_FLOW_V, CTC_FLOW_FEAT, CTC_FLOW_STEPS = 5, 6, 200
CTC_FLOW_RTOL = 1e-5
# 13c: CRNN-CTC (PaddlePaddle/models fluid/ocr_recognition
# crnn_ctc_model.py, early 2018) at its own widths: 1 x 48 x 512 images
# (the reader's DATA_SHAPE), batch 32, four groups of two 3x3
# convolutions ([16, 16] .. [128, 128], each with batch_norm and relu,
# each group a 2x2 max pool), im2sequence to 32 steps of 384, two fc of
# 600, GRUs of 200 both ways (relu candidates), fc to 95 classes and the
# blank, warpctc(norm_by_times) summed, Momentum at lr 1e-3 and 0.9;
# every parameter with ctc_train.py's L2Decay(l2 = 0.0004) and
# GradientClipByValue(max_clip = 10.0, min_clip = -10.0).  Labels of
# 4-16 classes, pixels uniform in [0, 255) less 127.5
CRNN_HW, CRNN_BATCH, CRNN_CLASSES, CRNN_HIDDEN = (48, 512), 32, 95, 200
CRNN_L2, CRNN_CLIP = 0.0004, 10.0
CRNN_GROUPS = ((16, 16), (32, 32), (64, 64), (128, 128))
CRNN_LABELS = (4, 16)
CRNN_LR, CRNN_MOMENTUM = 1e-3, 0.9
CRNN_SERVE = 3                   # concurrent requests of one image each
CRNN_BUCKETS = [1, 2, 4]
# 2 Momentum steps on the card against the CPU plain path from one state:
# f32 on both sides (TF32 off), cuDNN's convolutions against the CPU's and
# the batch norms' and GRUs' sums in other orders.  The loss (a sum of 32
# per-frame CTC losses, about 150, where one ulp is 1.5e-5) within
# CRNN_LOSS_RTOL of its size; each group's change over the steps
# (parameters, velocities, batch-norm statistics) in relative L2 within
# CRNN_STATE_RL2
CRNN_LOSS_RTOL = 1e-5
CRNN_STATE_RL2 = 1e-3


def ctc_while_program(fluid, max_steps, limit=CTC_LOOP_LIMIT):
    """A loop carrying acc = tanh(acc W + x), a counter, its condition
    and an array written each step (capacity 8), built by `fluid`'s
    layers (tests/test_torch_control_flow.py builds it with both
    packages' and holds the port's run to the JAX package's)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        layers = fluid.layers
        x = layers.data(name="x", shape=[2, 4], dtype="float32",
                        append_batch_size=False)
        acc = layers.data(name="acc", shape=[2, 4], dtype="float32",
                          append_batch_size=False)
        i = layers.fill_constant(shape=[1], dtype="int64", value=0)
        top = layers.fill_constant(shape=[1], dtype="int64", value=limit)
        arr = layers.array_write(x, i=i, capacity=8)
        cond = layers.less_than(x=i, y=top)
        loop = layers.While(cond=cond, max_steps=max_steps)
        with loop.block():
            h = layers.fc(input=acc, size=4, bias_attr=False)
            layers.sums(input=[layers.tanh(
                layers.elementwise_add(x=h, y=x))], out=acc)
            layers.increment(x=i, value=1, in_place=True)
            layers.array_write(acc, i=i, array=arr)
            layers.less_than(x=i, y=top, cond=cond)
    return main


def ctc_while_env(main, device, seed=SEED):
    """The while op's inputs on `device`: the feeds and the weight from
    the seed, and block 0's values before the loop."""
    import torch
    from paddle_tpu_torch.core.tensor_array import TensorArray

    rs = np.random.RandomState(seed)
    x = rs.randn(2, 4).astype(np.float32)
    env = {"x": x, "acc": rs.randn(2, 4).astype(np.float32),
           "fc_0.w_0": (rs.randn(4, 4) * 0.5).astype(np.float32)}
    env = {n: torch.from_numpy(v).to(device) for n, v in env.items()}
    for op in main.desc.block(0).ops:
        name = (op.output("Out") or [None])[0]
        if op.type == "fill_constant":
            env[name] = torch.tensor([int(op.attrs["value"])],
                                     dtype=torch.int32, device=device)
        elif op.type == "less_than":
            env[name] = torch.tensor([True], device=device)
        elif op.type == "write_to_array":
            buf = torch.zeros((8, 2, 4), device=device)
            buf[0] = env["x"]
            env[name] = TensorArray(buf, 1)
    return env


def ctc_host(v):
    """A value as host arrays: (values, lod or length or None)."""
    if hasattr(v, "buffer"):
        return v.buffer.detach().cpu().numpy(), int(v.length)
    if hasattr(v, "row_splits"):
        return v.values.detach().cpu().numpy()[:int(v.nvalid)], v.lod()
    if isinstance(v, (list, tuple)):
        return [ctc_host(s) for s in v], None
    return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                      else v), None


def ctc_same(tag, got, ref, exact):
    """The largest difference of two host values (0 where exact and
    equal); raises on a mismatch."""
    (gv, gmeta), (rv, rmeta) = ctc_host(got), ctc_host(ref)
    if isinstance(gv, list):
        errs = [ctc_same("%s[%d]" % (tag, k), a, b, exact)
                for k, (a, b) in enumerate(zip(got, ref))]
        if len(gv) != len(rv):
            raise SystemExit("chip_smoke: %s: %d steps on the card, %d on "
                             "the CPU" % (tag, len(gv), len(rv)))
        return max(errs or [0.0])
    if gmeta != rmeta or gv.shape != rv.shape or gv.dtype != rv.dtype:
        raise SystemExit("chip_smoke: %s: structure %s %s %s on the card, "
                         "%s %s %s on the CPU" % (tag, gmeta, gv.shape,
                                                  gv.dtype, rmeta, rv.shape,
                                                  rv.dtype))
    if exact or not np.issubdtype(rv.dtype, np.floating):
        if not np.array_equal(gv, rv):
            raise SystemExit("chip_smoke: %s differs from the CPU" % tag)
        return 0.0
    err = float(np.abs(gv - rv).max()) if rv.size else 0.0
    if err > CTC_LOOP_ATOL * max(1.0, float(np.abs(rv).max())):
        raise SystemExit("chip_smoke: %s: max_abs_err %.3g on the card"
                         % (tag, err))
    return err


def ctc_machinery(device, smi):
    """13a: each loop-machinery program on the card and on the CPU plain
    path.  Returns {name: ms} of the bounded while op and its grad
    (device ms by graph replay, and eager)."""
    import torch
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.desc import OpDesc
    from paddle_tpu_torch.core.ragged import RaggedTensor
    from paddle_tpu_torch.core.tensor_array import TensorArray
    from paddle_tpu_torch.fluid.executor import ExecContext, apply_op
    from paddle_tpu_torch.ops.registry import get_op_info

    cpu = torch.device("cpu")
    lines = []

    # the bounded loop and its generic grad, the op alone
    main = ctc_while_program(fluid, CTC_LOOP_STEPS)
    op = next(o for o in main.desc.block(0).ops if o.type == "while")
    outs = op.output("Out")
    arr = next(n for n in outs if n.startswith("array"))
    grad_ins = dict(op.inputs, **{"O@Out": list(outs), "OG@Out": [
        n + "@GRAD" if n in ("acc", arr) else "@EMPTY@" for n in outs]})
    grad_op = OpDesc("while_grad", grad_ins,
                     {"X@GRAD": [n + "@GRAD" for n in op.input("X")]},
                     dict(op.attrs))
    rs = np.random.RandomState(SEED + 1)
    og_acc = rs.randn(2, 4).astype(np.float32)
    og_buf = rs.randn(8, 2, 4).astype(np.float32)

    def run_loop(dev):
        env = ctc_while_env(main, dev)
        ctx = ExecContext(main.desc, 0, dict(env), device=dev)
        apply_op(ctx, op)
        fwd = {n: ctx.env[n] for n in outs}
        genv = dict(env, **fwd)
        genv["acc@GRAD"] = torch.from_numpy(og_acc).to(dev)
        genv[arr + "@GRAD"] = TensorArray(torch.from_numpy(og_buf).to(dev),
                                          0)
        gctx = ExecContext(main.desc, 0, genv, device=dev)
        apply_op(gctx, grad_op)
        return fwd, {n: gctx.env[n + "@GRAD"] for n in ("x", "acc",
                                                        "fc_0.w_0", arr)}

    (cf, cg), (gf, gg) = run_loop(cpu), run_loop(device)
    errs = [ctc_same("bounded while " + n, gf[n], cf[n], False)
            for n in outs]
    errs += [ctc_same("bounded while grad " + n, gg[n], cg[n], False)
             for n in cg]
    steps = int(gf[next(n for n in outs if gf[n].dtype == torch.int32)
                   ].reshape(-1)[0])
    if steps != CTC_LOOP_LIMIT:
        raise SystemExit("chip_smoke: the bounded loop ran %d steps" % steps)
    lines.append("a bounded While (max_steps %d, %d steps taken; the carry, "
                 "the counter, the condition and a TensorArray) and its "
                 "generic grad: max_abs_err %.3g" % (CTC_LOOP_STEPS, steps,
                                                    max(errs)))

    # the same loop unbounded, forward
    main_u = ctc_while_program(fluid, None)
    op_u = next(o for o in main_u.desc.block(0).ops if o.type == "while")
    res = []
    for dev in (cpu, device):
        ctx = ExecContext(main_u.desc, 0, ctc_while_env(main_u, dev),
                          device=dev)
        apply_op(ctx, op_u)
        res.append({n: ctx.env[n] for n in op_u.output("Out")})
    err = max(ctc_same("unbounded while " + n, res[1][n], res[0][n], False)
              for n in res[0])
    lines.append("an unbounded While (a host read a step), forward: "
                 "max_abs_err %.3g" % err)

    # IfElse row routing (tests/test_lod_machinery.py:158)
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        layers = fluid.layers
        x = layers.data(name="x", shape=[1], dtype="float32")
        zero = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        ie = layers.IfElse(layers.less_than(x=x, y=zero))
        with ie.true_block():
            ie.output(layers.scale(x=ie.input(x), scale=-1.0))
        with ie.false_block():
            ie.output(ie.input(x))
        out = ie()
    xs = np.random.RandomState(SEED + 2).randn(64, 1).astype(np.float32)
    got = [fluid.Executor(place).run(prog, feed={"x": xs},
                                     fetch_list=[out])[0]
           for place in (fluid.CPUPlace(), fluid.CUDAPlace(0))]
    if not (np.array_equal(got[0], got[1])
            and np.array_equal(got[1], np.abs(xs))):
        raise SystemExit("chip_smoke: IfElse on the card differs")
    lines.append("IfElse routing 64 rows by sign: exact")

    # split and merge of a ragged value (tests/test_lod_machinery.py:183)
    vals = np.arange(12, dtype=np.float32).reshape(6, 2)
    splits = np.array([0, 1, 4, 6], np.int32)
    mask = np.array([[1], [0], [1]], np.int32)
    parts = []
    for dev in (cpu, device):
        x = RaggedTensor(torch.from_numpy(vals).to(dev),
                         [torch.from_numpy(splits).to(dev)])
        m = torch.from_numpy(mask).to(dev)
        sp = get_op_info("split_lod_tensor").kernel(
            None, {"X": [x], "Mask": [m]}, {})
        mg = get_op_info("merge_lod_tensor").kernel(
            None, {"X": [x], "Mask": [m], "InTrue": sp["OutTrue"],
                   "InFalse": sp["OutFalse"]}, {})
        parts.append([sp["OutTrue"][0], sp["OutFalse"][0], mg["Out"][0]])
    for name, a, b in zip(("OutTrue", "OutFalse", "merged"), parts[1],
                          parts[0]):
        ctc_same("split/merge " + name, a, b, True)
    if not np.array_equal(ctc_host(parts[1][2])[0], vals):
        raise SystemExit("chip_smoke: the merge is not the input")
    lines.append("split_lod_tensor and merge_lod_tensor of a ragged value: "
                 "exact, the merge the input")

    # the rank-table round trip, flat (a program) and lod-level-2 (the ops)
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        layers = fluid.layers
        x = layers.data(name="x", shape=[2], dtype="float32", lod_level=1)
        table = layers.lod_rank_table(x)
        back = layers.array_to_lod_tensor(layers.lod_tensor_to_array(
            x, table), table)
        reordered = layers.reorder_lod_tensor_by_rank(x, table)
    seqs = [np.full((n, 2), k + 1, np.float32)
            for k, n in enumerate([1, 3, 2, 5, 0, 4])]
    got = [fluid.Executor(place).run(
        prog, feed={"x": RaggedTensor.from_sequences(seqs, bucket=8)},
        fetch_list=[back, reordered], return_numpy=False)
        for place in (fluid.CPUPlace(), fluid.CUDAPlace(0))]
    for name, a, b in zip(("round trip", "reorder"), got[1], got[0]):
        ctc_same("rank table " + name, a, b, True)
    vals = np.arange(1, 7, dtype=np.float32).reshape(6, 1)
    nested = []
    for dev in (cpu, device):
        x = RaggedTensor(torch.from_numpy(vals).to(dev), [
            torch.tensor([0, 1, 3], dtype=torch.int32, device=dev),
            torch.tensor([0, 2, 3, 6], dtype=torch.int32, device=dev)])
        t = get_op_info("lod_rank_table").kernel(None, {"X": [x]},
                                                 {"level": 0})["Out"][0]
        steps = get_op_info("lod_tensor_to_array").kernel(
            None, {"X": [x], "RankTable": [t]}, {})["Out"][0]
        back = get_op_info("array_to_lod_tensor").kernel(
            None, {"X": [steps], "RankTable": [t]}, {})["Out"][0]
        nested.append((t.items, steps, back))
    if nested[0][0] != nested[1][0]:
        raise SystemExit("chip_smoke: the lod-level-2 rank table differs")
    ctc_same("lod-level-2 steps", nested[1][1], nested[0][1], True)
    ctc_same("lod-level-2 round trip", nested[1][2], nested[0][2], True)
    lines.append("the rank-table round trip and reorder of 6 sequences (one "
                 "empty, a 16-row bucket), and the lod-level-2 round trip: "
                 "exact")
    for line in lines:
        print("ctc: loops on the card against the CPU plain path: " + line,
              flush=True)

    # the bounded loop's device and eager ms (for PERF.md's table)
    env = ctc_while_env(main, device)
    ctx = ExecContext(main.desc, 0, {}, device=device)
    kernel = get_op_info("while").kernel
    names = op.input("X")
    ins = {"X": [env[n] for n in names],
           "Condition": [env[op.input("Condition")[0]]]}
    fwd, _ = run_loop(device)

    def loop():
        with torch.no_grad():
            return kernel(ctx, ins, op.attrs)

    genv = dict(env, **fwd)
    genv["acc@GRAD"] = torch.from_numpy(og_acc).to(device)
    genv[arr + "@GRAD"] = TensorArray(torch.from_numpy(og_buf).to(device),
                                      torch.zeros((), dtype=torch.int32,
                                                  device=device))

    def loop_grad():
        with torch.no_grad():
            apply_op(ExecContext(main.desc, 0, dict(genv), device=device),
                     grad_op)

    times = {}
    for name, fn in (("while", loop), ("while_grad", loop_grad)):
        times[name] = replay_or_profile(name, fn)
        times[name + "_plain"] = cuda_ms(fn, iters=10)
    # its bound: the float inputs read and the outputs written once (its
    # few hundred operations take far less)
    nbytes = sum(v.values.numel() * 4 if isinstance(v, TensorArray)
                 else v.numel() * v.element_size() for v in
                 list(env.values()) + list(fwd.values()))
    times["bound"] = nbytes / HBM_BYTES_PER_S * 1e3
    print("ctc: the bounded while op ([2, 4] carry, %d masked steps): "
          "device ms %.4f (%s), grad %.4f (%s); eager %.4f ms, grad %.4f ms; "
          "bound %.3g ms by bytes (%d bytes) [%s]"
          % (CTC_LOOP_STEPS, *times["while"], *times["while_grad"],
             times["while_plain"], times["while_grad_plain"],
             times["bound"], nbytes, smi), flush=True)
    return times


def ctc_flow_data(rs, n_seqs=4):
    """tests/test_ctc_training.py's `_make_data`, copied (the test file
    imports the JAX package): each class a feature direction, one frame
    per target symbol, targets without adjacent repeats."""
    protos = rs.randn(CTC_FLOW_V + 1, CTC_FLOW_FEAT).astype(np.float32) * 2.0
    xs, ys = [], []
    for _ in range(n_seqs):
        target = [int(rs.randint(1, CTC_FLOW_V + 1))]
        for _ in range(int(rs.randint(1, 3))):
            nxt = int(rs.randint(1, CTC_FLOW_V + 1))
            while nxt == target[-1]:
                nxt = int(rs.randint(1, CTC_FLOW_V + 1))
            target.append(nxt)
        frames = [protos[t] + rs.randn(CTC_FLOW_FEAT).astype(np.float32)
                  * 0.05 for t in target]
        xs.append(np.stack(frames, 0))
        ys.append(np.asarray(target, np.int64).reshape(-1, 1))
    return xs, ys


def ctc_flow(exe):
    """13b: the JAX CTC test's flow on the card: its first step against
    the CPU plain path from one state, then its 200 SGD steps and its
    criterion, and the greedy decode equal to the targets."""
    import paddle_tpu_torch.fluid as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[CTC_FLOW_FEAT],
                              dtype="float32", lod_level=1)
        y = fluid.layers.data(name="y", shape=[1], dtype="int64",
                              lod_level=1)
        logits = fluid.layers.fc(input=x, size=CTC_FLOW_V + 1, act=None)
        loss = fluid.layers.mean(
            x=fluid.layers.warpctc(input=logits, label=y, blank=0))
        decoded = fluid.layers.ctc_greedy_decoder(logits, blank=0)
        fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    xs, ys = ctc_flow_data(np.random.RandomState(0))
    feed = fluid.DataFeeder(place=fluid.CPUPlace(), feed_list=[x, y]).feed(
        list(zip(xs, ys)))
    init = book_state(exe, startup, main)
    cpu, cpu_state, _ = run_from_state(fluid.Executor(fluid.CPUPlace()),
                                       main, loss, init, [feed])
    card, card_state, _ = run_from_state(exe, main, loss, init, [feed])
    errs = [abs(card[0] - cpu[0]) / max(1.0, abs(cpu[0]))]
    errs += [float(np.abs(card_state[n] - cpu_state[n]).max())
             / max(1.0, float(np.abs(cpu_state[n]).max())) for n in init]
    scope = params_scope(card_state, exe.device)
    t0 = time.perf_counter()
    losses = card + [float(exe.run(main, feed=feed, fetch_list=[loss],
                                   scope=scope)[0][0])
                     for _ in range(CTC_FLOW_STEPS - 1)]
    secs = time.perf_counter() - t0
    dec, = exe.run(main, feed=feed, fetch_list=[decoded], scope=scope,
                   return_numpy=False)
    dec = ctc_host(dec)
    splits, vals = dec[1][0], dec[0].reshape(-1).tolist()
    got = [vals[splits[i]:splits[i + 1]] for i in range(len(splits) - 1)]
    want = [t.reshape(-1).tolist() for t in ys]
    print("ctc: tests/test_ctc_training.py's flow on the card: the first "
          "step against the CPU plain path, relative error %.3g (gate %g); "
          "%d SGD steps in %.1f s, loss %.6f -> %.6f (criterion: below %.6f);"
          " greedy decode %s, targets %s"
          % (max(errs), CTC_FLOW_RTOL, CTC_FLOW_STEPS, secs, losses[0],
             losses[-1], 0.1 * losses[0], got, want), flush=True)
    if max(errs) > CTC_FLOW_RTOL or not losses[-1] < 0.1 * losses[0] \
            or got != want:
        raise SystemExit("chip_smoke: the CTC flow failed on the card")


def build_crnn(fluid, hw=CRNN_HW, groups=CRNN_GROUPS, hidden=CRNN_HIDDEN,
               classes=CRNN_CLASSES, lr=CRNN_LR):
    """crnn_ctc_model.py's ctc_train_net through `fluid`'s layers (the
    port's here; tests/test_torch_ctc.py builds it with both packages'
    and holds the descs and steps equal): (main, startup, infer, loss,
    decoded, distance); `infer` is main's clone for test before the
    optimizer, with the greedy decode and the edit distance to the
    label appended."""
    layers = fluid.layers

    def attr(std, lr=1.0):
        # a fresh ParamAttr per parameter: a reused one would name them
        # all alike
        return fluid.ParamAttr(
            initializer=fluid.initializer.Normal(0.0, std), learning_rate=lr,
            regularizer=fluid.regularizer.L2Decay(CRNN_L2),
            gradient_clip=fluid.clip.GradientClipByValue(
                max=CRNN_CLIP, min=-CRNN_CLIP))

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        images = layers.data(name="pixel", shape=[1, hw[0], hw[1]],
                             dtype="float32")
        label = layers.data(name="label", shape=[1], dtype="int32",
                            lod_level=1)
        t = images
        for g, chans in enumerate(groups):
            for ch in chans:
                t = layers.conv2d(input=t, num_filters=ch, filter_size=3,
                                  padding=1,
                                  param_attr=attr(0.0005 if g == 0 else 0.01),
                                  bias_attr=attr(0.0))
                t = layers.batch_norm(input=t, act="relu",
                                      param_attr=attr(0.01),
                                      bias_attr=attr(0.0))
            t = layers.pool2d(input=t, pool_size=2, pool_type="max",
                              pool_stride=2, ceil_mode=True)
        seq = layers.im2sequence(input=t, stride=[1, 1],
                                 filter_size=[t.shape[2], 1])
        fc_1 = layers.fc(input=seq, size=hidden * 3, param_attr=attr(0.02),
                         bias_attr=attr(0.02))
        fc_2 = layers.fc(input=seq, size=hidden * 3, param_attr=attr(0.02),
                         bias_attr=attr(0.02))
        forward = layers.dynamic_gru(input=fc_1, size=hidden,
                                     param_attr=attr(0.02),
                                     bias_attr=attr(0.02, 2.0),
                                     candidate_activation="relu")
        backward = layers.dynamic_gru(input=fc_2, size=hidden,
                                      is_reverse=True, param_attr=attr(0.02),
                                      bias_attr=attr(0.02, 2.0),
                                      candidate_activation="relu")
        fc_out = layers.fc(input=[forward, backward], size=classes + 1,
                           param_attr=attr(0.02), bias_attr=attr(0.0))
        cost = layers.warpctc(input=fc_out, label=label, blank=classes,
                              norm_by_times=True)
        loss = layers.reduce_sum(cost)
        infer = main.clone(for_test=True)
        fluid.optimizer.Momentum(learning_rate=lr,
                                 momentum=CRNN_MOMENTUM).minimize(loss)
    with fluid.program_guard(infer, fluid.Program()):
        block = infer.global_block()
        decoded = layers.ctc_greedy_decoder(block.var(fc_out.name),
                                            blank=classes)
        distance, _ = layers.edit_distance(decoded, block.var(label.name))
    return main, startup, infer, loss, decoded, distance


def crnn_samples(n, hw, classes, seed, lengths=CRNN_LABELS):
    """`n` (image, label) samples from the seed: pixels uniform in
    [0, 255) less 127.5, labels of lengths[0]..lengths[1] classes in
    [0, classes)."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        img = (rs.uniform(0, 255, (1,) + tuple(hw)) - 127.5) \
            .astype(np.float32)
        lab = rs.randint(0, classes, rs.randint(lengths[0], lengths[1] + 1))
        out.append((img, lab.astype(np.int32).reshape(-1, 1)))
    return out


def crnn_decode_state(state, params, seed=SEED + 3):
    """`state` with every bias of `params` 0, the batch norms' scales 1,
    the convolutions' filters N(0, 2 / fan in) and the last fc's weights
    N(0, 1), drawn from the seed.  Under the source's initializers the
    image's signal reaches the GRUs far below the biases' (the inference
    program normalizes by running statistics near 0 and 1), so every
    image decodes alike, which no comparison of decodes could tell from
    a wrong one; with these each step's argmax follows the image."""
    out = dict(state)
    rs = np.random.RandomState(seed)
    for name in params:
        v = state[name]
        if name.startswith("batch_norm_"):
            out[name] = (np.ones_like(v) if name.endswith(".w_0")
                         else np.zeros_like(v))
        elif v.ndim == 4:
            out[name] = (rs.randn(*v.shape) * np.sqrt(
                2.0 / np.prod(v.shape[1:]))).astype(np.float32)
        elif v.ndim == 1 or v.shape[0] == 1:
            out[name] = np.zeros_like(v)
    for name in ("fc_2.w_0", "fc_2.w_1"):
        out[name] = rs.randn(*state[name].shape).astype(np.float32)
    return out


def crnn_serve(state, infer, decoded, images, smi):
    """The export of `decoded` from the `pixel` feed with `state`,
    loaded by InferenceEngine on the card behind InferenceServer:
    CRNN_SERVE concurrent requests of one image each.  Returns (the
    replies' ids, the card engine's, the CPU engine's)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.ragged import ragged_to_sequences
    from paddle_tpu_torch.fluid import io
    from paddle_tpu_torch.serving import (InferenceEngine, InferenceServer,
                                          ServerConfig)

    with tempfile.TemporaryDirectory() as tmp:
        with fluid.scope_guard(params_scope(state, "cpu")):
            io.save_inference_model(
                tmp, ["pixel"], [decoded], fluid.Executor(fluid.CPUPlace()),
                infer, bucket_hints={"batch_buckets": CRNN_BUCKETS})
        engine = InferenceEngine.from_saved_model(tmp)
        if engine.place.device().type != "cuda":
            raise SystemExit("chip_smoke: the engine is not on the card")
        server = InferenceServer(engine, ServerConfig(
            port=0, max_batch=max(CRNN_BUCKETS), max_wait_ms=50.0,
            warmup=True))
        try:
            server.start()
            host, port = server.address
            url = "http://%s:%d/v1/infer" % (host, port)
            replies = [None] * CRNN_SERVE

            def client(i):
                replies[i] = _post(url, {"inputs": {"pixel": [
                    images[i].tolist()]}})

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(CRNN_SERVE)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            if any(r is None for r in replies):
                raise SystemExit("chip_smoke: an HTTP request got no reply")
            print("ctc: CRNN %d concurrent requests of one image answered "
                  "in %d batch(es); latencies %s ms [%s]"
                  % (CRNN_SERVE, server.metrics.batch_occupancy.count,
                     ", ".join("%.1f" % r[2] for r in replies), smi),
                  flush=True)
        finally:
            server.shutdown()
        card = engine.run({"pixel": images[:CRNN_SERVE]})[0]
        cpu = InferenceEngine.from_saved_model(
            tmp, place=fluid.CPUPlace()).run(
                {"pixel": images[:CRNN_SERVE]})[0]
    fetch = engine.fetch_names[0]
    served = []
    for status, body, _ in replies:
        if status != 200:
            raise SystemExit("chip_smoke: HTTP %d: %s" % (status, body))
        served.append([row[0] for row in body["outputs"][fetch][0]])
    ids = [[s.reshape(-1).tolist() for s in ragged_to_sequences(r)]
           for r in (card, cpu)]
    return served, ids[0], ids[1]


def crnn_repeat(exe, main, feed, state, logits):
    """One CRNN step twice from one state: (the names of the grads of
    warpctc's logits and of every parameter, the convolutions' and batch
    norms' included, that differ bit for bit, with their largest
    differences; the count of grads compared, and of those the
    convolutions' and batch norms')."""
    import torch
    from paddle_tpu_torch.fluid import Scope
    from paddle_tpu_torch.ops.registry import values_of

    if torch.are_deterministic_algorithms_enabled():
        raise SystemExit("chip_smoke: torch's deterministic mode is on")
    params = [p.name for p in main.global_block().all_parameters()]
    grads = [logits + "@GRAD"] + [p + "@GRAD" for p in params]
    runs = []
    for _ in range(2):
        scope = Scope()
        for n, t in state.items():
            scope.set(n, t.clone())
        runs.append(exe.run(main, feed=feed, fetch_list=grads, scope=scope,
                            return_numpy=False))
        del scope
    differ = {g: float((values_of(a) - values_of(b)).abs().max())
              for g, a, b in zip(grads, *runs) if not same_bits(a, b)}
    n_conv = sum(g.startswith(("conv2d", "batch_norm")) for g in grads)
    return differ, len(grads), n_conv


def crnn_full(exe, smi):
    """13c: CRNN-CTC at full width on the card (see CRNN_HW).  Returns
    the launch counts of its checked steps."""
    import torch
    import torch.utils._pytree as pytree
    import paddle_tpu_torch.fluid as fluid

    t0 = time.perf_counter()
    main, startup, infer, loss, decoded, distance = build_crnn(fluid)
    block = main.desc.block(0)
    counts = collections.Counter(op.type for op in block.ops)
    n_values = sum(int(np.prod(v.shape)) for v in block.vars.values()
                   if v.is_parameter)
    print("ctc: CRNN-CTC main %d ops of %d types (%s), %d parameter values "
          "(%.3f M), inference program %d ops; built in %.1f s"
          % (len(block.ops), len(counts), ", ".join(
              "%s %d" % kv for kv in sorted(counts.items())), n_values,
             n_values / 1e6, len(infer.desc.block(0).ops),
             time.perf_counter() - t0), flush=True)
    if counts["conv2d"] != 8 or counts["gru"] != 2 \
            or counts["warpctc_grad"] != 1:
        raise SystemExit("chip_smoke: the CRNN program is not the one "
                         "held against the JAX package")
    init = book_state(exe, startup, main)
    params = [p.name for p in main.global_block().all_parameters()]
    groups = {"parameters": params,
              "velocities": [n for n in init if "_velocity_" in n],
              "statistics": [n for n in init
                             if n.startswith("_generated_var_")]}
    samples = crnn_samples(CRNN_BATCH * 3, CRNN_HW, CRNN_CLASSES, SEED)
    batches = [samples[k * CRNN_BATCH:(k + 1) * CRNN_BATCH]
               for k in range(3)]
    fvars = [main.global_block().var(n) for n in ("pixel", "label")]
    feeds = book_feeds(main, fvars, batches)
    cpu, cpu_state, csecs = run_from_state(
        fluid.Executor(fluid.CPUPlace()), main, loss, init, feeds[:2])
    reset_launches()
    card, card_state, gsecs = run_from_state(exe, main, loss, init,
                                             feeds[:2])
    launches = read_launches()
    loss_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(card, cpu))
    errs = {g: change_rl2(card_state, cpu_state, init, names)
            for g, names in groups.items()}
    print("ctc: CRNN 2 Momentum steps at batch %d from one state: CPU plain "
          "path (%.1f s) losses %s; card (%.1f s) %s; loss error %.3g of "
          "its size (gate %g); the steps' change, relative L2 error: %s "
          "(gate %g); hand-written kernel launches %s"
          % (CRNN_BATCH, csecs, ", ".join("%.6f" % x for x in cpu), gsecs,
             ", ".join("%.6f" % x for x in card), loss_err, CRNN_LOSS_RTOL,
             ", ".join("%s %.3g" % kv for kv in errs.items()),
             CRNN_STATE_RL2, json.dumps(launches)), flush=True)
    if loss_err > CRNN_LOSS_RTOL or max(errs.values()) > CRNN_STATE_RL2 \
            or not all(np.isfinite(v).all() for v in card_state.values()):
        raise SystemExit("chip_smoke: CRNN steps on the card disagree with "
                         "the CPU plain path")

    dev_feeds = [pytree.tree_map(lambda t: t.to(exe.device), f)
                 for f in feeds]
    scope = params_scope(init, exe.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in dev_feeds:
        exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                return_numpy=False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    # no synchronizing call in a training step
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = exe.run(main, feed=dev_feeds[0], fetch_list=[loss],
                      scope=scope, return_numpy=False)[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise SystemExit("chip_smoke: the CRNN step gave %s" % out)
    print("ctc: CRNN: no synchronizing call in one training step (8 "
          "convolutions, two 32-step GRUs, the 32-step CTC recursion and "
          "their grads)", flush=True)

    def step():
        return exe.run(main, feed=dev_feeds[0], fetch_list=[loss],
                       scope=scope, return_numpy=False)

    # ROADMAP C4's cost: the same step with cuDNN's algorithms free
    # (conv2d's registration off), then held to deterministic ones again
    from paddle_tpu_torch.ops.registry import get_op_info

    conv = get_op_info("conv2d")
    conv.deterministic = False
    try:
        free = timed_steps(step)
    finally:
        conv.deterministic = True
    times = timed_steps(step)
    med = float(np.median(times))
    labels = int(dev_feeds[0]["label"].nvalid)
    print("ctc: CRNN batch %d: step %.3f ms (median of 10 after 2 warm, "
          "feeds on the card, conv2d and its grad under deterministic "
          "cuDNN algorithms; mean %.3f, min %.3f, max %.3f), %.1f images/s,"
          " %.1f labels/s (%d labels); peak memory of 3 steps %.3f GB; the "
          "same step with cuDNN's algorithms free, timed just before: "
          "%.3f ms (mean %.3f, min %.3f, max %.3f) [%s]"
          % (CRNN_BATCH, med, np.mean(times), min(times), max(times),
             CRNN_BATCH / med * 1e3, labels / med * 1e3, labels, peak / 1e9,
             float(np.median(free)), np.mean(free), min(free), max(free),
             smi), flush=True)
    profile_step(step, set(counts), 0, med,
                 what="one CRNN-CTC step at batch %d" % CRNN_BATCH)

    # one step twice from one state: every grad, the convolutions' and
    # batch norms' included (ROADMAP C4)
    logits = next(op for op in block.ops
                  if op.type == "warpctc").input("Logits")[0]
    state = {n: torch.from_numpy(v).to(exe.device) for n, v in init.items()}
    differ, n_grads, n_conv = crnn_repeat(exe, main, dev_feeds[0], state,
                                          logits)
    print("ctc: CRNN one step from one state and feed, run twice without "
          "torch's deterministic algorithms: %d of %d grads (warpctc's "
          "logits, the GRUs, the fcs and the %d convolution and batch-norm "
          "grads) differ bit for bit%s"
          % (len(differ), n_grads, n_conv, " (largest differences: %s)"
             % ", ".join("%s %.3g" % kv for kv in sorted(
                 differ.items(), key=lambda kv: -kv[1])[:6])
             if differ else ""), flush=True)
    if differ:
        raise SystemExit("chip_smoke: CRNN grads differ run to run: %s"
                         % sorted(differ))

    # decode and edit distance on the card against the CPU
    dstate = crnn_decode_state({n: scope.get(n).cpu().numpy()
                                for n in init}, params)
    res = []
    for ex in (fluid.Executor(fluid.CPUPlace()), exe):
        res.append(ex.run(infer, feed=feeds[0], fetch_list=[decoded,
                                                            distance],
                          scope=params_scope(dstate, ex.device),
                          return_numpy=False))
    ctc_same("CRNN decode", res[1][0], res[0][0], True)
    ctc_same("CRNN edit distance", res[1][1], res[0][1], True)
    dec, dist = ctc_host(res[1][0]), ctc_host(res[1][1])[0]
    print("ctc: CRNN greedy decode of batch %d (%d ids) and edit distance "
          "(mean %.3f) on the card equal the CPU's exactly"
          % (CRNN_BATCH, len(dec[0]), float(dist.mean())), flush=True)
    if not len(dec[0]):
        raise SystemExit("chip_smoke: the CRNN decode is empty")

    images = np.stack([s[0] for s in batches[0]])
    served, card_ids, cpu_ids = crnn_serve(dstate, infer, decoded, images,
                                           smi)
    print("ctc: CRNN served ids %s; the card engine's %s; the CPU's %s"
          % (served, card_ids, cpu_ids), flush=True)
    if not served == card_ids == cpu_ids:
        raise SystemExit("chip_smoke: served CRNN ids disagree")
    del scope
    torch.cuda.empty_cache()
    return launches


def kernel_sum_ms(fn, runs=10):
    """Mean device ms of fn()'s kernels a call, summed from
    torch.profiler's CUDA activity over `runs` calls: the device time of
    a call that CUDA graph capture refuses (one that copies from the
    host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return sum(k[1] for k in device_kernels(prof.key_averages(), set())) \
        / 1e3 / runs


def replay_or_profile(tag, fn):
    """(device ms, how): by CUDA graph replay, else (capture refused) by
    the profiler's kernel sum."""
    import torch

    try:
        return device_ms(fn, launches=5, replays=3), "graph replay"
    except RuntimeError as exc:
        torch.cuda.synchronize()
        print("ctc: %s under CUDA graph capture failed (%s): its device ms "
              "from the profiler's kernel sum" % (tag, str(exc)[:160]),
              flush=True)
        return kernel_sum_ms(fn), "profiler kernel sum"


def ctc_bound(t_lens, l_lens, classes, grad=False):
    """(ms, "bytes" | "operations") of warpctc's least time on these
    inputs: the logits [T, C] and the labels read once and the loss [B]
    written (the grad: the loss's grad read too, the logits' grad
    written); the log-softmax's 5 operations an element and 9 a state
    (two log-add-exps and an add) for each of a sequence's steps and its
    2 L + 1 states, on the f32 cores (the grad: 3 times that)."""
    T = int(sum(t_lens))
    labels = int(sum(l_lens))
    flops = 5.0 * T * classes + 9.0 * sum(
        t * (2 * n + 1) for t, n in zip(t_lens, l_lens))
    nbytes = 4.0 * (T * classes + labels + len(t_lens))
    if grad:
        nbytes, flops = nbytes + 4.0 * T * classes, 3 * flops
    t_ops, t_bytes = flops / F32_CORE_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def ctc_op_times(device, smi):
    """13d: warpctc alone at CRNN's shape (B 32, T 32, C 96, labels of
    4-16): forward and generic grad by CUDA graph replay and eagerly,
    beside F.ctc_loss over log_softmax (forward, and with its backward)
    and the bound.  Returns {name: ms}."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.core.ragged import RaggedTensor, bucket_max_seqlen
    from paddle_tpu_torch.ops.registry import get_op_info, run_generic_grad

    rs = np.random.RandomState(SEED + 4)
    B, T, C = CRNN_BATCH, CRNN_HW[1] // 16, CRNN_CLASSES + 1
    l_lens = rs.randint(CRNN_LABELS[0], CRNN_LABELS[1] + 1, B)
    logits = torch.from_numpy(rs.randn(B * T, C).astype(np.float32)).to(
        device)
    labels = torch.from_numpy(rs.randint(0, CRNN_CLASSES, int(l_lens.sum()))
                              .astype(np.int32)).to(device)
    lg = RaggedTensor(logits, [torch.arange(B + 1, dtype=torch.int32,
                                            device=device) * T],
                      max_seqlen=T)
    lb = RaggedTensor(labels.reshape(-1, 1), [torch.from_numpy(np.cumsum(
        [0] + list(l_lens)).astype(np.int32)).to(device)],
        max_seqlen=bucket_max_seqlen(l_lens))
    attrs = {"blank": CRNN_CLASSES, "norm_by_times": True}
    og = torch.ones(B, 1, device=device)
    kernel = get_op_info("warpctc").kernel
    ins = {"Logits": [lg], "Label": [lb]}

    def forward():
        with torch.no_grad():
            return kernel(None, ins, attrs)

    def grad():
        with torch.no_grad():
            return run_generic_grad(None, "warpctc", dict(
                ins, **{"OG@Loss": [og], "OG@WarpCTCGrad": [None]}), attrs)

    x = logits.reshape(B, T, C).transpose(0, 1).contiguous()
    t_list, l_list = [T] * B, [int(n) for n in l_lens]
    lab64 = labels.long()

    def library():
        with torch.no_grad():
            return F.ctc_loss(F.log_softmax(x, -1), lab64, t_list, l_list,
                              blank=CRNN_CLASSES, reduction="none") / T

    xg = x.clone().requires_grad_(True)

    def library_grad():
        with torch.enable_grad():
            out = F.ctc_loss(F.log_softmax(xg, -1), lab64, t_list, l_list,
                             blank=CRNN_CLASSES, reduction="none") / T
            return torch.autograd.grad(out.sum(), xg)

    port = forward()["Loss"][0].reshape(-1)
    ref = library()
    err = float((port - ref).abs().max())
    g_port = grad()["Logits@GRAD"][0].values.reshape(B, T, C)
    g_ref = library_grad()[0].transpose(0, 1).reshape(B, T, C)
    g_err = float((g_port - g_ref).abs().max())
    times = {}
    for name, fn in (("warpctc", forward), ("warpctc_grad", grad),
                     ("ctc_loss", library), ("ctc_loss_grad", library_grad)):
        times[name] = replay_or_profile(name, fn)
        times[name + "_plain"] = cuda_ms(fn, iters=10)
    bound = ctc_bound(t_list, l_list, C)
    bound_grad = ctc_bound(t_list, l_list, C, grad=True)

    def fmt(name):
        return "%.4f (%s)" % times[name]

    print("ctc: warpctc alone at B %d, T %d, C %d (labels of %d-%d, %d in "
          "all): against F.ctc_loss over log_softmax, loss max_abs_err %.3g, "
          "grad %.3g; device ms forward %s, grad %s; eager %.4f, grad %.4f; "
          "F.ctc_loss %s, with backward %s (eager %.4f, %.4f); bound %.6f by "
          "%s, grad %.6f by %s [%s]"
          % (B, T, C, min(l_list), max(l_list), sum(l_list), err, g_err,
             fmt("warpctc"), fmt("warpctc_grad"), times["warpctc_plain"],
             times["warpctc_grad_plain"], fmt("ctc_loss"),
             fmt("ctc_loss_grad"), times["ctc_loss_plain"],
             times["ctc_loss_grad_plain"], bound[0], bound[1],
             bound_grad[0], bound_grad[1], smi), flush=True)
    if err > 1e-4 or g_err > 1e-4:
        raise SystemExit("chip_smoke: warpctc disagrees with F.ctc_loss")
    times["bound"], times["bound_grad"] = bound[0], bound_grad[0]
    return times


def phase_ctc():
    """Loops, conditionals, tensor arrays, rank tables and CTC (phase
    13): the loop machinery on the card against the CPU (13a), the JAX
    CTC test's flow (13b), CRNN-CTC at full width (13c) and warpctc
    alone (13d).  Returns the launch counts of CRNN's checked steps (no
    hand-written kernel runs here)."""
    import paddle_tpu_torch.fluid as fluid

    t0 = time.perf_counter()
    exe = fluid.Executor()
    if exe.device.type != "cuda":
        raise SystemExit("chip_smoke: the executor is not on the card")
    smi = nvidia_smi_line()
    ctc_machinery(exe.device, smi)
    ctc_flow(exe)
    launches = crnn_full(exe, smi)
    ctc_op_times(exe.device, smi)
    print("ctc: phase 13 in %.1f s" % (time.perf_counter() - t0),
          flush=True)
    return launches


# -- phase 14: the v2 API and the book's attention NMT ------------------------

# the Paddle book's chapter 8 (machine_translation, the v2 train.py; the
# reference's demo/seqToseq): BASELINE.json configs[3] "seq2seq NMT with
# attention" at its published widths
NMT_DICT = 30000          # source and target dictionaries
NMT_WORD = 512            # word vectors
NMT_HID = 512             # encoder GRUs (each way) and decoder GRU
NMT_LR, NMT_L2 = 5e-5, 8e-4
NMT_BEAM, NMT_MAXLEN = 3, 250
NMT_BATCH = 64            # the port's seeded wmt14 synthetic reader
NMT_GEN_BATCH = 4         # sentences beam-generated on the card and CPU


def build_nmt(v2, dict_size=NMT_DICT, word=NMT_WORD, hidden=NMT_HID,
              generating=False, beam_size=NMT_BEAM, max_length=NMT_MAXLEN):
    """The book's `seq_to_seq_net` through `v2`'s layers (the port's
    here; tests/test_torch_v2.py builds it with both packages' and holds
    the descs and steps equal), into the current default programs: a
    forward and a reverse `simple_gru` over the source embedding,
    concatenated; the encoder projection (`fc`, linear, no bias); the
    decoder boot `fc(first_seq(backward), tanh, no bias)`; the decoder
    step (`memory("gru_decoder")`, `simple_attention`, `fc([context,
    word]) -> 3 * hidden`, `gru_step_layer`, `fc(dict, softmax)`).
    Training returns the `classification_cost`; generating, the
    `beam_search` handle (bos 0, eos 1).  Both topologies name their
    parameters alike in a fresh program, so the generation topology
    reads what training left in the scope."""
    layer, networks = v2.layer, v2.networks
    act, dtype = v2.activation, v2.data_type
    src = layer.data(name="source_language_word",
                     type=dtype.integer_value_sequence(dict_size))
    src_emb = layer.embedding(input=src, size=word)
    fwd = networks.simple_gru(input=src_emb, size=hidden)
    bwd = networks.simple_gru(input=src_emb, size=hidden, reverse=True)
    enc = layer.concat(input=[fwd, bwd])
    enc_proj = layer.fc(input=enc, size=hidden, act=act.Linear(),
                        bias_attr=False)
    boot = layer.fc(input=layer.first_seq(input=bwd), size=hidden,
                    act=act.Tanh(), bias_attr=False)

    def step(enc_vec, proj, current_word):
        mem = layer.memory(name="gru_decoder", size=hidden, boot_layer=boot)
        context = networks.simple_attention(
            encoded_sequence=enc_vec, encoded_proj=proj, decoder_state=mem)
        inputs = layer.fc(input=[context, current_word], size=hidden * 3,
                          act=act.Linear(), bias_attr=False)
        gru = layer.gru_step_layer(input=inputs, output_mem=mem,
                                   size=hidden, name="gru_decoder")
        return layer.fc(input=gru, size=dict_size, act=act.Softmax(),
                        bias_attr=True)

    statics = [layer.StaticInput(input=enc), layer.StaticInput(input=enc_proj)]
    if generating:
        word_in = layer.GeneratedInput(
            size=dict_size, embedding_name="_target_language_embedding",
            embedding_size=word)
        return layer.beam_search(step=step, input=statics + [word_in],
                                 bos_id=0, eos_id=1, beam_size=beam_size,
                                 max_length=max_length)
    trg = layer.embedding(
        input=layer.data(name="target_language_word",
                         type=dtype.integer_value_sequence(dict_size)),
        size=word, param_attr=v2.attr.Param(name="_target_language_embedding"))
    decoder = layer.recurrent_group(step=step, input=statics + [trg])
    label = layer.data(name="target_language_next_word",
                       type=dtype.integer_value_sequence(dict_size))
    return layer.classification_cost(input=decoder, label=label)


def nmt_decode_state(state, main, seed=SEED + 4):
    """A state from which beam search decodes non-degenerately: `state`
    ({name: ndarray} of `main`'s parameters, `main` the training
    program) with, in the decoder step (block 1), the weights of the
    product into the GRU's gates 20 times theirs, the output layer's
    weight drawn from N(0, 1000^2 / hidden) by `seed` and its bias 0.
    From random weights every step's probabilities lie near 1 / dict: a
    step's top candidates are ties within rounding, and over 250 steps
    the beams' scores (sums near -2,500) differ by less than the card's
    and the CPU's rounding.  With these the decoder's state saturates
    and sets a peaked softmax: the best word of a step has a
    log-probability near 0, the beams' scores stay near -10 and lie
    apart by 0.05 and more, and the words follow the source (through
    the attention) and the last word (through its embedding)."""
    out = dict(state)
    block = main.desc.block(1)
    gru = next(op for op in block.ops if op.type == "gru_unit")
    gates = state[gru.input("Weight")[0]].shape[1]
    muls = [op.input("Y")[0] for op in block.ops if op.type == "mul"]
    out_w = muls[-1]                      # the last fc: the dictionary
    for n in muls[:-1]:
        if state[n].shape[1] == gates:
            out[n] = state[n] * np.float32(20.0)
    rows, dict_size = state[out_w].shape
    out[out_w] = (np.random.RandomState(seed).randn(rows, dict_size)
                  * (1000.0 / np.sqrt(rows))).astype(np.float32)
    for n, v in state.items():
        if v.shape == (dict_size,):
            out[n] = np.zeros_like(v)
    return out


# the card against the CPU plain path: (a) each new op's outputs exactly
# (they copy, move or count rows, or print) but the ragged sums and means
# and the nested gather's grad, f32 sums in other orders, within
# V2_OP_RTOL of the larger of 1 and their magnitude; (c) the NMT's 2 Adam
# steps from one state: the loss within NMT_LOSS_RTOL of its size (f32 on
# both sides; the 30,000-way softmax and the 32-step decoder sum in other
# orders) and each group's change (parameters, moments) within
# NMT_CHANGE_RL2 in relative L2, as the seq2seq of phase 11; (d) the beam's
# ids exactly and its scores within NMT_SCORE_ATOL: a score sums up to 250
# log-probabilities whose logits reach about 1e3 under the decode state
# (`nmt_decode_state`), where an f32 rounding of 1e-7 of a logit moves a
# step's log-probability by up to 1e-4; on the CPU, perturbing every
# weight by 1e-6 of itself moved the scores by up to 7.4e-4, and the
# beams a step keeps lie 0.086 and more apart; (e) the nested group's
# outputs exactly and its 10 SGD losses within NMT_LOSS_RTOL
V2_OP_RTOL = 1e-6
NMT_LOSS_RTOL = 1e-5
NMT_CHANGE_RL2 = 1e-4
NMT_SCORE_ATOL = 5e-3


@contextlib.contextmanager
def v2_program(v2, use_gpu, scope=None):
    """The v2 API on the card (or, with use_gpu False, the CPU) building
    into fresh default programs, with `scope` (a fresh Scope when None)
    as the global scope: yields (main, startup, scope)."""
    import paddle_tpu_torch.fluid as fluid

    main, startup = fluid.Program(), fluid.Program()
    scope = scope if scope is not None else fluid.Scope()
    v2.init(use_gpu=use_gpu)
    with fluid.program_guard(main, startup), fluid.scope_guard(scope):
        yield main, startup, scope


def v2_op_cases(rs):
    """(tag, op type, inputs {slot: [(name, value)]}, outputs, attrs,
    exact) of 14a: the nested ops, print, the five ops' ragged inputs
    and sign, on CPU tensors from `rs`."""
    import torch
    from paddle_tpu_torch.core.ragged import RaggedTensor

    def rag(lengths, width, outer=None, pad=3, ints=None):
        total = int(sum(lengths))
        vals = (rs.randint(0, ints, size=(total + pad, width)) if ints
                else rs.randn(total + pad, width)).astype(
                    np.int32 if ints else np.float32)
        vals[total:] = ints - 1 if ints else 1e4
        splits = ([outer] if outer else []) + [np.cumsum([0] + lengths)]
        return RaggedTensor(torch.from_numpy(vals),
                            [torch.tensor(sp, dtype=torch.int32)
                             for sp in splits], nvalid=total, max_seqlen=8)

    ref = RaggedTensor(torch.zeros(5, 1),
                       [torch.tensor([0, 2, 2, 5], dtype=torch.int32)])
    x, y = rag([2, 0, 3, 1], 3), rag([2, 0, 3, 1], 3)
    ids = rag([2, 0, 3, 1], 2, ints=4)
    label = torch.from_numpy(rs.randint(0, 4, size=(9, 1)).astype(np.int32))
    red = [("reduce_sum", {"dim": 0}, False),
           ("reduce_mean", {"reduce_all": True}, False),
           ("reduce_max", {"dim": 0, "keep_dim": True}, True),
           ("reduce_min", {"dim": 1, "keep_dim": True}, True)]
    return [
        ("seq_unnest", "seq_unnest",
         {"X": [("x", rag([2, 1, 3, 1, 2], 3, outer=[0, 2, 2, 5]))]},
         {"Inner": ["i"], "OuterRef": ["r"]}, {}, True),
        ("seq_outer_expand", "seq_outer_expand",
         {"X": [("x", torch.from_numpy(rs.randn(3, 4).astype(np.float32)))],
          "OuterRef": [("r", ref)]}, {"Out": ["o"]}, {}, True),
        ("seq_renest dense", "seq_renest",
         {"X": [("x", torch.from_numpy(rs.randn(5, 3).astype(np.float32)))],
          "OuterRef": [("r", ref)]}, {"Out": ["o"]}, {}, True),
        ("seq_renest ragged", "seq_renest",
         {"X": [("x", rag([2, 1, 3, 1, 2], 3))], "OuterRef": [("r", ref)]},
         {"Out": ["o"]}, {}, True),
        ("print", "print", {"In": [("x", x)]}, {"Out": ["o"]},
         {"message": "v2: the print op on the card:", "summarize": 4}, True),
        ("concat", "concat", {"X": [("x", x), ("y", y)]}, {"Out": ["o"]},
         {"axis": 1}, True),
        ("increment", "increment", {"X": [("x", x)]}, {"Out": ["o"]},
         {"step": 2.0}, True),
    ] + [(op, op, {"X": [("x", x)]}, {"Out": ["o"]}, attrs, exact)
         for op, attrs, exact in red] + [
        ("dropout", "dropout", {"X": [("x", x)]},
         {"Out": ["o"], "Mask": ["m"]},
         {"dropout_prob": 0.3, "is_test": True}, True),
        ("accuracy", "accuracy",
         {"Out": [("o", ids.values.float())], "Indices": [("i", ids)],
          "Label": [("l", label)]},
         {"Accuracy": ["a"], "Correct": ["c"], "Total": ["t"]}, {}, True),
        ("sign", "sign", {"X": [("x", x)]}, {"Out": ["o"]}, {}, True),
    ]


def v2_beam_inputs(rs, steps=4, n_src=3, beam=3, cands=4):
    """(beam_search's inputs of the reference test, the per-step
    selections of `steps` seeded beam_search calls on the CPU): the
    latter feed beam_search_decode."""
    import torch
    from paddle_tpu_torch.core.ragged import RaggedTensor
    from paddle_tpu_torch.ops.registry import get_op_info

    def two(vals, lod0, lod1):
        return RaggedTensor(torch.from_numpy(np.asarray(vals)),
                            [torch.tensor(lod0, dtype=torch.int32),
                             torch.tensor(lod1, dtype=torch.int32)])

    lod = ([0, 2, 4], [0, 1, 2, 3, 4])
    first = {"pre_ids": [two(np.asarray([[1], [2], [0], [4]], np.int32),
                             *lod)],
             "ids": [two(np.asarray([[4, 2, 5], [2, 1, 3], [3, 5, 2],
                                     [8, 2, 1]], np.int32), *lod)],
             "scores": [two(np.asarray([[.5, .3, .2], [.6, .3, .1],
                                        [.9, .5, .1], [.7, .5, .1]],
                                       np.float32), *lod)]}
    kernel = get_op_info("beam_search").kernel
    lod0, lod1 = np.arange(n_src + 1), np.arange(n_src + 1)
    pre = np.zeros((n_src, 1), np.int32)
    sel = []
    for _ in range(steps):
        rows = int(lod1[-1])
        out = kernel(None, {
            "pre_ids": [two(pre, lod0, lod1)],
            "ids": [two(rs.randint(2, 20, size=(rows, cands)).astype(
                np.int32), lod0, lod1)],
            "scores": [two(rs.rand(rows, cands).astype(np.float32), lod0,
                           lod1)]}, {"beam_size": beam, "end_id": 1})
        ids, scores = out["selected_ids"][0], out["selected_scores"][0]
        sel.append((ids, scores))
        lod0 = ids.row_splits[1][ids.row_splits[0].long()].numpy()
        lod1 = np.arange(int(ids.row_splits[1][-1]) + 1)
        pre = ids.values.numpy()
    return first, sel


def v2_ops(device):
    """14a: each new op on the card against the CPU plain path; the
    nested gather's generic grad too; the beam ops on the reference
    test's inputs and on 4 seeded steps of 3 sources."""
    import torch
    from paddle_tpu_torch.ops.registry import get_op_info, like, values_of

    rs = np.random.RandomState(SEED)
    worst = {}
    for tag, op, ins, outs, attrs, exact in v2_op_cases(rs):
        ref = book_run_op(op, ins, outs, attrs, torch.device("cpu"))
        got = book_run_op(op, ins, outs, attrs, device)
        err = book_compare(tag, got, ref)
        if err > (0.0 if exact else V2_OP_RTOL):
            raise SystemExit("chip_smoke: %s on the card differs from the "
                             "CPU by %.3g" % (tag, err))
        worst[tag] = err
        if op in ("seq_outer_expand", "dropout"):
            o = ref["o"]
            og = torch.from_numpy(rs.randn(*values_of(o).shape).astype(
                np.float32))
            gins = book_grad_ins(ins, outs, {"Out": like(o, og)}, ref)
            if op == "dropout":
                gins["O@Mask"] = [("m", torch.from_numpy(
                    (rs.rand(*ref["m"].shape) > 0.3).astype(np.float32)))]
            gouts = {"X@GRAD": ["x@GRAD"]}
            gattrs = dict(attrs, is_test=False)
            err = book_compare(tag + " grad", book_run_op(
                op + "_grad", gins, gouts, gattrs, device), book_run_op(
                op + "_grad", gins, gouts, gattrs, torch.device("cpu")))
            if err > V2_OP_RTOL:
                raise SystemExit("chip_smoke: %s's grad on the card differs "
                                 "from the CPU by %.3g" % (tag, err))
            worst[tag + " grad"] = err

    def on(v, dev):
        return [x.to(dev) for x in v] if isinstance(v, list) else v.to(dev)

    first, sel = v2_beam_inputs(rs)
    decode_ins = {"Ids": [[i for i, _ in sel]], "Scores": [[s for _, s in
                                                           sel]]}
    for op, ins in (("beam_search", first), ("beam_search_decode",
                                             decode_ins)):
        kernel = get_op_info(op).kernel
        attrs = {"beam_size": 2, "end_id": 0}
        ref = kernel(None, {k: [on(v, "cpu") for v in vs]
                            for k, vs in ins.items()}, attrs)
        got = kernel(None, {k: [on(v, device) for v in vs]
                            for k, vs in ins.items()}, attrs)
        for slot in ref:
            if got[slot][0].values.device.type != "cuda":
                raise SystemExit("chip_smoke: %s's %s is not on the card"
                                 % (op, slot))
            if book_compare(op, {slot: got[slot][0]},
                            {slot: ref[slot][0]}) != 0.0:
                raise SystemExit("chip_smoke: %s's %s differs on the card"
                                 % (op, slot))
        worst[op] = 0.0
    print("v2: 14a, each new op on the card against the CPU plain path, "
          "largest error of its size: %s (gate: exact, sums and means %g)"
          % (", ".join("%s %.3g" % kv for kv in worst.items()), V2_OP_RTOL),
          flush=True)


def v2_fit_a_line(smi):
    """14b: tests/test_v2_api.py's fit-a-line through v2's SGD.train on
    the card: 12 passes of the shuffled uci_housing reader at batch 20,
    the cost must fall; then test() and infer()."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.v2 as v2

    t0 = time.perf_counter()
    with v2_program(v2, True):
        x = v2.layer.data(name="x", type=v2.data_type.dense_vector(13))
        pred = v2.layer.fc(input=x, size=1, act=v2.activation.Linear())
        y = v2.layer.data(name="y", type=v2.data_type.dense_vector(1))
        cost = v2.layer.square_error_cost(input=pred, label=y)
        params = v2.parameters.create(cost)
        trainer = v2.trainer.SGD(
            cost=cost, parameters=params,
            update_equation=v2.optimizer.Momentum(momentum=0.9,
                                                  learning_rate=1e-3))
        costs = []
        trainer.train(reader=v2.batch(v2.reader.shuffle(
            paddle.dataset.uci_housing.train(), buf_size=500),
            batch_size=20), num_passes=12, feeding={"x": 0, "y": 1},
            event_handler=lambda e: costs.append(e.cost) if isinstance(
                e, v2.event.EndIteration) else None)
        test = trainer.test(reader=v2.batch(
            paddle.dataset.uci_housing.test(), batch_size=20),
            feeding={"x": 0, "y": 1})
        data = [(s[0],) for s in paddle.dataset.uci_housing.test()()][:8]
        out = v2.infer(output_layer=pred, parameters=params, input=data,
                       feeding={"x": 0, "y": 1})
    print("v2: 14b fit-a-line through v2.trainer.SGD on the card: %d steps,"
          " cost %.6f -> %.6f, test cost %.6f, infer %s finite; %.1f s [%s]"
          % (len(costs), costs[0], costs[-1], test.cost, out.shape,
             time.perf_counter() - t0, smi), flush=True)
    if not costs[-1] < costs[0] or not np.isfinite(out).all():
        raise SystemExit("chip_smoke: v2 fit-a-line did not learn")


def nmt_batches(n, batch=NMT_BATCH):
    """The first n batches of the port's wmt14 reader at dict 30,000."""
    import paddle_tpu_torch as paddle

    rows = []
    for sample in paddle.dataset.wmt14.train(NMT_DICT)():
        rows.append(sample)
        if len(rows) == n * batch:
            break
    return [rows[k * batch:(k + 1) * batch] for k in range(n)]


def sync_count(fn):
    """(count, {"file:line": count}) of the synchronizing CUDA calls
    fn() makes, counted by PyTorch's sync debug mode (one warning each,
    at the Python line that made the call)."""
    import warnings
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    where = collections.Counter(
        "%s:%d" % (os.path.relpath(w.filename), w.lineno) for w in caught
        if "synchroniz" in str(w.message))
    return sum(where.values()), dict(where)


def nmt_train(exe, smi):
    """14c: the book's attention NMT at full width, trained through v2's
    SGD on the card.  Returns (the launches of its 2 checked steps, the
    card's state after them, the parameter names, the program)."""
    import torch
    import paddle_tpu_torch.fluid as fluid
    import paddle_tpu_torch.v2 as v2

    t0 = time.perf_counter()
    with v2_program(v2, True) as (main, startup, scope):
        cost = build_nmt(v2)
        params = v2.parameters.create(cost)
        trainer = v2.trainer.SGD(
            cost=cost, parameters=params,
            update_equation=v2.optimizer.Adam(
                learning_rate=NMT_LR, regularization_rate=NMT_L2))
        block = main.desc.block(0)
        counts = collections.Counter(op.type for op in block.ops)
        pnames = [p.name for p in main.global_block().all_parameters()]
        n_values = sum(int(np.prod(block.vars[n].shape)) for n in pnames)
        persist = [n for n, vd in block.vars.items() if vd.persistable]
        init = {n: scope.get(n).cpu().numpy() for n in persist}
        print("v2: 14c NMT (the book's seq_to_seq_net at dict %d, %d wide): "
              "main %d ops in %d blocks (%d + %d), %d parameters, %d values "
              "(%.3f M), %d persistables; built and started in %.1f s"
              % (NMT_DICT, NMT_WORD, len(block.ops) + len(
                  main.desc.block(1).ops), len(main.desc.blocks),
                 len(block.ops), len(main.desc.block(1).ops), len(pnames),
                 n_values, n_values / 1e6, len(persist),
                 time.perf_counter() - t0), flush=True)
        if counts["recurrent"] != 1 or counts["adam"] != len(pnames):
            raise SystemExit("chip_smoke: the NMT program is not the one "
                             "held against the JAX package")
        batches = nmt_batches(3)
        rows = [sum(len(s[2]) for s in b) for b in batches]
        card = []
        reset_launches()
        t1 = time.perf_counter()
        trainer.train(reader=lambda: iter(batches[:2]),
                      event_handler=lambda e: card.append(e.cost)
                      if isinstance(e, v2.event.EndIteration) else None)
        torch.cuda.synchronize()
        gsecs = time.perf_counter() - t1
        launches = read_launches()
        after = {n: scope.get(n).cpu().numpy() for n in persist}
    fvars = [main.global_block().var(n) for n in (
        "source_language_word", "target_language_word",
        "target_language_next_word")]
    cpu_feeds = book_feeds(main, fvars, batches)
    cpu, cpu_state, csecs = run_from_state(
        fluid.Executor(fluid.CPUPlace()), main, cost, init, cpu_feeds[:2])
    loss_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(card, cpu))
    groups = {"parameters": pnames,
              "moments": [n for n in persist if "_moment" in n]}
    errs = {g: change_rl2(after, cpu_state, init, names)
            for g, names in groups.items()}
    print("v2: NMT 2 Adam steps at batch %d (%d and %d target rows) from "
          "one state: v2 SGD.train on the card (%.1f s) costs %s; the CPU "
          "plain path (%.1f s) %s; loss error %.3g of its size (gate %g); "
          "the steps' change, relative L2 error: %s (gate %g); hand-written "
          "kernel launches %s"
          % (NMT_BATCH, rows[0], rows[1], gsecs, ", ".join(
              "%.6f" % c for c in card), csecs, ", ".join(
              "%.6f" % c for c in cpu), loss_err, NMT_LOSS_RTOL, ", ".join(
              "%s %.3g" % kv for kv in errs.items()), NMT_CHANGE_RL2,
             json.dumps(launches)), flush=True)
    if loss_err > NMT_LOSS_RTOL or max(errs.values()) > NMT_CHANGE_RL2 \
            or not all(np.isfinite(v).all() for v in after.values()):
        raise SystemExit("chip_smoke: the NMT steps on the card disagree "
                         "with the CPU plain path")

    dev_feeds = book_feeds(main, fvars, batches, exe.device)
    state = {n: torch.from_numpy(v).to(exe.device) for n, v in init.items()}
    repeat_gate("v2: NMT", exe, main, dev_feeds[0], state)
    del state
    scope = params_scope(init, exe.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in dev_feeds:
        exe.run(main, feed=f, fetch_list=[cost], scope=scope,
                return_numpy=False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    def step():
        return exe.run(main, feed=dev_feeds[0], fetch_list=[cost],
                       scope=scope, return_numpy=False)

    syncs = sync_count(step)
    with fluid.scope_guard(scope):
        sgd_syncs = sync_count(lambda: trainer.train(
            reader=lambda: iter(batches[:1])))
    times = timed_steps(step)
    med = float(np.median(times))
    print("v2: NMT batch %d: step %.3f ms (median of 10 after 2 warm, feeds "
          "on the card; mean %.3f, min %.3f, max %.3f), %.1f target "
          "tokens/s (%d target rows), %.1f sentence pairs/s; peak memory "
          "of 3 steps %.3f GB; synchronizing calls: %d in an executor step "
          "(the cost left on the card; %s), %d in one SGD.train step "
          "(feeding from the host and fetching the cost; %s) [%s]"
          % (NMT_BATCH, med, np.mean(times), min(times), max(times),
             rows[0] / med * 1e3, rows[0], NMT_BATCH / med * 1e3,
             peak / 1e9, syncs[0], json.dumps(syncs[1]), sgd_syncs[0],
             json.dumps(sgd_syncs[1]), smi), flush=True)
    profile_step(step, set(counts) | set(
        op.type for op in main.desc.block(1).ops), 0, med,
        what="one NMT step at batch %d" % NMT_BATCH)
    del scope
    torch.cuda.empty_cache()
    return launches, after, pnames, main


def nmt_generate(state, pnames, main, smi):
    """14d: beam 3 to at most 250 tokens on the card and on the CPU from
    one decode state (`nmt_decode_state` over the trained `state` of
    the training program `main`),
    through v2.infer on a generation topology built in a fresh program:
    ids equal, scores within NMT_SCORE_ATOL; ms per generated token."""
    import torch
    import paddle_tpu_torch.fluid as fluid
    import paddle_tpu_torch.v2 as v2

    dstate = nmt_decode_state({n: state[n] for n in pnames}, main)
    sources = [(s[0],) for s in nmt_batches(1, NMT_GEN_BATCH)[0]]
    res = {}
    for use_gpu in (False, True):
        dev = "cuda" if use_gpu else "cpu"
        place = fluid.CUDAPlace(0) if use_gpu else fluid.CPUPlace()
        with v2_program(v2, use_gpu, scope=params_scope(dstate,
                                                        place.device())):
            beam = build_nmt(v2, generating=True)
            inference = v2.inference.Inference(beam)
            # on the card the second of two runs is timed: the first
            # meets each shape's first launch
            for _ in range(2 if use_gpu else 1):
                t0 = time.perf_counter()
                probs, ids = inference.iter_infer_field(
                    sources, field=["prob", "id"])
                if use_gpu:
                    torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                if use_gpu and dev in res and res[dev][1] != ids:
                    raise SystemExit("chip_smoke: the NMT beam differs "
                                     "run to run on the card")
                res[dev] = (probs, ids, secs,
                            inference.last_stats["steps"])
    (cprobs, cids, csecs, csteps), (gprobs, gids, gsecs, gsteps) = \
        res["cpu"], res["cuda"]
    err = float(np.abs(gprobs - cprobs).max())
    seqs, cur = [], []
    for w in gids:
        if w == -1:
            seqs.append(cur)
            cur = []
        else:
            cur.append(w)
    print("v2: 14d beam %d to at most %d tokens for %d sentences on the "
          "card (the second of two runs, which gave the same ids): %d steps "
          "in %.1f ms, %.3f ms per generated token (CPU %d steps, %.1f "
          "ms); %d results of %s tokens, %d distinct; ids equal the CPU's: "
          "%s; scores %s, max_abs_err %.3g (gate %g) [%s]"
          % (NMT_BEAM, NMT_MAXLEN, len(sources), gsteps, gsecs * 1e3,
             gsecs * 1e3 / max(gsteps, 1), csteps, csecs * 1e3, len(seqs),
             sorted({len(s) for s in seqs}), len({tuple(s) for s in seqs}),
             gids == cids, np.round(gprobs, 4).tolist(), err,
             NMT_SCORE_ATOL, smi), flush=True)
    if gids != cids or err > NMT_SCORE_ATOL or gsteps != csteps:
        raise SystemExit("chip_smoke: the NMT beam on the card differs from "
                         "the CPU")
    words = {w for s in seqs for w in s[1:-1]}
    print("v2: the NMT beam's results use %d distinct words" % len(words),
          flush=True)
    if len({tuple(s) for s in seqs}) < len(seqs) or len(words) < 10:
        raise SystemExit("chip_smoke: the NMT beam decodes degenerately")


def v2_nested(device):
    """14e: the nested SubsequenceInput groups of
    tests/test_v2_recurrent.py:281-380 on the card against the CPU: the
    inner accumulation exactly, the sentence encoder's 10 SGD steps."""
    import paddle_tpu_torch.fluid as fluid
    import paddle_tpu_torch.v2 as v2

    layer = v2.layer
    out = []
    seqs = [[[[1, 0], [2, 0]], [[5, 0], [1, 0], [1, 0]]], [[[7, 0]]]]
    for use_gpu in (False, True):
        with v2_program(v2, use_gpu) as (main, startup, scope):
            x = layer.data(name="x",
                           type=v2.data_type.dense_vector_sub_sequence(2))

            def outer_step(sent):
                def inner_step(w):
                    mem = layer.memory(name="nacc", size=2)
                    acc = layer.addto(input=[mem, w], act=None)
                    mem.set_input(acc)
                    return acc
                return layer.recurrent_group(step=inner_step, input=sent)

            res = layer.recurrent_group(step=outer_step,
                                        input=layer.SubsequenceInput(x))
            place = v2.config._place()
            feed = fluid.DataFeeder(feed_list=[x], place=place).feed(
                [(s,) for s in seqs])
            out.append(fluid.Executor(place).run(main, feed=feed,
                                                 fetch_list=[res])[0])
    (gv, glod), (cv, clod) = ctc_host(out[1]), ctc_host(out[0])
    if glod != clod or not np.array_equal(gv, cv):
        raise SystemExit("chip_smoke: the nested group differs on the card")

    rs = np.random.RandomState(SEED)
    docs = [[rs.rand(rs.randint(2, 5), 4).tolist()
             for _ in range(rs.randint(1, 4))] for _ in range(6)]
    rows = list(zip(docs, [rs.rand(4).tolist() for _ in range(6)],
                    [[float(len(d))] for d in docs]))
    with v2_program(v2, True) as (main, startup, _):
        words = layer.data(name="words",
                           type=v2.data_type.dense_vector_sub_sequence(4))
        glob = layer.data(name="glob", type=v2.data_type.dense_vector(4))
        label = layer.data(name="label", type=v2.data_type.dense_vector(1))

        def encode_sentence(sent, g):
            h = layer.fc(input=sent, size=6, act=v2.activation.Tanh())
            return layer.addto(input=[layer.last_seq(input=h),
                                      layer.fc(input=g, size=6)], act=None)

        sent_seq = layer.recurrent_group(
            step=encode_sentence,
            input=[layer.SubsequenceInput(words), layer.StaticInput(glob)])
        pred = layer.fc(input=layer.last_seq(input=sent_seq), size=1)
        cost = layer.mse_cost(input=pred, label=label)
        fluid.optimizer.SGD(learning_rate=0.05).minimize(cost)
    init = book_state(fluid.Executor(fluid.CPUPlace()), startup, main)
    feeds = book_feeds(main, [main.global_block().var(n) for n in (
        "words", "glob", "label")], [rows] * 10)
    losses = [run_from_state(ex, main, cost, init, feeds)[0] for ex in (
        fluid.Executor(fluid.CPUPlace()), fluid.Executor(fluid.CUDAPlace(0)))]
    err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(*losses[::-1]))
    print("v2: 14e nested SubsequenceInput groups on the card: the inner "
          "accumulation %s with lod %s, equal to the CPU's; the sentence "
          "encoder's 10 SGD steps %.6f -> %.6f, loss error %.3g of its size "
          "(gate %g)"
          % (gv.tolist(), glod, losses[1][0], losses[1][-1], err,
             NMT_LOSS_RTOL), flush=True)
    if err > NMT_LOSS_RTOL or not losses[1][-1] < losses[1][0]:
        raise SystemExit("chip_smoke: the nested encoder differs on the "
                         "card")


def phase_v2():
    """The v2 API and the book's attention NMT (phase 14): the new ops on
    the card (14a), v2 fit-a-line (14b), the NMT trained at full width
    (14c) and beam-generated (14d), the nested groups (14e).  Returns the
    launch counts of the NMT's checked steps (no hand-written kernel
    runs here)."""
    import paddle_tpu_torch.fluid as fluid

    t0 = time.perf_counter()
    exe = fluid.Executor()
    if exe.device.type != "cuda":
        raise SystemExit("chip_smoke: the executor is not on the card")
    smi = nvidia_smi_line()
    v2_ops(exe.device)
    v2_fit_a_line(smi)
    launches, state, pnames, main = nmt_train(exe, smi)
    nmt_generate(state, pnames, main, smi)
    v2_nested(exe.device)
    print("v2: phase 14 in %.1f s" % (time.perf_counter() - t0), flush=True)
    return launches


# -- phase 15: the optimizer and layer stack; the transformer trained as
# its users train it ------------------------------------------------------

# the transformer at bench.py's width (BATCH, SEQ, VOCAB, N_LAYER, N_HEAD,
# D_MODEL) with label smoothing STACK_EPS on its logits, one
# GradientClipByGlobalNorm(STACK_CLIP) on every parameter, a piecewise
# schedule whose steps cross a boundary, and Adam with fused updates at
# the default cap (2^18 elements)
STACK_EPS = 0.1
STACK_CLIP = 1.0
STACK_BOUNDS, STACK_LRS = [2, 4], [1e-3, 5e-4, 2.5e-4]


def build_stack(fluid, batch=BATCH, seq=SEQ, vocab=VOCAB, n_layer=N_LAYER,
                n_head=N_HEAD, d_model=D_MODEL, clip_norm=STACK_CLIP,
                fuse=True):
    """The transformer of models/transformer_program.py through
    `fluid`'s layers (the port's here; tests/test_torch_optim_stack.py
    builds it with both packages' and holds the descs and steps equal),
    trained with label smoothing (a `one_hot` of the targets scaled by
    1 - STACK_EPS plus STACK_EPS / vocab, against
    `softmax_with_cross_entropy(soft_label=True)`), a global-norm clip of
    `clip_norm` on every parameter, the STACK_BOUNDS / STACK_LRS
    piecewise schedule and Adam, its updates fused with `fuse`: (main,
    startup, loss, lr, the global norm's var name)."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        tokens, positions, targets = (
            layers.data(name=name, shape=shape, dtype="int64",
                        append_batch_size=False)
            for name, shape in (("tokens", [batch, seq]),
                                ("positions", [batch, seq]),
                                ("targets", [batch, seq, 1])))
        x = layers.embedding(tokens, size=[vocab, d_model]) \
            + layers.embedding(positions, size=[seq, d_model])
        for _ in range(n_layer):
            h = layers.layer_norm(x, begin_norm_axis=2)
            qkv = layers.fc(input=h, size=3 * d_model, num_flatten_dims=2)
            q, k, v = layers.split(qkv, num_or_sections=3, dim=-1)
            o = layers.flash_attention(q, k, v, num_heads=n_head,
                                       causal=True)
            x = x + layers.fc(input=o, size=d_model, num_flatten_dims=2)
            h = layers.layer_norm(x, begin_norm_axis=2)
            h = layers.fc(input=h, size=4 * d_model, num_flatten_dims=2,
                          act="relu")
            x = x + layers.fc(input=h, size=d_model, num_flatten_dims=2)
        x = layers.layer_norm(x, begin_norm_axis=2)
        logits = layers.fc(input=x, size=vocab, num_flatten_dims=2)
        flat = layers.reshape(x=logits, shape=[-1, vocab])
        tgt = layers.reshape(x=targets, shape=[-1, 1])
        smooth = layers.elementwise_add(
            x=layers.scale(x=layers.one_hot(tgt, vocab),
                           scale=1.0 - STACK_EPS),
            y=layers.fill_constant(shape=[1], dtype="float32",
                                   value=STACK_EPS / vocab))
        loss = layers.mean(x=layers.softmax_with_cross_entropy(
            flat, smooth, soft_label=True))
        clip = fluid.clip.GradientClipByGlobalNorm(clip_norm=clip_norm)
        for p in main.global_block().all_parameters():
            p.gradient_clip_attr = clip
        lr = fluid.lr_schedules.piecewise_decay(STACK_BOUNDS, STACK_LRS)
        fluid.optimizer.AdamOptimizer(learning_rate=lr).minimize(
            loss, fuse_updates=fuse)
    gnorm = next(op.output("Out")[0] for op in main.global_block().ops
                 if op.type == "sqrt"
                 and op.output("Out")[0].startswith("global_norm"))
    return main, startup, loss, lr, gnorm


# the activations' tie points: each bound of brelu (-1, 2 as set below),
# relu6 (0, 6), hard_sigmoid (x = -2.5, 2.5), soft_relu (-40, 40),
# softshrink and hard_shrink (-0.5, 0.5), thresholded_relu (1), the 0 of
# relu, leaky_relu, elu, abs and the clip op, the halves round takes to
# even; then randn
STACK_TIES = (-41.0, -40.0, -24.0, -6.0, -2.5, -2.0, -1.0, -0.5, -0.25, -0.0,
              0.0, 0.25, 0.5, 1.0, 2.0, 2.5, 6.0, 24.0, 40.0, 41.0)
STACK_ACTS = (  # (op type, attrs)
    ("brelu", {"t_min": -1.0, "t_max": 2.0}), ("ceil", {}), ("elu", {}),
    ("elu", {"alpha": 0.5}), ("floor", {}), ("hard_shrink", {}),
    ("hard_sigmoid", {}), ("leaky_relu", {"alpha": 0.1}),
    ("logsigmoid", {}), ("pow", {"factor": 3.0}), ("reciprocal", {}),
    ("relu6", {}), ("round", {}), ("soft_relu", {}), ("softplus", {}),
    ("softshrink", {}), ("softsign", {}), ("stanh", {}),
    ("swish", {"beta": 2.0}), ("tanh_shrink", {}),
    ("thresholded_relu", {}), ("abs", {}), ("relu", {}))


def stack_op_cases():
    """(case id, op, ins {slot: [(name, CPU value)]}, outs {slot:
    [names]}, attrs, differentiated input slots, output grads {slot:
    value}, exact) for the op types of the optimizer and layer stack's
    slice, from the seed: the activations over STACK_TIES; matmul
    transposed, batched, broadcast and 1-D; gather with negative,
    repeated and out-of-range ids; scatter with a repeated, a negative and
    an out-of-range id; multiplex's negative and out-of-range ids;
    one_hot's out-of-range and negative ids, and ragged ones; soft
    labels; smooth_l1 at its bound.  `exact`: the op only moves or makes
    values, so card and CPU must agree bit for bit (NaN for NaN)."""
    import torch

    rs = np.random.RandomState(SEED + 150)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(
            np.float32))

    def ids(*v):
        return torch.tensor(v, dtype=torch.int32)

    ties = torch.cat([torch.tensor(STACK_TIES, dtype=torch.float32),
                      t(20)]).reshape(5, 8)
    x, og = [("x", ties)], {"Out": t(5, 8)}
    cases = [("%s%s" % (op, "".join("_%s%g" % kv for kv in attrs.items())),
              op, {"X": x}, {"Out": ["o"]}, attrs, ["X"], og, False)
             for op, attrs in STACK_ACTS]
    cases.append(("pow_2.5", "pow", {"X": [("x", t(5, 8).abs())]},
                  {"Out": ["o"]}, {"factor": 2.5}, ["X"], og, False))
    for tag, xs, ys, attrs in (
            ("2d", (5, 7), (7, 3), {}),
            ("transposed", (7, 5), (3, 7),
             {"transpose_X": True, "transpose_Y": True}),
            ("batched", (2, 4, 5, 6), (2, 4, 6, 3), {}),
            ("broadcast", (3, 4, 5), (5, 2), {"transpose_Y": False}),
            ("1d_2d", (5,), (5, 3), {}), ("2d_1d", (3, 5), (5,), {})):
        out_shape = torch.matmul(
            torch.zeros(xs).transpose(-1, -2) if attrs.get("transpose_X")
            else torch.zeros(xs),
            torch.zeros(ys).transpose(-1, -2) if attrs.get("transpose_Y")
            else torch.zeros(ys)).shape
        cases.append(("matmul_" + tag, "matmul",
                      {"X": [("x", t(*xs))], "Y": [("y", t(*ys))]},
                      {"Out": ["o"]}, attrs, ["X", "Y"],
                      {"Out": t(*out_shape)}, False))
    cases += [
        ("squared_l2_norm", "squared_l2_norm", {"X": [("x", t(6, 7))]},
         {"Out": ["o"]}, {}, ["X"], {"Out": torch.tensor(0.7)}, False),
        ("l1_norm", "l1_norm", {"X": x}, {"Out": ["o"]}, {}, ["X"],
         {"Out": torch.tensor(-1.3)}, False),
        ("minus", "minus", {"X": [("x", t(4, 5))], "Y": [("y", t(4, 5))]},
         {"Out": ["o"]}, {}, ["X", "Y"], {"Out": t(4, 5)}, False),
        ("squared_l2_distance", "squared_l2_distance",
         {"X": [("x", t(6, 4))], "Y": [("y", t(6, 4))]},
         {"sub_result": ["s"], "Out": ["o"]}, {}, ["X", "Y"],
         {"Out": t(6, 1)}, False),
        ("squared_l2_distance_row", "squared_l2_distance",
         {"X": [("x", t(6, 4))], "Y": [("y", t(1, 4))]},
         {"sub_result": ["s"], "Out": ["o"]}, {}, ["X", "Y"],
         {"Out": t(6, 1), "sub_result": t(6, 4)}, False),
        ("assign", "assign", {"X": [("x", t(3, 4))]}, {"Out": ["o"]}, {},
         ["X"], {"Out": t(3, 4)}, True),
        ("assign_value_int32", "assign_value", {}, {"Out": ["o"]},
         {"shape": [2, 3], "dtype": "int32", "values": [3, -1, 0, 7, 2, 5]},
         [], None, True),
        ("assign_value_float32", "assign_value", {}, {"Out": ["o"]},
         {"shape": [3], "dtype": "float32", "values": [0.5, -2.0, 1e-3]},
         [], None, True),
        ("fill", "fill", {}, {"Out": ["o"]},
         {"shape": [2, 2], "dtype": "float32", "data": [1.0, 2.5, -3.0, 0.0]},
         [], None, True),
        ("fill_zeros_like", "fill_zeros_like", {"X": [("x", t(3, 4))]},
         {"Out": ["o"]}, {}, [], None, True),
        ("fill_zeros_like_ragged", "fill_zeros_like",
         {"X": [("x", book_ragged([2, 0, 3], 4, SEED + 151))]},
         {"Out": ["o"]}, {}, [], None, True),
        ("clip", "clip", {"X": x}, {"Out": ["o"]},
         {"min": 0.0, "max": 6.0}, ["X"], og, False),
        ("clip_by_norm_scaled", "clip_by_norm", {"X": [("x", t(4, 6))]},
         {"Out": ["o"]}, {"max_norm": 1.0}, ["X"], {"Out": t(4, 6)}, False),
        ("clip_by_norm_kept", "clip_by_norm", {"X": [("x", t(4, 6))]},
         {"Out": ["o"]}, {"max_norm": 1e3}, ["X"], {"Out": t(4, 6)}, False),
        ("expand", "expand", {"X": [("x", t(2, 3))]}, {"Out": ["o"]},
         {"expand_times": [2, 3]}, ["X"], {"Out": t(4, 9)}, True),
        ("expand_fewer_times", "expand", {"X": [("x", t(2, 3))]},
         {"Out": ["o"]}, {"expand_times": [2]}, ["X"], {"Out": t(2, 6)},
         True),
        ("gather", "gather", {"X": [("x", t(6, 4))],
                              "Index": [("i", ids(-1, 2, 2, 7, -7, 0, 5, 2))]},
         {"Out": ["o"]}, {}, ["X"], {"Out": t(8, 4)}, False),
        ("scatter", "scatter",
         {"Ref": [("r", t(6, 3))], "Index": [("i", ids(1, 1, 2, -1, 9, 1))],
          "Updates": [("u", t(6, 3))]},
         {"Out": ["o"]}, {}, ["Ref", "Updates"], {"Out": t(6, 3)}, True),
        ("pad", "pad", {"X": [("x", t(2, 3))]}, {"Out": ["o"]},
         {"paddings": [1, 0, 2, 1], "pad_value": 0.5}, ["X"],
         {"Out": t(3, 6)}, True),
        ("crop", "crop", {"X": [("x", t(4, 5))]}, {"Out": ["o"]},
         {"offsets": [1, 2], "shape": [2, 3]}, ["X"], {"Out": t(2, 3)},
         True),
        ("multiplex", "multiplex",
         {"X": [("a", t(5, 3)), ("b", t(5, 3)), ("c", t(5, 3))],
          "Ids": [("i", ids([0], [2], [-1], [7], [-5]))]},
         {"Out": ["o"]}, {}, ["X"], {"Out": t(5, 3)}, True),
        ("is_empty", "is_empty", {"X": [("x", t(2, 3))]}, {"Out": ["o"]},
         {}, [], None, True),
        ("is_empty_empty", "is_empty", {"X": [("x", t(0, 3))]},
         {"Out": ["o"]}, {}, [], None, True),
        ("shape", "shape", {"Input": [("x", t(2, 3, 4))]}, {"Out": ["o"]},
         {}, [], None, True),
        ("prelu_scalar", "prelu", {"X": [("x", ties)],
                                   "Alpha": [("a", torch.tensor([0.25]))]},
         {"Out": ["o"]}, {}, ["X", "Alpha"], og, False),
        ("prelu_columns", "prelu", {"X": [("x", ties)],
                                    "Alpha": [("a", t(8))]},
         {"Out": ["o"]}, {}, ["X", "Alpha"], og, False),
        ("one_hot", "one_hot", {"X": [("x", ids([0], [3], [-1], [9], [2]))]},
         {"Out": ["o"]}, {"depth": 5}, [], None, True),
        ("one_hot_ragged", "one_hot",
         {"X": [("x", book_ragged([2, 0, 3], 1, SEED + 152, hi=6))]},
         {"Out": ["o"]}, {"depth": 5}, [], None, True),
        ("norm_axis1", "norm", {"X": [("x", t(3, 4, 5))]}, {"Out": ["o"]},
         {"axis": 1, "epsilon": 1e-10}, ["X"], {"Out": t(3, 4, 5)}, False),
        ("norm_last", "norm", {"X": [("x", t(3, 4, 5))]}, {"Out": ["o"]},
         {}, ["X"], {"Out": t(3, 4, 5)}, False),
        ("softmax_with_cross_entropy_soft", "softmax_with_cross_entropy",
         {"Logits": [("z", t(6, 10, scale=3.0))],
          "Label": [("l", torch.softmax(t(6, 10), -1))]},
         {"Softmax": ["p"], "Loss": ["o"]}, {"soft_label": True},
         ["Logits"], {"Loss": t(6, 1)}, False),
        ("cross_entropy_soft", "cross_entropy",
         {"X": [("x", torch.softmax(t(6, 10), -1))],
          "Label": [("l", torch.softmax(t(6, 10), -1))]},
         {"Y": ["o"]}, {"soft_label": True}, ["X"], {"Y": t(6, 1)}, False),
        ("smooth_l1_loss", "smooth_l1_loss",
         {"X": [("x", torch.cat([torch.tensor([[0.25, -0.25, 0.0, 1.0]]),
                                 t(4, 4)]))],
          "Y": [("y", torch.cat([torch.zeros(1, 4), t(4, 4)]))]},
         {"Diff": ["d"], "Out": ["o"]}, {"sigma": 2.0}, ["X", "Y"],
         {"Out": t(5, 1)}, False),
        ("smooth_l1_loss_weighted", "smooth_l1_loss",
         {"X": [("x", t(5, 4))], "Y": [("y", t(5, 4))],
          "InsideWeight": [("iw", t(5, 4).abs())],
          "OutsideWeight": [("ow", t(5, 4).abs())]},
         {"Diff": ["d"], "Out": ["o"]}, {}, ["X", "Y"], {"Out": t(5, 1)},
         False),
    ]
    return cases


def stack_feeds(batch, seq, vocab, steps, seed=SEED):
    """`steps` feeds of tokens, positions and targets from the seed."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        tokens = rs.randint(0, vocab, (batch, seq)).astype(np.int64)
        out.append({"tokens": tokens,
                    "positions": np.tile(np.arange(seq, dtype=np.int64),
                                         (batch, 1)),
                    "targets": np.concatenate(
                        [tokens[:, 1:], rs.randint(0, vocab, (batch, 1))],
                        1).reshape(batch, seq, 1).astype(np.int64)})
    return out


# the recipes held fused against unfused: (attrs, shared scalars, the
# per-parameter state slots)
STACK_FUSED = {
    "sgd": ({}, {}, ()),
    "momentum": ({"mu": 0.9, "use_nesterov": False}, {}, ("Velocity",)),
    "adam": ({"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
             {"Beta1Pow": 0.9, "Beta2Pow": 0.999}, ("Moment1", "Moment2")),
}
# card against CPU, each op of stack_op_cases and its grad: the largest
# error over the larger of 1 and the reference's magnitude (f32; CUDA's
# and the CPU's libm and sum orders differ by a few ulps)
STACK_OP_RTOL = 1e-5
# 15b: nets.scaled_dot_product_attention at the transformer's attention
# shape, its dense route (two f32 matmuls and a softmax, TF32 off)
# against its use_flash route (the kernel's f32 route, split TF32): the
# largest absolute difference of the outputs (values of about 1); and the
# dense route on the card against the CPU plain path, forward and grads,
# over the larger of 1 and the magnitude
STACK_ATTN_ATOL = 1e-4
STACK_ATTN_RTOL = 1e-5
# 15c: 2 Adam steps on the card against the CPU plain path from one
# state.  The loss within 1e-5 of its size and the learning rate exactly.
# The grads differ more than f32 sums in other orders would make them:
# the card's forward differs from the CPU's by about 1e-6, which flips
# relu's mask at the few pre-activations that lie that close to 0, and
# a flipped entry's whole grad flows on one side only.  An H100 read the
# grads equal to 1.1e-6 (relative L2) down to the last layer's relu_grad
# and 4.6e-4 after it, the flash kernel replaced by its plain version
# on the card too; the global norm 2.6e-5 of its size (8.4e-6 with the
# plain version).  Adam then moves each entry by about lr * sign(g), so
# the parameters differ more than the moments: phase 7's gates for the
# same model and optimizer (ADAM_MOMENT_RL2, ADAM_PARAM_RL2; read 2.6e-3
# m1, 1.2e-3 m2, 6.8e-3 parameters over 2 steps), the global norm at
# 2e-4; a wrong grad, clip or update reads order 1.  At 2 layers on the
# CPU, tests/test_torch_optim_stack.py holds the port against the JAX
# package at 1e-4 and 1e-5
STACK_STEPS = 2
STACK_LOSS_RTOL = 1e-5
STACK_NORM_RTOL = 2e-4


def stack_update_inputs(op, sparse, device, seed=SEED + 160):
    """The ins of one update recipe over a stack of 3 parameters of
    different shapes (the first grad a SelectedRows of a repeated row
    when `sparse`), on `device`, and the stacked slots."""
    import torch
    from paddle_tpu_torch.core.ragged import SelectedRows

    rs = np.random.RandomState(seed)
    shapes = [(4, 3), (5,), (2, 2, 2)]

    def t(shape, pos=False):
        a = rs.randn(*shape).astype(np.float32)
        return torch.from_numpy(np.abs(a) if pos else a).to(device)

    _, shared, slots = STACK_FUSED[op]
    ins = {"Param": [t(s) for s in shapes],
           "Grad": [t(s) for s in shapes],
           "LearningRate": [torch.full((1,), 0.05, device=device)]}
    if sparse:
        ins["Grad"][0] = SelectedRows(
            torch.tensor([3, 0, 3], dtype=torch.int32, device=device),
            t((3, 3)), 4)
    for slot in slots:
        ins[slot] = [t(s, pos=slot == "Moment2") for s in shapes]
    for slot, v in shared.items():
        ins[slot] = [torch.full((1,), v, device=device)]
    return ins, sorted(["Grad", "Param"] + list(slots))


def stack_fused_differ(op, sparse, device):
    """The outputs of `fused_update` over stack_update_inputs that differ
    bit for bit from the unfused op's, run per parameter on `device`;
    and the count compared."""
    from paddle_tpu_torch.fluid import executor as ex
    from paddle_tpu_torch.ops.registry import get_op_info

    ins, stacked = stack_update_inputs(op, sparse, device)
    attrs = STACK_FUSED[op][0]
    ctx = ex.ExecContext(None, 0, {}, device=device)
    fused = get_op_info("fused_update").kernel(
        ctx, ins, dict(attrs, inner_type=op, stacked_slots=stacked))
    differ, n = [], 0
    for i in range(len(ins["Param"])):
        one = {k: [v[i]] if k in stacked else v for k, v in ins.items()}
        for slot, vals in get_op_info(op).kernel(ctx, one, attrs).items():
            n += 1
            if not same_bits(fused[slot][i], vals[0]):
                differ.append("%s[%d]" % (slot, i))
    return differ, n


def stack_compare(tag, got, ref):
    """`book_compare` of the outputs with NaN where the reference has NaN
    (gather's rows of out-of-range ids) and nowhere else: those places
    must agree, and the rest is compared."""
    from paddle_tpu_torch.core.ragged import RaggedTensor

    def finite(v):
        vals = v.values if isinstance(v, RaggedTensor) else v
        vals = vals.nan_to_num(nan=0.0) if vals.is_floating_point() \
            else vals
        return v.with_values(vals) if isinstance(v, RaggedTensor) else vals

    for n, r in ref.items():
        (gv, _), (rv, _) = book_host(got[n]), book_host(r)
        if gv.dtype.kind == "f" and gv.shape == rv.shape \
                and not np.array_equal(np.isnan(gv), np.isnan(rv)):
            raise SystemExit("chip_smoke: %s: %s has NaN at other places on "
                             "the card than on the CPU" % (tag, n))
    return book_compare(tag, {n: finite(v) for n, v in got.items()},
                        {n: finite(v) for n, v in ref.items()})


def stack_ops(device):
    """15a: each case of stack_op_cases on the card against its CPU run,
    forward (exact where the op only moves or makes values) and grad
    (STACK_OP_RTOL); gather's grad run twice on the card, bit for bit;
    fused_update against the unfused ops on the card, bit for bit."""
    import torch

    cpu = torch.device("cpu")
    worst = {}
    for name, op, ins, outs, attrs, diff, out_grads, exact in \
            stack_op_cases():
        ref = book_run_op(op, ins, outs, attrs, cpu)
        got = book_run_op(op, ins, outs, attrs, device)
        if exact:
            for n, r in ref.items():
                (gv, glod), (rv, rlod) = book_host(got[n]), book_host(r)
                if glod != rlod or gv.dtype != rv.dtype \
                        or not np.array_equal(gv, rv, equal_nan=gv.dtype.kind
                                              == "f"):
                    raise SystemExit("chip_smoke: op case %s: %s on the "
                                     "card is not the CPU's" % (name, n))
            err = 0.0
        else:
            err = stack_compare(name, got, ref)
        if diff:
            gins = book_grad_ins(ins, outs, out_grads, ref)
            gouts = {s + "@GRAD": ["%s@GRAD" % n for n, _ in ins[s]]
                     for s in diff}
            gref = book_run_op(op + "_grad", gins, gouts, attrs, cpu)
            ggot = book_run_op(op + "_grad", gins, gouts, attrs, device)
            err = max(err, stack_compare(name + "_grad", ggot, gref))
            if op == "gather":
                again = book_run_op(op + "_grad", gins, gouts, attrs,
                                    device)
                if not all(same_bits(ggot[n], again[n]) for n in ggot):
                    raise SystemExit("chip_smoke: gather's grad differs "
                                     "when run twice on the card")
        worst[name] = err
        if not err <= STACK_OP_RTOL:
            raise SystemExit("chip_smoke: op case %s on the card disagrees "
                             "with the CPU (%.3g, gate %g)"
                             % (name, err, STACK_OP_RTOL))
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:6]
    print("stack: 15a %d op cases of %d op types on the card against the "
          "CPU plain path, forward and %d grads: the exact ones bit for bit "
          "(NaN rows of out-of-range gather ids, scatter's last update "
          "winning, one_hot's zero rows), the rest within %g of the larger "
          "of 1 and the magnitude, worst %s; gather's grad (ids -1, 2, 2, "
          "7, -7, 0, 5, 2) twice on the card: the same bits"
          % (len(worst), len({c[1] for c in stack_op_cases()}),
             sum(1 for c in stack_op_cases() if c[5]), STACK_OP_RTOL,
             ", ".join("%s %.3g" % kv for kv in top)), flush=True)
    for op in sorted(STACK_FUSED):
        for sparse in (False, True):
            differ, n = stack_fused_differ(op, sparse, device)
            print("stack: fused_update[%s]%s on the card against the "
                  "unfused op per parameter: %d of %d outputs differ bit "
                  "for bit" % (op, " with a SelectedRows grad" if sparse
                               else "", len(differ), n), flush=True)
            if differ:
                raise SystemExit("chip_smoke: fused_update[%s] differs from "
                                 "the unfused op in %s" % (op, differ))


def stack_attention(exe, smi):
    """15b: nets.scaled_dot_product_attention at the transformer's
    attention shape (queries, keys and values [BATCH, SEQ, D_MODEL],
    N_HEAD heads): the dense route against use_flash on the card, and
    the dense route's forward and grads (calc_gradient, a random output
    grad) on the card against the CPU.  Returns the launch counts of the
    flash route's run."""
    import torch
    import paddle_tpu_torch.fluid as fluid

    def build(use_flash):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            q, k, v, og = (fluid.layers.data(
                name=n, shape=[BATCH, SEQ, D_MODEL], dtype="float32",
                append_batch_size=False) for n in ("q", "k", "v", "og"))
            out = fluid.nets.scaled_dot_product_attention(
                q, k, v, num_heads=N_HEAD, use_flash=use_flash)
            grads = [] if use_flash else fluid.calc_gradient(
                out, [q, k, v], target_gradients=[og])
        return main, [out] + grads

    rs = np.random.RandomState(SEED + 170)
    feed = {n: rs.randn(BATCH, SEQ, D_MODEL).astype(np.float32)
            for n in ("q", "k", "v", "og")}
    dev = {n: torch.from_numpy(a).to(exe.device) for n, a in feed.items()}
    flash_main, flash_fetch = build(True)
    dense_main, dense_fetch = build(False)
    types = collections.Counter(op.type for op in dense_main.desc.block(0)
                                .ops)
    scope = fluid.Scope()
    reset_launches()
    flash = exe.run(flash_main, feed=dev, fetch_list=flash_fetch,
                    scope=scope, return_numpy=False)[0]
    torch.cuda.synchronize()
    launches = read_launches()
    dense = exe.run(dense_main, feed=dev, fetch_list=dense_fetch,
                    scope=scope, return_numpy=False)
    routes = float((dense[0] - flash).abs().max())
    f32 = launches[route_entry("f32")]
    cpu = fluid.Executor(fluid.CPUPlace()).run(
        dense_main, feed=feed, fetch_list=dense_fetch, scope=fluid.Scope())
    errs = [float(np.abs(d.cpu().numpy() - c).max()) / max(
        1.0, float(np.abs(c).max())) for d, c in zip(dense, cpu)]
    flash_ms = cuda_ms(lambda: exe.run(flash_main, feed=dev,
                                       fetch_list=flash_fetch, scope=scope,
                                       return_numpy=False))
    dense_ms = cuda_ms(lambda: exe.run(dense_main, feed=dev,
                                       fetch_list=dense_fetch[:1],
                                       scope=scope, return_numpy=False))
    print("stack: 15b nets.scaled_dot_product_attention [%d, %d, %d], %d "
          "heads: the dense route (%s) against use_flash (one "
          "flash_attention op; f32 route launches %d): max abs difference "
          "%.3g (gate %g); the dense route on the card against the CPU "
          "plain path: forward %.3g, dq %.3g, dk %.3g, dv %.3g of the "
          "magnitude (gate %g); forward ms (CUDA events, eager): dense "
          "%.4f, flash %.4f [%s]"
          % (BATCH, SEQ, D_MODEL, N_HEAD, ", ".join(
              "%s %d" % kv for kv in sorted(types.items())), f32, routes,
             STACK_ATTN_ATOL, errs[0], errs[1], errs[2], errs[3],
             STACK_ATTN_RTOL, dense_ms, flash_ms, smi), flush=True)
    if f32 < 1 or not routes <= STACK_ATTN_ATOL \
            or not max(errs) <= STACK_ATTN_RTOL:
        raise SystemExit("chip_smoke: scaled_dot_product_attention's routes "
                         "or the card and the CPU disagree")
    return launches


def stack_run(exe, main, fetch, state, feeds):
    """([[loss, lr, global norm] per step], the state after, seconds):
    the steps of `feeds` through `main` from `state` in a fresh scope on
    the executor's device."""
    from paddle_tpu_torch.fluid import Scope, io

    scope = Scope()
    io.params_from_numpy(scope, state, exe.device)
    t0 = time.perf_counter()
    out = [[float(v.reshape(-1)[0]) for v in exe.run(
        main, feed=f, fetch_list=fetch, scope=scope)] for f in feeds]
    return out, {n: scope.get(n).cpu().numpy() for n in state}, \
        time.perf_counter() - t0


def stack_check(exe, main, fetch, init, feeds, groups, tag,
                clip_norm=STACK_CLIP):
    """The steps of `feeds` on the card (launches counted from 0 just
    before) against the CPU plain path from `init`, gated; returns (the
    card's [[loss, lr, norm]], the launches)."""
    import paddle_tpu_torch.fluid as fluid

    cpu, cpu_state, csecs = stack_run(fluid.Executor(fluid.CPUPlace()),
                                      main, fetch, init, feeds)
    reset_launches()
    card, card_state, gsecs = stack_run(exe, main, fetch, init, feeds)
    launches = read_launches()
    loss_err = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(card, cpu))
    norm_err = max(abs(a[2] - b[2]) / abs(b[2]) for a, b in zip(card, cpu))
    lr_same = all(a[1] == b[1] for a, b in zip(card, cpu))
    errs = {g: change_rl2(card_state, cpu_state, init, names)
            for g, names in groups.items()}
    gates = {g: ADAM_PARAM_RL2 if g == "parameters" else ADAM_MOMENT_RL2
             for g in groups}
    print("stack: %s: %d Adam steps from one state: CPU plain path (%.1f "
          "s) loss, lr, global norm %s; card (%.1f s) %s; loss error %.3g "
          "of its size (gate %g), global norm %.3g (gate %g), learning "
          "rates %s; the steps' change, relative L2 error: %s; the clip "
          "bound in %d of %d steps (norm above the clip_norm)"
          % (tag, len(feeds), csecs, json.dumps(cpu), gsecs,
             json.dumps(card), loss_err, STACK_LOSS_RTOL, norm_err,
             STACK_NORM_RTOL, "equal" if lr_same else "DIFFER",
             ", ".join("%s %.3g (gate %g)" % (g, e, gates[g])
                       for g, e in errs.items()),
             sum(1 for c in card if c[2] > clip_norm), len(card)),
          flush=True)
    if not (loss_err <= STACK_LOSS_RTOL and norm_err <= STACK_NORM_RTOL
            and lr_same and all(errs[g] <= gates[g] for g in errs)) \
            or not all(np.isfinite(v).all() for v in card_state.values()):
        raise SystemExit("chip_smoke: %s: the steps on the card disagree "
                         "with the CPU plain path" % tag)
    return card, launches


def stack_train(exe, smi):
    """15c: the transformer at bench.py's width trained with label
    smoothing, the global-norm clip, the piecewise schedule and fused
    Adam updates.  Returns the launch counts of its checked steps."""
    import torch
    import paddle_tpu_torch.fluid as fluid

    t0 = time.perf_counter()
    main, startup, loss, lr, gnorm = build_stack(fluid)
    umain, _, uloss, _, _ = build_stack(fluid, fuse=False)
    block = main.desc.block(0)
    counts = collections.Counter(op.type for op in block.ops)
    ucounts = collections.Counter(op.type for op in umain.desc.block(0).ops)
    pnames = [p.name for p in main.global_block().all_parameters()]
    n_values = sum(int(np.prod(block.vars[n].shape)) for n in pnames)
    fused = [op for op in block.ops if op.type == "fused_update"]
    print("stack: 15c the transformer (batch %d, seq %d, d_model %d, %d "
          "layers, %d heads, vocab %d), label smoothing %g, "
          "GradientClipByGlobalNorm(%g) on its %d parameters (%d values), "
          "piecewise_decay(%s, %s), Adam with fused updates (cap 2^18): "
          "main %d ops of %d types (%s); %d fused_update op(s) stacking %s "
          "parameters and %d adam ops (%d adam ops unfused, %d ops); built "
          "in %.1f s"
          % (BATCH, SEQ, D_MODEL, N_LAYER, N_HEAD, VOCAB, STACK_EPS,
             STACK_CLIP, len(pnames), n_values, STACK_BOUNDS, STACK_LRS,
             len(block.ops), len(counts), ", ".join(
                 "%s %d" % kv for kv in sorted(counts.items())), len(fused),
             "+".join(str(len(op.input("Param"))) for op in fused),
             counts["adam"], ucounts["adam"], len(umain.desc.block(0).ops),
             time.perf_counter() - t0), flush=True)
    if counts["flash_attention"] != N_LAYER or not fused \
            or counts["adam"] + sum(len(op.input("Param")) for op in fused) \
            != len(pnames) or ucounts["adam"] != len(pnames) \
            or counts["squared_l2_norm"] != len(pnames):
        raise SystemExit("chip_smoke: the stack program is not the one held "
                         "against the JAX package")
    init = book_state(exe, startup, main)
    persist = list(init)
    groups = {"parameters": pnames,
              "moment1": [n for n in persist if n.endswith("_moment1_0")],
              "moment2": [n for n in persist if n.endswith("_moment2_0")]}
    feeds = stack_feeds(BATCH, SEQ, VOCAB, STACK_STEPS)
    card, launches = stack_check(exe, main, [loss, lr, gnorm], init, feeds,
                                 groups, "15c")
    per_step = 2 * N_LAYER
    flash = launches[route_entry("f32")]
    print("stack: 15c flash launches in the %d checked steps, counted from "
          "0 just before: %d (%d per step: the forward op and the generic "
          "grad's recompute per layer); all launches %s"
          % (STACK_STEPS, flash, per_step, json.dumps(launches)), flush=True)
    if flash != per_step * STACK_STEPS:
        raise SystemExit("chip_smoke: %d flash launches in %d steps, "
                         "designed %d per step" % (flash, STACK_STEPS,
                                                   per_step))
    if card[0][2] <= STACK_CLIP:
        # the clip did not bind: hold the scaling path at full width too
        half, hstart, hloss, hlr, hnorm = build_stack(
            fluid, clip_norm=card[0][2] / 2)
        stack_check(exe, half, [hloss, hlr, hnorm], init, feeds[:1],
                    groups, "15c at clip_norm %.6g (half the first norm)"
                    % (card[0][2] / 2), clip_norm=card[0][2] / 2)

    # fused against unfused: one step from one state, every tensor
    dev_feed = {n: torch.from_numpy(a.astype(np.int32)).to(exe.device)
                for n, a in feeds[0].items()}
    state = {n: torch.from_numpy(v).to(exe.device) for n, v in init.items()}
    after = []
    for prog, lss in ((main, loss), (umain, uloss)):
        scope = fluid.Scope()
        for n, v in state.items():
            scope.set(n, v.clone())
        out = exe.run(prog, feed=dev_feed, fetch_list=[lss], scope=scope,
                      return_numpy=False)[0]
        after.append((out, {n: scope.get(n) for n in state}))
    differ = [n for n in state if not same_bits(after[0][1][n],
                                                after[1][1][n])]
    if not same_bits(after[0][0], after[1][0]):
        differ.append("the loss")
    print("stack: 15c one step fused and one unfused from one state: %d of "
          "%d parameters, moments, schedule and Adam scalars differ bit for "
          "bit%s" % (len(differ), len(state), (" (%s)" % ", ".join(differ))
                     if differ else ""), flush=True)
    if differ:
        raise SystemExit("chip_smoke: fused and unfused steps differ in %s"
                         % differ)
    del after
    repeat_gate("stack: 15c", exe, main, dev_feed, state)

    scope = params_scope(init, exe.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        exe.run(main, feed=dev_feed, fetch_list=[loss], scope=scope,
                return_numpy=False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    report = {}
    for tag, prog, lss in (("fused", main, loss), ("unfused", umain, uloss)):
        def step(prog=prog, lss=lss):
            return exe.run(prog, feed=dev_feed, fetch_list=[lss],
                           scope=scope, return_numpy=False)

        times = timed_steps(step)
        med = float(np.median(times))
        prof = profile_step(step, set(counts) | set(ucounts), per_step,
                            med, what="one %s 15c step" % tag)
        report[tag] = (med, prof)
        print("stack: 15c %s: step %.3f ms (median of 10 after 2 warm, "
              "feeds on the card; mean %.3f, min %.3f, max %.3f), %.0f "
              "tokens/s; %s launches a step, device busy %s ms [%s]"
              % (tag, med, np.mean(times), min(times), max(times),
                 BATCH * SEQ / med * 1e3,
                 prof["launches"] if prof else "not measured",
                 "%.3f" % prof["busy_ms"] if prof else "not measured", smi),
              flush=True)
    print("stack: 15c peak memory of 3 steps %.3f GB; fused against "
          "unfused: %s against %s launches a step, %.3f against %.3f ms"
          % (peak / 1e9, *(report[k][1]["launches"] if report[k][1]
                           else "not measured" for k in ("fused",
                                                         "unfused")),
             report["fused"][0], report["unfused"][0]), flush=True)
    del scope, state
    torch.cuda.empty_cache()
    return launches


def phase_stack():
    """The optimizer and layer stack (phase 15): the new op types on the
    card (15a), nets.scaled_dot_product_attention's two routes (15b) and
    the transformer trained as its users train it (15c).  Returns the
    launch counts of 15b's flash route and 15c's checked steps."""
    import paddle_tpu_torch.fluid as fluid

    t0 = time.perf_counter()
    exe = fluid.Executor()
    if exe.device.type != "cuda":
        raise SystemExit("chip_smoke: the executor is not on the card")
    smi = nvidia_smi_line()
    stack_ops(exe.device)
    attn = stack_attention(exe, smi)
    train = stack_train(exe, smi)
    print("stack: phase 15 in %.1f s" % (time.perf_counter() - t0),
          flush=True)
    return {n: attn.get(n, 0) + train.get(n, 0)
            for n in set(attn) | set(train)}


# phase 16, obs: numerics health, the flight recorder, the profiler,
# request tracing and the NHWC relayout.  16a: the finiteness ops on
# 2^20 + 7 values with OBS_PLANTED NaNs, +Infs and -Infs each, f32, bf16
# and f16, card against CPU exactly (they count; nothing rounds)
OBS_VALUES = (1 << 20) + 7
OBS_PLANTED = 64
# the served forward under FLAGS_check_nan_inf: one Inf in layer 1's
# q/k/v weight, so the scan must pass layer 0 and stop at that product
OBS_INF_WEIGHT, OBS_INF_AT = "fc_4.w_0", (0, 0)
OBS_SCAN_ROWS = 2
# 16b: the transformer at bench.py's width under bf16 AMP with Adam and
# the numerics monitor, OBS_STEPS steps; its first step again on the CPU
# plain path from the same state.  Both run bf16 products and keep bf16
# activations between ops, rounding at the same points; their f32 sums
# run in other orders, so an activation near a bf16 rounding boundary
# rounds the other way (2^-9 of it) on one side, through 6 layers.  The
# cost's max-abs (the loss itself, about ln 8192 = 9.0) within
# OBS_AMP_LOSS_ATOL, 1e-4 of it: test_torch_training's AMP parity read
# 4.3e-4 at 2 layers against the JAX package, whose products round
# elsewhere; a wrong policy or route reads order 1e-2 (phase 5's wide
# AMP against f32) and up.  The grad global norm within OBS_NORM_RTOL of
# its size: phase 15c's 2e-4 holds f32 steps, but a bf16 step moves its
# norm by more when only its inputs' last bits move: on an H100 the card
# against itself from the state with every f32 value moved by one ulp
# read 6.5e-4, the card against the CPU 4.4e-4; the gate is 3 times the
# first, and a grad lost or doubled moves the norm by percents
OBS_STEPS = 3
OBS_AMP_LOSS_ATOL = 1e-3
OBS_NORM_RTOL = 2e-3
# 16d: the v2 NMT of phase 14 through step_runner at a smaller batch
OBS_NMT_BATCH = 16
# 16e: requests of one row each from 4 client threads, to phase 3's
# transformer exported with its logits' top 2 per position as the fetch:
# a [1, 512, 8192] logits reply is 86 MB of JSON (5.3 s to write and 2.9
# s to read on one CPU core), so 64 of them would be minutes of JSON
OBS_REQUESTS, OBS_CLIENTS, OBS_TOPK = 64, 4, 2
OBS_QUEUE = 8
OBS_SLO_MS = 500.0
# 16f: ResNet-50 at bench.py's training shape under bf16 AMP, NHWC
# (fluid.convert_layout before minimize) against NCHW from one state, 2
# Momentum steps.  The same bf16 products and activations in another
# memory order: cuDNN picks other algorithms per layout, whose f32 sums
# round differently before the bf16 rounding, through 50 layers and the
# batch norms' statistics.  The first loss (about ln 1000 = 6.9) within
# NHWC_LOSS_ATOL, a third of phase 6's AMP-against-f32 gate (an H100
# read 2.7e-4).  The first step's update under AMP is not a usable
# gate: from a state with every f32 value moved by one ulp the NCHW
# step's change moved by 1.12 in relative L2 on an H100 (the bf16 batch
# norms' grads at initialisation), so it is printed; the update is held
# in f32 instead (TF32 off, one step from the same state): the loss at
# phase 6's RN_LOSS_ATOL and the change within NHWC_F32_CHANGE_RL2,
# phase 6's card-against-CPU gate (an H100 read 4.3e-6 and 2.7e-2).  A
# layout misread (an NHWC image taken as NCHW) reads order 1 in both
NHWC_STEPS = 2
NHWC_LOSS_ATOL = 0.05
NHWC_F32_CHANGE_RL2 = 0.1


def obs_ops(device):
    """16a: isfinite and count_nonfinite on the card against the CPU."""
    import torch
    from paddle_tpu_torch.ops.registry import get_op_info

    rs = np.random.RandomState(SEED + 160)
    checked = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        x = rs.randn(OBS_VALUES).astype(np.float32)
        idx = rs.choice(x.size, 3 * OBS_PLANTED, replace=False)
        x[idx[:OBS_PLANTED]] = np.nan
        x[idx[OBS_PLANTED:2 * OBS_PLANTED]] = np.inf
        x[idx[2 * OBS_PLANTED:]] = -np.inf
        for planted in (True, False):
            vals = x if planted else np.nan_to_num(x, nan=0.0, posinf=1.0,
                                                  neginf=-1.0)
            t = torch.from_numpy(vals).to(dtype)
            for op, want in (("isfinite", not planted),
                             ("count_nonfinite",
                              3 * OBS_PLANTED if planted else 0)):
                kernel = get_op_info(op).kernel
                got = kernel(None, {"X": [t.to(device)]}, {})["Out"][0]
                ref = kernel(None, {"X": [t]}, {})["Out"][0]
                got = got.cpu()
                if got.dtype != ref.dtype or not torch.equal(got, ref) \
                        or got.shape != (1,) or got.item() != want:
                    raise SystemExit(
                        "chip_smoke: %s of %s on the card %s, the CPU %s, "
                        "planted %s" % (op, dtype, got.tolist(),
                                        ref.tolist(), want))
                checked.append(got.item())
    print("obs: 16a isfinite and count_nonfinite on %d values with %d "
          "NaN, +Inf and -Inf planted, f32, bf16 and f16: %d cases equal "
          "to the CPU plain path exactly (%s)"
          % (OBS_VALUES, OBS_PLANTED, len(checked),
             ", ".join(str(c) for c in checked)), flush=True)


def obs_scan(exe, smi):
    """16a: the served transformer's forward with one Inf planted in a
    weight, under FLAGS_check_nan_inf, on the card and the CPU: the same
    NonfiniteError."""
    from paddle_tpu_torch.fluid import CPUPlace, Executor
    from paddle_tpu_torch.fluid.executor import NonfiniteError
    from paddle_tpu_torch.models import transformer_program as tp
    from paddle_tpu_torch.utils import flags

    prog = tp.build_transformer_inference_program(
        BATCH, SEQ, VOCAB, n_layer=N_LAYER, n_head=N_HEAD, d_model=D_MODEL)
    params = tp.init_transformer_params(prog, seed=SEED)
    params[OBS_INF_WEIGHT][OBS_INF_AT] = np.inf
    feed = {n: v[:OBS_SCAN_ROWS] for n, v in tp.transformer_feeds(
        BATCH, SEQ, VOCAB, seed=SEED + 161).items()}
    fetch = [tp.logits_name(N_LAYER)]
    errors = []
    flags.set_flag("check_nan_inf", True)
    try:
        for executor, device in ((exe, exe.device), (Executor(CPUPlace()),
                                                     "cpu")):
            t0 = time.perf_counter()
            try:
                executor.run(prog, feed=feed, fetch_list=fetch,
                             scope=params_scope(params, device))
            except NonfiniteError as err:
                errors.append((err, time.perf_counter() - t0))
            else:
                raise SystemExit("chip_smoke: the planted Inf passed the "
                                 "check_nan_inf scan on %s" % device)
    finally:
        flags.set_flag("check_nan_inf", False)
    fields = [tuple(getattr(e, f) for f in (
        "op_type", "op_index", "slot", "var_name", "nonfinite_count"))
        for e, _ in errors]
    print("obs: 16a the served forward (%d rows) with an Inf in %s under "
          "FLAGS_check_nan_inf: card %s in %.2f s, CPU %s in %.2f s [%s]"
          % (OBS_SCAN_ROWS, OBS_INF_WEIGHT, fields[0], errors[0][1],
             fields[1], errors[1][1], smi), flush=True)
    if fields[0] != fields[1] or fields[0][0] != "mul":
        raise SystemExit("chip_smoke: the card's NonfiniteError differs "
                         "from the CPU's")


def scope_bits(scope):
    """{name: a copy of each value's tensors, or the random stream's
    state} of a scope, to hold it bit for bit."""
    import torch
    import torch.utils._pytree as pytree

    out = {}
    for name, value in scope._vars.items():
        if isinstance(value, torch.Generator):
            out[name] = [value.get_state()]
        else:
            out[name] = [t.clone() for t in pytree.tree_leaves(value)
                         if isinstance(t, torch.Tensor)]
    return out


def bits_differ(before, scope):
    """Names whose tensors in `scope` differ in any bit from `before`."""
    import torch

    def raw(t):
        return t.view(torch.uint8) if t.is_floating_point() else t

    now = scope_bits(scope)
    return [n for n in set(before) | set(now)
            if n not in before or n not in now
            or len(before[n]) != len(now[n])
            or not all(a.dtype == b.dtype and a.shape == b.shape
                       and torch.equal(raw(a), raw(b))
                       for a, b in zip(before[n], now[n]))]


def obs_amp(exe, smi):
    """16b and 16c: the transformer at full width under bf16 AMP with
    Adam, the numerics monitor and a loss scaler, inside the flight
    recorder; then the costs of each surface, the planted Inf and a
    crash.  Returns the launch counts of the monitored steps."""
    import copy
    import io as io_mod

    import torch
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.desc import ProgramDesc
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.fluid.amp import LossScaler
    from paddle_tpu_torch.models import transformer_program as tp
    from paddle_tpu_torch.obs import flight, health, registry, trace
    from paddle_tpu_torch.utils import flags

    t0 = time.perf_counter()
    main_d, startup_d, loss, _ = tp.build_transformer_program(
        BATCH, SEQ, VOCAB, n_layer=N_LAYER, n_head=N_HEAD, d_model=D_MODEL)
    _, pairs = fluid.Adam(ADAM_LR).minimize(loss, main_d, startup_d)
    plain = ProgramDesc.from_dict(main_d.to_dict())  # without the monitor
    main = fluid.Program.from_desc(main_d)
    scaler = LossScaler()
    with fluid.program_guard(main):
        mon = health.NumericsMonitor.for_train_program(
            main, cost=loss, params_grads=pairs, loss_scaler=scaler) \
            .install()
    fetch = [loss] + mon.fetch_names
    block = main_d.block(0)
    persist = [n for n, v in block.vars.items() if v.persistable]
    scope = fluid.Scope()
    exe.run(startup_d, scope=scope)
    init = {n: scope.get(n).cpu().numpy() for n in persist}
    feeds = [tp.transformer_feeds(BATCH, SEQ, VOCAB, seed=SEED + 162 + i,
                                  targets=True) for i in range(OBS_STEPS)]
    print("obs: 16b the transformer (%d layers, d_model %d, %d heads, "
          "vocab %d, batch %d x %d) with Adam (lr %g) and the monitor: %d "
          "ops, %d of them the monitor's, %d fetched scalars; built in "
          "%.1f s" % (N_LAYER, D_MODEL, N_HEAD, VOCAB, BATCH, SEQ, ADAM_LR,
                      len(block.ops), len(block.ops) - len(plain.block(0)
                                                            .ops),
                      len(mon.fetch_names), time.perf_counter() - t0),
          flush=True)

    # 16c around the monitored steps: the flight recorder, and the obs
    # trace on for its span tail
    flight_dir = tempfile.mkdtemp(prefix="flight_")
    rec = flight.install(out_dir=flight_dir, min_dump_interval_s=0.0)
    trace.enable()
    summaries, scales, record_us = [], [], []
    try:
        with fluid.amp.bf16_guard():
            reset_launches()
            for i, f in enumerate(feeds):
                outs = exe.run(main, feed=f, fetch_list=fetch, scope=scope)
                summaries.append(mon.record(outs[1:]))
                scales.append(scaler.scale)
                t1 = time.perf_counter()
                flight.record_step("transformer", i, feeds=f,
                                   loss=float(outs[0][0]))
                record_us.append((time.perf_counter() - t1) * 1e6)
            # the main path ends here: read the counts
            launches = read_launches()
            bad = dict(feeds[0], tokens=feeds[0]["tokens"][:, :SEQ // 2])
            try:
                exe.run(main, feed=bad, fetch_list=[loss], scope=scope)
            except Exception as exc:  # noqa: BLE001 — the forced crash
                crash = exc
            else:
                raise SystemExit("chip_smoke: a feed of the wrong shape "
                                 "ran")
    finally:
        trace.disable()
        trace.reset()
        flight.uninstall()
    with open(rec.last_bundle_path) as fh:
        bundle = json.load(fh)
    note = bundle["notes"][-1]
    bundle_ok = (
        [r["step"] for r in bundle["steps"]] == list(range(OBS_STEPS))
        and all(r["feeds"] == {n: "int64%s" % list(v.shape)
                               for n, v in feeds[0].items()}
                for r in bundle["steps"])
        and note["origin"] == "executor/run"
        and note["feeds"]["tokens"] == "int64[%d, %d]" % (BATCH, SEQ // 2)
        and bundle["exception"]["type"] == type(crash).__name__
        and bundle["recent_spans"]
        and os.path.getsize(rec.last_bundle_path) < 1 << 20)
    print("obs: 16c the flight bundle (%d bytes): %d step records, feeds "
          "%s, the crash %s (%s) noted from %s, %d spans in its tail; "
          "record_step %.1f us a step (mean of %d; %s)"
          % (os.path.getsize(rec.last_bundle_path), len(bundle["steps"]),
             bundle["steps"][0]["feeds"], bundle["exception"]["type"],
             str(crash)[:80], note["origin"], len(bundle["recent_spans"]),
             np.mean(record_us), len(record_us),
             ", ".join("%.1f" % u for u in record_us)), flush=True)
    if not bundle_ok:
        raise SystemExit("chip_smoke: the flight bundle lacks what it must "
                         "hold")

    # the first step again on the CPU plain path, from the same state
    cpu_scope = params_scope(init, "cpu")
    cpu_mon = copy.copy(mon)
    cpu_mon.loss_scaler = LossScaler()
    t0 = time.perf_counter()
    with fluid.amp.bf16_guard():
        cpu_outs = fluid.Executor(fluid.CPUPlace()).run(
            main, feed=feeds[0], fetch_list=fetch, scope=cpu_scope)
    cpu = cpu_mon.record(cpu_outs[1:])
    cpu_s = time.perf_counter() - t0
    del cpu_scope
    # the card against itself from the state with every f32 value moved
    # by about one ulp: how far the bf16 step's rounding alone moves the
    # norm
    nudge_mon = copy.copy(mon)
    nudge_mon.loss_scaler = None
    nudged = params_scope({n: v * np.float32(1 + 2 ** -23)
                           if v.dtype == np.float32 else v
                           for n, v in init.items()}, exe.device)
    with fluid.amp.bf16_guard():
        nudge = nudge_mon.record(exe.run(main, feed=feeds[0],
                                         fetch_list=fetch,
                                         scope=nudged)[1:])
    del nudged
    card = summaries[0]
    nudge_err = abs(card["grad_global_norm"] - nudge["grad_global_norm"]) \
        / card["grad_global_norm"]
    norm_err = abs(card["grad_global_norm"] - cpu["grad_global_norm"]) \
        / cpu["grad_global_norm"]
    cost_err = abs(card["max_abs"][loss] - cpu["max_abs"][loss])
    print("obs: 16b %d monitored AMP steps on the card: losses' max-abs "
          "%s, grad global norms %s, nonfinite %d, loss scale %s; the first "
          "on the CPU plain path (%.1f s): max-abs %.6f, norm %.6f, "
          "nonfinite %d, scale %g; card against CPU: cost %.3g (atol %g), "
          "norm %.3g of its size (gate %g); the card from the state moved "
          "by one ulp: norm %.3g of its size"
          % (OBS_STEPS, ", ".join("%.6f" % s["max_abs"][loss]
                                  for s in summaries),
             ", ".join("%.6f" % s["grad_global_norm"] for s in summaries),
             sum(sum(s["nonfinite"].values()) for s in summaries),
             scales, cpu_s, cpu["max_abs"][loss], cpu["grad_global_norm"],
             sum(cpu["nonfinite"].values()), cpu["loss_scale"], cost_err,
             OBS_AMP_LOSS_ATOL, norm_err, OBS_NORM_RTOL, nudge_err),
          flush=True)
    if any(s["found_nonfinite"] for s in summaries) \
            or cpu["nonfinite"] != card["nonfinite"] \
            or norm_err > OBS_NORM_RTOL or cost_err > OBS_AMP_LOSS_ATOL \
            or cpu["loss_scale"] != scales[0] \
            or scales != [2.0 ** 15] * OBS_STEPS:
        raise SystemExit("chip_smoke: the monitored AMP steps disagree "
                         "with the CPU plain path")

    # what each surface costs: the step with the monitor and without,
    # with FLAGS_check_nan_inf, with fluid.profiler's table
    dev_feed = {n: torch.from_numpy(v.astype(np.int32)).to(exe.device)
                for n, v in feeds[0].items()}

    def step(prog, names):
        return lambda: exe.run(prog, feed=dev_feed, fetch_list=names,
                               scope=scope)

    monitored, unmonitored = step(main, fetch), step(plain, [loss])
    times = collections.defaultdict(list)
    with fluid.amp.bf16_guard():
        for tag, fn in (("without", unmonitored), ("with", monitored),
                        ("with", monitored), ("without", unmonitored)):
            times[tag] += timed_steps(fn, runs=5, warm=1)
        table = io_mod.StringIO()
        with contextlib.redirect_stdout(table), profiler.profiler():
            times["profiler"] = timed_steps(unmonitored, runs=5, warm=1)
        records = profiler.get_profile_records()
        flags.set_flag("check_nan_inf", True)
        try:
            times["check_nan_inf"] = timed_steps(unmonitored, runs=3,
                                                 warm=1)
        finally:
            flags.set_flag("check_nan_inf", False)
        op_types = {op.type for op in main_d.block(0).ops}
        profiles = {tag: profile_step(fn, op_types, 2 * N_LAYER,
                                      float(np.median(times[tag])),
                                      what="one AMP step %s the monitor"
                                      % tag)
                    for tag, fn in (("without", unmonitored),
                                    ("with", monitored))}
    # the monitor's scalars' copies to the host alone, after a step
    with fluid.amp.bf16_guard():
        left = exe.run(main, feed=dev_feed, fetch_list=fetch, scope=scope,
                       return_numpy=False)[1:]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for v in left:
        fluid.executor.fetch_to_host(v)
    fetch_ms = (time.perf_counter() - t1) * 1e3
    med = {tag: float(np.median(t)) for tag, t in times.items()}
    ops = profiles["with"]["ops"] if profiles["with"] else {}
    print("obs: 16b the monitor's cost: its %d scalars' copies to the host "
          "%.3f ms after a step; host ms of its op types in a profiled "
          "step: %s" % (len(left), fetch_ms, ", ".join(
              "%s %.3f (%d ops)" % (t, ops[t][1], ops[t][2])
              for t in ("count_nonfinite", "squared_l2_norm", "abs",
                        "reduce_max") if t in ops)), flush=True)
    print("obs: 16b AMP step (median, feeds on the card, fetches to the "
          "host): without the monitor %.3f ms, with it %.3f ms (%+.3f ms, "
          "%d scalars fetched); with fluid.profiler's table %.3f ms (%+.3f "
          "ms; %d op types, %d ops timed); with FLAGS_check_nan_inf %.3f "
          "ms (%.2fx, one read back per float output) [%s]"
          % (med["without"], med["with"], med["with"] - med["without"],
             len(mon.fetch_names), med["profiler"],
             med["profiler"] - med["without"], len(records),
             sum(r["calls"] for r in records.values()),
             med["check_nan_inf"], med["check_nan_inf"] / med["without"],
             smi), flush=True)
    for tag, prof in profiles.items():
        if prof is None:
            continue
        flash_ms, flash_n = prof["flash"]
        print("obs: 16b %s the monitor: %d launches a step, busy %.3f "
              "device-ms; the bf16 flash route %d launches a step, %.4f "
              "device-ms each (%.3f ms a step) [%s]"
              % (tag, prof["launches"], prof["busy_ms"], flash_n,
                 flash_ms / max(flash_n, 1), flash_ms, smi), flush=True)
    bf16 = launches[route_entry("bf16")]
    if bf16 != 2 * N_LAYER * OBS_STEPS:
        raise SystemExit("chip_smoke: %d bf16 flash launches in %d AMP "
                         "steps, designed %d a step"
                         % (bf16, OBS_STEPS, 2 * N_LAYER))

    # an Inf planted in one weight: located on the card and the CPU, the
    # scope bit for bit after the replay; then the step finds it
    scope.get(OBS_INF_WEIGHT)[OBS_INF_AT] = float("inf")
    before = scope_bits(scope)
    with fluid.amp.bf16_guard():
        t0 = time.perf_counter()
        found = health.locate_nonfinite(main, feeds[0], scope=scope)
        card_s = time.perf_counter() - t0
        differ = bits_differ(before, scope)
        planted = {n: scope.get(n).cpu().numpy() for n in persist}
        t0 = time.perf_counter()
        found_cpu = health.locate_nonfinite(
            main, feeds[0], scope=params_scope(planted, "cpu"),
            place=fluid.CPUPlace())
        cpu_s = time.perf_counter() - t0
        del planted
        outs = exe.run(main, feed=feeds[0], fetch_list=fetch, scope=scope)
        verdict = mon.record(outs[1:])
    gauge = registry.get_registry().gauge("amp_loss_scale").value
    print("obs: 16b Inf in %s%s: locate_nonfinite on the card (%.2f s) %s; "
          "on the CPU (%.2f s) %s; %d of %d scope entries differ after the "
          "replay; the step: found_nonfinite %s, %d nonfinite, loss scale "
          "%g -> %g, amp_loss_scale gauge %g"
          % (OBS_INF_WEIGHT, list(OBS_INF_AT), card_s,
             {k: v for k, v in (found or {}).items() if k != "message"},
             cpu_s, {k: v for k, v in (found_cpu or {}).items()
                     if k != "message"}, len(differ), len(before),
             verdict["found_nonfinite"], sum(verdict["nonfinite"].values()),
             scales[-1], verdict["loss_scale"], gauge), flush=True)
    if found is None or found != found_cpu or differ \
            or not verdict["found_nonfinite"] \
            or verdict["loss_scale"] != 2.0 ** 14 or gauge != 2.0 ** 14:
        raise SystemExit("chip_smoke: the planted Inf was not handled as "
                         "on the CPU")
    del scope, before
    torch.cuda.empty_cache()
    return launches


def obs_v2(smi):
    """16d: phase 14's NMT through v2's step_runner with health and the
    flight recorder on, on the card and the CPU from one state."""
    import paddle_tpu_torch.v2 as v2
    from paddle_tpu_torch.fluid import io
    from paddle_tpu_torch.obs import flight, health

    batches = nmt_batches(2, batch=OBS_NMT_BATCH)
    health.enable()
    rec = flight.install(out_dir=tempfile.mkdtemp(prefix="flight_"))
    runs = {}
    try:
        init = None
        for use_gpu in (True, False):
            with v2_program(v2, use_gpu) as (main, startup, scope):
                cost = build_nmt(v2)
                trainer = v2.trainer.SGD(
                    cost=cost, parameters=v2.parameters.create(cost),
                    update_equation=v2.optimizer.Adam(
                        learning_rate=NMT_LR, regularization_rate=NMT_L2))
                persist = [n for n, vd in main.desc.block(0).vars.items()
                           if vd.persistable]
                if init is None:
                    init = {n: scope.get(n).cpu().numpy() for n in persist}
                else:
                    io.params_from_numpy(scope, init, "cpu")
                step = trainer.step_runner()
                t0 = time.perf_counter()
                costs, norms = [], []
                for b in batches:
                    costs.append(step(b))
                    norms.append(trainer._health_monitor.last)
                runs[use_gpu] = (costs, norms, time.perf_counter() - t0,
                                 trainer._health_monitor)
    finally:
        health.disable()
        flight.uninstall()
    (card, cnorm, card_s, mon), (cpu, pnorm, cpu_s, _) = \
        runs[True], runs[False]
    errs = [abs(a["grad_global_norm"] - b["grad_global_norm"])
            / b["grad_global_norm"] for a, b in zip(cnorm, pnorm)]
    steps = [r for r in rec._steps if r["trainer"] == "v2"]
    print("obs: 16d the v2 NMT (dict %d, %d wide) at batch %d, 2 steps "
          "through step_runner with health on: the trainer's monitor %d "
          "scalars; card (%.1f s) costs %s norms %s; CPU (%.1f s) costs %s "
          "norms %s; norm error %s of its size (gate %g); %d nonfinite; "
          "%d flight records"
          % (NMT_DICT, NMT_WORD, OBS_NMT_BATCH, len(mon.fetch_names),
             card_s, ", ".join("%.6f" % c for c in card),
             ", ".join("%.6f" % n["grad_global_norm"] for n in cnorm),
             cpu_s, ", ".join("%.6f" % c for c in cpu),
             ", ".join("%.6f" % n["grad_global_norm"] for n in pnorm),
             ", ".join("%.3g" % e for e in errs), OBS_NORM_RTOL,
             sum(sum(n["nonfinite"].values()) for n in cnorm + pnorm),
             len(steps)), flush=True)
    if mon is None or max(errs) > OBS_NORM_RTOL or len(steps) != 4 \
            or any(n["found_nonfinite"] for n in cnorm + pnorm) \
            or not np.isfinite(card).all():
        raise SystemExit("chip_smoke: the v2 trainer's monitor disagrees "
                         "with the CPU")


def _request(url, payload, headers):
    """(status, body, headers, client ms) of one POST, errors included."""
    t0 = time.perf_counter()
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode("utf-8"),
        headers=dict(headers, **{"Content-Type": "application/json"}))
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            status, raw, hdrs = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as err:
        status, raw, hdrs = err.code, err.read(), err.headers
    return status, json.loads(raw), hdrs, (time.perf_counter() - t0) * 1e3


def _drive(url, rows, clients, traceparents):
    """Each request (one row of `rows`) from `clients` threads, in turn:
    the replies in row order."""
    replies = [None] * len(traceparents)

    def client(c):
        for i in range(c, len(traceparents), clients):
            replies[i] = _request(url, {"inputs": {
                n: v[i:i + 1].tolist() for n, v in rows.items()}},
                {"traceparent": traceparents[i]})

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    if any(r is None for r in replies):
        raise SystemExit("chip_smoke: a request got no reply")
    return replies


def obs_serve(smi):
    """16e: phase 3's transformer served with the SLO, the tail, the
    access log, traceparent, Retry-After and check_numerics on, against
    the same server without them.  Returns the launch counts of the
    observed server's run."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import Scope, io
    from paddle_tpu_torch.models import transformer_program as tp
    from paddle_tpu_torch.obs import registry
    from paddle_tpu_torch.serving import (EngineConfig, InferenceEngine,
                                          InferenceServer, ServerConfig)

    registry.reset_registry()
    rows = tp.transformer_feeds(OBS_REQUESTS, SEQ, VOCAB, seed=SEED + 170)
    rs = np.random.RandomState(SEED + 171)
    traceparents = ["00-%s-%s-01" % (rs.bytes(16).hex(), rs.bytes(8).hex())
                    for _ in range(OBS_REQUESTS)]
    tmp = tempfile.mkdtemp(prefix="serve_")
    prog = fluid.Program.from_desc(tp.build_transformer_inference_program(
        BATCH, SEQ, VOCAB, n_layer=N_LAYER, n_head=N_HEAD, d_model=D_MODEL))
    params = tp.init_transformer_params(prog.desc, seed=SEED)
    with fluid.program_guard(prog):
        values, ids = fluid.layers.topk(
            prog.global_block().var(tp.logits_name(N_LAYER)), k=OBS_TOPK)
    scope = Scope()
    io.params_from_numpy(scope, params, "cpu")
    io.save_inference_model(tmp, ["tokens", "positions"],
                            [values.name, ids.name], scope, prog,
                            bucket_hints={"batch_buckets": BUCKETS})
    results, log_path = {}, os.path.join(tmp, "access.jsonl")
    slow_ms = None
    for observed in (False, True):
        config = dict(port=0, max_batch=BATCH, max_wait_ms=50.0,
                      warmup=True)
        engine_config = None
        if observed:
            config.update(slo_ms=OBS_SLO_MS, tail_slow_ms=slow_ms,
                          tail_capacity=OBS_REQUESTS, access_log=log_path,
                          retry_after_s=2, queue_size=OBS_QUEUE)
            engine_config = EngineConfig(batch_buckets=BUCKETS,
                                         check_numerics=True)
            reset_launches()
        engine = InferenceEngine.from_saved_model(tmp, config=engine_config)
        server = InferenceServer(engine, ServerConfig(**config))
        try:
            server.start()
            url = "http://%s:%d/v1/infer" % server.address
            t0 = time.perf_counter()
            replies = _drive(url, rows, OBS_CLIENTS, traceparents)
            wall = time.perf_counter() - t0
            lat = np.array([r[3] for r in replies])
            results[observed] = (replies, lat)
            print("obs: 16e %s: %d requests from %d threads in %.2f s, "
                  "client latency p50 %.3f ms, p99 %.3f ms, max %.3f ms "
                  "[%s]" % ("with the observability" if observed else
                            "phase 3's server without it", OBS_REQUESTS,
                            OBS_CLIENTS, wall, np.percentile(lat, 50),
                            np.percentile(lat, 99), lat.max(), smi),
                  flush=True)
            if not observed:
                slow_ms = float(np.percentile(lat, 50))
                continue
            with open(log_path) as fh:
                log = [json.loads(line) for line in fh]
            base = "http://%s:%d" % server.address
            with urllib.request.urlopen(base + "/debug/tail",
                                        timeout=60) as r:
                tail = json.loads(r.read())
            with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
            # a burst past the queue while the engine is held
            burst = [None] * (OBS_QUEUE + BATCH + 8)
            with engine._lock:
                def shed(i):
                    burst[i] = _request(url, {"inputs": {
                        n: v[:1].tolist() for n, v in rows.items()}}, {})

                threads = [threading.Thread(target=shed, args=(i,))
                           for i in range(len(burst))]
                for th in threads:
                    th.start()
                t1 = time.time()
                while time.time() - t1 < 60 and sum(
                        b is not None for b in burst) < 8:
                    time.sleep(0.05)
            for th in threads:
                th.join(timeout=600)
            # the main path ends here: read the counts
            launches = read_launches()
        finally:
            server.shutdown()

    plain, _ = results[False]
    replies, lat = results[True]
    sent = [tp_.split("-")[1] for tp_ in traceparents]
    echoed = [r[2].get("traceparent", "").split("-")[1:2] for r in replies]
    ids_ok = all(r[0] == 200 and e == [s] and r[2].get("x-request-id")
                 == r[1]["request_id"] for r, e, s in
                 zip(replies, echoed, sent))
    log_ok = len(log) == OBS_REQUESTS and sorted(
        (x["trace_id"], x["request_id"]) for x in log) == sorted(
        (s, r[1]["request_id"]) for s, r in zip(sent, replies))
    want_tail = {x["request_id"] for x in log
                 if x["latency_ms"] >= slow_ms}
    got_tail = {x["request_id"] for x in tail["requests"]}
    edge = {x["request_id"] for x in log
            if abs(x["latency_ms"] - slow_ms) < 1e-3}
    tail_ok = (got_tail ^ want_tail) <= edge
    health_ok = "slo" in health and "slo_burn_rate" in health \
        and health["numerics_nonfinite_total"] == 0
    shed = [b for b in burst if b is not None and b[0] == 429]
    burst_ok = all(b is not None and b[0] in (200, 429) for b in burst) \
        and shed and all(b[2].get("Retry-After") == "2" for b in shed)
    worst, flips = 0.0, 0
    for p, r in zip(plain, replies):
        pv = np.asarray(p[1]["outputs"][values.name], np.float32)
        rv = np.asarray(r[1]["outputs"][values.name], np.float32)
        pi = np.asarray(p[1]["outputs"][ids.name])
        ri = np.asarray(r[1]["outputs"][ids.name])
        worst = max(worst, float(np.abs(pv - rv).max()))
        clear = (pv[..., 0] - pv[..., 1]) > 2 * LOGITS_ATOL
        flips += int((pi[..., 0] != ri[..., 0])[clear].sum())
    print("obs: 16e every reply echoed its trace id and request id: %s; "
          "access log %d lines carrying them: %s; /debug/tail %d requests, "
          "the %d logged at or above tail_slow_ms %.3f ms: %s; /healthz "
          "slo %s, burn %s, numerics_nonfinite_total %s; burst of %d with "
          "the engine held: %d answered 429 with Retry-After %s; answers "
          "against the server without the observability: top-%d values "
          "max_abs_err %.3g (atol %g), %d top-1 ids differ where the top "
          "two lie more than %g apart"
          % (ids_ok, len(log), log_ok, len(got_tail), len(want_tail),
             slow_ms, tail_ok, health.get("slo"),
             health.get("slo_burn_rate"),
             health.get("numerics_nonfinite_total"), len(burst), len(shed),
             sorted({b[2].get("Retry-After") for b in shed}), OBS_TOPK,
             worst, LOGITS_ATOL, flips, 2 * LOGITS_ATOL), flush=True)
    if tail["requests"]:
        slowest = max(tail["requests"], key=lambda r: r["latency_ms"])
        stages = []

        def walk(nodes):
            for node in nodes:
                stages.append("%s %.1f" % (node["name"].split("/")[-1],
                                           node["dur_ms"]))
                walk(node["children"])

        walk(slowest["spans"])
        print("obs: 16e the slowest request's span tree (%.1f ms): %s"
              % (slowest["latency_ms"], ", ".join(stages)), flush=True)
    if not (ids_ok and log_ok and tail_ok and health_ok and burst_ok) \
            or worst > LOGITS_ATOL or flips:
        raise SystemExit("chip_smoke: the observed server broke its "
                         "contract")
    return launches


def obs_nhwc(exe, smi):
    """16f: ResNet-50 at bench.py's width under bf16 AMP, converted to
    NHWC by fluid.convert_layout before minimize, against NCHW from one
    state; the first step also in f32."""
    import contextlib

    import torch
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models.image import resnet50

    progs = {}
    for layout in ("NCHW", "NHWC"):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            image = fluid.layers.data(
                name="image", shape=[RN_BATCH, 3, RN_HW, RN_HW],
                dtype="float32", append_batch_size=False)
            label = fluid.layers.data(name="label", shape=[RN_BATCH, 1],
                                      dtype="int64",
                                      append_batch_size=False)
            logits = resnet50(image, class_dim=RN_CLASSES)
            avg_loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(logits, label))
            n = fluid.convert_layout(main) if layout == "NHWC" else 0
            fluid.MomentumOptimizer(LR, MOMENTUM).minimize(avg_loss)
        progs[layout] = (main, startup, avg_loss, n)
    main, startup, _, _ = progs["NCHW"]
    persist = [n for n, v in main.desc.block(0).vars.items()
               if v.persistable]
    params = [p.name for p in main.global_block().all_parameters()]
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    init = {n: scope.get(n).cpu().numpy() for n in persist}
    del scope
    feeds = [{n: torch.from_numpy(v).to(exe.device) for n, v in f.items()}
             for f in resnet_feeds(RN_BATCH, NHWC_STEPS, SEED + 180)]

    def steps(layout, amp, state, n):
        """(losses, the parameters after each) of n steps from state."""
        main, _, loss, _ = progs[layout]
        scope = params_scope(state, exe.device)
        losses, after = [], []
        with fluid.amp.bf16_guard() if amp else contextlib.nullcontext():
            for f in feeds[:n]:
                losses.append(float(exe.run(main, feed=f, fetch_list=[loss],
                                            scope=scope)[0][0]))
                after.append({p: scope.get(p).float().cpu().numpy()
                              for p in params})
        return losses, after

    out = {layout: steps(layout, True, init, NHWC_STEPS)
           for layout in progs}
    torch.cuda.empty_cache()
    # the step's time in turns, NCHW, NHWC, NHWC, NCHW (the host's
    # spread moves a median between calls by more than the layouts do)
    fns, times = {}, collections.defaultdict(list)
    for layout, (main, _, loss, _) in progs.items():
        scope = params_scope(init, exe.device)
        fns[layout] = (lambda main=main, loss=loss, scope=scope: exe.run(
            main, feed=feeds[0], fetch_list=[loss], scope=scope,
            return_numpy=False))
    with fluid.amp.bf16_guard():
        for layout in ("NCHW", "NHWC", "NHWC", "NCHW"):
            times[layout] += timed_steps(fns[layout], runs=5, warm=1)
        profs = {layout: profile_step(
            fns[layout], {op.type for op in progs[layout][0].desc.block(0)
                          .ops}, 0, float(np.median(times[layout])),
            what="one ResNet-50 AMP step in %s" % layout)
            for layout in progs}
    del fns
    torch.cuda.empty_cache()
    for layout, (losses, _) in out.items():
        med, prof = float(np.median(times[layout])), profs[layout]
        print("obs: 16f ResNet-50 %s (%d transposes inserted), batch %d, "
              "bf16 AMP: losses %s; step %.3f ms (median of 10 in two "
              "turns), %.1f images/s; %s launches, cuDNN's layout "
              "transposes %s device-ms, busy %s device-ms [%s]"
              % (layout, progs[layout][3], RN_BATCH,
                 ", ".join("%.6f" % x for x in losses), med,
                 RN_BATCH / med * 1e3,
                 prof["launches"] if prof else "not measured",
                 "%.3f" % prof["families"].get("layout transposes", 0.0)
                 if prof else "not measured",
                 "%.3f" % prof["busy_ms"] if prof else "not measured", smi),
              flush=True)
    (nchw, nchw_after), (nhwc, nhwc_after) = out["NCHW"], out["NHWC"]
    # how far a bf16 step moves when its inputs' last bits do: NCHW from
    # the state with every f32 value moved by about one ulp
    _, nudged = steps("NCHW", True, {
        n: v * np.float32(1 + 2 ** -23) if v.dtype == np.float32 else v
        for n, v in init.items()}, 1)
    nudge = change_rl2(nudged[0], nchw_after[0], init, params)
    f32 = {layout: steps(layout, False, init, 1) for layout in progs}
    torch.cuda.empty_cache()
    f32_loss = abs(f32["NHWC"][0][0] - f32["NCHW"][0][0])
    f32_change = change_rl2(f32["NHWC"][1][0], f32["NCHW"][1][0], init,
                            params)
    loss_err = abs(nhwc[0] - nchw[0])
    change = change_rl2(nhwc_after[0], nchw_after[0], init, params)
    worst = sorted(params, key=lambda p: -change_rl2(
        nhwc_after[0], nchw_after[0], init, [p]))[:3]
    print("obs: 16f NHWC against NCHW from one state, bf16 AMP: first loss "
          "%.4g (atol %g), the first step's change %.4g in relative L2 "
          "(not gated: NCHW against itself from the state moved by one ulp "
          "%.4g; most apart %s); after step 2: loss %.4g, change %.4g; in "
          "f32 (TF32 off): first loss %.4g (atol %g), the first step's "
          "change %.4g (gate %g)"
          % (loss_err, NHWC_LOSS_ATOL, change, nudge,
             ", ".join("%s %.3g" % (p, change_rl2(nhwc_after[0],
                                                  nchw_after[0], init, [p]))
                       for p in worst),
             abs(nhwc[1] - nchw[1]),
             change_rl2(nhwc_after[1], nchw_after[1], init, params),
             f32_loss, RN_LOSS_ATOL, f32_change, NHWC_F32_CHANGE_RL2),
          flush=True)
    if loss_err > NHWC_LOSS_ATOL or f32_loss > RN_LOSS_ATOL \
            or f32_change > NHWC_F32_CHANGE_RL2 \
            or not np.isfinite(nhwc).all():
        raise SystemExit("chip_smoke: the NHWC program disagrees with NCHW")


def phase_obs():
    """Numerics health, the flight recorder, the profiler, request
    tracing and the NHWC relayout (phase 16).  Returns the launch counts
    of 16b's monitored AMP steps and of 16e's observed server."""
    import paddle_tpu_torch.fluid as fluid

    t0 = time.perf_counter()
    exe = fluid.Executor()
    if exe.device.type != "cuda":
        raise SystemExit("chip_smoke: the executor is not on the card")
    smi = nvidia_smi_line()
    obs_ops(exe.device)
    obs_scan(exe, smi)
    amp = obs_amp(exe, smi)
    obs_v2(smi)
    serve = obs_serve(smi)
    obs_nhwc(exe, smi)
    print("obs: phase 16 in %.1f s" % (time.perf_counter() - t0),
          flush=True)
    return amp, serve


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
    sequence_launches = phase_sequence()
    ctr_launches = phase_ctr()
    seq2seq_launches = phase_seq2seq()
    book_launches = phase_book()
    ctc_launches = phase_ctc()
    v2_launches = phase_v2()
    stack_launches = phase_stack()
    obs_amp_launches, obs_serve_launches = phase_obs()
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels._build import SOURCES

    # ResNet-50, the image models, the lstm, the ctr model, the seq2seq,
    # the book's chapters, CRNN-CTC and the v2 NMT run no hand-written
    # kernel: conv2d is cuDNN, the products cuBLAS and the rest ATen (the
    # sparse updates a segment reduction and `index_add`, the
    # recurrences, the CRF and the CTC loops of ATen ops), as the JAX
    # package leaves them to XLA
    for what, got in (("ResNet-50", resnet_launches),
                      ("the image models", image_launches),
                      ("the lstm", sequence_launches),
                      ("the ctr model", ctr_launches),
                      ("the seq2seq", seq2seq_launches),
                      ("the book's chapters", book_launches),
                      ("CRNN-CTC", ctc_launches),
                      ("the v2 NMT", v2_launches)):
        if any(got.values()):
            raise SystemExit("chip_smoke: %s launched %s"
                             % (what, json.dumps(got)))
    # the f32 route on each of the transformer's main paths
    f32 = route_entry("f32")
    paths = (launches[f32], train_launches[f32], decode_launches[f32],
             stack_launches[f32], obs_serve_launches[f32])
    if min(paths) < 1:
        raise SystemExit("chip_smoke: the f32 route was never launched on "
                         "a main path (served, trained, decoded, trained "
                         "with the whole stack, served with the "
                         "observability: %s)" % (paths,))
    kernels = []
    for route in fa.ROUTES:
        name = route_entry(route)
        total = sum(c.get(name, 0) for c in (
            launches, train_launches, wide_launches, resnet_launches,
            decode_launches, image_launches, sequence_launches,
            ctr_launches, seq2seq_launches, book_launches, ctc_launches,
            v2_launches, stack_launches, obs_amp_launches,
            obs_serve_launches))
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
