"""paddle_tpu_torch — the PyTorch + CUDA port of paddle_tpu.

A second implementation of the framework for NVIDIA Hopper GPUs
(H100, sm_90a), beside the JAX package it is held against.  It imports
torch, numpy and the standard library only — never jax and nothing of
paddle_tpu — and keeps the JAX package's module layout (core/, ops/,
kernels/, fluid/, models/, serving/, utils/) so each module has an
obvious counterpart.  Programs are built through its own fluid.layers.  The one hand-written TPU kernel on the served path, the
flash-attention forward, is CUDA C++ here (csrc/, built at first use).

Entry points (fluid.Executor, fluid.ProgramDecoder,
serving.InferenceEngine) run on the card, CUDAPlace(0), unless the
caller passes CPUPlace(); without a CUDA device they raise instead of
carrying on on the CPU.

Importing this package sets torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 to False, so float32 matrix products
run in full float32 on the card, as XLA runs them on the JAX side.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
