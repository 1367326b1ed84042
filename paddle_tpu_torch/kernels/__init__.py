"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  `_build` compiles csrc/ at first use; `KERNELS` lists every
kernel wrapper of the package, whose `launches` counts its launches."""

from . import flash_attention
from ._build import build_all

KERNELS = {
    "flash_attention_fwd": flash_attention.flash_attention_fwd,
}

__all__ = ["KERNELS", "build_all", "flash_attention"]
