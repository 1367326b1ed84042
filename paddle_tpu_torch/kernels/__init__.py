"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  `_build` compiles csrc/ at first use; `KERNELS` lists every
kernel wrapper of the package, whose `launches` counts its launches;
`launch_counts` reads them in one dict and `reset_launches` zeroes
them."""

from . import flash_attention
from ._build import build_all

KERNELS = {
    "flash_attention_fwd": flash_attention.flash_attention_fwd,
}

__all__ = ["KERNELS", "build_all", "flash_attention", "launch_counts",
           "reset_launches", "route_entry"]


def route_entry(route):
    """The `launch_counts` name of the flash kernel's `route`."""
    return "flash_attention_fwd[%s]" % route


def reset_launches():
    """Every launch count to 0: each kernel's, and the flash kernel's by
    route."""
    for w in KERNELS.values():
        w.launches = 0
    for route in flash_attention.ROUTES:
        flash_attention.flash_attention_fwd.route_launches[route] = 0


def launch_counts():
    """{name: launches} of each kernel, and of the flash kernel by route
    (`route_entry`)."""
    counts = {n: w.launches for n, w in KERNELS.items()}
    counts.update({route_entry(r): n for r, n in
                   flash_attention.flash_attention_fwd.route_launches
                   .items()})
    return counts
