"""Reader decorators, creators and prefetching (reference:
python/paddle/v2/reader/); counterpart of paddle_tpu/reader/."""

from .decorator import *  # noqa: F401,F403
from .decorator import __all__ as _dec_all
from . import creator  # noqa: F401
from .prefetch import device_prefetch, host_prefetch  # noqa: F401

__all__ = list(_dec_all) + ["creator", "device_prefetch",
                            "host_prefetch"]
