"""Device layers (reference: python/paddle/v2/fluid/layers/device.py,
get_places over get_places_op.cc).

Counterpart of paddle_tpu/fluid/layers/device.py.
"""

from ..layer_helper import LayerHelper

__all__ = ["get_places"]


def get_places(device_count=None, device_type=None, **kwargs):
    """The device list of data-parallel layout, as an int32 tensor of
    place indices.  Informational: the mesh (parallel.make_mesh) is the
    real layout; kept for parallel_do users.  The `get_places` op counts
    the ranks of the ambient mesh, or else the visible CUDA devices (1
    on the CPU)."""
    from ...ops.control_flow import visible_places

    helper = LayerHelper("get_places", **kwargs)
    out = helper.create_variable(name=helper.name, dtype="int32")
    avail = visible_places()
    if device_count is None:
        device_count = avail
    out.device_count = min(device_count, avail)
    helper.append_op(type="get_places", outputs={"Out": [out]},
                     attrs={"device_count": device_count,
                            "device_type": device_type or "CUDA"})
    return out
