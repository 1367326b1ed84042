"""v2 Parameters: numpy views over the trained state, and tar files
(reference: python/paddle/v2/parameters.py — Parameters, to_tar,
from_tar; its tar holds one raw file per parameter).

The port's counterpart of paddle_tpu/v2/parameters.py.  The scope holds
torch tensors on the place's device: `get` copies one to the host as a
numpy array, and `set` writes a numpy array back as a tensor of the old
value's dtype, shape and device (the place's device for a name without
a value).  The tar format is the JAX package's, member for member: a
`manifest.json` listing the names, then one `<name>.npy` per parameter
in name order, so a tar written by either package loads in the other.
"""

import io
import json
import tarfile

import numpy as np
import torch

from .. import fluid
from ..core import scope as scope_mod
from ..core.types import tensor_from_numpy
from ..fluid import framework
from ..fluid.io import host_array

__all__ = ["Parameters", "create"]


class Parameters:
    """Name -> numpy parameter view bound to a scope."""

    def __init__(self, program=None, scope=None):
        self._program = program or framework.default_main_program()
        self._scope = scope or scope_mod.global_scope()

    def _param_vars(self):
        out = {}
        for block in self._program.blocks:
            for var in block.vars.values():
                if isinstance(var, framework.Parameter):
                    out[var.name] = var
        return out

    def keys(self):
        return sorted(self._param_vars())

    def names(self):
        return self.keys()

    def has_key(self, key):
        return key in self._param_vars()

    def __iter__(self):
        return iter(self.keys())

    def __len__(self):
        return len(self._param_vars())

    def get(self, name):
        val = self._scope.get(name)
        if val is None:
            raise ValueError("parameter %r has no value yet" % name)
        return host_array(name, val)

    __getitem__ = get

    def get_shape(self, name):
        return tuple(self._param_vars()[name].shape)

    def set(self, name, value):
        old = self._scope.get(name)
        value = np.asarray(value)
        if isinstance(old, torch.Tensor):
            t = tensor_from_numpy(value, "cpu").reshape(old.shape).to(
                device=old.device, dtype=old.dtype)
        else:
            from .config import _place

            t = tensor_from_numpy(value, _place().device())
        self._scope.set(name, t)

    __setitem__ = set

    def to_tar(self, f):
        """A `manifest.json` member listing the names, then one `.npy`
        member per parameter (the JAX package's format)."""
        tar = tarfile.open(fileobj=f, mode="w")
        names = self.keys()
        manifest = json.dumps({"parameters": names}).encode()
        info = tarfile.TarInfo("manifest.json")
        info.size = len(manifest)
        tar.addfile(info, io.BytesIO(manifest))
        for name in names:
            buf = io.BytesIO()
            np.save(buf, self.get(name))
            data = buf.getvalue()
            info = tarfile.TarInfo(name + ".npy")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
        tar.close()

    @classmethod
    def from_tar(cls, f, program=None, scope=None):
        params = cls(program=program, scope=scope)
        for name, arr in _tar_arrays(f):
            params.set(name, arr)
        return params

    def init_from_tar(self, f):
        """Set the parameters of this topology that the tar holds."""
        for name, arr in _tar_arrays(f):
            if self.has_key(name):
                self.set(name, arr)


def _tar_arrays(f):
    """(name, array) of each `.npy` member of the tar `f`."""
    with tarfile.open(fileobj=f, mode="r") as tar:
        for member in tar.getmembers():
            if member.name.endswith(".npy"):
                data = tar.extractfile(member).read()
                yield member.name[:-4], np.load(io.BytesIO(data))


def create(cost_or_program=None):
    """Run the startup program on the v2 place and return a Parameters
    view (reference: parameters.create(topology); the topology here is
    the default program)."""
    from .config import _place

    program = None
    if cost_or_program is not None and hasattr(cost_or_program, "blocks"):
        program = cost_or_program
    exe = fluid.Executor(_place())
    exe.run(framework.default_startup_program())
    return Parameters(program=program)
