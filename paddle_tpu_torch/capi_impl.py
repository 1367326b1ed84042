"""Python side of the C inference API (consumed by native/capi.cc).

Counterpart of paddle_tpu/capi_impl.py (reference: paddle/capi — the C
deployment path loads a trained model and runs forward-only): `CEngine`
wraps `fluid.io.load_inference_model` and an `Executor`.  The JAX
package pins it to its CPU; the port runs on `CUDAPlace(0)` unless the
flag `use_gpu` (`FLAGS_use_gpu=0` in the environment of the C program)
asks for the CPU, since the C signature has no place.  Without a CUDA
device and without that flag, constructing an engine raises naming
CUDA, as the port's other entry points do.

`run_raw` keeps the JAX module's contract: float32 bytes and a shape
in, float32 bytes and the output's shape out.  Each engine loads its
parameters into a scope of its own.
"""

import numpy as np

__all__ = ["CEngine"]


class CEngine:
    def __init__(self, model_dir):
        from . import fluid
        from .utils import flags

        place = fluid.CUDAPlace(0) if flags.get_flag("use_gpu") \
            else fluid.CPUPlace()
        self._exe = fluid.Executor(place)
        self._scope = fluid.Scope()
        with fluid.scope_guard(self._scope):
            program, feed_names, fetch_names = \
                fluid.io.load_inference_model(model_dir, self._exe)
        self._program = program
        self._feed_names = feed_names
        self._fetch_names = fetch_names

    def run(self, arr):
        outs = self._exe.run(self._program,
                             feed={self._feed_names[0]: arr},
                             fetch_list=list(self._fetch_names),
                             scope=self._scope)
        return np.asarray(outs[0])

    def run_raw(self, data, shape):
        """bytes + shape tuple -> (bytes, shape tuple); float32 only
        (the C API's plain-buffer contract)."""
        arr = np.frombuffer(data, np.float32).reshape(shape)
        out = self.run(arr).astype(np.float32)
        return out.tobytes(), tuple(int(d) for d in out.shape)
