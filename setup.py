"""Packaging for paddle_tpu (reference: the CMake superbuild +
manylinux wheel pipeline, CMakeLists.txt:38-62 + tools/manylinux1).

The TPU build needs no compiled extension at wheel time: the compute
path is JAX/XLA, and the native runtime (pserver/master/recordio/
allocator) ships as C++ sources that `paddle_tpu.native` compiles once
at first use with the host toolchain (see native/Makefile).  So the
wheel is pure-Python plus the native/ source tree as package data.

    pip wheel .            # build a wheel
    pip install .          # or install straight into the env
"""

import os

from setuptools import setup, find_packages

_HERE = os.path.dirname(os.path.abspath(__file__))


def _native_sources():
    out = []
    for root, _dirs, files in os.walk(os.path.join(_HERE, "native")):
        for f in files:
            if f.endswith((".cc", ".h", "Makefile")) or f == "Makefile":
                out.append(os.path.relpath(os.path.join(root, f), _HERE))
    return out


setup(
    name="paddle_tpu",
    version="0.4.0",
    description="TPU-native deep learning framework with the "
                "PaddlePaddle v2/early-Fluid capability surface",
    packages=find_packages(include=["paddle_tpu", "paddle_tpu.*",
                                    "paddle_tpu_torch",
                                    "paddle_tpu_torch.*"]),
    package_data={"paddle_tpu_torch": ["csrc/*.cu", "native/*.cc",
                                       "native/*.h", "native/Makefile"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    # the native runtime builds from these at first use (installed
    # flat under <prefix>/paddle_tpu_native/native; paddle_tpu.native
    # copies them into a writable cache and makes there)
    data_files=[("paddle_tpu_native/native", _native_sources())],
    entry_points={
        "console_scripts": [
            "paddle_trainer=paddle_tpu.tools.trainer_cli:main",
            "paddle_serve=paddle_tpu.tools.serve_cli:main",
            "pperf=paddle_tpu.tools.perf_cli:main",
            "pmem=paddle_tpu.tools.mem_cli:main",
            "ptune=paddle_tpu.tools.tune_cli:main",
            "pshard=paddle_tpu.tools.shard_cli:main",
            "pcomm=paddle_tpu.tools.comm_cli:main",
            "pload=paddle_tpu.tools.load_cli:main",
            "pelastic=paddle_tpu.tools.elastic_cli:main",
        ],
    },
)
