"""The port's C inference API (paddle_tpu_torch/native/capi.cc over
`paddle_tpu_torch.capi_impl`) driven by the JAX test's C program
(tests/test_capi.py, printing 9 significant digits where that prints
6 decimals, so that rtol 1e-5 holds for small outputs too, and calling
`ptcapi_run` once more into a short buffer), on the CPU
(`FLAGS_use_gpu=0` in the program's environment), against each
package's own `exe.run` at rtol 1e-5:

- on an export saved by the port, against the port's run;
- on an export saved by the JAX package, against JAX's run;
- a `ptcapi_run` into a buffer too small for the output returns -1;
- `CEngine` without a CUDA device and without the flag raises naming
  CUDA;
- the library builds from the port's sources into
  build/paddle_tpu_torch/native/ (nothing under native/ or paddle_tpu/),
  and the port's capi.cc is the JAX file but for the module it imports.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import native
from paddle_tpu_torch.utils import flags as tflags

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

C_SRC = r'''
#include <stdio.h>
#include <stdint.h>

extern void *ptcapi_create(const char *model_dir);
extern int64_t ptcapi_run(void *h, const float *in, const int64_t *dims,
                          int ndims, float *out, int64_t cap,
                          int64_t *out_dims, int *out_ndims);
extern void ptcapi_destroy(void *h);

int main(int argc, char **argv) {
  void *h = ptcapi_create(argv[1]);
  if (!h) { fprintf(stderr, "create failed\n"); return 2; }
  float in[8];
  for (int i = 0; i < 8; ++i) in[i] = (float)i / 8.0f;
  int64_t dims[2] = {2, 4};
  float out[64];
  int64_t out_dims[8];
  int out_nd = 0;
  int64_t n = ptcapi_run(h, in, dims, 2, out, 64, out_dims, &out_nd);
  if (n < 0) { fprintf(stderr, "run failed\n"); return 3; }
  printf("n=%lld nd=%d", (long long)n, out_nd);
  for (int i = 0; i < out_nd; ++i)
    printf(" d%d=%lld", i, (long long)out_dims[i]);
  for (int i = 0; i < (n < 6 ? n : 6); ++i) printf(" v%d=%.9e", i, out[i]);
  /* the capacity contract: an output that does not fit returns -1 */
  int64_t small = ptcapi_run(h, in, dims, 2, out, n - 1, out_dims, &out_nd);
  printf(" small=%lld\n", (long long)small);
  ptcapi_destroy(h);
  return 0;
}
'''

INPUT = (np.arange(8, dtype=np.float32) / 8.0).reshape(2, 4)


@pytest.fixture(scope="module")
def c_program(tmp_path_factory):
    """The C consumer compiled against the port's library (built at
    first use)."""
    lib = native.build_capi()
    d = tmp_path_factory.mktemp("capi")
    src = d / "use_capi.c"
    src.write_text(C_SRC)
    exe_path = str(d / "use_capi")
    lib_dir = os.path.dirname(lib)
    subprocess.run(["gcc", str(src), "-o", exe_path, "-L" + lib_dir,
                    "-lpaddle_tpu_torch_capi", "-Wl,-rpath," + lib_dir],
                   check=True)
    return exe_path


def _run_c(exe_path, model_dir):
    env = dict(os.environ, PYTHONPATH=native.capi_pythonpath(),
               FLAGS_use_gpu="0", JAX_PLATFORMS="cpu")
    out = subprocess.run([exe_path, model_dir], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return dict(kv.split("=") for kv in out.stdout.split())


def _check(fields, expect):
    assert fields["n"] == "6" and fields["nd"] == "2"
    assert fields["d0"] == "2" and fields["d1"] == "3"
    got = [float(fields["v%d" % i]) for i in range(6)]
    np.testing.assert_allclose(got, np.asarray(expect).reshape(-1),
                               rtol=1e-5)
    assert fields["small"] == "-1"


def test_c_program_on_port_export(c_program, tmp_path):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        y = tfluid.layers.fc(input=x, size=3, act=None)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    model_dir = str(tmp_path / "model")
    tfluid.io.save_inference_model(model_dir, ["x"], [y], scope, main)
    with tfluid.scope_guard(tfluid.Scope()):
        prog, _, fetches = tfluid.io.load_inference_model(model_dir, exe)
        expect, = exe.run(prog, feed={"x": INPUT}, fetch_list=fetches)
    _check(_run_c(c_program, model_dir), expect)


def test_c_program_on_jax_export(c_program, tmp_path):
    x = jfluid.layers.data(name="x", shape=[4], dtype="float32")
    y = jfluid.layers.fc(input=x, size=3, act=None)
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(jfluid.default_startup_program())
    model_dir = str(tmp_path / "model")
    jfluid.io.save_inference_model(model_dir, ["x"], [y], exe)
    expect, = exe.run(jfluid.io.load_inference_model(model_dir, exe)[0],
                      feed={"x": INPUT}, fetch_list=[y.name])
    _check(_run_c(c_program, model_dir), expect)


def test_cengine_refuses_the_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default place is valid")
    from paddle_tpu_torch.capi_impl import CEngine

    prev = tflags.get_flag("use_gpu")
    tflags.set_flag("use_gpu", True)
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            CEngine(str(tmp_path))
    finally:
        tflags.set_flag("use_gpu", prev)


def test_capi_source_and_build_place():
    with open(os.path.join(ROOT, "native", "capi.cc")) as f:
        jax_src = f.read()
    with open(os.path.join(native.SOURCE_DIR, "capi.cc")) as f:
        port_src = f.read()
    assert port_src == jax_src.replace("paddle_tpu.capi_impl",
                                       "paddle_tpu_torch.capi_impl")
    lib = native.build_capi()
    assert os.path.dirname(lib) == os.path.join(ROOT, "build",
                                                "paddle_tpu_torch", "native")
    assert os.path.exists(lib)
    assert not os.path.exists(os.path.join(native.SOURCE_DIR,
                                           "libpaddle_tpu_torch_capi.so"))
    assert not os.path.exists(os.path.join(ROOT, "native",
                                           "libpaddle_tpu_torch_capi.so"))
