// C inference API: load a saved inference model and run it from C.
//
// TPU-native equivalent of the reference's C deployment API
// (reference: paddle/capi/capi.h, gradient_machine.h:36
// paddle_gradient_machine_create_for_inference(_with_parameters) +
// forward).  The reference embeds Python for config parsing
// (paddle/utils/PythonUtil.h); here the whole inference engine is the
// Python/XLA stack, so the C API embeds CPython and drives
// paddle_tpu_torch.capi_impl — the compiled XLA executable does the math, C
// callers get a plain float-buffer interface.
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>

extern "C" {

struct PtCapiEngine {
  PyObject *engine;  // paddle_tpu_torch.capi_impl.CEngine
};

static std::once_flag g_py_init;

static void ensureInterpreter() {
  std::call_once(g_py_init, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      // release the GIL the init thread holds, or every other thread's
      // PyGILState_Ensure deadlocks
      PyEval_SaveThread();
    }
  });
}

// Create an engine from a save_inference_model directory.  Returns
// NULL on failure (error printed to stderr).
void *ptcapi_create(const char *model_dir) {
  ensureInterpreter();
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *mod = PyImport_ImportModule("paddle_tpu_torch.capi_impl");
  if (!mod) {
    PyErr_Print();
    PyGILState_Release(gil);
    return nullptr;
  }
  PyObject *engine = PyObject_CallMethod(mod, "CEngine", "s", model_dir);
  Py_DECREF(mod);
  if (!engine) {
    PyErr_Print();
    PyGILState_Release(gil);
    return nullptr;
  }
  PtCapiEngine *h = new PtCapiEngine{engine};
  PyGILState_Release(gil);
  return h;
}

// Run inference: one float input of shape dims[0..ndims), one float
// output written to `output` (capacity in elements); the actual output
// shape lands in out_dims/out_ndims (caller provides space for 8 dims).
// Returns number of output elements, or -1 on error.
int64_t ptcapi_run(void *handle, const float *input, const int64_t *dims,
                   int ndims, float *output, int64_t out_capacity,
                   int64_t *out_dims, int *out_ndims) {
  PtCapiEngine *h = static_cast<PtCapiEngine *>(handle);
  PyGILState_STATE gil = PyGILState_Ensure();

  int64_t n = 1;
  PyObject *shape = PyTuple_New(ndims);
  for (int i = 0; i < ndims; ++i) {
    n *= dims[i];
    PyTuple_SET_ITEM(shape, i, PyLong_FromLongLong(dims[i]));
  }
  PyObject *data = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(input), n * 4);
  PyObject *res = PyObject_CallMethod(h->engine, "run_raw", "OO", data,
                                      shape);
  Py_DECREF(data);
  Py_DECREF(shape);
  if (!res) {
    PyErr_Print();
    PyGILState_Release(gil);
    return -1;
  }
  // res = (bytes, shape tuple)
  PyObject *out_bytes = PyTuple_GetItem(res, 0);
  PyObject *out_shape = PyTuple_GetItem(res, 1);
  int64_t out_n = static_cast<int64_t>(PyBytes_Size(out_bytes)) / 4;
  if (out_n > out_capacity) {
    Py_DECREF(res);
    PyGILState_Release(gil);
    return -1;
  }
  memcpy(output, PyBytes_AsString(out_bytes), out_n * 4);
  int nd = static_cast<int>(PyTuple_Size(out_shape));
  if (nd > 8) {  // out_dims contract is 8 entries max
    Py_DECREF(res);
    PyGILState_Release(gil);
    return -1;
  }
  if (out_ndims) *out_ndims = nd;
  if (out_dims) {
    for (int i = 0; i < nd; ++i)
      out_dims[i] = PyLong_AsLongLong(PyTuple_GetItem(out_shape, i));
  }
  Py_DECREF(res);
  PyGILState_Release(gil);
  return out_n;
}

void ptcapi_destroy(void *handle) {
  PtCapiEngine *h = static_cast<PtCapiEngine *>(handle);
  PyGILState_STATE gil = PyGILState_Ensure();
  Py_XDECREF(h->engine);
  PyGILState_Release(gil);
  delete h;
}

}  // extern "C"
