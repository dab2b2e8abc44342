// C inference ABI over the port's merged models.
//
// Reference analog: paddle/capi — the pure-C surface embedded apps link
// against (paddle_gradient_machine_create_for_inference_with_parameters,
// _forward; capi/gradient_machine.h:36-112) driving the engine on a merged
// single-file model.
//
// Two C surfaces share the merged-model story:
//  1. This file, the full-coverage path: the merged model is an exported
//     torch program (paddle_tpu_torch/export.py merge_model) and this ABI
//     hosts an embedded CPython running paddle_tpu_torch.export's loader.
//     The program runs on the device it was traced on (the manifest names
//     it), so a model merged on the card infers on the card.
//  2. native/src/aot_runtime.cpp, the interpreter-free path: the .ptnm
//     tensor program export_aot_program writes, run by plain C++ loops
//     with no Python in the process.
// Embedders get plain float-in / float-out calls either way, with the same
// symbols and return codes as the JAX package's capi.cpp.

#include <Python.h>

#include <cstdint>
#include <cstring>
#include <mutex>

namespace {

std::once_flag g_init_once;

struct Model {
  PyObject* model = nullptr;  // paddle_tpu_torch.export.MergedModel
};

void ensure_python() {
  std::call_once(g_init_once, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      // drop the GIL the init thread holds, or every other embedder
      // thread deadlocks in PyGILState_Ensure
      PyEval_SaveThread();
    }
  });
}

}  // namespace

extern "C" {

// Load a merged model file. Returns a handle or nullptr.
void* ptpu_model_load(const char* path) {
  ensure_python();
  PyGILState_STATE gil = PyGILState_Ensure();
  Model* out = nullptr;
  PyObject* mod = PyImport_ImportModule("paddle_tpu_torch.export");
  if (mod) {
    PyObject* loader = PyObject_GetAttrString(mod, "load_merged_model");
    if (loader) {
      PyObject* m = PyObject_CallFunction(loader, "s", path);
      if (m) {
        out = new Model();
        out->model = m;
      }
      Py_DECREF(loader);
    }
    Py_DECREF(mod);
  }
  if (!out) PyErr_Print();
  PyGILState_Release(gil);
  return out;
}

// Single dense float input -> first output, as [rows, cols] with rows the
// output's leading dim. Returns 0 on success, -2 when out_capacity is too
// small (out_rows/out_cols then hold the required shape so the caller can
// resize and retry), -1 on failure.
int ptpu_infer(void* handle, const char* input_name, const float* data,
               int64_t batch, int64_t dim, float* out, int64_t out_capacity,
               int64_t* out_rows, int64_t* out_cols) {
  auto* m = static_cast<Model*>(handle);
  if (!m || !m->model || batch < 0 || dim < 0) return -1;
  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = -1;
  // the feed crosses as raw little-endian f32 bytes (one copy); the
  // loader views them as a [batch, dim] array
  PyObject* raw = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(data),
      static_cast<Py_ssize_t>(batch * dim * sizeof(float)));
  PyObject* res = raw ? PyObject_CallMethod(m->model, "_infer_flat", "sOLL",
                                            input_name, raw,
                                            static_cast<long long>(batch),
                                            static_cast<long long>(dim))
                      : nullptr;
  Py_XDECREF(raw);
  long long rows = 0, cols = 0;
  PyObject* bytes = nullptr;
  if (res && PyArg_ParseTuple(res, "LLS", &rows, &cols, &bytes)) {
    *out_rows = rows;
    *out_cols = cols;
    if (rows * cols > out_capacity) {
      rc = -2;  // caller can resize using *out_rows / *out_cols
    } else if (PyBytes_Size(bytes) ==
               static_cast<Py_ssize_t>(rows * cols * sizeof(float))) {
      std::memcpy(out, PyBytes_AsString(bytes), rows * cols * sizeof(float));
      rc = 0;
    }
  }
  Py_XDECREF(res);
  if (rc == -1 && PyErr_Occurred()) PyErr_Print();
  PyGILState_Release(gil);
  return rc;
}

// Shared-param multi-instance handle (gradient_machine.h:88 analog): the
// clone's MergedModel shares the origin's loaded program and its one
// weight copy, so N serving threads hold N handles over ONE weight copy.
// Returns nullptr on failure.
void* ptpu_model_create_shared(void* origin) {
  auto* m = static_cast<Model*>(origin);
  if (!m || !m->model) return nullptr;
  PyGILState_STATE gil = PyGILState_Ensure();
  Model* out = nullptr;
  PyObject* clone = PyObject_CallMethod(m->model, "create_shared", nullptr);
  if (clone) {
    out = new Model();
    out->model = clone;
  } else {
    PyErr_Print();
  }
  PyGILState_Release(gil);
  return out;
}

void ptpu_model_release(void* handle) {
  auto* m = static_cast<Model*>(handle);
  if (!m) return;
  PyGILState_STATE gil = PyGILState_Ensure();
  Py_XDECREF(m->model);
  PyGILState_Release(gil);
  delete m;
}

}  // extern "C"
