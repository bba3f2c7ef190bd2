/* mh_tpu native runtime: C ABI shared library embedding the JAX engine.
 *
 * Re-creation of the reference's host wrapper (SURVEY.md C9):
 * where the reference builds a CUDA DLL whose exported KernelWrapper stages
 * buffers and launches kernels (Kernel.cu:873-984), this library embeds
 * CPython, forwards the same wire structs to mh_tpu.native.bridge as raw
 * byte buffers, and copies the results back into caller-allocated memory.
 * A C / C# / C++ host application links (or P/Invokes) exactly as it would
 * against the reference DLL.
 *
 * Unlike the reference, all buffers are owned/freed properly (the reference
 * leaks 7 of its 12 device allocations, Kernel.cu:963-967) and the returned
 * cost breakdowns are real (Kernel.cu:852-861 leaves them uninitialized).
 */

#include <Python.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>

#include "wire.h"

#ifndef MH_TPU_PYROOT
#define MH_TPU_PYROOT ""
#endif

namespace {

std::mutex g_mutex;
bool g_initialized = false;
PyObject* g_bridge = nullptr;  // mh_tpu.native.bridge module

// Initialize the embedded interpreter + import the bridge once.
// Returns 0 on success. Caller must hold g_mutex.
int64_t ensure_bridge_locked() {
  if (g_initialized) return g_bridge ? 0 : -1;
  g_initialized = true;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
  }
  // Make the mh_tpu package importable without a site-packages install:
  // prepend the build-time repo root (or MH_TPU_PYROOT env override) to
  // sys.path. The reference DLL has no analogous concern (pure CUDA).
  {
    const char* env_root = std::getenv("MH_TPU_PYROOT");
    const char* root = (env_root && *env_root) ? env_root : MH_TPU_PYROOT;
    if (root && *root) {
      PyObject* sys_path = PySys_GetObject("path");  // borrowed
      PyObject* entry = sys_path ? PyUnicode_FromString(root) : nullptr;
      if (entry) {
        PyList_Insert(sys_path, 0, entry);
        Py_DECREF(entry);
      }
    }
  }
  g_bridge = PyImport_ImportModule("mh_tpu.native.bridge");
  if (!g_bridge) {
    PyErr_Print();
    return -1;
  }
  return 0;
}

PyObject* bytes_view(const void* p, Py_ssize_t len) {
  return PyBytes_FromStringAndSize(static_cast<const char*>(p), len);
}

}  // namespace

extern "C" int64_t MHKernelWrapper(const mh_surface* surface,
                                   const mh_relationship* relationships,
                                   const mh_angle_relationship* angle_relationships,
                                   const mh_pose* poses,
                                   const mh_rect* clearances,
                                   const mh_rect* offlimits,
                                   const mh_config* config,
                                   double* out_points,
                                   mh_result_costs* out_costs,
                                   double* out_accept_rate) {
  if (!surface || !poses || !config || !out_points || !out_costs ||
      !out_accept_rate) {
    return -2;
  }
  std::lock_guard<std::mutex> lock(g_mutex);
  if (ensure_bridge_locked() != 0) return -1;

  const int64_t n = surface->n_objs;
  const int64_t chains = config->n_chains;

  PyObject* args = Py_BuildValue(
      "(NNNNNNN)",
      bytes_view(surface, sizeof(mh_surface)),
      bytes_view(relationships,
                 sizeof(mh_relationship) * surface->n_relationships),
      bytes_view(angle_relationships,
                 sizeof(mh_angle_relationship) *
                     surface->n_angle_relationships),
      bytes_view(poses, sizeof(mh_pose) * n),
      bytes_view(clearances, sizeof(mh_rect) * surface->n_clearances),
      bytes_view(offlimits, sizeof(mh_rect) * n),
      bytes_view(config, sizeof(mh_config)));
  if (!args) {
    PyErr_Print();
    return -3;
  }

  PyObject* fn = PyObject_GetAttrString(g_bridge, "run_wire");
  PyObject* result = fn ? PyObject_CallObject(fn, args) : nullptr;
  Py_XDECREF(fn);
  Py_DECREF(args);
  if (!result) {
    PyErr_Print();
    return -4;
  }

  // result: bytes = points f64[chains*n*6] | costs f64[chains*8] |
  //                 accept f64[chains]
  const int64_t pts = chains * n * 6;
  const int64_t expect =
      static_cast<int64_t>(sizeof(double)) * (pts + chains * 8 + chains);
  char* buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(result, &buf, &len) != 0 || len != expect) {
    Py_DECREF(result);
    return -5;
  }
  std::memcpy(out_points, buf, sizeof(double) * pts);
  std::memcpy(out_costs, buf + sizeof(double) * pts,
              sizeof(double) * chains * 8);
  std::memcpy(out_accept_rate, buf + sizeof(double) * (pts + chains * 8),
              sizeof(double) * chains);
  Py_DECREF(result);
  return 0;
}

extern "C" int64_t MHDeviceReport(char* buf, int64_t buf_len) {
  if (!buf || buf_len <= 0) return -2;
  std::lock_guard<std::mutex> lock(g_mutex);
  if (ensure_bridge_locked() != 0) return -1;
  PyObject* s = PyObject_CallMethod(g_bridge, "device_report", nullptr);
  if (!s) {
    PyErr_Print();
    return -4;
  }
  const char* c = PyUnicode_AsUTF8(s);
  if (!c) {
    Py_DECREF(s);
    return -5;
  }
  std::snprintf(buf, static_cast<size_t>(buf_len), "%s", c);
  Py_DECREF(s);
  return 0;
}
