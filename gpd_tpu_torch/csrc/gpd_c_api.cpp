// gpd_tpu_torch C ABI implementation (see gpd_c_api.h).
//
// Embeds CPython and drives gpd_tpu_torch.capi, marshaling results out
// through the buffer protocol into plain malloc'd C structs. The reference's
// equivalent layer is src/detect_grasps_python.cpp (a C ABI over the C++
// pipeline for ctypes callers); here the direction is inverted because the
// pipeline itself is a PyTorch program.
//
// Works both as the embedding host (a C program links the library and we
// initialize the interpreter) and loaded INTO a running Python process
// (ctypes: Py_IsInitialized() is already true and only the GIL is taken).

#include "gpd_c_api.h"

#include <Python.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

namespace {

thread_local std::string g_last_error;

void set_error(const char *where) {
  g_last_error = where;
  if (PyErr_Occurred()) {
    PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
    PyErr_Fetch(&type, &value, &trace);
    PyErr_NormalizeException(&type, &value, &trace);
    if (value != nullptr) {
      PyObject *s = PyObject_Str(value);
      if (s != nullptr) {
        const char *msg = PyUnicode_AsUTF8(s);
        if (msg != nullptr) {
          g_last_error += ": ";
          g_last_error += msg;
        }
        Py_DECREF(s);
      }
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(trace);
  }
}

std::mutex g_init_mutex;
bool g_we_initialized = false;

// Ensure the interpreter exists. Returns false on failure.
bool ensure_python() {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    if (!Py_IsInitialized()) {
      g_last_error = "Py_InitializeEx failed";
      return false;
    }
    // Release the GIL acquired by initialization so PyGILState_Ensure
    // works uniformly from any thread afterwards.
    (void)PyEval_SaveThread();
    g_we_initialized = true;
  }
  return true;
}

class GIL {
 public:
  GIL() : state_(PyGILState_Ensure()) {}
  ~GIL() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

PyObject *capi_module() {
  // Borrowed-module pattern: import once per call; Python caches it.
  PyObject *mod = PyImport_ImportModule("gpd_tpu_torch.capi");
  if (mod == nullptr) set_error("import gpd_tpu_torch.capi failed");
  return mod;
}

// Call gpd_tpu_torch.capi.<fn>(args...) and return the result (new ref).
PyObject *call_capi(const char *fn, PyObject *args) {
  PyObject *mod = capi_module();
  if (mod == nullptr) return nullptr;
  PyObject *f = PyObject_GetAttrString(mod, fn);
  Py_DECREF(mod);
  if (f == nullptr) {
    set_error("missing gpd_tpu_torch.capi function");
    return nullptr;
  }
  PyObject *out = PyObject_CallObject(f, args);
  Py_DECREF(f);
  if (out == nullptr) set_error(fn);
  return out;
}

// Wrap host memory as a read-only 2D float32 memoryview-compatible object.
PyObject *as_float_array(const float *data, Py_ssize_t rows,
                         Py_ssize_t cols) {
  if (data == nullptr) Py_RETURN_NONE;
  // Build a bytes copy; simplest ownership story across the boundary.
  PyObject *np = PyImport_ImportModule("numpy");
  if (np == nullptr) return nullptr;
  PyObject *frombuffer = PyObject_GetAttrString(np, "frombuffer");
  PyObject *bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(data),
      static_cast<Py_ssize_t>(sizeof(float)) * rows * cols);
  PyObject *arr = nullptr;
  if (frombuffer != nullptr && bytes != nullptr) {
    arr = PyObject_CallFunction(frombuffer, "Os", bytes, "float32");
  }
  Py_XDECREF(bytes);
  Py_XDECREF(frombuffer);
  PyObject *shaped = nullptr;
  if (arr != nullptr) {
    PyObject *reshape = PyObject_GetAttrString(arr, "reshape");
    if (reshape != nullptr) {
      shaped = PyObject_CallFunction(reshape, "nn", rows, cols);
      Py_DECREF(reshape);
    }
    Py_DECREF(arr);
  }
  Py_DECREF(np);
  return shaped;
}

PyObject *as_uint32_array(const uint32_t *data, Py_ssize_t n) {
  if (data == nullptr) Py_RETURN_NONE;
  PyObject *np = PyImport_ImportModule("numpy");
  if (np == nullptr) return nullptr;
  PyObject *frombuffer = PyObject_GetAttrString(np, "frombuffer");
  PyObject *bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(data),
      static_cast<Py_ssize_t>(sizeof(uint32_t)) * n);
  PyObject *arr = nullptr;
  if (frombuffer != nullptr && bytes != nullptr) {
    arr = PyObject_CallFunction(frombuffer, "Os", bytes, "uint32");
  }
  Py_XDECREF(bytes);
  Py_XDECREF(frombuffer);
  Py_DECREF(np);
  return arr;
}

// Copy an (n, GRASP_FLOATS) float64 buffer into malloc'd GpdGrasp rows.
int grasps_from_buffer(PyObject *rows_obj, GpdGrasp **out_grasps,
                       int *out_count) {
  Py_buffer view;
  if (PyObject_GetBuffer(rows_obj, &view, PyBUF_C_CONTIGUOUS) != 0) {
    set_error("grasp buffer not C-contiguous");
    return -1;
  }
  const int kFloats = 19;  // gpd_tpu_torch.capi.GRASP_FLOATS
  if (view.itemsize != sizeof(double) ||
      view.len % (kFloats * sizeof(double)) != 0) {
    PyBuffer_Release(&view);
    g_last_error = "unexpected grasp row layout";
    return -1;
  }
  int n = static_cast<int>(view.len / (kFloats * sizeof(double)));
  GpdGrasp *grasps = nullptr;
  if (n > 0) {
    grasps = static_cast<GpdGrasp *>(malloc(sizeof(GpdGrasp) * n));
    if (grasps == nullptr) {
      PyBuffer_Release(&view);
      g_last_error = "out of memory";
      return -1;
    }
    const double *src = static_cast<const double *>(view.buf);
    for (int i = 0; i < n; ++i) {
      const double *r = src + i * kFloats;
      memcpy(grasps[i].position, r, 3 * sizeof(double));
      memcpy(grasps[i].orientation, r + 3, 9 * sizeof(double));
      memcpy(grasps[i].sample, r + 12, 3 * sizeof(double));
      grasps[i].width = r[15];
      grasps[i].score = r[16];
      grasps[i].full_antipodal = r[17] != 0.0;
      grasps[i].half_antipodal = r[18] != 0.0;
    }
  }
  PyBuffer_Release(&view);
  *out_grasps = grasps;
  *out_count = n;
  return 0;
}

}  // namespace

extern "C" {

const char *gpd_last_error(void) { return g_last_error.c_str(); }

int gpd_init(const char *platform) {
  if (!ensure_python()) return -1;
  GIL gil;
  PyObject *args = Py_BuildValue("(s)", platform != nullptr ? platform : "");
  PyObject *r = call_capi("set_device", args);
  Py_XDECREF(args);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int64_t gpd_detector_create(const char *cfg_path) {
  if (!ensure_python()) return 0;
  GIL gil;
  PyObject *args = Py_BuildValue("(s)", cfg_path);
  PyObject *h = call_capi("create_detector", args);
  Py_XDECREF(args);
  if (h == nullptr) return 0;
  int64_t handle = PyLong_AsLongLong(h);
  Py_DECREF(h);
  if (handle <= 0) {
    g_last_error = "invalid detector handle";
    return 0;
  }
  return handle;
}

void gpd_detector_destroy(int64_t detector) {
  if (!Py_IsInitialized()) return;
  GIL gil;
  PyObject *args = Py_BuildValue("(L)", detector);
  PyObject *r = call_capi("destroy_detector", args);
  Py_XDECREF(args);
  Py_XDECREF(r);
}

int gpd_detect_grasps_in_file(int64_t detector, const char *cloud_path,
                              GpdGrasp **out_grasps, int *out_count) {
  if (out_grasps == nullptr || out_count == nullptr) return -1;
  if (!ensure_python()) return -1;
  GIL gil;
  PyObject *args = Py_BuildValue("(Ls)", detector, cloud_path);
  PyObject *rows = call_capi("detect_in_file", args);
  Py_XDECREF(args);
  if (rows == nullptr) return -1;
  int rc = grasps_from_buffer(rows, out_grasps, out_count);
  Py_DECREF(rows);
  return rc;
}

int gpd_detect_grasps_in_cloud(int64_t detector, const float *points,
                               int n_points, const float *view_points,
                               int n_view_points, const uint32_t *cam_source,
                               GpdGrasp **out_grasps, int *out_count) {
  if (points == nullptr || out_grasps == nullptr || out_count == nullptr) {
    g_last_error = "null argument";
    return -1;
  }
  if (!ensure_python()) return -1;
  GIL gil;
  PyObject *pts = as_float_array(points, n_points, 3);
  PyObject *vps = as_float_array(view_points, n_view_points, 3);
  PyObject *cam = as_uint32_array(cam_source, n_points);
  if (pts == nullptr || vps == nullptr || cam == nullptr) {
    set_error("argument marshaling failed");
    Py_XDECREF(pts);
    Py_XDECREF(vps);
    Py_XDECREF(cam);
    return -1;
  }
  PyObject *args = Py_BuildValue("(LOOO)", detector, pts, vps, cam);
  Py_DECREF(pts);
  Py_DECREF(vps);
  Py_DECREF(cam);
  PyObject *rows = call_capi("detect_in_cloud", args);
  Py_XDECREF(args);
  if (rows == nullptr) return -1;
  int rc = grasps_from_buffer(rows, out_grasps, out_count);
  Py_DECREF(rows);
  return rc;
}

int gpd_calc_grasp_descriptors(int64_t detector, const float *points,
                               int n_points, const float *view_points,
                               int n_view_points, GpdGrasp **out_grasps,
                               uint8_t **out_images, int *out_count,
                               int *out_image_size, int *out_channels) {
  if (points == nullptr || out_grasps == nullptr || out_images == nullptr ||
      out_count == nullptr || out_image_size == nullptr ||
      out_channels == nullptr) {
    g_last_error = "null argument";
    return -1;
  }
  if (!ensure_python()) return -1;
  GIL gil;
  PyObject *pts = as_float_array(points, n_points, 3);
  PyObject *vps = as_float_array(view_points, n_view_points, 3);
  if (pts == nullptr || vps == nullptr) {
    set_error("argument marshaling failed");
    Py_XDECREF(pts);
    Py_XDECREF(vps);
    return -1;
  }
  PyObject *args = Py_BuildValue("(LOO)", detector, pts, vps);
  Py_DECREF(pts);
  Py_DECREF(vps);
  PyObject *tup = call_capi("calc_descriptors", args);
  Py_XDECREF(args);
  if (tup == nullptr) return -1;
  if (!PyTuple_Check(tup) || PyTuple_Size(tup) != 2) {
    Py_DECREF(tup);
    g_last_error = "calc_descriptors: unexpected return";
    return -1;
  }
  PyObject *rows = PyTuple_GetItem(tup, 0);    // borrowed
  PyObject *images = PyTuple_GetItem(tup, 1);  // borrowed

  int rc = grasps_from_buffer(rows, out_grasps, out_count);
  if (rc != 0) {
    Py_DECREF(tup);
    return rc;
  }

  // images: (G, s, s, C) uint8, C-contiguous.
  PyObject *shape = PyObject_GetAttrString(images, "shape");
  long s = 0, c = 0;
  if (shape != nullptr && PyTuple_Check(shape) && PyTuple_Size(shape) == 4) {
    s = PyLong_AsLong(PyTuple_GetItem(shape, 1));
    c = PyLong_AsLong(PyTuple_GetItem(shape, 3));
  }
  Py_XDECREF(shape);
  Py_buffer view;
  if (PyObject_GetBuffer(images, &view, PyBUF_C_CONTIGUOUS) != 0) {
    set_error("image buffer not C-contiguous");
    free(*out_grasps);
    *out_grasps = nullptr;
    Py_DECREF(tup);
    return -1;
  }
  uint8_t *buf = nullptr;
  if (view.len > 0) {
    buf = static_cast<uint8_t *>(malloc(view.len));
    if (buf == nullptr) {
      PyBuffer_Release(&view);
      free(*out_grasps);
      *out_grasps = nullptr;
      Py_DECREF(tup);
      g_last_error = "out of memory";
      return -1;
    }
    memcpy(buf, view.buf, view.len);
  }
  PyBuffer_Release(&view);
  Py_DECREF(tup);
  *out_images = buf;
  *out_image_size = static_cast<int>(s);
  *out_channels = static_cast<int>(c);
  return 0;
}

void gpd_free(void *ptr) { free(ptr); }

}  // extern "C"
