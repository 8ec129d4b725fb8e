// c_api.cpp — C ABI over the TPU-native renderer (see include/iht.h).
//
// TPU-native counterpart of the reference's C API implementation
// (reference/src/server/c_api.cpp): opaque handles + error codes over
// the server layer. The compute stack is the port's engine; this translation
// unit embeds (or joins) a CPython interpreter and drives
// ice_halo_sim_tpu_torch.engine.server.Server through the CPython C API.
//
// Interpreter ownership: if the process already hosts Python (the library
// was dlopen'd from a Python process, e.g. via ctypes), we join it; when
// standalone (a C front-end linked against libiht) we initialize Python
// lazily on first use. Every entry point takes the GIL via PyGILState.
//
// Result frames copy all pixel/stat data into C++ storage at acquire time,
// so reads need no GIL and frames stay valid across interpreter activity —
// the immutable-snapshot contract (reference ResultFrame, server.hpp).

#include "iht.h"

#include <Python.h>

#include <atomic>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;

void SetError(const std::string& msg) { g_last_error = msg; }

std::string FetchPyError() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = "python error";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return msg;
}

// ---- interpreter bootstrap -------------------------------------------------

std::once_flag g_init_once;
bool g_we_initialized = false;

void EnsureInterpreter() {
  std::call_once(g_init_once, [] {
    if (Py_IsInitialized() == 0) {
      Py_InitializeEx(0);
      g_we_initialized = true;
      // Release the GIL acquired by Py_Initialize so PyGILState_Ensure
      // works uniformly from any thread (including this one).
      PyEval_SaveThread();
    }
  });
}

class Gil {
 public:
  Gil() {
    EnsureInterpreter();
    state_ = PyGILState_Ensure();
  }
  ~Gil() { PyGILState_Release(state_); }
  Gil(const Gil&) = delete;
  Gil& operator=(const Gil&) = delete;

 private:
  PyGILState_STATE state_;
};

// Call a method on obj; returns new reference or nullptr (error fetched).
PyObject* CallMethod(PyObject* obj, const char* name, PyObject* args) {
  PyObject* fn = PyObject_GetAttrString(obj, name);
  if (fn == nullptr) return nullptr;
  PyObject* res = PyObject_CallObject(fn, args);
  Py_DECREF(fn);
  return res;
}

}  // namespace

// ---- handle types ----------------------------------------------------------

struct IHT_Server {
  PyObject* py_server;  // ice_halo_sim_tpu_torch.engine.server.Server
};

struct RenderImage {
  int width = 0;
  int height = 0;
  std::vector<unsigned char> rgb;  // H*W*3
  std::vector<float> xyz;         // H*W*3
  std::vector<float> composite;   // H*W*3 (empty when no raypath_color)
  double landed = 0.0;
  double ev_auto = 0.0;
};

struct IHT_ResultFrame {
  long long generation = 0;
  long long ray_count = 0;
  int is_idle = 0;
  IHT_Stats stats{};
  std::vector<RenderImage> renders;
};

// ---- API -------------------------------------------------------------------

extern "C" {

int IHT_ApiVersion(void) { return IHT_API_VERSION; }

const char* IHT_LastError(void) { return g_last_error.c_str(); }

IHT_Status IHT_CreateServer(IHT_Server** out, unsigned int seed,
                            int batch_size) {
  if (out == nullptr) {
    SetError("out is null");
    return IHT_ERR_INVALID_ARG;
  }
  *out = nullptr;
  Gil gil;
  PyObject* mod = PyImport_ImportModule("ice_halo_sim_tpu_torch.engine.server");
  if (mod == nullptr) {
    SetError("import ice_halo_sim_tpu_torch.engine.server failed: " + FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  PyObject* cls = PyObject_GetAttrString(mod, "Server");
  Py_DECREF(mod);
  if (cls == nullptr) {
    SetError(FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  PyObject* kwargs = Py_BuildValue(
      "{s:I,s:O}", "seed", seed, "batch_size",
      batch_size > 0 ? PyLong_FromLong(batch_size) : Py_NewRef(Py_None));
  PyObject* args = PyTuple_New(0);
  PyObject* server = PyObject_Call(cls, args, kwargs);
  Py_DECREF(cls);
  Py_DECREF(args);
  Py_XDECREF(kwargs);
  if (server == nullptr) {
    SetError("Server() failed: " + FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  *out = new IHT_Server{server};
  return IHT_OK;
}

IHT_Status IHT_DestroyServer(IHT_Server* server) {
  if (server == nullptr) return IHT_ERR_INVALID_ARG;
  {
    Gil gil;
    PyObject* res = CallMethod(server->py_server, "shutdown", nullptr);
    if (res == nullptr) {
      PyErr_Clear();
    } else {
      Py_DECREF(res);
    }
    Py_DECREF(server->py_server);
  }
  delete server;
  return IHT_OK;
}

static IHT_Status CommitImpl(IHT_Server* server, PyObject* arg,
                             int* out_reused) {
  PyObject* args = PyTuple_Pack(1, arg);
  PyObject* res = CallMethod(server->py_server, "commit", args);
  Py_DECREF(args);
  if (res == nullptr) {
    SetError("commit failed: " + FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  if (out_reused != nullptr) *out_reused = PyObject_IsTrue(res) == 1 ? 1 : 0;
  Py_DECREF(res);
  return IHT_OK;
}

IHT_Status IHT_CommitSceneJson(IHT_Server* server, const char* json,
                               int* out_reused) {
  if (server == nullptr || json == nullptr) return IHT_ERR_INVALID_ARG;
  Gil gil;
  // Parse JSON text to a dict (Server.commit(str) means "file path").
  PyObject* jmod = PyImport_ImportModule("json");
  if (jmod == nullptr) {
    SetError(FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  PyObject* text = PyUnicode_FromString(json);
  PyObject* args = PyTuple_Pack(1, text);
  PyObject* obj = CallMethod(jmod, "loads", args);
  Py_DECREF(args);
  Py_DECREF(text);
  Py_DECREF(jmod);
  if (obj == nullptr) {
    SetError("bad JSON: " + FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  IHT_Status st = CommitImpl(server, obj, out_reused);
  Py_DECREF(obj);
  return st;
}

IHT_Status IHT_CommitSceneFile(IHT_Server* server, const char* path,
                               int* out_reused) {
  if (server == nullptr || path == nullptr) return IHT_ERR_INVALID_ARG;
  Gil gil;
  PyObject* p = PyUnicode_FromString(path);
  IHT_Status st = CommitImpl(server, p, out_reused);
  Py_DECREF(p);
  return st;
}

long long IHT_GetSimRayCount(IHT_Server* server) {
  if (server == nullptr) return -1;
  Gil gil;
  PyObject* res = CallMethod(server->py_server, "sim_ray_count", nullptr);
  if (res == nullptr) {
    PyErr_Clear();
    return -1;
  }
  long long v = PyLong_AsLongLong(res);
  Py_DECREF(res);
  return v;
}

int IHT_QueryServerState(IHT_Server* server) {
  if (server == nullptr) return IHT_ERR_INVALID_ARG;
  Gil gil;
  PyObject* res = CallMethod(server->py_server, "state", nullptr);
  if (res == nullptr) {
    SetError(FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  PyObject* value = PyObject_GetAttrString(res, "value");
  Py_DECREF(res);
  if (value == nullptr) {
    SetError(FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  const char* s = PyUnicode_AsUTF8(value);
  int state = IHT_ERR_RUNTIME;
  if (s != nullptr) {
    if (std::strcmp(s, "idle") == 0) state = IHT_STATE_IDLE;
    if (std::strcmp(s, "running") == 0) state = IHT_STATE_RUNNING;
    if (std::strcmp(s, "stopped") == 0) state = IHT_STATE_STOPPED;
  }
  Py_DECREF(value);
  return state;
}

IHT_Status IHT_WaitIdle(IHT_Server* server, double timeout_s) {
  if (server == nullptr) return IHT_ERR_INVALID_ARG;
  Gil gil;
  PyObject* args;
  if (timeout_s < 0) {
    args = PyTuple_Pack(1, Py_None);
  } else {
    PyObject* t = PyFloat_FromDouble(timeout_s);
    args = PyTuple_Pack(1, t);
    Py_DECREF(t);
  }
  PyObject* res = CallMethod(server->py_server, "wait_idle", args);
  Py_DECREF(args);
  if (res == nullptr) {
    SetError(FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  bool ok = PyObject_IsTrue(res) == 1;
  Py_DECREF(res);
  return ok ? IHT_OK : IHT_ERR_TIMEOUT;
}

IHT_Status IHT_StopServer(IHT_Server* server) {
  if (server == nullptr) return IHT_ERR_INVALID_ARG;
  Gil gil;
  PyObject* res = CallMethod(server->py_server, "stop", nullptr);
  if (res == nullptr) {
    SetError(FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  Py_DECREF(res);
  return IHT_OK;
}

// ---- frames ----------------------------------------------------------------

}  // extern "C"

namespace {

// Copy a bytes-like numpy array (via tobytes()) into out.
template <typename T>
bool CopyArray(PyObject* arr, std::vector<T>* out) {
  PyObject* b = CallMethod(arr, "tobytes", nullptr);
  if (b == nullptr) return false;
  char* data = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(b, &data, &len) != 0) {
    Py_DECREF(b);
    return false;
  }
  out->resize(static_cast<size_t>(len) / sizeof(T));
  std::memcpy(out->data(), data, static_cast<size_t>(len));
  Py_DECREF(b);
  return true;
}

long long GetLLAttr(PyObject* obj, const char* name, long long dflt = 0) {
  PyObject* a = PyObject_GetAttrString(obj, name);
  if (a == nullptr) {
    PyErr_Clear();
    return dflt;
  }
  long long v = PyLong_AsLongLong(a);
  if (PyErr_Occurred() != nullptr) {
    PyErr_Clear();
    v = dflt;
  }
  Py_DECREF(a);
  return v;
}

double GetDblAttr(PyObject* obj, const char* name, double dflt = 0.0) {
  PyObject* a = PyObject_GetAttrString(obj, name);
  if (a == nullptr) {
    PyErr_Clear();
    return dflt;
  }
  double v = PyFloat_AsDouble(a);
  if (PyErr_Occurred() != nullptr) {
    PyErr_Clear();
    v = dflt;
  }
  Py_DECREF(a);
  return v;
}

}  // namespace

extern "C" {

IHT_Status IHT_AcquireResultFrame(IHT_Server* server, IHT_ResultFrame** out) {
  if (server == nullptr || out == nullptr) return IHT_ERR_INVALID_ARG;
  *out = nullptr;
  Gil gil;
  PyObject* frame = CallMethod(server->py_server, "acquire_frame", nullptr);
  if (frame == nullptr) {
    SetError(FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  if (frame == Py_None) {
    Py_DECREF(frame);
    SetError("no scene committed yet");
    return IHT_ERR_NO_FRAME;
  }
  auto* f = new IHT_ResultFrame();
  f->generation = GetLLAttr(frame, "generation");
  f->ray_count = GetLLAttr(frame, "ray_count");
  PyObject* idle = PyObject_GetAttrString(frame, "is_idle");
  f->is_idle = (idle != nullptr && PyObject_IsTrue(idle) == 1) ? 1 : 0;
  Py_XDECREF(idle);

  PyObject* stats = PyObject_GetAttrString(frame, "stats");
  if (stats != nullptr) {
    f->stats.rays_traced = GetLLAttr(stats, "rays_traced");
    f->stats.ray_segments = GetLLAttr(stats, "ray_segments");
    f->stats.landed_weight = GetDblAttr(stats, "landed_weight");
    f->stats.dropped_cont_weight = GetDblAttr(stats, "dropped_cont_weight");
    f->stats.stochastic_crystal_samples =
        GetLLAttr(stats, "stochastic_crystal_samples");
    f->stats.stochastic_orientation_samples =
        GetLLAttr(stats, "stochastic_orientation_samples");
    f->stats.deterministic_crystal_count =
        GetLLAttr(stats, "deterministic_crystal_count");
    f->stats.deterministic_orientation_count =
        GetLLAttr(stats, "deterministic_orientation_count");
    Py_DECREF(stats);
  } else {
    PyErr_Clear();
  }

  PyObject* images = PyObject_GetAttrString(frame, "images");
  PyObject* raws = PyObject_GetAttrString(frame, "raw_xyz");
  PyObject* comps = PyObject_GetAttrString(frame, "composites");
  PyObject* landed = PyObject_GetAttrString(frame, "landed");
  PyObject* ev_auto = PyObject_GetAttrString(frame, "ev_auto");
  if (comps == nullptr || landed == nullptr || ev_auto == nullptr) {
    PyErr_Clear();
  }
  bool ok = images != nullptr && raws != nullptr;
  if (ok) {
    Py_ssize_t n = PySequence_Length(images);
    for (Py_ssize_t i = 0; ok && i < n; ++i) {
      PyObject* img = PySequence_GetItem(images, i);
      PyObject* raw = PySequence_GetItem(raws, i);
      RenderImage r;
      if (img != nullptr && raw != nullptr) {
        PyObject* shape = PyObject_GetAttrString(img, "shape");
        if (shape != nullptr && PyTuple_Check(shape) != 0 &&
            PyTuple_Size(shape) == 3) {
          r.height = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(shape, 0)));
          r.width = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(shape, 1)));
          ok = CopyArray(img, &r.rgb) && CopyArray(raw, &r.xyz);
        } else {
          ok = false;
        }
        Py_XDECREF(shape);
      } else {
        ok = false;
      }
      if (ok && comps != nullptr && i < PySequence_Length(comps)) {
        PyObject* c = PySequence_GetItem(comps, i);
        if (c != nullptr && c != Py_None) {
          if (!CopyArray(c, &r.composite)) {
            PyErr_Clear();
            r.composite.clear();
          }
        }
        Py_XDECREF(c);
      }
      if (ok && landed != nullptr && i < PySequence_Length(landed)) {
        PyObject* v = PySequence_GetItem(landed, i);
        if (v != nullptr) r.landed = PyFloat_AsDouble(v);
        if (PyErr_Occurred() != nullptr) PyErr_Clear();
        Py_XDECREF(v);
      }
      if (ok && ev_auto != nullptr && i < PySequence_Length(ev_auto)) {
        PyObject* v = PySequence_GetItem(ev_auto, i);
        if (v != nullptr) r.ev_auto = PyFloat_AsDouble(v);
        if (PyErr_Occurred() != nullptr) PyErr_Clear();
        Py_XDECREF(v);
      }
      if (ok) f->renders.push_back(std::move(r));
    }
  }
  Py_XDECREF(images);
  Py_XDECREF(raws);
  Py_XDECREF(comps);
  Py_XDECREF(landed);
  Py_XDECREF(ev_auto);
  Py_DECREF(frame);
  if (!ok) {
    delete f;
    SetError("frame extraction failed: " + FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  *out = f;
  return IHT_OK;
}

IHT_Status IHT_ReleaseResultFrame(IHT_ResultFrame* frame) {
  if (frame == nullptr) return IHT_ERR_INVALID_ARG;
  delete frame;  // pure C++ storage: no GIL needed
  return IHT_OK;
}

long long IHT_FrameGetGeneration(const IHT_ResultFrame* frame) {
  return frame == nullptr ? -1 : frame->generation;
}

long long IHT_FrameGetRayCount(const IHT_ResultFrame* frame) {
  return frame == nullptr ? -1 : frame->ray_count;
}

int IHT_FrameIsIdle(const IHT_ResultFrame* frame) {
  return frame == nullptr ? 0 : frame->is_idle;
}

int IHT_FrameGetRenderCount(const IHT_ResultFrame* frame) {
  return frame == nullptr ? -1 : static_cast<int>(frame->renders.size());
}

IHT_Status IHT_FrameGetRenderSize(const IHT_ResultFrame* frame, int idx,
                                  int* width, int* height) {
  if (frame == nullptr || idx < 0 ||
      idx >= static_cast<int>(frame->renders.size())) {
    return IHT_ERR_INVALID_ARG;
  }
  if (width != nullptr) *width = frame->renders[idx].width;
  if (height != nullptr) *height = frame->renders[idx].height;
  return IHT_OK;
}

IHT_Status IHT_FrameGetRender(const IHT_ResultFrame* frame, int idx,
                              unsigned char* dst, size_t cap) {
  if (frame == nullptr || dst == nullptr || idx < 0 ||
      idx >= static_cast<int>(frame->renders.size())) {
    return IHT_ERR_INVALID_ARG;
  }
  const auto& rgb = frame->renders[idx].rgb;
  if (cap < rgb.size()) return IHT_ERR_BUFFER_TOO_SMALL;
  std::memcpy(dst, rgb.data(), rgb.size());
  return IHT_OK;
}

IHT_Status IHT_FrameGetRawXyz(const IHT_ResultFrame* frame, int idx,
                              float* dst, size_t cap) {
  if (frame == nullptr || dst == nullptr || idx < 0 ||
      idx >= static_cast<int>(frame->renders.size())) {
    return IHT_ERR_INVALID_ARG;
  }
  const auto& xyz = frame->renders[idx].xyz;
  if (cap < xyz.size()) return IHT_ERR_BUFFER_TOO_SMALL;
  std::memcpy(dst, xyz.data(), xyz.size() * sizeof(float));
  return IHT_OK;
}

IHT_Status IHT_FrameGetStats(const IHT_ResultFrame* frame, IHT_Stats* out) {
  if (frame == nullptr || out == nullptr) return IHT_ERR_INVALID_ARG;
  *out = frame->stats;
  return IHT_OK;
}

int IHT_FrameHasComposite(const IHT_ResultFrame* frame, int idx) {
  if (frame == nullptr || idx < 0 ||
      idx >= static_cast<int>(frame->renders.size())) {
    return 0;
  }
  return frame->renders[idx].composite.empty() ? 0 : 1;
}

IHT_Status IHT_FrameGetComposite(const IHT_ResultFrame* frame, int idx,
                                 float* dst, size_t cap) {
  if (frame == nullptr || dst == nullptr || idx < 0 ||
      idx >= static_cast<int>(frame->renders.size())) {
    return IHT_ERR_INVALID_ARG;
  }
  const auto& c = frame->renders[idx].composite;
  if (c.empty()) return IHT_ERR_NO_FRAME;
  if (cap < c.size()) return IHT_ERR_BUFFER_TOO_SMALL;
  std::memcpy(dst, c.data(), c.size() * sizeof(float));
  return IHT_OK;
}

IHT_Status IHT_FrameGetLanded(const IHT_ResultFrame* frame, int idx,
                              double* out) {
  if (frame == nullptr || out == nullptr || idx < 0 ||
      idx >= static_cast<int>(frame->renders.size())) {
    return IHT_ERR_INVALID_ARG;
  }
  *out = frame->renders[idx].landed;
  return IHT_OK;
}

IHT_Status IHT_FrameGetEvAuto(const IHT_ResultFrame* frame, int idx,
                              double* out) {
  if (frame == nullptr || out == nullptr || idx < 0 ||
      idx >= static_cast<int>(frame->renders.size())) {
    return IHT_ERR_INVALID_ARG;
  }
  *out = frame->renders[idx].ev_auto;
  return IHT_OK;
}

// ---- display-time color control ---------------------------------------------

IHT_Status IHT_SetRaypathColors(IHT_Server* server, const char* json) {
  if (server == nullptr || json == nullptr) return IHT_ERR_INVALID_ARG;
  Gil gil;
  PyObject* text = PyUnicode_FromString(json);
  PyObject* args = PyTuple_Pack(1, text);
  PyObject* res = CallMethod(server->py_server, "set_raypath_colors_json", args);
  Py_DECREF(args);
  Py_DECREF(text);
  if (res == nullptr) {
    SetError("set_raypath_colors failed: " + FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  Py_DECREF(res);
  return IHT_OK;
}

IHT_Status IHT_SetCompositeExposure(IHT_Server* server, double ev) {
  if (server == nullptr) return IHT_ERR_INVALID_ARG;
  Gil gil;
  PyObject* v = PyFloat_FromDouble(ev);
  PyObject* args = PyTuple_Pack(1, v);
  PyObject* res = CallMethod(server->py_server, "set_composite_exposure", args);
  Py_DECREF(args);
  Py_DECREF(v);
  if (res == nullptr) {
    SetError(FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  Py_DECREF(res);
  return IHT_OK;
}

int IHT_GetColorClassSignal(IHT_Server* server, int* out, int cap) {
  if (server == nullptr) return IHT_ERR_INVALID_ARG;
  Gil gil;
  PyObject* res = CallMethod(server->py_server, "color_class_signal", nullptr);
  if (res == nullptr) {
    SetError(FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  Py_ssize_t n = PySequence_Length(res);
  if (n < 0) {
    Py_DECREF(res);
    SetError(FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  if (out != nullptr) {
    for (Py_ssize_t i = 0; i < n && i < cap; ++i) {
      PyObject* v = PySequence_GetItem(res, i);
      out[i] = (v != nullptr && PyObject_IsTrue(v) == 1) ? 1 : 0;
      Py_XDECREF(v);
    }
  }
  Py_DECREF(res);
  return static_cast<int>(n);
}

IHT_Status IHT_GetColorOverflowInfo(IHT_Server* server, int* overflow_count,
                                    int* capacity) {
  if (server == nullptr) return IHT_ERR_INVALID_ARG;
  Gil gil;
  PyObject* res = CallMethod(server->py_server, "color_overflow_info", nullptr);
  if (res == nullptr) {
    SetError(FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  PyObject* cnt = PyDict_GetItemString(res, "component_overflow_count");
  PyObject* cp = PyDict_GetItemString(res, "component_capacity");
  if (overflow_count != nullptr) {
    *overflow_count = cnt != nullptr ? static_cast<int>(PyLong_AsLong(cnt)) : 0;
  }
  if (capacity != nullptr) {
    *capacity = cp != nullptr ? static_cast<int>(PyLong_AsLong(cp)) : 0;
  }
  if (PyErr_Occurred() != nullptr) PyErr_Clear();
  Py_DECREF(res);
  return IHT_OK;
}

// ---- lifecycle / drain -------------------------------------------------------

IHT_Status IHT_GetDrainStatus(IHT_Server* server, long long* current_epoch,
                              long long* drained_epoch) {
  if (server == nullptr) return IHT_ERR_INVALID_ARG;
  Gil gil;
  PyObject* res = CallMethod(server->py_server, "drain_status", nullptr);
  if (res == nullptr) {
    SetError(FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  if (current_epoch != nullptr) *current_epoch = GetLLAttr(res, "current_epoch");
  if (drained_epoch != nullptr) *drained_epoch = GetLLAttr(res, "drained_epoch");
  Py_DECREF(res);
  return IHT_OK;
}

IHT_Status IHT_GetSimLifecycle(IHT_Server* server, int* state,
                               long long* epoch) {
  if (server == nullptr) return IHT_ERR_INVALID_ARG;
  Gil gil;
  PyObject* res = CallMethod(server->py_server, "lifecycle", nullptr);
  if (res == nullptr) {
    SetError(FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  if (state != nullptr) {
    *state = IHT_ERR_RUNTIME;
    PyObject* s = PyDict_GetItemString(res, "state");
    const char* c = s != nullptr ? PyUnicode_AsUTF8(s) : nullptr;
    if (c != nullptr) {
      if (std::strcmp(c, "idle") == 0) *state = IHT_STATE_IDLE;
      if (std::strcmp(c, "running") == 0) *state = IHT_STATE_RUNNING;
      if (std::strcmp(c, "stopped") == 0) *state = IHT_STATE_STOPPED;
    }
  }
  if (epoch != nullptr) {
    PyObject* e = PyDict_GetItemString(res, "epoch");
    *epoch = e != nullptr ? PyLong_AsLongLong(e) : 0;
    if (PyErr_Occurred() != nullptr) PyErr_Clear();
  }
  Py_DECREF(res);
  return IHT_OK;
}

}  // extern "C"

// ---- logging ----------------------------------------------------------------

namespace {

std::atomic<IHT_LogCallback> g_log_cb{nullptr};
std::atomic<void*> g_log_user{nullptr};

PyObject* LogTrampoline(PyObject* /*self*/, PyObject* args) {
  const char* lvl = nullptr;
  const char* logger = nullptr;
  const char* msg = nullptr;
  if (PyArg_ParseTuple(args, "sss", &lvl, &logger, &msg) == 0) return nullptr;
  IHT_LogCallback cb = g_log_cb.load();
  if (cb != nullptr) {
    void* user = g_log_user.load();
    // The callback is plain C — release the GIL around it so it can block
    // without stalling the interpreter.
    Py_BEGIN_ALLOW_THREADS
    cb(lvl, logger, msg, user);
    Py_END_ALLOW_THREADS
  }
  Py_RETURN_NONE;
}

PyMethodDef g_log_def = {"iht_log_trampoline", LogTrampoline, METH_VARARGS,
                         nullptr};

}  // namespace

extern "C" {

IHT_Status IHT_SetLogLevel(const char* level) {
  if (level == nullptr) return IHT_ERR_INVALID_ARG;
  Gil gil;
  PyObject* mod = PyImport_ImportModule("ice_halo_sim_tpu_torch.utils.log");
  if (mod == nullptr) {
    SetError(FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  PyObject* text = PyUnicode_FromString(level);
  PyObject* args = PyTuple_Pack(1, text);
  PyObject* res = CallMethod(mod, "set_log_level", args);
  Py_DECREF(args);
  Py_DECREF(text);
  Py_DECREF(mod);
  if (res == nullptr) {
    SetError(FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  Py_DECREF(res);
  return IHT_OK;
}

IHT_Status IHT_SetLogCallback(IHT_LogCallback cb, void* user) {
  Gil gil;
  PyObject* mod = PyImport_ImportModule("ice_halo_sim_tpu_torch.utils.log");
  if (mod == nullptr) {
    SetError(FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  g_log_cb.store(cb);
  g_log_user.store(user);
  PyObject* fn;
  if (cb != nullptr) {
    fn = PyCFunction_New(&g_log_def, nullptr);
  } else {
    fn = Py_NewRef(Py_None);
  }
  PyObject* args = PyTuple_Pack(1, fn);
  PyObject* res = CallMethod(mod, "set_log_callback", args);
  Py_DECREF(args);
  Py_DECREF(fn);
  Py_DECREF(mod);
  if (res == nullptr) {
    SetError(FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  Py_DECREF(res);
  return IHT_OK;
}

// ---- geometry introspection ---------------------------------------------------

IHT_Status IHT_GetCrystalMesh(const char* crystal_json, float* vertices,
                              size_t vertex_cap_floats, int* out_n_vertices,
                              int* triangles, size_t triangle_cap_ints,
                              int* out_n_triangles) {
  if (crystal_json == nullptr) return IHT_ERR_INVALID_ARG;
  Gil gil;
  PyObject* mod = PyImport_ImportModule("ice_halo_sim_tpu_torch.core.mesh");
  if (mod == nullptr) {
    SetError(FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  PyObject* text = PyUnicode_FromString(crystal_json);
  PyObject* args = PyTuple_Pack(1, text);
  PyObject* mesh = CallMethod(mod, "crystal_mesh_from_json", args);
  Py_DECREF(args);
  Py_DECREF(text);
  Py_DECREF(mod);
  if (mesh == nullptr) {
    SetError("crystal mesh failed: " + FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  PyObject* v = PyObject_GetAttrString(mesh, "vertices");
  PyObject* t = PyObject_GetAttrString(mesh, "triangles");
  std::vector<float> vbuf;
  std::vector<int> tbuf;
  bool ok = v != nullptr && t != nullptr && CopyArray(v, &vbuf) &&
            CopyArray(t, &tbuf);
  Py_XDECREF(v);
  Py_XDECREF(t);
  Py_DECREF(mesh);
  if (!ok) {
    SetError("mesh extraction failed: " + FetchPyError());
    return IHT_ERR_RUNTIME;
  }
  int nv = static_cast<int>(vbuf.size() / 3);
  int nt = static_cast<int>(tbuf.size() / 3);
  if (out_n_vertices != nullptr) *out_n_vertices = nv;
  if (out_n_triangles != nullptr) *out_n_triangles = nt;
  IHT_Status st = IHT_OK;
  if (vertices != nullptr) {
    if (vertex_cap_floats < vbuf.size()) {
      st = IHT_ERR_BUFFER_TOO_SMALL;
    } else {
      std::memcpy(vertices, vbuf.data(), vbuf.size() * sizeof(float));
    }
  }
  if (triangles != nullptr) {
    if (triangle_cap_ints < tbuf.size()) {
      st = IHT_ERR_BUFFER_TOO_SMALL;
    } else {
      std::memcpy(triangles, tbuf.data(), tbuf.size() * sizeof(int));
    }
  }
  return st;
}

// ---- validation helpers (pure C++, no Python) ------------------------------

int IHT_IsLegalFace(IHT_CrystalKind kind, int face) {
  // Legal sets (reference crystal.cpp:35-56): basal 1-2, prism lateral 3-8,
  // upper pyramid 13-18, lower pyramid 23-28.
  bool basal = face == 1 || face == 2;
  bool lateral = face >= 3 && face <= 8;
  bool upper = face >= 13 && face <= 18;
  bool lower = face >= 23 && face <= 28;
  switch (kind) {
    case IHT_CRYSTAL_PRISM:
      return (basal || lateral) ? 1 : 0;
    case IHT_CRYSTAL_PYRAMID:
      return (basal || lateral || upper || lower) ? 1 : 0;
  }
  return 0;
}

int IHT_ValidateRaypathText(const char* text, int kind) {
  if (text == nullptr) return IHT_RAYPATH_INVALID;
  // Tokenize on '-' and ','; mirror config/validation.py rules.
  std::vector<std::string> tokens;
  std::string cur;
  for (const char* p = text; *p != '\0'; ++p) {
    if (*p == '-' || *p == ',') {
      tokens.push_back(cur);
      cur.clear();
    } else if (*p != ' ') {
      cur += *p;
    }
  }
  tokens.push_back(cur);
  if (tokens.size() == 1 && tokens[0].empty()) return IHT_RAYPATH_VALID;
  for (size_t i = 1; i + 1 < tokens.size(); ++i) {
    if (tokens[i].empty()) return IHT_RAYPATH_INVALID;
  }
  if (tokens.size() >= 2 && tokens.front().empty() && tokens.back().empty()) {
    return IHT_RAYPATH_INVALID;
  }
  for (const auto& t : tokens) {
    for (char c : t) {
      if (c < '0' || c > '9') return IHT_RAYPATH_INVALID;
    }
  }
  if (tokens.back().empty() || tokens.front().empty()) {
    return IHT_RAYPATH_INCOMPLETE;
  }
  if (kind >= 0) {
    for (const auto& t : tokens) {
      int face = std::atoi(t.c_str());
      if (IHT_IsLegalFace(static_cast<IHT_CrystalKind>(kind), face) == 0) {
        return IHT_RAYPATH_INVALID;
      }
    }
  }
  return IHT_RAYPATH_VALID;
}

int IHT_IsShapeScalarApplicable(IHT_CrystalKind kind, int slot) {
  // Unified 10-slot map (reference crystal_config.hpp:32-41): 0 = prism
  // height, 1-3 = pyramid upper_h/prism_h/lower_h, 4-9 = face distances.
  if (slot < 0 || slot >= 10) return 0;
  if (slot >= 4) return 1;  // face distances: both kinds
  switch (kind) {
    case IHT_CRYSTAL_PRISM:
      return slot == 0 ? 1 : 0;
    case IHT_CRYSTAL_PYRAMID:
      return slot >= 1 && slot <= 3 ? 1 : 0;
  }
  return 0;
}

const char* IHT_ShapeScalarSyncKeyName(IHT_CrystalKind kind, int slot) {
  if (IHT_IsShapeScalarApplicable(kind, slot) == 0) return nullptr;
  switch (slot) {
    case 0: return "height";
    case 1: return "upper_h";
    case 2: return "prism_h";
    case 3: return "lower_h";
    default: return "face_distance";
  }
}

}  // extern "C"
