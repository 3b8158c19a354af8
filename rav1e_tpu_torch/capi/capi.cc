// C ABI for rav1e_tpu_torch, the PyTorch port (include/rav1e_tpu.h) —
// counterpart of the reference's src/capi.rs.  Embeds CPython and marshals
// through rav1e_tpu_torch/capi_glue.py, keeping this layer mechanical.  A
// copy of native/capi.cc that imports the port's glue: it exports the same
// rav1e_* symbols, so one C program links against either shim.
//
// Build (from the repository root):
//   mkdir -p build/rav1e_tpu_torch
//   g++ -O2 -shared -fPIC rav1e_tpu_torch/capi/capi.cc \
//       $(python3-config --includes) $(python3-config --ldflags --embed) \
//       -o build/rav1e_tpu_torch/librav1e_tpu_torch_capi.so

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdlib>
#include <cstring>

#include "../../include/rav1e_tpu.h"

namespace {

PyObject *g_glue = nullptr;

bool ensure_init() {
  if (g_glue) return true;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
  }
  PyGILState_STATE st = PyGILState_Ensure();
  g_glue = PyImport_ImportModule("rav1e_tpu_torch.capi_glue");
  if (!g_glue) PyErr_Print();
  PyGILState_Release(st);
  return g_glue != nullptr;
}

struct PyHolder {
  PyObject *obj;
};

}  // namespace

struct RaConfig {
  PyObject *dict;
};
struct RaContext {
  PyObject *ctx;
};
struct RaFrame {
  PyObject *frame;
};

extern "C" {

RaConfig *rav1e_config_default(void) {
  if (!ensure_init()) return nullptr;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject *d = PyObject_CallMethod(g_glue, "config_new", nullptr);
  PyGILState_Release(st);
  if (!d) return nullptr;
  RaConfig *c = new RaConfig{d};
  return c;
}

int rav1e_config_parse(RaConfig *cfg, const char *key, const char *value) {
  if (!cfg) return RA_ENCODER_STATUS_FAILURE;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject *r =
      PyObject_CallMethod(g_glue, "config_set", "Oss", cfg->dict, key, value);
  int ret = RA_ENCODER_STATUS_FAILURE;
  if (r) {
    ret = (int)PyLong_AsLong(r);
    Py_DECREF(r);
  } else {
    PyErr_Print();
  }
  PyGILState_Release(st);
  return ret;
}

int rav1e_config_parse_int(RaConfig *cfg, const char *key, int value) {
  char buf[32];
  snprintf(buf, sizeof(buf), "%d", value);
  return rav1e_config_parse(cfg, key, buf);
}

void rav1e_config_unref(RaConfig *cfg) {
  if (!cfg) return;
  PyGILState_STATE st = PyGILState_Ensure();
  Py_XDECREF(cfg->dict);
  PyGILState_Release(st);
  delete cfg;
}

RaContext *rav1e_context_new(const RaConfig *cfg) {
  if (!cfg) return nullptr;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject *c = PyObject_CallMethod(g_glue, "context_new", "O", cfg->dict);
  if (!c) PyErr_Print();
  PyGILState_Release(st);
  if (!c) return nullptr;
  return new RaContext{c};
}

void rav1e_context_unref(RaContext *ctx) {
  if (!ctx) return;
  PyGILState_STATE st = PyGILState_Ensure();
  Py_XDECREF(ctx->ctx);
  PyGILState_Release(st);
  delete ctx;
}

RaFrame *rav1e_frame_new(RaContext *ctx) {
  if (!ctx) return nullptr;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject *f = PyObject_CallMethod(g_glue, "frame_new", "O", ctx->ctx);
  if (!f) PyErr_Print();
  PyGILState_Release(st);
  if (!f) return nullptr;
  return new RaFrame{f};
}

int rav1e_frame_fill_plane(RaFrame *frame, int plane, const uint8_t *data,
                           size_t len, ptrdiff_t stride, int bytewidth) {
  if (!frame) return RA_ENCODER_STATUS_FAILURE;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject *bytes = PyBytes_FromStringAndSize((const char *)data, (Py_ssize_t)len);
  PyObject *r = PyObject_CallMethod(g_glue, "frame_fill_plane", "OiOni",
                                    frame->frame, plane, bytes, (Py_ssize_t)stride,
                                    bytewidth);
  int ret = RA_ENCODER_STATUS_FAILURE;
  if (r) {
    ret = (int)PyLong_AsLong(r);
    Py_DECREF(r);
  } else {
    PyErr_Print();
  }
  Py_XDECREF(bytes);
  PyGILState_Release(st);
  return ret;
}

void rav1e_frame_unref(RaFrame *frame) {
  if (!frame) return;
  PyGILState_STATE st = PyGILState_Ensure();
  Py_XDECREF(frame->frame);
  PyGILState_Release(st);
  delete frame;
}

int rav1e_send_frame(RaContext *ctx, RaFrame *frame) {
  if (!ctx) return RA_ENCODER_STATUS_FAILURE;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject *arg = frame ? frame->frame : Py_None;
  PyObject *r = PyObject_CallMethod(g_glue, "send_frame", "OO", ctx->ctx, arg);
  int ret = RA_ENCODER_STATUS_FAILURE;
  if (r) {
    ret = (int)PyLong_AsLong(r);
    Py_DECREF(r);
  } else {
    PyErr_Print();
  }
  PyGILState_Release(st);
  return ret;
}

int rav1e_receive_packet(RaContext *ctx, RaPacket **packet) {
  if (!ctx || !packet) return RA_ENCODER_STATUS_FAILURE;
  *packet = nullptr;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject *r = PyObject_CallMethod(g_glue, "receive_packet", "O", ctx->ctx);
  int ret = RA_ENCODER_STATUS_FAILURE;
  if (r && PyTuple_Check(r) && PyTuple_Size(r) == 4) {
    ret = (int)PyLong_AsLong(PyTuple_GetItem(r, 0));
    if (ret == RA_ENCODER_STATUS_SUCCESS) {
      PyObject *data = PyTuple_GetItem(r, 1);
      Py_ssize_t n = PyBytes_Size(data);
      uint8_t *copy = (uint8_t *)malloc((size_t)n);
      memcpy(copy, PyBytes_AsString(data), (size_t)n);
      RaPacket *pkt = (RaPacket *)malloc(sizeof(RaPacket));
      pkt->data = copy;
      pkt->len = (size_t)n;
      pkt->input_frameno =
          (uint64_t)PyLong_AsUnsignedLongLong(PyTuple_GetItem(r, 2));
      pkt->frame_type = (int)PyLong_AsLong(PyTuple_GetItem(r, 3));
      *packet = pkt;
    }
  } else if (!r) {
    PyErr_Print();
  }
  Py_XDECREF(r);
  PyGILState_Release(st);
  return ret;
}

void rav1e_packet_unref(RaPacket *packet) {
  if (!packet) return;
  free((void *)packet->data);
  free(packet);
}

const char *rav1e_version_short(void) { return "rav1e-tpu 0.1"; }

}  // extern "C"
