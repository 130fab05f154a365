// The C API of the PyTorch/CUDA port (counterpart:
// flexflow_tpu/capi/flexflow_c.cc): embeds CPython and drives
// flexflow_tpu_torch (see flexflow_c.h; reference analog
// src/c/flexflow_c.cc). It imports flexflow_tpu_torch and nothing of JAX.
//
// Build (python -m flexflow_tpu_torch.capi.build):
//   c++ -O2 -shared -fPIC -std=c++17 flexflow_c.cc \
//       -I$(python3 -c 'import sysconfig; print(sysconfig.get_paths()["include"])') \
//       -L$LIBDIR -lpython3.12 -o libflexflow_tpu_torch_c.so

#include "flexflow_c.h"

#include <Python.h>

#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>

namespace {

std::string g_error;
std::unordered_map<int64_t, PyObject*> g_models;    // FFModel objects
std::unordered_map<int64_t, PyObject*> g_tensors;   // Tensor objects
int64_t g_next_handle = 1;
PyObject* g_config = nullptr;  // FFConfig from flexflow_init argv

// Every public entry point holds the GIL for its duration: the host may
// have initialized CPython itself and released the GIL (PyEval_SaveThread),
// or may call from a non-Python thread — both are fatal without this.
struct Gil {
  PyGILState_STATE s;
  Gil() : s(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(s); }
};

int fail(const char* where) {
  std::string msg = where;
  if (PyErr_Occurred()) {
    PyObject *type, *value, *tb;
    PyErr_Fetch(&type, &value, &tb);
    PyObject* s = value ? PyObject_Str(value) : nullptr;
    if (s) {
      msg += ": ";
      msg += PyUnicode_AsUTF8(s);
      Py_DECREF(s);
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
  }
  g_error = msg;
  return 1;
}

int64_t store(std::unordered_map<int64_t, PyObject*>& m, PyObject* obj) {
  const int64_t h = g_next_handle++;
  m[h] = obj;  // steals the reference
  return h;
}

PyObject* get(std::unordered_map<int64_t, PyObject*>& m, int64_t h) {
  auto it = m.find(h);
  return it == m.end() ? nullptr : it->second;
}

// numpy array from a C buffer: np.frombuffer(bytes, dtype).reshape(dims).copy()
PyObject* np_from_buffer(const void* data, const int64_t* dims, int ndims,
                         const char* dtype, size_t itemsize) {
  size_t n = 1;
  for (int i = 0; i < ndims; ++i) n *= static_cast<size_t>(dims[i]);
  PyObject* np = PyImport_ImportModule("numpy");
  if (!np) return nullptr;
  PyObject* bytes = PyBytes_FromStringAndSize(
      static_cast<const char*>(data), static_cast<Py_ssize_t>(n * itemsize));
  PyObject* flat = bytes ? PyObject_CallMethod(np, "frombuffer", "Os", bytes,
                                               dtype)
                         : nullptr;
  Py_XDECREF(bytes);
  PyObject* shape = nullptr;
  PyObject* out = nullptr;
  if (flat) {
    shape = PyTuple_New(ndims);
    for (int i = 0; i < ndims; ++i)
      PyTuple_SET_ITEM(shape, i, PyLong_FromLongLong(dims[i]));
    PyObject* reshaped = PyObject_CallMethod(flat, "reshape", "O", shape);
    if (reshaped) {
      out = PyObject_CallMethod(reshaped, "copy", nullptr);
      Py_DECREF(reshaped);
    }
  }
  Py_XDECREF(flat);
  Py_XDECREF(shape);
  Py_DECREF(np);
  return out;
}

// calls m.method(t, name=name) via kwargs so positional signatures with
// extra parameters (softmax's axis, embedding's dims) can't be miskeyed
int unary_builder(ff_model_t model, const char* method, ff_tensor_t input,
                  const char* name, ff_tensor_t* out) {
  PyObject* m = get(g_models, model);
  PyObject* t = get(g_tensors, input);
  if (!m || !t) {
    g_error = "bad handle";
    return 1;
  }
  PyObject* fn = PyObject_GetAttrString(m, method);
  if (!fn) return fail(method);
  PyObject* args = Py_BuildValue("(O)", t);
  PyObject* kwargs = Py_BuildValue("{s:s}", "name", name ? name : "");
  PyObject* r = (args && kwargs) ? PyObject_Call(fn, args, kwargs) : nullptr;
  Py_XDECREF(args);
  Py_XDECREF(kwargs);
  Py_DECREF(fn);
  if (!r) return fail(method);
  *out = store(g_tensors, r);
  return 0;
}

}  // namespace

extern "C" {

const char* flexflow_last_error(void) { return g_error.c_str(); }

static int init_impl(int argc, const char** argv) {
  // FLEXFLOW_PLATFORM=cpu asks for the CPU (as the launcher takes it);
  // otherwise the model runs on the GPU, and compile raises without one
  const char* plat = std::getenv("FLEXFLOW_PLATFORM");
  if (plat && *plat) {
    PyObject* dev = PyImport_ImportModule("flexflow_tpu_torch.device");
    if (!dev) return fail("import flexflow_tpu_torch.device");
    PyObject* r = PyObject_CallMethod(dev, "set_default_device", "s", plat);
    Py_DECREF(dev);
    if (!r) return fail("FLEXFLOW_PLATFORM");
    Py_DECREF(r);
  }
  PyObject* mod = PyImport_ImportModule("flexflow_tpu_torch");
  if (!mod) return fail("import flexflow_tpu_torch");
  PyObject* cfg_cls = PyObject_GetAttrString(mod, "FFConfig");
  Py_DECREF(mod);
  if (!cfg_cls) return fail("FFConfig");
  PyObject* args = PyList_New(argc);
  for (int i = 0; i < argc; ++i)
    PyList_SET_ITEM(args, i, PyUnicode_FromString(argv[i]));
  PyObject* cfg = PyObject_CallMethod(cfg_cls, "parse_args", "O", args);
  Py_DECREF(args);
  Py_DECREF(cfg_cls);
  if (!cfg) return fail("parse_args");
  Py_XDECREF(g_config);
  g_config = cfg;
  return 0;
}

int flexflow_init(int argc, const char** argv) {
  bool created = false;
  if (!Py_IsInitialized()) {
    Py_Initialize();
    created = true;
  }
  int rc;
  {
    Gil gil;
    rc = init_impl(argc, argv);
  }
  // when WE created the interpreter this thread still holds the main-state
  // GIL from Py_Initialize; release it so every later entry point's
  // PyGILState_Ensure/Release pairs cleanly (and other host threads can
  // call in)
  if (created) PyEval_SaveThread();
  return rc;
}

void flexflow_finalize(void) {
  Gil gil;
  for (auto& kv : g_tensors) Py_XDECREF(kv.second);
  for (auto& kv : g_models) Py_XDECREF(kv.second);
  g_tensors.clear();
  g_models.clear();
  Py_XDECREF(g_config);
  g_config = nullptr;
  // the port's fit-end bookkeeping (flexflow_tpu_torch.capi.on_finalize:
  // the kernels' launch counts, when FLEXFLOW_CAPI_LAUNCH_COUNTS names a
  // file); the interpreter stays alive, its teardown is left to exit
  PyObject* capi = PyImport_ImportModule("flexflow_tpu_torch.capi");
  PyObject* r = capi ? PyObject_CallMethod(capi, "on_finalize", nullptr)
                     : nullptr;
  Py_XDECREF(r);
  Py_XDECREF(capi);
  if (PyErr_Occurred()) {
    fail("on_finalize");
    std::fprintf(stderr, "flexflow_finalize: %s\n", g_error.c_str());
  }
}

int flexflow_model_create(ff_model_t* out) {
  Gil gil;
  PyObject* mod = PyImport_ImportModule("flexflow_tpu_torch");
  if (!mod) return fail("import flexflow_tpu_torch");
  PyObject* cls = PyObject_GetAttrString(mod, "FFModel");
  Py_DECREF(mod);
  if (!cls) return fail("FFModel");
  PyObject* m = g_config ? PyObject_CallFunction(cls, "O", g_config)
                         : PyObject_CallFunction(cls, nullptr);
  Py_DECREF(cls);
  if (!m) return fail("FFModel()");
  *out = store(g_models, m);
  return 0;
}

void flexflow_model_destroy(ff_model_t model) {
  Gil gil;
  auto it = g_models.find(model);
  if (it != g_models.end()) {
    Py_XDECREF(it->second);
    g_models.erase(it);
  }
}

int flexflow_tensor_create(ff_model_t model, int ndims, const int64_t* dims,
                           const char* dtype, const char* name,
                           ff_tensor_t* out) {
  Gil gil;
  PyObject* m = get(g_models, model);
  if (!m) {
    g_error = "bad model handle";
    return 1;
  }
  PyObject* shape = PyList_New(ndims);
  for (int i = 0; i < ndims; ++i)
    PyList_SET_ITEM(shape, i, PyLong_FromLongLong(dims[i]));
  PyObject* t = PyObject_CallMethod(m, "create_tensor", "Oss", shape,
                                    dtype ? dtype : "float32",
                                    name ? name : "");
  Py_DECREF(shape);
  if (!t) return fail("create_tensor");
  *out = store(g_tensors, t);
  return 0;
}

int flexflow_dense(ff_model_t model, ff_tensor_t input, int64_t out_dim,
                   const char* activation, int use_bias, const char* name,
                   ff_tensor_t* out) {
  Gil gil;
  PyObject* m = get(g_models, model);
  PyObject* t = get(g_tensors, input);
  if (!m || !t) {
    g_error = "bad handle";
    return 1;
  }
  PyObject* fn = PyObject_GetAttrString(m, "dense");
  if (!fn) return fail("dense attr");
  PyObject* args = Py_BuildValue("(OL)", t, static_cast<long long>(out_dim));
  PyObject* kwargs = Py_BuildValue("{s:i,s:s}", "use_bias", use_bias,
                                   "name", name ? name : "");
  if (kwargs) {
    if (activation) {
      PyObject* a = PyUnicode_FromString(activation);
      PyDict_SetItemString(kwargs, "activation", a);
      Py_DECREF(a);
    } else {
      PyDict_SetItemString(kwargs, "activation", Py_None);
    }
  }
  PyObject* r = (args && kwargs) ? PyObject_Call(fn, args, kwargs) : nullptr;
  Py_XDECREF(args);
  Py_XDECREF(kwargs);
  Py_DECREF(fn);
  if (!r) return fail("dense");
  *out = store(g_tensors, r);
  return 0;
}

int flexflow_conv2d(ff_model_t model, ff_tensor_t input, int out_channels,
                    int kernel_h, int kernel_w, int stride_h, int stride_w,
                    int padding_h, int padding_w, const char* activation,
                    int use_bias, const char* name, ff_tensor_t* out) {
  Gil gil;
  PyObject* m = get(g_models, model);
  PyObject* t = get(g_tensors, input);
  if (!m || !t) {
    g_error = "bad handle";
    return 1;
  }
  PyObject* act = activation ? PyUnicode_FromString(activation)
                             : (Py_INCREF(Py_None), Py_None);
  PyObject* r = PyObject_CallMethod(
      m, "conv2d", "OiiiiiiiOiiOOs", t, out_channels, kernel_h, kernel_w,
      stride_h, stride_w, padding_h, padding_w, act, 1, use_bias, Py_None,
      Py_None, name ? name : "");
  Py_DECREF(act);
  if (!r) return fail("conv2d");
  *out = store(g_tensors, r);
  return 0;
}

int flexflow_pool2d(ff_model_t model, ff_tensor_t input, int kernel_h,
                    int kernel_w, int stride_h, int stride_w, int padding_h,
                    int padding_w, const char* pool_type, const char* name,
                    ff_tensor_t* out) {
  Gil gil;
  PyObject* m = get(g_models, model);
  PyObject* t = get(g_tensors, input);
  if (!m || !t) {
    g_error = "bad handle";
    return 1;
  }
  PyObject* r = PyObject_CallMethod(m, "pool2d", "OiiiiiisOs", t, kernel_h,
                                    kernel_w, stride_h, stride_w, padding_h,
                                    padding_w, pool_type ? pool_type : "max",
                                    Py_None, name ? name : "");
  if (!r) return fail("pool2d");
  *out = store(g_tensors, r);
  return 0;
}

int flexflow_embedding(ff_model_t model, ff_tensor_t input,
                       int64_t num_entries, int64_t out_dim, const char* name,
                       ff_tensor_t* out) {
  Gil gil;
  PyObject* m = get(g_models, model);
  PyObject* t = get(g_tensors, input);
  if (!m || !t) {
    g_error = "bad handle";
    return 1;
  }
  PyObject* fn = PyObject_GetAttrString(m, "embedding");
  if (!fn) return fail("embedding attr");
  PyObject* args = Py_BuildValue("(OLL)", t, static_cast<long long>(num_entries),
                                 static_cast<long long>(out_dim));
  PyObject* kwargs = Py_BuildValue("{s:s}", "name", name ? name : "");
  PyObject* r = (args && kwargs) ? PyObject_Call(fn, args, kwargs) : nullptr;
  Py_XDECREF(args);
  Py_XDECREF(kwargs);
  Py_DECREF(fn);
  if (!r) return fail("embedding");
  *out = store(g_tensors, r);
  return 0;
}

int flexflow_relu(ff_model_t model, ff_tensor_t input, const char* name,
                  ff_tensor_t* out) {
  Gil gil;
  return unary_builder(model, "relu", input, name, out);
}

int flexflow_flat(ff_model_t model, ff_tensor_t input, const char* name,
                  ff_tensor_t* out) {
  Gil gil;
  return unary_builder(model, "flat", input, name, out);
}

int flexflow_softmax(ff_model_t model, ff_tensor_t input, const char* name,
                     ff_tensor_t* out) {
  Gil gil;
  return unary_builder(model, "softmax", input, name, out);
}

int flexflow_add(ff_model_t model, ff_tensor_t a, ff_tensor_t b,
                 const char* name, ff_tensor_t* out) {
  Gil gil;
  PyObject* m = get(g_models, model);
  PyObject* ta = get(g_tensors, a);
  PyObject* tb = get(g_tensors, b);
  if (!m || !ta || !tb) {
    g_error = "bad handle";
    return 1;
  }
  PyObject* r = PyObject_CallMethod(m, "add", "OOs", ta, tb, name ? name : "");
  if (!r) return fail("add");
  *out = store(g_tensors, r);
  return 0;
}

int flexflow_model_compile(ff_model_t model, const char* optimizer, double lr,
                           const char* loss) {
  Gil gil;
  PyObject* m = get(g_models, model);
  if (!m) {
    g_error = "bad model handle";
    return 1;
  }
  PyObject* mod = PyImport_ImportModule("flexflow_tpu_torch");
  if (!mod) return fail("import flexflow_tpu_torch");
  const char* cls_name =
      (optimizer && std::strcmp(optimizer, "adam") == 0) ? "AdamOptimizer"
                                                         : "SGDOptimizer";
  PyObject* cls = PyObject_GetAttrString(mod, cls_name);
  Py_DECREF(mod);
  if (!cls) return fail("optimizer class");
  PyObject* opt = PyObject_CallFunction(cls, nullptr);  // defaults; lr below
  Py_DECREF(cls);
  if (!opt) return fail("optimizer()");
  if (lr > 0) {
    PyObject* lr_obj = PyFloat_FromDouble(lr);
    // SGD uses .lr, Adam uses .alpha — set whichever exists
    if (PyObject_HasAttrString(opt, "lr"))
      PyObject_SetAttrString(opt, "lr", lr_obj);
    if (PyObject_HasAttrString(opt, "alpha"))
      PyObject_SetAttrString(opt, "alpha", lr_obj);
    Py_DECREF(lr_obj);
  }
  PyObject* empty_metrics = PyList_New(0);
  PyObject* r = PyObject_CallMethod(m, "compile", "OsO", opt,
                                    loss ? loss
                                         : "sparse_categorical_crossentropy",
                                    empty_metrics);
  Py_DECREF(opt);
  Py_DECREF(empty_metrics);
  if (!r) return fail("compile");
  Py_DECREF(r);
  return 0;
}

int flexflow_model_fit_f32(ff_model_t model, const float* x,
                           const int64_t* x_dims, int x_ndims, const void* y,
                           const int64_t* y_dims, int y_ndims,
                           const char* y_dtype, int epochs,
                           double* final_loss) {
  Gil gil;
  PyObject* m = get(g_models, model);
  if (!m) {
    g_error = "bad model handle";
    return 1;
  }
  PyObject* xa = np_from_buffer(x, x_dims, x_ndims, "float32", 4);
  if (!xa) return fail("x array");
  const char* ydt = y_dtype ? y_dtype : "int32";
  const size_t ysz = (std::strcmp(ydt, "int64") == 0 ||
                      std::strcmp(ydt, "float64") == 0)
                         ? 8
                         : 4;
  PyObject* ya = np_from_buffer(y, y_dims, y_ndims, ydt, ysz);
  if (!ya) {
    Py_DECREF(xa);
    return fail("y array");
  }
  PyObject* kwargs = Py_BuildValue("{s:i,s:O}", "epochs", epochs, "verbose",
                                   Py_False);
  PyObject* args = Py_BuildValue("(OO)", xa, ya);
  PyObject* fit = PyObject_GetAttrString(m, "fit");
  PyObject* hist = fit ? PyObject_Call(fit, args, kwargs) : nullptr;
  Py_XDECREF(fit);
  Py_DECREF(args);
  Py_DECREF(kwargs);
  Py_DECREF(xa);
  Py_DECREF(ya);
  if (!hist) return fail("fit");
  double loss = 0.0;
  if (PyList_Check(hist) && PyList_Size(hist) > 0) {
    PyObject* last = PyList_GetItem(hist, PyList_Size(hist) - 1);
    PyObject* l = PyMapping_GetItemString(last, "loss");
    if (l) {
      loss = PyFloat_AsDouble(l);
      Py_DECREF(l);
    }
  }
  Py_DECREF(hist);
  if (PyErr_Occurred()) return fail("fit history");
  if (final_loss) *final_loss = loss;
  return 0;
}

int flexflow_model_forward_f32(ff_model_t model, const float* x,
                               const int64_t* x_dims, int x_ndims, float* out,
                               int64_t* out_dims, int* out_ndims) {
  Gil gil;
  PyObject* m = get(g_models, model);
  if (!m) {
    g_error = "bad model handle";
    return 1;
  }
  PyObject* xa = np_from_buffer(x, x_dims, x_ndims, "float32", 4);
  if (!xa) return fail("x array");
  PyObject* r = PyObject_CallMethod(m, "forward", "O", xa);
  Py_DECREF(xa);
  if (!r) return fail("forward");
  // the output is a tensor on the model's device: copied to a host f32
  // array by flexflow_tpu_torch.capi.host_f32
  PyObject* capi = PyImport_ImportModule("flexflow_tpu_torch.capi");
  PyObject* arr = capi ? PyObject_CallMethod(capi, "host_f32", "O", r)
                       : nullptr;
  Py_XDECREF(capi);
  Py_DECREF(r);
  if (!arr) return fail("forward->host");
  PyObject* shape = PyObject_GetAttrString(arr, "shape");
  const int nd = static_cast<int>(PyTuple_Size(shape));
  if (nd > 8) {
    Py_DECREF(shape);
    Py_DECREF(arr);
    g_error = "forward output has more than 8 dims";
    return 1;
  }
  size_t n = 1;
  for (int i = 0; i < nd; ++i) {
    out_dims[i] = PyLong_AsLongLong(PyTuple_GetItem(shape, i));
    n *= static_cast<size_t>(out_dims[i]);
  }
  *out_ndims = nd;
  Py_DECREF(shape);
  PyObject* bytes = PyObject_CallMethod(arr, "tobytes", nullptr);
  Py_DECREF(arr);
  if (!bytes) return fail("tobytes");
  std::memcpy(out, PyBytes_AsString(bytes), n * sizeof(float));
  Py_DECREF(bytes);
  return 0;
}

}  // extern "C"
