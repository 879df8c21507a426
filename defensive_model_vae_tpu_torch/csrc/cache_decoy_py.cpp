// P3's launch as a CPython function, for ops/cache_decoy.py.
//
// P3 is bound by the host work around its launch (csrc/cache_decoy.cu),
// and ctypes' argument conversion was a measurable share of that work
// (PERF.md, section 6).  So the library of P3 also holds this small CPython
// module: launch(x_ptr, out_ptr, n, stream) -> p3_decoy's return code,
// taking its four Python ints through METH_FASTCALL.  It needs Python's
// headers (no PyTorch headers), so it builds in seconds like the rest;
// ops/_build.py adds their directory (named by the Python version) for
// this object only, and the library's key hashes it with the flags.

#include <Python.h>

extern "C" int p3_decoy(const float* x, float* out, long long n, void* stream);

namespace {

PyObject* launch(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 4) {
    PyErr_SetString(PyExc_TypeError, "launch(x_ptr, out_ptr, n, stream)");
    return nullptr;
  }
  void* x = PyLong_AsVoidPtr(args[0]);
  void* out = PyLong_AsVoidPtr(args[1]);
  const long long n = PyLong_AsLongLong(args[2]);
  void* stream = PyLong_AsVoidPtr(args[3]);
  if (PyErr_Occurred()) return nullptr;
  return PyLong_FromLong(p3_decoy(static_cast<const float*>(x), static_cast<float*>(out), n,
                                  stream));
}

PyMethodDef methods[] = {
    {"launch", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(launch)),
     METH_FASTCALL, "P3: out = 2 x + 1 over n floats on stream; returns the CUDA error."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "cache_decoy_ext", nullptr, -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit_cache_decoy_ext() { return PyModule_Create(&module); }
