// P3: the cache probe's decoy kernel, for Hopper.
//
// Replaces the Pallas kernel scripts/cache_probe.py::_decoy (:102,
// pallas_call :112): out = 2 x + 1 over a (128, 128) float32 array held in
// VMEM.  JAX's probe only lowers it, to disturb the process's trace context
// before its context-B lowerings; the port's probe
// (scripts/cache_probe.py) builds and launches it before its round B of
// nvcc builds, and holds it against its plain version, x * 2 + 1, bit for
// bit (2 x is exact, so one rounding either way).
//
// Design: one thread per element, 256 a block.  Bound: the bytes, 128 x
// 128 x 4 read and as many written (131 KB: 0.04 us at 3.35 TB/s); one
// launch's overhead is far above that.
//
// Interface: plain C, built by nvcc into a shared library and called
// through ctypes (ops/_build.py).  The caller allocates everything.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
decoy_kernel(const float* __restrict__ x, float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] * 2.0f + 1.0f;
}

}  // namespace

extern "C" {

// out = 2 x + 1 over n floats on `stream`; returns cudaGetLastError().
int p3_decoy(const float* x, float* out, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  decoy_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
