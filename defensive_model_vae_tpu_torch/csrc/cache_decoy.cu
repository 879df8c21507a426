// P3: the cache probe's decoy kernel, for Hopper.
//
// Replaces the Pallas kernel scripts/cache_probe.py::_decoy (:102,
// pallas_call :112): out = 2 x + 1 over a (128, 128) float32 array held in
// VMEM.  JAX's probe only lowers it, to disturb the process's trace context
// before its context-B lowerings; the port's probe
// (scripts/cache_probe.py) builds and launches it before its round B of
// nvcc builds, and holds it against its plain version, x * 2 + 1, bit for
// bit (2 x is exact, so one rounding either way, fused or not).
//
// Bound: the bytes, 128 x 128 x 4 read and as many written (131 KB: 0.04
// us at 3.35 TB/s).  One launch's overhead is far above that, and a call
// through the wrapper is host work around the launch, so the design keeps
// both small: one launch, one 16-byte load and store a thread (4,096
// threads for the shape, 16 blocks of 256), no shared memory, no barrier.
// The n % 4 floats after the last whole vector go one a thread to the
// first threads.  When x or out is not 16-byte aligned (x a slice that
// starts inside a vector; out comes from torch.empty_like, so it always
// is), each thread takes 4 floats one at a time.
//
// Interface: plain C, built by nvcc into a shared library and called
// through ctypes (ops/_build.py).  The caller allocates everything.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float decoy(float v) { return v * 2.0f + 1.0f; }

// nvec > 0: x and out are 16-byte aligned, and a thread takes one of the
// nvec whole float4s (the first threads also one float of the tail);
// nvec == 0: a thread takes 4 floats, a grid's width apart
__global__ void __launch_bounds__(NT)
decoy_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
             long long nvec) {
  const long long g = (long long)blockIdx.x * NT + threadIdx.x;
  if (nvec == 0) {
    const long long threads = (long long)gridDim.x * NT;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long i = g + k * threads;
      if (i < n) out[i] = decoy(x[i]);
    }
    return;
  }
  if (g < nvec) {
    const float4 v = reinterpret_cast<const float4*>(x)[g];
    reinterpret_cast<float4*>(out)[g] =
        make_float4(decoy(v.x), decoy(v.y), decoy(v.z), decoy(v.w));
  }
  if (g < n - nvec * 4) out[nvec * 4 + g] = decoy(x[nvec * 4 + g]);
}

}  // namespace

extern "C" {

// out = 2 x + 1 over n floats on `stream`; returns cudaGetLastError().
int p3_decoy(const float* x, float* out, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long nvec = aligned ? n / 4 : 0;
  const long long threads = nvec ? nvec : (n + 3) / 4;
  decoy_kernel<<<(unsigned)((threads + NT - 1) / NT), NT, 0, (cudaStream_t)stream>>>(
      x, out, n, nvec);
  return (int)cudaGetLastError();
}

}  // extern "C"
