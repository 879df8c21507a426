// P1-sol: the K3 ablation's compute floor, on Hopper's tensor cores.
//
// Replaces the Pallas kernel of the JAX package's K3 ablation,
// scripts/scale_ablation.py::_make_sol_kernel (:148, pallas_call :240):
// per tile and epoch h = x W_in (bf16 operands, float32 sums), then
// n_chain products h <- bf16(h) W_chain (float32 sums, no relu), and
// sum(h) into metrics[e, 0].  "FLOP-equivalent chained matmuls ... the
// MXU+stream speed of light": its only job is to be the floor the other
// variants are read against, so it runs where the TPU kernel ran its dots,
// on the matrix unit.
//
// Bound: operations.  2 (41 x 128 + 23 x 128 x 128) = 764,160 FLOP a row
// an epoch; at the bench shape (131,072 rows x 20 epochs) 2.0 TFLOP, 2.03
// ms at 989 TFLOP/s bf16; the corpus (10.7 MB, 82 bytes a row) is read
// once an epoch from the 50 MB L2, 0.064 ms of HBM time at most.
//
// Design:
// - wgmma m64n128k16 (bf16 -> float32), A from registers, B from shared
//   memory.  W_chain (32 KB) and W_in (its rows zero-padded to 64, 16 KB)
//   are stored once per CTA, K-major ([n][k], 128 bytes of k a row) in
//   128-byte-swizzled atoms of 128 rows x 64 k, which the descriptors read.
// - The chain stays in registers: the m64n128 accumulator layout of a
//   thread (rows g and g + 8 of its warp's 16, columns 8j + 2t, +1) is the
//   A-fragment layout of the next product's k-slice j/2, so each product's
//   64 float32 accumulators are rounded to bf16 (nearest even) in pairs
//   into the 32 registers of the next product's A operand.  No h goes back
//   to shared or device memory between the 23 steps.
// - Rows: a tile of 64 rows is one contiguous range (64 x 82 bytes, 16-byte
//   aligned), brought in by 16-byte cp.async into one of two slots of its
//   warpgroup, one tile ahead; the entry product's A fragments are read
//   from the slot.  Rows past the corpus read as zeros.
// - A persistent grid (the CTAs an SM holds, p1_sol_grid), two warpgroups
//   a CTA, so one warpgroup's rounding and loads overlap another's
//   products.  One launch takes all epochs: in each, warpgroup w of G
//   takes the tiles w, w + G, ..., keeps a float32 sum per thread and
//   writes one partial (0 for a warpgroup without a tile); a one-block
//   kernel then sums each epoch's G partials in index order.  Every epoch
//   repeats the same sums in the same order, and no float is added
//   atomically, so every epoch's row, and every call on a card, has the
//   same bits.
//
// Interface: plain C, built by nvcc for sm_90a into a shared library and
// called through ctypes (ops/_build.py).  The caller allocates everything.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WG = 128;          // threads of a warpgroup
constexpr int NWG = 2;           // warpgroups of a CTA
constexpr int NT = WG * NWG;
constexpr int TM = 64;           // rows of a tile: wgmma's M
constexpr int HD = 128;          // the hidden width: N, and the chain's K
constexpr int KIN = 64;          // the entry product's K, padded: one atom
constexpr int ATOM = HD * 128;   // bytes of a K-major atom: 128 rows x 64 bf16
constexpr int RED_BYTES = 64;    // per-warpgroup warp sums (4 floats each)
constexpr int ROWS_NT = 256;     // threads of the partials' sum

long long g_launches;            // CUDA launches issued by p1_sol

// bytes of a slot: a tile's rows, rounded up to 16
__host__ __device__ int slot_bytes(int width) { return (TM * width * 2 + 15) / 16 * 16; }

int smem_bytes(int width) {
  return 1024 + 3 * ATOM + NWG * 2 * slot_bytes(width) + NWG * RED_BYTES;
}

// ---- device-only helpers ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a wgmma descriptor of a K-major operand in 128-byte-swizzled atoms: start
// address, leading offset 16 bytes (unused by this layout), stride 1024
// bytes between groups of 8 rows, layout 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// element (k, n) of a K-major operand: atom k / 64, row n, the 16-byte
// chunk (k % 64) / 8 swizzled by n % 8
__device__ __forceinline__ int sw128_offset(int k, int n) {
  const int kk = k & 63;
  return (k >> 6) * ATOM + n * 128 + (((kk >> 3) ^ (n & 7)) << 4) + (kk & 7) * 2;
}

// d (+)= A B, m64n128k16, bf16 in, float32 out; A's fragment a0..a3 from
// registers, B by descriptor; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses of the accumulators across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the warpgroup's own barrier (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(wg + 1), "n"(WG) : "memory");
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- end of the device-only helpers ----

// start copying tile `t` (its `rows` rows of `width` bf16) into the slot
// at shared address `dst`: 16-byte cp.async, the tail (under 16 bytes) by
// plain loads and stores
__device__ __forceinline__ void load_tile(const bf16* __restrict__ packed, int width,
                                          long long t, int rows, uint32_t dst, char* dst_p,
                                          int tid) {
  const char* src = reinterpret_cast<const char*>(packed + t * TM * width);
  const int bytes = rows * width * 2;
  const int full = bytes / 16;
  for (int c = tid; c < full; c += WG) cp_async16(dst + c * 16, src + c * 16);
  for (int b = full * 16 + 2 * tid; b < bytes; b += 2 * WG)
    *reinterpret_cast<unsigned short*>(dst_p + b) =
        *reinterpret_cast<const unsigned short*>(src + b);
}

// the warpgroup's float32 sum of v (a shuffle tree in each warp, then the
// four warps in order) into partial[at], by its thread 0
__device__ __forceinline__ void flush(float v, float* red, int wg, int tid, float* partial,
                                      long long at) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((tid & 31) == 0) red[tid >> 5] = v;
  wg_sync(wg);
  if (tid == 0) partial[at] = (red[0] + red[1]) + (red[2] + red[3]);
  wg_sync(wg);
}

__global__ void __launch_bounds__(NT, 2)
sol_kernel(const bf16* __restrict__ packed, int width, long long n_pad,
           const bf16* __restrict__ w_in, const bf16* __restrict__ w_chain, int n_chain,
           int epochs, float* __restrict__ partial) {
  extern __shared__ unsigned char smem_raw[];
  // the atoms' base on a 1024-byte boundary (the swizzle's period)
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* wc = base;                 // W_chain: atoms k 0-63, 64-127
  unsigned char* wi = base + 2 * ATOM;      // W_in: one atom, k >= width zero
  const int sb = slot_bytes(width);
  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  unsigned char* slots = base + 3 * ATOM + wg * 2 * sb;
  float* red = reinterpret_cast<float*>(base + 3 * ATOM + NWG * 2 * sb) + wg * 4;

  for (int i = threadIdx.x; i < HD * HD; i += NT)
    *reinterpret_cast<bf16*>(wc + sw128_offset(i / HD, i % HD)) = w_chain[i];
  for (int i = threadIdx.x; i < KIN * HD; i += NT) {
    const int k = i / HD;
    *reinterpret_cast<bf16*>(wi + sw128_offset(k, i % HD)) =
        k < width ? w_in[i] : __float2bfloat16(0.f);
  }
  // the generic proxy's stores made visible to wgmma's reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const uint32_t wc_addr = smem_addr(wc), wi_addr = smem_addr(wi);
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = (tid >> 5) * 16 + g;  // this thread's rows r0 and r0 + 8
  const int kin = (width + 15) / 16;   // the entry product's k-steps
  const long long tiles = (n_pad + TM - 1) / TM;
  const long long G = (long long)gridDim.x * NWG, gw = (long long)blockIdx.x * NWG + wg;
  // this warpgroup's tiles an epoch: gw, gw + G, ...; the same in every
  // epoch, so every epoch's partials, and its total, have the same bits
  const long long nt = gw < tiles ? (tiles - 1 - gw) / G + 1 : 0, items = nt * epochs;

  float acc[64] = {};
  uint32_t a[32];
  float tsum = 0.f;
  long long cur_e = -1;

  auto tile_of = [&](long long j) { return gw + (j % nt) * G; };
  auto rows_of = [&](long long tile) {
    const long long left = n_pad - tile * TM;
    return (int)(left < TM ? left : TM);
  };
  if (items > 0) {
    const long long tile = tile_of(0);
    load_tile(packed, width, tile, rows_of(tile), smem_addr(slots), (char*)slots, tid);
  }
  cp_async_commit();
  for (long long j = 0; j < items; ++j) {
    unsigned char* slot = slots + (j & 1) * sb;
    if (j + 1 < items) {
      unsigned char* other = slots + ((j + 1) & 1) * sb;
      const long long tile = tile_of(j + 1);
      load_tile(packed, width, tile, rows_of(tile), smem_addr(other), (char*)other, tid);
    }
    cp_async_commit();
    cp_async_wait_1();
    wg_sync(wg);  // tile j is in its slot, every thread's part of it

    const long long e = j / nt;
    if (e != cur_e) {
      if (cur_e >= 0) flush(tsum, red, wg, tid, partial, cur_e * G + gw);
      tsum = 0.f;
      cur_e = e;
    }
    // the entry product's A fragments: x's rows r0, r0 + 8, columns
    // 16 s + 2 t4 (+1, +8, +9), zero past the corpus's rows and width
    const int rows = rows_of(tile_of(j));
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(slot);
    auto xv = [&](int r, int c) -> uint32_t {
      return (r < rows && c < width) ? (uint32_t)xs[r * width + c] : 0u;
    };
#pragma unroll
    for (int s = 0; s < KIN / 16; ++s) {
      const int c0 = 16 * s + 2 * t4;
      a[4 * s + 0] = xv(r0, c0) | (xv(r0, c0 + 1) << 16);
      a[4 * s + 1] = xv(r0 + 8, c0) | (xv(r0 + 8, c0 + 1) << 16);
      a[4 * s + 2] = xv(r0, c0 + 8) | (xv(r0, c0 + 9) << 16);
      a[4 * s + 3] = xv(r0 + 8, c0 + 8) | (xv(r0 + 8, c0 + 9) << 16);
    }
    wg_sync(wg);  // the slot is read: the next tile's copy may land in it

    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KIN / 16; ++s)
      if (s < kin)
        wgmma_rs(acc, a[4 * s], a[4 * s + 1], a[4 * s + 2], a[4 * s + 3],
                 sw128_desc(wi_addr + s * 32), s > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
    for (int c = 0; c < n_chain; ++c) {
#pragma unroll
      for (int q = 0; q < 32; ++q) a[q] = pack_bf16(acc[2 * q], acc[2 * q + 1]);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < HD / 16; ++s)
        wgmma_rs(acc, a[4 * s], a[4 * s + 1], a[4 * s + 2], a[4 * s + 3],
                 sw128_desc(wc_addr + (s >> 2) * ATOM + (s & 3) * 32), s > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
    }
    float s_tile = 0.f;
#pragma unroll
    for (int q = 0; q < 64; ++q) s_tile += acc[q];
    tsum += s_tile;
  }
  if (cur_e >= 0) flush(tsum, red, wg, tid, partial, cur_e * G + gw);
  if (nt == 0 && tid == 0)
    for (int e = 0; e < epochs; ++e) partial[e * G + gw] = 0.f;
}

// metrics[e] = [the sum of partial[e * G, (e + 1) * G) in index order, 0 x 7]
__global__ void __launch_bounds__(ROWS_NT)
rows_kernel(const float* __restrict__ partial, long long G, int epochs,
            float* __restrict__ metrics) {
  __shared__ float wsum[ROWS_NT / 32];
  for (int e = 0; e < epochs; ++e) {
    float v = 0.f;
    for (long long c = threadIdx.x; c < G; c += ROWS_NT) v += partial[e * G + c];
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < ROWS_NT / 32; ++w) s += wsum[w];
      metrics[8LL * e] = s;
      for (int q = 1; q < 8; ++q) metrics[8LL * e + q] = 0.f;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

long long p1_sol_cuda_launches() { return g_launches; }

// the CTAs of sol_kernel resident at once on a card of `sms` SMs, at
// this width (its registers and shared memory decide how many an SM holds)
int p1_sol_grid(int sms, int width) {
  if (sms <= 0 || width <= 0 || width > KIN) return 0;
  const int smem = smem_bytes(width);
  if (cudaFuncSetAttribute(sol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess)
    return 0;
  int per = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, sol_kernel, NT, smem) !=
          cudaSuccess ||
      per < 1)
    per = 1;
  return sms * per;
}

// the warpgroups of a grid of `grid` CTAs: the partials an epoch
long long p1_sol_partials(int grid) { return (long long)grid * NWG; }

// P1-sol: for every epoch the chained products over the (n_pad, width)
// bf16 corpus, sum(h) into metrics[e, 0] (the row's other lanes 0).  w_in
// (width, 128) and w_chain (128, 128) are bf16, row-major; partial holds
// epochs x p1_sol_partials(grid) floats; packed 16-byte aligned.
// Two launches a call: the products, then the partials' sum.
int p1_sol(const void* packed, int width, long long n_pad, const void* w_in,
           const void* w_chain, int n_chain, int epochs, float* partial, int grid,
           float* metrics, void* stream) {
  if (n_pad <= 0 || width <= 0 || width > KIN || n_chain < 0 || epochs <= 0 || grid <= 0 ||
      (reinterpret_cast<uintptr_t>(packed) & 15))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(width);
  int err = (int)cudaFuncSetAttribute(sol_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  sol_kernel<<<grid, NT, smem, st>>>((const bf16*)packed, width, n_pad, (const bf16*)w_in,
                                     (const bf16*)w_chain, n_chain, epochs, partial);
  ++g_launches;
  err = (int)cudaGetLastError();
  if (err) return err;
  rows_kernel<<<1, ROWS_NT, 0, st>>>(partial, p1_sol_partials(grid), epochs, metrics);
  ++g_launches;
  return (int)cudaGetLastError();
}

}  // extern "C"
