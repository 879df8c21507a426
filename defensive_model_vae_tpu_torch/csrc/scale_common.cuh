// Device code shared by the production-scale trainer (fused_scale.cu: K3,
// K4; fused_scale_knob.cu: K3's ablation knobs) and the K3 ablation's own
// kernels (scale_ablation.cu: P1, P2).  One copy, so the ablation's forward,
// loss and backward cannot drift from K3's.
//
// What lives here: the model's shape and its flat parameter layout, the
// shared-memory layout of one block (every activation of a 32-row step),
// the product engines (`wg_product`: the manual bf16 step's forward and
// activation-gradient products on wgmma, its forward's near-ties and the
// mu/logvar head (`head_fma`) in the FMA engine's order; `gemm`: float32
// FMA over cp.async-staged tiles, for every other instance; the deferred
// weight gradients, mma.sync on the tensor cores over a per-chunk scratch
// of bf16 operands) and their forward /
// weight-gradient / activation-gradient forms, the Philox noise, and the
// pieces of one step of K3: stage the rows, the forward, the loss sums
// with d_recon, the manual backward (with the ablation knobs as template
// bits), the autodiff backward (backward="auto", in three dtype modes),
// and the block-wide sums.  The design note of fused_scale.cu says how K3
// uses them, and why a step is 32 rows.
//
// Everything is in an anonymous namespace: each source that includes this
// file compiles its own copy of the kernels it instantiates.  Functions
// called from another source take builtin types only.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 10, D = 3, F = T * D, Z = 8, H = 128, C = 2;
constexpr int Z2 = 2 * Z, H2 = 2 * H, GIN = Z + H;
constexpr int W_IN = F + C + 1;              // packed columns before the eps ones
constexpr int NT = 256;                      // threads of a block
constexpr int R = 32;                        // rows of one step
constexpr int TM = 32, TN = 128, TK = 32;    // product tile
constexpr int TMP = TM + 4, TNP = TN + 4;    // padded rows of the float32 staged tiles

using bf16 = __nv_bfloat16;

// the flat parameter layout (ops/fused_trainer.py::pack_kernel_params):
// 11 layers in forward order, each W (in, out) row-major then b (out);
// layer 6 is the merged [fc_mu | fc_logvar] head
__host__ __device__ constexpr int layer_in(int l) {
  return l == 0 ? C : l == 2 ? F : l == 6 ? H2 : l == 7 ? GIN : H;
}
__host__ __device__ constexpr int layer_out(int l) { return l == 6 ? Z2 : l == 10 ? F : H; }
__host__ __device__ constexpr int w_off(int l) {
  return l == 0 ? 0 : w_off(l - 1) + layer_in(l - 1) * layer_out(l - 1) + layer_out(l - 1);
}
__host__ __device__ constexpr int b_off(int l) { return w_off(l) + layer_in(l) * layer_out(l); }
constexpr int N_PARAMS = w_off(11);
static_assert(N_PARAMS == 128942, "parameter count of CVAEConfig()");

constexpr int L_C0 = 0, L_C1 = 1, L_E0 = 2, L_E1 = 3, L_E2 = 4, L_E3 = 5,
              L_ML = 6, L_D0 = 7, L_D1 = 8, L_D2 = 9, L_D3 = 10;

// one row of the partial buffer: the gradients, then the five loss sums
// [recon, kld, start, t0, time-increase] (row length a multiple of 4 floats)
constexpr int LOSS_OFF = (N_PARAMS + 3) / 4 * 4;
constexpr int PART_STRIDE = LOSS_OFF + 8;

// a block's running bias-gradient sums in shared memory, layer by layer
__host__ __device__ constexpr int bs_off(int l) {
  return l == 0 ? 0 : bs_off(l - 1) + layer_out(l - 1);
}
constexpr int BS_FLOATS = bs_off(11);

// the deferred weight gradients' scratch (bf16 modes of the manual
// instances): one row of SCR_ROW bf16 a corpus row, per layer its product
// input then its output cotangent, each padded to 8 values (16 bytes)
__host__ __device__ constexpr int pad8(int x) { return (x + 7) / 8 * 8; }
__host__ __device__ constexpr int scr_in(int l) {
  return l == 0 ? 0 : scr_in(l - 1) + pad8(layer_in(l - 1)) + pad8(layer_out(l - 1));
}
__host__ __device__ constexpr int scr_dy(int l) { return scr_in(l) + pad8(layer_in(l)); }
constexpr int SCR_ROW = scr_in(11);
static_assert(SCR_ROW % 8 == 0, "16-byte scratch rows");

// K3's ablation knobs (ops/fused_scale.py::ABLATE_BITS), one bit each
enum Knob { K_NOADAM = 1, K_NOACC = 2, K_BIASDOT = 4, K_CHAINCD = 8, K_NODW = 16,
            K_FWDONLY = 32, K_DWT = 64 };

// the autodiff instances' dtype modes (ops/fused_scale.py::AUTO_MODES)
enum AutoMode { A_F32 = 0, A_ACTS = 1, A_CHAIN = 2 };

// what the engine does (ks_engine): the bf16 weight gradients on the
// tensor cores; the manual bf16 step's forward and activation-gradient
// products on wgmma
enum Engine { E_TENSOR_CORES = 1, E_STEP_WGMMA = 2 };

// whether a rounded weight operand is staged from the bf16 copy of the
// params, which K3's and K4's entries always pass; P1's kernels have no
// copy (scale_ablation.cu defines KS_NO_WEIGHT_COPY) and round as they read
#ifdef KS_NO_WEIGHT_COPY
constexpr bool WEIGHT_COPY = false;
#else
constexpr bool WEIGHT_COPY = true;
#endif

// the knob instances whose step products stay on float32 FMA: noacc, whose
// loss rows are held to a limit (NOACC_TOL) set against that engine's
// summation order before any order spread was measured
constexpr int FMA_KNOBS = K_NOACC;

// whether the manual instance (dtype BF, knobs AB) runs its step's products
// on wgmma: bf16 with the weights' bf16 copy, and not a knob of FMA_KNOBS
__host__ __device__ constexpr bool step_wgmma(bool bf, int ab) {
  return bf && WEIGHT_COPY && (ab & FMA_KNOBS) == 0;
}

// the staging of the step's products: FM_S slots of A [TK][TMP] and B,
// float32 [TK][TNP] (n contiguous) or [TN][FM_BK] (k contiguous), bf16
// [TK][FM_BH] or [TN][FM_BKH]; rows of 528, 144, 272 and 80 bytes, each a
// multiple of 16 and read without bank conflicts (two-way for the last)
constexpr int FM_BK = TK + 4, FM_BH = TN + 8, FM_BKH = TK + 8;
constexpr int FM_S = 2, FM_A = TK * TMP;
constexpr int FM_B = TK * TNP > TN * FM_BK ? TK * TNP : TN * FM_BK;
constexpr int FM_SLOT = FM_A + FM_B;
static_assert(TK * FM_BH * 2 <= FM_B * 4 && TN * FM_BKH * 2 <= FM_B * 4,
              "a bf16 B tile fits the slot's float32 one");
constexpr int STG_BYTES = FM_S * FM_SLOT * 4;
// the deferred weight-gradient products' tiles and ring (over the step's
// buffers, which are free by then): A [DK][DM + 8] (or, under dwT,
// [DM][DK + 8]) and B [DK][DN + 8]
constexpr int DM = 128, DN = 128, DK = 64, D_S = 4;
constexpr int D_AM = DM + 8, D_AK = DK + 8, D_BN = DN + 8;
constexpr int D_A_BYTES = DK * D_AM * 2 > DM * D_AK * 2 ? DK * D_AM * 2 : DM * D_AK * 2;
constexpr int D_SLOT = D_A_BYTES + DK * D_BN * 2;

// shared memory (floats), each buffer row-major [R][width]
constexpr int S_X = 0;
constexpr int S_CND = S_X + R * F;
constexpr int S_MSK = S_CND + R * C;
constexpr int S_EPS = S_MSK + R;
constexpr int S_C0 = S_EPS + R * Z;
constexpr int S_HCAT = S_C0 + R * H;      // [h | hc]
constexpr int S_E0 = S_HCAT + R * H2;
constexpr int S_E1 = S_E0 + R * H;
constexpr int S_E2 = S_E1 + R * H;
constexpr int S_ML = S_E2 + R * H;        // [mu | logvar]
constexpr int S_GIN = S_ML + R * Z2;      // [z | hc]
constexpr int S_G1 = S_GIN + R * GIN;
constexpr int S_G2 = S_G1 + R * H;
constexpr int S_G3 = S_G2 + R * H;
constexpr int S_REC = S_G3 + R * H;
constexpr int S_DREC = S_REC + R * F;
constexpr int S_STG = S_DREC + R * F;     // the products' ring (STG_BYTES)
constexpr int S_RED = S_STG;              // [5][NT] loss sums, outside any product
constexpr int S_BSUM = S_STG + STG_BYTES / 4;  // the bias-gradient sums
constexpr int S_FLOATS = S_BSUM + (BS_FLOATS + 3) / 4 * 4;
constexpr int SMEM_BYTES = S_FLOATS * 4;
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
static_assert(S_STG % 4 == 0 && S_BSUM % 4 == 0 && STG_BYTES % 16 == 0, "16-byte slots");
static_assert(5 * NT * 4 <= STG_BYTES, "the loss sums fit in the ring");
static_assert(D_S * D_SLOT <= S_STG * 4, "the deferred products' ring fits in the step's buffers");

// the bf16 step products on wgmma (wg_product) take the ring for their B:
// the step's R rows of the operand rounded to bf16, K-major in
// 128-byte-swizzled atoms of R rows x 64 values (K <= 256), on a 1024-byte
// boundary; their A (the weights) goes from the bf16 copy to registers
constexpr int WB_ATOM = R * 128;
constexpr int WB_BYTES = 4 * WB_ATOM;
static_assert(1008 + WB_BYTES <= STG_BYTES, "the wgmma products' B fits in the ring, aligned");

extern __shared__ __align__(16) float sm[];

template <bool BF>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <bool BF> struct Elem { using type = float; };
template <> struct Elem<true> { using type = __nv_bfloat16; };

// ---- device-only helpers: asynchronous copies, ldmatrix, mma --------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, the last 16 - bytes zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(bytes));
}

// 4 bytes likewise
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 bf16 matrices, each row's 16-byte address from one lane (lanes
// 8i .. 8i+7: matrix i); .trans hands each thread a column pair instead
__device__ __forceinline__ void ldsm4(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d (16x8, float32) += a (16x16, bf16, row-major) . b (16x8, bf16)
__device__ __forceinline__ void mma16816(float d[4], const unsigned a[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a wgmma descriptor of a K-major operand in 128-byte-swizzled atoms: start
// address, leading offset 16 bytes (unused by this layout), stride 1024
// bytes between groups of 8 rows, layout 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d = a . b, m64n32k16, bf16 in, float32 out: A's fragment from registers,
// B by descriptor, d overwritten (scale-d 0: the product summed from zero)
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], const unsigned (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(0));
}

// the same at n16 (8 outputs a thread)
__device__ __forceinline__ void wgmma_m64n16(float (&d)[8], const unsigned (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(0));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of the warpgroup's committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// shared-memory stores of the generic proxy made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep the compiler from moving a register that an asynchronous product
// reads or writes across the wait for it
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(unsigned& r) { asm volatile("" : "+r"(r)::"memory"); }

// ---- end of the device-only helpers ----------------------------------------

// acc += a . b, the 16-deep product summed by the tensor core from zero and
// then added in float32 with rounding to nearest: the tensor core's own
// accumulation truncates, so chaining it through its accumulator input
// would bias every long sum toward zero by about an ulp a step
__device__ __forceinline__ void mma16816_add(float acc[4], const unsigned a[4], unsigned b0,
                                             unsigned b1) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma16816(d, a, b0, b1);
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] += d[c];
}

// one product's epilogue on one output element (gemm's note)
template <int RO, bool RBI>
__device__ __forceinline__ float epilogue(float v, int m, int n, const float* bias, bool relu,
                                          const float* add, int lda, const float* mask,
                                          int ldm) {
  if constexpr (RO >= 1) v = rnd<true>(v);
  if (bias) v += rnd<RBI>(bias[n]);
  if (add) v += add[(long long)m * lda + n];
  if constexpr (RO == 2) v = rnd<true>(v);
  if (relu) v = fmaxf(v, 0.f);
  if (mask) v = v * (mask[(long long)m * ldm + n] > 0.f ? 1.f : 0.f);
  return v;
}

// eight bf16 of B from the bf16 copy Bb along its contiguous index into dst
// (16 bytes) by cp.async: 16 bytes where aligned and whole, else
// 2-byte-granular 4-byte copies; `valid` of the eight are real, the rest
// zero
__device__ __forceinline__ void stage8(bf16* dst, const bf16* Bb, long long off, int valid) {
  const bf16* src = Bb + off;
  if (valid >= 8 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(dst, src, 16);
  } else if ((reinterpret_cast<uintptr_t>(src) & 3) == 0) {
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const int b = valid - e >= 2 ? 4 : valid - e == 1 ? 2 : 0;
      cp_async4(dst + e, b ? src + e : Bb, b);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = e < valid ? src[e] : __float2bfloat16_rn(0.f);
  }
}

// C[M, N] = A[M, K] . B[K, N] with A(m, k) = A[m sam + k sak] and
// B(k, n) = B[k sbk + n sbn], so one routine serves the forward (act . W),
// the activation gradient (dY . W^T) and, in float32 and f32_acts, the
// weight gradient (act^T . dY), on float32 FMA: an operand rounded to bf16
// when RA / RB, tiles of TM x TN, each thread 4 x 4 outputs, every output
// one FMA chain over k in order.  It is the step engine of float32 K3 and
// K4 (whose digest holds that order bit for bit), of the autodiff
// instances, of P1's kernels (no bf16 copy) and of the knob instances of
// FMA_KNOBS; the manual bf16 instances run their step's products on
// wgmma (wg_product).  The depth in steps of TK through a
// ring of FM_S slots: A (shared memory) copied in rounded when RA; B, when
// it lies in global memory (the weights), by cp.async one step ahead along
// its contiguous index (n: the forward; k: the activation gradients' W^T,
// staged [n][k]), 16 bytes where aligned, else 4 bytes an element: a
// rounded B from its bf16 copy Bb (WEIGHT_COPY), kept bf16 in the slot and
// widened when read (exact), else float32 and rounded when read if RB; B
// in shared memory (BSM: the weight gradients' dY) copied in rounded when
// RB.  Epilogue, in order: the product rounded to bf16 when RO >= 1, +
// bias[n] (itself rounded to bf16 when RBI), + add[m lda + n], rounded
// again when RO == 2, relu, times (mask[m ldm + n] > 0), then + the old C
// (read before the depth loop) when accum.
template <bool RA, bool RB, int RO = 0, bool RBI = false, bool BSM = false>
__device__ void gemm(int M, int N, int K, const float* A, int sam, int sak, const float* Bm,
                     int sbk, int sbn, float* Cm, int ldc, bool accum, const float* bias,
                     bool relu, const float* add, int lda, const float* mask, int ldm,
                     const bf16* Bb = nullptr) {
  float* stg = sm + S_STG;
  const int tid = threadIdx.x;
  const int tx = tid % 32, ty = tid / 32;
  constexpr bool b_async = !BSM;
  if (b_async && sbn != 1 && sbk != 1) __trap();  // global B needs a contiguous index
  // B in global memory with k its contiguous index (the activation
  // gradients' W^T) is staged as [n][k], and each thread then takes the
  // columns tx + 32 c (else tx 4 + c): its reads of four k at a time miss
  // each other's banks
  const bool b_k = b_async && sbk == 1 && sbn != 1;
  constexpr bool b_bf16 = RB && b_async && WEIGHT_COPY;
  if (b_bf16 && !Bb) __trap();  // the caller passes the copy
  const int tiles_m = (M + TM - 1) / TM, tiles_n = (N + TN - 1) / TN;
  const int nsteps = (K + TK - 1) / TK;
  const bool vec = !b_k && (ldc % 4 == 0) && ((reinterpret_cast<uintptr_t>(Cm) & 15) == 0);
  const int cstep = b_k ? 32 : 1;  // a thread's columns: cbase + c cstep
  for (int tile = 0; tile < tiles_m * tiles_n; ++tile) {
    const int m0 = (tile / tiles_n) * TM, n0 = (tile % tiles_n) * TN;
    const int nb = n0 + tx * 4;
    const int cbase = b_k ? n0 + tx : nb;
    auto stage = [&](int s) {
      float* As = stg + (s % FM_S) * FM_SLOT;
      float* Bs = As + FM_A;
      const int k0 = s * TK;
      for (int i = tid; i < TK * TM; i += NT) {
        int kk, mm;
        if (sak == 1) { kk = i % TK; mm = i / TK; } else { kk = i / TM; mm = i % TM; }
        const int m = m0 + mm, k = k0 + kk;
        As[kk * TMP + mm] =
            (m < M && k < K) ? rnd<RA>(A[(long long)m * sam + (long long)k * sak]) : 0.f;
      }
      if (b_bf16 && b_k) {
        bf16* Bh = reinterpret_cast<bf16*>(Bs);
        for (int i = tid; i < TN * TK / 8; i += NT) {
          const int nn = i / (TK / 8), kk = 8 * (i % (TK / 8));
          const int k = k0 + kk, n = n0 + nn;
          const int valid = n < N ? (K - k < 8 ? K - k : 8) : 0;
          stage8(Bh + nn * FM_BKH + kk, Bb, (long long)n * sbn + k, valid < 0 ? 0 : valid);
        }
      } else if (b_bf16 && sbn == 1) {
        bf16* Bh = reinterpret_cast<bf16*>(Bs);
        for (int i = tid; i < TK * TN / 8; i += NT) {
          const int kk = i / (TN / 8), nn = 8 * (i % (TN / 8));
          const int k = k0 + kk, n = n0 + nn;
          const int valid = k < K ? (N - n < 8 ? N - n : 8) : 0;
          stage8(Bh + kk * FM_BH + nn, Bb, (long long)k * sbk + n, valid < 0 ? 0 : valid);
        }
      } else if (b_k) {
        for (int i = tid; i < TN * TK / 4; i += NT) {
          const int nn = i / (TK / 4), kk = 4 * (i % (TK / 4));
          const int k = k0 + kk, n = n0 + nn;
          const float* src = Bm + (long long)n * sbn + k;
          float* dst = Bs + nn * FM_BK + kk;
          const int valid = n < N ? (K - k < 4 ? K - k : 4) : 0;
          if (valid == 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
            cp_async16(dst, src, 16);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) cp_async4(dst + e, e < valid ? src + e : Bm, e < valid ? 4 : 0);
          }
        }
      } else if (b_async && sbn == 1) {
        for (int i = tid; i < TK * TN / 4; i += NT) {
          const int kk = i / (TN / 4), nn = 4 * (i % (TN / 4));
          const int k = k0 + kk, n = n0 + nn;
          const float* src = Bm + (long long)k * sbk + n;
          float* dst = Bs + kk * TNP + nn;
          const int valid = k < K ? (N - n < 4 ? N - n : 4) : 0;
          if (valid == 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
            cp_async16(dst, src, 16);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) cp_async4(dst + e, e < valid ? src + e : Bm, e < valid ? 4 : 0);
          }
        }
      } else {
        for (int i = tid; i < TK * TN; i += NT) {
          int kk, nn;
          if (sbn == 1) { kk = i / TN; nn = i % TN; } else { kk = i % TK; nn = i / TK; }
          const int n = n0 + nn, k = k0 + kk;
          Bs[kk * TNP + nn] =
              (n < N && k < K) ? rnd<RB>(Bm[(long long)k * sbk + (long long)n * sbn]) : 0.f;
        }
      }
    };
    float acc[4][4], old[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][c] = 0.f;
        const int m = m0 + ty * 4 + r, n = cbase + c * cstep;
        old[r][c] = accum && m < M && n < N ? Cm[(long long)m * ldc + n] : 0.f;
      }
    stage(0);
    cp_commit();
    for (int s = 0; s < nsteps; ++s) {
      if (s + 1 < nsteps) stage(s + 1);
      cp_commit();
      cp_wait<1>();
      __syncthreads();
      const float* As = stg + (s % FM_S) * FM_SLOT;
      const float* Bs = As + FM_A;
      // B(kk, n .. n + 3) as floats: widened from bf16, rounded if RB and
      // staged unrounded, or as staged
      auto body = [&](auto load_b) {
#pragma unroll 8
        for (int kk = 0; kk < TK; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(As + kk * TMP + ty * 4);
          float bv[4];
          load_b(kk, bv);
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
        }
      };
      // [n][k]: four k of the thread's four columns at a time, then each
      // output's four FMAs in k order
      auto body_k = [&](auto load_b4) {
#pragma unroll 2
        for (int kk = 0; kk < TK; kk += 4) {
          float4 a[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            a[j] = *reinterpret_cast<const float4*>(As + (kk + j) * TMP + ty * 4);
          float b[4][4];
#pragma unroll
          for (int c = 0; c < 4; ++c) load_b4(tx + 32 * c, kk, b[c]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float av[4] = {a[j].x, a[j].y, a[j].z, a[j].w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], b[c][j], acc[r][c]);
          }
        }
      };
      if (b_k && b_bf16) {
        const bf16* Bh = reinterpret_cast<const bf16*>(Bs);
        body_k([&](int nn, int kk, float* bv) {
          const uint2 q = *reinterpret_cast<const uint2*>(Bh + nn * FM_BKH + kk);
          bv[0] = __uint_as_float(q.x << 16); bv[1] = __uint_as_float(q.x & 0xFFFF0000u);
          bv[2] = __uint_as_float(q.y << 16); bv[3] = __uint_as_float(q.y & 0xFFFF0000u);
        });
      } else if (b_k) {
        body_k([&](int nn, int kk, float* bv) {
          const float4 q = *reinterpret_cast<const float4*>(Bs + nn * FM_BK + kk);
          bv[0] = rnd<RB>(q.x); bv[1] = rnd<RB>(q.y); bv[2] = rnd<RB>(q.z); bv[3] = rnd<RB>(q.w);
        });
      } else if (b_bf16) {
        const bf16* Bh = reinterpret_cast<const bf16*>(Bs);
        body([&](int kk, float* bv) {
          const uint2 q = *reinterpret_cast<const uint2*>(Bh + kk * FM_BH + tx * 4);
          bv[0] = __uint_as_float(q.x << 16); bv[1] = __uint_as_float(q.x & 0xFFFF0000u);
          bv[2] = __uint_as_float(q.y << 16); bv[3] = __uint_as_float(q.y & 0xFFFF0000u);
        });
      } else if (RB && b_async) {
        body([&](int kk, float* bv) {
          const float4 b = *reinterpret_cast<const float4*>(Bs + kk * TNP + tx * 4);
          bv[0] = rnd<RB>(b.x); bv[1] = rnd<RB>(b.y); bv[2] = rnd<RB>(b.z); bv[3] = rnd<RB>(b.w);
        });
      } else {
        body([&](int kk, float* bv) {
          const float4 b = *reinterpret_cast<const float4*>(Bs + kk * TNP + tx * 4);
          bv[0] = b.x; bv[1] = b.y; bv[2] = b.z; bv[3] = b.w;
        });
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = m0 + ty * 4 + r;
      if (m >= M) continue;
      float val[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = cbase + c * cstep;
        val[c] = n < N ? epilogue<RO, RBI>(acc[r][c], m, n, bias, relu, add, lda, mask, ldm)
                       : acc[r][c];
      }
      float* dst = Cm + (long long)m * ldc + cbase;
      if (vec && nb + 4 <= N) {
        float4 o = make_float4(val[0], val[1], val[2], val[3]);
        if (accum) {
          o.x = old[r][0] + o.x; o.y = old[r][1] + o.y;
          o.z = old[r][2] + o.z; o.w = old[r][3] + o.w;
        }
        *reinterpret_cast<float4*>(dst) = o;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (cbase + c * cstep < N)
            dst[c * cstep] = accum ? old[r][c] + val[c] : val[c];
      }
    }
  }
  __syncthreads();
}

// byte offset of element (k, n) of wg_product's B: atom k / 64, row n, the
// 16-byte chunk (k % 64) / 8 swizzled by n % 8
__device__ __forceinline__ int wb_offset(int k, int n) {
  const int kk = k & 63;
  return (k >> 6) * WB_ATOM + n * 128 + (((kk >> 3) ^ (n & 7)) << 4) + (kk & 7) * 2;
}

// the weights of one wgmma product, from the bf16 copy: M outputs, K deep,
// W(m, k) = w[k ldw + m] in the forward, w[m ldw + k] in the activation
// gradients (M, K and ldw even)
struct WOp {
  const bf16* w;
  int ldw, M, K;
};

__host__ __device__ constexpr int ks_of(int k) { return (k + 15) / 16; }

// the forward's outputs m and m + 1 at depth k as one register (low half
// first); zero past M or K
__device__ __forceinline__ unsigned w_pair_fwd(const WOp& op, int m, int k) {
  if (m >= op.M || k >= op.K) return 0u;
  return __ldg(reinterpret_cast<const unsigned*>(op.w + k * op.ldw + m));
}

// the activation gradients' output m at depths k .. k + 3 as two registers;
// zero past M or K
__device__ __forceinline__ uint2 w_quad_ag(const WOp& op, int m, int k) {
  if (m >= op.M || k >= op.K) return make_uint2(0u, 0u);
  const bf16* p = op.w + m * op.ldw + k;
  if (k + 4 <= op.K && (op.ldw & 3) == 0) return __ldg(reinterpret_cast<const uint2*>(p));
  return make_uint2(__ldg(reinterpret_cast<const unsigned*>(p)),
                    k + 2 < op.K ? __ldg(reinterpret_cast<const unsigned*>(p + 2)) : 0u);
}

// The A fragments of a 64-output tile over KS k16 slices, from the bf16
// copy.  This thread's fragment rows g and g + 8 are the outputs m and m + 1
// (m = the warp's 16 + 2 g).  TR: slice s's depths 16 s + 2 t4, + 1, + 8,
// + 9 as the fragment lays them out, by four 4-byte loads (m and m + 1 at
// one depth each) paired by byte permutes.  Else the depths 16 s + 4 t4 ..
// + 3 of each row by one 8-byte load, the first pair as the fragment's
// depths 2 t4, + 1 and the second as 2 t4 + 8, + 9; wg_product stages B in
// that order.  Either way a warp's loads read whole 32-byte sectors.
template <bool TR, int KS>
__device__ __forceinline__ void w_frags(unsigned (&a)[KS][4], const WOp& op, int m, int t4) {
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if constexpr (TR) {
      const int k = 16 * s + 2 * t4;
      const unsigned u0 = w_pair_fwd(op, m, k), u1 = w_pair_fwd(op, m, k + 1);
      const unsigned u2 = w_pair_fwd(op, m, k + 8), u3 = w_pair_fwd(op, m, k + 9);
      a[s][0] = __byte_perm(u0, u1, 0x5410);
      a[s][1] = __byte_perm(u0, u1, 0x7632);
      a[s][2] = __byte_perm(u2, u3, 0x5410);
      a[s][3] = __byte_perm(u2, u3, 0x7632);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint2 q = w_quad_ag(op, m + h, 16 * s + 4 * t4);
        a[s][h] = q.x;
        a[s][2 + h] = q.y;
      }
    }
  }
}

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&b);
}

// FIX's margin: T = FIX_C |a_m| |b_n| against |wgmma's sum - the FMA
// chain's|, which read at most 2.9 units of 2^-24 |a_m| |b_n| (Cauchy-
// Schwarz over sum_k |a_k b_k|) over 4M outputs a layer of the model's
// forward at init, emulated on the CPU: 8 units
constexpr float FIX_C = 0x1p-21f;

// The bf16 step product on wgmma, transposed: C[r][m] = epilogue(sum_k
// W(m, k) . rnd(Bv[r ldb + k])) for the step's R rows r and outputs m < M of
// op.  The outputs are wgmma's M: FULLT, the first 128 in two tiles of 64,
// tile t on warpgroup t at n32 over the R rows; PART, those past them (fewer
// than 64) in one tile that both warpgroups run at n16, each on half the
// rows.  So both warpgroups run the same instructions and no wgmma lies in
// a divergent path.  K is padded with zeros to KS k16 slices and M to whole
// tiles, which changes no sum of real terms.
//
// A from registers (w_frags), loaded from the bf16 copy (L2) before B is
// staged; B, the rows rounded to bf16 nearest even as gemm rounds them, by
// descriptor from its swizzled atoms, its depths within a slice in the
// order of A's.  Each k16 slice is summed by the tensor core from zero and
// added to the float32 sum with rounding to nearest, in k order
// (mma16816_add's note), the next slice's product running beside the add.
// Epilogue as gemm's (RO, bias unrounded), on each output once, two outputs
// at a time; no atomics, so the same bits on every run.  FIX (the forward's
// relu products): an output whose rounded activation could differ in the
// FMA engine's order (within FIX_C |a_m| |b_n| of a bf16 rounding boundary
// or of 0) takes gemm's FMA chain instead, so the forward hands on gemm's
// bf16 activations (fused_scale.cu's note says why).  One instance a shape
// (not inlined), to keep the objects' build short.
template <bool TR, int RO, int KS, bool FULLT, bool PART, bool FIX>
__device__ __noinline__ void wg_product(WOp op, const float* Bv, int ldb, float* Cm, int ldc,
                                        const float* bias, bool relu, const float* add,
                                        int lda, const float* mask, int ldm) {
  static_assert(FULLT || PART, "a product has outputs");
  static_assert(16 * KS <= 4 * 64, "B fits its four atoms");
  static_assert(!FIX || (TR && FULLT && !PART), "FIX: a forward product of whole tiles");
  char* ring = reinterpret_cast<char*>(sm + S_STG);
  const unsigned ring_s = smem_u32(ring);
  const unsigned b_s = (ring_s + 1023) & ~1023u;
  char* bbuf = ring + (b_s - ring_s);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mf = wg * 64 + warp * 16 + 2 * g;            // FULLT: tile wg
  const int mq = (FULLT ? 128 : 0) + warp * 16 + 2 * g;  // PART
  unsigned af[FULLT ? KS : 1][4], ap[PART ? KS : 1][4];
  if constexpr (FULLT) w_frags<TR, KS>(af, op, mf, t4);
  if constexpr (PART) w_frags<TR, KS>(ap, op, mq, t4);
  // B: the operand's rows rounded to bf16, 8 values a 16-byte store, zeros
  // from K to the last slice's end
  const int K = op.K;
  if constexpr (TR) {
    constexpr int OCT = 2 * KS;
    for (int i = tid; i < R * OCT; i += NT) {
      const int n = i / OCT, k8 = (i % OCT) * 8;
      const float* src = Bv + n * ldb + k8;
      uint4 v;
      if ((ldb & 3) == 0 && k8 + 8 <= K) {
        const float4 lo = *reinterpret_cast<const float4*>(src);
        const float4 hi = *reinterpret_cast<const float4*>(src + 4);
        v = make_uint4(bf16_pair(lo.x, lo.y), bf16_pair(lo.z, lo.w), bf16_pair(hi.x, hi.y),
                       bf16_pair(hi.z, hi.w));
      } else {
        unsigned w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = k8 + 2 * e;
          w[e] = bf16_pair(k < K ? src[2 * e] : 0.f, k + 1 < K ? src[2 * e + 1] : 0.f);
        }
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
      *reinterpret_cast<uint4*>(bbuf + wb_offset(k8, n)) = v;
    }
  } else {
    // a slice's depth pair 2 j + h at the fragment's pair j of half h (w_frags)
    for (int i = tid; i < R * KS; i += NT) {
      const int n = i / KS, k0 = 16 * (i % KS);
      const float* src = Bv + n * ldb + k0;
      unsigned w[2][4];
      if ((ldb & 3) == 0 && k0 + 16 <= K) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 q = *reinterpret_cast<const float4*>(src + 4 * j);
          w[0][j] = bf16_pair(q.x, q.y);
          w[1][j] = bf16_pair(q.z, q.w);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = k0 + 4 * j + 2 * h;
            w[h][j] = bf16_pair(k < K ? src[k - k0] : 0.f, k + 1 < K ? src[k - k0 + 1] : 0.f);
          }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint4*>(bbuf + wb_offset(k0 + 8 * h, n)) =
            make_uint4(w[h][0], w[h][1], w[h][2], w[h][3]);
    }
  }
  fence_proxy_async();
  __syncthreads();  // B in place, for both proxies
  float2 bf = make_float2(0.f, 0.f), bq = bf;  // the bias pairs, read once the last slice runs
  float na[2] = {0.f, 0.f};  // FIX: |a_m|^2, |a_m+1|^2
  float accf[16], accp[8], df[2][16], dp[2][8];
#pragma unroll
  for (int q = 0; q < 16; ++q) accf[q] = df[0][q] = df[1][q] = 0.f;
#pragma unroll
  for (int q = 0; q < 8; ++q) accp[q] = dp[0][q] = dp[1][q] = 0.f;
  const unsigned b_half = b_s + wg * 16 * 128;  // PART: this warpgroup's 16 rows
#pragma unroll
  for (int s = 0; s <= KS; ++s) {
    if (s < KS) {  // slice s, from zero
      const unsigned off = (s >> 2) * WB_ATOM + (s & 3) * 32;
      wgmma_fence();
      if constexpr (FULLT) wgmma_m64n32(df[s & 1], af[s], sw128_desc(b_s + off));
      if constexpr (PART) wgmma_m64n16(dp[s & 1], ap[s], sw128_desc(b_half + off));
      wgmma_commit();
      // FIX, beside the last slice: |a_m|^2 from the fragments (over the
      // four lanes of a row pair), and each row's |b_n|^2 into S_DREC (free
      // in the forward)
      if constexpr (FIX) {
        if (s == KS - 1) {
#pragma unroll
          for (int t = 0; t < KS; ++t)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const unsigned x = af[t][h + 2 * u];
                const float lo = __uint_as_float(x << 16), hi = __uint_as_float(x & 0xFFFF0000u);
                na[h] = fmaf(hi, hi, fmaf(lo, lo, na[h]));
              }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            na[h] += __shfl_xor_sync(0xFFFFFFFFu, na[h], 1);
            na[h] += __shfl_xor_sync(0xFFFFFFFFu, na[h], 2);
          }
          const int n = tid >> 3, part = tid & 7;
          float nb = 0.f;
          for (int k = part; k < K; k += 8) {
            const float a = rnd<true>(Bv[n * ldb + k]);
            nb = fmaf(a, a, nb);
          }
          nb += __shfl_xor_sync(0xFFFFFFFFu, nb, 1);
          nb += __shfl_xor_sync(0xFFFFFFFFu, nb, 2);
          nb += __shfl_xor_sync(0xFFFFFFFFu, nb, 4);
          if (part == 0) sm[S_DREC + n] = nb;
        }
      }
      if (s == KS - 1 && bias) {
        if constexpr (FULLT) bf = *reinterpret_cast<const float2*>(bias + mf);
        if constexpr (PART) if (mq < op.M) bq = *reinterpret_cast<const float2*>(bias + mq);
      }
    }
    const int r = s - 1;  // slice r, added, slice s running beside it
    if (r >= 0) {
      if (s < KS) wgmma_wait<1>();
      else wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (FULLT) fence_reg(af[r][q]);
        if constexpr (PART) fence_reg(ap[r][q]);
      }
      if constexpr (FULLT) {
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          fence_reg(df[r & 1][q]);
          accf[q] += df[r & 1][q];
        }
      }
      if constexpr (PART) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          fence_reg(dp[r & 1][q]);
          accp[q] += dp[r & 1][q];
        }
      }
    }
  }
  // epilogue, as gemm's: d[4j + 2h + e] holds output m + h (fragment row
  // g + 8h) of row 8j + 2 t4 + e
  auto epi = [&](float v, float b, float ad, float mk) {
    if constexpr (RO >= 1) v = rnd<true>(v);
    if (bias) v += b;
    if (add) v += ad;
    if constexpr (RO == 2) v = rnd<true>(v);
    if (relu) v = fmaxf(v, 0.f);
    if (mask) v = v * (mk > 0.f ? 1.f : 0.f);
    return v;
  };
  auto out2 = [&](float v0, float v1, int n, int m, float2 b) {
    float2 ad = make_float2(0.f, 0.f), mk = ad;
    if (add) ad = *reinterpret_cast<const float2*>(add + n * lda + m);
    if (mask) mk = *reinterpret_cast<const float2*>(mask + n * ldm + m);
    *reinterpret_cast<float2*>(Cm + n * ldc + m) =
        make_float2(epi(v0, b.x, ad.x, mk.x), epi(v1, b.y, ad.y, mk.y));
  };
  if constexpr (FIX) {
    // an output whose rounded activation (bias, relu, bf16) is not the same
    // over +-T around its value may round otherwise in the FMA engine's
    // order; it takes that order (below), so every bf16 operand the
    // forward hands on is the FMA engine's
    __syncthreads();  // every row's |b_n|^2 in S_DREC
    unsigned flags = 0u;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int h = (q >> 1) & 1, n = 8 * (q >> 2) + 2 * t4 + (q & 1);
      const float T = FIX_C * sqrtf(na[h] * sm[S_DREC + n]), x = accf[q] + (h ? bf.y : bf.x);
      if (rnd<true>(fmaxf(x - T, 0.f)) != rnd<true>(fmaxf(x + T, 0.f))) flags |= 1u << q;
    }
    // gemm's value of each flagged output: the FMA chain over k in order
    // from zero (rounded activations times the weights), then gemm's
    // zero-padded depth past K (one fmaf(0, 0, .) where K is not a multiple
    // of TK: -0 becomes +0).  Row m + h's weights come from the four lanes
    // that hold its fragments (lane t: depths 2t, 2t + 1 and 2t + 8, 2t + 9
    // of each slice), so the warp runs its lanes' flagged outputs one at a
    // time together
    const int rounds = __reduce_max_sync(0xFFFFFFFFu, __popc(flags)), base = lane & ~3;
    for (int i = 0; i < rounds; ++i) {
      const bool mine = flags != 0u;
      const int q = mine ? __ffs(flags) - 1 : 0;
      flags &= flags - 1u;
      const int h = (q >> 1) & 1, n = 8 * (q >> 2) + 2 * t4 + (q & 1);
      const float* arow = Bv + n * ldb;
      float v = 0.f;
#pragma unroll
      for (int t = 0; t < KS; ++t) {
        float av[16];  // the slice's activations, loaded ahead of its chain
        if (mine) {
          if ((ldb & 3) == 0) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 a4 = *reinterpret_cast<const float4*>(arow + 16 * t + 4 * u);
              av[4 * u] = a4.x; av[4 * u + 1] = a4.y; av[4 * u + 2] = a4.z; av[4 * u + 3] = a4.w;
            }
          } else {
#pragma unroll
            for (int u = 0; u < 16; ++u) av[u] = arow[16 * t + u];
          }
        }
        unsigned lo[4], hi[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned r0 = __shfl_sync(0xFFFFFFFFu, af[t][0], base + u);
          const unsigned r1 = __shfl_sync(0xFFFFFFFFu, af[t][1], base + u);
          const unsigned r2 = __shfl_sync(0xFFFFFFFFu, af[t][2], base + u);
          const unsigned r3 = __shfl_sync(0xFFFFFFFFu, af[t][3], base + u);
          lo[u] = h ? r1 : r0;
          hi[u] = h ? r3 : r2;
        }
#pragma unroll
        for (int kk = 0; kk < 16; ++kk) {
          const int k = 16 * t + kk;
          const unsigned word = kk < 8 ? lo[kk >> 1] : hi[(kk - 8) >> 1];
          const float w = (kk & 1) ? __uint_as_float(word & 0xFFFF0000u) : __uint_as_float(word << 16);
          if (mine && k < K) v = fmaf(rnd<true>(av[kk]), w, v);
        }
      }
      if (K % TK) v = fmaf(0.f, 0.f, v);
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (mine && u == q) accf[u] = v;
    }
  }
  if constexpr (FULLT) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) out2(accf[4 * j + e], accf[4 * j + 2 + e], 8 * j + 2 * t4 + e, mf, bf);
  }
  if constexpr (PART) {
    if (mq < op.M) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          out2(accp[4 * j + e], accp[4 * j + 2 + e], wg * 16 + 8 * j + 2 * t4 + e, mq, bq);
    }
  }
  __syncthreads();
}

// The mu/logvar head's forward on FMA, each output as gemm computes it
// (one chain over k in order from zero, rounded activations times the bf16
// copy's weights, then the bias), two outputs a thread: z = mu + eps
// e^(logvar/2) is rounded to bf16 for dec_0 and its inputs come through
// exp, so the head keeps the FMA engine's order where the wgmma products
// fix only their near-ties
__device__ __forceinline__ void head_fma(const float* __restrict__ P,
                                         const bf16* __restrict__ Pb) {
  static_assert(R * Z2 == 2 * NT && H2 % 4 == 0, "two outputs a thread");
  const int r = threadIdx.x >> 3, j = 2 * (threadIdx.x & 7);
  const float* h = sm + S_HCAT + r * H2;
  const unsigned* w = reinterpret_cast<const unsigned*>(Pb + w_off(L_ML) + j);
  float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
  for (int k = 0; k < H2; k += 4) {
    const float4 hv = *reinterpret_cast<const float4*>(h + k);
    const float hk[4] = {rnd<true>(hv.x), rnd<true>(hv.y), rnd<true>(hv.z), rnd<true>(hv.w)};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned wv = __ldg(w + (k + u) * (Z2 / 2));
      a0 = fmaf(hk[u], __uint_as_float(wv << 16), a0);
      a1 = fmaf(hk[u], __uint_as_float(wv & 0xFFFF0000u), a1);
    }
  }
  const float* b = P + b_off(L_ML) + j;
  sm[S_ML + r * Z2 + j] = a0 + b[0];
  sm[S_ML + r * Z2 + j + 1] = a1 + b[1];
  __syncthreads();
}

// the forward product of layer L on wgmma (RELU: relu, and the near-tie
// fix of the activations it hands on)
template <int L, bool RELU = true>
__device__ __forceinline__ void fwd_tc(const float* in, int ldi, const float* P, const bf16* Pb,
                                       float* out, int ldo) {
  constexpr int fi = layer_in(L), fo = layer_out(L), off = w_off(L);
  static_assert(fo < 64 || fo / 64 == 2, "no tile of 64 outputs alone");
  wg_product<true, 0, ks_of(fi), (fo >= 128), (fo % 64 != 0), RELU>(
      WOp{Pb + off, fo, fo, fi}, in, ldi, out, ldo, P + b_off(L), RELU, nullptr, 0, nullptr, 0);
}

// the activation-gradient product of layer L for its inputs nf .. nf + NC
// on wgmma (agrad's)
template <int L, int RO, int NC>
__device__ __forceinline__ void ag_tc(const bf16* Pb, int nf, const float* dy, int ldy,
                                      float* d_in, int ldd, const float* add, int lda,
                                      const float* mask, int ldm) {
  constexpr int fo = layer_out(L), off = w_off(L);
  static_assert(NC < 64 || NC / 64 == 2, "no tile of 64 outputs alone");
  wg_product<false, RO, ks_of(fo), (NC >= 128), (NC % 64 != 0), false>(
      WOp{Pb + off + nf * fo, fo, NC, fo}, dy, ldy, d_in, ldd, nullptr, false, add, lda, mask,
      ldm);
}

// forward layer over the step's rows on float32 FMA: out = act(in . W + b),
// B from the bf16 copy Pb of the weights when it is given
template <bool BF, int L>
__device__ void fwd(const float* in, int ldi, const float* P, const bf16* Pb, float* out,
                    int ldo, bool relu) {
  constexpr int fi = layer_in(L), fo = layer_out(L);
  gemm<BF, BF>(R, fo, fi, in, ldi, 1, P + w_off(L), fo, 1, out, ldo, false, P + b_off(L),
               relu, nullptr, 0, nullptr, 0, Pb ? Pb + w_off(L) : nullptr);
}

// the bias gradient colsum(dy) of layer L into the block's running sums
// (written on the first step, added after), each column one thread's sum
// over the rows in order.  BD (the biasdot knob) sums the bf16-rounded dy,
// as a ones-row product does
template <bool BD, int L>
__device__ __forceinline__ void bias_sum(const float* dy, int ldy, bool accum) {
  constexpr int fo = layer_out(L);
  float* bs = sm + S_BSUM + bs_off(L);
  for (int n = threadIdx.x; n < fo; n += NT) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += rnd<BD>(dy[r * ldy + n]);
    bs[n] = accum ? bs[n] + s : s;
  }
}

// weight gradient in^T . dy of layer L on float32 FMA (in rounded to bf16
// when RA, dy when RB), into the chunk's partial row (written on the first
// step, added after), and its bias gradient
template <bool RA, bool RB, bool BD, int L>
__device__ void wgrad(const float* in, int ldi, const float* dy, int ldy, float* part,
                      bool accum) {
  constexpr int fi = layer_in(L), fo = layer_out(L);
  bias_sum<BD, L>(dy, ldy, accum);
  gemm<RA, RB, 0, false, true>(fi, fo, R, in, 1, ldi, dy, ldy, 1, part + w_off(L), fo,
                               accum, nullptr, false, nullptr, 0, nullptr, 0);
}

// R rows of `width` float32 values (row stride lds, even) into the scratch
// rows at dst (row stride SCR_ROW), rounded to bf16, 8 values (16 bytes) a
// store: the pad up to pad8(width) takes whatever follows the row in shared
// memory, which only the deferred product's discarded rows and columns read
__device__ __forceinline__ void to_scratch(const float* src, int lds, int width, bf16* dst) {
  const int oct = (width + 7) / 8;
  for (int i = threadIdx.x; i < R * oct; i += NT) {
    const int r = i / oct, c = 8 * (i % oct);
    const float* s = src + r * lds + c;
    uint4 v;
    unsigned* w = reinterpret_cast<unsigned*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = *reinterpret_cast<const float2*>(s + 2 * e);
      const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
      w[e] = *reinterpret_cast<const unsigned*>(&b);
    }
    *reinterpret_cast<uint4*>(dst + (long long)r * SCR_ROW + c) = v;
  }
}

// the deferred weight gradient of layer L: this step's in and dy, rounded
// to bf16, into its rows of the chunk's scratch (the product over all the
// chunk's rows runs once, at its end: wgrad_deferred), and its bias
// gradient now
template <bool BD, int L>
__device__ void wgrad_defer(const float* in, int ldi, const float* dy, int ldy, bf16* scr,
                            bool accum) {
  bias_sum<BD, L>(dy, ldy, accum);
  to_scratch(in, ldi, layer_in(L), scr + scr_in(L));
  to_scratch(dy, ldy, layer_out(L), scr + scr_dy(L));
  __syncthreads();
}

// The deferred weight gradient of one layer (fan-in M, fan-out N, its
// scratch columns in_col and dy_col, its weights at w_off) over the chunk's
// scratch rows k_lo .. k_hi (a multiple of R): part[w_off..] = in^T . dy,
// written once, on the tensor cores.  Tiles of DM x DN, warp w computing
// rows (w % 4) 32 .. + 32 and columns (w / 4) 64 .. + 64; the depth (the
// rows) in steps of DK through a ring of D_S slots over the step's
// buffers, by cp.async from the scratch.  A(m, k) = in of row k, column m:
// staged [k][m] and read by ldmatrix.trans, or under dwT (DWT) transposed
// by the threads into [m][k] and read by ldmatrix: the same values into
// the same products, so the same sums bit for bit.  One instance for all
// layers (not inlined), to keep the objects' build short.
template <bool DWT>
__device__ __noinline__ void wgrad_deferred(const bf16* scr, int k_lo, int k_hi, float* part,
                                            int M, int N, int in_col, int dy_col, int w_off) {
  const int MP = pad8(M), NP = pad8(N);
  char* ring = reinterpret_cast<char*>(sm);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int mat = lane >> 3, r8 = lane & 7, g = lane >> 2, t4 = lane & 3;
  const int nsteps = (k_hi - k_lo + DK - 1) / DK;
  const int tiles_m = (M + DM - 1) / DM, tiles_n = (N + DN - 1) / DN;
  for (int tile = 0; tile < tiles_m * tiles_n; ++tile) {
    const int m0 = (tile / tiles_n) * DM, n0 = (tile % tiles_n) * DN;
    auto stage = [&](int s) {
      char* slot = ring + (s % D_S) * D_SLOT;
      bf16* As = reinterpret_cast<bf16*>(slot);
      bf16* Bs = reinterpret_cast<bf16*>(slot + D_A_BYTES);
      const int k0 = k_lo + s * DK;
      if constexpr (DWT) {
        for (int i = tid; i < DM * DK / 2; i += NT) {
          const int mm = i / (DK / 2), kk = 2 * (i % (DK / 2));
          const int m = m0 + mm, k = k0 + kk;
          bf16 v0 = __float2bfloat16_rn(0.f), v1 = v0;
          if (m < MP) {
            const bf16* a = scr + (long long)k * SCR_ROW + in_col + m;
            if (k < k_hi) v0 = a[0];
            if (k + 1 < k_hi) v1 = a[SCR_ROW];
          }
          As[mm * D_AK + kk] = v0;
          As[mm * D_AK + kk + 1] = v1;
        }
      } else {
        for (int i = tid; i < DK * DM / 8; i += NT) {
          const int kk = i / (DM / 8), mm = 8 * (i % (DM / 8));
          const int k = k0 + kk, m = m0 + mm;
          const bool ok = k < k_hi && m < MP;
          cp_async16(As + kk * D_AM + mm,
                     ok ? scr + (long long)k * SCR_ROW + in_col + m : scr, ok ? 16 : 0);
        }
      }
      for (int i = tid; i < DK * DN / 8; i += NT) {
        const int kk = i / (DN / 8), nn = 8 * (i % (DN / 8));
        const int k = k0 + kk, n = n0 + nn;
        const bool ok = k < k_hi && n < NP;
        cp_async16(Bs + kk * D_BN + nn,
                   ok ? scr + (long long)k * SCR_ROW + dy_col + n : scr, ok ? 16 : 0);
      }
    };
    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
    // warps whose rows or columns all lie past the layer's compute nothing
    const bool rows_live = m0 + wm * 32 < M, cols_live = n0 + wn * 64 < N;
    __syncthreads();  // the step's buffers, or the last tile's slots, are free
#pragma unroll
    for (int s = 0; s < D_S - 1; ++s) {
      if (s < nsteps) stage(s);
      cp_commit();
    }
    for (int s = 0; s < nsteps; ++s) {
      cp_wait<D_S - 2>();
      __syncthreads();
      if (s + D_S - 1 < nsteps) stage(s + D_S - 1);
      cp_commit();
      if (!(rows_live && cols_live)) continue;
      const char* slot = ring + (s % D_S) * D_SLOT;
      const bf16* As = reinterpret_cast<const bf16*>(slot);
      const bf16* Bs = reinterpret_cast<const bf16*>(slot + D_A_BYTES);
#pragma unroll
      for (int kk = 0; kk < DK; kk += 16) {
        unsigned a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int mb = wm * 32 + i * 16;
          if constexpr (DWT)
            ldsm4(a[i], As + (mb + (mat & 1) * 8 + r8) * D_AK + kk + (mat >> 1) * 8);
          else
            ldsm4t(a[i], As + (kk + (mat >> 1) * 8 + r8) * D_AM + mb + (mat & 1) * 8);
        }
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          const int nb = wn * 64 + jp * 16;
          if (n0 + nb >= N) break;
          unsigned b[4];
          ldsm4t(b, Bs + (kk + (mat & 1) * 8 + r8) * D_BN + nb + (mat >> 1) * 8);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma16816_add(acc[i][2 * jp], a[i], b[0], b[1]);
            mma16816_add(acc[i][2 * jp + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
    if (rows_live && cols_live) {
      float* W = part + w_off;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = n0 + wn * 64 + j * 8 + 2 * t4;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + wm * 32 + i * 16 + g + 8 * h;
            if (m >= M || n >= N) continue;
            // N is even, so the pair lies inside the row
            *reinterpret_cast<float2*>(W + (long long)m * N + n) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          }
        }
    }
  }
  __syncthreads();
}

// the deferred weight gradients of every layer over the chunk's scratch
// rows k_lo .. k_hi
template <bool DWT, int L = 0>
__device__ __forceinline__ void wgrads_deferred(const bf16* scr, int k_lo, int k_hi,
                                                float* part) {
  if constexpr (L < 11) {
    wgrad_deferred<DWT>(scr, k_lo, k_hi, part, layer_in(L), layer_out(L), scr_in(L),
                        scr_dy(L), w_off(L));
    wgrads_deferred<DWT, L + 1>(scr, k_lo, k_hi, part);
  }
}

// the block's bias-gradient sums into its partial row, layer by layer with
// each offset a constant
template <int L = 0>
__device__ __forceinline__ void write_bias_sums(float* part) {
  if constexpr (L == 11) {
    __syncthreads();
  } else {
    for (int n = threadIdx.x; n < layer_out(L); n += NT)
      part[b_off(L) + n] = sm[S_BSUM + bs_off(L) + n];
    write_bias_sums<L + 1>(part);
  }
}

// the weight and bias gradient of the manual backward under knobs AB:
// deferred to the chunk's end (DEFER: the bf16 instances), else on float32
// FMA now
template <bool BF, bool DEFER, int AB, int L>
__device__ __forceinline__ void wgrad_ab(const float* in, int ldi, const float* dy, int ldy,
                                         float* part, bf16* scr, bool accum) {
  constexpr bool BD = (AB & K_BIASDOT) != 0;
  if constexpr (DEFER) {
    wgrad_defer<BD, L>(in, ldi, dy, ldy, scr, accum);
  } else {
    wgrad<BF, BF, BD, L>(in, ldi, dy, ldy, part, accum);
  }
}

// activation gradient of layer L for inputs n_first .. n_first + n_cnt on
// float32 FMA: d_in = (dy . W[n_first:, :]^T (+ add)) * (mask > 0),
// operands rounded when RA / RB (B from the bf16 copy Pb when it is given),
// the output as gemm's RO says
template <bool RA, bool RB, int RO, int L>
__device__ void agrad(const float* dy, int ldy, const float* P, const bf16* Pb, int n_first,
                      int n_cnt, float* d_in, int ldd, const float* add, int lda,
                      const float* mask, int ldm) {
  constexpr int fo = layer_out(L);
  const int off = w_off(L) + n_first * fo;
  gemm<RA, RB, RO>(R, n_cnt, fo, dy, ldy, 1, P + off, 1, fo, d_in, ldd, false, nullptr,
                   false, add, lda, mask, ldm, Pb ? Pb + off : nullptr);
}

__device__ __forceinline__ void philox(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) { k0 += 0x9E3779B9u; k1 += 0xBB67AE85u; }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0; c[1] = lo1; c[2] = n2; c[3] = lo0;
  }
}

enum Noise { PACKED = 0, HBM = 1, PRNG = 2 };

struct LossW { float recon, kld, start, time; };

// a thread's share of the five loss sums of its block's rows
struct LossAcc { float rec = 0.f, kld = 0.f, start = 0.f, t0 = 0.f, tinc = 0.f; };

// the loss's cotangent coefficients at the global scale S = 1 / n_valid
struct LossCoef { float rec, start, t0, td, kS; };

__device__ __forceinline__ LossCoef loss_coef(LossW lw, float S) {
  return {lw.recon * 2.f * S / (float)F, lw.start * S, lw.time * 2.f * S,
          -lw.time * S / (float)(T - 1),  // d max(-dt, 0)/d dt where dt < 0
          lw.kld * S / (float)Z};
}

// stage the rows r0 .. r0 + R of the packed corpus into X, CND and MSK and
// their noise into EPS (rows past the corpus: zeros, mask 0)
template <bool BF>
__device__ __forceinline__ void load_step(const typename Elem<BF>::type* __restrict__ packed,
                                          int width,
                                          const typename Elem<BF>::type* __restrict__ eps_hbm,
                                          int noise, long long n_pad, int tile,
                                          unsigned long long seed_base, long long r0) {
  float* X = sm + S_X;
  float* CND = sm + S_CND;
  float* MSK = sm + S_MSK;
  float* EPS = sm + S_EPS;
  const int tid = threadIdx.x;
  for (int i = tid; i < R * W_IN; i += NT) {
    const int r = i / W_IN, j = i % W_IN;
    const long long row = r0 + r;
    const float v = row < n_pad ? to_f(packed[row * width + j]) : 0.f;
    if (j < F) X[r * F + j] = v;
    else if (j < F + C) CND[r * C + (j - F)] = v;
    else MSK[r] = v;
  }
  if (noise == PRNG) {
    for (int i = tid; i < R * (Z / 4); i += NT) {
      const int r = i / (Z / 4), g = i % (Z / 4);
      const long long row = r0 + r;
      float* out = EPS + r * Z + 4 * g;
      if (row >= n_pad) {
        out[0] = out[1] = out[2] = out[3] = 0.f;
        continue;
      }
      // tile i of the epoch is philox_normal(seed_base + i, 0, tile, Z)
      const unsigned long long s = seed_base + (unsigned long long)(row / tile);
      uint32_t c[4] = {0u, (uint32_t)(row % tile), (uint32_t)g, 0u};
      philox(c, (uint32_t)(s & 0xFFFFFFFFull), (uint32_t)(s >> 32));
      const float scale = 1.f / 16777216.f;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float u1 = (float)((c[2 * p] >> 8) + 1u) * scale;
        const float u2 = (float)(c[2 * p + 1] >> 8) * scale;
        const float rr = sqrtf(-2.f * logf(u1));
        const float th = 6.2831853071795862f * u2;
        out[2 * p] = rr * cosf(th);
        out[2 * p + 1] = rr * sinf(th);
      }
    }
  } else {
    for (int i = tid; i < R * Z; i += NT) {
      const int r = i / Z, j = i % Z;
      const long long row = r0 + r;
      float v = 0.f;
      if (row < n_pad)
        v = noise == HBM ? to_f(eps_hbm[row * Z + j]) : to_f(packed[row * width + W_IN + j]);
      EPS[i] = v;
    }
  }
  __syncthreads();
}

// the forward of the staged rows: every activation into its buffer
template <bool BF, bool TC = false>
__device__ __forceinline__ void forward_step(const float* __restrict__ P,
                                             const bf16* __restrict__ Pb) {
  float* X = sm + S_X;
  float* CND = sm + S_CND;
  float* EPS = sm + S_EPS;
  float* C0 = sm + S_C0;
  float* HCAT = sm + S_HCAT;
  float* E0 = sm + S_E0;
  float* E1 = sm + S_E1;
  float* E2 = sm + S_E2;
  float* ML = sm + S_ML;
  float* GINb = sm + S_GIN;
  float* G1 = sm + S_G1;
  float* G2 = sm + S_G2;
  float* G3 = sm + S_G3;
  float* REC = sm + S_REC;
  const int tid = threadIdx.x;
  if constexpr (TC) {
    fwd_tc<L_C0>(CND, C, P, Pb, C0, H);
    fwd_tc<L_C1>(C0, H, P, Pb, HCAT + H, H2);
    fwd_tc<L_E0>(X, F, P, Pb, E0, H);
    fwd_tc<L_E1>(E0, H, P, Pb, E1, H);
    fwd_tc<L_E2>(E1, H, P, Pb, E2, H);
    fwd_tc<L_E3>(E2, H, P, Pb, HCAT, H2);
    head_fma(P, Pb);
  } else {
    fwd<BF, L_C0>(CND, C, P, Pb, C0, H, true);
    fwd<BF, L_C1>(C0, H, P, Pb, HCAT + H, H2, true);   // hc -> hcat[:, H:]
    fwd<BF, L_E0>(X, F, P, Pb, E0, H, true);
    fwd<BF, L_E1>(E0, H, P, Pb, E1, H, true);
    fwd<BF, L_E2>(E1, H, P, Pb, E2, H, true);
    fwd<BF, L_E3>(E2, H, P, Pb, HCAT, H2, true);       // h -> hcat[:, :H]
    fwd<BF, L_ML>(HCAT, H2, P, Pb, ML, Z2, false);     // [mu | logvar]
  }
  for (int i = tid; i < R * GIN; i += NT) {
    const int r = i / GIN, j = i % GIN;
    GINb[i] = j < Z ? ML[r * Z2 + j] + EPS[r * Z + j] * expf(0.5f * ML[r * Z2 + Z + j])
                    : HCAT[r * H2 + H + (j - Z)];
  }
  __syncthreads();
  if constexpr (TC) {
    fwd_tc<L_D0>(GINb, GIN, P, Pb, G1, H);
    fwd_tc<L_D1>(G1, H, P, Pb, G2, H);
    fwd_tc<L_D2>(G2, H, P, Pb, G3, H);
    fwd_tc<L_D3, false>(G3, H, P, Pb, REC, F);  // recon: float32 into the loss
  } else {
    fwd<BF, L_D0>(GINb, GIN, P, Pb, G1, H, true);
    fwd<BF, L_D1>(G1, H, P, Pb, G2, H, true);
    fwd<BF, L_D2>(G2, H, P, Pb, G3, H, true);
    fwd<BF, L_D3>(G3, H, P, Pb, REC, F, false);
  }
}

// the step's loss sums into `a`; with DREC_OUT the fused d_recon into DREC
// (rounded to bf16 when DREC_RND, the chaincd knob); with DIR_OUT the loss's
// direct cotangent in x into DIR: -(recon - x) (c_rec + c_start on the
// start columns), the part of d_recon that reaches x without the network
template <bool DREC_OUT, bool DREC_RND, bool DIR_OUT>
__device__ __forceinline__ void loss_step(LossAcc& a, const LossCoef& k, float* DIR) {
  const float* X = sm + S_X;
  const float* MSK = sm + S_MSK;
  const float* ML = sm + S_ML;
  const float* REC = sm + S_REC;
  float* DREC = sm + S_DREC;
  const int tid = threadIdx.x;
  for (int i = tid; i < R * F; i += NT) {
    const int r = i / F, f = i % F;
    const float m = MSK[r];
    const float rv = REC[i], d = rv - X[i];
    const bool is_start = (f == 1 || f == 2);
    a.rec += m * (d * d);
    if (is_start) a.start += m * (d * d);
    if (f == 0) a.t0 += m * (rv * rv);
    float g = m * (d * (k.rec + (is_start ? k.start : 0.f)) + rv * (f == 0 ? k.t0 : 0.f));
    if constexpr (DIR_OUT) DIR[i] = -(m * (d * (k.rec + (is_start ? k.start : 0.f))));
    if (f % D == 0) {
      const int j = f / D;
      if (j >= 1 && rv - REC[i - D] < 0.f) g += k.td * m;
      if (j <= T - 2) {
        const float td = REC[i + D] - rv;
        a.tinc += m * fmaxf(-td, 0.f);
        if (td < 0.f) g -= k.td * m;
      }
    }
    if constexpr (DREC_OUT) DREC[i] = rnd<DREC_RND>(g);
  }
  for (int i = tid; i < R * Z; i += NT) {
    const int r = i / Z, j = i % Z;
    const float mu = ML[r * Z2 + j], lv = ML[r * Z2 + Z + j];
    a.kld += MSK[r] * (1.f + lv - mu * mu - expf(lv));
  }
  __syncthreads();
}

// the μ/logσ² head's cotangents, into ML over [mu | logvar]:
// d_mu = dz + wk S/Z m mu; d_lv = dz eps sd/2 - wk S/(2Z) m (1 - e^lv),
// with dz the first Z columns of GIN's cotangent
__device__ __forceinline__ void head_grad(float kS) {
  const float* MSK = sm + S_MSK;
  const float* EPS = sm + S_EPS;
  const float* GINb = sm + S_GIN;
  float* ML = sm + S_ML;
  for (int i = threadIdx.x; i < R * Z; i += NT) {
    const int r = i / Z, j = i % Z;
    const float m = MSK[r];
    const float mu = ML[r * Z2 + j], lv = ML[r * Z2 + Z + j];
    const float dz = GINb[r * GIN + j];
    const float sd = expf(0.5f * lv);
    ML[r * Z2 + j] = dz + kS * m * mu;
    ML[r * Z2 + Z + j] = dz * EPS[i] * (0.5f * sd) - (0.5f * kS) * m * (1.f - expf(lv));
  }
  __syncthreads();
}

// K3's manual backward of the step (ops/manual_grad.py, phase by phase),
// each cotangent overwriting its activation; the weight gradients deferred
// into the scratch rows scr (DEFER) or on float32 FMA into part.  Knobs
// (template bits AB): K_BIASDOT sums rounded dy for the biases; K_CHAINCD
// rounds each activation gradient's output to bf16 (and the sum of hc's
// two cotangents); K_NODW skips every weight and bias gradient and adds
// the chains' last cotangents into `chk` instead; K_DWT changes only the
// deferred products (wgrad_deferred).
template <bool BF, bool DEFER, int AB>
__device__ __forceinline__ void backward_step(const float* __restrict__ P,
                                              const bf16* __restrict__ Pb, float* part,
                                              bf16* scr, bool accum, float kS, float& chk) {
  constexpr bool NODW = (AB & K_NODW) != 0, TC = step_wgmma(BF, AB);
  constexpr int RO1 = (AB & K_CHAINCD) ? 1 : 0, RO2 = (AB & K_CHAINCD) ? 2 : 0;
  float* X = sm + S_X;
  float* CND = sm + S_CND;
  float* C0 = sm + S_C0;
  float* HCAT = sm + S_HCAT;
  float* E0 = sm + S_E0;
  float* E1 = sm + S_E1;
  float* E2 = sm + S_E2;
  float* ML = sm + S_ML;
  float* GINb = sm + S_GIN;
  float* G1 = sm + S_G1;
  float* G2 = sm + S_G2;
  float* G3 = sm + S_G3;
  float* DREC = sm + S_DREC;
#define KS_WG(L, in, ldi, dy, ldy) \
  if constexpr (!NODW) wgrad_ab<BF, DEFER, AB, L>(in, ldi, dy, ldy, part, scr, accum)

  // ---- decoder ------------------------------------------------------------
  KS_WG(L_D3, G3, H, DREC, F);
  if constexpr (TC) ag_tc<L_D3, RO1, H>(Pb, 0, DREC, F, G3, H, nullptr, 0, G3, H);
  else agrad<BF, BF, RO1, L_D3>(DREC, F, P, Pb, 0, H, G3, H, nullptr, 0, G3, H);
  KS_WG(L_D2, G2, H, G3, H);
  if constexpr (TC) ag_tc<L_D2, RO1, H>(Pb, 0, G3, H, G2, H, nullptr, 0, G2, H);
  else agrad<BF, BF, RO1, L_D2>(G3, H, P, Pb, 0, H, G2, H, nullptr, 0, G2, H);
  KS_WG(L_D1, G1, H, G2, H);
  if constexpr (TC) ag_tc<L_D1, RO1, H>(Pb, 0, G2, H, G1, H, nullptr, 0, G1, H);
  else agrad<BF, BF, RO1, L_D1>(G2, H, P, Pb, 0, H, G1, H, nullptr, 0, G1, H);
  KS_WG(L_D0, GINb, GIN, G1, H);
  // [dz | dhc_dec]
  if constexpr (TC) ag_tc<L_D0, RO1, GIN>(Pb, 0, G1, H, GINb, GIN, nullptr, 0, nullptr, 0);
  else agrad<BF, BF, RO1, L_D0>(G1, H, P, Pb, 0, GIN, GINb, GIN, nullptr, 0, nullptr, 0);

  // ---- heads ----------------------------------------------------------------
  head_grad(kS);
  KS_WG(L_ML, HCAT, H2, ML, Z2);
  // encoder top cotangent, relu-masked by h; condition cotangent from both
  // concats, relu-masked by hc
  if constexpr (TC) {
    ag_tc<L_ML, RO1, H>(Pb, 0, ML, Z2, HCAT, H2, nullptr, 0, HCAT, H2);
    ag_tc<L_ML, RO2, H>(Pb, H, ML, Z2, HCAT + H, H2, GINb + Z, GIN, HCAT + H, H2);
  } else {
    agrad<BF, BF, RO1, L_ML>(ML, Z2, P, Pb, 0, H, HCAT, H2, nullptr, 0, HCAT, H2);
    agrad<BF, BF, RO2, L_ML>(ML, Z2, P, Pb, H, H, HCAT + H, H2, GINb + Z, GIN, HCAT + H, H2);
  }

  // ---- encoder and condition chains -----------------------------------------
  KS_WG(L_E3, E2, H, HCAT, H2);
  if constexpr (TC) ag_tc<L_E3, RO1, H>(Pb, 0, HCAT, H2, E2, H, nullptr, 0, E2, H);
  else agrad<BF, BF, RO1, L_E3>(HCAT, H2, P, Pb, 0, H, E2, H, nullptr, 0, E2, H);
  KS_WG(L_E2, E1, H, E2, H);
  if constexpr (TC) ag_tc<L_E2, RO1, H>(Pb, 0, E2, H, E1, H, nullptr, 0, E1, H);
  else agrad<BF, BF, RO1, L_E2>(E2, H, P, Pb, 0, H, E1, H, nullptr, 0, E1, H);
  KS_WG(L_E1, E0, H, E1, H);
  if constexpr (TC) ag_tc<L_E1, RO1, H>(Pb, 0, E1, H, E0, H, nullptr, 0, E0, H);
  else agrad<BF, BF, RO1, L_E1>(E1, H, P, Pb, 0, H, E0, H, nullptr, 0, E0, H);
  KS_WG(L_E0, X, F, E0, H);
  KS_WG(L_C1, C0, H, HCAT + H, H2);
  if constexpr (TC) ag_tc<L_C1, RO1, H>(Pb, 0, HCAT + H, H2, C0, H, nullptr, 0, C0, H);
  else agrad<BF, BF, RO1, L_C1>(HCAT + H, H2, P, Pb, 0, H, C0, H, nullptr, 0, C0, H);
  if constexpr (!NODW) {
    wgrad_ab<BF, DEFER, AB, L_C0>(CND, C, C0, H, part, scr, accum);
  } else {
    for (int i = threadIdx.x; i < R * H; i += NT) chk += E0[i] + C0[i];
    __syncthreads();
  }
#undef KS_WG
}

// the block's sum of one value per thread, in a fixed order (RED: NT floats)
__device__ __forceinline__ float block_sum(float v, float* RED) {
  const int tid = threadIdx.x;
  RED[tid] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) RED[tid] += RED[tid + s];
    __syncthreads();
  }
  const float out = RED[0];
  __syncthreads();
  return out;
}

// the block's five loss sums into out[0..4] (written by thread 0..4) and
// zeros into out[5..7]
__device__ __forceinline__ void write_loss_sums(const LossAcc& a, float* out) {
  float* RED = sm + S_RED;
  const int tid = threadIdx.x;
  RED[0 * NT + tid] = a.rec;
  RED[1 * NT + tid] = a.kld;
  RED[2 * NT + tid] = a.start;
  RED[3 * NT + tid] = a.t0;
  RED[4 * NT + tid] = a.tinc;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s)
      for (int q = 0; q < 5; ++q) RED[q * NT + tid] += RED[q * NT + tid + s];
    __syncthreads();
  }
  if (tid < 8) out[tid] = tid < 5 ? RED[tid * NT] : 0.f;
  __syncthreads();
}

// the epoch's metrics row [total, recon, kld, start, time, 0, 0, 0] from the
// five summed loss terms
__device__ __forceinline__ void loss_row(const float* red, float n_valid, LossW lw,
                                         float* row) {
  const float nv = n_valid;
  const float recon_l = red[0] / (nv * F);
  const float kld = -0.5f * (red[1] / (nv * Z));
  const float start_l = red[2] / (nv * 2.f);
  const float time_l = red[3] / nv + red[4] / (nv * (T - 1));
  row[0] = lw.recon * recon_l + lw.kld * kld + lw.start * start_l + lw.time * time_l;
  row[1] = recon_l; row[2] = kld; row[3] = start_l; row[4] = time_l;
  row[5] = 0.f; row[6] = 0.f; row[7] = 0.f;
}

// chunking of the padded corpus: steps of R rows, about one chunk per SM
inline long long chunk_steps(long long n_pad, int sms) {
  const long long steps = (n_pad + R - 1) / R;
  const long long per = (steps + sms - 1) / sms;
  return per < 1 ? 1 : per;
}

inline long long n_chunks_of(long long n_pad, int sms) {
  const long long steps = (n_pad + R - 1) / R;
  const long long per = chunk_steps(n_pad, sms);
  return (steps + per - 1) / per;
}

// the rows of one chunk's scratch: `steps` 32-row steps of SCR_ROW bf16
__host__ __device__ inline long long scratch_chunk(int steps) {
  return (long long)steps * R * SCR_ROW;
}

// (a) of K3 and K4: one block per chunk of `steps` 32-row steps; writes the
// chunk's partial gradients and loss sums to partial[blockIdx.x].  AB holds
// the ablation knobs of this instance (0: production).  In bf16 (BF) the
// step's products stage their weights from the bf16 copy Pb, and the
// weight gradients are deferred: each step writes its products' bf16
// operands to the chunk's rows of `scratch`, and after the last step one
// tensor-core product a layer over the chunk's rows writes the partial
// row once; in float32 each step's weight gradients go onto FMA and are
// added into the partial row.  The bias gradients are summed in shared
// memory either way and written at the end.  Under K_NOACC every step
// overwrites the chunk's gradient sums except the steps whose rows lie in
// the epoch's last tile, which add to them (the first of them
// overwriting), so a chunk that reaches the last tile holds its share of
// that tile's gradient, and the reduce reads no chunk before it.
// K_FWDONLY runs no backward and writes only the loss sums.  K_NODW writes
// the chains' checksum into every element of cond_0's bias row instead of
// gradients.
template <bool BF, int AB>
__global__ void __launch_bounds__(NT, 1)
ks_grad_kernel(const typename Elem<BF>::type* __restrict__ packed, int width,
               const typename Elem<BF>::type* __restrict__ eps_hbm, int noise,
               long long n_pad, int tile, float S, LossW lw,
               unsigned long long seed_base, const float* __restrict__ P,
               const bf16* __restrict__ Pb, float* __restrict__ partial,
               bf16* __restrict__ scratch, int steps) {
  constexpr bool NOACC = (AB & K_NOACC) != 0, FWDONLY = (AB & K_FWDONLY) != 0;
  constexpr bool NODW = (AB & K_NODW) != 0, DEFER = BF;
  float* part = partial + (long long)blockIdx.x * PART_STRIDE;
  bf16* scr = BF ? scratch + blockIdx.x * scratch_chunk(steps) : nullptr;
  LossAcc acc;
  float chk = 0.f;
  const LossCoef k = loss_coef(lw, S);
  const long long last_start = n_pad - tile;
  int first = 0, done = 0;  // the steps whose weight gradients the chunk sums

  for (int step = 0; step < steps; ++step) {
    const long long r0 = ((long long)blockIdx.x * steps + step) * R;
    if (r0 >= n_pad) break;  // the same for the whole block
    bool accum = step > 0;
    if constexpr (NOACC) accum = step > 0 && r0 - R >= last_start;
    if (!accum) first = step;
    done = step + 1;
    load_step<BF>(packed, width, eps_hbm, noise, n_pad, tile, seed_base, r0);
    forward_step<BF, step_wgmma(BF, AB)>(P, Pb);
    loss_step<!FWDONLY, (AB & K_CHAINCD) != 0, false>(acc, k, nullptr);
    if constexpr (!FWDONLY)
      backward_step<BF, DEFER, AB>(P, Pb, part, BF ? scr + (long long)step * R * SCR_ROW : nullptr,
                                   accum, k.kS, chk);
  }
  if constexpr (DEFER && !FWDONLY && !NODW) {
    wgrads_deferred<(AB & K_DWT) != 0>(scr, first * R, done * R, part);
  }
  if constexpr (!FWDONLY && !NODW) write_bias_sums(part);
  write_loss_sums(acc, part + LOSS_OFF);
  if constexpr (NODW) {
    const float s = block_sum(chk, sm + S_RED);
    for (int n = threadIdx.x; n < H; n += NT) part[b_off(L_C0) + n] = s;
  }
}

template <bool BF, int AB>
int launch_grad(const void* packed, int width, const void* eps, int noise,
                long long n_pad, int tile, float n_valid, LossW lw,
                unsigned long long seed_base, const float* P, const bf16* Pb, float* partial,
                bf16* scratch, int sms, cudaStream_t stream) {
  using E = typename Elem<BF>::type;
  if (BF && (!Pb || !scratch)) return (int)cudaErrorInvalidValue;
  const cudaError_t a = cudaFuncSetAttribute(
      ks_grad_kernel<BF, AB>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (a != cudaSuccess) return (int)a;
  const long long n_chunks = n_chunks_of(n_pad, sms);
  ks_grad_kernel<BF, AB><<<(unsigned)n_chunks, NT, SMEM_BYTES, stream>>>(
      (const E*)packed, width, (const E*)eps, noise, n_pad, tile, 1.f / n_valid, lw,
      seed_base, P, Pb, partial, scratch, (int)chunk_steps(n_pad, sms));
  return (int)cudaGetLastError();
}

// the bf16 copy of the weights, rounded to nearest even as rnd<true>
__global__ void __launch_bounds__(256) ks_weights_bf16_kernel(const float* __restrict__ P,
                                                              bf16* __restrict__ Pb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N_PARAMS) Pb[i] = __float2bfloat16_rn(P[i]);
}

inline int launch_weights_bf16(const float* P, bf16* Pb, cudaStream_t stream) {
  ks_weights_bf16_kernel<<<(N_PARAMS + 255) / 256, 256, 0, stream>>>(P, Pb);
  return (int)cudaGetLastError();
}


// ---- the autodiff instances (backward="auto") -------------------------------
//
// What JAX's jax.value_and_grad of _forward_loss computes per tile, in three
// dtype modes (MODE): A_F32 (float32), A_ACTS (f32_acts: bf16 product
// operands, float32 activations) and A_CHAIN (bf16_chain: every activation
// and cotangent bf16).  Against the manual backward:
//   - the mu and logvar heads' activation gradients are two products, each
//     rounded to bf16 in the bf16 modes, then added (and the sum rounded in
//     A_CHAIN), where the manual backward contracts the merged head once;
//   - an activation-gradient product takes its float32 cotangent as it is
//     and rounds its output to bf16 (A_ACTS; the cast's VJP), and a weight
//     gradient is bf16 activations times that float32 cotangent: the
//     product engine's staging rounds the bf16 operand only (RA / RB);
//   - the loss terms' cotangents are added term by term, the time term as
//     the two-term sum of the +-1 difference product's transpose;
//   - in A_CHAIN the forward rounds each product, adds the bf16 bias and
//     rounds again, std = bf16(exp(lv / 2)), z = bf16(mu + bf16(eps std)),
//     and every cotangent is rounded where JAX's bf16 arithmetic rounds it.
// Autodiff returns each TILE's weight gradients rounded to bf16 in the bf16
// modes (and its bias gradients in A_CHAIN): the chunks of these instances
// lie within one tile, and their reduce (fused_scale.cu) sums a tile's
// chunks in order, rounds, then adds the tiles in order.

// the forward of the staged rows in MODE: the manual instances' forward,
// or (A_CHAIN) the bf16 chain's
template <int MODE>
__device__ __forceinline__ void forward_step_auto(const float* __restrict__ P,
                                                  const bf16* __restrict__ Pb) {
  if constexpr (MODE != A_CHAIN) {
    forward_step<MODE == A_ACTS>(P, Pb);
  } else {
    float* X = sm + S_X;
    float* CND = sm + S_CND;
    float* EPS = sm + S_EPS;
    float* C0 = sm + S_C0;
    float* HCAT = sm + S_HCAT;
    float* E0 = sm + S_E0;
    float* E1 = sm + S_E1;
    float* E2 = sm + S_E2;
    float* ML = sm + S_ML;
    float* GINb = sm + S_GIN;
    float* G1 = sm + S_G1;
    float* G2 = sm + S_G2;
    float* G3 = sm + S_G3;
    float* REC = sm + S_REC;
    const int tid = threadIdx.x;
    for (int i = tid; i < R * Z; i += NT) EPS[i] = rnd<true>(EPS[i]);  // prng draws f32
    __syncthreads();
    // out = bf16(bf16(in . W) + bf16(b)), then relu
#define KS_CHAIN_FWD(L, in, ldi, out, ldo, relu)                                         \
    gemm<true, true, 2, true>(R, layer_out(L), layer_in(L), in, ldi, 1, P + w_off(L),    \
                              layer_out(L), 1, out, ldo, false, P + b_off(L), relu,      \
                              nullptr, 0, nullptr, 0, Pb ? Pb + w_off(L) : nullptr)
    KS_CHAIN_FWD(L_C0, CND, C, C0, H, true);
    KS_CHAIN_FWD(L_C1, C0, H, HCAT + H, H2, true);
    KS_CHAIN_FWD(L_E0, X, F, E0, H, true);
    KS_CHAIN_FWD(L_E1, E0, H, E1, H, true);
    KS_CHAIN_FWD(L_E2, E1, H, E2, H, true);
    KS_CHAIN_FWD(L_E3, E2, H, HCAT, H2, true);
    KS_CHAIN_FWD(L_ML, HCAT, H2, ML, Z2, false);
    for (int i = tid; i < R * GIN; i += NT) {
      const int r = i / GIN, j = i % GIN;
      if (j < Z) {
        const float sd = rnd<true>(expf(0.5f * ML[r * Z2 + Z + j]));
        GINb[i] = rnd<true>(ML[r * Z2 + j] + rnd<true>(EPS[r * Z + j] * sd));
      } else {
        GINb[i] = HCAT[r * H2 + H + (j - Z)];
      }
    }
    __syncthreads();
    KS_CHAIN_FWD(L_D0, GINb, GIN, G1, H, true);
    KS_CHAIN_FWD(L_D1, G1, H, G2, H, true);
    KS_CHAIN_FWD(L_D2, G2, H, G3, H, true);
    KS_CHAIN_FWD(L_D3, G3, H, REC, F, false);
#undef KS_CHAIN_FWD
  }
}

// the step's loss sums into `a` (as loss_step) and d_recon into DREC, the
// loss terms' cotangents added term by term: recon, start, the time
// differences' (one two-term sum, the transposed +-1 product), t0; rounded
// to bf16 in A_CHAIN (the cast of recon up to float32)
template <int MODE>
__device__ __forceinline__ void loss_step_auto(LossAcc& a, const LossCoef& k) {
  const float* X = sm + S_X;
  const float* MSK = sm + S_MSK;
  const float* ML = sm + S_ML;
  const float* REC = sm + S_REC;
  float* DREC = sm + S_DREC;
  const int tid = threadIdx.x;
  for (int i = tid; i < R * F; i += NT) {
    const int r = i / F, f = i % F;
    const float m = MSK[r];
    const float rv = REC[i], d = rv - X[i];
    const bool is_start = (f == 1 || f == 2);
    a.rec += m * (d * d);
    if (is_start) a.start += m * (d * d);
    if (f == 0) a.t0 += m * (rv * rv);
    float g = m * (k.rec * d);
    if (is_start) g += m * (k.start * d);
    if (f % D == 0) {
      const int j = f / D;
      float up = 0.f, down = 0.f;
      if (j >= 1 && rv - REC[i - D] < 0.f) up = k.td * m;
      if (j <= T - 2) {
        const float td = REC[i + D] - rv;
        a.tinc += m * fmaxf(-td, 0.f);
        if (td < 0.f) down = k.td * m;
      }
      g += up - down;
    }
    if (f == 0) g += m * (k.t0 * rv);
    DREC[i] = rnd<MODE == A_CHAIN>(g);
  }
  for (int i = tid; i < R * Z; i += NT) {
    const int r = i / Z, j = i % Z;
    const float mu = ML[r * Z2 + j], lv = ML[r * Z2 + Z + j];
    a.kld += MSK[r] * (1.f + lv - mu * mu - expf(lv));
  }
  __syncthreads();
}

// the heads' cotangents into ML over [mu | logvar], as autodiff forms them:
// d_mu = dz + (-c)(2 mu), d_lv = (dz eps) e^(lv/2) / 2 + (c - c e^lv) with
// c = -wk S/(2Z) m the kld term's cotangent; in A_CHAIN each bf16 value's
// cotangent rounded (the product dz eps, each float32 use of mu and lv, and
// the bf16 sums)
template <int MODE>
__device__ __forceinline__ void head_grad_auto(float kS) {
  constexpr bool CH = MODE == A_CHAIN;
  const float* MSK = sm + S_MSK;
  const float* EPS = sm + S_EPS;
  const float* GINb = sm + S_GIN;
  float* ML = sm + S_ML;
  for (int i = threadIdx.x; i < R * Z; i += NT) {
    const int r = i / Z, j = i % Z;
    const float c = -0.5f * kS * MSK[r];
    const float mu = ML[r * Z2 + j], lv = ML[r * Z2 + Z + j];
    const float dz = GINb[r * GIN + j];
    const float d_std = rnd<CH>(dz * EPS[i]);
    ML[r * Z2 + j] = rnd<CH>(dz + rnd<CH>(-c * (2.f * mu)));
    ML[r * Z2 + Z + j] = rnd<CH>(rnd<CH>(d_std * expf(0.5f * lv) * 0.5f) +
                                 rnd<CH>(c - c * expf(lv)));
  }
  __syncthreads();
}

// the weight and bias gradient of layer L in the autodiff instance MODE:
// in A_CHAIN deferred to the chunk's end (both operands are bf16 values),
// else on float32 FMA now, in rounded to bf16 in A_ACTS and dy as it is
template <int MODE, int L>
__device__ __forceinline__ void wgrad_auto(const float* in, int ldi, const float* dy, int ldy,
                                           float* part, bf16* scr, bool accum) {
  if constexpr (MODE == A_CHAIN) {
    wgrad_defer<false, L>(in, ldi, dy, ldy, scr, accum);
  } else {
    wgrad<MODE != A_F32, false, false, L>(in, ldi, dy, ldy, part, accum);
  }
}

// the autodiff backward of the step in MODE, each cotangent overwriting
// its activation as in backward_step.  In A_CHAIN every cotangent is a
// bf16 value (rounded where JAX's bf16 arithmetic rounds it), so its
// products take it as a rounded operand (rounding a bf16 value changes
// nothing) and its weight gradients are deferred into the scratch rows scr
// as the manual bf16 instances'; in A_ACTS the cotangents are float32, so
// the weight gradients stay on FMA, step by step into part.
template <int MODE>
__device__ __forceinline__ void backward_step_auto(const float* __restrict__ P,
                                                   const bf16* __restrict__ Pb, float* part,
                                                   bf16* scr, bool accum, float kS) {
  constexpr bool RT = MODE != A_F32;          // bf16 operands and outputs
  constexpr bool CH = MODE == A_CHAIN;        // bf16 cotangents too
  constexpr int RO = RT ? 1 : 0;              // an activation gradient's output
  constexpr int RO2 = CH ? 2 : RO;            // ... and the bf16 sum with `add`
  float* X = sm + S_X;
  float* CND = sm + S_CND;
  float* C0 = sm + S_C0;
  float* HCAT = sm + S_HCAT;
  float* E0 = sm + S_E0;
  float* E1 = sm + S_E1;
  float* E2 = sm + S_E2;
  float* ML = sm + S_ML;
  float* GINb = sm + S_GIN;
  float* G1 = sm + S_G1;
  float* G2 = sm + S_G2;
  float* G3 = sm + S_G3;
  float* DREC = sm + S_DREC;
  float* TMP = sm + S_G2;  // [R][H2] over G2 and G3, free after the decoder

  // ---- decoder ------------------------------------------------------------
  wgrad_auto<MODE, L_D3>(G3, H, DREC, F, part, scr, accum);
  agrad<CH, RT, RO, L_D3>(DREC, F, P, Pb, 0, H, G3, H, nullptr, 0, G3, H);
  wgrad_auto<MODE, L_D2>(G2, H, G3, H, part, scr, accum);
  agrad<CH, RT, RO, L_D2>(G3, H, P, Pb, 0, H, G2, H, nullptr, 0, G2, H);
  wgrad_auto<MODE, L_D1>(G1, H, G2, H, part, scr, accum);
  agrad<CH, RT, RO, L_D1>(G2, H, P, Pb, 0, H, G1, H, nullptr, 0, G1, H);
  wgrad_auto<MODE, L_D0>(GINb, GIN, G1, H, part, scr, accum);
  agrad<CH, RT, RO, L_D0>(G1, H, P, Pb, 0, GIN, GINb, GIN, nullptr, 0, nullptr, 0);

  // ---- heads: dW of the merged head is each head's own, column by column;
  // the activation gradients are the mu head's (into TMP), then the logvar
  // head's added to it ------------------------------------------------------
  head_grad_auto<MODE>(kS);
  wgrad_auto<MODE, L_ML>(HCAT, H2, ML, Z2, part, scr, accum);
  const bf16* Wml = Pb ? Pb + w_off(L_ML) : nullptr;
  gemm<CH, RT, RO>(R, H2, Z, ML, Z2, 1, P + w_off(L_ML), 1, Z2, TMP, H2, false,
                   nullptr, false, nullptr, 0, nullptr, 0, Wml);
  // the encoder's top cotangent, relu-masked by h
  gemm<CH, RT, RO2>(R, H, Z, ML + Z, Z2, 1, P + w_off(L_ML) + Z, 1, Z2, HCAT, H2, false,
                    nullptr, false, TMP, H2, HCAT, H2, Wml ? Wml + Z : nullptr);
  // hc's: hcat's part, then dec_0's added, relu-masked by hc
  gemm<CH, RT, RO2>(R, H, Z, ML + Z, Z2, 1, P + w_off(L_ML) + H * Z2 + Z, 1, Z2,
                    TMP + H, H2, false, nullptr, false, TMP + H, H2, nullptr, 0,
                    Wml ? Wml + H * Z2 + Z : nullptr);
  for (int i = threadIdx.x; i < R * H; i += NT) {
    const int r = i / H, j = i % H;
    float* hc = HCAT + r * H2 + H + j;
    const float d = rnd<CH>(GINb[r * GIN + Z + j] + TMP[r * H2 + H + j]);
    *hc = d * (*hc > 0.f ? 1.f : 0.f);
  }
  __syncthreads();

  // ---- encoder and condition chains -----------------------------------------
  wgrad_auto<MODE, L_E3>(E2, H, HCAT, H2, part, scr, accum);
  agrad<CH, RT, RO, L_E3>(HCAT, H2, P, Pb, 0, H, E2, H, nullptr, 0, E2, H);
  wgrad_auto<MODE, L_E2>(E1, H, E2, H, part, scr, accum);
  agrad<CH, RT, RO, L_E2>(E2, H, P, Pb, 0, H, E1, H, nullptr, 0, E1, H);
  wgrad_auto<MODE, L_E1>(E0, H, E1, H, part, scr, accum);
  agrad<CH, RT, RO, L_E1>(E1, H, P, Pb, 0, H, E0, H, nullptr, 0, E0, H);
  wgrad_auto<MODE, L_E0>(X, F, E0, H, part, scr, accum);
  wgrad_auto<MODE, L_C1>(C0, H, HCAT + H, H2, part, scr, accum);
  agrad<CH, RT, RO, L_C1>(HCAT + H, H2, P, Pb, 0, H, C0, H, nullptr, 0, C0, H);
  wgrad_auto<MODE, L_C0>(CND, C, C0, H, part, scr, accum);
}

// the autodiff instances' chunking: each tile's 32-row steps (the last
// one cut at the tile's end) in `cpt` chunks of `per` steps, as many
// chunks a tile as fill the SMs, so no chunk straddles a tile
inline void auto_chunking(long long n_pad, int tile, int sms, int* cpt, int* per) {
  const long long n_tiles = n_pad / tile;
  const int spt = (tile + R - 1) / R;
  long long want = sms / n_tiles;
  if (want < 1) want = 1;
  if (want > spt) want = spt;
  *per = (int)((spt + want - 1) / want);
  *cpt = (spt + *per - 1) / *per;
}

// (a) of K3's and K4's autodiff instances: block c takes steps
// (c % cpt) per .. of tile c / cpt and writes the chunk's partial
// gradients and loss sums to partial[c]; in A_CHAIN through `scratch`,
// `per` steps of rows a chunk (backward_step_auto)
template <int MODE>
__global__ void __launch_bounds__(NT, 1)
ks_grad_auto_kernel(const typename Elem<MODE != A_F32>::type* __restrict__ packed,
                    int width,
                    const typename Elem<MODE != A_F32>::type* __restrict__ eps_hbm,
                    int noise, int tile, float S, LossW lw,
                    unsigned long long seed_base, const float* __restrict__ P,
                    const bf16* __restrict__ Pb, float* __restrict__ partial,
                    bf16* __restrict__ scratch, int cpt, int per) {
  constexpr bool BF = MODE != A_F32, DEFER = MODE == A_CHAIN;
  float* part = partial + (long long)blockIdx.x * PART_STRIDE;
  bf16* scr = DEFER ? scratch + blockIdx.x * scratch_chunk(per) : nullptr;
  const int spt = (tile + R - 1) / R;
  const long long t0 = (long long)(blockIdx.x / cpt) * tile;
  const int s0 = (int)(blockIdx.x % cpt) * per;
  const int s1 = s0 + per < spt ? s0 + per : spt;
  LossAcc acc;
  const LossCoef k = loss_coef(lw, S);
  for (int s = s0; s < s1; ++s) {
    // rows past the tile's end are staged as zeros with mask 0: they add
    // exact zeros to every sum
    load_step<BF>(packed, width, eps_hbm, noise, t0 + tile, tile, seed_base,
                  t0 + (long long)s * R);
    forward_step_auto<MODE>(P, Pb);
    loss_step_auto<MODE>(acc, k);
    backward_step_auto<MODE>(P, Pb, part,
                             DEFER ? scr + (long long)(s - s0) * R * SCR_ROW : nullptr,
                             s > s0, k.kS);
  }
  if constexpr (DEFER) wgrads_deferred<false>(scr, 0, (s1 - s0) * R, part);
  write_bias_sums(part);
  write_loss_sums(acc, part + LOSS_OFF);
}

template <int MODE>
int launch_grad_auto(const void* packed, int width, const void* eps, int noise,
                     long long n_pad, int tile, float n_valid, LossW lw,
                     unsigned long long seed_base, const float* P, const bf16* Pb,
                     float* partial, bf16* scratch, int cpt, int per, cudaStream_t stream) {
  using E = typename Elem<MODE != A_F32>::type;
  if ((MODE != A_F32 && !Pb) || (MODE == A_CHAIN && !scratch)) return (int)cudaErrorInvalidValue;
  const cudaError_t a = cudaFuncSetAttribute(
      ks_grad_auto_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (a != cudaSuccess) return (int)a;
  ks_grad_auto_kernel<MODE><<<(unsigned)(n_pad / tile * cpt), NT, SMEM_BYTES, stream>>>(
      (const E*)packed, width, (const E*)eps, noise, tile, 1.f / n_valid, lw, seed_base, P,
      Pb, partial, scratch, cpt, per);
  return (int)cudaGetLastError();
}

}  // namespace

// K3's knob instances, one source compiled once per knob (fused_scale_knob.cu
// with -DKS_KNOB=<bit>): bf16 only, builtin types only across sources
#define KS_KNOB_LAUNCHER(bit)                                                      \
  int ks_launch_grad_knob_##bit(const void* packed, int width, const void* eps,   \
                                int noise, long long n_pad, int tile,             \
                                float n_valid, float w_recon, float w_kld,        \
                                float w_start, float w_time,                      \
                                unsigned long long seed_base, const float* P,     \
                                const void* Pb, float* partial, void* scratch,    \
                                int sms, void* stream)

// the autodiff instances, one source compiled once per mode
// (fused_scale_auto.cu with -DKS_AUTO_MODE=<mode>)
#define KS_AUTO_LAUNCHER(mode)                                                     \
  int ks_launch_grad_auto_##mode(const void* packed, int width, const void* eps,   \
                                 int noise, long long n_pad, int tile,             \
                                 float n_valid, float w_recon, float w_kld,        \
                                 float w_start, float w_time,                      \
                                 unsigned long long seed_base, const float* P,     \
                                 const void* Pb, float* partial, void* scratch,    \
                                 int cpt, int per, void* stream)
