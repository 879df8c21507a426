// Device code shared by the production-scale trainer (fused_scale.cu: K3,
// K4; fused_scale_knob.cu: K3's ablation knobs) and the K3 ablation's own
// kernels (scale_ablation.cu: P1, P2).  One copy, so the ablation's forward,
// loss and backward cannot drift from K3's.
//
// What lives here: the model's shape and its flat parameter layout, the
// shared-memory layout of one block (every activation of a 32-row step),
// the staged product `gemm` and its forward / weight-gradient /
// activation-gradient forms, the Philox noise, and the pieces of one step
// of K3: stage the rows, the forward, the loss sums with d_recon, the
// manual backward (with the ablation knobs as template bits), the
// autodiff backward (backward="auto", in three dtype modes), and the
// block-wide sums.  The design note of fused_scale.cu says how K3 uses
// them, and why a step is 32 rows.
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
constexpr int TMP = TM + 4, TNP = TN + 4;    // padded rows of the staged tiles

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

// K3's ablation knobs (ops/fused_scale.py::ABLATE_BITS), one bit each
enum Knob { K_NOADAM = 1, K_NOACC = 2, K_BIASDOT = 4, K_CHAINCD = 8, K_NODW = 16,
            K_FWDONLY = 32, K_DWT = 64 };

// the autodiff instances' dtype modes (ops/fused_scale.py::AUTO_MODES)
enum AutoMode { A_F32 = 0, A_ACTS = 1, A_CHAIN = 2 };

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
constexpr int S_AS = S_DREC + R * F;      // staged A tile [TK][TMP]
constexpr int S_BS = S_AS + TK * TMP;     // staged B tile [TK][TNP]
constexpr int S_RED = S_BS + TK * TNP;    // [5][NT] loss sums
constexpr int S_FLOATS = S_RED + 5 * NT;
constexpr int SMEM_BYTES = S_FLOATS * 4;
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
// the dwT knob's transposed activations [fi][R], up to GIN rows at a time
constexpr int S_TR = S_FLOATS;
constexpr int SMEM_BYTES_DWT = (S_TR + GIN * R) * 4;
static_assert(SMEM_BYTES_DWT <= 232448, "shared memory of the dwT instance");
static_assert(S_AS % 4 == 0 && S_BS % 4 == 0, "float4 tiles");

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

// C[M, N] = A[M, K] . B[K, N] with A(m, k) = A[m sam + k sak] and
// B(k, n) = B[k sbk + n sbn], so one routine serves the forward (act . W),
// the activation gradient (dY . W^T) and the weight gradient (act^T . dY).
// Each operand is staged into shared memory, rounded to bf16 when RA / RB.
// Epilogue, in order: the product rounded to bf16 when RO >= 1, + bias[n]
// (itself rounded to bf16 when RBI), + add[m lda + n], rounded again when
// RO == 2, relu, times (mask[m ldm + n] > 0), then + the old C when accum.
template <bool RA, bool RB, int RO = 0, bool RBI = false>
__device__ void gemm(int M, int N, int K,
                     const float* A, int sam, int sak,
                     const float* Bm, int sbk, int sbn,
                     float* Cm, int ldc, bool accum,
                     const float* bias, bool relu,
                     const float* add, int lda,
                     const float* mask, int ldm) {
  float* As = sm + S_AS;
  float* Bs = sm + S_BS;
  const int tid = threadIdx.x;
  const int tx = tid % 32, ty = tid / 32;
  const int tiles_m = (M + TM - 1) / TM, tiles_n = (N + TN - 1) / TN;
  const bool vec = (ldc % 4 == 0) && ((reinterpret_cast<uintptr_t>(Cm) & 15) == 0);
  for (int tile = 0; tile < tiles_m * tiles_n; ++tile) {
    const int m0 = (tile / tiles_n) * TM, n0 = (tile % tiles_n) * TN;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int k0 = 0; k0 < K; k0 += TK) {
      for (int i = tid; i < TK * TM; i += NT) {
        int kk, mm;
        if (sak == 1) { kk = i % TK; mm = i / TK; } else { kk = i / TM; mm = i % TM; }
        const int m = m0 + mm, k = k0 + kk;
        As[kk * TMP + mm] =
            (m < M && k < K) ? rnd<RA>(A[(long long)m * sam + (long long)k * sak]) : 0.f;
      }
      for (int i = tid; i < TK * TN; i += NT) {
        int kk, nn;
        if (sbn == 1) { kk = i / TN; nn = i % TN; } else { kk = i % TK; nn = i / TK; }
        const int n = n0 + nn, k = k0 + kk;
        Bs[kk * TNP + nn] =
            (n < N && k < K) ? rnd<RB>(Bm[(long long)k * sbk + (long long)n * sbn]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < TK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(As + kk * TMP + ty * 4);
        const float4 b = *reinterpret_cast<const float4*>(Bs + kk * TNP + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
      __syncthreads();
    }
    const int nb = n0 + tx * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = m0 + ty * 4 + r;
      if (m >= M) continue;
      float val[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = nb + c;
        float v = acc[r][c];
        if (n < N) {
          if constexpr (RO >= 1) v = rnd<true>(v);
          if (bias) v += rnd<RBI>(bias[n]);
          if (add) v += add[(long long)m * lda + n];
          if constexpr (RO == 2) v = rnd<true>(v);
          if (relu) v = fmaxf(v, 0.f);
          if (mask) v = v * (mask[(long long)m * ldm + n] > 0.f ? 1.f : 0.f);
        }
        val[c] = v;
      }
      float* dst = Cm + (long long)m * ldc + nb;
      if (vec && nb + 4 <= N) {
        float4 o = make_float4(val[0], val[1], val[2], val[3]);
        if (accum) {
          const float4 old = *reinterpret_cast<const float4*>(dst);
          o.x += old.x; o.y += old.y; o.z += old.z; o.w += old.w;
        }
        *reinterpret_cast<float4*>(dst) = o;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (nb + c < N) dst[c] = accum ? dst[c] + val[c] : val[c];
      }
    }
  }
  __syncthreads();
}

// forward layer over the step's rows: out = act(in . W + b)
template <bool BF, int L>
__device__ void fwd(const float* in, int ldi, const float* P, float* out, int ldo,
                    bool relu) {
  constexpr int fi = layer_in(L), fo = layer_out(L);
  gemm<BF, BF>(R, fo, fi, in, ldi, 1, P + w_off(L), fo, 1, out, ldo, false,
               P + b_off(L), relu, nullptr, 0, nullptr, 0);
}

// weight gradient in^T . dy and bias gradient colsum(dy) of layer L, into
// the chunk's partial row (written on the first step, added after).  BD
// (the biasdot knob) sums the bf16-rounded dy, as a ones-row product does
template <bool BF, bool BD, int L>
__device__ void wgrad(const float* in, int ldi, const float* dy, int ldy,
                      float* part, bool accum) {
  constexpr int fi = layer_in(L), fo = layer_out(L);
  gemm<BF, BF>(fi, fo, R, in, 1, ldi, dy, ldy, 1, part + w_off(L), fo, accum,
               nullptr, false, nullptr, 0, nullptr, 0);
  for (int n = threadIdx.x; n < fo; n += NT) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += rnd<BD>(dy[r * ldy + n]);
    part[b_off(L) + n] = accum ? part[b_off(L) + n] + s : s;
  }
  __syncthreads();
}

// the dwT knob's weight gradient: in^T written out into shared memory (up
// to GIN of its rows at a time), then a plain product over it.  It stages
// the same values into the product tiles as wgrad, so its sums are the
// same, bit for bit; the bias gradient is wgrad's.
template <bool BF, int L>
__device__ void wgrad_t(const float* in, int ldi, const float* dy, int ldy,
                        float* part, bool accum) {
  constexpr int fi = layer_in(L), fo = layer_out(L);
  float* TR = sm + S_TR;
  for (int f0 = 0; f0 < fi; f0 += GIN) {
    const int nf = fi - f0 < GIN ? fi - f0 : GIN;
    for (int i = threadIdx.x; i < nf * R; i += NT) {
      const int f = i / R, r = i % R;
      TR[i] = in[r * ldi + f0 + f];
    }
    __syncthreads();
    gemm<BF, BF>(nf, fo, R, TR, R, 1, dy, ldy, 1, part + w_off(L) + f0 * fo, fo, accum,
                 nullptr, false, nullptr, 0, nullptr, 0);
  }
  for (int n = threadIdx.x; n < fo; n += NT) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += dy[r * ldy + n];
    part[b_off(L) + n] = accum ? part[b_off(L) + n] + s : s;
  }
  __syncthreads();
}

// the weight and bias gradient of the manual backward under knobs AB
template <bool BF, int AB, int L>
__device__ __forceinline__ void wgrad_ab(const float* in, int ldi, const float* dy, int ldy,
                                         float* part, bool accum) {
  if constexpr ((AB & K_DWT) != 0) {
    wgrad_t<BF, L>(in, ldi, dy, ldy, part, accum);
  } else {
    wgrad<BF, (AB & K_BIASDOT) != 0, L>(in, ldi, dy, ldy, part, accum);
  }
}

// activation gradient of layer L for inputs n_first .. n_first + n_cnt:
// d_in = (dy . W[n_first:, :]^T (+ add)) * (mask > 0), operands rounded
// when RA / RB, the output as gemm's RO says
template <bool RA, bool RB, int RO, int L>
__device__ void agrad(const float* dy, int ldy, const float* P, int n_first,
                      int n_cnt, float* d_in, int ldd, const float* add, int lda,
                      const float* mask, int ldm) {
  constexpr int fo = layer_out(L);
  gemm<RA, RB, RO>(R, n_cnt, fo, dy, ldy, 1, P + w_off(L) + n_first * fo, 1, fo, d_in,
                   ldd, false, nullptr, false, add, lda, mask, ldm);
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
template <bool BF>
__device__ __forceinline__ void forward_step(const float* __restrict__ P) {
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
  fwd<BF, L_C0>(CND, C, P, C0, H, true);
  fwd<BF, L_C1>(C0, H, P, HCAT + H, H2, true);   // hc -> hcat[:, H:]
  fwd<BF, L_E0>(X, F, P, E0, H, true);
  fwd<BF, L_E1>(E0, H, P, E1, H, true);
  fwd<BF, L_E2>(E1, H, P, E2, H, true);
  fwd<BF, L_E3>(E2, H, P, HCAT, H2, true);       // h -> hcat[:, :H]
  fwd<BF, L_ML>(HCAT, H2, P, ML, Z2, false);     // [mu | logvar]
  for (int i = tid; i < R * GIN; i += NT) {
    const int r = i / GIN, j = i % GIN;
    GINb[i] = j < Z ? ML[r * Z2 + j] + EPS[r * Z + j] * expf(0.5f * ML[r * Z2 + Z + j])
                    : HCAT[r * H2 + H + (j - Z)];
  }
  __syncthreads();
  fwd<BF, L_D0>(GINb, GIN, P, G1, H, true);
  fwd<BF, L_D1>(G1, H, P, G2, H, true);
  fwd<BF, L_D2>(G2, H, P, G3, H, true);
  fwd<BF, L_D3>(G3, H, P, REC, F, false);
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
// each cotangent overwriting its activation.  Knobs (template bits AB):
// K_BIASDOT sums rounded dy for the biases; K_CHAINCD rounds each
// activation gradient's output to bf16 (and the sum of hc's two
// cotangents); K_NODW skips every weight and bias gradient and adds the
// chains' last cotangents into `chk` instead; K_DWT takes each weight
// gradient through an explicit transpose (wgrad_t).
template <bool BF, int AB>
__device__ __forceinline__ void backward_step(const float* __restrict__ P, float* part,
                                              bool accum, float kS, float& chk) {
  constexpr bool NODW = (AB & K_NODW) != 0;
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

  // ---- decoder ------------------------------------------------------------
  if constexpr (!NODW) wgrad_ab<BF, AB, L_D3>(G3, H, DREC, F, part, accum);
  agrad<BF, BF, RO1, L_D3>(DREC, F, P, 0, H, G3, H, nullptr, 0, G3, H);
  if constexpr (!NODW) wgrad_ab<BF, AB, L_D2>(G2, H, G3, H, part, accum);
  agrad<BF, BF, RO1, L_D2>(G3, H, P, 0, H, G2, H, nullptr, 0, G2, H);
  if constexpr (!NODW) wgrad_ab<BF, AB, L_D1>(G1, H, G2, H, part, accum);
  agrad<BF, BF, RO1, L_D1>(G2, H, P, 0, H, G1, H, nullptr, 0, G1, H);
  if constexpr (!NODW) wgrad_ab<BF, AB, L_D0>(GINb, GIN, G1, H, part, accum);
  agrad<BF, BF, RO1, L_D0>(G1, H, P, 0, GIN, GINb, GIN, nullptr, 0, nullptr, 0);  // [dz | dhc_dec]

  // ---- heads ----------------------------------------------------------------
  head_grad(kS);
  if constexpr (!NODW) wgrad_ab<BF, AB, L_ML>(HCAT, H2, ML, Z2, part, accum);
  // encoder top cotangent, relu-masked by h; condition cotangent from both
  // concats, relu-masked by hc
  agrad<BF, BF, RO1, L_ML>(ML, Z2, P, 0, H, HCAT, H2, nullptr, 0, HCAT, H2);
  agrad<BF, BF, RO2, L_ML>(ML, Z2, P, H, H, HCAT + H, H2, GINb + Z, GIN, HCAT + H, H2);

  // ---- encoder and condition chains -----------------------------------------
  if constexpr (!NODW) wgrad_ab<BF, AB, L_E3>(E2, H, HCAT, H2, part, accum);
  agrad<BF, BF, RO1, L_E3>(HCAT, H2, P, 0, H, E2, H, nullptr, 0, E2, H);
  if constexpr (!NODW) wgrad_ab<BF, AB, L_E2>(E1, H, E2, H, part, accum);
  agrad<BF, BF, RO1, L_E2>(E2, H, P, 0, H, E1, H, nullptr, 0, E1, H);
  if constexpr (!NODW) wgrad_ab<BF, AB, L_E1>(E0, H, E1, H, part, accum);
  agrad<BF, BF, RO1, L_E1>(E1, H, P, 0, H, E0, H, nullptr, 0, E0, H);
  if constexpr (!NODW) wgrad_ab<BF, AB, L_E0>(X, F, E0, H, part, accum);
  if constexpr (!NODW) wgrad_ab<BF, AB, L_C1>(C0, H, HCAT + H, H2, part, accum);
  agrad<BF, BF, RO1, L_C1>(HCAT + H, H2, P, 0, H, C0, H, nullptr, 0, C0, H);
  if constexpr (!NODW) {
    wgrad_ab<BF, AB, L_C0>(CND, C, C0, H, part, accum);
  } else {
    for (int i = threadIdx.x; i < R * H; i += NT) chk += E0[i] + C0[i];
    __syncthreads();
  }
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

// (a) of K3 and K4: one block per chunk of `steps` 32-row steps; writes the
// chunk's partial gradients and loss sums to partial[blockIdx.x].  AB holds
// the ablation knobs of this instance (0: production).  Under K_NOACC every
// step overwrites the chunk's gradient row except the steps whose rows lie
// in the epoch's last tile, which add to it (the first of them overwriting),
// so a chunk that reaches the last tile holds its share of that tile's
// gradient, and the reduce reads no chunk before it.  K_FWDONLY runs no
// backward and writes only the loss sums.  K_NODW writes the chains'
// checksum into every element of cond_0's bias row instead of gradients.
template <bool BF, int AB>
__global__ void __launch_bounds__(NT, 1)
ks_grad_kernel(const typename Elem<BF>::type* __restrict__ packed, int width,
               const typename Elem<BF>::type* __restrict__ eps_hbm, int noise,
               long long n_pad, int tile, float S, LossW lw,
               unsigned long long seed_base, const float* __restrict__ P,
               float* __restrict__ partial, int steps) {
  constexpr bool NOACC = (AB & K_NOACC) != 0, FWDONLY = (AB & K_FWDONLY) != 0;
  float* part = partial + (long long)blockIdx.x * PART_STRIDE;
  LossAcc acc;
  float chk = 0.f;
  const LossCoef k = loss_coef(lw, S);
  const long long last_start = n_pad - tile;

  for (int step = 0; step < steps; ++step) {
    const long long r0 = ((long long)blockIdx.x * steps + step) * R;
    if (r0 >= n_pad) break;  // the same for the whole block
    bool accum = step > 0;
    if constexpr (NOACC) accum = step > 0 && r0 - R >= last_start;
    load_step<BF>(packed, width, eps_hbm, noise, n_pad, tile, seed_base, r0);
    forward_step<BF>(P);
    loss_step<!FWDONLY, (AB & K_CHAINCD) != 0, false>(acc, k, nullptr);
    if constexpr (!FWDONLY) backward_step<BF, AB>(P, part, accum, k.kS, chk);
  }
  write_loss_sums(acc, part + LOSS_OFF);
  if constexpr ((AB & K_NODW) != 0) {
    const float s = block_sum(chk, sm + S_RED);
    for (int n = threadIdx.x; n < H; n += NT) part[b_off(L_C0) + n] = s;
  }
}

template <bool BF, int AB>
int launch_grad(const void* packed, int width, const void* eps, int noise,
                long long n_pad, int tile, float n_valid, LossW lw,
                unsigned long long seed_base, const float* P, float* partial,
                int sms, cudaStream_t stream) {
  using E = typename Elem<BF>::type;
  constexpr int smem = (AB & K_DWT) != 0 ? SMEM_BYTES_DWT : SMEM_BYTES;
  const cudaError_t a = cudaFuncSetAttribute(
      ks_grad_kernel<BF, AB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (a != cudaSuccess) return (int)a;
  const long long n_chunks = n_chunks_of(n_pad, sms);
  ks_grad_kernel<BF, AB><<<(unsigned)n_chunks, NT, smem, stream>>>(
      (const E*)packed, width, (const E*)eps, noise, n_pad, tile, 1.f / n_valid, lw,
      seed_base, P, partial, (int)chunk_steps(n_pad, sms));
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
__device__ __forceinline__ void forward_step_auto(const float* __restrict__ P) {
  if constexpr (MODE != A_CHAIN) {
    forward_step<MODE == A_ACTS>(P);
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
                              nullptr, 0, nullptr, 0)
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

// weight gradient in^T . dy of layer L with in rounded to bf16 when RA and
// dy taken as it is, into the chunk's partial row, and the bias gradient
// colsum(dy) in float32 (written on the first step, added after)
template <bool RA, int L>
__device__ void wgrad_auto(const float* in, int ldi, const float* dy, int ldy,
                           float* part, bool accum) {
  constexpr int fi = layer_in(L), fo = layer_out(L);
  gemm<RA, false>(fi, fo, R, in, 1, ldi, dy, ldy, 1, part + w_off(L), fo, accum,
                  nullptr, false, nullptr, 0, nullptr, 0);
  for (int n = threadIdx.x; n < fo; n += NT) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += dy[r * ldy + n];
    part[b_off(L) + n] = accum ? part[b_off(L) + n] + s : s;
  }
  __syncthreads();
}

// the autodiff backward of the step in MODE, each cotangent overwriting
// its activation as in backward_step
template <int MODE>
__device__ __forceinline__ void backward_step_auto(const float* __restrict__ P, float* part,
                                                   bool accum, float kS) {
  constexpr bool RT = MODE != A_F32;          // bf16 operands and outputs
  constexpr int RO = RT ? 1 : 0;              // an activation gradient's output
  constexpr int RO2 = MODE == A_CHAIN ? 2 : RO;  // ... and the bf16 sum with `add`
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
  wgrad_auto<RT, L_D3>(G3, H, DREC, F, part, accum);
  agrad<false, RT, RO, L_D3>(DREC, F, P, 0, H, G3, H, nullptr, 0, G3, H);
  wgrad_auto<RT, L_D2>(G2, H, G3, H, part, accum);
  agrad<false, RT, RO, L_D2>(G3, H, P, 0, H, G2, H, nullptr, 0, G2, H);
  wgrad_auto<RT, L_D1>(G1, H, G2, H, part, accum);
  agrad<false, RT, RO, L_D1>(G2, H, P, 0, H, G1, H, nullptr, 0, G1, H);
  wgrad_auto<RT, L_D0>(GINb, GIN, G1, H, part, accum);
  agrad<false, RT, RO, L_D0>(G1, H, P, 0, GIN, GINb, GIN, nullptr, 0, nullptr, 0);

  // ---- heads: dW of the merged head is each head's own, column by column;
  // the activation gradients are the mu head's (into TMP), then the logvar
  // head's added to it ------------------------------------------------------
  head_grad_auto<MODE>(kS);
  wgrad_auto<RT, L_ML>(HCAT, H2, ML, Z2, part, accum);
  gemm<false, RT, RO>(R, H2, Z, ML, Z2, 1, P + w_off(L_ML), 1, Z2, TMP, H2, false,
                      nullptr, false, nullptr, 0, nullptr, 0);
  // the encoder's top cotangent, relu-masked by h
  gemm<false, RT, RO2>(R, H, Z, ML + Z, Z2, 1, P + w_off(L_ML) + Z, 1, Z2, HCAT, H2, false,
                       nullptr, false, TMP, H2, HCAT, H2);
  // hc's: hcat's part, then dec_0's added, relu-masked by hc
  gemm<false, RT, RO2>(R, H, Z, ML + Z, Z2, 1, P + w_off(L_ML) + H * Z2 + Z, 1, Z2,
                       TMP + H, H2, false, nullptr, false, TMP + H, H2, nullptr, 0);
  for (int i = threadIdx.x; i < R * H; i += NT) {
    const int r = i / H, j = i % H;
    float* hc = HCAT + r * H2 + H + j;
    const float d = rnd<MODE == A_CHAIN>(GINb[r * GIN + Z + j] + TMP[r * H2 + H + j]);
    *hc = d * (*hc > 0.f ? 1.f : 0.f);
  }
  __syncthreads();

  // ---- encoder and condition chains -----------------------------------------
  wgrad_auto<RT, L_E3>(E2, H, HCAT, H2, part, accum);
  agrad<false, RT, RO, L_E3>(HCAT, H2, P, 0, H, E2, H, nullptr, 0, E2, H);
  wgrad_auto<RT, L_E2>(E1, H, E2, H, part, accum);
  agrad<false, RT, RO, L_E2>(E2, H, P, 0, H, E1, H, nullptr, 0, E1, H);
  wgrad_auto<RT, L_E1>(E0, H, E1, H, part, accum);
  agrad<false, RT, RO, L_E1>(E1, H, P, 0, H, E0, H, nullptr, 0, E0, H);
  wgrad_auto<RT, L_E0>(X, F, E0, H, part, accum);
  wgrad_auto<RT, L_C1>(C0, H, HCAT + H, H2, part, accum);
  agrad<false, RT, RO, L_C1>(HCAT + H, H2, P, 0, H, C0, H, nullptr, 0, C0, H);
  wgrad_auto<RT, L_C0>(CND, C, C0, H, part, accum);
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
// gradients and loss sums to partial[c]
template <int MODE>
__global__ void __launch_bounds__(NT, 1)
ks_grad_auto_kernel(const typename Elem<MODE != A_F32>::type* __restrict__ packed,
                    int width,
                    const typename Elem<MODE != A_F32>::type* __restrict__ eps_hbm,
                    int noise, int tile, float S, LossW lw,
                    unsigned long long seed_base, const float* __restrict__ P,
                    float* __restrict__ partial, int cpt, int per) {
  constexpr bool BF = MODE != A_F32;
  float* part = partial + (long long)blockIdx.x * PART_STRIDE;
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
    forward_step_auto<MODE>(P);
    loss_step_auto<MODE>(acc, k);
    backward_step_auto<MODE>(P, part, s > s0, k.kS);
  }
  write_loss_sums(acc, part + LOSS_OFF);
}

template <int MODE>
int launch_grad_auto(const void* packed, int width, const void* eps, int noise,
                     long long n_pad, int tile, float n_valid, LossW lw,
                     unsigned long long seed_base, const float* P, float* partial,
                     int cpt, int per, cudaStream_t stream) {
  using E = typename Elem<MODE != A_F32>::type;
  const cudaError_t a = cudaFuncSetAttribute(
      ks_grad_auto_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (a != cudaSuccess) return (int)a;
  ks_grad_auto_kernel<MODE><<<(unsigned)(n_pad / tile * cpt), NT, SMEM_BYTES, stream>>>(
      (const E*)packed, width, (const E*)eps, noise, tile, 1.f / n_valid, lw, seed_base, P,
      partial, cpt, per);
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
                                float* partial, int sms, void* stream)

// the autodiff instances, one source compiled once per mode
// (fused_scale_auto.cu with -DKS_AUTO_MODE=<mode>)
#define KS_AUTO_LAUNCHER(mode)                                                     \
  int ks_launch_grad_auto_##mode(const void* packed, int width, const void* eps,   \
                                 int noise, long long n_pad, int tile,             \
                                 float n_valid, float w_recon, float w_kld,        \
                                 float w_start, float w_time,                      \
                                 unsigned long long seed_base, const float* P,     \
                                 float* partial, int cpt, int per, void* stream)
