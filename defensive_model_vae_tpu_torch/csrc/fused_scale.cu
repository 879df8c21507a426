// K3 and K4: the production-scale streaming CVAE trainer, for Hopper.
//
// Replaces the Pallas kernels defensive_model_vae_tpu/ops/fused_scale.py::
// _make_scale_kernel (:191, K3, launched by _fused_scale_call :310) and
// _make_grad_kernel (:500, K4, launched by _grad_epoch_call :567).  K3 is a
// whole run: per epoch, per tile of the packed corpus rows
// [x(30) | cond(2) | mask(1) (| eps(8))], the forward pass, the four-term
// loss scaled by the GLOBAL valid-row count and the hand-written backward of
// ops/manual_grad.py (its torch port is the written specification, phase by
// phase), the gradients summed over the tiles, then Adam with bias
// correction 1 - exp(t ln b) and one metrics row per epoch.  K4 is one
// epoch of that without Adam: the summed gradients and the loss row.
//
// Design.  On the TPU the grid (epochs x tiles) runs in order on one core
// and the gradient sum is carried across grid steps in VMEM.  Hopper's
// blocks run in parallel and in no order, so an epoch is two launches:
//   (a) ks_grad_kernel: the padded corpus is cut into chunks of whole
//       32-row steps, one chunk per block, about one block per SM (the
//       wrapper passes the SM count; a block needs 206 KB of shared memory,
//       so one block fills an SM).  A block runs each step's forward, loss
//       and backward with every activation of its 32 rows in shared memory
//       (the backward overwrites each saved activation with its own
//       relu-masked cotangent), reads the weights from global memory (they
//       stay in L2), and sums its weight and bias gradients and its five
//       loss sums into its own row of a (chunks, params) partial buffer:
//       the first step writes, the later ones add.
//   (b) ks_reduce_kernel: one thread per parameter sums the partial rows in
//       chunk order (so in row and tile order, and the same way every run)
//       and applies Adam (K3) or writes the sum (K4); block 0 writes the
//       epoch's metrics row.
// K3's entry point launches (a) and (b) once per epoch on the caller's
// stream.  Products are float32 FMA over shared-memory tiles (32 x 128
// outputs, depth 32, 4 x 4 outputs a thread).  In bf16 mode both operands
// of every product are rounded to bf16 (nearest even) as they are staged
// into shared memory and the product accumulates in float32: exactly the
// arithmetic of the JAX f32_acts mode and of the tensor cores' bf16 mma,
// so a later version can move the products onto wgmma without changing
// results.  Time differences, bias gradients, the head math and the loss
// stay float32.
//
// Bound (bench shape: 131,072 windows x 200 epochs, tile 2048).  The
// products are 2 (2 sum in.out + sum in.out without cond_0 and enc_0) =
// 758,272 FLOP a window-epoch, 19.9 TFLOP a run.  On the tensor cores in
// bf16 (989 TFLOP/s) that is 20.1 ms; on float32 FMA (67 TFLOP/s), the
// floor of this design, 297 ms.  The bytes that must move are the corpus
// and the eps stream, read once an epoch, ~2.15 GB a run in bf16 (0.64 ms
// at 3.35 TB/s), so operations bound it.  This design also moves the
// weights from L2 twice a step and the partial rows once (about 2 MB a
// 32-row step): its L2 traffic is of the order of its FMA time, which is
// the next thing to cut (larger steps, bf16 activations, tensor cores).
//
// Interface: plain C, built by nvcc into a shared library and called
// through ctypes (ops/_build.py).  The caller allocates everything.

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
// Both operands are staged into shared memory (rounded to bf16 when BF).
// Epilogue, in order: + bias[n], + add[m lda + n], relu, times
// (mask[m ldm + n] > 0), then + the old C when accum.
template <bool BF>
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
            (m < M && k < K) ? rnd<BF>(A[(long long)m * sam + (long long)k * sak]) : 0.f;
      }
      for (int i = tid; i < TK * TN; i += NT) {
        int kk, nn;
        if (sbn == 1) { kk = i / TN; nn = i % TN; } else { kk = i % TK; nn = i / TK; }
        const int n = n0 + nn, k = k0 + kk;
        Bs[kk * TNP + nn] =
            (n < N && k < K) ? rnd<BF>(Bm[(long long)k * sbk + (long long)n * sbn]) : 0.f;
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
          if (bias) v += bias[n];
          if (add) v += add[(long long)m * lda + n];
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
  gemm<BF>(R, fo, fi, in, ldi, 1, P + w_off(L), fo, 1, out, ldo, false,
           P + b_off(L), relu, nullptr, 0, nullptr, 0);
}

// weight gradient in^T . dy and bias gradient colsum(dy) of layer L, into
// the chunk's partial row (written on the first step, added after)
template <bool BF, int L>
__device__ void wgrad(const float* in, int ldi, const float* dy, int ldy,
                      float* part, bool accum) {
  constexpr int fi = layer_in(L), fo = layer_out(L);
  gemm<BF>(fi, fo, R, in, 1, ldi, dy, ldy, 1, part + w_off(L), fo, accum,
           nullptr, false, nullptr, 0, nullptr, 0);
  for (int n = threadIdx.x; n < fo; n += NT) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += dy[r * ldy + n];
    part[b_off(L) + n] = accum ? part[b_off(L) + n] + s : s;
  }
  __syncthreads();
}

// activation gradient of layer L for inputs n_first .. n_first + n_cnt:
// d_in = (dy . W[n_first:, :]^T (+ add)) * (mask > 0)
template <bool BF, int L>
__device__ void agrad(const float* dy, int ldy, const float* P, int n_first,
                      int n_cnt, float* d_in, int ldd, const float* add, int lda,
                      const float* mask, int ldm) {
  constexpr int fo = layer_out(L);
  gemm<BF>(R, n_cnt, fo, dy, ldy, 1, P + w_off(L) + n_first * fo, 1, fo, d_in, ldd,
           false, nullptr, false, add, lda, mask, ldm);
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

// (a): one block per chunk of `steps` 32-row steps; writes the chunk's
// partial gradients and loss sums to partial[blockIdx.x]
template <bool BF>
__global__ void __launch_bounds__(NT, 1)
ks_grad_kernel(const typename Elem<BF>::type* __restrict__ packed, int width,
               const typename Elem<BF>::type* __restrict__ eps_hbm, int noise,
               long long n_pad, int tile, float S, LossW lw,
               unsigned long long seed_base, const float* __restrict__ P,
               float* __restrict__ partial, int steps) {
  float* X = sm + S_X;
  float* CND = sm + S_CND;
  float* MSK = sm + S_MSK;
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
  float* DREC = sm + S_DREC;
  float* RED = sm + S_RED;
  const int tid = threadIdx.x;
  float* part = partial + (long long)blockIdx.x * PART_STRIDE;
  float s_rec = 0.f, s_kld = 0.f, s_start = 0.f, s_t0 = 0.f, s_tinc = 0.f;
  const float c_rec = lw.recon * 2.f * S / (float)F;
  const float c_start = lw.start * S;
  const float c_t0 = lw.time * 2.f * S;
  const float c_td = -lw.time * S / (float)(T - 1);  // d max(-dt, 0)/d dt where dt < 0
  const float kS = lw.kld * S / (float)Z;

  for (int step = 0; step < steps; ++step) {
    const long long r0 = ((long long)blockIdx.x * steps + step) * R;
    if (r0 >= n_pad) break;  // the same for the whole block
    const bool accum = step > 0;

    // ---- the step's rows (rows past the corpus: zeros, mask 0) ----------
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

    // ---- forward ---------------------------------------------------------
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

    // ---- loss sums and the fused d_recon ----------------------------------
    for (int i = tid; i < R * F; i += NT) {
      const int r = i / F, f = i % F;
      const float m = MSK[r];
      const float rv = REC[i], d = rv - X[i];
      const bool is_start = (f == 1 || f == 2);
      s_rec += m * (d * d);
      if (is_start) s_start += m * (d * d);
      if (f == 0) s_t0 += m * (rv * rv);
      float g = m * (d * (c_rec + (is_start ? c_start : 0.f)) + rv * (f == 0 ? c_t0 : 0.f));
      if (f % D == 0) {
        const int j = f / D;
        if (j >= 1 && rv - REC[i - D] < 0.f) g += c_td * m;
        if (j <= T - 2) {
          const float td = REC[i + D] - rv;
          s_tinc += m * fmaxf(-td, 0.f);
          if (td < 0.f) g -= c_td * m;
        }
      }
      DREC[i] = g;
    }
    for (int i = tid; i < R * Z; i += NT) {
      const int r = i / Z, j = i % Z;
      const float mu = ML[r * Z2 + j], lv = ML[r * Z2 + Z + j];
      s_kld += MSK[r] * (1.f + lv - mu * mu - expf(lv));
    }
    __syncthreads();

    // ---- backward: decoder (each cotangent overwrites its activation) -----
    wgrad<BF, L_D3>(G3, H, DREC, F, part, accum);
    agrad<BF, L_D3>(DREC, F, P, 0, H, G3, H, nullptr, 0, G3, H);
    wgrad<BF, L_D2>(G2, H, G3, H, part, accum);
    agrad<BF, L_D2>(G3, H, P, 0, H, G2, H, nullptr, 0, G2, H);
    wgrad<BF, L_D1>(G1, H, G2, H, part, accum);
    agrad<BF, L_D1>(G2, H, P, 0, H, G1, H, nullptr, 0, G1, H);
    wgrad<BF, L_D0>(GINb, GIN, G1, H, part, accum);
    agrad<BF, L_D0>(G1, H, P, 0, GIN, GINb, GIN, nullptr, 0, nullptr, 0);  // [dz | dhc_dec]

    // ---- heads: d_mu = dz + wk S/Z m mu; d_lv = dz eps sd/2 - wk S/(2Z) m (1 - e^lv)
    for (int i = tid; i < R * Z; i += NT) {
      const int r = i / Z, j = i % Z;
      const float m = MSK[r];
      const float mu = ML[r * Z2 + j], lv = ML[r * Z2 + Z + j];
      const float dz = GINb[r * GIN + j];
      const float sd = expf(0.5f * lv);
      ML[r * Z2 + j] = dz + kS * m * mu;
      ML[r * Z2 + Z + j] = dz * EPS[i] * (0.5f * sd) - (0.5f * kS) * m * (1.f - expf(lv));
    }
    __syncthreads();
    wgrad<BF, L_ML>(HCAT, H2, ML, Z2, part, accum);
    // encoder top cotangent, relu-masked by h; condition cotangent from both
    // concats, relu-masked by hc
    agrad<BF, L_ML>(ML, Z2, P, 0, H, HCAT, H2, nullptr, 0, HCAT, H2);
    agrad<BF, L_ML>(ML, Z2, P, H, H, HCAT + H, H2, GINb + Z, GIN, HCAT + H, H2);

    // ---- backward: encoder and condition chains ----------------------------
    wgrad<BF, L_E3>(E2, H, HCAT, H2, part, accum);
    agrad<BF, L_E3>(HCAT, H2, P, 0, H, E2, H, nullptr, 0, E2, H);
    wgrad<BF, L_E2>(E1, H, E2, H, part, accum);
    agrad<BF, L_E2>(E2, H, P, 0, H, E1, H, nullptr, 0, E1, H);
    wgrad<BF, L_E1>(E0, H, E1, H, part, accum);
    agrad<BF, L_E1>(E1, H, P, 0, H, E0, H, nullptr, 0, E0, H);
    wgrad<BF, L_E0>(X, F, E0, H, part, accum);
    wgrad<BF, L_C1>(C0, H, HCAT + H, H2, part, accum);
    agrad<BF, L_C1>(HCAT + H, H2, P, 0, H, C0, H, nullptr, 0, C0, H);
    wgrad<BF, L_C0>(CND, C, C0, H, part, accum);
  }

  // ---- the chunk's loss sums --------------------------------------------------
  RED[0 * NT + tid] = s_rec;
  RED[1 * NT + tid] = s_kld;
  RED[2 * NT + tid] = s_start;
  RED[3 * NT + tid] = s_t0;
  RED[4 * NT + tid] = s_tinc;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s)
      for (int q = 0; q < 5; ++q) RED[q * NT + tid] += RED[q * NT + tid + s];
    __syncthreads();
  }
  if (tid < 8) part[LOSS_OFF + tid] = tid < 5 ? RED[tid * NT] : 0.f;
}

// (b): sum the partial rows in chunk order; Adam (adam != 0) or the sum
// into grad_out; block 0 writes the loss row
__global__ void __launch_bounds__(256)
ks_reduce_kernel(const float* __restrict__ partial, int n_chunks, float* P, float* mv,
                 float* grad_out, float* row, int adam, float lr, float tf,
                 float n_valid, LossW lw) {
  __shared__ float red[5];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N_PARAMS) {
    float g = 0.f;
    for (int c = 0; c < n_chunks; ++c) g += partial[(long long)c * PART_STRIDE + i];
    if (adam) {
      const float LN_B1 = -0.10536051565782630f, LN_B2 = -0.0010005003335835335f;
      const float bc1 = 1.f - expf(tf * LN_B1), bc2 = 1.f - expf(tf * LN_B2);
      float* m = mv;
      float* v = mv + N_PARAMS;
      const float mi = 0.9f * m[i] + 0.1f * g;
      const float vi = 0.999f * v[i] + 0.001f * g * g;
      m[i] = mi;
      v[i] = vi;
      P[i] = P[i] - lr * ((mi / bc1) / (sqrtf(vi / bc2) + 1e-8f));
    } else {
      grad_out[i] = g;
    }
  }
  if (blockIdx.x == 0) {
    if (threadIdx.x < 5) {
      float s = 0.f;
      for (int c = 0; c < n_chunks; ++c) s += partial[(long long)c * PART_STRIDE + LOSS_OFF + threadIdx.x];
      red[threadIdx.x] = s;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const float nv = n_valid;
      const float recon_l = red[0] / (nv * F);
      const float kld = -0.5f * (red[1] / (nv * Z));
      const float start_l = red[2] / (nv * 2.f);
      const float time_l = red[3] / nv + red[4] / (nv * (T - 1));
      row[0] = lw.recon * recon_l + lw.kld * kld + lw.start * start_l + lw.time * time_l;
      row[1] = recon_l; row[2] = kld; row[3] = start_l; row[4] = time_l;
      row[5] = 0.f; row[6] = 0.f; row[7] = 0.f;
    }
  }
}

// chunking of the padded corpus: steps of R rows, about one chunk per SM
long long chunk_steps(long long n_pad, int sms) {
  const long long steps = (n_pad + R - 1) / R;
  const long long per = (steps + sms - 1) / sms;
  return per < 1 ? 1 : per;
}

long long n_chunks_of(long long n_pad, int sms) {
  const long long steps = (n_pad + R - 1) / R;
  const long long per = chunk_steps(n_pad, sms);
  return (steps + per - 1) / per;
}

template <bool BF>
int launch_grad(const void* packed, int width, const void* eps, int noise,
                long long n_pad, int tile, float n_valid, LossW lw,
                unsigned long long seed_base, const float* P, float* partial,
                int sms, cudaStream_t stream) {
  using E = typename Elem<BF>::type;
  const cudaError_t a = cudaFuncSetAttribute(
      ks_grad_kernel<BF>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (a != cudaSuccess) return (int)a;
  const long long n_chunks = n_chunks_of(n_pad, sms);
  ks_grad_kernel<BF><<<(unsigned)n_chunks, NT, SMEM_BYTES, stream>>>(
      (const E*)packed, width, (const E*)eps, noise, n_pad, tile, 1.f / n_valid, lw,
      seed_base, P, partial, (int)chunk_steps(n_pad, sms));
  return (int)cudaGetLastError();
}

int check_args(int width, const void* eps, int noise, long long n_pad, int tile,
               float n_valid, int sms) {
  const bool ok = n_pad > 0 && tile > 0 && n_pad % tile == 0 && n_valid > 0.f &&
                  sms > 0 && noise >= PACKED && noise <= PRNG &&
                  width == W_IN + (noise == PACKED ? Z : 0) &&
                  (noise != HBM || eps != nullptr);
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

long long ks_param_floats() { return N_PARAMS; }

long long ks_partial_floats() { return PART_STRIDE; }

long long ks_chunks(long long n_pad, int sms) { return n_chunks_of(n_pad, sms); }

// K3: `epochs` epochs of (a) then (b) with Adam, on `stream`.  With hbm
// noise, eps is the (epochs n_pad, Z) stream; prng keys tile i of epoch e
// by seed + e n_tiles + i.  params (n_params) is updated in place; mv is
// m then v, zeroed by the caller; metrics gets one row of 8 per epoch.
int k3_train(const void* packed, int width, const void* eps, int bf16, int noise,
             long long n_pad, int tile, float n_valid, int epochs, float lr,
             float w_recon, float w_kld, float w_start, float w_time,
             unsigned long long seed, float* params, float* mv, float* partial,
             int sms, float* metrics, void* stream) {
  int err = check_args(width, eps, noise, n_pad, tile, n_valid, sms);
  if (err || epochs <= 0) return err ? err : (int)cudaErrorInvalidValue;
  const LossW lw{w_recon, w_kld, w_start, w_time};
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n_tiles = n_pad / tile;
  const int n_chunks = (int)n_chunks_of(n_pad, sms);
  const size_t esize = bf16 ? 2 : 4;
  for (int e = 0; e < epochs; ++e) {
    const void* eps_e = noise == HBM
        ? (const void*)((const char*)eps + (size_t)e * n_pad * Z * esize) : eps;
    const unsigned long long base = seed + (unsigned long long)e * n_tiles;
    err = bf16 ? launch_grad<true>(packed, width, eps_e, noise, n_pad, tile, n_valid,
                                   lw, base, params, partial, sms, st)
               : launch_grad<false>(packed, width, eps_e, noise, n_pad, tile, n_valid,
                                    lw, base, params, partial, sms, st);
    if (err) return err;
    ks_reduce_kernel<<<(N_PARAMS + 255) / 256, 256, 0, st>>>(
        partial, n_chunks, params, mv, nullptr, metrics + (long long)e * 8, 1, lr,
        (float)(e + 1), n_valid, lw);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// K4: one epoch of (a) then (b) without Adam: the summed gradients into
// grad (n_params) and the loss row into row (8).  prng keys tile i by
// stream_base + i; with hbm noise, eps is this epoch's (n_pad, Z) stream.
int k4_grad_epoch(const void* packed, int width, const void* eps, int bf16, int noise,
                  long long n_pad, int tile, float n_valid, float w_recon,
                  float w_kld, float w_start, float w_time,
                  unsigned long long stream_base, const float* params, float* partial,
                  int sms, float* grad, float* row, void* stream) {
  int err = check_args(width, eps, noise, n_pad, tile, n_valid, sms);
  if (err) return err;
  const LossW lw{w_recon, w_kld, w_start, w_time};
  const cudaStream_t st = (cudaStream_t)stream;
  err = bf16 ? launch_grad<true>(packed, width, eps, noise, n_pad, tile, n_valid, lw,
                                 stream_base, params, partial, sms, st)
             : launch_grad<false>(packed, width, eps, noise, n_pad, tile, n_valid, lw,
                                  stream_base, params, partial, sms, st);
  if (err) return err;
  ks_reduce_kernel<<<(N_PARAMS + 255) / 256, 256, 0, st>>>(
      partial, (int)n_chunks_of(n_pad, sms), nullptr, nullptr, grad, row, 0, 0.f, 0.f,
      n_valid, lw);
  return (int)cudaGetLastError();
}

}  // extern "C"
