// K1 and K2: whole-run fused CVAE trainers, one thread block per training run.
//
// K1 replaces the Pallas kernel defensive_model_vae_tpu/ops/fused_trainer.py::
// _make_kernel (:326), launched there by _fused_call (:375).  Same contract:
// x (B, 30), cond (B, 2), an optional explicit eps (B, 8) held constant over
// the epochs, a seed and the initial parameters go in; the final parameters
// and one metrics row [total, recon, kld, start, time, 0, 0, 0] per epoch
// come out.  Each epoch: eps (Philox4x32-10 + Box-Muller, or the explicit
// one), the forward pass and four-term loss, the hand-written backward of
// ops/manual_grad.py (whose torch port is this kernel's written
// specification, phase by phase), and Adam with bias correction
// 1 - exp(t ln b).
//
// K2 replaces _make_multi_kernel (:454), launched by _fused_multi_call
// (:531): K1's run once per grid program over S models, each on its own
// corpus and seed.  The same grid trains S seeds of one corpus
// (fused_train_seeds, which the TPU runs as S launches of K1).
//
// Design.  The TPU kernel keeps params, Adam m and v and the activations in
// VMEM for the whole run.  On Hopper, p + m + v of the 128,942-parameter
// model come to 1.55 MB: more than one SM's 227 KB of shared memory, far
// less than the 50 MB L2.  So one run keeps them, the gradients and the
// saved activations (about B x 1.9k floats) in device memory, where they
// stay L2-resident, and runs in ONE thread block: a loop over epochs inside
// the kernel, __syncthreads() between phases, and no synchronisation
// between blocks (a grid-wide barrier deadlocks when the blocks are not all
// resident).  Each layer's product is a 64 x 64 output tile loop over
// shared-memory tiles in plain float32 FMA: no TF32 and no tensor cores,
// which keeps parity with the float32 JAX reference.  The run is one device
// function, train_run; K1 is a grid of (1,) around it and the grid kernel
// one of (S,), so K1, K2 and the seed grid cannot drift apart.
//
// K2's rows are ragged, not padded.  The TPU pads each corpus to n_max and
// masks, because a BlockSpec has one shape.  Here block s reads only its own
// B_s rows of a concatenated (sum B_s, 30) corpus through an (S+1) row-offset
// array, and its means over B_s rows are JAX's masked means with
// max(sum mask, 1) = B_s as the denominator: padded rows cost no work.  Its
// Philox counter is (epoch, row within its own corpus, group), so block s
// draws exactly what K1 draws for that corpus and seed.  The seed grid has
// no offsets: every block reads the one shared corpus.
//
// Bound.  One epoch is 758,272 B + 10 x 128,942 FLOP (the forward, dW and
// the activation gradients, then Adam): 103 MFLOP at B = 134, 309 GFLOP for
// 3000 epochs, 4.6 ms on the whole card at 67 TFLOP/s of float32 (H100 SXM);
// one SM has 1/132 of that rate, so one block cannot beat about 0.6 s.  A
// grid's blocks run side by side on their own SMs, so the largest block
// bounds it.  The bytes (inputs, params in and out, the metrics) are a few
// MB, so the work is bound by operations.  Later work closes the gap: split
// each epoch across the SMs of a cluster (distributed shared memory instead
// of a grid barrier), and tensor cores.
//
// The autodiff instance (backward="auto", JAX's _epoch_body with
// jax.value_and_grad of _forward_loss): train_run<true>, the same run with
// the arithmetic of autodiff in float32.  It differs from the manual
// backward only in summation trees (JAX ops/manual_grad.py:15-41): the mu
// and logvar heads' activation gradients are two products, added; the loss
// terms' cotangents are added term by term, the time term as the two-term
// sum of the +-1 difference product's transpose; the heads' cotangents are
// formed as autodiff forms them.  This source compiled with -DK1_AUTO
// (ops/_build.py) is its own object holding only that instance and its
// entries (the *_auto functions), so the manual instances are the code
// they were.
//
// Interface: plain C, built by nvcc into a shared library and called
// through ctypes (ops/_build.py).  The caller allocates everything.

#include <cuda_runtime.h>
#include <stdint.h>

// this object's instance: the manual backward, or with -DK1_AUTO the
// autodiff one, whose entries carry the suffix _auto
#ifdef K1_AUTO
#define K1_AUTO_BIT true
#define K1_ENTRY(name) name##_auto
#else
#define K1_AUTO_BIT false
#define K1_ENTRY(name) name
#endif

namespace {

constexpr int T = 10, D = 3, F = T * D, Z = 8, H = 128, C = 2;
constexpr int Z2 = 2 * Z, H2 = 2 * H, GIN = Z + H;
constexpr int NT = 256;                      // threads of the block
constexpr int TM = 64, TN = 64, TK = 16;     // product tile

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

// the work buffer: grads, m, v, then the activations of one epoch
struct Work {
  float *grad, *m, *v;
  float *c0, *hcat, *e0, *e1, *e2, *ml, *gin, *g1, *g2, *g3, *recon, *eps;
  float *d_recon, *buf1, *buf2, *d_gin, *d_ml, *d_hcat, *dhc;
};

__host__ __device__ long long carve(float* base, int B, Work* w) {
  // sizes in the order of Work's fields
  const long long n[22] = {
      N_PARAMS, N_PARAMS, N_PARAMS,
      (long long)B * H, (long long)B * H2, (long long)B * H, (long long)B * H,
      (long long)B * H, (long long)B * Z2, (long long)B * GIN, (long long)B * H,
      (long long)B * H, (long long)B * H, (long long)B * F, (long long)B * Z,
      (long long)B * F, (long long)B * H, (long long)B * H, (long long)B * GIN,
      (long long)B * Z2, (long long)B * H2, (long long)B * H};
  float* p[22];
  long long off = 0;
  for (int i = 0; i < 22; ++i) {
    p[i] = base ? base + off : nullptr;
    off += n[i];
  }
  if (w) {
    *w = Work{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10],
              p[11], p[12], p[13], p[14], p[15], p[16], p[17], p[18], p[19],
              p[20], p[21]};
  }
  return off;
}

// C[M, N] = A[M, K] . B[K, N] with A(m, k) = A[m sam + k sak] and
// B(k, n) = B[k sbk + n sbn], so one routine serves the forward (act . W),
// the activation gradient (dY . W^T) and the weight gradient (act^T . dY).
// Epilogue: + bias[n], then relu, or times (mask[m ldm + n] > 0).
__device__ void gemm(int M, int N, int K,
                     const float* A, int sam, int sak,
                     const float* Bm, int sbk, int sbn,
                     float* Cm, int ldc,
                     const float* bias, bool relu,
                     const float* mask, int ldm,
                     float* As, float* Bs) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int tiles_m = (M + TM - 1) / TM, tiles_n = (N + TN - 1) / TN;
  for (int tile = 0; tile < tiles_m * tiles_n; ++tile) {
    const int m0 = (tile / tiles_n) * TM, n0 = (tile % tiles_n) * TN;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int k0 = 0; k0 < K; k0 += TK) {
      for (int i = tid; i < TK * TM; i += NT) {
        const int kk = i / TM, mm = i % TM, m = m0 + mm, k = k0 + kk;
        As[i] = (m < M && k < K) ? A[(long long)m * sam + (long long)k * sak] : 0.f;
      }
      for (int i = tid; i < TK * TN; i += NT) {
        const int kk = i / TN, nn = i % TN, n = n0 + nn, k = k0 + kk;
        Bs[i] = (n < N && k < K) ? Bm[(long long)k * sbk + (long long)n * sbn] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = As[kk * TM + ty * 4 + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = Bs[kk * TN + tx * 4 + c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = m0 + ty * 4 + r, n = n0 + tx * 4 + c;
        if (m < M && n < N) {
          float val = acc[r][c];
          if (bias) val += bias[n];
          if (relu) val = fmaxf(val, 0.f);
          if (mask) val = val * (mask[(long long)m * ldm + n] > 0.f ? 1.f : 0.f);
          Cm[(long long)m * ldc + n] = val;
        }
      }
    }
  }
  __syncthreads();
}

// forward layer: out = act(in . W + b)
// (the layer is a template argument so every offset is a compile-time constant)
template <int L>
__device__ void fwd(int B, const float* in, int ldi, const float* P,
                    float* out, int ldo, bool relu, float* As, float* Bs) {
  constexpr int fi = layer_in(L), fo = layer_out(L), wo = w_off(L), bo = b_off(L);
  gemm(B, fo, fi, in, ldi, 1, P + wo, fo, 1, out, ldo, P + bo, relu, nullptr, 0,
       As, Bs);
}

// backward of one layer: dW = in^T . dy, db = colsum(dy), and when
// d_in is given, d_in = (dy . W^T) * (mask > 0) (no mask when mask is null)
template <int L>
__device__ void bwd(int B, const float* in, int ldi, const float* dy, int ldy,
                    const float* P, float* G, float* d_in, int ldd,
                    const float* mask, int ldm, float* As, float* Bs) {
  constexpr int fi = layer_in(L), fo = layer_out(L), wo = w_off(L), bo = b_off(L);
  gemm(fi, fo, B, in, 1, ldi, dy, ldy, 1, G + wo, fo, nullptr, false,
       nullptr, 0, As, Bs);
  for (int n = threadIdx.x; n < fo; n += NT) {
    float s = 0.f;
    for (int m = 0; m < B; ++m) s += dy[(long long)m * ldy + n];
    G[bo + n] = s;
  }
  if (d_in)
    gemm(B, fi, fo, dy, ldy, 1, P + wo, 1, fo, d_in, ldd, nullptr, false,
         mask, ldm, As, Bs);
  __syncthreads();
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

// One whole training run on B rows: the work of one block.  AUTO: the
// autodiff instance (the note at the top).
template <bool AUTO>
__device__ __forceinline__ void
train_run(const float* __restrict__ x, const float* __restrict__ cond,
          const float* __restrict__ eps_in, float* P,
          float* work, float* __restrict__ metrics, int B,
          int epochs, float lr, float w_recon, float w_kld, float w_start,
          float w_time, unsigned long long seed) {
  __shared__ float As[TK * TM];
  __shared__ float Bs[TK * TN];
  __shared__ float red[5][NT];
  const int tid = threadIdx.x;
  Work w;
  carve(work, B, &w);
  for (int i = tid; i < 2 * N_PARAMS; i += NT) w.m[i] = 0.f;  // m and v are adjacent
  __syncthreads();

  const float S = 1.f / (float)B;
  const uint32_t key0 = (uint32_t)(seed & 0xFFFFFFFFull), key1 = (uint32_t)(seed >> 32);
  const float LN_B1 = -0.10536051565782630f, LN_B2 = -0.0010005003335835335f;

  for (int e = 0; e < epochs; ++e) {
    // ---- noise ----------------------------------------------------------
    const float* eps = eps_in;
    if (!eps_in) {
      for (int i = tid; i < B * (Z / 4); i += NT) {
        const int b = i / (Z / 4), g = i % (Z / 4);
        uint32_t c[4] = {(uint32_t)e, (uint32_t)b, (uint32_t)g, 0u};
        philox(c, key0, key1);
        const float scale = 1.f / 16777216.f;
        float* out = w.eps + b * Z + 4 * g;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float u1 = (float)((c[2 * p] >> 8) + 1u) * scale;
          const float u2 = (float)(c[2 * p + 1] >> 8) * scale;
          const float r = sqrtf(-2.f * logf(u1));
          const float th = 6.2831853071795862f * u2;
          out[2 * p] = r * cosf(th);
          out[2 * p + 1] = r * sinf(th);
        }
      }
      eps = w.eps;
      __syncthreads();
    }

    // ---- forward ---------------------------------------------------------
    fwd<L_C0>(B, cond, C, P, w.c0, H, true, As, Bs);
    fwd<L_C1>(B, w.c0, H, P, w.hcat + H, H2, true, As, Bs);   // hc -> hcat[:, H:]
    fwd<L_E0>(B, x, F, P, w.e0, H, true, As, Bs);
    fwd<L_E1>(B, w.e0, H, P, w.e1, H, true, As, Bs);
    fwd<L_E2>(B, w.e1, H, P, w.e2, H, true, As, Bs);
    fwd<L_E3>(B, w.e2, H, P, w.hcat, H2, true, As, Bs);       // h -> hcat[:, :H]
    fwd<L_ML>(B, w.hcat, H2, P, w.ml, Z2, false, As, Bs);     // [mu | logvar]
    for (int i = tid; i < B * GIN; i += NT) {
      const int b = i / GIN, j = i % GIN;
      float val;
      if (j < Z) {
        const float mu = w.ml[b * Z2 + j], lv = w.ml[b * Z2 + Z + j];
        val = mu + eps[b * Z + j] * expf(0.5f * lv);
      } else {
        val = w.hcat[b * H2 + H + (j - Z)];
      }
      w.gin[i] = val;
    }
    __syncthreads();
    fwd<L_D0>(B, w.gin, GIN, P, w.g1, H, true, As, Bs);
    fwd<L_D1>(B, w.g1, H, P, w.g2, H, true, As, Bs);
    fwd<L_D2>(B, w.g2, H, P, w.g3, H, true, As, Bs);
    fwd<L_D3>(B, w.g3, H, P, w.recon, F, false, As, Bs);

    // ---- loss and the fused d_recon --------------------------------------
    float s_rec = 0.f, s_kld = 0.f, s_start = 0.f, s_t0 = 0.f, s_tinc = 0.f;
    const float c_rec = w_recon * 2.f * S / (float)F;
    const float c_start = w_start * S;
    const float c_t0 = w_time * 2.f * S;
    const float c_td = -w_time * S / (float)(T - 1);  // d max(-dt, 0)/d dt where dt < 0
    for (int i = tid; i < B * F; i += NT) {
      const int f = i % F;
      const float r = w.recon[i], d = r - x[i];
      s_rec += d * d;
      const bool is_start = (f == 1 || f == 2);
      if (is_start) s_start += d * d;
      if (f == 0) s_t0 += r * r;
      if constexpr (AUTO) {
        // term by term: recon, start, the time differences (one two-term
        // sum), t0
        float g = c_rec * d;
        if (is_start) g += c_start * d;
        if (f % D == 0) {
          const int j = f / D;
          float up = 0.f, down = 0.f;
          if (j >= 1 && r - w.recon[i - D] < 0.f) up = c_td;
          if (j <= T - 2) {
            const float td = w.recon[i + D] - r;
            s_tinc += fmaxf(-td, 0.f);
            if (td < 0.f) down = c_td;
          }
          g += up - down;
        }
        if (f == 0) g += c_t0 * r;
        w.d_recon[i] = g;
      } else {
        float g = d * (c_rec + (is_start ? c_start : 0.f)) + r * (f == 0 ? c_t0 : 0.f);
        if (f % D == 0) {
          const int j = f / D;
          if (j >= 1 && r - w.recon[i - D] < 0.f) g += c_td;
          if (j <= T - 2) {
            const float td = w.recon[i + D] - r;
            s_tinc += fmaxf(-td, 0.f);
            if (td < 0.f) g -= c_td;
          }
        }
        w.d_recon[i] = g;
      }
    }
    for (int i = tid; i < B * Z; i += NT) {
      const int b = i / Z, j = i % Z;
      const float mu = w.ml[b * Z2 + j], lv = w.ml[b * Z2 + Z + j];
      s_kld += 1.f + lv - mu * mu - expf(lv);
    }
    red[0][tid] = s_rec; red[1][tid] = s_kld; red[2][tid] = s_start;
    red[3][tid] = s_t0; red[4][tid] = s_tinc;
    __syncthreads();
    for (int s = NT / 2; s > 0; s >>= 1) {
      if (tid < s)
        for (int q = 0; q < 5; ++q) red[q][tid] += red[q][tid + s];
      __syncthreads();
    }
    if (tid == 0) {
      const float fB = (float)B;
      const float recon_l = red[0][0] / (fB * F);
      const float kld = -0.5f * (red[1][0] / (fB * Z));
      const float start_l = red[2][0] / (fB * 2.f);
      const float time_l = red[3][0] / fB + red[4][0] / (fB * (T - 1));
      const float total = w_recon * recon_l + w_kld * kld + w_start * start_l + w_time * time_l;
      float* row = metrics + (long long)e * 8;
      row[0] = total; row[1] = recon_l; row[2] = kld; row[3] = start_l; row[4] = time_l;
      row[5] = 0.f; row[6] = 0.f; row[7] = 0.f;
    }
    __syncthreads();

    // ---- backward: decoder -----------------------------------------------
    bwd<L_D3>(B, w.g3, H, w.d_recon, F, P, w.grad, w.buf1, H, w.g3, H, As, Bs);
    bwd<L_D2>(B, w.g2, H, w.buf1, H, P, w.grad, w.buf2, H, w.g2, H, As, Bs);
    bwd<L_D1>(B, w.g1, H, w.buf2, H, P, w.grad, w.buf1, H, w.g1, H, As, Bs);
    bwd<L_D0>(B, w.gin, GIN, w.buf1, H, P, w.grad, w.d_gin, GIN, nullptr, 0, As, Bs);

    // ---- heads: d_mu = dz + wk S/Z mu; d_lv = dz eps std/2 - wk S/(2Z)(1 - e^lv)
    const float kS = w_kld * S / (float)Z;
    for (int i = tid; i < B * Z; i += NT) {
      const int b = i / Z, j = i % Z;
      const float mu = w.ml[b * Z2 + j], lv = w.ml[b * Z2 + Z + j];
      const float dz = w.d_gin[b * GIN + j];
      const float sd = expf(0.5f * lv);
      if constexpr (AUTO) {
        const float c = -0.5f * kS;  // the kld term's cotangent
        w.d_ml[b * Z2 + j] = dz + -c * (2.f * mu);
        w.d_ml[b * Z2 + Z + j] = dz * eps[i] * sd * 0.5f + (c - c * expf(lv));
      } else {
        w.d_ml[b * Z2 + j] = dz + kS * mu;
        w.d_ml[b * Z2 + Z + j] = dz * eps[i] * (0.5f * sd) - (0.5f * kS) * (1.f - expf(lv));
      }
    }
    __syncthreads();
    if constexpr (AUTO) {
      // dW and db of the merged head are each head's own, column by column;
      // d_hcat is the mu head's product plus the logvar head's (in buf1 and
      // buf2, adjacent: B x 2H floats, free after the decoder)
      bwd<L_ML>(B, w.hcat, H2, w.d_ml, Z2, P, w.grad, nullptr, 0, nullptr, 0, As, Bs);
      gemm(B, H2, Z, w.d_ml, Z2, 1, P + w_off(L_ML), 1, Z2, w.d_hcat, H2, nullptr, false,
           nullptr, 0, As, Bs);
      gemm(B, H2, Z, w.d_ml + Z, Z2, 1, P + w_off(L_ML) + Z, 1, Z2, w.buf1, H2, nullptr,
           false, nullptr, 0, As, Bs);
      for (int i = tid; i < B * H2; i += NT) w.d_hcat[i] = w.d_hcat[i] + w.buf1[i];
      __syncthreads();
    } else {
      bwd<L_ML>(B, w.hcat, H2, w.d_ml, Z2, P, w.grad, w.d_hcat, H2, nullptr, 0, As, Bs);
    }
    // condition cotangent from both concats, relu-masked by hc
    for (int i = tid; i < B * H; i += NT) {
      const int b = i / H, j = i % H;
      const float d = w.d_gin[b * GIN + Z + j] + w.d_hcat[b * H2 + H + j];
      w.dhc[i] = d * (w.hcat[b * H2 + H + j] > 0.f ? 1.f : 0.f);
    }
    // encoder top cotangent, relu-masked by h = hcat[:, :H]
    for (int i = tid; i < B * H; i += NT) {
      const int b = i / H, j = i % H;
      w.buf1[i] = w.d_hcat[b * H2 + j] * (w.hcat[b * H2 + j] > 0.f ? 1.f : 0.f);
    }
    __syncthreads();

    // ---- backward: encoder and condition chains ----------------------------
    bwd<L_E3>(B, w.e2, H, w.buf1, H, P, w.grad, w.buf2, H, w.e2, H, As, Bs);
    bwd<L_E2>(B, w.e1, H, w.buf2, H, P, w.grad, w.buf1, H, w.e1, H, As, Bs);
    bwd<L_E1>(B, w.e0, H, w.buf1, H, P, w.grad, w.buf2, H, w.e0, H, As, Bs);
    bwd<L_E0>(B, x, F, w.buf2, H, P, w.grad, nullptr, 0, nullptr, 0, As, Bs);
    bwd<L_C1>(B, w.c0, H, w.dhc, H, P, w.grad, w.buf1, H, w.c0, H, As, Bs);
    bwd<L_C0>(B, cond, C, w.buf1, H, P, w.grad, nullptr, 0, nullptr, 0, As, Bs);

    // ---- Adam (optax defaults), bias correction 1 - exp(t ln b) -----------
    const float tf = (float)(e + 1);
    const float bc1 = 1.f - expf(tf * LN_B1), bc2 = 1.f - expf(tf * LN_B2);
    for (int i = tid; i < N_PARAMS; i += NT) {
      const float g = w.grad[i];
      const float mi = 0.9f * w.m[i] + 0.1f * g;
      const float vi = 0.999f * w.v[i] + 0.001f * g * g;
      w.m[i] = mi;
      w.v[i] = vi;
      P[i] = P[i] - lr * ((mi / bc1) / (sqrtf(vi / bc2) + 1e-8f));
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT)
k1_kernel(const float* __restrict__ x, const float* __restrict__ cond,
          const float* __restrict__ eps_in, float* P,
          float* work, float* __restrict__ metrics, int B,
          int epochs, float lr, float w_recon, float w_kld, float w_start,
          float w_time, unsigned long long seed) {
  train_run<K1_AUTO_BIT>(x, cond, eps_in, P, work, metrics, B, epochs, lr, w_recon,
                        w_kld, w_start, w_time, seed);
}

// Block s trains run s.  With row_off (S+1 offsets), its rows are
// row_off[s]..row_off[s+1] of x, cond and eps (K2); without, every block
// reads all B rows of x and cond, and rows s B..(s+1) B of eps (the seed
// grid).  Params (S, N_PARAMS), metrics (S, epochs, 8); block s's work
// region starts after those of blocks 0..s-1, whose sizes carve() gives.
__global__ void __launch_bounds__(NT)
grid_kernel(const float* __restrict__ x, const float* __restrict__ cond,
            const float* __restrict__ eps_in, const int* __restrict__ row_off,
            int B, const unsigned long long* __restrict__ seeds, float* P,
            float* work, float* __restrict__ metrics, int epochs, float lr,
            float w_recon, float w_kld, float w_start, float w_time) {
  const int s = blockIdx.x;
  long long x0 = 0, e0 = (long long)s * B;
  int n = B;
  if (row_off) {
    x0 = e0 = row_off[s];
    n = row_off[s + 1] - row_off[s];
  }
  const long long run_floats = carve(nullptr, 0, nullptr);
  const long long row_floats = carve(nullptr, 1, nullptr) - run_floats;
  train_run<K1_AUTO_BIT>(x + x0 * F, cond + x0 * C, eps_in ? eps_in + e0 * Z : nullptr,
            P + (long long)s * N_PARAMS, work + s * run_floats + e0 * row_floats,
            metrics + (long long)s * epochs * 8, n, epochs, lr, w_recon, w_kld,
            w_start, w_time, seeds[s]);
}

}  // namespace

extern "C" {

#ifndef K1_AUTO
long long k1_param_floats() { return N_PARAMS; }

long long k1_work_floats(int B) { return carve(nullptr, B, nullptr); }
#endif

// Launch K1 on `stream`; returns cudaGetLastError() of the launch.
int K1_ENTRY(k1_fused_train)(const float* x, const float* cond, const float* eps,
                   float* params, float* work, float* metrics, int B,
                   int epochs, float lr, float w_recon, float w_kld,
                   float w_start, float w_time, unsigned long long seed,
                   void* stream) {
  if (B <= 0 || epochs <= 0) return (int)cudaErrorInvalidValue;
  k1_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
      x, cond, eps, params, work, metrics, B, epochs, lr, w_recon, w_kld,
      w_start, w_time, seed);
  return (int)cudaGetLastError();
}

// K2: S runs, run s on rows row_off[s]..row_off[s+1] (device int32, S+1) of
// x, cond and eps, keyed by seeds[s] (device uint64, S).  work holds
// S k1_work_floats(0) + row_off[S] (k1_work_floats(1) - k1_work_floats(0))
// floats.
int K1_ENTRY(k2_fused_train_multi)(const float* x, const float* cond, const float* eps,
                         const int* row_off, const unsigned long long* seeds,
                         int S, float* params, float* work, float* metrics,
                         int epochs, float lr, float w_recon, float w_kld,
                         float w_start, float w_time, void* stream) {
  if (S <= 0 || epochs <= 0 || !row_off) return (int)cudaErrorInvalidValue;
  grid_kernel<<<S, NT, 0, (cudaStream_t)stream>>>(
      x, cond, eps, row_off, 0, seeds, params, work, metrics, epochs, lr,
      w_recon, w_kld, w_start, w_time);
  return (int)cudaGetLastError();
}

// K1 on a grid: S runs on the same B rows of x and cond, run s keyed by
// seeds[s] with eps rows s B..(s+1) B when eps is given.  work holds
// S k1_work_floats(B) floats.
int K1_ENTRY(k1_fused_train_seeds)(const float* x, const float* cond, const float* eps,
                         const unsigned long long* seeds, int S, float* params,
                         float* work, float* metrics, int B, int epochs,
                         float lr, float w_recon, float w_kld, float w_start,
                         float w_time, void* stream) {
  if (S <= 0 || B <= 0 || epochs <= 0) return (int)cudaErrorInvalidValue;
  grid_kernel<<<S, NT, 0, (cudaStream_t)stream>>>(
      x, cond, eps, nullptr, B, seeds, params, work, metrics, epochs, lr,
      w_recon, w_kld, w_start, w_time);
  return (int)cudaGetLastError();
}

}  // extern "C"
