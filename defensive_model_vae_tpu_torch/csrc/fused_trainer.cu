// K1 and K2: whole-run fused CVAE trainers, one thread-block cluster per
// training run.
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
// (:531): K1's run once per cluster over S models, each on its own corpus
// and seed.  The same grid trains S seeds of one corpus (fused_train_seeds,
// which the TPU runs as S launches of K1).
//
// Design.  The TPU kernel keeps params, Adam m and v and the activations in
// VMEM for the whole run.  Here one run is one thread-block cluster of cs
// CTAs (1, 2, 4, 8 or 16, picked per launch from
// cudaOccupancyMaxActiveClusters: the largest size at which all S clusters
// are resident at once), looping over the epochs inside the kernel.  The
// params, m, v and the saved activations (about B x 2.6k floats) stay in
// device memory, where they are L2-resident.  Each epoch is 22 phases (the
// products of one or two layers, or an elementwise pass); the cluster
// barrier (release/acquire) ends each phase, and nothing else synchronises
// CTAs: no grid barrier, and no cluster depends on another, so S clusters
// cannot deadlock whether or not they are resident together.  Each product
// C[M, N] = A[M, K] B[K, N] is cut into cs blocks of rows x columns, the
// cut that gives each CTA the fewest operand rows and columns to load; a
// CTA streams its block's operands through shared memory in depth-32
// steps, three steps in flight by cp.async (16 bytes a copy, each operand
// staged along its own contiguous index), into 4 x 2 register tiles of
// plain float32 FMA.  The dW products carry Adam in their epilogue: each
// thread updates m, v and the parameter of the gradient it just summed,
// and the bias gradients are summed from the same staged dY steps by spare
// threads.  Every read of a parameter in an epoch is from one of two
// copies in the work buffer and every write to the other (the two
// alternate by epoch), so Adam needs no phase of its own; the caller's
// buffer is read once and written once.
//
// Bit for bit the one-block build.  Every output of every product is one
// thread's fmaf chain over k in order from +0.f, padded as that build
// padded it (zeros to a multiple of 16), then the same epilogue; there is
// no split over k.  The bias sums run over the rows in order, the loss
// partials over 256 lanes of stride 256 with the same tree, and the
// noise, the heads, the loss gradient and Adam are the same expressions.
// So the results do not depend on the cluster size: K2's runs and the seed
// grid's are fused_train's, bit for bit (scripts/k1_digest.py holds them to
// the one-block build's digests).  No TF32, no tensor cores: parity with
// the float32 JAX reference.
//
// K2's rows are ragged, not padded.  The TPU pads each corpus to n_max and
// masks, because a BlockSpec has one shape.  Here cluster s reads only its
// own B_s rows of a concatenated (sum B_s, 30) corpus through an (S+1)
// row-offset array, and its means over B_s rows are JAX's masked means with
// max(sum mask, 1) = B_s as the denominator: padded rows cost no work.  Its
// Philox counter is (epoch, row within its own corpus, group), so cluster s
// draws exactly what K1 draws for that corpus and seed.  JAX's
// use_mask=False (padded rows counted as rows, each drawing its noise) is
// the padded blocks passed whole as ragged rows (ops/fused_trainer.py::
// padded_rows), so it needs no code here.  The seed grid has no offsets:
// every cluster reads the one shared corpus.
//
// Bound.  One epoch is 758,272 B + 10 x 128,942 FLOP (the forward, dW and
// the activation gradients, then Adam): 103 MFLOP at B = 134, 309 GFLOP for
// 3000 epochs, 4.6 ms on the whole card at 67 TFLOP/s of float32 (H100 SXM);
// one SM has 1/132 of that rate, so a cluster of cs CTAs cannot beat
// 608 ms / cs.  A grid's clusters run side by side, so the largest run
// bounds it.  The bytes (inputs, params in and out, the metrics) are a few
// MB, so the work is bound by operations; what holds it above the FMA bound
// is latency: 22 dependent phases an epoch, each an L2 round trip and a
// cluster barrier (the phase timer below measures the split).
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
constexpr int NT = 256;                      // threads of a CTA
constexpr int TK = 32;                       // a product's depth step
constexpr int STAGES = 3;                    // depth steps in flight
constexpr int MB_MAX = 256, NB_MAX = 64;     // a CTA's product sub-block, at most
constexpr int RM = 4, RN = 2;                // a thread's register tile
constexpr int TKP = TK + 4;                  // a staged row along k (16-byte aligned)
constexpr int A_FLOATS = MB_MAX * TKP, B_FLOATS = NB_MAX * TKP;
static_assert(TK * MB_MAX <= A_FLOATS && TK * NB_MAX <= B_FLOATS, "stage layouts");
constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
// shared memory: the depth steps in flight; each thread's epilogue operands
// (3 a register-tile output, 3 for a bias column); the loss tree; the timer
constexpr int EPI_FLOATS = (3 * RM * RN + 3) * NT;
constexpr int RED_OFF = STAGES * STAGE_FLOATS + EPI_FLOATS;
constexpr int TIMER_OFF = RED_OFF + 5 * NT;
constexpr int SMEM_FLOATS = TIMER_OFF + 2 * 8;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;
constexpr int LOSS_ROWS = 256;               // rows of the loss staged at once
static_assert(LOSS_ROWS * (2 * F + Z2) <= STAGES * STAGE_FLOATS, "loss staging");
constexpr int MAX_CLUSTER = 16;

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

// the work buffer: Adam's m and v, the two copies of the params (an epoch
// reads one and Adam writes the other), then the activations and their
// gradients of one epoch; every region starts on 16 bytes when B is even
constexpr int NP_PAD = (N_PARAMS + 3) / 4 * 4;
struct Work {
  float *m, *v, *p1, *p2;
  float *c0, *hcat, *e0, *e1, *e2, *ml, *gin, *g1, *g2, *g3, *recon, *eps;
  float *d_recon, *buf_a, *buf_b, *d_gin, *d_ml, *d_hcat, *d_hcat2, *dhc, *d_c0;
};

__host__ __device__ long long carve(float* base, int B, Work* w) {
  // sizes in the order of Work's fields
  const long long b = B;
  const long long n[25] = {
      NP_PAD, NP_PAD, NP_PAD, NP_PAD,
      b * H, b * H2, b * H, b * H, b * H, b * Z2, b * GIN, b * H, b * H, b * H, b * F, b * Z,
      b * F, b * H, b * H, b * GIN, b * Z2, b * H2, b * H2, b * H, b * H};
  float* p[25];
  long long off = 0;
  for (int i = 0; i < 25; ++i) {
    p[i] = base ? base + off : nullptr;
    off += n[i];
  }
  if (w) {
    *w = Work{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10], p[11],
              p[12], p[13], p[14], p[15], p[16], p[17], p[18], p[19], p[20], p[21], p[22],
              p[23], p[24]};
  }
  return off;
}

// ---- device-only helpers: PTX for shared memory, cp.async, the cluster and
// the clock --------------------------------------------------------------
__device__ __forceinline__ float* smem_base() {
  extern __shared__ __align__(16) float smem_dyn[];
  return smem_dyn;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// every thread of the cluster: global and shared writes before it are
// seen by every thread of the cluster after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_index() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// ---- end of the device-only helpers ----

// The phase timer (optional, null on every main path): thread 0 of rank 0
// of run 0 reads %globaltimer at each phase's end, once its CTA is done and
// once the cluster barrier lets it go, and adds the nanoseconds to the
// phase's slot; slot BARRIER holds the waits.  Adam runs inside the dW
// products, so its slot stays 0.
enum { T_NOISE, T_FORWARD, T_LOSS, T_DEC_BWD, T_HEADS, T_ENC_BWD, T_ADAM, T_BARRIER,
       T_SLOTS = 16 };

struct PhaseTimer {
  unsigned long long* out;  // null: off for this thread
  bool on;                  // on for this CTA
  unsigned long long last, *acc;  // acc: 8 slots in shared memory
  __device__ void start(unsigned long long* o, bool rank0) {
    on = o != nullptr;
    out = (on && rank0 && threadIdx.x == 0) ? o : nullptr;
    acc = reinterpret_cast<unsigned long long*>(smem_base() + TIMER_OFF);
    if (out) {
      for (int i = 0; i < 8; ++i) acc[i] = 0;
      last = global_ns();
    }
  }
  __device__ __forceinline__ void mark(int slot) {
    if (!out) return;
    const unsigned long long t = global_ns();
    acc[slot] += t - last;
    last = t;
  }
  // a phase's end: its CTA's time, the cluster barrier, the wait
  __device__ __forceinline__ void end(int slot) {
    if (on) {
      __syncthreads();
      mark(slot);
    }
    cluster_sync();
    mark(T_BARRIER);
  }
  __device__ void finish(int epochs) {
    if (!out) return;
    for (int i = 0; i < 8; ++i) out[i] = acc[i];
    out[8] = (unsigned long long)epochs;
  }
};

// ---- the products ---------------------------------------------------------
//
// C[M, N] = A[M, K] . B[K, N] with A(m, k) = A[m sam + k sak] and
// B(k, n) = B[k sbk + n sbn], so one routine serves the forward (act . W),
// the activation gradient (dY . W^T) and the weight gradient (act^T . dY).
struct Prod {
  int M, N, K;
  const float* A;
  int sam, sak;
  const float* Bm;
  int sbk, sbn;
};

enum { EPI_FWD, EPI_DIN, EPI_DW };

// what a product's outputs become: FWD out = act(acc + bias[n]); DIN
// out = acc, times (mask > 0) when there is a mask; DW Adam on the
// parameters at wo + m N + n (and the bias at bo + n, its gradient the
// column sum of B over k)
struct Epi {
  float* out;
  int ldc;
  const float* bias;
  bool relu;
  const float* mask;
  int ldm;
  int wo, bo;
};

// Adam (optax defaults) from the params p into p_next.  A thread stages
// its m, v and p into shared memory by cp.async before the product whose
// gradient they take, so the reads wait behind the product's steps and hold
// no registers.  The update is
// written out as nvcc contracted the one-block build's
// 0.9 m + 0.1 g, 0.999 v + 0.001 g g and p - lr q (its SASS: the products
// of m and v rounded, g's fused), so no other contraction can change a bit.
struct Adam {
  float *m, *v, *p_next;
  const float* p;
  float lr, bc1, bc2;
  struct Old {
    float m, v, p;
  };
  // stage m, v and p of parameter i into o[0], o[NT], o[2 NT]
  __device__ __forceinline__ void fetch(int i, float* o) const {
    cp_async4(o, m + i);
    cp_async4(o + NT, v + i);
    cp_async4(o + 2 * NT, p + i);
  }
  __device__ __forceinline__ void step(int i, float g, const Old& o) const {
    const float mi = __fmaf_rn(g, 0.1f, __fmul_rn(o.m, 0.9f));
    const float vi = __fmaf_rn(g, __fmul_rn(g, 0.001f), __fmul_rn(o.v, 0.999f));
    m[i] = mi;
    v[i] = vi;
    p_next[i] = __fmaf_rn(-((mi / bc1) / (sqrtf(vi / bc2) + 1e-8f)), lr, o.p);
  }
};

// columns cut into pn parts and rows into cs / pn: the cut whose blocks
// have the fewest operand rows and columns to load
__device__ inline int pick_pn(int M, int N, int cs) {
  int best = 1, best_cost = 1 << 30;
  for (int pn = 1; pn <= cs; pn *= 2) {
    const int pm = cs / pn;
    const int cost = (M + pm - 1) / pm + (N + pn - 1) / pn;
    if (cost < best_cost) {
      best_cost = cost;
      best = pn;
    }
  }
  return best;
}

// A staged tile: `rows` rows of w floats (w a multiple of 4) at dst with
// row stride ss; row r is src + r sg, of which the first nr rows and nv
// columns are real and the rest zeros, as the one-block build padded.  A
// thread takes one 4-float chunk of a row, fixed for the sub-block, and
// steps over rows: 16 bytes a copy where the source is aligned, else 4.
struct Chunks {
  int c4, r0, r_step;
  bool on;
  __device__ __forceinline__ void init(int w) {
    const int tid = threadIdx.x, per_row = w / 4, rows_at_once = NT / per_row;
    c4 = 4 * (tid % per_row);
    r0 = tid / per_row;
    r_step = rows_at_once;
    on = tid < rows_at_once * per_row;
  }
};
static_assert(MB_MAX <= 4 * NT && TK <= 4 * NT, "a row's chunks fit the CTA");

__device__ __forceinline__ void stage_tile(const Chunks& ch, const float* src, long long sg,
                                           int rows, int nr, int nv, float* dst, int ss) {
  if (!ch.on) return;
  for (int r = ch.r0; r < rows; r += ch.r_step) {
    float* d = dst + r * ss + ch.c4;
    const float* g = src + r * sg + ch.c4;
    if (r < nr && ch.c4 + 3 < nv && !(reinterpret_cast<uintptr_t>(g) & 15)) {
      cp_async16(d, g);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (r < nr && ch.c4 + e < nv) cp_async4(d + e, g + e);
        else d[e] = 0.f;
      }
    }
  }
}

// one sub-block of a CTA's block: rows m0..m0+mb, columns n0..n0+nb, at
// most NT register tiles; with_bias: the first rows of a DW product, whose
// column sums of B (the bias gradients) this sub-block also takes, one
// column a thread from the last thread down.
//
// Shared-memory layouts, each staged along its operand's contiguous index:
// AK, A(m, k) at As[m TKP + k] (k contiguous in memory), else at
// As[k mbp + m] (m contiguous); BK, B(k, n) at Bs[n TKP + k], else at
// Bs[k nbp + n].
template <int KIND, bool AK, bool BK>
__device__ __forceinline__ void sub_block(const Prod& p, const Epi& ep, const Adam& ad, int m0,
                                          int mb, int n0, int nb, bool with_bias) {
  float* const sm = smem_base();
  const int tid = threadIdx.x;
  const int mbp = (mb + 3) / 4 * 4, nbp = (nb + 3) / 4 * 4;
  const int mcols = nbp / RN, n_tiles = (mbp / RM) * mcols;
  const int tr = tid / mcols, tc = tid % mcols;
  const bool computes = tid < n_tiles;
  const int bcol = NT - 1 - tid;
  const bool sums_bias = KIND == EPI_DW && with_bias && bcol < nb;
  const int nk = (p.K + TK - 1) / TK;
  Chunks ca, cb;
  ca.init(AK ? TK : mbp);
  cb.init(BK ? TK : nbp);
  float acc[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;
  float bsum = 0.f;

  // the epilogue's operands, staged now (their own cp.async group, the
  // oldest): the bias, the mask, or Adam's m, v and p of each output,
  // slot q of this thread at epi[q NT + tid]
  float* const epi = sm + STAGES * STAGE_FLOATS + tid;
  float* const bepi = epi + 3 * RM * RN * NT;
  if (computes) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
#pragma unroll
      for (int cc = 0; cc < RN; ++cc) {
        const int mm = RM * tr + r, nn = RN * tc + cc, q = r * RN + cc;
        if (mm < mb && nn < nb) {
          const int m = m0 + mm, n = n0 + nn;
          if (KIND == EPI_FWD) cp_async4(epi + q * NT, ep.bias + n);
          if (KIND == EPI_DIN && ep.mask)
            cp_async4(epi + q * NT, ep.mask + (long long)m * ep.ldm + n);
          if (KIND == EPI_DW) ad.fetch(ep.wo + m * p.N + n, epi + 3 * q * NT);
        }
      }
    }
  }
  if (sums_bias) ad.fetch(ep.bo + n0 + bcol, bepi);
  cp_async_commit();

  // depth step c of both operands into stage st
  auto stage_step = [&](int c, float* st) {
    const int k0 = c * TK, kv = p.K - k0;
    if (AK) stage_tile(ca, p.A + (long long)m0 * p.sam + k0, p.sam, mbp, mb, kv, st, TKP);
    else stage_tile(ca, p.A + (long long)k0 * p.sak + m0, p.sak, TK, kv, mb, st, mbp);
    if (BK) stage_tile(cb, p.Bm + (long long)n0 * p.sbn + k0, p.sbn, nbp, nb, kv, st + A_FLOATS,
                       TKP);
    else stage_tile(cb, p.Bm + (long long)k0 * p.sbk + n0, p.sbk, TK, kv, nb, st + A_FLOATS,
                    nbp);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) stage_step(s, sm + s * STAGE_FLOATS);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nc = c + STAGES - 1;
    if (nc < nk) stage_step(nc, sm + (nc % STAGES) * STAGE_FLOATS);
    cp_async_commit();
    const float* As = sm + (c % STAGES) * STAGE_FLOATS;
    const float* Bs = As + A_FLOATS;
    if (computes) {
      // depth in halves of 16, each taken whole (zeros past K) as long as
      // it starts inside K: the one-block build's padding, step for step
#pragma unroll
      for (int h = 0; h < TK / 16; ++h) {
        if (c * TK + 16 * h < p.K) {
#pragma unroll
          for (int k4 = 16 * h; k4 < 16 * h + 16; k4 += 4) {
            // four depth rows of the register tile's operands: a[r][q], b[q][c]
            float a[RM][4], b[4][RN];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 v = AK ? *reinterpret_cast<const float4*>(As + (RM * tr + i) * TKP + k4)
                                  : *reinterpret_cast<const float4*>(As + (k4 + i) * mbp + RM * tr);
              const float w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (AK) a[i][j] = w4[j];
                else a[j][i] = w4[j];
              }
            }
            if (BK) {
#pragma unroll
              for (int cc = 0; cc < RN; ++cc) {
                const float4 v = *reinterpret_cast<const float4*>(Bs + (RN * tc + cc) * TKP + k4);
                b[0][cc] = v.x; b[1][cc] = v.y; b[2][cc] = v.z; b[3][cc] = v.w;
              }
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float2 v = *reinterpret_cast<const float2*>(Bs + (k4 + q) * nbp + RN * tc);
                b[q][0] = v.x; b[q][1] = v.y;
              }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int r = 0; r < RM; ++r)
#pragma unroll
                for (int cc = 0; cc < RN; ++cc) acc[r][cc] = fmaf(a[r][q], b[q][cc], acc[r][cc]);
          }
        }
      }
    }
    if (sums_bias) {
      const int kn = min(TK, p.K - c * TK);
      for (int kk = 0; kk < kn; ++kk) bsum += Bs[kk * nbp + bcol];
    }
  }
  __syncthreads();  // the stages are free for the next sub-block

  if (computes) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
#pragma unroll
      for (int cc = 0; cc < RN; ++cc) {
        const int mm = RM * tr + r, nn = RN * tc + cc;
        const int q = r * RN + cc;
        if (mm < mb && nn < nb) {
          const int m = m0 + mm, n = n0 + nn;
          float val = acc[r][cc];
          if (KIND == EPI_FWD) {
            val += epi[q * NT];
            if (ep.relu) val = fmaxf(val, 0.f);
            ep.out[(long long)m * ep.ldc + n] = val;
          } else if (KIND == EPI_DIN) {
            if (ep.mask) val = val * (epi[q * NT] > 0.f ? 1.f : 0.f);
            ep.out[(long long)m * ep.ldc + n] = val;
          } else {
            const float* o = epi + 3 * q * NT;
            ad.step(ep.wo + m * p.N + n, val, Adam::Old{o[0], o[NT], o[2 * NT]});
          }
        }
      }
    }
  }
  if (sums_bias) ad.step(ep.bo + n0 + bcol, bsum, Adam::Old{bepi[0], bepi[NT], bepi[2 * NT]});
}

// this CTA's block of a product, in sub-blocks
template <int KIND, bool AK, bool BK>
__device__ void product(const Prod& p, const Epi& ep, const Adam& ad, int cs, int rank) {
  const int pn = pick_pn(p.M, p.N, cs), pm = cs / pn;
  const int im = rank / pn, in = rank % pn;
  const int m_lo = p.M * im / pm, m_hi = p.M * (im + 1) / pm;
  const int n_lo = p.N * in / pn, n_hi = p.N * (in + 1) / pn;
  if (m_lo >= m_hi || n_lo >= n_hi) return;
  // sub-blocks of even size: columns at most NB_MAX, rows at most what NT
  // register tiles of that width hold
  const int n_parts = (n_hi - n_lo + NB_MAX - 1) / NB_MAX;
  const int nbs = (n_hi - n_lo + n_parts - 1) / n_parts;
  const int m_cap = min(MB_MAX, (NT / ((nbs + 3) / 4 * 4 / RN)) * RM);
  const int m_parts = (m_hi - m_lo + m_cap - 1) / m_cap;
  const int mbs = (m_hi - m_lo + m_parts - 1) / m_parts;
  for (int m0 = m_lo; m0 < m_hi; m0 += mbs)
    for (int n0 = n_lo; n0 < n_hi; n0 += nbs)
      sub_block<KIND, AK, BK>(p, ep, ad, m0, min(mbs, m_hi - m0), n0, min(nbs, n_hi - n0),
                              m0 == 0);
}

// forward layer: out = act(in . W + b)
template <int L>
__device__ void fwd(int B, const float* in, int ldi, const float* P, float* out, int ldo,
                    bool relu, const Adam& ad, int cs, int rank) {
  constexpr int fi = layer_in(L), fo = layer_out(L);
  const Prod p{B, fo, fi, in, ldi, 1, P + w_off(L), fo, 1};
  const Epi ep{out, ldo, P + b_off(L), relu, nullptr, 0, 0, 0};
  product<EPI_FWD, true, false>(p, ep, ad, cs, rank);
}

// backward of one layer: dW = in^T . dy and db = colsum(dy), each into
// Adam; when d_in is given, d_in = (dy . W^T) * (mask > 0) (no mask when
// mask is null)
template <int L>
__device__ void bwd(int B, const float* in, int ldi, const float* dy, int ldy, const float* P,
                    float* d_in, int ldd, const float* mask, int ldm, const Adam& ad, int cs,
                    int rank) {
  constexpr int fi = layer_in(L), fo = layer_out(L);
  const Prod pw{fi, fo, B, in, 1, ldi, dy, ldy, 1};
  const Epi ew{nullptr, 0, nullptr, false, nullptr, 0, w_off(L), b_off(L)};
  product<EPI_DW, false, false>(pw, ew, ad, cs, rank);
  if (d_in) {
    const Prod pd{B, fi, fo, dy, ldy, 1, P + w_off(L), 1, fo};
    const Epi ed{d_in, ldd, nullptr, false, mask, ldm, 0, 0};
    product<EPI_DIN, true, true>(pd, ed, ad, cs, rank);
  }
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

// One whole training run on B rows: the work of one cluster of cs CTAs,
// this one of rank `rank`.  P holds the initial params and gets the final
// ones.  AUTO: the autodiff instance (the note at the top).
template <bool AUTO>
__device__ __forceinline__ void
train_run(const float* __restrict__ x, const float* __restrict__ cond,
          const float* __restrict__ eps_in, float* P,
          float* work, float* __restrict__ metrics, int B,
          int epochs, float lr, float w_recon, float w_kld, float w_start,
          float w_time, unsigned long long seed, unsigned long long* timer, int cs,
          int rank, int metrics_step) {
  float* const red = smem_base() + RED_OFF;  // [5][NT]
  const int tid = threadIdx.x;
  // the elementwise passes: the cluster's threads in turn
  const int g0 = rank * NT + tid, gstep = cs * NT;
  Work w;
  carve(work, B, &w);
  for (int i = g0; i < N_PARAMS; i += gstep) {
    w.m[i] = 0.f;
    w.v[i] = 0.f;
    w.p1[i] = P[i];
  }
  PhaseTimer tm;
  tm.start(timer, rank == 0);
  cluster_sync();

  const float S = 1.f / (float)B;
  const uint32_t key0 = (uint32_t)(seed & 0xFFFFFFFFull), key1 = (uint32_t)(seed >> 32);
  const float LN_B1 = -0.10536051565782630f, LN_B2 = -0.0010005003335835335f;

  for (int e = 0; e < epochs; ++e) {
    // this epoch reads the params from one copy and Adam writes the other
    const float* Pc = (e & 1) ? w.p2 : w.p1;
    const float tf = (float)(e + 1);
    const float bc1 = 1.f - expf(tf * LN_B1), bc2 = 1.f - expf(tf * LN_B2);
    const Adam ad{w.m, w.v, (e & 1) ? w.p1 : w.p2, Pc, lr, bc1, bc2};

    // ---- noise ----------------------------------------------------------
    const float* eps = eps_in;
    if (!eps_in) {
      for (int i = g0; i < B * (Z / 4); i += gstep) {
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
      if (tm.on) __syncthreads();
      tm.mark(T_NOISE);
    }

    // ---- forward (the condition and encoder chains side by side) ----------
    fwd<L_C0>(B, cond, C, Pc, w.c0, H, true, ad, cs, rank);
    fwd<L_E0>(B, x, F, Pc, w.e0, H, true, ad, cs, rank);
    tm.end(T_FORWARD);
    fwd<L_C1>(B, w.c0, H, Pc, w.hcat + H, H2, true, ad, cs, rank);   // hc -> hcat[:, H:]
    fwd<L_E1>(B, w.e0, H, Pc, w.e1, H, true, ad, cs, rank);
    tm.end(T_FORWARD);
    fwd<L_E2>(B, w.e1, H, Pc, w.e2, H, true, ad, cs, rank);
    tm.end(T_FORWARD);
    fwd<L_E3>(B, w.e2, H, Pc, w.hcat, H2, true, ad, cs, rank);       // h -> hcat[:, :H]
    tm.end(T_FORWARD);
    fwd<L_ML>(B, w.hcat, H2, Pc, w.ml, Z2, false, ad, cs, rank);     // [mu | logvar]
    tm.end(T_FORWARD);
    for (int i = g0; i < B * GIN; i += gstep) {
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
    tm.end(T_FORWARD);
    fwd<L_D0>(B, w.gin, GIN, Pc, w.g1, H, true, ad, cs, rank);
    tm.end(T_FORWARD);
    fwd<L_D1>(B, w.g1, H, Pc, w.g2, H, true, ad, cs, rank);
    tm.end(T_FORWARD);
    fwd<L_D2>(B, w.g2, H, Pc, w.g3, H, true, ad, cs, rank);
    tm.end(T_FORWARD);
    fwd<L_D3>(B, w.g3, H, Pc, w.recon, F, false, ad, cs, rank);
    tm.end(T_FORWARD);

    // ---- loss and the fused d_recon: rank 0, its rows staged in shared
    // memory; lane tid takes i = tid mod NT in order, as the one-block build
    if (rank == 0) {
      float s_rec = 0.f, s_kld = 0.f, s_start = 0.f, s_t0 = 0.f, s_tinc = 0.f;
      const float c_rec = w_recon * 2.f * S / (float)F;
      const float c_start = w_start * S;
      const float c_t0 = w_time * 2.f * S;
      const float c_td = -w_time * S / (float)(T - 1);  // d max(-dt, 0)/d dt where dt < 0
      float* const sr = smem_base();
      float* const sx = sr + LOSS_ROWS * F;
      float* const sml = sx + LOSS_ROWS * F;
      for (int r0 = 0; r0 < B; r0 += LOSS_ROWS) {
        const int nr = min(LOSS_ROWS, B - r0);
        for (int j = tid; j < nr * F; j += NT) {
          cp_async4(sr + j, w.recon + (long long)r0 * F + j);
          cp_async4(sx + j, x + (long long)r0 * F + j);
        }
        for (int j = tid; j < nr * Z2; j += NT) cp_async4(sml + j, w.ml + (long long)r0 * Z2 + j);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        const int lo = r0 * F, hi = (r0 + nr) * F;
        for (int i = lo + (tid - lo % NT + NT) % NT; i < hi; i += NT) {
          const int f = i % F, li = i - lo;
          const float r = sr[li], d = r - sx[li];
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
              if (j >= 1 && r - sr[li - D] < 0.f) up = c_td;
              if (j <= T - 2) {
                const float td = sr[li + D] - r;
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
              if (j >= 1 && r - sr[li - D] < 0.f) g += c_td;
              if (j <= T - 2) {
                const float td = sr[li + D] - r;
                s_tinc += fmaxf(-td, 0.f);
                if (td < 0.f) g -= c_td;
              }
            }
            w.d_recon[i] = g;
          }
        }
        const int klo = r0 * Z, khi = (r0 + nr) * Z;
        for (int i = klo + (tid - klo % NT + NT) % NT; i < khi; i += NT) {
          const int b = i / Z - r0, j = i % Z;
          const float mu = sml[b * Z2 + j], lv = sml[b * Z2 + Z + j];
          s_kld += 1.f + lv - mu * mu - expf(lv);
        }
        __syncthreads();
      }
      red[0 * NT + tid] = s_rec; red[1 * NT + tid] = s_kld; red[2 * NT + tid] = s_start;
      red[3 * NT + tid] = s_t0; red[4 * NT + tid] = s_tinc;
      __syncthreads();
      for (int s = NT / 2; s > 0; s >>= 1) {
        if (tid < s)
          for (int q = 0; q < 5; ++q) red[q * NT + tid] += red[q * NT + tid + s];
        __syncthreads();
      }
      if (tid == 0) {
        const float fB = (float)B;
        const float recon_l = red[0 * NT] / (fB * F);
        const float kld = -0.5f * (red[1 * NT] / (fB * Z));
        const float start_l = red[2 * NT] / (fB * 2.f);
        const float time_l = red[3 * NT] / fB + red[4 * NT] / (fB * (T - 1));
        const float total = w_recon * recon_l + w_kld * kld + w_start * start_l + w_time * time_l;
        float* row = metrics + (long long)e * metrics_step;
        row[0] = total; row[1] = recon_l; row[2] = kld; row[3] = start_l; row[4] = time_l;
        row[5] = 0.f; row[6] = 0.f; row[7] = 0.f;
      }
    }
    tm.end(T_LOSS);

    // ---- backward: decoder -----------------------------------------------
    bwd<L_D3>(B, w.g3, H, w.d_recon, F, Pc, w.buf_a, H, w.g3, H, ad, cs, rank);
    tm.end(T_DEC_BWD);
    bwd<L_D2>(B, w.g2, H, w.buf_a, H, Pc, w.buf_b, H, w.g2, H, ad, cs, rank);
    tm.end(T_DEC_BWD);
    bwd<L_D1>(B, w.g1, H, w.buf_b, H, Pc, w.buf_a, H, w.g1, H, ad, cs, rank);
    tm.end(T_DEC_BWD);
    bwd<L_D0>(B, w.gin, GIN, w.buf_a, H, Pc, w.d_gin, GIN, nullptr, 0, ad, cs, rank);
    tm.end(T_DEC_BWD);

    // ---- heads: d_mu = dz + wk S/Z mu; d_lv = dz eps std/2 - wk S/(2Z)(1 - e^lv)
    const float kS = w_kld * S / (float)Z;
    for (int i = g0; i < B * Z; i += gstep) {
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
    tm.end(T_HEADS);
    bwd<L_ML>(B, w.hcat, H2, w.d_ml, Z2, Pc, AUTO ? nullptr : w.d_hcat, H2, nullptr, 0, ad,
              cs, rank);
    if constexpr (AUTO) {
      // dW and db of the merged head are each head's own, column by column;
      // d_hcat is the mu head's product plus the logvar head's
      const Epi ed{w.d_hcat, H2, nullptr, false, nullptr, 0, 0, 0};
      const Epi ed2{w.d_hcat2, H2, nullptr, false, nullptr, 0, 0, 0};
      product<EPI_DIN, true, true>(Prod{B, H2, Z, w.d_ml, Z2, 1, Pc + w_off(L_ML), 1, Z2},
                                   ed, ad, cs, rank);
      product<EPI_DIN, true, true>(Prod{B, H2, Z, w.d_ml + Z, Z2, 1, Pc + w_off(L_ML) + Z, 1,
                                        Z2}, ed2, ad, cs, rank);
    }
    tm.end(T_HEADS);
    // condition cotangent from both concats, relu-masked by hc; encoder top
    // cotangent, relu-masked by h = hcat[:, :H]
    for (int i = g0; i < B * H; i += gstep) {
      const int b = i / H, j = i % H;
      float dh = w.d_hcat[b * H2 + H + j], dt = w.d_hcat[b * H2 + j];
      if constexpr (AUTO) {
        dh = dh + w.d_hcat2[b * H2 + H + j];
        dt = dt + w.d_hcat2[b * H2 + j];
      }
      const float d = w.d_gin[b * GIN + Z + j] + dh;
      w.dhc[i] = d * (w.hcat[b * H2 + H + j] > 0.f ? 1.f : 0.f);
      w.buf_b[i] = dt * (w.hcat[b * H2 + j] > 0.f ? 1.f : 0.f);
    }
    tm.end(T_HEADS);

    // ---- backward: encoder and condition chains, side by side ---------------
    bwd<L_E3>(B, w.e2, H, w.buf_b, H, Pc, w.buf_a, H, w.e2, H, ad, cs, rank);
    bwd<L_C1>(B, w.c0, H, w.dhc, H, Pc, w.d_c0, H, w.c0, H, ad, cs, rank);
    tm.end(T_ENC_BWD);
    bwd<L_E2>(B, w.e1, H, w.buf_a, H, Pc, w.buf_b, H, w.e1, H, ad, cs, rank);
    bwd<L_C0>(B, cond, C, w.d_c0, H, Pc, nullptr, 0, nullptr, 0, ad, cs, rank);
    tm.end(T_ENC_BWD);
    bwd<L_E1>(B, w.e0, H, w.buf_b, H, Pc, w.buf_a, H, w.e0, H, ad, cs, rank);
    tm.end(T_ENC_BWD);
    bwd<L_E0>(B, x, F, w.buf_a, H, Pc, nullptr, 0, nullptr, 0, ad, cs, rank);
    tm.end(T_ENC_BWD);
  }
  // the last epoch's Adam wrote p2 after an odd number of epochs, else p1
  const float* last = (epochs & 1) ? w.p2 : w.p1;
  for (int i = g0; i < N_PARAMS; i += gstep) P[i] = last[i];
  tm.finish(epochs);
}

// Cluster s trains run s.  With row_off (S+1 offsets), its rows are
// row_off[s]..row_off[s+1] of x, cond and eps (K2); without, every cluster
// reads all B rows of x and cond, and rows s B..(s+1) B of eps (the seed
// grid, and K1 as its S = 1).  Seeds from `seeds`, or `seed` when null.
// Params (S, N_PARAMS), metrics (S, epochs, 8); run s's work region starts
// after those of runs 0..s-1, whose sizes carve() gives.
__global__ void __launch_bounds__(NT, 1)
train_kernel(const float* __restrict__ x, const float* __restrict__ cond,
             const float* __restrict__ eps_in, const int* __restrict__ row_off,
             int B, const unsigned long long* __restrict__ seeds, unsigned long long seed,
             float* P, float* work, float* __restrict__ metrics, int epochs, float lr,
             float w_recon, float w_kld, float w_start, float w_time,
             unsigned long long* timer, int metrics_step) {
  const int s = (int)cluster_index(), cs = (int)cluster_size(), rank = (int)cluster_rank();
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
            w_start, w_time, seeds ? seeds[s] : seed, s == 0 ? timer : nullptr, cs, rank,
            metrics_step);
}

// Launch S runs as S clusters: `cluster` 0 picks the largest size (16, 8,
// 4, 2, 1) at which S clusters are resident at once (1 when none is), or
// forces 1, 2, 4, 8 or 16; the size taken goes to *taken.  Returns the
// first CUDA error of the query or the launch.
int launch(int S, int cluster, int* taken, cudaStream_t stream,
           const float* x, const float* cond, const float* eps, const int* row_off, int B,
           const unsigned long long* seeds, unsigned long long seed, float* params,
           float* work, float* metrics, int epochs, float lr, float w_recon, float w_kld,
           float w_start, float w_time, unsigned long long* timer, int metrics_step = 8) {
  if (cluster < 0 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)))
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(train_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      SMEM_BYTES);
  if (!err)
    err = (int)cudaFuncSetAttribute(train_kernel,
                                    cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int cs = cluster;
  for (int c = MAX_CLUSTER; cs == 0 && c >= 1; c /= 2) {
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(S * c);
    int n = 0;
    err = (int)cudaOccupancyMaxActiveClusters(&n, train_kernel, &cfg);
    if (err) return err;
    if (n >= S || (c == 1 && n > 0)) cs = c;
  }
  if (cs == 0) return (int)cudaErrorInvalidConfiguration;  // not even one CTA fits
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(S * cs);
  *taken = cs;
  err = (int)cudaLaunchKernelEx(&cfg, train_kernel, x, cond, eps, row_off, B, seeds, seed,
                                params, work, metrics, epochs, lr, w_recon, w_kld, w_start,
                                w_time, timer, metrics_step);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#ifndef K1_AUTO
long long k1_param_floats() { return N_PARAMS; }

long long k1_work_floats(int B) { return carve(nullptr, B, nullptr); }
#endif

// Launch K1 on `stream` as one cluster (`cluster`: 0 picks the size, or
// 1, 2, 4, 8, 16; the size taken goes to *taken); `timer`, when not null,
// gets the phase split (T_SLOTS uint64).  Returns the launch's CUDA error.
int K1_ENTRY(k1_fused_train)(const float* x, const float* cond, const float* eps,
                   float* params, float* work, float* metrics, int B,
                   int epochs, float lr, float w_recon, float w_kld,
                   float w_start, float w_time, unsigned long long seed,
                   int cluster, unsigned long long* timer, int* taken, void* stream) {
  if (B <= 0 || epochs <= 0) return (int)cudaErrorInvalidValue;
  return launch(1, cluster, taken, (cudaStream_t)stream, x, cond, eps, nullptr, B, nullptr,
                seed, params, work, metrics, epochs, lr, w_recon, w_kld, w_start, w_time,
                timer);
}

// K2: S runs, run s on rows row_off[s]..row_off[s+1] (device int32, S+1) of
// x, cond and eps, keyed by seeds[s] (device uint64, S).  work holds
// S k1_work_floats(0) + row_off[S] (k1_work_floats(1) - k1_work_floats(0))
// floats.  metrics_static (JAX's _metrics="static", a diagnostic of the
// metrics store's cost): every epoch's row goes to row 0 of its run, so the
// history is invalid and the parameters are those of the full store, bit
// for bit (a runtime argument: no other instance is built).
int K1_ENTRY(k2_fused_train_multi)(const float* x, const float* cond, const float* eps,
                         const int* row_off, const unsigned long long* seeds,
                         int S, float* params, float* work, float* metrics,
                         int epochs, float lr, float w_recon, float w_kld,
                         float w_start, float w_time, int metrics_static, int cluster,
                         unsigned long long* timer, int* taken, void* stream) {
  if (S <= 0 || epochs <= 0 || !row_off) return (int)cudaErrorInvalidValue;
  return launch(S, cluster, taken, (cudaStream_t)stream, x, cond, eps, row_off, 0, seeds, 0,
                params, work, metrics, epochs, lr, w_recon, w_kld, w_start, w_time, timer,
                metrics_static ? 0 : 8);
}

// K1 on a grid: S runs on the same B rows of x and cond, run s keyed by
// seeds[s] with eps rows s B..(s+1) B when eps is given.  work holds
// S k1_work_floats(B) floats.
int K1_ENTRY(k1_fused_train_seeds)(const float* x, const float* cond, const float* eps,
                         const unsigned long long* seeds, int S, float* params,
                         float* work, float* metrics, int B, int epochs,
                         float lr, float w_recon, float w_kld, float w_start,
                         float w_time, int cluster, unsigned long long* timer,
                         int* taken, void* stream) {
  if (S <= 0 || B <= 0 || epochs <= 0) return (int)cudaErrorInvalidValue;
  return launch(S, cluster, taken, (cudaStream_t)stream, x, cond, eps, nullptr, B, seeds, 0,
                params, work, metrics, epochs, lr, w_recon, w_kld, w_start, w_time, timer);
}

}  // extern "C"
