// P1 and P2: the K3 ablation's own kernels, for Hopper.
//
// Replace the Pallas kernels of the JAX package's K3 ablation,
// scripts/scale_ablation.py (_ablation_call :207): _make_stream_kernel
// (:182, pallas_call :236), _make_sol_kernel (:148, :240) and
// _make_ablation_kernel (:94, :248, modes fwd and dx), and the probe
// scripts/noise_consumer_probe.py::_stream_kernel (:78, gen_stream :94,
// pallas_call :100).  P1's kernels run the grid (epochs x corpus) the way
// K3 does on this card (fused_scale.cu): per epoch a kernel whose blocks
// each take a chunk of the rows and write a partial row, then a one-block
// kernel that sums the partial rows in chunk order into the epoch's
// metrics row, so every result is the same from run to run (no atomics).
//
//   p1_stream    per epoch the float32 sum of the whole packed bf16 block
//                into metrics[e, 0]: each block sums a range of the flat
//                array with 16-byte loads.  A reduction like this is what
//                Triton serves, but one CUDA source keeps one build path.
//                Bound: the corpus read once an epoch, 2.15 GB for the
//                bench shape x 200 epochs (0.64 ms at 3.35 TB/s); the 10.7
//                MB corpus stays in the 50 MB L2 from epoch to epoch, so
//                the launches (two an epoch) are what this one measures.
//   p1_sol       per 32-row step h = x W_in (41 x 128), then n_chain
//                products h W (128 x 128), no relu, on K3's own `gemm`
//                (scale_common.cuh) with its staging, its rounding of both
//                operands to bf16 and float32 FMA, each output one chain
//                over k in order, as K3's step products; sum(h) into
//                metrics[e, 0].  The FLOPs of K3's products with none of
//                K3's other work.  Every h is rounded to bf16 again by the
//                next of its 23 chained products, so another order of the
//                sums moves the total past P1_TOL's 1e-6 of Σ|terms| (the
//                tensor cores: 2.7e-6, PERF.md §6).
//   p1_ablation  K3's forward and loss (mode 0, fwd) under fixed params
//                with packed eps, and (mode 1, dx) the gradient of the total
//                loss in x, summed into metrics[e, 5].  dx is JAX autodiff's
//                gradient in the f32_acts mode: each activation-gradient
//                product takes the float32 cotangent unrounded and the
//                bf16-rounded weight and rounds its output to bf16 (the
//                cast's VJP); μ and logσ² are two products, each rounded,
//                summed in float32; the chain runs back through enc_0 to x,
//                which K3 never does, and x also takes the loss's direct
//                terms -(recon - x) (2 w_r S/F, + w_s S on columns 1-2);
//                gx is rounded to bf16 (x is a bf16 leaf) before the sum.
//                Only the chain that reaches x runs: the cond chain and
//                dec_0's hc columns are dead.
//   p2_stream_sum  the (rows, 8) bf16 eps stream summed into one (1, 8)
//                row holding the total in all eight lanes, in ONE launch
//                of its own kernel (p2_kernel below; p1_stream's are left
//                as they are).  Bound: the stream read once, 419 MB at
//                the probe's 200 x 131,072 x 8 (0.125 ms at 3.35 TB/s);
//                the 50 MB L2 holds an eighth of it, so every byte comes
//                from HBM.  By Little's law the card needs ~2.3 MB in
//                flight (3.35 TB/s x ~0.7 us), ~18 KB an SM: each thread
//                issues P2_U = 4 independent 16-byte read-only streaming
//                loads before it adds any (a resident grid of 256-thread
//                blocks keeps >100 KB an SM in flight), each into its own
//                float accumulator; warps reduce by shuffles and the block
//                across its warps in one shared-memory step.  The grid is
//                the card's SMs x the blocks an SM holds (p2_grid, from
//                the kernel's registers), and the finish is the last block
//                to arrive: each block writes its partial, fences and
//                takes a ticket; the block that draws the last ticket sums
//                the partials in a fixed order, writes the row and resets
//                the ticket to 0.  No float is added atomically, so every
//                call gives the same bits; no fill kernel, as every lane
//                of the row is written.
//
// Interface: plain C, built by nvcc into a shared library and called
// through ctypes (ops/_build.py).  The caller allocates everything.  Each
// entry counts the kernel launches it issues (sa_cuda_launches).

// P1's weights have no bf16 copy: its rounded weight operands are rounded
// as they are read (scale_common.cuh, WEIGHT_COPY)
#define KS_NO_WEIGHT_COPY
#include "scale_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// kernel launches issued, by entry (and P1-abl mode), counted at the launch
enum { L_STREAM, L_SOL, L_FWD, L_DX, L_P2, L_KINDS };
long long g_launches[L_KINDS];

// float32 sum of p[begin, end) by one block (16-byte loads where
// p + begin is 16-byte aligned, then the tail), in a fixed order
__device__ float block_sum_bf16(const bf16* __restrict__ p, long long begin,
                                long long end, float* RED) {
  float s = 0.f;
  long long i0 = begin;
  if ((reinterpret_cast<uintptr_t>(p + begin) & 15) == 0) {
    const long long nvec = (end - begin) / 8;
    const uint4* v = reinterpret_cast<const uint4*>(p + begin);
#pragma unroll 4
    for (long long i = threadIdx.x; i < nvec; i += NT) {
      const uint4 q = v[i];
      const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // two bf16 a word, low half first
        s += __uint_as_float(w[k] << 16);
        s += __uint_as_float(w[k] & 0xFFFF0000u);
      }
    }
    i0 = begin + nvec * 8;
  }
  for (long long i = i0 + threadIdx.x; i < end; i += NT) s += __bfloat162float(p[i]);
  return block_sum(s, RED);
}

// one partial per block: the sum of its range of n elements (ranges of
// `per` elements, a multiple of 8)
__global__ void __launch_bounds__(NT)
sum_kernel(const bf16* __restrict__ p, long long n, long long per,
           float* __restrict__ partial) {
  __shared__ float red[NT];
  const long long b = (long long)blockIdx.x * per;
  const long long e = b + per < n ? b + per : n;
  const float s = block_sum_bf16(p, b, e, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

// the ordered sum of the n partial rows of `stride` floats.  kind 0:
// row = [sum col 0, 0 x 7]; kind 1: row = [sum col 0] x 8; kind 2: the
// loss row of columns 0-4 (loss_row) and the sum of column 5 in row[5]
__global__ void __launch_bounds__(NT)
rows_kernel(const float* __restrict__ partial, int n, int stride, int kind,
            float n_valid, LossW lw, float* __restrict__ row) {
  __shared__ float red[NT];
  __shared__ float cols[8];
  const int ncol = kind == 2 ? 6 : 1;
  for (int q = 0; q < ncol; ++q) {
    float s = 0.f;
    for (int c = threadIdx.x; c < n; c += NT) s += partial[(long long)c * stride + q];
    const float t = block_sum(s, red);
    if (threadIdx.x == 0) cols[q] = t;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (kind == 2) {
      loss_row(cols, n_valid, lw, row);
      row[5] = cols[5];
    } else {
      for (int q = 0; q < 8; ++q) row[q] = (kind == 1 || q == 0) ? cols[0] : 0.f;
    }
  }
}

// P1-sol: one block per chunk of `steps` 32-row steps
__global__ void __launch_bounds__(NT, 1)
sol_kernel(const bf16* __restrict__ packed, int width, long long n_pad,
           const float* __restrict__ w_in, const float* __restrict__ w_chain,
           int n_chain, float* __restrict__ partial, int steps) {
  float* XS = sm + S_C0;  // R x width staged rows (width <= H)
  float* HA = sm + S_E0;
  float* HB = sm + S_E1;
  float s = 0.f;
  for (int step = 0; step < steps; ++step) {
    const long long r0 = ((long long)blockIdx.x * steps + step) * R;
    if (r0 >= n_pad) break;
    for (int i = threadIdx.x; i < R * width; i += NT) {
      const long long row = r0 + i / width;
      XS[i] = row < n_pad ? __bfloat162float(packed[r0 * width + i]) : 0.f;
    }
    __syncthreads();
    gemm<true, true>(R, H, width, XS, width, 1, w_in, H, 1, HA, H, false, nullptr, false,
                     nullptr, 0, nullptr, 0);
    float* cur = HA;
    float* nxt = HB;
    for (int c = 0; c < n_chain; ++c) {
      gemm<true, true>(R, H, H, cur, H, 1, w_chain, H, 1, nxt, H, false, nullptr, false,
                       nullptr, 0, nullptr, 0);
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    for (int i = threadIdx.x; i < R * H; i += NT) s += cur[i];
    __syncthreads();
  }
  const float t = block_sum(s, sm + S_RED);
  if (threadIdx.x == 0) partial[blockIdx.x] = t;
}

// dx's chain: JAX autodiff's gradient of the total loss in x, f32_acts
// rounding (the note above), from DREC (d_recon) and DIR (the direct term)
// into X (gx, bf16 values)
__device__ __forceinline__ void dx_chain(const float* __restrict__ P, float kS,
                                         const float* DIR) {
  float* X = sm + S_X;
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
  agrad<false, true, 1, L_D3>(DREC, F, P, nullptr, 0, H, G3, H, nullptr, 0, G3, H);
  agrad<false, true, 1, L_D2>(G3, H, P, nullptr, 0, H, G2, H, nullptr, 0, G2, H);
  agrad<false, true, 1, L_D1>(G2, H, P, nullptr, 0, H, G1, H, nullptr, 0, G1, H);
  agrad<false, true, 1, L_D0>(G1, H, P, nullptr, 0, Z, GINb, GIN, nullptr, 0, nullptr, 0);  // dz
  head_grad(kS);
  // d_h = round(d_mu W_mu[:H]^T) + round(d_lv W_lv[:H]^T), relu-masked by h
  gemm<false, true, 1>(R, H, Z, ML, Z2, 1, P + w_off(L_ML), 1, Z2, G3, H, false, nullptr,
                       false, nullptr, 0, nullptr, 0);
  gemm<false, true, 1>(R, H, Z, ML + Z, Z2, 1, P + w_off(L_ML) + Z, 1, Z2, HCAT, H2, false,
                       nullptr, false, G3, H, HCAT, H2);
  agrad<false, true, 1, L_E3>(HCAT, H2, P, nullptr, 0, H, E2, H, nullptr, 0, E2, H);
  agrad<false, true, 1, L_E2>(E2, H, P, nullptr, 0, H, E1, H, nullptr, 0, E1, H);
  agrad<false, true, 1, L_E1>(E1, H, P, nullptr, 0, H, E0, H, nullptr, 0, E0, H);
  // gx = round(round(dy_enc0 W_e0^T) + direct term)
  agrad<false, true, 2, L_E0>(E0, H, P, nullptr, 0, F, X, F, DIR, F, nullptr, 0);
}

// P1-abl: one block per chunk of `steps` 32-row steps of the packed bf16
// corpus (packed eps); partial row: the five loss sums, then (dx) sum(gx)
template <int MODE>
__global__ void __launch_bounds__(NT, 1)
abl_kernel(const bf16* __restrict__ packed, int width, long long n_pad, float S, LossW lw,
           const float* __restrict__ P, float* __restrict__ partial, int steps) {
  constexpr bool DX = MODE == 1;
  float* part = partial + (long long)blockIdx.x * 8;
  float* DIR = sm + S_C0;  // free once the forward has made hc
  LossAcc acc;
  float s_gx = 0.f;
  const LossCoef k = loss_coef(lw, S);
  for (int step = 0; step < steps; ++step) {
    const long long r0 = ((long long)blockIdx.x * steps + step) * R;
    if (r0 >= n_pad) break;
    load_step<true>(packed, width, nullptr, PACKED, n_pad, 1, 0ull, r0);
    forward_step<true>(P, nullptr);
    loss_step<DX, false, DX>(acc, k, DIR);
    if constexpr (DX) {
      dx_chain(P, k.kS, DIR);
      const float* X = sm + S_X;
      for (int i = threadIdx.x; i < R * F; i += NT) s_gx += X[i];
      __syncthreads();
    }
  }
  write_loss_sums(acc, part);
  if constexpr (DX) {
    const float t = block_sum(s_gx, sm + S_RED);
    if (threadIdx.x == 0) part[5] = t;
  }
}

// ---- P2 ---------------------------------------------------------------------

constexpr int P2_NT = 256;  // threads of a block
constexpr int P2_U = 4;     // 16-byte loads a thread has in flight before it adds

// a read-only streaming load: not kept in L1, as no byte is read twice
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// the float32 sum of the eight bf16 values of q (two a word, low half
// first), pairwise
__device__ __forceinline__ float sum8(const uint4 q) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
  float s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    s[k] = __uint_as_float(w[k] << 16) + __uint_as_float(w[k] & 0xFFFF0000u);
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// the sum of v over the block's threads, in a fixed order (a shuffle tree
// in each warp, then warp 0 over the warps' sums); the result in thread 0
__device__ __forceinline__ float p2_block_sum(float v, float* wsum) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) wsum[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    v = lane < P2_NT / 32 ? wsum[lane] : 0.f;
#pragma unroll
    for (int o = P2_NT / 64; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// P2: the float32 sum of p[0, n) into out[0..7].  The 16-byte vectors from
// p's first 16-byte boundary go in batches of P2_U a thread (batch j of
// block b: vectors (j * gridDim.x + b) * P2_NT * P2_U + u * P2_NT + t); the
// head before that boundary and the tail after the last vector (each under
// 8 elements) one element a thread of block 0.  partial holds gridDim.x
// floats; *ticket is 0 at the launch and again when it ends.
__global__ void __launch_bounds__(P2_NT)
p2_kernel(const bf16* __restrict__ p, long long n, float* __restrict__ partial,
          unsigned* __restrict__ ticket, float* __restrict__ out) {
  __shared__ float wsum[P2_NT / 32];
  __shared__ bool last;
  __shared__ float total;
  long long head = (long long)((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 2;
  if (head > n) head = n;
  const long long nvec = (n - head) / 8;
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  float acc[P2_U];
#pragma unroll
  for (int u = 0; u < P2_U; ++u) acc[u] = 0.f;
  const long long step = (long long)gridDim.x * P2_NT * P2_U;
  long long i = (long long)blockIdx.x * P2_NT * P2_U + threadIdx.x;
  for (; i + (P2_U - 1) * P2_NT < nvec; i += step) {
    uint4 q[P2_U];
#pragma unroll
    for (int u = 0; u < P2_U; ++u) q[u] = ld_stream(v + i + u * P2_NT);
#pragma unroll
    for (int u = 0; u < P2_U; ++u) acc[u] += sum8(q[u]);
  }
#pragma unroll
  for (int u = 0; u < P2_U; ++u)  // the thread's last batch, if partial
    if (i + u * P2_NT < nvec) acc[u] += sum8(ld_stream(v + i + u * P2_NT));
  if (blockIdx.x == 0) {
    const long long tail = head + nvec * 8;
    if (threadIdx.x < head) acc[0] += __bfloat162float(p[threadIdx.x]);
    if (threadIdx.x < n - tail) acc[0] += __bfloat162float(p[tail + threadIdx.x]);
  }
  const float s = p2_block_sum((acc[0] + acc[1]) + (acc[2] + acc[3]), wsum);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = s;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every other partial is written; sum them in a fixed
  // order (thread t takes t, t + P2_NT, ..., then the block's tree)
  __threadfence();
  float t = 0.f;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += P2_NT) t += __ldcg(partial + b);
  t = p2_block_sum(t, wsum);
  if (threadIdx.x == 0) total = t;
  __syncthreads();
  if (threadIdx.x < 8) out[threadIdx.x] = total;
  if (threadIdx.x == 0) *ticket = 0u;
}

template <typename K>
int set_smem(K kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SMEM_BYTES);
}

// the flat sum's layout: ranges of `per` elements (a multiple of 8, at
// least 64 K), at most 8 blocks an SM → the block count
long long sum_layout(long long n, int sms, long long* per) {
  long long b = (n + 65535) / 65536;
  if (b > 8LL * sms) b = 8LL * sms;
  if (b < 1) b = 1;
  *per = ((n + b - 1) / b + 7) / 8 * 8;
  return (n + *per - 1) / *per;
}

}  // namespace

extern "C" {

long long sa_param_floats() { return N_PARAMS; }

long long sa_cuda_launches(int kind) {
  return kind >= 0 && kind < L_KINDS ? g_launches[kind] : -1;
}

long long sa_chunks(long long n_pad, int sms) { return n_chunks_of(n_pad, sms); }

long long sa_sum_blocks(long long n, int sms) {
  long long per;
  return sum_layout(n, sms, &per);
}

// P1-stream: per epoch, the float32 sum of the n_elems bf16 values of the
// packed corpus into metrics[e, 0] (rows of 8, the rest zero).  partial
// holds sa_sum_blocks(n_elems, sms) floats.
int p1_stream(const void* packed, long long n_elems, int epochs, float* partial, int sms,
              float* metrics, void* stream) {
  if (n_elems <= 0 || epochs <= 0 || sms <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  long long per;
  const int blocks = (int)sum_layout(n_elems, sms, &per);
  for (int e = 0; e < epochs; ++e) {
    sum_kernel<<<blocks, NT, 0, st>>>((const bf16*)packed, n_elems, per, partial);
    ++g_launches[L_STREAM];
    rows_kernel<<<1, NT, 0, st>>>(partial, blocks, 1, 0, 1.f, LossW{}, metrics + 8LL * e);
    ++g_launches[L_STREAM];
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// P1-sol: per epoch the chained products over every 32-row step of the
// (n_pad, width) bf16 corpus, sum(h) into metrics[e, 0].  w_in (width, 128)
// and w_chain (128, 128) are float32 holding bf16 values; partial holds
// sa_chunks(n_pad, sms) floats.
int p1_sol(const void* packed, int width, long long n_pad, const float* w_in,
           const float* w_chain, int n_chain, int epochs, float* partial, int sms,
           float* metrics, void* stream) {
  if (n_pad <= 0 || width <= 0 || width > H || n_chain < 0 || epochs <= 0 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  int err = set_smem(sol_kernel);
  if (err) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int chunks = (int)n_chunks_of(n_pad, sms);
  const int steps = (int)chunk_steps(n_pad, sms);
  for (int e = 0; e < epochs; ++e) {
    sol_kernel<<<chunks, NT, SMEM_BYTES, st>>>((const bf16*)packed, width, n_pad, w_in,
                                               w_chain, n_chain, partial, steps);
    ++g_launches[L_SOL];
    rows_kernel<<<1, NT, 0, st>>>(partial, chunks, 1, 0, 1.f, LossW{}, metrics + 8LL * e);
    ++g_launches[L_SOL];
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// P1-abl: per epoch K3's forward and loss (mode 0) or that and the
// gradient in x (mode 1) over the (n_pad, W_IN + Z) bf16 corpus with
// packed eps under the fixed params; metrics[e] = [total, recon, kld,
// start, time, sum(gx) (mode 1), 0, 0].  partial holds 8 sa_chunks floats.
int p1_ablation(const void* packed, int width, long long n_pad, float n_valid, int mode,
                float w_recon, float w_kld, float w_start, float w_time,
                const float* params, int epochs, float* partial, int sms, float* metrics,
                void* stream) {
  if (n_pad <= 0 || width != W_IN + Z || n_valid <= 0.f || mode < 0 || mode > 1 ||
      epochs <= 0 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  int err = mode ? set_smem(abl_kernel<1>) : set_smem(abl_kernel<0>);
  if (err) return err;
  const LossW lw{w_recon, w_kld, w_start, w_time};
  const cudaStream_t st = (cudaStream_t)stream;
  const int chunks = (int)n_chunks_of(n_pad, sms);
  const int steps = (int)chunk_steps(n_pad, sms);
  for (int e = 0; e < epochs; ++e) {
    if (mode)
      abl_kernel<1><<<chunks, NT, SMEM_BYTES, st>>>((const bf16*)packed, width, n_pad,
                                                    1.f / n_valid, lw, params, partial, steps);
    else
      abl_kernel<0><<<chunks, NT, SMEM_BYTES, st>>>((const bf16*)packed, width, n_pad,
                                                    1.f / n_valid, lw, params, partial, steps);
    ++g_launches[mode ? L_DX : L_FWD];
    rows_kernel<<<1, NT, 0, st>>>(partial, chunks, 8, 2, n_valid, lw, metrics + 8LL * e);
    ++g_launches[mode ? L_DX : L_FWD];
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// P2's grid on a card of `sms` SMs: the blocks of p2_kernel resident at
// once (its registers decide how many an SM holds)
int p2_grid(int sms) {
  int per = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, p2_kernel, P2_NT, 0) != cudaSuccess ||
      per < 1)
    per = 1;
  return sms * per;
}

// P2: the float32 sum of the n_elems bf16 values of the eps stream into
// out[0..7], each lane the total, in one launch.  partial holds `grid`
// floats (p2_grid) and *ticket is 0; both are the stream's own, as two
// calls running at once on two streams must not share them.  A stream of
// fewer than grid full batches takes fewer blocks.
int p2_stream_sum(const void* eps, long long n_elems, float* partial, unsigned* ticket,
                  int grid, float* out, void* stream) {
  if (n_elems <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  const long long batches = (n_elems / 8 + P2_NT * P2_U - 1) / (P2_NT * P2_U);
  const int blocks = batches < 1 ? 1 : batches < grid ? (int)batches : grid;
  p2_kernel<<<blocks, P2_NT, 0, (cudaStream_t)stream>>>((const bf16*)eps, n_elems, partial,
                                                        ticket, out);
  ++g_launches[L_P2];
  return (int)cudaGetLastError();
}

}  // extern "C"
