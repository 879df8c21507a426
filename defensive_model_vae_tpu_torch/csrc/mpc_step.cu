// The MPC tracker's step, for Hopper: the two halves of a projected
// Levenberg–Marquardt iteration of control/mpc.py::_Problem.solve around
// the LU kernel (csrc/lu_solve.cu), one block a row of the batch.
//
// Replaces no Pallas kernel.  The JAX package's tracker is plain XLA inside
// one jitted lax.scan (control/mpc.py:141-222).  The port captures its
// step as a CUDA graph; written with torch ops, an LM iteration was some
// 110 launches over tensors of at most 16 x 102 x 40 floats (residuals and
// Jacobian by cats, cumsums, four products with the hold and slice writes;
// J^T J and J^T r by SIMT GEMM; the clip, the trial residuals, the accept
// and lambda selects), about 1.6 us a launch.  Here an iteration is three
// launches: mpc_form_kernel, lu_reg_kernel (unchanged, its own launch),
// mpc_update_kernel; a step of 3 iterations is 9.
//
// mpc_form_kernel: from the iterate u (M rows of [a, delta]), the state, the
// step's reference rows, the last applied control, the row's first-solve
// flag and lambda: the Euler rollout of theta and v (prefix sums over the P
// inputs, input s driven by control row min(s, M - 1): the hold), the
// residual r (2(P+1) track rows, then 2M Delta-u rows) and cost0 = sum r^2,
// J from its structure (below), H = J^T J + lambda I and g = J^T r.
// Where `freeze` is set (cfg.freeze_jacobian), J is the warm start's
// [last, 0, ...] (the iterate itself at iteration 0), as in solve.
//
// J's structure (the prefix sums' derivatives): with A_s = dt ca_s (ca, cd
// the clip's derivative: 1 inside the bound, 1/2 on it, 0 outside),
// D_s = v_s (1 + tan^2 delta_s) cd_s / L dt and kk_t = sum_{s<t} tan
// delta_s / L dt, the track rows of column j < M - 1 are nonzero only for
// t > j: d theta_t/da_j = A_j (kk_t - kk_{j+1}), d theta_t/d delta_j = D_j,
// d v_t/da_j = A_j (d v_t/d delta_j = 0), each times the row's weight; the
// held column M - 1 sums those over s = M - 1 .. t - 1.  The Delta-u rows
// are +-sqrt(r_c) on two diagonals (row 0's weight 0 on a simulation's
// first solve).  So H's entry (p, q) sums the track rows from
// max(j_p, j_q) + 1 on (the v rows only where both columns are
// accelerations), then at most two Delta-u products; g likewise.
//
// mpc_update_kernel: step = -x (x from the LU kernel), u_trial =
// clip(u + step), the trial residual's cost (the same rollout and sums),
// accept where strictly lower than cost0, u where'd, lambda halved or
// quadrupled and clamped to [1e-8, 1e4].  With `apply` (the step's last
// iteration) it also applies u[0]: the Euler step of the state
// (control/mpc.py::_dynamics), the new last control, the row's flag
// cleared, and the next warm start [last, 0, ...] into u.
//
// Arithmetic: float32, no tensor cores, built with -fmad=false so that
// every product and sum rounds as the torch ops of ops/mpc_step.py's plain
// mirror do (division by L is a product by 1/L, as torch divides by a
// scalar on the card).  Prefix sums are a warp's Kogge-Stone scans, the
// cost a warp's sum (each lane its residuals in order, then a xor
// butterfly), each entry of H and g a thread's sum over the track rows in
// order; products that are exact zeros (J's rows above a column's first
// nonzero row, a steering column's v rows) may be left out.  These are
// other orders than cuBLAS's and torch.cumsum's, so the step is not the
// torch step's bits; the serve cell's state_gap and control_mean_gap hold
// it.
//
// Bound: at the serve configuration (P 30, M 20) a step of 16 rows needs
// 2.1 MFLOP and 374 KB here (port_bench/mpc_step_flops.py): 0.11 us at the
// card's bytes rate.  The kernels take ~30 us a step (form 6.0 us, update
// 3.8 us a launch at 16 rows; 7.0 and 4.3 at 134; NVIDIA H100 80GB HBM3,
// 700 W), about 1 us of it a launch's own (an empty kernel's): latency,
// one row's chain of dependent steps in one block, which nothing hides at
// 16 rows (16 of 132 SMs hold a block each).  The form kernel's phases by
// clock64 in block 0, in cycles: its inputs 1.0k; warp 0 (the iterate's
// rollout, residuals and cost) beside warp 1 (J's coefficients) 2.9k;
// J's entries 1.8k; H and g 5.4k, where a thread takes control j's two
// rows by four columns on or above the diagonal (its reads of J in 8- and
// 16-byte pieces, ~5.5 bytes of shared memory a product) and copies each
// entry below.  The update kernel is one warp a row: the trial rollout,
// residuals and cost, then the selects.  Both kernels are programmatic
// dependent launches: each may start while the grid before it in the
// stream finishes, and waits for it first thing, so that a launch's start
// overlaps its predecessor's tail (~0.75 us a kernel boundary left inside
// the captured step).
//
// Interface: plain C, built by nvcc into a shared library and called
// through ctypes (ops/_build.py).  The caller allocates everything; each
// launch returns cudaGetLastError.  Each kernel counts its own runs on the
// device (thread 0 of block 0), so a replay of a CUDA graph that holds it
// counts as a launch from the host does: mpc_step_launches,
// mpc_step_reset_launches.

#include <cuda_runtime.h>

// each kernel's runs since the last reset (form, update)
__device__ unsigned long long d_mpc_launches[2] = {0, 0};

// the configuration's constants, passed by value (mirrored by
// ops/_build.py::MpcConsts; outside the anonymous namespace, so that the C
// functions that take it keep external linkage)
struct MpcConsts {
  float dt, inv_l, max_accel, max_steer;
  float w_th, w_v, wf_th, wf_v;  // sqrt(q), sqrt(qf): the track rows' weights
  float sr_a, sr_d;              // sqrt(r): the Delta-u rows' weights
  float lam0;                    // lambda at a solve's first iteration
  int P, M;
};

namespace {

// the bounds on the horizons (mirrored by ops/mpc_step.py::PMAX, MMAX):
// 2 MMAX is the LU kernel's largest register instance
constexpr int PMAX = 64, MMAX = 32;
constexpr int RMAX = 2 * (PMAX + 1) + 2 * MMAX;
// the form kernel: warps 0 and 1 the rollouts, then a thread an entry of
// J, then a tile of H or an entry of g (at the serve order 620 entries of
// J, 200 tiles and 40 entries of g); the update kernel one warp
constexpr int FORM_THREADS = 512, UPDATE_THREADS = 32;
constexpr unsigned FULL = 0xffffffffu;

// clip to [-b, b], NaN kept (torch.clamp's, torch.maximum then minimum's)
__device__ __forceinline__ float clampf(float x, float b) {
  return x != x ? x : fminf(fmaxf(x, -b), b);
}

// d clip(x, -b, b)/dx as JAX differentiates jnp.clip: 1 inside, 1/2 on the
// bound, 0 outside (and for NaN)
__device__ __forceinline__ float clip_deriv(float x, float b) {
  const float a = fabsf(x);
  return a < b ? 1.f : a == b ? 0.5f : 0.f;
}

// the inclusive prefix sums of a warp's 64 values (lane l holds x_l in a,
// x_{l+32} in b): a Kogge-Stone scan of each half (lane l adds lane l - o's
// running sum, o = 1, 2, 4, 8, 16), then the first half's total added to
// the second half's sums
__device__ __forceinline__ void warp_scan(float& a, float& b, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float ya = __shfl_up_sync(FULL, a, o), yb = __shfl_up_sync(FULL, b, o);
    if (lane >= o) {
      a = a + ya;
      b = b + yb;
    }
  }
  b = __shfl_sync(FULL, a, 31) + b;
}

// x0 + the sums of a warp_scan before inputs s = lane (ea) and lane + 32
// (eb): x0 plus the scan's previous entry, x0 alone at s = 0
__device__ __forceinline__ void before(float a, float b, float x0, int lane, float& ea,
                                       float& eb) {
  const float pa = __shfl_up_sync(FULL, a, 1), pb = __shfl_up_sync(FULL, b, 1);
  const float ta = __shfl_sync(FULL, a, 31);
  ea = lane ? x0 + pa : x0;
  eb = lane ? x0 + pb : x0 + ta;
}

// the Euler rollout of controls w (M rows of [a, delta]) by one warp, a
// lane holding inputs s = lane and lane + 32 (input s driven by row
// min(s, M - 1)): adt_s = clip(a) dt, tn_s = tan(clip(delta)), v_t = v0 +
// sum_{s<t} adt_s into v[0..P], and with th, dth_s = v_s tn_s / L dt and
// theta_t = theta0 + sum_{s<t} dth_s into th[0..P]; the lane's tn_s and
// v_s in tn, vs
__device__ void rollout_warp(const MpcConsts& c, const float* w, float th0, float v0, int lane,
                             float* v, float* th, float tn[2], float vs[2]) {
  const int P = c.P;
  float adt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = lane + 32 * h, j = min(s, c.M - 1);
    adt[h] = tn[h] = 0.f;
    if (s < P) {
      adt[h] = clampf(w[2 * j], c.max_accel) * c.dt;
      tn[h] = tanf(clampf(w[2 * j + 1], c.max_steer));
    }
  }
  warp_scan(adt[0], adt[1], lane);
  before(adt[0], adt[1], v0, lane, vs[0], vs[1]);
  if (lane == 0) v[0] = v0;
  if (lane < P) v[lane + 1] = v0 + adt[0];
  if (lane + 32 < P) v[lane + 33] = v0 + adt[1];
  if (!th) return;
  float d0 = lane < P ? vs[0] * tn[0] * c.inv_l * c.dt : 0.f;
  float d1 = lane + 32 < P ? vs[1] * tn[1] * c.inv_l * c.dt : 0.f;
  warp_scan(d0, d1, lane);
  if (lane == 0) th[0] = th0;
  if (lane < P) th[lane + 1] = th0 + d0;
  if (lane + 32 < P) th[lane + 33] = th0 + d1;
}

// the residual vector (R = 2(P+1) + 2M) by one warp into r, and its sum
// of squares: rows [(theta_t - ref) w_th, (v_t - ref) w_v] for t = 0..P
// (sqrt(qf) at t = P), then ((u_i - u_{i-1}) sqrt(r_c)) w_i, u_{-1} the
// last applied control, w_0 = 0 on a first solve.  Lane l takes rows k =
// l, l + 32, ... in order and sums their squares, then a butterfly (xor
// 16, 8, 4, 2, 1) adds the lanes' sums, every lane ending with the same
// bits
__device__ float residuals_warp(const MpcConsts& c, const float* w, const float* v,
                                const float* th, const float* ref, const float* last,
                                bool first, float* r, int lane) {
  const int P = c.P, T = 2 * (P + 1), R = T + 2 * c.M;
  float acc = 0.f;
  for (int k = lane; k < R; k += 32) {
    float rk;
    if (k < T) {
      const int t = k >> 1;
      const bool vel = k & 1;
      const float wt = vel ? (t < P ? c.w_v : c.wf_v) : (t < P ? c.w_th : c.wf_th);
      rk = ((vel ? v[t] : th[t]) - ref[k]) * wt;
    } else {
      const int d = k - T, i = d >> 1;
      const float prev = i ? w[d - 2] : last[d & 1];
      const float wi = i == 0 && first ? 0.f : 1.f;
      rk = (w[d] - prev) * (d & 1 ? c.sr_d : c.sr_a) * wi;
    }
    r[k] = rk;
    acc = acc + rk * rk;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) acc = acc + __shfl_xor_sync(FULL, acc, o);
  return acc;
}

// a programmatic dependent launch's wait for the grid before it in the
// stream (its writes visible); the launch itself overlaps that grid's tail
__device__ __forceinline__ void wait_prior_grid() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  cudaGridDependencySynchronize();
#endif
}

struct FormShared {
  float u[2 * MMAX], uj[2 * MMAX], ref[2 * (PMAX + 1)], last[2];
  float v[PMAX + 1], th[PMAX + 1], vj[PMAX + 1], res[RMAX];
  float A[PMAX], D[PMAX], kk[PMAX + 1];
  // J's track rows, row t, column p = 2 j + c: theta rows; v rows (zero in
  // the delta columns).  16-byte rows, read four columns at a time
  __align__(16) float Jth[PMAX + 1][2 * MMAX];
  __align__(16) float Jv[PMAX + 1][2 * MMAX];
};

__global__ void __launch_bounds__(FORM_THREADS)
mpc_form_kernel(const float* __restrict__ u, const float* __restrict__ state,
                const float* __restrict__ ref, const float* __restrict__ last,
                const int* __restrict__ first, const float* __restrict__ lam,
                float* __restrict__ H, float* __restrict__ g, float* __restrict__ cost0,
                MpcConsts c, int it, int freeze) {
  __shared__ FormShared sh;
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int P = c.P, M = c.M, n = 2 * M;
  wait_prior_grid();
  if (b == 0 && tid == 0) atomicAdd(&d_mpc_launches[0], 1ull);
  const float* ub = u + (long long)b * n;
  const float* lb = last + 2LL * b;
  const float* rb = ref + (long long)b * 2 * (P + 1);
  const bool frozen = freeze && it > 0;
  for (int k = tid; k < n; k += blockDim.x) {
    sh.u[k] = ub[k];
    sh.uj[k] = frozen ? (k < 2 ? lb[k] : 0.f) : ub[k];
  }
  for (int k = tid; k < 2 * (P + 1); k += blockDim.x) sh.ref[k] = rb[k];
  if (tid < 2) sh.last[tid] = lb[tid];
  const float th0 = state[4LL * b + 2], v0 = state[4LL * b + 3];
  const bool fst = first[b] != 0;
  const float lm = it ? lam[b] : c.lam0;
  __syncthreads();
  if (warp == 0) {
    // the iterate: its rollout, residuals and cost
    float tn[2], vs[2];
    rollout_warp(c, sh.u, th0, v0, lane, sh.v, sh.th, tn, vs);
    __syncwarp();
    const float cost = residuals_warp(c, sh.u, sh.v, sh.th, sh.ref, sh.last, fst, sh.res, lane);
    if (lane == 0) cost0[b] = cost;
  } else if (warp == 1) {
    // J's controls (the iterate's, or the warm start's where frozen): their
    // v and tan, each input's A, D and kk's increment, then kk
    float tn[2], vs[2], e[2];
    rollout_warp(c, sh.uj, th0, v0, lane, sh.vj, nullptr, tn, vs);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = lane + 32 * h, j = min(s, M - 1);
      e[h] = 0.f;
      if (s < P) {
        const float ca = clip_deriv(sh.uj[2 * j], c.max_accel);
        const float cd = clip_deriv(sh.uj[2 * j + 1], c.max_steer);
        sh.A[s] = c.dt * ca;
        sh.D[s] = vs[h] * (1.f + tn[h] * tn[h]) * cd * c.inv_l * c.dt;
        e[h] = tn[h] * c.inv_l * c.dt;
      }
    }
    warp_scan(e[0], e[1], lane);
    if (lane == 0) sh.kk[0] = 0.f;
    if (lane < P) sh.kk[lane + 1] = e[0];
    if (lane + 32 < P) sh.kk[lane + 33] = e[1];
  }
  __syncthreads();
  // J's track rows: row t, column j; the held column's (the longest sums)
  // first
  for (int k = tid; k < (P + 1) * M; k += blockDim.x) {
    const bool held = k <= P;
    const int t = held ? k : (k - P - 1) / (M - 1);
    const int j = held ? M - 1 : k - P - 1 - t * (M - 1);
    float ja = 0.f, jd = 0.f, jv = 0.f;
    if (!held) {
      if (t > j) {
        ja = sh.A[j] * (sh.kk[t] - sh.kk[j + 1]);
        jd = sh.D[j];
        jv = sh.A[j];
      }
    } else {
      for (int s = M - 1; s < t; ++s) {
        ja = ja + sh.A[s] * (sh.kk[t] - sh.kk[s + 1]);
        jd = jd + sh.D[s];
        jv = jv + sh.A[s];
      }
    }
    const float wth = t < P ? c.w_th : c.wf_th, wv = t < P ? c.w_v : c.wf_v;
    sh.Jth[t][2 * j] = ja * wth;
    sh.Jth[t][2 * j + 1] = jd * wth;
    sh.Jv[t][2 * j] = jv * wv;
    sh.Jv[t][2 * j + 1] = 0.f;
  }
  __syncthreads();
  // a thread a tile of H = J^T J + lambda I: control j's two rows (its
  // acceleration's and steering's) by four columns, on or above the
  // diagonal (each entry copied below); then a thread an entry of g = J^T
  // r.  Every sum runs over the track rows in order, the products that are
  // exact zeros left out (a steering column's v rows).  A warp's lanes walk
  // the same rows, from the least row that is not zero in any of their
  // columns (the terms before a lane's own first such row are exact zero
  // products): J's rows are 64 floats, a multiple of the banks, so lanes
  // on different rows would read the same banks
  float* Hb = H + (long long)b * n * n;
  const float* rdu = sh.res + 2 * (P + 1);
  const int strips = (n + 3) >> 2, tiles = M * strips, items = tiles + n;
  for (int base = warp * 32; base < items; base += blockDim.x) {
    const int k = base + lane;
    const bool tile = k < tiles;
    const int j = tile ? k / strips : (k - tiles) >> 1;
    const int q0 = tile ? 4 * (k - j * strips) : 0;
    const bool live = tile ? q0 + 3 >= 2 * j : k < items;
    const int t0 = __reduce_min_sync(FULL, live ? (tile ? max(j, q0 >> 1) : j) + 1 : P + 1);
    if (!live) continue;
    if (tile) {
      float ha[4] = {0.f, 0.f, 0.f, 0.f}, hd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int t = t0; t <= P; ++t) {
        const float2 pr = *reinterpret_cast<const float2*>(&sh.Jth[t][2 * j]);
        const float vp = sh.Jv[t][2 * j];
        const float4 aq = *reinterpret_cast<const float4*>(&sh.Jth[t][q0]);
        const float4 vq = *reinterpret_cast<const float4*>(&sh.Jv[t][q0]);
        ha[0] = ha[0] + pr.x * aq.x;
        ha[0] = ha[0] + vp * vq.x;
        ha[1] = ha[1] + pr.x * aq.y;
        ha[2] = ha[2] + pr.x * aq.z;
        ha[2] = ha[2] + vp * vq.z;
        ha[3] = ha[3] + pr.x * aq.w;
        hd[0] = hd[0] + pr.y * aq.x;
        hd[1] = hd[1] + pr.y * aq.y;
        hd[2] = hd[2] + pr.y * aq.z;
        hd[3] = hd[3] + pr.y * aq.w;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 2 * j + r;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + i, jq = q >> 1;
          if (q < p || q >= n) continue;
          float h = r ? hd[i] : ha[i];
          // the Delta-u rows: row j of column j (weight w_j), row j + 1 of
          // columns j and j + 1 (+-sqrt(r_c))
          if ((p & 1) == (q & 1)) {
            const float sr = p & 1 ? c.sr_d : c.sr_a;
            if (p == q) {
              if (!(j == 0 && fst)) h = h + sr * sr;
              if (j + 1 < M) h = h + sr * sr;
            } else if (jq == j + 1) {
              h = h + (-sr) * sr;
            }
          }
          if (p == q) h = h + lm;
          Hb[p * n + q] = h;
          Hb[q * n + p] = h;
        }
      }
    } else {
      const int p = k - tiles;
      float acc = 0.f;
      for (int t = t0; t <= P; ++t) {
        acc = acc + sh.Jth[t][p] * sh.res[2 * t];
        acc = acc + sh.Jv[t][p] * sh.res[2 * t + 1];
      }
      const float sr = p & 1 ? c.sr_d : c.sr_a;
      if (!(j == 0 && fst)) acc = acc + sr * rdu[p];
      if (j + 1 < M) acc = acc + (-sr) * rdu[p + 2];
      g[(long long)b * n + p] = acc;
    }
  }
}

struct UpdateShared {
  float ut[2 * MMAX], un[2 * MMAX], ref[2 * (PMAX + 1)], last[2];
  float v[PMAX + 1], th[PMAX + 1], res[RMAX];
};

// one warp a row
__global__ void __launch_bounds__(UPDATE_THREADS)
mpc_update_kernel(const float* __restrict__ x, float* __restrict__ u, float* __restrict__ state,
                  const float* __restrict__ ref, float* __restrict__ last, int* __restrict__ first,
                  float* __restrict__ lam, const float* __restrict__ cost0, MpcConsts c, int it,
                  int apply) {
  __shared__ UpdateShared sh;
  const int b = blockIdx.x, lane = threadIdx.x;
  const int P = c.P, n = 2 * c.M;
  wait_prior_grid();
  if (b == 0 && lane == 0) atomicAdd(&d_mpc_launches[1], 1ull);
  float* ub = u + (long long)b * n;
  const float* xb = x + (long long)b * n;
  float* lb = last + 2LL * b;
  float* sb = state + 4LL * b;
  const float* rb = ref + (long long)b * 2 * (P + 1);
  for (int k = lane; k < n; k += 32)
    sh.ut[k] = clampf(ub[k] + -xb[k], k & 1 ? c.max_steer : c.max_accel);
  for (int k = lane; k < 2 * (P + 1); k += 32) sh.ref[k] = rb[k];
  if (lane < 2) sh.last[lane] = lb[lane];
  const bool fst = first[b] != 0;
  const float c0 = cost0[b], th0 = sb[2], v0 = sb[3];
  __syncwarp();
  float tn[2], vs[2];
  rollout_warp(c, sh.ut, th0, v0, lane, sh.v, sh.th, tn, vs);
  __syncwarp();
  const bool accept =
      residuals_warp(c, sh.ut, sh.v, sh.th, sh.ref, sh.last, fst, sh.res, lane) < c0;
  for (int k = lane; k < n; k += 32) sh.un[k] = accept ? sh.ut[k] : ub[k];
  if (lane == 0) {
    const float l = it ? lam[b] : c.lam0;
    const float lt = accept ? l * 0.5f : l * 4.f;
    lam[b] = lt != lt ? lt : fminf(fmaxf(lt, 1e-8f), 1e4f);
  }
  __syncwarp();
  if (!apply) {
    for (int k = lane; k < n; k += 32) ub[k] = sh.un[k];
    return;
  }
  // the solve's first control applied: the Euler step, the new last
  // control, the flag cleared, the next warm start [last, 0, ...]
  if (lane == 0) {
    const float la = sh.un[0], ld = sh.un[1];
    const float px = sb[0], py = sb[1];
    const float a = clampf(la, c.max_accel), d = clampf(ld, c.max_steer);
    sb[0] = px + v0 * cosf(th0) * c.dt;
    sb[1] = py + v0 * sinf(th0) * c.dt;
    sb[2] = th0 + v0 * tanf(d) * c.inv_l * c.dt;
    sb[3] = v0 + a * c.dt;
    lb[0] = la;
    lb[1] = ld;
    first[b] = 0;
  }
  for (int k = lane; k < n; k += 32) ub[k] = k < 2 ? sh.un[k] : 0.f;
}

// a launch that may start while the grid before it in the stream finishes
// (programmatic dependent launch; the kernel waits for it first thing)
template <typename... Params, typename... Args>
int launch_dependent(void (*kernel)(Params...), int grid, int block, cudaStream_t stream,
                     Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

bool shape_ok(int batch, const MpcConsts& c) {
  return batch > 0 && c.P >= 1 && c.P <= PMAX && c.M >= 1 && c.M <= MMAX && c.M <= c.P;
}

}  // namespace

extern "C" {

// each kernel's runs on the current device since the last reset, into
// out[0] (form) and out[1] (update) (synchronous with the legacy default
// stream: the caller synchronises the streams that launch them)
int mpc_step_launches(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, d_mpc_launches, 2 * sizeof(*out));
}

int mpc_step_reset_launches() {
  const unsigned long long zero[2] = {0, 0};
  return (int)cudaMemcpyToSymbol(d_mpc_launches, zero, sizeof(zero));
}

// the bounds on P and M, into out[0], out[1]
int mpc_step_bounds(int* out) {
  out[0] = PMAX;
  out[1] = MMAX;
  return 0;
}

// H (B, 2M, 2M), g (B, 2M), cost0 (B) of LM iteration `it` from u (B, M, 2),
// state (B, 4), ref (B, P + 1, 2), last (B, 2), first (B, int32), lam (B),
// float32 and contiguous; one launch on `stream`
int mpc_form(const float* u, const float* state, const float* ref, const float* last,
             const int* first, const float* lam, float* H, float* g, float* cost0, int batch,
             MpcConsts c, int it, int freeze, void* stream) {
  if (!shape_ok(batch, c)) return (int)cudaErrorInvalidValue;
  return launch_dependent(mpc_form_kernel, batch, FORM_THREADS, (cudaStream_t)stream, u, state,
                          ref, last, first, lam, H, g, cost0, c, it, freeze);
}

// LM iteration `it`'s update of u and lam from the LU kernel's x (B, 2M);
// with `apply` the step's control applied to state, last, first and u
int mpc_update(const float* x, float* u, float* state, const float* ref, float* last,
               int* first, float* lam, const float* cost0, int batch, MpcConsts c, int it,
               int apply, void* stream) {
  if (!shape_ok(batch, c)) return (int)cudaErrorInvalidValue;
  return launch_dependent(mpc_update_kernel, batch, UPDATE_THREADS, (cudaStream_t)stream, x, u,
                          state, ref, last, first, lam, cost0, c, it, apply);
}

}  // extern "C"
