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
//       wrapper passes the SM count; a block needs 225 KB of shared memory,
//       so one block fills an SM).  A block runs each step's forward, loss
//       and backward with every activation of its 32 rows in shared memory
//       (the backward overwrites each saved activation with its own
//       relu-masked cotangent), reads the weights from global memory (they
//       stay in L2) and sums its bias gradients in shared memory.  In
//       float32 each step's weight gradients are added into the block's
//       row of a (chunks, params) partial buffer (the first step writes);
//       in bf16 they are deferred: each step writes its products' bf16
//       operands to the chunk's rows of a scratch buffer, and after the
//       chunk's last step one tensor-core product a layer over all its
//       rows writes the partial row once.
//   (b) ks_reduce_kernel: one thread per parameter sums the partial rows in
//       chunk order (so in row and tile order, and the same way every run)
//       and applies Adam (K3), refreshing the bf16 copy of the params, or
//       writes the sum (K4); block 0 writes the epoch's metrics row.
// K3's entry point makes the bf16 copy once, then launches (a) and (b) once
// per epoch on the caller's stream; K4's makes it at every call.
//
// The products (csrc/scale_common.cuh).  In bf16 both operands are rounded
// to bf16 (nearest even) and the sums are float32: the arithmetic of the
// JAX f32_acts mode.  The manual bf16 instances run the step's forward and
// activation-gradient products on wgmma (wg_product), transposed: wgmma's
// M (64 a warpgroup) is the layer's outputs, tile t of the first 128 on
// warpgroup t and any outputs past them in one tile that both warpgroups
// run on half the rows each, and its N the step's 32 rows.  So the step,
// its chunking, the scratch and the shared-memory plan stay as they are (a
// 64-row step would halve the weights' reads from L2 but move all of
// them).  The weights from the bf16 copy are A, from registers, loaded from
// L2 a product ahead: each product loads the next one's fragments while it
// runs and leaves them in per-thread slots at the end of the ring, so the
// L2's latency is off the step's chain of products.  The step's rows,
// rounded as they are read, are B, in 128-byte-swizzled K-major atoms.
// Ragged K (cond_0's 2, enc_0's 30, dec_0's 136, dec_3's activation
// gradient's 30) and M (the head's 16, dec_3's 30, dec_0's activation
// gradient's 136) are padded with zeros, which change no sum of real terms.
// Each k16 slice is summed from zero by the tensor core and added in
// float32 with rounding to nearest: the tensor core's chained accumulation
// truncates, and that bias would reach the next product through its bf16
// rounding.  Only the order of each product's sum differs from the FMA
// engine's: the rounding points, the epilogue (bias, add, relu, mask, the
// chaincd roundings), the loss and head math stay as they were.  A sum in
// another order flips some bf16 roundings of the next product's operands.
// In the backward that is order noise, which chip_smoke.py's K3_TOL holds
// (twice the plain version's own spread under permuted summation orders,
// scripts/k3_order_noise.py, and K3 and K4 bit for bit on an order-free
// case).  In the forward it is not: the loss of an untrained model is
// carried by a few rows, and the flips moved the first epoch's loss 2e-6 to
// 6e-6 from the benchmark's reference (which sums in the FMA engine's
// order; its limit is 4e-6).  So the forward hands on exactly the FMA
// engine's bf16 activations: an output whose rounded activation is not the
// same over a margin around its wgmma sum (FIX: 8 units of 2^-24 |a| |b|,
// 2.7 times the largest gap measured) takes the FMA engine's chain, about
// 0.5% of them, and the mu/logvar head, whose outputs reach dec_0 through
// exp, runs on FMA (head_fma).  The deferred weight gradients run mma.sync
// m16n8k16 bf16 -> float32 on the tensor cores.  The FMA engine (gemm: 32
// x 128 output tiles, depth 32, 4 x 4 outputs a thread, each output one
// chain over k in order, its operands staged by 16-byte cp.async one depth
// step ahead) stays for float32 (TF32 off), the autodiff instances, P1's
// kernels (no bf16 copy) and the noacc knob (FMA_KNOBS), which each compile
// time picks by dtype, backward and knob bits.  Time differences, bias
// gradients, the head math and the loss stay float32.
//
// Bound (bench shape: 131,072 windows x 200 epochs, tile 2048).  The
// products are 2 (2 sum in.out + sum in.out without cond_0 and enc_0) =
// 758,272 FLOP a window-epoch, 19.9 TFLOP a run.  On the tensor cores in
// bf16 (989 TFLOP/s) that is 20.1 ms; on float32 FMA (67 TFLOP/s) 297 ms.
// The bytes that must move are the corpus and the eps stream, read once an
// epoch, ~2.15 GB a run in bf16 (0.64 ms at 3.35 TB/s), so operations
// bound it.  This design moves more: in float32 the partial rows, read and
// written every step (4.2 GB an epoch at the bench shape); in bf16 the
// scratch, written and read once (1.33 GB an epoch) and the partial rows
// once (66 MB).
//
// The device code (the product engines, the step's forward, loss and
// backward, the gradient kernel (a)) is in scale_common.cuh, shared with
// the ablation's kernels in scale_ablation.cu.
//
// Ablation knobs (JAX _make_scale_kernel's _ablate, :194-281; k3_train's
// `ablate` bits, ops/fused_scale.py::ABLATE_BITS).  Each per-tile knob is
// its own instance of (a), a template bit tested at compile time, so the
// production instance (no bits) is the code it was; the instances are
// built from fused_scale_knob.cu, once per knob, in bf16 only.  What the
// reduce (b) does under them, with uniform flags:
//   noadam   sums the partials as always and writes the sum to a sink
//            buffer instead of applying Adam, so the sum is not dead code;
//            params, m and v are never touched; metrics rows are written.
//   noacc    (a) drops the read-add except inside the epoch's last tile
//            (ks_grad_kernel's note); (b) sums the gradient rows of the
//            chunks from the one holding the last tile's first step on,
//            so Adam takes the last tile's gradient; the loss rows of all
//            chunks still go into the metrics.  Needs tile % 32 == 0.
//   nodw     (b) reads only cond_0's bias row (the checksum); every other
//            gradient is zero and Adam runs on them, as in JAX.
//   fwdonly  (a) runs forward and loss only; (b) reads no gradient row and
//            runs Adam on zeros (params unchanged), and writes the loss.
//   biasdot, chaincd, dwT  only (a) changes (dwT: each deferred weight
//            gradient's activations transposed into shared memory by the
//            threads, the same sums bit for bit).
//
// The autodiff instances (backward="auto"; JAX's jax.value_and_grad of
// _forward_loss inside the kernel) are (a) compiled once per dtype mode
// from fused_scale_auto.cu: float32, f32_acts and bf16_chain, the last the
// scan trainer's bf16 recipe, which has no manual backward.  Autodiff
// returns each tile's gradients, rounded to bf16 where its weights (and,
// in bf16_chain, biases) are bf16, and the tiles' sum adds those in
// float32.  So these instances cut each tile into its own chunks (no chunk
// straddles a tile; as many a tile as fill the SMs: two of 32 steps at the
// bench shape, the manual layout), and their reduce (b) sums a tile's
// chunks in order, rounds that sum, then adds the tiles in order.  Of
// them bf16_chain defers its weight gradients as the manual bf16 instances
// do (its cotangents are bf16 values); float32 and f32_acts (float32
// cotangents) add theirs into the partial rows step by step on FMA.
//
// Interface: plain C, built by nvcc into a shared library and called
// through ctypes (ops/_build.py).  The caller allocates everything.

#include "scale_common.cuh"

KS_KNOB_LAUNCHER(2);
KS_KNOB_LAUNCHER(4);
KS_KNOB_LAUNCHER(8);
KS_KNOB_LAUNCHER(16);
KS_KNOB_LAUNCHER(32);
KS_KNOB_LAUNCHER(64);
KS_AUTO_LAUNCHER(0);
KS_AUTO_LAUNCHER(1);
KS_AUTO_LAUNCHER(2);

namespace {

// Adam (optax defaults) on parameter i with gradient g, bias correction
// 1 - exp(t ln b)
__device__ __forceinline__ void adam_at(int i, float g, float* P, float* mv, float lr,
                                        float tf, bf16* Pb) {
  const float LN_B1 = -0.10536051565782630f, LN_B2 = -0.0010005003335835335f;
  const float bc1 = 1.f - expf(tf * LN_B1), bc2 = 1.f - expf(tf * LN_B2);
  float* m = mv;
  float* v = mv + N_PARAMS;
  const float mi = 0.9f * m[i] + 0.1f * g;
  const float vi = 0.999f * v[i] + 0.001f * g * g;
  m[i] = mi;
  v[i] = vi;
  const float p = P[i] - lr * ((mi / bc1) / (sqrtf(vi / bc2) + 1e-8f));
  P[i] = p;
  if (Pb) Pb[i] = __float2bfloat16_rn(p);  // the bf16 copy, as rnd<true> rounds
}

// the loss row of the epoch from the loss sums of every chunk, in order
// (thread 0..4 of block 0)
__device__ __forceinline__ void reduce_loss_row(const float* __restrict__ partial,
                                                int n_chunks, float n_valid, LossW lw,
                                                float* row) {
  __shared__ float red[5];
  if (threadIdx.x < 5) {
    float s = 0.f;
    for (int c = 0; c < n_chunks; ++c) s += partial[(long long)c * PART_STRIDE + LOSS_OFF + threadIdx.x];
    red[threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) loss_row(red, n_valid, lw, row);
}

// (b): sum the partial rows in chunk order; Adam (adam != 0, refreshing the
// bf16 copy Pb of the params when it is given) or the sum into grad_out;
// block 0 writes the loss row.  Gradient rows are summed
// from chunk first_chunk on (noacc) and only where grad_mode says: 0 every
// parameter, 1 cond_0's bias alone (nodw), 2 none (fwdonly); the loss rows
// of every chunk are summed.
__global__ void __launch_bounds__(256)
ks_reduce_kernel(const float* __restrict__ partial, int n_chunks, int first_chunk,
                 int grad_mode, float* P, float* mv, bf16* Pb, float* grad_out, float* row,
                 int adam, float lr, float tf, float n_valid, LossW lw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N_PARAMS) {
    float g = 0.f;
    if (grad_mode == 0 || (grad_mode == 1 && i >= b_off(L_C0) && i < b_off(L_C0) + H))
      for (int c = first_chunk; c < n_chunks; ++c) g += partial[(long long)c * PART_STRIDE + i];
    if (adam) adam_at(i, g, P, mv, lr, tf, Pb);
    else grad_out[i] = g;
  }
  if (blockIdx.x == 0) reduce_loss_row(partial, n_chunks, n_valid, lw, row);
}

// layer by layer with each offset a constant: w_off called with a loop index
// compiles to a recursive call with a stack frame
template <int L = 0>
__device__ __forceinline__ bool is_weight(int i) {
  if constexpr (L == 11) {
    return false;
  } else {
    constexpr int wo = w_off(L), bo = b_off(L);
    return (i >= wo && i < bo) || is_weight<L + 1>(i);
  }
}

// (b) of the autodiff instances: per tile the sum of its cpt chunks' rows in
// order, rounded to bf16 where autodiff rounds (mode A_ACTS: weights;
// A_CHAIN: weights and biases), the tiles added in order; then Adam or the
// sum into grad_out, and block 0 writes the loss row
__global__ void __launch_bounds__(256)
ks_reduce_auto_kernel(const float* __restrict__ partial, int n_tiles, int cpt, int mode,
                      float* P, float* mv, bf16* Pb, float* grad_out, float* row, int adam,
                      float lr, float tf, float n_valid, LossW lw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N_PARAMS) {
    const bool round_tile = mode == A_CHAIN || (mode == A_ACTS && is_weight(i));
    float g = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      float s = 0.f;
      for (int j = 0; j < cpt; ++j) s += partial[((long long)t * cpt + j) * PART_STRIDE + i];
      g += round_tile ? rnd<true>(s) : s;
    }
    if (adam) adam_at(i, g, P, mv, lr, tf, Pb);
    else grad_out[i] = g;
  }
  if (blockIdx.x == 0) reduce_loss_row(partial, n_tiles * cpt, n_valid, lw, row);
}

int launch_auto(int mode, const void* packed, int width, const void* eps, int noise,
                long long n_pad, int tile, float n_valid, LossW lw,
                unsigned long long seed_base, const float* P, const bf16* Pb, float* partial,
                bf16* scratch, int cpt, int per, cudaStream_t stream) {
  switch (mode) {
#define KS_AUTO_CASE(m)                                                             \
    case m:                                                                         \
      return ks_launch_grad_auto_##m(packed, width, eps, noise, n_pad, tile,       \
                                     n_valid, lw.recon, lw.kld, lw.start, lw.time, \
                                     seed_base, P, Pb, partial, scratch, cpt, per,      \
                                     (void*)stream);
    KS_AUTO_CASE(0) KS_AUTO_CASE(1) KS_AUTO_CASE(2)
#undef KS_AUTO_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int launch_knob(int knob, const void* packed, int width, const void* eps, int noise,
                long long n_pad, int tile, float n_valid, LossW lw,
                unsigned long long seed_base, const float* P, const bf16* Pb, float* partial,
                bf16* scratch, int sms, cudaStream_t stream) {
  switch (knob) {
#define KS_KNOB_CASE(bit)                                                           \
    case bit:                                                                       \
      return ks_launch_grad_knob_##bit(packed, width, eps, noise, n_pad, tile,     \
                                       n_valid, lw.recon, lw.kld, lw.start,        \
                                       lw.time, seed_base, P, Pb, partial,         \
                                       scratch, sms, (void*)stream);
    KS_KNOB_CASE(2) KS_KNOB_CASE(4) KS_KNOB_CASE(8) KS_KNOB_CASE(16) KS_KNOB_CASE(32)
    KS_KNOB_CASE(64)
#undef KS_KNOB_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
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

// what the engine does: E_TENSOR_CORES | E_STEP_WGMMA
int ks_engine() { return E_TENSOR_CORES | E_STEP_WGMMA; }

// the bf16 elements of the deferred weight gradients' scratch of the
// manual bf16 instances: one chunk's rows (its steps x 32) of SCR_ROW each
long long ks_scratch_elems(long long n_pad, int sms) {
  if (n_pad <= 0 || sms <= 0) return 0;
  return n_chunks_of(n_pad, sms) * scratch_chunk((int)chunk_steps(n_pad, sms));
}

// the partial rows of the autodiff instances (chunks within tiles)
long long ks_chunks_auto(long long n_pad, int tile, int sms) {
  if (n_pad <= 0 || tile <= 0 || sms <= 0) return 0;
  int cpt, per;
  auto_chunking(n_pad, tile, sms, &cpt, &per);
  return n_pad / tile * cpt;
}

// the scratch of the bf16_chain autodiff instance (its weight gradients
// deferred as the manual bf16 instances'): each chunk's `per` steps
long long ks_scratch_elems_auto(long long n_pad, int tile, int sms) {
  if (n_pad <= 0 || tile <= 0 || sms <= 0) return 0;
  int cpt, per;
  auto_chunking(n_pad, tile, sms, &cpt, &per);
  return n_pad / tile * cpt * scratch_chunk(per);
}

// the bf16 copy of the params (n_params bf16), on `stream`
int ks_weights_bf16(const float* params, void* pb, void* stream) {
  return launch_weights_bf16(params, (bf16*)pb, (cudaStream_t)stream);
}

// K3: `epochs` epochs of (a) then (b) with Adam, on `stream`.  With hbm
// noise, eps is the (epochs n_pad, Z) stream; prng keys tile i of epoch e
// by seed + e n_tiles + i.  params (n_params) is updated in place; mv is
// m then v, zeroed by the caller; metrics gets one row of 8 per epoch.
// In bf16, pb (n_params bf16) receives the bf16 copy of the params (made
// before the first epoch, refreshed by every Adam step) and scratch
// (ks_scratch_elems bf16) the deferred weight gradients' operands; both
// may be null in float32.  `ablate` holds the knob bits (0 in production):
// at most one per-tile knob (bf16 only) beside noadam, whose summed
// gradients go to `sink` (n_params).
int k3_train(const void* packed, int width, const void* eps, int bf16_mode, int noise,
             long long n_pad, int tile, float n_valid, int epochs, float lr,
             float w_recon, float w_kld, float w_start, float w_time,
             unsigned long long seed, float* params, float* mv, float* partial,
             int sms, float* metrics, void* pb, void* scratch, int ablate, float* sink,
             void* stream) {
  int err = check_args(width, eps, noise, n_pad, tile, n_valid, sms);
  if (err || epochs <= 0) return err ? err : (int)cudaErrorInvalidValue;
  const int knob = ablate & ~K_NOADAM;
  const bool noadam = (ablate & K_NOADAM) != 0;
  if ((ablate & ~127) || (knob & (knob - 1)) || (knob && !bf16_mode) || (noadam && !sink) ||
      (knob == K_NOACC && tile % R) || (bf16_mode && (!pb || !scratch)))
    return (int)cudaErrorInvalidValue;
  const LossW lw{w_recon, w_kld, w_start, w_time};
  const cudaStream_t st = (cudaStream_t)stream;
  bf16* Pb = bf16_mode ? (bf16*)pb : nullptr;
  bf16* scr = bf16_mode ? (bf16*)scratch : nullptr;
  const long long n_tiles = n_pad / tile;
  const int n_chunks = (int)n_chunks_of(n_pad, sms);
  const int first_chunk =
      knob == K_NOACC ? (int)(((n_pad - tile) / R) / chunk_steps(n_pad, sms)) : 0;
  const int grad_mode = knob == K_NODW ? 1 : knob == K_FWDONLY ? 2 : 0;
  const size_t esize = bf16_mode ? 2 : 4;
  if (Pb && (err = launch_weights_bf16(params, Pb, st))) return err;
  for (int e = 0; e < epochs; ++e) {
    const void* eps_e = noise == HBM
        ? (const void*)((const char*)eps + (size_t)e * n_pad * Z * esize) : eps;
    const unsigned long long base = seed + (unsigned long long)e * n_tiles;
    if (knob)
      err = launch_knob(knob, packed, width, eps_e, noise, n_pad, tile, n_valid, lw, base,
                        params, Pb, partial, scr, sms, st);
    else
      err = bf16_mode
          ? launch_grad<true, 0>(packed, width, eps_e, noise, n_pad, tile, n_valid, lw, base,
                                 params, Pb, partial, scr, sms, st)
          : launch_grad<false, 0>(packed, width, eps_e, noise, n_pad, tile, n_valid, lw, base,
                                  params, nullptr, partial, nullptr, sms, st);
    if (err) return err;
    ks_reduce_kernel<<<(N_PARAMS + 255) / 256, 256, 0, st>>>(
        partial, n_chunks, first_chunk, grad_mode, params, mv, Pb, noadam ? sink : nullptr,
        metrics + (long long)e * 8, noadam ? 0 : 1, lr, (float)(e + 1), n_valid, lw);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// K4: one epoch of (a) then (b) without Adam: the summed gradients into
// grad (n_params) and the loss row into row (8).  prng keys tile i by
// stream_base + i; with hbm noise, eps is this epoch's (n_pad, Z) stream.
// In bf16, pb and scratch as k3_train's (the copy made at the start).
int k4_grad_epoch(const void* packed, int width, const void* eps, int bf16_mode, int noise,
                  long long n_pad, int tile, float n_valid, float w_recon,
                  float w_kld, float w_start, float w_time,
                  unsigned long long stream_base, const float* params, float* partial,
                  int sms, float* grad, float* row, void* pb, void* scratch, void* stream) {
  int err = check_args(width, eps, noise, n_pad, tile, n_valid, sms);
  if (err) return err;
  if (bf16_mode && (!pb || !scratch)) return (int)cudaErrorInvalidValue;
  const LossW lw{w_recon, w_kld, w_start, w_time};
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16_mode) {
    if ((err = launch_weights_bf16(params, (bf16*)pb, st))) return err;
    err = launch_grad<true, 0>(packed, width, eps, noise, n_pad, tile, n_valid, lw,
                               stream_base, params, (const bf16*)pb, partial, (bf16*)scratch,
                               sms, st);
  } else {
    err = launch_grad<false, 0>(packed, width, eps, noise, n_pad, tile, n_valid, lw,
                                stream_base, params, nullptr, partial, nullptr, sms, st);
  }
  if (err) return err;
  ks_reduce_kernel<<<(N_PARAMS + 255) / 256, 256, 0, st>>>(
      partial, (int)n_chunks_of(n_pad, sms), 0, 0, nullptr, nullptr, nullptr, grad, row, 0,
      0.f, 0.f, n_valid, lw);
  return (int)cudaGetLastError();
}

// K3's autodiff instance in dtype mode `mode` (0 float32, 1 f32_acts, 2
// bf16_chain; the corpus and eps stream bf16 in modes 1 and 2): `epochs`
// epochs of its (a) then its reduce with Adam, on `stream`, arguments as
// k3_train's; partial holds ks_chunks_auto rows; in modes 1 and 2 pb
// receives the bf16 copy of the params, as k3_train's, and in mode 2
// scratch (ks_scratch_elems_auto bf16) the deferred weight gradients'
// operands.
int k3_train_auto(const void* packed, int width, const void* eps, int mode, int noise,
                  long long n_pad, int tile, float n_valid, int epochs, float lr,
                  float w_recon, float w_kld, float w_start, float w_time,
                  unsigned long long seed, float* params, float* mv, float* partial,
                  int sms, float* metrics, void* pb, void* scratch, void* stream) {
  int err = check_args(width, eps, noise, n_pad, tile, n_valid, sms);
  if (err || epochs <= 0 || mode < A_F32 || mode > A_CHAIN || (mode != A_F32 && !pb) ||
      (mode == A_CHAIN && !scratch))
    return err ? err : (int)cudaErrorInvalidValue;
  const LossW lw{w_recon, w_kld, w_start, w_time};
  const cudaStream_t st = (cudaStream_t)stream;
  bf16* Pb = mode != A_F32 ? (bf16*)pb : nullptr;
  const long long n_tiles = n_pad / tile;
  int cpt, per;
  auto_chunking(n_pad, tile, sms, &cpt, &per);
  const size_t esize = mode == A_F32 ? 4 : 2;
  if (Pb && (err = launch_weights_bf16(params, Pb, st))) return err;
  for (int e = 0; e < epochs; ++e) {
    const void* eps_e = noise == HBM
        ? (const void*)((const char*)eps + (size_t)e * n_pad * Z * esize) : eps;
    err = launch_auto(mode, packed, width, eps_e, noise, n_pad, tile, n_valid, lw,
                      seed + (unsigned long long)e * n_tiles, params, Pb, partial,
                      (bf16*)scratch, cpt, per, st);
    if (err) return err;
    ks_reduce_auto_kernel<<<(N_PARAMS + 255) / 256, 256, 0, st>>>(
        partial, (int)n_tiles, cpt, mode, params, mv, Pb, nullptr, metrics + (long long)e * 8,
        1, lr, (float)(e + 1), n_valid, lw);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// K4's autodiff instance: one epoch of k3_train_auto's (a) then its reduce
// without Adam, arguments as k4_grad_epoch's with `mode` for bf16 (pb
// needed in modes 1 and 2, scratch in mode 2, as k3_train_auto's).
int k4_grad_epoch_auto(const void* packed, int width, const void* eps, int mode,
                       int noise, long long n_pad, int tile, float n_valid,
                       float w_recon, float w_kld, float w_start, float w_time,
                       unsigned long long stream_base, const float* params,
                       float* partial, int sms, float* grad, float* row, void* pb,
                       void* scratch, void* stream) {
  int err = check_args(width, eps, noise, n_pad, tile, n_valid, sms);
  if (err || mode < A_F32 || mode > A_CHAIN || (mode != A_F32 && !pb) ||
      (mode == A_CHAIN && !scratch))
    return err ? err : (int)cudaErrorInvalidValue;
  const LossW lw{w_recon, w_kld, w_start, w_time};
  const cudaStream_t st = (cudaStream_t)stream;
  bf16* Pb = mode != A_F32 ? (bf16*)pb : nullptr;
  if (Pb && (err = launch_weights_bf16(params, Pb, st))) return err;
  int cpt, per;
  auto_chunking(n_pad, tile, sms, &cpt, &per);
  err = launch_auto(mode, packed, width, eps, noise, n_pad, tile, n_valid, lw, stream_base,
                    params, Pb, partial, (bf16*)scratch, cpt, per, st);
  if (err) return err;
  ks_reduce_auto_kernel<<<(N_PARAMS + 255) / 256, 256, 0, st>>>(
      partial, (int)(n_pad / tile), cpt, mode, nullptr, nullptr, nullptr, grad, row, 0, 0.f,
      0.f, n_valid, lw);
  return (int)cudaGetLastError();
}

}  // extern "C"
