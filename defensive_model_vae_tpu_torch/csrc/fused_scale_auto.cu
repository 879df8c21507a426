// One dtype mode's autodiff instance (backward="auto") of K3's and K4's
// gradient kernel (a), for fused_scale.cu's k3_train_auto and
// k4_grad_epoch_auto.  Compiled once per mode with -DKS_AUTO_MODE=<mode>
// (ops/_build.py; 0 float32, 1 f32_acts, 2 bf16_chain), each into its own
// object, so the instances build in parallel.  What an instance computes
// is described beside ks_grad_auto_kernel in scale_common.cuh.

#include "scale_common.cuh"

#ifndef KS_AUTO_MODE
#error "compile once per mode with -DKS_AUTO_MODE=<mode> (0, 1 or 2)"
#endif
static_assert(KS_AUTO_MODE == A_F32 || KS_AUTO_MODE == A_ACTS || KS_AUTO_MODE == A_CHAIN,
              "one dtype mode");

// one level of indirection, so KS_AUTO_MODE expands before it is pasted
#define KS_AUTO_DEFINE(mode) KS_AUTO_LAUNCHER(mode)

KS_AUTO_DEFINE(KS_AUTO_MODE) {
  return launch_grad_auto<KS_AUTO_MODE>(packed, width, eps, noise, n_pad, tile, n_valid,
                                        LossW{w_recon, w_kld, w_start, w_time}, seed_base,
                                        P, partial, cpt, per, (cudaStream_t)stream);
}
