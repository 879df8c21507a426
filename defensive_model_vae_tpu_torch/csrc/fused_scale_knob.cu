// One ablation knob's instance of K3's gradient kernel (a), for
// fused_scale.cu's k3_train.  Compiled once per knob with -DKS_KNOB=<bit>
// (ops/_build.py), each into its own object, so the instances build in
// parallel; bf16 only, as the ablation runs.  The knobs and what they do
// are described in fused_scale.cu and scale_common.cuh.

#include "scale_common.cuh"

#ifndef KS_KNOB
#error "compile once per knob with -DKS_KNOB=<bit> (2, 4, 8, 16, 32 or 64)"
#endif
static_assert(KS_KNOB == K_NOACC || KS_KNOB == K_BIASDOT || KS_KNOB == K_CHAINCD ||
                  KS_KNOB == K_NODW || KS_KNOB == K_FWDONLY || KS_KNOB == K_DWT,
              "one per-tile knob");

// one level of indirection, so KS_KNOB expands before it is pasted
#define KS_KNOB_DEFINE(bit) KS_KNOB_LAUNCHER(bit)

KS_KNOB_DEFINE(KS_KNOB) {
  return launch_grad<true, KS_KNOB>(packed, width, eps, noise, n_pad, tile, n_valid,
                                    LossW{w_recon, w_kld, w_start, w_time}, seed_base,
                                    P, partial, sms, (cudaStream_t)stream);
}
