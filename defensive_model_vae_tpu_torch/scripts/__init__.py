"""Measurement scripts of the port, each run as a module:

- ``python -m defensive_model_vae_tpu_torch.scripts.scale_ablation`` — K3's
  time taken apart by variants that each remove one layer of work;
- ``python -m defensive_model_vae_tpu_torch.scripts.noise_consumer_probe``
  — a generated ε stream consumed by ``torch.sum`` against the P2 kernel;
- ``python -m defensive_model_vae_tpu_torch.scripts.k3_digest`` — digests
  of K3's and K4's results on fixed cases, against their earlier build;
- ``python -m defensive_model_vae_tpu_torch.scripts.cache_probe`` — whether
  an nvcc build of the kernels' objects is deterministic and independent of
  what was built before it (P3 launched between the rounds);
- ``python -m defensive_model_vae_tpu_torch.scripts.conv_profile`` — where
  an epoch of the Conv1D VAE trainer (BASELINE config 3) goes on the card:
  its kernels, device busy time and host share.

Each runs on the card; those that take ``--device`` also on the CPU with
``--device cpu``.
"""
