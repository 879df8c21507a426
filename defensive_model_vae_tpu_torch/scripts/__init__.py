"""Measurement scripts of the port, each run as a module:

- ``python -m defensive_model_vae_tpu_torch.scripts.scale_ablation`` — K3's
  time taken apart by variants that each remove one layer of work;
- ``python -m defensive_model_vae_tpu_torch.scripts.noise_consumer_probe``
  — a generated ε stream consumed by ``torch.sum`` against the P2 kernel;
- ``python -m defensive_model_vae_tpu_torch.scripts.k3_digest`` — digests
  of K3's and K4's results on fixed cases, against their earlier build.

Each runs on the card unless ``--device cpu`` is given.
"""
