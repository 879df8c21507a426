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
  its kernels, device busy time and host share;
- ``python -m defensive_model_vae_tpu_torch.scripts.grid_probe`` — the seed
  grid on K2 (unmasked, masked, static metrics, fewer seeds) against K1
  launched once a seed;
- ``python -m defensive_model_vae_tpu_torch.scripts.run_baseline_configs``
  — BASELINE.json's configurations on the fixtures, as one report;
- ``python -m defensive_model_vae_tpu_torch.scripts.serve_latency`` — the
  HTTP endpoint's latency at batch 1, its tail under concurrent clients and
  a full-batch throughput;
- ``python -m defensive_model_vae_tpu_torch.scripts.hot_probe`` — K3's hbm ε
  stream: its generation against its streaming, and the dwT knob;
- ``python -m defensive_model_vae_tpu_torch.scripts.robustness_row`` — the
  scoreboard's selection-free row from the committed train-seed sweeps;
- ``python -m defensive_model_vae_tpu_torch.scripts.mint_provenance_probe``
  — which edits and moves of the checkout re-key the kernel build cache;
- ``python -m defensive_model_vae_tpu_torch.scripts.seed_sweep`` — train-seed
  selection over the scan trainer, ranked against the published-best values;
- ``python -m defensive_model_vae_tpu_torch.scripts.multiseed_validate`` —
  the unselected multi-seed band of every scenario's validation metrics;
- ``python -m defensive_model_vae_tpu_torch.scripts.stage_timings`` — the
  warm production loop's stage times (pipeline, K2, the DNDA sweep);
- ``python -m defensive_model_vae_tpu_torch.scripts.dnda_drift_probe`` — the
  SUT sweep's time taken apart into preparation, sweep and finalize;
- ``python -m defensive_model_vae_tpu_torch.scripts.build_timing`` — the
  kernels' cold build, and the cache probe's rounds after it;
- ``python -m defensive_model_vae_tpu_torch.scripts.episodes`` — the
  committed windows written out as CARLA-format episode trees.

Each runs on the card; those that take ``--device`` also on the CPU with
``--device cpu``.  The research drivers (``grid_probe`` to
``dnda_drift_probe``) each print one JSON line and write a file only under
``--out``; ``seed_sweep``, ``multiseed_validate``, ``stage_timings`` and
``dnda_drift_probe`` read episode trees and SUT episodes (``episodes``
writes the trees).
"""
