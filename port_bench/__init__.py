"""The benchmark of the PyTorch/CUDA port (``defensive_model_vae_tpu_torch``).

``python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card it is
started on and prints one JSON line.  Everything a cell needs is found by
name: its configuration in ``configs/<config>.json``, its traffic in
``traffic/<traffic>.json``, which names a driver in ``drivers/<driver>.py``,
and each per-layer metric's reader in ``layer_metrics/<metric>.py``.  The
plain references that decide ``correct`` are in ``reference/`` and import
nothing of the port; ``flops.py`` holds the operations, bytes and peaks.
Nothing here imports JAX or the JAX package.
"""
