"""defensive-model-vae-tpu, PyTorch + CUDA port.

The counterpart of ``defensive_model_vae_tpu`` for an NVIDIA H100: plain
tensor code is PyTorch, and the Pallas kernels of the JAX package are
hand-written CUDA kernels under ``csrc/``.  This package imports torch,
numpy and scipy only — never jax, optax, pandas, matplotlib, nor anything
of the JAX package (which stays the reference the tests hold it against).

Importing this package touches no device and builds nothing: kernels are
compiled at their first launch (``ops/_build.py``).
"""

__version__ = "0.1.0"
