"""Production-scale training of the dense CVAE through
``ops.fused_scale.fused_train_scale`` (K3): whole jobs back to back over
one seeded corpus, each from a fresh seeded start.

Traffic keys: ``rows`` (windows in the corpus), ``epochs`` (a job),
``tile``, ``noise`` (the program's ε mode), ``trace_jobs`` and ``limits``.
"""

from __future__ import annotations

from .. import corpus, seeds
from ..driver_base import TrainingJobs
from ..reference import compare
from ..reference import cvae as ref_cvae


class Driver(TrainingJobs):
    name = "scale_train"

    def make_inputs(self) -> None:
        from defensive_model_vae_tpu_torch.models import LossWeights
        from defensive_model_vae_tpu_torch.ops.fused_scale import fused_train_scale

        t, c = self.traffic, self.config
        self.rows, self.epochs = int(t["rows"]), int(t["epochs"])
        if self.rows % int(t["tile"]):
            raise ValueError("rows must be a multiple of the tile (no padded rows)")
        self.windows = corpus.scale_corpus(self.rows, seeds.derive(self.ctx.seed, "corpus"),
                                           c["seq_len"])
        self._train = fused_train_scale
        self._weights = LossWeights(**c["loss_weights"])

    def run_job(self, job_seed: int, epochs: int = None):
        t, c = self.traffic, self.config
        params, hist = self._train(
            self.windows, epochs=self.epochs if epochs is None else epochs, lr=c["lr"],
            weights=self._weights, seed=job_seed, tile=int(t["tile"]),
            compute_dtype=c["precision"], mixed_style=c["mixed_style"], noise=t["noise"],
            device=self.device)
        leaves = [params[n][k] for n in ref_cvae.LAYERS for k in ("w", "b")]
        return job_seed, leaves, hist["total"]

    def reference(self, job_seed: int, epochs: int, precision: str) -> dict:
        c = self.config
        return ref_cvae.train_job(self.windows, job_seed, epochs, c, precision,
                                  c["precision"], self.device, compare.FIRST_EPOCHS)
