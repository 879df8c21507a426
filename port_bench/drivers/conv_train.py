"""Training of the temporal Conv1D VAE through ``train.train.train_conv``
(eager, cuDNN, torch Adam): whole jobs back to back over one seeded corpus
of random-walk windows, each from a fresh seeded start (the entry draws its
init and its per-epoch ε from the job's seed).

Traffic keys: ``rows``, ``epochs``, ``max_angle_deg`` (the walks' turn a
step), ``trace_jobs`` and ``limits``.  The configuration's ``precision``
is float32 with TF32 off; its control is the reference with TF32 on.
"""

from __future__ import annotations

from .. import corpus, seeds
from ..driver_base import TrainingJobs, tf32
from ..reference import compare
from ..reference import conv_cvae as ref_conv


class Driver(TrainingJobs):
    name = "conv_train"

    def make_inputs(self) -> None:
        from defensive_model_vae_tpu_torch.models.conv_cvae import ConvCVAEConfig
        from defensive_model_vae_tpu_torch.train.train import TrainConfig, train_conv

        t, c = self.traffic, self.config
        self.rows, self.epochs = int(t["rows"]), int(t["epochs"])
        self.windows = corpus.random_walks(self.rows, c["seq_len"],
                                           seeds.derive(self.ctx.seed, "corpus"),
                                           t["max_angle_deg"])
        self._model = ConvCVAEConfig(seq_len=c["seq_len"], dim=c["dim"],
                                     latent_dim=c["latent_dim"], hidden_dim=c["hidden_dim"],
                                     cond_dim=c["cond_dim"], channels=tuple(c["channels"]),
                                     kernel=c["kernel"])
        self._train, self._cfg = train_conv, TrainConfig

    def run_job(self, job_seed: int, epochs: int = None):
        c = self.config
        params, hist, _ = self._train(
            self.windows, self._model,
            self._cfg(epochs=self.epochs if epochs is None else epochs, lr=c["lr"],
                      seed=job_seed),
            kld_weight=c["kld_weight"], device=self.device)
        leaves = [params[n][k] for n, _ in ref_conv.layer_shapes(c) for k in ("w", "b")]
        return job_seed, leaves, hist["total"]

    def reference(self, job_seed: int, epochs: int, precision: str) -> dict:
        with tf32({"float32": False, "tf32": True}[precision]):
            return ref_conv.train_job(self.windows, job_seed, self.config,
                                      compare.FIRST_EPOCHS, self.device)
