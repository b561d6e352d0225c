"""dvae_tpu_torch — the PyTorch/CUDA port of dvae_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module names so each
counterpart is easy to find.  It imports torch, numpy and scipy, never JAX
and nothing of ``dvae_tpu``.  Kernels the JAX package writes in Pallas are
hand-written CUDA here (``csrc/``), built with ``nvcc`` at first use.

Ported so far: the serving path (``CplMixVAE.load_model`` →
``eval_model``, ``eval.evaluate.summarize_inference``, the ``evaluate``
command) and the MSE training path on one device (``CplMixVAE.init_model``
→ ``train``: train-mode forward, gradients through the fused dropout+fc1
and recon-loss kernels, Adam, the on-device epoch runner, validation,
checkpoints, pruning, resume; the ``train`` command).  Run either with
``python -m dvae_tpu_torch.cli {train,evaluate} --device {cuda,cpu}``.
"""

from dvae_tpu_torch.config import (MeshConfig, ReparamNoise, ShardingStrategy,
                                   TrainConfig, VAEConfig)

__all__ = ["VAEConfig", "TrainConfig", "MeshConfig", "ReparamNoise",
           "ShardingStrategy", "CplMixVAE"]


def __getattr__(name):
    if name == "CplMixVAE":
        from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
        return CplMixVAE
    raise AttributeError(name)
