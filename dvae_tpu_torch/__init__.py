"""dvae_tpu_torch — the PyTorch/CUDA port of dvae_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module names so each
counterpart is easy to find.  It imports torch, numpy and scipy, never JAX
and nothing of ``dvae_tpu``.  Kernels the JAX package writes in Pallas are
hand-written CUDA here (``csrc/``), built with ``nvcc`` at first use.

This slice ports the serving path: ``CplMixVAE.load_model`` →
``eval_model`` (eval-mode forward, loss with the fused recon-loss forward
kernel, consensus), ``eval.evaluate.summarize_inference`` and the
``evaluate`` command (``python -m dvae_tpu_torch.cli evaluate``).
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
