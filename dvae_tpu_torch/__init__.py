"""dvae_tpu_torch — the PyTorch/CUDA port of dvae_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module names so each
counterpart is easy to find.  It imports torch, numpy and scipy, never JAX
and nothing of ``dvae_tpu``.  Kernels the JAX package writes in Pallas are
hand-written CUDA here (``csrc/``), built with ``nvcc`` at first use.

Ported so far: serving and training on one device in MSE and ZINB mode
(``CplMixVAE.load_model`` → ``eval_model``, ``CplMixVAE.init_model`` →
``train``), the categorical path, ``fused_decoder``, the augmenter and
the GAN that trains it, streaming and ``.h5ad`` input, the quality
examples, and the analysis and interop path (``models.api.load_vae`` →
``generate``, the traversal study, cross-run consensus, ``import-torch``
of reference PyTorch checkpoints).  The commands are
``python -m dvae_tpu_torch.cli {train,evaluate,train-augmenter,
import-torch}``; the model runs on ``--device cuda`` unless ``cpu`` is
asked for.
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
