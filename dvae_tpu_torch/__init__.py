"""dvae_tpu_torch — the PyTorch/CUDA port of dvae_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module names so each
counterpart is easy to find.  It imports torch, numpy and scipy, never JAX
and nothing of ``dvae_tpu``.  Kernels the JAX package writes in Pallas are
hand-written CUDA here (``csrc/``), built with ``nvcc`` at first use.

Ported so far: serving and training on one device in MSE and ZINB mode
(``CplMixVAE.load_model`` → ``eval_model``, ``CplMixVAE.init_model`` →
``train``), the categorical path, ``fused_decoder``, the augmenter and
the GAN that trains it, streaming and ``.h5ad`` input, the quality
examples, the analysis and interop path (``models.api.load_vae`` →
``generate``, the traversal study, cross-run consensus, ``import-torch``
of reference PyTorch checkpoints), and the taxonomy and clusterability
path (``analysis.taxonomy.HTree`` without pandas, the taxonomy study,
``eval.cluster_analysis`` without scikit-learn but for its random
forest).  The commands are
``python -m dvae_tpu_torch.cli {train,evaluate,train-augmenter,
import-torch}``; the model runs on ``--device cuda`` unless ``cpu`` is
asked for.
"""

__version__ = "0.1.0"

from dvae_tpu_torch.config import (MeshConfig, ReparamNoise, ShardingStrategy,
                                   TrainConfig, VAEConfig)

__all__ = ["VAEConfig", "TrainConfig", "MeshConfig", "ReparamNoise",
           "ShardingStrategy", "CplMixVAE"]

# the JAX package's lazy names, each at the port's module of the same name
_LAZY = {
    "CplMixVAE": ("dvae_tpu_torch.train.cpl_mixvae", "CplMixVAE"),
    "mixvae_loss": ("dvae_tpu_torch.models.losses", "mixvae_loss"),
    "LossOutputs": ("dvae_tpu_torch.models.losses", "LossOutputs"),
    "MixVAEOutputs": ("dvae_tpu_torch.models.mixvae", "MixVAEOutputs"),
    "apply": ("dvae_tpu_torch.models.mixvae", "apply"),
    "init_params": ("dvae_tpu_torch.models.mixvae", "init_params"),
    "init_bn_state": ("dvae_tpu_torch.models.mixvae", "init_bn_state"),
    "generate": ("dvae_tpu_torch.models.api", "generate"),
    "load_vae": ("dvae_tpu_torch.models.api", "load_vae"),
}


def __getattr__(name):  # lazy imports keep `import dvae_tpu_torch` light
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
