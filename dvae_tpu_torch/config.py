"""Configuration trees of the PyTorch port.

Own copies of ``VAEConfig``, ``TrainConfig``, ``MeshConfig``,
``ReparamNoise`` and ``ShardingStrategy`` with the same fields and defaults
as the JAX package's ``config.py``, so the ``cfg``/``tcfg`` metadata of a
checkpoint written by either package rebuilds them.  The port imports
nothing from the JAX package, not even this stdlib-only module.

The field comments of the JAX package describe TPU measurements; they are
left out here.  The flags keep their meaning: ``fused_recon`` routes the
MSE reconstruction loss through the hand-written kernels of
``ops/recon.py`` (the forward in eval, the forward+backward in training);
``fused_encoder`` runs train-mode input dropout and fc1 through those of
``ops/encoder.py``; ``bn_groups`` > 1 is ghost batch norm in train mode.
``use_pallas`` (the JAX package's name for its opt-in kernels, kept so that
either package's checkpoints rebuild the other's config) turns on the
hand-written Gumbel-softmax sampler of ``ops/gumbel.py`` in training and
the fused coupling distance of ``ops/coupling.py`` in every loss.
``fused_decoder`` (opt-in, MSE mode with ``fused_recon``) runs the whole
decoder, trunk and output layer, in the kernels of ``ops/decoder.py``; ZINB
mode ignores it.  ``TrainConfig.aug_noise`` scales the noise of a frozen
augmenter's per-arm views.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional


class ShardingStrategy(str, Enum):
    """The reference FSDP sharding-strategy matrix (fsdp_mnist.py:215-228)."""

    FULL_SHARD = "full"
    SHARD_GRAD_OP = "grad-op"
    NO_SHARD = "no"
    HYBRID_SHARD = "hybrid"
    HYBRID_SHARD_ZERO2 = "hybrid-zero2"
    DDP = "ddp"


class ReparamNoise(str, Enum):
    """Noise distribution of the state-variable reparameterization.

    The reference draws uniform noise (mmidas/nn_model.py:427); ``GAUSSIAN``
    is the default and ``UNIFORM`` the bit-faithful compatibility flag.
    """

    GAUSSIAN = "gaussian"
    UNIFORM = "uniform"


@dataclass(frozen=True)
class VAEConfig:
    """Hyperparameters of the multi-arm mixVAE (reference
    mmidas/nn_model.py:14-36)."""

    n_categories: int = 92          # C
    state_dim: int = 2              # S
    input_dim: int = 5032           # D
    fc_dim: int = 100               # F
    lowD_dim: int = 10              # L
    x_drop: float = 0.5
    s_drop: float = 0.2
    lr: float = 0.001
    lam: float = 1.0
    lam_pc: float = 1.0
    n_arm: int = 2                  # A
    temp: float = 1.0
    tau: float = 0.005
    beta: float = 1.0
    hard: bool = False
    variational: bool = True
    ref_prior: bool = False
    trained_model: Optional[str] = None
    n_pr: int = 0
    momentum: float = 0.01
    mode: str = "MSE"
    eps: float = 1e-8
    reparam_noise: ReparamNoise = ReparamNoise.GAUSSIAN
    dtype: str = "float32"
    use_pallas: bool = False
    recon_bce_metric: bool = True
    fused_recon: bool = False
    fused_encoder: bool = False
    fused_decoder: bool = False
    bn_groups: int = 1

    def replace(self, **kw) -> "VAEConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_pairs(self) -> int:
        return max(self.n_arm * (self.n_arm - 1) // 2, 1)


@dataclass(frozen=True)
class MeshConfig:
    """Logical device-mesh shape (data × arm × fsdp)."""

    data: int = 1
    arm: int = 1
    fsdp: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.arm * self.fsdp


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop configuration (reference train.py:172-267 defaults)."""

    n_epoch: int = 50000
    n_epoch_p: int = 0
    batch_size: int = 5000
    min_con: float = 0.99
    max_prun_it: int = 0
    good_enuf_consensus: float = 0.75
    seed: int = 546
    optimizer: str = "adam"
    epochs_per_jit: int = 10
    eval_every: int = 10
    ckpt_every: int = 10
    sharding: ShardingStrategy = ShardingStrategy.NO_SHARD
    mesh: MeshConfig = field(default_factory=MeshConfig)
    bf16: bool = False
    aug_noise: float = 0.1
    rng_impl: str = "threefry2x32"
    halt_on_nan: bool = True
    stream: bool = False
    align_arms_every: int = 0
    shuffle_block: int = 1

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
