"""Eval step and eval runner of the PyTorch port.

Counterpart of the eval half of dvae_tpu/train/step.py.  PyTorch runs
eagerly, so the runner is a Python loop over the K batches of a chunk
where the JAX package scans them in one device program; it returns the
same ``EvalFields`` in arm-major layout.  The train step arrives with the
training slice.

Every batch is evaluated from the same state, as in the JAX package
(its scan carries no state): the reparameterization noise of variational
mode comes from a fresh CPU ``torch.Generator`` seeded with
``TrainState.seed`` for each batch, so a run's numbers do not depend on
how the batches were chunked, nor on the device.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from dvae_tpu_torch.config import TrainConfig, VAEConfig
from dvae_tpu_torch.models import mixvae
from dvae_tpu_torch.models.losses import LossOutputs, mixvae_loss


class TrainState(NamedTuple):
    """What eval reads of the training state.  ``opt_state`` keeps a
    loaded checkpoint's optimizer leaves (numpy) for the training slice."""

    params: Any            # stacked-arm dict of tensors
    bn: Any                # batch-norm running stats
    mask: torch.Tensor     # (C,) category keep-mask (all-ones = unpruned)
    seed: int              # seeds the eval noise generator
    epoch: int
    opt_state: Any = None


class EvalFields(NamedTuple):
    """Eval outputs stacked arm-major, (A, N, ·)."""

    c: torch.Tensor         # (A, N, C)
    s_mean: torch.Tensor    # (A, N, S)
    s_logvar: torch.Tensor  # (A, N, S)
    x_low: torch.Tensor     # (A, N, L)
    lab: torch.Tensor       # (A, N)


def _cast_params(params, dtype):
    return {name: {k: v.to(dtype) for k, v in layer.items()}
            for name, layer in params.items()}


def _apply_with_loss(params, bn, cfg: VAEConfig, x, generator, temp, mask,
                     prior_c):
    """Forward + loss with the fused-recon wiring in one place
    (dvae_tpu/train/step.py:135-159), eval mode."""
    fused = cfg.fused_recon
    outs, _ = mixvae.apply(params, bn, cfg, x, temp=temp, train=False,
                           mask=mask, prior_c=prior_c, skip_recon=fused,
                           generator=generator)
    aux = mixvae_loss(cfg, outs, x, prior_c,
                      fused_recon_args=(params, x) if fused else None)
    return outs, aux


def make_eval_step(cfg: VAEConfig, tcfg: TrainConfig):
    """Validation forward: no grad, eval semantics (hard one-hot, running
    BN statistics), the training compute dtype (bf16 under ``tcfg.bf16``)
    with the f32 islands of the loss.  Metrics leave in f32.

    step(state, x (B, D), prior_c (B, C) | None, temp) →
        (LossOutputs, labels (A, B), MixVAEOutputs)
    """
    compute_dtype = torch.bfloat16 if tcfg.bf16 else torch.float32
    cache = {}

    @torch.no_grad()
    def eval_step(state: TrainState, x, prior_c, temp):
        params = state.params
        if compute_dtype != torch.float32:
            # cast once per state, not once per batch
            if cache.get("src") is not params:
                cache["src"], cache["cast"] = params, _cast_params(
                    params, compute_dtype)
            params = cache["cast"]
        x = x.to(compute_dtype)
        gen = torch.Generator(device="cpu").manual_seed(state.seed)
        outs, aux = _apply_with_loss(params, state.bn, cfg, x, gen, temp,
                                     state.mask, prior_c)
        labels = torch.argmax(outs.c, dim=-1)
        aux = LossOutputs(*(v.float() for v in aux))
        return aux, labels, outs

    return eval_step


def make_eval_runner(cfg: VAEConfig, tcfg: TrainConfig):
    """run(state, x_chunk (K, B, D), temp, prior_chunk (K, B, C) | None) →
    (LossOutputs stacked (K, ...), EvalFields (A, K·B, ·)).

    Per-batch numerics are those of ``make_eval_step``."""
    ev = make_eval_step(cfg, tcfg)

    def run(state: TrainState, x_chunk, temp,
            prior_chunk: Optional[torch.Tensor] = None):
        auxes, fields = [], []
        for k in range(x_chunk.shape[0]):
            pb = None if prior_chunk is None else prior_chunk[k]
            aux, lab, outs = ev(state, x_chunk[k], pb, temp)
            auxes.append(aux)
            fields.append((outs.c, outs.s_mean, outs.s_logvar, outs.x_low,
                           lab))
        aux = LossOutputs(*(torch.stack(v) for v in zip(*auxes)))
        # (A, B, ...) per batch → (A, K·B, ...)
        stacked = EvalFields(*(torch.cat(v, dim=1) for v in zip(*fields)))
        return aux, stacked

    return run
