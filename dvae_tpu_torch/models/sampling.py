"""Stochastic sampling primitives: Gumbel-softmax and reparameterization.

Counterpart of dvae_tpu/models/sampling.py.  Every random draw takes an
explicit ``torch.Generator`` or an explicit noise tensor: torch and JAX
never share a bitstream, so parity tests hand both sides the same numbers.

Reference semantics:
  * ``dropout``         — dvae_tpu/models/mixvae.py:211-216 (inverted
    dropout, ``where(mask, x / keep, 0)``)
  * ``gumbel_softmax``  — mmidas/nn_model.py:457-493 (straight-through
    one-hot at :487-493; eval form at :341-343)
  * ``reparameterize``  — mmidas/nn_model.py:413-428 (uniform-noise quirk
    at :427; see config.ReparamNoise)
"""

from __future__ import annotations

from typing import Optional

import torch

from dvae_tpu_torch.config import ReparamNoise


def _draw(kind: str, shape, like: torch.Tensor,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """U[0, 1) or N(0, 1) numbers of ``shape`` drawn on the generator's own
    device, then moved to ``like``'s device and dtype: a CPU generator gives
    the same numbers whatever device the model runs on."""
    dev = generator.device if generator is not None else like.device
    fn = torch.rand if kind == "uniform" else torch.randn
    e = fn(shape, generator=generator, device=dev, dtype=torch.float32)
    return e.to(device=like.device, dtype=like.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Train-mode inverted dropout: ``where(mask, x / keep, 0)`` in x's
    dtype, with the keep-mask given or drawn from ``generator`` with
    P(keep) = 1 − rate.  ``rate`` 0 without a mask returns x itself."""
    keep = 1.0 - rate
    if mask is None:
        if rate <= 0.0:
            return x
        dev = generator.device if generator is not None else x.device
        mask = (torch.rand(x.shape, generator=generator, device=dev)
                < keep).to(x.device)
    return torch.where(mask.bool(), x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def sample_gumbel(shape, like: torch.Tensor, eps: float,
                  generator: Optional[torch.Generator] = None,
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-log(-log(U + eps) + eps) with U ~ Uniform[0, 1) (or the given ``u``)."""
    if u is None:
        u = _draw("uniform", shape, like, generator)
    return -torch.log(-torch.log(u + eps) + eps)


def gumbel_softmax_sample(phi: torch.Tensor, temperature: float, eps: float,
                          generator: Optional[torch.Generator] = None,
                          u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax((log(phi + eps) + Gumbel noise) / temperature)."""
    logits = torch.log(phi + eps) + sample_gumbel(phi.shape, phi, eps,
                                                  generator, u)
    return torch.softmax(logits / temperature, dim=-1)


def hard_one_hot_st(y: torch.Tensor) -> torch.Tensor:
    """Straight-through hard one-hot: forward = argmax one-hot, backward =
    identity.  ``(y - y) + one_hot`` is exactly the one-hot in value."""
    idx = torch.argmax(y, dim=-1)
    y_hard = torch.nn.functional.one_hot(idx, y.shape[-1]).to(y.dtype)
    return y - y.detach() + y_hard


def gumbel_softmax(phi: torch.Tensor, temperature: float, eps: float,
                   hard: bool = False, gumbel_noise: bool = True,
                   generator: Optional[torch.Generator] = None,
                   u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gumbel-softmax / ST-Gumbel-softmax sample over the last axis.

    ``gumbel_noise=False, hard=True`` is the eval path: the deterministic
    argmax one-hot (reference mmidas/nn_model.py:341-343).
    """
    y = (gumbel_softmax_sample(phi, temperature, eps, generator, u)
         if gumbel_noise else phi)
    return hard_one_hot_st(y) if hard else y


def reparameterize(mean: torch.Tensor, logvar: torch.Tensor,
                   noise: ReparamNoise = ReparamNoise.GAUSSIAN,
                   generator: Optional[torch.Generator] = None,
                   e: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean + e·std with std = sqrt(exp(logvar)).

    ``e`` is the explicit noise tensor (same shape as ``mean``); without it
    the noise is drawn from ``generator``: N(0, 1), or U[0, 1) under
    ``ReparamNoise.UNIFORM`` (the reference's torch.rand_like quirk).
    """
    std = torch.sqrt(torch.exp(logvar))
    if e is None:
        kind = "uniform" if noise == ReparamNoise.UNIFORM else "normal"
        e = _draw(kind, mean.shape, mean, generator)
    return mean + e.to(mean.dtype) * std
