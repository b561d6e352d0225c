"""Multi-arm coupled mixture VAE — the PyTorch port's model (eval mode).

Counterpart of dvae_tpu/models/mixvae.py, itself the reference
``mixVAE_model`` (mmidas/nn_model.py:89-493).  The layout is the JAX one:
every per-arm parameter is stacked on a leading A axis, weights are
``(A, fan_in, fan_out)`` and a layer is ``x @ w + b``.  The A arms run as a
batch dimension of ``torch.baddbmm``, never as a Python loop.

A batch that every arm shares (no augmentation) stays ``(B, D)``: the
input layer fc1 is one ``(B, D) @ (D, A·F)`` GEMM, so the ``(A, B, D)``
broadcast the JAX package gets for free from XLA is never materialised.

Train mode (dropout, batch-norm statistic updates, Gumbel noise) arrives
with the training slice of the port; ``apply`` raises for it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dvae_tpu_torch.config import VAEConfig
from dvae_tpu_torch.models.sampling import gumbel_softmax, reparameterize


class MixVAEOutputs(NamedTuple):
    """Forward outputs; every tensor has a leading A (arm) axis.  Field
    order and meaning as in dvae_tpu/models/mixvae.py:48-66."""

    x_rec: torch.Tensor      # (A, B, D), or (A, B, F) decoder hidden under skip_recon
    p_x: torch.Tensor        # ZINB heads: zeros in MSE mode
    r_x: torch.Tensor
    x_low: torch.Tensor      # (A, B, L)
    c: torch.Tensor          # (A, B, C) tau-sharpened categorical posterior, f32
    s_smp: torch.Tensor      # (A, B, S)
    c_smp: torch.Tensor      # (A, B, C) one-hot sample
    s_mean: torch.Tensor     # (A, B, S)
    s_logvar: torch.Tensor   # (A, B, S)
    c_prob: torch.Tensor     # (A, B, C) pre-sharpening softmax probs


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _arm_shapes(cfg: VAEConfig) -> dict:
    D, F, L, C, S = (cfg.input_dim, cfg.fc_dim, cfg.lowD_dim,
                     cfg.n_categories, cfg.state_dim)
    shapes = {
        "fc1": (D, F), "fc2": (F, F), "fc3": (F, F), "fc4": (F, F),
        "fc5": (F, L), "fcc": (L, C),
        "fc_mu": (L + C, S), "fc_sigma": (L + C, S),
        "fc6": (C + S, L), "fc7": (L, F), "fc8": (F, F), "fc9": (F, F),
        "fc10": (F, F), "fc11": (F, D),
    }
    if cfg.mode == "ZINB":
        shapes["fc11_p"] = (F, D)
        shapes["fc11_r"] = (F, D)
    return shapes


def init_params(generator: torch.Generator, cfg: VAEConfig,
                device="cpu", dtype=torch.float32) -> dict:
    """Stacked-arm parameters with torch's ``nn.Linear`` default init,
    W, b ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)).  The numbers are drawn on
    the generator's device and moved to ``device``."""
    A = cfg.n_arm
    params = {}
    for name, (fan_in, fan_out) in _arm_shapes(cfg).items():
        bound = 1.0 / fan_in ** 0.5
        layer = {}
        for leaf, shape in (("w", (A, fan_in, fan_out)), ("b", (A, fan_out))):
            u = torch.rand(shape, generator=generator,
                           device=generator.device, dtype=torch.float32)
            layer[leaf] = ((2.0 * u - 1.0) * bound).to(device=device,
                                                       dtype=dtype)
        params[name] = layer
    return params


def init_bn_state(cfg: VAEConfig, device="cpu",
                  dtype=torch.float32) -> dict:
    """Running mean/var of the five encoder batch-norms, per arm."""
    A, F, L = cfg.n_arm, cfg.fc_dim, cfg.lowD_dim
    dims = {"bn1": F, "bn2": F, "bn3": F, "bn4": F, "bn5": L}
    return {name: {"mean": torch.zeros((A, d), device=device, dtype=dtype),
                   "var": torch.ones((A, d), device=device, dtype=dtype)}
            for name, d in dims.items()}


# ---------------------------------------------------------------------------
# Layers (arms batched on the leading axis)
# ---------------------------------------------------------------------------

def _linear(p: dict, h: torch.Tensor) -> torch.Tensor:
    """(A, B, fan_in) @ (A, fan_in, fan_out) + (A, fan_out)."""
    return torch.baddbmm(p["b"][:, None, :], h, p["w"])


def _fc1(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Input layer.  Shared x (B, D): one GEMM against the arms' weights
    laid side by side, (D, A·F), so no (A, B, D) copy of x exists."""
    if x.dim() == 3:
        return _linear(p, x)
    A, D, F = p["w"].shape
    w_cat = p["w"].permute(1, 0, 2).reshape(D, A * F)
    y = (x @ w_cat).view(x.shape[0], A, F).transpose(0, 1)
    return y + p["b"][:, None, :]


def _batch_norm_eval(h: torch.Tensor, stats: dict, eps: float) -> torch.Tensor:
    """BatchNorm1d(affine=False) in eval mode: normalise with the running
    statistics in f32, with ``cfg.eps`` (1e-8), not torch's default 1e-5."""
    mean = stats["mean"].float()[:, None, :]
    var = stats["var"].float()[:, None, :]
    return ((h.float() - mean) * torch.rsqrt(var + eps)).to(h.dtype)


def _encoder(params, bn, x, cfg: VAEConfig):
    """(x_low, c_prob) — reference mmidas/nn_model.py:263-269, eval mode."""
    eps = cfg.eps
    h = _batch_norm_eval(torch.relu(_fc1(params["fc1"], x)), bn["bn1"], eps)
    for layer, norm in (("fc2", "bn2"), ("fc3", "bn3"), ("fc4", "bn4")):
        h = _batch_norm_eval(torch.relu(_linear(params[layer], h)),
                             bn[norm], eps)
    x_low = _batch_norm_eval(torch.relu(_linear(params["fc5"], h)),
                             bn["bn5"], eps)
    c_prob = torch.softmax(_linear(params["fcc"], x_low), dim=-1)
    return x_low, c_prob


def _decode_hidden(params, c_smp, s):
    """Decoder trunk up to, not including, the output layer fc11."""
    h = torch.relu(_linear(params["fc6"], torch.cat([c_smp, s], dim=-1)))
    for layer in ("fc7", "fc8", "fc9", "fc10"):
        h = torch.relu(_linear(params[layer], h))
    return h


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def apply(params, bn_state, cfg: VAEConfig, x: torch.Tensor,
          temp: float = 1.0, train: bool = False,
          mask: Optional[torch.Tensor] = None,
          prior_c: Optional[torch.Tensor] = None,
          skip_recon: bool = False,
          noise: Optional[torch.Tensor] = None,
          generator: Optional[torch.Generator] = None):
    """Eval-mode forward of all A arms at once.

    Args:
      params, bn_state: from ``init_params`` / ``init_bn_state`` (or a
        checkpoint through ``utils.checkpoint.params_from_jax``).
      x: (B, D) batch shared by every arm, or (A, B, D) per-arm views.
      mask: optional (C,) keep-mask for category pruning.
      prior_c: optional (B, C) reference prior (ref_prior mode).
      skip_recon: stop the decoder before fc11; the (A, B, F) pre-output
        hidden rides in the ``x_rec`` slot for the fused recon-loss kernel.
      noise: (A, B, S) reparameterization noise.  Variational mode draws
        it even in eval (dvae_tpu/models/mixvae.py:288-293); without
        ``noise`` it comes from ``generator``.

    Returns (MixVAEOutputs, bn_state) — eval leaves the statistics as they
    are.
    """
    if train:
        raise NotImplementedError(
            "train mode (dropout, BN updates, Gumbel noise) is not ported "
            "yet; the port serves eval mode only")
    if cfg.mode != "MSE":
        raise NotImplementedError(f"mode {cfg.mode!r} is not ported yet")
    A = cfg.n_arm
    if x.dim() == 3 and x.shape[0] != A:
        raise ValueError(f"expected leading arm axis {A}, got {tuple(x.shape)}")

    x_low, c_prob = _encoder(params, bn_state, x, cfg)

    # tau-sharpened posterior in f32; pruned categories → -inf
    # (reference mmidas/nn_model.py:332-345)
    logits_tau = (c_prob / cfg.tau).float()
    if mask is not None:
        logits_tau = torch.where(mask > 0, logits_tau,
                                 torch.full_like(logits_tau, -torch.inf))
    c = torch.softmax(logits_tau, dim=-1)
    c_smp = gumbel_softmax(c, temp, cfg.eps, hard=True, gumbel_noise=False)
    c_in = c_smp.to(x_low.dtype)

    y_cat = (prior_c.to(x_low.dtype).expand(A, *prior_c.shape)
             if cfg.ref_prior and prior_c is not None else c_in)
    y = torch.cat([x_low, y_cat], dim=-1)
    s_mean = _linear(params["fc_mu"], y)
    if cfg.variational:
        s_var = torch.sigmoid(_linear(params["fc_sigma"], y))
        s_logvar = torch.log(s_var + cfg.eps)
        s_smp = reparameterize(s_mean, s_logvar, cfg.reparam_noise,
                               generator=generator, e=noise)
    else:
        s_logvar = torch.zeros_like(s_mean)
        s_smp = s_mean

    h_dec = _decode_hidden(params, c_in, s_smp)
    if skip_recon:
        x_rec = h_dec
        small = h_dec.new_zeros(h_dec.shape[:-1] + (1,))
        p_x = r_x = small
    else:
        x_rec = torch.relu(_linear(params["fc11"], h_dec))
        # zero-stride view: the MSE-mode heads cost no (A, B, D) memory
        p_x = r_x = x_rec.new_zeros(()).expand_as(x_rec)
    outs = MixVAEOutputs(x_rec, p_x, r_x, x_low, c, s_smp, c_smp,
                         s_mean, s_logvar, c_prob)
    return outs, bn_state
