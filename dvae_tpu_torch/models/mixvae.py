"""Multi-arm coupled mixture VAE — the PyTorch port's model.

Counterpart of dvae_tpu/models/mixvae.py, itself the reference
``mixVAE_model`` (mmidas/nn_model.py:89-493).  The layout is the JAX one:
every per-arm parameter is stacked on a leading A axis, weights are
``(A, fan_in, fan_out)`` and a layer is ``x @ w + b``.  The A arms run as a
batch dimension of ``torch.baddbmm``, never as a Python loop.

A batch that every arm shares (no augmentation) stays ``(B, D)``: the
input layer fc1 is one ``(B, D) @ (D, A·F)`` GEMM, so the ``(A, B, D)``
broadcast the JAX package gets for free from XLA is never materialised.

Train mode draws input dropout, Gumbel noise, the reparameterization
noise and state dropout, and normalises with batch statistics while it
updates the running ones.  Every draw comes from an explicit ``Noise``
bundle (parity tests hand both packages the same numbers) or else from a
``torch.Generator``.  Under ``cfg.fused_encoder`` input dropout and fc1 run
as one hand-written kernel (``ops/encoder.fused_dropout_fc1``) that draws
its mask in-kernel from a seed, so no (A, B, D) dropped input exists.
Under ``cfg.use_pallas`` the train-mode categorical sample runs as one
hand-written kernel (``ops/gumbel.gumbel_softmax_fused``) that draws its
uniforms in-kernel from a seed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dvae_tpu_torch.config import VAEConfig
from dvae_tpu_torch.models.sampling import (dropout, gumbel_softmax,
                                            reparameterize)


class MixVAEOutputs(NamedTuple):
    """Forward outputs; every tensor has a leading A (arm) axis.  Field
    order and meaning as in dvae_tpu/models/mixvae.py:48-66."""

    x_rec: torch.Tensor      # (A, B, D); (A, B, F) decoder hidden under skip_recon;
                             # (A, B, C+S) decoder input under skip_trunk
    p_x: torch.Tensor        # ZINB success-probability head; zeros in MSE mode
    r_x: torch.Tensor        # ZINB zero-inflation head; zeros in MSE mode
    x_low: torch.Tensor      # (A, B, L)
    c: torch.Tensor          # (A, B, C) tau-sharpened categorical posterior, f32
    s_smp: torch.Tensor      # (A, B, S)
    c_smp: torch.Tensor      # (A, B, C) one-hot sample
    s_mean: torch.Tensor     # (A, B, S)
    s_logvar: torch.Tensor   # (A, B, S)
    c_prob: torch.Tensor     # (A, B, C) pre-sharpening softmax probs


class Noise(NamedTuple):
    """Explicit random numbers of one forward; each field may be None (then
    it is drawn from the generator).  Shapes: x_mask (A, B, D) keep-mask of
    input dropout, gumbel_u (A, B, C) uniforms, reparam_e (A, B, S),
    s_mask (A, B, S) keep-mask of state dropout.  ``gumbel_seed`` keys the
    uniforms the fused Gumbel kernel draws itself under ``cfg.use_pallas``;
    an explicit ``gumbel_u`` wins over it."""

    x_mask: Optional[torch.Tensor] = None
    gumbel_u: Optional[torch.Tensor] = None
    reparam_e: Optional[torch.Tensor] = None
    s_mask: Optional[torch.Tensor] = None
    gumbel_seed: Optional[int] = None


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


class _NormalizeTrain(torch.autograd.Function):
    """x̂ = (x − mean) · rsqrt(var + eps) over the rows of each (arm, row
    block, feature) of an f32 (A, G, n, F) tensor, biased variance.
    Autograd of that expression would keep x − mean alive for the backward
    as well, one more (A, B, F) tensor per layer; this keeps x (which the
    ReLU before it keeps anyway), the mean and rsqrt only and recomputes x̂.
    Returns (x̂, mean, var); mean and var carry no gradient."""

    @staticmethod
    def forward(ctx, xg, eps):
        mean = xg.mean(dim=2, keepdim=True)
        var = xg.var(dim=2, unbiased=False, keepdim=True)
        rstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(xg, mean, rstd)
        ctx.mark_non_differentiable(mean, var)
        return (xg - mean) * rstd, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        xg, mean, rstd = ctx.saved_tensors
        xhat = (xg - mean) * rstd
        gx = gy - gy.mean(dim=2, keepdim=True) \
            - xhat * (gy * xhat).mean(dim=2, keepdim=True)
        return gx * rstd, None


def _batch_norm(h: torch.Tensor, stats: dict, train: bool, momentum: float,
                eps: float, groups: int = 1):
    """BatchNorm1d(affine=False) with torch semantics on (A, B, F), per arm
    (dvae_tpu/models/mixvae.py:146-208), in f32 with ``cfg.eps`` (1e-8,
    not torch's default 1e-5).  Returns (y in h's dtype, new stats).

    Train: normalise with the biased batch variance, update the running
    variance with the unbiased one; ``groups`` > 1 is ghost batch norm,
    statistics per contiguous row block, running stats updated with the
    blocks' mean.  Eval: normalise with the running statistics."""
    if not train:
        mean = stats["mean"].float()[:, None, :]
        var = stats["var"].float()[:, None, :]
        return ((h.float() - mean) * torch.rsqrt(var + eps)).to(h.dtype), stats
    A, n, F = h.shape
    if n % groups:
        raise ValueError(f"batch {n} not divisible by bn_groups={groups}")
    ng = n // groups
    y, mean_g, var_g = _NormalizeTrain.apply(
        h.float().reshape(A, groups, ng, F), eps)
    mean = mean_g.mean(dim=(1, 2))
    unbiased = (var_g * (ng / max(ng - 1, 1))).mean(dim=(1, 2))
    new = {"mean": (1 - momentum) * stats["mean"] + momentum * mean,
           "var": (1 - momentum) * stats["var"] + momentum * unbiased}
    return y.reshape(A, n, F).to(h.dtype), new


def _fused_fc1(params, x, cfg: VAEConfig, noise: Noise, generator,
               enc_seed: Optional[int]) -> torch.Tensor:
    """fc1 pre-activation through the fused dropout+fc1 kernel.  On the CPU
    the mask is drawn on the host, as the JAX package does off the TPU
    (dvae_tpu/models/mixvae.py:369-371); on CUDA the kernel draws it from
    ``enc_seed``."""
    from dvae_tpu_torch.ops.encoder import (dropout_mask_host,
                                            fused_dropout_fc1)
    A, D = cfg.n_arm, cfg.input_dim
    mask = noise.x_mask
    if mask is None and x.device.type == "cpu" and cfg.x_drop > 0:
        mask = dropout_mask_host(generator, (A, x.shape[-2], D), cfg.x_drop)
    if enc_seed is None:
        dev = generator.device if generator is not None else x.device
        enc_seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator,
                                     device=dev))
    return fused_dropout_fc1(enc_seed, x, params["fc1"]["w"],
                             params["fc1"]["b"], cfg.x_drop,
                             None if mask is None else mask.to(x.device))


def _encoder(params, bn, x, cfg: VAEConfig, train: bool = False,
             noise: Noise = Noise(), generator=None,
             enc_seed: Optional[int] = None):
    """(x_low, c_prob, new_bn) — reference mmidas/nn_model.py:263-269."""
    eps, mom, g = cfg.eps, cfg.momentum, cfg.bn_groups
    if train and cfg.fused_encoder:
        y1 = _fused_fc1(params, x, cfg, noise, generator, enc_seed)
    elif train and (cfg.x_drop > 0 or noise.x_mask is not None):
        xs = x if x.dim() == 3 else x.expand(cfg.n_arm, *x.shape)
        y1 = _linear(params["fc1"], dropout(xs, cfg.x_drop, generator,
                                            noise.x_mask))
    else:
        y1 = _fc1(params["fc1"], x)
    new_bn = {}
    h, new_bn["bn1"] = _batch_norm(torch.relu(y1), bn["bn1"], train, mom, eps,
                                   g)
    for layer, norm in (("fc2", "bn2"), ("fc3", "bn3"), ("fc4", "bn4")):
        h, new_bn[norm] = _batch_norm(torch.relu(_linear(params[layer], h)),
                                      bn[norm], train, mom, eps, g)
    x_low, new_bn["bn5"] = _batch_norm(torch.relu(_linear(params["fc5"], h)),
                                       bn["bn5"], train, mom, eps, g)
    c_prob = torch.softmax(_linear(params["fcc"], x_low), dim=-1)
    return x_low, c_prob, new_bn


def _sample_categorical(c, cfg: VAEConfig, temp, train: bool, noise: Noise,
                        generator) -> torch.Tensor:
    """Gumbel sample of the stacked (A, B, C) posterior
    (dvae_tpu/models/mixvae.py:312-323): in train mode under
    ``cfg.use_pallas`` through the fused kernel, which draws its own
    uniforms from ``noise.gumbel_seed`` (or a seed from ``generator``)
    unless ``noise.gumbel_u`` gives them; eval is the deterministic
    one-hot."""
    if train and cfg.use_pallas:
        from dvae_tpu_torch.ops.gumbel import gumbel_softmax_fused
        seed = noise.gumbel_seed
        if seed is None and noise.gumbel_u is None:
            dev = generator.device if generator is not None else c.device
            seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator,
                                     device=dev))
        return gumbel_softmax_fused(0 if seed is None else seed, c,
                                    noise.gumbel_u, temp, cfg.eps, cfg.hard)
    if train:
        return gumbel_softmax(c, temp, cfg.eps, hard=cfg.hard,
                              generator=generator, u=noise.gumbel_u)
    return gumbel_softmax(c, temp, cfg.eps, hard=True, gumbel_noise=False)


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
          skip_trunk: bool = False,
          noise=None,
          generator: Optional[torch.Generator] = None,
          enc_seed: Optional[int] = None):
    """Forward of all A arms at once.

    Args:
      params, bn_state: from ``init_params`` / ``init_bn_state`` (or a
        checkpoint through ``utils.checkpoint.params_from_jax``).
      x: (B, D) batch shared by every arm, or (A, B, D) per-arm views.
      train: dropout, batch statistics (and their running update) and
        Gumbel noise; else eval semantics.
      mask: optional (C,) keep-mask for category pruning.
      prior_c: optional (B, C) reference prior (ref_prior mode).
      skip_recon: stop the decoder before fc11; the (A, B, F) pre-output
        hidden rides in the ``x_rec`` slot for the fused recon-loss kernel.
      skip_trunk: stop the decoder before fc6; its input
        ``z = [c_smp, dropout(s_smp)]`` (A, B, C+S) rides in the ``x_rec``
        slot for the fused whole-decoder kernel (``ops/decoder.py``).  The
        state dropout is drawn as on the other paths, so the same noise
        gives the same numbers with and without the flag.
      noise: a ``Noise`` bundle, or an (A, B, S) tensor of
        reparameterization noise (variational mode draws it even in eval,
        dvae_tpu/models/mixvae.py:288-293).  What it leaves out comes from
        ``generator``.
      enc_seed: the fused encoder kernel's mask seed (train mode under
        ``cfg.fused_encoder``); drawn from ``generator`` when None.  The
        fused Gumbel kernel's seed (train mode under ``cfg.use_pallas``)
        rides in ``noise.gumbel_seed`` likewise.

    Returns (MixVAEOutputs, bn_state) — the updated running statistics in
    train mode, the given ones in eval.
    """
    if cfg.mode not in ("MSE", "ZINB"):
        raise ValueError(f"unknown reconstruction mode {cfg.mode!r}")
    if noise is None:
        noise = Noise()
    elif isinstance(noise, torch.Tensor):
        noise = Noise(reparam_e=noise)
    A = cfg.n_arm
    if x.dim() == 3 and x.shape[0] != A:
        raise ValueError(f"expected leading arm axis {A}, got {tuple(x.shape)}")

    x_low, c_prob, new_bn = _encoder(params, bn_state, x, cfg, train, noise,
                                     generator, enc_seed)
    if not train:
        new_bn = bn_state

    # tau-sharpened posterior in f32; pruned categories → -inf
    # (reference mmidas/nn_model.py:332-345)
    logits_tau = (c_prob / cfg.tau).float()
    if mask is not None:
        logits_tau = torch.where(mask > 0, logits_tau,
                                 torch.full_like(logits_tau, -torch.inf))
    c = torch.softmax(logits_tau, dim=-1)
    c_smp = _sample_categorical(c, cfg, temp, train, noise, generator)
    c_in = c_smp.to(x_low.dtype)

    y_cat = (prior_c.to(x_low.dtype).expand(A, *prior_c.shape)
             if cfg.ref_prior and prior_c is not None else c_in)
    y = torch.cat([x_low, y_cat], dim=-1)
    s_mean = _linear(params["fc_mu"], y)
    if cfg.variational:
        s_var = torch.sigmoid(_linear(params["fc_sigma"], y))
        s_logvar = torch.log(s_var + cfg.eps)
        s_smp = reparameterize(s_mean, s_logvar, cfg.reparam_noise,
                               generator=generator, e=noise.reparam_e)
    else:
        s_logvar = torch.zeros_like(s_mean)
        s_smp = s_mean

    s_dec = (dropout(s_smp, cfg.s_drop, generator, noise.s_mask)
             if train else s_smp)
    if skip_trunk:
        x_rec = torch.cat([c_in, s_dec], dim=-1)
        p_x = r_x = x_rec.new_zeros(x_rec.shape[:-1] + (1,))
        return (MixVAEOutputs(x_rec, p_x, r_x, x_low, c, s_smp, c_smp,
                              s_mean, s_logvar, c_prob), new_bn)
    h_dec = _decode_hidden(params, c_in, s_dec)
    if skip_recon:
        x_rec = h_dec
        small = h_dec.new_zeros(h_dec.shape[:-1] + (1,))
        p_x = r_x = small
    else:
        x_rec = torch.relu(_linear(params["fc11"], h_dec))
        if cfg.mode == "ZINB":
            p_x = torch.sigmoid(_linear(params["fc11_p"], h_dec))
            r_x = torch.sigmoid(_linear(params["fc11_r"], h_dec))
        else:
            # zero-stride view: the MSE-mode heads cost no (A, B, D) memory
            p_x = r_x = x_rec.new_zeros(()).expand_as(x_rec)
    outs = MixVAEOutputs(x_rec, p_x, r_x, x_low, c, s_smp, c_smp,
                         s_mean, s_logvar, c_prob)
    return outs, new_bn
