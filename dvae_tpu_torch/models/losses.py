"""Loss of the coupled mixVAE, vectorized over arms.

Counterpart of dvae_tpu/models/losses.py (reference ``mixVAE_model.loss``,
mmidas/nn_model.py:495-598).  The O(A²) coupling terms come from one
(A, A) Gram matrix, centred first (see ``_pair_sums_from_gram``); the
naive pair-loop versions stay beside them as oracles.  ``mixvae_loss``
takes the batch ``x`` as (B, D), shared by every arm, or (A, B, D).

Gradients come from torch autograd.  The fused reconstruction branch goes
through the autograd ops ``ops/recon.fused_recon_mse`` (MSE mode; with
``cfg.fused_decoder`` the whole-decoder ``ops/decoder.fused_decoder_mse``)
and ``ops/zinb.fused_zinb`` (ZINB mode): the fused forward+backward kernel
when a gradient is asked for.  The binarized-BCE metric is detached in
both MSE branches, as in the JAX package (dvae_tpu/models/losses.py:105,
:353).  Under ``cfg.use_pallas`` the coupling distance goes through the
fused kernel of ``ops/coupling.py``, in training and in eval
(dvae_tpu/models/losses.py:396-401); its gradient is the eager form's.

On a mesh (``spmd``) ``outs`` and ``x`` are this rank's blocks.  The
reconstruction runs through the partitioned kernels of
``ops/partitioned.py`` (dvae_tpu/models/losses.py:262, :297-340), or on the
plain path as sums over the local rows; per-arm terms are summed over the
batch group and gathered over the arm group, and the coupling terms are
computed on the gathered (A, B, C) posteriors.  Every rank gets the same
loss; the collectives' backwards (``parallel.runtime``) count each term
once.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from dvae_tpu_torch.config import VAEConfig
from dvae_tpu_torch.models.mixvae import MixVAEOutputs
from dvae_tpu_torch.models.sampling import hard_one_hot_st
from dvae_tpu_torch.parallel.runtime import (all_gather,
                                             gather_for_replicated,
                                             sum_for_replicated)

_LOG_CLAMP = -100.0  # torch binary_cross_entropy clamps log at -100
_P_TINY = 1e-37      # smallest guard that stays a normal f32


class LossOutputs(NamedTuple):
    """Mirrors dvae_tpu/models/losses.py:27-51."""

    total: torch.Tensor        # scalar
    loss_rec: torch.Tensor     # (A,)
    loss_joint: torch.Tensor   # scalar
    neg_entropy: torch.Tensor  # scalar
    c_dist: torch.Tensor       # scalar
    c_l2_dist: torch.Tensor    # scalar
    kl: torch.Tensor           # (A,)
    ll: torch.Tensor           # (A,) NaN under the fused ZINB kernel,
                               # which never materialises x_rec
    rec_nll: torch.Tensor      # (A,) == loss_rec in ZINB mode, NaN in MSE


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------

def binarize(x: torch.Tensor, thr: float) -> torch.Tensor:
    """where(x > thr, 1, 0) — reference mmidas/nn_model.py:39-40."""
    return (x > thr).to(x.dtype)


def _safe_log(p: torch.Tensor) -> torch.Tensor:
    """log(p) clamped to -100 (torch BCE semantics)."""
    return torch.where(p >= _P_TINY,
                       torch.clamp(torch.log(torch.clamp(p, min=_P_TINY)),
                                   min=_LOG_CLAMP),
                       torch.full_like(p, _LOG_CLAMP))


def bce(p: torch.Tensor, t: torch.Tensor, dim=None) -> torch.Tensor:
    """Mean binary cross entropy with torch's -100 log clamp; over all
    elements, or over ``dim``."""
    v = t * _safe_log(p) + (1.0 - t) * _safe_log(1.0 - p)
    return -(v.mean() if dim is None else v.mean(dim=dim))


def kl_gaussian(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """-0.5·mean_B(1 + logvar − mu² − exp(logvar)) summed over state dims;
    (…, B, S) → (…)."""
    return (-0.5 * (1 + logvar - mean ** 2 - torch.exp(logvar))
            .mean(dim=-2)).sum(dim=-1)


def recon_loss_mse(x_rec: torch.Tensor, x: torch.Tensor,
                   thr: float = 0.1) -> torch.Tensor:
    """Per-arm 0.5·sumMSE/B + 0.5·BCE(binarize(x_rec), binarize(x)) for
    x_rec (A, B, D) against x (B, D) or (A, B, D) — reference
    mmidas/nn_model.py:542-546.  The BCE term is a value-only metric."""
    B = x.shape[-2]
    mse = 0.5 * ((x_rec - x) ** 2).sum(dim=(1, 2)) / B
    bce_term = 0.5 * bce(binarize(x_rec, thr),
                         binarize(x, thr).expand_as(x_rec), dim=(1, 2))
    return mse + bce_term.detach()


def zinb_loss(x_rec: torch.Tensor, x_p: torch.Tensor, x_r: torch.Tensor,
              x: torch.Tensor, eps: float = 1e-6, dim=None) -> torch.Tensor:
    """Zero-inflated negative-binomial reconstruction loss, the mean over
    all elements or over ``dim`` (reference ``zinb_loss``, mmidas/nn_model.py:642-676;
    dvae_tpu/models/losses.py:108-127).  ``x`` holds log1p values, turned
    back into counts; ``x_rec``, ``x_p`` and ``x_r`` are the NB rate, the
    success probability and the zero-inflation probability heads."""
    k = torch.exp(x) - 1.0
    r = x_rec + eps
    p = (1 - eps) * (x_p + eps)
    z = (1 - eps) * (x_r + eps)
    nonzero = (x > 0).to(x.dtype)
    loss_zero = (nonzero - 1.0) * torch.log(z + (1.0 - z) * (1.0 - p) ** r)
    loss_nonzero = nonzero * (
        -torch.lgamma(k + r) + torch.lgamma(r)
        - k * torch.log(p) - r * torch.log(1.0 - p) - torch.log(1.0 - z))
    v = loss_zero + loss_nonzero
    return v.mean() if dim is None else v.mean(dim=dim)


def inv_sd(c: torch.Tensor, eps: float) -> torch.Tensor:
    """sqrt(1 / (var_B(c) + eps)) with the unbiased batch variance;
    (B, C) → (1, C) or (A, B, C) → (A, 1, C)."""
    var = torch.var(c, dim=-2, keepdim=True, unbiased=True)
    return torch.sqrt(1.0 / (var + eps))


def neg_entropy(c: torch.Tensor, logc: torch.Tensor) -> torch.Tensor:
    """mean_B Σ_C c·log c (reference mmidas/nn_model.py:65-66)."""
    return (c * logc).sum(dim=-1).mean(dim=-1)


def arm_combs(A: int) -> float:
    """Number of unordered arm pairs, at least 1 (reference
    mmidas/nn_model.py:48-50)."""
    return max(A * (A - 1) / 2, 1)


def l2_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance along the last axis (reference
    mmidas/nn_model.py:53-54)."""
    return ((a - b) ** 2).sum(dim=-1)


def simplex_dist(a, b) -> torch.Tensor:
    """Precision-scaled simplex distance of two arms' posteriors (reference
    mmidas/nn_model.py:57-62): each argument is a ``(log c, inv_sd)`` pair
    and the distance is ``l2_dist`` of their products — the per-pair form
    of what ``coupling_distance`` sums over every pair."""
    loga, inv_vara = a
    logb, inv_varb = b
    return l2_dist(loga * inv_vara, logb * inv_varb)


def _pair_sums_from_gram(v: torch.Tensor) -> torch.Tensor:
    """Σ_{a<b} mean_B ‖v_a − v_b‖² for v (A, B, C), from one Gram matrix:
    A·tr(G) − Σ G with G = v vᵀ / B.  v is centred first — dead
    categories carry identical huge constants in every arm and the
    uncentred f32 Gram entries would cancel catastrophically
    (dvae_tpu/models/losses.py:168-187)."""
    v = v.float()
    v = v - v.mean(dim=(0, 1))
    A, B = v.shape[0], v.shape[1]
    g = torch.einsum("abc,dbc->ad", v, v) / B
    # diagonal().sum(), not torch.trace: trace's backward reads the
    # gradient back to the host, a device synchronisation every step
    return A * g.diagonal().sum() - g.sum()


def coupling_distance(c: torch.Tensor, eps: float) -> torch.Tensor:
    """Σ over arm pairs of the mean precision-scaled simplex distance."""
    logc = torch.log(c + eps)
    return _pair_sums_from_gram(logc * inv_sd(c, eps))


def coupling_distance_naive(c: torch.Tensor, eps: float) -> torch.Tensor:
    """Loop-over-pairs oracle for ``coupling_distance``."""
    A = c.shape[0]
    total = c.new_zeros(())
    for a in range(A):
        pa = torch.log(c[a] + eps) * inv_sd(c[a], eps)
        for b in range(a + 1, A):
            pb = torch.log(c[b] + eps) * inv_sd(c[b], eps)
            total = total + ((pa - pb) ** 2).sum(dim=-1).mean()
    return total


def l2_pair_sum_naive(v: torch.Tensor) -> torch.Tensor:
    """Loop-over-pairs oracle of ``_pair_sums_from_gram``:
    Σ_{a<b} mean_B ‖v_a − v_b‖²."""
    A = v.shape[0]
    total = v.new_zeros(())
    for a in range(A):
        for b in range(a + 1, A):
            total = total + ((v[a] - v[b]) ** 2).sum(dim=-1).mean()
    return total


def mixvae_loss_naive(cfg: VAEConfig, outs: MixVAEOutputs,
                      x: torch.Tensor) -> torch.Tensor:
    """Total-loss oracle with explicit pair loops — the direct transcription
    of the reference accumulation (mmidas/nn_model.py:539-587), unfused,
    without the prior."""
    A, C = cfg.n_arm, cfg.n_categories
    eps = cfg.eps
    xs = x.expand(A, *x.shape) if x.dim() == 2 else x
    total = x.new_zeros((), dtype=torch.float32)
    for a in range(A):
        if cfg.mode == "ZINB":
            rec = zinb_loss(outs.x_rec[a], outs.p_x[a], outs.r_x[a], xs[a])
        else:
            rec = recon_loss_mse(outs.x_rec[a:a + 1], xs[a])[0]
        kl_a = (kl_gaussian(outs.s_mean[a], outs.s_logvar[a])
                if cfg.variational else 0.0)
        total = total + max(A - 1, 1) * (rec + cfg.beta * kl_a)
    for a in range(A):
        ca = outs.c[a]
        pa = torch.log(ca + eps) * inv_sd(ca, eps)
        ha = neg_entropy(ca, torch.log(ca + eps))
        for b in range(a + 1, A):
            cb = outs.c[b]
            pb = torch.log(cb + eps) * inv_sd(cb, eps)
            hb = neg_entropy(cb, torch.log(cb + eps))
            d = ((pa - pb) ** 2).sum(dim=-1).mean()
            total = total + cfg.lam * d + ha + hb
    n_pairs = max(A * (A - 1) // 2, 1)
    return total + n_pairs * ((C / 2) * math.log(2 * math.pi)
                              - 0.5 * math.log(2 * cfg.lam))


# ---------------------------------------------------------------------------
# Full loss
# ---------------------------------------------------------------------------

def _gather_all(t: torch.Tensor, spmd) -> torch.Tensor:
    """Stacked (k, A_l, B_l, ·) blocks → the whole (k, A, B, ·) tensors on
    every rank, each block's gradient back to its owner only."""
    if spmd is None:
        return t
    t = gather_for_replicated(t, spmd.batch_group, 2)
    return gather_for_replicated(t, spmd.arm_group, 1)


def mixvae_loss(cfg: VAEConfig, outs: MixVAEOutputs, x: torch.Tensor,
                prior_c: Optional[torch.Tensor] = None,
                fused_recon_args: Optional[tuple] = None,
                fused_trunk: bool = False, spmd=None) -> LossOutputs:
    """Total cpl-mixVAE loss (reference mmidas/nn_model.py:495-598):

      total = scaler·Σ_a (rec_a + β·KL_a)
            + λ·Σ_pairs d_simplex + Σ_pairs (−H_a − H_b) + constants

    ``fused_recon_args = (params, x_target)`` routes the reconstruction
    terms through the fused kernel (``ops/recon.fused_recon_mse``, or
    ``ops/zinb.fused_zinb`` in ZINB mode): ``outs.x_rec`` then holds the
    decoder pre-output hidden (A, B, F) and ``x_target`` is (B, D) or
    (A, B, D).  With ``fused_trunk`` (MSE mode, ``cfg.fused_decoder``)
    ``outs.x_rec`` holds the decoder input z (A, B, C+S) instead and the
    whole fc6..fc11 chain runs in ``ops/decoder.fused_decoder_mse``.
    ``spmd``: this rank's shards on a mesh (see the module docstring).
    """
    A, C = cfg.n_arm, cfg.n_categories
    B_l, D = x.shape[-2], x.shape[-1]
    B = B_l if spmd is None else spmd.n_rows
    frac = B_l / B   # this rank's share of the rows (1 off a mesh)
    eps = cfg.eps
    bg = None if spmd is None else spmd.batch_group
    ag = None if spmd is None else spmd.arm_group

    nan_a = torch.full((outs.c.shape[0],), torch.nan, device=x.device,
                       dtype=torch.float32)
    if fused_recon_args is not None and cfg.mode == "ZINB":
        # the head names are the reference's: fc11 is the rate head,
        # fc11_p the success probability, fc11_r the zero inflation
        from dvae_tpu_torch.ops.zinb import fused_zinb
        fparams, x_target = fused_recon_args
        if spmd is not None:
            from dvae_tpu_torch.ops.partitioned import make_partitioned_zinb
            fused_zinb = make_partitioned_zinb(spmd.arm_axes, spmd.batch_axes,
                                               spmd.mesh)
        sums = fused_zinb(outs.x_rec,
                          fparams["fc11"]["w"], fparams["fc11"]["b"],
                          fparams["fc11_p"]["w"], fparams["fc11_p"]["b"],
                          fparams["fc11_r"]["w"], fparams["fc11_r"]["b"],
                          x_target)
        loss_rec = sums / (B * D)
        ll = nan_a   # no materialised x_rec: read rec_nll instead
    elif fused_recon_args is not None:
        fparams, x_target = fused_recon_args
        if fused_trunk:
            from dvae_tpu_torch.ops.decoder import fused_decoder_mse
            flat = [fparams[name][leaf]
                    for name in ("fc6", "fc7", "fc8", "fc9", "fc10", "fc11")
                    for leaf in ("w", "b")]
            sumsq, mism = fused_decoder_mse(outs.x_rec, *flat, x_target,
                                            0.1, cfg.recon_bce_metric)
        else:
            from dvae_tpu_torch.ops.recon import fused_recon_mse
            recon_op = lambda h, w, b, xt: fused_recon_mse(  # noqa: E731
                h, w, b, xt, 0.1, cfg.recon_bce_metric)
            if spmd is not None:
                from dvae_tpu_torch.ops.partitioned import (
                    make_partitioned_recon)
                recon_op = make_partitioned_recon(
                    spmd.arm_axes, spmd.batch_axes, spmd.mesh, 0.1,
                    cfg.recon_bce_metric)
            sumsq, mism = recon_op(outs.x_rec, fparams["fc11"]["w"],
                                   fparams["fc11"]["b"], x_target)
        loss_rec = 0.5 * sumsq / B
        if cfg.recon_bce_metric:
            # BCE on hard-binarized inputs ≡ 100 · mismatch fraction; a
            # metric without gradient
            loss_rec = loss_rec + (50.0 * mism / (B * D)).detach()
        ll = sumsq / (B * D) + B * math.log(2 * math.pi)
    else:
        if cfg.mode == "ZINB":
            loss_rec = zinb_loss(outs.x_rec, outs.p_x, outs.r_x, x,
                                 dim=(1, 2))
        elif cfg.recon_bce_metric:
            loss_rec = recon_loss_mse(outs.x_rec, x)
        else:
            loss_rec = 0.5 * ((outs.x_rec - x) ** 2).sum(dim=(1, 2)) / B_l
        ll = ((outs.x_rec - x) ** 2).mean(dim=(1, 2))

    if cfg.variational:
        # f32: bf16 cancellation in the mean/var reductions corrupts KL
        kl = kl_gaussian(outs.s_mean.float(), outs.s_logvar.float())
    else:
        kl = torch.zeros_like(nan_a)
    if spmd is not None:
        # the per-arm means over this rank's rows → over the whole batch
        # (one all-reduce), then this rank's arms → every arm (one gather)
        rowed = fused_recon_args is None
        parts = [loss_rec, ll] if rowed else []
        if cfg.variational:
            parts.append(kl)
        if parts:
            parts = sum_for_replicated(torch.stack([
                p.float() * frac for p in parts]), bg).unbind(0)
            if rowed:
                loss_rec, ll, *parts = parts
            if cfg.variational:
                kl = parts[-1]
    if fused_recon_args is None:
        ll = ll + B * math.log(2 * math.pi)
    rec_nll = loss_rec if cfg.mode == "ZINB" else nan_a
    if spmd is not None:
        loss_rec, kl, ll, rec_nll = gather_for_replicated(
            torch.stack([loss_rec.float(), kl.float(), ll.float(),
                         rec_nll.float()], dim=1), ag, 0).unbind(dim=1)

    loss_ind_sum = (loss_rec + cfg.beta * kl).sum()

    # coupling terms, always f32 (dvae_tpu/models/losses.py:388-391), on
    # the posteriors of every arm and row
    c, c_smp = outs.c.float(), outs.c_smp
    if spmd is not None:
        c, c_smp = _gather_all(torch.stack([c, c_smp.float()]),
                               spmd).unbind(0)
    if spmd is not None and prior_c is not None:
        prior_c = all_gather(prior_c, bg, 0)
    logc = torch.log(c + eps)
    negent = neg_entropy(c, logc)                         # (A,)
    n_pairs = A * (A - 1) // 2
    if n_pairs > 0:
        if cfg.use_pallas:
            from dvae_tpu_torch.ops.coupling import coupling_distance_fused
            sum_c_dists = coupling_distance_fused(c, eps)
        else:
            sum_c_dists = coupling_distance(c, eps)
        sum_c_l2 = _pair_sums_from_gram(c_smp)
        sum_c_ents = (A - 1) * negent.sum()
    else:
        sum_c_dists = sum_c_l2 = sum_c_ents = x.new_zeros(())

    n_dist_terms = n_ent_terms = n_l2_terms = n_pairs
    if cfg.ref_prior and prior_c is not None:
        c_bin = hard_one_hot_st(c)
        prior_bce = bce(c_bin, prior_c.float().expand_as(c_bin), dim=(1, 2))
        prior_l2 = ((c_smp - prior_c) ** 2).sum(dim=-1).mean(dim=-1)
        sum_c_ents = sum_c_ents + negent.sum()
        sum_c_l2 = sum_c_l2 + prior_l2.sum()
        sum_c_dists = sum_c_dists + cfg.lam_pc * prior_bce.sum()
        n_dist_terms += A
        n_ent_terms += A
        n_l2_terms += A
        n_comb = max(A * (A + 1) // 2, 1)
        scaler = A
    else:
        n_comb = max(n_pairs, 1)
        scaler = max(A - 1, 1)

    const = n_comb * ((C / 2) * math.log(2 * math.pi)
                      - 0.5 * math.log(2 * cfg.lam))
    loss_joint = cfg.lam * sum_c_dists + sum_c_ents + const
    total = scaler * loss_ind_sum + loss_joint
    return LossOutputs(
        total=total,
        loss_rec=loss_rec,
        loss_joint=loss_joint,
        neg_entropy=sum_c_ents / max(n_ent_terms, 1),
        c_dist=sum_c_dists / max(n_dist_terms, 1),
        c_l2_dist=sum_c_l2 / max(n_l2_terms, 1),
        kl=kl,
        ll=ll,
        rec_nll=rec_nll,
    )
