"""Adversarial training of the VAE-GAN augmenter.

Counterpart of dvae_tpu/augment/train.py (reference ``train_augmenter``,
mmidas/augmentation/train.py:10-157):

  * **Gated discriminator updates**: D steps only when its real or its
    fake loss exceeds log(2)/2 (train.py:53-57, :83-91), and only the terms
    above that threshold enter its gradient.  The gate stays on the device:
    ``GatedAdam`` keeps its step count as a device tensor, computes the bias
    corrections there in f32 as optax does, and selects parameters, both
    moments and the count with ``torch.where``, so a closed gate keeps all
    of them and a step reads nothing back.  D's batch-norm statistics move
    whatever the gate says.
  * Augmenter loss λ0·gen + λ1·triplet + λ2·‖z1 − z2‖² + λ3·recon with
    λ = [1, .5, .1, .5] (train.py:111-114).  The augmented samples are
    binarized by a hard threshold (MSE mode, 1e-3) or Bernoulli-sampled
    (ZINB mode), so the gen, triplet and z terms carry no gradient into the
    augmenter: only the reconstruction MSE does, as in the reference, with
    no straight-through estimator.
  * **One pair of fakes for both updates**: the augmenter's two forwards
    (``fake1`` with noise, ``fake2`` without) run once.  The D step takes
    their binarized values, detached; the A step keeps ``fake2``'s graph
    (``fake1`` reaches the loss only through its binarized values, so it
    runs without one).  The JAX package calls its A loss twice with one key
    and leaves the merge to XLA (dvae_tpu/augment/train.py:164-176).
  * ``bf16``: parameters and network inputs are cast to bf16 for compute;
    every loss is taken on f32 views; master weights, Adam moments,
    batch-norm statistics and the gate stay f32.  A state, data and noise
    in f64 make an f64 step throughout (the losses too), the reference the
    f32 step is held against.

Every product is a plain matrix product that the JAX package leaves to
XLA outside any kernel (its GAN imports nothing of ``ops/``): they stay
``torch.matmul``.  A step's random numbers come from
``GanState.generator`` (on the model's device) or, explicitly, from a
``GanNoise`` bundle, so a test can hand both packages the same numbers.

``train_augmenter`` runs ``epochs_per_jit`` epochs as one chunk (each
epoch a permutation drawn on the device and ``n // batch_size`` steps);
the chunk's metrics stay on the device and are read back once, at its end.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple, Optional

import torch

from dvae_tpu_torch.augment.augmenter import (AugmenterConfig, AugNoise,
                                              DiscriminatorConfig,
                                              apply_augmenter,
                                              apply_discriminator,
                                              cast_augmenter_params,
                                              init_augmenter,
                                              init_discriminator,
                                              save_augmenter)
from dvae_tpu_torch.models.losses import bce
from dvae_tpu_torch.models.sampling import _draw
from dvae_tpu_torch.train.step import adam_direction, tree_leaves

_LOG2_HALF = math.log(2.0) / 2.0
DATA_BIN_EPS = 1e-4
FAKE_BIN_EPS = 1e-3


class GatedAdamState(NamedTuple):
    """optax ``ScaleByAdamState`` with the count on the device: ``count``
    a () int32 tensor, ``mu``/``nu`` one tensor per entry of
    ``tree_leaves(params)``."""

    count: torch.Tensor
    mu: list
    nu: list


class GatedAdam:
    """optax.adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root,
    eps_root 0) whose step can be gated by a device boolean without a host
    read: the bias corrections 1 − b^t are computed on the device in f32
    from the device count.  ``update`` changes the parameters, the moments
    and the count in place; under a false ``gate`` all of them keep their
    values bit for bit.  The trainer's ``train/step.Adam`` keeps its count
    on the host, where its checkpoints and eval cache read it; the GAN
    never reads its count on the host."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params) -> GatedAdamState:
        ps = tree_leaves(params)
        return GatedAdamState(
            torch.zeros((), dtype=torch.int32, device=ps[0].device),
            [torch.zeros_like(p) for p in ps],
            [torch.zeros_like(p) for p in ps])

    def update(self, grads: list, state: GatedAdamState, params,
               gate: Optional[torch.Tensor] = None) -> GatedAdamState:
        p = tree_leaves(params)
        count = state.count + 1
        t = count.to(torch.float32)
        bc1, bc2 = 1.0 - torch.pow(self.b1, t), 1.0 - torch.pow(self.b2, t)
        if gate is None:
            mu, nu = state.mu, state.nu
        else:
            mu = [m.clone() for m in state.mu]
            nu = [v.clone() for v in state.nu]
        upd = adam_direction(grads, mu, nu, self.b1, self.b2, bc1, bc2,
                             self.eps)
        if gate is None:
            torch._foreach_add_(p, upd, alpha=-self.lr)
            state.count.copy_(count)
            return state
        new_p = list(torch._foreach_add(p, upd, alpha=-self.lr))
        for dst, src in zip(p + state.mu + state.nu, new_p + mu + nu):
            dst.copy_(torch.where(gate, src, dst))
        state.count.copy_(torch.where(gate, count, state.count))
        return state


class GanState(NamedTuple):
    a_params: dict
    a_bn: dict
    d_params: dict
    d_bn: dict
    a_opt: GatedAdamState
    d_opt: GatedAdamState
    generator: torch.Generator   # the noise of every step, on the device


class GanMetrics(NamedTuple):
    """Per-step scalars, f32 on the device."""

    a_loss: torch.Tensor
    d_loss: torch.Tensor
    gen_loss: torch.Tensor
    recon_loss: torch.Tensor    # (MSE + binarized BCE)/2, the reference's
    mse_recon: torch.Tensor     # the differentiable MSE part alone
    triplet_loss: torch.Tensor
    d_skipped: torch.Tensor     # 1.0 when the D step was gated off (n_adv)


class GanNoise(NamedTuple):
    """Explicit random numbers of one GAN step; a field left None is drawn
    from the state's generator.  ``fake1``/``fake2``: the draws of the
    augmenter's forward with noise and without (smartseq scales
    ``fake2.z`` by 0); ``d_masks``: the (B, D) dropout keep-masks of the D
    step's three discriminator calls (real, fake1, fake2); ``a_masks``: the
    two of the A step's; ``u1``, ``u2``: (B, D) uniforms of the ZINB
    Bernoulli draws (x_bin = u < p)."""

    fake1: AugNoise = AugNoise()
    fake2: AugNoise = AugNoise()
    d_masks: tuple = (None, None, None)
    a_masks: tuple = (None, None)
    u1: Optional[torch.Tensor] = None
    u2: Optional[torch.Tensor] = None


def _wide(t):
    """The loss view of an activation: f32 from bf16 or f32, f64 kept."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _binarize(x, thr):
    return (x > thr).to(x.dtype)


def _triplet(anchor, positive, negative, margin: float):
    """BCE-distance triplet loss (mmidas/augmentation/aug_utils.py:30-48)."""
    return torch.relu(bce(positive, anchor) - bce(negative, anchor) + margin)


def _live(params):
    """Detached aliases of the parameters that record a graph."""
    return {n: {k: None if v is None else v.detach().requires_grad_()
                for k, v in layer.items()} for n, layer in params.items()}


def _detached(tree):
    return {n: {k: v.detach() for k, v in d.items()} for n, d in tree.items()}


def make_gan_step(a_cfg: AugmenterConfig, d_cfg: DiscriminatorConfig,
                  a_tx: GatedAdam, d_tx: GatedAdam,
                  lambdas=(1.0, 0.5, 0.1, 0.5), alpha: float = 0.2,
                  mode: str = "MSE", bf16: bool = False):
    """step(state, data (B, D) f32, noise=GanNoise()) → (state, GanMetrics):
    the gated D step, then the A step against the selected D parameters
    and D's new batch-norm statistics (dvae_tpu/augment/train.py:74-208).
    Parameters, moments and counts are updated in place."""
    cdt = torch.bfloat16 if bf16 else None
    zinb = mode == "ZINB" and a_cfg.n_zim > 1
    D = a_cfg.input_dim

    def _cx(x):
        return x if cdt is None else x.to(cdt)

    def disc(params, bn, x, gen, mask):
        return apply_discriminator(params, bn, d_cfg, _cx(x), gen, True, mask)

    def bce_to(p, value: float):
        p = _wide(p).reshape(-1)
        return bce(p, torch.full_like(p, value))

    def step(state: GanState, data: torch.Tensor,
             noise: GanNoise = GanNoise()):
        gen = state.generator
        data_bin = _binarize(data, DATA_BIN_EPS)

        # the augmenter's two forwards; fake2 keeps its graph for the A step
        a_live = _live(state.a_params)
        with torch.enable_grad():
            a_c = cast_augmenter_params(a_live, cdt)
            with torch.no_grad():
                _, fake1, bn_a1 = apply_augmenter(
                    a_c, state.a_bn, a_cfg, _cx(data), gen, train=True,
                    noise=True, draws=noise.fake1)
            _, fake2, bn_a2 = apply_augmenter(
                a_c, bn_a1, a_cfg, _cx(data), gen, train=True, noise=False,
                draws=noise.fake2)
            if zinb:
                p1 = data_bin * _wide(fake1[..., D:])
                p2 = data_bin * _wide(fake2.detach()[..., D:])
                u1, u2 = (u if u is not None else
                          _draw("uniform", p1.shape, p1, gen)
                          for u in (noise.u1, noise.u2))
                f1_bin = (u1 < p1).to(data.dtype)
                f2_bin = (u2 < p2).to(data.dtype)
                fake_rec = _wide(fake2[..., :D]) * data_bin
            else:
                # the threshold compare sees the unrounded loss view
                f1_bin = _binarize(_wide(fake1), FAKE_BIN_EPS)
                f2_bin = _binarize(_wide(fake2.detach()), FAKE_BIN_EPS)
                fake_rec = _wide(fake2)
            mse_rec = ((fake_rec - data) ** 2).mean()

        # the discriminator step, gated on the device
        d_live = _live(state.d_params)
        m = noise.d_masks
        with torch.enable_grad():
            dp = cast_augmenter_params(d_live, cdt)
            _, p_real, bn1 = disc(dp, state.d_bn, data_bin, gen, m[0])
            loss_real = bce_to(p_real, 1.0)
            _, p_f1, bn2 = disc(dp, bn1, f1_bin, gen, m[1])
            _, p_f2, bn3 = disc(dp, bn2, f2_bin, gen, m[2])
            loss_fake = (bce_to(p_f1, 0.0) + bce_to(p_f2, 0.0)) / 2
            g_real = (loss_real > _LOG2_HALF).float().detach()
            g_fake = (loss_fake > _LOG2_HALF).float().detach()
            gated = g_real * loss_real + g_fake * loss_fake
            d_grads = torch.autograd.grad(gated, tree_leaves(d_live))
        gate = (g_real + g_fake) > 0
        with torch.no_grad():
            d_tx.update(list(d_grads), state.d_opt, state.d_params, gate)
        d_bn = _detached(bn3)

        # the augmenter step: D with the selected parameters, its new
        # statistics; only the reconstruction MSE carries a gradient
        m = noise.a_masks
        with torch.no_grad():
            dp = cast_augmenter_params(state.d_params, cdt)
            z1, q1, _ = disc(dp, d_bn, f1_bin, gen, m[0])
            z2, q2, _ = disc(dp, d_bn, f2_bin, gen, m[1])
            gen_loss = (bce_to(q1, 1.0) + bce_to(q2, 1.0)) / 2
            trip = _triplet(data_bin, f2_bin, f1_bin, alpha)
            z_mse = ((_wide(z1) - _wide(z2)) ** 2).mean()
            bce_rec = bce(f2_bin, data_bin)
        with torch.enable_grad():
            recon = (mse_rec + bce_rec) / 2
            total = (lambdas[0] * gen_loss + lambdas[1] * trip
                     + lambdas[2] * z_mse + lambdas[3] * recon)
            a_leaves = tree_leaves(a_live)
            a_grads = torch.autograd.grad(total, a_leaves, allow_unused=True)
        with torch.no_grad():
            a_tx.update([torch.zeros_like(p) if g is None else g
                         for g, p in zip(a_grads, a_leaves)],
                        state.a_opt, state.a_params)
        metrics = GanMetrics(
            total.detach(), (loss_real + loss_fake).detach(), gen_loss,
            recon.detach(), mse_rec.detach(), trip, 1.0 - gate.float())
        return state._replace(a_bn=_detached(bn_a2), d_bn=d_bn), metrics

    return step


def init_gan_state(seed: int, a_cfg: AugmenterConfig,
                   d_cfg: DiscriminatorConfig, a_tx: GatedAdam,
                   d_tx: GatedAdam, device="cuda") -> GanState:
    """Fresh augmenter and discriminator (drawn on the CPU from ``seed``,
    then moved), zero Adam states, and the run's generator on ``device``
    seeded with ``seed``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    a_params, a_bn = init_augmenter(g, a_cfg, device)
    d_params, d_bn = init_discriminator(g, d_cfg, device)
    run = torch.Generator(device=device).manual_seed(seed)
    return GanState(a_params, a_bn, d_params, d_bn, a_tx.init(a_params),
                    d_tx.init(d_params), run)


def cast_gan_state(state: GanState, dtype) -> GanState:
    """A copy of ``state`` with its weights, batch-norm statistics and Adam
    moments in ``dtype`` (the count copied, the generator shared): f64
    makes the reference step an f32 or bf16 one is held against."""
    def cast(tree):
        return {n: {k: None if v is None else v.to(dtype, copy=True)
                    for k, v in layer.items()} for n, layer in tree.items()}

    def opt(o):
        return o._replace(count=o.count.clone(),
                          mu=[m.to(dtype, copy=True) for m in o.mu],
                          nu=[v.to(dtype, copy=True) for v in o.nu])
    return state._replace(a_params=cast(state.a_params),
                          a_bn=cast(state.a_bn),
                          d_params=cast(state.d_params),
                          d_bn=cast(state.d_bn), a_opt=opt(state.a_opt),
                          d_opt=opt(state.d_opt))


def make_gan_runner(step_fn, n: int, batch_size: int):
    """run(state, x_all (n, D), n_epochs) → (state, metrics (n_epochs, 7)
    on the device): per epoch a permutation drawn from the state's
    generator, ``n // batch_size`` steps on its batches (the remainder
    dropped), the mean of each ``GanMetrics`` field.  Nothing is read back
    to the host."""
    steps = max(n // batch_size, 1)

    def run(state: GanState, x_all: torch.Tensor, n_epochs: int):
        rows = []
        for _ in range(n_epochs):
            perm = torch.randperm(n, generator=state.generator,
                                  device=x_all.device)
            plan = perm[: steps * batch_size].reshape(steps, batch_size)
            ms = []
            for s in range(steps):
                state, m = step_fn(state, x_all.index_select(0, plan[s]))
                ms.append(torch.stack(m))
            rows.append(torch.stack(ms).mean(dim=0))
        return state, torch.stack(rows)

    return run


def train_augmenter(x_train, a_cfg: Optional[AugmenterConfig] = None,
                    n_epochs: int = 50, batch_size: int = 1000,
                    lr: float = 1e-3, lambdas=(1.0, 0.5, 0.1, 0.5),
                    alpha: float = 0.2, mode: str = "MSE", seed: int = 0,
                    saving_path: Optional[str] = None, verbose: bool = True,
                    bf16: bool = False, epochs_per_jit: int = 1,
                    device="cuda"):
    """Full GAN training (reference ``train_augmenter``,
    augmentation/train.py; dvae_tpu/augment/train.py:211-307).  Returns
    (params, bn, cfg, history), the history one dict of ``GanMetrics``
    floats an epoch.

    ``x_train`` (n, D): numpy or a tensor (used in place on ``device``).
    ZINB mode forces the dropout head (``n_zim=2``).  ``epochs_per_jit``
    epochs make one chunk, whose metrics are read back once; the last chunk
    is shorter when it does not divide ``n_epochs``.  ``bf16``: bf16
    products, f32 losses and master weights."""
    from dvae_tpu_torch.train.cpl_mixvae import _resolve_device
    dev = _resolve_device(device)
    D = x_train.shape[1]
    a_cfg = a_cfg or AugmenterConfig(input_dim=D)
    if mode == "ZINB" and a_cfg.n_zim <= 1:
        # ZINB training needs the fc11_p dropout head (reference
        # networks.py mode='ZINB'); an MSE model under a 'ZINB' label would
        # be a trap
        a_cfg = AugmenterConfig(**{**a_cfg.__dict__, "n_zim": 2})
    d_cfg = DiscriminatorConfig(input_dim=D)
    a_tx, d_tx = GatedAdam(lr), GatedAdam(lr)
    state = init_gan_state(seed, a_cfg, d_cfg, a_tx, d_tx, dev)
    x_all = torch.as_tensor(x_train).to(device=dev, dtype=torch.float32)
    n = x_all.shape[0]
    batch_size = min(batch_size, n)   # small dataset: one batch of n rows
    run = make_gan_runner(
        make_gan_step(a_cfg, d_cfg, a_tx, d_tx, lambdas, alpha, mode, bf16),
        n, batch_size)

    E = max(int(epochs_per_jit), 1)
    history = []
    e0 = 0
    while e0 < n_epochs:
        k = min(E, n_epochs - e0)
        t0 = time.perf_counter()
        state, ms = run(state, x_all, k)
        ms = ms.cpu().numpy()   # the chunk's one host read
        dt = (time.perf_counter() - t0) / k
        for i in range(k):
            m = GanMetrics(*(float(v) for v in ms[i]))
            history.append(m._asdict())
            if verbose:
                print(f"=====> Epoch:{e0 + i}, Generator Loss: "
                      f"{m.a_loss:.4f}, Discriminator Loss: "
                      f"{m.d_loss:.4f}, Recon Loss: {m.recon_loss:.4f}, "
                      f"Trip Loss: {m.triplet_loss:.4f}, "
                      f"Elapsed Time:{dt:.2f}")
        e0 += k

    if saving_path:
        save_augmenter(saving_path, state.a_params, state.a_bn, a_cfg,
                       extra={"history_tail": history[-5:]})
    return state.a_params, state.a_bn, a_cfg, history
