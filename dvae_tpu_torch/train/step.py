"""Train step, epoch runner, eval step and eval runner of the PyTorch port.

Counterpart of dvae_tpu/train/step.py.  PyTorch runs eagerly, so where the
JAX package scans steps and batches inside one device program, the port
runs a Python loop that only enqueues work: inside a chunk of epochs
nothing is read back to the host (the permutation, the batches, the
labels and the consensus stay on the device), and the host wakes once per
chunk, when the caller reads the ``EpochMetrics``.

Randomness.  A chunk's noise comes from a ``torch.Generator`` on the data's
device, seeded from (``TrainState.seed``, ``TrainState.epoch``), so a run
resumed from a checkpoint continues the noise chain instead of replaying
it.  The seeds of the in-kernel draws (the fused encoder kernel's mask
and, under ``use_pallas``, the fused Gumbel kernel's uniforms) come from a
host numpy generator seeded the same way, so drawing them needs no
synchronisation.

The optimizer is Adam with optax's semantics (``Adam``), updating the
parameters and its moments in place: the port keeps one copy of the
training state where JAX returns a new one.

Eval: every batch is evaluated from the same state, as in the JAX package
(its scan carries no state): the reparameterization noise of variational
mode comes from a fresh CPU ``torch.Generator`` seeded with
``TrainState.seed`` for each batch, so a run's numbers do not depend on
how the batches were chunked, nor on the device.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from dvae_tpu_torch.config import TrainConfig, VAEConfig
from dvae_tpu_torch.eval.metrics import consensus_device
from dvae_tpu_torch.models import mixvae
from dvae_tpu_torch.models.losses import LossOutputs, mixvae_loss


# (x (B, D), n_arm, generator, draws) → (A, B, D) per-arm views: the frozen
# augmenter as the trainer closes over it (``CplMixVAE._augment_fn``)
AugmentFn = Callable[..., torch.Tensor]


class TrainState(NamedTuple):
    """The training state.  ``seed`` and ``epoch`` are host integers."""

    params: Any            # stacked-arm dict of tensors
    bn: Any                # batch-norm running stats
    mask: torch.Tensor     # (C,) category keep-mask (all-ones = unpruned)
    seed: int              # seeds the noise of every chunk and of eval
    epoch: int
    opt_state: Any = None  # AdamState


class StepMetrics(NamedTuple):
    """Per-step scalars (dvae_tpu/train/step.py:50-61), f32 on the device."""

    total: torch.Tensor
    loss_rec: torch.Tensor     # (A,)
    loss_joint: torch.Tensor
    neg_entropy: torch.Tensor
    c_dist: torch.Tensor
    c_l2_dist: torch.Tensor
    kl: torch.Tensor           # (A,)


class EpochMetrics(NamedTuple):
    """Per-epoch aggregates of one chunk, stacked (E, ...) on the device."""

    total: torch.Tensor        # (E,)
    loss_rec: torch.Tensor     # (E, A)
    loss_joint: torch.Tensor   # (E,)
    neg_entropy: torch.Tensor  # (E,)
    c_dist: torch.Tensor       # (E,)
    c_l2_dist: torch.Tensor    # (E,)
    kl: torch.Tensor           # (E, A)
    consensus: torch.Tensor    # (E,) train consensus (-1 where not computed)


class EvalFields(NamedTuple):
    """Eval outputs stacked arm-major, (A, N, ·)."""

    c: torch.Tensor         # (A, N, C)
    s_mean: torch.Tensor    # (A, N, S)
    s_logvar: torch.Tensor  # (A, N, S)
    x_low: torch.Tensor     # (A, N, L)
    lab: torch.Tensor       # (A, N)


# ---------------------------------------------------------------------------
# Parameter trees (dict of dicts, leaves in sorted key order as in JAX)
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> list:
    """The tensors of a parameter tree in JAX's leaf order; a bias-free
    layer's None (the augmenter's ``noise`` layer) is no leaf."""
    return [tree[n][k] for n in sorted(tree) for k in sorted(tree[n])
            if tree[n][k] is not None]


def tree_like(tree, leaves) -> dict:
    it = iter(leaves)
    return {n: {k: next(it) for k in sorted(tree[n])} for n in sorted(tree)}


def _cast_params(params, dtype):
    return {name: {k: v.to(dtype) for k, v in layer.items()}
            for name, layer in params.items()}


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def adam_direction(grads: list, mu: list, nu: list, b1: float, b2: float,
                   bc1, bc2, eps: float, eps_root: float = 0.0) -> list:
    """optax's ``scale_by_adam`` on lists of leaves: moves the moments in
    place and returns m̂ / (sqrt(v̂ + eps_root) + eps).  ``bc1``, ``bc2``
    are the bias corrections 1 − b^t, floats or device scalars."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(grads, grads), alpha=1.0 - b2)
    upd = list(torch._foreach_div(mu, bc1))
    den = torch._foreach_div(nu, bc2)
    if eps_root:
        torch._foreach_add_(den, eps_root)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(upd, den)
    return upd


class AdamState(NamedTuple):
    """optax ``ScaleByAdamState``: the step count (a host integer here) and
    the two moment trees."""

    count: int
    mu: dict
    nu: dict


class Adam:
    """Adam with optax's semantics (optax.adam; optax.adamw with
    ``weight_decay``): b1 0.9, b2 0.999, eps 1e-8 outside the square root,
    eps_root 0, bias corrections 1 − b^t computed in f32, decoupled weight
    decay added before the learning-rate scale.  ``update`` changes the
    parameters and the moments in place."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0,
                 weight_decay: float = 0.0):
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.eps_root, self.weight_decay = eps, eps_root, weight_decay

    def init(self, params) -> AdamState:
        zeros = lambda: tree_like(params, [torch.zeros_like(p)  # noqa: E731
                                           for p in tree_leaves(params)])
        return AdamState(0, zeros(), zeros())

    def update(self, grads, state: AdamState, params) -> AdamState:
        p, g = tree_leaves(params), tree_leaves(grads)
        mu, nu = tree_leaves(state.mu), tree_leaves(state.nu)
        count = state.count + 1
        bc1, bc2 = (float(np.float32(1) - np.float32(b) ** np.float32(count))
                    for b in (self.b1, self.b2))
        upd = adam_direction(g, mu, nu, self.b1, self.b2, bc1, bc2, self.eps,
                             self.eps_root)
        if self.weight_decay:
            torch._foreach_add_(upd, p, alpha=self.weight_decay)
        torch._foreach_add_(p, upd, alpha=-self.lr)
        return AdamState(count, state.mu, state.nu)


def make_optimizer(cfg: VAEConfig, name: str = "adam") -> Adam:
    """adam/adamw with the reference defaults (lr = cfg.lr); adamw takes
    optax's default weight decay of 1e-4 (not torch's 1e-2)."""
    if name == "adamw":
        return Adam(cfg.lr, weight_decay=1e-4)
    if name == "adam":
        return Adam(cfg.lr)
    raise ValueError(f"unknown optimizer {name!r}")


def init_train_state(seed: int, cfg: VAEConfig, opt: Adam, device="cpu",
                     dtype=torch.float32) -> TrainState:
    """Fresh parameters (drawn on the CPU from ``seed``, then moved), unit
    running variances, an all-ones mask and a zero Adam state."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    params = mixvae.init_params(gen, cfg, device=device, dtype=dtype)
    return TrainState(params=params,
                      bn=mixvae.init_bn_state(cfg, device, dtype),
                      mask=torch.ones(cfg.n_categories, device=device,
                                      dtype=dtype),
                      seed=seed, epoch=0, opt_state=opt.init(params))


# ---------------------------------------------------------------------------
# Pruning masks
# ---------------------------------------------------------------------------

def _mask_params(params, mask, cfg: VAEConfig, inplace: bool = False):
    """Multiplicative category masks (dvae_tpu/train/step.py:248-271): fcc's
    output columns, the C input rows of fc_mu/fc_sigma and of fc6.  With
    ``inplace`` the tensors of ``params`` are scaled where they are."""
    L, S = cfg.lowD_dim, cfg.state_dim
    ones = lambda n: torch.ones(n, device=mask.device, dtype=mask.dtype)  # noqa: E731
    row_mu = torch.cat([ones(L), mask])
    row_dec = torch.cat([mask, ones(S)])
    scale = {("fcc", "w"): mask[None, None, :], ("fcc", "b"): mask[None, :],
             ("fc_mu", "w"): row_mu[None, :, None],
             ("fc_sigma", "w"): row_mu[None, :, None],
             ("fc6", "w"): row_dec[None, :, None]}
    if inplace:
        for (name, leaf), s in scale.items():
            params[name][leaf].mul_(s.to(params[name][leaf].dtype))
        return params
    out = {name: dict(layer) for name, layer in params.items()}
    for (name, leaf), s in scale.items():
        out[name][leaf] = params[name][leaf] * s
    return out


def _mask_grads(grads, mask, cfg: VAEConfig):
    """Zero the gradients of pruned category units."""
    return _mask_params(grads, mask, cfg)


# ---------------------------------------------------------------------------
# Loss and train step
# ---------------------------------------------------------------------------

def _apply_with_loss(params, bn, cfg: VAEConfig, x, generator, temp, mask,
                     prior_c, train: bool = False, noise=None,
                     enc_seed: Optional[int] = None):
    """Forward + loss with the fused-recon wiring in one place
    (dvae_tpu/train/step.py:135-159); train and eval share it.  Under
    ``cfg.fused_decoder`` (MSE mode only; ZINB ignores the flag) the model
    stops before the decoder trunk and the whole-decoder kernel takes it
    from there.  Returns (outs, new_bn, aux)."""
    fused = cfg.fused_recon
    fused_trunk = fused and cfg.fused_decoder and cfg.mode != "ZINB"
    outs, new_bn = mixvae.apply(params, bn, cfg, x, temp=temp, train=train,
                                mask=mask, prior_c=prior_c, skip_recon=fused,
                                skip_trunk=fused_trunk, noise=noise,
                                generator=generator, enc_seed=enc_seed)
    aux = mixvae_loss(cfg, outs, x, prior_c,
                      fused_recon_args=(params, x) if fused else None,
                      fused_trunk=fused_trunk)
    return outs, new_bn, aux


def loss_fn(params, bn, cfg: VAEConfig, x, temp, mask, prior_c,
            compute_dtype=None, noise=None, generator=None,
            enc_seed: Optional[int] = None):
    """Train-mode loss; returns (total f32, (aux, new_bn, labels (A, B))).
    ``x`` is (B, D), shared by the arms, or (A, B, D)."""
    if compute_dtype is not None and compute_dtype != torch.float32:
        params = _cast_params(params, compute_dtype)
        x = x.to(compute_dtype)
    outs, new_bn, aux = _apply_with_loss(params, bn, cfg, x, generator, temp,
                                         mask, prior_c, train=True,
                                         noise=noise, enc_seed=enc_seed)
    labels = torch.argmax(outs.c, dim=-1)
    return aux.total.float(), (aux, new_bn, labels)


def make_train_step(cfg: VAEConfig, tcfg: TrainConfig, opt: Adam,
                    augment: Optional[AugmentFn] = None):
    """step(state, x (B, D), prior_c (B, C) | None, temp, generator=None,
    enc_seed=None, noise=None, aug_draws=None) → (state, StepMetrics,
    labels (A, B)).

    Value and gradients of ``loss_fn``, pruned-category gradients zeroed,
    Adam, pruned parameters zeroed again (dvae_tpu/train/step.py:201-245).
    The parameters and the Adam moments are updated in place.  Without an
    augmenter every arm shares the (B, D) batch, and that is what the model
    and the kernels get; with one, its (A, B, D) per-arm views, made on the
    batch's device from ``generator`` (or the explicit ``aug_draws``)."""
    compute_dtype = torch.bfloat16 if tcfg.bf16 else torch.float32

    def step(state: TrainState, x, prior_c, temp, generator=None,
             enc_seed: Optional[int] = None, noise=None, aug_draws=None):
        if augment is not None:
            x = augment(x, cfg.n_arm, generator, aug_draws)
        live = {n: {k: v.detach().requires_grad_() for k, v in layer.items()}
                for n, layer in state.params.items()}
        leaves = tree_leaves(live)
        with torch.enable_grad():
            total, (aux, new_bn, labels) = loss_fn(
                live, state.bn, cfg, x, temp, state.mask, prior_c,
                compute_dtype, noise, generator, enc_seed)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = tree_like(state.params, [
            torch.zeros_like(p) if gr is None else gr.to(p.dtype)
            for gr, p in zip(grads, leaves)])
        grads = _mask_grads(grads, state.mask, cfg)
        with torch.no_grad():
            opt_state = opt.update(grads, state.opt_state, state.params)
            _mask_params(state.params, state.mask, cfg, inplace=True)
        metrics = StepMetrics(*(v.detach().float() for v in (
            aux.total, aux.loss_rec, aux.loss_joint, aux.neg_entropy,
            aux.c_dist, aux.c_l2_dist, aux.kl)))
        return (state._replace(bn=new_bn, opt_state=opt_state), metrics,
                labels)

    return step


# ---------------------------------------------------------------------------
# Epoch runner
# ---------------------------------------------------------------------------

def chunk_rngs(seed: int, epoch: int, device):
    """(torch.Generator on ``device``, numpy Generator) of the chunk that
    starts at ``epoch``: the noise chain of a run continues across chunks
    and resumes."""
    host = np.random.default_rng([seed, epoch])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(host.integers(0, 2 ** 63 - 1)))
    return gen, host


def epoch_metrics(ms, consensus: torch.Tensor) -> EpochMetrics:
    """One epoch's row of ``EpochMetrics`` from its steps' metrics (the
    means of dvae_tpu/train/step.py:373-382) and its consensus."""
    st = StepMetrics(*(torch.stack(v) for v in zip(*ms)))
    return EpochMetrics(
        total=st.total.mean(), loss_rec=st.loss_rec.mean(dim=0),
        loss_joint=st.loss_joint.mean(), neg_entropy=st.neg_entropy.mean(),
        c_dist=st.c_dist.mean(), c_l2_dist=st.c_l2_dist.mean(),
        kl=st.kl.mean(dim=0), consensus=consensus.float())


def make_epoch_runner(cfg: VAEConfig, tcfg: TrainConfig, opt: Adam,
                      n_train: int, epochs_per_chunk: Optional[int] = None,
                      consensus_every_epoch: bool = True,
                      augment: Optional[AugmentFn] = None):
    """run_epochs(state, x_all (N, D), prior_all (N, C) | None, temp) →
    (state, EpochMetrics), everything on x_all's device.

    Per epoch: a permutation drawn on the device at ``shuffle_block``-row
    granularity, the last partial batch dropped (dvae_tpu/train/step.py
    :297-394); ``steps`` train steps; the argmax labels gathered into an
    (A, n_used) buffer and the all-pairs consensus computed on the
    device.  ``augment`` makes each step's per-arm views inside the chunk,
    on the device, from the chunk's generator."""
    E = epochs_per_chunk or tcfg.epochs_per_jit
    B = tcfg.batch_size
    steps = n_train // B
    if steps == 0:
        raise ValueError(f"batch_size {B} > dataset size {n_train}")
    step_fn = make_train_step(cfg, tcfg, opt, augment)
    n_used = steps * B
    sb = tcfg.shuffle_block
    if sb > 1 and B % sb:
        raise ValueError(f"shuffle_block {sb} must divide batch_size {B}")
    n_blocks = n_train // sb
    A, K = cfg.n_arm, cfg.n_categories

    def run_epochs(state: TrainState, x_all, prior_all, temp):
        dev = x_all.device
        gen, host = chunk_rngs(state.seed, state.epoch, dev)
        x_view = x_all[: n_blocks * sb].reshape(n_blocks, sb, -1)
        prior_view = (None if prior_all is None else
                      prior_all[: n_blocks * sb].reshape(n_blocks, sb, -1))
        per_epoch = []
        for i in range(E):
            perm = torch.randperm(n_blocks, generator=gen, device=dev)
            plan = perm[: n_used // sb].reshape(steps, B // sb)
            labels = torch.empty((A, n_used), dtype=torch.long, device=dev)
            ms = []
            for s in range(steps):
                sel = plan[s]
                x = x_view.index_select(0, sel).reshape(B, -1)
                prior = (None if prior_view is None else
                         prior_view.index_select(0, sel).reshape(B, -1))
                enc_seed = int(host.integers(0, 2 ** 31 - 1))
                noise = (mixvae.Noise(gumbel_seed=int(
                    host.integers(0, 2 ** 31 - 1)))
                    if cfg.use_pallas else None)
                state, m, lab = step_fn(state, x, prior, temp, generator=gen,
                                        enc_seed=enc_seed, noise=noise)
                labels[:, s * B:(s + 1) * B] = lab
                ms.append(m)
            del x, prior  # the last batch need not outlive the epoch
            if consensus_every_epoch or i == E - 1:
                cons = consensus_device(labels, K)
            else:
                cons = torch.full((), -1.0, device=dev)
            per_epoch.append(epoch_metrics(ms, cons))
            state = state._replace(epoch=state.epoch + 1)
        return state, EpochMetrics(*(torch.stack(v)
                                     for v in zip(*per_epoch)))

    return run_epochs


# ---------------------------------------------------------------------------
# Eval
# ---------------------------------------------------------------------------

def make_eval_step(cfg: VAEConfig, tcfg: TrainConfig,
                   augment: Optional[AugmentFn] = None):
    """Validation forward: no grad, eval semantics (hard one-hot, running
    BN statistics), the training compute dtype (bf16 under ``tcfg.bf16``)
    with the f32 islands of the loss.  Metrics leave in f32.  With an
    augmenter eval sees per-arm views too (dvae_tpu/train/step.py:509),
    their noise drawn from the same per-batch generator.

    step(state, x (B, D), prior_c (B, C) | None, temp) →
        (LossOutputs, labels (A, B), MixVAEOutputs)
    """
    compute_dtype = torch.bfloat16 if tcfg.bf16 else torch.float32
    cache = {}

    @torch.no_grad()
    def eval_step(state: TrainState, x, prior_c, temp):
        params = state.params
        if compute_dtype != torch.float32:
            # cast once per state, not once per batch; the training step
            # updates the parameters in place, so the cache also keys on
            # the optimizer step count
            key = (id(params), getattr(state.opt_state, "count", None))
            if cache.get("key") != key:
                cache["key"], cache["cast"] = key, _cast_params(
                    params, compute_dtype)
            params = cache["cast"]
        x = x.to(compute_dtype)
        gen = torch.Generator(device="cpu").manual_seed(state.seed)
        if augment is not None:
            x = augment(x, cfg.n_arm, gen, None)
        outs, _, aux = _apply_with_loss(params, state.bn, cfg, x, gen, temp,
                                        state.mask, prior_c)
        labels = torch.argmax(outs.c, dim=-1)
        aux = LossOutputs(*(v.float() for v in aux))
        return aux, labels, outs

    return eval_step


def make_eval_runner(cfg: VAEConfig, tcfg: TrainConfig,
                     augment: Optional[AugmentFn] = None):
    """run(state, x_chunk (K, B, D), temp, prior_chunk (K, B, C) | None) →
    (LossOutputs stacked (K, ...), EvalFields (A, K·B, ·)).

    Per-batch numerics are those of ``make_eval_step``."""
    ev = make_eval_step(cfg, tcfg, augment)

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
