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

The resident epoch runner and the streamed one (data/stream.py) differ
only in where a batch comes from: both run ``make_chunk_loop``.

On a mesh (``mesh``, a ``parallel.sharding.Mesh`` of several devices; the
model of such a run is in parallel/sharding.py) the state holds this
rank's blocks under ``TrainConfig.sharding``, the step takes the whole
batch and computes on this rank's arms and rows (``_spmd``, after
dvae_tpu/train/step.py:162-198), sums the gradients over the batch group
(the partitioned kernels have summed theirs), and runs ``Adam.update`` on
this rank's blocks of the Adam moments (``update_blocks``).  The epoch
loop gathers each epoch's labels over the batch and arm groups for the
consensus; the eval step gathers its outputs, so every rank returns the
whole arrays.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from dvae_tpu_torch.config import TrainConfig, VAEConfig
from dvae_tpu_torch.eval.metrics import consensus_device
from dvae_tpu_torch.models import mixvae
from dvae_tpu_torch.models.losses import LossOutputs, mixvae_loss
from dvae_tpu_torch.parallel.runtime import (all_gather, flat_all_reduce,
                                             flat_reduce_scatter, record_mark)
from dvae_tpu_torch.parallel.sharding import (BATCH_AXES, Spmd, local_block,
                                              reshard, state_specs)
from dvae_tpu_torch.utils.profiling import span, spanned


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
    """The tensors of a parameter tree (nested dicts, lists and tuples) in
    JAX's leaf order: dict keys sorted, sequences in order.  A bias-free
    layer's None (the augmenter's ``noise`` layer) is no leaf."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for sub in tree for v in tree_leaves(sub)]
    return [] if tree is None else [tree]


def _fill(node, leaves):
    if isinstance(node, dict):
        return {k: _fill(node[k], leaves) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_fill(v, leaves) for v in node)
    return None if node is None else next(leaves)


def tree_like(tree, leaves):
    """``tree``'s structure with ``leaves`` in ``tree_leaves``' order; a None
    stays None.  (A module-level helper, not a recursive closure: a closure
    that calls itself is a reference cycle, which would keep ``leaves``, a
    step's gradients, alive until the garbage collector runs.)"""
    return _fill(tree, iter(leaves))


def value_and_grad(loss_fn, params):
    """(loss, aux, grads) of ``loss_fn(params) -> (loss, aux)`` by autograd;
    ``grads`` is a tree like ``params``, each leaf in its parameter's dtype,
    zeros for a leaf the loss does not use.  ``params`` is not changed.
    The forward and the backward are the spans ``dvae.step.forward`` and
    ``dvae.step.backward`` of a profile."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        with span("step.forward"):
            loss, aux = loss_fn(tree_like(params, live))
        with span("step.backward"):
            grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss, aux, tree_like(params, [
        torch.zeros_like(p) if g is None else g.to(p.dtype)
        for g, p in zip(grads, leaves)])


def optimizer_step(loss_fn, params, opt, opt_state):
    """One update of ``opt`` (the ``Adam`` interface) from ``loss_fn``'s
    gradients, ``params`` changed in place; returns (opt state, loss
    detached, aux)."""
    loss, aux, grads = value_and_grad(loss_fn, params)
    with torch.no_grad():
        opt_state = opt.update(grads, opt_state, params)
    return opt_state, loss.detach(), aux


def leaf_specs(tree, specs) -> list:
    """The spec of each leaf of ``tree`` in ``tree_leaves``' order, from a
    spec tree of its structure whose leaves are spec tuples."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in leaf_specs(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [s for i, sub in enumerate(tree)
                for s in leaf_specs(sub, specs[i])]
    return [] if tree is None else [specs]


def sharded_optimizer_step(loss_fn, params, opt, opt_state, p_specs, o_specs,
                           mesh, group):
    """``optimizer_step`` on a data-parallel mesh (``parallel.sharding
    .DPMesh``): ``params`` are this rank's blocks under ``p_specs``, the
    optimizer's state its blocks under ``o_specs``.  ``loss_fn`` takes the
    whole parameters (gathered over the mesh) and returns the loss of this
    rank's rows; the loss and the gradients are averaged over ``group``
    (None: every rank computed the whole batch, and nothing is summed).
    ``opt.update`` then runs on the moments' blocks: of the gradients and
    of the parameters (views into them), and a parameter whose moments the
    mesh shards more than itself is gathered back whole.  On a mesh of one
    rank it is ``optimizer_step``, operation for operation.  Returns (opt
    state, loss detached, aux)."""
    from dvae_tpu_torch.parallel.sharding import full_leaf
    p = tree_leaves(params)
    ps, ms = leaf_specs(params, p_specs), leaf_specs(params, o_specs)
    whole = tree_like(params, [full_leaf(t, s, mesh) for t, s in zip(p, ps)])
    loss, aux, grads = value_and_grad(loss_fn, whole)
    loss = loss.detach()
    g = tree_leaves(grads)
    del whole, grads
    if group is not None and group.size > 1:
        loss, *g = flat_all_reduce([loss.float().reshape(1), *g], group)
        torch._foreach_mul_([loss, *g], 1.0 / group.size)
        loss = loss[0]
    with torch.no_grad():
        opt_state = update_blocks(
            opt, tree_like(params, [local_block(t, m, mesh)
                                    for t, m in zip(g, ms)]),
            opt_state, params, p_specs, o_specs, mesh)
    return opt_state, loss, aux


def update_blocks(opt, grads, opt_state, params, p_specs, m_specs, mesh):
    """``opt.update`` on this rank's blocks of the moments (spec tree
    ``m_specs``, as ``grads``): ``params`` (``p_specs``) go in as their
    views in the moments' spec, and one that its moments shard more is
    gathered back after the update.  Returns the opt state."""
    p = tree_leaves(params)
    ps, ms = leaf_specs(params, p_specs), leaf_specs(params, m_specs)
    views = [reshard(t, s, m, mesh) for t, s, m in zip(p, ps, ms)]
    opt_state = opt.update(grads, opt_state, tree_like(params, views))
    for t, v, s, m in zip(p, views, ps, ms):
        if v is not t:   # the moments' block of a wider parameter
            t.copy_(reshard(v, m, s, mesh))
    return opt_state


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

def _mask_params(params, mask, cfg: VAEConfig, inplace: bool = False,
                 local=None):
    """Multiplicative category masks (dvae_tpu/train/step.py:248-271): fcc's
    output columns, the C input rows of fc_mu/fc_sigma and of fc6.  With
    ``inplace`` the tensors of ``params`` are scaled where they are.
    ``local(name, leaf, scale)`` cuts a scale to a sharded leaf's block."""
    L, S = cfg.lowD_dim, cfg.state_dim
    ones = lambda n: torch.ones(n, device=mask.device, dtype=mask.dtype)  # noqa: E731
    row_mu = torch.cat([ones(L), mask])
    row_dec = torch.cat([mask, ones(S)])
    scale = {("fcc", "w"): mask[None, None, :], ("fcc", "b"): mask[None, :],
             ("fc_mu", "w"): row_mu[None, :, None],
             ("fc_sigma", "w"): row_mu[None, :, None],
             ("fc6", "w"): row_dec[None, :, None]}
    if local is not None:
        scale = {k: local(*k, v) for k, v in scale.items()}
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

def expand_arms(x: torch.Tensor, n_arm: int, generator=None,
                draws=None) -> torch.Tensor:
    """The no-augmentation ``AugmentFn``: every arm sees the same batch, an
    (A, B, D) ``expand`` view of x (B, D), no copy (reference
    ``x.expand(A, -1, -1)``, cpl_mixvae.py:433-436;
    dvae_tpu/train/step.py:102).  It draws nothing."""
    del generator, draws
    return x.expand(n_arm, *x.shape)


def _fused_trunk(cfg: VAEConfig, spmd: Optional[Spmd],
                 fused: bool) -> bool:
    """The whole-decoder kernel runs off batch axes only: under them the
    fc11-only kernel takes over (dvae_tpu/train/step.py:144-147)."""
    return (fused and cfg.fused_decoder and cfg.mode != "ZINB"
            and (spmd is None or not spmd.batch_axes))


def _apply_with_loss(params, bn, cfg: VAEConfig, x, generator, temp, mask,
                     prior_c, train: bool = False, noise=None,
                     enc_seed: Optional[int] = None,
                     spmd: Optional[Spmd] = None):
    """Forward + loss with the fused-recon wiring in one place
    (dvae_tpu/train/step.py:135-159); train and eval share it.  Under
    ``cfg.fused_decoder`` (MSE mode only; ZINB ignores the flag) the model
    stops before the decoder trunk and the whole-decoder kernel takes it
    from there.  Returns (outs, new_bn, aux)."""
    fused = cfg.fused_recon
    fused_trunk = _fused_trunk(cfg, spmd, fused)
    outs, new_bn = mixvae.apply(params, bn, cfg, x, temp=temp, train=train,
                                mask=mask, prior_c=prior_c, skip_recon=fused,
                                skip_trunk=fused_trunk, noise=noise,
                                generator=generator, enc_seed=enc_seed,
                                spmd=spmd)
    aux = mixvae_loss(cfg, outs, x, prior_c,
                      fused_recon_args=(params, x) if fused else None,
                      fused_trunk=fused_trunk, spmd=spmd)
    return outs, new_bn, aux


def loss_fn(params, bn, cfg: VAEConfig, x, temp, mask, prior_c,
            compute_dtype=None, noise=None, generator=None,
            enc_seed: Optional[int] = None, spmd: Optional[Spmd] = None):
    """Train-mode loss; returns (total f32, (aux, new_bn, labels (A, B))).
    ``x`` is (B, D), shared by the arms, or (A, B, D); on a mesh this
    rank's block, and the labels are this rank's."""
    if compute_dtype is not None and compute_dtype != torch.float32:
        params = _cast_params(params, compute_dtype)
        x = x.to(compute_dtype)
    outs, new_bn, aux = _apply_with_loss(params, bn, cfg, x, generator, temp,
                                         mask, prior_c, train=True,
                                         noise=noise, enc_seed=enc_seed,
                                         spmd=spmd)
    labels = torch.argmax(outs.c, dim=-1)
    return aux.total.float(), (aux, new_bn, labels)


# ---------------------------------------------------------------------------
# Mesh (dvae_tpu/train/step.py:162-198)
# ---------------------------------------------------------------------------

def _spmd_axes(cfg: VAEConfig, tcfg: TrainConfig):
    """(arm_axes, batch_axes) a step shards over on a mesh of several
    devices, None on one: an axis that does not divide its dimension is
    dropped (arm ∤ A, or data·fsdp ∤ B), and every rank of it computes
    the whole dimension.  The JAX package's ``_fused_spmd_axes``
    (dvae_tpu/train/step.py:162-181) without its condition on the fused
    kernels: XLA shards JAX's plain path by itself, the port's by these
    axes as well."""
    m = tcfg.mesh
    if m.n_devices <= 1:
        return None
    arm_axes = ("arm",) if (m.arm > 1 and cfg.n_arm % m.arm == 0) else ()
    n_batch = m.data * m.fsdp
    batch_axes = tuple(
        ax for ax, sz in (("data", m.data), ("fsdp", m.fsdp)) if sz > 1
    ) if tcfg.batch_size % max(n_batch, 1) == 0 else ()
    return arm_axes, batch_axes


def _batch_ns(mesh, n_rows: int) -> Optional[slice]:
    """This rank's rows of an ``n_rows`` batch laid over the batch axes, or
    None when the mesh is absent or trivial or does not divide ``n_rows``
    (the counterpart of dvae_tpu/train/step.py:184-198's sharding)."""
    if mesh is None:
        return None
    n = mesh.axis_size(BATCH_AXES)
    if n == 1 or n_rows % n:
        return None
    k = n_rows // n
    return slice(mesh.batch_index * k, mesh.batch_index * k + k)


def _spmd(cfg: VAEConfig, tcfg: TrainConfig, mesh,
          n_rows: int) -> Optional[Spmd]:
    """This rank's shards of a step on an ``n_rows`` batch (None off a
    mesh); a batch the batch axes do not divide is computed whole."""
    axes = _spmd_axes(cfg, tcfg) if mesh is not None else None
    if axes is None:
        return None
    arm_axes, batch_axes = axes
    if batch_axes and _batch_ns(mesh, n_rows) is None:
        batch_axes = ()
    return Spmd(mesh, arm_axes, batch_axes, cfg.n_arm, n_rows)


def _leaf_items(tree):
    """(name, leaf) pairs of a two-level parameter tree in sorted order."""
    return [(n, k) for n in sorted(tree) for k in sorted(tree[n])]


def _compute_params(params, specs, mesh):
    """The parameters a step computes on: this rank's arms, gathered over
    fsdp (the stored tensors themselves where nothing is sharded)."""
    return {n: {k: reshard(v, specs.params[n][k], specs.compute[n][k], mesh)
                for k, v in layer.items()} for n, layer in params.items()}


def _reduced_in_op(cfg: VAEConfig, spmd: Spmd) -> set:
    """Gradient leaves the partitioned kernels summed over the batch group
    already (fc1 under the fused encoder, fc11's heads under the fused
    reconstruction loss)."""
    out = set()
    if cfg.fused_encoder:
        out |= {("fc1", "w"), ("fc1", "b")}
    if cfg.fused_recon and not _fused_trunk(cfg, spmd, True):
        heads = ("fc11", "fc11_p", "fc11_r") if cfg.mode == "ZINB" \
            else ("fc11",)
        out |= {(h, k) for h in heads for k in ("w", "b")}
    return out


def _fsdp_dim(spec) -> Optional[int]:
    """The dimension ``spec`` shards over fsdp, or None."""
    return next((i for i, e in enumerate(spec) if e == "fsdp"), None)


def _sync_grads(grads, cfg: VAEConfig, spmd: Spmd, specs):
    """The gradients summed over the batch group, each moved to its Adam
    moments' spec.  A leaf whose moments the fsdp axis shards (the ZeRO
    strategies) is reduce-scattered over fsdp and all-reduced over data;
    the others are all-reduced over the batch group (one collective for
    each kind), then sliced or gathered to their moments' spec.  The
    leaves the partitioned kernels reduced are only moved."""
    done = _reduced_in_op(cfg, spmd)
    mesh = spmd.mesh
    scatter = "fsdp" in spmd.batch_axes
    items = [it for it in _leaf_items(grads) if it not in done]
    part = [it for it in items
            if scatter and _fsdp_dim(specs.moments[it[0]][it[1]]) is not None]
    rest = [it for it in items if it not in part]
    out = {n: dict(layer) for n, layer in grads.items()}
    summed = flat_all_reduce([grads[n][k] for n, k in rest],
                             spmd.batch_group)
    for (n, k), g in zip(rest, summed):
        out[n][k] = g
    blocks = flat_all_reduce(flat_reduce_scatter(
        [grads[n][k] for n, k in part],
        [_fsdp_dim(specs.moments[n][k]) for n, k in part],
        mesh.fsdp_group), mesh.data_group)
    for (n, k), g in zip(part, blocks):
        out[n][k] = g
    return {n: {k: g if (n, k) in part else reshard(
        g, specs.compute[n][k], specs.moments[n][k], mesh)
        for k, g in layer.items()} for n, layer in out.items()}


def _sync_bn(bn, cfg: VAEConfig, spmd: Spmd):
    """Ghost batch norm on a mesh: each rank updated the running statistics
    from its own row blocks; their mean over the batch group is the JAX
    package's mean over every block (models/mixvae.py:171-175 there)."""
    group = spmd.batch_group
    if cfg.bn_groups == 1 or group is None:
        return bn
    items = _leaf_items(bn)
    summed = flat_all_reduce([bn[n][k] for n, k in items], group)
    out = {n: dict(layer) for n, layer in bn.items()}
    for (n, k), v in zip(items, summed):
        out[n][k] = v / group.size
    return out


def _gather_rows_arms(t: torch.Tensor, spmd: Spmd, row_dim: int = 1):
    """A block (no gradient) → the whole tensor: rows over the batch group,
    then arms over the arm group."""
    return all_gather(all_gather(t, spmd.batch_group, row_dim),
                      spmd.arm_group, 0)


def make_train_step(cfg: VAEConfig, tcfg: TrainConfig, opt: Adam,
                    augment: Optional[AugmentFn] = None, mesh=None):
    """step(state, x (B, D), prior_c (B, C) | None, temp, generator=None,
    enc_seed=None, noise=None, aug_draws=None, n_rows=None) → (state,
    StepMetrics, labels (A, B)).

    Value and gradients of ``loss_fn``, pruned-category gradients zeroed,
    ``opt.update``, pruned parameters zeroed again (dvae_tpu/train/step.py
    :201-245).  The parameters and the Adam moments are updated in place.
    Without an augmenter every arm shares the (B, D) batch, and that is
    what the model and the kernels get; with one, its (A, B, D) per-arm
    views, made on the batch's device from ``generator`` (or the explicit
    ``aug_draws``) inside the span ``dvae.step.augment``.

    ``mesh`` (several devices): the state is this rank's blocks, x the
    whole batch (or, with ``n_rows=`` the whole batch's row count, this
    rank's rows of it), the noise tensors whole; the update runs on the
    moments' blocks (``update_blocks``).  The labels returned are this
    rank's (A_l, B_l) block and the metrics those of the whole batch, the
    same on every rank."""
    compute_dtype = torch.bfloat16 if tcfg.bf16 else torch.float32
    specs = (state_specs(cfg, tcfg.sharding, mesh)
             if mesh is not None and mesh.cfg.n_devices > 1 else None)
    local = None if specs is None else (
        lambda name, leaf, scale: local_block(scale, specs.params[name][leaf],
                                              mesh))

    def step(state: TrainState, x, prior_c, temp, generator=None,
             enc_seed: Optional[int] = None, noise=None, aug_draws=None,
             n_rows: Optional[int] = None):
        spmd, whole = None, n_rows is None
        if specs is not None:
            spmd = _spmd(cfg, tcfg, mesh, x.shape[0] if whole else n_rows)
            if not whole and spmd.batch_axes == () and x.shape[0] != n_rows:
                raise ValueError(f"a batch of {n_rows} rows that the batch "
                                 "axes do not divide needs the whole batch")
            if augment is not None and not whole:
                raise ValueError("an augmenter needs the whole batch on "
                                 "every rank")
        if augment is not None:
            with span("step.augment"):
                x = augment(x, cfg.n_arm, generator, aug_draws)
                if spmd is not None:
                    x = spmd.local(x)
        elif spmd is not None and whole:
            x = spmd.local_rows(x)
        if spmd is not None and whole and prior_c is not None:
            prior_c = spmd.local_rows(prior_c)
        params = (state.params if specs is None else
                  _compute_params(state.params, specs, mesh))
        _, (aux, new_bn, labels), grads = value_and_grad(
            lambda p: loss_fn(p, state.bn, cfg, x, temp, state.mask, prior_c,
                              compute_dtype, noise, generator, enc_seed,
                              spmd), params)
        del params
        with span("step.update"):
            grads = _mask_grads(grads, state.mask, cfg)
            with torch.no_grad():
                if specs is None:
                    opt_state = opt.update(grads, state.opt_state,
                                           state.params)
                else:
                    grads = _sync_grads(grads, cfg, spmd, specs)
                    new_bn = _sync_bn(new_bn, cfg, spmd)
                    opt_state = update_blocks(
                        opt, grads, state.opt_state, state.params,
                        specs.params, specs.moments, mesh)
                _mask_params(state.params, state.mask, cfg, inplace=True,
                             local=local)
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


def make_chunk_loop(cfg: VAEConfig, tcfg: TrainConfig, opt: Adam,
                    n_train: int, augment: Optional[AugmentFn] = None,
                    mesh=None):
    """The epoch loop of the resident and the streamed runner: run(state,
    temp, n_epochs, device, batches, **step_kw) → (state, EpochMetrics).

    ``batches(gen, epoch)`` yields epoch ``epoch``'s ``n_train //
    batch_size`` (x, prior) batches and may draw from ``gen`` before the
    first.  Per step: the in-kernel seeds from the host generator, the
    train step (with ``step_kw``) in the span ``dvae.step``, a ``step``
    mark for the census.  Per epoch: the labels (gathered on a ``mesh``)
    and their consensus on the device, in ``dvae.runner.epoch_end``."""
    B = tcfg.batch_size
    steps = n_train // B
    if steps == 0:
        raise ValueError(f"batch_size {B} > dataset size {n_train}")
    step_fn = make_train_step(cfg, tcfg, opt, augment, mesh)
    spmd = _spmd(cfg, tcfg, mesh, B)
    n_used = steps * B
    A, K = cfg.n_arm, cfg.n_categories

    @spanned("runner")
    def run(state: TrainState, temp, n_epochs: int, device, batches,
            **step_kw):
        gen, host = chunk_rngs(state.seed, state.epoch, device)
        per_epoch = []
        for _ in range(n_epochs):
            labels = (torch.empty((A, n_used), dtype=torch.long,
                                  device=device) if spmd is None else [])
            ms = []
            for s, (x, prior) in enumerate(batches(gen, state.epoch)):
                enc_seed = int(host.integers(0, 2 ** 31 - 1))
                noise = (mixvae.Noise(gumbel_seed=int(
                    host.integers(0, 2 ** 31 - 1)))
                    if cfg.use_pallas else None)
                with span("step"):
                    state, m, lab = step_fn(state, x, prior, temp,
                                            generator=gen, enc_seed=enc_seed,
                                            noise=noise, **step_kw)
                record_mark("step")  # the census's step boundary
                if spmd is None:
                    labels[:, s * B:(s + 1) * B] = lab
                else:
                    labels.append(lab)
                ms.append(m)
            del x, prior  # the last batch need not outlive the epoch
            with span("runner.epoch_end"):
                if spmd is not None:  # (A_l, steps, B_l) → (A, S·B)
                    labels = _gather_rows_arms(
                        torch.stack(labels, dim=1), spmd, 2).reshape(
                            A, n_used)
                per_epoch.append(epoch_metrics(
                    ms, consensus_device(labels, K)))
            state = state._replace(epoch=state.epoch + 1)
        return state, EpochMetrics(*(torch.stack(v)
                                     for v in zip(*per_epoch)))

    return run


def make_epoch_runner(cfg: VAEConfig, tcfg: TrainConfig, opt: Adam,
                      n_train: int, epochs_per_chunk: Optional[int] = None,
                      augment: Optional[AugmentFn] = None, mesh=None):
    """run_epochs(state, x_all (N, D), prior_all (N, C) | None, temp) →
    (state, EpochMetrics), everything on x_all's device.

    ``make_chunk_loop`` over batches drawn on the device: per epoch a
    permutation at ``shuffle_block``-row granularity, the last partial
    batch dropped (dvae_tpu/train/step.py:297-394), each batch an
    ``index_select`` of x_all.  On a ``mesh`` every rank holds x_all whole
    and draws the same permutation."""
    E = epochs_per_chunk or tcfg.epochs_per_jit
    loop = make_chunk_loop(cfg, tcfg, opt, n_train, augment, mesh)
    B = tcfg.batch_size
    steps = n_train // B
    sb = tcfg.shuffle_block
    if sb > 1 and B % sb:
        raise ValueError(f"shuffle_block {sb} must divide batch_size {B}")
    n_blocks = n_train // sb

    def run_epochs(state: TrainState, x_all, prior_all, temp):
        dev = x_all.device
        x_view = x_all[: n_blocks * sb].reshape(n_blocks, sb, -1)
        prior_view = (None if prior_all is None else
                      prior_all[: n_blocks * sb].reshape(n_blocks, sb, -1))

        def batches(gen, epoch):
            perm = torch.randperm(n_blocks, generator=gen, device=dev)
            plan = perm[: steps * B // sb].reshape(steps, B // sb)
            for s in range(steps):
                sel = plan[s]
                yield (x_view.index_select(0, sel).reshape(B, -1),
                       None if prior_view is None else
                       prior_view.index_select(0, sel).reshape(B, -1))

        return loop(state, temp, E, dev, batches)

    return run_epochs


# ---------------------------------------------------------------------------
# Eval
# ---------------------------------------------------------------------------

def make_eval_step(cfg: VAEConfig, tcfg: TrainConfig,
                   augment: Optional[AugmentFn] = None, mesh=None):
    """Validation forward: no grad, eval semantics (hard one-hot, running
    BN statistics), the training compute dtype (bf16 under ``tcfg.bf16``)
    with the f32 islands of the loss.  Metrics leave in f32.  With an
    augmenter eval sees per-arm views too (dvae_tpu/train/step.py:509),
    their noise drawn from the same per-batch generator, inside the span
    ``dvae.eval.augment``.

    step(state, x (B, D), prior_c (B, C) | None, temp) →
        (LossOutputs, labels (A, B), MixVAEOutputs)

    On a ``mesh`` each rank evaluates its rows and arms of the batch and
    the outputs are gathered: the labels and every (A, B, ·) field of the
    outputs but x_rec, p_x and r_x (which stay this rank's block) are
    whole on every rank.  A batch the batch axes cannot divide (the
    trailing one) is evaluated whole on every rank, through the same
    kernels as the others: the JAX package takes the materialising path
    there (dvae_tpu/train/step.py:496-520) because its partitioning rule
    cannot split the batch, which the port's ops need not do.
    """
    compute_dtype = torch.bfloat16 if tcfg.bf16 else torch.float32
    cache = {}
    specs = (state_specs(cfg, tcfg.sharding, mesh)
             if mesh is not None and mesh.cfg.n_devices > 1 else None)

    @torch.no_grad()
    def eval_step(state: TrainState, x, prior_c, temp):
        params = state.params
        if specs is not None or compute_dtype != torch.float32:
            # gather and cast once per state, not once per batch; the
            # training step updates the parameters in place, so the cache
            # also keys on the optimizer step count
            key = (id(params), getattr(state.opt_state, "count", None))
            if cache.get("key") != key:
                if specs is not None:
                    params = _compute_params(params, specs, mesh)
                cache["key"], cache["cast"] = key, _cast_params(
                    params, compute_dtype)
            params = cache["cast"]
        x = x.to(compute_dtype)
        gen = torch.Generator(device="cpu").manual_seed(state.seed)
        if augment is not None:
            with span("eval.augment"):
                x = augment(x, cfg.n_arm, gen, None)
        spmd = _spmd(cfg, tcfg, mesh, x.shape[-2])
        if spmd is not None:
            x = (spmd.local(x) if x.dim() == 3 else spmd.local_rows(x))
            prior_c = spmd.local_rows(prior_c)
        outs, _, aux = _apply_with_loss(params, state.bn, cfg, x, gen, temp,
                                        state.mask, prior_c, spmd=spmd)
        labels = torch.argmax(outs.c, dim=-1)
        if spmd is not None:
            labels = _gather_rows_arms(labels, spmd)
            outs = outs._replace(**{
                k: _gather_rows_arms(getattr(outs, k), spmd)
                for k in ("x_low", "c", "s_smp", "c_smp", "s_mean",
                          "s_logvar", "c_prob")})
        aux = LossOutputs(*(v.float() for v in aux))
        return aux, labels, outs

    return eval_step


def make_eval_runner(cfg: VAEConfig, tcfg: TrainConfig,
                     augment: Optional[AugmentFn] = None, mesh=None):
    """run(state, x_chunk (K, B, D), temp, prior_chunk (K, B, C) | None) →
    (LossOutputs stacked (K, ...), EvalFields (A, K·B, ·)).

    Per-batch numerics are those of ``make_eval_step``."""
    ev = make_eval_step(cfg, tcfg, augment, mesh)

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
