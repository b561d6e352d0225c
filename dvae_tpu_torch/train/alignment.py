"""Cross-arm category alignment (off by default).

Counterpart of dvae_tpu/train/alignment.py.  The coupling loss is a
per-category distance between the arms' categorical posteriors, so
consensus needs every arm to use the same category INDEX for the same
cluster.  Gradient descent finds that permutation slowly; this module makes
the exact discrete move instead: Hungarian-match every arm's labels to a
reference arm's and apply the matched permutation to the few parameter
tensors indexed by the category axis.  The permutation is loss-neutral per
arm (reconstruction, KL and entropy are exactly invariant: the categories
are only renamed) while the cross-arm coupling term drops to its aligned
value at once.  Adam's moments are permuted the same way, so optimization
goes on as if the arm had always used the new labeling.

Category-indexed tensors (models/mixvae._arm_shapes):

  * ``fcc``      (L, C)   — logits head: weight columns and bias
  * ``fc_mu``    (L+C, S) — state head: input rows L..L+C (y = [x_low, c])
  * ``fc_sigma`` (L+C, S) — the same rows
  * ``fc6``      (C+S, L) — decoder input rows 0..C (z = [c_smp, s])

Batch norm carries no category axis.  Under a partly pruned mask (the (C,)
mask is shared by the arms) the match is restricted to the ACTIVE
categories: each arm's permutation maps active to active and fixes every
pruned index, so the mask is exactly invariant.  Not applicable under
``ref_prior`` (the prior table pins the indices); the trainer gates on it.

The permuted tensors are new tensors on the old ones' device: the training
step updates parameters and moments in place, so the state returned here is
the one to train on — the tensors of the state passed in are left as they
were and no longer belong to the run.

On a mesh (``shards``: the state's ``parallel.sharding.StateSpecs`` and the
rank's mesh; dvae_tpu/train/alignment.py:103-121) the labels are the
gathered ones every rank holds, so every rank finds the same permutation;
each category-indexed leaf is gathered whole, permuted the same way on
every rank and cut back to this rank's block, and moments that live in
host memory stay there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dvae_tpu_torch.config import VAEConfig

__all__ = [
    "match_to_reference",
    "permute_categories",
    "permute_opt_state",
    "moved_counts",
    "align_state",
]


def match_to_reference(labels: np.ndarray, K: int, ref_arm: int = 0,
                       active: Optional[np.ndarray] = None) -> np.ndarray:
    """(A, K) relabeling table ``m`` with ``m[a, old] = new``.

    For each arm, Hungarian-matches its label histogram against
    ``ref_arm``'s (the maximum-agreement assignment on the (K, K) confusion
    matrix); the reference arm maps to the identity.  ``labels``: (A, N)
    ints in [0, K).

    ``active``: optional (K,) boolean keep-mask (a pruned-category mask).
    With it the match runs on the active × active confusion submatrix and
    every pruned index maps to itself (an unrestricted match could send an
    empty active row to a pruned column and silently un-prune it).
    """
    from scipy.optimize import linear_sum_assignment

    labels = np.asarray(labels)
    A = labels.shape[0]
    ref = labels[ref_arm]
    m = np.tile(np.arange(K), (A, 1))
    act = None if active is None else np.flatnonzero(np.asarray(active))
    for a in range(A):
        if a == ref_arm:
            continue
        conf = np.zeros((K, K), np.int64)
        np.add.at(conf, (labels[a], ref), 1)
        if act is None:
            rows, cols = linear_sum_assignment(-conf)
            m[a, rows] = cols
        else:
            rows, cols = linear_sum_assignment(-conf[np.ix_(act, act)])
            m[a, act[rows]] = act[cols]
    return m


def _inv(m: np.ndarray) -> np.ndarray:
    """Row-wise inverse permutation: ``inv[a, new] = old``."""
    return np.argsort(m, axis=1)


def permute_categories(params: dict, m: np.ndarray, cfg: VAEConfig) -> dict:
    """Apply the per-arm relabeling ``m`` to a stacked-arm parameter tree
    (the parameters, or an Adam moment tree of the same structure).

    With ``inv = argsort(m)``, new slot ``j`` takes old slot ``inv[j]``, so
    the argmax labels afterwards satisfy ``new = m[a, old]`` and every
    per-arm output is exactly invariant.  The gathers run on each tensor's
    own device; untouched leaves are shared with ``params``.
    """
    L, C, S = cfg.lowD_dim, cfg.n_categories, cfg.state_dim
    A = cfg.n_arm
    inv = torch.from_numpy(_inv(np.asarray(m)).astype(np.int64))   # (A, C)
    steps = lambda n: torch.arange(n).expand(A, n)  # noqa: E731
    head_rows = torch.cat([steps(L), L + inv], dim=1)              # (A, L+C)
    dec_rows = torch.cat([inv, C + steps(S)], dim=1)               # (A, C+S)
    out = {k: dict(v) for k, v in params.items()}

    fcc = out["fcc"]
    w, b = fcc["w"], fcc["b"]
    fcc["w"] = torch.take_along_dim(
        w, inv[:, None, :].expand_as(w).to(w.device), dim=2)
    fcc["b"] = torch.take_along_dim(b, inv.to(b.device), dim=1)
    for name, rows in (("fc_mu", head_rows), ("fc_sigma", head_rows),
                       ("fc6", dec_rows)):
        w = out[name]["w"]
        out[name]["w"] = torch.take_along_dim(
            w, rows[:, :, None].expand_as(w).to(w.device), dim=1)
    return out


def permute_opt_state(opt_state, m: np.ndarray, cfg: VAEConfig):
    """Permute the Adam moments the way the parameters were: the moment
    entries of a category follow it.  A state without moment trees passes
    through untouched."""
    if not (hasattr(opt_state, "mu") and hasattr(opt_state, "nu")):
        return opt_state
    return opt_state._replace(mu=permute_categories(opt_state.mu, m, cfg),
                              nu=permute_categories(opt_state.nu, m, cfg))


def moved_counts(m: np.ndarray, labels: np.ndarray) -> Tuple[int, int]:
    """(total, active) remapped-index counts of the relabeling ``m``.

    ``active`` counts only categories with at least one cell assigned in
    the arm whose index moved — the number that matters: the Hungarian row
    of an unused category is a near-tie, and its index shuffles freely from
    one alignment to the next without touching any cell's label.
    """
    K = m.shape[1]
    changed = m != np.arange(K)
    support = np.stack([np.bincount(lab, minlength=K) > 0
                        for lab in np.asarray(labels)])
    return int(changed.sum()), int((changed & support).sum())


_CATEGORY_LEAVES = (("fcc", "w"), ("fcc", "b"), ("fc_mu", "w"),
                    ("fc_sigma", "w"), ("fc6", "w"))


def _permute_blocks(tree: dict, specs: dict, mesh, m: np.ndarray,
                    cfg: VAEConfig) -> dict:
    """``permute_categories`` of a tree of this rank's blocks: the category
    leaves gathered whole, permuted, and cut back (every rank must call)."""
    from dvae_tpu_torch.parallel.sharding import full_leaf, place
    whole = {k: dict(v) for k, v in tree.items()}
    for name, leaf in _CATEGORY_LEAVES:
        whole[name][leaf] = full_leaf(tree[name][leaf], specs[name][leaf],
                                      mesh)
    moved = permute_categories(whole, m, cfg)
    out = {k: dict(v) for k, v in tree.items()}
    for name, leaf in _CATEGORY_LEAVES:
        out[name][leaf] = place(moved[name][leaf], specs[name][leaf], mesh)
    return out


def align_state(state, labels: np.ndarray, cfg: VAEConfig, ref_arm: int = 0,
                mask: Optional[np.ndarray] = None, shards=None
                ) -> Tuple[object, np.ndarray, int]:
    """Hungarian-align every arm to ``ref_arm`` and permute the parameters
    and the Adam moments.  Returns ``(new_state, m, moved)`` with ``moved``
    the number of category indices that changed (0: already aligned, the
    state is returned as it was).

    ``mask``: optional (C,) pruning keep-mask.  The match is restricted to
    active categories (pruned indices are fixed points), so the shared mask
    needs no update.  ``shards``: (StateSpecs, Mesh) on a mesh.
    """
    K = cfg.n_categories
    active = None
    if mask is not None:
        mask = np.asarray(mask)
        if not bool(np.all(mask > 0)):
            active = mask > 0
    m = match_to_reference(labels, K, ref_arm, active=active)
    moved = int((m != np.arange(K)).sum())
    if moved == 0:
        return state, m, 0
    if shards is not None:
        specs, mesh = shards
        opt = state.opt_state
        if hasattr(opt, "mu") and hasattr(opt, "nu"):
            opt = opt._replace(
                mu=_permute_blocks(opt.mu, specs.moments, mesh, m, cfg),
                nu=_permute_blocks(opt.nu, specs.moments, mesh, m, cfg))
        return state._replace(
            params=_permute_blocks(state.params, specs.params, mesh, m, cfg),
            opt_state=opt), m, moved
    return state._replace(
        params=permute_categories(state.params, m, cfg),
        opt_state=permute_opt_state(state.opt_state, m, cfg)), m, moved
