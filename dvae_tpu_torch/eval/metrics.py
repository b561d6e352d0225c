"""Consensus / confusion-matrix metrics of the PyTorch port.

Counterpart of dvae_tpu/eval/metrics.py (reference mmidas/_utils.py):
the numpy host functions on their numpy path (the port does not load the
JAX package's native helpers), and the device functions
(``confmat_device``, ``consensus_device``, ``consensus_device_both``) as
scatter-added counts on the tensors' device, which read nothing back to
the host.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host (numpy)
# ---------------------------------------------------------------------------


def compute_confmat(labels1: np.ndarray, labels2: np.ndarray,
                    K: int | None = None) -> np.ndarray:
    """K×K co-occurrence matrix of two label vectors (reference
    mmidas/_utils.py:83-93); ``K`` defaults to the larger unique count."""
    if labels1.shape != labels2.shape or labels1.ndim != 1:
        raise ValueError("expected two label vectors of one length")
    labels1 = labels1.astype(np.int64, copy=False)
    labels2 = labels2.astype(np.int64, copy=False)
    if K is None:
        K = max(len(np.unique(labels1)), len(np.unique(labels2)))
    idx = labels1 * K + labels2
    return np.bincount(idx, minlength=K * K).reshape(K, K).astype(np.float64)


def confmat_normalize(cm: np.ndarray) -> np.ndarray:
    """Divide column j by max(row_j sum, col_j sum); 0 where the max is 0."""
    maxes = np.maximum(np.sum(cm, axis=0), np.sum(cm, axis=1))
    return np.divide(cm, maxes, out=np.zeros_like(cm, dtype=np.float64),
                     where=maxes != 0)


def confmat_mean(cm: np.ndarray) -> float:
    """Mean of the diagonal — the consensus score."""
    return float(np.mean(np.diag(cm)))


def consensus_from_labels(labels: np.ndarray, K: int) -> float:
    """Mean pairwise consensus over all arm pairs of (A, N) labels."""
    A = labels.shape[0]
    scores = [confmat_mean(confmat_normalize(
        compute_confmat(labels[a], labels[b], K)))
        for a in range(A) for b in range(a + 1, A)]
    return float(np.mean(scores)) if scores else 1.0


def per_category_agreement(labels: np.ndarray, K: int) -> np.ndarray:
    """(K,) per-category consensus averaged over arm pairs — the pruning
    criterion (build/lib/mmidas/cpl_mixvae.py:355-391)."""
    A = labels.shape[0]
    if A < 2:
        return np.ones(K)
    diags = [np.diag(confmat_normalize(
        compute_confmat(labels[a], labels[b], K)))
        for a in range(A) for b in range(a + 1, A)]
    return np.mean(diags, axis=0)


# ---------------------------------------------------------------------------
# Device (torch)
# ---------------------------------------------------------------------------

def _pair_counts(labels1: torch.Tensor, labels2: torch.Tensor,
                 K: int) -> torch.Tensor:
    """(P, K·K) co-occurrence counts of P label-vector pairs (P, N), added
    with ``scatter_add_``: integer counts, exact in f32 below 2**24 and so
    the same whatever the order of the atomic adds; no one-hot tensor and
    no read back to the host."""
    idx = labels1.long() * K + labels2.long()
    out = torch.zeros((idx.shape[0], K * K), device=idx.device)
    return out.scatter_add_(1, idx, torch.ones((1, 1), device=idx.device)
                            .expand_as(idx))


def confmat_device(labels1: torch.Tensor, labels2: torch.Tensor,
                   K: int) -> torch.Tensor:
    """(K, K) confusion matrix of two label vectors on their device
    (dvae_tpu/eval/metrics.py:197-204)."""
    return _pair_counts(labels1[None], labels2[None], K).view(K, K)


def pairwise_confmats_device(labels: torch.Tensor, K: int) -> torch.Tensor:
    """(A, A, K, K) confusion matrices of (A, N) labels; only the a<b
    triangle is meaningful.  The JAX package's one-hot einsum would hold
    (A, N, K) one-hots (74 MB at A=5, N=40,000, K=92, and as much again in
    copies); the counts need an (A·A, N) index only."""
    A, N = labels.shape
    l1 = labels[:, None, :].expand(A, A, N).reshape(A * A, N)
    l2 = labels[None, :, :].expand(A, A, N).reshape(A * A, N)
    return _pair_counts(l1, l2, K).view(A, A, K, K)


def consensus_device_both(labels: torch.Tensor, K: int):
    """(reference consensus, active-only consensus) in one pass
    (dvae_tpu/eval/metrics.py:218-243): the mean normalised diagonal over
    all K categories, and over categories with support in the pair."""
    A = labels.shape[0]
    if A * (A - 1) // 2 == 0:
        one = torch.ones((), device=labels.device)
        return one, one
    cms = pairwise_confmats_device(labels, K)             # (A, A, K, K)
    col = cms.sum(dim=-2)
    row = cms.sum(dim=-1)
    maxes = torch.maximum(col, row)
    diag = torch.diagonal(cms, dim1=-2, dim2=-1)          # (A, A, K)
    norm_diag = torch.where(maxes != 0,
                            diag / torch.where(maxes == 0,
                                               torch.ones_like(maxes), maxes),
                            torch.zeros_like(diag))
    iu = torch.triu_indices(A, A, offset=1, device=labels.device)
    per_pair_all = norm_diag.mean(dim=-1)
    n_active = torch.clamp((maxes != 0).sum(dim=-1), min=1)
    per_pair_active = norm_diag.sum(dim=-1) / n_active
    return (per_pair_all[iu[0], iu[1]].mean(),
            per_pair_active[iu[0], iu[1]].mean())


def consensus_device(labels: torch.Tensor, K: int,
                     active_only: bool = False) -> torch.Tensor:
    """Mean pairwise consensus of (A, N) labels on their device (one
    variant of ``consensus_device_both``; dvae_tpu/eval/metrics.py:246-252)."""
    both = consensus_device_both(labels, K)
    return both[1] if active_only else both[0]
