"""Consensus / confusion-matrix metrics of the PyTorch port.

Counterpart of dvae_tpu/eval/metrics.py (reference mmidas/_utils.py):
the numpy host functions on their numpy path (the port does not load the
JAX package's native helpers), the small helpers of the reference's
``_utils.py`` (``classify``, ``reassign``, ``ecdf``, ``set_seeds``, …),
and the device functions (``confmat_device``, ``consensus_device``,
``consensus_device_both``) as scatter-added counts on the tensors'
device, which read nothing back to the host.

Two helpers differ from the JAX package's: ``set_seeds`` also seeds torch
and every CUDA device, as the reference's does (mmidas/_utils.py:34-40),
and ``time_function`` synchronises the card around the call when CUDA is
in use, so that queued kernels are timed.
"""

from __future__ import annotations

import functools
import os
import random
import time
import warnings
from itertools import starmap

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

# ---------------------------------------------------------------------------
# Host (numpy)
# ---------------------------------------------------------------------------


def classify(probs: np.ndarray) -> np.ndarray:
    """argmax over the last axis."""
    return np.argmax(probs, axis=-1)


def _sync_cuda() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_function(f, *a, **kw) -> float:
    """Seconds taken by ``f(*a, **kw)`` (reference ``_utils.time_function``,
    mmidas/_utils.py:43-50).  When CUDA is in use the card is synchronised
    before the clock starts and before it stops, so the work ``f`` queued
    there is timed, not only its launch."""
    _sync_cuda()
    tic = time.perf_counter()
    f(*a, **kw)
    _sync_cuda()
    return time.perf_counter() - tic


def unstable(func):
    """Mark an API as unstable: a FutureWarning on every call (reference
    ``_utils.unstable``, mmidas/_utils.py:53-61)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        warnings.warn(f"{func.__name__}() is unstable",
                      category=FutureWarning, stacklevel=2)
        return func(*args, **kwargs)

    return wrapper


def mk_masks(bias: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(active indices, pruned indices) of a bias or mask vector: the
    categories whose entry is zero are the pruned ones (reference
    ``_utils.mk_masks``, mmidas/_utils.py:74-75)."""
    bias = np.asarray(bias)
    return np.where(bias != 0)[0], np.where(bias == 0)[0]


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


def compute_confmat_naive(labels1: np.ndarray, labels2: np.ndarray,
                          K: int | None = None) -> np.ndarray:
    """Per-sample loop oracle of ``compute_confmat``."""
    if labels1.shape != labels2.shape or labels1.ndim != 1:
        raise ValueError("expected two label vectors of one length")
    if K is None:
        K = max(len(np.unique(labels1)), len(np.unique(labels2)))
    m = np.zeros((K, K))
    for i in range(len(labels1)):
        m[int(labels1[i]), int(labels2[i])] += 1
    return m


def confmat_normalize(cm: np.ndarray) -> np.ndarray:
    """Divide column j by max(row_j sum, col_j sum); 0 where the max is 0."""
    maxes = np.maximum(np.sum(cm, axis=0), np.sum(cm, axis=1))
    return np.divide(cm, maxes, out=np.zeros_like(cm, dtype=np.float64),
                     where=maxes != 0)


def confmat_normalize_naive(cm: np.ndarray) -> np.ndarray:
    """Loop oracle of ``confmat_normalize``."""
    maxes = np.array([max(np.sum(cm[k, :]), np.sum(cm[:, k]))
                      for k in range(cm.shape[0])])
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


def reassign(x: np.ndarray) -> np.ndarray:
    """Permute the columns by the Hungarian algorithm to maximise the
    diagonal (reference ``_utils.reassign``, mmidas/_utils.py:69-71)."""
    _, col_inds = linear_sum_assignment(-x)
    return x[:, col_inds]


def ecdf(labels: np.ndarray) -> np.ndarray:
    """Empirical class frequencies of dense labels 0..K-1."""
    if labels.ndim != 1:
        raise ValueError("expected a label vector")
    return np.bincount(labels) / len(labels)


def no_ext(text: str) -> str:
    """``text`` without its last dotted extension."""
    return "".join(text.split(".")[:-1])


def parse_epoch(s: str):
    """The epoch number of a checkpoint file name, or the name itself when
    it holds none (reference ``_utils.parse_epoch``, mmidas/_utils.py:289-293)."""
    try:
        return int(no_ext(s).split("_epoch_")[-1])
    except (ValueError, IndexError):
        return s


def set_seeds(s: int) -> None:
    """Seed every global generator the reference seeds (``_utils.set_seeds``,
    mmidas/_utils.py:34-40): torch and every CUDA device, numpy, ``random``
    and PYTHONHASHSEED.  The port's own draws take explicit generators
    seeded from ``TrainConfig.seed``."""
    torch.manual_seed(s)
    torch.cuda.manual_seed_all(s)
    np.random.seed(s)
    random.seed(s)
    os.environ["PYTHONHASHSEED"] = str(s)


def mapv(f, assocs):
    """Map ``f`` over the values of (k, v) pairs (reference ``_utils.mapv``,
    mmidas/_utils.py:30-31)."""
    return starmap(lambda k, v: (k, f(v)), assocs)


def compose(*fs):
    """Right-to-left composition of functions (reference ``_utils.compose``,
    mmidas/_utils.py:23-27)."""

    def compose2(f, g):
        return lambda *a, **kw: f(g(*a, **kw))

    return functools.reduce(compose2, fs)


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
