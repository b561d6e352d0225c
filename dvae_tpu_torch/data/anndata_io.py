"""Cell×gene datasets of the PyTorch port.

Counterpart of the synthetic half of dvae_tpu/data/anndata_io.py:
``CellDataset``, ``synthetic_dataset`` (:533-561), number for number the
same data from the same seed, and ``hard_synthetic_dataset`` (:420-530),
whose programs, assignments and labels are the JAX package's number for
number while its ZINB counts come from the port's own sampler (the same
distributions, another bitstream).  Reading ``.h5ad`` files needs h5py,
which the port's target machine does not carry; it arrives with a later
slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - np.max(x, axis=axis, keepdims=True)
    e = np.exp(x)
    return e / np.sum(e, axis=axis, keepdims=True)


@dataclass
class CellDataset:
    """A cell×gene dataset with cluster annotations.

    ``log1p`` (N, D) float32 expression; ``gene_id`` (D,); ``cluster_label``
    (N,) strings; ``cluster_id`` (N,) 1-based ids; ``c_onehot`` (N, K);
    ``c_p`` (N, K) softened prior softmax((onehot+eps)/tau); ``n_type`` K.
    """

    log1p: np.ndarray
    gene_id: np.ndarray
    cluster_label: np.ndarray
    cluster_id: np.ndarray
    c_onehot: np.ndarray
    c_p: np.ndarray
    n_type: int
    obs: dict = field(default_factory=dict)


def _encode_labels(labels: np.ndarray, eps: float, tau: float):
    """Dense 1-based ids, one-hot and softened prior from string labels."""
    uniq, int_enc = np.unique(labels, return_inverse=True)
    cluster_id = (int_enc + 1).astype(np.float64)
    K = len(uniq)
    onehot = np.zeros((len(labels), K), dtype=np.float64)
    onehot[np.arange(len(labels)), int_enc] = 1.0
    c_p = _softmax((onehot + eps) / tau, axis=1)
    return cluster_id, onehot, c_p, K


def synthetic_dataset(n_cells: int = 2000, n_genes: int = 500,
                      n_types: int = 10, seed: int = 0, eps: float = 1e-1,
                      tau: float = 1.0, sparsity: float = 0.7) -> CellDataset:
    """Synthetic log1p-CPM-like data with planted cluster structure:
    sparse non-negative per-type mean programs plus Gaussian noise."""
    rng = np.random.default_rng(seed)
    centers = rng.gamma(2.0, 2.0, (n_types, n_genes)).astype(np.float32)
    centers *= rng.random((n_types, n_genes)) > sparsity
    assign = rng.integers(0, n_types, n_cells)
    X = centers[assign] + rng.normal(0, 0.3, (n_cells, n_genes)).astype(
        np.float32)
    X = np.maximum(X, 0.0).astype(np.float32)

    labels = np.array([f"type_{i:03d}" for i in assign])
    cluster_id, onehot, c_p, K = _encode_labels(labels, eps, tau)
    return CellDataset(
        log1p=X, gene_id=np.array([f"g{j}" for j in range(n_genes)]),
        cluster_label=labels, cluster_id=cluster_id, c_onehot=onehot,
        c_p=c_p, n_type=K)


def hard_synthetic_dataset(
    n_cells: int = 20000,
    n_genes: int = 5032,
    n_types: int = 92,
    seed: int = 0,
    n_roots: int = 12,
    marker_frac: float = 0.03,
    root_frac: float = 0.4,
    lib_mu: Optional[float] = None,  # median log library size; default
                                     # log(2·n_genes): about 2 counts/gene
    lib_sigma: float = 0.6,
    theta_scale: float = 2.0,     # NB inverse dispersion (low = noisy)
    zi_max: float = 0.5,          # dropout ceiling for silent genes
    eps: float = 1e-1,
    tau: float = 1.0,
    chunk: int = 2000,
    device="cpu",
) -> CellDataset:
    """Hard-mode synthetic scRNA-seq: ZINB counts with the failure modes of
    real Smart-seq data (dvae_tpu/data/anndata_io.py:420-530):

      * hierarchy and overlap: ``n_roots`` root expression programs; each
        leaf type perturbs only ``marker_frac`` of its root's genes;
      * abundance imbalance: Dirichlet type proportions;
      * library size: per-cell total counts ~ LogNormal(lib_mu, lib_sigma);
      * overdispersion: per-gene NB theta ~ LogNormal around
        ``theta_scale``;
      * dropout: per-gene zero inflation, strongest for low-expression
        genes.

    Everything up to the count draw is numpy from ``default_rng(seed)`` and
    equals the JAX package's; the counts come from
    ``models/distributions.ZeroInflatedNegativeBinomial.sample`` with a
    ``torch.Generator`` on ``device`` seeded with ``seed``, chunk by chunk,
    and go through ``logcpm``.  Leaf labels are ``r{root:02d}_t{leaf:03d}``.
    """
    import torch

    from dvae_tpu_torch.models.distributions import \
        ZeroInflatedNegativeBinomial
    from dvae_tpu_torch.utils.tools import logcpm

    rng = np.random.default_rng(seed)

    # root programs: sparse heavy-tailed base, per-root fold changes on a
    # root_frac subset of genes
    base = rng.gamma(0.3, 1.0, n_genes)
    roots = np.tile(base, (n_roots, 1))
    for r in range(n_roots):
        sel = rng.random(n_genes) < root_frac
        roots[r, sel] *= rng.lognormal(0.0, 1.5, sel.sum())

    # leaves: each type perturbs marker_frac of its root's genes only
    leaf_root = np.sort(rng.integers(0, n_roots, n_types))
    progs = roots[leaf_root].copy()
    for t in range(n_types):
        sel = rng.random(n_genes) < marker_frac
        progs[t, sel] *= rng.lognormal(0.0, 1.0, sel.sum())
    props = progs / progs.sum(axis=1, keepdims=True)      # (T, D)

    # imbalanced type abundances (floored so the stratified split holds)
    abund = rng.dirichlet(np.full(n_types, 1.5))
    abund = np.maximum(abund, 0.3 / n_types)
    abund /= abund.sum()
    assign = rng.choice(n_types, size=n_cells, p=abund)

    if lib_mu is None:
        lib_mu = float(np.log(2.0 * n_genes))
    lib = rng.lognormal(lib_mu, lib_sigma, n_cells)       # counts/cell

    # per-gene dispersion + expression-dependent dropout
    theta_g = rng.lognormal(np.log(theta_scale), 0.5, n_genes)
    mean_prop = (abund[:, None] * props).sum(axis=0)      # dataset mean
    zi_prob = np.clip(zi_max * np.exp(-2e4 * mean_prop), 0.01, zi_max)
    zi_logits = np.log(zi_prob / (1.0 - zi_prob)).astype(np.float32)

    gen = torch.Generator(device=device).manual_seed(seed)
    theta_t = torch.as_tensor(theta_g, dtype=torch.float32, device=device)
    zi_t = torch.as_tensor(zi_logits, device=device)
    X = np.empty((n_cells, n_genes), np.float32)
    for lo in range(0, n_cells, chunk):
        hi = min(lo + chunk, n_cells)
        mu = (lib[lo:hi, None] * props[assign[lo:hi]]).astype(np.float32)
        d = ZeroInflatedNegativeBinomial(
            mu=torch.as_tensor(mu, device=device), theta=theta_t,
            zi_logits=zi_t)
        X[lo:hi] = logcpm(d.sample(gen).cpu().numpy()).astype(np.float32)

    labels = np.array([f"r{leaf_root[t]:02d}_t{t:03d}" for t in assign])
    cluster_id, onehot, c_p, K = _encode_labels(labels, eps, tau)
    return CellDataset(
        log1p=X, gene_id=np.array([f"g{j}" for j in range(n_genes)]),
        cluster_label=labels, cluster_id=cluster_id, c_onehot=onehot,
        c_p=c_p, n_type=K)
