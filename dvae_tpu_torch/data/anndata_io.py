"""Cell×gene datasets of the PyTorch port (numpy only).

Counterpart of the synthetic half of dvae_tpu/data/anndata_io.py:
``CellDataset`` and ``synthetic_dataset`` (:533-561), number for number
the same data from the same seed.  Reading ``.h5ad`` files needs h5py,
which the port's target machine does not carry; it arrives with a later
slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field

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
