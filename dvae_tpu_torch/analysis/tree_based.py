"""State-variable / gene-expression correlation of the PyTorch port.

Counterpart of dvae_tpu/analysis/tree_based.py (reference
``mmidas/utils/tree_based_analysis.py``), numpy only:
  * ``masked_pearson`` / ``corr_analysis`` :7-62 — Pearson correlation of
    each continuous state dimension with each gene over the cells that
    express it, vectorised over genes; ``corr_analysis_naive`` is the
    reference's per-gene scipy loop, kept as the oracle.
  * ``get_merged_types`` :62-115 needs the taxonomy tree (``HTree``, which
    reads its CSV with pandas) and arrives with the taxonomy slice of the
    port.  This module imports without pandas.
"""

from __future__ import annotations

import numpy as np


def masked_pearson(state_col: np.ndarray, cell: np.ndarray,
                   min_nonzero: int = 5) -> np.ndarray:
    """(G,) Pearson r between one state vector (N,) and every gene of cell
    (N, G), each over the gene's nonzero cells; a gene with fewer than
    ``min_nonzero`` of them gets r = 0 (the reference's ``len(zind) > 4``)."""
    x = state_col[:, None]
    m = (cell > 0).astype(np.float64)
    n = m.sum(axis=0)
    safe_n = np.maximum(n, 1.0)

    sx = (x * m).sum(axis=0)
    sy = (cell * m).sum(axis=0)
    sxx = (x ** 2 * m).sum(axis=0)
    syy = (cell ** 2 * m).sum(axis=0)
    sxy = (x * cell * m).sum(axis=0)

    cov = sxy - sx * sy / safe_n
    var_x = sxx - sx ** 2 / safe_n
    var_y = syy - sy ** 2 / safe_n
    denom = np.sqrt(np.maximum(var_x * var_y, 0.0))
    r = np.divide(cov, denom, out=np.zeros_like(cov), where=denom > 0)
    r[n <= min_nonzero - 1] = 0.0
    return r


def corr_analysis(state: np.ndarray, cell: np.ndarray):
    """Per state dimension s: ``all_corr[s]``, the genes' |r| sorted
    ascending, and ``all_geneID[s]``, the gene indices in that order (the
    reference's contract)."""
    all_corr, all_geneID = [], []
    for s in range(state.shape[-1]):
        r = masked_pearson(state[:, s].astype(np.float64),
                           cell.astype(np.float64))
        order = np.argsort(np.abs(r))
        all_corr.append(np.abs(r)[order])
        all_geneID.append(order)
    return all_corr, all_geneID


def corr_analysis_naive(state: np.ndarray, cell: np.ndarray,
                        min_nonzero: int = 5):
    """Per-gene scipy loop oracle (the reference's implementation)."""
    from scipy import stats

    n_gene = cell.shape[-1]
    all_corr, all_geneID = [], []
    for s in range(state.shape[-1]):
        r = np.zeros(n_gene)
        for g in range(n_gene):
            if np.max(cell[:, g]) > 0:
                nz = np.where(cell[:, g] > 0)[0]
                if len(nz) > min_nonzero - 1:
                    r[g], _ = stats.pearsonr(state[nz, s], cell[nz, g])
        order = np.argsort(np.abs(r))
        all_corr.append(np.sort(np.abs(r)))
        all_geneID.append(order)
    return all_corr, all_geneID


def get_merged_types(htree_file: str, cells_labels, num_classes: int = 0,
                     ref_leaf=(), node: str = "n4"):
    """Merge labels along the taxonomy tree of ``htree_file`` (reference
    tree_based_analysis.py:62-115).  Not ported yet: it needs the taxonomy
    tree (``analysis/taxonomy.HTree``)."""
    from dvae_tpu_torch.train.cpl_mixvae import _not_ported
    raise _not_ported("get_merged_types (the taxonomy tree, HTree)",
                      "taxonomy (ROADMAP A9b)")
