"""Marker-gene panel selection for augmenter training (numpy only).

Counterpart of dvae_tpu/augment/genes.py (reference
``mmidas/augmentation/dataloader.py``: ``get_genes`` :6-51, the curated
GABAergic/glutamatergic marker panels merged with the first ``n_genes``
columns, and ``get_data`` :55-71, expression + binarized-expression
batches).  The panels are the Allen Institute cortical marker sets of the
reference, kept here as the port's own copy.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

GLUTAMATERGIC_MARKERS = (
    "Slc30a3", "Cux2", "Rorb", "Deptor", "Scnn1a", "Rspo1", "Hsd11b1",
    "Batf3", "Oprk1", "Osr1", "Car3", "Fam84b", "Chrna6", "Pvalb", "Pappa2",
    "Foxp2", "Slc17a8", "Trhr", "Tshz2", "Rapdegf3", "Trh", "Gpr139",
    "Nxph4", "Rprm", "Crym", "Nxph3", "Nlgn1", "C1ql2", "C1ql3", "Adgrl1",
    "Nlgn3", "Dag1", "Cbln1", "Lrrtm1")

GABA_MARKERS_1 = (
    "Lamp5", "Ndnf", "Krt73", "Fam19a1", "Pax6", "Ntn1", "Plch2", "Lsp1",
    "Lhx6", "Nkx2.1", "Vip", "Sncg", "Slc17a8", "Nptx2", "Gpr50", "Itih5",
    "Serpinf1", "Igfbp6", "Gpc3", "Lmo1", "Ptprt", "Rspo4", "Chat",
    "Crispld2", "Col15a1", "Pde1a", "Cbln2", "Cbln4", "C1ql1", "Lrrtm3",
    "Clstn3", "Nlgn2", "Nr2e1", "Unc5a", "Rgs16", "Kcnh3", "Celsr3")

GABA_MARKERS_2 = (
    "Sst", "Chodl", "Nos1", "Mme", "Tac1", "Tacr3", "Calb2", "Nr2f2",
    "Myh8", "Tac2", "Hpse", "Crchr2", "Crh", "Esm1", "Rxfp1", "Nts",
    "Pvalb", "Gabrg1", "Th", "Calb1", "Akr1c18", "Sea3e", "Gpr149", "Reln",
    "Tpbg", "Cpne5", "Vipr2", "Nkx2-1", "Lrrtm3", "Clstn3", "Nlgn2",
    "Cbln3", "Lrrtm2", "Nxph1", "Nxph2", "Nxph4", "Syt2", "Hapln4",
    "St6galnac5", "Etv6", "Iqgap2", "Rasgef1b", "Oxtr", "Lama4", "Lipa",
    "Sirt4")


def additional_gene() -> list[str]:
    """The curated extra-marker panel of ``mmidas/utils/local_config.py``
    ``additional_gene`` :3-24: the glutamatergic and GABAergic panels as one
    flat list, order and duplicates as in the reference."""
    return list(GLUTAMATERGIC_MARKERS) + list(GABA_MARKERS_1) \
        + list(GABA_MARKERS_2)


def get_genes(gene_id: Sequence[str], n_genes: int = 0) -> np.ndarray:
    """Column indices combining the first ``n_genes`` genes (0: all) with
    the marker panels (reference ``get_genes``, a vectorized lookup)."""
    gene_id = np.asarray(gene_id)
    marker_set = set(GLUTAMATERGIC_MARKERS) | set(GABA_MARKERS_1) \
        | set(GABA_MARKERS_2)
    marker_idx = np.where(np.isin(gene_id, list(marker_set)))[0]
    base = np.arange(n_genes if n_genes > 0 else len(gene_id))
    return np.unique(np.concatenate([base, marker_idx]))


def get_data(log1p: np.ndarray, batch_size: int, training: bool = True,
             eps: float = 1e-1, seed: int = 0):
    """(x, x_bin) batch iterator for augmenter training (reference
    ``get_data``: expression and its binarized view, shuffled with the last
    partial batch dropped when training), on the port's ``BatchIterator``
    (``data/pipeline.py``)."""
    from dvae_tpu_torch.data.pipeline import BatchIterator

    x = np.asarray(log1p, np.float32)
    x_bin = (x > eps).astype(np.float32)
    it_x = BatchIterator(x, np.arange(len(x)), batch_size,
                         shuffle=training, drop_last=True, seed=seed)
    it_b = BatchIterator(x_bin, np.arange(len(x)), batch_size,
                         shuffle=training, drop_last=True, seed=seed)

    def gen():
        for (xb, _), (bb, _) in zip(it_x, it_b):
            yield xb, bb
    return gen()
