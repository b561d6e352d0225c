"""Cross-validation folds and probabilistic leaf classifiers for taxonomy
validation, in the PyTorch port.

A copy of dvae_tpu/analysis/tree_helpers.py (numpy and scipy; the port
imports nothing of the JAX package).  scikit-learn is imported only inside
``get_cca_projections``.  The reference is
``mmidas/utils/analysis_tree_helpers.py``:
  * ``get_cvfold`` :197-270 / ``get_cvfold_extended`` :271-372 — load paired
    (transcriptomic, electrophysiology) latent CV splits from .mat files.
  * ``custom_QDA`` :374-416 — per-class Gaussian fits, unweighted argmax
    posterior.
  * ``predict_leaf_gmm`` :418-519 — Gaussian leaf classifier with
    descendant-merged probabilities against a taxonomy.
  * ``get_cca_projections`` :521-554 — whitened CCA projections of paired
    latents.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

_LEAF_GRAY = "#808080"  # non-leaf marker color in the Allen taxonomy


def _subset(d: dict, keep: np.ndarray) -> dict:
    return {k: v[keep] for k, v in d.items()}


def get_cvfold(cvfile: str = "", refdata: Optional[dict] = None):
    """Load one CV split (.mat) into paired/leaf train/val dicts
    (reference :197-270).

    Returns (train_paired, val_paired, train_leaf, val_leaf), each a dict
    with keys T_z, E_z, color, labels, labels_id.
    """
    import scipy.io as sio

    refdata = refdata or {}
    mat = sio.loadmat(cvfile, squeeze_me=True)

    def build(z_t, z_e, ind):
        return {"T_z": z_t, "E_z": z_e,
                "color": refdata["cluster_color"][ind],
                "labels": refdata["cluster"][ind],
                "labels_id": refdata["clusterID"][ind]}

    t_paired = refdata["T_ispaired"][mat["train_ind_T"]] == 1
    train_paired = build(mat["z_train_0"][t_paired],
                         mat["z_train_1"][refdata["E_ispaired"][
                             mat["train_ind_E"]] == 1],
                         mat["train_ind_T"][t_paired])
    val_paired = build(mat["z_val_0"], mat["z_val_1"], mat["val_ind"])

    train_leaf = _subset(train_paired, train_paired["color"] != _LEAF_GRAY)
    val_leaf = _subset(val_paired, val_paired["color"] != _LEAF_GRAY)
    return train_paired, val_paired, train_leaf, val_leaf


def get_cvfold_extended(cvfile: str = "", refdata: Optional[dict] = None,
                        full_data: bool = False):
    """``get_cvfold`` + per-sample dataset indices (and optionally raw
    features) carried through every split (reference :271-372).

    Each returned dict additionally holds ``T_ind``/``E_ind`` — the
    original row indices into the reference dataset — and, with
    ``full_data=True``, the leaf dicts also carry ``T_x``/``E_x`` gene
    expression / ephys feature matrices gathered by those indices.
    """
    import scipy.io as sio

    refdata = refdata or {}
    mat = sio.loadmat(cvfile, squeeze_me=True)

    def build(z_t, z_e, ind_t, ind_e):
        return {"T_z": z_t, "E_z": z_e,
                "color": refdata["cluster_color"][ind_t],
                "labels": refdata["cluster"][ind_t],
                "labels_id": refdata["clusterID"][ind_t],
                "T_ind": np.asarray(ind_t).copy(),
                "E_ind": np.asarray(ind_e).copy()}

    t_paired = refdata["T_ispaired"][mat["train_ind_T"]] == 1
    e_paired = refdata["E_ispaired"][mat["train_ind_E"]] == 1
    train_paired = build(mat["z_train_0"][t_paired],
                         mat["z_train_1"][e_paired],
                         mat["train_ind_T"][t_paired],
                         mat["train_ind_E"][e_paired])
    val_paired = build(mat["z_val_0"], mat["z_val_1"],
                       mat["val_ind"], mat["val_ind"])

    train_leaf = _subset(train_paired, train_paired["color"] != _LEAF_GRAY)
    val_leaf = _subset(val_paired, val_paired["color"] != _LEAF_GRAY)
    if full_data:
        for leaf in (train_leaf, val_leaf):
            leaf["T_x"] = refdata["T_dat"][leaf["T_ind"], :]
            leaf["E_x"] = refdata["E_dat"][leaf["E_ind"], :]
    return train_paired, val_paired, train_leaf, val_leaf


def _fit_class_gaussians(train_z, train_lbl, unique_lbl,
                         n_per_class_thr: int, diag_cov_n_sample_thr: int,
                         ridge: float = 0.0):
    """Per-class (mean, cov) fits; classes under the sample threshold are
    excluded.  Small classes get diagonal covariances."""
    fits, excluded = {}, []
    for lbl in unique_lbl:
        z = train_z[train_lbl == lbl]
        if z.shape[0] > n_per_class_thr:
            cov = np.cov(z, rowvar=False)
            if ridge:
                cov = cov + ridge * np.eye(z.shape[1])
            if z.shape[0] < diag_cov_n_sample_thr:
                cov = np.diagonal(cov)
            fits[lbl] = (np.mean(z, axis=0), cov)
        else:
            excluded.append(lbl)
    return fits, excluded


def custom_QDA(train_z, true_train_lbl, test_z, true_test_lbl,
               n_per_class_thr: int = 6, diag_cov_n_sample_thr: int = 12):
    """Per-class Gaussian fits + unweighted max-likelihood assignment
    (reference :374-416: p(class|z) ∝ p(z|class), uniform p(class))."""
    from scipy.stats import multivariate_normal as mvn

    # keep the caller's label values as-is (object dtype): an astype(str)
    # here would make int labels compare unequal to everything downstream
    # (str('0') == 0 is False), silently excluding every class
    true_train_lbl = np.asarray(true_train_lbl, dtype=object)
    true_test_lbl = np.asarray(true_test_lbl, dtype=object)
    unique_lbl = np.unique(np.concatenate(
        [true_train_lbl, true_test_lbl]))
    fits, excluded = _fit_class_gaussians(
        np.asarray(train_z), np.asarray(true_train_lbl), unique_lbl,
        n_per_class_thr, diag_cov_n_sample_thr)
    pdf = np.zeros((test_z.shape[0], unique_lbl.size))
    for i, lbl in enumerate(unique_lbl):
        if lbl in fits:
            mean, cov = fits[lbl]
            pdf[:, i] = mvn.pdf(test_z, mean, cov)
    pred = unique_lbl[np.argmax(pdf, axis=1)].astype(object)
    if len(true_test_lbl):
        for lbl in excluded:
            pred[true_test_lbl == lbl] = "excluded"
            true_test_lbl[true_test_lbl == lbl] = "excluded"
    return true_test_lbl, pred


def predict_leaf_gmm(train_z, true_train_lbl, test_z, true_test_lbl=(),
                     n_per_class_thr: int = 6,
                     diag_cov_n_sample_thr: int = 12,
                     unique_dataset_lbl: Sequence = (),
                     unique_leaf_lbl: Sequence = (),
                     descendant_dict: Optional[dict] = None,
                     label_weight: Sequence = ()):
    """Gaussian leaf classifier with taxonomy-merged probabilities
    (reference :418-519): fit per-leaf Gaussians, then sum leaf posterior
    mass into each merged dataset label through ``descendant_dict`` and
    argmax over merged labels.

    Returns (true_test_lbl, pred_test_lbl, n_excluded_cells,
    n_classes_predicted, n_classes_removed, pred_probability).
    """
    from scipy.stats import multivariate_normal as mvn

    descendant_dict = descendant_dict or {}
    if descendant_dict:
        assert len(unique_dataset_lbl), \
            "unique_dataset_lbl required with descendant_dict"
    unique_dataset_lbl = np.asarray(list(unique_dataset_lbl), dtype=object)
    unique_leaf_lbl = np.unique(np.asarray(list(unique_leaf_lbl)))
    # object dtype: fixed-width string arrays would truncate merged labels
    true_test_lbl = np.asarray(list(true_test_lbl), dtype=object)
    train_z = np.asarray(train_z)
    test_z = np.asarray(test_z)

    fits, excluded = _fit_class_gaussians(
        train_z, np.asarray(true_train_lbl), unique_leaf_lbl,
        n_per_class_thr, diag_cov_n_sample_thr, ridge=1e-4)
    pdf = np.zeros((test_z.shape[0], unique_leaf_lbl.size))
    for i, lbl in enumerate(unique_leaf_lbl):
        if lbl in fits:
            mean, cov = fits[lbl]
            pdf[:, i] = mvn.pdf(test_z, mean, cov)
    if len(label_weight):
        pdf = pdf * np.reshape(label_weight, (1, -1))
    denom = np.sum(pdf, axis=1, keepdims=True)
    denom[denom == 0] = 1.0
    pdf = pdf / denom

    keep = ~np.isin(true_test_lbl, excluded)
    n_excluded_cells = int(np.sum(~keep))
    test_z, true_test_lbl, pdf = test_z[keep], true_test_lbl[keep], pdf[keep]

    # leaf → merged-label map
    from_label, to_label = [], []
    for key, vals in descendant_dict.items():
        for v in vals or ():
            from_label.append(v)
            to_label.append(key)
    from_label, to_label = np.asarray(from_label), np.asarray(to_label)

    merged = np.zeros((test_z.shape[0], unique_dataset_lbl.size))
    for i, lbl in enumerate(unique_dataset_lbl):
        if lbl in unique_leaf_lbl:
            merged[:, i] = pdf[:, unique_leaf_lbl == lbl].squeeze(-1)
        elif to_label.size:
            merge_inds = np.isin(unique_leaf_lbl,
                                 from_label[to_label == lbl])
            if merge_inds.any():
                merged[:, i] = np.sum(pdf[:, merge_inds], axis=1)

    pred = unique_dataset_lbl[np.argmax(merged, axis=1)]
    prob = np.max(merged, axis=1)
    for f, t in zip(from_label, to_label):
        true_test_lbl[true_test_lbl == f] = t
    n_removed = int(np.sum(np.isin(unique_dataset_lbl, excluded)))
    n_predicted = int(unique_dataset_lbl.size - n_removed)
    return (true_test_lbl, pred, n_excluded_cells, n_predicted, n_removed,
            prob)


def get_cca_projections(train_leaf: dict, val_leaf: dict,
                        n_components: int = 3):
    """Whitened CCA projections of paired (T_z, E_z) latents
    (reference :521-554)."""
    from scipy.linalg import sqrtm
    from sklearn.cross_decomposition import CCA

    cca = CCA(n_components=n_components, scale=True, max_iter=int(1e4))
    cca.fit(train_leaf["T_z"], train_leaf["E_z"])

    def project(d):
        t, e = cca.transform(d["T_z"], d["E_z"])
        # whiten each projection so scales match
        t = t @ np.linalg.inv(np.real(sqrtm(np.cov(t, rowvar=False))))
        e = e @ np.linalg.inv(np.real(sqrtm(np.cov(e, rowvar=False))))
        return t, e

    train_t, train_e = project(train_leaf)
    val_t, val_e = project(val_leaf)
    return train_t, train_e, val_t, val_e
