"""Clusterability scoring of the PyTorch port: CV classifiers, silhouette,
K selection.

Counterpart of dvae_tpu/eval/cluster_analysis.py (reference
``mmidas/utils/cluster_analysis.py``), with the same functions and returns.
The JAX module calls scikit-learn throughout; the card machine has none, so
every call but the random forest is done here:

  * ``kfold_classifier``'s folds: ``KFold(n_splits, shuffle=True,
    random_state=seed)`` — the indices shuffled by
    ``np.random.RandomState(seed)``, the first ``n % k`` folds one longer,
    train and test indices ascending; the accuracy is the mean of equal
    labels.
  * ``kind="lda"``: ``LinearDiscriminantAnalysis(solver="svd")`` fit and
    predict, priors from the training frequencies (``_LDA``); ``kind="qda"``:
    ``QuadraticDiscriminantAnalysis(reg_param=1e-2)`` (``_QDA``).  Both are
    numpy and scipy on the host, the same operations in the same dtype as
    sklearn's, so their predictions are sklearn's.
  * ``get_SilhScore``: the silhouette in torch f64 on the data's device (or
    ``device``): Euclidean distances of each row chunk to every point, summed
    per cluster; a singleton cluster scores 0.
  * ``cluster_compare``'s PCA: the centred data's SVD in f64 on the device,
    each component's largest entry made positive (sklearn's ``svd_flip``).
  * ``kind="rf"`` is sklearn's ``RandomForestClassifier(random_state=seed)``:
    a forest is sklearn's own random stream and tree growth, so there is no
    twin of it; without scikit-learn it raises ``ImportError``.

The ``plot=True`` branch of ``cluster_compare`` needs matplotlib.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import scipy.linalg
import torch

# rows of the distance matrix held at once by the silhouette: 2^25 f64
# entries (256 MiB) a chunk
_SILH_CHUNK_ELEMS = 1 << 25


class _LDA:
    """``LinearDiscriminantAnalysis(solver="svd")``: fit and predict as
    sklearn's ``_solve_svd`` and ``LinearClassifierMixin.predict``."""

    tol = 1e-4

    def fit(self, X, y) -> "_LDA":
        X = np.asarray(X)
        if X.dtype not in (np.float32, np.float64):   # sklearn keeps f32
            X = X.astype(np.float64)
        y = np.asarray(y)
        self.classes_, yi, cnts = np.unique(y, return_inverse=True,
                                            return_counts=True)
        n_samples = X.shape[0]
        n_classes = len(self.classes_)
        if n_samples == n_classes:
            raise ValueError("The number of samples must be more than the "
                             "number of classes.")
        priors = cnts.astype(X.dtype) / float(n_samples)
        means = np.zeros((n_classes, X.shape[1]), dtype=X.dtype)
        np.add.at(means, yi, X)
        means /= np.bincount(yi)[:, None]
        Xc = np.concatenate([X[y == g] - means[i]
                             for i, g in enumerate(self.classes_)], axis=0)
        xbar = priors @ means
        # within-class scaling by the classes' std-dev, then its SVD
        std = np.std(Xc, axis=0)
        std[std == 0] = 1.0
        fac = np.asarray(1.0 / (n_samples - n_classes), dtype=X.dtype)
        _, S, Vt = scipy.linalg.svd(np.sqrt(fac) * (Xc / std),
                                    full_matrices=False)
        rank = np.sum((S > self.tol).astype(np.int32))
        scalings = (Vt[:rank, :] / std).T / S[:rank]
        fac = 1.0 if n_classes == 1 else 1.0 / (n_classes - 1)
        # between-class scaling: the weighted centres in that space
        Xb = ((np.sqrt((n_samples * priors) * fac)) * (means - xbar).T).T \
            @ scalings
        _, S, Vt = scipy.linalg.svd(Xb, full_matrices=False)
        rank = np.sum((S > self.tol * S[0]).astype(np.int32))
        scalings = scalings @ Vt.T[:, :rank]
        coef = (means - xbar) @ scalings
        intercept = -0.5 * np.sum(coef ** 2, axis=1) + np.log(priors)
        coef = coef @ scalings.T
        intercept -= xbar @ coef.T
        if n_classes == 2:   # sklearn's binary case: one decision column
            coef = np.asarray(coef[1, :] - coef[0, :],
                              dtype=X.dtype).reshape(1, -1)
            intercept = np.asarray(intercept[1] - intercept[0],
                                   dtype=X.dtype).reshape(1)
        self.coef_, self.intercept_ = coef, intercept
        return self

    def predict(self, X) -> np.ndarray:
        scores = np.asarray(X) @ self.coef_.T + self.intercept_
        if scores.shape[1] == 1:
            indices = (scores.reshape(-1) > 0).astype(np.intp)
        else:
            indices = np.argmax(scores, axis=1)
        return self.classes_.take(indices, axis=0)


class _QDA:
    """``QuadraticDiscriminantAnalysis(reg_param)``: a per-class SVD, the
    scalings ``S² (1 − reg)/(n − 1) + reg``, and sklearn's log-posterior."""

    tol = 1e-4

    def __init__(self, reg_param: float = 1e-2):
        self.reg_param = reg_param

    def fit(self, X, y) -> "_QDA":
        X = np.asarray(X)
        y = np.asarray(y)
        self.classes_, cnts = np.unique(y, return_counts=True)
        n_samples, n_features = X.shape
        if len(self.classes_) < 2:
            raise ValueError("The number of classes has to be greater than "
                             f"one. Got {len(self.classes_)} class.")
        self.priors_ = cnts / float(n_samples)
        means, self.scalings_, self.rotations_ = [], [], []
        for label in self.classes_:
            Xk = X[y == label, :]
            if len(Xk) == 1:
                raise ValueError(f"y has only 1 sample in class {label}, "
                                 "covariance is ill defined.")
            mean = Xk.mean(0)
            means.append(mean)
            _, S, Vt = np.linalg.svd(Xk - mean, full_matrices=False)
            scaling = (S ** 2) / (Xk.shape[0] - 1)
            scaling = ((1 - self.reg_param) * scaling) + self.reg_param
            if np.sum(scaling > self.tol) < n_features:
                raise np.linalg.LinAlgError(
                    f"The covariance matrix of class {label} is not full "
                    "rank. Increase the value of `reg_param` to reduce the "
                    "collinearity.")
            self.scalings_.append(scaling)
            self.rotations_.append(Vt.T)
        self.means_ = np.asarray(means)
        return self

    def predict(self, X) -> np.ndarray:
        X = np.asarray(X)
        norm2 = []
        for i in range(len(self.classes_)):
            R, S = self.rotations_[i], self.scalings_[i]
            X2 = np.dot(X - self.means_[i], R * (S ** (-0.5)))
            norm2.append(np.sum(X2 ** 2, axis=1))
        norm2 = np.array(norm2).T
        u = np.asarray([np.sum(np.log(s)) for s in self.scalings_])
        scores = -0.5 * (norm2 + u) + np.log(self.priors_)
        return self.classes_.take(scores.argmax(axis=1))


def _make_model(kind: str, seed: Optional[int] = None):
    if kind == "rf":
        try:
            from sklearn.ensemble import RandomForestClassifier
        except ImportError as e:
            raise ImportError(
                "kfold_classifier(kind='rf') needs scikit-learn: the random "
                "forest is sklearn's RandomForestClassifier, which the port "
                "does not replace") from e
        return RandomForestClassifier(random_state=seed)
    if kind == "lda":
        return _LDA()
    if kind == "qda":
        return _QDA(reg_param=1e-2)
    raise ValueError(f"unknown classifier kind {kind!r}")


def kfold_splits(n_samples: int, n_splits: int, seed: Optional[int] = 0):
    """The (train, test) index pairs of ``sklearn.model_selection.KFold(
    n_splits, shuffle=True, random_state=seed).split`` over ``n_samples``
    rows (seed None draws from numpy's global RandomState, as sklearn)."""
    if n_splits < 2:
        raise ValueError(f"k-fold cross-validation needs at least 2 "
                         f"splits, got n_splits={n_splits}")
    if n_splits > n_samples:
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} "
                         f"greater than the number of samples: "
                         f"n_samples={n_samples}.")
    indices = np.arange(n_samples)
    rng = (np.random.mtrand._rand if seed is None
           else np.random.RandomState(seed))
    rng.shuffle(indices)
    fold_sizes = np.full(n_splits, n_samples // n_splits, dtype=int)
    fold_sizes[: n_samples % n_splits] += 1
    current = 0
    for fold_size in fold_sizes:
        test = np.zeros(n_samples, dtype=bool)
        test[indices[current:current + fold_size]] = True
        current += fold_size
        yield np.flatnonzero(~test), np.flatnonzero(test)


def kfold_classifier(data, labels: Mapping[str, np.ndarray],
                     kfold: int = 5, seed: Optional[int] = 0,
                     kind: str = "rf"):
    """k-fold CV accuracy of predicting each label set from ``data``.

    Returns (acc, ref_labels, pred_labels) keyed by label-set name —
    the reference's contract for all three *_classifier functions.
    """
    if torch.is_tensor(data):
        data = data.detach().cpu().numpy()
    data = np.asarray(data)
    acc, pred_labels, ref_labels = {}, {}, {}
    for key, y in labels.items():
        y = np.asarray(y)
        acc[key], pred_labels[key], ref_labels[key] = [], [], []
        for train_index, test_index in kfold_splits(len(data), kfold, seed):
            model = _make_model(kind, seed)
            model.fit(data[train_index], y[train_index])
            y_pred = model.predict(data[test_index])
            acc[key].append(float(np.mean(y[test_index] == y_pred)))
            pred_labels[key].append(y_pred)
            ref_labels[key].append(y[test_index])
    return acc, ref_labels, pred_labels


def RF_classifier(data, labels, kfold=5, seed=0):
    return kfold_classifier(data, labels, kfold, seed, kind="rf")


def LDA_classifier(data, labels, kfold=5, seed=0):
    return kfold_classifier(data, labels, kfold, seed, kind="lda")


def QDA_classifier(data, labels, kfold=5, seed=0):
    return kfold_classifier(data, labels, kfold, seed, kind="qda")


def _device_of(x, device):
    if device is not None:
        return torch.device(device)
    return x.device if torch.is_tensor(x) else torch.device("cpu")


def silhouette_samples(x, labels, device=None) -> np.ndarray:
    """``sklearn.metrics.silhouette_samples`` (Euclidean) in torch f64 on
    the data's device or on ``device``: (b − a) / max(a, b) for each point,
    a its mean distance to the rest of its cluster, b the least mean
    distance to another cluster; 0 in a singleton cluster."""
    uniq, inv = np.unique(np.asarray(labels), return_inverse=True)
    n, k = len(inv), len(uniq)
    if not 1 < k < n:
        raise ValueError(f"Number of labels is {k}. Valid values are 2 to "
                         "n_samples - 1 (inclusive)")
    dev = _device_of(x, device)
    xt = torch.as_tensor(x).to(device=dev, dtype=torch.float64)
    lab = torch.as_tensor(inv.reshape(-1)).to(dev)
    freqs = torch.bincount(lab, minlength=k).to(torch.float64)
    onehot = torch.nn.functional.one_hot(lab, k).to(torch.float64)
    intra = torch.empty(n, dtype=torch.float64, device=dev)
    inter = torch.empty(n, dtype=torch.float64, device=dev)
    rows = max(1, _SILH_CHUNK_ELEMS // n)
    for s in range(0, n, rows):
        e = min(n, s + rows)
        # the direct formula: a point's distance to itself is exactly 0
        d = torch.cdist(xt[s:e], xt,
                        compute_mode="donot_use_mm_for_euclid_dist")
        sums = d @ onehot                                  # (rows, k)
        own = lab[s:e, None]
        intra[s:e] = sums.gather(1, own)[:, 0]
        inter[s:e] = (sums.scatter(1, own, float("inf"))
                      / freqs).min(dim=1).values
    a = intra / (freqs - 1)[lab]          # 0/0 in a singleton cluster
    sil = (inter - a) / torch.maximum(a, inter)
    return torch.nan_to_num(sil).cpu().numpy()


def get_SilhScore(x, labels: np.ndarray, device=None):
    """(per-cluster mean silhouette, overall silhouette) — reference :201.
    The silhouette runs on the data's device (a tensor's) or ``device``."""
    labels = np.asarray(labels)
    uniq = np.unique(labels)
    sample_score = silhouette_samples(x, labels, device)
    overall = float(np.mean(sample_score))
    per_cluster = np.array([np.mean(sample_score[labels == c]) for c in uniq])
    return per_cluster, overall


def pca_transform(data, num_pc: int, device=None) -> torch.Tensor:
    """``PCA(n_components=num_pc).fit_transform(data)`` in f64 on the data's
    device or ``device``: the centred data's SVD, each component's entry of
    largest magnitude made positive (``svd_flip(u_based_decision=False)``),
    the centred data projected on the first ``num_pc``."""
    dev = _device_of(data, device)
    X = torch.as_tensor(data).to(device=dev, dtype=torch.float64)
    if not 0 < num_pc <= min(X.shape):
        raise ValueError(f"n_components={num_pc} must be between 1 and "
                         f"min(n_samples, n_features)={min(X.shape)}")
    Xc = X - X.mean(dim=0)
    _, _, Vt = torch.linalg.svd(Xc, full_matrices=False)
    top = Vt.abs().argmax(dim=1, keepdim=True)
    Vt = Vt * torch.sign(Vt.gather(1, top))
    return Xc @ Vt[:num_pc].T


def cluster_compare(data, labels: Mapping[str, np.ndarray],
                    num_pc: int = 0, saving_path: str = "",
                    plot: bool = False, device=None):
    """Silhouette comparison of label sets in PCA space (reference :87-120),
    on the data's device or ``device``.

    Returns (fig|None, silh_smp_score, sil_score, c_size).
    """
    if num_pc <= 0:
        raise ValueError("num_pc must be > 0")
    z = pca_transform(data, num_pc, device)
    silh_smp_score, sil_score, c_size = [], [], []
    for key, y in labels.items():
        y = np.asarray(y)
        per_cluster, overall = get_SilhScore(z, y)
        sil_score.append(overall)
        sizes = np.array([np.sum(y == c) for c in np.unique(y)])
        order = np.argsort(per_cluster)
        silh_smp_score.append(per_cluster)
        c_size.append(sizes[order])
    fig = None
    if plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(10, 5))
        for (key, y), sc in zip(labels.items(), silh_smp_score):
            ax.plot(np.arange(len(sc)), np.sort(sc), label=key)
        ax.set_title(f"{num_pc} PCs")
        ax.set_xlabel("Ordered clusters")
        ax.set_ylabel("Ave. Silhouette scores")
        ax.legend()
        fig.tight_layout()
        if saving_path:
            fig.savefig(saving_path, dpi=300)
    return fig, silh_smp_score, sil_score, c_size


def K_selection(num_pruned: Sequence[int],
                recon_loss: Sequence[Sequence[float]],
                con_mean: np.ndarray,
                d_qc: Optional[np.ndarray] = None,
                thr: float = 0.95):
    """Category-count selection from a pruning sweep (reference :123-199).

    Args:
      num_pruned: surviving-category count per run.
      recon_loss: (n_arm, n_runs) reconstruction losses.
      con_mean:   (n_pairs, n_runs) or (n_runs,) mean consensus per run.
      d_qc:       optional (n_runs,) categorical distances (Aitchison).
      thr:        minimum acceptable consensus.

    Returns (ordered_num_pruned, ordered_recon_mean, ordered_consensus, K)
    with K=None when no run reaches ``thr`` (reference prints a warning and
    declines to choose, :180-184).
    """
    num_pruned = np.asarray(num_pruned)
    recon = np.asarray(recon_loss, dtype=np.float64)
    con_mean = np.atleast_2d(np.asarray(con_mean, dtype=np.float64))
    consensus = np.mean(con_mean, axis=0)
    l_recon_mean = np.mean(recon, axis=0)

    indx = np.argsort(num_pruned)
    ordered_cons = consensus[indx]
    K = None
    ok = np.where(ordered_cons > thr)[0]
    if thr <= consensus.max() and len(ok) > 0:
        if len(ok) > 1:
            jumps = np.diff(ordered_cons[ok])
            sel = int(np.argmax(jumps)) + 1
        else:
            # exactly one qualifying run: select it (the reference's
            # max-of-empty-diff crashes here)
            sel = int(ok[0])
        K = int(num_pruned[indx][sel])
    else:
        # thr == max(consensus) lands here too: the strict `>` filter is
        # empty, so decline rather than guess
        print("Required minimum consensus is set too high, kindly consider "
              "specifying a lower value.")
    return num_pruned[indx], l_recon_mean[indx], ordered_cons, K
