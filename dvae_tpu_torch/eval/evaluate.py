"""Inference summary, cross-run reproducibility and north-star metrics of
the PyTorch port (numpy and scipy only).

Counterpart of dvae_tpu/eval/evaluate.py:
  * ``summarize_inference`` — mmidas/eval_models.py:8-134
  * ``mutinfo`` / ``avg_consensus`` / ``avg_max`` — evaluation.py:25-66,
    and ``mutinfo_oracle``, the sklearn double loop that ``mutinfo``
    replaces (sklearn imported inside it: the card machine has none)
  * ``evals2`` / ``evals2_files`` — mmidas/_evals.py:8-230
  * ``compute_consensus_statistics`` — mmidas/_utils.py:131-276
  * ``adjusted_mutual_info_score`` — sklearn's, which the examples score
    with (dvae_tpu/examples/hard_synthetic.py:130)
``mutinfo`` runs the numpy expected-MI path; the port does not load the
JAX package's native helpers.
"""

from __future__ import annotations

import pickle
from typing import Optional, Sequence

import numpy as np

from dvae_tpu_torch.eval.metrics import (compute_confmat, confmat_mean,
                                         confmat_normalize,
                                         consensus_from_labels,
                                         per_category_agreement, reassign)


def mutinfo_oracle(probs: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Reference transcription of ``mutinfo`` (evaluation.py:25-41): sklearn's
    AMI for every (reference type, cluster) pair, the oracle of ``mutinfo``.
    Minutes at production size; needs scikit-learn."""
    from sklearn.metrics.cluster import adjusted_mutual_info_score

    preds = np.argmax(probs, axis=1)
    uniq = np.unique(preds)
    prediction = np.zeros(len(preds))
    for i, c in enumerate(uniq):
        prediction[preds == c] = i
    F = len(np.unique(np.argmax(targets, axis=-1)))
    mi = np.zeros((F, len(uniq)))
    for c in range(mi.shape[1]):
        per_c = (prediction == c).astype(int)
        for f in range(F):
            mi[f, c] = adjusted_mutual_info_score(targets[:, f], per_c)
    return mi


def _lngamma_table(n: int) -> np.ndarray:
    """T[k] = ln k! for k = 0..n."""
    t = np.empty(n + 1)
    t[0] = 0.0
    np.cumsum(np.log(np.arange(1, n + 1)), out=t[1:])
    return t


def _emi_cell(a: np.ndarray, b: np.ndarray, N: int, T: np.ndarray,
              chunk: int = 4096) -> np.ndarray:
    """Expected-MI contribution of one cell of a 2x2 contingency table,
    E[(k/N)·ln(N·k/(a·b))] over k ~ Hypergeom(N, a, b), summed over a
    ±(12σ+25) window around the mean (Vinh et al. 2010)."""
    a, b = np.broadcast_arrays(a, b)
    shape = a.shape
    a = a.ravel().astype(np.int64)
    b = b.ravel().astype(np.int64)
    out = np.zeros(a.size)
    lo_sup = np.maximum(1, a + b - N)
    hi_sup = np.minimum(a, b)
    af, bf = a.astype(np.float64), b.astype(np.float64)
    mu = af * bf / N
    sig = np.sqrt(np.maximum(
        af * bf * (N - af) * (N - bf) / (float(N) * N * max(N - 1, 1)), 0.0))
    w = 12.0 * sig + 25.0
    lo = np.maximum(lo_sup, np.floor(mu - w).astype(np.int64))
    hi = np.minimum(hi_sup, np.ceil(mu + w).astype(np.int64))
    ln_const = T[N] - T[a] - T[N - a]
    for s in range(0, a.size, chunk):
        e = min(s + chunk, a.size)
        al, bl = a[s:e, None], b[s:e, None]
        lol, hil = lo[s:e], hi[s:e]
        span = int(max(0, (hil - lol).max())) + 1 if e > s else 0
        if span <= 0 or (hil < lol).all():
            continue
        k = lol[:, None] + np.arange(span)[None, :]
        valid = k <= hil[:, None]
        k = np.where(valid, k, 1)
        ln_pmf = ((T[bl] - T[k] - T[np.maximum(bl - k, 0)])
                  + (T[np.maximum(N - bl, 0)] - T[np.maximum(al - k, 0)]
                     - T[np.maximum(N - bl - al + k, 0)])
                  - ln_const[s:e, None])
        with np.errstate(divide="ignore"):
            term = ((k / N) * (np.log(N * k) - np.log(al * bl))
                    * np.exp(ln_pmf))
        out[s:e] = np.where(valid, term, 0.0).sum(axis=1)
    return out.reshape(shape)


def mutinfo(probs: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Per-(reference-type, discovered-cluster) adjusted mutual information
    of one arm's (N, C) posterior against (N, F) one-hot reference labels:
    the (F, C_used) matrix of reference evaluation.py:25-41, from 2x2
    contingency counts in closed form (sklearn's 'arithmetic' AMI)."""
    preds = np.argmax(probs, axis=1)
    uniq, prediction = np.unique(preds, return_inverse=True)
    C = len(uniq)
    t_int = np.argmax(targets, axis=-1)
    F = len(np.unique(t_int))
    N = len(prediction)

    fcols = np.asarray(targets[:, :F])
    n11 = np.empty((F, C), np.int64)
    tf = np.empty(F, np.int64)
    for f in range(F):
        mask = fcols[:, f] != 0
        tf[f] = int(mask.sum())
        n11[f] = np.bincount(prediction[mask], minlength=C)
    pc = np.bincount(prediction, minlength=C).astype(np.int64)
    n10 = tf[:, None] - n11
    n01 = pc[None, :] - n11
    n00 = N - tf[:, None] - pc[None, :] + n11

    def _mi_cell(n, aa, bb):
        n = n.astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (n / N) * (np.log(N * n) - np.log(aa * bb))
        return np.where(n > 0, t, 0.0)

    af, bf = tf[:, None].astype(np.float64), pc[None, :].astype(np.float64)
    mi = (_mi_cell(n11, af, bf) + _mi_cell(n10, af, N - bf)
          + _mi_cell(n01, N - af, bf) + _mi_cell(n00, N - af, N - bf))

    def _h2(cnt):
        p = cnt / N
        with np.errstate(divide="ignore", invalid="ignore"):
            h = -(p * np.log(p) + (1 - p) * np.log1p(-p))
        return np.where((cnt > 0) & (cnt < N), h, 0.0)

    h_u = _h2(tf.astype(np.float64))[:, None]
    h_v = _h2(pc.astype(np.float64))[None, :]
    T = _lngamma_table(N)
    emi = (_emi_cell(tf[:, None], pc[None, :], N, T)
           + _emi_cell(tf[:, None], N - pc[None, :], N, T)
           + _emi_cell(N - tf[:, None], pc[None, :], N, T)
           + _emi_cell(N - tf[:, None], N - pc[None, :], N, T))

    normalizer = 0.5 * (h_u + h_v)
    denom = normalizer - emi
    eps = np.finfo(np.float64).eps
    denom = np.where(denom < 0, np.minimum(denom, -eps),
                     np.maximum(denom, eps))
    ami = (mi - emi) / denom
    single_u = (tf == 0) | (tf == N)
    both_single = single_u[:, None] & np.full((1, C), C == 1)
    return np.where(both_single, 1.0, ami)


def _entropy_of_counts(counts: np.ndarray) -> float:
    """Shannon entropy (nats) of a labeling from its cluster sizes."""
    counts = counts[counts > 0].astype(np.float64)
    total = counts.sum()
    return float(-np.sum((counts / total) * (np.log(counts) - np.log(total))))


def adjusted_mutual_info_score(labels_true, labels_pred) -> float:
    """Adjusted mutual information of two labelings of the same N samples,
    with arithmetic normalisation: ``sklearn.metrics.
    adjusted_mutual_info_score`` in numpy (the card machine has no sklearn).

    AMI = (MI − E[MI]) / (mean(H_true, H_pred) − E[MI]) over the general
    R×C contingency table (kept sparse); E[MI] is the sum of ``_emi_cell``
    over the cluster sizes' pairs (Vinh et al. 2010), each distinct pair of
    sizes computed once.  sklearn's conventions for degenerate labelings:
    1.0 when both have one cluster (or none); 0.0 when only one does; the
    numerator and the denominator kept at least machine epsilon from 0 with
    their signs.  Labelings equal up to a renaming of their clusters give
    1.0."""
    t = np.asarray(labels_true).ravel()
    p = np.asarray(labels_pred).ravel()
    if t.shape != p.shape:
        raise ValueError(f"labelings of {t.size} and {p.size} samples")
    classes, ti = np.unique(t, return_inverse=True)
    clusters, pj = np.unique(p, return_inverse=True)
    R, C = len(classes), len(clusters)
    if R == C == 1 or R == C == 0:
        return 1.0
    if R == 1 or C == 1:
        return 0.0
    N = t.size
    cells, nij = np.unique(ti.astype(np.int64) * C + pj, return_counts=True)
    if len(cells) == R == C:   # a renaming: MI = H_true = H_pred
        return 1.0
    a, b = np.bincount(ti, minlength=R), np.bincount(pj, minlength=C)
    ai, bj = a[cells // C].astype(np.int64), b[cells % C].astype(np.int64)
    frac = nij / N
    mi = (frac * (np.log(nij) - np.log(N))
          + frac * (-np.log(ai * bj) + 2.0 * np.log(N)))
    mi = float(np.clip(np.where(np.abs(mi) < np.finfo(np.float64).eps,
                                0.0, mi).sum(), 0.0, None))
    ua, na = np.unique(a, return_counts=True)
    ub, nb = np.unique(b, return_counts=True)
    emi = float(np.sum(na[:, None] * nb[None, :] * _emi_cell(
        ua[:, None], ub[None, :], N, _lngamma_table(N))))
    eps = np.finfo(np.float64).eps
    den = 0.5 * (_entropy_of_counts(a) + _entropy_of_counts(b)) - emi
    den = min(den, -eps) if den < 0 else max(den, eps)
    num = mi - emi
    num = min(num, -eps) if num < 0 else max(num, eps)
    return float(num / den)


def avg_max(a: np.ndarray) -> float:
    """Mean over rows of the row max (reference ``avg``, evaluation.py:43)."""
    return float(np.mean(np.max(a, axis=-1)))


def avg_consensus(labels: np.ndarray) -> dict:
    """Exact-agreement consensus of (A, N) labels (evaluation.py:46-66):
    'pairwise' = mean over arm pairs of the agreeing fraction, 'all' =
    fraction of samples where every arm agrees."""
    A = labels.shape[0]
    if A == 1:
        return {"all": 1.0, "pairwise": 1.0}
    pairs = [float(np.mean(labels[i] == labels[j]))
             for i in range(A) for j in range(i + 1, A)]
    all_agree = float(np.mean(np.all(labels == labels[0], axis=0)))
    return {"all": all_agree, "pairwise": sum(pairs) / len(pairs)}


def summarize_inference(cpl, files, x, saving_file: Optional[str] = None
                        ) -> dict:
    """Load checkpoint(s) into ``cpl`` (a CplMixVAE), run batched eval over
    ``x`` and build the consensus summary (reference eval_models.py:8-134).
    Confusion matrices and consensus are restricted to unpruned
    categories."""
    if isinstance(files, (str, bytes)):
        files = [files]
    summaries = []
    for f in files:
        cpl.load_model(f)
        K = cpl.cfg.n_categories
        res = cpl.eval_model(x)
        labels = res["pred_label"]
        A = labels.shape[0]
        active = np.where(np.asarray(res["mask"]) > 0)[0]
        conf, cons = {}, {}
        for a in range(A):
            for b in range(a + 1, A):
                cm = confmat_normalize(
                    compute_confmat(labels[a], labels[b], K))
                cm = cm[np.ix_(active, active)]
                conf[(a, b)] = cm
                cons[(a, b)] = confmat_mean(cm)
        summaries.append({
            "file": f,
            "c_prob": res["c_prob"],
            "state_mu": res["state_mu"],
            "state_logvar": res["state_logvar"],
            "x_low": res["x_low"],
            "pred_label": labels,
            "armA_vs_armB": conf,
            "consensus_per_pair": cons,
            "consensus": res["consensus"],
            "per_category_agreement": per_category_agreement(labels, K),
            "total_loss_rec": res["total_loss_rec"],
            "mask": res["mask"],
            "nprune_indx": active,
        })
    out = summaries[0] if len(summaries) == 1 else {"runs": summaries}
    if saving_file:
        with open(saving_file, "wb") as fh:
            pickle.dump(out, fh, protocol=pickle.HIGHEST_PROTOCOL)
    return out


# ---------------------------------------------------------------------------
# Cross-run reproducibility (mmidas/_evals.py)
# ---------------------------------------------------------------------------

def evals2(labels_a: np.ndarray, labels_b: np.ndarray,
           c_prob_a: Optional[np.ndarray] = None,
           c_prob_b: Optional[np.ndarray] = None,
           K: Optional[int] = None) -> dict:
    """Within-run and between-run consensus of two trained models on the
    same cells (reference ``evals2``, mmidas/_evals.py:8-230).

    ``labels_*``: (A, N) argmax labels; ``c_prob_*``: optional (A, N, C)
    posteriors.  Returns 'within_a'/'within_b' (A, A) consensus of the arm
    pairs of one run, 'between' (A_a, A_b) consensus of arms across runs,
    and with posteriors 'l2_between', the mean squared L2 distance.  Only
    the between-run pairs are Hungarian-aligned before the diagonal is
    read (_evals.py:90): two runs may name the same clusters differently,
    while the arms of one run share category indices (:138, :186)."""
    if K is None:
        K = int(max(labels_a.max(), labels_b.max())) + 1

    def pair_consensus(la, lb, align=False):
        cm = confmat_normalize(compute_confmat(la, lb, K))
        return confmat_mean(reassign(cm) if align else cm)

    def within(labels):
        A = labels.shape[0]
        m = np.eye(A)
        for a in range(A):
            for b in range(a + 1, A):
                m[a, b] = m[b, a] = pair_consensus(labels[a], labels[b])
        return m

    Aa, Ab = labels_a.shape[0], labels_b.shape[0]
    between = np.zeros((Aa, Ab))
    for a in range(Aa):
        for b in range(Ab):
            between[a, b] = pair_consensus(labels_a[a], labels_b[b],
                                           align=True)
    out = {"within_a": within(labels_a), "within_b": within(labels_b),
           "between": between}
    if c_prob_a is not None and c_prob_b is not None:
        l2 = np.zeros((Aa, Ab))
        for a in range(Aa):
            for b in range(Ab):
                l2[a, b] = float(np.mean(
                    np.sum((c_prob_a[a] - c_prob_b[b]) ** 2, axis=-1)))
        out["l2_between"] = l2
    return out


def evals2_files(file_a: str, file_b: str, x, batch_size: int = 5000,
                 with_probs: bool = True, device="cuda") -> dict:
    """Cross-run reproducibility from two checkpoint files (the reference's
    ``evals2(fa, fb, dl)`` workflow, mmidas/_evals.py:8): each checkpoint,
    written by either package, is loaded by a fresh ``CplMixVAE`` on
    ``device``, served over ``x`` by ``eval_model`` (on CUDA through the
    serving kernels) and the two label sets go to ``evals2``.  Returns its
    dict plus ``labels_a``/``labels_b``."""
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE

    results = []
    for f in (file_a, file_b):
        cpl = CplMixVAE(device=device)
        cpl.load_model(f)
        results.append(cpl.eval_model(x, batch_size=batch_size))
    ra, rb = results
    K = max(r["c_prob"].shape[-1] for r in results)
    out = evals2(ra["pred_label"], rb["pred_label"],
                 c_prob_a=ra["c_prob"] if with_probs else None,
                 c_prob_b=rb["c_prob"] if with_probs else None, K=K)
    out["labels_a"], out["labels_b"] = ra["pred_label"], rb["pred_label"]
    return out


def compute_consensus_statistics(runs_labels: Sequence[np.ndarray],
                                 K: int) -> dict:
    """Within-run and between-run consensus over many runs (reference
    mmidas/_utils.py:131-276); ``runs_labels``: one (A, N) label array a
    run."""
    n_runs = len(runs_labels)
    within = [consensus_from_labels(lb, K) for lb in runs_labels]
    between = np.eye(n_runs)
    for i in range(n_runs):
        for j in range(i + 1, n_runs):
            e = evals2(runs_labels[i], runs_labels[j], K=K)
            between[i, j] = between[j, i] = float(np.mean(e["between"]))
    return {"within_run": np.asarray(within), "between_run": between,
            "mean_within": float(np.mean(within)),
            "mean_between": float(np.mean(between[np.triu_indices(n_runs, 1)]))
            if n_runs > 1 else 1.0}
