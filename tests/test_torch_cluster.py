"""The PyTorch port's clusterability scoring against the JAX package and
scikit-learn: ``eval/cluster_analysis.py`` and
``examples/clusterability.py``.

The cluster cases of ``tests/test_eval_stack.py`` (``test_kfold_classifiers``,
``test_silhouette``, both ``K_selection`` tests) run on the port and each
compares with the JAX function on the same input.  The port replaces
every sklearn call but the random forest, and each replacement is held to
sklearn here: the k-fold index sets exactly; LDA (``solver="svd"``) and QDA
(``reg_param=1e-2``) predictions and accuracies exactly, on blobs and on a
(600, 10) latent space of 6 classes, in f32 and f64; the silhouette within
1e-10 on f64 data (on f32 data sklearn rounds the distances to f32, so
1e-6); the PCA transform within 1e-8.  The random forest is sklearn's on
both sides (equal), and without sklearn it raises ``ImportError``.
"""

import sys

import numpy as np
import pytest
import torch

from dvae_tpu.eval import cluster_analysis as jca
from dvae_tpu.examples import clusterability as jclus

from dvae_tpu_torch.eval import cluster_analysis as tca
from dvae_tpu_torch.examples import clusterability as tclus

TOL_SILH = 1e-10
TOL_SILH_F32 = 1e-6
TOL_PCA = 1e-8


def _blobs(seed=21, n=150, d=8, k=3, spread=0.5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 5, (k, d))
    y = rng.integers(0, k, n)
    return centers[y] + rng.normal(0, spread, (n, d)), y


def _latent(seed=5, n=600, d=10, k=6):
    """A (600, 10) latent space of 6 overlapping classes."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1.5, (k, d))
    y = rng.integers(0, k, n)
    return centers[y] + rng.normal(0, 1.0, (n, d)), y


DATA = {"blobs": _blobs, "latent": _latent,
        "binary": lambda: _blobs(seed=3, k=2)}


# ---------------------------------------------------------------------------
# The cluster cases of tests/test_eval_stack.py on the port, against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rf", "lda", "qda"])
def test_kfold_classifiers(kind):
    x, y = _blobs()
    acc, ref, pred = tca.kfold_classifier(x, {"true": y}, kfold=3, seed=0,
                                          kind=kind)
    assert np.mean(acc["true"]) > 0.9, kind
    jacc, jref, jpred = jca.kfold_classifier(x, {"true": y}, kfold=3,
                                             seed=0, kind=kind)
    assert acc == jacc
    for a, b in zip(ref["true"] + pred["true"], jref["true"] + jpred["true"]):
        np.testing.assert_array_equal(a, b)


def test_silhouette():
    x, y = _blobs()
    per_cluster, overall = tca.get_SilhScore(x, y)
    assert len(per_cluster) == 3
    assert overall > 0.5
    jper, jall = jca.get_SilhScore(x, y)
    np.testing.assert_allclose(per_cluster, jper, atol=TOL_SILH, rtol=0)
    assert overall == pytest.approx(jall, abs=TOL_SILH)


def test_k_selection_picks_consensus_jump():
    num_pruned = [10, 8, 6, 4]
    recon = [[5.0, 4.0, 3.0, 2.0]] * 2
    con = np.array([[0.5, 0.8, 0.97, 0.99]])
    _, _, ordered_cons, K = tca.K_selection(num_pruned, recon, con, thr=0.9)
    assert K in (6, 8)
    *_, K_none = tca.K_selection(num_pruned, recon, con, thr=0.999)
    assert K_none is None


def test_k_selection_single_qualifier_and_exact_threshold():
    num_pruned = [3, 9]
    recon = [[1.0, 0.5]]
    con = np.array([0.5, 0.97])
    *_, K = tca.K_selection(num_pruned, recon, con, thr=0.95)
    assert K == 9
    *_, K = tca.K_selection(num_pruned, recon, con, thr=0.97)
    assert K is None


@pytest.mark.parametrize("seed", range(4))
def test_k_selection_equals_jax(seed):
    rng = np.random.default_rng(seed)
    runs = 7
    num_pruned = rng.permutation(np.arange(4, 4 + 2 * runs, 2))
    recon = rng.random((3, runs))
    con = rng.uniform(0.85, 1.0, (2, runs))
    for thr in (0.9, 0.95, 0.99):
        got = tca.K_selection(num_pruned, recon, con, thr=thr)
        want = jca.K_selection(num_pruned, recon, con, thr=thr)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3]


# ---------------------------------------------------------------------------
# Each sklearn call the port replaces, against sklearn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,seed", [(150, 3, 0), (600, 5, 0), (10, 3, 7),
                                      (11, 4, 1), (12000, 3, 0), (5, 5, 2)])
def test_kfold_splits_equal_sklearn(n, k, seed):
    from sklearn.model_selection import KFold

    got = list(tca.kfold_splits(n, k, seed))
    want = list(KFold(n_splits=k, random_state=seed, shuffle=True)
                .split(np.zeros((n, 1))))
    assert len(got) == len(want) == k
    for (tr, te), (wtr, wte) in zip(got, want):
        np.testing.assert_array_equal(tr, wtr)
        np.testing.assert_array_equal(te, wte)


def test_kfold_splits_refuse_what_sklearn_refuses():
    with pytest.raises(ValueError):
        list(tca.kfold_splits(3, 4, 0))
    with pytest.raises(ValueError):
        list(tca.kfold_splits(10, 1, 0))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("data", sorted(DATA))
@pytest.mark.parametrize("kind", ["lda", "qda"])
def test_discriminant_predictions_equal_sklearn(kind, data, dtype):
    from sklearn.discriminant_analysis import (
        LinearDiscriminantAnalysis, QuadraticDiscriminantAnalysis)

    x, y = DATA[data]()
    x = x.astype(dtype)
    ours = tca._LDA() if kind == "lda" else tca._QDA(reg_param=1e-2)
    ref = (LinearDiscriminantAnalysis(store_covariance=True) if kind == "lda"
           else QuadraticDiscriminantAnalysis(reg_param=1e-2,
                                              store_covariance=True))
    for tr, te in tca.kfold_splits(len(x), 3, 0):
        got = ours.fit(x[tr], y[tr]).predict(x[te])
        want = ref.fit(x[tr], y[tr]).predict(x[te])
        np.testing.assert_array_equal(got, want)
    acc, _, _ = tca.kfold_classifier(x, {"y": y}, kfold=3, kind=kind)
    jacc, _, _ = jca.kfold_classifier(x, {"y": y}, kfold=3, kind=kind)
    assert acc == jacc


def test_discriminants_take_string_labels():
    from sklearn.discriminant_analysis import LinearDiscriminantAnalysis

    x, y = _latent()
    names = np.array([f"t{v:02d}" for v in y], dtype=object)
    got = tca._LDA().fit(x, names).predict(x)
    np.testing.assert_array_equal(
        got, LinearDiscriminantAnalysis().fit(x, names).predict(x))
    acc, _, pred = tca.kfold_classifier(x, {"n": names}, kfold=3, kind="qda")
    jacc, _, jpred = jca.kfold_classifier(x, {"n": names}, kfold=3,
                                          kind="qda")
    assert acc == jacc
    assert all(np.array_equal(a, b) for a, b in zip(pred["n"], jpred["n"]))


def test_qda_refuses_a_one_sample_class():
    x, y = _blobs()
    y = y.copy()
    y[0] = 9
    with pytest.raises(ValueError, match="only 1 sample"):
        tca._QDA().fit(x, y)


@pytest.mark.parametrize("data", sorted(DATA))
def test_silhouette_equals_sklearn(data):
    from sklearn.metrics import silhouette_samples, silhouette_score

    x, y = DATA[data]()
    got = tca.silhouette_samples(x, y)
    np.testing.assert_allclose(got, silhouette_samples(x, y), atol=TOL_SILH,
                               rtol=0)
    per, overall = tca.get_SilhScore(x, y)
    assert overall == pytest.approx(silhouette_score(x, y), abs=TOL_SILH)
    jper, _ = jca.get_SilhScore(x, y)
    np.testing.assert_allclose(per, jper, atol=TOL_SILH, rtol=0)
    # f32 data: sklearn rounds its distances to f32, the port does not
    x32 = x.astype(np.float32)
    np.testing.assert_allclose(tca.silhouette_samples(x32, y),
                               silhouette_samples(x32, y),
                               atol=TOL_SILH_F32, rtol=0)


def _silhouette_direct(x, labels):
    """The silhouette's definition over scipy's direct Euclidean distances:
    sklearn's expansion ‖x‖² − 2x·y + ‖y‖² leaves ~1e-7 between duplicate
    points, so duplicates are held to this."""
    from scipy.spatial.distance import cdist

    d = cdist(x, x)
    out = np.zeros(len(x))
    for i, li in enumerate(labels):
        own = labels == li
        if own.sum() == 1:
            continue
        a = d[i, own].sum() / (own.sum() - 1)
        b = min(d[i, labels == c].mean() for c in np.unique(labels)
                if c != li)
        out[i] = (b - a) / max(a, b)
    return out


def test_silhouette_singletons_duplicates_and_chunks(monkeypatch):
    """A singleton cluster scores 0, duplicate points are at distance 0,
    string labels, a tensor input, and row chunks of any size give the
    same scores."""
    x, y = _latent(n=200)
    x[5] = x[6]
    y = y.copy()
    y[7] = 99
    labels = np.array([f"c{v}" for v in y], dtype=object)
    got = tca.silhouette_samples(torch.as_tensor(x), labels)
    assert got[7] == 0.0
    np.testing.assert_allclose(got, _silhouette_direct(x, labels),
                               atol=1e-12, rtol=0)
    monkeypatch.setattr(tca, "_SILH_CHUNK_ELEMS", 200 * 7)
    np.testing.assert_allclose(tca.silhouette_samples(x, labels), got,
                               atol=1e-15, rtol=0)
    with pytest.raises(ValueError, match="Number of labels"):
        tca.silhouette_samples(x, np.zeros(len(x)))
    with pytest.raises(ValueError, match="Number of labels"):
        tca.silhouette_samples(x[:4], np.arange(4))


@pytest.mark.parametrize("num_pc", [1, 3, 5, 10])
def test_pca_transform_equals_sklearn(num_pc):
    from sklearn.decomposition import PCA

    x, _ = _latent()
    got = tca.pca_transform(x, num_pc).numpy()
    np.testing.assert_allclose(got, PCA(n_components=num_pc)
                               .fit_transform(x), atol=TOL_PCA, rtol=0)
    with pytest.raises(ValueError):
        tca.pca_transform(x, 11)


def test_cluster_compare_equals_jax(tmp_path):
    x, y = _latent()
    rng = np.random.default_rng(1)
    labels = {"true": y, "noisy": np.where(rng.random(len(y)) < 0.3,
                                           rng.integers(0, 6, len(y)), y)}
    fig, smp, sil, size = tca.cluster_compare(
        x, labels, num_pc=5, saving_path=str(tmp_path / "c.png"), plot=True)
    jfig, jsmp, jsil, jsize = jca.cluster_compare(x, labels, num_pc=5)
    assert fig is not None and (tmp_path / "c.png").exists()
    for a, b in zip(smp, jsmp):
        np.testing.assert_allclose(a, b, atol=TOL_SILH, rtol=0)
    np.testing.assert_allclose(sil, jsil, atol=TOL_SILH, rtol=0)
    for a, b in zip(size, jsize):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tca.cluster_compare(x, labels, num_pc=0)
    import matplotlib.pyplot as plt
    plt.close("all")


def test_rf_without_sklearn_names_scikit_learn(monkeypatch):
    x, y = _blobs()
    monkeypatch.setitem(sys.modules, "sklearn.ensemble", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        tca.kfold_classifier(x, {"y": y}, kfold=3, kind="rf")
    # the other kinds need no sklearn
    acc, _, _ = tca.kfold_classifier(x, {"y": y}, kfold=3, kind="lda")
    assert np.mean(acc["y"]) > 0.9
    with pytest.raises(ValueError, match="unknown"):
        tca.kfold_classifier(x, {"y": y}, kind="svm")


def test_wrappers_equal_jax():
    x, y = _latent()
    for name in ("RF_classifier", "LDA_classifier", "QDA_classifier"):
        acc, _, _ = getattr(tca, name)(x, {"y": y}, kfold=3, seed=2)
        jacc, _, _ = getattr(jca, name)(x, {"y": y}, kfold=3, seed=2)
        assert acc == jacc, name


# ---------------------------------------------------------------------------
# The example
# ---------------------------------------------------------------------------

def test_clusterability_study_equals_jax():
    x, y = _latent()
    rng = np.random.default_rng(4)
    pred = np.where(rng.random(len(y)) < 0.2, rng.integers(0, 6, len(y)), y)
    got = tclus.clusterability_study(x, pred, y, kfold=3, num_pc=4,
                                     device="cpu")
    want = jclus.clusterability_study(x, pred, y, kfold=3, num_pc=4)
    assert sorted(got) == sorted(want)
    for k in ("rf_accuracy", "lda_accuracy"):
        assert got[k] == want[k]
    for k in ("silhouette_discovered", "silhouette_reference"):
        assert got[k] == pytest.approx(want[k], abs=TOL_SILH)
    for k in want["silhouette_pca"]:
        assert got["silhouette_pca"][k] == pytest.approx(
            want["silhouette_pca"][k], abs=TOL_SILH)


def test_clusterability_cli_serves_a_checkpoint(tmp_path, capsys):
    import json

    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    cpl = CplMixVAE(saving_folder=str(tmp_path), device="cpu", seed=3)
    cpl.init_model(n_categories=6, input_dim=40, fc_dim=8, lowD_dim=4,
                   n_arm=2, batch_size=100)
    path = cpl.save_checkpoint("c")
    assert tclus.main(["--ckpt", path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    res = json.loads(out[out.index("{"):])
    assert sorted(res) == ["lda_accuracy", "rf_accuracy",
                           "silhouette_discovered", "silhouette_reference"]
    assert all(0.0 <= v <= 1.0 for d in ("rf_accuracy", "lda_accuracy")
               for v in res[d].values())
