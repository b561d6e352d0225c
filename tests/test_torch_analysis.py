"""The PyTorch port's analysis surface against the JAX package: the helpers
of ``eval/metrics.py``, cross-run consensus (``evals2``, ``evals2_files``,
``compute_consensus_statistics``, ``mutinfo_oracle``), the logging and
tree helpers, ``analysis/tree_based.py``, ``analysis/tree_helpers.py`` and
the traversal study.

Inputs are made with numpy from a seed.  The numpy functions are copies of
the JAX package's numerics and are held to it within 1e-12 (most bit for
bit); labels and consensus matrices, which are counts, exactly.  The
traversal study runs JAX's model weights in both packages on JAX's noise,
rebuilt from its key splits (``tests/test_torch_api.py``), and is held at
rtol 1e-5 / atol 1e-6.  Checkpoints are written by the port's trainer at
small widths (A=3, D=64, F=16, L=4, C=6) and served by both packages on
the CPU.
"""

import os
import random
import sys
import types

import numpy as np
import pytest
import torch

import jax

import dvae_tpu.config as jcfg
from dvae_tpu.analysis import tree_based as jtree
from dvae_tpu.analysis import tree_helpers as jhelp
from dvae_tpu.eval import evaluate as jevaluate
from dvae_tpu.eval import metrics as jmetrics
from dvae_tpu.examples import state_traversal as jtrav
from dvae_tpu.models import mixvae as jmixvae
from dvae_tpu.utils import checkpoint as jckpt
from dvae_tpu.utils import logging as jlog

import dvae_tpu_torch.config as tcfg_mod
from dvae_tpu_torch.analysis import tree_based as ttree
from dvae_tpu_torch.analysis import tree_helpers as thelp
from dvae_tpu_torch.data.anndata_io import synthetic_dataset
from dvae_tpu_torch.eval import evaluate as tevaluate
from dvae_tpu_torch.eval import metrics as tmetrics
from dvae_tpu_torch.examples import state_traversal as ttrav
from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
from dvae_tpu_torch.utils import checkpoint as tckpt
from dvae_tpu_torch.utils import logging as tlog

A, D, F, L, C, S = 3, 64, 16, 4, 6, 2
DIMS = dict(n_arm=A, input_dim=D, fc_dim=F, lowD_dim=L, n_categories=C,
            state_dim=S)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _labels(seed, n=300, arms=A, K=C):
    return np.random.default_rng(seed).integers(0, K, size=(arms, n))


# ---------------------------------------------------------------------------
# eval/metrics.py helpers
# ---------------------------------------------------------------------------

def test_metric_helpers_match_jax():
    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.ones(C), size=(A, 50))
    np.testing.assert_array_equal(tmetrics.classify(probs),
                                  jmetrics.classify(probs))
    bias = np.array([0.5, 0.0, -1.0, 0.0, 2.0, 0.0])
    for got, want in zip(tmetrics.mk_masks(bias), jmetrics.mk_masks(bias)):
        np.testing.assert_array_equal(got, want)
    l1, l2 = _labels(1, 200, 2)
    np.testing.assert_array_equal(tmetrics.compute_confmat_naive(l1, l2),
                                  jmetrics.compute_confmat_naive(l1, l2))
    np.testing.assert_array_equal(tmetrics.compute_confmat_naive(l1, l2, 8),
                                  tmetrics.compute_confmat(l1, l2, 8))
    cm = tmetrics.compute_confmat(l1, l2, C + 2)   # two empty categories
    np.testing.assert_allclose(tmetrics.confmat_normalize_naive(cm),
                               jmetrics.confmat_normalize_naive(cm),
                               atol=1e-12)
    np.testing.assert_allclose(tmetrics.confmat_normalize_naive(cm),
                               tmetrics.confmat_normalize(cm), atol=1e-12)
    square = rng.random((7, 7))
    np.testing.assert_array_equal(tmetrics.reassign(square),
                                  jmetrics.reassign(square))
    np.testing.assert_array_equal(tmetrics.ecdf(l1), jmetrics.ecdf(l1))
    for name in ("cpl_mixVAE_model_epoch_40.ckpt", "a.b_epoch_7.pth",
                 "best_train.ckpt", "noext"):
        assert tmetrics.no_ext(name) == jmetrics.no_ext(name)
        assert tmetrics.parse_epoch(name) == jmetrics.parse_epoch(name)
    pairs = [("a", 1), ("b", 2)]
    assert (list(tmetrics.mapv(lambda v: v * 3, pairs))
            == list(jmetrics.mapv(lambda v: v * 3, pairs)))
    fs = (lambda v: v + 1, lambda v: v * 2, lambda v: v - 3)
    assert tmetrics.compose(*fs)(5) == jmetrics.compose(*fs)(5) == 5


def test_unstable_warns_like_jax():
    def f(v):
        return v + 1

    for mod in (tmetrics, jmetrics):
        with pytest.warns(FutureWarning, match="f\\(\\) is unstable"):
            assert mod.unstable(f)(1) == 2


def test_time_function_times_the_call():
    calls = []
    dt = tmetrics.time_function(lambda v, k=0: calls.append((v, k)), 3, k=4)
    assert calls == [(3, 4)] and dt >= 0.0


def test_set_seeds_seeds_torch_numpy_and_random(monkeypatch):
    monkeypatch.setenv("PYTHONHASHSEED", "0")
    jmetrics.set_seeds(123)
    want = (np.random.random(), random.random())
    tmetrics.set_seeds(123)
    assert (np.random.random(), random.random()) == want
    assert os.environ["PYTHONHASHSEED"] == "123"
    np.testing.assert_array_equal(
        torch.rand(3).numpy(),
        torch.rand(3, generator=torch.Generator().manual_seed(123)).numpy())


# ---------------------------------------------------------------------------
# Cross-run consensus
# ---------------------------------------------------------------------------

def test_evals2_matches_jax():
    la, lb = _labels(2), _labels(3)
    rng = np.random.default_rng(4)
    pa = rng.dirichlet(np.ones(C), size=(A, 300))
    pb = rng.dirichlet(np.ones(C), size=(A, 300))
    got = tevaluate.evals2(la, lb, pa, pb)
    want = jevaluate.evals2(la, lb, pa, pb)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-12, err_msg=k)
    assert "l2_between" not in tevaluate.evals2(la, lb, K=C)


def test_evals2_aligns_a_permuted_run():
    """A run against a copy of itself with its categories renamed: the
    between-run consensus of an arm with its own copy is 1 once the
    Hungarian alignment runs (the raw diagonal is not), while the
    within-run matrices (not aligned) equal each other.  Each category
    holds the same number of cells: the matrix is normalised by row j's and
    column j's sums before the alignment (the reference's order), so with
    unequal sizes a renamed copy scores just below 1."""
    rng = np.random.default_rng(5)
    la = np.stack([rng.permutation(np.repeat(np.arange(C), 70))
                   for _ in range(A)])
    perm = (np.arange(C) + 1) % C        # no category keeps its name
    lb = perm[la]
    out = tevaluate.evals2(la, lb, K=C)
    np.testing.assert_allclose(np.diag(out["between"]), 1.0, atol=1e-12)
    np.testing.assert_allclose(out["within_a"], out["within_b"], atol=1e-12)
    raw = tmetrics.confmat_mean(tmetrics.confmat_normalize(
        tmetrics.compute_confmat(la[0], lb[0], C)))
    assert raw == 0.0


def test_compute_consensus_statistics_matches_jax():
    runs = [_labels(s, 250) for s in (7, 8, 9)]
    got = tevaluate.compute_consensus_statistics(runs, C)
    want = jevaluate.compute_consensus_statistics(runs, C)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-12, err_msg=k)
    one = tevaluate.compute_consensus_statistics(runs[:1], C)
    assert one["mean_between"] == 1.0


def test_mutinfo_oracle_matches_jax_and_mutinfo():
    rng = np.random.default_rng(10)
    probs = rng.dirichlet(np.ones(C), size=120)
    targets = np.eye(4)[rng.integers(0, 4, size=120)].astype(int)
    got = tevaluate.mutinfo_oracle(probs, targets)
    np.testing.assert_allclose(got, jevaluate.mutinfo_oracle(probs, targets),
                               atol=1e-12)
    np.testing.assert_allclose(got, tevaluate.mutinfo(probs, targets),
                               atol=1e-10)


@pytest.fixture(scope="module")
def two_runs(tmp_path_factory):
    """Two checkpoints of the port's trainer, one trained two epochs."""
    x = synthetic_dataset(60, D, C, seed=12).log1p
    paths = []
    for seed, epochs in ((1, 0), (2, 2)):
        folder = str(tmp_path_factory.mktemp(f"run{seed}"))
        cpl = CplMixVAE(saving_folder=folder, device="cpu", seed=seed)
        cpl.init_model(**DIMS, batch_size=20, epochs_per_jit=1)
        if epochs:
            paths.append(cpl.train(x, n_epoch=epochs, early_stop_consensus=0,
                                   save_plots=False))
        else:
            paths.append(cpl.save_checkpoint("epoch_0"))
    return x, paths


def test_evals2_files_matches_jax(two_runs):
    x, (fa, fb) = two_runs
    got = tevaluate.evals2_files(fa, fb, x, batch_size=20, device="cpu")
    want = jevaluate.evals2_files(fa, fb, x, batch_size=20)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["labels_a"], want["labels_a"])
    np.testing.assert_array_equal(got["labels_b"], want["labels_b"])
    for k in ("within_a", "within_b", "between", "l2_between"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    # and it is evals2 of the two eval_model label sets
    res = []
    for f in (fa, fb):
        cpl = CplMixVAE(device="cpu")
        cpl.load_model(f)
        res.append(cpl.eval_model(x, batch_size=20)["pred_label"])
    again = tevaluate.evals2(*res, K=C)
    for k in ("within_a", "within_b", "between"):
        np.testing.assert_array_equal(got[k], again[k])
    no_probs = tevaluate.evals2_files(fa, fb, x, batch_size=20,
                                      with_probs=False, device="cpu")
    assert "l2_between" not in no_probs


# ---------------------------------------------------------------------------
# Logging
# ---------------------------------------------------------------------------

def test_logging_helpers_match_jax(capsys):
    assert tlog.is_master() == jlog.is_master() is True
    jlog.rprint("hello", 3)
    want = capsys.readouterr().out
    tlog.rprint("hello", 3)
    assert capsys.readouterr().out == want == "[proc 0] hello 3\n"
    jlog.dprint("dbg", color="red")
    want = capsys.readouterr().out
    tlog.dprint("dbg", color="red")
    assert capsys.readouterr().out == want
    for n in (0, 1024, 5 * 2 ** 20 + 3):
        assert tlog.bytes_to_mb(n) == jlog.bytes_to_mb(n)
    for xs in ([], [1.0, 2.5, 4.0], range(7)):
        assert tlog.avg(xs) == jlog.avg(xs)


def _fake_wandb(init_fail=False, groups=()):
    mod = types.ModuleType("wandb")
    mod.init_calls, mod.logged, mod.finished = [], [], 0

    def init(**kw):
        if init_fail:
            raise RuntimeError("wandb.init exploded")
        mod.init_calls.append(kw)

    def log(metrics, step=None):
        mod.logged.append((dict(metrics), step))

    def finish():
        mod.finished += 1

    class Api:
        def runs(self, project):
            return [types.SimpleNamespace(group=g) for g in groups]

    mod.init, mod.log, mod.finish, mod.Api = init, log, finish, Api
    return mod


@pytest.mark.parametrize("package", ["port", "jax"])
def test_metric_logger_forwards_to_wandb(package, monkeypatch, tmp_path):
    """The same calls reach wandb from either package's logger, the local
    history and JSONL file kept beside them."""
    mod = _fake_wandb(groups=["s-0", "s-1", None, "x-4"])
    monkeypatch.setitem(sys.modules, "wandb", mod)
    logger_cls = (tlog if package == "port" else jlog).MetricLogger
    lg = logger_cls(use_wandb=True, project="p", run_name="r",
                    config={"n_arm": 2}, jsonl_path=str(tmp_path / "m.jsonl"),
                    auto_group_prefix="s")
    lg.log({"train/loss": 1.5}, step=0)
    lg.finish()
    assert mod.init_calls == [{"project": "p", "name": "r", "group": "s-2",
                               "config": {"n_arm": 2}}]
    assert mod.logged == [({"train/loss": 1.5}, 0)] and mod.finished == 1
    assert lg.history[0]["train/loss"] == 1.5
    assert (tmp_path / "m.jsonl").read_text().count("\n") == 1


@pytest.mark.parametrize("package", ["port", "jax"])
def test_metric_logger_falls_back_without_wandb(package, monkeypatch,
                                                capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)   # import fails
    logger_cls = (tlog if package == "port" else jlog).MetricLogger
    lg = logger_cls(use_wandb=True)
    assert "falling back to local logging" in capsys.readouterr().out
    lg.log({"a": 1.0})
    lg.finish()
    assert lg.history[0]["a"] == 1.0


# ---------------------------------------------------------------------------
# Checkpoint tree helpers
# ---------------------------------------------------------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"fc1": {"w": rng.normal(size=(2, 3)).astype(np.float32),
                               "b": rng.normal(size=3).astype(np.float32)}},
            "count": np.asarray(3, np.int32),
            "extra": [rng.normal(size=2), (np.arange(4),)]}


def test_abstract_like_matches_jax():
    tree = _tree(0)
    want = jckpt.abstract_like(tree)
    got = tckpt.abstract_like(tree)
    wl = jax.tree_util.tree_leaves(want)
    gl = [leaf for _, leaf in tckpt._leaves_with_path(got)]
    assert len(wl) == len(gl)
    for w, g in zip(wl, gl):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
    t = torch.zeros((2, 5), dtype=torch.bfloat16)
    assert tckpt.abstract_like({"t": t})["t"].dtype == torch.bfloat16


def test_compare_pytrees_matches_jax():
    a, b = _tree(1), _tree(1)
    b["params"]["fc1"]["w"] = b["params"]["fc1"]["w"] + 1e-3
    b["extra"][1] = (np.arange(4) + 1,)
    for rtol, atol in ((0.0, 0.0), (0.0, 1e-2)):
        got = tckpt.compare_pytrees(a, b, rtol, atol)
        assert got == jckpt.compare_pytrees(a, b, rtol, atol)
    assert got["mismatched_paths"] == ["['extra'][1][0]"]
    c = dict(_tree(1), more=np.ones(1))
    assert (tckpt.compare_pytrees(a, c)
            == jckpt.compare_pytrees(a, c)
            == {"match": False, "structure_equal": False,
                "mismatched_paths": ["<tree structure differs>"]})
    port = {"params": {k: torch.from_numpy(v) for k, v
                       in a["params"]["fc1"].items()}}
    assert tckpt.compare_pytrees(port, {"params": a["params"]["fc1"]}
                                 )["match"]


# ---------------------------------------------------------------------------
# analysis/tree_based.py and analysis/tree_helpers.py
# ---------------------------------------------------------------------------

def test_corr_analysis_matches_jax_and_the_scipy_loop():
    rng = np.random.default_rng(13)
    state = rng.normal(0, 1, (80, 2))
    cell = np.maximum(rng.normal(0.5, 1, (80, 15)), 0)
    cell[:, 3] = 0.0
    cell[:3, 5], cell[3:, 5] = 1.0, 0.0     # fewer than 5 nonzero cells
    np.testing.assert_array_equal(ttree.masked_pearson(state[:, 0], cell),
                                  jtree.masked_pearson(state[:, 0], cell))
    for got, want in zip(ttree.corr_analysis(state, cell),
                         jtree.corr_analysis(state, cell)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    fast, _ = ttree.corr_analysis(state, cell)
    slow, _ = ttree.corr_analysis_naive(state, cell)
    jslow, _ = jtree.corr_analysis_naive(state, cell)
    for f, s, j in zip(fast, slow, jslow):
        np.testing.assert_allclose(f, s, atol=1e-10)
        np.testing.assert_array_equal(s, j)


def test_get_merged_types_waits_for_the_taxonomy_slice():
    with pytest.raises(NotImplementedError, match="A9b"):
        ttree.get_merged_types("tree.csv", ["a", "b"])


def _cv_fixture(tmp_path):
    import scipy.io as sio
    rng = np.random.default_rng(14)
    n_ref, n_tr, n_val, z = 40, 20, 8, 3
    refdata = {
        "cluster_color": np.array(["#808080" if i % 4 == 0 else f"#c{i:05d}"
                                   for i in range(n_ref)], dtype=object),
        "cluster": np.array([f"t{i % 5}" for i in range(n_ref)],
                            dtype=object),
        "clusterID": np.arange(n_ref),
        "T_ispaired": (np.arange(n_ref) % 2 == 0).astype(int),
        "E_ispaired": (np.arange(n_ref) % 2 == 0).astype(int),
        "T_dat": rng.normal(0, 1, (n_ref, 6)),
        "E_dat": rng.normal(0, 1, (n_ref, 4))}
    mat = {"z_train_0": rng.normal(0, 1, (n_tr, z)),
           "z_train_1": rng.normal(0, 1, (n_tr, z)),
           "z_val_0": rng.normal(0, 1, (n_val, z)),
           "z_val_1": rng.normal(0, 1, (n_val, z)),
           "train_ind_T": np.arange(n_tr), "train_ind_E": np.arange(n_tr),
           "val_ind": np.arange(n_tr, n_tr + n_val)}
    path = str(tmp_path / "cv.mat")
    sio.savemat(path, mat)
    return path, refdata


def _assert_dicts_equal(got, want):
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_cvfolds_match_jax(tmp_path):
    path, refdata = _cv_fixture(tmp_path)
    _assert_dicts_equal(thelp.get_cvfold(path, refdata),
                        jhelp.get_cvfold(path, refdata))
    for full in (False, True):
        _assert_dicts_equal(
            thelp.get_cvfold_extended(path, refdata, full_data=full),
            jhelp.get_cvfold_extended(path, refdata, full_data=full))


def _blobs(rng, n):
    centers = {"A": [0, 0], "B": [6, 0], "C": [0, 6], "D": [6, 6]}
    labels = rng.choice(list(centers), n)
    labels[:3] = "D"          # a class too small to fit: excluded
    labels[3:] = np.where(labels[3:] == "D", "A", labels[3:])
    z = np.array([centers[lb] for lb in labels]) + rng.normal(0, .5, (n, 2))
    return z, labels.astype(object)


def test_leaf_classifiers_match_jax():
    rng = np.random.default_rng(15)
    z_tr, y_tr = _blobs(rng, 300)
    z_te, y_te = _blobs(rng, 100)
    got = thelp.custom_QDA(z_tr, y_tr, z_te, y_te.copy())
    want = jhelp.custom_QDA(z_tr, y_tr, z_te, y_te.copy())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    kw = dict(unique_dataset_lbl=["A", "BC", "D"],
              unique_leaf_lbl=["A", "B", "C", "D"],
              descendant_dict={"BC": ["B", "C"], "A": []},
              label_weight=[1.0, 0.5, 2.0, 1.0])
    got = thelp.predict_leaf_gmm(z_tr, y_tr, z_te, list(y_te), **kw)
    want = jhelp.predict_leaf_gmm(z_tr, y_tr, z_te, list(y_te), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_cca_projections_match_jax(tmp_path):
    """sklearn is imported inside the function only (the card machine has
    none), so this runs here."""
    path, refdata = _cv_fixture(tmp_path)
    _, _, tr_leaf, val_leaf = thelp.get_cvfold(path, refdata)
    got = thelp.get_cca_projections(tr_leaf, val_leaf, n_components=2)
    want = jhelp.get_cca_projections(tr_leaf, val_leaf, n_components=2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-12)


# ---------------------------------------------------------------------------
# The traversal study
# ---------------------------------------------------------------------------

def test_traversal_study_matches_jax():
    jc = jcfg.VAEConfig(**DIMS, tau=0.1)
    tc = tcfg_mod.VAEConfig(**DIMS, tau=0.1)
    params = jax.tree_util.tree_map(
        np.asarray, jmixvae.init_params(jax.random.key(4), jc))
    bn = jax.tree_util.tree_map(np.asarray, jmixvae.init_bn_state(jc))
    x = synthetic_dataset(16, D, C, seed=16).log1p
    n_samp = 9
    key = jax.random.key(17)
    want = jtrav.traversal_study(jc, params, bn, x, d_s=1, n_samp=n_samp,
                                 key=key)
    _, k_rest = jax.random.split(key)
    ak = jax.random.split(k_rest, (A, 3))
    noise = np.stack([np.asarray(jax.random.normal(ak[a, 1], (16, S)))
                      for a in range(A)])
    draws = np.stack([np.asarray(jax.random.normal(k, (A, 16)))
                      for k in jax.random.split(key, n_samp)])
    got = ttrav.traversal_study(
        tc, tckpt.params_from_jax(params), tckpt.bn_from_jax(bn), x, d_s=1,
        n_samp=n_samp, noise=torch.from_numpy(noise),
        draws=torch.from_numpy(draws))
    assert set(got) == set(want)
    for k in ("recon", "s_vals"):
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    # |r| in [0, 1] from f64 sums over f32 reconstructions that differ at
    # 1e-6: absolute 1e-5
    np.testing.assert_allclose(got["gene_corr_sorted"],
                               want["gene_corr_sorted"], atol=1e-5)
    assert got["gene_order"].shape == (D,)
    assert sorted(got["gene_order"]) == list(range(D))


def test_state_traversal_main_on_a_checkpoint(tmp_path, capsys):
    cpl = CplMixVAE(saving_folder=str(tmp_path), device="cpu", seed=3)
    cpl.init_model(**DIMS, batch_size=16)
    path = cpl.save_checkpoint("t")
    assert ttrav.main(["--ckpt", path, "--n_samp", "4", "--device",
                       "cpu"]) == 0
    out = capsys.readouterr().out
    assert "top responding genes" in out and "max |corr|" in out
    assert ttrav.main(["--n_samp", "3", "--device", "cpu"]) == 0
