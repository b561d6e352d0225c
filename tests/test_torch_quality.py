"""The port's quality surfaces: the marker-gene panels and augmenter data
iterator (dvae_tpu_torch/augment/genes.py) against the JAX package's, the
numpy adjusted mutual information (dvae_tpu_torch/eval/evaluate.py)
against sklearn's, ``cli train-augmenter``, and the four example scripts
(dvae_tpu_torch/examples/) at small sizes on the CPU.

The AMI is held to sklearn's within 1e-6 absolute: both sum the same
hypergeometric terms in float64; the port's window of ±(12σ + 25) around
each term's mean leaves out probabilities below e^-72.
"""

import json
import os

import numpy as np
import pytest
import torch
from sklearn.metrics import adjusted_mutual_info_score as sk_ami

from dvae_tpu.augment import genes as jgenes
from dvae_tpu.augment import augmenter as jaug
from dvae_tpu_torch import cli as tcli
from dvae_tpu_torch.augment import augmenter as taug
from dvae_tpu_torch.augment import genes as tgenes
from dvae_tpu_torch.eval.evaluate import adjusted_mutual_info_score
from dvae_tpu_torch.examples import (consensus_convergence, hard_augmenter,
                                     hard_synthetic, production_scale)
from dvae_tpu_torch.utils import checkpoint as tckpt


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# genes.py
# ---------------------------------------------------------------------------

def test_marker_panels_and_get_genes_match_jax():
    assert tgenes.additional_gene() == jgenes.additional_gene()
    for name in ("GLUTAMATERGIC_MARKERS", "GABA_MARKERS_1", "GABA_MARKERS_2"):
        assert getattr(tgenes, name) == getattr(jgenes, name)
    rng = np.random.default_rng(0)
    names = np.array(jgenes.additional_gene()
                     + [f"Gene{i}" for i in range(200)])
    gene_id = names[rng.permutation(len(names))][:150]
    for n_genes in (0, 3, 40, 150):
        np.testing.assert_array_equal(tgenes.get_genes(gene_id, n_genes),
                                      jgenes.get_genes(gene_id, n_genes))


@pytest.mark.parametrize("training", [True, False])
def test_get_data_gives_the_jax_batches(training):
    x = np.random.default_rng(1).random((53, 7)).astype(np.float32)
    want = list(jgenes.get_data(x, batch_size=10, training=training, seed=4))
    got = list(tgenes.get_data(x, batch_size=10, training=training, seed=4))
    assert len(got) == len(want) == 5   # the partial batch dropped
    for (tx, tb), (jx, jb) in zip(got, want):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tb, (tx > 0.1).astype(np.float32))


# ---------------------------------------------------------------------------
# The numpy AMI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,r,c", [(2000, 100, 100), (2000, 92, 12),
                                   (2000, 3, 100), (500, 10, 10),
                                   (60, 7, 3), (2, 2, 2)])
def test_ami_matches_sklearn(n, r, c):
    rng = np.random.default_rng(n + r + c)
    for _ in range(3):
        t = rng.integers(0, r, n)
        p = rng.integers(0, c, n)
        related = np.where(rng.random(n) < 0.6, t % c, p)
        for a, b in ((t, p), (t, related), (related, t)):
            assert abs(adjusted_mutual_info_score(a, b) - sk_ami(a, b)) \
                <= 1e-6


def test_ami_degenerate_labelings_follow_sklearn():
    rng = np.random.default_rng(2)
    some = rng.integers(0, 4, 30)
    cases = [
        (np.zeros(30, int), np.zeros(30, int)),        # one cluster each
        (np.zeros(30, int), some), (some, np.zeros(30, int)),
        (np.arange(30), np.arange(30)),                # all distinct
        (np.arange(30), some), (some, np.arange(30)),
        (some, some), (some, (some + 1) % 4),          # identical, renamed
        (np.array([5]), np.array([9])),                # N = 1
        (np.array(["b", "a", "b"]), np.array([1, 1, 2])),
    ]
    for a, b in cases:
        got = adjusted_mutual_info_score(a, b)
        assert isinstance(got, float)
        assert abs(got - sk_ami(a, b)) <= 1e-6, (a, b, got)
    with pytest.raises(ValueError):
        adjusted_mutual_info_score([1, 2], [1, 2, 3])


# ---------------------------------------------------------------------------
# cli train-augmenter
# ---------------------------------------------------------------------------

def test_cli_train_augmenter_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "aug.ckpt")
    assert tcli.main(["train-augmenter", "--device", "cpu", "--synthetic",
                      "--syn_cells", "90", "--syn_genes", "40",
                      "--syn_types", "4", "--n_epoch", "3",
                      "--batch_size", "30", "--n_dim", "20",
                      "--noise_dim", "6", "--z_dim", "4", "--gan_bf16",
                      "--lambda", "1", "0.5", "0.1", "0.5",
                      "--mode", "ZINB", "--out", out]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("=====> Epoch:") for line in lines) == 3
    assert lines[-1] == f"saved augmenter: {out}"
    _, _, cfg = taug.load_augmenter(out)
    assert (cfg.input_dim, cfg.n_dim, cfg.noise_dim, cfg.latent_dim,
            cfg.n_zim) == (40, 20, 6, 4, 2)
    # the JAX package reads it too
    assert jaug.load_augmenter(out)[2].n_zim == 2
    _, meta = tckpt.load_checkpoint(out)
    assert len(meta["history_tail"]) == 3


# ---------------------------------------------------------------------------
# The examples at small sizes
# ---------------------------------------------------------------------------

@pytest.fixture
def small_recipe(monkeypatch, tmp_path):
    """The recipes' sizes lowered; the dataset cache in a directory of the
    test's own."""
    monkeypatch.setattr(hard_synthetic, "N_CELLS", 400)
    monkeypatch.setattr(hard_synthetic, "N_GENES", 64)
    monkeypatch.setattr(hard_synthetic, "N_TYPES", 24)
    monkeypatch.setattr(hard_synthetic, "BATCH_SIZE", 88)
    monkeypatch.setattr(hard_synthetic, "EPOCHS_PER_JIT", 2)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    return tmp_path


def test_hard_synthetic_dataset_cache_is_the_ports_own(small_recipe):
    # a file under the JAX package's cache name is never read
    jax_name = small_recipe / "hard_syn_3_20000x5032x92.npz"
    np.savez(jax_name, log1p=np.zeros((2, 2)))
    ds = hard_synthetic._dataset(3, "cpu")
    cached = small_recipe / "hard_syn_torch_cpu_3_400x64x24.npz"
    assert cached.exists() and ds.log1p.shape == (400, 64)
    again = hard_synthetic._dataset(3, "cpu")
    np.testing.assert_array_equal(again.log1p, ds.log1p)
    np.testing.assert_array_equal(again.cluster_label, ds.cluster_label)


def _check_scores(out, n_arm=2):
    for key in ("ami_leaf", "ami_root"):
        assert len(out[key]) == n_arm
        assert all(isinstance(v, float) and -1.0 <= v <= 1.0
                   for v in out[key])
    assert -1.0 <= out["ami_arm_arm"] <= 1.0
    assert 0.0 <= out["test_consensus"] <= 1.0


def test_hard_synthetic_run_small(small_recipe):
    out = hard_synthetic.main([
        "--epochs", "4", "--seed", "3", "--device", "cpu",
        "--folder", str(small_recipe / "run"), "--categories", "24"])
    _check_scores(out)
    # scored at the best-consensus checkpoint, written after a chunk
    assert out["final_epoch"] in (2, 4) and out["aug_file"] is None


def test_hard_synthetic_run_small_pruning_zinb(small_recipe):
    out = hard_synthetic.run(n_epoch=2, mode="ZINB", n_categories=26,
                             n_epoch_p=2, max_prun_it=1, min_con=1.0,
                             folder=str(small_recipe / "prune"),
                             verbose=False, device="cpu")
    _check_scores(out)
    assert out["prune"]["max_prun_it"] == 1 and out["mode"] == "ZINB"


def test_hard_augmenter_feeds_hard_synthetic(small_recipe):
    ckpt = str(small_recipe / "art" / "augmenter_MSE.ckpt")
    summary = hard_augmenter.main([
        "--epochs", "10", "--batch_size", "150", "--epochs_per_jit", "4",
        "--device", "cpu", "--out", ckpt])
    assert summary["n_epochs"] == 10 and len(
        summary["recon_decile_means"]) == 10
    with open(os.path.splitext(ckpt)[0] + "_curves.json") as fh:
        curves = json.load(fh)["curves"]
    assert len(curves["mse_recon"]) == 10
    params, _, cfg = taug.load_augmenter(ckpt)
    assert cfg.input_dim == 64
    w = params["fc1"]["w"]
    # weights rounded to bf16, stored f32
    assert w.dtype == torch.float32 and torch.equal(
        w, w.to(torch.bfloat16).float())
    out = hard_synthetic.run(n_epoch=2, aug_file=ckpt, verbose=False,
                             folder=str(small_recipe / "aug"),
                             n_categories=24, device="cpu")
    _check_scores(out)
    assert out["aug_file"] == ckpt


def test_hard_augmenter_default_output_is_not_the_jax_artifacts():
    assert hard_augmenter._ART.endswith(os.path.join("artifacts", "torch"))


def test_production_scale_run_small(monkeypatch, tmp_path):
    monkeypatch.setattr(production_scale, "N_CELLS", 300)
    monkeypatch.setattr(production_scale, "N_GENES", 48)
    monkeypatch.setattr(production_scale, "N_TYPES", 6)
    monkeypatch.setattr(production_scale, "BATCH_SIZE", 88)
    monkeypatch.setattr(production_scale, "EPOCHS_PER_JIT", 2)
    out = production_scale.main(["--epochs", "4", "--folder",
                                 str(tmp_path / "prod"), "--device", "cpu"])
    assert len(out["ami_vs_truth"]) == 2
    assert all(-1.0 <= v <= 1.0 for v in out["ami_vs_truth"])
    assert out["categories_remaining"] == 6


def test_consensus_convergence_run_small(tmp_path):
    out = consensus_convergence.run(
        n_cells=300, n_genes=40, n_types=4, n_categories=4, batch_size=90,
        n_epoch=6, epochs_per_jit=3, folder=str(tmp_path / "cons"),
        verbose=False, device="cpu")
    # the last logged epoch's index, 0-based: 2 after an early stop at 3
    assert out["final_epoch"] in (2, 5)
    assert 0.0 <= out["train_consensus"] <= 1.0
    assert len(out["curve_tail"]) >= 1
