"""The PyTorch port's real-data input against the JAX package: the .h5ad
readers and writers and ``load_data`` (dvae_tpu_torch/data/anndata_io.py),
``get_paths``, ``logcpm`` and ``reorder_genes`` (utils/tools.py), the host
loaders ``BatchIterator`` and ``get_loaders`` (data/pipeline.py), and the
command line that reads a dataset named by a TOML.

The inputs are the committed fixtures (tests/fixtures/: the anndata>=0.8
layout with a CSR X and the 0.7.x vintage, with their values in
expected.json), files each package writes for the other, and numpy draws
from seeds.  Every comparison is exact: both packages run the same numpy
and h5py code on the same bytes.
"""

import json
import os

import numpy as np
import pytest

from dvae_tpu.data import anndata_io as janndata
from dvae_tpu.data import pipeline as jpipeline
from dvae_tpu.utils import tools as jtools

from dvae_tpu_torch import cli as tcli
from dvae_tpu_torch.data import anndata_io as tanndata
from dvae_tpu_torch.data import pipeline as tpipeline
from dvae_tpu_torch.utils import tools as ttools

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
FIXTURES = ["tiny_modern_csr.h5ad", "tiny_legacy07.h5ad"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(FIXDIR, "expected.json")) as f:
        return json.load(f)


def _same_dataset(got, want):
    for k in ("log1p", "gene_id", "cluster_label", "cluster_id", "c_onehot",
              "c_p"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), k)
    assert got.n_type == want.n_type
    assert sorted(got.obs) == sorted(want.obs)
    for k in want.obs:
        np.testing.assert_array_equal(got.obs[k], want.obs[k], k)


@pytest.mark.parametrize("fname", FIXTURES)
def test_read_h5ad_arrays_matches_jax_and_the_expected_values(fname,
                                                              expected):
    path = os.path.join(FIXDIR, fname)
    X, genes, obs = tanndata.read_h5ad_arrays(path)
    jX, jgenes, jobs = janndata.read_h5ad_arrays(path)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(genes, jgenes)
    assert sorted(obs) == sorted(jobs)
    for k in jobs:
        np.testing.assert_array_equal(obs[k], jobs[k])
    np.testing.assert_array_equal(X, np.asarray(expected["X"], np.float32))
    assert X.dtype == np.float32
    assert list(genes) == expected["genes"]
    assert list(obs["cluster"]) == expected["cluster"]
    assert [int(v) for v in obs["depth"]] == expected["depth"]
    assert list(obs["cell_id"]) == [f"cell_{i}" for i in range(expected["n"])]


@pytest.mark.parametrize("fname", FIXTURES)
@pytest.mark.parametrize("kw", [dict(min_num=1), dict(n_gene=5, min_num=1),
                                dict(rmv_type=["type_b"], min_num=1),
                                dict(gene_id=["Gene-007", "Gene-002"],
                                     min_num=1)],
                         ids=["all", "n_gene", "rmv_type", "gene_id"])
def test_load_data_matches_jax(fname, kw, expected):
    path = os.path.join(FIXDIR, fname)
    got = tanndata.load_data(path, verbose=False, **kw)
    want = janndata.load_data(path, verbose=False, **kw)
    _same_dataset(got, want)
    assert got.log1p.dtype == np.float32
    assert got.n_cells == want.n_cells and got.n_genes == want.n_genes
    if kw == dict(min_num=1):
        assert got.n_cells == expected["n"] and got.n_genes == expected["d"]
    if "rmv_type" in kw:
        assert "type_b" not in set(got.cluster_label)
    d = got.as_dict()
    assert d["n_type"] == got.n_type and d["log1p"] is got.log1p
    assert set(d) >= {"cluster_id", "c_onehot", "c_p", "gene_id", "depth"}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("layout", ["dense", "csr", "csc", "legacy",
                                    "legacy_sparse"])
def test_files_written_by_one_package_read_by_the_other(writer, layout,
                                                        tmp_path):
    r = np.random.default_rng(5)
    n, d = 30, 9
    X = (r.gamma(1.5, 1.0, (n, d)) * (r.random((n, d)) > 0.6)).astype(
        np.float32)
    labels = np.array([f"t{i % 3}" for i in range(n)])
    genes = np.array([f"g{j}" for j in range(d)])
    obs = {"depth": np.arange(n, dtype=np.int64) * 7}
    mod = tanndata if writer == "port" else janndata
    reader = janndata if writer == "port" else tanndata
    path = str(tmp_path / f"{layout}.h5ad")
    if layout.startswith("legacy"):
        mod.write_h5ad_legacy07(path, X, genes, labels, obs=obs,
                                sparse=layout == "legacy_sparse")
    else:
        mod.write_h5ad(path, X, genes, labels, obs=obs,
                       sparse=None if layout == "dense" else layout)
    gX, ggenes, gobs = reader.read_h5ad_arrays(path)
    np.testing.assert_array_equal(gX, X)
    np.testing.assert_array_equal(ggenes, genes)
    np.testing.assert_array_equal(gobs["cluster"], labels)
    np.testing.assert_array_equal(gobs["depth"], obs["depth"])
    # the same file through both loaders
    _same_dataset(tanndata.load_data(path, verbose=False, min_num=1),
                  janndata.load_data(path, verbose=False, min_num=1))


@pytest.mark.parametrize("min_num", [1, 5, 9])
def test_load_data_drops_small_types_like_jax(min_num, tmp_path):
    """Types with fewer than ``min_num`` cells leave the dataset, their
    rows and obs with them (20, 8 and 3 cells of three types)."""
    r = np.random.default_rng(9)
    labels = np.array(["a"] * 20 + ["b"] * 8 + ["c"] * 3)
    r.shuffle(labels)
    X = r.random((len(labels), 6)).astype(np.float32)
    path = tanndata.write_h5ad(str(tmp_path / "imbalanced.h5ad"), X,
                               [f"g{j}" for j in range(6)], labels,
                               obs={"depth": np.arange(len(labels))},
                               sparse="csr")
    got = tanndata.load_data(path, verbose=False, min_num=min_num)
    _same_dataset(got, janndata.load_data(path, verbose=False,
                                          min_num=min_num))
    kept = {1: "abc", 5: "ab", 9: "a"}[min_num]
    assert set(got.cluster_label) == set(kept)
    assert got.n_cells == sum(int(np.sum(labels == k)) for k in kept)
    np.testing.assert_array_equal(got.log1p, X[np.isin(labels, list(kept))])


def test_get_paths_on_the_repositorys_toml(monkeypatch):
    monkeypatch.chdir(REPO)
    ttools.get_paths.cache_clear()
    jtools.get_paths.cache_clear()
    for section in ("mouse_smartseq", "synthetic", "files"):
        got = ttools.get_paths("dvae.toml", sub_file=section)
        want = jtools.get_paths("dvae.toml", sub_file=section)
        assert got == want
    got = ttools.get_paths("dvae.toml", sub_file="mouse_smartseq")
    assert got["mouse_smartseq"]["anndata_file"] == "Mouse_ALM-VISp_cpm.h5ad"
    assert str(got["paths"]["main_dir"]) == REPO
    assert ttools.get_paths("absent.toml") == {}
    ttools.get_paths.cache_clear()
    jtools.get_paths.cache_clear()


def test_logcpm_and_reorder_genes_match_jax():
    r = np.random.default_rng(3)
    counts = r.poisson(2.0, (40, 2500)).astype(np.float64)
    counts[3] = 0.0  # an empty cell: its row stays 0
    np.testing.assert_array_equal(ttools.normalize_cellxgene(counts),
                                  jtools.normalize_cellxgene(counts))
    x = ttools.logcpm(counts)
    np.testing.assert_array_equal(x, jtools.logcpm(counts))
    assert np.all(x[3] == 0.0)
    x = x * (r.random(x.shape) > 0.7)
    got = ttools.reorder_genes(x, chunksize=1000)
    np.testing.assert_array_equal(got, jtools.reorder_genes(x,
                                                            chunksize=1000))
    assert len(got) > 0


@pytest.mark.parametrize("label", [True, False], ids=["stratified",
                                                      "uniform"])
def test_get_loaders_give_the_jax_packages_batches(label):
    r = np.random.default_rng(2)
    data = r.random((97, 6)).astype(np.float32)
    labels = r.integers(0, 4, 97).astype(str) if label else ()
    got = tpipeline.get_loaders(data, labels, seed=5, batch_size=16)
    want = jpipeline.get_loaders(data, labels, seed=5, batch_size=16)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for epoch in range(2):
            for (gx, gi), (wx, wi) in zip(g, w):
                np.testing.assert_array_equal(gx, wx)
                np.testing.assert_array_equal(gi, wi)
    it = tpipeline.BatchIterator(data, np.arange(97), 10, seed=1)
    jt = jpipeline.BatchIterator(data, np.arange(97), 10, seed=1)
    it.set_epoch(4)
    jt.set_epoch(4)
    assert [i.tolist() for _, i in it] == [i.tolist() for _, i in jt]
    # the distributed sampler: each rank's wrap-padded slices, as in JAX
    for rank in range(2):
        got = tpipeline.get_loaders(data, labels, seed=5, batch_size=16,
                                    use_dist_sampler=True, world_size=2,
                                    rank=rank)
        want = jpipeline.get_loaders(data, labels, seed=5, batch_size=16,
                                     use_dist_sampler=True, world_size=2,
                                     rank=rank)
        for g, w in zip(got, want):
            assert len(g) == len(w)
            for (gx, gi), (wx, wi) in zip(g, w):
                np.testing.assert_array_equal(gx, wx)
                np.testing.assert_array_equal(gi, wi)


def _toml(tmp_path, anndata_file):
    (tmp_path / "data").mkdir(exist_ok=True)
    (tmp_path / "run.toml").write_text(
        "[paths]\nmain_dir = \".\"\n\n[tiny]\n"
        f"anndata_file = \"{anndata_file}\"\ndata_path = \"data/\"\n")


@pytest.mark.parametrize("fname", FIXTURES)
def test_cli_load_dataset_reads_the_toml_and_falls_back_like_jax(
        fname, tmp_path, monkeypatch):
    """``--toml``/``--dataset``/``--n_gene`` read the fixture the TOML
    names, as ``dvae_tpu.cli._load_dataset`` does on the same arguments; a
    section whose file is absent, or ``--synthetic``, gives the synthetic
    dataset, as there."""
    import shutil
    from dvae_tpu import cli as jcli
    os.makedirs(tmp_path / "data")
    shutil.copy(os.path.join(FIXDIR, fname), tmp_path / "data")
    _toml(tmp_path, fname)
    monkeypatch.chdir(tmp_path)
    ttools.get_paths.cache_clear()
    jtools.get_paths.cache_clear()
    for extra in (["--n_gene", "7"], ["--synthetic"],
                  ["--dataset", "absent"]):
        argv = ["train", "--toml", "run.toml", "--dataset", "tiny",
                "--syn_cells", "30", "--syn_genes", "8", *extra]
        args = tcli.build_parser().parse_args(argv)
        got = tcli._load_dataset(args)
        _same_dataset(got, jcli._load_dataset(args))
        if extra == ["--n_gene", "7"]:
            assert got.n_genes == 7 and got.n_cells == 40
        else:
            assert (got.n_cells, got.n_genes) == (30, 8)  # synthetic
    ttools.get_paths.cache_clear()
    jtools.get_paths.cache_clear()


def _train_argv(tmp_path, *extra):
    return ["train", "--device", "cpu", "--toml", "run.toml", "--dataset",
            "tiny", "--n_categories", "4", "--n_arm", "2", "--fc_dim", "8",
            "--latent_dim", "4", "--batch_size", "16", "--n_epoch", "2",
            "--epochs_per_jit", "1", "--saving_folder",
            str(tmp_path / "runs") + "/", *extra]


@pytest.mark.parametrize("stream", [False, True], ids=["resident", "stream"])
def test_cli_trains_on_the_fixture_the_toml_names(stream, tmp_path,
                                                  monkeypatch):
    """``cli train --toml`` on the modern fixture (40 cells, 12 genes), the
    batches resident or streamed (``--stream``): the run trains, its
    checkpoint records the mode and the data's width."""
    from dvae_tpu_torch.utils import checkpoint as tckpt
    import shutil
    os.makedirs(tmp_path / "data")
    shutil.copy(os.path.join(FIXDIR, FIXTURES[0]), tmp_path / "data")
    _toml(tmp_path, FIXTURES[0])
    monkeypatch.chdir(tmp_path)
    ttools.get_paths.cache_clear()
    extra = ["--stream"] if stream else []
    assert tcli.main(_train_argv(tmp_path, *extra)) == 0
    ckpts = sorted((tmp_path / "runs").glob("*/cpl_mixVAE_model_epoch_2"
                                             ".ckpt"))
    assert len(ckpts) == 1
    tree, meta = tckpt.load_checkpoint(str(ckpts[0]))
    assert meta["tcfg"]["stream"] is stream
    assert meta["cfg"]["input_dim"] == 12 and meta["epoch"] == 2
    ttools.get_paths.cache_clear()
