"""The PyTorch port's single-device tools against the JAX package:
``data/prep.py``, ``utils/host_ops.py`` (the numpy twins of the native
host metrics, and ``gather_rows``' ``n_threads``), ``utils/profiling.py``,
``utils/parser.py`` and ``utils/backend_probe.py``.

Mirrored: the ``StepTimer``, ``memory_snapshot`` and parser cases of
``tests/test_api_utils.py`` and ``tests/test_analysis_extras.py``, the
``synthetic_h5ad`` case of
``tests/test_pipeline.py`` and the probe cases of
``tests/test_backend_guard.py`` that do not run ``bench.py`` (each under a
private ``DVAE_PROBE_PIDFILE`` and temporary directory).  Tolerances: the
data preparation bit for bit; the host ops' counts exact and every other
value within 1e-12 (against JAX's numpy paths always, against the native
library only where ``dvae_tpu.utils.host_ops.available()``: those cases
alone skip without it).
"""

import json
import os
import subprocess
import sys
import tempfile

import h5py
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dvae_tpu.data import anndata_io as jio
from dvae_tpu.data import prep as jprep
from dvae_tpu.eval import evaluate as jev
from dvae_tpu.eval import metrics as jmetrics
from dvae_tpu.utils import host_ops as jho
from dvae_tpu.utils import parser as jparser

from dvae_tpu_torch.data import anndata_io as tio
from dvae_tpu_torch.data import prep as tprep
from dvae_tpu_torch.eval import evaluate as tev
from dvae_tpu_torch.utils import backend_probe as bp
from dvae_tpu_torch.utils import host_ops as tho
from dvae_tpu_torch.utils import parser as tparser
from dvae_tpu_torch.utils import profiling as tprof

TOL = 1e-12


def _native():
    if not jho.available():
        pytest.skip("native/libhost_ops.so does not load here")


@pytest.fixture
def numpy_metrics(monkeypatch):
    """JAX's metrics on their numpy path (no native library)."""
    monkeypatch.setattr(jmetrics, "_host_ops", None)
    monkeypatch.setattr(jho, "has_emi", lambda: False)


def _labels(seed=0, A=4, N=3000, K=7):
    return np.random.default_rng(seed).integers(0, K, (A, N))


# ---------------------------------------------------------------------------
# Fault C14: gather_rows takes the JAX function's n_threads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
def test_gather_rows_takes_n_threads(out_dtype):
    import inspect
    param = inspect.signature(tho.gather_rows).parameters["n_threads"]
    assert param.default == 0
    rng = np.random.default_rng(3)
    x = rng.normal(size=(50, 9)).astype(np.float32)
    sel = rng.integers(0, 50, 17)
    want = tho.gather_rows(x, sel, out_dtype)
    for got in (tho.gather_rows(x, sel, out_dtype, n_threads=3),
                tho.gather_rows(x, sel, out_dtype, 3),
                tho.gather_rows(torch.from_numpy(x), sel, out_dtype, 1)):
        assert got.dtype == want.dtype
        assert torch.equal(got.view(torch.int16) if out_dtype else got,
                           want.view(torch.int16) if out_dtype else want)


# ---------------------------------------------------------------------------
# The host-op twins
# ---------------------------------------------------------------------------

def test_no_native_library():
    assert tho.available() is False
    assert tho.has_emi() is False
    assert tho.has_gather() is False


@pytest.mark.parametrize("K", [1, 7, 30])
def test_confmat_equals_the_naive_loop(K):
    l1, l2 = _labels(K, 2, 2000, K)
    got = tho.confmat(l1, l2, K)
    assert got.dtype == np.float64 and got.shape == (K, K)
    assert np.array_equal(got, jmetrics.compute_confmat_naive(l1, l2, K))


def test_confmat_skips_labels_out_of_range_and_checks_lengths():
    l1 = np.array([0, 1, 2, -1, 5, 1])
    l2 = np.array([0, 1, 3, 1, 0, -2])
    want = np.zeros((4, 4))
    want[0, 0] = want[1, 1] = want[2, 3] = 1
    assert np.array_equal(tho.confmat(l1, l2, 4), want)
    with pytest.raises(ValueError, match="length mismatch"):
        tho.confmat(l1, l2[:5], 4)


def test_confmat_matches_native():
    _native()
    l1 = np.array([0, 1, 2, -1, 5, 1, 3, 3])
    l2 = np.array([0, 1, 3, 1, 0, -2, 3, 2])
    assert np.array_equal(tho.confmat(l1, l2, 4), jho.confmat(l1, l2, 4))
    l1, l2 = _labels(1, 2, 5000, 12)
    assert np.array_equal(tho.confmat(l1, l2, 12), jho.confmat(l1, l2, 12))
    with pytest.raises(ValueError):
        jho.confmat(l1, l2[:10], 12)


@pytest.mark.parametrize("kind", ["counts", "float", "empty_row"])
def test_confmat_normalize_equals_the_naive(kind):
    rng = np.random.default_rng(2)
    cm = (rng.integers(0, 50, (9, 9)).astype(np.float64) if kind != "float"
          else rng.random((9, 9)))
    if kind == "empty_row":
        cm[3, :] = 0
        cm[:, 3] = 0
    got = tho.confmat_normalize(cm)
    np.testing.assert_allclose(got, jmetrics.confmat_normalize_naive(cm),
                               rtol=0, atol=TOL)
    assert not np.shares_memory(got, cm)
    if kind == "empty_row":
        assert not got[:, 3].any()


def test_confmat_normalize_matches_native():
    _native()
    cm = np.random.default_rng(4).random((11, 11))
    cm[2] = 0
    cm[:, 2] = 0
    np.testing.assert_allclose(tho.confmat_normalize(cm),
                               jho.confmat_normalize(cm), rtol=0, atol=TOL)


@pytest.mark.parametrize("A", [1, 2, 5])
def test_pairwise_consensus_equals_the_numpy_sums(A, numpy_metrics):
    labels = _labels(A, A, 4000, 9)
    mean, scores = tho.pairwise_consensus(labels, 9)
    assert scores.shape == (A, A) and np.array_equal(np.diag(scores),
                                                     np.ones(A))
    np.testing.assert_allclose(scores, scores.T, rtol=0, atol=0)
    for a in range(A):
        for b in range(a + 1, A):
            want = jmetrics.confmat_mean(jmetrics.confmat_normalize_naive(
                jmetrics.compute_confmat_naive(labels[a], labels[b], 9)))
            assert abs(scores[a, b] - want) <= TOL
    assert abs(mean - jmetrics.consensus_from_labels(labels, 9)) <= TOL
    if A == 1:
        assert mean == 1.0


@pytest.mark.parametrize("A", [1, 2, 5])
def test_per_category_agreement_equals_the_numpy_sums(A, numpy_metrics):
    labels = _labels(10 + A, A, 4000, 9)
    got = tho.per_category_agreement(labels, 9)
    np.testing.assert_allclose(got, jmetrics.per_category_agreement(labels, 9),
                               rtol=0, atol=TOL)


def test_consensus_twins_match_native():
    _native()
    labels = _labels(7, 5, 20000, 13)
    mean, scores = tho.pairwise_consensus(labels, 13)
    nmean, nscores = jho.pairwise_consensus(labels, 13)
    assert abs(mean - nmean) <= TOL
    np.testing.assert_allclose(scores, nscores, rtol=0, atol=TOL)
    np.testing.assert_allclose(tho.per_category_agreement(labels, 13),
                               jho.per_category_agreement(labels, 13),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("N", [40, 3000])
def test_emi_binary_equals_the_emi_cell_sum(N):
    """On marginals in [1, N - 1], the domain of JAX's numpy sum (its
    ``mutinfo`` counts each reference type and cluster at least once)."""
    rng = np.random.default_rng(N)
    tf = np.concatenate([[1, N - 1], rng.integers(1, N, 12)])
    pc = np.concatenate([[1, N - 1], rng.integers(1, N, 6)])
    T = jev._lngamma_table(N)
    want = (jev._emi_cell(tf[:, None], pc[None, :], N, T)
            + jev._emi_cell(tf[:, None], N - pc[None, :], N, T)
            + jev._emi_cell(N - tf[:, None], pc[None, :], N, T)
            + jev._emi_cell(N - tf[:, None], N - pc[None, :], N, T))
    got = tho.emi_binary(tf, pc, N)
    assert got.shape == (len(tf), len(pc))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_emi_binary_of_empty_and_full_marginals_is_zero():
    """A marginal of 0 or N fixes the table: no expected MI, as the C++
    gives (a cell with a or b = 0 contributes 0)."""
    N = 500
    got = tho.emi_binary(np.array([0, N, 7]), np.array([0, 3, N, 250]), N)
    np.testing.assert_allclose(got[:2], 0.0, rtol=0, atol=TOL)
    np.testing.assert_allclose(got[:, [0, 2]], 0.0, rtol=0, atol=TOL)
    assert got[2, 1] > 0 and np.isfinite(got).all()


def test_emi_binary_matches_native():
    _native()
    if not jho.has_emi():
        pytest.skip("the native library has no emi_binary")
    rng = np.random.default_rng(8)
    N = 5000
    tf = np.concatenate([[0, N], rng.integers(0, N, 20)])
    pc = np.concatenate([[0, N], rng.integers(0, N, 9)])
    np.testing.assert_allclose(tho.emi_binary(tf, pc, N),
                               jho.emi_binary(tf, pc, N), rtol=0, atol=TOL)


def test_mutinfo_goes_through_emi_binary(numpy_metrics, monkeypatch):
    """``eval.evaluate.mutinfo`` takes its E[MI] from the twin and still
    equals JAX's numpy path."""
    rng = np.random.default_rng(5)
    probs = rng.random((600, 6))
    targets = np.eye(4)[rng.integers(0, 4, 600)]
    want = jev.mutinfo(probs, targets)
    calls = []
    emi = tev.emi_binary
    monkeypatch.setattr(tev, "emi_binary",
                        lambda *a: calls.append(a) or emi(*a))
    got = tev.mutinfo(probs, targets)
    assert len(calls) == 1
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# Data preparation
# ---------------------------------------------------------------------------

def _counts(seed=0, n=60, d=40):
    ds = tio.synthetic_dataset(n, d, 4, seed)
    return np.expm1(ds.log1p), ds.gene_id, ds.cluster_label


@pytest.mark.parametrize("n_top", [0, 10, 1000])
@pytest.mark.parametrize("already", [False, True])
def test_normalized_bit_for_bit(n_top, already):
    counts, genes, _ = _counts()
    xj, gj = jprep._normalized(counts, genes, n_top, already)
    xt, gt = tprep._normalized(counts, genes, n_top, already)
    assert xt.dtype == xj.dtype == np.float64
    assert np.array_equal(xt, xj) and np.array_equal(gt, gj)


@pytest.fixture
def no_anndata(monkeypatch):
    """anndata made unimportable in this process (neither container has
    it; this keeps the case fixed where one does)."""
    monkeypatch.setitem(sys.modules, "anndata", None)


def test_prepare_dataset_raises_without_anndata(no_anndata):
    counts, genes, labels = _counts()
    for mod in (jprep, tprep):
        with pytest.raises(ImportError):
            mod.prepare_dataset(counts, genes, labels)


def _h5_tree(path):
    """Every dataset (values) and attribute of an HDF5 file, by path."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, node):
            attrs = {k: np.asarray(v).tolist() for k, v in node.attrs.items()}
            if isinstance(node, h5py.Dataset):
                out[name] = (np.asarray(node[()]).tolist(), attrs)
            else:
                out[name] = (None, attrs)
        out["/"] = (None, {k: np.asarray(v).tolist()
                           for k, v in f.attrs.items()})
        f.visititems(visit)
    return out


@pytest.mark.parametrize("sparse", [None, "csr", "csc"])
def test_prepare_h5ad_writes_jaxs_file(sparse, tmp_path, no_anndata):
    counts, genes, labels = _counts(1)
    obs = {"batch": np.arange(len(labels)) % 3}
    pj = jprep.prepare_h5ad(str(tmp_path / "j.h5ad"), counts, genes, labels,
                            obs=obs, n_top_genes=12, sparse=sparse)
    pt = tprep.prepare_h5ad(str(tmp_path / "t.h5ad"), counts, genes, labels,
                            obs=obs, n_top_genes=12, sparse=sparse)
    assert pt == str(tmp_path / "t.h5ad")
    assert _h5_tree(pt) == _h5_tree(pj)
    dj = jio.load_data(pj, verbose=False, min_num=0)
    dt = tio.load_data(pt, verbose=False, min_num=0)
    for f in ("log1p", "gene_id", "cluster_label", "cluster_id", "c_onehot",
              "c_p"):
        assert np.array_equal(getattr(dt, f), getattr(dj, f)), f
    assert dt.n_type == dj.n_type and dt.n_genes == 12


def test_prepare_h5ad_names_h5py_when_it_is_absent(tmp_path, no_anndata,
                                                   monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    counts, genes, labels = _counts()
    with pytest.raises(ImportError, match="h5py"):
        tprep.prepare_h5ad(str(tmp_path / "x.h5ad"), counts, genes, labels)
    assert not (tmp_path / "x.h5ad").exists()


def test_prepare_dataset_roundtrip(tmp_path):
    """tests/test_pipeline.py's case on the port: data-prep → h5ad →
    load_data, and the file is JAX's."""
    p = str(tmp_path / "syn.h5ad")
    tprep.synthetic_h5ad(p, n_cells=100, n_genes=30, n_types=4, seed=0)
    ds = tio.load_data(p, verbose=False)
    assert ds.n_cells == 100 and ds.n_genes == 30
    assert ds.n_type == 4
    assert ds.c_onehot.shape == (100, 4)
    pj = jprep.synthetic_h5ad(str(tmp_path / "j.h5ad"), n_cells=100,
                              n_genes=30, n_types=4, seed=0)
    assert _h5_tree(p) == _h5_tree(pj)


# ---------------------------------------------------------------------------
# Profiling
# ---------------------------------------------------------------------------

def _write_trace(path, events):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)


def test_trace_total_device_ms_sums_device_events(tmp_path):
    """Kernels, copies and memsets count; CPU operators, runtime calls,
    annotations (which enclose kernels), flows and metadata do not."""
    ev = [{"ph": "X", "cat": "kernel", "name": "k", "dur": 10.5},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
           "dur": 2.25},
          {"ph": "X", "cat": "gpu_memset", "name": "Memset", "dur": 1.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 100.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "dur": 50.0},
          {"ph": "X", "cat": "gpu_user_annotation", "name": "step",
           "dur": 13.75},
          {"ph": "X", "cat": "user_annotation", "name": "step", "dur": 99.0},
          {"ph": "f", "cat": "ac2g", "name": "flow", "id": 1},
          {"ph": "M", "name": "process_name", "args": {"name": "x"}},
          {"ph": "i", "cat": "kernel", "name": "instant", "s": "t"}]
    _write_trace(str(tmp_path / "a" / "h_1.1.pt.trace.json"), ev)
    _write_trace(str(tmp_path / "b" / "c" / "h_2.2.pt.trace.json"),
                 [{"ph": "X", "cat": "kernel", "name": "k2", "dur": 0.25}])
    _write_trace(str(tmp_path / "other.json"),
                 [{"ph": "X", "cat": "kernel", "name": "k3", "dur": 1e6}])
    assert tprof.trace_total_device_ms(str(tmp_path)) == pytest.approx(
        (10.5 + 2.25 + 1.0 + 0.25) / 1e3, rel=0, abs=1e-15)
    _write_trace(str(tmp_path / "cpu" / "h.pt.trace.json"), ev[3:])
    assert tprof.trace_total_device_ms(str(tmp_path / "cpu")) == 0.0


def test_trace_total_device_ms_without_a_trace(tmp_path):
    with pytest.raises(FileNotFoundError):
        tprof.trace_total_device_ms(str(tmp_path))


def test_profile_run_on_the_cpu(tmp_path, capsys):
    d = str(tmp_path / "prof")
    with tprof.profile_run(d, create_perfetto_link=True) as out:
        y = torch.ones(64, 64) @ torch.ones(64, 64)
    assert out == d and isinstance(out, str)
    assert float(y[0, 0]) == 64.0
    files = [f for f in os.listdir(d) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    assert files[0] in capsys.readouterr().out
    assert tprof.trace_total_device_ms(d) == 0.0
    names = {e.key for e in out.profiler.key_averages()}
    assert "aten::mm" in names


class TestProfiling:
    def test_step_timer(self):
        t = tprof.StepTimer()
        x = torch.ones((64, 64))
        t.start()
        y = x @ x
        dt = t.stop(sync_on=y)
        assert dt > 0
        assert t.summary()["n"] == 1
        assert set(t.summary()) == {"mean_s", "p50_s", "p95_s", "n"}

    def test_memory_snapshot(self, tmp_path):
        p = str(tmp_path / "mem.json")
        snap = tprof.memory_snapshot(p)
        assert os.path.exists(p)
        assert len(snap) >= 1
        with open(p) as f:
            assert json.load(f) == snap


def test_step_timer_waits_on_the_first_tensor_leaf(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: seen.append(device))
    t = tprof.StepTimer()
    assert t.summary() == {} and t.mean == 0.0
    for tree in ({}, [], {"b": [1.0], "a": (torch.ones(2),)},
                 [None, {"x": torch.zeros(1)}]):
        t.start()
        t.stop(sync_on=tree)
    assert seen == []            # CPU tensors and empty trees need no wait
    assert tprof._first_tensor({"b": torch.ones(1), "a": [torch.zeros(2)]}
                               ).shape == (2,)      # keys sorted, as JAX
    assert t.summary()["n"] == 4 and t.mean > 0


def test_memory_snapshot_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tprof.memory_snapshot() == {"cpu": {}}


# ---------------------------------------------------------------------------
# The parser
# ---------------------------------------------------------------------------

class TestParser:
    def test_primitives(self):
        assert tparser.one_char("a")("abc") == ("a", "bc")
        assert tparser.one_char("a")("xbc") is None
        assert tparser.any_digit()("1x") == ("1", "x")

    def test_compose_choice_many(self):
        p = tparser.compose(tparser.one_char("a"), tparser.any_digit())
        assert p("a1rest") == (("a", "1"), "rest")
        assert p("ax") is None
        c = tparser.choice(tparser.one_char("a"), tparser.one_char("b"))
        assert c("b!") == ("b", "!")
        m = tparser.many(tparser.any_digit())
        assert m("123x") == (["1", "2", "3"], "x")


def test_parser_exception_surface():
    assert tparser.parse(tparser.any_char(), "xy") == ("x", "y")
    assert tparser.parse(tparser.compose(tparser.any_digit(),
                                         tparser.any_char()),
                         "7q!") == (("7", "q"), "!")
    with pytest.raises(tparser.ParserError):
        tparser.parse(tparser.any_digit(), "abc")
    with pytest.raises(tparser.ParserError, match="Parse failure: "):
        tparser.parse(tparser.any_char(), "")


def _grammar(m):
    """The same parser built from either module's combinators."""
    digit_or_a = m.choice(m.any_digit(), m.one_char("a"))
    pair = m.compose(m.one_char("("), m.compose(m.many(digit_or_a),
                                                m.one_char(")")))
    return m.many(m.choice(pair, m.compose(m.sat(str.isupper),
                                           m.any_char())))


@settings(max_examples=200, deadline=None)
@given(st.text(alphabet="()a19Zb ", max_size=24))
def test_parser_matches_jax_on_random_strings(s):
    got, want = _grammar(tparser)(s), _grammar(jparser)(s)
    assert got == want
    for p in (tparser, jparser):
        assert p.any_char()(s) == (p.parse(p.any_char(), s) if s else None)


# ---------------------------------------------------------------------------
# The probe of the card
# ---------------------------------------------------------------------------

@pytest.fixture
def probe_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("DVAE_PROBE_PIDFILE", str(tmp_path / "p.pid"))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def test_probe_body_checks_the_card():
    assert "cuda" in bp.PROBE_CODE and "jax" not in bp.PROBE_CODE
    compile(bp.PROBE_CODE, "<probe>", "exec")


def test_pidfile_lives_in_the_temporary_directory(monkeypatch, tmp_path):
    monkeypatch.delenv("DVAE_PROBE_PIDFILE", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert bp._pidfile_for("abc") == str(tmp_path /
                                         "dvae_backend_probe.abc.pid")


def test_probe_fast_fail(probe_tmp, monkeypatch):
    monkeypatch.setenv("DVAE_PROBE_CODE", "raise SystemExit(3)")
    assert bp.probe_backend(timeout_s=60) is False
    monkeypatch.setenv("DVAE_PROBE_CODE", "x = 1")
    assert bp.probe_backend(timeout_s=60) is True
    assert any(p.name.startswith("dvae_probe_done.")
               for p in probe_tmp.iterdir())


def test_hung_probe_is_left_running(probe_tmp, monkeypatch):
    """A probe past its timeout raises and is NOT killed: the next caller
    adopts the same process."""
    monkeypatch.setenv("DVAE_PROBE_CODE", "import time; time.sleep(60)")
    with pytest.raises(subprocess.TimeoutExpired):
        bp.probe_backend(timeout_s=0.3)
    again = bp.start_probe()
    try:
        assert isinstance(again, bp.AdoptedProbe)
        assert bp._proc_starttime(again.pid) is not None   # still alive
    finally:
        os.kill(again.pid, 9)
        os.waitpid(again.pid, 0)


class TestProbeAdoption:
    """tests/test_backend_guard.py's adoption cases on the port."""

    @pytest.fixture(autouse=True)
    def _isolated(self, probe_tmp):
        self.tmp = probe_tmp

    def test_pending_probe_adopted_not_duplicated(self, monkeypatch):
        monkeypatch.setenv("DVAE_PROBE_CODE", "import time; time.sleep(60)")
        p1 = bp.start_probe()
        try:
            p2 = bp.start_probe()
            assert isinstance(p2, bp.AdoptedProbe)
            assert p2.pid == p1.pid
            assert p2.poll() is None
            with pytest.raises(subprocess.TimeoutExpired):
                p2.wait(timeout=0.3)
        finally:
            p1.kill()
            p1.wait()
        assert p2.wait(timeout=5) == 1
        p3 = bp.start_probe()
        try:
            assert not isinstance(p3, bp.AdoptedProbe)
            assert p3.pid != p1.pid
        finally:
            p3.kill()
            p3.wait()

    def test_adopted_handle_sees_success_via_done_file(self, monkeypatch):
        monkeypatch.setenv("DVAE_PROBE_CODE", "import time; time.sleep(1)")
        p1 = bp.start_probe()
        p2 = bp.start_probe()
        assert isinstance(p2, bp.AdoptedProbe)
        assert p1.wait(timeout=30) == 0
        assert p2.wait(timeout=10) == 0

    def test_finished_probe_never_adopted(self, monkeypatch):
        monkeypatch.setenv("DVAE_PROBE_CODE", "x = 1")
        p1 = bp.start_probe()
        assert p1.wait(timeout=30) == 0
        p2 = bp.start_probe()
        assert not isinstance(p2, bp.AdoptedProbe)
        assert p2.wait(timeout=30) == 0

    def test_different_probe_body_not_adopted(self, monkeypatch):
        monkeypatch.setenv("DVAE_PROBE_CODE", "import time; time.sleep(60)")
        p1 = bp.start_probe()
        try:
            monkeypatch.setenv("DVAE_PROBE_CODE",
                               "import time; time.sleep(2)")
            p2 = bp.start_probe()
            try:
                assert not isinstance(p2, bp.AdoptedProbe)
                assert p2.pid != p1.pid
            finally:
                p2.kill()
                p2.wait()
        finally:
            p1.kill()
            p1.wait()
