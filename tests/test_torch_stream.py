"""The PyTorch port's host→device streaming (dvae_tpu_torch/data/stream.py)
and the trainer's streamed and host-matrix paths against the JAX package.

On the CPU the port's streamer hands out plain tensors; the pinned ring,
the copy stream and its events run only on the card (chip_smoke.py phase
10).  What is held here, with its tolerance:

  * the batch plan and every batch equal to ``dvae_tpu.data.stream
    .BatchStreamer``'s, exactly: dense f32, a bf16 cast (the bits: both
    round to nearest even), CSR, CSC converted once, prior rows, prefetch
    1 to 3;
  * the cases of tests/test_stream.py and tests/test_stream_overlap.py that
    need no mesh, on the port;
  * a streamed chunk equal to a manual loop of ``make_train_step`` over the
    same batches and the same noise chain, bit for bit (MSE, ZINB,
    use_pallas; two chunks, so the chain continues across them);
  * one ``step`` mark a step in a collective recorder, from the streamed
    runner as from the resident one (the epoch loop both share);
  * the streamed batches of both packages through three train steps from
    the same weights and noise: the loss trajectory at ``TRAJ`` (rtol
    1e-3, as tests/test_torch_train.py holds the resident steps);
  * ``validate`` and ``eval_model`` on a CSR matrix equal to the same calls
    on the dense array: labels exact, values within 1e-6 (the dense array
    rides the eval runner in chunks, the CSR one goes batch by batch: the
    same per-batch arithmetic on other memory).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from dvae_tpu.data import stream as jstream

import dvae_tpu_torch.config as tcfg_mod
import dvae_tpu_torch.train.cpl_mixvae as tm
from dvae_tpu_torch.data.stream import (BatchStreamer, feed_census,
                                        make_streaming_runner)
from dvae_tpu_torch.models import mixvae as tmixvae
from dvae_tpu_torch.train import step as tstep

N, D, C = 64, 24, 6
TRAJ = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_cfgs(**kw):
    cfg = tcfg_mod.VAEConfig(n_categories=C, state_dim=2, input_dim=D,
                             fc_dim=16, lowD_dim=8, n_arm=2,
                             fused_recon=True, fused_encoder=True, **kw)
    tcfg = tcfg_mod.TrainConfig(batch_size=16, epochs_per_jit=2, seed=3)
    return cfg, tcfg


def make_data(seed=0, n=N, d=D):
    return np.random.default_rng(seed).random((n, d), np.float32)


def sparse_data(seed=4):
    rng = np.random.default_rng(seed)
    dense = rng.random((N, D), np.float32) * (rng.random((N, D)) > 0.8)
    return sp.csr_matrix(dense), dense.astype(np.float32)


def _np(t):
    """A batch as numpy; bf16 as its bits."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(t)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


# ---------------------------------------------------------------------------
# The streamer against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [1, 2, 3])
@pytest.mark.parametrize("case", ["dense", "bf16", "csr", "csc", "prior"])
def test_batches_equal_the_jax_streamers(case, prefetch):
    x = make_data(1)
    prior = None
    dtypes = (None, None)
    if case == "bf16":
        dtypes = (torch.bfloat16, jnp.bfloat16)
    elif case in ("csr", "csc"):
        xs, _ = sparse_data()
        x = xs if case == "csr" else sp.csc_matrix(xs)
    elif case == "prior":
        prior = np.random.default_rng(2).dirichlet(np.ones(C), N).astype(
            np.float32)
    got = BatchStreamer(x, 16, prior=prior, seed=7, dtype=dtypes[0],
                        device="cpu", prefetch=prefetch)
    want = jstream.BatchStreamer(x, 16, prior=prior, seed=7,
                                 dtype=dtypes[1], prefetch=prefetch)
    for e in (0, 3):
        order = np.random.default_rng((7, e)).permutation(N)
        np.testing.assert_array_equal(got.plan(e).ravel(), order)
        gb, wb = list(got.epoch(e)), list(want.epoch(e))
        assert len(gb) == len(wb) == 4
        for g, w in zip(gb, wb):
            assert g.x.dtype == (dtypes[0] or torch.float32)
            np.testing.assert_array_equal(_np(g.x), _np(w.x))
            if prior is None:
                assert g.prior is None and w.prior is None
            else:
                np.testing.assert_array_equal(_np(g.prior), _np(w.prior))
    if case == "csc":
        assert got.x.format == "csr"


def test_bf16_cast_rounds_to_nearest_even():
    """Values halfway between two bf16 numbers go to the even one, and
    the sparse path casts as the dense one does."""
    base = np.array([1.0, 1.0078125, 3.0, -2.0], np.float32)
    halfway = (base.view(np.uint32) + np.uint32(0x8000)).view(np.float32)
    x = np.tile(np.concatenate([base, halfway]), (4, 1))
    dense = next(iter(BatchStreamer(x, 4, shuffle=False, dtype=torch.bfloat16,
                                    device="cpu").epoch(0))).x
    csr = next(iter(BatchStreamer(sp.csr_matrix(x), 4, shuffle=False,
                                  dtype=torch.bfloat16,
                                  device="cpu").epoch(0))).x
    want = jnp.asarray(x).astype(jnp.bfloat16)
    np.testing.assert_array_equal(_np(dense), _np(want))
    np.testing.assert_array_equal(_np(csr), _np(want))


# ---------------------------------------------------------------------------
# The cases of tests/test_stream.py and tests/test_stream_overlap.py
# ---------------------------------------------------------------------------

class TestBatchStreamer:
    def test_epoch_covers_each_row_once(self):
        x = make_data()
        seen = [b.x.numpy() for b in BatchStreamer(x, 16, seed=7,
                                                   device="cpu").epoch(0)]
        assert len(seen) == 4 and all(s.shape == (16, D) for s in seen)
        np.testing.assert_array_equal(np.sort(np.concatenate(seen), axis=0),
                                      np.sort(x, axis=0))

    def test_shuffle_is_deterministic_per_epoch_and_differs_across(self):
        x = make_data()
        a, b, c = ([t.x.numpy() for t in BatchStreamer(
            x, 16, seed=7, device="cpu").epoch(e)] for e in (2, 2, 3))
        assert all(np.array_equal(u, v) for u, v in zip(a, b))
        assert not all(np.array_equal(u, v) for u, v in zip(a, c))

    def test_drop_last_and_prior_alignment(self):
        x = make_data()
        prior = x[:, :1] * 10.0  # a row-identifying companion
        batches = list(BatchStreamer(x, 24, prior=prior, seed=1,
                                     device="cpu").epoch(0))
        assert len(batches) == 2  # 64 // 24: the last 16 rows dropped
        for b in batches:
            torch.testing.assert_close(b.prior, b.x[:, :1] * 10.0, rtol=0,
                                       atol=0)

    def test_prefetch_depths_yield_identical_streams(self):
        x = make_data()
        ref = [b.x for b in BatchStreamer(x, 16, seed=5,
                                          device="cpu").epoch(1)]
        for depth in (1, 3, 9):  # 9 > steps: clamped
            got = [b.x for b in BatchStreamer(x, 16, seed=5, prefetch=depth,
                                              device="cpu").epoch(1)]
            assert all(torch.equal(u, v) for u, v in zip(ref, got))

    def test_batch_too_large_raises(self):
        with pytest.raises(ValueError, match="batch_size"):
            BatchStreamer(make_data(), N + 1, device="cpu")
        with pytest.raises(ValueError, match="batch_size"):
            make_streaming_runner(*small_cfgs(), tstep.make_optimizer(
                small_cfgs()[0]), 15, device="cpu")

    def test_issue_ahead_invariant(self):
        """The window never drains below min(remaining, prefetch + 1)
        (tests/test_stream_overlap.py); on the CPU no host wait is made."""
        x = make_data(0, 2048, 64)
        for prefetch in (1, 2, 3):
            bs = BatchStreamer(x, 256, prefetch=prefetch, record_stats=True,
                               device="cpu")
            steps = bs.steps_per_epoch
            assert sum(1 for _ in bs.epoch(0)) == steps
            assert bs.stats.ahead == [min(steps - i, prefetch + 1)
                                      for i in range(steps)]
            assert len(bs.stats.gather_s) == steps
            assert all(t >= 0 for t in bs.stats.gather_s)
            assert bs.stats.waits == [0] * steps

    def test_stats_off_by_default(self):
        bs = BatchStreamer(make_data(0, 2048, 64), 256, device="cpu")
        assert bs.stats is None
        assert sum(1 for _ in bs.epoch(0)) == bs.steps_per_epoch

    def test_csc_converted_and_dtype_cast(self):
        xs, xd = sparse_data()
        s = BatchStreamer(sp.csc_matrix(xs), 16, seed=3,
                          dtype=torch.bfloat16, device="cpu")
        b = next(iter(s.epoch(0)))
        assert b.x.dtype == torch.bfloat16 and s.x.format == "csr"
        dense = [b.x for b in BatchStreamer(xd, 16, seed=3,
                                            device="cpu").epoch(0)]
        sparse = [b.x for b in BatchStreamer(xs, 16, seed=3,
                                             device="cpu").epoch(0)]
        assert all(torch.equal(u, v) for u, v in zip(sparse, dense))


class TestFeedCensus:
    X = make_data(0, 2048, 64)

    def test_compute_bound_fully_overlapped(self):
        out = feed_census(self.X, 256, device="cpu", device_ms_per_step=50.0,
                          link_gbps=16.0)
        assert out["predicted_overlap_pct"] == 100.0
        assert out["bound_by"] == "device"
        assert out["batch_mb"] == pytest.approx(256 * 64 * 4 / 1e6,
                                                abs=0.006)
        assert out["host_gather_ms"] >= 0
        assert out["link_ms"] == pytest.approx(256 * 64 * 4 / 1e6 / 16.0,
                                               abs=5e-4)

    def test_feed_bound_reports_below_100(self):
        out = feed_census(self.X, 256, device="cpu", device_ms_per_step=1e-6,
                          link_gbps=0.001)
        assert out["predicted_overlap_pct"] < 100.0
        assert out["bound_by"] in ("host", "link")

    def test_respects_cast_dtype(self):
        out = feed_census(self.X, 256, device="cpu", dtype=torch.bfloat16)
        assert out["batch_mb"] == pytest.approx(256 * 64 * 2 / 1e6,
                                                abs=0.006)

    def test_commit_false_never_touches_the_device(self, monkeypatch):
        def boom(*a, **k):
            raise AssertionError("a device object made in a commit=False "
                                 "census")
        for name in ("Stream", "Event", "synchronize"):
            monkeypatch.setattr(torch.cuda, name, boom)
        out = feed_census(self.X, 256, commit=False, device="cuda",
                          device_ms_per_step=50.0)
        assert "commit_ms" not in out
        assert out["predicted_overlap_pct"] == 100.0

    @pytest.mark.parametrize("device_ms", [None, 50.0, 1e-6])
    def test_keys_and_bound_by_as_the_jax_census(self, device_ms):
        """Both packages report the same keys and the same batch and link
        figures; the bound is the slowest stage of the port's own
        measurement, by the JAX package's rule."""
        kw = dict(device_ms_per_step=device_ms, link_gbps=16.0,
                  commit=False)
        got = feed_census(self.X, 256, dtype=torch.bfloat16, **kw)
        want = jstream.feed_census(self.X, 256, dtype=jnp.bfloat16, **kw)
        assert sorted(got) == sorted(want)
        for k in ("batch_mb", "link_ms", "link_gbps_assumed"):
            assert got[k] == want[k]
        if device_ms is not None:
            stages = {"host": got["host_gather_ms"], "link": got["link_ms"],
                      "device": device_ms}
            assert got["bound_by"] == max(stages, key=stages.get)
            feed = max(got["host_gather_ms"], got["link_ms"])
            assert got["predicted_overlap_pct"] == round(
                100.0 * min(1.0, device_ms / feed), 1)


# ---------------------------------------------------------------------------
# The streaming runner
# ---------------------------------------------------------------------------

def _manual_chunks(cfg, tcfg, opt, x, chunks, prior=None):
    """The streaming runner written out: per chunk, the noise chain of
    ``chunk_rngs`` at the chunk's first epoch; per epoch, the streamer's
    batches through ``make_train_step``."""
    state = tstep.init_train_state(0, cfg, opt)
    step = tstep.make_train_step(cfg, tcfg, opt)
    streamer = BatchStreamer(x, tcfg.batch_size, prior=prior, seed=tcfg.seed,
                             device="cpu")
    for n_chunk in chunks:
        gen, host = tstep.chunk_rngs(state.seed, state.epoch, "cpu")
        for _ in range(n_chunk):
            for b in streamer.epoch(state.epoch):
                enc_seed = int(host.integers(0, 2 ** 31 - 1))
                noise = (tmixvae.Noise(gumbel_seed=int(
                    host.integers(0, 2 ** 31 - 1)))
                    if cfg.use_pallas else None)
                state, _, _ = step(state, b.x, b.prior, 1.0, generator=gen,
                                   enc_seed=enc_seed, noise=noise)
            state = state._replace(epoch=state.epoch + 1)
    return state


@pytest.mark.parametrize("mode", ["MSE", "ZINB", "use_pallas", "ref_prior"])
def test_runner_matches_a_manual_step_loop_bit_for_bit(mode):
    kw = {"MSE": {}, "ZINB": {"mode": "ZINB"},
          "use_pallas": {"use_pallas": True},
          "ref_prior": {"ref_prior": True}}[mode]
    cfg, tcfg = small_cfgs(**kw)
    opt = tstep.make_optimizer(cfg)
    x = make_data(3)
    if mode == "ZINB":
        x = np.floor(x * 4).astype(np.float32)
    prior = (np.random.default_rng(1).dirichlet(np.ones(C), N).astype(
        np.float32) if mode == "ref_prior" else None)
    runner = make_streaming_runner(cfg, tcfg, opt, N, device="cpu")
    state = tstep.init_train_state(0, cfg, opt)
    for n_chunk in (2, 1):  # the chain continues across chunks
        state, ems = runner(n_chunk)(state, x, prior, 1.0)
    want = _manual_chunks(cfg, tcfg, opt, x, (2, 1), prior)
    assert state.epoch == want.epoch == 3
    assert state.opt_state.count == want.opt_state.count == 12
    for pa, pb in zip(tstep.tree_leaves(state.params),
                      tstep.tree_leaves(want.params)):
        assert torch.equal(pa, pb)
    assert tuple(ems.total.shape) == (1,)


def test_runner_epoch_metrics_contract():
    cfg, tcfg = small_cfgs()
    opt = tstep.make_optimizer(cfg)
    runner = make_streaming_runner(cfg, tcfg, opt, N, device="cpu")
    state, ems = runner(3)(tstep.init_train_state(0, cfg, opt), make_data(),
                           None, 1.0)
    assert tuple(ems.total.shape) == (3,)
    assert tuple(ems.loss_rec.shape) == (3, cfg.n_arm)
    assert tuple(ems.kl.shape) == (3, cfg.n_arm)
    assert bool(torch.isfinite(ems.total).all())
    assert bool(((ems.consensus >= 0) & (ems.consensus <= 1)).all())
    assert state.epoch == 3 and runner.streamer.steps_per_epoch == 4


@pytest.mark.parametrize("where", ["resident", "streamed"])
def test_runner_leaves_one_step_mark_a_step(where):
    """Both runners leave one ``step`` mark a step in an open collective
    recorder, the boundary ``collective_cost.per_step_records`` splits a
    run at."""
    from dvae_tpu_torch.parallel.runtime import record_collectives
    cfg, tcfg = small_cfgs()
    opt = tstep.make_optimizer(cfg)
    x = make_data()
    if where == "resident":
        run = tstep.make_epoch_runner(cfg, tcfg, opt, N, epochs_per_chunk=2)
        x = torch.from_numpy(x)
    else:
        run = make_streaming_runner(cfg, tcfg, opt, N, device="cpu")(2)
    with record_collectives() as records:
        state, _ = run(tstep.init_train_state(0, cfg, opt), x, None, 1.0)
    steps = 2 * (N // tcfg.batch_size)
    assert [r.kind for r in records] == ["step"] * steps
    assert state.opt_state.count == steps


def test_streamed_batches_track_jax_through_the_train_step():
    """The batches both streamers draw for one epoch, through three train
    steps of each package from the same weights and noise
    (tests/test_torch_train._jax_then_port_steps): the loss trajectories
    agree to TRAJ."""
    import test_torch_train as tt
    from dvae_tpu.train import step as jstep
    from dvae_tpu_torch.utils import checkpoint as tckpt
    x = np.maximum(np.random.default_rng(4).normal(0.5, 1, (3 * tt.B, tt.D)),
                   0).astype(np.float32)
    xb = np.stack([b.x.numpy() for b in BatchStreamer(
        x, tt.B, seed=9, device="cpu").epoch(0)])
    jb = np.stack([np.asarray(b.x) for b in jstream.BatchStreamer(
        x, tt.B, seed=9).epoch(0)])
    np.testing.assert_array_equal(xb, jb)
    jc, tc = tt._cfgs(fused_encoder=True, fused_recon=True)
    tx = jstep.make_optimizer(jc)
    jstate = jstep.init_train_state(jax.random.key(2), jc, tx)
    params = jax.tree_util.tree_map(np.array, jstate.params)
    opt = tstep.make_optimizer(tc)
    tp = tckpt.params_from_jax(params)
    tstate = tstep.TrainState(
        tp, tckpt.bn_from_jax(jax.tree_util.tree_map(np.array, jstate.bn)),
        torch.ones(tt.C), 0, 0, opt.init(tp))
    _, tstate, jl, tl = tt._jax_then_port_steps(jstate, tstate, jc, tc, xb,
                                                3)
    np.testing.assert_allclose(tl, jl, rtol=TRAJ)
    assert tstate.opt_state.count == 3


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

def _trainer(tmp_path, **kw):
    cpl = tm.CplMixVAE(saving_folder=str(tmp_path), device="cpu", seed=1)
    cpl.init_model(**{**dict(n_categories=C, state_dim=2, input_dim=D,
                             fc_dim=16, lowD_dim=8, n_arm=2, batch_size=16,
                             epochs_per_jit=2, fused=True), **kw})
    return cpl


class TestTrainer:
    def test_train_stream_end_to_end(self, tmp_path):
        rng = np.random.default_rng(0)
        centers = rng.random((C, D), np.float32) * 2
        x = (centers[rng.integers(0, C, N)]
             + 0.05 * rng.standard_normal((N, D)).astype(np.float32))
        cpl = _trainer(tmp_path, stream=True)
        assert cpl.tcfg.stream
        path = cpl.train(x, x_val=x[:16], n_epoch=4, save_plots=False,
                         early_stop_consensus=0)
        assert path and cpl.state.epoch == 4
        assert cpl.state.opt_state.count == 16

    def test_train_stream_with_ref_prior(self, tmp_path):
        rng = np.random.default_rng(2)
        x = rng.random((N, D), np.float32)
        c_p = rng.dirichlet(np.ones(C), N).astype(np.float32)
        cpl = _trainer(tmp_path, stream=True, ref_prior=True)
        cpl.train(x, n_epoch=2, c_p=c_p, train_idx=np.arange(N),
                  save_plots=False, early_stop_consensus=0)
        assert cpl.state.epoch == 2

    def test_auto_stream_when_the_dataset_exceeds_the_device(
            self, tmp_path, monkeypatch):
        monkeypatch.setattr(tm, "_dataset_exceeds_device",
                            lambda x, dt, dev: True)
        cpl = _trainer(tmp_path)
        assert not cpl.tcfg.stream
        cpl.train(make_data(), n_epoch=2, save_plots=False,
                  early_stop_consensus=0)
        assert cpl.tcfg.stream  # switched by the guard
        assert cpl.state.epoch == 2

    def test_device_guard_math(self, monkeypatch):
        class Props:
            def __init__(self, total):
                self.total_memory = total

        x = np.zeros((1000, 100), np.float32)  # 400 kB, 200 kB in bf16
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda dev: Props(1 << 20))
        assert not tm._dataset_exceeds_device(x, torch.float32, "cuda")
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda dev: Props(500_000))
        assert tm._dataset_exceeds_device(x, torch.float32, "cuda")
        assert not tm._dataset_exceeds_device(x, torch.bfloat16, "cuda")
        # a sparse matrix counts at its dense size
        assert tm._dataset_exceeds_device(sp.csr_matrix(x), torch.float32,
                                          "cuda")
        assert not tm._dataset_exceeds_device(x, torch.float32, "cpu")

    def test_train_stream_sparse_end_to_end(self, tmp_path):
        xs, _ = sparse_data()
        cpl = _trainer(tmp_path, stream=True)
        cpl.train(xs, n_epoch=2, save_plots=False, early_stop_consensus=0)
        assert cpl.state.epoch == 2
        res = cpl.eval_model(xs, batch_size=16)
        assert res["pred_label"].shape == (2, N)
        assert np.isfinite(res["total_loss"])

    def test_coo_train_prune_align_and_eval(self, tmp_path):
        """COO and CSC become CSR at ingestion: training, the pruning
        phase's label pass, the alignment and eval_model all slice it."""
        xs, _ = sparse_data()
        cpl = _trainer(tmp_path, stream=True, align_arms_every=1)
        cpl.train(sp.coo_matrix(xs), n_epoch=2, n_epoch_p=2, max_prun_it=1,
                  min_con=1.01, save_plots=False, early_stop_consensus=0)
        assert cpl.state.epoch == 4
        assert int(cpl.state.mask.sum()) == C - 1
        res = cpl.eval_model(sp.coo_matrix(xs), batch_size=16)
        res2 = cpl.eval_model(sp.csc_matrix(xs), batch_size=16)
        np.testing.assert_array_equal(res2["pred_label"], res["pred_label"])

    def test_resident_path_densifies_sparse(self, tmp_path):
        xs, _ = sparse_data()
        cpl = _trainer(tmp_path)
        cpl.train(xs, n_epoch=2, save_plots=False, early_stop_consensus=0)
        assert not cpl.tcfg.stream and cpl.state.epoch == 2

    def test_sparse_validation_set(self, tmp_path):
        xs, dense = sparse_data()
        cpl = _trainer(tmp_path, stream=True, epochs_per_jit=1)
        cpl.train(xs[:48], x_val=xs[48:], n_epoch=2, save_plots=False,
                  early_stop_consensus=0)
        val = cpl.validate(xs[48:], batch_size=16)
        assert np.isfinite(val["loss"])
        val2 = cpl.validate(sp.csc_matrix(dense[48:]), batch_size=16)
        assert val2["loss"] == val["loss"]

    @pytest.mark.parametrize("mode", ["MSE", "ZINB"])
    def test_eval_on_csr_equals_eval_on_the_dense_array(self, mode,
                                                        tmp_path):
        """validate and eval_model over 80 cells in batches of 16 (the
        dense array in one chunk of 5 batches, the CSR matrix batch by
        batch): labels exact, values within 1e-6."""
        rng = np.random.default_rng(6)
        dense = (rng.random((80, D), np.float32)
                 * (rng.random((80, D)) > 0.6)).astype(np.float32)
        if mode == "ZINB":
            dense = np.floor(dense * 5).astype(np.float32)
        cpl = _trainer(tmp_path, mode=mode)
        cpl.train(dense, n_epoch=2, save_plots=False, early_stop_consensus=0)
        csr = sp.csr_matrix(dense)
        a, b = cpl.eval_model(csr, batch_size=16), cpl.eval_model(
            dense, batch_size=16)
        np.testing.assert_array_equal(a["pred_label"], b["pred_label"])
        for k in ("c_prob", "state_mu", "state_logvar", "x_low",
                  "total_loss_rec"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6)
        assert a["total_loss"] == pytest.approx(b["total_loss"], rel=1e-6)
        assert a["consensus"] == b["consensus"]
        va, vb = cpl.validate(csr, batch_size=16), cpl.validate(
            dense, batch_size=16)
        assert va["consensus"] == vb["consensus"]
        for k in vb:
            assert va[k] == pytest.approx(vb[k], rel=1e-6, abs=1e-6), k
        la = cpl._predict_labels(csr, 1.0, batch_size=16)
        np.testing.assert_array_equal(
            la, cpl._predict_labels(dense, 1.0, batch_size=16))

    def test_a_dense_host_matrix_too_large_for_the_device_goes_by_batch(
            self, tmp_path, monkeypatch):
        """Where the dense x would not fit the card, the eval surfaces keep
        it on the host and move it one batch at a time."""
        x = make_data(5, 48)
        cpl = _trainer(tmp_path)
        cpl.train(x, n_epoch=2, save_plots=False, early_stop_consensus=0)
        want = cpl.eval_model(x, batch_size=16)
        monkeypatch.setattr(tm, "_dataset_exceeds_device",
                            lambda x, dt, dev: True)
        host = cpl._eval_input(x)  # the numpy array itself, not a copy
        assert host.device.type == "cpu"
        assert host.data_ptr() == x.__array_interface__["data"][0]
        got = cpl.eval_model(x, batch_size=16)
        np.testing.assert_array_equal(got["pred_label"], want["pred_label"])
        np.testing.assert_allclose(got["c_prob"], want["c_prob"], rtol=1e-6,
                                   atol=1e-6)

