"""The PyTorch port's inference API and traversal (dvae_tpu_torch.models.api,
``mixvae.state_changes``/``param_count``, the loss helpers, ``expand_arms``)
against the JAX package.

Small widths (A=3 arms, D=64 genes, F=16, L=4, C=6, S=2).  Weights are made
by the JAX package and handed to the port through the weight bridge; the
inputs are made with numpy from a seed.  The noise is JAX's, rebuilt from
its key splits and handed to the port as explicit draws: ``generate`` takes
a new key a batch (``key, k = jax.random.split(key)``,
dvae_tpu/models/api.py:157) whose eval forward draws the
reparameterisation noise from ``split(split(k)[1], (A, 3))[a, 1]``
(dvae_tpu/models/mixvae.py:356-359); ``state_changes`` draws the eval
noise from its key and the n_samp traversal draws from
``split(key, n_samp)`` (:458).  JAX runs on the CPU as its own tests run
it, the coupling kernel of ``use_pallas`` in interpret mode.

Tolerances: ``TOL`` (rtol 1e-5, atol 1e-6) for f32 values computed by the
same operations summed in another order; labels exact; ``loss_rec``
relative 1e-5; the loss helpers relative 1e-6.  ``tau`` is 0.1: the
default 0.005 multiplies the logits' rounding by 200 before the softmax
of ``c_prob``, which the serving tests hold at rtol 1e-4 for that reason.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dvae_tpu.config as jcfg
from dvae_tpu.models import api as japi
from dvae_tpu.models import losses as jlosses
from dvae_tpu.models import mixvae as jmixvae
from dvae_tpu.ops.coupling_pallas import coupling_distance_pallas
from dvae_tpu.train import step as jstep
from dvae_tpu.train.cpl_mixvae import CplMixVAE as JaxCplMixVAE

import dvae_tpu_torch.config as tcfg_mod
from dvae_tpu_torch.data.anndata_io import synthetic_dataset
from dvae_tpu_torch.models import api as tapi
from dvae_tpu_torch.models import losses as tlosses
from dvae_tpu_torch.models import mixvae as tmixvae
from dvae_tpu_torch.ops import coupling as tcoupling
from dvae_tpu_torch.train import step as tstep
from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
from dvae_tpu_torch.utils import checkpoint as tckpt

TOL = dict(rtol=1e-5, atol=1e-6)
A, D, F, L, C, S = 3, 64, 16, 4, 6, 2
DIMS = dict(n_arm=A, input_dim=D, fc_dim=F, lowD_dim=L, n_categories=C,
            state_dim=S, tau=0.1)
N, BS = 23, 10          # two full batches and a padded one of 3 rows


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    kw = {**DIMS, **kw}
    return jcfg.VAEConfig(**kw), tcfg_mod.VAEConfig(**kw)


def _model(jc, seed=0):
    """JAX-initialised weights and random running statistics (numpy)."""
    params = jax.tree_util.tree_map(
        np.asarray, jmixvae.init_params(jax.random.key(seed), jc))
    rng = np.random.default_rng(seed)
    bn = {k: {"mean": (0.1 * rng.normal(size=v["mean"].shape))
              .astype(np.float32),
              "var": rng.uniform(0.5, 1.5, v["var"].shape).astype(np.float32)}
          for k, v in jax.tree_util.tree_map(
              np.asarray, jmixvae.init_bn_state(jc)).items()}
    return params, bn


def _x(n=N, seed=1):
    return synthetic_dataset(n, D, C, seed=seed).log1p


def _eval_noise(key, rows):
    """JAX's eval-forward reparameterisation draw for ``key``, (A, rows, S)."""
    _, k_rest = jax.random.split(key)
    arm_keys = jax.random.split(k_rest, (A, 3))
    return np.stack([np.asarray(jax.random.normal(arm_keys[a, 1], (rows, S)))
                     for a in range(A)])


def _generate_noise(key, n, pad_final):
    """The draws of JAX's ``generate`` batch by batch."""
    draws = []
    for i in range(0, n, BS):
        key, k = jax.random.split(key)
        rows = BS if pad_final else min(BS, n - i)
        draws.append(torch.from_numpy(_eval_noise(k, rows)))
    return draws


def _port(params, bn):
    return tckpt.params_from_jax(params), tckpt.bn_from_jax(bn)


def _assert_generate_equal(got, want):
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["pred_label"], want["pred_label"])
    for k in ("recon", "c_prob", "c_smp", "state", "state_mu",
              "state_logvar", "x_low"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    np.testing.assert_allclose(got["loss_rec"], want["loss_rec"], rtol=1e-5)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad_final", [True, False])
@pytest.mark.parametrize("case", ["plain", "ref_prior", "use_pallas", "zinb"])
def test_generate_matches_jax(case, pad_final, monkeypatch):
    """Three batches (10, 10, 3 rows), the last padded with its own rows or
    evaluated ragged; with the reference prior; with ``use_pallas``, where
    each batch's coupling distance goes through the port's #11 (plain on
    the CPU), held against JAX's interpreted kernel on the same posterior;
    in ZINB mode."""
    kw = {"ref_prior": {"ref_prior": True}, "use_pallas": {"use_pallas": True},
          "zinb": {"mode": "ZINB"}}.get(case, {})
    jc, tc = _cfgs(**kw)
    params, bn = _model(jc, seed=3)
    x = _x()
    c_p = (np.random.default_rng(4).dirichlet(np.ones(C), size=N)
           .astype(np.float32) if case == "ref_prior" else None)
    key = jax.random.key(11)
    want = japi.generate(jc, params, bn, x, key=key, batch_size=BS, c_p=c_p,
                         pad_final=pad_final)
    calls = []
    fused = tcoupling.coupling_distance_fused

    def counted(c, eps):
        calls.append(c.shape)
        return fused(c, eps)

    monkeypatch.setattr(tcoupling, "coupling_distance_fused", counted)
    got = tapi.generate(tc, *_port(params, bn), x, batch_size=BS, c_p=c_p,
                        pad_final=pad_final,
                        noise=_generate_noise(key, N, pad_final))
    _assert_generate_equal(got, want)
    rows = [BS, BS, BS if pad_final else N - 2 * BS]
    assert calls == ([(A, r, C) for r in rows] if case == "use_pallas"
                     else [])
    if case == "use_pallas":
        # a batch's shape on a Dirichlet posterior: this random model's
        # sharp posteriors leave categories dead in a 10-row batch, where
        # the distance (~4e9) keeps no f32 digit on either side
        c = (np.random.default_rng(5).dirichlet(np.ones(C), size=(A, BS))
             .astype(np.float32))
        np.testing.assert_allclose(
            float(fused(torch.from_numpy(c), tc.eps)),
            float(coupling_distance_pallas(jnp.asarray(c), jc.eps)),
            rtol=1e-5)


def test_generate_refuses_ref_prior_without_prior():
    jc, tc = _cfgs(ref_prior=True)
    params, bn = _model(jc)
    with pytest.raises(ValueError, match="ref_prior"):
        japi.generate(jc, params, bn, _x(), batch_size=BS)
    with pytest.raises(ValueError, match="ref_prior"):
        tapi.generate(tc, *_port(params, bn), _x(), batch_size=BS)


def test_generate_draws_from_its_generator():
    """Without explicit draws each batch's noise comes from the generator in
    turn: the same seed gives the same numbers, on a tensor input too."""
    _, tc = _cfgs()
    params, bn = _model(_cfgs()[0])
    p, b = _port(params, bn)
    x = _x()
    one = tapi.generate(tc, p, b, x, batch_size=BS,
                        generator=torch.Generator().manual_seed(5))
    two = tapi.generate(tc, p, b, torch.from_numpy(x), batch_size=BS,
                        generator=torch.Generator().manual_seed(5))
    for k in one:
        np.testing.assert_array_equal(one[k], two[k], err_msg=k)
    other = tapi.generate(tc, p, b, x, batch_size=BS,
                          generator=torch.Generator().manual_seed(6))
    assert not np.array_equal(one["state"], other["state"])


def test_generate_matches_eval_model_from_a_checkpoint(tmp_path):
    """``load_vae`` → ``generate`` gives what the trainer's ``eval_model``
    gives on the same checkpoint and noise (eval draws each batch's noise
    from a CPU generator seeded with the state's seed)."""
    trainer = CplMixVAE(saving_folder=str(tmp_path), device="cpu", seed=7)
    trainer.init_model(**DIMS, batch_size=BS)
    path = trainer.save_checkpoint("g")
    x = _x()
    res = trainer.eval_model(x, batch_size=BS)
    cfg, params, bn, mask = tapi.load_vae(path, device="cpu")
    draws = []
    for i in range(0, N, BS):
        rows = min(BS, N - i)
        e = torch.zeros((A, BS, S))
        e[:, :rows] = torch.randn((A, rows, S),
                                  generator=torch.Generator().manual_seed(7))
        draws.append(e)
    got = tapi.generate(cfg, params, bn, x, mask=mask, batch_size=BS,
                        noise=draws)
    np.testing.assert_array_equal(got["pred_label"], res["pred_label"])
    np.testing.assert_allclose(got["c_prob"], res["c_prob"], **TOL)
    np.testing.assert_allclose(got["state_mu"], res["state_mu"], **TOL)
    np.testing.assert_allclose(got["state_logvar"], res["state_logvar"],
                               **TOL)


# ---------------------------------------------------------------------------
# state_changes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d_s", [0, 1])
@pytest.mark.parametrize("reparam", ["GAUSSIAN", "UNIFORM"])
def test_state_changes_matches_jax(reparam, d_s):
    jc, tc = _cfgs(reparam_noise=jcfg.ReparamNoise[reparam])
    params, bn = _model(jc, seed=5)
    x = _x(12, seed=2)
    n_samp = 7
    key = jax.random.key(13)
    recon_j, s_j = jmixvae.state_changes(params, bn, jc, jnp.asarray(x),
                                         d_s=d_s, key=key, n_samp=n_samp)
    draw = (jax.random.uniform if reparam == "UNIFORM"
            else jax.random.normal)
    draws = np.stack([np.asarray(draw(k, (A, 12)))
                      for k in jax.random.split(key, n_samp)])
    p, b = _port(params, bn)
    e = _eval_noise(key, 12)
    if reparam == "UNIFORM":   # the eval forward's own draw follows the flag
        _, k_rest = jax.random.split(key)
        ak = jax.random.split(k_rest, (A, 3))
        e = np.stack([np.asarray(jax.random.uniform(ak[a, 1], (12, S)))
                      for a in range(A)])
    recon_t, s_t = tmixvae.state_changes(
        p, b, tc, torch.from_numpy(x), d_s=d_s, n_samp=n_samp,
        noise=torch.from_numpy(e), draws=torch.from_numpy(draws))
    assert recon_t.shape == (A, n_samp, 12, D) and s_t.shape == (A, n_samp, 12)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **TOL)
    np.testing.assert_allclose(recon_t.numpy(), np.asarray(recon_j), **TOL)
    assert bool((s_t[:, 1:] >= s_t[:, :-1]).all())


def test_state_changes_sorts_stably():
    """Equal values keep their draw order (``jnp.argsort`` is stable): with
    every draw equal, sample i is draw i and all reconstructions agree."""
    _, tc = _cfgs()
    params, bn = _model(_cfgs()[0])
    p, b = _port(params, bn)
    x = torch.from_numpy(_x(5))
    recon, s = tmixvae.state_changes(p, b, tc, x, d_s=0, n_samp=4,
                                     noise=torch.zeros((A, 5, S)),
                                     draws=torch.full((4, A, 5), 0.5))
    assert bool((s == s[:, :1]).all())
    assert bool((recon == recon[:, :1]).all())


# ---------------------------------------------------------------------------
# load_vae, the helpers of api.py, param_count
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both_checkpoints(tmp_path_factory):
    """A checkpoint written by the JAX trainer and one by the port's."""
    folder = tmp_path_factory.mktemp("api_ckpts")
    j = JaxCplMixVAE(saving_folder=str(folder / "jax"), seed=3)
    j.init_model(**DIMS, mode="ZINB", n_pr=1, batch_size=BS)
    t = CplMixVAE(saving_folder=str(folder / "port"), device="cpu", seed=3)
    t.init_model(**DIMS, n_pr=2, batch_size=BS)
    return {"jax": j.save_checkpoint("epoch_3"),
            "port": t.save_checkpoint("epoch_5")}


def _assert_tree_bits(t_tree, j_tree):
    j_tree = jax.tree_util.tree_map(np.asarray, j_tree)
    assert set(t_tree) == set(j_tree)
    for n in j_tree:
        for k in j_tree[n]:
            got = t_tree[n][k].numpy()
            assert got.dtype == j_tree[n][k].dtype
            assert got.tobytes() == j_tree[n][k].tobytes(), (n, k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_load_vae_reads_both_packages(both_checkpoints, writer):
    path = both_checkpoints[writer]
    jc, jparams, jbn, jmask = japi.load_vae(path)
    tc, tparams, tbn, tmask = tapi.load_vae(path, device="cpu")
    assert tc == tcfg_mod.VAEConfig(**jc.__dict__)
    _assert_tree_bits(tparams, jparams)
    _assert_tree_bits(tbn, jbn)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert tmask.sum() < C   # the pruned categories came along
    assert tmixvae.param_count(tparams) == jmixvae.param_count(jparams)


def test_load_vae_on_cuda_needs_a_card(both_checkpoints):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.load_vae(both_checkpoints["port"])


def test_run_discovery_matches_jax(both_checkpoints):
    folder = os.path.dirname(both_checkpoints["jax"])
    assert tapi.mk_run(folder) == japi.mk_run(folder)
    tp, tb, tm, tmeta = tapi.get_weights(folder, device="cpu")
    jp, jb, jm, jmeta = japi.get_weights(folder)
    _assert_tree_bits(tp, jp)
    assert tmeta["epoch"] == jmeta["epoch"] == 0
    tv, jv = tapi.view_weights(folder, device="cpu"), japi.view_weights(folder)
    assert tv["summary"] == jv["summary"]
    assert tapi.mk_config(**DIMS) == tcfg_mod.VAEConfig(**DIMS)


def test_simplex_helpers_match_jax():
    p = np.random.default_rng(0).dirichlet(np.ones(C), size=(4, 5))
    p = p.astype(np.float32)
    np.testing.assert_array_equal(tapi.is_normalized(torch.from_numpy(p))
                                  .numpy(),
                                  np.asarray(japi.is_normalized(p)))
    np.testing.assert_allclose(tapi.clr(torch.from_numpy(p)).numpy(),
                               np.asarray(japi.clr(p)), **TOL)
    for bad in (p * 2, -p):
        with pytest.raises(ValueError):
            tapi.clr(torch.from_numpy(bad))
        with pytest.raises(ValueError):
            japi.clr(bad)


def test_reparam_and_sample_normal():
    rng = np.random.default_rng(1)
    mean = rng.normal(size=(4, S)).astype(np.float32)
    logvar = rng.normal(size=(4, S)).astype(np.float32)
    key = jax.random.key(2)
    want = japi.reparam(mean, logvar, key)
    e = torch.from_numpy(np.array(jax.random.normal(key, mean.shape)))
    got = tapi.reparam(torch.from_numpy(mean), torch.from_numpy(logvar), e=e)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    g1 = torch.Generator().manual_seed(3)
    drawn = tapi.reparam(torch.from_numpy(mean), torch.from_numpy(logvar),
                         generator=g1)
    g2 = torch.Generator().manual_seed(3)
    np.testing.assert_array_equal(
        drawn.numpy(), (torch.from_numpy(mean) + torch.randn(
            mean.shape, generator=g2) * torch.exp(
                0.5 * torch.from_numpy(logvar))).numpy())
    # Box-Muller on the same two uniforms
    u1, u2 = torch.rand(2, generator=torch.Generator().manual_seed(4))
    z = tapi.sample_normal(torch.Generator().manual_seed(4))
    assert z == pytest.approx(float(np.sqrt(-2 * np.log(1 - float(u1)))
                                    * np.cos(2 * np.pi * float(u2))),
                              rel=1e-12)
    assert np.isfinite(tapi.sample_normal())


def test_single_vae_apply_matches_jax():
    jc, tc = _cfgs()
    params, bn = _model(jc, seed=6)
    x = _x(9)
    key = jax.random.key(8)
    arm = 1
    jp = jax.tree_util.tree_map(lambda v: v[arm], params)
    jb = jax.tree_util.tree_map(lambda v: v[arm], bn)
    want, _ = japi.single_vae_apply(jc, jp, jb, jnp.asarray(x), key)
    _, k_rest = jax.random.split(key)
    ak = jax.random.split(k_rest, (1, 3))
    e = torch.from_numpy(np.array(jax.random.normal(ak[0, 1], (9, S))))
    tp, tb = _port(jp, jb)
    got, new_bn = tapi.single_vae_apply(tc, tp, tb, torch.from_numpy(x),
                                        noise=e)
    for name in tmixvae.MixVAEOutputs._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **TOL,
                                   err_msg=name)
    assert set(new_bn) == set(tb)


# ---------------------------------------------------------------------------
# Loss helpers and expand_arms
# ---------------------------------------------------------------------------

def test_loss_helpers_match_jax():
    rng = np.random.default_rng(9)
    a, b = (rng.normal(size=(5, 7)).astype(np.float32) for _ in range(2))
    for n_arm in (1, 2, 3, 5):
        assert tlosses.arm_combs(n_arm) == jlosses.arm_combs(n_arm)
    np.testing.assert_allclose(
        tlosses.l2_dist(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jlosses.l2_dist(a, b)), rtol=1e-6)
    ia, ib = (rng.uniform(0.5, 2.0, size=(1, 7)).astype(np.float32)
              for _ in range(2))
    got = tlosses.simplex_dist((torch.from_numpy(a), torch.from_numpy(ia)),
                               (torch.from_numpy(b), torch.from_numpy(ib)))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jlosses.simplex_dist((a, ia),
                                                               (b, ib))),
                               rtol=1e-6)
    v = rng.normal(size=(4, 6, 7)).astype(np.float32)
    naive = tlosses.l2_pair_sum_naive(torch.from_numpy(v))
    np.testing.assert_allclose(float(naive),
                               float(jlosses.l2_pair_sum_naive(v)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(naive), float(tlosses._pair_sums_from_gram(torch.from_numpy(v))),
        rtol=1e-5)


def test_expand_arms_is_a_view_equal_to_jax():
    x = torch.from_numpy(_x(6))
    got = tstep.expand_arms(x, A)
    want = jstep.expand_arms(jax.random.key(0), jnp.asarray(x.numpy()), A)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.data_ptr() == x.data_ptr() and got.stride(0) == 0
