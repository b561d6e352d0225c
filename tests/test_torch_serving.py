"""The PyTorch port's serving path (dvae_tpu_torch) against the JAX package.

Small shapes (A=3 arms, B=16, D=40, F=16, L=8, C=6, S=2).  Inputs, weights
and noise are made with numpy or by the JAX package and handed to both
sides through the weight bridge (utils/checkpoint.params_from_jax).  JAX
runs on the CPU as the JAX tests run it; its fused recon kernel runs in
interpret mode.  Tolerances, with their reason:

  * ``TIGHT`` (rtol 1e-5): f32 values from the same operations summed in
    another order (XLA's and torch's CPU matmuls block differently);
  * ``SHARP`` (rtol 1e-4, atol 1e-6): values downstream of the
    tau = 0.005 sharpening, which multiplies rounding differences of the
    logits by 1/tau = 200;
  * labels and one-hot samples: exact.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dvae_tpu.config as jcfg
from dvae_tpu.eval import evaluate as jevaluate
from dvae_tpu.eval import metrics as jmetrics
from dvae_tpu.models import losses as jlosses
from dvae_tpu.models import mixvae as jmixvae
from dvae_tpu.models import sampling as jsampling
from dvae_tpu.train.cpl_mixvae import CplMixVAE as JaxCplMixVAE

import dvae_tpu_torch.config as tcfg_mod
from dvae_tpu_torch.data.anndata_io import synthetic_dataset
from dvae_tpu_torch.eval import evaluate as tevaluate
from dvae_tpu_torch.eval import metrics as tmetrics
from dvae_tpu_torch.models import losses as tlosses
from dvae_tpu_torch.models import mixvae as tmixvae
from dvae_tpu_torch.models import sampling as tsampling
from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
from dvae_tpu_torch.utils import checkpoint as tckpt

TIGHT = dict(rtol=1e-5, atol=1e-6)
SHARP = dict(rtol=1e-4, atol=1e-6)
A, B, D, F, L, C, S = 3, 16, 40, 16, 8, 6, 2
DIMS = dict(n_arm=A, input_dim=D, fc_dim=F, lowD_dim=L, n_categories=C,
            state_dim=S)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    kw = {**DIMS, **kw}
    return jcfg.VAEConfig(**kw), tcfg_mod.VAEConfig(**kw)


def _model(seed=0):
    """JAX-initialised weights with non-trivial BN running statistics, as
    numpy trees, plus a (B, D) batch."""
    cfg, _ = _cfgs()
    params = jax.tree_util.tree_map(
        np.asarray, jmixvae.init_params(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)
    bn = {k: {"mean": (0.1 * rng.normal(size=v["mean"].shape)).astype(np.float32),
              "var": rng.uniform(0.5, 1.5, v["var"].shape).astype(np.float32)}
          for k, v in jax.tree_util.tree_map(
              np.asarray, jmixvae.init_bn_state(cfg)).items()}
    x = synthetic_dataset(B, D, C, seed=seed).log1p
    return params, bn, x


def _jax_noise(key, n_rows=B):
    """The reparameterization noise JAX's eval forward draws from ``key``:
    split → split(·, (A, 3))[a, 1] → normal (dvae_tpu/models/mixvae.py:356-359)."""
    _, k_rest = jax.random.split(key)
    arm_keys = jax.random.split(k_rest, (A, 3))
    return np.stack([np.asarray(jax.random.normal(arm_keys[a, 1], (n_rows, S)))
                     for a in range(A)])


def _mask(pruned):
    m = np.ones(C, np.float32)
    if pruned:
        m[-2:] = 0.0
    return m


def _both_forward(jc, tc, params, bn, x, mask, skip_recon, prior=None,
                  key_seed=7):
    key = jax.random.key(key_seed)
    xs = jnp.broadcast_to(jnp.asarray(x), (A,) + x.shape)
    jout, _ = jmixvae.apply(params, bn, jc, xs, key, train=False,
                            mask=None if mask is None else jnp.asarray(mask),
                            prior_c=None if prior is None else jnp.asarray(prior),
                            skip_recon=skip_recon)
    tout, _ = tmixvae.apply(
        tckpt.params_from_jax(params), tckpt.bn_from_jax(bn), tc,
        torch.from_numpy(x), train=False,
        mask=None if mask is None else torch.from_numpy(mask),
        prior_c=None if prior is None else torch.from_numpy(prior),
        skip_recon=skip_recon, noise=torch.from_numpy(_jax_noise(key)))
    return jout, tout


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["GAUSSIAN", "UNIFORM"])
def test_reparameterize_matches_jax(kind):
    key = jax.random.key(3)
    rng = np.random.default_rng(3)
    mean = rng.normal(size=(B, S)).astype(np.float32)
    logvar = rng.normal(size=(B, S)).astype(np.float32)
    want = jsampling.reparameterize(key, mean, logvar,
                                    getattr(jcfg.ReparamNoise, kind))
    draw = jax.random.uniform if kind == "UNIFORM" else jax.random.normal
    e = np.array(draw(key, (B, S)))
    got = tsampling.reparameterize(torch.from_numpy(mean),
                                   torch.from_numpy(logvar),
                                   getattr(tcfg_mod.ReparamNoise, kind),
                                   e=torch.from_numpy(e))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)


def test_reparameterize_draws_from_generator():
    mean, logvar = torch.zeros(4, S), torch.zeros(4, S)
    uni = tcfg_mod.ReparamNoise.UNIFORM
    a = tsampling.reparameterize(mean, logvar, uni,
                                 generator=torch.Generator().manual_seed(1))
    b = tsampling.reparameterize(mean, logvar, uni,
                                 generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and bool(((a >= 0) & (a < 1)).all())


@pytest.mark.parametrize("form", ["eval", "soft", "hard"])
def test_gumbel_softmax_matches_jax(form):
    key = jax.random.key(5)
    rng = np.random.default_rng(5)
    phi = rng.dirichlet(np.ones(C), size=(A, B)).astype(np.float32)
    noisy = form != "eval"
    hard = form != "soft"
    want = jsampling.gumbel_softmax(key, phi, 0.7, 1e-8, hard=hard,
                                    gumbel_noise=noisy)
    u = torch.from_numpy(np.array(jax.random.uniform(key, phi.shape)))
    got = tsampling.gumbel_softmax(torch.from_numpy(phi), 0.7, 1e-8,
                                   hard=hard, gumbel_noise=noisy, u=u)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SHARP)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("skip_recon", [False, True])
@pytest.mark.parametrize("pruned", [False, True])
@pytest.mark.parametrize("variational", [True, False])
def test_apply_eval_matches_jax(variational, pruned, skip_recon):
    jc, tc = _cfgs(variational=variational)
    params, bn, x = _model()
    jout, tout = _both_forward(jc, tc, params, bn, x, _mask(pruned),
                               skip_recon)
    for name in ("x_low", "c_prob", "s_mean", "s_logvar", "s_smp", "x_rec"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)), **SHARP,
                                   err_msg=name)
    np.testing.assert_allclose(tout.c.numpy(), np.asarray(jout.c), **SHARP)
    np.testing.assert_array_equal(tout.c_smp.numpy(), np.asarray(jout.c_smp))
    if pruned:
        assert float(tout.c[..., -2:].max()) == 0.0


def test_apply_shared_and_per_arm_batches_agree():
    _, tc = _cfgs()
    params, bn, x = _model(1)
    p, s = tckpt.params_from_jax(params), tckpt.bn_from_jax(bn)
    noise = torch.zeros(A, B, S)
    xt = torch.from_numpy(x)
    shared, _ = tmixvae.apply(p, s, tc, xt, noise=noise)
    per_arm, _ = tmixvae.apply(p, s, tc, xt.expand(A, B, D).contiguous(),
                               noise=noise)
    for a, b in zip(shared, per_arm):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TIGHT)


def test_apply_refuses_train_mode():
    """Train mode runs (tests/test_torch_train.py holds it to JAX); what it
    refuses are the flags of later slices of the port."""
    _, tc = _cfgs()
    params, bn, x = _model()
    p, s, xt = tckpt.params_from_jax(params), tckpt.bn_from_jax(bn), \
        torch.from_numpy(x)
    outs, new_bn = tmixvae.apply(p, s, tc, xt, train=True,
                                 generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(outs.x_rec).all() and new_bn is not s
    # fused_decoder is taken: with skip_trunk the decoder's input rides in
    # the x_rec slot, the other fields as without it on the same noise
    noise = tmixvae.Noise(
        x_mask=torch.rand((A, B, D)) < 0.5, gumbel_u=torch.rand((A, B, C)),
        reparam_e=torch.randn((A, B, S)), s_mask=torch.rand((A, B, S)) < 0.8)
    full, _ = tmixvae.apply(p, s, tc, xt, train=True, noise=noise)
    cut, _ = tmixvae.apply(p, s, tc.replace(fused_decoder=True), xt,
                           train=True, skip_trunk=True, noise=noise)
    assert cut.x_rec.shape == (A, B, C + S) and full.x_rec.shape == (A, B, D)
    assert torch.equal(cut.x_rec[..., :C], full.c_smp)
    assert torch.equal(
        cut.x_rec[..., C:],
        torch.where(noise.s_mask, full.s_smp / 0.8, torch.zeros(())))
    for name in ("x_low", "c", "c_smp", "s_smp", "s_mean", "c_prob"):
        assert torch.equal(getattr(cut, name), getattr(full, name)), name
    # use_pallas is taken: the fused sampler, seeded or on given uniforms
    pc = tc.replace(use_pallas=True)
    a, _ = tmixvae.apply(p, s, pc, xt, train=True,
                         noise=tmixvae.Noise(gumbel_seed=5),
                         generator=torch.Generator().manual_seed(0))
    b, _ = tmixvae.apply(p, s, pc, xt, train=True,
                         noise=tmixvae.Noise(gumbel_seed=5),
                         generator=torch.Generator().manual_seed(0))
    c, _ = tmixvae.apply(p, s, pc, xt, train=True,
                         noise=tmixvae.Noise(gumbel_seed=6),
                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(a.c_smp, b.c_smp) and not torch.equal(a.c_smp, c.c_smp)
    np.testing.assert_allclose(a.c_smp.sum(-1).detach().numpy(), 1.0,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bce_metric", [True, False])
@pytest.mark.parametrize("ref_prior", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_loss_matches_jax(fused, ref_prior, bce_metric):
    jc, tc = _cfgs(ref_prior=ref_prior, recon_bce_metric=bce_metric,
                   fused_recon=fused)
    params, bn, x = _model(2)
    prior = (np.random.default_rng(2).dirichlet(np.ones(C), size=B)
             .astype(np.float32) if ref_prior else None)
    jout, tout = _both_forward(jc, tc, params, bn, x, None, fused, prior)
    xs = jnp.broadcast_to(jnp.asarray(x), (A,) + x.shape)
    want = jlosses.mixvae_loss(
        jc, jout, xs, None if prior is None else jnp.asarray(prior),
        fused_recon_args=(params, jnp.asarray(x)) if fused else None)
    xt = torch.from_numpy(x)
    got = tlosses.mixvae_loss(
        tc, tout, xt, None if prior is None else torch.from_numpy(prior),
        fused_recon_args=((tckpt.params_from_jax(params), xt) if fused
                          else None))
    for name in tlosses.LossOutputs._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **SHARP,
                                   err_msg=name)


@pytest.mark.parametrize("bce_metric", [True, False])
@pytest.mark.parametrize("per_arm", [False, True])
@pytest.mark.parametrize("pruned", [False, True])
def test_fused_decoder_eval_matches_jax(pruned, per_arm, bce_metric):
    """Eval with ``skip_trunk``: the decoder's input rides in the x_rec
    slot as in JAX, and the loss through the whole-decoder op (the JAX
    kernel in interpret mode) equals JAX's, on a shared batch and on
    per-arm targets; the fused_recon route gives the port the same loss."""
    jc, tc = _cfgs(fused_recon=True, fused_decoder=True,
                   recon_bce_metric=bce_metric)
    params, bn, x = _model(4)
    mask = _mask(pruned)
    key = jax.random.key(7)
    xs = jnp.broadcast_to(jnp.asarray(x), (A,) + x.shape)
    if per_arm:
        xs = xs * jnp.asarray([1.0, 0.9, 1.1])[:, None, None]
    jout, _ = jmixvae.apply(params, bn, jc, xs, key, train=False,
                            mask=jnp.asarray(mask), skip_recon=True,
                            skip_trunk=True)
    target = xs if per_arm else jnp.asarray(x)
    want = jlosses.mixvae_loss(jc, jout, xs, None,
                               fused_recon_args=(params, target),
                               fused_trunk=True)
    xt = torch.from_numpy(np.array(target))
    tp, tb = tckpt.params_from_jax(params), tckpt.bn_from_jax(bn)
    noise = torch.from_numpy(_jax_noise(key))
    tout, _ = tmixvae.apply(tp, tb, tc, xt, mask=torch.from_numpy(mask),
                            skip_recon=True, skip_trunk=True, noise=noise)
    assert tuple(tout.x_rec.shape) == (A, B, C + S)
    np.testing.assert_allclose(tout.x_rec.numpy(), np.asarray(jout.x_rec),
                               **SHARP)
    got = tlosses.mixvae_loss(tc, tout, xt, None, fused_recon_args=(tp, xt),
                              fused_trunk=True)
    hid, _ = tmixvae.apply(tp, tb, tc, xt, mask=torch.from_numpy(mask),
                           skip_recon=True, noise=noise)
    recon = tlosses.mixvae_loss(tc, hid, xt, None, fused_recon_args=(tp, xt))
    for name in tlosses.LossOutputs._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **SHARP,
                                   err_msg=name)
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(recon, name).numpy(), rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("pruned", [False, True])
@pytest.mark.parametrize("ref_prior", [False, True])
@pytest.mark.parametrize("mode", ["MSE", "ZINB"])
def test_use_pallas_eval_loss_matches_jax(mode, ref_prior, pruned):
    """The eval loss with the fused coupling distance (the JAX kernel in
    interpret mode), MSE and ZINB, with and without the reference prior
    and a pruned mask, through the fused reconstruction branch."""
    jc, tc = _cfgs(mode=mode, ref_prior=ref_prior, use_pallas=True,
                   fused_recon=True)
    params, bn, x = (_zinb_model if mode == "ZINB" else _model)(2)
    prior = (np.random.default_rng(2).dirichlet(np.ones(C), size=B)
             .astype(np.float32) if ref_prior else None)
    jout, tout = _both_forward(jc, tc, params, bn, x, _mask(pruned), True,
                               prior)
    xs = jnp.broadcast_to(jnp.asarray(x), (A,) + x.shape)
    want = jlosses.mixvae_loss(
        jc, jout, xs, None if prior is None else jnp.asarray(prior),
        fused_recon_args=(params, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    got = tlosses.mixvae_loss(
        tc, tout, xt, None if prior is None else torch.from_numpy(prior),
        fused_recon_args=(tckpt.params_from_jax(params), xt))
    # pruned categories are 0 in every arm, the dead-category input of
    # tests/test_ops.py:55-71: the coupling term (and the total it
    # dominates) is then held to that test's rtol 5e-3
    loose = ("total", "loss_joint", "c_dist") if pruned else ()
    for name in tlosses.LossOutputs._fields:
        tol = dict(rtol=5e-3) if name in loose else SHARP
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **tol,
                                   err_msg=name, equal_nan=True)
    # and the flag changes the route, not the number
    eager = tlosses.mixvae_loss(
        tc.replace(use_pallas=False), tout, xt,
        None if prior is None else torch.from_numpy(prior),
        fused_recon_args=(tckpt.params_from_jax(params), xt))
    np.testing.assert_allclose(got.c_dist.numpy(), eager.c_dist.numpy(),
                               rtol=2e-4)


def test_fused_and_unfused_losses_agree():
    _, tc = _cfgs()
    params, bn, x = _model(3)
    p, s = tckpt.params_from_jax(params), tckpt.bn_from_jax(bn)
    xt, noise = torch.from_numpy(x), torch.zeros(A, B, S)
    outs_u, _ = tmixvae.apply(p, s, tc, xt, noise=noise)
    outs_f, _ = tmixvae.apply(p, s, tc, xt, noise=noise, skip_recon=True)
    unfused = tlosses.mixvae_loss(tc, outs_u, xt)
    fused = tlosses.mixvae_loss(tc, outs_f, xt, fused_recon_args=(p, xt))
    for a, b in zip(unfused, fused):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **TIGHT)


def test_loss_matches_naive_oracles():
    jc, tc = _cfgs(ref_prior=False)
    params, bn, x = _model(4)
    jout, tout = _both_forward(jc, tc, params, bn, x, None, False)
    xt = torch.from_numpy(x)
    total = tlosses.mixvae_loss(tc, tout, xt).total
    naive = tlosses.mixvae_loss_naive(tc, tout, xt)
    np.testing.assert_allclose(naive.numpy(), total.numpy(), **TIGHT)
    xs = jnp.broadcast_to(jnp.asarray(x), (A,) + x.shape)
    np.testing.assert_allclose(
        naive.numpy(), np.asarray(jlosses.mixvae_loss_naive(jc, jout, xs)),
        **SHARP)
    np.testing.assert_allclose(
        tlosses.coupling_distance(tout.c, tc.eps).numpy(),
        tlosses.coupling_distance_naive(tout.c, tc.eps).numpy(), rtol=1e-4)


def test_pair_sums_survive_dead_categories():
    """Centring keeps the pair sum exact when every arm carries the same
    huge constant in dead categories (dvae_tpu/models/losses.py:175-180)."""
    rng = np.random.default_rng(5)
    v = rng.normal(size=(A, B, C)).astype(np.float32)
    v[..., -2:] = -1.8e5
    got = tlosses._pair_sums_from_gram(torch.from_numpy(v))
    want = jlosses.l2_pair_sum_naive(jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


# ---------------------------------------------------------------------------
# ZINB mode: heads, loss
# ---------------------------------------------------------------------------

def _zinb_model(seed=0):
    """As ``_model`` with the two extra ZINB heads and count-like data: half
    of the entries exactly zero."""
    jc, _ = _cfgs(mode="ZINB")
    params = jax.tree_util.tree_map(
        np.asarray, jmixvae.init_params(jax.random.key(seed), jc))
    _, bn, _ = _model(seed)
    rng = np.random.default_rng(seed + 20)
    x = (np.maximum(rng.normal(0.8, 1, (B, D)), 0)
         * (rng.random((B, D)) > 0.5)).astype(np.float32)
    return params, bn, x


def test_zinb_params_have_the_jax_tree():
    jc, tc = _cfgs(mode="ZINB")
    want = jmixvae.init_params(jax.random.key(0), jc)
    got = tmixvae.init_params(torch.Generator().manual_seed(0), tc)
    assert list(got) == list(tmixvae._arm_shapes(tc)) and set(got) == set(want)
    for name in want:
        for leaf in ("w", "b"):
            assert tuple(got[name][leaf].shape) == want[name][leaf].shape
    assert {"fc11_p", "fc11_r"} <= set(got)


def test_zinb_loss_matches_jax():
    rng = np.random.default_rng(8)
    rate = rng.gamma(1.0, 2.0, (B, D)).astype(np.float32)
    p = rng.uniform(0.02, 0.98, (B, D)).astype(np.float32)
    z = rng.uniform(0.02, 0.98, (B, D)).astype(np.float32)
    x = (rng.gamma(1.0, 1.5, (B, D)) * (rng.random((B, D)) > 0.4)).astype(
        np.float32)
    want = jlosses.zinb_loss(*(jnp.asarray(v) for v in (rate, p, z, x)))
    got = tlosses.zinb_loss(*(torch.from_numpy(v) for v in (rate, p, z, x)))
    np.testing.assert_allclose(float(got), float(want), **TIGHT)
    rows = tlosses.zinb_loss(*(torch.from_numpy(v) for v in (rate, p, z, x)),
                             dim=1)
    np.testing.assert_allclose(float(rows.mean()), float(want), **TIGHT)


@pytest.mark.parametrize("skip_recon", [False, True])
def test_apply_eval_zinb_matches_jax(skip_recon):
    jc, tc = _cfgs(mode="ZINB")
    params, bn, x = _zinb_model()
    jout, tout = _both_forward(jc, tc, params, bn, x, _mask(False),
                               skip_recon)
    for name in tmixvae.MixVAEOutputs._fields:
        if name == "c_smp":
            np.testing.assert_array_equal(tout.c_smp.numpy(),
                                          np.asarray(jout.c_smp))
            continue
        got = getattr(tout, name).numpy()
        want = np.asarray(getattr(jout, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, **SHARP, err_msg=name)
    if not skip_recon:
        assert float(tout.p_x.min()) > 0 and float(tout.r_x.max()) < 1


@pytest.mark.parametrize("fused", [False, True])
def test_zinb_mixvae_loss_matches_jax(fused):
    """Both ZINB branches of the loss on the same outputs; under the fused
    kernel ``ll`` is NaN in both packages and ``rec_nll`` carries the loss."""
    jc, tc = _cfgs(mode="ZINB", fused_recon=fused)
    params, bn, x = _zinb_model(2)
    jout, tout = _both_forward(jc, tc, params, bn, x, None, fused)
    xs = jnp.broadcast_to(jnp.asarray(x), (A,) + x.shape)
    want = jlosses.mixvae_loss(
        jc, jout, xs, None,
        fused_recon_args=(params, jnp.asarray(x)) if fused else None)
    xt = torch.from_numpy(x)
    got = tlosses.mixvae_loss(
        tc, tout, xt, None,
        fused_recon_args=((tckpt.params_from_jax(params), xt) if fused
                          else None))
    for name in tlosses.LossOutputs._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **SHARP,
                                   err_msg=name)
    assert bool(torch.isnan(got.ll).all()) == fused
    assert torch.equal(got.rec_nll, got.loss_rec)
    assert bool(torch.isfinite(got.total))


def test_zinb_fused_loss_equals_unfused_and_naive():
    """tests/test_ops.py:465 on the port (rtol 1e-4: the kernels' lgamma is
    the shifted-Stirling form, the unfused loss calls the library's)."""
    jc, tc = _cfgs(mode="ZINB")
    params, bn, x = _zinb_model(3)
    p, s = tckpt.params_from_jax(params), tckpt.bn_from_jax(bn)
    xt, noise = torch.from_numpy(x), torch.zeros(A, B, S)
    outs_u, _ = tmixvae.apply(p, s, tc, xt, noise=noise)
    outs_f, _ = tmixvae.apply(p, s, tc, xt, noise=noise, skip_recon=True)
    unfused = tlosses.mixvae_loss(tc, outs_u, xt)
    fused = tlosses.mixvae_loss(tc, outs_f, xt, fused_recon_args=(p, xt))
    np.testing.assert_allclose(fused.total.numpy(), unfused.total.numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(fused.loss_rec.numpy(),
                               unfused.loss_rec.numpy(), rtol=1e-4)
    assert bool(torch.isfinite(unfused.ll).all())
    naive = tlosses.mixvae_loss_naive(tc, outs_u, xt)
    np.testing.assert_allclose(naive.numpy(), unfused.total.numpy(), **TIGHT)
    jout, _ = _both_forward(jc, tc, params, bn, x, None, False)
    xs = jnp.broadcast_to(jnp.asarray(x), (A,) + x.shape)
    np.testing.assert_allclose(
        naive.numpy(), np.asarray(jlosses.mixvae_loss_naive(jc, jout, xs)),
        **SHARP)


def test_unknown_mode_is_refused():
    _, tc = _cfgs(mode="POISSON")
    params, bn, x = _model()
    with pytest.raises(ValueError, match="unknown reconstruction mode"):
        tmixvae.apply(tckpt.params_from_jax(params), tckpt.bn_from_jax(bn),
                      tc, torch.from_numpy(x))
    with pytest.raises(ValueError, match="unknown reconstruction mode"):
        CplMixVAE(device="cpu").init_model(**DIMS, mode="POISSON")


# ---------------------------------------------------------------------------
# Checkpoints and the serving path end to end
# ---------------------------------------------------------------------------

N_CELLS, EVAL_B = 53, 16   # one 3-batch runner chunk plus a 5-row tail


@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    """Checkpoints written by the JAX CplMixVAE (fused and unfused), and the
    JAX eval_model results read back from them by a fresh instance."""
    x = synthetic_dataset(N_CELLS, D, C, seed=11).log1p
    out = {}
    for fused in (True, False):
        folder = str(tmp_path_factory.mktemp(f"jax_fused{fused}"))
        trainer = JaxCplMixVAE(saving_folder=folder, seed=9)
        trainer.init_model(**DIMS, variational=False, fused=fused,
                           batch_size=EVAL_B)
        path = trainer.save_checkpoint("epoch_0")
        server = JaxCplMixVAE()
        server.load_model(path)
        out[fused] = {"path": path,
                      "eval": server.eval_model(x, batch_size=EVAL_B),
                      "validate": server.validate(x, batch_size=EVAL_B),
                      "summary": jevaluate.summarize_inference(
                          JaxCplMixVAE(), path, x)}
    return x, out


@pytest.mark.parametrize("fused", [True, False])
def test_eval_model_from_jax_checkpoint(jax_checkpoints, fused):
    x, ckpts = jax_checkpoints
    want = ckpts[fused]["eval"]
    cpl = CplMixVAE(device="cpu")
    cpl.load_model(ckpts[fused]["path"])
    assert cpl.cfg.fused_recon == fused
    got = cpl.eval_model(x, batch_size=EVAL_B)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["pred_label"], want["pred_label"])
    np.testing.assert_array_equal(got["mask"], want["mask"])
    for k in ("c_prob", "state_mu", "state_logvar", "x_low",
              "total_loss_rec", "total_loss"):
        np.testing.assert_allclose(got[k], want[k], **SHARP, err_msg=k)
    assert got["consensus"] == pytest.approx(want["consensus"], abs=1e-12)
    np.testing.assert_array_equal(
        cpl._predict_labels(x, 1.0, batch_size=EVAL_B), want["pred_label"])


def test_validate_from_jax_checkpoint(jax_checkpoints):
    x, ckpts = jax_checkpoints
    cpl = CplMixVAE(device="cpu")
    cpl.load_model(ckpts[True]["path"])
    got = cpl.validate(x, batch_size=EVAL_B)
    want = ckpts[True]["validate"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **SHARP, err_msg=k)


def test_summarize_inference_matches_jax(jax_checkpoints):
    x, ckpts = jax_checkpoints
    want = ckpts[True]["summary"]
    got = tevaluate.summarize_inference(CplMixVAE(device="cpu"),
                                        ckpts[True]["path"], x)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["pred_label"], want["pred_label"])
    np.testing.assert_array_equal(got["nprune_indx"], want["nprune_indx"])
    np.testing.assert_allclose(got["per_category_agreement"],
                               want["per_category_agreement"], atol=1e-12)
    assert got["consensus_per_pair"] == pytest.approx(
        want["consensus_per_pair"], abs=1e-12)
    for pair, cm in want["armA_vs_armB"].items():
        np.testing.assert_allclose(got["armA_vs_armB"][pair], cm, atol=1e-12)


def test_host_metrics_match_jax():
    rng = np.random.default_rng(6)
    labels = rng.integers(0, C, size=(A, 200))
    probs = rng.dirichlet(np.ones(C), size=200)
    targets = np.eye(4)[rng.integers(0, 4, size=200)].astype(int)
    np.testing.assert_allclose(tevaluate.mutinfo(probs, targets),
                               jevaluate.mutinfo(probs, targets), atol=1e-10)
    assert tevaluate.avg_consensus(labels) == jevaluate.avg_consensus(labels)
    assert tevaluate.avg_max(probs) == jevaluate.avg_max(probs)
    assert tmetrics.consensus_from_labels(labels, C) == pytest.approx(
        jmetrics.consensus_from_labels(labels, C), abs=1e-12)
    np.testing.assert_allclose(
        tmetrics.per_category_agreement(labels, C),
        jmetrics.per_category_agreement(labels, C), atol=1e-12)
    got = tmetrics.consensus_device_both(torch.from_numpy(labels), C)
    want = jmetrics.consensus_device_both(jnp.asarray(labels), C)
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in want], rtol=1e-6)


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for u, v in zip(a, b):
            _assert_trees_equal(u, v)
    elif a is None:
        assert b is None
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_checkpoint_roundtrip_is_bit_exact(tmp_path):
    cpl = CplMixVAE(saving_folder=str(tmp_path), device="cpu", seed=123)
    cpl.init_model(**DIMS, n_pr=1)
    path = cpl.save_checkpoint("a")
    again = CplMixVAE(saving_folder=str(tmp_path), device="cpu")
    again.load_model(path)
    assert again.cfg == cpl.cfg and again.tcfg == cpl.tcfg
    assert again.state.seed == 123
    _assert_trees_equal(tckpt.params_to_jax(again.state.params),
                        tckpt.params_to_jax(cpl.state.params))
    _assert_trees_equal(tckpt.bn_to_jax(again.state.bn),
                        tckpt.bn_to_jax(cpl.state.bn))
    tree_a, meta_a = tckpt.load_checkpoint(path)
    tree_b, meta_b = tckpt.load_checkpoint(again.save_checkpoint("b"))
    _assert_trees_equal(tree_a, tree_b)
    assert meta_a == meta_b


def test_jax_checkpoint_survives_a_port_roundtrip(jax_checkpoints, tmp_path):
    """Optimizer state comes back as numpy stand-ins and is written back
    unchanged; configs map onto the port's own classes."""
    _, ckpts = jax_checkpoints
    tree, meta = tckpt.load_checkpoint(ckpts[True]["path"])
    assert isinstance(meta["cfg"]["reparam_noise"], tcfg_mod.ReparamNoise)
    kinds = {s.kind for s in tree["opt_state"]
             if isinstance(s, tckpt.ForeignState)}
    assert "optax._src.transform.ScaleByAdamState" in kinds
    cpl = CplMixVAE(saving_folder=str(tmp_path), device="cpu")
    cpl.load_model(ckpts[True]["path"])
    tree2, _ = tckpt.load_checkpoint(cpl.save_checkpoint("resaved"))
    _assert_trees_equal(tree2["opt_state"], tree["opt_state"])
    _assert_trees_equal(tree2["params"], tree["params"])
    np.testing.assert_array_equal(tree2["key_data"], tree["key_data"])


@pytest.fixture(scope="module")
def jax_zinb_checkpoints(tmp_path_factory):
    """ZINB checkpoints written by the JAX CplMixVAE after one epoch of
    training (three heads, Adam moments for them), fused and unfused, with
    the JAX eval_model results read back by a fresh instance."""
    rng = np.random.default_rng(13)
    x = (np.maximum(rng.normal(0.8, 1, (N_CELLS, D)), 0)
         * (rng.random((N_CELLS, D)) > 0.5)).astype(np.float32)
    out = {}
    for fused in (True, False):
        folder = str(tmp_path_factory.mktemp(f"jax_zinb_fused{fused}"))
        trainer = JaxCplMixVAE(saving_folder=folder, seed=9)
        trainer.init_model(**DIMS, mode="ZINB", variational=False,
                           fused=fused, batch_size=EVAL_B, epochs_per_jit=1)
        path = trainer.train(x[:48], n_epoch=1, save_plots=False,
                             early_stop_consensus=0)
        server = JaxCplMixVAE()
        server.load_model(path)
        out[fused] = {"path": path,
                      "eval": server.eval_model(x, batch_size=EVAL_B),
                      "summary": jevaluate.summarize_inference(
                          JaxCplMixVAE(), path, x)}
    return x, out


@pytest.mark.parametrize("fused", [True, False])
def test_eval_model_from_jax_zinb_checkpoint(jax_zinb_checkpoints, fused):
    x, ckpts = jax_zinb_checkpoints
    want = ckpts[fused]["eval"]
    cpl = CplMixVAE(device="cpu")
    assert cpl.load_model(ckpts[fused]["path"]) == 1
    assert cpl.cfg.mode == "ZINB" and cpl.cfg.fused_recon == fused
    assert {"fc11_p", "fc11_r"} <= set(cpl.state.params)
    assert cpl.state.opt_state.count == 3
    got = cpl.eval_model(x, batch_size=EVAL_B)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["pred_label"], want["pred_label"])
    for k in ("c_prob", "state_mu", "state_logvar", "x_low",
              "total_loss_rec", "total_loss"):
        np.testing.assert_allclose(got[k], want[k], **SHARP, err_msg=k)
    assert np.isfinite(got["total_loss_rec"]).all()
    assert got["consensus"] == pytest.approx(want["consensus"], abs=1e-12)


def test_summarize_inference_zinb_matches_jax(jax_zinb_checkpoints):
    """No crash on the ZINB fields (``ll`` NaN under the fused kernel), no
    NaN where the JAX package gives a number."""
    x, ckpts = jax_zinb_checkpoints
    want = ckpts[True]["summary"]
    got = tevaluate.summarize_inference(CplMixVAE(device="cpu"),
                                        ckpts[True]["path"], x)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["pred_label"], want["pred_label"])
    np.testing.assert_allclose(got["total_loss_rec"], want["total_loss_rec"],
                               **SHARP)
    np.testing.assert_allclose(got["per_category_agreement"],
                               want["per_category_agreement"], atol=1e-12)
    for k, v in want.items():
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            assert np.array_equal(np.isnan(got[k]), np.isnan(v)), k


def test_jax_zinb_checkpoint_survives_a_port_roundtrip(jax_zinb_checkpoints,
                                                       tmp_path):
    """Three heads and their Adam moments cross the packages bit for bit."""
    _, ckpts = jax_zinb_checkpoints
    tree, meta = tckpt.load_checkpoint(ckpts[True]["path"])
    assert meta["cfg"]["mode"] == "ZINB"
    cpl = CplMixVAE(saving_folder=str(tmp_path), device="cpu")
    cpl.load_model(ckpts[True]["path"])
    tree2, meta2 = tckpt.load_checkpoint(cpl.save_checkpoint("resaved"))
    _assert_trees_equal(tree2["opt_state"], tree["opt_state"])
    _assert_trees_equal(tree2["params"], tree["params"])
    _assert_trees_equal(tree2["bn"], tree["bn"])
    assert meta2["cfg"]["mode"] == "ZINB" and meta2["epoch"] == meta["epoch"]
    back = JaxCplMixVAE()
    assert back.load_model(cpl.save_checkpoint("resaved")) == 1
    _assert_trees_equal(
        jax.tree_util.tree_map(np.asarray, back.state.params),
        jax.tree_util.tree_map(np.asarray, tree["params"]))


def test_bf16_eval_returns_f32_fields():
    cpl = CplMixVAE(device="cpu")
    cpl.init_model(**DIMS, bf16=True, fused=True)
    x = synthetic_dataset(N_CELLS, D, C, seed=12).log1p
    got = cpl.eval_model(x, batch_size=EVAL_B)
    ref = CplMixVAE(device="cpu")
    ref.init_model(**DIMS, fused=True)
    want = ref.eval_model(x, batch_size=EVAL_B)
    for k in ("c_prob", "state_mu", "x_low"):
        assert got[k].dtype == np.float32 and np.isfinite(got[k]).all()
    # bf16 keeps ~3 significant digits through the encoder
    np.testing.assert_allclose(got["total_loss_rec"], want["total_loss_rec"],
                               rtol=2e-2)


def test_cuda_entry_points_fail_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CplMixVAE()


# ---------------------------------------------------------------------------
# The port stands alone
# ---------------------------------------------------------------------------

_GUARD = """
import importlib.abc, importlib.machinery, json, sys
import numpy as np
import torch
class Refuse(importlib.abc.Loader):
    def create_module(self, spec):
        raise ImportError(f"{{spec.name}} is blocked")
    def exec_module(self, module):
        raise ImportError(f"{{module.__name__}} is blocked")
class Block(importlib.abc.MetaPathFinder):
    # a spec without an origin whose loader raises: importing the module
    # fails, while a probe of the spec alone (torch.profiler's
    # importlib.util.find_spec over optional packages) finds no file
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "optax", "pandas",
                                  "sklearn", "matplotlib", "anndata",
                                  "dvae_tpu"):
            return importlib.machinery.ModuleSpec(name, Refuse())
        return None
sys.meta_path.insert(0, Block())
torch.set_num_threads(1)
import dvae_tpu_torch.analysis.tree_based
import dvae_tpu_torch.analysis.tree_helpers
import dvae_tpu_torch.examples.state_traversal
import dvae_tpu_torch.utils.torch_import
import dvae_tpu_torch.ops.partitioned
import dvae_tpu_torch.parallel.runtime
import dvae_tpu_torch.parallel.sharding
from dvae_tpu_torch.models import api
from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
cpl = CplMixVAE(device="cpu")
cpl.load_model(sys.argv[1])
x = np.random.default_rng(0).random((20, {D})).astype("float32")
res = cpl.eval_model(x, batch_size=8)
gen = api.generate(*api.load_vae(sys.argv[1], device="cpu")[:3], x,
                   batch_size=8)
cpl.tcfg = cpl.tcfg.replace(batch_size=8, epochs_per_jit=1)
cpl.train(x, n_epoch=2, early_stop_consensus=0)
z = CplMixVAE(device="cpu", seed=1)
z.init_model(n_arm=2, input_dim={D}, fc_dim=8, lowD_dim=4, n_categories=4,
             mode="ZINB", fused=True, batch_size=8, epochs_per_jit=1)
z.train(x * (x > 0.5), n_epoch=1, early_stop_consensus=0)
zres = z.eval_model(x * (x > 0.5), batch_size=8)
k = CplMixVAE(device="cpu", seed=2)
k.init_model(n_arm=3, input_dim={D}, fc_dim=8, lowD_dim=4, n_categories=4,
             fused=True, use_pallas=True, align_arms_every=1, batch_size=8,
             epochs_per_jit=1)
k.train(x, x_val=x[:8], n_epoch=2, early_stop_consensus=0)
kres = k.eval_model(x, batch_size=8)
from dvae_tpu_torch.augment.augmenter import (AugmenterConfig, init_augmenter,
                                              save_augmenter)
acfg = AugmenterConfig(input_dim={D}, n_dim=20, noise_dim=6, latent_dim=4)
aug_file = save_augmenter("aug.ckpt", *init_augmenter(
    torch.Generator().manual_seed(3), acfg), acfg)
d = CplMixVAE(saving_folder="dec", aug_file=aug_file, device="cpu", seed=4)
d.init_model(n_arm=2, input_dim={D}, fc_dim=8, lowD_dim=4, n_categories=4,
             fused=True, fused_decoder=True, batch_size=8, epochs_per_jit=1)
dpath = d.train(x, x_val=x[:8], n_epoch=2, early_stop_consensus=0)
ds = CplMixVAE(aug_file=aug_file, device="cpu")
ds.load_model(dpath)
dres = ds.eval_model(x, batch_size=8)
import scipy.sparse as sp
st = CplMixVAE(device="cpu", seed=5)
st.init_model(n_arm=2, input_dim={D}, fc_dim=8, lowD_dim=4, n_categories=4,
              fused=True, stream=True, batch_size=8, epochs_per_jit=1)
xs = sp.csr_matrix(x * (x > 0.5))
st.train(xs, x_val=xs[:8], n_epoch=2, early_stop_consensus=0)
sres = st.eval_model(xs, batch_size=8)
from dvae_tpu_torch.augment.train import train_augmenter
_, _, gcfg, ghist = train_augmenter(
    x, AugmenterConfig(input_dim={D}, n_dim=20, noise_dim=6, latent_dim=4),
    n_epochs=2, batch_size=10, mode="ZINB", verbose=False, device="cpu")
from dvae_tpu_torch import cli
cli.main(["train-augmenter", "--device", "cpu", "--synthetic", "--syn_cells",
          "40", "--syn_genes", "{D}", "--syn_types", "3", "--n_epoch", "1",
          "--batch_size", "20", "--n_dim", "20", "--noise_dim", "6",
          "--z_dim", "4", "--out", "cli_aug.ckpt"])
from dvae_tpu_torch.eval.evaluate import adjusted_mutual_info_score
ami = adjusted_mutual_info_score(res["pred_label"][0], res["pred_label"][-1])
from dvae_tpu_torch.analysis import hierarchy_viz, tree_based
from dvae_tpu_torch.analysis.taxonomy import HTree, simplify_tree
from dvae_tpu_torch.eval import cluster_analysis as ca
from dvae_tpu_torch.examples import clusterability, taxonomy_study
tm = HTree(htree_df={{"x": [0, 1, 0.5, 0.5], "y": [0, 0, 1, 2],
                      "leaf": [True, True, False, False],
                      "label": ["a", "b", "m", "top"],
                      "parent": ["m", "m", "top", None], "col": [None] * 4}})
with open("dend.csv", "w") as f:
    f.write("x,y,leaf,label,parent,col\\n0,0,TRUE,a,m,#1\\n"
            "1,0,TRUE,b,m,\\n0.5,1,,m,top,\\n0.5,2,,top,NA,\\n")
tc = HTree(htree_file="dend.csv")
merged = tree_based.get_merged_types("dend.csv", ["a", "b", "a"],
                                     num_classes=2, node="top")[0]
simple, skipped = simplify_tree(tc)
study = taxonomy_study.run(depth=2, n_cells=80, n_genes=12, n_arm=2,
                           batch_size=20, n_epoch=2, epochs_per_jit=2,
                           folder="taxonomy", save_plots=False,
                           verbose=False, device="cpu")
xl = np.random.default_rng(1).normal(size=(60, 4)) + np.repeat(
    np.eye(4)[:3] * 4, 20, axis=0)
yl = np.repeat(np.arange(3), 20)
lda = ca.kfold_classifier(xl, {{"y": yl}}, kfold=3, kind="lda")[0]["y"]
qda = ca.kfold_classifier(xl, {{"y": yl}}, kfold=3, kind="qda")[0]["y"]
silh = ca.get_SilhScore(xl, yl)[1]
pca_sil = ca.cluster_compare(xl, {{"y": yl}}, num_pc=2)[2]
k_sel = ca.K_selection([4, 6, 8], [[1.0, 2.0, 3.0]], [0.9, 0.97, 0.99],
                       thr=0.95)[3]
try:
    ca.kfold_classifier(xl, {{"y": yl}}, kfold=3, kind="rf")
    rf = "ran"
except ImportError as e:
    rf = "scikit-learn" in str(e)
from dvae_tpu_torch.train.fit import fit_mnist_demo
from dvae_tpu_torch.examples.fsdp_tutorial import (synthetic_mnist,
                                                   train_mnist_fsdp)
demo = fit_mnist_demo("net", max_epochs=1, n_train=128, verbose=False,
                      device="cpu")
fsdp = train_mnist_fsdp(n_epochs=1, batch_size=64,
                        data=synthetic_mnist(128, 0),
                        test_data=synthetic_mnist(64, 1), verbose=False,
                        device="cpu")
from dvae_tpu_torch.data import prep
genes = [f"g{{i}}" for i in range({D})]
xn, gn = prep._normalized(x * (x > 0.5) * 10, genes, 3, False)
try:
    prep.prepare_dataset(x, genes, ["a"] * len(x))
    prep_err = "ran"
except ImportError as e:
    prep_err = "anndata" in str(e)
from dvae_tpu_torch.utils import host_ops, parser, profiling
lab = np.random.default_rng(2).integers(0, 4, (3, 50))
host = [bool(v) for v in (
    host_ops.confmat(lab[0], lab[1], 4).sum() == 50,
    0.0 <= host_ops.pairwise_consensus(lab, 4)[0] <= 1.0,
    host_ops.per_category_agreement(lab, 4).shape == (4,),
    np.isfinite(host_ops.emi_binary([10, 20], [5, 40], 50)).all(),
    host_ops.available() is False)]
with profiling.profile_run("prof") as prof_dir:
    torch.ones(8, 8) @ torch.ones(8, 8)
trace_ms = profiling.trace_total_device_ms(prof_dir)
snap = profiling.memory_snapshot("mem.json")
timer = profiling.StepTimer()
timer.start()
timer.stop(sync_on={{"a": torch.ones(1)}})
parsed = parser.parse(parser.many(parser.any_digit()), "12a")
from dvae_tpu_torch.bench import sweep
from dvae_tpu_torch.config import MeshConfig, VAEConfig
from dvae_tpu_torch.examples import arm_parallelism
from dvae_tpu_torch.parallel import census, collective_cost
from dvae_tpu_torch.parallel.sharding import make_mesh, state_specs
from dvae_tpu_torch.train import step as tstep
from dvae_tpu_torch.utils.checkpoint import restore_sharded, save_sharded
cen = census.run_census(make_mesh(MeshConfig()), budget_s=0.0,
                        log=lambda *_: None, device="cpu")
grid = sweep.gen_configs(strategies=("full", "ddp"))
arm_res = arm_parallelism.benchmark_arm_strategies(
    VAEConfig(n_arm=2, input_dim={D}, n_categories=4, fc_dim=8, lowD_dim=4),
    batch_size=16, n_iters=1, device="cpu")
scfg = VAEConfig(n_arm=2, input_dim={D}, fc_dim=8, lowD_dim=4,
                 n_categories=4)
sopt = tstep.make_optimizer(scfg)
sstate = tstep.init_train_state(6, scfg, sopt)._replace(epoch=3)
smesh = make_mesh(MeshConfig())
sspecs = state_specs(scfg, "full", smesh)
save_sharded("sharded", sstate, {{"epoch": 3}}, specs=sspecs, mesh=smesh)
sback, smeta = restore_sharded("sharded", tstep.init_train_state(
    7, scfg, sopt), specs=sspecs, mesh=smesh)
import os
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "dvae_tpu",
                                    "sklearn", "pandas", "matplotlib",
                                    "anndata"))
print(json.dumps({{"bad": bad, "labels": res["pred_label"].shape,
                  "generate_labels": bool(np.array_equal(
                      gen["pred_label"], res["pred_label"])),
                  "steps": cpl.state.opt_state.count,
                  "zinb_steps": z.state.opt_state.count,
                  "zinb_rec_finite": bool(np.isfinite(
                      zres["total_loss_rec"]).all()),
                  "pallas_steps": k.state.opt_state.count,
                  "pallas_loss_finite": bool(np.isfinite(
                      kres["total_loss"])),
                  "decoder_steps": d.state.opt_state.count,
                  "decoder_flag": bool(ds.cfg.fused_decoder),
                  "decoder_loss_finite": bool(np.isfinite(
                      dres["total_loss"])),
                  "stream_steps": st.state.opt_state.count,
                  "stream_labels": sres["pred_label"].shape,
                  "stream_loss_finite": bool(np.isfinite(
                      sres["total_loss"])),
                  "gan_epochs": len(ghist), "gan_n_zim": gcfg.n_zim,
                  "cli_augmenter": os.path.exists("cli_aug.ckpt"),
                  "ami_finite": bool(np.isfinite(ami)),
                  "tree_mapping_csv_equal": tm.child.tolist()
                  == tc.child.tolist() == ["a", "b", "m", "top"],
                  "merged": merged.tolist(), "skipped": skipped,
                  "simplified": simple.child.tolist(),
                  "nodes": hierarchy_viz.cell_nodes_dict(tc)["a"],
                  "study_leaves": study["n_leaves"],
                  "study_finite": bool(np.isfinite(study["leaf_ami"]).all()
                                       and study["levels"] != []),
                  "lda_qda": [len(lda), len(qda), min(lda + qda) > 0.9],
                  "silhouette": bool(0.5 < silh <= 1.0),
                  "pca_silhouette": bool(0.5 < pca_sil[0] <= 1.0),
                  "k_selection": k_sel, "rf_import_error": rf,
                  "demo_keys": sorted(demo),
                  "demo_finite": bool(np.isfinite(list(demo.values())).all()),
                  "fsdp_epochs": len(fsdp.train_losses),
                  "fsdp_finite": bool(np.isfinite(fsdp.train_losses).all()),
                  "normalized": [list(xn.shape), len(gn)],
                  "prep_import_error": prep_err, "host_ops": host,
                  "trace_ms": trace_ms,
                  "snapshot": sorted(snap) == ["cpu"] or all(
                      k.startswith("cuda:") for k in snap),
                  "timer_n": timer.summary()["n"], "parsed": parsed,
                  "census_skipped": len(cen["skipped"]),
                  "census_clean": cen["clean"], "sweep_grid": len(grid),
                  "arm_keys": sorted(arm_res),
                  "sharded": [smeta["epoch"], sback.epoch, bool(all(
                      torch.equal(a, b) for a, b in zip(
                          tstep.tree_leaves(sback.params),
                          tstep.tree_leaves(sstate.params))))]}}))
""".format(D=D)


def _run_port(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax(jax_checkpoints, tmp_path):
    """A fresh interpreter imports the port, reads a JAX-written checkpoint,
    runs a tiny eval and a few training steps (4: two epochs of two
    batches), then trains (2 steps) and serves a ZINB model, then trains
    (4 steps, an alignment after each epoch) and serves with use_pallas,
    then trains (4 steps), reloads and serves with fused_decoder and a
    frozen augmenter, then trains streamed from a CSR matrix (4 steps,
    validating on CSR rows) and serves the CSR matrix, then trains an
    augmenter (ZINB, 2 epochs) through the API and through ``cli
    train-augmenter`` and scores an AMI, without loading JAX, optax,
    sklearn, pandas, matplotlib or dvae_tpu: once torch is loaded,
    importing any of them raises.  The taxonomy and clusterability path
    runs there too: ``HTree`` from a mapping and from a dend CSV,
    ``tree_based.get_merged_types``, ``simplify_tree``, ``cell_nodes_dict``,
    ``taxonomy_study.run(save_plots=False)`` at a tiny size, LDA, QDA, the
    silhouette, ``cluster_compare``'s PCA and ``K_selection``; the random
    forest raises ``ImportError`` naming scikit-learn.  The single-device
    tools run there as well, with anndata blocked too: ``fit_mnist_demo``
    and ``train_mnist_fsdp`` (one epoch each, tiny), ``prep._normalized``
    and ``prepare_dataset``'s ``ImportError``, the host-op twins,
    ``profile_run`` with ``trace_total_device_ms``, ``memory_snapshot``,
    ``StepTimer`` and the parser.  It also imports
    the analysis and interop modules (``models.api``,
    ``analysis.tree_based``, ``analysis.tree_helpers``,
    ``utils.torch_import``, ``examples.state_traversal``) and the mesh
    layer (``parallel.runtime``, ``parallel.sharding``,
    ``ops.partitioned``), and serves the JAX checkpoint through
    ``load_vae`` → ``generate``, whose labels are ``eval_model``'s.  The
    multi-device tools run in a world of one: ``run_census`` with no
    budget, ``gen_configs``, ``benchmark_arm_strategies`` at test width,
    and ``save_sharded`` / ``restore_sharded`` of a state."""
    _, ckpts = jax_checkpoints
    proc = _run_port(["-c", _GUARD, ckpts[True]["path"]], str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"bad": [], "labels": [A, 20], "generate_labels": True,
                   "steps": 4,
                   "zinb_steps": 2, "zinb_rec_finite": True,
                   "pallas_steps": 4, "pallas_loss_finite": True,
                   "decoder_steps": 4, "decoder_flag": True,
                   "decoder_loss_finite": True, "stream_steps": 4,
                   "stream_labels": [2, 20], "stream_loss_finite": True,
                   "gan_epochs": 2, "gan_n_zim": 2, "cli_augmenter": True,
                   "ami_finite": True, "tree_mapping_csv_equal": True,
                   "merged": ["m", "m", "m"], "skipped": ["top", "root"],
                   "simplified": ["a", "b", "m"],
                   "nodes": ["m", "top", "root"],
                   "study_leaves": 4, "study_finite": True,
                   "lda_qda": [3, 3, True], "silhouette": True,
                   "pca_silhouette": True, "k_selection": 6,
                   "rf_import_error": True,
                   "demo_keys": ["avg_epoch_time", "avg_memory_usage"],
                   "demo_finite": True, "fsdp_epochs": 1, "fsdp_finite": True,
                   "normalized": [[20, 3], 3], "prep_import_error": True,
                   "host_ops": [True] * 5, "trace_ms": 0.0, "snapshot": True,
                   "timer_n": 1, "parsed": [["1", "2"], "a"],
                   "census_skipped": 21, "census_clean": False,
                   "sweep_grid": 2,
                   "arm_keys": ["loop_ms", "speedup_vmap_over_loop",
                                "vmap_ms"],
                   "sharded": [3, 3, True]}


def test_cli_evaluate_on_cpu(jax_checkpoints, tmp_path):
    _, ckpts = jax_checkpoints
    proc = _run_port(["-m", "dvae_tpu_torch.cli", "evaluate", "--device",
                      "cpu", "--ckpt", ckpts[True]["path"], "--synthetic",
                      "--syn_cells", "30", "--syn_genes", str(D),
                      "--syn_types", str(C), "--n_arm", str(A),
                      "--out_dir", str(tmp_path / "evaluation")],
                     str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["arms"] == A and len(res["mi"]) == A
    assert 0.0 <= res["consensus"] <= 1.0
    assert (tmp_path / "evaluation" / f"A{A}-RUN0-E0.npy").exists()
