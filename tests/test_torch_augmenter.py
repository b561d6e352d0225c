"""The port's frozen augmenter (dvae_tpu_torch/augment/augmenter.py) against
the JAX package's (dvae_tpu/augment/augmenter.py) at small widths.

Weights come from the JAX initialiser through the weight bridge
(utils/checkpoint.augmenter_from_jax); the batch-norm running statistics
are made non-trivial with numpy.  The three random draws are computed here
from the JAX key exactly as the JAX functions split and draw them
(augmenter.py:195, :245, :154, :161, :175) and handed to the port as an
``AugNoise`` bundle.  Tolerance rtol 1e-5 / atol 1e-5: f32 values from the
same operations, the products summed in another order, through eleven
batch norms (train-mode statistics over 24 to 72 rows divide by a standard
deviation that carries the same rounding).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvae_tpu.augment import augmenter as jaug
from dvae_tpu_torch.augment import augmenter as taug
from dvae_tpu_torch.utils import checkpoint as tckpt

TOL = dict(rtol=1e-5, atol=1e-5)
A, B, D = 3, 24, 40
SMALL = dict(input_dim=D, n_dim=20, noise_dim=6, latent_dim=4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model(variant="smartseq", n_zim=1, seed=0):
    """(jax cfg, port cfg, numpy params, numpy bn, x (B, D))."""
    kw = dict(SMALL, variant=variant, n_zim=n_zim)
    jc, tc = jaug.AugmenterConfig(**kw), taug.AugmenterConfig(**kw)
    params, bn = jaug.init_augmenter(jax.random.key(seed), jc)
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed)
    bn = {name: {k: (rng.uniform(0.5, 1.5, v.shape) if k in ("var", "scale")
                     else 0.1 * rng.normal(size=v.shape)).astype(np.float32)
                 for k, v in stats.items()} for name, stats in bn.items()}
    x = (np.maximum(rng.normal(0.5, 1, (B, D)), 0)
         * (rng.random((B, D)) > 0.3)).astype(np.float32)
    return jc, tc, params, bn, x


def _draws(key, cfg, lead, train):
    """What ``apply_augmenter`` / ``augment_arms`` draw from ``key`` for an
    input with leading axes ``lead``."""
    k_drop, k_noise, k_reparam = jax.random.split(key, 3)
    mask = (jax.random.bernoulli(k_drop, 1.0 - cfg.p_drop, lead + (D,))
            if train else None)
    z = jax.random.normal(k_noise, lead + (cfg.noise_dim,), jnp.float32)
    e = jax.random.normal(k_reparam, lead + (cfg.latent_dim,), jnp.float32)
    return taug.AugNoise(*(None if v is None else
                           torch.from_numpy(np.array(v)) for v in (mask, z, e)))


def _port(params, bn):
    return tckpt.augmenter_from_jax(params, bn)


@pytest.mark.parametrize("arm_major", [False, True])
@pytest.mark.parametrize("noise", [True, False])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("variant,n_zim", [("smartseq", 1), ("smartseq", 2),
                                           ("generic", 1), ("generic", 2)])
def test_apply_augmenter_matches_jax(variant, n_zim, train, noise, arm_major):
    jc, tc, params, bn, x = _model(variant, n_zim, seed=n_zim)
    if arm_major:
        x = np.broadcast_to(x, (A, B, D)).copy()
    key = jax.random.key(5)
    js, jx, jbn = jaug.apply_augmenter(params, bn, jc, jnp.asarray(x), key,
                                       train=train, noise=noise, scale=0.7)
    tp, tb = _port(params, bn)
    ts, tx, tbn = taug.apply_augmenter(
        tp, tb, tc, torch.from_numpy(x), train=train, noise=noise, scale=0.7,
        draws=_draws(key, jc, x.shape[:-1], train))
    assert tuple(tx.shape) == x.shape[:-1] + (D * (2 if n_zim > 1 else 1),)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    # the running statistics: updated in train mode, the given ones in eval
    assert set(tbn) == set(jbn)
    for name in jbn:
        for leaf in jbn[name]:
            np.testing.assert_allclose(tbn[name][leaf].numpy(),
                                       np.asarray(jbn[name][leaf]), **TOL,
                                       err_msg=f"{name}.{leaf}")
    used = "bn5" if (variant == "smartseq" or noise) else "bn5_plain"
    moved = not np.allclose(tbn[used]["mean"].numpy(), bn[used]["mean"])
    assert moved == train


@pytest.mark.parametrize("variant,n_zim", [("smartseq", 1), ("smartseq", 2),
                                           ("generic", 2)])
def test_augment_arms_matches_jax_and_the_broadcast_forward(variant, n_zim):
    jc, tc, params, bn, x = _model(variant, n_zim, seed=3)
    key = jax.random.key(9)
    want = jaug.augment_arms(params, bn, jc, key, jnp.asarray(x), A, 0.1)
    tp, tb = _port(params, bn)
    draws = _draws(key, jc, (A, B), train=False)
    got = taug.augment_arms(tp, tb, tc, torch.from_numpy(x), A, 0.1,
                            draws=draws)
    assert tuple(got.shape) == (A, B, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the arms differ, and equal apply_augmenter on the broadcast batch
    assert not torch.allclose(got[0], got[1])
    _, full, _ = taug.apply_augmenter(
        tp, tb, tc, torch.from_numpy(x).expand(A, B, D), scale=0.1,
        draws=draws)
    views = full[..., :D]
    if n_zim > 1:
        views = views * (torch.from_numpy(x) > 0)
        assert bool((got[:, torch.from_numpy(x) == 0] == 0).all())
    np.testing.assert_allclose(got.numpy(), views.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_draws_come_from_the_generator_when_not_given():
    _, tc, params, bn, x = _model()
    tp, tb = _port(params, bn)
    xt = torch.from_numpy(x)
    views = [taug.augment_arms(tp, tb, tc, xt, A,
                               generator=torch.Generator().manual_seed(s))
             for s in (1, 1, 2)]
    assert torch.equal(views[0], views[1])
    assert not torch.equal(views[0], views[2])
    g = torch.Generator().manual_seed(4)
    s1, out1, _ = taug.apply_augmenter(tp, tb, tc, xt, g, train=True)
    s2, out2, _ = taug.apply_augmenter(tp, tb, tc, xt, g, train=True)
    assert not torch.equal(out1, out2) and torch.isfinite(out1).all()
    # smartseq with noise off: a zero z, whatever the generator says
    a = taug.apply_augmenter(tp, tb, tc, xt, noise=False,
                             draws=taug.AugNoise(e=torch.zeros(B, 4)))[1]
    b = taug.apply_augmenter(tp, tb, tc, xt, noise=False,
                             draws=taug.AugNoise(z=torch.ones(B, 6),
                                                 e=torch.zeros(B, 4)))[1]
    assert torch.equal(a, b)


def test_init_augmenter_has_the_jax_tree():
    for variant, n_zim in (("smartseq", 1), ("generic", 2)):
        jc, tc, params, bn, _ = _model(variant, n_zim)
        tp, tb = taug.init_augmenter(torch.Generator().manual_seed(0), tc)
        assert set(tp) == set(params) and set(tb) == set(bn)
        for name in params:
            assert tp[name]["b"] is None if params[name]["b"] is None else \
                tuple(tp[name]["b"].shape) == params[name]["b"].shape
            assert tuple(tp[name]["w"].shape) == params[name]["w"].shape
            bound = 1.0 / np.sqrt(params[name]["w"].shape[0])
            assert float(tp[name]["w"].abs().max()) <= bound
        for name in bn:
            assert set(tb[name]) == set(bn[name])
        assert tp["noise"]["b"] is None and "scale" in tb["bnz"]


def test_checkpoints_cross_the_packages_both_ways(tmp_path):
    jc, tc, params, bn, x = _model("generic", 2, seed=6)
    key = jax.random.key(2)
    want = np.asarray(jaug.augment_arms(params, bn, jc, key, jnp.asarray(x),
                                        A, 0.1))
    draws = _draws(key, jc, (A, B), train=False)
    # written by the JAX package, read by the port
    path = jaug.save_augmenter(str(tmp_path / "jax_aug.ckpt"), params, bn, jc,
                               extra={"mode": "ZINB"})
    tp, tb, cfg = taug.load_augmenter(path)
    assert cfg == tc and tp["noise"]["b"] is None
    got = taug.augment_arms(tp, tb, cfg, torch.from_numpy(x), A, 0.1,
                            draws=draws)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    apply = taug.load_augmenter_apply(path, device="cpu")
    assert torch.equal(apply(torch.from_numpy(x), A, 0.1, None, draws), got)
    # written by the port, read by the JAX package
    back = taug.save_augmenter(str(tmp_path / "port_aug.ckpt"), tp, tb, cfg)
    jp, jb, jcfg2 = jaug.load_augmenter(back)
    assert jcfg2 == jc and jp["noise"]["b"] is None
    again = jaug.augment_arms(jp, jb, jcfg2, key, jnp.asarray(x), A, 0.1)
    np.testing.assert_array_equal(np.asarray(again), want)


@pytest.mark.parametrize("name,n_zim", [("augmenter_MSE.ckpt", 1),
                                        ("augmenter_ZINB.ckpt", 2)])
def test_committed_checkpoints_give_the_jax_views(name, n_zim):
    """Both committed augmenters (bf16 weights on disk) load without JAX's
    dtype package and give the JAX views on 64 cells.  rtol 1e-4 / atol
    1e-4: products of depth 5032 and 1006, summed in another order."""
    path = os.path.join(REPO, "artifacts", "hard_synthetic", name)
    jp, jb, jc = jaug.load_augmenter(path)
    tp, tb, tc = taug.load_augmenter(path)
    assert tc.__dict__ == jc.__dict__
    assert (tc.variant, tc.input_dim, tc.n_dim, tc.noise_dim, tc.latent_dim,
            tc.n_zim) == ("smartseq", 5032, 500, 50, 10, n_zim)
    assert tp["fc1"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(
        tp["fc1"]["w"].numpy(), np.asarray(jp["fc1"]["w"], np.float32))
    rng = np.random.default_rng(1)
    x = (np.maximum(rng.normal(0.5, 1.5, (64, 5032)), 0)
         * (rng.random((64, 5032)) > 0.6)).astype(np.float32)
    key = jax.random.key(3)
    want = np.asarray(jaug.augment_arms(jp, jb, jc, key, jnp.asarray(x), 2,
                                        0.1))
    _, k_noise, k_reparam = jax.random.split(key, 3)
    draws = taug.AugNoise(
        z=torch.from_numpy(np.array(jax.random.normal(k_noise, (2, 64, 50)))),
        e=torch.from_numpy(np.array(jax.random.normal(k_reparam,
                                                      (2, 64, 10)))))
    got = taug.augment_arms(tp, tb, tc, torch.from_numpy(x), 2, 0.1,
                            draws=draws).numpy()
    assert got.shape == (2, 64, 5032) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if n_zim > 1:
        assert (got[:, x == 0] == 0).all()


def test_closures_cast_once_and_keep_the_statistics_f32():
    _, tc, params, bn, x = _model()
    tp, tb = _port(params, bn)
    cast = taug.cast_augmenter_params(tp, torch.bfloat16)
    assert cast["fc1"]["w"].dtype == torch.bfloat16
    assert cast["noise"]["b"] is None and taug.cast_augmenter_params(tp) is tp
    g = torch.Generator().manual_seed(0)
    draws = taug.AugNoise(z=torch.randn((A, B, 6), generator=g),
                          e=torch.randn((A, B, 4), generator=g))
    f32 = taug.make_augment_apply(tp, tb, tc)(torch.from_numpy(x), A, 0.1,
                                              None, draws)
    bf16 = taug.make_augment_apply(tp, tb, tc, torch.bfloat16)(
        torch.from_numpy(x).to(torch.bfloat16), A, 0.1, None, draws)
    assert bf16.dtype == torch.bfloat16 and tb["bn1"]["mean"].dtype == torch.float32
    # bf16 weights and activations: eight mantissa bits through 14 layers
    err = (bf16.float() - f32).abs().max() / f32.abs().max()
    assert float(err) < 0.1
    rand = taug.frozen_random_augment_fn(D, n_dim=20, device="cpu")
    v = rand(torch.from_numpy(x), A, torch.Generator().manual_seed(1))
    assert tuple(v.shape) == (A, B, D) and torch.isfinite(v).all()
    assert bool((v >= 0).all())
