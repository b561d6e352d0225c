"""The port's GAN that trains an augmenter (dvae_tpu_torch/augment/
augmenter.py: generator, discriminator, ``kl_dist``;
dvae_tpu_torch/augment/train.py) against the JAX package's
(dvae_tpu/augment/augmenter.py, dvae_tpu/augment/train.py) at small widths.

Weights come from the JAX initialisers through the weight bridge
(``augmenter_from_jax``).  Every random draw of a JAX call is rebuilt here
from its key splits (augmenter.py:154, :195, :320, :375; train.py:127,
:142-143, :153) and handed to the port explicitly (``AugNoise``,
``GanNoise``), so both packages see the same numbers.

Tolerances:
  * forwards, rtol 1e-5 / atol 1e-5: the same f32 operations, the products
    summed in another order, through batch norms over 24-32 rows;
  * GAN losses in f32, rtol 1e-5: the same, over one to three steps;
  * parameters after Adam, the trainer's rule: max |Δ| ≤ 2·lr a step, and
    in f32 at most 0.1% of the entries beyond 1e-5.  Adam's first update is
    about −lr·sign(g), so a gradient near zero whose sign differs in its
    last bit moves one weight by up to 2·lr.  The biases of the layers that
    feed a batch norm are left out of the share: the norm subtracts the
    batch mean, so their true gradient is 0 and the sign of what is left is
    rounding;
  * bf16: a_loss and d_loss rtol 0.05, as tests/test_augment.py:93-130
    holds the bf16 step against the f32 one.  Every activation is rounded to
    8 bits in both packages, so most gradients differ in their last bits
    and only the 2·lr bound applies to the parameters;
  * the gradients themselves, leaf by leaf, ‖Δ‖ / ‖JAX‖ against the JAX
    step's (read through an identity optimizer), the biases that feed a
    batch norm left out: f32 1e-4 (read: at most 1.2e-5); bf16 0.75 (read:
    at most 0.52, d.fc2.w in MSE).  At these widths a bf16 gradient of the
    augmenter's trunk is as far from the f32 one in both packages (‖Δ‖ /
    ‖f32‖ 0.6-2.0: batch norm's backward subtracts a batch mean that the
    8-bit activations carry), so it is held against JAX's bf16 and not
    against f32.
"""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from dvae_tpu.augment import augmenter as jaug
from dvae_tpu.augment import train as jtrain
from dvae_tpu_torch.augment import augmenter as taug
from dvae_tpu_torch.augment import train as ttrain
from dvae_tpu_torch.train.step import tree_leaves
from dvae_tpu_torch.utils import checkpoint as tckpt

TOL = dict(rtol=1e-5, atol=1e-5)
B, D, LR = 32, 50, 1e-3
SMALL = dict(noise_dim=10, latent_dim=4, input_dim=D, n_dim=20, p_drop=0.2)
# biases whose layer feeds a batch norm (true gradient 0)
_BN_FED = {"fc1", "fc2", "fc3", "fc4", "fc5", "fc5_plain", "fc6", "fc7",
           "fc8", "fc9", "fc10", "fc_mu"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    """A JAX array as a torch tensor: bool stays bool, floats (bf16
    included, exactly) become f32."""
    a = np.array(a)
    return torch.from_numpy(a if a.dtype == bool else a.astype(np.float32))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(seed, rows=B):
    rng = np.random.default_rng(seed)
    return (rng.gamma(2.0, 1.0, (rows, D))
            * (rng.random((rows, D)) > 0.6)).astype(np.float32)


# ---------------------------------------------------------------------------
# Generator, discriminator, kl_dist
# ---------------------------------------------------------------------------

def test_kl_dist_matches_jax():
    rng = np.random.default_rng(0)
    mu1, mu2 = rng.normal(size=(2, 7, 5)).astype(np.float32)
    v1, v2 = rng.uniform(0.1, 2.0, (2, 7, 5)).astype(np.float32)
    want = jaug.kl_dist(*map(jnp.asarray, (mu1, v1, mu2, v2)))
    got = taug.kl_dist(*map(torch.from_numpy, (mu1, v1, mu2, v2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert float(taug.kl_dist(*map(torch.from_numpy,
                                   (mu1, v1, mu1, v1)))) < 1e-5


@pytest.mark.parametrize("train", [False, True])
def test_discriminator_matches_jax(train):
    jc, tc = jaug.DiscriminatorConfig(D), taug.DiscriminatorConfig(D)
    params, bn = _np_tree(jaug.init_discriminator(jax.random.key(1), jc))
    x = _data(2)
    key = jax.random.key(3)
    jh, jp, jbn = jaug.apply_discriminator(params, bn, jc, jnp.asarray(x),
                                           key, train=train)
    tp, tb = tckpt.augmenter_from_jax(params, bn)
    mask = (_t(jax.random.bernoulli(key, 1.0 - jc.p_drop, x.shape))
            if train else None)
    th, tprob, tbn = taug.apply_discriminator(tp, tb, tc, torch.from_numpy(x),
                                              train=train, drop_mask=mask)
    assert tuple(tprob.shape) == (B, 1) and tuple(th.shape) == (B, D // 5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jp), **TOL)
    for name in jbn:
        for leaf in jbn[name]:
            np.testing.assert_allclose(tbn[name][leaf].numpy(),
                                       np.asarray(jbn[name][leaf]), **TOL)
    moved = not np.allclose(tbn["bn1"]["mean"].numpy(), bn["bn1"]["mean"])
    assert moved == train


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("n_zim", [1, 2])
def test_generator_matches_jax(n_zim, train):
    kw = dict(latent_dim=4, input_dim=D, n_dim=12, n_zim=n_zim)
    jc, tc = jaug.GeneratorConfig(**kw), taug.GeneratorConfig(**kw)
    params, bn = _np_tree(jaug.init_generator(jax.random.key(4), jc))
    x = _data(5)
    key = jax.random.key(6)
    js, jx, jbn = jaug.apply_generator(params, bn, jc, jnp.asarray(x), key,
                                       train=train)
    k_drop, k_reparam = jax.random.split(key)
    draws = taug.AugNoise(
        drop_mask=(_t(jax.random.bernoulli(k_drop, 1.0 - jc.p_drop, x.shape))
                   if train else None),
        e=_t(jax.random.normal(k_reparam, (B, jc.latent_dim))))
    tp, tb = tckpt.augmenter_from_jax(params, bn)
    ts, tx, tbn = taug.apply_generator(tp, tb, tc, torch.from_numpy(x),
                                       train=train, draws=draws)
    assert tuple(tx.shape) == (B, D * n_zim)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    assert set(tbn) == set(jbn)
    for name in jbn:
        for leaf in jbn[name]:
            np.testing.assert_allclose(tbn[name][leaf].numpy(),
                                       np.asarray(jbn[name][leaf]), **TOL)


def test_init_generator_and_discriminator_have_the_jax_trees():
    for jc, tc, jinit, tinit in (
            (jaug.GeneratorConfig(input_dim=D, n_zim=2),
             taug.GeneratorConfig(input_dim=D, n_zim=2),
             jaug.init_generator, taug.init_generator),
            (jaug.DiscriminatorConfig(D), taug.DiscriminatorConfig(D),
             jaug.init_discriminator, taug.init_discriminator)):
        jp, jb = jinit(jax.random.key(0), jc)
        tp, tb = tinit(torch.Generator().manual_seed(0), tc, device="cpu")
        assert set(tp) == set(jp) and set(tb) == set(jb)
        for name in jp:
            for leaf in ("w", "b"):
                assert tuple(tp[name][leaf].shape) == jp[name][leaf].shape
            bound = 1.0 / np.sqrt(jp[name]["w"].shape[0])
            assert float(tp[name]["w"].abs().max()) <= bound
        # both directions of the bridge keep the trees
        back_p, back_b = tckpt.augmenter_to_jax(tp, tb)
        assert jax.tree_util.tree_structure(back_p) == \
            jax.tree_util.tree_structure(_np_tree(jp))
        assert jax.tree_util.tree_structure(back_b) == \
            jax.tree_util.tree_structure(_np_tree(jb))


# ---------------------------------------------------------------------------
# The GAN step
# ---------------------------------------------------------------------------

def _jax_noise(key, a_cfg, d_cfg, mode, bf16):
    """What one JAX GAN step draws from ``state.key`` (train.py:127,
    :142-143, :153; augmenter.py:154, :161, :175, :195), as a GanNoise."""
    _, k_a, k_d = jax.random.split(key, 3)
    kf1, kf2, kd1, kd2 = jax.random.split(k_a, 4)
    dt = jnp.bfloat16 if bf16 else jnp.float32

    def aug(k):
        k_drop, k_noise, k_rep = jax.random.split(k, 3)
        return taug.AugNoise(
            _t(jax.random.bernoulli(k_drop, 1.0 - a_cfg.p_drop, (B, D))),
            _t(jax.random.normal(k_noise, (B, a_cfg.noise_dim), dt)),
            _t(jax.random.normal(k_rep, (B, a_cfg.latent_dim), dt)))

    def mask(k):
        return _t(jax.random.bernoulli(k, 1.0 - d_cfg.p_drop, (B, D)))

    u1 = u2 = None
    if mode == "ZINB":
        kb1, kb2 = jax.random.split(kf1)
        u1, u2 = (_t(jax.random.uniform(k, (B, D))) for k in (kb1, kb2))
    return ttrain.GanNoise(aug(kf1), aug(kf2),
                           tuple(mask(k) for k in jax.random.split(k_d, 3)),
                           (mask(kd1), mask(kd2)), u1, u2)


def _both(mode, bf16, variant="smartseq", seed=0):
    """(jax state, jitted jax step, port state, port step, configs)."""
    n_zim = 2 if mode == "ZINB" else 1
    kw = dict(SMALL, n_zim=n_zim, variant=variant)
    jc, tc = jaug.AugmenterConfig(**kw), taug.AugmenterConfig(**kw)
    jd, td = jaug.DiscriminatorConfig(D), taug.DiscriminatorConfig(D)
    ka, kd, kr = jax.random.split(jax.random.key(seed), 3)
    ap, ab = jaug.init_augmenter(ka, jc)
    dp, db = jaug.init_discriminator(kd, jd)
    atx, dtx = optax.adam(LR), optax.adam(LR)
    jstate = jtrain.GanState(ap, ab, dp, db, atx.init(ap), dtx.init(dp), kr)
    jstep = jax.jit(jtrain.make_gan_step(jc, jd, atx, dtx, mode=mode,
                                         bf16=bf16))
    tap, tab = tckpt.augmenter_from_jax(*_np_tree((ap, ab)))
    tdp, tdb = tckpt.augmenter_from_jax(*_np_tree((dp, db)))
    ta, tdx = ttrain.GatedAdam(LR), ttrain.GatedAdam(LR)
    tstate = ttrain.GanState(tap, tab, tdp, tdb, ta.init(tap),
                             tdx.init(tdp), torch.Generator().manual_seed(0))
    tstep = ttrain.make_gan_step(tc, td, ta, tdx, mode=mode, bf16=bf16)
    return jstate, jstep, tstate, tstep, (jc, jd)


def _hold_params(jtree, ttree, steps, share=True):
    worst, beyond, n = 0.0, 0, 0
    for name in jtree:
        for leaf, v in jtree[name].items():
            if v is None:
                assert ttree[name][leaf] is None
                continue
            d = np.abs(np.asarray(v) - ttree[name][leaf].numpy())
            worst = max(worst, float(d.max()))
            if not (leaf == "b" and name in _BN_FED):
                beyond += int((d > 1e-5).sum())
                n += d.size
    assert worst <= 2 * LR * steps, worst
    if share:
        assert beyond <= 1e-3 * n, (beyond, n)


def _snapshot(state):
    return [t.clone() for t in tree_leaves(state.d_params)
            + state.d_opt.mu + state.d_opt.nu + [state.d_opt.count]]


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("gate", ["open", "closed"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["MSE", "ZINB"])
def test_gan_step_matches_jax(mode, bf16, gate, steps, monkeypatch):
    if gate == "closed":
        # no loss exceeds the threshold: the D step is gated off
        monkeypatch.setattr(jtrain, "_LOG2_HALF", 1e9)
        monkeypatch.setattr(ttrain, "_LOG2_HALF", 1e9)
    jstate, jstep, tstate, tstep, (jc, jd) = _both(mode, bf16)
    for s in range(steps):
        x = _data(10 + s)
        noise = _jax_noise(jstate.key, jc, jd, mode, bf16)
        before = _snapshot(tstate)
        bn_before = tstate.d_bn["bn1"]["mean"].clone()
        jstate, jm = jstep(jstate, jnp.asarray(x))
        tstate, tm = tstep(tstate, torch.from_numpy(x), noise)
        jm = {k: float(v) for k, v in jm._asdict().items()}
        tm = {k: float(v) for k, v in tm._asdict().items()}
        assert tm["d_skipped"] == jm["d_skipped"] == (gate == "closed")
        names = ("a_loss", "d_loss") if bf16 else tuple(jm)
        for k in names:
            np.testing.assert_allclose(tm[k], jm[k],
                                       rtol=0.05 if bf16 else 1e-5,
                                       atol=0 if bf16 else 1e-6, err_msg=k)
        if gate == "closed":
            # parameters, both moments and the count bit for bit; the
            # statistics move
            after = _snapshot(tstate)
            assert all(torch.equal(u, v) for u, v in zip(before, after))
            assert not torch.equal(bn_before, tstate.d_bn["bn1"]["mean"])
        else:
            assert int(tstate.d_opt.count) == s + 1
    assert int(tstate.a_opt.count) == steps
    _hold_params(jstate.a_params, tstate.a_params, steps, share=not bf16)
    _hold_params(jstate.d_params, tstate.d_params, steps, share=not bf16)
    for name in jstate.a_bn:
        # after the first step a running mean also carries the drift of its
        # layer's bias (up to 2·lr a step), scaled by the momentum
        mom = taug._BN_HYPERS.get(name, (0, taug.BN_MOMENTUM))[1]
        for leaf in jstate.a_bn[name]:
            assert tstate.a_bn[name][leaf].dtype == torch.float32
            if not bf16:
                np.testing.assert_allclose(
                    tstate.a_bn[name][leaf].numpy(),
                    np.asarray(jstate.a_bn[name][leaf]), rtol=1e-4,
                    atol=1e-5 + (steps - 1) * 2 * LR * mom,
                    err_msg=f"{name}.{leaf}")


class _Recording(ttrain.GatedAdam):
    def update(self, grads, state, params, gate=None):
        self.grads = [g.clone() for g in grads]
        return super().update(grads, state, params, gate)


_IDENTITY = optax.GradientTransformation(lambda p: optax.EmptyState(),
                                        lambda g, s, p=None: (g, s))


def _jax_grads(jstate, jc, jd, mode, bf16, x):
    """The JAX step's gradients, leaf by leaf in ``tree_leaves`` order: with
    an identity optimizer the step adds them to the parameters (both D
    losses exceed the gate at initialisation, so D's are applied too)."""
    step = jax.jit(jtrain.make_gan_step(jc, jd, _IDENTITY, _IDENTITY,
                                        mode=mode, bf16=bf16))
    st = jstate._replace(a_opt=optax.EmptyState(),
                         d_opt=optax.EmptyState())
    new, m = step(st, jnp.asarray(x))
    assert not bool(m.d_skipped)
    out = []
    for tree in ("a_params", "d_params"):
        old, upd = getattr(st, tree), getattr(new, tree)
        out += [(f"{tree[0]}.{n}.{k}", np.asarray(upd[n][k], np.float64)
                 - np.asarray(old[n][k], np.float64))
                for n in sorted(old) for k in sorted(old[n])
                if old[n][k] is not None]
    return out


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["MSE", "ZINB"])
def test_gan_gradients_match_jax(mode, bf16):
    """Both updates' gradients leaf by leaf against the JAX step's from the
    same state, data and draws (module docstring for the tolerances)."""
    jstate, _, tstate, _, (jc, jd) = _both(mode, bf16)
    kw = dict(SMALL, n_zim=2 if mode == "ZINB" else 1, variant="smartseq")
    ta, tdx = _Recording(LR), _Recording(LR)
    step = ttrain.make_gan_step(taug.AugmenterConfig(**kw),
                                taug.DiscriminatorConfig(D), ta, tdx,
                                mode=mode, bf16=bf16)
    x = _data(10)
    step(tstate, torch.from_numpy(x),
         _jax_noise(jstate.key, jc, jd, mode, bf16))
    want = _jax_grads(jstate, jc, jd, mode, bf16, x)
    got = ta.grads + tdx.grads
    assert len(got) == len(want)
    tol, held = (0.75 if bf16 else 1e-4), 0
    for (name, w), g in zip(want, got):
        layer, leaf = name.split(".")[1:]
        if leaf == "b" and layer in _BN_FED:
            continue
        g = g.double().numpy()
        if not w.any():   # no path to the losses (noise.w, the ZINB head)
            assert not g.any(), name
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= tol, (name, err)
        held += 1
    assert held >= 15


def _widened(noise, dtype):
    """A GanNoise (or a part of one) with its floating tensors in dtype."""
    if isinstance(noise, tuple):
        parts = [_widened(v, dtype) for v in noise]
        return type(noise)(*parts) if hasattr(noise, "_fields") \
            else tuple(parts)
    if noise is None or not noise.is_floating_point():
        return noise
    return noise.to(dtype)


@pytest.mark.parametrize("mode", ["MSE", "ZINB"])
def test_f64_gan_step_is_f64_throughout(mode):
    """``cast_gan_state`` to f64 with f64 data and draws: every weight,
    statistic, moment and loss stays f64, the losses match the JAX f32
    step's, and the gradients are the f32 step's to f32 rounding."""
    jstate, jstep, tstate, _, (jc, jd) = _both(mode, False)
    kw = dict(SMALL, n_zim=2 if mode == "ZINB" else 1, variant="smartseq")
    x = _data(10)
    noise = _jax_noise(jstate.key, jc, jd, mode, False)
    grads, metrics = {}, {}
    for dtype in (torch.float32, torch.float64):
        ta, tdx = _Recording(LR), _Recording(LR)
        st = ttrain.cast_gan_state(tstate, dtype)
        step = ttrain.make_gan_step(taug.AugmenterConfig(**kw),
                                    taug.DiscriminatorConfig(D), ta, tdx,
                                    mode=mode)
        st, m = step(st, torch.from_numpy(x).to(dtype),
                     _widened(noise, dtype))
        leaves = (tree_leaves(st.a_params) + tree_leaves(st.d_params)
                  + tree_leaves(st.a_bn) + st.a_opt.mu + st.d_opt.nu)
        assert all(t.dtype == dtype for t in leaves)
        assert all(v.dtype == dtype for v in m[:-1])
        grads[dtype], metrics[dtype] = ta.grads + tdx.grads, m
    # cast_gan_state copies: the f32 state was left as it was
    assert int(tstate.a_opt.count) == 0
    assert tree_leaves(tstate.a_params)[0].dtype == torch.float32
    _, jm = jstep(jstate, jnp.asarray(x))
    for k, v in jm._asdict().items():
        np.testing.assert_allclose(float(getattr(metrics[torch.float64], k)),
                                   float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    names = [f"{n}.{k}" for tree in (tstate.a_params, tstate.d_params)
             for n in sorted(tree) for k in sorted(tree[n])
             if tree[n][k] is not None]
    for name, g32, g64 in zip(names, grads[torch.float32],
                              grads[torch.float64]):
        layer, leaf = name.split(".")
        if g64.any() and not (leaf == "b" and layer in _BN_FED):
            err = float((g32.double() - g64).norm() / g64.norm())
            assert err <= 1e-4, (name, err)


def test_mse_augmenter_gradient_is_that_of_the_recon_term_alone():
    """The binarized fakes carry no gradient: the augmenter's gradient is
    that of λ3·recon = λ3·(mse + bce)/2 alone, through fake2 (no
    straight-through estimator)."""
    _, _, tstate, _, (jc, jd) = _both("MSE", False)
    a_cfg = taug.AugmenterConfig(**SMALL)
    ta, tdx = _Recording(LR), ttrain.GatedAdam(LR)
    step = ttrain.make_gan_step(a_cfg, taug.DiscriminatorConfig(D), ta, tdx,
                                lambdas=(1.0, 0.5, 0.1, 0.5))
    x = torch.from_numpy(_data(20))
    noise = _jax_noise(jax.random.key(9), jc, jd, "MSE", False)
    live = {n: {k: None if v is None else v.clone().requires_grad_()
                for k, v in layer.items()}
            for n, layer in tstate.a_params.items()}
    # the reconstruction term alone, by hand
    _, fake1, bn1 = taug.apply_augmenter(live, tstate.a_bn, a_cfg, x,
                                         train=True, noise=True,
                                         draws=noise.fake1)
    _, fake2, _ = taug.apply_augmenter(live, bn1, a_cfg, x, train=True,
                                       noise=False, draws=noise.fake2)
    f2_bin = ttrain._binarize(fake2.detach(), ttrain.FAKE_BIN_EPS)
    x_bin = ttrain._binarize(x, ttrain.DATA_BIN_EPS)
    recon = (((fake2 - x) ** 2).mean()
             + ttrain.bce(f2_bin, x_bin)) / 2
    want = torch.autograd.grad(0.5 * recon, tree_leaves(live),
                               allow_unused=True)
    step(tstate, x, noise)
    assert len(ta.grads) == len(want)
    for g, w in zip(ta.grads, want):
        w = torch.zeros_like(g) if w is None else w
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=0)
    assert any(float(g.abs().max()) > 0 for g in ta.grads)


def test_train_augmenter_is_a_loop_of_gan_steps():
    """train_augmenter equals, bit for bit, make_gan_step by hand over the
    batches of the same generator's permutations."""
    x = np.concatenate([_data(30), _data(31), _data(32)])[:90]
    a_cfg = taug.AugmenterConfig(**SMALL)
    params, bn, cfg, hist = ttrain.train_augmenter(
        x, a_cfg, n_epochs=3, batch_size=40, seed=5, verbose=False,
        epochs_per_jit=2, device="cpu")
    d_cfg = taug.DiscriminatorConfig(D)
    a_tx, d_tx = ttrain.GatedAdam(1e-3), ttrain.GatedAdam(1e-3)
    state = ttrain.init_gan_state(5, a_cfg, d_cfg, a_tx, d_tx, "cpu")
    step = ttrain.make_gan_step(a_cfg, d_cfg, a_tx, d_tx)
    xt = torch.from_numpy(x)
    rows = []
    for _ in range(3):
        perm = torch.randperm(90, generator=state.generator)
        ms = []
        for s in range(2):
            state, m = step(state, xt[perm[s * 40:(s + 1) * 40]])
            ms.append(torch.stack(m))
        rows.append(torch.stack(ms).mean(dim=0))
    assert len(hist) == 3 and cfg == a_cfg
    for h, r in zip(hist, rows):
        assert list(h.values()) == [float(v) for v in r]
    for name in params:
        for leaf, v in params[name].items():
            assert (v is None and state.a_params[name][leaf] is None) or \
                torch.equal(v, state.a_params[name][leaf])
    for name in bn:
        for leaf in bn[name]:
            assert torch.equal(bn[name][leaf], state.a_bn[name][leaf])


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_gan_training_reduces_recon(bf16, tmp_path):
    """tests/test_augment.py:70 for the port: the differentiable part of the
    recon objective falls over 10 epochs, the history has the JAX keys, and
    the checkpoint reloads as a frozen closure."""
    rng = np.random.default_rng(11)
    x = rng.gamma(2.0, 1.0, (120, D)).astype(np.float32)
    x *= rng.random((120, D)) > 0.6
    path = str(tmp_path / "aug.ckpt")
    _, _, cfg, hist = ttrain.train_augmenter(
        x, taug.AugmenterConfig(**SMALL), n_epochs=10, batch_size=40,
        saving_path=path, verbose=False, bf16=bf16, epochs_per_jit=4,
        device="cpu")
    assert list(hist[0]) == list(jtrain.GanMetrics._fields)
    assert np.isfinite([h["a_loss"] for h in hist]).all()
    assert (np.mean([h["mse_recon"] for h in hist[-3:]])
            < np.mean([h["mse_recon"] for h in hist[:3]]))
    _, meta = tckpt.load_checkpoint(path)
    assert meta["history_tail"] == hist[-5:]
    views = taug.load_augmenter_apply(path, device="cpu")(
        torch.from_numpy(x[:8]), 2, 0.1, torch.Generator().manual_seed(0))
    assert tuple(views.shape) == (2, 8, D)
    assert torch.isfinite(views).all()


def test_zinb_forces_the_dropout_head(capsys):
    x = _data(40, rows=48)
    _, _, cfg, hist = ttrain.train_augmenter(
        x, taug.AugmenterConfig(**SMALL), n_epochs=2, batch_size=100,
        mode="ZINB", verbose=True, device="cpu")
    assert cfg.n_zim == 2 and len(hist) == 2
    out = capsys.readouterr().out.splitlines()
    # the JAX package's line; one batch of all 48 rows an epoch
    assert out[0].startswith("=====> Epoch:0, Generator Loss: ")
    assert "Trip Loss: " in out[1] and "Elapsed Time:" in out[1]


def _views_jax(path, x, key):
    return np.asarray(jaug.load_augmenter_apply(path)(key, jnp.asarray(x), 3,
                                                      0.1))


def _draws(key, cfg, rows):
    _, k_noise, k_rep = jax.random.split(key, 3)
    return taug.AugNoise(
        z=_t(jax.random.normal(k_noise, (3, rows, cfg.noise_dim))),
        e=_t(jax.random.normal(k_rep, (3, rows, cfg.latent_dim))))


@pytest.mark.parametrize("mode", ["MSE", "ZINB"])
def test_port_trained_augmenter_loads_in_jax(mode, tmp_path):
    x = _data(50, rows=64)
    path = str(tmp_path / "port.ckpt")
    _, _, cfg, _ = ttrain.train_augmenter(
        x, taug.AugmenterConfig(**SMALL), n_epochs=2, batch_size=32,
        mode=mode, saving_path=path, verbose=False, device="cpu")
    key = jax.random.key(8)
    want = _views_jax(path, x[:16], key)
    got = taug.load_augmenter_apply(path, device="cpu")(
        torch.from_numpy(x[:16]), 3, 0.1, None, _draws(key, cfg, 16))
    assert jaug.load_augmenter(path)[2].n_zim == cfg.n_zim
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_jax_trained_augmenter_loads_in_the_port(tmp_path):
    x = _data(51, rows=64)
    path = str(tmp_path / "jax.ckpt")
    jtrain.train_augmenter(x, jaug.AugmenterConfig(**SMALL), n_epochs=2,
                           batch_size=32, saving_path=path, verbose=False)
    key = jax.random.key(4)
    want = _views_jax(path, x[:16], key)
    tp, tb, cfg = taug.load_augmenter(path)
    got = taug.augment_arms(tp, tb, cfg, torch.from_numpy(x[:16]), 3, 0.1,
                            draws=_draws(key, cfg, 16))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert os.path.getsize(path) > 0
