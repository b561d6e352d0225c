"""The PyTorch port's training path (dvae_tpu_torch) against the JAX package.

Small shapes (A=3 arms, B=70, D=120, F=24, L=6, C=10, S=2, the shapes of
tests/test_ops.py:270).  Weights come from the JAX package through the
weight bridge; every random number of a train-mode forward (dropout masks,
Gumbel uniforms, reparameterization noise) is rebuilt from the JAX key the
way dvae_tpu/models/mixvae.apply splits it, and handed to the port as a
``Noise`` bundle.  JAX runs on the CPU; its Pallas kernels run in interpret
mode.  Tolerances, with their reason:

  * ``SHARP`` (rtol 1e-4, atol 1e-5): values downstream of the tau = 0.005
    sharpening, which multiplies rounding differences by 1/tau = 200, and
    of five train-mode batch norms, whose outputs of order 1 carry
    absolute rounding differences up to 1e-5 near zero;
  * ``GRAD`` (rtol 5e-4, atol 1e-5): loss gradients, as
    tests/test_ops.py:297-300 holds the fused path against the unfused,
    with the atol taken relative to the largest gradient of each leaf: at
    tau = 0.005 the encoder gradients reach 1e11 (the sharpening and the
    coupling term's precision scaling) and are sums of such terms that
    cancel, so an entry near zero carries the last bits of 1e11-sized
    terms summed in another order;
  * Adam against optax on the same gradients (rtol 1e-5, atol 1e-7): the
    same arithmetic, a few f32 roundings apart (bias corrections, square
    root, division, fused multiply-adds); where random gradients of
    opposite signs cancel in the first moment, those roundings reach 1e-4
    of an update of size lr = 1e-3;
  * the loss over k = 3 steps (``TRAJ``, rtol 1e-3): Adam's first update
    is about −lr·sign(g), so gradients near zero whose sign differs in the
    last bit move single weights by up to 2·lr; the trajectory, not the
    weights, is what stays comparable.
"""

import json
import os
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import dvae_tpu.config as jcfg
from dvae_tpu.augment import augmenter as jaug
from dvae_tpu.eval import metrics as jmetrics
from dvae_tpu.models import mixvae as jmixvae
from dvae_tpu.ops import encoder_pallas
from dvae_tpu.train import step as jstep
from dvae_tpu.train.cpl_mixvae import CplMixVAE as JaxCplMixVAE

import dvae_tpu_torch.config as tcfg_mod
from dvae_tpu_torch.augment import augmenter as taug
from dvae_tpu_torch.data.anndata_io import (hard_synthetic_dataset,
                                            synthetic_dataset)
from dvae_tpu_torch.data import pipeline as tpipeline
from dvae_tpu_torch.eval import metrics as tmetrics
from dvae_tpu_torch.models import mixvae as tmixvae
from dvae_tpu_torch.train import step as tstep
from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
from dvae_tpu_torch.utils import checkpoint as tckpt

SHARP = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=5e-4, atol=1e-5)
ADAM = dict(rtol=1e-5, atol=1e-7)
TRAJ = 1e-3
A, B, D, F, L, C, S = 3, 70, 120, 24, 6, 10, 2
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


def _model(seed=0, n=B):
    cfg, _ = _cfgs()
    params = jax.tree_util.tree_map(
        np.array, jmixvae.init_params(jax.random.key(seed), cfg))
    bn = jax.tree_util.tree_map(np.array, jmixvae.init_bn_state(cfg))
    x = np.maximum(np.random.default_rng(seed + 1).normal(0.5, 1, (n, D)),
                   0).astype(np.float32)
    return params, bn, x


def _noise(key, cfg, n_rows=B):
    """The random numbers JAX's train-mode apply draws from ``key``
    (dvae_tpu/models/mixvae.py:336-423), as a port ``Noise`` bundle."""
    A, D, C, S = cfg.n_arm, cfg.input_dim, cfg.n_categories, cfg.state_dim
    k_gumbel, k_rest = jax.random.split(key)
    arm_keys = jax.random.split(k_rest, (A, 3))
    if cfg.fused_encoder:
        seed = jax.random.bits(jax.random.fold_in(k_gumbel, 1),
                               dtype=jnp.uint32).astype(jnp.int32)
        x_mask = encoder_pallas.dropout_mask_host(seed, (A, n_rows, D),
                                                  cfg.x_drop)
    else:
        x_mask = jnp.stack([jax.random.bernoulli(
            arm_keys[a, 0], 1 - cfg.x_drop, (n_rows, D)) for a in range(A)])
    if cfg.use_pallas:
        # off the TPU the fused sampler draws its uniforms from a key made
        # of its seed (dvae_tpu/ops/gumbel_pallas.py:96-99, mixvae.py:317)
        seed = jax.random.bits(k_gumbel, dtype=jnp.uint32).astype(jnp.int32)
        u = jax.random.uniform(jax.random.key(seed.reshape(())),
                               (A, n_rows, C), jnp.float32)
    else:
        u = jax.random.uniform(k_gumbel, (A, n_rows, C))
    e = jnp.stack([jax.random.normal(arm_keys[a, 1], (n_rows, S))
                   for a in range(A)])
    s_mask = jnp.stack([jax.random.bernoulli(
        arm_keys[a, 2], 1 - cfg.s_drop, (n_rows, S)) for a in range(A)])
    return tmixvae.Noise(*(torch.from_numpy(np.array(v))
                           for v in (x_mask, u, e, s_mask)))


def _tree_close(got, want, scaled=False, **tol):
    """Leaf-wise assert_allclose; ``scaled`` multiplies the atol by each
    leaf's largest magnitude."""
    for name in want:
        for leaf in want[name]:
            w = np.asarray(want[name][leaf])
            t = dict(tol)
            if scaled:
                t["atol"] = tol["atol"] * float(np.abs(w).max())
            np.testing.assert_allclose(np.asarray(got[name][leaf]), w,
                                       err_msg=f"{name}.{leaf}", **t)


# ---------------------------------------------------------------------------
# Forward and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
def test_train_apply_matches_jax(groups, fused):
    jc, tc = _cfgs(bn_groups=groups, fused_encoder=fused, fused_recon=fused)
    params, bn, x = _model(groups)
    key = jax.random.key(11)
    xs = jnp.broadcast_to(jnp.asarray(x), (A, B, D))
    jout, jbn = jmixvae.apply(params, bn, jc, xs, key, train=True,
                              skip_recon=fused,
                              x_shared=jnp.asarray(x) if fused else None)
    tout, tbn = tmixvae.apply(tckpt.params_from_jax(params),
                              tckpt.bn_from_jax(bn), tc, torch.from_numpy(x),
                              train=True, skip_recon=fused,
                              noise=_noise(key, jc))
    for name in ("x_low", "c_prob", "c", "c_smp", "s_mean", "s_logvar",
                 "s_smp", "x_rec"):
        np.testing.assert_allclose(getattr(tout, name).detach().numpy(),
                                   np.asarray(getattr(jout, name)), **SHARP,
                                   err_msg=name)
    _tree_close(tbn, jbn, **SHARP)
    assert any(not np.allclose(tbn[k]["var"], 1.0) for k in tbn)


@pytest.mark.parametrize("fused", [False, True])
def test_loss_fn_value_and_grads_match_jax(fused):
    jc, tc = _cfgs(fused_encoder=fused, fused_recon=fused)
    params, bn, x = _model(3)
    key = jax.random.key(7)
    xs = jnp.broadcast_to(jnp.asarray(x), (A, B, D))
    mask = np.ones(C, np.float32)
    (jt, (jaux, jbn, jlab)), jg = jax.value_and_grad(
        jstep.loss_fn, has_aux=True)(params, bn, jc, xs, key, 1.0,
                                     jnp.asarray(mask), None, None,
                                     jnp.asarray(x))
    live = {n: {k: v.requires_grad_() for k, v in layer.items()}
            for n, layer in tckpt.params_from_jax(params).items()}
    tt, (taux, tbn, tlab) = tstep.loss_fn(
        live, tckpt.bn_from_jax(bn), tc, torch.from_numpy(x), 1.0,
        torch.from_numpy(mask), None, noise=_noise(key, jc))
    leaves = tstep.tree_leaves(live)
    grads = tstep.tree_like(live, torch.autograd.grad(tt, leaves))
    np.testing.assert_allclose(float(tt.detach()), float(jt), rtol=1e-5)
    for name in ("loss_rec", "kl", "c_dist", "neg_entropy", "c_l2_dist"):
        np.testing.assert_allclose(getattr(taux, name).detach().numpy(),
                                   np.asarray(getattr(jaux, name)), **SHARP,
                                   err_msg=name)
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
    _tree_close(tbn, jbn, **SHARP)
    _tree_close(grads, jax.tree_util.tree_map(np.asarray, jg), scaled=True,
                **GRAD)


# ---------------------------------------------------------------------------
# ZINB mode.  ZGRAD: rtol 3e-3 as tests/test_ops.py:503-506 holds the fused
# ZINB path against the unfused, atol 1e-4 of each leaf's largest gradient
# (the JAX test takes 2e-3 absolute).  Looser than GRAD because the loss
# sums lnΓ terms of size 1e3-1e4 that cancel, and the two packages' lgamma
# and digamma (XLA's and ATen's library versions unfused, reciprocal with
# a Newton step against division fused) differ in their last bits.
# ---------------------------------------------------------------------------

ZGRAD = dict(rtol=3e-3, atol=1e-4)


def _zinb_model(seed=0, n=B):
    jc, _ = _cfgs(mode="ZINB")
    params = jax.tree_util.tree_map(
        np.array, jmixvae.init_params(jax.random.key(seed), jc))
    bn = jax.tree_util.tree_map(np.array, jmixvae.init_bn_state(jc))
    rng = np.random.default_rng(seed + 1)
    x = (np.maximum(rng.normal(0.5, 1, (n, D)), 0)
         * (rng.random((n, D)) > 0.5)).astype(np.float32)
    return params, bn, x


@pytest.mark.parametrize("fused", [False, True])
def test_train_apply_zinb_matches_jax(fused):
    jc, tc = _cfgs(mode="ZINB", fused_encoder=fused, fused_recon=fused)
    params, bn, x = _zinb_model(1)
    key = jax.random.key(11)
    xs = jnp.broadcast_to(jnp.asarray(x), (A, B, D))
    jout, jbn = jmixvae.apply(params, bn, jc, xs, key, train=True,
                              skip_recon=fused,
                              x_shared=jnp.asarray(x) if fused else None)
    tout, tbn = tmixvae.apply(tckpt.params_from_jax(params),
                              tckpt.bn_from_jax(bn), tc, torch.from_numpy(x),
                              train=True, skip_recon=fused,
                              noise=_noise(key, jc))
    for name in tmixvae.MixVAEOutputs._fields:
        got = getattr(tout, name).detach().numpy()
        want = np.asarray(getattr(jout, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, **SHARP, err_msg=name)
    _tree_close(tbn, jbn, **SHARP)


@pytest.mark.parametrize("fused", [False, True])
def test_zinb_loss_fn_value_and_grads_match_jax(fused):
    jc, tc = _cfgs(mode="ZINB", fused_encoder=fused, fused_recon=fused)
    params, bn, x = _zinb_model(3)
    key = jax.random.key(7)
    xs = jnp.broadcast_to(jnp.asarray(x), (A, B, D))
    mask = np.ones(C, np.float32)
    (jt, (jaux, jbn, jlab)), jg = jax.value_and_grad(
        jstep.loss_fn, has_aux=True)(params, bn, jc, xs, key, 1.0,
                                     jnp.asarray(mask), None, None,
                                     jnp.asarray(x))
    live = {n: {k: v.requires_grad_() for k, v in layer.items()}
            for n, layer in tckpt.params_from_jax(params).items()}
    tt, (taux, tbn, tlab) = tstep.loss_fn(
        live, tckpt.bn_from_jax(bn), tc, torch.from_numpy(x), 1.0,
        torch.from_numpy(mask), None, noise=_noise(key, jc))
    leaves = tstep.tree_leaves(live)
    grads = tstep.tree_like(live, torch.autograd.grad(tt, leaves))
    np.testing.assert_allclose(float(tt.detach()), float(jt), rtol=1e-5)
    for name in ("loss_rec", "rec_nll", "kl", "c_dist", "neg_entropy"):
        np.testing.assert_allclose(getattr(taux, name).detach().numpy(),
                                   np.asarray(getattr(jaux, name)), **SHARP,
                                   err_msg=name)
    assert bool(torch.isnan(taux.ll).all()) == fused
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
    assert all(float(grads[h]["w"].abs().max()) > 0
               for h in ("fc11", "fc11_p", "fc11_r"))
    _tree_close(grads, jax.tree_util.tree_map(np.asarray, jg), scaled=True,
                **ZGRAD)


def test_zinb_k_step_loss_trajectory_matches_jax():
    """Three Adam steps of the fused ZINB path from bridged weights with the
    same noise: the losses track JAX's (TRAJ, as the MSE twin) and the three
    heads' parameters and moments stay within Adam's first-step bound."""
    jc, tc = _cfgs(mode="ZINB", fused_encoder=True, fused_recon=True)
    tx = jstep.make_optimizer(jc)
    jstate = jstep.init_train_state(jax.random.key(2), jc, tx)
    params = jax.tree_util.tree_map(np.array, jstate.params)
    opt = tstep.make_optimizer(tc)
    tp = tckpt.params_from_jax(params)
    tstate = tstep.TrainState(
        tp, tckpt.bn_from_jax(jax.tree_util.tree_map(np.array, jstate.bn)),
        torch.ones(C), 0, 0, opt.init(tp))
    assert set(tstate.opt_state.mu) == set(params)   # moments for 16 layers
    xb = np.stack([_zinb_model(10 + i)[2] for i in range(3)])
    jstate, tstate, jl, tl = _jax_then_port_steps(jstate, tstate, jc, tc, xb,
                                                  3)
    np.testing.assert_allclose(tl, jl, rtol=TRAJ)
    assert tstate.opt_state.count == 3
    for head in ("fc11", "fc11_p", "fc11_r"):
        d = np.abs(tstate.params[head]["w"].numpy()
                   - np.asarray(jstate.params[head]["w"]))
        # 3 steps of at most lr each way where a gradient's sign differs
        assert d.max() <= 2 * 3 * jc.lr and np.mean(d > 1e-5) < 0.01, head
        assert float(tstate.opt_state.nu[head]["w"].max()) > 0


def test_mask_params_and_grads_match_jax():
    jc, tc = _cfgs()
    params, _, _ = _model(4)
    mask = np.ones(C, np.float32)
    mask[[2, 7]] = 0.0
    want = jstep._mask_params(params, jnp.asarray(mask), jc)
    tp = tckpt.params_from_jax(params)
    got = tstep._mask_params(tp, torch.from_numpy(mask), tc)
    _tree_close(got, want, rtol=0, atol=0)
    _tree_close(tstep._mask_grads(tp, torch.from_numpy(mask), tc),
                jstep._mask_grads(params, jnp.asarray(mask), jc),
                rtol=0, atol=0)
    tstep._mask_params(tp, torch.from_numpy(mask), tc, inplace=True)
    _tree_close(tp, want, rtol=0, atol=0)


def test_device_consensus_matches_jax():
    rng = np.random.default_rng(6)
    labels = rng.integers(0, C, size=(A, 300))
    want = jmetrics.consensus_device(jnp.asarray(labels), C)
    got = tmetrics.consensus_device(torch.from_numpy(labels), C)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        float(tmetrics.consensus_device(torch.from_numpy(labels), C, True)),
        float(jmetrics.consensus_device(jnp.asarray(labels), C, True)),
        rtol=1e-6)
    np.testing.assert_array_equal(
        tmetrics.confmat_device(torch.from_numpy(labels[0]),
                                torch.from_numpy(labels[1]), C).numpy(),
        np.asarray(jmetrics.confmat_device(jnp.asarray(labels[0]),
                                           jnp.asarray(labels[1]), C)))


# ---------------------------------------------------------------------------
# Optimizer and steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_adam_matches_optax_on_the_same_gradients(name):
    jc, tc = _cfgs()
    params, _, _ = _model(5)
    tx = jstep.make_optimizer(jc, name)
    opt = tstep.make_optimizer(tc, name)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    tp = tckpt.params_from_jax(params)
    ts = opt.init(tp)
    rng = np.random.default_rng(8)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = opt.update(tckpt.params_from_jax(g), ts, tp)
    _tree_close(tp, jp, **ADAM)
    assert ts.count == int(js[0].count) == 3
    _tree_close(ts.mu, js[0].mu, **ADAM)
    _tree_close(ts.nu, js[0].nu, **ADAM)


def _jax_then_port_steps(jstate, tstate, jc, tc, xb, k):
    """k train steps on the same batches from the same state in both
    packages; the port's noise is rebuilt from the JAX step's key."""
    tcfg = jcfg.TrainConfig(batch_size=xb.shape[1])
    tx = jstep.make_optimizer(jc)
    jfn = jax.jit(jstep.make_train_step(jc, tcfg, tx))
    tfn = tstep.make_train_step(tc, tcfg_mod.TrainConfig(
        batch_size=xb.shape[1]), tstep.make_optimizer(tc))
    jl, tl = [], []
    for i in range(k):
        _, _, k_fwd = jax.random.split(jstate.key, 3)
        noise = _noise(k_fwd, jc, xb.shape[1])
        jstate, jm, _ = jfn(jstate, jnp.asarray(xb[i]), None, 1.0)
        tstate, tm, _ = tfn(tstate, torch.from_numpy(xb[i]), None, 1.0,
                            noise=noise)
        jl.append(float(jm.total))
        tl.append(float(tm.total))
    return jstate, tstate, np.array(jl), np.array(tl)


def test_k_step_loss_trajectory_matches_jax():
    jc, tc = _cfgs(fused_encoder=True, fused_recon=True)
    tx = jstep.make_optimizer(jc)
    jstate = jstep.init_train_state(jax.random.key(2), jc, tx)
    params = jax.tree_util.tree_map(np.array, jstate.params)
    opt = tstep.make_optimizer(tc)
    tp = tckpt.params_from_jax(params)
    tstate = tstep.TrainState(
        tp, tckpt.bn_from_jax(jax.tree_util.tree_map(np.array, jstate.bn)),
        torch.ones(C), 0, 0, opt.init(tp))
    xb = np.stack([_model(10 + i)[2] for i in range(3)])
    _, tstate, jl, tl = _jax_then_port_steps(jstate, tstate, jc, tc, xb, 3)
    np.testing.assert_allclose(tl, jl, rtol=TRAJ)
    assert tstate.opt_state.count == 3


def test_epoch_runner_shapes_and_noise_chain():
    _, tc = _cfgs()
    tcfg = tcfg_mod.TrainConfig(batch_size=32, epochs_per_jit=2,
                                shuffle_block=4)
    opt = tstep.make_optimizer(tc)
    x = torch.from_numpy(_model(6, n=100)[2])
    run = tstep.make_epoch_runner(tc, tcfg, opt, 100)
    s0 = tstep.init_train_state(1, tc, opt)
    s1, ems = run(s0, x, None, 1.0)
    assert s1.epoch == 2 and s1.opt_state.count == 6
    assert tuple(ems.total.shape) == (2,) and tuple(ems.kl.shape) == (2, A)
    assert ((ems.consensus >= 0) & (ems.consensus <= 1)).all()
    # the next chunk draws other noise than the first (seeded by epoch)
    g0, _ = tstep.chunk_rngs(1, 0, "cpu")
    g2, _ = tstep.chunk_rngs(1, 2, "cpu")
    assert not torch.equal(torch.rand(8, generator=g0),
                           torch.rand(8, generator=g2))


def test_one_device_step_updates_through_adam_once_a_step(monkeypatch):
    """The one-device step's update is ``Adam.update``, called once a step
    on the whole gradients and parameters."""
    _, tc = _cfgs()
    tcfg = tcfg_mod.TrainConfig(batch_size=32, epochs_per_jit=2)
    opt = tstep.make_optimizer(tc)
    calls = []
    update = tstep.Adam.update

    def counted(self, grads, state, params):
        calls.append((self, tstep.tree_leaves(params)))
        return update(self, grads, state, params)
    monkeypatch.setattr(tstep.Adam, "update", counted)
    x = torch.from_numpy(_model(6, n=100)[2])
    s0 = tstep.init_train_state(1, tc, opt)
    s1, _ = tstep.make_epoch_runner(tc, tcfg, opt, 100)(s0, x, None, 1.0)
    assert len(calls) == s1.opt_state.count == 2 * (100 // 32)
    for who, params in calls:
        assert who is opt
        assert all(a is b for a, b in zip(params,
                                          tstep.tree_leaves(s1.params)))


def test_splits_match_jax():
    from dvae_tpu.data import pipeline as jpipeline
    labels = np.random.default_rng(1).integers(0, 5, 97).astype(str)
    for a, b in zip(tpipeline.stratified_split_indices(labels, 0.9, 3),
                    jpipeline.stratified_split_indices(labels, 0.9, 3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tpipeline.train_test_split_indices(97, 0.8, 3),
                    jpipeline.train_test_split_indices(97, 0.8, 3)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Checkpoints across the two packages, the trainer, the CLI
# ---------------------------------------------------------------------------

SMALL = dict(n_arm=2, input_dim=40, fc_dim=16, lowD_dim=6, n_categories=5,
             state_dim=2)


@pytest.fixture(scope="module")
def small_data():
    return synthetic_dataset(96, 40, 5, seed=4).log1p


@pytest.fixture(scope="module")
def jax_trained(small_data, tmp_path_factory):
    """A checkpoint of the JAX trainer after 2 epochs (Adam state with
    count 4)."""
    folder = str(tmp_path_factory.mktemp("jax_train"))
    cpl = JaxCplMixVAE(saving_folder=folder, seed=3)
    cpl.init_model(**SMALL, batch_size=32, epochs_per_jit=2, fused=False)
    path = cpl.train(small_data[:64], n_epoch=2, save_plots=False,
                     early_stop_consensus=0)
    return path


def test_jax_checkpoint_resumes_in_the_port(jax_trained, small_data):
    """The port resumes a JAX checkpoint with its Adam state: two more
    steps on the same batches and noise give JAX's losses."""
    jcpl = JaxCplMixVAE()
    jcpl.load_model(jax_trained)
    tcpl = CplMixVAE(device="cpu")
    assert tcpl.load_model(jax_trained) == 2
    assert tcpl.resume_progress["main_epochs"] == 2
    adam = tcpl.state.opt_state
    assert adam.count == int(jcpl.state.opt_state[0].count) == 4
    _tree_close(adam.mu, jcpl.state.opt_state[0].mu, rtol=0, atol=0)
    xb = np.stack([small_data[64:96], small_data[:32]])
    _, tstate, jl, tl = _jax_then_port_steps(
        jcpl.state, tcpl.state, jcpl.cfg, tcpl.cfg, xb, 2)
    np.testing.assert_allclose(tl, jl, rtol=TRAJ)
    assert tstate.opt_state.count == 6


def test_port_checkpoint_trains_on_in_jax(small_data, tmp_path):
    cpl = CplMixVAE(saving_folder=str(tmp_path), device="cpu", seed=5)
    cpl.init_model(**SMALL, batch_size=32, epochs_per_jit=2,
                   optimizer="adamw")
    path = cpl.train(small_data[:64], x_val=small_data[64:], n_epoch=2,
                     early_stop_consensus=0)
    assert os.path.basename(path) == "cpl_mixVAE_model_epoch_2.ckpt"
    assert cpl.state.opt_state.count == 4
    jcpl = JaxCplMixVAE(saving_folder=str(tmp_path / "jax"))
    assert jcpl.load_model(path) == 2
    assert jcpl.cfg.reparam_noise == jcfg.ReparamNoise.GAUSSIAN
    adam = jcpl.state.opt_state[0]
    assert int(adam.count) == 4 and len(jcpl.state.opt_state) == 3
    _tree_close(adam.nu, tckpt.params_to_jax(cpl.state.opt_state.nu),
                rtol=0, atol=0)
    _tree_close(jcpl.state.params, tckpt.params_to_jax(cpl.state.params),
                rtol=0, atol=0)
    out = jcpl.train(small_data[:64], n_epoch=1, save_plots=False,
                     early_stop_consensus=0)
    assert int(jcpl.state.epoch) == 3 and os.path.exists(out)
    assert int(jcpl.state.opt_state[0].count) == 6


def test_trainer_phases_on_the_cpu(small_data, tmp_path):
    """Checkpoint cadence, best_ files, a pruning iteration, the metrics
    log, resume of the progress, a mesh without its world refused and the
    opt-in flags taken."""
    cpl = CplMixVAE(saving_folder=str(tmp_path), device="cpu", seed=2)
    cpl.init_model(**SMALL, batch_size=32, epochs_per_jit=1, ckpt_every=2,
                   eval_every=1)
    path = cpl.train(small_data[:64], x_val=small_data[64:], n_epoch=2,
                     n_epoch_p=1, max_prun_it=1, min_con=1.1,
                     early_stop_consensus=0)
    names = sorted(os.listdir(tmp_path))
    assert "cpl_mixVAE_model_epoch_2.ckpt" in names
    assert "cpl_mixVAE_model_best_train.ckpt" in names
    assert "cpl_mixVAE_model_before_pruning_0_A2.ckpt" in names
    assert os.path.basename(path) == "cpl_mixVAE_model_epoch_3.ckpt"
    assert int(cpl.state.mask.sum()) == SMALL["n_categories"] - 1
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert any("val/consensus" in r for r in rows)
    again = CplMixVAE(device="cpu")
    again.load_model(path)
    assert again.resume_progress == {"main_epochs": 2, "pr_it": 1,
                                     "prune_epochs": 1}
    # a mesh of two devices needs a world of two processes
    with pytest.raises(ValueError, match="--num_processes 2"):
        CplMixVAE(device="cpu").init_model(
            **SMALL, mesh=tcfg_mod.MeshConfig(data=2))
    for kw in ({"use_pallas": True}, {"align_arms_every": 5},
               {"fused_decoder": True}, {"stream": True}):
        taken = CplMixVAE(device="cpu")
        taken.init_model(**SMALL, **kw)
        assert (taken.cfg.use_pallas, taken.tcfg.align_arms_every,
                taken.cfg.fused_decoder, taken.tcfg.stream) == (
            kw.get("use_pallas", False), kw.get("align_arms_every", 0),
            kw.get("fused_decoder", False), kw.get("stream", False))
    # aug_file is taken: the constructor loads the augmenter it names
    acfg = taug.AugmenterConfig(input_dim=SMALL["input_dim"], n_dim=20,
                                noise_dim=6, latent_dim=4)
    aug_file = taug.save_augmenter(
        str(tmp_path / "augmenter.ckpt"),
        *taug.init_augmenter(torch.Generator().manual_seed(0), acfg), acfg)
    with_aug = CplMixVAE(device="cpu", aug_file=aug_file)
    assert with_aug.aug_file == aug_file and with_aug._augment_fn() is not None
    assert CplMixVAE(device="cpu")._augment_fn() is None


def test_plot_artifacts_have_the_jax_packages_names(tmp_path):
    """For one history and one set of labels the port writes the files the
    JAX package writes: the loss curve and one consensus matrix per arm
    pair."""
    from dvae_tpu.utils import plots as jplots
    from dvae_tpu_torch.utils import plots as tplots
    history = [{"train/loss": 3.0 - e, "val/loss": 3.5 - e, "step": e}
               for e in range(3)]
    labels = np.random.default_rng(0).integers(0, 4, (3, 50))
    jw = jplots.save_training_artifacts(str(tmp_path / "jax"), history,
                                        labels=labels, K=4)
    tw = tplots.save_training_artifacts(str(tmp_path / "port"), history,
                                        labels=labels, K=4)
    names = [os.path.basename(p) for p in tw]
    assert names == [os.path.basename(p) for p in jw]
    assert names == ["loss_curve.png", "consensus_arm_0_arm_1.png",
                     "consensus_arm_0_arm_2.png", "consensus_arm_1_arm_2.png"]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(names)
    assert all(os.path.getsize(p) > 0 for p in tw)


def _plot_files(folder):
    return sorted(n for n in os.listdir(folder) if n.endswith(".png"))


def test_train_saves_plots_by_default(small_data, tmp_path):
    """``train`` writes the artifact set into its run folder by default,
    as the JAX trainer does; ``save_plots=False`` writes none."""
    cpl = CplMixVAE(saving_folder=str(tmp_path / "on"), device="cpu", seed=6)
    cpl.init_model(**SMALL, batch_size=32, epochs_per_jit=1)
    cpl.train(small_data[:64], n_epoch=1, early_stop_consensus=0)
    A = SMALL["n_arm"]
    assert _plot_files(tmp_path / "on") == sorted(
        ["loss_curve.png"] + [f"consensus_arm_{a}_arm_{b}.png"
                              for a in range(A) for b in range(a + 1, A)])
    off = CplMixVAE(saving_folder=str(tmp_path / "off"), device="cpu",
                    seed=6)
    off.init_model(**SMALL, batch_size=32, epochs_per_jit=1)
    off.train(small_data[:64], n_epoch=1, save_plots=False,
              early_stop_consensus=0)
    assert _plot_files(tmp_path / "off") == []


def test_train_skips_plots_without_matplotlib(small_data, tmp_path,
                                             monkeypatch, capsys):
    """Without matplotlib (the card machine has none) training finishes,
    writes its checkpoint and no image, and says the artifacts were
    skipped."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cpl = CplMixVAE(saving_folder=str(tmp_path), device="cpu", seed=6)
    cpl.init_model(**SMALL, batch_size=32, epochs_per_jit=1)
    path = cpl.train(small_data[:64], n_epoch=1, early_stop_consensus=0)
    assert os.path.exists(path)
    assert _plot_files(tmp_path) == []
    assert "plot artifacts skipped" in capsys.readouterr().out


@pytest.fixture(scope="module")
def small_counts():
    """Count-like log1p data: half of the entries exactly zero."""
    rng = np.random.default_rng(14)
    return (np.maximum(rng.normal(0.8, 1, (96, 40)), 0)
            * (rng.random((96, 40)) > 0.5)).astype(np.float32)


def test_zinb_checkpoints_cross_the_packages_both_ways(small_counts,
                                                       tmp_path):
    """A ZINB checkpoint of the JAX trainer resumes in the port with its
    Adam state over the three heads (two more steps give JAX's losses); the
    port's own ZINB checkpoint then trains on in the JAX package, bit for
    bit the same parameters and moments."""
    jfolder = str(tmp_path / "jax")
    jtrainer = JaxCplMixVAE(saving_folder=jfolder, seed=3)
    jtrainer.init_model(**SMALL, mode="ZINB", batch_size=32,
                        epochs_per_jit=2, fused=True)
    jpath = jtrainer.train(small_counts[:64], n_epoch=2, save_plots=False,
                           early_stop_consensus=0)
    jcpl = JaxCplMixVAE()
    jcpl.load_model(jpath)
    tcpl = CplMixVAE(saving_folder=str(tmp_path / "port"), device="cpu")
    assert tcpl.load_model(jpath) == 2 and tcpl.cfg.mode == "ZINB"
    adam = tcpl.state.opt_state
    assert adam.count == int(jcpl.state.opt_state[0].count) == 4
    _tree_close(adam.mu, jcpl.state.opt_state[0].mu, rtol=0, atol=0)
    assert float(adam.mu["fc11_r"]["w"].abs().max()) > 0
    xb = np.stack([small_counts[64:96], small_counts[:32]])
    _, tstate, jl, tl = _jax_then_port_steps(
        jcpl.state, tcpl.state, jcpl.cfg, tcpl.cfg, xb, 2)
    np.testing.assert_allclose(tl, jl, rtol=TRAJ)
    assert tstate.opt_state.count == 6
    # and back: the port trains on, saves, the JAX package resumes
    tcpl.tcfg = tcpl.tcfg.replace(epochs_per_jit=1)
    path = tcpl.train(small_counts[:64], x_val=small_counts[64:], n_epoch=1,
                      early_stop_consensus=0)
    back = JaxCplMixVAE(saving_folder=str(tmp_path / "back"))
    assert back.load_model(path) == 3
    assert back.cfg.mode == "ZINB"
    _tree_close(back.state.params, tckpt.params_to_jax(tcpl.state.params),
                rtol=0, atol=0)
    _tree_close(back.state.opt_state[0].nu,
                tckpt.params_to_jax(tcpl.state.opt_state.nu), rtol=0, atol=0)
    out = back.train(small_counts[:64], n_epoch=1, save_plots=False,
                     early_stop_consensus=0)
    assert int(back.state.epoch) == 4 and os.path.exists(out)


def test_zinb_trainer_on_the_cpu(small_counts, tmp_path):
    """init_model(mode="ZINB") → train with validation → save → a fresh
    load_model → eval_model, fused and unfused: the fused run's ``ll`` is
    NaN by design and does not trip the NaN halt; the record carries the
    reconstruction NLL."""
    recs = {}
    for fused in (True, False):
        folder = tmp_path / f"fused{fused}"
        cpl = CplMixVAE(saving_folder=str(folder), device="cpu", seed=2)
        cpl.init_model(**SMALL, mode="ZINB", fused=fused, batch_size=32,
                       epochs_per_jit=1, eval_every=1)
        assert cpl.cfg.fused_recon == fused
        path = cpl.train(small_counts[:64], x_val=small_counts[64:],
                         n_epoch=2, early_stop_consensus=0)
        assert not cpl._halted and cpl.state.opt_state.count == 4
        with open(folder / "metrics.jsonl") as f:
            rows = [json.loads(line) for line in f]
        rec = [r["train/rec_loss_arm0"] for r in rows
               if "train/rec_loss_arm0" in r]
        assert len(rec) == 2 and all(np.isfinite(rec))
        assert any(np.isfinite(r.get("val/rec_loss_arm1", np.nan))
                   for r in rows)
        server = CplMixVAE(device="cpu")
        server.load_model(path)
        res = server.eval_model(small_counts, batch_size=32)
        assert np.isfinite(res["total_loss_rec"]).all()
        recs[fused] = rec
    # the same seed, data and noise: the two routes agree to the kernels'
    # lgamma form (rtol 1e-4, tests/test_ops.py:491)
    np.testing.assert_allclose(recs[True][0], recs[False][0], rtol=1e-4)


def test_zinb_bf16_training_runs_and_agrees_across_routes(small_counts,
                                                          tmp_path):
    """Under ``bf16`` the parameters and the batch are cast once per step;
    the fused op takes bf16 operands and hands back bf16 cotangents, the
    master weights and the Adam moments of the three heads stay f32.  The
    fused and unfused routes agree to bf16 precision (rtol 2e-2, as
    tests/test_torch_serving.py holds bf16 eval to f32)."""
    recs = {}
    for fused in (True, False):
        cpl = CplMixVAE(saving_folder=str(tmp_path / f"fused{fused}"),
                        device="cpu", seed=1)
        cpl.init_model(**SMALL, mode="ZINB", bf16=True, fused=fused,
                       batch_size=32, epochs_per_jit=1)
        cpl.train(small_counts[:64], n_epoch=2, early_stop_consensus=0)
        assert not cpl._halted and cpl.state.opt_state.count == 4
        for head in ("fc11", "fc11_p", "fc11_r"):
            assert cpl.state.params[head]["w"].dtype == torch.float32
            assert float(cpl.state.opt_state.nu[head]["w"].max()) > 0
        recs[fused] = cpl.eval_model(small_counts,
                                     batch_size=32)["total_loss_rec"]
        assert np.isfinite(recs[fused]).all()
    np.testing.assert_allclose(recs[True], recs[False], rtol=2e-2)


def test_training_writes_checkpoints_only_into_its_folder(small_data,
                                                         tmp_path,
                                                         monkeypatch):
    """A trainer with a folder leaves the working directory as it was: the
    checkpoints go to ``saving_folder`` (``self.folder or "."``, as the JAX
    trainer writes them)."""
    monkeypatch.chdir(tmp_path)
    folder = tmp_path / "run"
    cpl = CplMixVAE(saving_folder=str(folder), device="cpu", seed=1)
    cpl.init_model(**SMALL, batch_size=32, epochs_per_jit=1)
    path = cpl.train(small_data[:64], n_epoch=2, early_stop_consensus=0)
    assert os.path.dirname(os.path.abspath(path)) == str(folder)
    assert not list(tmp_path.glob("cpl_mixVAE_model_*.ckpt"))
    assert list(folder.glob("cpl_mixVAE_model_*.ckpt"))


def test_hard_synthetic_dataset_matches_jax():
    """Labels, ids and the number of types equal the JAX package's at the
    same seed (numpy draws, in the same order); the counts come from another
    bitstream of the same ZINB, so the zero fraction (±0.01: 120,000
    Bernoulli-like entries, sd 0.0014), the mean of log1p (±2%) and the
    per-type mean profile (correlation ≥ 0.95: each profile is a mean over
    about 75 cells of overdispersed counts, and two independent draws
    correlate at about 0.98) are held statistically."""
    from dvae_tpu.data.anndata_io import hard_synthetic_dataset as jhard
    kw = dict(n_cells=600, n_genes=200, n_types=8, seed=3, chunk=256)
    want, got = jhard(**kw), hard_synthetic_dataset(**kw)
    np.testing.assert_array_equal(got.cluster_label, want.cluster_label)
    np.testing.assert_array_equal(got.cluster_id, want.cluster_id)
    np.testing.assert_array_equal(got.gene_id, want.gene_id)
    np.testing.assert_array_equal(got.c_p, want.c_p)
    assert got.n_type == want.n_type
    assert got.log1p.dtype == np.float32 and got.log1p.shape == (600, 200)
    assert abs((got.log1p == 0).mean() - (want.log1p == 0).mean()) < 0.01
    np.testing.assert_allclose(got.log1p.mean(), want.log1p.mean(), rtol=0.02)
    ids = got.cluster_id.astype(int)
    prof = lambda ds: np.stack([ds.log1p[ids == i].mean(axis=0)  # noqa: E731
                                for i in np.unique(ids)])
    assert np.corrcoef(prof(got).ravel(), prof(want).ravel())[0, 1] >= 0.95
    again = hard_synthetic_dataset(**kw)
    np.testing.assert_array_equal(again.log1p, got.log1p)


def test_nan_halt_keeps_the_last_good_checkpoint(small_data, tmp_path):
    cpl = CplMixVAE(saving_folder=str(tmp_path), device="cpu", seed=2)
    cpl.init_model(**SMALL, batch_size=32, epochs_per_jit=1, ckpt_every=1)
    cpl.train(small_data[:64], n_epoch=1, early_stop_consensus=0)
    x = small_data[:64].copy()
    x[3, 5] = np.nan
    path = cpl.train(x, n_epoch=3, early_stop_consensus=0)
    assert cpl._halted and cpl.state.epoch == 2
    assert os.path.basename(path) == "cpl_mixVAE_model_epoch_1.ckpt"
    assert not os.path.exists(tmp_path / "cpl_mixVAE_model_epoch_2.ckpt")


# ---------------------------------------------------------------------------
# The categorical path: use_pallas (fused Gumbel sampler and coupling
# distance) and cross-arm alignment.  On the CPU the JAX package runs both
# Pallas kernels in interpret mode and draws the sampler's uniforms from a
# key made of its seed; ``_noise`` rebuilds them.
# ---------------------------------------------------------------------------

def _pruned_mask():
    m = np.ones(C, np.float32)
    m[[2, 7]] = 0.0
    return m


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("mode", ["MSE", "ZINB"])
def test_use_pallas_loss_fn_value_and_grads_match_jax(mode, hard):
    """Loss, its parts and its gradients with the fused sampler and the
    fused coupling distance, under a pruned mask: to the limits of the
    twin tests without use_pallas (GRAD in MSE mode, ZGRAD in ZINB mode)."""
    jc, tc = _cfgs(mode=mode, hard=hard, use_pallas=True, fused_encoder=True,
                   fused_recon=True)
    params, bn, x = (_zinb_model if mode == "ZINB" else _model)(3)
    mask = _pruned_mask()
    params = jax.tree_util.tree_map(
        np.array, jstep._mask_params(params, jnp.asarray(mask), jc))
    key = jax.random.key(7)
    xs = jnp.broadcast_to(jnp.asarray(x), (A, B, D))
    (jt, (jaux, jbn, jlab)), jg = jax.value_and_grad(
        jstep.loss_fn, has_aux=True)(params, bn, jc, xs, key, 1.0,
                                     jnp.asarray(mask), None, None,
                                     jnp.asarray(x))
    live = {n: {k: v.requires_grad_() for k, v in layer.items()}
            for n, layer in tckpt.params_from_jax(params).items()}
    tt, (taux, tbn, tlab) = tstep.loss_fn(
        live, tckpt.bn_from_jax(bn), tc, torch.from_numpy(x), 1.0,
        torch.from_numpy(mask), None, noise=_noise(key, jc))
    leaves = tstep.tree_leaves(live)
    grads = tstep.tree_like(live, torch.autograd.grad(tt, leaves))
    np.testing.assert_allclose(float(tt.detach()), float(jt), rtol=1e-5)
    for name in ("loss_rec", "kl", "c_dist", "neg_entropy", "c_l2_dist"):
        np.testing.assert_allclose(getattr(taux, name).detach().numpy(),
                                   np.asarray(getattr(jaux, name)), **SHARP,
                                   err_msg=name)
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
    _tree_close(tbn, jbn, **SHARP)
    _tree_close(grads, jax.tree_util.tree_map(np.asarray, jg), scaled=True,
                **(ZGRAD if mode == "ZINB" else GRAD))


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("mode", ["MSE", "ZINB"])
def test_use_pallas_train_steps_match_jax(mode, hard):
    """Two Adam steps with use_pallas under a pruned mask from bridged
    weights and shared uniforms: the losses track JAX's (TRAJ) and the
    pruned categories' parameters stay zero."""
    jc, tc = _cfgs(mode=mode, hard=hard, use_pallas=True, fused_encoder=True,
                   fused_recon=True)
    tx = jstep.make_optimizer(jc)
    mask = _pruned_mask()
    jstate = jstep.init_train_state(jax.random.key(2), jc, tx)
    jstate = jstate._replace(
        mask=jnp.asarray(mask),
        params=jstep._mask_params(jstate.params, jnp.asarray(mask), jc))
    params = jax.tree_util.tree_map(np.array, jstate.params)
    opt = tstep.make_optimizer(tc)
    tp = tckpt.params_from_jax(params)
    tstate = tstep.TrainState(
        tp, tckpt.bn_from_jax(jax.tree_util.tree_map(np.array, jstate.bn)),
        torch.from_numpy(mask), 0, 0, opt.init(tp))
    model = _zinb_model if mode == "ZINB" else _model
    xb = np.stack([model(10 + i)[2] for i in range(2)])
    jstate, tstate, jl, tl = _jax_then_port_steps(jstate, tstate, jc, tc, xb,
                                                  2)
    np.testing.assert_allclose(tl, jl, rtol=TRAJ)
    assert tstate.opt_state.count == 2
    assert float(tstate.params["fcc"]["w"][:, :, [2, 7]].abs().max()) == 0.0
    d = np.abs(tstate.params["fcc"]["w"].numpy()
               - np.asarray(jstate.params["fcc"]["w"]))
    # 2 steps of at most lr each way where a gradient's sign differs
    assert d.max() <= 2 * 2 * jc.lr


def test_use_pallas_train_step_at_600_categories_matches_jax():
    """One Adam step with use_pallas at n_categories = 600, rows wider than
    the Gumbel kernels kept in registers before they walked C in chunks
    (the JAX kernels take any C): the loss and the categorical head's
    weights track JAX's as in the two-step case above."""
    jc, tc = _cfgs(n_categories=600, use_pallas=True, fused_encoder=True,
                   fused_recon=True)
    tx = jstep.make_optimizer(jc)
    jstate = jstep.init_train_state(jax.random.key(4), jc, tx)
    params = jax.tree_util.tree_map(np.array, jstate.params)
    opt = tstep.make_optimizer(tc)
    tp = tckpt.params_from_jax(params)
    tstate = tstep.TrainState(
        tp, tckpt.bn_from_jax(jax.tree_util.tree_map(np.array, jstate.bn)),
        torch.ones(600), 0, 0, opt.init(tp))
    xb = _model(12)[2][None]
    jstate, tstate, jl, tl = _jax_then_port_steps(jstate, tstate, jc, tc, xb,
                                                  1)
    np.testing.assert_allclose(tl, jl, rtol=TRAJ)
    assert np.isfinite(tl).all() and tstate.opt_state.count == 1
    d = np.abs(tstate.params["fcc"]["w"].numpy()
               - np.asarray(jstate.params["fcc"]["w"]))
    assert tstate.params["fcc"]["w"].shape[-1] == 600
    assert d.max() <= 2 * jc.lr


def test_use_pallas_checkpoints_cross_the_packages_both_ways(small_data,
                                                             tmp_path):
    """A use_pallas checkpoint of the JAX trainer loads in the port with
    the flag set, serves the JAX package's numbers, and resumes (two more
    steps give JAX's losses); the port's own checkpoint then trains on in
    the JAX package, bit for bit the same parameters."""
    jtrainer = JaxCplMixVAE(saving_folder=str(tmp_path / "jax"), seed=3)
    jtrainer.init_model(**SMALL, batch_size=32, epochs_per_jit=2, fused=True,
                        use_pallas=True)
    jpath = jtrainer.train(small_data[:64], n_epoch=2, save_plots=False,
                           early_stop_consensus=0)
    jcpl = JaxCplMixVAE()
    jcpl.load_model(jpath)
    tcpl = CplMixVAE(saving_folder=str(tmp_path / "port"), device="cpu")
    assert tcpl.load_model(jpath) == 2 and tcpl.cfg.use_pallas
    want = jcpl.eval_model(small_data, batch_size=32)
    got = tcpl.eval_model(small_data, batch_size=32)
    np.testing.assert_array_equal(got["pred_label"], want["pred_label"])
    for k in ("c_prob", "state_mu", "state_logvar", "x_low"):
        np.testing.assert_allclose(got[k], want[k], **SHARP, err_msg=k)
    # the losses pass through the reparameterization noise of variational
    # mode, which each package draws from its own stream in eval
    for k in ("total_loss_rec", "total_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-2, err_msg=k)
    xb = np.stack([small_data[64:96], small_data[:32]])
    _, tstate, jl, tl = _jax_then_port_steps(
        jcpl.state, tcpl.state, jcpl.cfg, tcpl.cfg, xb, 2)
    np.testing.assert_allclose(tl, jl, rtol=TRAJ)
    assert tstate.opt_state.count == 6
    # and back: the port trains on, saves, the JAX package resumes
    tcpl.tcfg = tcpl.tcfg.replace(epochs_per_jit=1)
    path = tcpl.train(small_data[:64], x_val=small_data[64:], n_epoch=1,
                      early_stop_consensus=0)
    back = JaxCplMixVAE(saving_folder=str(tmp_path / "back"))
    assert back.load_model(path) == 3 and back.cfg.use_pallas
    _tree_close(back.state.params, tckpt.params_to_jax(tcpl.state.params),
                rtol=0, atol=0)
    out = back.train(small_data[:64], n_epoch=1, save_plots=False,
                     early_stop_consensus=0)
    assert int(back.state.epoch) == 4 and os.path.exists(out)


def test_alignment_gives_the_jax_relabeling_table(small_data, tmp_path,
                                                  monkeypatch):
    """Two epochs with align_arms_every=1 in both packages from the same
    checkpoint.  With lr = 0, no input dropout and the whole dataset as one
    batch, nothing the alignment reads depends on the packages' random
    streams, so both must find the same relabeling table ``m`` after the
    first epoch, nothing left to move after the second, and end with the
    same permuted parameters, exactly."""
    import dvae_tpu.train.alignment as jalign
    import dvae_tpu_torch.train.cpl_mixvae as tmod
    x = small_data[:64]
    seed_run = JaxCplMixVAE(saving_folder=str(tmp_path / "seed"), seed=5)
    seed_run.init_model(**SMALL, lr=0.0, x_drop=0.0, batch_size=64,
                        epochs_per_jit=1, align_arms_every=1, fused=False)
    start = seed_run.save_checkpoint("epoch_0")
    tables = {"jax": [], "port": []}

    def recording(fn, log):
        def wrapped(state, labels, cfg, **kw):
            new, m, moved = fn(state, labels, cfg, **kw)
            log.append((np.array(labels), np.array(m), moved))
            return new, m, moved
        return wrapped

    monkeypatch.setattr(jalign, "align_state",
                        recording(jalign.align_state, tables["jax"]))
    monkeypatch.setattr(tmod, "align_state",
                        recording(tmod.align_state, tables["port"]))
    jcpl = JaxCplMixVAE(saving_folder=str(tmp_path / "jax"))
    jcpl.load_model(start)
    jcpl.train(x, n_epoch=2, save_plots=False, early_stop_consensus=0)
    tcpl = CplMixVAE(saving_folder=str(tmp_path / "port"), device="cpu")
    tcpl.load_model(start)
    assert tcpl.tcfg.align_arms_every == 1
    tcpl.train(x, n_epoch=2, early_stop_consensus=0)
    assert len(tables["jax"]) == len(tables["port"]) == 2
    for (jlab, jm, jmoved), (tlab, tm, tmoved) in zip(tables["jax"],
                                                      tables["port"]):
        np.testing.assert_array_equal(tlab, jlab)
        np.testing.assert_array_equal(tm, jm)
        assert tmoved == jmoved
    assert tables["port"][0][2] > 0 and tables["port"][1][2] == 0
    _tree_close(tcpl.state.params,
                jax.tree_util.tree_map(np.asarray, jcpl.state.params),
                rtol=0, atol=0)
    with open(tmp_path / "port" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    moved = [r for r in rows if "train/align_moved" in r]
    assert len(moved) == 1 and moved[0]["train/align_moved"] == \
        tables["port"][0][2]
    assert {"train/align_moved_active", "train/align_consensus"} <= set(
        moved[0])


def test_alignment_is_gated_under_ref_prior_and_runs_in_pruning(small_data,
                                                                tmp_path):
    """ref_prior pins the category indices: no alignment.  Under a pruned
    mask the alignment leaves the pruned indices where they are."""
    ds = synthetic_dataset(96, 40, 5, seed=4)
    cpl = CplMixVAE(saving_folder=str(tmp_path / "prior"), device="cpu",
                    seed=2)
    cpl.init_model(**SMALL, batch_size=32, epochs_per_jit=1, ref_prior=True,
                   align_arms_every=1)
    cpl.train(ds.log1p[:64], n_epoch=1, c_p=ds.c_p, early_stop_consensus=0)
    with open(tmp_path / "prior" / "metrics.jsonl") as f:
        assert "align_moved" not in f.read()
    pruned = CplMixVAE(saving_folder=str(tmp_path / "pruned"), device="cpu",
                       seed=2)
    pruned.init_model(**SMALL, batch_size=32, epochs_per_jit=1, n_pr=2,
                      align_arms_every=1, use_pallas=True)
    pruned.train(small_data[:64], n_epoch=2, early_stop_consensus=0)
    assert pruned.state.mask.tolist() == [1.0, 1.0, 1.0, 0.0, 0.0]
    assert float(pruned.state.params["fcc"]["w"][:, :, 3:].abs().max()) == 0.0
    labels = pruned._predict_labels(small_data, 1.0, batch_size=32)
    assert labels.max() < 3


def _run_port(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_train_on_cpu(tmp_path):
    args = ["-m", "dvae_tpu_torch.cli", "train", "--device", "cpu",
            "--synthetic", "--syn_cells", "120", "--syn_genes", "40",
            "--syn_types", "5", "--n_categories", "5", "--n_arm", "2",
            "--fc_dim", "16", "--latent_dim", "6", "--batch_size", "32",
            "--n_epoch", "2", "--epochs_per_jit", "1", "--eval_every", "1",
            "--saving_folder", str(tmp_path) + "/"]
    proc = _run_port(args, str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert "epoch 2:" in proc.stdout
    final = proc.stdout.strip().splitlines()[-1]
    assert final.startswith("final checkpoint:") and final.endswith(
        "cpl_mixVAE_model_epoch_2.ckpt")


def test_cli_train_zinb_on_cpu(tmp_path):
    args = ["-m", "dvae_tpu_torch.cli", "train", "--device", "cpu",
            "--loss_mode", "ZINB", "--hard_synthetic", "--syn_cells", "120",
            "--syn_genes", "40", "--syn_types", "5", "--n_categories", "5",
            "--n_arm", "2", "--fc_dim", "16", "--latent_dim", "6",
            "--batch_size", "32", "--n_epoch", "2", "--epochs_per_jit", "1",
            "--eval_every", "1", "--saving_folder", str(tmp_path) + "/"]
    proc = _run_port(args, str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert "HARD synthetic" in proc.stdout and "epoch 2:" in proc.stdout
    final = proc.stdout.strip().splitlines()[-1]
    assert final.endswith("cpl_mixVAE_model_epoch_2.ckpt")
    ckpt = final.split("final checkpoint:")[1].strip()
    _, meta = tckpt.load_checkpoint(ckpt)
    assert meta["cfg"]["mode"] == "ZINB"


def test_cli_train_with_alignment_on_cpu(tmp_path):
    args = ["-m", "dvae_tpu_torch.cli", "train", "--device", "cpu",
            "--synthetic", "--syn_cells", "120", "--syn_genes", "40",
            "--syn_types", "5", "--n_categories", "5", "--n_arm", "3",
            "--fc_dim", "16", "--latent_dim", "6", "--batch_size", "32",
            "--n_epoch", "2", "--epochs_per_jit", "1", "--align_every", "1",
            "--saving_folder", str(tmp_path) + "/"]
    proc = _run_port(args, str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert "[align] epoch 1: remapped" in proc.stdout
    ckpt = proc.stdout.strip().splitlines()[-1].split(
        "final checkpoint:")[1].strip()
    _, meta = tckpt.load_checkpoint(ckpt)
    assert meta["tcfg"]["align_arms_every"] == 1


# ---------------------------------------------------------------------------
# fused_decoder (the whole-decoder op) and the frozen augmenter.  DEC: rtol
# 5e-4 / atol 2e-5 of each leaf's largest gradient, as tests/test_ops.py
# :640-675 holds the fused_decoder path against the fused_recon one: the
# same sums through five gated layers, taken in another order.
# ---------------------------------------------------------------------------

DEC = dict(rtol=5e-4, atol=2e-5)
AUG_SMALL = dict(n_dim=20, noise_dim=6, latent_dim=4)


def _aug_model(input_dim, seed=0, n_zim=1):
    """A small frozen augmenter made by the JAX initialiser, as numpy
    trees with non-trivial running statistics, and both packages' configs."""
    kw = dict(AUG_SMALL, input_dim=input_dim, n_zim=n_zim)
    jc, tc = jaug.AugmenterConfig(**kw), taug.AugmenterConfig(**kw)
    params, bn = jaug.init_augmenter(jax.random.key(seed), jc)
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed)
    bn = {name: {k: (rng.uniform(0.5, 1.5, v.shape) if k in ("var", "scale")
                     else 0.1 * rng.normal(size=v.shape)).astype(np.float32)
                 for k, v in stats.items()} for name, stats in bn.items()}
    return jc, tc, params, bn


def _aug_draws(k_aug, acfg, n_arm, n_rows):
    """What ``augment_arms`` draws from ``k_aug``
    (dvae_tpu/augment/augmenter.py:245, :161, :175)."""
    _, k_noise, k_reparam = jax.random.split(k_aug, 3)
    return taug.AugNoise(
        z=torch.from_numpy(np.array(jax.random.normal(
            k_noise, (n_arm, n_rows, acfg.noise_dim)))),
        e=torch.from_numpy(np.array(jax.random.normal(
            k_reparam, (n_arm, n_rows, acfg.latent_dim)))))


@pytest.mark.parametrize("per_arm", [False, True])
def test_fused_decoder_loss_fn_equals_fused_recon_and_jax(per_arm):
    """loss_fn value, metrics and all parameter gradients: the port with
    fused_decoder against the port without it on the same ``Noise``, and
    against the JAX loss_fn with fused_decoder, on a shared batch and on
    per-arm views."""
    jc, tc = _cfgs(fused_encoder=True, fused_recon=True, fused_decoder=True)
    params, bn, x = _model(5)
    key = jax.random.key(13)
    mask = np.ones(C, np.float32)
    if per_arm:
        views = np.stack([x * s for s in (1.0, 0.9, 1.1)]).astype(np.float32)
        xs, x_shared, xt = jnp.asarray(views), None, torch.from_numpy(views)
    else:
        xs = jnp.broadcast_to(jnp.asarray(x), (A, B, D))
        x_shared, xt = jnp.asarray(x), torch.from_numpy(x)
    (jt, (jaux, _, jlab)), jg = jax.value_and_grad(
        jstep.loss_fn, has_aux=True)(params, bn, jc, xs, key, 1.0,
                                     jnp.asarray(mask), None, None, x_shared)
    noise = _noise(key, jc)
    out = {}
    for flag in (True, False):
        live = {n: {k: v.requires_grad_() for k, v in layer.items()}
                for n, layer in tckpt.params_from_jax(params).items()}
        tt, (taux, _, tlab) = tstep.loss_fn(
            live, tckpt.bn_from_jax(bn), tc.replace(fused_decoder=flag), xt,
            1.0, torch.from_numpy(mask), None, noise=noise)
        grads = tstep.tree_like(live, torch.autograd.grad(
            tt, tstep.tree_leaves(live)))
        out[flag] = (tt.detach(), taux, tlab, grads)
    on, off = out[True], out[False]
    np.testing.assert_allclose(float(on[0]), float(off[0]), rtol=1e-5)
    np.testing.assert_allclose(float(on[0]), float(jt), rtol=1e-5)
    for name in ("loss_rec", "kl", "c_dist", "neg_entropy", "c_l2_dist",
                 "ll"):
        np.testing.assert_allclose(getattr(on[1], name).detach().numpy(),
                                   getattr(off[1], name).detach().numpy(),
                                   rtol=1e-5, err_msg=name)
    for name in ("loss_rec", "kl", "c_dist", "neg_entropy", "c_l2_dist"):
        np.testing.assert_allclose(getattr(on[1], name).detach().numpy(),
                                   np.asarray(getattr(jaux, name)), **SHARP,
                                   err_msg=name)
    assert torch.equal(on[2], off[2])
    np.testing.assert_array_equal(on[2].numpy(), np.asarray(jlab))
    _tree_close(on[3], tckpt.params_to_jax(off[3]), scaled=True, **DEC)
    _tree_close(on[3], jax.tree_util.tree_map(np.asarray, jg), scaled=True,
                **DEC)


def test_fused_decoder_with_use_pallas_feeds_the_gumbel_backward():
    """dz's first C columns reach the fused sampler's backward: the same
    gradients with and without fused_decoder under use_pallas."""
    _, tc = _cfgs(fused_encoder=True, fused_recon=True, use_pallas=True)
    params, bn, x = _model(8)
    noise = _noise(jax.random.key(3), _cfgs(fused_encoder=True)[0])
    grads = []
    for flag in (True, False):
        live = {n: {k: v.requires_grad_() for k, v in layer.items()}
                for n, layer in tckpt.params_from_jax(params).items()}
        tt, _ = tstep.loss_fn(live, tckpt.bn_from_jax(bn),
                              tc.replace(fused_decoder=flag),
                              torch.from_numpy(x), 1.0, torch.ones(C), None,
                              noise=noise)
        grads.append(tstep.tree_like(live, torch.autograd.grad(
            tt, tstep.tree_leaves(live))))
    assert float(grads[0]["fcc"]["w"].abs().max()) > 0
    _tree_close(grads[0], tckpt.params_to_jax(grads[1]), scaled=True, **DEC)


def test_zinb_mode_ignores_fused_decoder():
    """In ZINB mode the flag changes nothing: the ZINB op runs, as in JAX
    (dvae_tpu/train/step.py:146)."""
    _, tc = _cfgs(mode="ZINB", fused_encoder=True, fused_recon=True)
    params, bn, x = _zinb_model(2)
    noise = _noise(jax.random.key(4), _cfgs(fused_encoder=True)[0])
    totals = []
    for flag in (False, True):
        tt, (aux, _, _) = tstep.loss_fn(
            tckpt.params_from_jax(params), tckpt.bn_from_jax(bn),
            tc.replace(fused_decoder=flag), torch.from_numpy(x), 1.0,
            torch.ones(C), None, noise=noise)
        totals.append((tt, aux.loss_rec))
    assert torch.equal(totals[0][0], totals[1][0])
    assert torch.equal(totals[0][1], totals[1][1])
    assert torch.isfinite(totals[0][0])


def test_augmented_train_steps_match_jax():
    """Three train steps with a frozen augmenter and fused_decoder in both
    packages: the port's views and noise are rebuilt from the JAX step's
    key splits (dvae_tpu/train/step.py:219-225).  Adam's first update is
    about -lr * sign(g), so an initialisation with a gradient entry near
    zero can part the two trajectories after one step; this one has none."""
    jc, tc = _cfgs(fused_encoder=True, fused_recon=True, fused_decoder=True)
    ajc, atc, aparams, abn = _aug_model(D, seed=4)
    japply = jaug.make_augment_apply(aparams, abn, ajc)
    tapply = taug.make_augment_apply(
        *tckpt.augmenter_from_jax(aparams, abn), atc)
    jtcfg = jcfg.TrainConfig(batch_size=B)
    tx = jstep.make_optimizer(jc)
    jstate = jstep.init_train_state(jax.random.key(7), jc, tx)
    opt = tstep.make_optimizer(tc)
    tp = tckpt.params_from_jax(jax.tree_util.tree_map(np.array,
                                                      jstate.params))
    tstate = tstep.TrainState(
        tp, tckpt.bn_from_jax(jax.tree_util.tree_map(np.array, jstate.bn)),
        torch.ones(C), 0, 0, opt.init(tp))
    jfn = jax.jit(jstep.make_train_step(
        jc, jtcfg, tx, augment=lambda k, x, n: japply(k, x, n, 0.1)))
    tfn = tstep.make_train_step(
        tc, tcfg_mod.TrainConfig(batch_size=B), opt,
        augment=lambda x, n, gen, draws: tapply(x, n, 0.1, gen, draws))
    jl, tl = [], []
    for i in range(3):
        xb = _model(20 + i)[2]
        _, k_aug, k_fwd = jax.random.split(jstate.key, 3)
        jstate, jm, jlab = jfn(jstate, jnp.asarray(xb), None, 1.0)
        tstate, tm, tlab = tfn(tstate, torch.from_numpy(xb), None, 1.0,
                               noise=_noise(k_fwd, jc),
                               aug_draws=_aug_draws(k_aug, ajc, A, B))
        jl.append(float(jm.total))
        tl.append(float(tm.total))
        if i == 0:
            np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
    np.testing.assert_allclose(tl, jl, rtol=TRAJ)
    assert tstate.opt_state.count == 3


@pytest.mark.parametrize("with_aug", [False, True])
def test_fused_decoder_trainer_on_the_cpu(small_data, tmp_path, with_aug):
    """init_model(fused_decoder=True) → train with validation → save → a
    fresh load → eval_model and validate, without and with an augmenter
    written by the test."""
    aug_file = None
    if with_aug:
        _, atc, aparams, abn = _aug_model(SMALL["input_dim"], seed=1)
        aug_file = taug.save_augmenter(
            str(tmp_path / "aug.ckpt"),
            *tckpt.augmenter_from_jax(aparams, abn), atc)
    cpl = CplMixVAE(saving_folder=str(tmp_path / "run"), aug_file=aug_file,
                    device="cpu", seed=5)
    cpl.init_model(**SMALL, batch_size=32, epochs_per_jit=1, eval_every=1,
                   fused=True, fused_decoder=True)
    assert cpl.cfg.fused_decoder and cpl.cfg.fused_recon
    path = cpl.train(small_data[:64], x_val=small_data[64:], n_epoch=2,
                     early_stop_consensus=0)
    assert cpl.state.opt_state.count == 4
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert sum("val/loss" in r for r in rows) == 2
    assert all(np.isfinite(r["train/loss"]) for r in rows
               if "train/loss" in r)
    fresh = CplMixVAE(aug_file=aug_file, device="cpu")
    assert fresh.load_model(path) == 2 and fresh.cfg.fused_decoder
    res = fresh.eval_model(small_data, batch_size=32)
    val = fresh.validate(small_data[64:], batch_size=32)
    assert res["pred_label"].shape == (2, 96)
    assert np.isfinite(res["total_loss"]) and np.isfinite(val["loss"])
    # the flag changes the route, not the numbers
    plain = CplMixVAE(aug_file=aug_file, device="cpu")
    plain.load_model(path)
    plain.cfg = plain.cfg.replace(fused_decoder=False)
    want = plain.eval_model(small_data, batch_size=32)
    np.testing.assert_array_equal(res["pred_label"], want["pred_label"])
    np.testing.assert_allclose(res["total_loss_rec"], want["total_loss_rec"],
                               rtol=1e-5)
    if with_aug:
        # the views differ from the data, so the loss does
        bare = CplMixVAE(device="cpu")
        bare.load_model(path)
        other = bare.eval_model(small_data, batch_size=32)
        assert not np.allclose(other["total_loss_rec"],
                               res["total_loss_rec"])


def test_fused_decoder_is_off_by_default():
    cpl = CplMixVAE(device="cpu")
    cpl.init_model(**SMALL, fused=True)
    assert cpl.cfg.fused_recon and not cpl.cfg.fused_decoder


def test_changing_the_augmenter_drops_the_cached_eval_functions(small_data,
                                                                tmp_path):
    cpl = CplMixVAE(device="cpu", seed=1)
    cpl.init_model(**SMALL, batch_size=32)
    before = cpl.eval_model(small_data[:32], batch_size=32)
    assert cpl._eval_step is not None
    _, atc, aparams, abn = _aug_model(SMALL["input_dim"], seed=2)
    cpl._load_augmenter(taug.save_augmenter(
        str(tmp_path / "aug.ckpt"), *tckpt.augmenter_from_jax(aparams, abn),
        atc))
    assert cpl._eval_step is None and cpl._eval_runner is None
    after = cpl.eval_model(small_data[:32], batch_size=32)
    assert not np.allclose(before["total_loss_rec"], after["total_loss_rec"])
    # bf16 training takes a bf16 copy of the weights, made once
    cpl.tcfg = cpl.tcfg.replace(bf16=True, aug_noise=0.3)
    cpl._reset_eval_fns()
    fn = cpl._augment_fn()
    v = fn(torch.from_numpy(small_data[:8]).to(torch.bfloat16), 2,
           torch.Generator().manual_seed(0))
    assert v.dtype == torch.bfloat16 and tuple(v.shape) == (2, 8, 40)
    assert cpl._aug_apply is not None and cpl._augment_fn() is not None


def test_cli_train_with_an_augmenter_on_cpu(tmp_path):
    _, atc, aparams, abn = _aug_model(40, seed=3)
    aug_file = taug.save_augmenter(
        str(tmp_path / "aug.ckpt"), *tckpt.augmenter_from_jax(aparams, abn),
        atc)
    args = ["-m", "dvae_tpu_torch.cli", "train", "--device", "cpu",
            "--synthetic", "--syn_cells", "120", "--syn_genes", "40",
            "--syn_types", "5", "--n_categories", "5", "--n_arm", "2",
            "--fc_dim", "16", "--latent_dim", "6", "--batch_size", "32",
            "--n_epoch", "2", "--epochs_per_jit", "1", "--aug_file", aug_file,
            "--saving_folder", str(tmp_path) + "/"]
    proc = _run_port(args, str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert "_AUGTrue_" in proc.stdout and "epoch 2:" in proc.stdout
    assert proc.stdout.strip().splitlines()[-1].endswith(
        "cpl_mixVAE_model_epoch_2.ckpt")
