"""The PyTorch port's cross-arm alignment (dvae_tpu_torch/train/alignment.py)
against dvae_tpu/train/alignment.py.

Labels come from numpy seeds; parameters and Adam moments are made by the
JAX package and handed to the port through the weight bridge.  Everything
here is index arithmetic and gathers, so the two packages agree exactly
(no tolerance), except the model outputs of the invariance property, which
pass through GEMMs whose columns sit in another order (rtol 1e-5, atol
1e-6: f32 sums in another order).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import dvae_tpu.config as jcfg
from dvae_tpu.models import mixvae as jmixvae
from dvae_tpu.train import alignment as jalign
from dvae_tpu.train import step as jstep

import dvae_tpu_torch.config as tcfg_mod
from dvae_tpu_torch.models import losses as tlosses
from dvae_tpu_torch.models import mixvae as tmixvae
from dvae_tpu_torch.train import alignment as talign
from dvae_tpu_torch.train import step as tstep
from dvae_tpu_torch.utils import checkpoint as tckpt

A, B, D, F, L, C, S = 3, 48, 40, 16, 6, 8, 2
DIMS = dict(n_arm=A, input_dim=D, fc_dim=F, lowD_dim=L, n_categories=C,
            state_dim=S)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _labels(seed=0, n=400, k=C, arms=A, live=None):
    """Arm 0 draws labels; the other arms see them through a random
    renaming with 10% of the cells relabelled at random."""
    rng = np.random.default_rng(seed)
    live = k if live is None else live
    base = rng.integers(0, live, n)
    labels = [base]
    for _ in range(arms - 1):
        perm = np.arange(k)
        perm[:live] = rng.permutation(live)
        lab = perm[base]
        noisy = rng.random(n) < 0.1
        lab[noisy] = rng.integers(0, live, int(noisy.sum()))
        labels.append(lab)
    return np.stack(labels)


def _jax_state(seed=0):
    """A JAX train state after two steps (non-zero Adam moments), the
    configs of both packages, and the batch."""
    jc, tc = jcfg.VAEConfig(**DIMS), tcfg_mod.VAEConfig(**DIMS)
    tx = jstep.make_optimizer(jc)
    state = jstep.init_train_state(jax.random.key(seed), jc, tx)
    x = np.maximum(np.random.default_rng(seed + 1).normal(0.5, 1, (B, D)),
                   0).astype(np.float32)
    step = jax.jit(jstep.make_train_step(jc, jcfg.TrainConfig(batch_size=B),
                                         tx))
    for _ in range(2):
        state, _, _ = step(state, jnp.asarray(x), None, 1.0)
    return state, jc, tc, x


def _port_state(jstate, tc):
    """The port's TrainState holding the JAX state's numbers."""
    tree = lambda t: tckpt.params_from_jax(  # noqa: E731
        jax.tree_util.tree_map(np.array, t))
    adam = jstate.opt_state[0]
    return tstep.TrainState(
        params=tree(jstate.params),
        bn=tckpt.bn_from_jax(jax.tree_util.tree_map(np.array, jstate.bn)),
        mask=torch.from_numpy(np.array(jstate.mask)), seed=0, epoch=0,
        opt_state=tstep.AdamState(int(adam.count), tree(adam.mu),
                                  tree(adam.nu)))


def _assert_tree_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        for leaf in want[name]:
            np.testing.assert_array_equal(np.asarray(got[name][leaf]),
                                          np.asarray(want[name][leaf]),
                                          err_msg=f"{name}.{leaf}")


@pytest.mark.parametrize("ref_arm", [0, 2])
@pytest.mark.parametrize("pruned", [False, True])
def test_match_to_reference_equals_jax(pruned, ref_arm):
    live = C - 2 if pruned else C
    labels = _labels(1, live=live)
    active = None
    if pruned:
        active = np.ones(C, bool)
        active[-2:] = False
    want = jalign.match_to_reference(labels, C, ref_arm, active=active)
    got = talign.match_to_reference(labels, C, ref_arm, active=active)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[ref_arm], np.arange(C))
    assert all(sorted(row) == list(range(C)) for row in got)
    if pruned:
        np.testing.assert_array_equal(got[:, -2:],
                                      np.tile(np.arange(C)[-2:], (A, 1)))
    # the relabelled arms agree with the reference on the undisturbed cells
    new = np.take_along_axis(got, labels, axis=1)
    assert np.mean(new == new[ref_arm]) > 0.85


def test_moved_counts_equals_jax():
    labels = _labels(2, live=C - 3)
    m = talign.match_to_reference(labels, C)
    assert talign.moved_counts(m, labels) == jalign.moved_counts(m, labels)
    total, active = talign.moved_counts(m, labels)
    assert 0 < active <= total
    assert talign.moved_counts(np.tile(np.arange(C), (A, 1)),
                               labels) == (0, 0)


def test_permute_categories_and_opt_state_equal_jax():
    jstate, jc, tc, _ = _jax_state(3)
    m = talign.match_to_reference(_labels(3), C)
    assert (m != np.arange(C)).any()
    want = jalign.permute_categories(jstate.params, m, jc)
    tstate = _port_state(jstate, tc)
    got = talign.permute_categories(tstate.params, m, tc)
    _assert_tree_equal(got, want)
    # untouched leaves are shared, permuted ones are new tensors
    assert got["fc1"]["w"] is tstate.params["fc1"]["w"]
    assert got["fcc"]["w"] is not tstate.params["fcc"]["w"]
    jopt = jalign.permute_opt_state(jstate.opt_state, m, jc)
    topt = talign.permute_opt_state(tstate.opt_state, m, tc)
    assert topt.count == int(jopt[0].count) == 2
    _assert_tree_equal(topt.mu, jopt[0].mu)
    _assert_tree_equal(topt.nu, jopt[0].nu)
    assert float(topt.nu["fcc"]["w"].abs().max()) > 0
    assert talign.permute_opt_state(None, m, tc) is None


@pytest.mark.parametrize("pruned", [False, True])
def test_align_state_equals_jax(pruned):
    jstate, jc, tc, _ = _jax_state(4)
    mask = np.ones(C, np.float32)
    if pruned:
        mask[[1, 6]] = 0.0
    live = np.flatnonzero(mask)
    labels = live[_labels(4, k=len(live))]
    jnew, jm, jmoved = jalign.align_state(jstate, labels, jc, mask=mask)
    tstate = _port_state(jstate, tc)
    tnew, tm, tmoved = talign.align_state(tstate, labels, tc, mask=mask)
    np.testing.assert_array_equal(tm, jm)
    assert tmoved == jmoved > 0
    if pruned:
        np.testing.assert_array_equal(tm[:, [1, 6]],
                                      np.tile([1, 6], (A, 1)))
    _assert_tree_equal(tnew.params, jnew.params)
    _assert_tree_equal(tnew.opt_state.mu, jnew.opt_state[0].mu)
    _assert_tree_equal(tnew.opt_state.nu, jnew.opt_state[0].nu)
    # already aligned: the state comes back as it was
    same, m2, moved2 = talign.align_state(
        tnew, np.take_along_axis(tm, labels, axis=1), tc, mask=mask)
    assert moved2 == 0 and same is tnew
    np.testing.assert_array_equal(m2, np.tile(np.arange(C), (A, 1)))


def test_each_arm_is_invariant_up_to_the_renaming():
    """After the permutation every arm's eval outputs are the same with its
    categories renamed: labels follow ``new = m[a, old]``, the posteriors
    move to their new slots, reconstruction, state, KL and entropy do not
    change."""
    jstate, jc, tc, x = _jax_state(5)
    tstate = _port_state(jstate, tc)
    m = talign.match_to_reference(_labels(5), C)
    new = talign.permute_categories(tstate.params, m, tc)
    xt, noise = torch.from_numpy(x), torch.zeros(A, B, S)
    before, _ = tmixvae.apply(tstate.params, tstate.bn, tc, xt, noise=noise)
    after, _ = tmixvae.apply(new, tstate.bn, tc, xt, noise=noise)
    tol = dict(rtol=1e-5, atol=1e-6)
    lab0 = before.c.argmax(-1).numpy()
    np.testing.assert_array_equal(after.c.argmax(-1).numpy(),
                                  np.take_along_axis(m, lab0, axis=1))
    idx = torch.from_numpy(m)[:, None, :].expand(A, B, C)
    moved_c = torch.zeros_like(before.c).scatter(2, idx, before.c)
    np.testing.assert_allclose(after.c.numpy(), moved_c.numpy(), rtol=1e-4,
                               atol=1e-6)
    for name in ("x_rec", "s_mean", "s_logvar", "x_low"):
        np.testing.assert_allclose(getattr(after, name).numpy(),
                                   getattr(before, name).numpy(), **tol,
                                   err_msg=name)
    l0 = tlosses.mixvae_loss(tc, before, xt)
    l1 = tlosses.mixvae_loss(tc, after, xt)
    for name in ("loss_rec", "kl", "neg_entropy"):
        np.testing.assert_allclose(getattr(l1, name).numpy(),
                                   getattr(l0, name).numpy(), rtol=1e-5,
                                   err_msg=name)


def test_training_goes_on_with_the_permuted_tensors():
    """The step updates parameters and moments in place: after an alignment
    it must move the permuted tensors, not the ones the old state held."""
    jstate, jc, tc, x = _jax_state(6)
    tstate = _port_state(jstate, tc)
    labels = _labels(6)
    new, m, moved = talign.align_state(tstate, labels, tc)
    assert moved > 0
    old_w = tstate.params["fcc"]["w"].clone()
    new_w = new.params["fcc"]["w"].clone()
    step = tstep.make_train_step(tc, tcfg_mod.TrainConfig(batch_size=B),
                                 tstep.make_optimizer(tc))
    out, _, _ = step(new, torch.from_numpy(x), None, 1.0,
                     generator=torch.Generator().manual_seed(0))
    assert out.opt_state.count == 3
    assert out.params["fcc"]["w"] is new.params["fcc"]["w"]
    assert not torch.equal(new.params["fcc"]["w"], new_w)
    assert torch.equal(tstate.params["fcc"]["w"], old_w)


def test_optax_state_of_the_jax_package_is_what_the_bridge_reads():
    """Guards the fixture: the JAX state's first element is optax's Adam
    state, whose moments the port's AdamState mirrors."""
    jstate, _, _, _ = _jax_state(7)
    assert isinstance(jstate.opt_state[0], optax.ScaleByAdamState)
