"""The PyTorch port's fused Gumbel-softmax op (dvae_tpu_torch/ops/gumbel.py)
against dvae_tpu/ops/gumbel_pallas.py.

Inputs come from numpy seeds and both sides get the same explicit uniforms
``u``.  JAX runs on the CPU with its Pallas kernels in interpret mode, as
tests/test_ops.py::TestGumbelPallas runs them; the port on CPU tensors runs
its plain versions, which compute what the CUDA kernels compute.  Small
shapes (A = 2-3, B ≤ 700, C ≤ 30, plus one C = 92, and rows wider than
the CUDA kernels keep in registers: C = 600 and 1100).  Tolerances, with
their reason:

  * the sample ``y`` (rtol 1e-5, atol 1e-6, tests/test_ops.py:100): the
    same formula, logs and exps a few f32 roundings apart;
  * ``dphi`` (rtol 1e-3, atol 1e-6) and ``dtemp`` (rtol 3e-4), as
    tests/test_ops.py:183-185 holds the interpreted kernel to autodiff of
    the XLA formula: dphi divides by phi + eps and dtemp sums thousands of
    terms of both signs;
  * one-hot samples: exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvae_tpu.models.sampling import gumbel_softmax_sample
from dvae_tpu.ops import gumbel_pallas as jgumbel

from dvae_tpu_torch.ops import gumbel as tgumbel

EPS = 1e-8
Y_TOL = dict(rtol=1e-5, atol=1e-6)
DPHI_TOL = dict(rtol=1e-3, atol=1e-6)
DTEMP_RTOL = 3e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _probs(shape, seed, pruned=0):
    """Probabilities over the last axis; the last ``pruned`` categories are
    exactly zero, as a pruning mask leaves them."""
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    if pruned:
        x[..., -pruned:] = 0.0
    x = x / x.sum(-1, keepdims=True)
    u = rng.random(shape).astype(np.float32)
    return x, u


SHAPES = [((3, 150, 12), 0), ((2, 70, 30), 3), ((2, 33, 92), 0),
          ((2, 9, 600), 0), ((1, 7, 1100), 5)]
WIDE_C = [600, 1100]


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("shape,pruned", SHAPES)
def test_forward_matches_the_interpreted_kernel(shape, pruned, hard):
    phi, u = _probs(shape, 1, pruned)
    want = jgumbel.gumbel_softmax_pallas(jnp.int32(0), jnp.asarray(phi),
                                         jnp.asarray(u), 0.8, EPS, hard)
    got = tgumbel.gumbel_softmax_plain(torch.from_numpy(phi),
                                       torch.from_numpy(u), 0.8, EPS,
                                       hard=hard)
    fused = tgumbel.gumbel_softmax_fused(0, torch.from_numpy(phi),
                                         torch.from_numpy(u), 0.8, EPS, hard)
    if hard:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert set(np.unique(got.numpy())) <= {0.0, 1.0}
        np.testing.assert_array_equal(got.numpy().sum(-1), 1.0)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **Y_TOL)
        np.testing.assert_allclose(got.numpy().sum(-1), 1.0, rtol=1e-5)
    assert torch.equal(fused, got)


@pytest.mark.parametrize("hard", [False, True])
def test_sharpen_variant_matches_the_interpreted_kernel(hard):
    rng = np.random.default_rng(2)
    logits = rng.dirichlet(np.ones(12), size=(3, 40)).astype(np.float32)
    u = rng.random(logits.shape).astype(np.float32)
    tau = 0.05
    want = jgumbel._gumbel_fwd_pallas(jnp.int32(0), jnp.asarray(logits), 0.7,
                                      EPS, tau, hard, jnp.asarray(u))
    got = tgumbel.sharpen_gumbel_fused(0, torch.from_numpy(logits), tau, 0.7,
                                       EPS, hard, u=torch.from_numpy(u))
    if hard:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        # the sharpened probabilities pass through log(phi + eps): entries
        # of phi near eps carry the softmax's rounding at full size
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="tau"):
        tgumbel.sharpen_gumbel_fused(0, torch.from_numpy(logits), 0.0)


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("C", WIDE_C)
def test_sharpen_variant_on_wide_rows_matches_the_interpreted_kernel(C, hard):
    """The tau variant past the rows the CUDA kernel keeps in registers
    (C > 512 before the chunked walk; the JAX kernel takes any C), at the
    sharpen test's tolerance."""
    rng = np.random.default_rng(C)
    logits = rng.dirichlet(np.ones(C), size=(2, 5)).astype(np.float32)
    u = rng.random(logits.shape).astype(np.float32)
    want = jgumbel._gumbel_fwd_pallas(jnp.int32(0), jnp.asarray(logits), 0.7,
                                      EPS, 0.05, hard, jnp.asarray(u))
    got = tgumbel.sharpen_gumbel_fused(0, torch.from_numpy(logits), 0.05,
                                       0.7, EPS, hard, u=torch.from_numpy(u))
    if hard:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("C", WIDE_C)
def test_wide_rows_gradients_match_jax_grad_of_the_kernel(C, hard):
    """dphi and dtemp at C = 600 and 1100 (the backward walks such rows in
    groups of 128 columns on the card) against jax.grad of the interpreted
    kernel, soft and straight-through."""
    phi, u = _probs((2, 11, C), C, pruned=3)
    dy = np.random.default_rng(C + 1).normal(size=phi.shape).astype(
        np.float32)

    def jloss(p, t):
        return jnp.sum(jgumbel.gumbel_softmax_pallas(
            jnp.int32(0), p, jnp.asarray(u), t, EPS, hard) * jnp.asarray(dy))

    gp, gt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(phi),
                                             jnp.float32(0.8))
    p = torch.from_numpy(phi).requires_grad_()
    t = torch.tensor(0.8, requires_grad=True)
    y = tgumbel.gumbel_softmax_fused(0, p, torch.from_numpy(u), t, EPS, hard)
    y.backward(torch.from_numpy(dy))
    assert float(gt) != 0.0 and bool(torch.isfinite(p.grad).all())
    np.testing.assert_allclose(float(t.grad), float(gt), rtol=DTEMP_RTOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp), **DPHI_TOL)


@pytest.mark.parametrize("t0", [0.3, 1.0, 3.0])
def test_gradients_match_jax_grad_of_the_kernel(t0):
    """dphi and dtemp of the port's autograd function against jax.grad of
    the interpreted kernel; 700 rows are no multiple of the TPU kernel's
    512-row tile."""
    phi, u = _probs((700, 12), 3)

    def jloss(p, t):
        return jnp.sum(jgumbel.gumbel_softmax_pallas(
            jnp.int32(0), p, jnp.asarray(u), t) ** 2)

    gp, gt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(phi),
                                             jnp.float32(t0))
    p = torch.from_numpy(phi).requires_grad_()
    t = torch.tensor(t0, requires_grad=True)
    y = tgumbel.gumbel_softmax_fused(0, p, torch.from_numpy(u), t, EPS)
    (y ** 2).sum().backward()
    assert float(gt) != 0.0
    np.testing.assert_allclose(float(t.grad), float(gt), rtol=DTEMP_RTOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp), **DPHI_TOL)


@pytest.mark.parametrize("pruned", [0, 3])
def test_backward_plain_matches_autograd_of_the_formula(pruned):
    """The hand-derived backward against torch autograd of the eager
    formula (rtol 1e-4: the same chain rule, summed in another order); with
    pruned categories (phi = 0 exactly) every entry stays finite."""
    phi, u = _probs((2, 90, 10), 4, pruned)
    dy = np.random.default_rng(5).normal(size=phi.shape).astype(np.float32)
    p = torch.from_numpy(phi).requires_grad_()
    t = torch.tensor(0.6, requires_grad=True)
    y = tgumbel.gumbel_softmax_plain(p, torch.from_numpy(u), t, EPS)
    y.backward(torch.from_numpy(dy))
    dphi, dtemp = tgumbel.gumbel_softmax_bwd_plain(
        y.detach(), p.detach(), torch.from_numpy(dy), 0.6, EPS)
    assert bool(torch.isfinite(dphi).all()) and bool(torch.isfinite(dtemp))
    scale = float(p.grad.abs().max())
    np.testing.assert_allclose(dphi.numpy(), p.grad.numpy(), rtol=1e-4,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(float(dtemp), float(t.grad), rtol=1e-4)


def test_hard_path_gradient_is_the_soft_one():
    """Straight-through: with ``hard`` the cotangent reaches the soft sample
    unchanged, so the same dy gives the same dphi and dtemp, and both match
    jax.grad of the interpreted hard kernel."""
    phi, u = _probs((60, 8), 6)
    dy = torch.from_numpy(
        np.random.default_rng(7).normal(size=phi.shape).astype(np.float32))
    grads = {}
    for hard in (False, True):
        p = torch.from_numpy(phi).requires_grad_()
        t = torch.tensor(1.0, requires_grad=True)
        y = tgumbel.gumbel_softmax_fused(0, p, torch.from_numpy(u), t, EPS,
                                         hard)
        y.backward(dy)
        grads[hard] = (p.grad.clone(), t.grad.clone())
        assert bool(torch.isfinite(p.grad).all())
        assert bool(torch.isfinite(t.grad))
    assert torch.equal(grads[True][0], grads[False][0])
    assert torch.equal(grads[True][1], grads[False][1])
    jg = jax.grad(lambda q: jnp.sum(jgumbel.gumbel_softmax_pallas(
        jnp.int32(0), q, jnp.asarray(u), 1.0, EPS, True)
        * jnp.asarray(dy.numpy())))(jnp.asarray(phi))
    np.testing.assert_allclose(grads[True][0].numpy(), np.asarray(jg),
                               **DPHI_TOL)


def test_float_temperature_takes_no_gradient_and_changes_nothing():
    phi, u = _probs((2, 40, 9), 8)
    p = torch.from_numpy(phi).requires_grad_()
    y = tgumbel.gumbel_softmax_fused(0, p, torch.from_numpy(u), 0.5, EPS)
    y.square().sum().backward()
    q = torch.from_numpy(phi).requires_grad_()
    t = torch.tensor([0.5], requires_grad=True)
    z = tgumbel.gumbel_softmax_fused(0, q, torch.from_numpy(u), t, EPS)
    z.square().sum().backward()
    assert torch.equal(y, z) and torch.equal(p.grad, q.grad)
    assert t.grad.shape == (1,) and float(t.grad) != 0.0


def test_philox_uniform_is_in_range_reproducible_and_seeded():
    shape = (3, 50, 30)
    u = tgumbel.philox_uniform(7, shape)
    assert u.shape == shape and u.dtype == np.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    np.testing.assert_array_equal(u, tgumbel.philox_uniform(7, shape))
    assert not np.array_equal(u, tgumbel.philox_uniform(8, shape))
    # 23 random bits: every value is a multiple of 2^-23
    np.testing.assert_array_equal(u * 2.0 ** 23, np.round(u * 2.0 ** 23))
    # a row's numbers do not depend on how many rows or columns follow
    np.testing.assert_array_equal(tgumbel.philox_uniform(7, (150, 30))[:20],
                                  tgumbel.philox_uniform(7, (20, 30)))
    np.testing.assert_array_equal(
        tgumbel.philox_uniform(7, (150, 30))[:, :13],
        tgumbel.philox_uniform(7, (150, 13)))
    # 4,500 uniforms: mean within 5 sigma (0.29 / sqrt(4500) = 0.0043)
    assert abs(float(u.mean()) - 0.5) < 0.0215


def test_seeded_sampler_matches_the_eager_samplers_distribution():
    """Other random streams, the same distribution: the argmax frequencies
    of the port's seeded sampler match the JAX package's eager sampler
    within 0.04 (tests/test_ops.py:117-130); another seed gives another
    sample, the same seed the same."""
    C, N = 6, 4000
    phi_row = np.asarray([0.4, 0.25, 0.15, 0.1, 0.07, 0.03], np.float32)
    phi = torch.from_numpy(np.tile(phi_row, (N, 1)))
    y = tgumbel.gumbel_softmax_fused(11, phi, None, 0.5, EPS, True)
    y_x = np.asarray(gumbel_softmax_sample(
        jax.random.key(0), jnp.asarray(phi.numpy()), 0.5, EPS))
    freq_p = np.bincount(y.numpy().argmax(-1), minlength=C) / N
    freq_x = np.bincount(y_x.argmax(-1), minlength=C) / N
    np.testing.assert_allclose(freq_p, freq_x, atol=0.04)
    np.testing.assert_allclose(freq_p, phi_row, atol=0.04)
    soft1 = tgumbel.gumbel_softmax_fused(1, phi[:50], None, 1.0, EPS)
    soft2 = tgumbel.gumbel_softmax_fused(2, phi[:50], None, 1.0, EPS)
    assert not torch.allclose(soft1, soft2)
    assert torch.equal(soft1, tgumbel.gumbel_softmax_fused(1, phi[:50], None,
                                                           1.0, EPS))


def test_wrappers_count_no_launch_on_the_cpu_and_check_devices():
    phi, u = _probs((2, 10, 5), 9)
    before = (tgumbel.gumbel_fwd.launches, tgumbel.gumbel_bwd.launches,
              tgumbel.sharpen_gumbel_fused.launches)
    p = torch.from_numpy(phi).requires_grad_()
    tgumbel.gumbel_softmax_fused(0, p, torch.from_numpy(u)).sum().backward()
    tgumbel.sharpen_gumbel_fused(0, torch.from_numpy(phi), 0.1)
    assert before == (tgumbel.gumbel_fwd.launches,
                      tgumbel.gumbel_bwd.launches,
                      tgumbel.sharpen_gumbel_fused.launches)
    with pytest.raises(ValueError, match="several devices"):
        tgumbel.gumbel_fwd(0, torch.from_numpy(phi),
                           torch.from_numpy(u).to("meta"))


# ---------------------------------------------------------------------------
# The forward kernel's row plan (csrc/gumbel.cu fwd_plan), through its twin
# ---------------------------------------------------------------------------

PLAN_C = [1, 3, 30, 92, 93, 128, 200, 512, 513, 600, 1024, 4099]


def _plan_columns(plan, sub, chunk):
    """The first columns of the quads lane ``sub`` of a row holds in chunk
    ``chunk`` under ``plan``, as csrc/gumbel.cu walks them: quads chunk ·
    lanes · quads + sub + lanes · j (past C they are masked)."""
    base = chunk * plan["lanes"] * plan["quads"]
    return [4 * (base + sub + plan["lanes"] * j)
            for j in range(plan["quads"])]


@pytest.mark.parametrize("C", PLAN_C)
def test_gumbel_plan_covers_every_column_once(C):
    """Each row's columns are held by exactly one (lane, quad, chunk) of its
    lanes, whatever C; groups cover the rows and every block of the striding
    grid takes the same number of steps."""
    sms = 132
    for N in (1, 33, 25000):
        plan = tgumbel.gumbel_plan(N, C, sms)
        lanes, quads, chunks = plan["lanes"], plan["quads"], plan["chunks"]
        assert lanes in (1, 2, 4, 8, 16, 32)
        assert 1 <= quads <= tgumbel.GUMBEL_MAX_QUADS
        assert chunks == 1 or (lanes, quads) == (32, tgumbel.GUMBEL_WIDE_QUADS)
        assert plan["rows"] * lanes == tgumbel.GUMBEL_WARPS * 32
        assert plan["groups"] * plan["rows"] >= N > (
            plan["groups"] - 1) * plan["rows"]
        steps = -(-plan["groups"] // plan["grid"])
        assert plan["grid"] <= sms * tgumbel.GUMBEL_BLOCKS_PER_SM
        assert plan["grid"] * (steps - 1) < plan["groups"]
        # the lanes of one row: lanes 0 .. lanes-1 of a warp
        seen = np.zeros(C, np.int64)
        for sub in range(lanes):
            for chunk in range(chunks):
                for c0 in _plan_columns(plan, sub, chunk):
                    seen[c0:min(c0 + 4, C)] += 1
        np.testing.assert_array_equal(seen, 1)
        # padding: less than one quad a lane (one chunk a row when wide)
        slack = 4 * lanes * quads * chunks - C
        assert 0 <= slack < 4 * (lanes if chunks == 1 else 32 * quads)


def test_gumbel_plan_keeps_the_lanes_busy():
    """At the production C = 92: 8 lanes of 3 quads (92 of 96 columns busy,
    where one warp a row kept 92 of 128), 32 rows a group, and on 132 SMs
    782 blocks of one group each for 25,000 rows, 1,042 of at most 30
    groups each for a million; the widths that fill a power of two of lanes take all
    32; past 1024 columns the chunked walk."""
    p = tgumbel.gumbel_plan(25000, 92)
    assert (p["lanes"], p["quads"], p["chunks"], p["rows"]) == (8, 3, 1, 32)
    assert (p["groups"], p["grid"]) == (782, 782)
    p = tgumbel.gumbel_plan(10 ** 6, 92)
    assert (p["groups"], p["grid"]) == (31250, 1042)
    assert (tgumbel.gumbel_plan(10, 128)["lanes"],
            tgumbel.gumbel_plan(10, 128)["quads"]) == (32, 1)
    assert tgumbel.gumbel_plan(10, 600)["quads"] == 5
    assert tgumbel.gumbel_plan(10, 1024)["chunks"] == 1
    assert tgumbel.gumbel_plan(10, 1025)["chunks"] == 3
    assert tgumbel.gumbel_plan(10, 4099)["chunks"] == 9


def test_no_plan_or_wrapper_refuses_a_width():
    """Every C from 1 to 5,000 (and far wider) has a plan, and the operand
    check takes it: no category limit is left in the wrappers."""
    for C in list(range(1, 5001)) + [65536, 1 << 20]:
        p = tgumbel.gumbel_plan(7, C)
        assert 4 * p["lanes"] * p["quads"] * p["chunks"] >= C
    for C in (513, 1100, 4099, 70000):
        phi = torch.zeros(3, C)
        assert tgumbel._check_rows(("phi", "u"), (phi, phi)) == (3, C)
