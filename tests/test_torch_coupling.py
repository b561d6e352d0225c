"""The PyTorch port's fused coupling distance (dvae_tpu_torch/ops/coupling.py)
against dvae_tpu/ops/coupling_pallas.py.

Inputs come from numpy seeds, the five cases of
tests/test_ops.py::TestCouplingPallas.  JAX runs on the CPU with its Pallas
kernel in interpret mode; the port on CPU tensors runs its plain version,
which walks the two phases the CUDA kernels walk.  Tolerances, with their
reason:

  * the Gram matrix (rtol 2e-4, atol 1e-5 after division by B,
    tests/test_ops.py:41): f32 sums of B·C products in another order, the
    column sums in double here and in f32 there;
  * the distance (rtol 2e-4, :47) and its gradient (rtol 1e-4, :53: both
    sides differentiate the eager form; atol 1e-6 of the largest entry,
    because an entry is a sum over the other arms of terms that cancel, and
    XLA and torch sum them in another order);
  * the two degenerate inputs (rtol 5e-3, :71 and :88): dead categories
    put log(eps)·rsqrt(eps) ≈ −1.8e5 into every arm and a collapsed arm
    drives the one-pass variance to its clamp, so what is left after the
    centring carries f32 rounding at that size.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvae_tpu.models import losses as jlosses
from dvae_tpu.ops import coupling_pallas as jcoupling

from dvae_tpu_torch.models import losses as tlosses
from dvae_tpu_torch.ops import coupling as tcoupling

EPS = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _probs(A, B, C, seed=5):
    x = np.random.default_rng(seed).random((A, B, C)).astype(np.float32)
    return x / x.sum(-1, keepdims=True)


def _dead_categories():
    """Near-one-hot posteriors with categories 16..23 exactly 0 in every
    arm (tests/test_ops.py:55-71)."""
    rng = np.random.default_rng(7)
    A, B, C, live = 3, 400, 24, 16
    labels = rng.integers(0, live, (A, B))
    c = np.zeros((A, B, C), np.float32)
    for a in range(A):
        c[a, np.arange(B), labels[a]] = 1.0
    return c


def _collapsed_arm(B=1000):
    """Arm 0 collapsed onto category 3 (tests/test_ops.py:73-88, fewer
    rows)."""
    rng = np.random.default_rng(8)
    A, C = 2, 12
    z = rng.normal(size=(A, B, C)).astype(np.float32) / 0.05
    z = np.exp(z - z.max(-1, keepdims=True))
    c = (z / z.sum(-1, keepdims=True)).astype(np.float32)
    col = np.full((B, C), 1e-8, np.float32)
    col[:, 3] = 1.0
    c[0] = col / col.sum(-1, keepdims=True)
    return c


@pytest.mark.parametrize("shape", [(2, 64, 10), (5, 300, 92), (3, 1025, 17)])
def test_gram_matches_the_interpreted_kernel(shape):
    c = _probs(*shape)
    B = shape[1]
    want = np.asarray(jcoupling.coupling_gram_pallas(jnp.asarray(c), EPS)) / B
    got = tcoupling.coupling_gram_plain(torch.from_numpy(c), EPS).numpy() / B
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(got, got.T)
    fused = tcoupling.coupling_gram_fused(torch.from_numpy(c), EPS)
    np.testing.assert_array_equal(fused.numpy() / B, got)


def test_distance_matches_the_interpreted_kernel_and_the_eager_form():
    c = _probs(4, 500, 30)
    want = float(jcoupling.coupling_distance_pallas(jnp.asarray(c), EPS))
    got = float(tcoupling.coupling_distance_fused(torch.from_numpy(c), EPS))
    eager = float(tlosses.coupling_distance(torch.from_numpy(c), EPS))
    assert got == pytest.approx(want, rel=2e-4)
    assert got == pytest.approx(eager, rel=2e-4)
    assert got == pytest.approx(
        float(jlosses.coupling_distance(jnp.asarray(c), EPS)), rel=2e-4)


def test_gradient_matches_jax_grad():
    c = _probs(3, 100, 12)
    want = jax.grad(lambda x: jcoupling.coupling_distance_pallas(x, EPS))(
        jnp.asarray(c))
    x = torch.from_numpy(c).requires_grad_()
    d = tcoupling.coupling_distance_fused(x, EPS)
    (3.0 * d).backward()
    want = np.asarray(want)
    np.testing.assert_allclose(x.grad.numpy() / 3.0, want, rtol=1e-4,
                               atol=1e-6 * float(np.abs(want).max()))
    # exactly the eager form's gradient, as the JAX package's _bwd takes it
    y = torch.from_numpy(c).requires_grad_()
    (3.0 * tlosses.coupling_distance(y, EPS)).backward()
    assert torch.equal(x.grad, y.grad)


def test_sharp_posteriors_with_dead_categories():
    c = _dead_categories()
    ref = float(jlosses.coupling_distance(jnp.asarray(c), EPS))
    want = float(jcoupling.coupling_distance_pallas(jnp.asarray(c), EPS))
    got = float(tcoupling.coupling_distance_fused(torch.from_numpy(c), EPS))
    assert ref > 1.0               # the arms genuinely disagree
    assert got == pytest.approx(ref, rel=5e-3)
    assert got == pytest.approx(want, rel=5e-3)


def test_collapsed_arm_constant_category_no_nan():
    c = _collapsed_arm()
    ref = float(jlosses.coupling_distance(jnp.asarray(c), EPS))
    want = float(jcoupling.coupling_distance_pallas(jnp.asarray(c), EPS))
    got = float(tcoupling.coupling_distance_fused(torch.from_numpy(c), EPS))
    assert np.isfinite(got)
    assert got == pytest.approx(ref, rel=5e-3)
    assert got == pytest.approx(want, rel=5e-3)


def test_clamp_guards_a_negative_one_pass_variance():
    """A category that is the same value in every row: the one-pass
    variance may come out slightly negative; the clamp lands on
    rsqrt(eps) and the Gram stays finite."""
    c = _probs(2, 257, 6, seed=3)
    c[0, :, 2] = 0.3
    g = tcoupling.coupling_gram_plain(torch.from_numpy(c), EPS)
    assert bool(torch.isfinite(g).all())
    want = np.asarray(jcoupling.coupling_gram_pallas(jnp.asarray(c), EPS))
    np.testing.assert_allclose(g.numpy() / 257, want / 257, rtol=5e-3,
                               atol=1e-3)


def test_wrapper_checks_its_operand_and_counts_no_launch_on_the_cpu():
    c = torch.from_numpy(_probs(2, 16, 4))
    before = tcoupling.coupling_gram_fused.launches
    tcoupling.coupling_distance_fused(c, EPS)
    tcoupling.coupling_gram_fused(c, EPS)
    assert tcoupling.coupling_gram_fused.launches == before
    with pytest.raises(ValueError, match=r"\(A, B, C\)"):
        tcoupling.coupling_gram_fused(c[0], EPS)
    with pytest.raises(ValueError, match="B >= 2"):
        tcoupling.coupling_distance_fused(c[:, :1], EPS)
    with pytest.raises(ValueError, match="unsupported device"):
        tcoupling.coupling_gram_fused(c.to("meta"), EPS)


def test_no_grad_call_returns_a_plain_scalar():
    c = torch.from_numpy(_probs(3, 40, 5)).requires_grad_()
    with torch.no_grad():
        d = tcoupling.coupling_distance_fused(c, EPS)
    assert d.shape == () and not d.requires_grad


# ---------------------------------------------------------------------------
# The launch plan of kernel #11 (one cooperative launch): its Python twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 5000, 92), (5, 4999, 92),
                                   (2, 64, 10), (10, 130, 17), (5, 50000, 92),
                                   (10, 5000, 1024), (1, 2, 1), (3, 1060, 7)])
def test_coupling_plan_covers_b_once_from_the_shape_alone(shape):
    """The block count is min(132, ceil(B / 8)) whatever the card, each
    block owns one slab of consecutive rows of every arm, the slabs cover
    [0, B) once and in order, and the shared memory fits one block."""
    A, B, C = shape
    p = tcoupling.coupling_plan(A, B, C)
    assert p == tcoupling.coupling_plan(A, B, C)
    assert p["nb"] == min(132, -(-B // 8)) and p["rows"] == -(-B // p["nb"])
    slabs = [np.arange(B)[b * p["rows"]:(b + 1) * p["rows"]]
             for b in range(p["nb"])]
    np.testing.assert_array_equal(np.concatenate(slabs), np.arange(B))
    assert 1 <= p["piece"] <= p["rows"]
    assert p["keep"] == (p["piece"] == p["rows"]
                         and 4 * A * C * p["rows"] <= 160 * 1024)
    assert p["smem"] == 4 * A * C * p["piece"] + 4 * (A + 1) * C
    assert p["smem"] + 4 * 1024 <= 232448


def test_coupling_plan_keeps_the_logs_at_the_production_shape():
    """A=5, B=5000, C=92: 132 slabs of 38 rows whose logs stay in 70 KB of
    shared memory, so c is read once; at A=10, C=1024 (the kernel's largest
    arms and categories) a slab's logs need 1.56 MB, so the kernel walks it
    in pieces of 4 rows and reads c again for phase 1."""
    p = tcoupling.coupling_plan(5, 5000, 92)
    assert (p["nb"], p["rows"], p["piece"], p["keep"]) == (132, 38, 38, True)
    assert p["smem"] == 5 * 38 * 92 * 4 + 6 * 92 * 4 == 72128
    q = tcoupling.coupling_plan(10, 5000, 1024)
    assert (q["nb"], q["rows"], q["piece"], q["keep"]) == (132, 38, 4, False)
    assert q["smem"] == 208896


# ---------------------------------------------------------------------------
# Fault C8: any A and C.  Past 10 arms or 1024 categories the CUDA kernel
# runs its general form (arm pairs in tiles, c kept out of shared memory);
# the plain version it is held against on the card is held here against
# the interpreted TPU kernel at the same shapes.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(12, 64, 1100), (16, 130, 92)])
def test_many_arms_and_categories_match_the_interpreted_kernel(shape):
    """The Gram within 2e-4 of its largest entry (chip_smoke.py's
    ``TOL_GRAM``): with 16 arms its off-diagonal entries, about 1e4, are
    sums of terms that cancel against a diagonal of 2e6, so an entry-wise
    tolerance would hold the summation order, not the algorithm; the
    distance within 1e-4, relative."""
    c = _probs(*shape, seed=11)
    want = np.asarray(jcoupling.coupling_gram_pallas(jnp.asarray(c), EPS))
    got = tcoupling.coupling_gram_plain(torch.from_numpy(c), EPS).numpy()
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()
    np.testing.assert_array_equal(got, got.T)
    d_want = float(jcoupling.coupling_distance_pallas(jnp.asarray(c), EPS))
    d_got = float(tcoupling.coupling_distance_fused(torch.from_numpy(c), EPS))
    assert d_got == pytest.approx(d_want, rel=1e-4)


def test_coupling_plan_takes_any_arms_and_categories():
    """The twin of #11's plan for A from 1 to 16 and C from 1 to 4099: the
    templated kernel up to 10 arms and 1024 categories, with the plan of
    the earlier sweep; past either, the general kernel, whose shared
    memory is A doubles.  Every plan fits one block's shared memory and
    its slabs cover B once."""
    cs = sorted({1, 2, 7, 92, 100, 511, 1023, 1024, 1025, 1100, 2048, 4099}
                | set(range(1, 4100, 97)))
    for A in range(1, 17):
        for C in cs:
            for B in (2, 130, 5000):
                p = tcoupling.coupling_plan(A, B, C)
                assert p["general"] == (A > 10 or C > 1024), (A, B, C)
                assert p["nb"] == min(132, -(-B // 8))
                assert p["rows"] == -(-B // p["nb"])
                assert p["nb"] * p["rows"] >= B > (p["nb"] - 1) * p["rows"]
                assert p["smem"] <= 232448
                if p["general"]:
                    assert (p["piece"], p["keep"], p["smem"]) == (0, False,
                                                                  8 * A)
                else:
                    assert 1 <= p["piece"] <= p["rows"]
                    assert p["smem"] == (4 * A * C * p["piece"]
                                         + 4 * (A + 1) * C)


def test_no_limit_is_named_or_checked():
    """The wrapper and the kernel's source take any A >= 1, B >= 2 and
    C >= 1: no limit is exported, checked or named in a message, and the
    wrapper serves A=12, C=1100 (the plain version here)."""
    import inspect
    import pathlib
    src = inspect.getsource(tcoupling)
    cu = (pathlib.Path(tcoupling.__file__).parents[1] / "csrc"
          / "coupling.cu").read_text()
    for text in (src, cu):
        assert "coupling_max_arms" not in text
        assert "coupling_max_c" not in text
    assert "return A >= 1 && B >= 2 && C >= 1;" in cu
    assert "exceed" not in src
    c = torch.from_numpy(_probs(12, 4, 1100, seed=2))
    g = tcoupling.coupling_gram_fused(c, EPS)
    assert g.shape == (12, 12) and bool(torch.isfinite(g).all())
