"""The PyTorch port's count distributions and input transforms
(dvae_tpu_torch/models/distributions.py, utils/tools.py) against scipy and
against dvae_tpu/models/distributions.py.

The scipy-oracle cases are those of tests/test_eval_stack.py:144-331 on the
port's classes.  Log-probs are held to the JAX package's on the same numpy
inputs (rtol 1e-5, atol 1e-5: the same formula, with XLA's and ATen's
lgamma and softplus a few f32 roundings apart on values up to 1e2).
Samples come from a seeded ``torch.Generator``: another bitstream than a
JAX key gives, so moments are held within a stated statistical bound.
"""

import numpy as np
import pytest
import torch
from scipy import stats

import jax.numpy as jnp

from dvae_tpu.models import distributions as jdist
from dvae_tpu.utils import tools as jtools

from dvae_tpu_torch.models import distributions as tdist
from dvae_tpu_torch.utils import tools as ttools

CLOSE = dict(rtol=1e-5, atol=1e-5)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


def _params(seed=0, n=64):
    rng = np.random.default_rng(seed)
    x = rng.poisson(4.0, n) * (rng.random(n) > 0.3)
    mu = rng.gamma(2.0, 2.0, n) + 0.05
    mu2 = rng.gamma(2.0, 4.0, n) + 0.05
    theta = rng.lognormal(0.5, 0.5, n)
    theta2 = rng.lognormal(1.0, 0.5, n)
    logits = rng.normal(0, 1.5, n)
    return x, mu, mu2, theta, theta2, logits


def test_nb_logprob_matches_scipy():
    mu, theta = 4.0, 2.5
    k = np.arange(0, 20, dtype=np.float32)
    d = tdist.NegativeBinomial(torch.tensor(mu), torch.tensor(theta))
    ref = stats.nbinom(n=theta, p=theta / (theta + mu)).logpmf(k)
    np.testing.assert_allclose(d.log_prob(torch.from_numpy(k)).numpy(), ref,
                               rtol=1e-4)
    assert float(d.mean) == mu
    assert float(d.variance) == pytest.approx(mu + mu * mu / theta)


def test_zinb_logprob_zero_inflation():
    mu, theta, pi_logit = 4.0, 2.5, 0.7
    zinb = tdist.ZeroInflatedNegativeBinomial(
        torch.tensor(mu), torch.tensor(theta), torch.tensor(pi_logit))
    nb = tdist.NegativeBinomial(torch.tensor(mu), torch.tensor(theta))
    p = 1 / (1 + np.exp(-pi_logit))
    # P_zinb(0) = p + (1-p)·P_nb(0);  P_zinb(k>0) = (1-p)·P_nb(k)
    expected0 = np.log(p + (1 - p) * np.exp(float(nb.log_prob(0.0))))
    assert float(zinb.log_prob(torch.tensor(0.0))) == pytest.approx(
        expected0, rel=1e-5)
    expected3 = np.log(1 - p) + float(nb.log_prob(3.0))
    assert float(zinb.log_prob(torch.tensor(3.0))) == pytest.approx(
        expected3, rel=1e-5)
    assert float(zinb.mean) == pytest.approx((1 - p) * mu, rel=1e-6)
    nb_var = mu + mu * mu / theta
    assert float(zinb.variance) == pytest.approx(
        (1 - p) * (nb_var + p * mu * mu), rel=1e-6)


def test_gamma_log_prob_matches_scipy():
    g = tdist.Gamma(torch.tensor(2.5), torch.tensor(0.7))
    x = np.asarray([0.3, 1.0, 4.2], np.float32)
    want = stats.gamma.logpdf(x, a=2.5, scale=1 / 0.7)
    np.testing.assert_allclose(g.log_prob(torch.from_numpy(x)).numpy(), want,
                               rtol=1e-5)
    # the exponential case stays finite at the x == 0 boundary
    g1 = tdist.Gamma(torch.tensor(1.0), torch.tensor(0.7))
    np.testing.assert_allclose(
        float(g1.log_prob(torch.tensor(0.0))),
        stats.gamma.logpdf(0.0, a=1.0, scale=1 / 0.7), rtol=1e-5)


@pytest.mark.parametrize("fn", ["nb", "zinb", "mixture", "mixture_shared"])
def test_log_probs_match_jax(fn):
    x, mu, mu2, theta, theta2, logits = _params()
    if fn == "nb":
        got = tdist.log_nb_positive(*_t(x, mu, theta))
        want = jdist.log_nb_positive(*_j(x, mu, theta))
    elif fn == "zinb":
        got = tdist.log_zinb_positive(*_t(x, mu, theta, logits))
        want = jdist.log_zinb_positive(*_j(x, mu, theta, logits))
    elif fn == "mixture":
        got = tdist.log_mixture_nb(*_t(x, mu, mu2, theta, theta2, logits))
        want = jdist.log_mixture_nb(*_j(x, mu, mu2, theta, theta2, logits))
    else:
        tx, tm, tm2, tth, tl = _t(x, mu, mu2, theta, logits)
        jx, jm, jm2, jth, jl = _j(x, mu, mu2, theta, logits)
        got = tdist.log_mixture_nb(tx, tm, tm2, tth, None, tl)
        want = jdist.log_mixture_nb(jx, jm, jm2, jth, None, jl)
        np.testing.assert_allclose(
            got.numpy(),
            tdist.log_mixture_nb(tx, tm, tm2, tth, tth, tl).numpy())
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)


def test_distribution_objects_match_jax():
    x, mu, mu2, theta, theta2, logits = _params(1)
    pairs = [
        (tdist.NegativeBinomial(*_t(mu, theta)),
         jdist.NegativeBinomial(*_j(mu, theta))),
        (tdist.ZeroInflatedNegativeBinomial(*_t(mu, theta, logits)),
         jdist.ZeroInflatedNegativeBinomial(*_j(mu, theta, logits))),
        (tdist.NegativeBinomialMixture(*_t(mu, mu2, theta, logits)),
         jdist.NegativeBinomialMixture(*_j(mu, mu2, theta, logits))),
        (tdist.Gamma(*_t(theta, theta2)), jdist.Gamma(*_j(theta, theta2))),
    ]
    for td, jd in pairs:
        name = type(td).__name__
        np.testing.assert_allclose(np.asarray(td.mean), np.asarray(jd.mean),
                                   **CLOSE, err_msg=name)
        arg = x + 0.5 if name == "Gamma" else x
        np.testing.assert_allclose(td.log_prob(_t(arg)[0]).numpy(),
                                   np.asarray(jd.log_prob(_j(arg)[0])),
                                   **CLOSE, err_msg=name)
        if hasattr(td, "variance"):
            np.testing.assert_allclose(np.asarray(td.variance),
                                       np.asarray(jd.variance), rtol=1e-5,
                                       err_msg=name)
    d = tdist.NegativeBinomialMixture(torch.tensor(2.0), torch.tensor(10.0),
                                      torch.tensor(3.0), torch.tensor(0.0))
    assert float(d.mean) == pytest.approx(6.0)      # a 50/50 mixture
    assert np.isfinite(float(d.log_prob(torch.tensor(5.0))))


def test_conversions_and_mixing_gamma():
    """mu/theta <-> counts/logits invert each other; ``_gamma`` has the NB
    mean; its samples' mean is within 10% over 4,000 draws (the sd of the
    mean is at most 1.6% of it here)."""
    mu = torch.tensor([0.5, 3.0, 40.0])
    theta = torch.tensor([1.0, 2.0, 8.0])
    tc, logits = tdist._convert_mean_disp_to_counts_logits(mu, theta, eps=0.0)
    mu2, theta2 = tdist._convert_counts_logits_to_mean_disp(tc, logits)
    np.testing.assert_allclose(mu2.numpy(), mu.numpy(), rtol=1e-6)
    np.testing.assert_allclose(theta2.numpy(), theta.numpy())
    jtc, jlogits = jdist._convert_mean_disp_to_counts_logits(
        *_j(mu.numpy(), theta.numpy()))
    np.testing.assert_allclose(
        tdist._convert_mean_disp_to_counts_logits(mu, theta)[1].numpy(),
        np.asarray(jlogits), **CLOSE)
    g = tdist._gamma(theta, mu)
    np.testing.assert_allclose(g.mean.numpy(), mu.numpy(), rtol=1e-6)
    s = g.sample(torch.Generator().manual_seed(0), (4000,))
    assert tuple(s.shape) == (4000, 3)
    np.testing.assert_allclose(s.mean(dim=0).numpy(), mu.numpy(), rtol=0.1)
    with pytest.raises(ValueError):
        tdist._convert_mean_disp_to_counts_logits(None, torch.ones(3))


def test_nb_sampling_moments():
    """20,000 draws: the mean within 5% (its sd is 0.5%), the variance
    within 10% (its sd is about 2%)."""
    d = tdist.NegativeBinomial(torch.tensor(5.0), torch.tensor(3.0))
    gen = torch.Generator().manual_seed(0)
    s = d.sample(gen, (20000,)).numpy()
    assert s.dtype == np.float32 and (s == np.round(s)).all() and s.min() >= 0
    assert s.mean() == pytest.approx(5.0, rel=0.05)
    assert s.var() == pytest.approx(float(d.variance), rel=0.1)
    again = d.sample(torch.Generator().manual_seed(0), (20000,)).numpy()
    np.testing.assert_array_equal(s, again)


def test_zinb_and_mixture_sampling_moments():
    """The zero fraction and the mean of 40,000 ZINB draws against the
    distribution's own (zero fraction within 0.01: sd 0.0025; mean within
    5%: sd 0.9%), and the mean of a mixture's draws within 5%."""
    mu, theta, logit = 6.0, 2.0, -0.4
    d = tdist.ZeroInflatedNegativeBinomial(
        torch.tensor(mu), torch.tensor(theta), torch.tensor(logit))
    s = d.sample(torch.Generator().manual_seed(1), (40000,)).numpy()
    p0 = float(torch.exp(d.log_prob(torch.tensor(0.0))))
    assert abs((s == 0).mean() - p0) < 0.01
    assert s.mean() == pytest.approx(float(d.mean), rel=0.05)
    assert s.var() == pytest.approx(float(d.variance), rel=0.1)
    m = tdist.NegativeBinomialMixture(
        torch.full((40000,), 2.0), torch.full((40000,), 10.0),
        torch.tensor(3.0), torch.full((40000,), 0.8))
    sm = m.sample(torch.Generator().manual_seed(2)).numpy()
    assert sm.mean() == pytest.approx(float(m.mean[0]), rel=0.05)
    # broadcasting: per-gene theta and logits against a (cells, genes) mean
    z = tdist.ZeroInflatedNegativeBinomial(
        torch.rand(7, 5) + 1.0, torch.ones(5), torch.zeros(5))
    assert tuple(z.sample(torch.Generator().manual_seed(3)).shape) == (7, 5)


def test_tools_match_jax_package():
    rng = np.random.default_rng(4)
    x = rng.gamma(2, 2, (10, 30))
    x[3] = 0.0                                    # an empty cell
    n = ttools.normalize_cellxgene(x)
    np.testing.assert_allclose(np.delete(n, 3, axis=0).sum(1), 1.0,
                               rtol=1e-9)
    assert (n[3] == 0).all()
    np.testing.assert_array_equal(n, jtools.normalize_cellxgene(x))
    np.testing.assert_array_equal(ttools.logcpm(x), jtools.logcpm(x))
    np.testing.assert_allclose(ttools.logcpm(x), np.log1p(n * 1e6))
