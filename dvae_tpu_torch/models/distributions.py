"""Count likelihoods: NB / ZINB / NB-mixture log-probs and distributions.

Counterpart of dvae_tpu/models/distributions.py (reference
``mmidas/utils/distributions.py``, scvi-tools style: ``log_zinb_positive``
:15, ``log_nb_positive`` :65, ``log_mixture_nb`` :100, ``NegativeBinomial``
:224, ``ZeroInflatedNegativeBinomial`` :323, ``NegativeBinomialMixture``
:418).  Sampling goes through the gamma-Poisson mixture and takes a
``torch.Generator`` where the JAX package takes a key: the two draw other
numbers from the same seed, the distributions are the same.

Parameterization as in the reference: NB with mean ``mu`` and inverse
dispersion ``theta``; ZINB adds zero-inflation logits ``zi_logits``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F


def _t(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        v, dtype=torch.float32)


def log_nb_positive(x, mu, theta, eps: float = 1e-8) -> torch.Tensor:
    """NB(mu, theta) log-prob (reference distributions.py:65-97)."""
    x, mu, theta = _t(x), _t(mu), _t(theta)
    log_theta_mu_eps = torch.log(theta + mu + eps)
    return (theta * (torch.log(theta + eps) - log_theta_mu_eps)
            + x * (torch.log(mu + eps) - log_theta_mu_eps)
            + torch.lgamma(x + theta) - torch.lgamma(theta)
            - torch.lgamma(x + 1))


def log_zinb_positive(x, mu, theta, pi, eps: float = 1e-8) -> torch.Tensor:
    """ZINB log-prob with zero-inflation logits ``pi`` (reference
    distributions.py:15-62)."""
    x, mu, theta, pi = _t(x), _t(mu), _t(theta), _t(pi)
    softplus_pi = F.softplus(-pi)
    log_theta_eps = torch.log(theta + eps)
    log_theta_mu_eps = torch.log(theta + mu + eps)
    pi_theta_log = -pi + theta * (log_theta_eps - log_theta_mu_eps)

    case_zero = F.softplus(pi_theta_log) - softplus_pi
    case_non_zero = (-softplus_pi + pi_theta_log
                     + x * (torch.log(mu + eps) - log_theta_mu_eps)
                     + torch.lgamma(x + theta) - torch.lgamma(theta)
                     - torch.lgamma(x + 1))
    return torch.where(x < eps, case_zero, case_non_zero)


def log_mixture_nb(x, mu_1, mu_2, theta_1, theta_2, pi_logits,
                   eps: float = 1e-8) -> torch.Tensor:
    """Two-component NB mixture log-prob (reference distributions.py
    :100-165).  With ``theta_2`` None both components share ``theta_1``."""
    theta_2 = theta_1 if theta_2 is None else theta_2
    pi_logits = _t(pi_logits)
    lp1 = log_nb_positive(x, mu_1, theta_1, eps)
    lp2 = log_nb_positive(x, mu_2, theta_2, eps)
    log_pi = -F.softplus(-pi_logits)        # log sigmoid(pi)
    log_1m_pi = -F.softplus(pi_logits)
    return torch.logaddexp(lp1 + log_pi, lp2 + log_1m_pi)


# ---------------------------------------------------------------------------
# NB parameterization conversions (reference distributions.py:171-220)
# ---------------------------------------------------------------------------

def _convert_mean_disp_to_counts_logits(mu, theta, eps: float = 1e-6):
    """(mu, theta) → (total_count, logits) (reference :171-194)."""
    if (mu is None) != (theta is None):
        raise ValueError(
            "If using the mu/theta NB parameterization, both parameters "
            "must be specified")
    logits = torch.log(_t(mu) + eps) - torch.log(_t(theta) + eps)
    return theta, logits


def _convert_counts_logits_to_mean_disp(total_count, logits):
    """(total_count, logits) → (mu, theta) (reference :197-213)."""
    theta = total_count
    mu = torch.exp(_t(logits)) * theta
    return mu, theta


def _sample_gamma(concentration, shape, generator) -> torch.Tensor:
    """Gamma(concentration, 1) draws from ``generator``
    (``torch._standard_gamma`` is what ``torch.distributions.Gamma``
    calls; it takes a generator, the distribution class does not)."""
    c = _t(concentration).expand(shape).contiguous()
    return torch._standard_gamma(c, generator=generator)


@dataclass(frozen=True)
class Gamma:
    """Gamma(concentration, rate): the latent mixing distribution of the
    NB's gamma-Poisson representation (reference ``_gamma`` :216-221)."""

    concentration: torch.Tensor
    rate: torch.Tensor

    @property
    def mean(self):
        return _t(self.concentration) / _t(self.rate)

    def sample(self, generator: Optional[torch.Generator] = None,
               sample_shape=()):
        c, r = _t(self.concentration), _t(self.rate)
        shape = tuple(sample_shape) + tuple(
            torch.broadcast_shapes(c.shape, r.shape))
        return _sample_gamma(c, shape, generator) / r

    def log_prob(self, x):
        c, r, x = _t(self.concentration), _t(self.rate), _t(x)
        # xlogy keeps the exponential case (c == 1) finite at x == 0
        return (c * torch.log(r) + torch.xlogy(c - 1, x) - r * x
                - torch.lgamma(c))


def _gamma(theta, mu) -> Gamma:
    """The NB(mu, theta) mixing Gamma (reference :216-221)."""
    return Gamma(concentration=_t(theta), rate=_t(theta) / _t(mu))


# ---------------------------------------------------------------------------
# Distribution objects (sample / mean / variance / log_prob)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NegativeBinomial:
    """NB(mu, theta): gamma-Poisson mixture (reference :224-320)."""

    mu: torch.Tensor
    theta: torch.Tensor
    eps: float = 1e-8

    @property
    def mean(self):
        return _t(self.mu)

    @property
    def variance(self):
        return _t(self.mu) + _t(self.mu) ** 2 / _t(self.theta)

    def log_prob(self, x):
        return log_nb_positive(x, self.mu, self.theta, self.eps)

    def sample(self, generator: Optional[torch.Generator] = None,
               sample_shape=()):
        mu, theta = _t(self.mu), _t(self.theta)
        shape = tuple(sample_shape) + tuple(
            torch.broadcast_shapes(mu.shape, theta.shape))
        # Gamma(theta, scale = mu/theta) → Poisson
        rate = _sample_gamma(theta, shape, generator) * (mu / theta)
        return torch.poisson(rate, generator=generator).float()


@dataclass(frozen=True)
class ZeroInflatedNegativeBinomial:
    """ZINB(mu, theta, zi_logits) (reference :323-415)."""

    mu: torch.Tensor
    theta: torch.Tensor
    zi_logits: torch.Tensor
    eps: float = 1e-8

    @property
    def zi_probs(self):
        return torch.sigmoid(_t(self.zi_logits))

    @property
    def mean(self):
        return (1 - self.zi_probs) * _t(self.mu)

    @property
    def variance(self):
        p, mu = self.zi_probs, _t(self.mu)
        nb_var = mu + mu ** 2 / _t(self.theta)
        return (1 - p) * (nb_var + p * mu ** 2)

    def log_prob(self, x):
        return log_zinb_positive(x, self.mu, self.theta, self.zi_logits,
                                 self.eps)

    def sample(self, generator: Optional[torch.Generator] = None,
               sample_shape=()):
        nb = NegativeBinomial(self.mu, self.theta).sample(generator,
                                                          sample_shape)
        dropout = torch.bernoulli(self.zi_probs.expand(nb.shape),
                                  generator=generator).bool()
        return torch.where(dropout, torch.zeros_like(nb), nb)


@dataclass(frozen=True)
class NegativeBinomialMixture:
    """Two-component NB mixture (reference :418-518)."""

    mu1: torch.Tensor
    mu2: torch.Tensor
    theta1: torch.Tensor
    mixture_logits: torch.Tensor
    theta2: Optional[torch.Tensor] = None
    eps: float = 1e-8

    @property
    def mixture_probs(self):
        return torch.sigmoid(_t(self.mixture_logits))

    @property
    def mean(self):
        p = self.mixture_probs
        return p * _t(self.mu1) + (1 - p) * _t(self.mu2)

    def log_prob(self, x):
        return log_mixture_nb(x, self.mu1, self.mu2, self.theta1,
                              self.theta2, self.mixture_logits, self.eps)

    def sample(self, generator: Optional[torch.Generator] = None,
               sample_shape=()):
        comp1 = torch.bernoulli(self.mixture_probs,
                                generator=generator).bool()
        mu = torch.where(comp1, _t(self.mu1), _t(self.mu2))
        theta = (_t(self.theta1) if self.theta2 is None
                 else torch.where(comp1, _t(self.theta1), _t(self.theta2)))
        return NegativeBinomial(mu, theta).sample(generator, sample_shape)
