"""Scalar exponential families beyond the Gaussian (counterpart of
``rxinfer_tpu/dists/scalar_families.py``).

``Beta``, ``Bernoulli`` and its natural-parameter carrier
``BernoulliLogits`` (the Beta-Bernoulli conjugate pair), ``AbstractGamma``
with ``GammaShapeRate`` and ``GammaShapeScale``, the conjugate carriers of a
scalar precision or rate, ``InverseGamma`` (of a scalar variance),
``Poisson``, ``Binomial`` (its trial count a float tensor beside the
probability) and ``Uniform``; each with its mean, log-expectations, entropy
and closed-form product where the family has one.  Draws, modes and
log-densities live in ``sampling.py``.  Every tensor may carry leading
batch dimensions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .base import HUGE, TINY, Distribution, dist_dataclass, register_prod


def betaln(a, b):
    """log B(a, b) = lgamma(a) + lgamma(b) - lgamma(a + b)."""
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


@dist_dataclass
class Beta(Distribution):
    """Beta(a, b)."""

    a: torch.Tensor
    b: torch.Tensor

    def mean(self):
        return self.a / (self.a + self.b)

    def var(self):
        s = self.a + self.b
        return self.a * self.b / (s * s * (s + 1.0))

    # The expectations and the entropy are evaluated in float64 and
    # rounded once: at counts in the thousands they are differences of
    # digammas (and log-gammas) that float32 leaves at the 1e-4 level of a
    # free energy (the JAX package evaluates them in float32).

    def mean_log(self):
        a, b = self.a.double(), self.b.double()
        return (torch.digamma(a) - torch.digamma(a + b)).to(self.a.dtype)

    def mean_mirrorlog(self):
        """E[log(1 - x)]."""
        a, b = self.a.double(), self.b.double()
        return (torch.digamma(b) - torch.digamma(a + b)).to(self.a.dtype)

    def entropy(self):
        a, b = self.a.double(), self.b.double()
        return (betaln(a, b) - (a - 1.0) * torch.digamma(a)
                - (b - 1.0) * torch.digamma(b)
                + (a + b - 2.0) * torch.digamma(a + b)).to(self.a.dtype)


@register_prod(Beta, Beta)
def _prod_beta(x: Beta, y: Beta) -> Beta:
    return Beta(x.a + y.a - 1.0, x.b + y.b - 1.0)


@dist_dataclass
class Bernoulli(Distribution):
    """Bernoulli(p)."""

    p: torch.Tensor

    def mean(self):
        return self.p

    def var(self):
        return self.p * (1.0 - self.p)

    def entropy(self):
        p = self.p
        return -(torch.xlogy(p, p) + torch.xlogy(1.0 - p, 1.0 - p))


@register_prod(Bernoulli, Bernoulli)
def _prod_bernoulli(x: Bernoulli, y: Bernoulli) -> Bernoulli:
    num = x.p * y.p
    return Bernoulli(num / (num + (1.0 - x.p) * (1.0 - y.p)))


@dist_dataclass
class BernoulliLogits(Distribution):
    """Bernoulli carried by its log-odds, the natural parameter: message
    products add logits exactly, with no p <-> logit round trip."""

    logit: torch.Tensor

    def mean(self):
        return torch.sigmoid(self.logit)

    def var(self):
        p = self.mean()
        return p * (1.0 - p)

    def entropy(self):
        lg = self.logit
        p = torch.sigmoid(lg)
        # log p = -softplus(-l), log(1 - p) = -softplus(l): stable in the tails
        return p * F.softplus(-lg) + (1.0 - p) * F.softplus(lg)


class AbstractGamma(Distribution):
    """Gamma statistics over (shape, rate) accessors."""

    def shape_rate(self):
        raise NotImplementedError

    def mean(self):
        a, b = self.shape_rate()
        return a / b

    def var(self):
        a, b = self.shape_rate()
        return a / (b * b)

    def mean_log(self):
        a, b = self.shape_rate()
        return torch.digamma(a) - torch.log(b)

    def entropy(self):
        a, b = self.shape_rate()
        return a - torch.log(b) + torch.lgamma(a) + (1.0 - a) * torch.digamma(a)


@dist_dataclass
class GammaShapeRate(AbstractGamma):
    """Gamma(shape a, rate b); E[x] = a / b."""

    a: torch.Tensor
    b: torch.Tensor

    def shape_rate(self):
        return self.a, self.b

    @classmethod
    def vague(cls, dtype=torch.float32):
        return cls(torch.tensor(1.0, dtype=dtype), torch.tensor(TINY, dtype=dtype))


@dist_dataclass
class GammaShapeScale(AbstractGamma):
    """Gamma(shape a, scale theta); E[x] = a theta."""

    a: torch.Tensor
    theta: torch.Tensor

    def shape_rate(self):
        return self.a, 1.0 / self.theta

    @classmethod
    def vague(cls, dtype=torch.float32):
        return cls(torch.tensor(1.0, dtype=dtype), torch.tensor(HUGE, dtype=dtype))


def _prod_gamma(x, y):
    ax, bx = x.shape_rate()
    ay, by = y.shape_rate()
    return GammaShapeRate(ax + ay - 1.0, bx + by)


for _t1 in (GammaShapeRate, GammaShapeScale):
    for _t2 in (GammaShapeRate, GammaShapeScale):
        register_prod(_t1, _t2, symmetric=False)(_prod_gamma)


@dist_dataclass
class InverseGamma(Distribution):
    """InverseGamma(shape a, scale b); E[x] = b / (a - 1).  The conjugate
    message to a Gaussian's variance is the improper a = -1/2 member
    (natural parameters (1/2, C/2)): only its product with a proper prior is
    turned back into moments."""

    a: torch.Tensor
    b: torch.Tensor

    def mean(self):
        return self.b / (self.a - 1.0)

    def var(self):
        a, b = self.a, self.b
        return b * b / ((a - 1.0) ** 2 * (a - 2.0))

    def mean_log(self):
        return torch.log(self.b) - torch.digamma(self.a)

    def mean_inverse(self):
        """E[1/x] = a / b."""
        return self.a / self.b

    def entropy(self):
        a, b = self.a, self.b
        return (a + torch.log(b) + torch.lgamma(a)
                - (1.0 + a) * torch.digamma(a))

    @classmethod
    def vague(cls, dtype=torch.float32):
        return cls(torch.tensor(2.0 + TINY, dtype=dtype),
                   torch.tensor(TINY, dtype=dtype))


@register_prod(InverseGamma, InverseGamma)
def _prod_invgamma(x: InverseGamma, y: InverseGamma) -> InverseGamma:
    return InverseGamma(x.a + y.a + 1.0, x.b + y.b)


@dist_dataclass
class Poisson(Distribution):
    """Poisson(rate lam)."""

    lam: torch.Tensor

    def mean(self):
        return self.lam

    def var(self):
        return self.lam

    def entropy(self):
        """The Stirling-series approximation the JAX package takes."""
        lam = self.lam
        return (0.5 * torch.log(2.0 * math.pi * math.e * lam)
                - 1.0 / (12.0 * lam) - 1.0 / (24.0 * lam * lam))

    @classmethod
    def vague(cls, dtype=torch.float32):
        return cls(torch.tensor(1.0, dtype=dtype))


@register_prod(Poisson, Poisson)
def _prod_poisson(x: Poisson, y: Poisson) -> Poisson:
    # natural-parameter addition (eta = log lam), the base measure absorbed
    # into the normalization, as in the JAX package
    return Poisson(x.lam * y.lam)


@dist_dataclass
class Binomial(Distribution):
    """Binomial(n, p); the trial count n is a float tensor, a parameter
    outside the natural ones."""

    n: torch.Tensor
    p: torch.Tensor

    def mean(self):
        return self.n * self.p

    def var(self):
        return self.n * self.p * (1.0 - self.p)

    @classmethod
    def vague(cls, n=1.0, dtype=torch.float32):
        return cls(torch.tensor(float(n), dtype=dtype),
                   torch.tensor(0.5, dtype=dtype))


@dist_dataclass
class Uniform(Distribution):
    """Uniform(lo, hi)."""

    lo: torch.Tensor
    hi: torch.Tensor

    def mean(self):
        return 0.5 * (self.lo + self.hi)

    def var(self):
        return (self.hi - self.lo) ** 2 / 12.0

    def entropy(self):
        return torch.log(self.hi - self.lo)

    @classmethod
    def vague(cls, dtype=torch.float32):
        return cls(torch.tensor(-HUGE, dtype=dtype),
                   torch.tensor(HUGE, dtype=dtype))
