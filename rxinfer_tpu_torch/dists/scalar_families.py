"""Scalar exponential families beyond the Gaussian (counterpart of
``rxinfer_tpu/dists/scalar_families.py``).

Ported subset: ``Beta``, ``Bernoulli`` and its natural-parameter carrier
``BernoulliLogits`` (the Beta-Bernoulli conjugate pair), and
``AbstractGamma`` and ``GammaShapeRate``, the conjugate carrier of a scalar
precision (an unknown observation or process-noise precision); each with
its mean, log-expectations, entropy and closed-form product.
``GammaShapeScale``, ``InverseGamma``, ``Poisson`` and the rest arrive with
the slices whose paths need them.  Every tensor may carry leading batch
dimensions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import TINY, Distribution, dist_dataclass, register_prod


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

    def mean_log(self):
        return torch.digamma(self.a) - torch.digamma(self.a + self.b)

    def mean_mirrorlog(self):
        """E[log(1 - x)]."""
        return torch.digamma(self.b) - torch.digamma(self.a + self.b)

    def entropy(self):
        a, b = self.a, self.b
        return (betaln(a, b) - (a - 1.0) * torch.digamma(a)
                - (b - 1.0) * torch.digamma(b)
                + (a + b - 2.0) * torch.digamma(a + b))


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


def _prod_gamma(x, y):
    ax, bx = x.shape_rate()
    ay, by = y.shape_rate()
    return GammaShapeRate(ax + ay - 1.0, bx + by)


register_prod(GammaShapeRate, GammaShapeRate)(_prod_gamma)
