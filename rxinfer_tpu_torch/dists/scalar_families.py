"""Scalar exponential families beyond the Gaussian (counterpart of
``rxinfer_tpu/dists/scalar_families.py``).

Ported subset: ``AbstractGamma`` and ``GammaShapeRate`` with their
closed-form product, the conjugate carrier of a scalar precision (an
unknown observation or process-noise precision).  ``GammaShapeScale``,
``InverseGamma``, ``Beta``, ``Bernoulli``, ``Poisson`` and the rest arrive
with the slices whose paths need them.  Every tensor may carry leading
batch dimensions.
"""

from __future__ import annotations

import torch

from .base import TINY, Distribution, dist_dataclass, register_prod


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
