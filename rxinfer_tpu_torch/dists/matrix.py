"""Matrix-variate families (counterpart of ``rxinfer_tpu/dists/matrix.py``).

Ported subset: ``Wishart`` with its closed-form product and the
inverse-scale carrier ``WishartInverseScale`` (the conjugate message to a
precision matrix), and the multivariate log-gamma / digamma they use.
``InverseWishart`` arrives with the slice whose path needs it.  Every tensor
may carry leading batch dimensions: ``nu`` (...,), the scale (..., d, d).
"""

from __future__ import annotations

import torch

from .base import TINY, Distribution, dist_dataclass, register_prod
from .gaussian import pd_inverse, pd_logdet

_LOG2 = 0.6931471805599453
_LOGPI = 1.1447298858494002


def _half_steps(d: int, a: torch.Tensor) -> torch.Tensor:
    """a[..., None] + (1 - j) / 2 for j = 1..d."""
    j = torch.arange(1, d + 1, dtype=a.dtype, device=a.device)
    return a[..., None] + 0.5 * (1.0 - j)


def _mv_gammaln(d: int, a: torch.Tensor) -> torch.Tensor:
    """Multivariate log-gamma log Gamma_d(a)."""
    return 0.25 * d * (d - 1) * _LOGPI + torch.sum(
        torch.lgamma(_half_steps(d, a)), dim=-1)


def _mv_digamma(d: int, a: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.digamma(_half_steps(d, a)), dim=-1)


@dist_dataclass
class Wishart(Distribution):
    """Wishart(nu, S) with scale matrix S; E[X] = nu S."""

    nu: torch.Tensor
    s: torch.Tensor  # (..., d, d)

    @property
    def event_ndim(self) -> int:
        return 2

    @property
    def dim(self) -> int:
        return self.s.shape[-1]

    def mean(self):
        return self.nu[..., None, None] * self.s

    def mean_logdet(self):
        """E[log|X|] = psi_d(nu / 2) + d log 2 + log|S|."""
        d = self.dim
        return _mv_digamma(d, 0.5 * self.nu) + d * _LOG2 + pd_logdet(self.s)

    def entropy(self):
        d = self.dim
        nu = self.nu
        return (0.5 * (d + 1.0) * pd_logdet(self.s)
                + 0.5 * d * (d + 1.0) * _LOG2
                + _mv_gammaln(d, 0.5 * nu)
                - 0.5 * (nu - d - 1.0) * _mv_digamma(d, 0.5 * nu)
                + 0.5 * nu * d)

    @classmethod
    def vague(cls, dim: int, dtype=torch.float32):
        return cls(torch.tensor(float(dim), dtype=dtype),
                   (1.0 / TINY / dim) * torch.eye(dim, dtype=dtype))


@register_prod(Wishart, Wishart)
def _prod_wishart(x: Wishart, y: Wishart) -> Wishart:
    d = x.dim
    v_inv = pd_inverse(x.s) + pd_inverse(y.s)
    return Wishart(x.nu + y.nu - d - 1.0, pd_inverse(v_inv))


@dist_dataclass
class WishartInverseScale(Distribution):
    """Wishart message carrier parameterized by the inverse scale (natural
    form): density proportional to |X|^{(nu-d-1)/2} exp(-tr(s_inv X) / 2).
    One observation's scatter is singular, so the messages of a plate sum in
    this form without an inversion; only the aggregated posterior becomes a
    proper ``Wishart`` (``to_wishart``)."""

    nu: torch.Tensor
    s_inv: torch.Tensor

    @property
    def event_ndim(self) -> int:
        return 2

    @property
    def dim(self) -> int:
        return self.s_inv.shape[-1]

    def mean(self):
        return self.nu[..., None, None] * pd_inverse(self.s_inv)

    def to_wishart(self) -> Wishart:
        return Wishart(self.nu, pd_inverse(self.s_inv))
