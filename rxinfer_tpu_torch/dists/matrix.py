"""Matrix-variate families (counterpart of ``rxinfer_tpu/dists/matrix.py``).

``Wishart`` with its closed-form product, the inverse-scale carrier
``WishartInverseScale`` (the conjugate message to a precision matrix),
``InverseWishart`` (the conjugate carrier of a covariance matrix, with its
expected inverse and log-determinant) and the multivariate log-gamma /
digamma they use.  Every tensor may carry leading batch dimensions: ``nu``
(...,), the scale (..., d, d).
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


@dist_dataclass
class InverseWishart(Distribution):
    """InverseWishart(nu, Psi); E[X] = Psi / (nu - d - 1).  The conjugate
    message to a Gaussian's covariance is the improper nu = -d member
    (natural parameters (1, C)): its product with a proper prior adds one
    pseudo-observation, IW(nu0 + 1, Psi0 + C)."""

    nu: torch.Tensor
    psi: torch.Tensor  # (..., d, d)

    @property
    def event_ndim(self) -> int:
        return 2

    @property
    def dim(self) -> int:
        return self.psi.shape[-1]

    def mean(self):
        return self.psi / (self.nu - self.dim - 1.0)[..., None, None]

    def mean_inverse(self):
        """E[X^-1] = nu Psi^-1."""
        return self.nu[..., None, None] * pd_inverse(self.psi)

    def mean_logdet(self):
        """E[log|X|] = log|Psi| - d log 2 - psi_d(nu / 2)."""
        d = self.dim
        return (pd_logdet(self.psi) - d * _LOG2
                - _mv_digamma(d, 0.5 * self.nu))

    def entropy(self):
        """-E[log p(X)] = (d + 1)/2 log|Psi| - d (d + 1)/2 log 2 +
        log Gamma_d(nu/2) - (nu + d + 1)/2 psi_d(nu/2) + nu d / 2.  The
        JAX package adds the log 2 term where it subtracts it (ROADMAP
        C13)."""
        d = self.dim
        nu = self.nu
        return (0.5 * (d + 1.0) * pd_logdet(self.psi)
                - 0.5 * d * (d + 1.0) * _LOG2
                + _mv_gammaln(d, 0.5 * nu)
                - 0.5 * (nu + d + 1.0) * _mv_digamma(d, 0.5 * nu)
                + 0.5 * nu * d)

    @classmethod
    def vague(cls, dim: int, dtype=torch.float32):
        return cls(torch.tensor(dim + 2.0 + TINY, dtype=dtype),
                   TINY * torch.eye(dim, dtype=dtype))


@register_prod(InverseWishart, InverseWishart)
def _prod_inverse_wishart(x: InverseWishart, y: InverseWishart):
    return InverseWishart(x.nu + y.nu + x.dim + 1.0, x.psi + y.psi)
