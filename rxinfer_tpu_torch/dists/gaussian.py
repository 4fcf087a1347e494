"""Gaussian families, scalar and multivariate (counterpart of
``rxinfer_tpu/dists/gaussian.py``).

The scalar and multivariate mean-variance / mean-precision /
weighted-mean-precision parametrizations with their entropies (whose
log-determinants are one batched ``torch.linalg.slogdet``), the
scale-precision family ``MvNormalMeanScalePrecision`` (N(mu, (gamma I)^-1)),
``pd_inverse``/``pd_logdet`` and the natural-form conversions.  Not ported:
``JointGaussian``.  Draws and log-densities live in ``sampling.py``.

The compute form of message products is the information form: the product is
``(xi1 + xi2, W1 + W2)``.  Every tensor may carry leading batch dimensions.
"""

from __future__ import annotations

import torch

from .base import TINY, HUGE, Distribution, dist_dataclass, register_prod

_LOG2PI = 1.8378770664093453  # log(2*pi)


def _symmetrize(m):
    return 0.5 * (m + m.transpose(-1, -2))


def pd_inverse(m):
    """Positive-definite inverse, symmetrized.  d <= 16 uses the closed-form
    cofactor/Schur inverses of ``ops/smallmat.py`` (same numbers as the JAX
    package); larger d goes through Cholesky."""
    if m.shape[-1] <= 16:
        from ..ops.smallmat import small_inv

        return _symmetrize(small_inv(m))
    c = torch.linalg.cholesky(_symmetrize(m))
    return _symmetrize(torch.cholesky_inverse(c))


def pd_logdet(m):
    if m.shape[-1] <= 16:
        from ..ops.smallmat import small_logdet

        return small_logdet(m)
    c = torch.linalg.cholesky(_symmetrize(m))
    return 2.0 * torch.sum(torch.log(torch.diagonal(c, dim1=-2, dim2=-1)), dim=-1)


def batched_logdet(m):
    """log|det m| of a batch of positive-definite matrices in one batched
    pivoted-LU call (``torch.linalg.slogdet``).  The entropies read it: over
    millions of small matrices (a chain's marginals) it is one library
    call, where ``small_logdet``'s Schur recursion takes many tiny cuBLAS
    products."""
    return torch.linalg.slogdet(m)[1]


# -- scalar Gaussians ---------------------------------------------------------

class AbstractNormal(Distribution):
    def entropy(self):
        return 0.5 * (_LOG2PI + 1.0) + 0.5 * torch.log(self.var())

    def precision(self):
        return 1.0 / self.var()

    def weightedmean(self):
        return self.mean() / self.var()


@dist_dataclass
class NormalMeanVariance(AbstractNormal):
    mu: torch.Tensor
    v: torch.Tensor

    def mean(self):
        return self.mu

    def var(self):
        return self.v


@dist_dataclass
class NormalMeanPrecision(AbstractNormal):
    mu: torch.Tensor
    w: torch.Tensor

    def mean(self):
        return self.mu

    def var(self):
        return 1.0 / self.w

    def precision(self):
        return self.w

    def weightedmean(self):
        return self.mu * self.w


@dist_dataclass
class NormalWeightedMeanPrecision(AbstractNormal):
    """Information form: xi = w * mu."""

    xi: torch.Tensor
    w: torch.Tensor

    def mean(self):
        # the zero natural vector is the multiplicative identity: its mean is
        # 0 by convention, not 0/0
        w_safe = torch.where(self.w == 0.0, torch.full_like(self.w, TINY), self.w)
        return self.xi / w_safe

    def var(self):
        return 1.0 / self.w

    def precision(self):
        return self.w

    def weightedmean(self):
        return self.xi


ScalarGaussians = (NormalMeanVariance, NormalMeanPrecision,
                   NormalWeightedMeanPrecision)


def as_weighted_mean_precision(d) -> NormalWeightedMeanPrecision:
    if isinstance(d, NormalWeightedMeanPrecision):
        return d
    return NormalWeightedMeanPrecision(d.weightedmean(), d.precision())


def _scalar_gaussian_prod(a, b):
    fa, fb = as_weighted_mean_precision(a), as_weighted_mean_precision(b)
    return NormalWeightedMeanPrecision(fa.xi + fb.xi, fa.w + fb.w)


for _t1 in ScalarGaussians:
    for _t2 in ScalarGaussians:
        register_prod(_t1, _t2, symmetric=False)(_scalar_gaussian_prod)


# -- multivariate Gaussians ---------------------------------------------------

class AbstractMvNormal(Distribution):
    @property
    def event_ndim(self) -> int:
        return 1

    def precision(self):
        return pd_inverse(self.cov())

    def weightedmean(self):
        # xi = Sigma^{-1} mu as a closed-form solve (d <= 16)
        from ..ops.smallmat import small_solve

        return small_solve(_symmetrize(self.cov()), self.mean(), matrix=False)

    def var(self):
        return torch.diagonal(self.cov(), dim1=-2, dim2=-1)

    def entropy(self):
        cov = self.cov()
        d = cov.shape[-1]
        return 0.5 * d * (_LOG2PI + 1.0) + 0.5 * batched_logdet(cov)


@dist_dataclass
class MvNormalMeanCovariance(AbstractMvNormal):
    mu: torch.Tensor
    sigma: torch.Tensor

    def mean(self):
        return self.mu

    def cov(self):
        return self.sigma


@dist_dataclass
class MvNormalMeanPrecision(AbstractMvNormal):
    mu: torch.Tensor
    w: torch.Tensor

    def mean(self):
        return self.mu

    def cov(self):
        return pd_inverse(self.w)

    def entropy(self):
        d = self.w.shape[-1]
        return 0.5 * d * (_LOG2PI + 1.0) - 0.5 * batched_logdet(self.w)

    def precision(self):
        return self.w

    def weightedmean(self):
        return torch.einsum("...ij,...j->...i", self.w, self.mu)


@dist_dataclass
class MvNormalWeightedMeanPrecision(AbstractMvNormal):
    """Information form: xi = W mu, the message-product compute form."""

    xi: torch.Tensor
    w: torch.Tensor

    def mean(self):
        # exactly-zero precision (the identity carrier) has mean 0 by
        # convention; an unguarded solve would return NaN
        from ..ops.smallmat import small_solve

        d = self.w.shape[-1]
        allzero = torch.all(
            torch.all(self.w == 0.0, dim=-1), dim=-1)[..., None, None]
        eye = torch.eye(d, dtype=self.w.dtype, device=self.w.device) / HUGE
        w_safe = torch.where(allzero, eye, self.w)
        return small_solve(w_safe, self.xi, matrix=False)

    def cov(self):
        return pd_inverse(self.w)

    def entropy(self):
        d = self.w.shape[-1]
        return 0.5 * d * (_LOG2PI + 1.0) - 0.5 * batched_logdet(self.w)

    def precision(self):
        return self.w

    def weightedmean(self):
        return self.xi


@dist_dataclass
class MvNormalMeanScalePrecision(AbstractMvNormal):
    """N(mu, (gamma I)^-1): mu (..., d), the scalar precision gamma (...,)."""

    mu: torch.Tensor
    gamma: torch.Tensor

    def _eye(self):
        d = self.mu.shape[-1]
        return torch.eye(d, dtype=self.mu.dtype, device=self.mu.device)

    def mean(self):
        return self.mu

    def cov(self):
        return self._eye() / self.gamma[..., None, None]

    def var(self):
        return torch.broadcast_tensors((1.0 / self.gamma)[..., None],
                                       self.mu)[0]

    def precision(self):
        return self._eye() * self.gamma[..., None, None]

    def weightedmean(self):
        return self.mu * self.gamma[..., None]

    def entropy(self):
        d = self.mu.shape[-1]
        return 0.5 * d * (_LOG2PI + 1.0) - 0.5 * d * torch.log(self.gamma)


MvGaussians = (MvNormalMeanCovariance, MvNormalMeanPrecision,
               MvNormalWeightedMeanPrecision, MvNormalMeanScalePrecision)


def as_mv_weighted_mean_precision(d) -> MvNormalWeightedMeanPrecision:
    if isinstance(d, MvNormalWeightedMeanPrecision):
        return d
    return MvNormalWeightedMeanPrecision(d.weightedmean(), d.precision())


def _mv_gaussian_prod(a, b):
    fa, fb = as_mv_weighted_mean_precision(a), as_mv_weighted_mean_precision(b)
    return MvNormalWeightedMeanPrecision(fa.xi + fb.xi, fa.w + fb.w)


for _t1 in MvGaussians:
    for _t2 in MvGaussians:
        register_prod(_t1, _t2, symmetric=False)(_mv_gaussian_prod)
