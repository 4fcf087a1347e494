"""Discrete / simplex families (counterpart of ``rxinfer_tpu/dists/discrete.py``).

``Categorical`` (stored as logits; ``from_probs``, ``probs``,
``log_probs``, ``mean``, ``var``, ``entropy``), ``Dirichlet`` (``mean``,
``var``, ``mean_log``, ``entropy``, ``vague``) and ``DirichletCollection``
(``mean``, ``mean_log``, ``var`` and ``entropy``, summed over the columns)
with their closed-form products — what the HMM's discrete chain and its
Dirichlet transition/emission groups need, and the mixture weights of a
Gaussian mixture — and ``Multinomial`` (a trial count and logits; counts
data, its latent the Dirichlet of ``p``).  Draws and log-densities live in
``sampling.py``.

Batch axes.  Every tensor may carry leading batch dimensions.  A
``DirichletCollection`` is a collection of independent Dirichlets over the
columns of a (K_out, K_in) matrix: its event is the trailing two axes and the
simplex runs over K_out, axis -2.  (The JAX class reduces over axis 0, which
is the outcome axis only because it runs under ``vmap`` without a batch axis;
reducing over axis 0 here would normalise across the batch.)
"""

from __future__ import annotations

import torch

from .base import Distribution, dist_dataclass, register_prod


@dist_dataclass
class Categorical(Distribution):
    """Categorical over K classes, stored as logits (..., K)."""

    logits: torch.Tensor

    @property
    def event_ndim(self) -> int:
        return 1

    @classmethod
    def from_probs(cls, p):
        return cls(torch.log(torch.clamp(p, min=1e-37)))

    def probs(self):
        return torch.softmax(self.logits, dim=-1)

    def log_probs(self):
        return torch.log_softmax(self.logits, dim=-1)

    def mean(self):
        return self.probs()

    def var(self):
        p = self.probs()
        return p * (1.0 - p)

    def entropy(self):
        lp = self.log_probs()
        return -torch.sum(torch.exp(lp) * lp, dim=-1)


@register_prod(Categorical, Categorical)
def _prod_categorical(x: Categorical, y: Categorical) -> Categorical:
    return Categorical(x.logits + y.logits)


@dist_dataclass
class Dirichlet(Distribution):
    """Dirichlet(alpha) over the (K-1)-simplex; alpha (..., K)."""

    alpha: torch.Tensor

    @property
    def event_ndim(self) -> int:
        return 1

    def mean(self):
        return self.alpha / torch.sum(self.alpha, dim=-1, keepdim=True)

    def var(self):
        a0 = torch.sum(self.alpha, dim=-1, keepdim=True)
        m = self.alpha / a0
        return m * (1.0 - m) / (a0 + 1.0)

    def mean_log(self):
        """E[log p_k] = digamma(alpha_k) - digamma(alpha_0)."""
        return torch.digamma(self.alpha) - torch.digamma(
            torch.sum(self.alpha, dim=-1, keepdim=True))

    def entropy(self):
        a = self.alpha
        a0 = torch.sum(a, dim=-1)
        k = a.shape[-1]
        lb = torch.sum(torch.lgamma(a), dim=-1) - torch.lgamma(a0)
        return (lb + (a0 - k) * torch.digamma(a0)
                - torch.sum((a - 1.0) * torch.digamma(a), dim=-1))

    @classmethod
    def vague(cls, k: int, dtype=torch.float32):
        return cls(torch.ones((k,), dtype=dtype))


@register_prod(Dirichlet, Dirichlet)
def _prod_dirichlet(x: Dirichlet, y: Dirichlet) -> Dirichlet:
    return Dirichlet(x.alpha + y.alpha - 1.0)


@dist_dataclass
class DirichletCollection(Distribution):
    """Independent Dirichlets over the columns of a (K_out, K_in) matrix:
    each alpha[..., :, j] is a Dirichlet over K_out outcomes, so the columns
    of the mean sum to one (the HMM transition/emission prior)."""

    alpha: torch.Tensor  # (..., K_out, K_in) — simplex over axis -2

    @property
    def event_ndim(self) -> int:
        return 2

    def mean(self):
        a0 = torch.sum(self.alpha, dim=-2, keepdim=True)
        return self.alpha / a0

    def mean_log(self):
        return torch.digamma(self.alpha) - torch.digamma(
            torch.sum(self.alpha, dim=-2, keepdim=True))

    def var(self):
        a = self.alpha
        a0 = torch.sum(a, dim=-2, keepdim=True)
        m = a / a0
        return m * (1.0 - m) / (a0 + 1.0)

    def entropy(self):
        """Sum of the columns' Dirichlet entropies: shape (...,)."""
        a = self.alpha
        a0 = torch.sum(a, dim=-2)
        k = a.shape[-2]
        lb = torch.sum(torch.lgamma(a), dim=-2) - torch.lgamma(a0)
        per_col = (lb + (a0 - k) * torch.digamma(a0)
                   - torch.sum((a - 1.0) * torch.digamma(a), dim=-2))
        return torch.sum(per_col, dim=-1)


@register_prod(DirichletCollection, DirichletCollection)
def _prod_dirichlet_collection(x: DirichletCollection, y: DirichletCollection):
    return DirichletCollection(x.alpha + y.alpha - 1.0)


@dist_dataclass
class Multinomial(Distribution):
    """Multinomial(n, p), p stored as logits (..., K); n (...,)."""

    n: torch.Tensor
    logits: torch.Tensor

    @property
    def event_ndim(self) -> int:
        return 1

    def probs(self):
        return torch.softmax(self.logits, dim=-1)

    def mean(self):
        return self.n[..., None] * self.probs()

    def var(self):
        p = self.probs()
        return self.n[..., None] * p * (1.0 - p)

    @classmethod
    def vague(cls, k: int, n=1.0, dtype=torch.float32):
        return cls(torch.tensor(float(n), dtype=dtype),
                   torch.zeros((k,), dtype=dtype))
