"""Polya-Gamma augmented regression nodes: BinomialPolya, MultinomialPolya
(counterpart of ``rxinfer_tpu/rules/polya.py``).

A logistic likelihood becomes conditionally Gaussian in the coefficients
through the Polya-Gamma identity; the variational E-step uses the closed
form E[omega] = (n / 2c) tanh(c / 2) with c^2 = E[(x^T beta)^2], so the
message to beta is an exact Gaussian:

    W = E[omega] x x^T,   xi = (y - n/2) x.

``MultinomialPolya`` is the two-class variant of the JAX package (the first
count against the rest, through ``BinomialPolya``), not the general
stick-breaking construction.
"""

from __future__ import annotations

import torch

from ..dists import MvNormalWeightedMeanPrecision, PointMass
from .expectations import e_cov, e_mean
from .registry import node


def _e_omega(n, c):
    """E[omega] for omega ~ PG(n, c); the tanh form with its c -> 0 limit
    n / 4.  ``torch.where`` evaluates both branches, so the small ``c``
    are replaced by 1 before the division."""
    small = torch.abs(c) < 1e-4
    safe_c = torch.where(small, torch.ones_like(c), c)
    val = (n / (2.0 * safe_c)) * torch.tanh(safe_c / 2.0)
    return torch.where(small, n / 4.0, val)


def _point_or_mean(d):
    return d.point if isinstance(d, PointMass) else e_mean(d)


def _xbeta_moments(q):
    x = _point_or_mean(q["x"])
    mb = e_mean(q["beta"])
    vb = e_cov(q["beta"])
    mean = torch.sum(x * mb, dim=-1)
    var = torch.sum(x * torch.einsum("...ij,...j->...i", vb, x), dim=-1)
    return x, mean, var


@node("BinomialPolya")
class BinomialPolyaNode:
    """out ~ Binomial(n, logistic(x^T beta)); interfaces out, x, n, beta."""

    interfaces = ("out", "x", "n", "beta")
    needs_self_marginal = True   # reads q(beta) for the PG expectation

    @staticmethod
    def message_to_beta(q):
        y = e_mean(q["out"])
        n = _point_or_mean(q["n"])
        x, mean, var = _xbeta_moments(q)
        c = torch.sqrt(torch.clamp(mean * mean + var, min=1e-12))
        om = _e_omega(n, c)
        xi = (y - 0.5 * n)[..., None] * x
        w = om[..., None, None] * x[..., :, None] * x[..., None, :]
        return MvNormalWeightedMeanPrecision(xi, w)

    @staticmethod
    def average_energy(q):
        """E[-log p(y | x, beta)] under the Polya-Gamma variational bound."""
        y = e_mean(q["out"])
        n = _point_or_mean(q["n"])
        _, mean, var = _xbeta_moments(q)
        c = torch.sqrt(torch.clamp(mean * mean + var, min=1e-12))
        om = _e_omega(n, c)
        log_binom = (torch.lgamma(n + 1.0) - torch.lgamma(y + 1.0)
                     - torch.lgamma(n - y + 1.0))
        bound = (log_binom
                 + (y - 0.5 * n) * mean
                 - 0.5 * om * (mean * mean + var)
                 + 0.5 * om * c * c
                 - n * torch.log1p(torch.exp(c))
                 + 0.5 * n * c)
        return -bound


@node("MultinomialPolya")
class MultinomialPolyaNode:
    """out ~ Multinomial(n, ...) at K = 2: the first count's binomial
    regression (``BinomialPolya``).  Interfaces out (K counts), x, n,
    beta."""

    interfaces = ("out", "x", "n", "beta")
    needs_self_marginal = True

    @staticmethod
    def message_to_beta(q):
        y = e_mean(q["out"])
        q2 = dict(q)
        q2["out"] = PointMass(y[..., 0])
        q2["n"] = PointMass(torch.as_tensor(_point_or_mean(q["n"])))
        return BinomialPolyaNode.message_to_beta(q2)

    @staticmethod
    def average_energy(q):
        y = e_mean(q["out"])
        q2 = dict(q)
        q2["out"] = PointMass(y[..., 0])
        return BinomialPolyaNode.average_energy(q2)
