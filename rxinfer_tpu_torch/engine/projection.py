"""Exact M-projection of weighted sample clouds onto an exponential family
(counterpart of ``rxinfer_tpu/engine/projection.py``).

Matching the weighted means of the sufficient statistics E[T(x)] is the
maximum-likelihood fit of the family, inverted per family: in closed form
for the Gaussians, by Newton steps on the digamma systems for Beta, Gamma
and Dirichlet.  ``rules/delta.py`` uses it for ``CVIProjection(out_family=
...)``.  Every function runs over leading axes: a scalar family's samples
are (..., S), a vector family's (..., S, d), the weights (S,) or (..., S).

Ported subset: ``fit_weighted_samples`` and what it needs (``_nat_to_dist``,
``_dist_to_nat``, ``_project_domain``, ``_inv_digamma``, ``_stats_matrix``)
for the families the port has distributions of.  ``ProjectedTo`` (the form
constraint and its natural-gradient projection of message products) waits
for the port of constraints (ROADMAP A6c); the ``poisson`` and ``binomial``
families wait for those distributions.
"""

from __future__ import annotations

import torch

from ..dists import (
    BernoulliLogits,
    Beta,
    Dirichlet,
    GammaShapeRate,
    MvNormalWeightedMeanPrecision,
    NormalMeanVariance,
    pd_inverse,
)
from ..dists.natural import from_natural, to_natural

# sufficient statistics in the natural-parameter layouts of dists/natural.py
_SUFF = {
    "gaussian": lambda x: (x, -0.5 * x * x),
    "mv_gaussian": lambda x: (x, -0.5 * x[..., :, None] * x[..., None, :]),
    "beta": lambda x: (torch.log(x), torch.log1p(-x)),
    "gamma": lambda x: (torch.log(x), -x),
    "dirichlet": lambda x: (torch.log(x),),
    "bernoulli": lambda x: (x,),
}

SUPPORTED = tuple(sorted(_SUFF))


def _nat_to_dist(family: str, nat: tuple):
    return from_natural(family, nat)


def _dist_to_nat(family: str, dist):
    return to_natural(dist)


def _project_domain(family: str, nat: tuple) -> tuple:
    """Clamp natural parameters back into the family's open domain."""
    if family == "gaussian":
        return (nat[0], torch.clamp(nat[1], min=1e-8))
    if family == "mv_gaussian":
        w = 0.5 * (nat[1] + nat[1].transpose(-1, -2))
        evals, evecs = torch.linalg.eigh(w)
        evals = torch.clamp(evals, min=1e-6)
        w = torch.einsum("...ij,...j,...kj->...ik", evecs, evals, evecs)
        return (nat[0], w)
    if family == "beta":
        return (torch.clamp(nat[0], min=-0.999),
                torch.clamp(nat[1], min=-0.999))
    if family == "gamma":
        return (torch.clamp(nat[0], min=-0.999), torch.clamp(nat[1], min=1e-6))
    if family == "dirichlet":
        return (torch.clamp(nat[0], min=-0.999),)
    if family == "bernoulli":
        return (torch.clamp(nat[0], -15.0, 15.0),)
    raise ValueError(f"unsupported projection family {family!r}")


def _stats_matrix(family: str, z):
    """T(z) flattened over the statistics: (..., S, P) for samples
    (..., S[, d])."""
    event = 1 if family in ("mv_gaussian", "dirichlet") else 0
    lead = z.shape[:z.ndim - event]
    return torch.cat([tk.reshape(lead + (-1,)) for tk in _SUFF[family](z)],
                     dim=-1)


def _inv_digamma(y, iters: int = 5):
    """Newton inverse of digamma (Minka 2000, appendix C initialization)."""
    dg1 = torch.special.digamma(torch.ones((), dtype=y.dtype, device=y.device))
    x = torch.where(y >= -2.22, torch.exp(y) + 0.5, -1.0 / (y - dg1))
    for _ in range(iters):
        x = x - (torch.special.digamma(x) - y) / torch.clamp(
            torch.polygamma(1, x), min=1e-10)
        x = torch.clamp(x, min=1e-8)
    return x


def fit_weighted_samples(family: str, samples, weights):
    """Fit the exponential family to a weighted sample cloud by matching the
    weighted sufficient-statistic means (the exact M-projection); the sample
    axis is -1 for a scalar family, -2 for a vector one."""
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True),
                              min=1e-30)
    dg, tg = torch.special.digamma, lambda x: torch.polygamma(1, x)
    if family == "gaussian":
        m = torch.sum(w * samples, dim=-1)
        v = torch.clamp(torch.sum(w * (samples - m[..., None]) ** 2, dim=-1),
                        min=1e-10)
        return NormalMeanVariance(m, v)
    if family == "mv_gaussian":
        m = torch.einsum("...s,...si->...i", w, samples)
        c = samples - m[..., None, :]
        v = torch.einsum("...s,...si,...sj->...ij", w, c, c)
        v = v + 1e-8 * torch.eye(v.shape[-1], dtype=v.dtype, device=v.device)
        prec = pd_inverse(v)
        return MvNormalWeightedMeanPrecision(
            torch.einsum("...ij,...j->...i", prec, m), prec)
    if family == "beta":
        s = torch.clamp(samples, 1e-6, 1.0 - 1e-6)
        e_lx = torch.sum(w * torch.log(s), dim=-1)
        e_l1x = torch.sum(w * torch.log1p(-s), dim=-1)
        # method of moments, refined by Newton on the digamma system
        m = torch.sum(w * s, dim=-1)
        v = torch.clamp(torch.sum(w * (s - m[..., None]) ** 2, dim=-1),
                        min=1e-10)
        common = torch.clamp(m * (1 - m) / v - 1.0, min=1e-2)
        a = torch.clamp(m * common, min=1e-2)
        b = torch.clamp((1 - m) * common, min=1e-2)
        for _ in range(10):
            ga = dg(a) - dg(a + b) - e_lx
            gb = dg(b) - dg(a + b) - e_l1x
            tab = tg(a + b)
            j11 = tg(a) - tab
            j22 = tg(b) - tab
            det = torch.clamp(j11 * j22 - tab * tab, min=1e-12)
            da = (j22 * ga + tab * gb) / det
            db = (tab * ga + j11 * gb) / det
            a = torch.clamp(a - da, min=1e-3)
            b = torch.clamp(b - db, min=1e-3)
        return Beta(a, b)
    if family == "gamma":
        s = torch.clamp(samples, min=1e-10)
        e_x = torch.sum(w * s, dim=-1)
        e_lx = torch.sum(w * torch.log(s), dim=-1)
        # log(a) - digamma(a) = log E[x] - E[log x] by Newton, then b = a/E[x]
        gap = torch.clamp(torch.log(e_x) - e_lx, min=1e-8)
        a = 0.5 / gap
        for _ in range(8):
            g = torch.log(a) - dg(a) - gap
            dgr = 1.0 / a - tg(a)
            a = torch.clamp(a - g / torch.where(torch.abs(dgr) > 1e-12, dgr,
                                                torch.full_like(dgr, 1e-12)),
                            min=1e-3)
        return GammaShapeRate(a, a / torch.clamp(e_x, min=1e-10))
    if family == "bernoulli":
        m = torch.clamp(torch.sum(w * samples, dim=-1), 1e-6, 1.0 - 1e-6)
        return BernoulliLogits(torch.log(m) - torch.log1p(-m))
    if family == "dirichlet":
        s = torch.clamp(samples, min=1e-6)
        s = s / torch.sum(s, dim=-1, keepdim=True)
        e_lx = torch.einsum("...s,...sk->...k", w, torch.log(s))
        alpha = torch.ones_like(e_lx)
        for _ in range(8):
            # Minka's fixed point: digamma(a_k) = digamma(sum a) + E[log x_k]
            alpha = _inv_digamma(dg(torch.sum(alpha, dim=-1, keepdim=True))
                                 + e_lx)
        for _ in range(8):
            # Newton with the diagonal-plus-rank-one Hessian inverted by
            # Sherman-Morrison (Minka 2000, eq. 10-15)
            a0 = torch.sum(alpha, dim=-1, keepdim=True)
            g = dg(a0) - dg(alpha) + e_lx
            qd = -tg(alpha)
            z = tg(a0)
            b = torch.sum(g / qd, dim=-1, keepdim=True) / (
                1.0 / z + torch.sum(1.0 / qd, dim=-1, keepdim=True))
            alpha = torch.clamp(alpha - (g - b) / qd, min=1e-3)
        return Dirichlet(alpha)
    raise ValueError(f"unsupported sample-fit family {family!r}")
