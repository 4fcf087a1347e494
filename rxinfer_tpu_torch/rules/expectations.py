"""Sufficient-statistic expectations shared by the message rules
(counterpart of ``rxinfer_tpu/rules/expectations.py``).

``e_mean``, ``e_var``, ``e_cov``, ``e_sq``, ``e_outer`` and
``e_precision`` over the Gaussian families, the Gammas, ``Wishart`` (and
its inverse-scale carrier) and PointMass, and the log-expectations the
average energies read: ``e_log`` and ``e_mirrorlog`` (Beta, Gamma,
InverseGamma, DirichletCollection, PointMass), ``e_log_precision`` (Gamma,
PointMass), ``e_logdet`` (Wishart, InverseWishart, PointMass),
``e_inverse`` (E[X^-1]: InverseWishart, PointMass), ``e_inv_scalar``
(E[1/x]: InverseGamma, PointMass) and ``e_log_simplex`` (E[log p] of a
simplex: Dirichlet, DirichletCollection, PointMass).
"""

from __future__ import annotations

import torch

from ..dists import (
    Distribution,
    InverseWishart,
    PointMass,
    Wishart,
    pd_inverse,
    pd_logdet,
)


def e_mean(d: Distribution):
    return d.mean()


def e_var(d: Distribution):
    if isinstance(d, PointMass):
        return torch.zeros_like(d.point)
    return d.var()


def e_cov(d: Distribution):
    if isinstance(d, PointMass):
        p = d.point
        dd = p.shape[-1]
        return torch.zeros(p.shape[:-1] + (dd, dd), dtype=p.dtype,
                           device=p.device)
    return d.cov()


def e_sq(d: Distribution):
    """E[x^2] (scalar support)."""
    m = d.mean()
    return e_var(d) + m * m


def e_outer(d: Distribution):
    """E[x x^T] (vector support)."""
    m = d.mean()
    return e_cov(d) + m[..., None] * m[..., None, :]


def e_precision(d: Distribution):
    """E[W] for a precision-valued interface (Gamma, Wishart or
    PointMass)."""
    if isinstance(d, PointMass):
        return d.point
    if isinstance(d, Wishart):
        return d.nu[..., None, None] * d.s
    return d.mean()


def e_log(d: Distribution):
    """E[log x] (Gamma / Beta / DirichletCollection / PointMass support)."""
    if isinstance(d, PointMass):
        return torch.log(d.point)
    return d.mean_log()


def e_mirrorlog(d: Distribution):
    """E[log(1 - x)] (Beta / PointMass support)."""
    if isinstance(d, PointMass):
        return torch.log(1.0 - d.point)
    return d.mean_mirrorlog()


def e_logdet(d: Distribution):
    """E[log|X|] for a matrix-valued X (Wishart / PointMass)."""
    if isinstance(d, PointMass):
        return pd_logdet(d.point)
    if isinstance(d, (Wishart, InverseWishart)):
        return d.mean_logdet()
    raise TypeError(f"E[log|X|] undefined for {type(d).__name__}")


def e_inverse(d: Distribution):
    """E[X^-1] for a matrix-valued X (InverseWishart / PointMass)."""
    if isinstance(d, PointMass):
        return pd_inverse(d.point)
    if isinstance(d, InverseWishart):
        return d.mean_inverse()
    raise TypeError(f"E[X^-1] undefined for {type(d).__name__}")


def e_inv_scalar(d: Distribution):
    """E[1/x] for a scalar variance (InverseGamma / PointMass)."""
    if isinstance(d, PointMass):
        return 1.0 / d.point
    return d.mean_inverse()


def e_log_simplex(d: Distribution):
    """E[log p] for a simplex-valued p (Dirichlet, DirichletCollection or
    PointMass)."""
    if isinstance(d, PointMass):
        return torch.log(torch.clamp(d.point, min=1e-37))
    return d.mean_log()


def e_log_precision(d: Distribution):
    """E[log w] for a scalar precision (Gamma / PointMass)."""
    if isinstance(d, PointMass):
        return torch.log(d.point)
    return d.mean_log()
