"""Sufficient-statistic expectations shared by the message rules
(counterpart of ``rxinfer_tpu/rules/expectations.py``).

Ported subset: ``e_mean``, ``e_var``, ``e_cov``, ``e_sq`` and
``e_precision`` over the Gaussian families, ``GammaShapeRate``, ``Wishart``
(and its inverse-scale carrier) and PointMass.  The log-expectations
(``e_log``, ``e_logdet``) arrive with free energy.
"""

from __future__ import annotations

import torch

from ..dists import Distribution, PointMass, Wishart


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


def e_precision(d: Distribution):
    """E[W] for a precision-valued interface (Gamma, Wishart or
    PointMass)."""
    if isinstance(d, PointMass):
        return d.point
    if isinstance(d, Wishart):
        return d.nu[..., None, None] * d.s
    return d.mean()
