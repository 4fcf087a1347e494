"""Autoregressive (AR) node (counterpart of ``rxinfer_tpu/rules/ar.py``):
an order-k latent AR process in its state-space embedding.  The state s_t
stacks the last k values; the transition is the companion map with a random
coefficient vector theta and innovation precision gamma,

    s_t = C(theta) s_{t-1} + e_1 w_t,   w_t ~ N(0, 1/gamma).

The chain itself is solved exactly given E[theta], E[gamma]
(``engine/blocks.py`` ``ARChainBlock``); the rules here are the conjugate
messages from the transition factors to theta (Gaussian) and gamma (Gamma)
from the smoothed pair cross-covariances ``q["joint"]`` (structured VMP),
and the average energy.

Batch-major: theta and gamma, shared by a chain's transitions, arrive with a
unit plate axis (``engine/blocks.py`` ``build_q``), so a scalar expectation
of gamma broadcasts over a vector statistic through a trailing axis.
"""

from __future__ import annotations

import torch

from ..dists import (
    GammaShapeRate,
    MvNormalMeanCovariance,
    MvNormalWeightedMeanPrecision,
    NormalWeightedMeanPrecision,
)
from ..dists.gaussian import ScalarGaussians
from .expectations import (
    e_cov,
    e_log_precision,
    e_mean,
    e_outer,
    e_precision,
)
from .registry import node

_LOG2PI = 1.8378770664093453


def _is_scalar_ar(q) -> bool:
    """The univariate regime: order 1 with scalar latents and a scalar
    Normal theta (the reference's ``ARMeta(Univariate, ...)``).  The chain
    then carries scalar marginals; the statistics promote them to the 1-d
    embedding and the messages squeeze back."""
    return isinstance(q["out"], ScalarGaussians)


def _promote(q):
    out = dict(q)
    # a scalar chain's cross Cov(out, in) has no event axes
    if out.get("joint") is not None and isinstance(q["in"], ScalarGaussians):
        out["joint"] = out["joint"][..., None, None]
    for key in ("out", "in", "theta"):
        d = out.get(key)
        if isinstance(d, ScalarGaussians):
            out[key] = MvNormalMeanCovariance(d.mean()[..., None],
                                              d.var()[..., None, None])
    return out


def _theta_outer(q):
    th = q["theta"]
    m = e_mean(th)
    return e_cov(th) + m[..., None] * m[..., None, :], m


def _ar_stats(q):
    """Per-transition sufficient statistics: E[out], E[in], E[in in^T],
    E[out_0 in] and E[out_0^2]."""
    m_out = e_mean(q["out"])
    m_in = e_mean(q["in"])
    s_in = e_outer(q["in"])
    joint = q.get("joint")            # Cov(out, in), or None
    # E[out_0 in] = Cov(out_0, in) + E[out_0] E[in]
    if joint is not None:
        e_x0s = joint[..., 0, :] + m_out[..., 0:1] * m_in
    else:
        e_x0s = m_out[..., 0:1] * m_in
    v_out0 = e_cov(q["out"])[..., 0, 0]
    e_x0sq = v_out0 + m_out[..., 0] ** 2
    return m_out, m_in, s_in, e_x0s, e_x0sq


def _c2(q):
    """E[(out_0 - theta^T in)^2] per transition."""
    tt, mth = _theta_outer(q)
    _, _, s_in, e_x0s, e_x0sq = _ar_stats(q)
    return (e_x0sq - 2.0 * torch.einsum("...i,...i->...", mth, e_x0s)
            + torch.einsum("...ij,...ji->...", tt, s_in))


@node("AR")
class ARNode:
    interfaces = ("out", "in", "theta", "gamma")

    @staticmethod
    def message_to_theta(q):
        scalar = _is_scalar_ar(q)
        if scalar:
            q = _promote(q)
        g = e_precision(q["gamma"])
        _, _, s_in, e_x0s, _ = _ar_stats(q)
        if scalar:
            return NormalWeightedMeanPrecision(g * e_x0s[..., 0],
                                               g * s_in[..., 0, 0])
        return MvNormalWeightedMeanPrecision(g[..., None] * e_x0s,
                                             g[..., None, None] * s_in)

    @staticmethod
    def message_to_gamma(q):
        if _is_scalar_ar(q):
            q = _promote(q)
        c2 = _c2(q)
        return GammaShapeRate(torch.full_like(c2, 1.5), 0.5 * c2)

    @staticmethod
    def average_energy(q):
        """E[-log N(out_0; theta^T in, 1/gamma)] per transition copy: the
        shift rows are deterministic, so only the first component adds an
        energy."""
        if _is_scalar_ar(q):
            q = _promote(q)
        g = e_precision(q["gamma"])
        elog_g = e_log_precision(q["gamma"])
        return 0.5 * (_LOG2PI - elog_g + g * _c2(q))
