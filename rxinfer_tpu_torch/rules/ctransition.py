"""ContinuousTransition node: out = A(theta) in + noise with a random
vectorized transition matrix theta = vec(A), A of shape (dy, dx), row-major
(counterpart of ``rxinfer_tpu/rules/ctransition.py``).

Conjugate messages:

* to theta: log f is quadratic in theta, -1/2 theta^T (E[W] kron E[x x^T])
  theta + theta^T vec(E[W] E[y x^T]) (row-major Kronecker layout);
* to prec: the Wishart inverse-scale carrier of the moment-matched
  residual scatter;
* to out and in: linear-Gaussian messages at E[A], with the theta
  uncertainty E[A S A^T] - E[A] S E[A]^T folded into the noise.

The message to theta forms (dy dx, dy dx) per factor copy before the plate
reduction sums it.
"""

from __future__ import annotations

import torch

from ..dists import (
    MvNormalMeanCovariance,
    MvNormalWeightedMeanPrecision,
    PointMass,
    WishartInverseScale,
    pd_inverse,
    pd_logdet,
)
from .expectations import e_cov, e_logdet, e_mean, e_outer, e_precision
from .registry import node

_LOG2PI = 1.8378770664093453


def _dims(q):
    return e_mean(q["out"]).shape[-1], e_mean(q["in"]).shape[-1]


def _e_a(q, dy, dx):
    m = e_mean(q["theta"])
    return m.reshape(m.shape[:-1] + (dy, dx))


def _theta_cov_blocks(q, dy, dx):
    """Cov(theta) as (dy, dx, dy, dx) blocks."""
    c = e_cov(q["theta"])
    return c.reshape(c.shape[:-2] + (dy, dx, dy, dx))


def _inflation(q, s_in, dy, dx):
    """E[A S A^T] - E[A] S E[A]^T for S = ``s_in``."""
    return torch.einsum("...ijkl,...jl->...ik",
                        _theta_cov_blocks(q, dy, dx), s_in)


def _sandwich(a, s):
    """a s a^T over broadcast leading axes."""
    return torch.einsum("...ij,...jk,...lk->...il", a, s, a)


@node("ContinuousTransition")
class ContinuousTransitionNode:
    interfaces = ("out", "in", "theta", "prec")

    @classmethod
    def _residual_scatter(cls, q):
        dy, dx = _dims(q)
        a = _e_a(q, dy, dx)
        s_in = e_outer(q["in"])                       # E[x x^T]
        m_out, m_in = e_mean(q["out"]), e_mean(q["in"])
        diff = m_out - torch.einsum("...ij,...j->...i", a, m_in)
        c = (e_cov(q["out"]) + _sandwich(a, e_cov(q["in"]))
             + diff[..., :, None] * diff[..., None, :])
        c = c + _inflation(q, s_in, dy, dx)
        joint = q.get("joint")
        if joint is not None:   # Cov(out, in)
            cr = torch.einsum("...ij,...kj->...ik", joint, a)
            c = c - cr - cr.transpose(-1, -2)
        return c

    @classmethod
    def message_to_theta(cls, q):
        dy, dx = _dims(q)
        w = e_precision(q["prec"])
        s_in = e_outer(q["in"])
        m_out, m_in = e_mean(q["out"]), e_mean(q["in"])
        e_yx = m_out[..., :, None] * m_in[..., None, :]
        joint = q.get("joint")
        if joint is not None:   # E[y x^T] = Cov(out, in) + m m^T
            e_yx = e_yx + joint
        # W_theta = W kron S (row-major vec), xi = vec(W E[y x^T])
        kron = torch.einsum("...ik,...jl->...ijkl", w, s_in)
        w_theta = kron.reshape(kron.shape[:-4] + (dy * dx, dy * dx))
        wyx = torch.einsum("...ij,...jk->...ik", w, e_yx)
        xi = wyx.reshape(wyx.shape[:-2] + (dy * dx,))
        return MvNormalWeightedMeanPrecision(xi, w_theta)

    @classmethod
    def message_to_prec(cls, q):
        c = cls._residual_scatter(q)
        d = c.shape[-1]
        return WishartInverseScale(
            torch.full(c.shape[:-2], float(d) + 2.0, dtype=c.dtype,
                       device=c.device), c)

    @classmethod
    def message_to_out(cls, q):
        dy, dx = _dims(q)
        a = _e_a(q, dy, dx)
        noise = (pd_inverse(e_precision(q["prec"]))
                 + _inflation(q, e_outer(q["in"]), dy, dx))
        mean = torch.einsum("...ij,...j->...i", a, e_mean(q["in"]))
        cov = _sandwich(a, e_cov(q["in"])) + noise
        return MvNormalMeanCovariance(mean, cov)

    @classmethod
    def message_to_in(cls, q):
        """The backward information message at E[A] (the theta uncertainty
        folded into the noise)."""
        dy, dx = _dims(q)
        a = _e_a(q, dy, dx)
        w = e_precision(q["prec"])
        s = (pd_inverse(w) + e_cov(q["out"])
             + _inflation(q, e_outer(q["in"]), dy, dx))
        s_inv = pd_inverse(s)
        at_sinv = torch.einsum("...ji,...jk->...ik", a, s_inv)
        w_msg = torch.einsum("...ik,...kj->...ij", at_sinv, a)
        xi = torch.einsum("...ik,...k->...i", at_sinv, e_mean(q["out"]))
        return MvNormalWeightedMeanPrecision(xi, w_msg)

    @classmethod
    def average_energy(cls, q):
        c = cls._residual_scatter(q)
        d = c.shape[-1]
        w = e_precision(q["prec"])
        if isinstance(q["prec"], PointMass):
            elogdet = -pd_logdet(pd_inverse(w))
        else:
            elogdet = e_logdet(q["prec"])
        return 0.5 * (d * _LOG2PI - elogdet
                      + torch.einsum("...ij,...ji->...", w, c))
