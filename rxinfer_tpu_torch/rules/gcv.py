"""GCV (Gaussian controlled variance) node, the building block of the
hierarchical Gaussian filter (counterpart of ``rxinfer_tpu/rules/gcv.py``):

    out ~ N(in, exp(kappa z + omega)).

The x-level chain takes the log-normal moment E[exp(-(kappa z + omega))] of
q(z) as its per-step precision (``engine/blocks.py`` ``GCVChainBlock``); the
message to z is moment-matched by Gauss-Hermite quadrature of the tilted
density and divided by the current marginal q(z), so the rule reads its own
marginal (``needs_self_marginal``) and may return a negative precision, an
improper message the z chain takes as it is.
"""

from __future__ import annotations

import torch

from ..dists import NormalMeanVariance, NormalWeightedMeanPrecision, PointMass
from .expectations import e_mean, e_var
from .registry import node
from .special import _GH_POINTS, gauss_hermite_nodes

_LOG2PI = 1.8378770664093453


def _const(q, name, default=None):
    v = q.get(name, default)
    if isinstance(v, PointMass):
        return v.point
    if v is None:
        return default
    return e_mean(v)


def _delta2(q):
    """E[(out - in)^2] under the structured pair marginal.  The cross is
    clipped to the Cauchy-Schwarz bound of the marginal variances: mid-run
    a cavity-reconstructed cross can exceed it, which would make the
    expected squared step negative and blow up the quadrature."""
    m_out, v_out = e_mean(q["out"]), e_var(q["out"])
    m_in, v_in = e_mean(q["in"]), e_var(q["in"])
    cross = q.get("joint")
    if cross is None:
        c = 0.0
    else:
        bound = 0.999 * torch.sqrt(torch.clamp(v_out * v_in, min=0.0))
        c = torch.clamp(cross, min=-bound, max=bound)
    return torch.clamp(v_out + v_in - 2.0 * c + (m_out - m_in) ** 2,
                       min=1e-10)


def expected_precision(q):
    """E[exp(-(kappa z + omega))], the log-normal moment in closed form."""
    k = _const(q, "kappa", 1.0)
    w = _const(q, "omega", 0.0)
    mz, vz = e_mean(q["z"]), e_var(q["z"])
    return torch.exp(-k * mz + 0.5 * k * k * vz - w)


@node("GCV")
class GCVNode:
    interfaces = ("out", "in", "z", "kappa", "omega")
    needs_self_marginal = True   # message_to_z divides out q(z)
    # the reference HGF constraint q(x_t, z_t, x_{t-1}) = q(x_t, x_{t-1})
    # q(z_t): (out, in) is one cluster across the mean-field split
    cavity_cluster = ("out", "in")

    @staticmethod
    def message_to_out(q):
        """Structured message: the in edge convolved with the expected
        noise, its variance floored so that the message stays proper."""
        v = e_var(q["in"]) + 1.0 / expected_precision(q)
        return NormalMeanVariance(e_mean(q["in"]), torch.clamp(v, min=1e-8))

    @staticmethod
    def message_to_in(q):
        v = e_var(q["out"]) + 1.0 / expected_precision(q)
        return NormalMeanVariance(e_mean(q["out"]), torch.clamp(v, min=1e-8))

    @staticmethod
    def vmp_message_to_out(q):
        """Mean-field variant (q(out) q(in) factorized by a constraint)."""
        p = expected_precision(q)
        return NormalWeightedMeanPrecision(e_mean(q["in"]) * p, p)

    @staticmethod
    def vmp_message_to_in(q):
        p = expected_precision(q)
        return NormalWeightedMeanPrecision(e_mean(q["out"]) * p, p)

    @staticmethod
    def message_to_z(q):
        """Tilted moment matching, q*(z) ∝ q(z) exp(-(kz + w)/2 - d2/2
        e^{-kz - w}), then q* / q by natural subtraction, by the
        31-point quadrature per copy.  The log-likelihood is stabilized by
        its maximum over the grid, not its value at the mean: at a large
        d2 the tilted density peaks many widths from the mean, where a
        mean-point stabilizer overflows float32."""
        k = _const(q, "kappa", 1.0)
        w = _const(q, "omega", 0.0)
        d2 = _delta2(q)
        mz, vz = e_mean(q["z"]), e_var(q["z"])
        xg, wg = gauss_hermite_nodes(_GH_POINTS, mz.device)
        pts = mz[..., None] + torch.sqrt(vz)[..., None] * xg
        logl = -0.5 * (k * pts + w) - 0.5 * d2[..., None] * torch.exp(
            -k * pts - w)
        logl = logl - torch.amax(logl, dim=-1, keepdim=True)
        tw = wg * torch.exp(logl)
        w0 = torch.sum(tw, dim=-1)
        m1 = torch.sum(tw * pts, dim=-1) / w0
        m2 = torch.sum(tw * pts * pts, dim=-1) / w0
        vt = torch.clamp(m2 - m1 * m1, min=1e-8)
        return NormalWeightedMeanPrecision(m1 / vt - mz / vz,
                                           1.0 / vt - 1.0 / vz)

    @staticmethod
    def average_energy(q):
        """E[-log N(out; in, exp(kz + w))] with the structured (out, in)
        pair and a mean-field z."""
        k = _const(q, "kappa", 1.0)
        w = _const(q, "omega", 0.0)
        mz = e_mean(q["z"])
        return 0.5 * (_LOG2PI + k * mz + w
                      + expected_precision(q) * _delta2(q))
