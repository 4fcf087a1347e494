"""Node rules (counterpart of ``rxinfer_tpu/rules/nodes.py``).

Ported subset: the message rules of the nodes a linear-Gaussian chain is
built from — ``NormalMeanVariance``/``NormalMeanPrecision``,
``MvNormalMeanCovariance``/``MvNormalMeanPrecision`` and the scalar and
multivariate LinearGaussian pairs (out = A in + b + noise) — and those of an
HMM: ``Categorical`` (towards ``out``), ``DirichletCollection`` (towards
``out``) and ``DiscreteTransition`` (towards ``out``, ``in`` and
``matrix``, and the structured ``message_to_out_structured`` that
predictions of ``UnfactorizedData`` take).  Average energies, the conjugate
messages towards noise interfaces (Gamma / Wishart carriers) and
``Dirichlet`` arrive with free energy and the rest of the node library.

Rules are batched: leading dimensions of every marginal broadcast, so a whole
plate of messages is one tensor expression.
"""

from __future__ import annotations

import torch

from ..dists import (
    Categorical,
    DirichletCollection,
    MvNormalMeanCovariance,
    MvNormalMeanPrecision,
    MvNormalWeightedMeanPrecision,
    NormalMeanPrecision,
    NormalMeanVariance,
    NormalWeightedMeanPrecision,
    PointMass,
    pd_inverse,
)
from .expectations import e_cov, e_mean, e_precision, e_var
from .registry import node


# -- scalar Gaussian nodes -------------------------------------------------------

@node("NormalMeanVariance")
class NormalMeanVarianceNode:
    interfaces = ("out", "mean", "var")
    cavity_cluster = ("out", "mean")

    @staticmethod
    def message_to_out(q):
        return NormalMeanVariance(e_mean(q["mean"]),
                                  e_mean(q["var"]) + e_var(q["mean"]))

    @staticmethod
    def message_to_mean(q):
        return NormalMeanVariance(e_mean(q["out"]),
                                  e_mean(q["var"]) + e_var(q["out"]))

    @staticmethod
    def vmp_message_to_out(q):
        return NormalMeanVariance(e_mean(q["mean"]), e_mean(q["var"]))

    @staticmethod
    def vmp_message_to_mean(q):
        return NormalMeanVariance(e_mean(q["out"]), e_mean(q["var"]))


@node("NormalMeanPrecision")
class NormalMeanPrecisionNode:
    interfaces = ("out", "mean", "prec")
    cavity_cluster = ("out", "mean")

    @staticmethod
    def message_to_out(q):
        return NormalMeanVariance(
            e_mean(q["mean"]), 1.0 / e_precision(q["prec"]) + e_var(q["mean"]))

    @staticmethod
    def message_to_mean(q):
        return NormalMeanVariance(
            e_mean(q["out"]), 1.0 / e_precision(q["prec"]) + e_var(q["out"]))

    @staticmethod
    def vmp_message_to_out(q):
        return NormalMeanPrecision(e_mean(q["mean"]), e_precision(q["prec"]))

    @staticmethod
    def vmp_message_to_mean(q):
        return NormalMeanPrecision(e_mean(q["out"]), e_precision(q["prec"]))


# -- multivariate Gaussian nodes ---------------------------------------------------

@node("MvNormalMeanCovariance")
class MvNormalMeanCovarianceNode:
    interfaces = ("out", "mean", "cov")
    cavity_cluster = ("out", "mean")

    @staticmethod
    def message_to_out(q):
        return MvNormalMeanCovariance(e_mean(q["mean"]),
                                      e_mean(q["cov"]) + e_cov(q["mean"]))

    @staticmethod
    def message_to_mean(q):
        return MvNormalMeanCovariance(e_mean(q["out"]),
                                      e_mean(q["cov"]) + e_cov(q["out"]))

    @staticmethod
    def vmp_message_to_out(q):
        return MvNormalMeanCovariance(e_mean(q["mean"]), e_mean(q["cov"]))

    @staticmethod
    def vmp_message_to_mean(q):
        return MvNormalMeanCovariance(e_mean(q["out"]), e_mean(q["cov"]))


@node("MvNormalMeanPrecision")
class MvNormalMeanPrecisionNode:
    interfaces = ("out", "mean", "prec")
    cavity_cluster = ("out", "mean")

    @staticmethod
    def message_to_out(q):
        return MvNormalMeanCovariance(
            e_mean(q["mean"]),
            pd_inverse(e_precision(q["prec"])) + e_cov(q["mean"]))

    @staticmethod
    def message_to_mean(q):
        return MvNormalMeanCovariance(
            e_mean(q["out"]),
            pd_inverse(e_precision(q["prec"])) + e_cov(q["out"]))

    @staticmethod
    def vmp_message_to_out(q):
        return MvNormalMeanPrecision(e_mean(q["mean"]), e_precision(q["prec"]))

    @staticmethod
    def vmp_message_to_mean(q):
        return MvNormalMeanPrecision(e_mean(q["out"]), e_precision(q["prec"]))


# -- linear-Gaussian nodes: out = A @ in + b + noise --------------------------------

def _lg_noise_cov(q):
    if "cov" in q:
        noise = q["cov"]
        if isinstance(noise, PointMass):
            return noise.point
        return noise.mean()
    w = e_precision(q["prec"])
    return pd_inverse(w) if w.ndim >= 2 else 1.0 / w


class _MvLinearGaussianBase:
    interfaces = ("out", "in", "A", "b", "cov")

    @staticmethod
    def message_to_out(q):
        """BP forward message: N(A m + b, A V A^T + Sigma)."""
        a = q["A"].point
        b = q["b"].point
        m, v = e_mean(q["in"]), e_cov(q["in"])
        mean = torch.einsum("...ij,...j->...i", a, m) + b
        cov = torch.einsum("...ij,...jk,...lk->...il", a, v, a) + _lg_noise_cov(q)
        return MvNormalMeanCovariance(mean, cov)

    @staticmethod
    def message_to_in(q):
        """BP backward message in information form:
        W = A^T (Sigma + V_out)^-1 A,  xi = A^T (Sigma + V_out)^-1 (m_out - b)."""
        a = q["A"].point
        b = q["b"].point
        m_out, v_out = e_mean(q["out"]), e_cov(q["out"])
        s_inv = pd_inverse(_lg_noise_cov(q) + v_out)
        at_sinv = torch.einsum("...ji,...jk->...ik", a, s_inv)
        w = torch.einsum("...ik,...kj->...ij", at_sinv, a)
        xi = torch.einsum("...ik,...k->...i", at_sinv, m_out - b)
        return MvNormalWeightedMeanPrecision(xi, w)


@node("MvLinearGaussianCovariance")
class MvLinearGaussianCovarianceNode(_MvLinearGaussianBase):
    pass


@node("MvLinearGaussianPrecision")
class MvLinearGaussianPrecisionNode(_MvLinearGaussianBase):
    interfaces = ("out", "in", "A", "b", "prec")


class _LinearGaussianScalarBase:
    """Scalar out = a * in + b + noise."""

    interfaces = ("out", "in", "A", "b", "var")

    @staticmethod
    def _noise_var(q):
        if "var" in q:
            return e_mean(q["var"])
        return 1.0 / e_precision(q["prec"])

    @classmethod
    def message_to_out(cls, q):
        a, b = q["A"].point, q["b"].point
        return NormalMeanVariance(
            a * e_mean(q["in"]) + b,
            a * a * e_var(q["in"]) + cls._noise_var(q))

    @classmethod
    def message_to_in(cls, q):
        a, b = q["A"].point, q["b"].point
        s = cls._noise_var(q) + e_var(q["out"])
        w = a * a / s
        xi = a * (e_mean(q["out"]) - b) / s
        return NormalWeightedMeanPrecision(xi, w)


@node("LinearGaussianCovariance")
class LinearGaussianCovarianceNode(_LinearGaussianScalarBase):
    pass


@node("LinearGaussianPrecision")
class LinearGaussianPrecisionNode(_LinearGaussianScalarBase):
    interfaces = ("out", "in", "A", "b", "prec")


# -- Categorical / DirichletCollection / discrete transitions -----------------------

def _e_onehot(d):
    """E[one-hot(out)] for Categorical-valued variables (or observed one-hot)."""
    if isinstance(d, PointMass):
        return d.point
    return d.mean()


def _e_log_simplex(d):
    """E[log p] for simplex-valued variables (DirichletCollection or
    PointMass)."""
    if isinstance(d, PointMass):
        return torch.log(torch.clamp(d.point, min=1e-37))
    return d.mean_log()


@node("Categorical")
class CategoricalNode:
    interfaces = ("out", "p")

    @staticmethod
    def message_to_out(q):
        return Categorical(_e_log_simplex(q["p"]))


@node("DirichletCollection")
class DirichletCollectionNode:
    interfaces = ("out", "alpha")

    @staticmethod
    def message_to_out(q):
        return DirichletCollection(e_mean(q["alpha"]))


@node("DiscreteTransition")
class DiscreteTransitionNode:
    """out ~ Categorical(P[:, in]): interfaces out, in, matrix, with
    P[i, j] = p(out = i | in = j)."""

    interfaces = ("out", "in", "matrix")

    @classmethod
    def message_to_out(cls, q):
        return Categorical(torch.einsum(
            "...ij,...j->...i", _e_log_simplex(q["matrix"]), _e_onehot(q["in"])))

    @classmethod
    def message_to_in(cls, q):
        return Categorical(torch.einsum(
            "...ij,...i->...j", _e_log_simplex(q["matrix"]),
            _e_onehot(q["out"])))

    @classmethod
    def message_to_out_structured(cls, q):
        """Structured (BP) prediction message, for data wrapped in
        ``UnfactorizedData``: the out marginal of the joint q(out, in) ~
        exp(E[log A][out, in]) q(in), log p(out) = logsumexp_in(E[log A] +
        log q(in)), where the VMP message takes the geometric mean."""
        logq_in = torch.log(torch.clamp(_e_onehot(q["in"]), min=1e-37))
        return Categorical(torch.logsumexp(
            _e_log_simplex(q["matrix"]) + logq_in[..., None, :], dim=-1))

    @classmethod
    def message_to_matrix(cls, q):
        """Conjugate Dirichlet message; ``q["joint"]`` is the structured pair
        marginal q(out, in) of a discrete chain, in [out, in] order."""
        joint = q.get("joint")
        if joint is None:
            joint = (_e_onehot(q["out"])[..., :, None]
                     * _e_onehot(q["in"])[..., None, :])
        return DirichletCollection(1.0 + joint)
