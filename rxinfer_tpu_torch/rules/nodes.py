"""Node rules (counterpart of ``rxinfer_tpu/rules/nodes.py``).

Ported subset: the message rules of the nodes a linear-Gaussian chain is
built from — ``NormalMeanVariance``/``NormalMeanPrecision``,
``MvNormalMeanCovariance``/``MvNormalMeanPrecision``, the scalar and
multivariate LinearGaussian pairs (out = A in + b + noise) and the
GaussianDot pair (scalar out = a^T in + b + noise), with the
conjugate messages towards a random precision (``message_to_prec``: a
``GammaShapeRate`` for a scalar, a ``WishartInverseScale`` for a matrix) —
the priors of such a precision (``GammaShapeRate`` and ``Wishart``, towards
``out``), and those of an HMM: ``Categorical`` (towards ``out``),
``DirichletCollection`` (towards ``out``) and ``DiscreteTransition``
(towards ``out``, ``in`` and ``matrix``, and the structured
``message_to_out_structured`` that predictions of ``UnfactorizedData``
take), the Beta-Bernoulli pair: ``Beta`` (towards ``out``) and
``Bernoulli`` (towards ``out`` and ``p``), and the Gaussian mixture:
``Categorical`` towards ``p``, ``Dirichlet`` (towards ``out``) and
``NormalMixture`` / ``MvNormalMixture`` (towards ``out``, ``switch`` and
each component's ``mean{i}`` / ``prec{i}``).  Every one of these nodes has its
``average_energy(q)``, E_q[-log f] per factor copy, which free energy
reads; a chain transition's reads the structured pair statistics
``q["joint"]``.  The messages towards variance / covariance interfaces
(InverseGamma / InverseWishart carriers) arrive with the rest of the node
library.

Rules are batched: leading dimensions of every marginal broadcast, so a whole
plate of messages is one tensor expression.
"""

from __future__ import annotations

import torch

from ..dists import (
    Bernoulli,
    Beta,
    Categorical,
    Dirichlet,
    DirichletCollection,
    GammaShapeRate,
    MvNormalMeanCovariance,
    MvNormalMeanPrecision,
    MvNormalWeightedMeanPrecision,
    NormalMeanPrecision,
    NormalMeanVariance,
    NormalWeightedMeanPrecision,
    PointMass,
    Wishart,
    WishartInverseScale,
    pd_inverse,
    pd_logdet,
)
from ..dists.matrix import _mv_gammaln
from ..dists.scalar_families import betaln
from .expectations import (
    e_cov,
    e_log,
    e_log_precision,
    e_logdet,
    e_mean,
    e_mirrorlog,
    e_precision,
    e_sq,
    e_var,
)
from .registry import node

_LOG2PI = 1.8378770664093453
_LOG2 = 0.6931471805599453


def _scalar_c(q):
    """E[(out - mean)^2] under independent q(out), q(mean)."""
    return (e_sq(q["out"]) - 2.0 * e_mean(q["out"]) * e_mean(q["mean"])
            + e_sq(q["mean"]))


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

    @staticmethod
    def average_energy(q):
        v = q["var"].point   # the port has no random-variance family
        return 0.5 * (_LOG2PI + torch.log(v) + _scalar_c(q) * (1.0 / v))


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

    @staticmethod
    def message_to_prec(q):
        """Conjugate Gamma message: proportional to w^{1/2} exp(-w C / 2),
        C = E[(out - mean)^2]."""
        c = _scalar_c(q)
        return GammaShapeRate(torch.full_like(c, 1.5), 0.5 * c)

    @staticmethod
    def average_energy(q):
        w = e_precision(q["prec"])
        elogw = e_log_precision(q["prec"])
        return 0.5 * (_LOG2PI - elogw + w * _scalar_c(q))


# -- multivariate Gaussian nodes ---------------------------------------------------

def _mv_centered_second_moment(q):
    """E[(x - mu)(x - mu)^T] under independent q(x), q(mu)."""
    diff = e_mean(q["out"]) - e_mean(q["mean"])
    return (e_cov(q["out"]) + e_cov(q["mean"])
            + diff[..., None] * diff[..., None, :])


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

    @staticmethod
    def average_energy(q):
        cov = q["cov"].point   # the port has no random-covariance family
        c = _mv_centered_second_moment(q)
        d = c.shape[-1]
        return 0.5 * (d * _LOG2PI + pd_logdet(cov)
                      + torch.einsum("...ij,...ji->...", pd_inverse(cov), c))


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

    @staticmethod
    def message_to_prec(q):
        """Conjugate Wishart message, proportional to |W|^{1/2}
        exp(-tr(W C) / 2), in inverse-scale form (C is singular for one
        observation)."""
        c = _mv_centered_second_moment(q)
        d = c.shape[-1]
        return WishartInverseScale(
            torch.full(c.shape[:-2], float(d) + 2.0, dtype=c.dtype,
                       device=c.device), c)

    @staticmethod
    def average_energy(q):
        w = e_precision(q["prec"])
        elogdet = e_logdet(q["prec"])
        c = _mv_centered_second_moment(q)
        d = c.shape[-1]
        return 0.5 * (d * _LOG2PI - elogdet
                      + torch.einsum("...ij,...ji->...", w, c))


# -- linear-Gaussian nodes: out = A @ in + b + noise --------------------------------

def _lg_noise_cov(q):
    if "cov" in q:
        noise = q["cov"]
        if isinstance(noise, PointMass):
            return noise.point
        return noise.mean()
    w = e_precision(q["prec"])
    return pd_inverse(w) if w.ndim >= 2 else 1.0 / w


def _lg_noise_prec(q):
    if "prec" in q:
        return e_precision(q["prec"])
    v = q["cov"]
    v = v.point if isinstance(v, PointMass) else v.mean()
    return pd_inverse(v) if v.ndim >= 2 else 1.0 / v


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

    @staticmethod
    def _centered_second_moment(q):
        """E[(out - A in - b)(out - A in - b)^T]; ``q["joint"]``, the cross
        covariance Cov(out, in) of a chain (..., d_out, d_in), enters when
        present."""
        a = q["A"].point
        b = q["b"].point
        m_out, m_in = e_mean(q["out"]), e_mean(q["in"])
        diff = m_out - torch.einsum("...ij,...j->...i", a, m_in) - b
        c = (e_cov(q["out"])
             + torch.einsum("...ij,...jk,...lk->...il", a, e_cov(q["in"]), a)
             + diff[..., None] * diff[..., None, :])
        joint = q.get("joint")
        if joint is not None:
            cross = torch.einsum("...ij,...kj->...ik", joint, a)
            c = c - cross - cross.transpose(-1, -2)
        return c

    @classmethod
    def average_energy(cls, q):
        c = cls._centered_second_moment(q)
        d = c.shape[-1]
        w = _lg_noise_prec(q)
        if "prec" in q and not isinstance(q["prec"], PointMass):
            elogdet = e_logdet(q["prec"])
        else:
            elogdet = -pd_logdet(_lg_noise_cov(q))
        return 0.5 * (d * _LOG2PI - elogdet
                      + torch.einsum("...ij,...ji->...", w, c))


@node("MvLinearGaussianCovariance")
class MvLinearGaussianCovarianceNode(_MvLinearGaussianBase):
    pass


@node("MvLinearGaussianPrecision")
class MvLinearGaussianPrecisionNode(_MvLinearGaussianBase):
    interfaces = ("out", "in", "A", "b", "prec")

    @staticmethod
    def message_to_prec(q):
        c = _MvLinearGaussianBase._centered_second_moment(q)
        d = c.shape[-1]
        return WishartInverseScale(
            torch.full(c.shape[:-2], float(d) + 2.0, dtype=c.dtype,
                       device=c.device), c)


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

    @classmethod
    def _c2(cls, q):
        """E[(out - a in - b)^2]; ``q["joint"]``, a chain's Cov(out, in),
        enters when present."""
        a, b = q["A"].point, q["b"].point
        diff = e_mean(q["out"]) - a * e_mean(q["in"]) - b
        c = e_var(q["out"]) + a * a * e_var(q["in"]) + diff * diff
        joint = q.get("joint")
        if joint is not None:
            c = c - 2.0 * a * joint
        return c

    @classmethod
    def average_energy(cls, q):
        if "prec" in q and not isinstance(q["prec"], PointMass):
            elogw = e_log_precision(q["prec"])
            w = e_precision(q["prec"])
        else:
            v = cls._noise_var(q)
            elogw = -torch.log(v)
            w = 1.0 / v
        return 0.5 * (_LOG2PI - elogw + w * cls._c2(q))


@node("LinearGaussianCovariance")
class LinearGaussianCovarianceNode(_LinearGaussianScalarBase):
    pass


@node("LinearGaussianPrecision")
class LinearGaussianPrecisionNode(_LinearGaussianScalarBase):
    interfaces = ("out", "in", "A", "b", "prec")

    @classmethod
    def message_to_prec(cls, q):
        c2 = cls._c2(q)
        return GammaShapeRate(torch.full_like(c2, 1.5), 0.5 * c2)


# -- GaussianDot: scalar out = a^T in + b + noise, a known vector ------------------

class _GaussianDotBase:
    """Scalar out = a^T in + b + noise with a random vector in and a known
    vector a (a constant, or a slot of a data array: regression features).
    out and in form one cluster; the rules are message-form already."""

    interfaces = ("out", "in", "A", "b", "var")
    cavity_cluster = ("out", "in")

    @staticmethod
    def _noise_var(q):
        if "var" in q:
            return e_mean(q["var"])
        return 1.0 / e_precision(q["prec"])

    @classmethod
    def message_to_out(cls, q):
        a, b = q["A"].point, q["b"].point
        m, v = e_mean(q["in"]), e_cov(q["in"])
        mean = torch.einsum("...i,...i->...", a, m) + b
        var = torch.einsum("...i,...ij,...j->...", a, v, a) \
            + cls._noise_var(q)
        return NormalMeanVariance(mean, var)

    @classmethod
    def message_to_in(cls, q):
        a, b = q["A"].point, q["b"].point
        s = cls._noise_var(q) + e_var(q["out"])
        diff = e_mean(q["out"]) - b
        xi = a * (diff / s)[..., None]
        w = a[..., :, None] * a[..., None, :] / s[..., None, None]
        return MvNormalWeightedMeanPrecision(xi, w)

    @classmethod
    def _c2(cls, q):
        """E[(out - a^T in - b)^2] under independent q(out), q(in)."""
        a, b = q["A"].point, q["b"].point
        m, v = e_mean(q["in"]), e_cov(q["in"])
        diff = e_mean(q["out"]) - torch.einsum("...i,...i->...", a, m) - b
        return (e_var(q["out"]) + torch.einsum("...i,...ij,...j->...", a, v, a)
                + diff * diff)

    @classmethod
    def average_energy(cls, q):
        if "prec" in q and not isinstance(q["prec"], PointMass):
            elogw = e_log_precision(q["prec"])
            w = e_precision(q["prec"])
        else:
            nv = cls._noise_var(q)
            elogw = -torch.log(nv)
            w = 1.0 / nv
        return 0.5 * (_LOG2PI - elogw + w * cls._c2(q))


@node("GaussianDotCovariance")
class GaussianDotCovarianceNode(_GaussianDotBase):
    pass


@node("GaussianDotPrecision")
class GaussianDotPrecisionNode(_GaussianDotBase):
    interfaces = ("out", "in", "A", "b", "prec")

    @classmethod
    def message_to_prec(cls, q):
        c2 = cls._c2(q)
        return GammaShapeRate(torch.full_like(c2, 1.5), 0.5 * c2)


# -- Beta / Bernoulli ---------------------------------------------------------------

@node("Beta")
class BetaNode:
    interfaces = ("out", "a", "b")

    @staticmethod
    def message_to_out(q):
        return Beta(e_mean(q["a"]), e_mean(q["b"]))

    @staticmethod
    def average_energy(q):
        a, b = e_mean(q["a"]), e_mean(q["b"])
        return (betaln(a, b) - (a - 1.0) * e_log(q["out"])
                - (b - 1.0) * e_mirrorlog(q["out"]))


@node("Bernoulli")
class BernoulliNode:
    interfaces = ("out", "p")

    @staticmethod
    def message_to_out(q):
        logit = e_log(q["p"]) - e_mirrorlog(q["p"])
        return Bernoulli(torch.clamp(1.0 / (1.0 + torch.exp(-logit)),
                                     1e-12, 1 - 1e-12))

    @staticmethod
    def message_to_p(q):
        y = e_mean(q["out"])
        return Beta(1.0 + y, 2.0 - y)

    @staticmethod
    def average_energy(q):
        y = e_mean(q["out"])
        return -(y * e_log(q["p"]) + (1.0 - y) * e_mirrorlog(q["p"]))


# -- precision priors ---------------------------------------------------------------

@node("GammaShapeRate")
class GammaShapeRateNode:
    interfaces = ("out", "shape", "rate")

    @staticmethod
    def message_to_out(q):
        return GammaShapeRate(e_mean(q["shape"]), e_precision(q["rate"]))

    @staticmethod
    def average_energy(q):
        a = e_mean(q["shape"])
        return -((a - 1.0) * e_log(q["out"])
                 - e_mean(q["rate"]) * e_mean(q["out"])
                 + a * e_log(q["rate"]) - torch.lgamma(a))


@node("Wishart")
class WishartNode:
    interfaces = ("out", "nu", "S")

    @staticmethod
    def message_to_out(q):
        s = q["S"]
        return Wishart(e_mean(q["nu"]),
                       s.point if isinstance(s, PointMass) else e_mean(s))

    @staticmethod
    def average_energy(q):
        nu = e_mean(q["nu"])
        s = q["S"].point if isinstance(q["S"], PointMass) else e_mean(q["S"])
        d = s.shape[-1]
        e_x = e_precision(q["out"])
        return -(0.5 * (nu - d - 1.0) * e_logdet(q["out"])
                 - 0.5 * torch.einsum("...ij,...ji->...", pd_inverse(s), e_x)
                 - 0.5 * nu * d * _LOG2
                 - 0.5 * nu * pd_logdet(s)
                 - _mv_gammaln(d, 0.5 * nu))


# -- Categorical / DirichletCollection / discrete transitions -----------------------

def _e_onehot(d):
    """E[one-hot(out)] for Categorical-valued variables (or observed one-hot)."""
    if isinstance(d, PointMass):
        return d.point
    return d.mean()


def _e_log_simplex(d):
    """E[log p] for simplex-valued variables (Dirichlet, DirichletCollection
    or PointMass)."""
    if isinstance(d, PointMass):
        return torch.log(torch.clamp(d.point, min=1e-37))
    return d.mean_log()


@node("Categorical")
class CategoricalNode:
    interfaces = ("out", "p")

    @staticmethod
    def message_to_out(q):
        return Categorical(_e_log_simplex(q["p"]))

    @staticmethod
    def message_to_p(q):
        return Dirichlet(1.0 + _e_onehot(q["out"]))

    @staticmethod
    def average_energy(q):
        return -torch.sum(_e_onehot(q["out"]) * _e_log_simplex(q["p"]), dim=-1)


@node("Dirichlet")
class DirichletNode:
    interfaces = ("out", "alpha")

    @staticmethod
    def message_to_out(q):
        return Dirichlet(e_mean(q["alpha"]))

    @staticmethod
    def average_energy(q):
        a = e_mean(q["alpha"])
        lb = torch.sum(torch.lgamma(a), dim=-1) - torch.lgamma(
            torch.sum(a, dim=-1))
        return lb - torch.sum((a - 1.0) * _e_log_simplex(q["out"]), dim=-1)


@node("DirichletCollection")
class DirichletCollectionNode:
    interfaces = ("out", "alpha")

    @staticmethod
    def message_to_out(q):
        return DirichletCollection(e_mean(q["alpha"]))

    @staticmethod
    def average_energy(q):
        """Summed over the collection's columns (simplex axis -2)."""
        a = e_mean(q["alpha"])
        lb = (torch.sum(torch.lgamma(a), dim=-2)
              - torch.lgamma(torch.sum(a, dim=-2)))
        return (torch.sum(lb, dim=-1)
                + torch.sum(-(a - 1.0) * _e_log_simplex(q["out"]),
                            dim=(-2, -1)))


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
        return DirichletCollection(1.0 + cls._joint(q))

    @staticmethod
    def _joint(q):
        joint = q.get("joint")
        if joint is None:
            joint = (_e_onehot(q["out"])[..., :, None]
                     * _e_onehot(q["in"])[..., None, :])
        return joint

    @classmethod
    def average_energy(cls, q):
        return -torch.sum(cls._joint(q) * _e_log_simplex(q["matrix"]),
                          dim=(-2, -1))


# -- mixtures -------------------------------------------------------------------------

class _ComponentRules(type):
    """Resolves a mixture's per-component interface rules by name: for each
    prefix of the class's ``_indexed`` (``mean``, ``prec`` by default),
    ``message_to_<prefix>{i}`` is the class's ``_message_to_<prefix>_i(q,
    i)`` (the interfaces are ``mean0..meanK-1``, ``prec0..precK-1``)."""

    def __getattr__(cls, name):
        indexed = next((c.__dict__["_indexed"] for c in cls.__mro__
                        if "_indexed" in c.__dict__), ("mean", "prec"))
        for iface in indexed:
            prefix = f"message_to_{iface}"
            tail = name[len(prefix):]
            if name.startswith(prefix) and tail.isdigit():
                rule = getattr(cls, f"_message_to_{iface}_i")
                return lambda q, _i=int(tail): rule(q, _i)
        raise AttributeError(name)


def _n_components(q) -> int:
    return sum(1 for key in q if key.startswith("mean"))


def _component_c(q, i: int):
    """E[(out - mean_i)^2] under independent q(out), q(mean_i)."""
    return (e_sq(q["out"]) - 2.0 * e_mean(q["out"]) * e_mean(q[f"mean{i}"])
            + e_sq(q[f"mean{i}"]))


@node("NormalMixture")
class NormalMixtureNode(metaclass=_ComponentRules):
    """out ~ prod_k N(out; mean_k, prec_k^-1)^{s_k}: interfaces out,
    switch, mean0..meanK-1, prec0..precK-1 (Gaussian means, Gamma
    precisions)."""

    @staticmethod
    def message_to_out(q):
        r = _e_onehot(q["switch"])
        k = _n_components(q)
        w = sum(r[..., i] * e_precision(q[f"prec{i}"]) for i in range(k))
        xi = sum(r[..., i] * e_precision(q[f"prec{i}"])
                 * e_mean(q[f"mean{i}"]) for i in range(k))
        return NormalWeightedMeanPrecision(xi, w)

    @staticmethod
    def message_to_switch(q):
        logits = [-0.5 * (_LOG2PI - e_log_precision(q[f"prec{i}"])
                          + e_precision(q[f"prec{i}"]) * _component_c(q, i))
                  for i in range(_n_components(q))]
        return Categorical(torch.stack(logits, dim=-1))

    @staticmethod
    def _message_to_mean_i(q, i: int):
        r = _e_onehot(q["switch"])[..., i]
        w = e_precision(q[f"prec{i}"])
        return NormalWeightedMeanPrecision(r * w * e_mean(q["out"]), r * w)

    @staticmethod
    def _message_to_prec_i(q, i: int):
        r = _e_onehot(q["switch"])[..., i]
        return GammaShapeRate(1.0 + 0.5 * r, 0.5 * r * _component_c(q, i))

    @staticmethod
    def average_energy(q):
        r = _e_onehot(q["switch"])
        total = 0.0
        for i in range(_n_components(q)):
            total = total + r[..., i] * 0.5 * (
                _LOG2PI - e_log_precision(q[f"prec{i}"])
                + e_precision(q[f"prec{i}"]) * _component_c(q, i))
        return total


def _mv_component_c(q, i: int):
    """E[(out - m_i)(out - m_i)^T] under independent q(out), q(m_i)."""
    mx, mi = e_mean(q["out"]), e_mean(q[f"mean{i}"])
    xx = e_cov(q["out"]) + mx[..., :, None] * mx[..., None, :]
    mm = e_cov(q[f"mean{i}"]) + mi[..., :, None] * mi[..., None, :]
    cross = mx[..., :, None] * mi[..., None, :]
    return xx - cross - cross.transpose(-1, -2) + mm


def _mv_component_energy(q, i: int, d: int):
    tr = torch.einsum("...ij,...ji->...", e_precision(q[f"prec{i}"]),
                      _mv_component_c(q, i))
    return 0.5 * (d * _LOG2PI - e_logdet(q[f"prec{i}"]) + tr)


@node("MvNormalMixture")
class MvNormalMixtureNode(metaclass=_ComponentRules):
    """The multivariate mixture likelihood: MvNormal component means and
    Wishart component precisions."""

    @staticmethod
    def message_to_out(q):
        r = _e_onehot(q["switch"])
        k = _n_components(q)
        w = sum(r[..., i, None, None] * e_precision(q[f"prec{i}"])
                for i in range(k))
        xi = sum(r[..., i, None] * torch.einsum(
            "...ij,...j->...i", e_precision(q[f"prec{i}"]),
            e_mean(q[f"mean{i}"])) for i in range(k))
        return MvNormalWeightedMeanPrecision(xi, w)

    @staticmethod
    def message_to_switch(q):
        d = e_mean(q["out"]).shape[-1]
        return Categorical(torch.stack(
            [-_mv_component_energy(q, i, d) for i in range(_n_components(q))],
            dim=-1))

    @staticmethod
    def _message_to_mean_i(q, i: int):
        r = _e_onehot(q["switch"])[..., i]
        w = e_precision(q[f"prec{i}"])
        xi = torch.einsum("...ij,...j->...i", w, e_mean(q["out"]))
        return MvNormalWeightedMeanPrecision(r[..., None] * xi,
                                             r[..., None, None] * w)

    @staticmethod
    def _message_to_prec_i(q, i: int):
        """|W|^{r/2} exp(-r tr(C_i W) / 2) in the inverse-scale carrier
        (improper for r < 1; aggregated in natural form)."""
        r = _e_onehot(q["switch"])[..., i]
        c = _mv_component_c(q, i)
        return WishartInverseScale(r + c.shape[-1] + 1.0,
                                   r[..., None, None] * c)

    @staticmethod
    def average_energy(q):
        r = _e_onehot(q["switch"])
        d = e_mean(q["out"]).shape[-1]
        total = 0.0
        for i in range(_n_components(q)):
            total = total + r[..., i] * _mv_component_energy(q, i, d)
        return total
