"""Node rules (counterpart of ``rxinfer_tpu/rules/nodes.py``), every
``@node`` of the JAX module and the classes it registers outside ``@node``:

* the Gaussian nodes ``NormalMeanVariance`` / ``NormalMeanPrecision``,
  ``MvNormalMeanCovariance`` / ``MvNormalMeanPrecision`` and the
  scale-precision ``MvNormalMeanScalePrecision``, with the conjugate
  messages towards a random noise (``message_to_prec``: a
  ``GammaShapeRate`` or a ``WishartInverseScale``; ``message_to_var`` /
  ``message_to_cov``: the improper ``InverseGamma`` / ``InverseWishart``
  carriers; ``message_to_gamma``: a ``GammaShapeRate``);
* the linear-Gaussian pairs (out = A in + b + noise) and the GaussianDot
  pair (scalar out = a^T in + b + noise);
* the priors ``GammaShapeRate`` (towards ``out`` and ``rate``),
  ``GammaShapeScale``, ``InverseGamma``, ``Wishart``, ``InverseWishart``,
  ``Beta``, ``Uniform`` and the flat ``Uninformative``;
* the count likelihoods ``Bernoulli``, ``Binomial``, ``Poisson`` and
  ``Multinomial`` (towards their Beta / Gamma / Dirichlet parameters);
* the HMM's ``Categorical``, ``Dirichlet``, ``DirichletCollection`` and
  ``DiscreteTransition`` (with the structured ``message_to_out_structured``
  of ``UnfactorizedData``), and the Gaussian mixtures ``NormalMixture`` /
  ``MvNormalMixture``;
* the sums of random variables: the deterministic ``Sum`` and ``LinComb``
  (out = sum A_i in_i + b; exact BP in natural form, with their cavity
  stores, ``uses_cavity``) and the contracted ``GaussianSum*`` /
  ``MvGaussianSum*`` (out ~ N(sum in_i, noise)).

Every node but the deterministic ones has its ``average_energy(q)``,
E_q[-log f] per factor copy, which free energy reads; ``Sum`` and
``LinComb`` have a ``bethe_term`` instead, -H of the joint belief over their
inputs (the JAX package's ``LinComb`` has none: its free energy raises
there).  A chain transition's energy reads the structured pair statistics
``q["joint"]``.

Rules are batched: leading dimensions of every marginal broadcast, so a whole
plate of messages is one tensor expression.  A constant (a point mass of a
model constant) carries no batch axis, so its rank is its own.
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
    GammaShapeScale,
    InverseGamma,
    InverseWishart,
    MvNormalMeanCovariance,
    MvNormalMeanScalePrecision,
    MvNormalMeanPrecision,
    MvNormalWeightedMeanPrecision,
    NormalMeanPrecision,
    NormalMeanVariance,
    NormalWeightedMeanPrecision,
    PointMass,
    Poisson,
    Uniform,
    Wishart,
    WishartInverseScale,
    pd_inverse,
    pd_logdet,
)
from ..dists.gaussian import (
    AbstractMvNormal,
    AbstractNormal,
    as_mv_weighted_mean_precision,
    as_weighted_mean_precision,
)
from ..dists.matrix import _mv_gammaln
from ..dists.scalar_families import betaln
from .expectations import (
    e_cov,
    e_inv_scalar,
    e_inverse,
    e_log,
    e_log_precision,
    e_log_simplex,
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
_LOG2PIE = 2.837877066409345  # log(2 pi e)


def _scalar_c(q):
    """E[(out - mean)^2] under independent q(out), q(mean), expanded as the
    JAX package's messages take it."""
    return (e_sq(q["out"]) - 2.0 * e_mean(q["out"]) * e_mean(q["mean"])
            + e_sq(q["mean"]))


def _scalar_c_energy(q):
    """The same as Var[out] + Var[mean] + (E[out] - E[mean])^2, for the
    average energies: the expanded form cancels in float32 at levels far
    from 0 and leaves the free energy there off by up to 1e-4 relative
    (ROADMAP C14; the JAX package's energies keep it)."""
    diff = e_mean(q["out"]) - e_mean(q["mean"])
    return e_var(q["out"]) + e_var(q["mean"]) + diff * diff


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
    def message_to_var(q):
        """Conjugate InverseGamma message, proportional to v^{-1/2}
        exp(-C / (2 v)): the improper a = -1/2 carrier, natural parameters
        (1/2, C/2); only its product with a proper prior is normalized."""
        c = _scalar_c(q)
        return InverseGamma(torch.full_like(c, -0.5), 0.5 * c)

    @staticmethod
    def average_energy(q):
        return 0.5 * (_LOG2PI + e_log(q["var"])
                      + _scalar_c_energy(q) * e_inv_scalar(q["var"]))


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
        return 0.5 * (_LOG2PI - elogw + w * _scalar_c_energy(q))


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
    def message_to_cov(q):
        """Conjugate InverseWishart message, proportional to |V|^{-1/2}
        exp(-tr(V^-1 C) / 2): the improper nu = -d carrier, whose product
        with a prior IW(nu0, Psi0) is IW(nu0 + 1, Psi0 + C)."""
        c = _mv_centered_second_moment(q)
        d = c.shape[-1]
        return InverseWishart(
            torch.full(c.shape[:-2], -float(d), dtype=c.dtype,
                       device=c.device), c)

    @staticmethod
    def average_energy(q):
        c = _mv_centered_second_moment(q)
        d = c.shape[-1]
        return 0.5 * (d * _LOG2PI + e_logdet(q["cov"])
                      + torch.einsum("...ij,...ji->...",
                                     e_inverse(q["cov"]), c))


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
    def message_to_rate(q):
        return GammaShapeRate(e_mean(q["shape"]) + 1.0, e_mean(q["out"]))

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


_e_log_simplex = e_log_simplex


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
    """Resolves indexed interface rules by name: for each prefix of the
    class's ``_indexed`` (``mean``, ``prec`` by default: a mixture's
    ``mean0..meanK-1``, ``prec0..precK-1``; ``in`` for the sum nodes'
    ``in0..``), ``message_to_<prefix>{i}`` is the class's
    ``_message_to_<prefix>_i(q, i)``."""

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


# -- count likelihoods ----------------------------------------------------------------

def _lgamma1(x):
    """log Gamma(x + 1) of counts (data), in float64 and then rounded once:
    a log-coefficient such as lgamma(n + 1) - lgamma(y + 1) - lgamma(n - y
    + 1) cancels terms of order n log n, which float32 would leave at the
    1e-4 level of a free energy for trial counts in the hundreds (the JAX
    package evaluates it in float32)."""
    return torch.lgamma(x.double() + 1.0)


@node("Binomial")
class BinomialNode:
    """out ~ Binomial(n, p) with a known trial count n."""

    interfaces = ("out", "n", "p")

    @staticmethod
    def message_to_p(q):
        y, n = e_mean(q["out"]), e_mean(q["n"])
        return Beta(1.0 + y, 1.0 + n - y)

    @staticmethod
    def average_energy(q):
        y, n = e_mean(q["out"]), e_mean(q["n"])
        coeff = (_lgamma1(n) - _lgamma1(y) - _lgamma1(n - y)).to(y.dtype)
        return -(coeff + y * e_log(q["p"])
                 + (n - y) * e_mirrorlog(q["p"]))


@node("Poisson")
class PoissonNode:
    interfaces = ("out", "rate")

    @staticmethod
    def message_to_out(q):
        return Poisson(torch.exp(e_log(q["rate"])))

    @staticmethod
    def message_to_rate(q):
        y = e_mean(q["out"])
        return GammaShapeRate(1.0 + y, torch.ones_like(y))

    @staticmethod
    def average_energy(q):
        y = e_mean(q["out"])
        return (e_mean(q["rate"]) - y * e_log(q["rate"])
                + _lgamma1(y).to(y.dtype))


@node("Multinomial")
class MultinomialNode:
    """out ~ Multinomial(n, p): counts (..., K), the simplex p."""

    interfaces = ("out", "n", "p")

    @staticmethod
    def message_to_p(q):
        return Dirichlet(1.0 + e_mean(q["out"]))

    @staticmethod
    def average_energy(q):
        counts = e_mean(q["out"])
        n = e_mean(q["n"])
        coeff = (_lgamma1(n) - torch.sum(_lgamma1(counts), dim=-1)).to(
            counts.dtype)
        return -(coeff + torch.sum(counts * e_log_simplex(q["p"]), dim=-1))


# -- scale and variance priors -----------------------------------------------------

@node("GammaShapeScale")
class GammaShapeScaleNode:
    interfaces = ("out", "shape", "scale")

    @staticmethod
    def message_to_out(q):
        return GammaShapeScale(e_mean(q["shape"]), e_mean(q["scale"]))

    @staticmethod
    def average_energy(q):
        a = e_mean(q["shape"])
        th = e_mean(q["scale"])
        return -((a - 1.0) * e_log(q["out"]) - e_mean(q["out"]) / th
                 - a * torch.log(th) - torch.lgamma(a))


@node("InverseGamma")
class InverseGammaNode:
    interfaces = ("out", "shape", "scale")

    @staticmethod
    def message_to_out(q):
        return InverseGamma(e_mean(q["shape"]), e_mean(q["scale"]))

    @staticmethod
    def average_energy(q):
        a, b = e_mean(q["shape"]), e_mean(q["scale"])
        return -(a * torch.log(b) - torch.lgamma(a)
                 - (a + 1.0) * e_log(q["out"]) - b * e_inv_scalar(q["out"]))


@node("InverseWishart")
class InverseWishartNode:
    interfaces = ("out", "nu", "Psi")

    @staticmethod
    def message_to_out(q):
        psi = q["Psi"]
        return InverseWishart(
            e_mean(q["nu"]),
            psi.point if isinstance(psi, PointMass) else e_mean(psi))

    @staticmethod
    def average_energy(q):
        nu = e_mean(q["nu"])
        psi = q["Psi"]
        psi = psi.point if isinstance(psi, PointMass) else e_mean(psi)
        d = psi.shape[-1]
        return -(-0.5 * (nu + d + 1.0) * e_logdet(q["out"])
                 - 0.5 * torch.einsum("...ij,...ji->...", psi,
                                      e_inverse(q["out"]))
                 + 0.5 * nu * pd_logdet(psi)
                 - 0.5 * nu * d * _LOG2
                 - _mv_gammaln(d, 0.5 * nu))


@node("Uniform")
class UniformNode:
    interfaces = ("out", "lo", "hi")

    @staticmethod
    def message_to_out(q):
        return Uniform(e_mean(q["lo"]), e_mean(q["hi"]))

    @staticmethod
    def average_energy(q):
        return torch.log(e_mean(q["hi"]) - e_mean(q["lo"]))


@node("Uninformative")
class UninformativeNode:
    """Flat prior: the Gaussian message of precision 1e-12."""

    interfaces = ("out",)

    @staticmethod
    def message_to_out(q):
        del q
        return NormalWeightedMeanPrecision(torch.tensor(0.0),
                                           torch.tensor(1e-12))

    @staticmethod
    def average_energy(q):
        return torch.zeros_like(e_mean(q["out"]))


# -- scale-precision Gaussian ---------------------------------------------------------

@node("MvNormalMeanScalePrecision")
class MvNormalMeanScalePrecisionNode:
    """out ~ N(mean, (gamma I)^-1) with a scalar precision gamma."""

    interfaces = ("out", "mean", "gamma")

    @staticmethod
    def message_to_out(q):
        return MvNormalMeanScalePrecision(e_mean(q["mean"]),
                                          e_precision(q["gamma"]))

    @staticmethod
    def message_to_mean(q):
        return MvNormalMeanScalePrecision(e_mean(q["out"]),
                                          e_precision(q["gamma"]))

    @staticmethod
    def message_to_gamma(q):
        c = _mv_centered_second_moment(q)
        d = c.shape[-1]
        tr = torch.einsum("...ii->...", c)
        return GammaShapeRate(torch.full_like(tr, 1.0 + 0.5 * d), 0.5 * tr)

    @staticmethod
    def average_energy(q):
        c = _mv_centered_second_moment(q)
        d = c.shape[-1]
        tr = torch.einsum("...ii->...", c)
        return 0.5 * (d * _LOG2PI - d * e_log_precision(q["gamma"])
                      + e_precision(q["gamma"]) * tr)


# -- sums of random variables ---------------------------------------------------------

def _in_terms(q) -> list:
    return sorted((k for k in q if k.startswith("in") and k[2:].isdigit()),
                  key=lambda k: int(k[2:]))


def _mv_vec(m, x):
    return torch.einsum("...ij,...j->...i", m, x)


def _sym(m):
    return 0.5 * (m + m.transpose(-1, -2))


@node("Sum")
class SumNode(metaclass=_ComponentRules):
    """Deterministic sum out = sum_i in_i of Gaussian variables (the
    reference's ``+`` node).  It passes messages, not marginals: its cavity
    store divides out its previous messages (``uses_cavity``; exact BP on a
    tree).  Messages combine in natural form, conv((xi1, W1), (xi2, W2)) =
    (W2 S xi1 + W1 S xi2, W1 S W2), S = (W1 + W2)^-1: finite whenever the
    pair is jointly informative, even if one side is flat or rank-deficient.
    A point-mass term is an exact shift."""

    uses_cavity = True
    _indexed = ("in",)   # message_to_in{i} -> _message_to_in_i(q, i)

    @staticmethod
    def _nat(d):
        """(xi, W, vector?) of a Gaussian carrier."""
        if isinstance(d, AbstractMvNormal):
            f = as_mv_weighted_mean_precision(d)
            return f.xi, f.w, True
        f = as_weighted_mean_precision(d)
        return f.xi, f.w, False

    @staticmethod
    def _conv(n1, n2, mv: bool):
        from ..ops.smallmat import small_solve

        (xi1, w1), (xi2, w2) = n1, n2
        s = w1 + w2
        if mv:
            a1 = small_solve(s, xi1, matrix=False)
            a2 = small_solve(s, xi2, matrix=False)
            sw2 = small_solve(s, w2, matrix=True)
            return _mv_vec(w2, a1) + _mv_vec(w1, a2), w1 @ sw2
        return (w2 * xi1 + w1 * xi2) / s, w1 * w2 / s

    @classmethod
    def _conv_terms(cls, q, keys):
        """The convolution of the listed terms' Gaussian messages (None when
        every term is a point mass), the point masses' total shift, and
        whether the terms are vectors."""
        shift, nat, mv = None, None, False
        for k in keys:
            d = q[k]
            if isinstance(d, PointMass):
                shift = d.point if shift is None else shift + d.point
                continue
            xi, w, is_mv = cls._nat(d)
            mv = mv or is_mv
            nat = (xi, w) if nat is None else cls._conv(nat, (xi, w), is_mv)
        return nat, shift, mv

    @staticmethod
    def _shifted(xi, w, shift, mv: bool, sign: float = 1.0):
        if shift is None:
            return xi
        return xi + sign * (_mv_vec(w, shift) if mv else w * shift)

    @staticmethod
    def _gauss(xi, w, mv: bool):
        return (MvNormalWeightedMeanPrecision(xi, w) if mv
                else NormalWeightedMeanPrecision(xi, w))

    @classmethod
    def message_to_out(cls, q):
        nat, shift, mv = cls._conv_terms(q, _in_terms(q))
        if nat is None:
            return PointMass(shift)
        xi, w = nat
        return cls._gauss(cls._shifted(xi, w, shift, mv), w, mv)

    @classmethod
    def _message_to_in_i(cls, q, i: int):
        # in_i = out - sum(others): the others' convolution negated, then
        # convolved with the out cavity
        keys = [k for k in _in_terms(q) if k != f"in{i}"]
        nat_o, shift_o, mv = cls._conv_terms(q, keys)
        out = q["out"]
        if isinstance(out, PointMass):
            delta = out.point if shift_o is None else out.point - shift_o
            if nat_o is None:
                return PointMass(delta)
            w = nat_o[1]
            return cls._gauss(cls._shifted(-nat_o[0], w, delta, mv), w, mv)
        xi_out, w_out, out_mv = cls._nat(out)
        mv = mv or out_mv
        if nat_o is None:
            return cls._gauss(cls._shifted(xi_out, w_out, shift_o, mv, -1.0),
                              w_out, mv)
        xi, w = cls._conv((xi_out, w_out), (-nat_o[0], nat_o[1]), mv)
        return cls._gauss(cls._shifted(xi, w, shift_o, mv, -1.0), w, mv)

    @classmethod
    def bethe_term(cls, q):
        """-H[q(in_1..in_k)] of the joint belief over the inputs from their
        cavity messages: q(ins) proportional to prod N(x_i; cav_i) m_out(sum
        x_i).  A random out's cavity N(., W_out) gives the joint precision
        J = blockdiag(W_i) + (1 1^T) (x) W_out, finite when the out cavity is
        rank-deficient; an observed out constrains the inputs to the
        hyperplane sum x = y, a (k - 1) d-dimensional Gaussian.  On a tree
        the free energy is then -log Z."""
        keys = [k for k in _in_terms(q) if not isinstance(q[k], PointMass)]
        k = len(keys)
        mv = isinstance(q[keys[0]], AbstractMvNormal)
        if isinstance(q["out"], PointMass):
            if not mv:
                vs = [e_var(q[kk]) for kk in keys]
                return -0.5 * (k - 1) * _LOG2PIE + 0.5 * (
                    -sum(torch.log(v) for v in vs) + torch.log(sum(vs)))
            covs = [e_cov(q[kk]) for kk in keys]
            d = covs[0].shape[-1]
            return -0.5 * (k - 1) * d * _LOG2PIE + 0.5 * (
                -sum(pd_logdet(v) for v in covs) + pd_logdet(sum(covs)))
        ws = [cls._nat(q[kk])[1] for kk in keys]
        w_out = cls._nat(q["out"])[1]
        if not mv:
            ws = torch.broadcast_tensors(*ws, w_out)
            jmat = (torch.diag_embed(torch.stack(ws[:-1], dim=-1))
                    + ws[-1][..., None, None])
            d = 1
        else:
            ws = torch.broadcast_tensors(*ws, w_out)
            d = ws[0].shape[-1]
            blocks = [[ws[-1] + (ws[i] if i == j else 0.0)
                       for j in range(k)] for i in range(k)]
            jmat = torch.cat([torch.cat(row, dim=-1) for row in blocks],
                             dim=-2)
        return -0.5 * k * d * _LOG2PIE + 0.5 * torch.linalg.slogdet(jmat)[1]


def _rank_of(d):
    """Event rank of a Gaussian carrier (1 vector, 0 scalar); None for a
    point mass, whose batched point does not tell."""
    if isinstance(d, AbstractMvNormal):
        return 1
    if isinstance(d, AbstractNormal):
        return 0
    return None


@node("LinComb")
class LinCombNode(metaclass=_ComponentRules):
    """Deterministic linear combination out = sum_i A_i in_i + b of random
    vectors or scalars with known maps A_i (constants: a scalar multiplier,
    a row vector into a scalar out, a column vector lifting a scalar in, or
    a matrix) and a known b (the reference's composed ``*`` and ``+``
    deterministic nodes, ``x[t+1] ~ A * x[t] + B * u[t]``).  Exact BP with
    the cavity store (``uses_cavity``): forward, the cavity moments pushed
    through the maps; backward, the out cavity convolved with the other
    terms by W' = (I + W V_o)^-1 W (finite for a rank-deficient out cavity,
    by ``ops/smallmat.py``'s solves), pulled back through A_i^T (proper for
    a tall, non-invertible A_i too)."""

    uses_cavity = True
    _indexed = ("in",)

    @staticmethod
    def _amat(q, k, d_out):
        a = q[f"A{k[2:]}"].point
        if a.ndim == 0:     # a scalar multiplier on the shared space
            return a * torch.eye(d_out, dtype=a.dtype, device=a.device)
        if a.ndim == 1:
            # a row vector into a scalar out, or a column lifting a scalar
            return a[None, :] if d_out == 1 else a[:, None]
        return a

    @classmethod
    def _out_dim(cls, q) -> int:
        for k in q:
            if k.startswith("A") and k[1:].isdigit():
                a = q[k].point
                if a.ndim == 2:
                    return a.shape[0]
                if a.ndim == 1:
                    return 1
        for k in ["out"] + _in_terms(q):
            d = q.get(k)
            r = _rank_of(d) if d is not None else None
            if r == 1:
                return e_mean(d).shape[-1]
            if r == 0:
                return 1
        return 1

    @staticmethod
    def _moments_vec(d, d_in: int):
        """(mean (..., d_in), cov (..., d_in, d_in)) of one term."""
        m = e_mean(d)
        if _rank_of(d) == 1 or (_rank_of(d) is None and d_in > 1):
            return m, e_cov(d)
        return m[..., None], e_var(d)[..., None, None]

    @classmethod
    def _others(cls, q, skip=None):
        """Moments of sum_{i != skip} A_i in_i + b in the out space."""
        d_o = cls._out_dim(q)
        # the maps are constants: their device and dtype are the batch's
        like = next(v.point for k, v in q.items()
                    if k.startswith("A") and k[1:].isdigit())
        m = like.new_zeros((d_o,))
        b_q = q.get("b")
        if isinstance(b_q, PointMass):
            m = m + b_q.point
        v = like.new_zeros((d_o, d_o))
        for k in _in_terms(q):
            if k == skip:
                continue
            a = cls._amat(q, k, d_o)
            mi, vi = cls._moments_vec(q[k], a.shape[-1])
            m = m + _mv_vec(a, mi)
            v = v + a @ vi @ a.transpose(-1, -2)
        return m, v

    @classmethod
    def message_to_out(cls, q):
        m, v = cls._others(q)
        if m.shape[-1] == 1:
            return NormalMeanVariance(m[..., 0], v[..., 0, 0])
        return MvNormalMeanCovariance(m, _sym(v))

    @classmethod
    def _message_to_in_i(cls, q, i: int):
        from ..ops.smallmat import small_inv, small_solve

        d_o = cls._out_dim(q)
        out = q["out"]
        m_o, v_o = cls._others(q, skip=f"in{i}")
        a = cls._amat(q, f"in{i}", d_o)
        eye = torch.eye(d_o, dtype=v_o.dtype, device=v_o.device)
        if isinstance(out, PointMass):
            # an observed combination: the residual uncertainty is the
            # others' spread (a tiny ridge keeps a lone term invertible)
            p = out.point if d_o > 1 else out.point[..., None]
            w_t = small_inv(v_o + 1e-10 * eye)
            xi_t = _mv_vec(w_t, p - m_o)
        else:
            if _rank_of(out) == 1:
                f = as_mv_weighted_mean_precision(out)
                xi_c, w_c = f.xi, f.w
            else:
                f = as_weighted_mean_precision(out)
                xi_c, w_c = f.xi[..., None], f.w[..., None, None]
            # convolution with the others (their mean shift negated):
            # W' = (I + W V_o)^-1 W, xi' = (I + W V_o)^-1 (xi - W m_o)
            g = eye + w_c @ v_o
            w_t = small_solve(g, w_c, matrix=True)
            xi_t = small_solve(g, xi_c - _mv_vec(w_c, m_o), matrix=False)
        at = a.transpose(-1, -2)
        w_i = at @ w_t @ a
        xi_i = _mv_vec(at, xi_t)
        if a.shape[-1] == 1:
            return NormalWeightedMeanPrecision(xi_i[..., 0], w_i[..., 0, 0])
        return MvNormalWeightedMeanPrecision(xi_i, _sym(w_i))

    @classmethod
    def bethe_term(cls, q):
        """-H[q(in_1..in_k)] of the joint belief over the random inputs,
        q(ins) proportional to prod N(x_i; cav_i) m_out(sum A_i x_i + b):
        joint precision J = blockdiag(W_i) + A^T W_out A with A = [A_1 ..
        A_k], so that on a tree the free energy is -log Z.  (The JAX
        package's LinComb has no free-energy term.)  An observed out is
        refused: the inputs' belief then lives on an affine subspace whose
        measure the maps' parametrization sets."""
        if isinstance(q["out"], PointMass):
            raise NotImplementedError(
                "free_energy=True: a LinComb node with an observed out has "
                "no Bethe term in the PyTorch package (nor in the JAX one).")
        d_o = cls._out_dim(q)
        keys = [k for k in _in_terms(q) if not isinstance(q[k], PointMass)]
        if _rank_of(q["out"]) == 1:
            w_out = as_mv_weighted_mean_precision(q["out"]).w
        else:
            w_out = as_weighted_mean_precision(q["out"]).w[..., None, None]
        amats, ws = [], []
        for k in keys:
            a = cls._amat(q, k, d_o)
            amats.append(a)
            if a.shape[-1] == 1 and _rank_of(q[k]) == 0:
                ws.append(as_weighted_mean_precision(q[k]).w[..., None, None])
            else:
                ws.append(as_mv_weighted_mean_precision(q[k]).w)
        a_all = torch.cat(amats, dim=-1)
        jmat = a_all.transpose(-1, -2) @ w_out @ a_all
        dims = [a.shape[-1] for a in amats]
        lead = torch.broadcast_shapes(jmat.shape[:-2],
                                      *[w.shape[:-2] for w in ws])
        jmat = jmat.expand(lead + jmat.shape[-2:]).clone()
        off = 0
        for w, n in zip(ws, dims):
            jmat[..., off:off + n, off:off + n] += w
            off += n
        total = sum(dims)
        return (-0.5 * total * _LOG2PIE
                + 0.5 * torch.linalg.slogdet(jmat)[1])


class _GaussianSumScalarBase(metaclass=_ComponentRules):
    """out ~ N(sum_i in_i, noise): ``Normal(mean=a + b, ...)`` with random
    terms, contracted at trace time (exact BP messages and a well-defined
    average energy, where a standalone ``Sum`` has only its Bethe term)."""

    uses_cavity = True
    _indexed = ("in",)

    @staticmethod
    def _noise_var(q):
        if "var" in q:
            return e_mean(q["var"])
        return 1.0 / e_precision(q["prec"])

    @classmethod
    def message_to_out(cls, q):
        keys = _in_terms(q)
        m = sum(e_mean(q[k]) for k in keys)
        v = sum(e_var(q[k]) for k in keys) + cls._noise_var(q)
        return NormalMeanVariance(m, v)

    @classmethod
    def _message_to_in_i(cls, q, i: int):
        others = [k for k in _in_terms(q) if k != f"in{i}"]
        m = e_mean(q["out"]) - sum(e_mean(q[k]) for k in others)
        v = (e_var(q["out"]) + sum(e_var(q[k]) for k in others)
             + cls._noise_var(q))
        return NormalMeanVariance(m, v)

    @classmethod
    def _c2(cls, q):
        keys = _in_terms(q)
        diff = e_mean(q["out"]) - sum(e_mean(q[k]) for k in keys)
        return e_var(q["out"]) + sum(e_var(q[k]) for k in keys) + diff * diff

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


@node("GaussianSumCovariance")
class GaussianSumCovarianceNode(_GaussianSumScalarBase):
    pass


@node("GaussianSumPrecision")
class GaussianSumPrecisionNode(_GaussianSumScalarBase):
    @classmethod
    def message_to_prec(cls, q):
        c2 = cls._c2(q)
        return GammaShapeRate(torch.full_like(c2, 1.5), 0.5 * c2)


class _MvGaussianSumBase(metaclass=_ComponentRules):
    """The multivariate ``MvNormal(mean=a + b, ...)`` contraction."""

    uses_cavity = True
    _indexed = ("in",)

    @classmethod
    def message_to_out(cls, q):
        keys = _in_terms(q)
        m = sum(e_mean(q[k]) for k in keys)
        v = sum(e_cov(q[k]) for k in keys) + _lg_noise_cov(q)
        return MvNormalMeanCovariance(m, v)

    @classmethod
    def _message_to_in_i(cls, q, i: int):
        others = [k for k in _in_terms(q) if k != f"in{i}"]
        m = e_mean(q["out"]) - sum(e_mean(q[k]) for k in others)
        v = (e_cov(q["out"]) + sum(e_cov(q[k]) for k in others)
             + _lg_noise_cov(q))
        return MvNormalMeanCovariance(m, v)

    @classmethod
    def _centered_second_moment(cls, q):
        keys = _in_terms(q)
        diff = e_mean(q["out"]) - sum(e_mean(q[k]) for k in keys)
        return (e_cov(q["out"]) + sum(e_cov(q[k]) for k in keys)
                + diff[..., None] * diff[..., None, :])

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


@node("MvGaussianSumCovariance")
class MvGaussianSumCovarianceNode(_MvGaussianSumBase):
    pass


@node("MvGaussianSumPrecision")
class MvGaussianSumPrecisionNode(_MvGaussianSumBase):
    @classmethod
    def message_to_prec(cls, q):
        c = cls._centered_second_moment(q)
        d = c.shape[-1]
        return WishartInverseScale(
            torch.full(c.shape[:-2], float(d) + 2.0, dtype=c.dtype,
                       device=c.device), c)
