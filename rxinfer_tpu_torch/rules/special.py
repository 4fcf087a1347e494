"""The ``Probit``, ``GammaMixture``, ``SoftDot`` and generic ``Mixture``
nodes and the Gauss-Hermite quadrature (counterpart of
``rxinfer_tpu/rules/special.py``)."""

from __future__ import annotations

import numpy as np
import torch

from ..dists import (
    Bernoulli,
    BernoulliLogits,
    Categorical,
    GammaShapeRate,
    MvNormalWeightedMeanPrecision,
    NormalMeanPrecision,
    NormalWeightedMeanPrecision,
)
from ..dists.mixture import MixtureDist
from ..dists.natural import family_key, from_natural, log_partition, to_natural
from .expectations import (
    e_cov,
    e_log,
    e_log_precision,
    e_mean,
    e_precision,
    e_sq,
    e_var,
)
from .nodes import _ComponentRules
from .registry import node

_GH_POINTS = 31
_GH_NODES: dict = {}


def gauss_hermite_nodes(n: int, device) -> tuple:
    """The ``n`` probabilists' Gauss-Hermite nodes and their weights,
    normalized to sum to one, as float32 tensors on ``device``: computed by
    numpy once per (n, device) and kept, so a rule never copies them from
    the host again."""
    key = (n, str(torch.device(device)))
    hit = _GH_NODES.get(key)
    if hit is None:
        x, w = np.polynomial.hermite_e.hermegauss(n)
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        w = torch.as_tensor(w, dtype=torch.float32, device=device)
        hit = _GH_NODES[key] = (x, w / torch.sum(w))
    return hit


def _gauss_hermite(fn, m, v, n: int = _GH_POINTS):
    """E[fn(x)] under N(m, v) by ``n``-point Gauss-Hermite quadrature (the
    reference's GaussHermiteCubature meta); ``m`` and ``v`` broadcast."""
    x, w = gauss_hermite_nodes(n, m.device)
    pts = m[..., None] + torch.sqrt(v)[..., None] * x
    return torch.sum(w * fn(pts), dim=-1)


@node("Probit")
class ProbitNode:
    """out in {0, 1} ~ Bernoulli(Phi(in)) with a Gaussian in.  The message to
    in is EP moment matching: the closed-form tilted moments of
    N(x; m, v) Phi(s x), divided by the marginal (so the rule reads its own
    marginal, ``needs_self_marginal``)."""

    interfaces = ("out", "in")
    needs_self_marginal = True

    @staticmethod
    def message_to_out(q):
        m, v = e_mean(q["in"]), e_var(q["in"])
        p = torch.special.ndtr(m / torch.sqrt(1.0 + v))
        return Bernoulli(torch.clamp(p, 1e-7, 1 - 1e-7))

    @staticmethod
    def message_to_in(q):
        s = 2.0 * e_mean(q["out"]) - 1.0
        m, v = e_mean(q["in"]), e_var(q["in"])
        denom = torch.sqrt(1.0 + v)
        z = s * m / denom
        # phi(z) / Phi(z), stable through log Phi
        log_npdf = -0.5 * (z * z) - 0.9189385332046727
        ratio = torch.exp(log_npdf - torch.special.log_ndtr(z))
        mt = m + s * v * ratio / denom
        vt = torch.clamp(v - (v * v) * ratio * (z + ratio) / (1.0 + v),
                         min=1e-10)
        # the message: tilted / marginal, in natural parameters
        return NormalWeightedMeanPrecision(mt / vt - m / v, 1.0 / vt - 1.0 / v)

    @staticmethod
    def average_energy(q):
        s = 2.0 * e_mean(q["out"]) - 1.0
        m, v = e_mean(q["in"]), e_var(q["in"])
        m, v, s = torch.broadcast_tensors(m, v, s)
        return -_gauss_hermite(
            lambda x: torch.special.log_ndtr(s[..., None] * x), m, v)


@node("GammaMixture")
class GammaMixtureNode(metaclass=_ComponentRules):
    """out ~ prod_k Gamma(out; a_k, b_k)^{s_k}: interfaces out, switch,
    shape0..shapeK-1, rate0..rateK-1 (mean-field VMP)."""

    _indexed = ("rate",)

    @staticmethod
    def _k(q):
        return sum(1 for key in q if key.startswith("shape"))

    @classmethod
    def message_to_out(cls, q):
        r = q["switch"].mean()
        k = cls._k(q)
        shape = sum(r[..., i] * (e_mean(q[f"shape{i}"]) - 1.0)
                    for i in range(k)) + 1.0
        rate = sum(r[..., i] * e_mean(q[f"rate{i}"]) for i in range(k))
        return GammaShapeRate(shape, rate)

    @classmethod
    def message_to_switch(cls, q):
        logits = []
        for i in range(cls._k(q)):
            a = e_mean(q[f"shape{i}"])
            logits.append((a - 1.0) * e_log(q["out"])
                          - e_mean(q[f"rate{i}"]) * e_mean(q["out"])
                          + a * e_log(q[f"rate{i}"]) - torch.lgamma(a))
        return Categorical(torch.stack(logits, dim=-1))

    @staticmethod
    def _message_to_rate_i(q, i: int):
        r = q["switch"].mean()[..., i]
        a = e_mean(q[f"shape{i}"])
        return GammaShapeRate(r * a + 1.0, r * e_mean(q["out"]))

    @classmethod
    def average_energy(cls, q):
        r = q["switch"].mean()
        total = 0.0
        for i in range(cls._k(q)):
            a = e_mean(q[f"shape{i}"])
            total = total + r[..., i] * (
                -(a - 1.0) * e_log(q["out"])
                + e_mean(q[f"rate{i}"]) * e_mean(q["out"])
                - a * e_log(q[f"rate{i}"]) + torch.lgamma(a))
        return total


@node("SoftDot")
class SoftDotNode:
    """out ~ N(theta^T x, 1 / gamma) with theta and x both random (the
    soft inner product of time-varying regression): mean-field VMP."""

    interfaces = ("out", "theta", "x", "gamma")

    @staticmethod
    def _outer(d):
        m = e_mean(d)
        return e_cov(d) + m[..., None] * m[..., None, :], m

    @classmethod
    def message_to_out(cls, q):
        mean = torch.sum(e_mean(q["theta"]) * e_mean(q["x"]), dim=-1)
        mean, w = torch.broadcast_tensors(mean, e_precision(q["gamma"]))
        return NormalMeanPrecision(mean, w)

    @classmethod
    def message_to_theta(cls, q):
        g = e_precision(q["gamma"])
        xx, mx = cls._outer(q["x"])
        y = e_mean(q["out"])
        return MvNormalWeightedMeanPrecision(
            (g * y)[..., None] * mx, g[..., None, None] * xx)

    @classmethod
    def message_to_x(cls, q):
        g = e_precision(q["gamma"])
        tt, mt = cls._outer(q["theta"])
        y = e_mean(q["out"])
        return MvNormalWeightedMeanPrecision(
            (g * y)[..., None] * mt, g[..., None, None] * tt)

    @classmethod
    def _c2(cls, q):
        tt, mt = cls._outer(q["theta"])
        xx, mx = cls._outer(q["x"])
        y = e_mean(q["out"])
        return (e_sq(q["out"]) - 2.0 * y * torch.sum(mt * mx, dim=-1)
                + torch.sum(tt * xx.transpose(-1, -2), dim=(-2, -1)))

    @classmethod
    def message_to_gamma(cls, q):
        c2 = cls._c2(q)
        return GammaShapeRate(torch.full_like(c2, 1.5), 0.5 * c2)

    @classmethod
    def average_energy(cls, q):
        g = e_precision(q["gamma"])
        return 0.5 * (1.8378770664093453 - e_log_precision(q["gamma"])
                      + g * cls._c2(q))


@node("Mixture")
class MixtureNode(metaclass=_ComponentRules):
    """Generic family-agnostic mixture: out = comp_{switch}.  A
    belief-propagation node (``uses_cavity``: each rule sees the inbound
    MESSAGES on its other edges, the marginal divided by this node's last
    message there, ``engine/blocks.py`` ``PlainGroup.update``):

      to out    -- ``MixtureDist(the switch message's weights, the
                   components' messages)``: its product with the likelihood
                   distributes over the components, so q(out) is a mixture
                   whose component k is the model with component k alone and
                   whose weights are the switch's posterior;
      to comp_k -- the out edge's message (q(comp_k) = prior_k x m_out);
      to switch -- each component's log-evidence A(eta_k + eta_out) -
                   A(eta_k).

    No average energy: evidence and Bayes factors come from
    ``LogScaleAnnotations`` (``engine/logscale.py``), and ``free_energy=True``
    from its exact evidence (``inference._composed_mixture_fe``)."""

    uses_cavity = True
    _indexed = ("comp",)

    @staticmethod
    def _k(q):
        return sum(1 for key in q if key.startswith("comp"))

    @staticmethod
    def _switch_logw(d):
        """Normalized (K,) log-weights of a Categorical or Bernoulli switch
        message (a Bernoulli as [log(1 - p), log p])."""
        if isinstance(d, (Bernoulli, BernoulliLogits)):
            logit = to_natural(d)[0]
            sp = torch.nn.functional.softplus
            return torch.stack([-sp(logit), -sp(-logit)], dim=-1)
        return torch.log_softmax(d.logits, dim=-1)

    @staticmethod
    def _require_plain(d, edge):
        if isinstance(d, MixtureDist):
            raise TypeError(
                f"Mixture node: the {edge} edge carries a mixture-valued "
                "message where a plain conjugate message is required; "
                "initialize the mixture output with a plain (single-family) "
                "distribution.")
        # the natural carrier: one class for a message whatever it came as
        return from_natural(family_key(d), to_natural(d))

    @classmethod
    def message_to_out(cls, q):
        comps = tuple(cls._require_plain(q[f"comp{i}"], f"comp{i}")
                      for i in range(cls._k(q)))
        return MixtureDist(cls._switch_logw(q["switch"]), comps)

    @classmethod
    def message_to_switch(cls, q):
        out = cls._require_plain(q["out"], "out")
        fam = family_key(out)
        eta_out = to_natural(out)
        logits = []
        for i in range(cls._k(q)):
            eta_k = to_natural(q[f"comp{i}"])
            eta = tuple(a + b for a, b in zip(eta_k, eta_out))
            logits.append(log_partition(fam, eta) - log_partition(fam, eta_k))
        # a Categorical carrier, coerced to a Bernoulli where the switch
        # group is one (natural.coerce_message_family)
        return Categorical(torch.stack(logits, dim=-1))

    @classmethod
    def _message_to_comp_i(cls, q, i: int):
        del i   # every component receives the out edge's message
        return cls._require_plain(q["out"], "out")

    @staticmethod
    def average_energy(q):
        raise NotImplementedError(
            "free_energy=True is not supported with the generic Mixture node "
            "— it is a belief-propagation selection factor with no average "
            "energy (reference parity: mixture models use "
            "annotations=LogScaleAnnotations() for evidence / Bayes factors; "
            "VMP mixtures use NormalMixture/GammaMixture instead).")
