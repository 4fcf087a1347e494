"""Natural-parameter views: products, plate reductions and padding
(counterpart of ``rxinfer_tpu/dists/natural.py``).

For every family ``prod(d1, d2) == from_natural(to_natural(d1) +
to_natural(d2))`` and the ZERO natural vector is the multiplicative identity.
The ``gaussian``, ``mv_gaussian``, ``beta``, ``bernoulli``,
``categorical``, ``dirichlet``, ``dirichlet_collection``, ``gamma`` (any
Gamma parametrization, read as (shape, rate)), ``inverse_gamma``,
``wishart``, ``inverse_wishart`` and ``poisson`` families, ``prod_all``,
``nat_div``, ``prod_reduce``, ``pad_plate``, the grid factors'
``broadcast_batch`` and ``prod_reduce_axes``, ``NAT_EVENT_RANKS``, and for
the generic ``Mixture`` ``log_partition``, ``logpdf``, the mixture products
and divisions and ``coerce_message_family``.  The
``wishart`` view keeps the inverse-scale carrier: one observation's
natural matrix is singular, so only an aggregated posterior is converted
back to a ``Wishart`` (``WishartInverseScale.to_wishart``).

Batch axes.  The JAX package evaluates a plain group's messages per dataset
under ``vmap``, so a message leaf there is (plate..., event...).  The port
evaluates them over the whole batch at once: a leaf is (batch..., plate...,
event...), and ``prod_reduce`` / ``pad_plate`` take ``batch_ndim``, the
number of leading batch axes a batched leaf carries (0 gives the JAX
package's behaviour).  A leaf may lack the batch axis (a message computed
from constants only) and it may lack the plate axis (a message shared by
every plate copy); ``NAT_EVENT_RANKS`` tells them apart.
"""

from __future__ import annotations

import math

import torch

from .base import Distribution, ProductError
from .discrete import Categorical, Dirichlet, DirichletCollection
from .gaussian import (
    AbstractMvNormal,
    AbstractNormal,
    MvNormalWeightedMeanPrecision,
    NormalWeightedMeanPrecision,
    as_mv_weighted_mean_precision,
    as_weighted_mean_precision,
    pd_inverse,
)
from .matrix import InverseWishart, Wishart, WishartInverseScale
from .scalar_families import (
    AbstractGamma,
    Bernoulli,
    BernoulliLogits,
    Beta,
    GammaShapeRate,
    InverseGamma,
    Poisson,
)


def _gauss_to(d):
    f = as_weighted_mean_precision(d)
    return (f.xi, f.w)


def _mv_gauss_to(d):
    f = as_mv_weighted_mean_precision(d)
    return (f.xi, f.w)


_TABLE = {
    "gaussian": (_gauss_to, lambda n: NormalWeightedMeanPrecision(n[0], n[1])),
    "mv_gaussian": (_mv_gauss_to,
                    lambda n: MvNormalWeightedMeanPrecision(n[0], n[1])),
    "beta": (lambda d: (d.a - 1.0, d.b - 1.0),
             lambda n: Beta(n[0] + 1.0, n[1] + 1.0)),
    "bernoulli": (lambda d: ((d.logit,) if isinstance(d, BernoulliLogits)
                             else (torch.log(d.p) - torch.log1p(-d.p),)),
                  lambda n: BernoulliLogits(n[0])),
    "dirichlet": (lambda d: (d.alpha - 1.0,),
                  lambda n: Dirichlet(n[0] + 1.0)),
    "dirichlet_collection": (lambda d: (d.alpha - 1.0,),
                             lambda n: DirichletCollection(n[0] + 1.0)),
    "categorical": (lambda d: (d.logits,), lambda n: Categorical(n[0])),
    "gamma": (lambda d: (d.shape_rate()[0] - 1.0, d.shape_rate()[1]),
              lambda n: GammaShapeRate(n[0] + 1.0, n[1])),
    "wishart": (
        lambda d: ((d.nu - d.s_inv.shape[-1] - 1.0, d.s_inv)
                   if isinstance(d, WishartInverseScale)
                   else (d.nu - d.s.shape[-1] - 1.0, pd_inverse(d.s))),
        lambda n: WishartInverseScale(n[0] + n[1].shape[-1] + 1.0, n[1])),
    "inverse_gamma": (lambda d: (d.a + 1.0, d.b),
                      lambda n: InverseGamma(n[0] - 1.0, n[1])),
    "inverse_wishart": (
        lambda d: (d.nu + d.psi.shape[-1] + 1.0, d.psi),
        lambda n: InverseWishart(n[0] - n[1].shape[-1] - 1.0, n[1])),
    "poisson": (lambda d: (torch.log(d.lam),),
                lambda n: Poisson(torch.exp(n[0]))),
}

# Event ranks of each family's natural-parameter leaves: they tell the batch
# and plate axes from the event axes when reducing or padding message batches.
NAT_EVENT_RANKS = {
    "gaussian": (0, 0),
    "mv_gaussian": (1, 2),
    "beta": (0, 0),
    "bernoulli": (0,),
    "dirichlet": (1,),
    "dirichlet_collection": (2,),
    "categorical": (1,),
    "gamma": (0, 0),
    "inverse_gamma": (0, 0),
    "wishart": (0, 2),
    "inverse_wishart": (0, 2),
    "poisson": (0,),
}


def family_key(d: Distribution) -> str:
    if isinstance(d, AbstractMvNormal):
        return "mv_gaussian"
    if isinstance(d, AbstractNormal):
        return "gaussian"
    if isinstance(d, Beta):
        return "beta"
    if isinstance(d, (Bernoulli, BernoulliLogits)):
        return "bernoulli"
    if isinstance(d, Dirichlet):
        return "dirichlet"
    if isinstance(d, DirichletCollection):
        return "dirichlet_collection"
    if isinstance(d, Categorical):
        return "categorical"
    if isinstance(d, AbstractGamma):
        return "gamma"
    if isinstance(d, InverseGamma):
        return "inverse_gamma"
    if isinstance(d, (Wishart, WishartInverseScale)):
        return "wishart"
    if isinstance(d, InverseWishart):
        return "inverse_wishart"
    if isinstance(d, Poisson):
        return "poisson"
    raise TypeError(f"No natural-parameter view for {type(d).__name__}")


def to_natural(d: Distribution) -> tuple:
    return tuple(_TABLE[family_key(d)][0](d))


def from_natural(key: str, nat) -> Distribution:
    return _TABLE[key][1](nat)


def _wrap_gamma(d):
    """A Gamma of any parametrization as ``GammaShapeRate`` (the natural
    view reads (shape, rate))."""
    if isinstance(d, AbstractGamma) and not isinstance(d, GammaShapeRate):
        return GammaShapeRate(*d.shape_rate())
    return d


def log_partition(family: str, nat: tuple):
    """A(eta) of a unit-base-measure family (over leading axes): the
    evidence of a product of normalized densities is A(sum eta) -
    sum A(eta_i).  Read by the log-scale pass (``engine/logscale.py``) and
    by mixture products."""
    if family == "gaussian":
        xi, w = nat
        return 0.5 * xi * xi / w + 0.5 * torch.log(2.0 * math.pi / w)
    if family == "mv_gaussian":
        xi, w = nat
        d = xi.shape[-1]
        sol = torch.linalg.solve(w, xi.unsqueeze(-1)).squeeze(-1)
        return (0.5 * torch.einsum("...i,...i->...", xi, sol)
                + 0.5 * (d * math.log(2.0 * math.pi)
                         - torch.linalg.slogdet(w)[1]))
    if family == "beta":
        a, b = nat[0] + 1.0, nat[1] + 1.0
        return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
    if family == "gamma":
        return torch.lgamma(nat[0] + 1.0) - (nat[0] + 1.0) * torch.log(nat[1])
    if family == "dirichlet":
        alpha = nat[0] + 1.0
        return torch.lgamma(alpha).sum(-1) - torch.lgamma(alpha.sum(-1))
    if family == "bernoulli":
        return torch.nn.functional.softplus(nat[0])
    if family == "categorical":
        return torch.logsumexp(nat[0], dim=-1)
    if family == "inverse_gamma":
        a = nat[0] - 1.0
        return torch.lgamma(a) - a * torch.log(nat[1])
    if family == "poisson":
        return torch.exp(nat[0])
    raise NotImplementedError(
        f"log_partition for family {family!r} is not available.")


def logpdf(d: Distribution, x):
    """log density of ``d`` at ``x``: <eta, T(x)> - A(eta) for the
    unit-base-measure families of ``log_partition`` (a mixture by its
    components; a Categorical's or Bernoulli's x may be its probabilities,
    a soft one-hot)."""
    if hasattr(d, "components"):
        return d.logpdf(x)
    key = family_key(d)
    nat = to_natural(_wrap_gamma(d) if key == "gamma" else d)
    x = torch.as_tensor(x, dtype=nat[0].dtype, device=nat[0].device)
    if key == "gaussian":
        stat = nat[0] * x - 0.5 * nat[1] * x * x
    elif key == "mv_gaussian":
        stat = (torch.einsum("...i,...i->...", nat[0], x)
                - 0.5 * torch.einsum("...i,...ij,...j->...", x, nat[1], x))
    elif key == "beta":
        stat = nat[0] * torch.log(x) + nat[1] * torch.log1p(-x)
    elif key == "gamma":
        stat = nat[0] * torch.log(x) - nat[1] * x
    elif key == "dirichlet":
        stat = (nat[0] * torch.log(x)).sum(-1)
    elif key == "bernoulli":
        stat = nat[0] * x
    elif key == "categorical":
        stat = (nat[0] * x).sum(-1)
    elif key == "inverse_gamma":
        stat = -nat[0] * torch.log(x) - nat[1] / x
    elif key == "poisson":
        # the base measure 1 / x! enters here
        stat = nat[0] * x - torch.lgamma(x + 1.0)
    else:
        raise NotImplementedError(f"logpdf for family {key!r}")
    return stat - log_partition(key, nat)


def _prod_mixture(mix, rest: list) -> Distribution:
    """A mixture message times same-family messages: the natural sum
    distributed over the components, each re-weighted by its evidence
    log w'_k = log w_k + A(eta_k + eta_rest) - A(eta_k) (the shared
    -A(eta_rest) cancels when normalized), so that the weights equal the
    switch's posterior."""
    from .mixture import MixtureDist

    if not rest:
        return mix
    fam = family_key(mix.components[0])
    plain = prod_all(rest)
    if family_key(plain) != fam:
        raise ProductError(
            f"Mixture message with {fam!r} components meets a "
            f"{family_key(plain)!r} message on one variable.")
    eta_rest = to_natural(plain)
    lw0 = torch.log_softmax(mix.log_weights, dim=-1)
    comps, lws = [], []
    for i, c in enumerate(mix.components):
        eta_k = to_natural(c)
        eta = tuple(a + b for a, b in zip(eta_k, eta_rest))
        comps.append(from_natural(fam, eta))
        lws.append(lw0[..., i] + log_partition(fam, eta)
                   - log_partition(fam, eta_k))
    return MixtureDist(torch.log_softmax(torch.stack(lws, dim=-1), dim=-1),
                       tuple(comps))


def coerce_message_family(d, family):
    """A two-class Categorical message as a Bernoulli (log-odds) where the
    receiving group is Bernoulli, and the converse, so that a generic
    ``Mixture`` meets either switch prior; otherwise ``d`` unchanged."""
    try:
        key = family_key(d)
    except TypeError:
        return d
    if family is None or key == family:
        return d
    if key == "categorical" and family == "bernoulli" \
            and d.logits.shape[-1] == 2:
        return BernoulliLogits(d.logits[..., 1] - d.logits[..., 0])
    if key == "bernoulli" and family == "categorical":
        logit = to_natural(d)[0]
        return Categorical(torch.stack([torch.zeros_like(logit), logit], -1))
    return d


def prod_all(dists: list) -> Distribution:
    """Product of same-family messages via natural-parameter addition; a
    point-mass message collapses the product, and one mixture message
    distributes it over its components (``_prod_mixture``)."""
    from .mixture import MixtureDist
    from .pointmass import PointMass

    points = [d for d in dists if isinstance(d, PointMass)]
    if points:
        return points[0]
    mixtures = [d for d in dists if isinstance(d, MixtureDist)]
    if mixtures:
        if len(mixtures) > 1:
            raise ProductError(
                "Product of two mixture messages on one variable is not "
                "supported (K² component blow-up); restructure the model so "
                "at most one Mixture node feeds each variable.")
        return _prod_mixture(mixtures[0], [d for d in dists
                                           if not isinstance(d, MixtureDist)])
    keys = [family_key(d) for d in dists]
    if any(k != keys[0] for k in keys):
        raise ProductError(
            f"Non-conjugate message product: families {sorted(set(keys))} "
            "meet on one variable."
        )
    nats = [to_natural(_wrap_gamma(d) if keys[0] == "gamma" else d)
            for d in dists]
    total = nats[0]
    for n in nats[1:]:
        total = tuple(a + b for a, b in zip(total, n))
    return from_natural(keys[0], total)


def nat_div(a: Distribution, b: Distribution) -> Distribution:
    """a / b by natural-parameter subtraction (the cavity of EP updates).
    A mixture marginal over the mixture message that formed it: every
    component is (the message's component + the same rest), so component
    0's difference is that rest."""
    from .mixture import MixtureDist

    if isinstance(a, MixtureDist) and isinstance(b, MixtureDist):
        fam = family_key(a.components[0])
        na, nb = to_natural(a.components[0]), to_natural(b.components[0])
        return from_natural(fam, tuple(x - y for x, y in zip(na, nb)))
    if isinstance(a, MixtureDist) or isinstance(b, MixtureDist):
        raise TypeError(
            "Cavity division between a mixture and a plain distribution is "
            "undefined; initialize mixture-output variables with a plain "
            "(single-family) distribution so messages stay paired.")
    key = family_key(a)
    na, nb = to_natural(a), to_natural(b)
    return from_natural(key, tuple(x - y for x, y in zip(na, nb)))


def prod_reduce(d: Distribution, size: int, batch_ndim: int = 0) -> Distribution:
    """Product of ``size`` plated messages (natural-parameter sum over the
    plate axis, which follows the ``batch_ndim`` batch axes).

    A leaf without a plate axis stands for ``size`` identical copies and
    contributes ``size * leaf``; so does a leaf whose plate axis has length 1
    (a message computed from inputs shared by every copy)."""
    key = family_key(d)
    out = []
    for n, r in zip(to_natural(d), NAT_EVENT_RANKS[key]):
        if n.ndim <= r + batch_ndim:
            out.append(size * n)
        elif n.shape[batch_ndim] == 1:
            out.append(size * n.squeeze(batch_ndim))
        else:
            out.append(torch.sum(n, dim=batch_ndim))
    return from_natural(key, tuple(out))


def pad_plate(d: Distribution, lo: int, hi: int, total: int,
              batch_ndim: int = 0) -> Distribution:
    """Embed a message batch covering slots [lo, hi) into ``total`` slots,
    padding with the multiplicative identity (zero natural parameters).  A
    leaf without a plate axis is broadcast over [lo, hi) first; a leaf
    without a batch axis stays unbatched (it broadcasts against batched
    leaves)."""
    key = family_key(d)
    out = []
    for n, r in zip(to_natural(d), NAT_EVENT_RANKS[key]):
        lead = n.ndim - r
        if lead <= batch_ndim:
            n = n.unsqueeze(lead)          # insert the plate axis
        ax = n.ndim - r - 1
        shape = list(n.shape)
        shape[ax] = hi - lo
        n = n.expand(shape)
        if lo != 0 or hi != total:
            before = list(n.shape)
            before[ax] = lo
            after = list(n.shape)
            after[ax] = total - hi
            n = torch.cat([n.new_zeros(before), n, n.new_zeros(after)], dim=ax)
        out.append(n)
    return from_natural(key, tuple(out))


def broadcast_batch(d: Distribution, batch_shape: tuple) -> Distribution:
    """Every natural leaf broadcast to the full ``batch_shape`` (its trailing
    event axes kept): a nested-plate factor's message computed from
    partially batched inputs then stands for the whole grid of copies
    before it is masked and reduced.  The leaves are expanded views."""
    key = family_key(d)
    out = []
    for n, r in zip(to_natural(d), NAT_EVENT_RANKS[key]):
        evt = tuple(n.shape[n.ndim - r:]) if r else ()
        out.append(n.expand(tuple(batch_shape) + evt))
    return from_natural(key, tuple(out))


def prod_reduce_axes(d: Distribution, axes) -> Distribution:
    """Product of plated messages over several leading axes at once (a
    natural-parameter sum); the leaves carry the full batch
    (``broadcast_batch``)."""
    key = family_key(d)
    axes = tuple(axes)
    return from_natural(key, tuple(torch.sum(n, dim=axes)
                                   for n in to_natural(d)))
