"""Natural-parameter views: products, plate reductions and padding
(counterpart of ``rxinfer_tpu/dists/natural.py``).

For every family ``prod(d1, d2) == from_natural(to_natural(d1) +
to_natural(d2))`` and the ZERO natural vector is the multiplicative identity.
Ported subset: the ``gaussian``, ``mv_gaussian``, ``beta``, ``bernoulli``,
``categorical``, ``dirichlet``, ``dirichlet_collection``, ``gamma`` and
``wishart`` families (the other
conjugate families arrive with the rest of the node library), ``prod_all``,
``nat_div``, ``prod_reduce``, ``pad_plate`` and ``NAT_EVENT_RANKS``.  The
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
from .matrix import Wishart, WishartInverseScale
from .scalar_families import (
    AbstractGamma,
    Bernoulli,
    BernoulliLogits,
    Beta,
    GammaShapeRate,
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
    "wishart": (0, 2),
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
    if isinstance(d, (Wishart, WishartInverseScale)):
        return "wishart"
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


def prod_all(dists: list) -> Distribution:
    """Product of same-family messages via natural-parameter addition; a
    point-mass message collapses the product."""
    from .pointmass import PointMass

    points = [d for d in dists if isinstance(d, PointMass)]
    if points:
        return points[0]
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
    """a / b by natural-parameter subtraction (the cavity of EP updates)."""
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
