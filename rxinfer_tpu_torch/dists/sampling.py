"""Draws, modes and log-densities of the port's distributions, as the
form constraints and the projections need them (the ``sample`` / ``mode`` /
``logpdf`` methods of the JAX package's distributions).

Every draw comes from an explicit ``torch.Generator`` on the
distribution's device (``generator``), so that a seeded constraint draws
the same stream at every call; the streams are torch's, never JAX's.
Draws lead with the sample axis: ``sample(d, n, g)`` is (n, batch...,
event...).  Poisson and Binomial draws are float tensors of counts.
"""

from __future__ import annotations

import torch

from .base import Distribution, tree_leaves
from .discrete import Categorical, Dirichlet, Multinomial
from .gaussian import AbstractMvNormal, AbstractNormal
from .natural import logpdf as _natural_logpdf
from .pointmass import PointMass, SampleList
from .scalar_families import (
    AbstractGamma,
    Bernoulli,
    BernoulliLogits,
    Beta,
    Binomial,
    InverseGamma,
    Poisson,
)


def batch_shape(d):
    """The batch (leading) shape of a message or distribution: its
    natural-parameter leaves' (a function-form message's ``batch_shape``, a
    sample list's weights'); None when it cannot be told (a point mass)."""
    from .natural import NAT_EVENT_RANKS, family_key, to_natural

    if hasattr(d, "log_fn"):
        return tuple(getattr(d, "batch_shape", ()))
    if isinstance(d, SampleList):
        return tuple(d.log_weights.shape[:-1])
    try:
        key = family_key(d)
    except TypeError:
        return None
    return tuple(torch.broadcast_shapes(*[
        n.shape[:n.ndim - r]
        for n, r in zip(to_natural(d), NAT_EVENT_RANKS[key])]))


def batch_shape_of(msgs) -> tuple:
    """The broadcast batch shape of a list of messages."""
    shapes = [s for s in (batch_shape(m) for m in msgs) if s is not None]
    return tuple(torch.broadcast_shapes(*shapes)) if shapes else ()


def device_of(d) -> torch.device:
    """The device of a distribution's (first) tensor leaf."""
    if isinstance(d, torch.Tensor):
        return d.device
    return tree_leaves(d)[0].device


def device_of_messages(msgs) -> torch.device:
    """The device of the first message that is a distribution (a
    function-form message has none); the CPU when there is none."""
    return next((device_of(m) for m in msgs if m is not None
                 and not hasattr(m, "log_fn")), torch.device("cpu"))


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def _gamma_draws(a, n: int, g: torch.Generator):
    """Standard Gamma(a) draws, (n, *a.shape)."""
    return torch._standard_gamma(
        a.expand((n,) + tuple(a.shape)).contiguous(), generator=g)


def sample(d: Distribution, n: int, g: torch.Generator):
    """``n`` draws of ``d``, (n, batch..., event...)."""
    if isinstance(d, AbstractMvNormal):
        m, c = d.mean(), d.cov()
        chol = torch.linalg.cholesky(0.5 * (c + c.transpose(-1, -2)))
        eps = torch.randn((n,) + tuple(m.shape), generator=g,
                          device=m.device, dtype=m.dtype)
        return m + torch.einsum("...ij,...j->...i", chol, eps)
    if isinstance(d, AbstractNormal):
        m, v = torch.broadcast_tensors(d.mean(), d.var())
        eps = torch.randn((n,) + tuple(m.shape), generator=g,
                          device=m.device, dtype=m.dtype)
        return m + torch.sqrt(v) * eps
    tiny = torch.finfo(torch.float32).tiny
    if isinstance(d, AbstractGamma):
        a, b = torch.broadcast_tensors(*d.shape_rate())
        return torch.clamp(_gamma_draws(a, n, g) / b, min=tiny)
    if isinstance(d, Beta):
        a, b = torch.broadcast_tensors(d.a, d.b)
        x, y = _gamma_draws(a, n, g), _gamma_draws(b, n, g)
        return torch.clamp(x / (x + y), tiny, 1.0 - 2.0 ** -24)
    if isinstance(d, Dirichlet):
        x = _gamma_draws(d.alpha, n, g)
        return torch.clamp(x / torch.sum(x, dim=-1, keepdim=True), min=tiny)
    if isinstance(d, (Bernoulli, BernoulliLogits)):
        p = d.mean()
        u = torch.rand((n,) + tuple(p.shape), generator=g, device=p.device,
                       dtype=p.dtype)
        return (u < p).to(p.dtype)
    if isinstance(d, Poisson):
        lam = d.lam
        return torch.poisson(lam.expand((n,) + tuple(lam.shape)).contiguous(),
                             generator=g)
    if isinstance(d, Binomial):
        cnt, p = torch.broadcast_tensors(d.n, d.p)
        shape = (n,) + tuple(p.shape)
        return torch.binomial(cnt.expand(shape).contiguous(),
                              p.expand(shape).contiguous(), generator=g)
    raise NotImplementedError(
        f"sampling from {type(d).__name__} is not available.")


def mode(d: Distribution):
    """The mode in closed form; ``NotImplementedError`` for a family
    without one here (the point-mass constraint then optimizes)."""
    if isinstance(d, (PointMass, SampleList)):
        return d.mode()
    if isinstance(d, (AbstractNormal, AbstractMvNormal)):
        return d.mean()
    if isinstance(d, Beta):
        return (d.a - 1.0) / (d.a + d.b - 2.0)
    if isinstance(d, AbstractGamma):
        a, b = d.shape_rate()
        return (a - 1.0) / b
    if isinstance(d, BernoulliLogits):
        return (d.logit >= 0).to(d.logit.dtype)
    if isinstance(d, Bernoulli):
        return (d.p >= 0.5).to(d.p.dtype)
    if isinstance(d, InverseGamma):
        return d.b / (d.a + 1.0)
    if isinstance(d, Poisson):
        return torch.floor(d.lam)
    if isinstance(d, Binomial):
        return torch.clamp(torch.floor((d.n + 1.0) * d.p), max=d.n)
    if isinstance(d, Categorical):
        k = d.logits.shape[-1]
        return torch.nn.functional.one_hot(
            torch.argmax(d.logits, dim=-1), k).to(d.logits.dtype)
    raise NotImplementedError(
        f"{type(d).__name__} has no closed-form mode here.")


def logpdf(d, x):
    """log-density of a message or distribution at ``x`` (a function-form
    ``LogPdfMessage`` through its ``log_fn``)."""
    if hasattr(d, "log_fn"):
        return d.logpdf(x)
    if isinstance(d, Binomial):
        n, p = d.n, d.p
        x = torch.as_tensor(x, dtype=p.dtype, device=p.device)
        return (torch.lgamma(n + 1.0) - torch.lgamma(x + 1.0)
                - torch.lgamma(n - x + 1.0) + torch.xlogy(x, p)
                + torch.xlogy(n - x, 1.0 - p))
    if isinstance(d, Multinomial):
        x = torch.as_tensor(x, dtype=d.logits.dtype, device=d.logits.device)
        lp = torch.log_softmax(d.logits, dim=-1)
        return (torch.lgamma(torch.sum(x, dim=-1) + 1.0)
                - torch.sum(torch.lgamma(x + 1.0), dim=-1)
                + torch.sum(x * lp, dim=-1))
    return _natural_logpdf(d, x)
