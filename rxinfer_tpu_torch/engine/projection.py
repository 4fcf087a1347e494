"""Exponential-family manifold projection (counterpart of
``rxinfer_tpu/engine/projection.py``; the reference's ProjectedTo +
ExponentialFamilyProjection, ext/ProjectionExt/ProjectionExt.jl:24-67).

``project_logpdf`` projects an unnormalized log-density onto a family by
stochastic natural-gradient ascent on the M-projection objective: for
q_eta with sufficient statistics T(x), the natural gradient is
F^-1 Cov_q(T, log p~ - log q_eta) with F = Cov_q(T, T), the residual
control-variated so that its variance vanishes as q_eta approaches an
in-family target.  A fixed number of damped steps, each projected back into
the family's natural domain, and the Polyak average of the trailing half.
Every batch element runs at once: the natural parameters are (batch...,
P), the draws (S, batch..., event...), the Fisher solves (batch..., P, P)
elementwise (``ops/smallmat.py``, P <= 16).  The draws come from a
``torch.Generator`` on the marginals' device seeded from ``seed``, so the
streams are torch's, never JAX's.

``ProjectedTo(family)`` is the form constraint: a product of messages of
the target family is their exact natural-parameter sum (no draws); any
other product is projected, warm-started from the previous marginal when
it is of the family, else from a one-pass importance-sampling fit
(``_is_initializer``) or, for ``bernoulli``, the vague point.

``fit_weighted_samples`` is the exact M-projection of a weighted sample
cloud (matching E[T(x)]): closed form for the Gaussians, Newton steps on
the digamma systems for Beta, Gamma and Dirichlet; ``rules/delta.py`` uses
it for ``CVIProjection(out_family=...)``.  A scalar family's samples there
are (..., S), a vector family's (..., S, d), the weights (S,) or (..., S).

Families: gaussian, mv_gaussian, beta, gamma, dirichlet, bernoulli,
poisson and binomial (its trial count a parameter outside the natural one,
carried beside it: ``ProjectedTo("binomial", n=...)``).
"""

from __future__ import annotations

import torch

from ..dists import (
    BernoulliLogits,
    Beta,
    Binomial,
    Dirichlet,
    GammaShapeRate,
    MvNormalMeanCovariance,
    MvNormalWeightedMeanPrecision,
    NormalMeanVariance,
    Poisson,
    pd_inverse,
)
from ..dists.base import ProductError
from ..dists.gaussian import AbstractMvNormal, AbstractNormal
from ..dists.natural import (
    NAT_EVENT_RANKS,
    family_key,
    from_natural,
    prod_all,
    to_natural,
)
from ..dists.sampling import (
    batch_shape_of,
    device_of_messages,
    generator,
    logpdf,
    sample,
)
from ..graph.constraints import AbstractFormConstraint

# sufficient statistics in the natural-parameter layouts of dists/natural.py
_SUFF = {
    "gaussian": lambda x: (x, -0.5 * x * x),
    "mv_gaussian": lambda x: (x, -0.5 * x[..., :, None] * x[..., None, :]),
    "beta": lambda x: (torch.log(x), torch.log1p(-x)),
    "gamma": lambda x: (torch.log(x), -x),
    "dirichlet": lambda x: (torch.log(x),),
    "bernoulli": lambda x: (x,),
    "poisson": lambda x: (x,),
    "binomial": lambda x: (x,),
}

SUPPORTED = tuple(sorted(_SUFF))
# natural-parameter event ranks, the binomial's (its logit) beside the
# registry's
_RANKS = {**NAT_EVENT_RANKS, "binomial": (0,)}


def _check_family(family: str) -> None:
    if family not in _SUFF:
        raise ValueError(
            f"projection supports families {SUPPORTED}, got {family!r}")


def _nat_to_dist(family: str, nat: tuple, n_trials=None):
    """``from_natural``, with the binomial's trial count carried beside its
    natural parameter (the logit)."""
    if family == "binomial":
        n = torch.as_tensor(n_trials, dtype=nat[0].dtype,
                            device=nat[0].device)
        return Binomial(n, torch.sigmoid(nat[0]))
    return from_natural(family, nat)


def _dist_to_nat(family: str, dist):
    if family == "binomial":
        p = torch.clamp(dist.p, 1e-6, 1.0 - 1e-6)
        return (torch.log(p) - torch.log1p(-p),)
    return to_natural(dist)


def _project_domain(family: str, nat: tuple) -> tuple:
    """Clamp natural parameters back into the family's open domain."""
    if family == "gaussian":
        return (nat[0], torch.clamp(nat[1], min=1e-8))
    if family == "mv_gaussian":
        w = 0.5 * (nat[1] + nat[1].transpose(-1, -2))
        evals, evecs = torch.linalg.eigh(w)
        evals = torch.clamp(evals, min=1e-6)
        w = torch.einsum("...ij,...j,...kj->...ik", evecs, evals, evecs)
        return (nat[0], w)
    if family == "beta":
        return (torch.clamp(nat[0], min=-0.999),
                torch.clamp(nat[1], min=-0.999))
    if family == "gamma":
        return (torch.clamp(nat[0], min=-0.999), torch.clamp(nat[1], min=1e-6))
    if family == "dirichlet":
        return (torch.clamp(nat[0], min=-0.999),)
    if family in ("bernoulli", "binomial", "poisson"):
        # the logit, or log lam: bounded so that the draws stay finite
        return (torch.clamp(nat[0], -15.0, 15.0),)
    raise ValueError(f"unsupported projection family {family!r}")


def _flatten(nat: tuple, lead_ndim: int = 0):
    """Natural-parameter leaves (lead..., event...) as one vector per
    element, (lead..., P), and the leaves' event shapes."""
    leaves = [n.reshape(tuple(n.shape[:lead_ndim]) + (-1,)) for n in nat]
    shapes = [tuple(n.shape[lead_ndim:]) for n in nat]
    return torch.cat(leaves, dim=-1), shapes


def _unflatten(vec, shapes):
    out, off = [], 0
    for s in shapes:
        k = 1
        for d in s:
            k *= d
        out.append(vec[..., off:off + k].reshape(tuple(vec.shape[:-1]) + s))
        off += k
    return tuple(out)


def _lead_shape(family: str, nat: tuple) -> tuple:
    """The batch shape of a natural-parameter tuple."""
    return tuple(torch.broadcast_shapes(*[
        n.shape[:n.ndim - r] for n, r in zip(nat, _RANKS[family])]))


def project_logpdf(family: str, logpdf_fn, initial, *, n_iters: int = 40,
                   n_samples: int = 512, step: float = 0.4,
                   decay: float = 0.05, ridge: float = 1e-5, seed: int = 0,
                   batch_shape: tuple = (), n_trials=None):
    """Stochastic natural-gradient projection of an unnormalized
    log-density onto ``family``, warm-started from ``initial`` (a
    distribution of the family).  ``logpdf_fn`` maps draws (S, batch...,
    event...) to (S, batch...); the batch is ``initial``'s broadcast with
    ``batch_shape``; ``n_trials`` is a binomial's trial count.  Returns the
    projected distribution over the batch."""
    from ..ops.smallmat import small_solve

    _check_family(family)
    ranks = _RANKS[family]
    eta0 = tuple(n.to(torch.float32)
                 for n in _dist_to_nat(family, initial))
    device = eta0[0].device
    g = generator(seed, device)
    lead = tuple(torch.broadcast_shapes(_lead_shape(family, eta0),
                                        tuple(batch_shape)))
    eta0 = tuple(n.expand(lead + tuple(n.shape[n.ndim - r:]))
                 for n, r in zip(eta0, ranks))
    vec, shapes = _flatten(eta0, len(lead))
    p = vec.shape[-1]
    eye = ridge * torch.eye(p, dtype=vec.dtype, device=device)
    half = max(1, n_iters // 2)  # n_iters = 1 must not divide by 0
    avg = torch.zeros_like(vec)
    for i in range(n_iters):
        q = _nat_to_dist(family, _project_domain(
            family, _unflatten(vec, shapes)), n_trials)
        z = sample(q, n_samples, g)                        # (S, lead, ev)
        t = _stats_matrix(family, z)                       # (S, lead, P)
        # Cov(T, log p~ - log q) = Cov(T, f) - F eta: F^-1 of it estimates
        # the natural gradient directly, and its variance vanishes as q
        # approaches an in-family target
        f = (logpdf_fn(z) - logpdf(q, z)).expand((n_samples,) + lead)
        tc = t - torch.mean(t, dim=0, keepdim=True)
        fc = f - torch.mean(f, dim=0, keepdim=True)
        g_eta = torch.einsum("s...p,s...->...p", tc, fc) / n_samples
        fisher = torch.einsum("s...p,s...q->...pq", tc, tc) / n_samples \
            + eye
        g_nat = small_solve(fisher, g_eta, matrix=False)
        rho = step / (1.0 + decay * i)
        vec, _ = _flatten(_project_domain(
            family, _unflatten(vec + rho * g_nat, shapes)), len(lead))
        if i >= n_iters - half:
            avg = avg + vec / half
    return _nat_to_dist(family,
                        _project_domain(family, _unflatten(avg, shapes)),
                        n_trials)


def _stats_matrix(family: str, z):
    """T(z) flattened over the statistics: (..., S, P) for samples
    (..., S[, d])."""
    event = 1 if family in ("mv_gaussian", "dirichlet") else 0
    lead = z.shape[:z.ndim - event]
    return torch.cat([tk.reshape(lead + (-1,)) for tk in _SUFF[family](z)],
                     dim=-1)


def _inv_digamma(y, iters: int = 5):
    """Newton inverse of digamma (Minka 2000, appendix C initialization)."""
    dg1 = torch.special.digamma(torch.ones((), dtype=y.dtype, device=y.device))
    x = torch.where(y >= -2.22, torch.exp(y) + 0.5, -1.0 / (y - dg1))
    for _ in range(iters):
        x = x - (torch.special.digamma(x) - y) / torch.clamp(
            torch.polygamma(1, x), min=1e-10)
        x = torch.clamp(x, min=1e-8)
    return x


def fit_weighted_samples(family: str, samples, weights):
    """Fit the exponential family to a weighted sample cloud by matching the
    weighted sufficient-statistic means (the exact M-projection); the sample
    axis is -1 for a scalar family, -2 for a vector one."""
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True),
                              min=1e-30)
    dg, tg = torch.special.digamma, lambda x: torch.polygamma(1, x)
    if family == "gaussian":
        m = torch.sum(w * samples, dim=-1)
        v = torch.clamp(torch.sum(w * (samples - m[..., None]) ** 2, dim=-1),
                        min=1e-10)
        return NormalMeanVariance(m, v)
    if family == "mv_gaussian":
        m = torch.einsum("...s,...si->...i", w, samples)
        c = samples - m[..., None, :]
        v = torch.einsum("...s,...si,...sj->...ij", w, c, c)
        v = v + 1e-8 * torch.eye(v.shape[-1], dtype=v.dtype, device=v.device)
        prec = pd_inverse(v)
        return MvNormalWeightedMeanPrecision(
            torch.einsum("...ij,...j->...i", prec, m), prec)
    if family == "beta":
        s = torch.clamp(samples, 1e-6, 1.0 - 1e-6)
        e_lx = torch.sum(w * torch.log(s), dim=-1)
        e_l1x = torch.sum(w * torch.log1p(-s), dim=-1)
        # method of moments, refined by Newton on the digamma system
        m = torch.sum(w * s, dim=-1)
        v = torch.clamp(torch.sum(w * (s - m[..., None]) ** 2, dim=-1),
                        min=1e-10)
        common = torch.clamp(m * (1 - m) / v - 1.0, min=1e-2)
        a = torch.clamp(m * common, min=1e-2)
        b = torch.clamp((1 - m) * common, min=1e-2)
        for _ in range(10):
            ga = dg(a) - dg(a + b) - e_lx
            gb = dg(b) - dg(a + b) - e_l1x
            tab = tg(a + b)
            j11 = tg(a) - tab
            j22 = tg(b) - tab
            det = torch.clamp(j11 * j22 - tab * tab, min=1e-12)
            da = (j22 * ga + tab * gb) / det
            db = (tab * ga + j11 * gb) / det
            a = torch.clamp(a - da, min=1e-3)
            b = torch.clamp(b - db, min=1e-3)
        return Beta(a, b)
    if family == "gamma":
        s = torch.clamp(samples, min=1e-10)
        e_x = torch.sum(w * s, dim=-1)
        e_lx = torch.sum(w * torch.log(s), dim=-1)
        # log(a) - digamma(a) = log E[x] - E[log x] by Newton, then b = a/E[x]
        gap = torch.clamp(torch.log(e_x) - e_lx, min=1e-8)
        a = 0.5 / gap
        for _ in range(8):
            g = torch.log(a) - dg(a) - gap
            dgr = 1.0 / a - tg(a)
            a = torch.clamp(a - g / torch.where(torch.abs(dgr) > 1e-12, dgr,
                                                torch.full_like(dgr, 1e-12)),
                            min=1e-3)
        return GammaShapeRate(a, a / torch.clamp(e_x, min=1e-10))
    if family == "bernoulli":
        m = torch.clamp(torch.sum(w * samples, dim=-1), 1e-6, 1.0 - 1e-6)
        return BernoulliLogits(torch.log(m) - torch.log1p(-m))
    if family == "poisson":
        return Poisson(torch.clamp(torch.sum(w * samples, dim=-1), min=1e-8))
    if family == "dirichlet":
        s = torch.clamp(samples, min=1e-6)
        s = s / torch.sum(s, dim=-1, keepdim=True)
        e_lx = torch.einsum("...s,...sk->...k", w, torch.log(s))
        alpha = torch.ones_like(e_lx)
        for _ in range(8):
            # Minka's fixed point: digamma(a_k) = digamma(sum a) + E[log x_k]
            alpha = _inv_digamma(dg(torch.sum(alpha, dim=-1, keepdim=True))
                                 + e_lx)
        for _ in range(8):
            # Newton with the diagonal-plus-rank-one Hessian inverted by
            # Sherman-Morrison (Minka 2000, eq. 10-15)
            a0 = torch.sum(alpha, dim=-1, keepdim=True)
            g = dg(a0) - dg(alpha) + e_lx
            qd = -tg(alpha)
            z = tg(a0)
            b = torch.sum(g / qd, dim=-1, keepdim=True) / (
                1.0 / z + torch.sum(1.0 / qd, dim=-1, keepdim=True))
            alpha = torch.clamp(alpha - (g - b) / qd, min=1e-3)
        return Dirichlet(alpha)
    raise ValueError(f"unsupported sample-fit family {family!r}")


# -- importance-sampling initializer (when no warm start exists yet) --------

def _is_initializer(family: str, msgs, n_samples: int, seed: int,
                    proposal_scale: float = 2.0):
    """One pass of self-normalized importance sampling and the weighted
    fit: a robust first point for the natural-gradient refinement."""
    device = device_of_messages(msgs)
    g = generator(seed + 101, device)
    gauss = [m for m in msgs if isinstance(m, AbstractNormal)]
    mv = [m for m in msgs if isinstance(m, AbstractMvNormal)]
    if family == "dirichlet":
        dirs = [m for m in msgs if isinstance(m, Dirichlet)]
        proposal = (prod_all(dirs) if dirs else Dirichlet(
            torch.ones(_dirichlet_dim(msgs), device=device)))
        z = sample(proposal, n_samples, g)
        logw = sum(logpdf(m, z) for m in msgs) - logpdf(proposal, z)
    elif family == "mv_gaussian" and mv:
        m0 = sum(p.mean() for p in mv) / len(mv)
        v0 = sum(p.cov() for p in mv) / len(mv) * proposal_scale
        proposal = MvNormalMeanCovariance(m0, v0)
        z = sample(proposal, n_samples, g)
        logw = sum(logpdf(m, z) for m in msgs) - logpdf(proposal, z)
    else:
        if gauss:
            m0 = sum(p.mean() for p in gauss) / len(gauss)
            v0 = sum(p.var() for p in gauss) / len(gauss) * proposal_scale
        else:
            m0 = torch.zeros((), device=device)
            v0 = torch.full((), 4.0, device=device)
        proposal = NormalMeanVariance(m0, v0)
        z0 = sample(proposal, n_samples, g)
        if family == "beta":
            z = torch.sigmoid(z0 * 2.0)   # squashed onto (0, 1)
            log_jac = torch.log(2.0 * z * (1.0 - z))
        elif family == "gamma":
            z = torch.exp(z0)
            log_jac = z0
        else:
            z, log_jac = z0, torch.zeros_like(z0)
        logw = (sum(logpdf(m, z) for m in msgs) - logpdf(proposal, z0)
                + log_jac)
    event = 1 if family in ("mv_gaussian", "dirichlet") else 0
    lead = tuple(torch.broadcast_shapes(logw.shape[1:],
                                        z.shape[1:z.ndim - event]))
    logw = logw.expand((n_samples,) + lead)
    z = z.expand((n_samples,) + lead + tuple(z.shape[z.ndim - event:]))
    logw = logw - torch.amax(logw, dim=0, keepdim=True)
    # the sample axis after the batch axes, as fit_weighted_samples takes it
    return fit_weighted_samples(family, z.movedim(0, len(lead)),
                                torch.exp(logw).movedim(0, -1))


def _dirichlet_dim(msgs) -> int:
    for m in msgs:
        if isinstance(m, Dirichlet):
            return m.alpha.shape[-1]
    raise ValueError(
        "ProjectedTo('dirichlet') without a Dirichlet message needs a warm "
        "start: provide initialization= for the constrained variable.")


class ProjectedTo(AbstractFormConstraint):
    """Project a (possibly non-conjugate) message product onto a family by
    stochastic natural-gradient descent on the exponential-family manifold
    (reference ``ProjectedTo``, ext/ProjectionExt/ProjectionExt.jl:24-67):
    ``ProjectedTo("beta")``, ``("gaussian")``, ``("mv_gaussian")``,
    ``("gamma")``, ``("dirichlet")``, ``("bernoulli")``, ``("poisson")``,
    ``("binomial", n=...)``.  Inside the engine the previous sweep's
    marginal warm-starts the descent (the reference's ProjectionContext);
    the first sweep starts from the initialization, or from an
    importance-sampling moment fit (the one-parameter discrete families from
    their vague point)."""

    def __init__(self, family: str, n_samples: int = 512, seed: int = 0,
                 n_iters: int = 40, step: float = 0.4,
                 proposal_scale: float = 2.0, n=None):
        _check_family(family)
        if family == "binomial" and n is None:
            raise ValueError(
                "ProjectedTo('binomial') needs the trial count: "
                "ProjectedTo('binomial', n=...) (a parameter outside the "
                "family's natural one).")
        self.family = family
        self.n_samples = n_samples
        self.seed = seed
        self.n_iters = n_iters
        self.step = step
        self.proposal_scale = proposal_scale
        self.n = n

    def project_product(self, msgs, prev=None):
        """The projection of the product of ``msgs``; ``prev`` is the
        variable's previous marginal (the warm start across sweeps)."""
        # exact fast path: a product within the family (ProjectionExt:28-35)
        try:
            if all(family_key(m) == self.family for m in msgs):
                return prod_all(msgs)
        except (TypeError, ProductError):  # function-form carriers
            pass
        if prev is not None and self._same_family(prev):
            initial = prev
        elif self.family in ("bernoulli", "poisson", "binomial"):
            # a one-parameter discrete target converges from the vague point
            # in a few natural-gradient steps
            dev = device_of_messages(msgs)
            initial = {
                "bernoulli": lambda: BernoulliLogits(
                    torch.zeros((), device=dev)),
                "poisson": lambda: Poisson(torch.ones((), device=dev)),
                "binomial": lambda: Binomial(
                    torch.as_tensor(float(self.n), device=dev),
                    torch.full((), 0.5, device=dev)),
            }[self.family]()
        else:
            initial = _is_initializer(
                self.family, [m for m in msgs if not hasattr(m, "log_fn")]
                or msgs, self.n_samples, self.seed, self.proposal_scale)

        def log_prod(x):
            return sum(logpdf(m, x) for m in msgs)

        return project_logpdf(
            self.family, log_prod, initial, n_iters=self.n_iters,
            n_samples=self.n_samples, step=self.step, seed=self.seed,
            batch_shape=batch_shape_of(msgs), n_trials=self.n)

    def _same_family(self, dist) -> bool:
        if self.family == "binomial":
            return isinstance(dist, Binomial)
        try:
            return family_key(dist) == self.family
        except TypeError:
            return False

    def constrain(self, dist):
        """A closed-form marginal: itself when of the family, else its
        density projected (ProjectionExt:28-46)."""
        if self._same_family(dist):
            return dist
        return self.project_product([dist])
