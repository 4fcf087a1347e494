"""The Delta node (out = fn(in0, in1, ...)) and its contraction with a
Gaussian, NonlinearGaussian (out = fn(in0, ...) + noise) (counterpart of
``rxinfer_tpu/rules/delta.py``).

The approximation method is the factor's meta, as in the reference's
DeltaMeta: ``Linearization`` (first-order Taylor, the Jacobian by
``torch.func.jacfwd``), ``Unscented(alpha, beta, kappa)`` (sigma points),
``CVIProjection(n_samples, seed, out_family)`` (alias ``CVI``: Monte-Carlo
moment matching of the (inputs, out) joint, or the out message projected
onto another exponential family by ``engine/projection.py``) and a known
inverse (``DeltaMeta(inverse=...)``: the linearization point of the message
to an input from fn's inverse).  Messages are moment-matched Gaussians;
several inputs are transformed jointly over their concatenated vector.

The user's ``fn`` (and an ``inverse``) is a pure torch function of single
values: a scalar input arrives as a 0-d tensor, a vector input as a 1-d
tensor, and it returns a 0-d or 1-d tensor.  The rules run over every copy of
a factor at once (the batch and plate axes of its marginals broadcast, the
layout of ``engine/blocks.py``): the linear algebra over those leading axes
directly, and ``fn`` (and its Jacobian) under one ``torch.func.vmap`` over the
copies flattened into one axis.  A function that is not vmappable -- it
calls ``.item()`` or ``.tolist()``, branches in Python on a tensor's value,
goes through numpy or writes into a tensor in place -- raises the
``RuntimeError`` of ``torch.func`` at its first call.

An input's event rank is its class's for a Gaussian marginal; a point mass
(a constant or a data slot) takes ``q["_meta"]["_ranks"]`` (set by
``engine/compile.py`` from the graph's shapes), a scalar without it, as the
JAX package takes a point-mass input of a plated factor.  ``CVIProjection``
draws its standard-normal samples from a ``torch.Generator`` seeded with
``seed`` on the marginals' device (``standard_normal_draws``), the same draws
for every copy, as the JAX package uses one key for all; the draws differ
from JAX's, so a comparison of the two hands ``_push_sampled`` JAX's draws.

Every rule pins ``torch.set_float32_matmul_precision("highest")`` for its
duration (``_fp32``) and restores the caller's setting afterwards.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Callable, Optional, Sequence

import torch

from ..dists import (
    GammaShapeRate,
    MvNormalMeanCovariance,
    MvNormalWeightedMeanPrecision,
    NormalMeanVariance,
    NormalWeightedMeanPrecision,
    PointMass,
    WishartInverseScale,
)
from ..dists.gaussian import (
    AbstractMvNormal,
    AbstractNormal,
    _symmetrize,
    as_mv_weighted_mean_precision,
    as_weighted_mean_precision,
    batched_logdet,
    pd_inverse,
)
from ..ops.smallmat import small_solve
from .expectations import e_log_precision, e_logdet, e_precision
from .registry import node

_LOG2PI = 1.8378770664093453
_LOG2PIE = 2.837877066409345


def _fp32(fn):
    """Pin the rule's float32 matmuls to full precision (no TF32) for its
    duration, restoring the caller's setting afterwards: the messages are
    small products feeding inversions and joint conditioning, where a
    reduced-precision product can leave the conditioned covariance
    indefinite."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_float32_matmul_precision(prev)

    return wrapped


@dataclasses.dataclass
class Linearization:
    """First-order Taylor approximation (reference Linearization())."""


@dataclasses.dataclass
class Unscented:
    """Sigma-point transform (reference Unscented(alpha, beta, kappa))."""

    alpha: float = 1e-3
    beta: float = 2.0
    kappa: float = 0.0


@dataclasses.dataclass
class CVIProjection:
    """Sampling-based projection of the delta transform (reference
    CVIProjection): ``n_samples`` joint-input draws pushed through fn and
    the (inputs, out) joint moment-matched; ``out_family`` projects the
    pushed out samples onto that exponential family instead
    (``engine/projection.fit_weighted_samples``)."""

    n_samples: int = 1024
    seed: int = 0
    out_family: Optional[str] = None


# the reference's deprecated alias
CVI = CVIProjection


@dataclasses.dataclass
class DeltaMeta:
    """Reference DeltaMeta(method=..., inverse=...)."""

    method: object = None
    inverse: Optional[Callable | Sequence[Callable]] = None


# -- batched small linear algebra ----------------------------------------------

def _mm(a, b):
    """a @ b over leading axes; small operands (every dimension <= 8) as an
    elementwise product and a sum, which avoids millions of tiny batched
    GEMMs."""
    if max(a.shape[-2], a.shape[-1], b.shape[-1]) <= 8:
        return torch.sum(a.unsqueeze(-1) * b.unsqueeze(-3), dim=-2)
    return a @ b


def _mv(a, x):
    """a @ x for matrices (..., m, n) and vectors (..., n)."""
    return torch.sum(a * x.unsqueeze(-2), dim=-1)


def _t(a):
    return a.transpose(-1, -2)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _solve(a, b):
    """solve(a, b) for a matrix right-hand side (..., n, k)."""
    return small_solve(a, b, matrix=True)


def _cholesky(v):
    """Lower Cholesky factor of positive-definite matrices (..., n, n): for
    n <= 8 elementwise over the leading axes, column by column; beyond by
    ``torch.linalg.cholesky``."""
    n = v.shape[-1]
    if n > 8:
        return torch.linalg.cholesky(v)
    cols = [[None] * n for _ in range(n)]
    for j in range(n):
        s = v[..., j, j]
        for k in range(j):
            s = s - cols[j][k] * cols[j][k]
        d = torch.sqrt(s)
        cols[j][j] = d
        for i in range(j + 1, n):
            s = v[..., i, j]
            for k in range(j):
                s = s - cols[i][k] * cols[j][k]
            cols[i][j] = s / d
    zero = torch.zeros_like(v[..., 0, 0])
    return torch.stack([torch.stack([cols[i][j] if j <= i else zero
                                     for j in range(n)], dim=-1)
                        for i in range(n)], dim=-2)


# -- the inputs as one vector space ---------------------------------------------

def _meta(q) -> dict:
    return q.get("_meta") or {}


def _inputs(q):
    return sorted((k for k in q if k.startswith("in")), key=lambda k: int(k[2:]))


def _rank(q, key) -> int:
    """Event rank of ``q[key]``: a Gaussian's by its class, a point mass's
    from the factor's ``_ranks`` meta (0 without it)."""
    d = q[key]
    if isinstance(d, AbstractMvNormal):
        return 1
    if isinstance(d, AbstractNormal):
        return 0
    return int((_meta(q).get("_ranks") or {}).get(key, 0))


def _moments(d, rank: int):
    """(mean (..., n), cov (..., n, n)) lifted to vector form."""
    if isinstance(d, PointMass):
        m = d.point
        if rank == 0:
            m = m[..., None]
        v = torch.zeros(m.shape + m.shape[-1:], dtype=m.dtype, device=m.device)
        return m, v
    m = d.mean()
    if rank == 0:
        return m[..., None], d.var()[..., None, None]
    return m, d.cov()


def _info_form(d, rank: int):
    """(xi, W) lifted to vector / matrix form: finite for improper
    carriers."""
    if rank >= 1 or isinstance(d, AbstractMvNormal):
        f = as_mv_weighted_mean_precision(d)
        return f.xi, f.w
    f = as_weighted_mean_precision(d)
    return f.xi[..., None], f.w[..., None, None]


def _lead(*tensors_and_ranks):
    return torch.broadcast_shapes(*(t.shape[:t.ndim - r]
                                    for t, r in tensors_and_ranks))


def _block_diag(vs, dims, lead):
    n = sum(dims)
    out = vs[0].new_zeros(lead + (n, n))
    off = 0
    for v, d in zip(vs, dims):
        out[..., off:off + d, off:off + d] = v
        off += d
    return out


def _flatten_inputs(q, keys):
    """The inputs' means concatenated (L, n) and their block-diagonal
    covariance (L, n, n) over the broadcast leading axes L, with each
    input's dimension and whether it is a vector."""
    ms, vs, dims, vecs = [], [], [], []
    for k in keys:
        r = _rank(q, k)
        m, v = _moments(q[k], r)
        ms.append(m)
        vs.append(v)
        dims.append(m.shape[-1])
        vecs.append(r >= 1)
    lead = _lead(*[(m, 1) for m in ms], *[(v, 2) for v in vs])
    mean = torch.cat([m.expand(lead + m.shape[-1:]) for m in ms], dim=-1)
    return mean, _block_diag(vs, dims, lead), dims, vecs


def _split(z, dims, vecs):
    args, off = [], 0
    for d, vec in zip(dims, vecs):
        part = z[off:off + d]
        args.append(part if vec else part[0])
        off += d
    return args


def _vmap_copies(fn, z, dims, vecs, jacobian: bool = False):
    """``fn`` over every copy of the joint input ``z`` (..., n): one
    ``torch.func.vmap`` over the leading axes flattened into one (what the
    JAX package's ``batched_delta_rule`` does by a vmap over the plate of
    each dataset).  Returns
    the outputs (..., d_out) and whether fn returns a vector, and with
    ``jacobian`` its Jacobian (..., d_out, n) by ``torch.func.jacfwd`` in
    the same pass."""
    lead, n = z.shape[:-1], z.shape[-1]
    flat = z.reshape(-1, n)

    def single(zz):
        out = fn(*_split(zz, dims, vecs))
        return torch.as_tensor(out, dtype=zz.dtype, device=zz.device)

    probe = [None]

    def flat_out(zz):
        out = single(zz)
        probe[0] = out.ndim
        return out.reshape(-1)

    if jacobian:
        def with_aux(zz):
            y = flat_out(zz)
            return y, y

        jac, y = torch.func.vmap(torch.func.jacfwd(with_aux, has_aux=True))(
            flat)
        d_out = y.shape[-1]
        # a Python number times a 0-d input comes out of jacfwd's tangents
        # in float64: the transform stays in the inputs' dtype
        return (y.reshape(lead + (d_out,)).to(z.dtype), probe[0] >= 1,
                jac.reshape(lead + (d_out, n)).to(z.dtype))
    y = torch.func.vmap(flat_out)(flat)
    return y.reshape(lead + (y.shape[-1],)).to(z.dtype), probe[0] >= 1


# -- the transforms -------------------------------------------------------------

def _push_linearized(fn, dims, vecs, m, v):
    """Linearization: (f(m), J V J^T, J, out is a vector)."""
    f0, out_vec, jac = _vmap_copies(fn, m, dims, vecs, jacobian=True)
    cov = _mm(_mm(jac, v), _t(jac))
    return f0, _symmetrize(cov), jac, out_vec


def _psd_guard(v):
    """Lift slightly indefinite moment matrices to positive definite before
    a Cholesky: by the most negative diagonal entry (0.1% over, so that the
    result stays strictly positive definite after float32 rounding) plus a
    scale-aware ridge; a positive-definite input moves by the ridge
    alone."""
    n = v.shape[-1]
    v = _symmetrize(v)
    diag = torch.diagonal(v, dim1=-2, dim2=-1)
    lift = torch.clamp(-torch.min(diag, dim=-1).values, min=0.0) * 1.001
    ridge = 1e-9 * (torch.abs(torch.sum(diag, dim=-1)) / n + 1e-30)
    return v + (lift + ridge)[..., None, None] * _eye(n, v)


def _sigma_points(m, v, alpha, beta, kappa):
    """The 2n + 1 sigma points (..., 2n + 1, n) and their mean and
    covariance weights (2n + 1,)."""
    n = m.shape[-1]
    lam = alpha * alpha * (n + kappa) - n
    # static (zero-variance) input dimensions make v singular; the guard
    # keeps the Cholesky finite (the points do not spread there)
    cols = _t(_cholesky(_psd_guard((n + lam) * v)))   # row i: column i
    c = m.unsqueeze(-2)
    pts = torch.cat([c, c + cols, c - cols], dim=-2)
    wm0 = lam / (n + lam)
    wc0 = wm0 + (1 - alpha * alpha + beta)
    wi = 1.0 / (2 * (n + lam))
    wm = torch.full((2 * n + 1,), wi, dtype=m.dtype, device=m.device)
    wc = wm.clone()
    wm[0] = wm0
    wc[0] = wc0
    return pts, wm, wc


def _push_unscented(fn, dims, vecs, m, v, params: Unscented):
    """Sigma-point transform: (E[y], Cov(y), Cov(z, y), out is a vector).

    The weights are of order 1 / (2 alpha^2 n): at the default alpha = 1e-3
    they amplify the float32 rounding of the points and outputs by about
    1e5, so the moments lose their digits once |m| or |f| is of order 10, in
    this package as in the JAX one (ROADMAP C11); alpha = 1 keeps them."""
    pts, wm, wc = _sigma_points(m, v, params.alpha, params.beta, params.kappa)
    ys, out_vec = _vmap_copies(fn, pts, dims, vecs)
    mean = torch.sum(wm[:, None] * ys, dim=-2)
    dy = ys - mean.unsqueeze(-2)
    dz = pts - m.unsqueeze(-2)
    cov = torch.einsum("s,...si,...sj->...ij", wc, dy, dy)
    cross = torch.einsum("s,...si,...sj->...ij", wc, dz, dy)  # Cov(z, y)
    return mean, _symmetrize(cov), cross, out_vec


def standard_normal_draws(params: CVIProjection, n: int, dtype, device):
    """The (n_samples, n) standard-normal draws of a CVIProjection: a
    ``torch.Generator`` on ``device`` seeded with ``params.seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(params.seed))
    return torch.randn((params.n_samples, n), generator=gen, dtype=dtype,
                       device=device)


def _push_sampled(fn, dims, vecs, m, v, params: CVIProjection, eps=None):
    """Monte-Carlo moment matching of (z, f(z)), the CVIProjection
    transform: (E[y], Cov(y), Cov(z, y), out is a vector).  ``eps`` are the
    (n_samples, n) standard-normal draws (``standard_normal_draws`` when
    None), shared by every copy."""
    n = m.shape[-1]
    if eps is None:
        eps = standard_normal_draws(params, n, m.dtype, m.device)
    eps = torch.as_tensor(eps, dtype=m.dtype, device=m.device)
    s = eps.shape[0]
    chol = _cholesky(_psd_guard(v))
    pts = m.unsqueeze(-2) + torch.einsum("sk,...jk->...sj", eps, chol)
    ys, out_vec = _vmap_copies(fn, pts, dims, vecs)
    mean = torch.mean(ys, dim=-2)
    dy = ys - mean.unsqueeze(-2)
    dz = pts - m.unsqueeze(-2)
    cov = torch.einsum("...si,...sj->...ij", dy, dy) / s
    cross = torch.einsum("...si,...sj->...ij", dz, dy) / s
    return mean, _symmetrize(cov), cross, out_vec


def _transform(fn, dims, vecs, m, v, method):
    """(f0, S_yy, S_zy, out is a vector, the Jacobian or None) of the
    method; the Jacobian comes with Linearization."""
    if isinstance(method, Unscented):
        return (*_push_unscented(fn, dims, vecs, m, v, method), None)
    if isinstance(method, CVIProjection):
        return (*_push_sampled(fn, dims, vecs, m, v, method), None)
    f0, s_yy, jac, out_vec = _push_linearized(fn, dims, vecs, m, v)
    return f0, s_yy, _mm(v, _t(jac)), out_vec, jac


def _ridged_inv(v):
    """Scale-aware ridged symmetric inverse, the one guard for
    rank-deficient matrices in the delta machinery."""
    n = v.shape[-1]
    tr = torch.sum(torch.diagonal(v, dim1=-2, dim2=-1), dim=-1)
    r = 1e-8 * (torch.abs(tr) / n + 1e-30) + 1e-12
    return _symmetrize(pd_inverse(_symmetrize(v) + r[..., None, None]
                                  * _eye(n, v)))


def _robust_moments(d, rank: int):
    """(mean, cov) lifted to vector form that stay finite for
    rank-deficient Gaussian carriers: from the ridged information form."""
    if isinstance(d, (AbstractMvNormal, AbstractNormal)):
        xi, w = _info_form(d, rank)
        v = _ridged_inv(w)
        return _mv(v, xi), v
    return _moments(d, rank)


def _stat_jacobian(fn, dims, vecs, z0, v_blk, method):
    """The method's linearization of fn around N(z0, v_blk): the
    statistical Jacobian Cov(z, y)^T V^-1 of the sigma points or samples,
    or the analytic Jacobian for Linearization; (..., d_out, sum d_in)."""
    if isinstance(method, Unscented):
        cross = _push_unscented(fn, dims, vecs, z0, v_blk, method)[2]
    elif isinstance(method, CVIProjection):
        cross = _push_sampled(fn, dims, vecs, z0, v_blk, method)[2]
    else:
        return _vmap_copies(fn, z0, dims, vecs, jacobian=True)[2]
    return _t(_mm(_ridged_inv(v_blk), cross))


def _known_inverse_backward(q, target_idx, keys, method, inverse,
                            extra_out_cov=None):
    """Known-inverse message to input ``target_idx`` (reference
    DeltaMeta(inverse=...)): the inverse gives the linearization point
    x0 = f_back(m_out, m_others) at the out mean combined with the forward
    prediction, and the message is the information-form pullback of the out
    belief through the forward Jacobian at x0:

        W_msg = J_i^T W_eff J_i,   xi_msg = W_msg x0,
        W_eff = (V_out + sum_{j != i} J_j V_j J_j^T [+ extra_out_cov])^-1.

    ``extra_out_cov`` widens the out belief (the contracted
    NonlinearGaussian adds its noise).  Returns None, after a warning, when
    ``inverse`` does not fit the node's inputs."""
    fn = _meta(q)["fn"]
    single = inverse if callable(inverse) else (
        inverse[0] if len(inverse) == 1 else None)
    usable = (len(keys) == 1 and single is not None) or (
        (not callable(inverse)) and len(inverse) == len(keys) > 1)
    if not usable:
        expected = ("a callable" if len(keys) == 1 else
                    f"a tuple of {len(keys)} callables (one per input, "
                    "reference delta-node.md)")
        warnings.warn(
            f"DeltaMeta(inverse=...) ignored: expected {expected} for a "
            f"{len(keys)}-input delta node; falling back to joint-Gaussian "
            "conditioning.",
            stacklevel=2,
        )
        return None

    moments = []
    for k in keys:
        r = _rank(q, k)
        m_k, v_k = _robust_moments(q[k], r)
        moments.append((m_k, v_k, r >= 1))
    lead_in = _lead(*[(m, 1) for m, _, _ in moments],
                    *[(v, 2) for _, v, _ in moments])
    moments = [(m.expand(lead_in + m.shape[-1:]),
                v.expand(lead_in + v.shape[-2:]), vec)
               for m, v, vec in moments]
    dims_f = [m.shape[-1] for m, _, _ in moments]
    vecs_f = [vec for _, _, vec in moments]
    offs = [0]
    for d_k in dims_f:
        offs.append(offs[-1] + d_k)
    v_blk = _block_diag([v for _, v, _ in moments], dims_f, lead_in)

    # forward predictive at the current input means: in-domain values for
    # out directions the cavity does not constrain
    z_m = torch.cat([m for m, _, _ in moments], dim=-1)
    y_fwd, out_vec = _vmap_copies(fn, z_m, dims_f, vecs_f)
    m_out, v_out = _robust_moments(q["out"], 1 if out_vec else 0)
    if extra_out_cov is not None:
        v_out = v_out + extra_out_cov
    jac_m = _stat_jacobian(fn, dims_f, vecs_f, z_m, v_blk, method)
    v_fwd = sum(_mm(_mm(jac_m[..., offs[j]:offs[j + 1]], moments[j][1]),
                    _t(jac_m[..., offs[j]:offs[j + 1]]))
                for j in range(len(keys)))
    w_o = _ridged_inv(v_out)
    w_fwd = _ridged_inv(v_fwd)
    rhs = _mv(w_o, m_out) + _mv(w_fwd, y_fwd)
    w_sum = w_o + w_fwd
    lead = torch.broadcast_shapes(w_sum.shape[:-2], rhs.shape[:-1])
    m_out_comb = _solve(w_sum.expand(lead + w_sum.shape[-2:]),
                        rhs.expand(lead + rhs.shape[-1:])[..., None])[..., 0]

    others = [mo for j, mo in enumerate(moments) if j != target_idx]
    d_out = m_out_comb.shape[-1]
    if len(keys) == 1:
        x0, _ = _vmap_copies(single, m_out_comb, [d_out], [out_vec])
    else:
        parts = [m_out_comb] + [m.expand(lead + m.shape[-1:])
                                for m, _, _ in others]
        x0, _ = _vmap_copies(inverse[target_idx], torch.cat(parts, dim=-1),
                             [d_out] + [m.shape[-1] for m, _, _ in others],
                             [out_vec] + [vec for _, _, vec in others])

    # the forward Jacobian at (x0, m_others), by the method
    parts, oi = [], 0
    for j in range(len(keys)):
        if j == target_idx:
            parts.append(x0)
        else:
            parts.append(others[oi][0].expand(lead + others[oi][0].shape[-1:]))
            oi += 1
    v_blk_l = v_blk.expand(lead + v_blk.shape[-2:])
    jac = _stat_jacobian(fn, dims_f, vecs_f, torch.cat(parts, dim=-1),
                         v_blk_l, method)
    j_i = jac[..., offs[target_idx]:offs[target_idx + 1]]
    # the out belief widened by the linearized uncertainty of the others
    v_eff = v_out
    oi = 0
    for j in range(len(keys)):
        if j == target_idx:
            continue
        j_j = jac[..., offs[j]:offs[j + 1]]
        v_eff = v_eff + _mm(_mm(j_j, others[oi][1]), _t(j_j))
        oi += 1
    w_eff = _ridged_inv(v_eff)
    w_msg = _symmetrize(_mm(_mm(_t(j_i), w_eff), j_i))
    xi_msg = _mv(w_msg, x0)
    if not moments[target_idx][2]:
        return NormalWeightedMeanPrecision(xi_msg[..., 0], w_msg[..., 0, 0])
    return MvNormalWeightedMeanPrecision(xi_msg, w_msg)


def _slopes(q, keys, v, dims, s_yy, s_zy, jac):
    """Each input's slope A_j of the transform's linear model y = sum_j A_j
    z_j + b + e, e ~ N(0, Omega), and A_j V_j A_j^T: the Jacobian's columns
    under Linearization (Omega = 0); under a sigma-point or sampled
    transform the statistical slopes S_{z_j y}^T V_j^-1 (a point-mass input
    has none) and Omega = S_yy - sum_j A_j V_j A_j^T, the part of the
    output's spread the slopes do not explain."""
    slopes, spreads, off = [], [], 0
    for k, d in zip(keys, dims):
        v_j = v[..., off:off + d, off:off + d]
        if jac is not None:
            a_j = jac[..., off:off + d]
        elif isinstance(q[k], PointMass):
            a_j = None
        else:
            a_j = _t(_mm(pd_inverse(v_j), s_zy[..., off:off + d, :]))
        slopes.append(a_j)
        spreads.append(None if a_j is None else _mm(_mm(a_j, v_j), _t(a_j)))
        off += d
    if jac is not None:
        return slopes, spreads, None
    omega = s_yy
    for sp in spreads:
        if sp is not None:
            omega = omega - sp
    return slopes, spreads, _symmetrize(omega)


def _message_to_input(q, keys, m, v, dims, f0, s_yy, s_zy, out_vec, jac,
                      target_idx, noise=None):
    """The message to input ``target_idx``: the transform's joint of
    (inputs, out) conditioned on the out belief, divided by the input's own
    marginal.  Written as the pullback of the out belief through the
    input's slope A_i (``_slopes``), with the other inputs' spread, Omega
    and the noise widening it (N = Omega + sum_{j != i} A_j V_j A_j^T +
    noise):

        observed y:      W = A_i^T N^-1 A_i,   xi = A_i^T N^-1 r,
        out belief:      W = A_i^T G^-1 W_o A_i,
                         xi = A_i^T G^-1 (xi_o - W_o (f0 - A_i m_i)),
                         G = W_o N + I,

    with r = y - f0 + A_i m_i.  This equals the JAX package's conditioning
    of the joint followed by the natural-parameter division of the input's
    posterior by its marginal, without that division: in float32 it
    cancels to noise once the marginal is much tighter than the message
    (ROADMAP C12).  A Delta node's observed out (no noise) is conditioned
    on exactly, as the JAX package does."""
    out = q["out"]
    key = keys[target_idx]
    vec_i = _rank(q, key) >= 1
    if isinstance(out, PointMass) and noise is None:
        return _condition_on_point(q, m, v, dims, f0, s_yy, s_zy, out_vec,
                                   target_idx, key, vec_i)
    slopes, spreads, n_mat = _slopes(q, keys, v, dims, s_yy, s_zy, jac)
    for j, sp in enumerate(spreads):
        if j != target_idx and sp is not None:
            n_mat = sp if n_mat is None else n_mat + sp
    if noise is not None:
        n_mat = noise if n_mat is None else n_mat + noise
    off = sum(dims[:target_idx])
    m_i = m[..., off:off + dims[target_idx]]
    a_i = slopes[target_idx]
    f_lin = f0 - _mv(a_i, m_i)          # the linear model's intercept
    if isinstance(out, PointMass):
        y, _ = _moments(out, 1 if out_vec else 0)
        n_inv = pd_inverse(_symmetrize(n_mat))
        proj = _mm(_t(a_i), n_inv)
        w_msg = _mm(proj, a_i)
        xi_msg = _mv(proj, y - f_lin)
    else:
        xi_o, w_o = _info_form(out, 1 if out_vec else 0)
        do = xi_o.shape[-1]
        if n_mat is None:
            n_mat = torch.zeros_like(w_o)
        g = _mm(w_o, _symmetrize(n_mat)) + _eye(do, w_o)
        lead = torch.broadcast_shapes(g.shape[:-2], w_o.shape[:-2],
                                      xi_o.shape[:-1], f_lin.shape[:-1])
        rhs = torch.cat([w_o.expand(lead + (do, do)),
                         (xi_o - _mv(w_o, f_lin)).expand(lead + (do,))
                         [..., None]], dim=-1)
        sol = _solve(g.expand(lead + (do, do)), rhs)   # G^-1 [W_o, r_o]
        w_msg = _mm(_mm(_t(a_i), sol[..., :do]), a_i)
        xi_msg = _mv(_t(a_i), sol[..., do])
    w_msg = _symmetrize(w_msg)
    if not vec_i:
        return NormalWeightedMeanPrecision(xi_msg[..., 0], w_msg[..., 0, 0])
    return MvNormalWeightedMeanPrecision(xi_msg, w_msg)


def _condition_on_point(q, m, v, dims, f0, s_yy, s_zy, out_vec, target_idx,
                        key, vec_i):
    """A Delta node's message to an input when its out is observed: the
    joint conditioned on y exactly (K = S_zy S_yy^-1), the input's
    posterior divided by its marginal."""
    y, _ = _moments(q["out"], 1 if out_vec else 0)
    s_total = _symmetrize(s_yy)
    k = _t(_solve(s_total, _t(s_zy)))
    m_post = m + _mv(k, y - f0)
    v_post = _symmetrize(v - _mm(_mm(k, s_total), _t(k)))
    off = sum(dims[:target_idx])
    d_i = dims[target_idx]
    w_post = pd_inverse(v_post[..., off:off + d_i, off:off + d_i])
    xi_post = _mv(w_post, m_post[..., off:off + d_i])
    m_prior, v_prior = _moments(q[key], 1 if vec_i else 0)
    w_prior = pd_inverse(v_prior)
    w_msg = w_post - w_prior
    xi_msg = xi_post - _mv(w_prior, m_prior)
    if not vec_i:
        return NormalWeightedMeanPrecision(xi_msg[..., 0], w_msg[..., 0, 0])
    return MvNormalWeightedMeanPrecision(xi_msg, w_msg)


def _method(meta):
    return meta.get("method") or Linearization()


def _joint(q):
    """(keys, m, v, dims, f0, S_yy, S_zy, out is a vector, the Jacobian or
    None) of the factor's transform."""
    meta = _meta(q)
    keys = _inputs(q)
    m, v, dims, vecs = _flatten_inputs(q, keys)
    return (keys, m, v, dims,
            *_transform(meta["fn"], dims, vecs, m, v, _method(meta)))


class _IndexedInputs(type):
    """``message_to_in{i}`` is the class's ``_backward(q, i)``."""

    def __getattr__(cls, name):
        tail = name[len("message_to_in"):]
        if name.startswith("message_to_in") and tail.isdigit():
            return lambda q, _i=int(tail): cls._backward(q, _i)
        raise AttributeError(name)


@node("Delta")
class DeltaNode(metaclass=_IndexedInputs):
    """Rules dispatch on the approximation method in the factor meta."""

    # the backward rules read (and divide out) the target input's own
    # marginal; out and the inputs form one BP cluster
    needs_self_marginal = True
    cavity_cluster = ("out", "in")

    @staticmethod
    @_fp32
    def bethe_term(q):
        """The deterministic node's Bethe contribution -H[q_a] from the
        cavity beliefs: the local joint over the random inputs has precision
        blockdiag(W_i) + J^T W_out J (the first-order pullback of the out
        cavity); static inputs contribute no entropy dimensions."""
        meta = _meta(q)
        keys = _inputs(q)
        ms, dims, vecs, rand, w_blocks = [], [], [], [], []
        off = 0
        for k in keys:
            d, r = q[k], _rank(q, k)
            vecs.append(r >= 1)
            if isinstance(d, PointMass):
                m_k = d.point if r >= 1 else d.point[..., None]
                ms.append(m_k)
                dims.append(m_k.shape[-1])
                off += m_k.shape[-1]
                continue
            xi_k, w_k = _info_form(d, r)
            dk = xi_k.shape[-1]
            m_k = _solve(w_k + 1e-12 * _eye(dk, w_k), xi_k[..., None])[..., 0]
            ms.append(m_k)
            rand.append((off, dk))
            w_blocks.append(w_k)
            dims.append(dk)
            off += dk
        d_rand = sum(dk for _, dk in rand)
        lead = _lead(*[(m, 1) for m in ms])
        if d_rand == 0:
            return torch.zeros(lead)
        m_flat = torch.cat([m.expand(lead + m.shape[-1:]) for m in ms], dim=-1)
        _, out_vec, jac = _vmap_copies(meta["fn"], m_flat, dims, vecs,
                                       jacobian=True)
        _, w_out = _info_form(q["out"], 1 if out_vec else 0)
        idx = [o + i for o, dk in rand for i in range(dk)]
        jac_r = jac[..., idx]
        jmat = _mm(_mm(_t(jac_r), w_out), jac_r)
        lead = torch.broadcast_shapes(jmat.shape[:-2],
                                      *(w.shape[:-2] for w in w_blocks))
        jmat = jmat.expand(lead + jmat.shape[-2:]).clone()
        o2 = 0
        for (_, dk), w_k in zip(rand, w_blocks):
            jmat[..., o2:o2 + dk, o2:o2 + dk] += w_k
            o2 += dk
        h = 0.5 * d_rand * _LOG2PIE - 0.5 * batched_logdet(jmat)
        return -h

    @staticmethod
    @_fp32
    def message_to_out(q):
        meta = _meta(q)
        fn = meta["fn"]
        method = _method(meta)
        keys = _inputs(q)
        m, v, dims, vecs = _flatten_inputs(q, keys)
        if isinstance(method, CVIProjection) and method.out_family is not None:
            # the pushed sample cloud projected onto the requested family
            from ..engine.projection import fit_weighted_samples

            n = m.shape[-1]
            tr = torch.sum(torch.diagonal(v, dim1=-2, dim2=-1), dim=-1)
            ridge = 1e-9 * (tr / n + 1e-30)
            chol = _cholesky(_symmetrize(v) + ridge[..., None, None]
                             * _eye(n, v))
            eps = standard_normal_draws(method, n, m.dtype, m.device)
            pts = m.unsqueeze(-2) + torch.einsum("sk,...jk->...sj", eps, chol)
            ys, _ = _vmap_copies(fn, pts, dims, vecs)
            samples = ys[..., 0] if (
                method.out_family in ("gaussian", "beta", "gamma")
                and ys.shape[-1] == 1) else ys
            return fit_weighted_samples(
                method.out_family, samples,
                torch.ones((method.n_samples,), dtype=m.dtype,
                           device=m.device))
        mean, cov, _, _, _ = _transform(fn, dims, vecs, m, v, method)
        if mean.shape[-1] == 1:
            return NormalMeanVariance(mean[..., 0],
                                      torch.clamp(cov[..., 0, 0], min=1e-12))
        # the pushforward of a lower-dimensional random input is rank
        # deficient; a relative ridge keeps the moment-form message
        # invertible (point-mass inputs count no random dimensions)
        d_o = cov.shape[-1]
        d_rand = sum(dk for k, dk in zip(keys, dims)
                     if not isinstance(q[k], PointMass))
        if d_rand < d_o:
            tr = torch.sum(torch.diagonal(cov, dim1=-2, dim2=-1), dim=-1)
            cov = cov + (1e-6 * torch.abs(tr) / d_o + 1e-12)[..., None, None] \
                * _eye(d_o, cov)
        return MvNormalMeanCovariance(mean, cov)

    @staticmethod
    @_fp32
    def _backward(q, target_idx: int):
        """Message to input ``target_idx`` by joint-Gaussian conditioning:
        the joint of (inputs, out) by the method, conditioned on the out
        belief, divided by the input's own marginal."""
        meta = _meta(q)
        inverse = meta.get("inverse")
        keys = _inputs(q)
        if inverse is not None:
            msg = _known_inverse_backward(q, target_idx, keys, _method(meta),
                                          inverse)
            if msg is not None:
                return msg
        return _message_to_input(q, *_joint(q), target_idx)


# -- NonlinearGaussian: out = fn(in0, ...) + noise, the contraction of a Delta
# feeding a Gaussian mean (engine/compile.py contract_deltas).  For a linear
# fn its backward messages are the exact likelihood messages.

def _noise_rank(q, key: str, d_out: int) -> int:
    d = q[key]
    if isinstance(d, PointMass):
        ranks = _meta(q).get("_ranks") or {}
        if key in ranks:
            return int(ranks[key])
        return 2 if key == "cov" or d_out > 1 else 0
    return 2 if d.event_ndim == 2 else 0


def _ng_noise_cov(q, d_out: int):
    """The noise covariance (..., d_out, d_out)."""
    for key in ("var", "cov"):
        if key in q:
            d = q[key]
            v = d.point if isinstance(d, PointMass) else d.mean()
            return v if _noise_rank(q, key, d_out) == 2 else v[..., None, None]
    w = e_precision(q["prec"])
    if _noise_rank(q, "prec", d_out) == 0:
        return (1.0 / w)[..., None, None]
    return pd_inverse(w)


class _NonlinearGaussianBase(metaclass=_IndexedInputs):
    needs_self_marginal = True
    # out and the Gaussian inputs form one BP cluster; the noise stays
    # across the mean-field boundary (reference default constraints)
    cavity_cluster = ("out", "in")

    @classmethod
    @_fp32
    def message_to_out(cls, q):
        _, _, _, _, f0, s_yy, _, _, _ = _joint(q)
        cov = s_yy + _ng_noise_cov(q, f0.shape[-1])
        if f0.shape[-1] == 1:
            return NormalMeanVariance(f0[..., 0], cov[..., 0, 0])
        return MvNormalMeanCovariance(f0, _symmetrize(cov))

    @classmethod
    @_fp32
    def _backward(cls, q, target_idx: int):
        meta = _meta(q)
        inverse = meta.get("inverse")
        if inverse is not None:
            # the known inverse on the contracted node: the out belief seen
            # by the delta is the observation widened by the noise
            keys_i = _inputs(q)
            m, v, dims, vecs = _flatten_inputs(q, keys_i)
            f0, _ = _vmap_copies(meta["fn"], m, dims, vecs)
            noise = _ng_noise_cov(q, f0.shape[-1])
            msg = _known_inverse_backward(q, target_idx, keys_i,
                                          _method(meta), inverse,
                                          extra_out_cov=noise)
            if msg is not None:
                return msg
        joint = _joint(q)
        noise = _ng_noise_cov(q, joint[4].shape[-1])
        return _message_to_input(q, *joint, target_idx, noise=noise)

    @classmethod
    def _c2(cls, q):
        """E[(out - f(in))(out - f(in))^T], moment-matched."""
        _, _, _, _, f0, s_yy, _, out_vec, _ = _joint(q)
        m_out, v_out = _moments(q["out"], 1 if out_vec else 0)
        diff = m_out - f0
        return v_out + s_yy + diff[..., :, None] * diff[..., None, :]

    @classmethod
    def average_energy(cls, q):
        c = cls._c2(q)
        d = c.shape[-1]
        if "prec" in q and not isinstance(q["prec"], PointMass):
            w = e_precision(q["prec"])
            if _noise_rank(q, "prec", d) == 0:
                elogdet = e_log_precision(q["prec"])
                w = w[..., None, None]
            else:
                elogdet = e_logdet(q["prec"])
        else:
            noise = _ng_noise_cov(q, d)
            w = pd_inverse(noise)
            elogdet = -batched_logdet(noise)
        tr = torch.sum(w * _t(c), dim=(-2, -1))
        return 0.5 * (d * _LOG2PI - elogdet + tr)


@node("NonlinearGaussianCovariance")
class NonlinearGaussianCovarianceNode(_NonlinearGaussianBase):
    pass


@node("NonlinearGaussianPrecision")
class NonlinearGaussianPrecisionNode(_NonlinearGaussianBase):
    @classmethod
    @_fp32
    def message_to_prec(cls, q):
        c = cls._c2(q)
        if c.shape[-1] == 1:
            c2 = c[..., 0, 0]
            return GammaShapeRate(torch.full_like(c2, 1.5), 0.5 * c2)
        d = c.shape[-1]
        return WishartInverseScale(
            torch.full(c.shape[:-2], float(d) + 2.0, dtype=c.dtype,
                       device=c.device), c)
