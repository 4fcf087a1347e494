"""Dense Kalman operations (counterpart of ``rxinfer_tpu/ops/kalman.py``).

``filter_step``, the batch-major predict + update that
``parallel/filtering.filtering_scan`` takes for state dimensions above 8;
the associative algebra of the temporally parallel smoother (Sarkka and
Garcia-Fernandez, IEEE TAC 2021): the filtering elements (A, b, C, eta, J)
with ``filter_compose`` and the RTS elements (E, g, L) with
``smooth_compose``, counterparts of ``_make_filter_elements`` /
``_filter_compose`` and ``_make_smoother_elements`` / ``_smooth_compose``;
and the single-chain solvers of the unfused chain path: ``ChainParams``,
``SmoothResult``, ``parallel_filter`` / ``parallel_smoother`` (those
elements under ``ops/scan.associative_scan``), ``sequential_filter`` /
``sequential_smoother`` (loops over T: the oracle, and the path for short
chains) and ``chain_log_evidence``.  The time-blocked smoother kernels
(``csrc/fused_smoother.cu``) fold the same elements over a block of steps;
``ops/fused_smoother.py`` builds the plain version of that design from the
functions here.

The struct-of-arrays variants of the JAX module are a TPU layout and are
not carried over: the functions here take leading batch axes natively
(vectors (..., T, d), matrices (..., T, d, d)), every function broadcasting
over them.  The bf16 scan payload (``payload_dtype``) is not ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..dists.gaussian import pd_inverse
from .scan import associative_scan
from .smallmat import small_inv, small_logdet, small_solve


class ChainParams(NamedTuple):
    """Linear-Gaussian chain parameters, every field with the same leading
    batch axes (or broadcast against them).

    x_0 ~ N(m0, P0); x_t = F_t x_{t-1} + b_t + w_t, w_t ~ N(0, Q_t) for
    t >= 1 (no transition at t = 0); evidence on x_t in information form,
    exp(xi_t^T x - x^T W_t x / 2).  F, b, Q are indexed by t - 1, the
    transition into step t: (..., T-1, d, d) and (..., T-1, d); xi
    (..., T, d) and W (..., T, d, d); m0 (..., d), P0 (..., d, d)."""

    m0: torch.Tensor
    P0: torch.Tensor
    F: torch.Tensor
    b: torch.Tensor
    Q: torch.Tensor
    xi: torch.Tensor
    W: torch.Tensor


class SmoothResult(NamedTuple):
    means: torch.Tensor       # (..., T, d) smoothed means
    covs: torch.Tensor        # (..., T, d, d) smoothed covariances
    filt_means: torch.Tensor  # (..., T, d) filtered means
    filt_covs: torch.Tensor   # (..., T, d, d)
    cross: torch.Tensor       # (..., T-1, d, d) Cov(x_t, x_{t+1} | evidence)


def _symmetrize(m):
    return 0.5 * (m + m.transpose(-1, -2))


def _mv(m, v):
    return torch.einsum("...ij,...j->...i", m, v)


def _t(m):
    return m.transpose(-1, -2)


def filter_step(m, P, F, b, Q, xi, W):
    """One predict + update in information form, batched over leading axes:
    m (..., d), P (..., d, d), evidence vector xi (..., d) and precision W.
    Returns the posterior (m, P)."""
    m_pred = torch.einsum("...ij,...j->...i", F, m) + b
    p_pred = _symmetrize(torch.einsum("...ij,...jk,...lk->...il", F, P, F) + Q)
    p_pred_inv = _symmetrize(small_inv(p_pred))
    w_post = p_pred_inv + W
    p_new = _symmetrize(small_inv(w_post))
    xi_tot = torch.einsum("...ij,...j->...i", p_pred_inv, m_pred) + xi
    m_new = torch.einsum("...ij,...j->...i", p_new, xi_tot)
    return m_new, p_new


# -- filtering: associative elements and composition -----------------------------

def filter_first_element(m0, P0, xi0, W0):
    """Element 0: the exact filtered state at t = 0 (prior x evidence_0, no
    transition), as (A, b, C, eta, J) = (0, m_f, P_f, 0, 0)."""
    w_post0 = _symmetrize(small_inv(P0)) + W0
    c0 = _symmetrize(small_inv(w_post0))
    m0f = _mv(c0, _mv(small_inv(P0), m0) + xi0)
    return (torch.zeros_like(c0), m0f, c0, torch.zeros_like(m0f),
            torch.zeros_like(c0))


def filter_step_element(F, b, Q, xi, W):
    """Element of one step t >= 1 from the transition (F, b, Q) into the step
    and the step's evidence (xi, W) in information form.  Q and W are
    symmetric, so (I + W Q) = (I + Q W)^T and one inverse serves both."""
    eye = torch.eye(F.shape[-1], dtype=F.dtype, device=F.device)
    minv = small_inv(eye + Q @ W)                  # (I + Q W)^-1
    minv_t = _t(minv)                              # (I + W Q)^-1
    a = minv @ F
    belem = _mv(minv, b + _mv(Q, xi))
    c = minv @ Q
    f_t = _t(F)
    eta = _mv(f_t, _mv(minv_t, xi - _mv(W, b)))
    j = f_t @ (minv_t @ W) @ F
    return a, belem, _symmetrize(c), eta, _symmetrize(j)


def _time_cat(parts, mat: bool):
    """Concatenate along the time axis (-3 for matrices, -2 for vectors),
    every part broadcast to one set of leading batch axes first."""
    dim = -3 if mat else -2
    lead = torch.broadcast_shapes(*(p.shape[:dim] for p in parts))
    return torch.cat([p.expand(lead + p.shape[dim:]) for p in parts], dim=dim)


def _one_step(x, mat: bool):
    """A time axis of length one for an entry without one."""
    return x.unsqueeze(-3 if mat else -2)


_FILTER_MATS = (True, False, True, False, True)    # (A, b, C, eta, J)
_SMOOTH_MATS = (True, False, True)                 # (E, g, L)


def make_filter_elements(m0, P0, F, b, Q, xi, W):
    """All T elements of a chain, time-major behind any leading batch axes:
    m0 (..., d), P0 (..., d, d); F, Q (..., T-1, d, d) and b (..., T-1, d)
    indexed by t-1 (the transition into step t); xi (..., T, d), W
    (..., T, d, d).  Returns (A, b, C, eta, J), each stacked over T."""
    first = filter_first_element(m0, P0, xi[..., 0, :], W[..., 0, :, :])
    rest = filter_step_element(F, b, Q, xi[..., 1:, :], W[..., 1:, :, :])
    return tuple(_time_cat([_one_step(e0, mat), er], mat)
                 for e0, er, mat in zip(first, rest, _FILTER_MATS))


def filter_compose(elem_i, elem_j):
    """Associative composition elem_i (earlier) x elem_j (later), lemma 8 of
    Sarkka and Garcia-Fernandez with the offsets already folded into b and
    eta.  C_i and J_j are symmetric, so (I + J_j C_i) = (I + C_i J_j)^T: one
    general inverse covers all five solves."""
    a_i, b_i, c_i, eta_i, j_i = elem_i
    a_j, b_j, c_j, eta_j, j_j = elem_j
    eye = torch.eye(a_i.shape[-1], dtype=a_i.dtype, device=a_i.device)
    minv = small_inv(eye + c_i @ j_j)              # (I + C_i J_j)^-1
    minv_t = _t(minv)                              # (I + J_j C_i)^-1

    a = a_j @ (minv @ a_i)
    b = _mv(a_j, _mv(minv, b_i + _mv(c_i, eta_j))) + b_j
    c = a_j @ (minv @ c_i) @ _t(a_j) + c_j

    a_i_t = _t(a_i)
    eta = _mv(a_i_t, _mv(minv_t, eta_j - _mv(j_j, b_i))) + eta_i
    j = a_i_t @ (minv_t @ j_j) @ a_i + j_i
    return a, b, _symmetrize(c), eta, _symmetrize(j)


def filter_apply(m, P, elem):
    """The filtered (m, P) after the steps an element spans, from the
    filtered (m, P) just before them: the (b, C) of (0, m, P, 0, 0) x elem."""
    zero_m, zero_v = torch.zeros_like(P), torch.zeros_like(m)
    _, b, c, _, _ = filter_compose((zero_m, m, P, zero_v, zero_m), elem)
    return b, c


# -- smoothing: associative elements and composition -----------------------------

def smoother_step_element(mf, Pf, F, b, Q):
    """RTS element (E, g, L) of a step t < T-1 from its filtered moments and
    the transition out of it: x_t | x_{t+1}, y_{1:t} ~ N(E x_{t+1} + g, L)."""
    p_pred = _symmetrize(F @ Pf @ _t(F) + Q)
    e = _t(small_inv(p_pred) @ (F @ Pf))           # gain P_f F^T P_pred^-1
    g = mf - _mv(e, _mv(F, mf) + b)
    l = _symmetrize(Pf - e @ p_pred @ _t(e))
    return e, g, l


def smoother_last_element(mf, Pf):
    """Element of the last step: smoothed == filtered, (0, m_f, P_f)."""
    return torch.zeros_like(Pf), mf, Pf


def make_smoother_elements(filt_means, filt_covs, F, b, Q):
    """All T RTS elements of a chain, time-major behind any leading batch
    axes: filt_means (..., T, d), filt_covs (..., T, d, d); F, Q
    (..., T-1, d, d), b (..., T-1, d).  Returns (E, g, L)."""
    rest = smoother_step_element(filt_means[..., :-1, :],
                                 filt_covs[..., :-1, :, :], F, b, Q)
    last = smoother_last_element(filt_means[..., -1, :],
                                 filt_covs[..., -1, :, :])
    return tuple(_time_cat([er, _one_step(el, mat)], mat)
                 for er, el, mat in zip(rest, last, _SMOOTH_MATS))


def smooth_compose(elem_later, elem_earlier):
    """Composition for the backward pass.  An element is the affine map
    (m, P) smoothed at its last step + 1 -> smoothed at its first step,
    m = E m' + g, P = E P' E^T + L; the earlier element is applied to the
    result of the later one.  No inverse."""
    e_i, g_i, l_i = elem_later
    e_j, g_j, l_j = elem_earlier
    e = e_j @ e_i
    g = _mv(e_j, g_i) + g_j
    l = e_j @ l_i @ _t(e_j) + l_j
    return e, g, _symmetrize(l)


def smooth_apply(m, P, elem):
    """The smoothed (m, P) at an element's first step from the smoothed
    (m, P) just after its last step."""
    e, g, l = elem
    return _mv(e, m) + g, _symmetrize(e @ P @ _t(e) + l)


# -- the single-chain solvers ---------------------------------------------------

def parallel_filter(p: ChainParams):
    """Filtered means (..., T, d) and covariances (..., T, d, d) by one
    associative scan over the filtering elements: O(log T) levels."""
    elems = make_filter_elements(*p)
    _, b, c, _, _ = associative_scan(filter_compose, elems,
                                     dim=elems[1].ndim - 2)
    return b, c


def parallel_smoother(p: ChainParams) -> SmoothResult:
    """Filter scan, then the RTS elements under a reverse scan (the later
    chunk the left operand, as ``smooth_compose`` expects), and the
    cross-covariances Cov(x_t, x_{t+1}) = E_t P_{t+1|T}."""
    fm, fc = parallel_filter(p)
    elems = make_smoother_elements(fm, fc, p.F, p.b, p.Q)
    e_step = elems[0][..., :-1, :, :]
    _, g, l = associative_scan(smooth_compose, elems, dim=elems[1].ndim - 2,
                               reverse=True)
    return SmoothResult(g, l, fm, fc, e_step @ l[..., 1:, :, :])


def _first_filtered(p: ChainParams):
    """The filtered state at t = 0: prior x evidence_0, no transition."""
    c0 = pd_inverse(pd_inverse(p.P0) + p.W[..., 0, :, :])
    m0f = _mv(c0, small_solve(p.P0, p.m0, matrix=False) + p.xi[..., 0, :])
    return m0f, c0


def sequential_filter(p: ChainParams):
    """The filter as a loop over T (the counterpart of the JAX package's
    ``lax.scan`` filter; same outputs as ``parallel_filter``)."""
    m, c = _first_filtered(p)
    means, covs = [m], [c]
    for t in range(p.xi.shape[-2] - 1):
        f, b, q = p.F[..., t, :, :], p.b[..., t, :], p.Q[..., t, :, :]
        m_pred = _mv(f, m) + b
        p_pred = _symmetrize(f @ c @ _t(f) + q)
        c = _symmetrize(pd_inverse(pd_inverse(p_pred) + p.W[..., t + 1, :, :]))
        m = _mv(c, small_solve(p_pred, m_pred, matrix=False)
                + p.xi[..., t + 1, :])
        means.append(m)
        covs.append(c)
    return (_time_cat([_one_step(x, False) for x in means], False),
            _time_cat([_one_step(x, True) for x in covs], True))


def sequential_smoother(p: ChainParams) -> SmoothResult:
    """Filter and RTS pass as loops over T: the oracle of the scans and the
    path for short chains."""
    fm, fc = sequential_filter(p)
    t_len = fm.shape[-2]
    m, c = fm[..., -1, :], fc[..., -1, :, :]
    means, covs, cross = [m], [c], []
    for t in range(t_len - 2, -1, -1):
        mf, cf = fm[..., t, :], fc[..., t, :, :]
        f, b, q = p.F[..., t, :, :], p.b[..., t, :], p.Q[..., t, :, :]
        p_pred = _symmetrize(f @ cf @ _t(f) + q)
        e = _t(small_solve(p_pred, f @ cf, matrix=True))
        cross.append(e @ c)
        m = mf + _mv(e, m - (_mv(f, mf) + b))
        c = _symmetrize(cf + e @ (c - p_pred) @ _t(e))
        means.append(m)
        covs.append(c)
    vec = lambda xs: _time_cat([_one_step(x, False) for x in xs[::-1]], False)
    mat = lambda xs: _time_cat([_one_step(x, True) for x in xs[::-1]], True)
    if cross:
        cross_t = mat(cross)
    else:
        cross_t = fc[..., :0, :, :]
    return SmoothResult(vec(means), mat(covs), fm, fc, cross_t)


def chain_log_evidence(p: ChainParams, filt_means, filt_covs, H, c, R, y,
                       mask: Optional[torch.Tensor] = None):
    """log Z = sum_t log N(y_t; H m_{t|t-1} + c, H P_{t|t-1} H^T + R), the
    prediction-error decomposition as one batched pass over the filtered
    moments.  H (..., T, dy, d) or broadcast, c (..., T, dy), R
    (..., T, dy, dy), y (..., T, dy); ``mask`` (..., T) drops the steps
    where it is False.  Returns (...)."""
    m_pred = _time_cat([_one_step(p.m0, False),
                        _mv(p.F, filt_means[..., :-1, :]) + p.b], False)
    p_pred = _time_cat([_one_step(p.P0, True),
                        p.F @ filt_covs[..., :-1, :, :] @ _t(p.F) + p.Q],
                       True)
    mu_y = _mv(H, m_pred) + c
    s = _symmetrize(H @ p_pred @ _t(H) + R)
    diff = y - mu_y
    dy = y.shape[-1]
    if dy <= 4:
        maha = torch.sum(diff * small_solve(s, diff, matrix=False), dim=-1)
        logdet = small_logdet(s)
    else:
        chol = torch.linalg.cholesky(s)
        sol = torch.linalg.solve_triangular(chol, diff[..., None],
                                            upper=False)[..., 0]
        maha = torch.sum(sol * sol, dim=-1)
        logdet = 2.0 * torch.sum(
            torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    ll = -0.5 * (dy * math.log(2.0 * math.pi) + logdet + maha)
    if mask is not None:
        ll = torch.where(mask, ll, torch.zeros_like(ll))
    return torch.sum(ll, dim=-1)
