"""Dense Kalman operations (counterpart of ``rxinfer_tpu/ops/kalman.py``).

Ported subset: ``filter_step``, the batch-major predict + update that
``parallel/filtering.filtering_scan`` takes for state dimensions above 8,
and the associative algebra of the temporally parallel smoother (Sarkka and
Garcia-Fernandez, IEEE TAC 2021): the filtering elements (A, b, C, eta, J)
with ``filter_compose`` and the RTS elements (E, g, L) with
``smooth_compose``, counterparts of ``_make_filter_elements`` /
``_filter_compose`` and ``_make_smoother_elements`` / ``_smooth_compose``.
The time-blocked smoother kernels (``csrc/fused_smoother.cu``) fold these
elements over a block of steps; ``ops/fused_smoother.py`` builds the plain
version of that design from the functions here.
Not ported yet: ``ChainParams``, the struct-of-arrays variants, the
``associative_scan`` passes (``parallel_filter`` / ``parallel_smoother``),
the sequential smoothers and ``chain_log_evidence`` (the single-dataset
``infer`` path).

Every function broadcasts over leading axes: matrices are (..., d, d),
vectors (..., d).
"""

from __future__ import annotations

import torch

from .smallmat import small_inv


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


def make_filter_elements(m0, P0, F, b, Q, xi, W):
    """All T elements of one chain, time-major: m0 (d,), P0 (d, d); F, Q
    (T-1, d, d) and b (T-1, d) indexed by t-1 (the transition into step t);
    xi (T, d), W (T, d, d).  Returns (A, b, C, eta, J), each stacked over T."""
    first = filter_first_element(m0, P0, xi[0], W[0])
    rest = filter_step_element(F, b, Q, xi[1:], W[1:])
    return tuple(torch.cat([e0[None], er], dim=0)
                 for e0, er in zip(first, rest))


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
    """All T RTS elements of one chain, time-major: filt_means (T, d),
    filt_covs (T, d, d); F, Q (T-1, d, d), b (T-1, d).  Returns (E, g, L)."""
    rest = smoother_step_element(filt_means[:-1], filt_covs[:-1], F, b, Q)
    last = smoother_last_element(filt_means[-1], filt_covs[-1])
    return tuple(torch.cat([er, el[None]], dim=0)
                 for er, el in zip(rest, last))


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
