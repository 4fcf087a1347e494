"""Closed-form small-matrix inverses and log-determinants (counterpart of
``rxinfer_tpu/ops/smallmat.py``).

Ported subset: ``small_inv``, ``small_logdet`` and ``small_solve`` over
batched ``(..., d, d)`` tensors, d <= 16, with the same cofactor / block-Schur
recursion and the same mean-|diagonal| normalization as the JAX package, so
that the port's numbers follow the reference's rounding rather than LAPACK's.
The struct-of-arrays variants are not ported.
"""

from __future__ import annotations

import torch


def _inv2(m):
    a = m[..., 0, 0]
    b = m[..., 0, 1]
    c = m[..., 1, 0]
    d = m[..., 1, 1]
    det = a * d - b * c
    inv_det = 1.0 / det
    row0 = torch.stack([d, -b], dim=-1)
    row1 = torch.stack([-c, a], dim=-1)
    return torch.stack([row0, row1], dim=-2) * inv_det[..., None, None]


def _inv3(m):
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / det
    r0 = torch.stack([co_a, -(b * i - c * h), (b * f - c * e)], dim=-1)
    r1 = torch.stack([co_b, (a * i - c * g), -(a * f - c * d)], dim=-1)
    r2 = torch.stack([co_c, -(a * h - b * g), (a * e - b * d)], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2) * inv_det[..., None, None]


def _schur_inv(ms, k, inv):
    a = ms[..., :k, :k]
    b = ms[..., :k, k:]
    c = ms[..., k:, :k]
    dd = ms[..., k:, k:]
    a_inv = inv(a)
    ca = c @ a_inv
    schur = dd - ca @ b
    s_inv = inv(schur)
    ab = a_inv @ b
    top_left = a_inv + ab @ s_inv @ ca
    top_right = -(ab @ s_inv)
    bot_left = -(s_inv @ ca)
    top = torch.cat([top_left, top_right], dim=-1)
    bot = torch.cat([bot_left, s_inv], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _inv4(m):
    """Blockwise 4x4 inverse via the 2x2 Schur complement."""
    return _schur_inv(m, 2, _inv2)


def _inv_core(ms):
    """Inverse of pre-normalized matrices, d <= 16 (4|rest for d in 5..8,
    8|rest for d in 9..16; no pivoting, safe for the SPD matrices of the
    message algebra)."""
    d = ms.shape[-1]
    if d == 1:
        return 1.0 / ms
    if d == 2:
        return _inv2(ms)
    if d == 3:
        return _inv3(ms)
    if d == 4:
        return _inv4(ms)
    return _schur_inv(ms, 8 if d > 8 else 4, _inv_core)


def _diag_scale(m):
    scale = torch.mean(torch.abs(torch.diagonal(m, dim1=-2, dim2=-1)), dim=-1)
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def small_inv(m):
    """General inverse for trailing dims d <= 16 as branch-free cofactor /
    Schur arithmetic, normalized by the mean |diagonal| so that vague
    (1e12-scaled) matrices keep their determinants inside fp32 range;
    ``torch.linalg.inv`` beyond d = 16."""
    d = m.shape[-1]
    if d > 16:
        return torch.linalg.inv(m)
    if d == 1:
        # (1 / (m / |m|)) / |m| is 1 / m bit for bit
        return 1.0 / m
    scale = _diag_scale(m)[..., None, None]
    return _inv_core(m / scale) / scale


def _det2(m):
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]


def _det3(m):
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _det4(m):
    """det(M) = det(A) det(D - C A^{-1} B) over the 2x2 blocks."""
    a = m[..., :2, :2]
    b = m[..., :2, 2:]
    c = m[..., 2:, :2]
    d = m[..., 2:, 2:]
    schur = d - c @ _inv2(a) @ b
    return _det2(a) * _det2(schur)


def _det_core(ms):
    d = ms.shape[-1]
    if d == 1:
        return ms[..., 0, 0]
    if d == 2:
        return _det2(ms)
    if d == 3:
        return _det3(ms)
    if d == 4:
        return _det4(ms)
    k = 8 if d > 8 else 4
    a = ms[..., :k, :k]
    schur = ms[..., k:, k:] - ms[..., k:, :k] @ _inv_core(a) @ ms[..., :k, k:]
    return _det_core(a) * _det_core(schur)


def small_logdet(m):
    """log|det m| for PD matrices, d <= 16 closed-form (same normalization as
    ``small_inv``), Cholesky beyond."""
    d = m.shape[-1]
    if d > 16:
        c = torch.linalg.cholesky(0.5 * (m + m.transpose(-1, -2)))
        return 2.0 * torch.sum(
            torch.log(torch.diagonal(c, dim1=-2, dim2=-1)), dim=-1)
    scale = _diag_scale(m)
    det = _det_core(m / scale[..., None, None])
    return torch.log(torch.clamp(det, min=1e-37)) + d * torch.log(scale)


def small_solve(m, x, *, matrix: bool):
    """solve(m, x) through the closed-form inverse: ``matrix=True`` for a
    matrix right-hand side (..., d, k), ``False`` for batched vectors (..., d)."""
    if m.shape[-1] > 16:
        if matrix:
            return torch.linalg.solve(m, x)
        return torch.linalg.solve(m, x[..., None])[..., 0]
    inv = small_inv(m)
    if m.shape[-1] == 1:
        # one product each, elementwise (the same bits as the matrix one)
        return inv * x if matrix else inv[..., 0] * x
    if matrix:
        return inv @ x
    return torch.einsum("...ij,...j->...i", inv, x)
