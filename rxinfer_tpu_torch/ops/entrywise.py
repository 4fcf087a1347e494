"""Entry-wise small-matrix algebra (counterpart of
``rxinfer_tpu/ops/entrywise.py``).

A d x d matrix is a Python list of lists of tensors (the entries, each of
shape ``(B,)`` for B chains), a vector a list of tensors; d is a Python int, so
every loop unrolls.  This is the arithmetic of the fused smoother and the
fused filter written once in PyTorch: ``ops/fused_smoother.py`` and
``ops/fused_filter.py`` build their plain versions from it, and the CUDA
kernels (``csrc/fused_smoother.cu``, ``csrc/fused_filter.cu``) perform the
same operations in the same order on per-thread registers.

Ported subset: the helpers the smoother and the filter kernels reach —
``mat_mul``, ``mat_vec``, ``mat_t``, ``mat_sub``, ``vec_add``, ``vec_sub``,
``sym_alias``, ``sandwich_sym``, ``sym_inv`` (unpivoted Schur split at
k = d // 2) and ``sym_inv_scaled`` (mean-|diagonal| scaling) — and those of
the full-matrix filtering scan (``parallel/filtering.py``): ``unstack_vec``,
``stack_vec``, ``mat_add``, ``mat_sym``, ``mat_inv`` and ``mat_inv_scaled``.
"""

from __future__ import annotations

import torch


# -- conversion -----------------------------------------------------------------

def unstack_vec(v):
    """(..., d) tensor -> list of d (...) entries."""
    return [v[..., i] for i in range(v.shape[-1])]


def stack_vec(v):
    return torch.stack(v, dim=-1)


# -- algebra --------------------------------------------------------------------

def mat_add(a, b):
    return [[x + y for x, y in zip(ra, rb)] for ra, rb in zip(a, b)]


def mat_sub(a, b):
    return [[x - y for x, y in zip(ra, rb)] for ra, rb in zip(a, b)]


def mat_t(a):
    d = len(a)
    return [[a[j][i] for j in range(d)] for i in range(d)]


def mat_mul(a, b):
    n, k, m = len(a), len(b), len(b[0])
    return [
        [sum(a[i][p] * b[p][j] for p in range(k)) for j in range(m)]
        for i in range(n)
    ]


def mat_vec(a, v):
    return [sum(a[i][j] * v[j] for j in range(len(v))) for i in range(len(a))]


def vec_add(a, b):
    return [x + y for x, y in zip(a, b)]


def vec_sub(a, b):
    return [x - y for x, y in zip(a, b)]


def mat_neg(a):
    return [[-x for x in row] for row in a]


def mat_sym(a):
    d = len(a)
    return [[0.5 * (a[i][j] + a[j][i]) for j in range(d)] for i in range(d)]


# -- general inverse (Schur recursion; pure scalar arithmetic) ------------------

def _inv1(a):
    return [[1.0 / a[0][0]]]


def _inv2_e(a):
    det = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    inv_det = 1.0 / det
    return [[a[1][1] * inv_det, -a[0][1] * inv_det],
            [-a[1][0] * inv_det, a[0][0] * inv_det]]


def _blocks(m, k):
    a = [row[:k] for row in m[:k]]
    b = [row[k:] for row in m[:k]]
    c = [row[:k] for row in m[k:]]
    dd = [row[k:] for row in m[k:]]
    return a, b, c, dd


def _join(tl, tr, bl, br):
    top = [rt + rr for rt, rr in zip(tl, tr)]
    bot = [rb + rr for rb, rr in zip(bl, br)]
    return top + bot


def mat_inv(m):
    """Inverse of a d x d entry-wise matrix by unpivoted Schur complements
    split at k = d // 2.  No normalization: use ``mat_inv_scaled`` when
    vague (1e12-scaled) magnitudes may appear."""
    d = len(m)
    if d == 1:
        return _inv1(m)
    if d == 2:
        return _inv2_e(m)
    k = d // 2
    a, b, c, dd = _blocks(m, k)
    a_inv = mat_inv(a)
    ca = mat_mul(c, a_inv)
    schur = mat_sub(dd, mat_mul(ca, b))
    s_inv = mat_inv(schur)
    ab = mat_mul(a_inv, b)
    tl = mat_add(a_inv, mat_mul(mat_mul(ab, s_inv), ca))
    tr = mat_neg(mat_mul(ab, s_inv))
    bl = mat_neg(mat_mul(s_inv, ca))
    return _join(tl, tr, bl, s_inv)


def mat_inv_scaled(m):
    """``mat_inv`` with the mean-|diagonal| normalization that keeps vague
    (1e12-scaled) determinants inside fp32 range."""
    d = len(m)
    scale = sum(torch.abs(m[i][i]) for i in range(d)) / d
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    inv_s = 1.0 / scale
    ms = [[x * inv_s for x in row] for row in m]
    inv = mat_inv(ms)
    return [[x * inv_s for x in row] for row in inv]


# -- symmetric-matrix variants (upper-triangle compute, aliased lower) --------

def sym_alias(m):
    """Make the lower triangle alias the upper one (list identity, no compute)."""
    d = len(m)
    return [[m[i][j] if i <= j else m[j][i] for j in range(d)]
            for i in range(d)]


def sandwich_sym(f, p, q):
    """F P F^T + Q for symmetric P, Q -> symmetric (aliased) result."""
    d = len(f)
    m = mat_mul(f, p)
    out = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i, d):
            out[i][j] = q[i][j] + sum(m[i][kk] * f[j][kk] for kk in range(d))
            out[j][i] = out[i][j]
    return out


def sym_inv(m):
    """Inverse of a symmetric entry-wise matrix: unpivoted Schur recursion
    split at k = d // 2, computing upper-triangle blocks only."""
    d = len(m)
    if d == 1:
        return [[1.0 / m[0][0]]]
    if d == 2:
        det = m[0][0] * m[1][1] - m[0][1] * m[0][1]
        inv_det = 1.0 / det
        x00 = m[1][1] * inv_det
        x01 = -m[0][1] * inv_det
        x11 = m[0][0] * inv_det
        return [[x00, x01], [x01, x11]]
    k = d // 2
    mm = d - k
    a = [row[:k] for row in m[:k]]
    b = [row[k:] for row in m[:k]]
    dd = [row[k:] for row in m[k:]]
    a_inv = sym_inv(a)
    ab = mat_mul(a_inv, b)                       # X = A^-1 B, k x mm
    sc = [[None] * mm for _ in range(mm)]
    for i in range(mm):
        for j in range(i, mm):
            sc[i][j] = dd[i][j] - sum(b[p][i] * ab[p][j] for p in range(k))
            sc[j][i] = sc[i][j]
    s_inv = sym_inv(sc)
    xs = mat_mul(ab, s_inv)                      # X S^-1, k x mm
    tl = [[None] * k for _ in range(k)]
    for i in range(k):
        for j in range(i, k):
            tl[i][j] = a_inv[i][j] + sum(xs[i][p] * ab[j][p]
                                         for p in range(mm))
            tl[j][i] = tl[i][j]
    top = [tl[i] + [-xs[i][p] for p in range(mm)] for i in range(k)]
    bot = [[-xs[i][p] for i in range(k)] + s_inv[p] for p in range(mm)]
    return top + bot


def sym_inv_scaled(m):
    """``sym_inv`` with the mean-|diagonal| normalization that keeps vague
    (1e12-scaled) determinants inside fp32 range."""
    d = len(m)
    scale = sum(torch.abs(m[i][i]) for i in range(d)) / d
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    inv_s = 1.0 / scale
    ms = sym_alias([[m[i][j] * inv_s if i <= j else None for j in range(d)]
                    for i in range(d)])
    inv = sym_inv(ms)
    return sym_alias([[inv[i][j] * inv_s if i <= j else None
                       for j in range(d)] for i in range(d)])
