"""Fused batched Kalman (RTS) smoother: the CUDA kernel pair and its plain
PyTorch version (counterpart of ``rxinfer_tpu/ops/pallas_smoother.py``).

Math per forward step (information form; no transition at t = 0):
    m_pred = F m + b ; P_pred = F P F^T + Q
    L = P_pred^-1 ; P = (L + W)^-1 ; m = P (L m_pred + xi_t)
Backward (RTS with recomputed prediction; smoothed == filtered at T-1):
    P_pred = F P_f F^T + Q ; G = P_f F^T P_pred^-1
    m_s = m_f + G (m_s' - F m_f - b) ; P_s = P_f + G (P_s' - P_pred) G^T
    cross_t = G P_s'            [Cov(x_t, x_{t+1} | all evidence)]

Kernels (``csrc/fused_smoother.cu``, one thread per chain, time loop inside):
  * ``fused_forward``  replaces ``_fwd_kernel`` (pallas_smoother.py:76-136);
  * ``fused_backward`` replaces ``_bwd_kernel`` (pallas_smoother.py:139-203).
Each wrapper takes its plain version when its tensors lie on the CPU and
launches its kernel when they lie on a CUDA device (any other device raises);
there is no fallback from the kernel to the plain version.  ``LAUNCHES``
counts kernel launches.

Moments travel between the two kernels in struct-of-arrays layout, batch
minor: means (T, d, B), upper-triangle covariances (T, nsym, B) in
``sym_idx`` order, cross (T-1, d*d, B) row-major.  ``fused_batched_smoother``
keeps the JAX wrapper's contract: m0 (B, d), p0 (B, d, d), xi (T, B, d) ->
means (T, B, d), covs (T, B, d, d), cross (T-1, B, d, d).  Unlike the JAX
wrapper it accepts T = 1 (cross is then (0, B, d, d)).

Ported subset: the static-parameter tier (F, b, Q, W shared by every chain
and step) in float32.  Not ported: bf16 moments (``moment_dtype``) and the
per-chain W/Q tiles of the dynamic tier.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels
from . import entrywise as ew

# Largest chain state the CUDA kernels take.  Each thread keeps one chain's
# state (d + d(d+1)/2 floats) and the Schur-inverse temporaries in registers;
# the kernels are instantiated for d = 1..8, and at d = 8 the backward kernel
# already needs 255 registers.  At d = 16 the state alone is 152 floats, so
# d in (8, 16] needs another design (state in shared memory, or several
# threads per chain).
MAX_DIM = 8

# kernel launches on CUDA tensors (the plain version on CPU tensors counts none)
LAUNCHES = {"fused_smoother_fwd": 0, "fused_smoother_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- layout helpers -------------------------------------------------------------

def sym_idx(d: int) -> list:
    """Upper-triangle entry order of the packed covariances."""
    return [(i, j) for i in range(d) for j in range(i, d)]


@functools.lru_cache(maxsize=None)
def _sym_indices(d: int, device: torch.device):
    """Index tensors on ``device``, built once per (d, device): the rows and
    columns of the packed entries, and for each full-matrix entry (row-major)
    its packed slot."""
    rows, cols = zip(*sym_idx(d))
    slot = {ij: k for k, ij in enumerate(sym_idx(d))}
    full = [slot[(min(i, j), max(i, j))] for i in range(d) for j in range(d)]
    return tuple(torch.tensor(a, dtype=torch.long, device=device)
                 for a in (rows, cols, full))


def sym_fold(p: torch.Tensor) -> torch.Tensor:
    """(..., B, d, d) symmetric -> (..., nsym, B) upper-triangle SoA."""
    rows, cols, _ = _sym_indices(p.shape[-1], p.device)
    return p[..., rows, cols].movedim(-1, -2)


def sym_unfold_t(x: torch.Tensor, d: int) -> torch.Tensor:
    """(T, nsym, B) -> (T, B, d, d): gather each full-matrix entry from its
    upper-triangle slot."""
    _, _, full = _sym_indices(d, x.device)
    gathered = x[:, full, :]                                  # (T, d*d, B)
    return gathered.reshape(x.shape[0], d, d, x.shape[-1]).permute(0, 3, 1, 2)


def _host_params(f, b, q, w, d):
    cast = lambda a: np.ascontiguousarray(
        np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a,
                   dtype=np.float32))
    f, b, q, w = cast(f), cast(b), cast(q), cast(w)
    if f.shape != (d, d) or q.shape != (d, d) or w.shape != (d, d) \
            or b.shape != (d,):
        raise ValueError(
            f"smoother parameters must be F, Q, W ({d}, {d}) and b ({d},); got "
            f"{f.shape}, {q.shape}, {w.shape}, {b.shape}")
    return f, b, q, w


# -- plain PyTorch versions -------------------------------------------------------
#
# One step of each pass works on entry lists (d x d lists of (B,) tensors, or
# of anything with the same arithmetic) so the same code serves the plain
# versions and an exact operation count of the kernels' steps.

def forward_step(m, p, xi_t, fe, be, qe, we, first: bool):
    """Filtered (m, P) at step t from the filtered (m, P) at t-1 (or the
    prior at t = 0, where there is no transition)."""
    d = len(m)
    if first:
        m_pred, p_pred = m, p
    else:
        m_pred = [a + bb for a, bb in zip(ew.mat_vec(fe, m), be)]
        p_pred = ew.sandwich_sym(fe, p, qe)
    lam = ew.sym_inv_scaled(p_pred)
    w_post = ew.sym_alias([[lam[i][j] + we[i][j] if i <= j else None
                            for j in range(d)] for i in range(d)])
    p_new = ew.sym_inv_scaled(w_post)
    m_new = ew.mat_vec(p_new, ew.vec_add(ew.mat_vec(lam, m_pred), xi_t))
    return m_new, p_new


def backward_step(m_f, p_f, m_s, p_s, fe, be, qe):
    """Smoothed (m, P) at step t and cross Cov(x_t, x_{t+1}) from the
    filtered moments at t and the smoothed ones at t+1."""
    d = len(m_f)
    p_pred = ew.sandwich_sym(fe, p_f, qe)
    gain = ew.mat_mul(ew.mat_mul(p_f, ew.mat_t(fe)), ew.sym_inv_scaled(p_pred))
    m_pred_next = [a + bb for a, bb in zip(ew.mat_vec(fe, m_f), be)]
    m_new = ew.vec_add(m_f, ew.mat_vec(gain, ew.vec_sub(m_s, m_pred_next)))
    gd = ew.mat_mul(gain, ew.mat_sub(p_s, p_pred))
    p_new = ew.sym_alias([
        [p_f[i][j] + sum(gd[i][kk] * gain[j][kk] for kk in range(d))
         if i <= j else None for j in range(d)] for i in range(d)])
    cross = ew.mat_mul(gain, p_s)
    return m_new, p_new, cross


def _unpack_entries(entries, d):
    full = [[None] * d for _ in range(d)]
    for e, (i, j) in zip(entries, sym_idx(d)):
        full[i][j] = e
        full[j][i] = e
    return full


def fused_forward_reference(m0, p0, xi, f, b, q, w):
    """Plain forward pass on (B,) entry tensors; returns mf (T, d, B) and
    pf (T, nsym, B).  Same recurrence and operation order as the kernel."""
    t_len, bsz, d = xi.shape
    f, b, q, w = _host_params(f, b, q, w, d)
    fe, be, qe, we = f.tolist(), b.tolist(), q.tolist(), w.tolist()
    m = [m0[:, i] for i in range(d)]
    p = ew.sym_alias([[p0[:, i, j] if i <= j else None for j in range(d)]
                      for i in range(d)])
    mf = torch.empty((t_len, d, bsz), dtype=xi.dtype, device=xi.device)
    pf = torch.empty((t_len, d * (d + 1) // 2, bsz), dtype=xi.dtype,
                     device=xi.device)
    for t in range(t_len):
        xi_t = [xi[t, :, k] for k in range(d)]
        m, p = forward_step(m, p, xi_t, fe, be, qe, we, first=t == 0)
        mf[t] = torch.stack(m)
        pf[t] = torch.stack([p[i][j] for i, j in sym_idx(d)])
    return mf, pf


def fused_backward_reference(mf, pf, f, b, q):
    """Plain RTS pass over the filtered SoA streams; returns ms (T, d, B),
    ps (T, nsym, B) and cross (T-1, d*d, B)."""
    t_len, d, bsz = mf.shape
    f, b, q, _ = _host_params(f, b, q, q, d)
    fe, be, qe = f.tolist(), b.tolist(), q.tolist()
    nsym = d * (d + 1) // 2
    ms = torch.empty_like(mf)
    ps = torch.empty_like(pf)
    cross = torch.empty((t_len - 1, d * d, bsz), dtype=mf.dtype,
                        device=mf.device)
    ms[t_len - 1] = mf[t_len - 1]
    ps[t_len - 1] = pf[t_len - 1]
    m_s = [mf[t_len - 1, i] for i in range(d)]
    p_s = _unpack_entries([pf[t_len - 1, k] for k in range(nsym)], d)
    for t in range(t_len - 2, -1, -1):
        m_f = [mf[t, i] for i in range(d)]
        p_f = _unpack_entries([pf[t, k] for k in range(nsym)], d)
        m_s, p_s, cr = backward_step(m_f, p_f, m_s, p_s, fe, be, qe)
        cross[t] = torch.stack([cr[i][j] for i in range(d) for j in range(d)])
        ms[t] = torch.stack(m_s)
        ps[t] = torch.stack([p_s[i][j] for i, j in sym_idx(d)])
    return ms, ps, cross


# -- kernel launches ----------------------------------------------------------------

def _library():
    lib = kernels.load("fused_smoother")
    if not getattr(lib, "_rxt_typed", False):
        p = ctypes.c_void_p
        lib.rxt_fused_smoother_fwd.argtypes = [
            ctypes.c_int, p, p, p, p, p, ctypes.c_int64, ctypes.c_int64,
            p, p, p, p, p]
        lib.rxt_fused_smoother_fwd.restype = ctypes.c_int
        lib.rxt_fused_smoother_bwd.argtypes = [
            ctypes.c_int, p, p, p, p, p, ctypes.c_int64, ctypes.c_int64,
            p, p, p, p]
        lib.rxt_fused_smoother_bwd.restype = ctypes.c_int
        lib._rxt_typed = True
    return lib


def _host_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _check_dims(t_len, d):
    if t_len < 1:
        raise ValueError("the smoother needs at least one time step")
    if not 1 <= d <= MAX_DIM:
        raise ValueError(
            f"state dim {d}: the CUDA smoother kernels are instantiated for "
            f"d = 1..{MAX_DIM}")


def fused_forward(m0, p0, xi, f, b, q, w):
    """K1 wrapper: filtered moments mf (T, d, B), pf (T, nsym, B)."""
    t_len, bsz, d = xi.shape
    _check_dims(t_len, d)
    if xi.device.type == "cpu":
        return fused_forward_reference(m0, p0, xi, f, b, q, w)
    kernels.check_tensor("xi", xi, (t_len, bsz, d))
    kernels.check_tensor("m0", m0, (bsz, d))
    kernels.check_tensor("p0", p0, (bsz, d, d))
    fh, bh, qh, wh = _host_params(f, b, q, w, d)
    nsym = d * (d + 1) // 2
    mf = torch.empty((t_len, d, bsz), dtype=torch.float32, device=xi.device)
    pf = torch.empty((t_len, nsym, bsz), dtype=torch.float32, device=xi.device)
    if bsz == 0:
        return mf, pf
    lib = _library()
    stream = torch.cuda.current_stream(xi.device).cuda_stream
    rc = lib.rxt_fused_smoother_fwd(
        d, xi.data_ptr(), m0.data_ptr(), p0.data_ptr(), mf.data_ptr(),
        pf.data_ptr(), t_len, bsz, _host_ptr(fh), _host_ptr(bh),
        _host_ptr(qh), _host_ptr(wh), stream)
    kernels.check(lib, rc, "fused_smoother forward kernel")
    LAUNCHES["fused_smoother_fwd"] += 1
    return mf, pf


def fused_backward(mf, pf, f, b, q):
    """K2 wrapper: smoothed ms (T, d, B), ps (T, nsym, B), cross
    (T-1, d*d, B) from the forward kernel's streams."""
    t_len, d, bsz = mf.shape
    _check_dims(t_len, d)
    if mf.device.type == "cpu":
        return fused_backward_reference(mf, pf, f, b, q)
    nsym = d * (d + 1) // 2
    kernels.check_tensor("mf", mf, (t_len, d, bsz))
    kernels.check_tensor("pf", pf, (t_len, nsym, bsz))
    fh, bh, qh, _ = _host_params(f, b, q, q, d)
    ms = torch.empty_like(mf)
    ps = torch.empty_like(pf)
    cross = torch.empty((t_len - 1, d * d, bsz), dtype=torch.float32,
                        device=mf.device)
    if bsz == 0:
        return ms, ps, cross
    lib = _library()
    stream = torch.cuda.current_stream(mf.device).cuda_stream
    rc = lib.rxt_fused_smoother_bwd(
        d, mf.data_ptr(), pf.data_ptr(), ms.data_ptr(), ps.data_ptr(),
        cross.data_ptr(), t_len, bsz, _host_ptr(fh), _host_ptr(bh),
        _host_ptr(qh), stream)
    kernels.check(lib, rc, "fused_smoother backward kernel")
    LAUNCHES["fused_smoother_bwd"] += 1
    return ms, ps, cross


def _unpack(ms, ps, cross, d):
    """SoA streams -> contract layout (views except the covariance gather)."""
    t_len = ms.shape[0]
    means = ms.permute(0, 2, 1)                               # (T, B, d)
    covs = sym_unfold_t(ps, d)                                # (T, B, d, d)
    crossm = cross.reshape(t_len - 1, d, d, cross.shape[-1]).permute(0, 3, 1, 2)
    return means, covs, crossm


def fused_batched_smoother(m0, p0, xi, f, b, q, w):
    """Batch-axis smoother: m0 (B, d), p0 (B, d, d), xi (T, B, d); F, Q, W
    (d, d) and b (d,) shared.  Returns smoothed means (T, B, d), covs
    (T, B, d, d), cross (T-1, B, d, d) = Cov(x_t, x_{t+1}).  CUDA tensors go
    through the two kernels; CPU tensors through their plain versions."""
    d = xi.shape[-1]
    mf, pf = fused_forward(m0, p0, xi, f, b, q, w)
    ms, ps, cross = fused_backward(mf, pf, f, b, q)
    return _unpack(ms, ps, cross, d)


def fused_batched_smoother_reference(m0, p0, xi, f, b, q, w):
    """The plain version of ``fused_batched_smoother`` on any device (the
    card-side yardstick the kernels are held against)."""
    d = xi.shape[-1]
    mf, pf = fused_forward_reference(m0, p0, xi, f, b, q, w)
    ms, ps, cross = fused_backward_reference(mf, pf, f, b, q)
    return _unpack(ms, ps, cross, d)
