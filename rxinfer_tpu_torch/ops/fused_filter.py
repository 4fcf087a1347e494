"""Fused streaming Kalman filter over many parallel chains: the CUDA kernel
and its plain PyTorch version (counterpart of
``rxinfer_tpu/ops/pallas_filter.py``).

Math per step (information form):
    xi = HR y_t                     HR = H^T R^-1, formed outside, (d, dy)
    m_pred = F m ; P_pred = F P F^T + Q
    L = P_pred^-1 ; P = (L + W)^-1 ; m = P (L m_pred + xi)      W = H^T R^-1 H
Unlike the smoother's forward pass (``ops/fused_smoother.py``) there is no
bias, the evidence vector is formed from the raw observation inside the step,
and the transition is applied at EVERY step, t = 0 included: the state handed
in is the posterior of the step before the stream, not a prior on its first
step.  The filter emits the posterior mean of every step and the final
(m, P), which is the state a continuous-batching caller feeds to its next
call.

Kernels (the time loop inside): ``fused_filter`` replaces ``_filter_kernel``
(pallas_filter.py:84-144) and its launch ``fused_filter_soa``, which unroll
any d and dy.  d <= ``REG_MAX_DIM`` with dy <= ``REG_MAX_OBS_DIM`` launches
``filter_kernel<D, DY>`` of ``csrc/fused_filter.cu`` (one thread a chain,
the state in registers); any other d <= ``MAX_DIM``, at any dy, launches
``wide_filter_kernel`` of ``csrc/fused_filter_wide.cu`` (a chain on 16
lanes, the state padded to 16, the wide smoother's step); d > ``MAX_DIM``
raises (ROADMAP V6).  The wrapper takes the plain version when its tensors
lie on the CPU and launches a kernel when they lie on a CUDA device; there
is no fallback from a kernel to the plain version.  ``LAUNCHES`` counts
kernel launches, ``fused_filter`` for the register kernel and
``fused_filter_wide`` for the wide one.

Layout of the kernel and its plain version: struct of arrays, batch minor —
ys (T, dy, B), m0 (d, B), p0 (nsym, B) upper triangle in ``sym_idx`` order;
means (T, d, B), final m (d, B), final packed P (nsym, B).
``fused_filtering_scan`` keeps the contract of ``filtering_scan``: state
(B, d) / (B, d, d) and ys (T, B, dy) in, ``(FilterState, means (T, B, d))``
out; it pays one copy of the observations into the batch-minor layout, and a
producer that stages its observations batch-minor calls ``fused_filter``
directly.  The kernel loops to T exactly and masks the ragged batch edge, so
the time chunks, batch tiles and identity-covariance pad chains of the TPU
wrapper have no counterpart here.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from . import entrywise as ew
from .fused_smoother import (
    _host_ptr,
    _unpack_entries,
    sym_fold,
    sym_idx,
    sym_unfold_t,
)

# Largest state and observation dimensions the register kernel is
# instantiated for (a chain's state in one thread's registers, as in the
# smoother's register kernels).
REG_MAX_DIM = 8
REG_MAX_OBS_DIM = 8
# Largest state dimension of the wide kernel (its padded width); it takes
# any observation dimension.
MAX_DIM = 16

# kernel launches on CUDA tensors (the plain version on CPU tensors counts none)
LAUNCHES = {"fused_filter": 0, "fused_filter_wide": 0}


def launch_key(d: int, dy: int) -> str:
    """The ``LAUNCHES`` key of a ``fused_filter`` call at (d, dy)."""
    reg = d <= REG_MAX_DIM and dy <= REG_MAX_OBS_DIM
    return "fused_filter" if reg else "fused_filter_wide"


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _host_params(f, q, hr, w, d, dy):
    cast = lambda a: np.ascontiguousarray(
        np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a,
                   dtype=np.float32))
    f, q, hr, w = cast(f), cast(q), cast(hr), cast(w)
    if f.shape != (d, d) or q.shape != (d, d) or w.shape != (d, d) \
            or hr.shape != (d, dy):
        raise ValueError(
            f"filter parameters must be F, Q, W ({d}, {d}) and HR ({d}, {dy});"
            f" got {f.shape}, {q.shape}, {w.shape}, {hr.shape}")
    return f, q, hr, w


# -- plain PyTorch version ------------------------------------------------------

def filter_step(m, p, y_t, fe, qe, we, hre):
    """Posterior (m, P) after one observation, from the posterior of the
    step before: entry lists of (B,) tensors (or of anything with the same
    arithmetic), parameters as d x d lists of floats."""
    d = len(m)
    xi = ew.mat_vec(hre, y_t)
    m_pred = ew.mat_vec(fe, m)
    p_pred = ew.sandwich_sym(fe, p, qe)
    lam = ew.sym_inv_scaled(p_pred)
    w_post = ew.sym_alias([[lam[i][j] + we[i][j] if i <= j else None
                            for j in range(d)] for i in range(d)])
    p_new = ew.sym_inv_scaled(w_post)
    m_new = ew.mat_vec(p_new, ew.vec_add(ew.mat_vec(lam, m_pred), xi))
    return m_new, p_new


def fused_filter_reference(m0, p0, ys, f, q, hr, w):
    """Plain filter on (B,) entry tensors, batch-minor layout in and out:
    returns means (T, d, B), final m (d, B), final packed P (nsym, B).  Same
    recurrence and operation order as the kernel."""
    t_len, dy, bsz = ys.shape
    d = m0.shape[0]
    f, q, hr, w = _host_params(f, q, hr, w, d, dy)
    fe, qe, hre, we = f.tolist(), q.tolist(), hr.tolist(), w.tolist()
    nsym = d * (d + 1) // 2
    m = [m0[i] for i in range(d)]
    p = _unpack_entries([p0[k] for k in range(nsym)], d)
    means = torch.empty((t_len, d, bsz), dtype=ys.dtype, device=ys.device)
    for t in range(t_len):
        m, p = filter_step(m, p, [ys[t, k] for k in range(dy)],
                           fe, qe, we, hre)
        means[t] = torch.stack(m)
    return means, torch.stack(m), torch.stack([p[i][j] for i, j in sym_idx(d)])


# -- kernel launch --------------------------------------------------------------

def _library(wide: bool):
    lib = kernels.load("fused_filter_wide" if wide else "fused_filter")
    if not getattr(lib, "_rxt_typed", False):
        p = ctypes.c_void_p
        i64 = ctypes.c_int64
        if wide:
            lib.rxt_wide_filter.argtypes = [
                ctypes.c_int, ctypes.c_int, p, p, p, p, p, p, p, i64, i64, p,
                p, p, p]
            lib.rxt_wide_filter.restype = ctypes.c_int
            lib.rxt_wide_filter_max_dim.restype = ctypes.c_int
            if lib.rxt_wide_filter_max_dim() != MAX_DIM:
                raise RuntimeError(
                    "csrc/fused_filter_wide.cu takes d up to "
                    f"{lib.rxt_wide_filter_max_dim()}, the wrapper expects "
                    f"{MAX_DIM}")
        else:
            lib.rxt_fused_filter.argtypes = [
                ctypes.c_int, ctypes.c_int, p, p, p, p, p, p, i64, i64, p, p,
                p, p, p]
            lib.rxt_fused_filter.restype = ctypes.c_int
        lib._rxt_typed = True
    return lib


def fused_filter(m0, p0, ys, f, q, hr, w):
    """K3 wrapper, batch-minor layout: m0 (d, B), p0 (nsym, B), ys (T, dy, B);
    F, Q, W (d, d) and HR (d, dy) shared by every chain.  Returns means
    (T, d, B), final m (d, B) and final packed P (nsym, B)."""
    t_len, dy, bsz = ys.shape
    d = m0.shape[0]
    if t_len < 1:
        raise ValueError("the filter needs at least one time step")
    if not 1 <= d <= MAX_DIM or dy < 1:
        raise ValueError(
            f"state dim {d}, observation dim {dy}: the CUDA filter kernels "
            f"take d = 1..{MAX_DIM} and any dy >= 1; d > {MAX_DIM} needs a "
            "chain over a whole warp, which is not written yet (ROADMAP V6)")
    if ys.device.type == "cpu":
        return fused_filter_reference(m0, p0, ys, f, q, hr, w)
    nsym = d * (d + 1) // 2
    kernels.check_tensor("ys", ys, (t_len, dy, bsz))
    kernels.check_tensor("m0", m0, (d, bsz))
    kernels.check_tensor("p0", p0, (nsym, bsz))
    fh, qh, hrh, wh = _host_params(f, q, hr, w, d, dy)
    means = torch.empty((t_len, d, bsz), dtype=torch.float32, device=ys.device)
    mf = torch.empty((d, bsz), dtype=torch.float32, device=ys.device)
    pf = torch.empty((nsym, bsz), dtype=torch.float32, device=ys.device)
    if bsz == 0:
        return means, mf, pf
    key = launch_key(d, dy)
    lib = _library(key == "fused_filter_wide")
    stream = torch.cuda.current_stream(ys.device).cuda_stream
    if key == "fused_filter":
        rc = lib.rxt_fused_filter(
            d, dy, ys.data_ptr(), m0.data_ptr(), p0.data_ptr(),
            means.data_ptr(), mf.data_ptr(), pf.data_ptr(), t_len, bsz,
            _host_ptr(fh), _host_ptr(qh), _host_ptr(wh), _host_ptr(hrh),
            stream)
    else:
        # HR^T (dy, d) on the device (lane r of a chain reads column r),
        # copied from pinned memory without a host synchronisation
        hr_t = torch.from_numpy(np.ascontiguousarray(hrh.T)).pin_memory().to(
            ys.device, non_blocking=True)
        rc = lib.rxt_wide_filter(
            d, dy, ys.data_ptr(), m0.data_ptr(), p0.data_ptr(),
            hr_t.data_ptr(), means.data_ptr(), mf.data_ptr(), pf.data_ptr(),
            t_len, bsz, _host_ptr(fh), _host_ptr(qh), _host_ptr(wh), stream)
    kernels.check(lib, rc, f"{key} kernel")
    LAUNCHES[key] += 1
    return means, mf, pf


def evidence_operators(h, r):
    """``(W, HR)`` of an observation model y = H x + noise(R), float32 on the
    CPU: W = H^T R^-1 H (d, d) and HR = H^T R^-1 (d, dy)."""
    from ..dists.gaussian import pd_inverse

    cast = lambda a: torch.as_tensor(
        a.detach().cpu() if isinstance(a, torch.Tensor) else np.asarray(a),
        dtype=torch.float32)
    h, r = cast(h), cast(r)
    rinv = pd_inverse(r)
    w_obs = torch.einsum("ji,jk,kl->il", h, rinv, h)
    hr = torch.einsum("ji,jk->ik", h, rinv)
    return w_obs, hr


def fused_filtering_scan(state, ys, f_mat, q_cov, h, r, operators=None):
    """Drop-in fused equivalent of ``parallel.filtering.filtering_scan``:
    state (B, d) / (B, d, d) and ys (T, B, dy) in, ``(FilterState, means
    (T, B, d))`` out.  CUDA tensors go through the kernel, CPU tensors
    through its plain version.  ``operators`` takes the ``(W, HR)`` that
    ``evidence_operators(h, r)`` gives, for a caller that filters many
    streams of one model and forms them once."""
    from ..parallel.filtering import FilterState

    d = state.m.shape[-1]
    w_obs, hr = operators if operators is not None \
        else evidence_operators(h, r)
    m0 = state.m.to(torch.float32).t().contiguous()               # (d, B)
    p0 = sym_fold(state.p.to(torch.float32)).contiguous()         # (nsym, B)
    ys_soa = ys.to(torch.float32).transpose(1, 2).contiguous()    # (T, dy, B)
    means, mf, pf = fused_filter(m0, p0, ys_soa, f_mat, q_cov, hr, w_obs)
    final = FilterState(mf.t(), sym_unfold_t(pf[None], d)[0])
    return final, means.transpose(1, 2)
