#!/usr/bin/env python3
"""Smoke test and measurement of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device and the CUDA
toolkit (``nvcc``).  Phases, each of which fails the run when it fails:

1. Environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions, both TF32 flags (the port must leave TF32 off).
2. Build every kernel source under ``rxinfer_tpu_torch/csrc`` with ``nvcc``
   for sm_90a, all builds started together; print the ``-Xptxas -v`` lines.
3. Kernels vs plain versions on the card, on the same CUDA tensors at
   several shapes: the smoother kernels K1/K2 against
   ``fused_forward_reference`` / ``fused_backward_reference`` (RTOL/ATOL),
   and the HMM forward-backward kernels K4/K5 (both ``per_step_xi``
   variants) against ``fb_forward_reference`` / ``fb_backward_reference``
   (FB_RTOL/FB_ATOL), plus sampled chains against a float64 numpy
   forward-backward (FB_ORACLE_TOL).
4. LGSSM path at full width: ``rxinfer_tpu_torch.batched_program`` on
   ``zoo.lgssm`` with B=1024 chains, T=10,000 steps, d=4 (the constants of
   the JAX package's bench), y from a numpy seed.  Checks that the plan runs
   on the CUDA kernels with exactly one K1 and one K2 launch per call, holds
   sampled chains against a float64 numpy RTS smoother, runs
   ``infer_batched`` at a smaller batch, times the program and each stage
   with CUDA events, and profiles one program call (device busy time, idle
   share, each kernel's device time).
5. HMM path at the JAX package's bench size: ``batched_program`` on
   ``zoo.hmm(3, 3)`` with B=256 chains, T=200 steps, 20 VMP iterations, y
   simulated from a numpy seed as ``bench.py`` does.  Checks that the chain
   runs on the CUDA forward-backward kernels with exactly 20 K4 and 20 K5
   launches per call, holds sampled chains against a float64 numpy VMP
   (HMM_ORACLE_TOL), holds K4/K5 against their plain versions on the
   inputs of the path's last sweep (FB_RTOL/FB_ATOL), checks
   ``infer_batched`` against ``batched_program`` on the same rows and those
   rows against the full batch (INFER_TOL), times the program and its
   stages with CUDA events, and profiles one program call as in phase 4.
6. One JSON line listing every ported kernel with its launches on its path,
   error against its plain version, time (alone, CUDA events over launches
   back to back; ``ms_in_path``: device time per launch inside the
   program, ``torch.profiler``), bound and plain time.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or outside a checkout of the repository, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# Tolerance of kernel vs plain version on the card: the JAX package's own
# smoother test tolerance.  The two sides differ only in rounding (the kernel
# contracts a*b+c into fused multiply-adds; the plain version rounds each
# product), and the filter recursion is contractive, so differences stay at
# float32 roundoff scale.
RTOL = ATOL = 3e-4
# Tolerance of the float32 main path against the float64 RTS oracle over
# T = 10,000 steps.  The plain float32 version on the CPU lands at 3.5e-7 on
# these chains; the filter is contractive, so roundoff does not grow with T.
ORACLE_TOL = 1e-4

# Tolerance of the forward-backward kernels vs their plain versions on the
# card: the JAX package's fused-vs-scan forward-backward tolerance (atol 2e-5
# on gammas/xis, tests/engine/test_batched_engine.py:232-235), with a
# relative term for the log-space alphas and logZ and the summed xi.  Both
# sides run the same operations in the same order; they differ only where
# the compiler's expf/logf and torch's exp/log round differently.
FB_RTOL = FB_ATOL = 2e-5
# Float32 forward-backward (kernel) against a float64 oracle on the same
# inputs: max-normalised log space keeps roundoff at a few ulps per step.
FB_ORACLE_TOL = 1e-5
# The HMM main path (20 VMP sweeps in float32) against a float64 numpy VMP:
# on gammas (absolute) and on the Dirichlet concentrations (relative to
# their size, which reaches ~200 at T=200).
HMM_ORACLE_TOL = {"gammas": 1e-4, "conc_rel": 1e-4}
# The sampled rows run as a batch of 4 against the same rows in the batch of
# 256 (see hmm_path): probabilities absolute, concentrations relative.  On
# an H100 the two read 4.8e-7 on probabilities and 5.4e-7 / 7.4e-7 relative
# on A / B; absolute, A reads 1.14e-5, 1.5 float32 ulps at concentrations
# of 64-128, which is why concentrations are held relative.
INFER_TOL = 1e-5

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, 80 GB HBM3 (data sheet)
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores

MAIN_B, MAIN_T, MAIN_D = 1024, 10_000, 4
CHECK_SHAPES = [(1000, 257, 4), (37, 64, 1), (64, 100, 2), (96, 48, 3),
                (64, 32, 8), (50, 1, 4), (50, 2, 4)]
PLAIN_SHAPE = CHECK_SHAPES[0]

HMM_B, HMM_T, HMM_IT, HMM_K = 256, 200, 20, 3
FB_CHECK_SHAPES = [(1000, 257, 3), (37, 64, 2), (64, 100, 5), (64, 33, 8),
                   (16, 40, 1), (50, 1, 3), (50, 2, 3)]
HMM_ROWS = (0, 1, 128, 255)

# kernel label -> the CUDA kernel's name, as the profiler reports it
SMOOTHER_KERNEL_NAMES = {"fused_smoother_fwd": "fwd_kernel",
                         "fused_smoother_bwd": "bwd_kernel"}
FB_KERNEL_NAMES = {"fused_fb_fwd": "fb_fwd_kernel",
                   "fused_fb_bwd": "fb_bwd_kernel"}


def _cuda_ms(fn, reps: int, warmup: int = 2, inner: int = 1) -> float:
    """Milliseconds per ``fn()`` call, CUDA events: the median over ``reps``
    rounds, each timing ``inner`` calls back to back.  With ``inner`` > 1
    the host enqueues ahead of the device, so a short kernel's time is not
    inflated by its own launch overhead."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


# -- exact operation counts of one chain-step ---------------------------------------

class _OpCount:
    """Stand-in entry that counts arithmetic operations when the plain step
    functions run on it (adds, subtracts, multiplies, divides, abs,
    compare/select, maximum, exp, log, each one operation; a leading ``0 +``
    of Python's ``sum`` is not an op)."""

    n = 0

    def _op(self, other):
        if isinstance(other, int) and other == 0:
            return self
        _OpCount.n += 1
        return _OpCount()

    __add__ = __radd__ = __sub__ = __rsub__ = _op
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = __gt__ = _op

    def __neg__(self):
        return _OpCount()

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        import torch

        if func in (torch.abs, torch.where, torch.maximum, torch.exp,
                    torch.log):
            _OpCount.n += 1
            return _OpCount()
        if func is torch.ones_like:
            return _OpCount()
        raise NotImplementedError(func)


def ops_per_step(d: int) -> tuple[int, int]:
    """Operations of one forward and one backward chain-step at dim d."""
    from rxinfer_tpu_torch.ops import fused_smoother as fs

    fe = [[0.5] * d for _ in range(d)]
    be = [0.0] * d
    ent = lambda: [_OpCount() for _ in range(d)]
    mat = lambda: [[_OpCount() for _ in range(d)] for _ in range(d)]
    _OpCount.n = 0
    fs.forward_step(ent(), mat(), ent(), fe, be, fe, fe, first=False)
    n_fwd = _OpCount.n
    _OpCount.n = 0
    fs.backward_step(ent(), mat(), ent(), mat(), fe, be, fe)
    return n_fwd, _OpCount.n


def kernel_bounds(b: int, t: int, d: int) -> dict:
    """Least time (ms) the card could take for K1 and K2 at (B, T, d): each
    input read once and each output written once over the HBM rate, against
    the operations over the float32 rate."""
    nsym = d * (d + 1) // 2
    f4 = 4
    fwd_bytes = (t * b * d + b * d + b * d * d) * f4 \
        + t * (d + nsym) * b * f4
    bwd_bytes = t * (d + nsym) * b * f4 \
        + (t * (d + nsym) + (t - 1) * d * d) * b * f4
    n_fwd, n_bwd = ops_per_step(d)
    out = {}
    for name, nbytes, ops in (("fused_smoother_fwd", fwd_bytes, n_fwd * t * b),
                              ("fused_smoother_bwd", bwd_bytes,
                               n_bwd * (t - 1) * b)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOPS * 1e3
        out[name] = {
            "bytes": nbytes, "ops": ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
    return out


def fb_ops(b: int, t: int, k: int) -> tuple[int, int]:
    """Operations of K4 and of K5 (per-step xi on) over a (B, T, K) call:
    each chain-step of the plain versions run on counting stand-ins."""
    from rxinfer_tpu_torch.ops import fused_fb as ffb

    ent = lambda: [_OpCount() for _ in range(k)]
    mat = lambda: [[_OpCount() for _ in range(k)] for _ in range(k)]

    def count(fn, *args, **kw):
        _OpCount.n = 0
        fn(*args, **kw)
        return _OpCount.n

    first = count(ffb.forward_step, ent(), ent(), mat(), first=True)
    step = count(ffb.forward_step, ent(), ent(), mat(), first=False)
    # logZ from the last alphas: K-1 maxima, K shifts, K exps, K-1 adds, one
    # log and the two adds of cum + m + log(s)
    logz = 4 * k + 1
    n_fwd = (first + (t - 1) * step + logz) * b
    last = count(ffb._softmax, ent())
    bstep = count(ffb.backward_step, ent(), ent(), ent(), mat()) + k * k
    n_bwd = (last + (t - 1) * bstep) * b
    return n_fwd, n_bwd


def fb_bounds(b: int, t: int, k: int) -> dict:
    """Least time (ms) the card could take for K4 and K5 (per-step xi on)
    at (B, T, K): inputs read once and outputs written once over the HBM
    rate, against the operations over the float32 rate."""
    f4 = 4
    fwd_bytes = (b * k + b * k * k + t * b * k + t * b * k + b) * f4
    bwd_bytes = (b * k * k + 2 * t * b * k + t * b * k + b * k * k
                 + (t - 1) * b * k * k) * f4
    n_fwd, n_bwd = fb_ops(b, t, k)
    out = {}
    for name, nbytes, ops in (("fused_fb_fwd", fwd_bytes, n_fwd),
                              ("fused_fb_bwd", bwd_bytes, n_bwd)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOPS * 1e3
        out[name] = {
            "bytes": nbytes, "ops": ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
    return out


# -- the float64 oracles --------------------------------------------------------------

def rts_float64(m0, p0, xi, f, b, q, w):
    """Information-form Kalman filter + RTS smoother in float64 numpy, for a
    few chains at once (no transition at t = 0).  xi (T, n, d); returns
    smoothed means (T, n, d) and covariances (T, n, d, d)."""
    t_len, n, d = xi.shape
    f, b, q, w = (np.asarray(a, np.float64) for a in (f, b, q, w))
    mf = np.empty((t_len, n, d))
    pf = np.empty((t_len, n, d, d))
    m = np.asarray(m0, np.float64)
    p = np.asarray(p0, np.float64)
    for t in range(t_len):
        if t > 0:
            m = m @ f.T + b
            p = f @ p @ f.T + q
        lam = np.linalg.inv(p)
        p = np.linalg.inv(lam + w)
        m = np.einsum("nij,nj->ni", p,
                      np.einsum("nij,nj->ni", lam, m) + xi[t])
        mf[t], pf[t] = m, p
    ms = mf.copy()
    ps = pf.copy()
    for t in range(t_len - 2, -1, -1):
        p_pred = f @ pf[t] @ f.T + q
        g = pf[t] @ f.T @ np.linalg.inv(p_pred)
        ms[t] = mf[t] + np.einsum("nij,nj->ni", g, ms[t + 1] - (mf[t] @ f.T + b))
        ps[t] = pf[t] + g @ (ps[t + 1] - p_pred) @ np.swapaxes(g, -1, -2)
    return ms, ps


def _max_err(got, want, rtol=RTOL, atol=ATOL):
    """(max abs error, max error relative to |want|, within rtol/atol)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.size == 0:
        return 0.0, 0.0, True
    diff = np.abs(got - want)
    ok = bool(np.all(diff <= atol + rtol * np.abs(want)))
    return float(diff.max()), float((diff / np.maximum(np.abs(want), 1e-6)).max()), ok


def _smoother_params(d: int, seed: int):
    """A stable random system: F a scaled orthogonal matrix."""
    rng = np.random.default_rng(seed)
    qm, _ = np.linalg.qr(rng.standard_normal((d, d)))
    f = (0.98 * qm).astype(np.float32)
    b = (0.1 * np.arange(d)).astype(np.float32)
    q = (0.4 * np.eye(d)).astype(np.float32)
    a = rng.standard_normal((d, d)) * 0.2
    w = (0.8 * np.eye(d) + a @ a.T).astype(np.float32)
    return f, b, q, w


def check_kernels(device, shapes, log=print) -> dict:
    """Phase 3: each kernel wrapper against its plain version on the same
    inputs.  Returns per-kernel max abs error."""
    import torch

    from rxinfer_tpu_torch.ops import fused_smoother as fs

    worst = {"fused_smoother_fwd": 0.0, "fused_smoother_bwd": 0.0}
    before = dict(fs.LAUNCHES)
    failures = []
    for i, (bsz, t_len, d) in enumerate(shapes):
        f, b, q, w = _smoother_params(d, seed=100 + i)
        rng = np.random.default_rng(i)
        xi = torch.as_tensor(rng.standard_normal((t_len, bsz, d)).astype(
            np.float32), device=device)
        m0 = torch.as_tensor(rng.standard_normal((bsz, d)).astype(np.float32),
                             device=device)
        p0 = torch.as_tensor(np.broadcast_to(9.0 * np.eye(d, dtype=np.float32),
                                             (bsz, d, d)).copy(), device=device)
        mf, pf = fs.fused_forward(m0, p0, xi, f, b, q, w)
        mf_r, pf_r = fs.fused_forward_reference(m0, p0, xi, f, b, q, w)
        ms, ps, cr = fs.fused_backward(mf, pf, f, b, q)
        ms_r, ps_r, cr_r = fs.fused_backward_reference(mf, pf, f, b, q)
        if device.type == "cuda":
            torch.cuda.synchronize()
        rows = {
            "fused_smoother_fwd": [("mf", mf, mf_r), ("pf", pf, pf_r)],
            "fused_smoother_bwd": [("ms", ms, ms_r), ("ps", ps, ps_r),
                                   ("cross", cr, cr_r)],
        }
        parts = []
        for kname, items in rows.items():
            for label, got, want in items:
                ea, er, ok = _max_err(got.cpu().numpy(), want.cpu().numpy())
                worst[kname] = max(worst[kname], ea)
                parts.append(f"{label} abs {ea:.3g} rel {er:.3g}")
                if not ok:
                    failures.append(f"(B,T,d)=({bsz},{t_len},{d}) {label}: "
                                    f"abs {ea:.3g} rel {er:.3g}")
        log(f"[check] (B,T,d)=({bsz},{t_len},{d}) " + "; ".join(parts))
    if failures:
        raise AssertionError("kernel disagrees with its plain version beyond "
                             f"rtol=atol={RTOL}: " + "; ".join(failures))
    if device.type == "cuda":
        for k in worst:
            if fs.LAUNCHES[k] - before[k] != len(shapes):
                raise AssertionError(f"{k}: launch counter did not rise once "
                                     "per checked shape")
    return worst


def _lse64(x, axis):
    m = x.max(axis=axis, keepdims=True)
    return np.squeeze(m + np.log(np.exp(x - m).sum(axis=axis, keepdims=True)),
                      axis)


def fb_float64(lp, lt, le):
    """Log-space forward-backward in float64 numpy for a few chains:
    lp (n, K), lt (n, K, K) [out, in], le (T, n, K).  Returns gammas
    (T, n, K), xis (T-1, n, K, K) and logZ (n,)."""
    lp, lt, le = (np.asarray(a, np.float64) for a in (lp, lt, le))
    t_len = le.shape[0]
    la = np.empty(le.shape)
    la[0] = lp + le[0]
    for t in range(1, t_len):
        la[t] = _lse64(lt + la[t - 1][:, None, :], -1) + le[t]
    lb = np.zeros(le.shape)
    for t in range(t_len - 2, -1, -1):
        lb[t] = _lse64(lt + (le[t + 1] + lb[t + 1])[:, :, None], 1)
    logz = _lse64(la[-1], -1)
    gammas = np.exp(la + lb - logz[None, :, None])
    xis = np.exp(la[:-1, :, None, :] + lt[None]
                 + (le[1:] + lb[1:])[:, :, :, None] - logz[None, :, None, None])
    return gammas, xis, logz


def digamma64(x):
    """float64 digamma: recurrence up to x >= 6, then the asymptotic
    series (error < 1e-12 there)."""
    x = np.array(x, np.float64)
    out = np.zeros_like(x)
    while np.any(x < 6.0):
        small = x < 6.0
        out[small] -= 1.0 / x[small]
        x[small] += 1.0
    f = 1.0 / (x * x)
    return out + np.log(x) - 0.5 / x - f * (
        1 / 12 - f * (1 / 120 - f * (1 / 252 - f * (1 / 240 - f / 132))))


def hmm_vmp_float64(y, a0, b0, iterations):
    """Structured VMP on ``zoo.hmm`` for a few chains in float64: y (n, T, m)
    one-hot, initial concentrations a0 (K, K) and b0 (m, K), flat
    DirichletCollection priors and a uniform initial state.  Returns gammas
    (n, T, K) and the A (n, K, K) and B (n, m, K) concentrations."""
    y = np.asarray(y, np.float64)
    n, _, _ = y.shape
    k = a0.shape[-1]
    ca = np.broadcast_to(np.asarray(a0, np.float64), (n, k, k))
    cb = np.broadcast_to(np.asarray(b0, np.float64), (n,) + b0.shape)
    lp = np.full((n, k), np.log(np.float32(1.0 / k)), np.float64)
    for _ in range(iterations):
        elog_a = digamma64(ca) - digamma64(ca.sum(-2, keepdims=True))
        elog_b = digamma64(cb) - digamma64(cb.sum(-2, keepdims=True))
        le = np.einsum("nij,nti->tnj", elog_b, y)
        gammas, xis, _ = fb_float64(lp, elog_a, le)
        ca = 1.0 + xis.sum(0)
        cb = 1.0 + np.einsum("nti,tnj->nij", y, gammas)
    return np.moveaxis(gammas, 0, 1), ca, cb


def _fb_inputs(b, t, k, seed, device):
    import torch

    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(a.astype(np.float32), device=device) for a in (
        rng.standard_normal((b, k)), 2.0 * rng.standard_normal((b, k, k)),
        2.0 * rng.standard_normal((t, b, k))))


def check_fb_kernels(device, shapes, log=print) -> dict:
    """Phase 3 for K4/K5: each kernel wrapper against its plain version on
    the same CUDA tensors (K5 with and without the per-step xi stream), and
    a few chains of the first shape against the float64 oracle.  Returns
    per-kernel max abs error against the plain versions."""
    import torch

    from rxinfer_tpu_torch.ops import fused_fb as ffb

    worst = {"fused_fb_fwd": 0.0, "fused_fb_bwd": 0.0}
    before = dict(ffb.LAUNCHES)
    failures = []
    for i, (bsz, t_len, k) in enumerate(shapes):
        lp, lt, le = _fb_inputs(bsz, t_len, k, seed=200 + i, device=device)
        alphas, logz = ffb.fb_forward(lp, lt, le)
        alphas_r, logz_r = ffb.fb_forward_reference(lp, lt, le)
        g, xs, steps = ffb.fb_backward(lt, le, alphas, per_step_xi=True)
        g2, xs2, none = ffb.fb_backward(lt, le, alphas, per_step_xi=False)
        g_r, xs_r, steps_r = ffb.fb_backward_reference(lt, le, alphas, True)
        torch.cuda.synchronize()
        if none is not None or tuple(steps.shape) != (t_len - 1, bsz, k, k):
            failures.append(f"(B,T,K)=({bsz},{t_len},{k}): xi_steps shape")
        rows = {
            "fused_fb_fwd": [("alphas", alphas, alphas_r),
                             ("logz", logz, logz_r)],
            "fused_fb_bwd": [("gammas", g, g_r), ("xi_sum", xs, xs_r),
                             ("xi_steps", steps, steps_r),
                             ("gammas(no steps)", g2, g_r),
                             ("xi_sum(no steps)", xs2, xs_r)],
        }
        parts = []
        for kname, items in rows.items():
            for label, got, want in items:
                ea, _, ok = _max_err(got.cpu().numpy(), want.cpu().numpy(),
                                     rtol=FB_RTOL, atol=FB_ATOL)
                worst[kname] = max(worst[kname], ea)
                parts.append(f"{label} {ea:.3g}")
                if not ok:
                    failures.append(f"(B,T,K)=({bsz},{t_len},{k}) {label}: "
                                    f"abs {ea:.3g}")
        log(f"[check] (B,T,K)=({bsz},{t_len},{k}) max abs: " + "; ".join(parts))
        if i == 0:
            idx = [0, 1, bsz // 2, bsz - 1]
            o_g, o_x, o_z = fb_float64(lp[idx].cpu().numpy(),
                                       lt[idx].cpu().numpy(),
                                       le[:, idx].cpu().numpy())
            errs = {
                "gammas": float(np.abs(g[:, idx].cpu().numpy() - o_g).max()),
                "xi_steps": float(np.abs(steps[:, idx].cpu().numpy()
                                         - o_x).max()),
                "logz_rel": float((np.abs(logz[idx].cpu().numpy() - o_z)
                                   / np.abs(o_z)).max()),
            }
            log(f"[check] K4/K5 vs float64 forward-backward, chains {idx}: "
                f"{errs} (tol {FB_ORACLE_TOL})")
            if max(errs.values()) > FB_ORACLE_TOL:
                failures.append(f"float64 oracle: {errs}")
    if failures:
        raise AssertionError("forward-backward kernels disagree: "
                             + "; ".join(failures))
    if (ffb.LAUNCHES["fused_fb_fwd"] - before["fused_fb_fwd"] != len(shapes)
            or ffb.LAUNCHES["fused_fb_bwd"] - before["fused_fb_bwd"]
            != 2 * len(shapes)):
        raise AssertionError("fused_fb launch counters did not rise once per "
                             "kernel call")
    return worst


def check_fb_path_inputs(lp, lt, le, log=print) -> dict:
    """K4/K5 against their plain versions on the inputs the HMM path hands
    them in its last sweep, at the path's own (B, T, K).  Returns per-kernel
    max abs error."""
    import torch

    from rxinfer_tpu_torch.ops import fused_fb as ffb

    alphas, logz = ffb.fb_forward(lp, lt, le)
    alphas_r, logz_r = ffb.fb_forward_reference(lp, lt, le)
    g, xs, steps = ffb.fb_backward(lt, le, alphas, per_step_xi=True)
    g_r, xs_r, steps_r = ffb.fb_backward_reference(lt, le, alphas, True)
    torch.cuda.synchronize()
    rows = {
        "fused_fb_fwd": [("alphas", alphas, alphas_r), ("logz", logz, logz_r)],
        "fused_fb_bwd": [("gammas", g, g_r), ("xi_sum", xs, xs_r),
                         ("xi_steps", steps, steps_r)],
    }
    worst = {}
    parts, failures = [], []
    for kname, items in rows.items():
        worst[kname] = 0.0
        for label, got, want in items:
            ea, _, ok = _max_err(got.cpu().numpy(), want.cpu().numpy(),
                                 rtol=FB_RTOL, atol=FB_ATOL)
            worst[kname] = max(worst[kname], ea)
            parts.append(f"{label} {ea:.3g}")
            if not ok:
                failures.append(f"{label}: abs {ea:.3g}")
    t_len, bsz, k = le.shape
    log(f"[hmm] K4/K5 vs plain versions on the path's inputs, (B,T,K)="
        f"({bsz},{t_len},{k}) max abs: " + "; ".join(parts)
        + f" (rtol=atol={FB_RTOL})")
    if failures:
        raise AssertionError("forward-backward kernels disagree on the HMM "
                             "path's inputs: " + "; ".join(failures))
    return worst


def simulate_hmm(b: int, t_len: int, seed: int):
    """One-hot observations of the JAX package's HMM bench (bench.py:514-522):
    a sticky 3-state chain and a noisy identity emission, from a numpy
    seed."""
    rng = np.random.default_rng(seed)
    a_true = np.array([[0.9, 0.05, 0.05], [0.05, 0.9, 0.05],
                       [0.05, 0.05, 0.9]], np.float64)
    yh = np.zeros((b, t_len), np.int64)
    for bidx in range(b):
        s = rng.integers(3)
        for t in range(t_len):
            s = rng.choice(3, p=a_true[:, s])
            yh[bidx, t] = rng.choice(3, p=a_true[:, s])
    return np.eye(3, dtype=np.float32)[yh]


def _hmm_diffs(got, want, rows) -> dict:
    """Max differences of the HMM posteriors ``got`` from ``want`` at
    ``rows``: s probabilities absolute, A and B concentrations absolute and
    relative to their size."""
    out = {"probs_abs": float((got["s"].probs() - want["s"].probs()[rows])
                              .abs().max())}
    for n in ("A", "B"):
        diff = (got[n].alpha - want[n].alpha[rows]).abs()
        out[f"{n}_abs"] = float(diff.max())
        out[f"{n}_rel"] = float((diff / want[n].alpha[rows]).max())
    return out


def reset_launches() -> None:
    from rxinfer_tpu_torch.ops import fused_fb, fused_smoother

    fused_smoother.reset_launches()
    fused_fb.reset_launches()


def read_launches() -> dict:
    from rxinfer_tpu_torch.ops import fused_fb, fused_smoother

    return {**fused_smoother.LAUNCHES, **fused_fb.LAUNCHES}


def hmm_path(device, b: int, t_len: int, iterations: int, reps: int,
             log=print) -> dict:
    """Phase 5: the port's batched program on zoo.hmm(3, 3)."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.engine import batched as eb
    from rxinfer_tpu_torch.engine.blocks import BatchContext
    from rxinfer_tpu_torch.models import zoo
    from rxinfer_tpu_torch.ops import fused_fb as ffb

    y_host = simulate_hmm(b, t_len, seed=0)
    y = torch.as_tensor(y_host, device=device)
    a0 = np.full((3, 3), 1.0, np.float32)
    b0 = np.float32(np.eye(3) * 5.0 + 1.0)
    init = {"A": rt.DirichletCollection(a0), "B": rt.DirichletCollection(b0)}
    model = zoo.hmm(3, 3)
    compiled, prog = rt.batched_program(
        model, {"y": y}, iterations=iterations, free_energy=False,
        initialization=init, device=device)
    report = compiled.plan_report()
    log(f"[hmm] plan_report {report}")
    if report.get("s") != {"fused": True, "kernel": "fused_fb",
                           "route": "cuda"}:
        raise AssertionError("chain s is not on the CUDA forward-backward "
                             "kernels")

    reset_launches()
    state, _, _ = prog({"y": y})
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[hmm] launches in one program call: {launches}")
    want = {"fused_smoother_fwd": 0, "fused_smoother_bwd": 0,
            "fused_fb_fwd": iterations, "fused_fb_bwd": iterations}
    if launches != want:
        raise AssertionError(f"expected {want}, got {launches}")

    probs = state["s"].probs().cpu().numpy()
    conc = {n: state[n].alpha.cpu().numpy() for n in ("A", "B")}
    if probs.shape != (b, t_len, 3) or not np.isfinite(probs).all() or \
            any(not np.isfinite(c).all() for c in conc.values()):
        raise AssertionError("HMM posteriors have the wrong shape or are "
                             "not finite")

    rows = list(HMM_ROWS)
    o_g, o_a, o_b = hmm_vmp_float64(y_host[rows], a0, b0, iterations)
    errs = {
        "gammas": float(np.abs(probs[rows] - o_g).max()),
        "A_rel": float((np.abs(conc["A"][rows] - o_a) / o_a).max()),
        "B_rel": float((np.abs(conc["B"][rows] - o_b) / o_b).max()),
    }
    log(f"[hmm] float64 VMP, chains {rows}: {errs} (tol {HMM_ORACLE_TOL})")
    if errs["gammas"] > HMM_ORACLE_TOL["gammas"] or max(
            errs["A_rel"], errs["B_rel"]) > HMM_ORACLE_TOL["conc_rel"]:
        raise AssertionError(f"HMM path disagrees with the float64 VMP: {errs}")

    # infer_batched on the sampled rows against batched_program on the same
    # rows: one plan on the same shapes, so the same operations; and those
    # rows run as a batch of 4 against the same rows of the batch of 256
    sub = {"y": y[rows]}
    res = rt.infer_batched(model, sub, iterations=iterations,
                           initialization=init, device=device)
    _, prog_sub = rt.batched_program(model, sub, iterations=iterations,
                                     free_energy=False, initialization=init,
                                     device=device)
    state_sub, _, _ = prog_sub(sub)
    same = _hmm_diffs(res.posteriors, state_sub, slice(None))
    across = _hmm_diffs(state_sub, state, rows)
    log(f"[hmm] infer_batched vs batched_program on rows {rows}: {same} "
        f"(must be 0)")
    log(f"[hmm] those rows as a batch of {len(rows)} vs in the batch of {b}:"
        f" {across} (tol {INFER_TOL} on probs_abs and the *_rel)")
    if max(same.values()) != 0.0:
        raise AssertionError("infer_batched disagrees with batched_program")
    if max(across["probs_abs"], across["A_rel"], across["B_rel"]) > INFER_TOL:
        raise AssertionError("the HMM path depends on the batch size beyond "
                             f"{INFER_TOL}: {across}")

    out = {"errs": errs, "launches": launches, "batch_diffs": across}
    block = next(blk for kind, blk in compiled.blocks if blk.var.name == "s")
    groups = [blk for kind, blk in compiled.blocks if kind == "plain"]
    ctx = BatchContext(device, b, {})
    lp, elog_a, le_t = block._inputs(state, {"y": y}, {}, ctx)
    out["kernel_errs"] = check_fb_path_inputs(lp, elog_a, le_t, log=log)

    # -- timing: the program and each stage alone, on the last sweep's inputs
    out["program_ms"] = _cuda_ms(lambda: prog({"y": y}), reps)
    out["updates_per_s"] = b * iterations * (t_len + 2) / (
        out["program_ms"] / 1e3)
    alphas, _ = ffb.fb_forward(lp, elog_a, le_t)
    gammas, _, _ = ffb.fb_backward(elog_a, le_t, alphas, per_step_xi=True)
    _, cross = eb._fused_discrete_update(block, state, {"y": y}, {}, ctx)
    cc = {"s": cross}
    stages = {
        "inputs": lambda: block._inputs(state, {"y": y}, {}, ctx),
        "fwd": lambda: ffb.fb_forward(lp, elog_a, le_t),
        "bwd": lambda: ffb.fb_backward(elog_a, le_t, alphas, per_step_xi=True),
        "marginal": lambda: torch.log(torch.clamp(gammas.transpose(0, 1),
                                                  min=1e-37)),
        "plain_groups": lambda: [g.update(state, {"y": y}, cc, ctx)
                                 for g in groups],
    }
    # each stage back to back (``iterations`` times, as in one call): a
    # kernel's time is then its device time, a host-bound stage's the host's
    # cost per sweep
    for name, fn in stages.items():
        out[f"{name}_ms"] = _cuda_ms(fn, reps, inner=iterations)
    out["profile"] = _device_profile(lambda: prog({"y": y}), FB_KERNEL_NAMES)
    busy = out["profile"]["busy_ms"]
    log(f"[hmm] program {out['program_ms']:.3f} ms/call "
        f"({out['updates_per_s']:.4g} updates/s); stages alone (one sweep): "
        + ", ".join(f"{n} {out[n + '_ms']:.4f} ms" for n in stages)
        + f"; device busy {busy} ms per program call, idle "
        f"{_idle_share(out['program_ms'], busy)}; in the program "
        f"{out['profile']['kernels']}")
    return out


def _device_profile(fn, kernels: dict) -> dict:
    """One ``fn()`` call under ``torch.profiler``.  ``busy_ms`` sums the
    device events (kernels, copies, sets) only: a CPU operator's device time
    repeats that of its kernels, so summing every event would count the
    torch operators twice.  For each entry of ``kernels`` (label -> CUDA
    kernel name) it gives the launches and the device ms per launch.
    Device numbers read "not measured" when the profiler records no device
    event."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if not dev:
        return {"busy_ms": "not measured",
                "kernels": {k: {"launches": "not measured",
                                "ms_per_launch": "not measured"}
                            for k in kernels}}
    out = {"busy_ms": sum(e.device_time_total for e in dev) / 1e3,
           "kernels": {}}
    for label, name in kernels.items():
        pat = re.compile(rf"(?<!\w){name}\b")
        hits = [e.device_time_total for e in dev if pat.search(e.name)]
        out["kernels"][label] = {
            "launches": len(hits),
            "ms_per_launch": sum(hits) / 1e3 / len(hits) if hits
            else "not measured"}
    return out


def _idle_share(program_ms: float, busy_ms) -> str:
    if not isinstance(busy_ms, float):
        return "not measured"
    return f"{100 * (1 - busy_ms / program_ms):.1f}%"


def time_fb_plain(device, shape, reps: int) -> dict:
    """K4/K5 kernel and plain-version times at the same (B, T, K)."""
    from rxinfer_tpu_torch.ops import fused_fb as ffb

    lp, lt, le = _fb_inputs(*shape, seed=7, device=device)
    alphas, _ = ffb.fb_forward(lp, lt, le)
    return {
        "fused_fb_fwd": {
            "plain_ms": _cuda_ms(lambda: ffb.fb_forward_reference(lp, lt, le),
                                 reps, warmup=1),
            "ms": _cuda_ms(lambda: ffb.fb_forward(lp, lt, le), reps * 5,
                           inner=20),
        },
        "fused_fb_bwd": {
            "plain_ms": _cuda_ms(lambda: ffb.fb_backward_reference(
                lt, le, alphas, True), reps, warmup=1),
            "ms": _cuda_ms(lambda: ffb.fb_backward(lt, le, alphas, True),
                           reps * 5, inner=20),
        },
    }


def lgssm_constants(d: int):
    """The JAX package's bench constants: F = kron(I, rot(pi/35)),
    H = 1.3 I, R = Q = I, m0 = 0, P0 = 25 I."""
    theta = np.pi / 35
    rot = np.array([[np.cos(theta), -np.sin(theta)],
                    [np.sin(theta), np.cos(theta)]], dtype=np.float32)
    f = np.kron(np.eye(d // 2, dtype=np.float32), rot)
    h = 1.3 * np.eye(d, dtype=np.float32)
    r = np.eye(d, dtype=np.float32)
    q = np.eye(d, dtype=np.float32)
    m0 = np.zeros(d, np.float32)
    p0 = 25.0 * np.eye(d, dtype=np.float32)
    return f, q, h, r, m0, p0


def main_path(device, b: int, t_len: int, d: int, reps: int,
              log=print) -> dict:
    """Phase 4: the port's batched program at (B, T, d)."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo
    from rxinfer_tpu_torch.ops import fused_smoother as fs

    f, q, h, r, m0, p0 = lgssm_constants(d)
    model = zoo.lgssm(f, q, h, r, m0, p0)
    rng = np.random.default_rng(0)
    y_host = rng.standard_normal((b, t_len, d), dtype=np.float32)
    y = torch.as_tensor(y_host, device=device)
    compiled, prog = rt.batched_program(model, {"y": y}, iterations=1,
                                        free_energy=False, device=device)
    report = compiled.plan_report()
    log(f"[main] plan_report {report}")
    want_route = "cuda" if device.type == "cuda" else "plain"
    if report.get("x", {}).get("fused") is not True \
            or report["x"].get("route") != want_route:
        raise AssertionError(f"chain x is not on the fused {want_route} path")

    reset_launches()
    state, _, _ = prog({"y": y})
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = read_launches()
    log(f"[main] launches in one program call: {launches}")
    want = {"fused_smoother_fwd": 1, "fused_smoother_bwd": 1,
            "fused_fb_fwd": 0, "fused_fb_bwd": 0}
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"expected {want}, got {launches}")

    post = state["x"]
    means = post.mu.cpu().numpy()
    covs = post.sigma.cpu().numpy()
    if means.shape != (b, t_len, d) or covs.shape != (b, t_len, d, d):
        raise AssertionError(f"posterior shapes {means.shape}, {covs.shape}")
    if not (np.isfinite(means).all() and np.isfinite(covs).all()):
        raise AssertionError("non-finite posterior moments")

    # sampled chains against the float64 oracle
    rows = sorted({0, 1, b // 2, b - 1})
    hinv = h.T @ np.linalg.inv(r)
    xi = np.einsum("ij,ntj->tni", hinv.astype(np.float64),
                   y_host[rows].astype(np.float64))
    w_obs = hinv @ h
    o_m, o_p = rts_float64(np.broadcast_to(m0, (len(rows), d)),
                                np.broadcast_to(p0, (len(rows), d, d)), xi,
                                f, np.zeros(d), q, w_obs)
    errs = {
        "means": np.abs(means[rows] - np.moveaxis(o_m, 0, 1)).max(),
        "covs": np.abs(covs[rows] - np.moveaxis(o_p, 0, 1)).max(),
    }
    log(f"[main] float64 oracle, chains {rows}: max abs err means "
        f"{errs['means']:.3g}, covs {errs['covs']:.3g} (tol {ORACLE_TOL})")
    if max(errs.values()) > ORACLE_TOL:
        raise AssertionError(f"main path disagrees with the float64 oracle: {errs}")

    # infer_batched at a smaller batch: same rows, same answers
    b_small = min(64, b)
    res = rt.infer_batched(model, {"y": y[:b_small]}, device=device)
    px = res.posteriors["x"]
    diff = float((px.mu - post.mu[:b_small]).abs().max())
    log(f"[main] infer_batched B={b_small}: max |mean - batched_program mean| "
        f"= {diff:.3g}")
    if px.mu.shape != (b_small, t_len, d) or diff > 1e-4:
        raise AssertionError("infer_batched disagrees with batched_program")

    out = {"errs": errs, "launches": launches}
    if device.type != "cuda":
        return out

    # -- timing: the program and each stage alone --------------------------------
    out["program_ms"] = _cuda_ms(lambda: prog({"y": y}), reps)
    out["updates_per_s"] = 3 * t_len * b / (out["program_ms"] / 1e3)
    ek = torch.as_tensor(hinv.astype(np.float32), device=device)
    xi_t = torch.einsum("if,btf->tbi", ek, y).contiguous()
    out["einsum_ms"] = _cuda_ms(
        lambda: torch.einsum("if,btf->tbi", ek, y).contiguous(), reps)
    m0_t = torch.as_tensor(m0, device=device).expand((b, d)).contiguous()
    p0_t = torch.as_tensor(p0, device=device).expand((b, d, d)).contiguous()
    zeros = np.zeros(d, np.float32)
    mf, pf = fs.fused_forward(m0_t, p0_t, xi_t, f, zeros, q, w_obs)
    ms, ps, cr = fs.fused_backward(mf, pf, f, zeros, q)
    out["fwd_ms"] = _cuda_ms(
        lambda: fs.fused_forward(m0_t, p0_t, xi_t, f, zeros, q, w_obs), reps)
    out["bwd_ms"] = _cuda_ms(lambda: fs.fused_backward(mf, pf, f, zeros, q),
                             reps)
    out["unpack_ms"] = _cuda_ms(lambda: fs.sym_unfold_t(ps, d), reps)
    out["profile"] = _device_profile(lambda: prog({"y": y}),
                                     SMOOTHER_KERNEL_NAMES)
    busy = out["profile"]["busy_ms"]
    log(f"[main] program {out['program_ms']:.3f} ms/call "
        f"({out['updates_per_s']:.4g} updates/s); stages alone: einsum "
        f"{out['einsum_ms']:.3f} ms, K1 {out['fwd_ms']:.3f} ms, K2 "
        f"{out['bwd_ms']:.3f} ms, covariance unpack {out['unpack_ms']:.3f} ms"
        f"; device busy {busy} ms per program call, idle "
        f"{_idle_share(out['program_ms'], busy)}; in the program "
        f"{out['profile']['kernels']}")
    return out


def time_plain(device, shape, reps: int) -> dict:
    """Kernel and plain-version times at the same (B, T, d)."""
    import torch

    from rxinfer_tpu_torch.ops import fused_smoother as fs

    bsz, t_len, d = shape
    f, b, q, w = _smoother_params(d, seed=7)
    rng = np.random.default_rng(7)
    xi = torch.as_tensor(rng.standard_normal((t_len, bsz, d)).astype(
        np.float32), device=device)
    m0 = torch.zeros((bsz, d), device=device)
    p0 = torch.as_tensor(np.broadcast_to(9.0 * np.eye(d, dtype=np.float32),
                                         (bsz, d, d)).copy(), device=device)
    mf, pf = fs.fused_forward(m0, p0, xi, f, b, q, w)
    return {
        "fused_smoother_fwd": {
            "plain_ms": _cuda_ms(lambda: fs.fused_forward_reference(
                m0, p0, xi, f, b, q, w), reps, warmup=1),
            "ms": _cuda_ms(lambda: fs.fused_forward(m0, p0, xi, f, b, q, w),
                           reps * 5, inner=20),
        },
        "fused_smoother_bwd": {
            "plain_ms": _cuda_ms(lambda: fs.fused_backward_reference(
                mf, pf, f, b, q), reps, warmup=1),
            "ms": _cuda_ms(lambda: fs.fused_backward(mf, pf, f, b, q),
                           reps * 5, inner=20),
        },
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import rxinfer_tpu_torch  # noqa: F401
        from rxinfer_tpu_torch import kernels
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    device = torch.device("cuda")

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(f"[env] nvidia-smi: {smi}")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    print(f"[env] tf32: matmul.allow_tf32={tf32[0]} cudnn.allow_tf32={tf32[1]}"
          f" float32_matmul_precision={torch.get_float32_matmul_precision()}")
    if tf32[0]:
        raise AssertionError("TF32 matmuls are enabled; the port must not "
                             "enable them")

    # 2. build
    t0 = time.perf_counter()
    libs = kernels.build_all()
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        for line in kernels.ptxas_report(name).splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill")):
                print(f"[ptxas] {name}: {line.strip()}")

    # 3. kernels vs plain versions
    worst = check_kernels(device, CHECK_SHAPES)
    worst.update(check_fb_kernels(device, FB_CHECK_SHAPES))

    # 4. LGSSM path at full width
    main = main_path(device, MAIN_B, MAIN_T, MAIN_D, reps=10)
    plain = time_plain(device, PLAIN_SHAPE, reps=3)
    bounds = kernel_bounds(MAIN_B, MAIN_T, MAIN_D)
    plain_bounds = kernel_bounds(*PLAIN_SHAPE)

    # 5. HMM path at the bench size
    hmm = hmm_path(device, HMM_B, HMM_T, HMM_IT, reps=10)
    hmm_shape = (HMM_B, HMM_T, HMM_K)
    fb_plain = time_fb_plain(device, hmm_shape, reps=3)
    fbb = fb_bounds(*hmm_shape)
    for name, ms_key in (("fused_fb_fwd", "fwd_ms"),
                         ("fused_fb_bwd", "bwd_ms")):
        print(f"[hmm] {name}: {hmm[ms_key]:.4f} ms, bound "
              f"{fbb[name]['bound_ms']:.6f} ms ({fbb[name]['bound_by']}), "
              f"roofline share {100 * fbb[name]['bound_ms'] / hmm[ms_key]:.3f}%;"
              f" plain {fb_plain[name]['plain_ms']:.2f} ms vs kernel "
              f"{fb_plain[name]['ms']:.4f} ms at (B,T,K)={hmm_shape}")

    for name, ms_key in (("fused_smoother_fwd", "fwd_ms"),
                         ("fused_smoother_bwd", "bwd_ms")):
        print(f"[main] {name}: {main[ms_key]:.4f} ms, bound "
              f"{bounds[name]['bound_ms']:.4f} ms ({bounds[name]['bound_by']}),"
              f" roofline share {100 * bounds[name]['bound_ms'] / main[ms_key]:.2f}%;"
              f" plain {plain[name]['plain_ms']:.2f} ms vs kernel "
              f"{plain[name]['ms']:.4f} ms at (B,T,d)={PLAIN_SHAPE}")

    # 6. the kernels line
    source = "rxinfer_tpu_torch/csrc/fused_smoother.cu"
    rows = []
    for name, replaces, ms_key in (
            ("fused_smoother_fwd", "rxinfer_tpu/ops/pallas_smoother.py:76",
             "fwd_ms"),
            ("fused_smoother_bwd", "rxinfer_tpu/ops/pallas_smoother.py:139",
             "bwd_ms")):
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main["launches"][name],
            "max_abs_err": worst[name], "ms": main[ms_key],
            "ms_in_path": main["profile"]["kernels"][name]["ms_per_launch"],
            "plain_ms": plain[name]["plain_ms"],
            "bound_ms": bounds[name]["bound_ms"],
            "bound_by": bounds[name]["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes a Kalman/RTS "
                            "smoother",
            "shape_BTd": [MAIN_B, MAIN_T, MAIN_D],
            "bytes": bounds[name]["bytes"], "ops": bounds[name]["ops"],
            "plain_shape_BTd": list(PLAIN_SHAPE),
            "ms_at_plain_shape": plain[name]["ms"],
            "bound_ms_at_plain_shape": plain_bounds[name]["bound_ms"],
        })
    fb_source = "rxinfer_tpu_torch/csrc/fused_fb.cu"
    for name, replaces, ms_key in (
            ("fused_fb_fwd", "rxinfer_tpu/ops/pallas_discrete.py:48",
             "fwd_ms"),
            ("fused_fb_bwd", "rxinfer_tpu/ops/pallas_discrete.py:87",
             "bwd_ms")):
        rows.append({
            "name": name, "route": "cuda", "source": fb_source,
            "replaces": replaces, "launches": hmm["launches"][name],
            "max_abs_err": max(worst[name], hmm["kernel_errs"][name]),
            "max_abs_err_on_path": hmm["kernel_errs"][name],
            "ms": hmm[ms_key],
            "ms_in_path": hmm["profile"]["kernels"][name]["ms_per_launch"],
            "plain_ms": fb_plain[name]["plain_ms"],
            "bound_ms": fbb[name]["bound_ms"],
            "bound_by": fbb[name]["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes an HMM "
                            "forward-backward",
            "shape_BTK": list(hmm_shape),
            "bytes": fbb[name]["bytes"], "ops": fbb[name]["ops"],
            "plain_shape_BTK": list(hmm_shape),
        })
    print(f"[hmm] program_ms {hmm['program_ms']:.4f} updates_per_s "
          f"{hmm['updates_per_s']:.6g} (B={HMM_B}, T={HMM_T}, "
          f"iterations={HMM_IT})")
    print(f"[main] program_ms {main['program_ms']:.4f} updates_per_s "
          f"{main['updates_per_s']:.6g} (B={MAIN_B}, T={MAIN_T}, d={MAIN_D}); "
          f"total run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
