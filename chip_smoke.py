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
   at shapes that take one time block and shapes that take many (the most
   the wrapper's rule gives, and a ragged last block), and the HMM
   forward-backward kernels K4/K5 (both ``per_step_xi`` variants) against
   ``fb_forward_reference`` / ``fb_backward_reference`` at the wrapper's
   marginal tile (FB_RTOL/FB_ATOL; shapes with one tile, many tiles, ragged
   staged and marginal tiles, and a large batch), xi_sum bit-identical over
   repeated calls, plus sampled chains against a float64 numpy
   forward-backward (FB_ORACLE_TOL).  The plain versions of K1/K2 are timed
   by their one call at the first check shape.  The K4/K5 checks, and
   phase 6's, run in a second process while this one checks K1/K2: the
   plain versions are host-bound loops, seconds a call.
4. LGSSM path at full width: ``rxinfer_tpu_torch.batched_program`` on
   ``zoo.lgssm`` with B=1024 chains, T=10,000 steps, d=4 (the constants of
   the JAX package's bench), y from a numpy seed.  Checks that the plan runs
   on the CUDA kernels with exactly one K1 and one K2 launch per call, holds
   sampled chains against a float64 numpy RTS smoother, runs
   ``infer_batched`` at a smaller batch, times the program and each stage
   with CUDA events, and profiles one program call (device busy time, idle
   share, each kernel's device time; the fold, carry and replay passes of
   K1 and K2 apart), at the wrapper's own number of time blocks.
5. HMM path at the JAX package's bench size: ``batched_program`` on
   ``zoo.hmm(3, 3)`` with B=256 chains, T=200 steps, 20 VMP iterations, y
   simulated from a numpy seed as ``bench.py`` does.  Checks that the chain
   runs on the CUDA forward-backward kernels with exactly 20 K4 and 20 K5
   launches per call, holds sampled chains against a float64 numpy VMP
   (HMM_ORACLE_TOL), holds K4/K5 against their plain versions on the
   inputs of the path's last sweep (FB_RTOL/FB_ATOL), checks
   ``infer_batched`` against ``batched_program`` on the same rows and those
   rows against the full batch (INFER_TOL), times the program and its
   stages with CUDA events, and profiles one program call as in phase 4
   (K5's beta, marginal and xi_sum passes apart).  Then K4 and K5 alone at
   the path's shape, beside the SM clock sampled meanwhile.  The plain
   versions are timed by their one call on the path's inputs.
6. (Run beside phase 3.) Filter and quantization kernels vs plain
   versions on the card: the streaming filter kernel K3 against
   ``fused_filter_reference`` at several (B, T, d, dy) (RTOL/ATOL), a
   ragged last warp at path A's width included, and sampled chains
   against a float64 filter; the quantize kernels K6/K7 against their
   plain versions (payload bytes and scales must be EQUAL, a zero row
   included) at
   QUANT_CHECK_SHAPES, which take each of their layouts
   (``pick_quant_layout``: narrow, wide, general) and a view that starts 4
   bytes into its storage; the dequantize + product kernel K8 on both
   payload types at DEQUANT_CHECK_SHAPES, which take each of its layouts
   (``pick_dequant_layout``: vector, general) and a payload view that
   starts 4 bytes into its storage (outputs must be EQUAL).
7. Path A, continuous-batching filter at full width:
   ``parallel.filtering.make_sharded_filtering(None, ..., fused=True)`` over
   a (T, B, dy) stream of B=10,000 chains, T=200 steps, d=dy=4 with the
   LGSSM constants.  One K3 launch per call; final state and sampled means
   against the float64 filter (ORACLE_TOL); the call and K3 alone (beside
   the SM clock) timed, K3's plain version by its one call on the path's
   inputs; one call profiled (K3's cycles a step).
8. Path B, quantized ingest.  (i) The LGSSM program of phase 4 with
   ``options={"observation_dtype": "int8" | "float8_e4m3fn"}`` at 1 and 10
   iterations beside the float32 program: one K6 or K7 launch per call
   whatever the iterations, posterior means within INT8_LEVEL / FP8_LEVEL of
   the float32 run's and equal (DEQ_TOL) to the float32 program run on the
   dequantized observations.  (ii) ``quantized_evidence`` and
   ``quantized_evidence_fp8`` at 2^21 rows, dy=16 -> dx=4: one K6 or K7 and
   one K8 launch per call, the result against the float32 product.  Both
   time K6/K7 alone with the layout their rows took, beside a device copy
   of the same rows (``torch.empty_like(x).copy_(x)``) as a yardstick of
   the bandwidth the card reaches; (ii) times K8 alone with its layout,
   beside a device copy of its payload and of its output.
9. The single-dataset ``infer`` and the unfused chain path, which launch
   no kernel (every kernel module's launch count must stay at zero):
   (a) ``infer`` on ``zoo.lgssm`` with one dataset of T=10,000, d=4 (the
   JAX package's single-chain row): the float64 RTS (ORACLE_TOL), the
   median of 5 calls (CUDA events), updates/s = 3 T / t, the device busy
   and idle share of one profiled call; (b) ``infer`` on ``zoo.hmm(3, 3)``,
   one dataset of T=200, 20 iterations, phase 5's initialization: the
   float64 VMP (HMM_ORACLE_TOL) and its time; (c) phase 4's cell with
   ``options={"fused_kernels": False}``: the plan report, the posteriors
   against the fused program's (ORACLE_TOL), the median of 3 calls beside
   the fused program's phase 4 time, and its peak device memory; (d) ``infer_batched`` on 64
   LGSSM chains of T=10,000 with 10% of the steps NaN: the plan report and
   sampled chains against the float64 RTS with no evidence at the missing
   steps (ORACLE_TOL).
10. One JSON line listing every ported kernel with its launches on its path,
   error against its plain version, time (alone, CUDA events over launches
   back to back; ``ms_in_path``: device time per launch inside the
   path's call, ``torch.profiler``), bound and plain time.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or outside a checkout of the repository, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import multiprocessing
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
# (8, 1056, 4): the most time blocks the wrapper's rule gives at that T (33
# of 32 steps); (40, 1001, 3): a ragged last block (30 of 33 steps and one of
# 11); (12, 300, 5): several blocks at the largest d with a fold kernel.
CHECK_SHAPES = [(1000, 257, 4), (37, 64, 1), (64, 100, 2), (96, 48, 3),
                (64, 32, 8), (50, 1, 4), (50, 2, 4), (8, 1056, 4),
                (40, 1001, 3), (12, 300, 5)]
BLOCKED_SHAPES = {(1000, 257, 4): 8, (8, 1056, 4): 33, (40, 1001, 3): 31,
                  (12, 300, 5): 9}       # shape -> time blocks on 132 SMs
PLAIN_SHAPE = CHECK_SHAPES[0]

HMM_B, HMM_T, HMM_IT, HMM_K = 256, 200, 20, 3
# (40, 1001, 3): ragged last staged tile (1001 = 31 * 32 + 9) and many
# marginal tiles; (8, 4099, 8): the most marginal tiles of the list, ragged;
# (8448, 64, 3): a batch that takes one marginal tile per 16 steps
FB_CHECK_SHAPES = [(1000, 257, 3), (37, 64, 2), (64, 100, 5), (64, 33, 8),
                   (16, 40, 1), (50, 1, 3), (50, 2, 3), (40, 1001, 3),
                   (8, 4099, 8), (8448, 64, 3)]
HMM_ROWS = (0, 1, 128, 255)
NAN_B = 64          # phase 9 (d): chains of the NaN batch

# The quantized LGSSM program against the float32 program on the
# dequantized observations (the two evidence einsums read different layouts
# and may sum in different orders).  K8 is held EQUAL to its plain version:
# both round every product and sum on its own, in the same order.
DEQ_TOL = 1e-5
# Posterior means on quantized observations against the float32 run, as a
# share of max |mean|: the JAX package's engine-test levels.
INT8_LEVEL, FP8_LEVEL = 0.05, 0.07

FILTER_B, FILTER_T, FILTER_D = 10_000, 200, 4
# (10_001, 200, 4, 4) is path A's shape with a ragged last warp.
FILTER_CHECK_SHAPES = [(1000, 257, 4, 4), (10_001, 200, 4, 4), (37, 64, 2, 3),
                       (64, 33, 8, 8), (16, 40, 1, 1), (50, 1, 3, 3)]
# (R, C, start): rows of x from ``start`` floats into its storage.  Each of
# the quantize kernels' layouts is taken (narrow with 4 row groups a thread
# and with 1, narrow with a warp a row, wide, general), and the general one
# for rows that are not 16-byte aligned: C % 4 != 0, past the wide layout's
# register cap, or a contiguous view that starts 4 bytes into its storage.
QUANT_CHECK_SHAPES = [(1 << 21, 16, 0), (100_001, 16, 0), (4096, 10_000, 0),
                      (5, 16_388, 0), (1024, 1001, 0), (4096, 16, 1),
                      (4096, 200, 0), (100_000, 16, 0), (777, 6, 0),
                      (3, 1, 0)]
# (R, dy, dx, start): a payload view ``start`` bytes into its storage.  Each
# of K8's layouts is taken (``pick_dequant_layout``: vector with 4 rows a
# thread and with 1; general for odd dy, rows of 8 bytes and the view that
# starts off 16 bytes).
DEQUANT_CHECK_SHAPES = [(1 << 21, 16, 4, 0), (100_001, 16, 4, 0),
                        (4096, 32, 8, 0), (1000, 3, 5, 0), (65_536, 8, 3, 0),
                        (5000, 16, 4, 4)]
QUANT_SHAPE = (MAIN_B * MAIN_D, MAIN_T)        # the engine's rows (B*F, T)
INGEST_SHAPE = (1 << 21, 16, 4)                # rows, dy, dx
QUANT_ITERATIONS = (1, 10)

# kernel label -> the CUDA kernel's name, as the profiler reports it
FILTER_KERNEL_NAMES = {"fused_filter": "filter_kernel"}
QUANT_KERNEL_NAMES = {
    "quantize_rows": r"quantize_(?:narrow|wide|general)_kernel<.*Int8Payload",
    "quantize_rows_fp8": r"quantize_(?:narrow|wide|general)_kernel<.*Fp8Payload",
                      "dequant_matmul": "dequant_matmul_kernel"}
# one wrapper call is up to three device kernels, the last always launched
SMOOTHER_KERNEL_NAMES = {
    "fused_smoother_fwd": ("fwd_fold_kernel", "fwd_carry_kernel",
                           "fwd_replay_kernel"),
    "fused_smoother_bwd": ("bwd_fold_kernel", "bwd_carry_kernel",
                           "bwd_replay_kernel")}
FB_KERNEL_NAMES = {"fused_fb_fwd": ("fb_fwd_kernel",),
                   "fused_fb_bwd": ("fb_beta_kernel", "fb_xisum_kernel",
                                    "fb_marg_kernel")}


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


def _once_ms(fn):
    """``fn()``'s result and its milliseconds, one call between CUDA events
    after a synchronize: the time of a plain version that a check runs
    anyway (thousands of small launches, seconds a call)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


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
    few chains at once (no transition at t = 0).  xi (T, n, d); w (d, d)
    shared or (T, n, d, d) a step; returns smoothed means (T, n, d) and
    covariances (T, n, d, d)."""
    t_len, n, d = xi.shape
    f, b, q, w = (np.asarray(a, np.float64) for a in (f, b, q, w))
    w_at = (lambda t: w[t]) if w.ndim == 4 else (lambda t: w)
    mf = np.empty((t_len, n, d))
    pf = np.empty((t_len, n, d, d))
    m = np.asarray(m0, np.float64)
    p = np.asarray(p0, np.float64)
    for t in range(t_len):
        if t > 0:
            m = m @ f.T + b
            p = f @ p @ f.T + q
        lam = np.linalg.inv(p)
        p = np.linalg.inv(lam + w_at(t))
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


def check_kernels(device, shapes, log=print) -> tuple[dict, dict]:
    """Phase 3: each kernel wrapper against its plain version on the same
    CUDA tensors.  Returns per-kernel max abs error, and at the first shape
    each plain version's time (its one call of the check) beside the
    kernel's."""
    import torch

    from rxinfer_tpu_torch.ops import fused_smoother as fs

    worst = {"fused_smoother_fwd": 0.0, "fused_smoother_bwd": 0.0}
    before = dict(fs.LAUNCHES)
    failures = []
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for i, (bsz, t_len, d) in enumerate(shapes):
        blocks = fs.pick_blocks(bsz, t_len, d, sms)
        want = BLOCKED_SHAPES.get((bsz, t_len, d), 1)
        if sms == 132 and blocks != want:
            raise AssertionError(f"(B,T,d)=({bsz},{t_len},{d}): the wrapper "
                                 f"takes {blocks} time blocks, expected {want}")
        f, b, q, w = _smoother_params(d, seed=100 + i)
        rng = np.random.default_rng(i)
        xi = torch.as_tensor(rng.standard_normal((t_len, bsz, d)).astype(
            np.float32), device=device)
        m0 = torch.as_tensor(rng.standard_normal((bsz, d)).astype(np.float32),
                             device=device)
        p0 = torch.as_tensor(np.broadcast_to(9.0 * np.eye(d, dtype=np.float32),
                                             (bsz, d, d)).copy(), device=device)
        mf, pf = fs.fused_forward(m0, p0, xi, f, b, q, w)
        (mf_r, pf_r), fwd_plain_ms = _once_ms(
            lambda: fs.fused_forward_reference(m0, p0, xi, f, b, q, w))
        ms, ps, cr = fs.fused_backward(mf, pf, f, b, q)
        (ms_r, ps_r, cr_r), bwd_plain_ms = _once_ms(
            lambda: fs.fused_backward_reference(mf, pf, f, b, q))
        torch.cuda.synchronize()
        if i == 0:
            # the plain versions' time at this shape; the kernels' at the
            # same shape is taken after the launch count below
            plain = {"fused_smoother_fwd": {"plain_ms": fwd_plain_ms},
                     "fused_smoother_bwd": {"plain_ms": bwd_plain_ms}}
            first = (lambda a=(m0, p0, xi, f, b, q, w): fs.fused_forward(*a),
                     lambda a=(mf, pf, f, b, q): fs.fused_backward(*a))
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
        log(f"[check] (B,T,d)=({bsz},{t_len},{d}) blocks {blocks} "
            + "; ".join(parts))
    if failures:
        raise AssertionError("kernel disagrees with its plain version beyond "
                             f"rtol=atol={RTOL}: " + "; ".join(failures))
    for k in worst:
        if fs.LAUNCHES[k] - before[k] != len(shapes):
            raise AssertionError(f"{k}: launch counter did not rise once "
                                 "per checked shape")
    for k, fn in zip(("fused_smoother_fwd", "fused_smoother_bwd"), first):
        plain[k]["ms"] = _cuda_ms(fn, 5, inner=20)
    return worst, plain


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
        tile = ffb.device_tile(bsz, t_len, device)
        alphas, logz = ffb.fb_forward(lp, lt, le)
        alphas_r, logz_r = ffb.fb_forward_reference(lp, lt, le)
        g, xs, steps = ffb.fb_backward(lt, le, alphas, per_step_xi=True)
        g2, xs2, none = ffb.fb_backward(lt, le, alphas, per_step_xi=False)
        _, xs3, _ = ffb.fb_backward(lt, le, alphas, per_step_xi=True)
        g_r, xs_r, steps_r = ffb.fb_backward_reference(lt, le, alphas, True,
                                                       tile=tile)
        torch.cuda.synchronize()
        if none is not None or tuple(steps.shape) != (t_len - 1, bsz, k, k):
            failures.append(f"(B,T,K)=({bsz},{t_len},{k}): xi_steps shape")
        if not (torch.equal(xs, xs2) and torch.equal(xs, xs3)):
            failures.append(f"(B,T,K)=({bsz},{t_len},{k}): xi_sum differs "
                            "between calls on the same inputs")
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
        log(f"[check] (B,T,K)=({bsz},{t_len},{k}) marginal tile {tile} "
            f"({-(-t_len // tile)} tiles) max abs: " + "; ".join(parts)
            + "; xi_sum bit-identical over 3 calls")
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
            != 3 * len(shapes)):
        raise AssertionError("fused_fb launch counters did not rise once per "
                             "kernel call")
    return worst


def check_fb_path_inputs(lp, lt, le, log=print) -> tuple[dict, dict]:
    """K4/K5 against their plain versions on the inputs the HMM path hands
    them in its last sweep, at the path's own (B, T, K).  Returns per-kernel
    max abs error and the plain versions' ms (their one call here)."""
    import torch

    from rxinfer_tpu_torch.ops import fused_fb as ffb

    t_len, bsz, k = le.shape
    alphas, logz = ffb.fb_forward(lp, lt, le)
    (alphas_r, logz_r), fwd_plain_ms = _once_ms(
        lambda: ffb.fb_forward_reference(lp, lt, le))
    g, xs, steps = ffb.fb_backward(lt, le, alphas, per_step_xi=True)
    (g_r, xs_r, steps_r), bwd_plain_ms = _once_ms(
        lambda: ffb.fb_backward_reference(
            lt, le, alphas, True, tile=ffb.device_tile(bsz, t_len,
                                                        le.device)))
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
    plain = {"fused_fb_fwd": fwd_plain_ms, "fused_fb_bwd": bwd_plain_ms}
    log(f"[hmm] K4/K5 vs plain versions on the path's inputs, (B,T,K)="
        f"({bsz},{t_len},{k}) max abs: " + "; ".join(parts)
        + f" (rtol=atol={FB_RTOL}); the plain versions' one call "
        f"{fwd_plain_ms:.1f} / {bwd_plain_ms:.1f} ms")
    if failures:
        raise AssertionError("forward-backward kernels disagree on the HMM "
                             "path's inputs: " + "; ".join(failures))
    return worst, plain


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


def _counted_modules():
    from rxinfer_tpu_torch.ops import (
        fused_fb,
        fused_filter,
        fused_smoother,
        quantized,
    )

    return fused_smoother, fused_fb, fused_filter, quantized


def reset_launches() -> None:
    for mod in _counted_modules():
        mod.reset_launches()


def read_launches() -> dict:
    out: dict = {}
    for mod in _counted_modules():
        out.update(mod.LAUNCHES)
    return out


def expect_launches(launches: dict, **nonzero) -> None:
    """Raise unless exactly the named kernels were launched, each the given
    number of times, and no other kernel at all."""
    want = {k: nonzero.get(k, 0) for k in launches}
    if launches != want or set(nonzero) - set(launches):
        raise AssertionError(f"expected launches {want}, got {launches}")


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
    expect_launches(launches, fused_fb_fwd=iterations, fused_fb_bwd=iterations)

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
    out["kernel_errs"], out["plain_ms"] = check_fb_path_inputs(
        lp, elog_a, le_t, log=log)

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
    """One ``fn()`` call under ``torch.profiler``, after a warm-up call inside
    the profiler that is not recorded.  ``busy_ms`` sums the
    device events (kernels, copies, sets) only: a CPU operator's device time
    repeats that of its kernels, so summing every event would count the
    torch operators twice.  For each entry of ``kernels`` (label -> CUDA
    kernel name, or the names of the device kernels that one wrapper call
    launches, the last of them at every call) it gives the launches and the
    device ms per launch, summed over the names, and for several names each
    one's ms per launch under ``parts``.  Device numbers read "not measured"
    when the profiler records no device event."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    # one warm-up step inside the profiler, discarded, then the recorded one:
    # device events of the first launches after the profiler starts are lost
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if not dev:
        return {"busy_ms": "not measured",
                "kernels": {k: {"launches": "not measured",
                                "ms_per_launch": "not measured"}
                            for k in kernels}}
    out = {"busy_ms": sum(e.device_time_total for e in dev) / 1e3,
           "kernels": {}}
    for label, names in kernels.items():
        names = (names,) if isinstance(names, str) else names
        hits = {}
        for name in names:
            pat = re.compile(rf"(?<!\w){name}\b")
            hits[name] = [e.device_time_total for e in dev
                          if pat.search(e.name)]
        calls = len(hits[names[-1]])
        row = {"launches": calls,
               "ms_per_launch": sum(map(sum, hits.values())) / 1e3 / calls
               if calls else "not measured"}
        if len(names) > 1 and calls:
            row["parts"] = {n: sum(h) / 1e3 / calls for n, h in hits.items()}
        out["kernels"][label] = row
    return out


def _cycles_per_step(ms, mhz: float, t_len: int):
    """SM cycles a time step: ``ms`` at ``mhz`` over ``t_len`` steps."""
    if not isinstance(ms, float) or mhz != mhz:
        return "not measured"
    return ms * mhz * 1e3 / t_len


def _share(bound_ms: float, ms):
    """``bound_ms`` over a measured ``ms``, or "not measured"."""
    return bound_ms / ms if isinstance(ms, float) else "not measured"


def _elapsed(what: str, t_start: float) -> None:
    print(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s",
          flush=True)


def _idle_share(program_ms: float, busy_ms) -> str:
    if not isinstance(busy_ms, float):
        return "not measured"
    return f"{100 * (1 - busy_ms / program_ms):.1f}%"


class SmClock:
    """``nvidia-smi`` sampling the SM clock every 50 ms while the block runs;
    ``mhz`` is the median sample (nan without one).  The process is stopped
    on exit."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate()
        mhz = [float(x) for x in out.split() if x.replace(".", "").isdigit()]
        self.mhz = statistics.median(mhz) if mhz else float("nan")
        return False


def time_fb_alone(device, shapes, smi: str, log=print) -> dict:
    """K4 and K5 (per-step xi on) alone at each (B, T, K), after half a
    second of launches that brings the clock up: device ms per wrapper call
    (``_device_profile`` over five calls of each; K5's passes summed) and
    the cycles a step it gives at the SM clock sampled meanwhile, and under
    ``wall_ms`` the ms between CUDA events over calls back to back, which
    the wrapper's Python bounds when the kernels are shorter."""
    import torch

    from rxinfer_tpu_torch.ops import fused_fb as ffb

    out = {}
    for shape in shapes:
        bsz, t_len, k = shape
        lp, lt, le = _fb_inputs(*shape, seed=7, device=device)
        alphas, _ = ffb.fb_forward(lp, lt, le)
        fwd = lambda: ffb.fb_forward(lp, lt, le)
        bwd = lambda: ffb.fb_backward(lt, le, alphas, per_step_xi=True)
        with SmClock() as clk:
            end = time.perf_counter() + 0.5
            while time.perf_counter() < end:
                fwd()
                bwd()
            torch.cuda.synchronize()
            wall = {"fused_fb_fwd": _cuda_ms(fwd, 9, inner=10),
                    "fused_fb_bwd": _cuda_ms(bwd, 9, inner=10)}
            prof = _device_profile(
                lambda: [f() for f in (fwd,) * 5 + (bwd,) * 5],
                FB_KERNEL_NAMES)["kernels"]
        row = {n: prof[n]["ms_per_launch"] for n in wall}
        row["wall_ms"] = wall
        row["bwd_parts"] = prof["fused_fb_bwd"].get("parts")
        row["sm_clock_mhz"] = clk.mhz
        row["cycles_per_step"] = {
            n: _cycles_per_step(row[n], clk.mhz, t_len) for n in wall}
        row["tile"] = ffb.device_tile(bsz, t_len, device)
        out[shape] = row
        fmt = lambda x, f: format(x, f) if isinstance(x, float) else str(x)
        cyc = lambda n: fmt(row["cycles_per_step"][n], ".0f")
        log(f"[hmm] alone at (B,T,K)={shape}, device ms: K4 "
            f"{fmt(row['fused_fb_fwd'], '.4f')} ({cyc('fused_fb_fwd')} cycles"
            f" a step), K5 {fmt(row['fused_fb_bwd'], '.4f')} "
            f"({cyc('fused_fb_bwd')} cycles a step, marginal tile "
            f"{row['tile']}, passes "
            f"{row['bwd_parts']}); between events K4 {wall['fused_fb_fwd']:.4f},"
            f" K5 {wall['fused_fb_bwd']:.4f}; at {clk.mhz:.0f} MHz; {smi}")
    return out


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
    if device.type == "cuda":
        expect_launches(launches, fused_smoother_fwd=1, fused_smoother_bwd=1)

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

    # the unfused chain path (phase 9) runs the same model on the same data
    out = {"errs": errs, "launches": launches, "model": model, "y": y}
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
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out["blocks"] = fs.pick_blocks(b, t_len, d, sms)
    slots = out["blocks"] if out["blocks"] > 1 else 0
    out["scratch_bytes"] = {
        "fused_smoother_fwd": 4 * slots * fs.forward_scratch_rows(d) * b,
        "fused_smoother_bwd": 4 * slots * fs.backward_scratch_rows(d) * b}
    log(f"[main] program {out['program_ms']:.3f} ms/call "
        f"({out['updates_per_s']:.4g} updates/s); stages alone: einsum "
        f"{out['einsum_ms']:.3f} ms, K1 {out['fwd_ms']:.3f} ms, K2 "
        f"{out['bwd_ms']:.3f} ms, covariance unpack {out['unpack_ms']:.3f} ms"
        f"; device busy {busy} ms per program call, idle "
        f"{_idle_share(out['program_ms'], busy)}; in the program "
        f"{out['profile']['kernels']}")
    for label, k in (("K1", "fused_smoother_fwd"), ("K2", "fused_smoother_bwd")):
        parts = out["profile"]["kernels"][k].get("parts", {})
        log(f"[main] {label} in the program, {out['blocks']} time blocks of "
            f"{-(-t_len // out['blocks'])} steps, scratch "
            f"{out['scratch_bytes'][k]} bytes: " + (", ".join(
                f"{n.split('_')[1]} {ms:.4f} ms" for n, ms in parts.items())
                or "passes not measured"))

    return out


# -- slice 3: the streaming filter (K3) and the quantized payloads (K6-K8) --------

def _bound(nbytes: int, ops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def filter_bound(b: int, t: int, d: int, dy: int) -> dict:
    """Least time the card could take for K3 at (B, T, d, dy): observations
    and initial state read once, means and final state written once, against
    the operations of T chain-steps (the plain step run on counting
    stand-ins)."""
    from rxinfer_tpu_torch.ops import fused_filter as ff

    nsym = d * (d + 1) // 2
    nbytes = (t * dy * b + t * d * b + 2 * (d + nsym) * b) * 4
    par = [[0.5] * d for _ in range(d)]
    _OpCount.n = 0
    ff.filter_step([_OpCount() for _ in range(d)],
                   [[_OpCount() for _ in range(d)] for _ in range(d)],
                   [_OpCount() for _ in range(dy)], par, par, par,
                   [[0.5] * dy for _ in range(d)])
    return _bound(nbytes, _OpCount.n * t * b)


def quantize_bound(r: int, c: int) -> dict:
    """K6 / K7 at (R, C): float32 in, one byte a value and one scale a row
    out; per element an abs, a max, a division and the rounding (int8: with
    its two clips)."""
    return _bound(r * c * 4 + r * c + r * 4, 6 * r * c)


def dequant_bound(r: int, dy: int, dx: int) -> dict:
    """K8 at (R, dy, dx): payload, scales and W in, float32 (R, dx) out; dy
    dequantizing multiplies and dy * dx multiply-adds a row."""
    return _bound(r * (dy + 4 + dx * 4) + dy * dx * 4, r * (dy + 2 * dy * dx))


def filter_float64(m0, p0, ys, f, q, h, r):
    """Information-form Kalman filter in float64 numpy for a few chains, the
    transition applied at every step: m0 (n, d), p0 (n, d, d), ys (T, n, dy).
    Returns means (T, n, d) and the final (m, P)."""
    f, q, h, r = (np.asarray(a, np.float64) for a in (f, q, h, r))
    hr = h.T @ np.linalg.inv(r)
    w = hr @ h
    m = np.asarray(m0, np.float64)
    p = np.asarray(p0, np.float64)
    means = np.empty((ys.shape[0],) + m.shape)
    for t in range(ys.shape[0]):
        m = m @ f.T
        p = f @ p @ f.T + q
        lam = np.linalg.inv(p)
        p = np.linalg.inv(lam + w)
        m = np.einsum("nij,nj->ni", p, np.einsum("nij,nj->ni", lam, m)
                      + np.asarray(ys[t], np.float64) @ hr.T)
        means[t] = m
    return means, m, p


def _filter_system(d: int, dy: int, seed: int):
    """A stable random system with a (dy, d) observation matrix."""
    rng = np.random.default_rng(seed)
    qm, _ = np.linalg.qr(rng.standard_normal((d, d)))
    f = (0.98 * qm).astype(np.float32)
    q = (0.4 * np.eye(d)).astype(np.float32)
    h = (1.2 * np.eye(dy, d) + 0.2 * rng.standard_normal((dy, d))).astype(
        np.float32)
    r = (0.8 * np.eye(dy) + 0.1 * np.ones((dy, dy))).astype(np.float32)
    return f, q, h, r


def _soa_state(m, p):
    """(B, d), (B, d, d) -> the kernel's batch-minor (d, B), (nsym, B)."""
    from rxinfer_tpu_torch.ops.fused_smoother import sym_fold

    return m.t().contiguous(), sym_fold(p).contiguous()


def check_filter_kernel(device, shapes, log=print) -> float:
    """Phase 6 for K3: the wrapper against its plain version on the same
    CUDA tensors, and chains of the first shape against the float64 filter.
    Returns the max abs error against the plain version."""
    import torch

    from rxinfer_tpu_torch.ops import fused_filter as ff

    worst = 0.0
    before = ff.LAUNCHES["fused_filter"]
    failures = []
    for i, (bsz, t_len, d, dy) in enumerate(shapes):
        f, q, h, r = _filter_system(d, dy, seed=300 + i)
        w_obs, hr = ff.evidence_operators(h, r)
        rng = np.random.default_rng(300 + i)
        ys = torch.as_tensor(rng.standard_normal((t_len, dy, bsz)).astype(
            np.float32), device=device)
        m = torch.as_tensor(rng.standard_normal((bsz, d)).astype(np.float32),
                            device=device)
        p = torch.as_tensor(np.broadcast_to(9.0 * np.eye(d, dtype=np.float32),
                                            (bsz, d, d)).copy(), device=device)
        m0, p0 = _soa_state(m, p)
        got = ff.fused_filter(m0, p0, ys, f, q, hr, w_obs)
        want = ff.fused_filter_reference(m0, p0, ys, f, q, hr, w_obs)
        torch.cuda.synchronize()
        parts = []
        for label, g, w in zip(("means", "final m", "final P"), got, want):
            ea, er, ok = _max_err(g.cpu().numpy(), w.cpu().numpy())
            worst = max(worst, ea)
            parts.append(f"{label} abs {ea:.3g} rel {er:.3g}")
            if not ok:
                failures.append(f"(B,T,d,dy)=({bsz},{t_len},{d},{dy}) {label}:"
                                f" abs {ea:.3g} rel {er:.3g}")
        log(f"[check] K3 (B,T,d,dy)=({bsz},{t_len},{d},{dy}) "
            + "; ".join(parts))
        if i == 0:
            idx = [0, 1, bsz // 2, bsz - 1]
            o_means, o_m, _ = filter_float64(
                m[idx].cpu().numpy(), p[idx].cpu().numpy(),
                ys[:, :, idx].transpose(1, 2).cpu().numpy(), f, q, h, r)
            err = max(
                float(np.abs(got[0][:, :, idx].transpose(1, 2).cpu().numpy()
                             - o_means).max()),
                float(np.abs(got[1][:, idx].t().cpu().numpy() - o_m).max()))
            log(f"[check] K3 vs float64 filter, chains {idx}: {err:.3g} "
                f"(tol {ORACLE_TOL})")
            if err > ORACLE_TOL:
                failures.append(f"float64 filter: {err:.3g}")
    if failures:
        raise AssertionError("filter kernel disagrees beyond rtol=atol="
                             f"{RTOL}: " + "; ".join(failures))
    if ff.LAUNCHES["fused_filter"] - before != len(shapes):
        raise AssertionError("fused_filter: launch counter did not rise once "
                             "per checked shape")
    return worst


def _quant_rows(r: int, c: int, seed: int, device, start: int = 0):
    """Rows with scales spread over e^-3 .. e^3 and, where there is more
    than one row, a zero row; a contiguous view ``start`` floats into its
    storage."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((r * c + start,), generator=gen, device=device)
    x = x[start:].view(r, c)
    x.mul_(torch.exp(6.0 * torch.rand((r, 1), generator=gen, device=device)
                     - 3.0))
    if r > 1:
        x[1] = 0.0
    return x


def _layout_name(layout) -> str:
    return f"{layout.variant}(group={layout.group}, rows_per_thread=" \
        f"{layout.rows_per_thread}, vecs={layout.vecs})"


def check_quant_kernels(device, log=print) -> tuple[dict, dict]:
    """Phase 6 for K6, K7, K8.  Quantize: payload bytes and scales equal to
    the plain version's, the zero row all zeros, at every entry of
    QUANT_CHECK_SHAPES, each of the kernels' layouts taken at least once.
    Dequantize + product: EQUAL to the plain version on both payload types
    at every entry of DEQUANT_CHECK_SHAPES, each of its layouts taken.
    Returns per-kernel max abs error (payloads decoded to float32) and the
    layout each shape took (``quantize``: (R, C, start), ``dequant``:
    (R, dy, dx, start))."""
    import torch

    from rxinfer_tpu_torch.ops import quantized as tq

    worst = {k: 0.0 for k in tq.LAUNCHES}
    before = dict(tq.LAUNCHES)
    failures = []
    pairs = (("quantize_rows", tq.quantize_rows, tq.quantize_rows_reference),
             ("quantize_rows_fp8", tq.quantize_rows_fp8,
              tq.quantize_rows_fp8_reference))
    layouts = {}
    for i, (r, c, start) in enumerate(QUANT_CHECK_SHAPES):
        x = _quant_rows(r, c, seed=400 + i, device=device, start=start)
        parts = []
        for name, fn, ref in pairs:
            v, s = fn(x)
            layouts[(r, c, start)] = tq.device_quant_layout(x, v)
            v_r, s_r = ref(x)
            torch.cuda.synchronize()
            n_bytes = int((v.view(torch.uint8) != v_r.view(torch.uint8)).sum())
            n_scales = int((s != s_r).sum())
            err = float((v.float() - v_r.float()).abs().max())
            worst[name] = max(worst[name], err)
            parts.append(f"{name}: {n_bytes} payload bytes and {n_scales} "
                         f"scales differ, max |payload diff| {err:.3g}")
            if n_bytes or n_scales:
                failures.append(f"(R,C)=({r},{c}) {parts[-1]}")
            if r > 1 and bool(v[1].view(torch.uint8).any()):
                failures.append(f"(R,C)=({r},{c}) {name}: zero row not zero")
        log(f"[check] K6/K7 (R,C)=({r},{c}) start {start}, "
            f"{_layout_name(layouts[(r, c, start)])}: " + "; ".join(parts))
        del x
    taken = {(lay.variant, lay.rows_per_thread, min(lay.vecs, 2))
             for lay in layouts.values() if lay.variant == "narrow"}
    taken |= {(lay.variant,) for lay in layouts.values()
              if lay.variant != "narrow"}
    if not {("narrow", 1, 1), ("narrow", tq.NARROW_ROW_GROUPS, 1),
            ("narrow", 1, 2), ("wide",), ("general",)} <= taken:
        failures.append(f"the check shapes took only the layouts {taken}")
    for (r, c, start), lay in layouts.items():
        if start and lay.variant != "general":
            failures.append(f"(R,C)=({r},{c}) {start} floats into its "
                            f"storage took {lay}, not the general layout")
    dq_layouts = {}
    for i, (r, dy, dx, start) in enumerate(DEQUANT_CHECK_SHAPES):
        x = _quant_rows(r, dy, seed=500 + i, device=device)
        gen = torch.Generator(device=device).manual_seed(600 + i)
        w = torch.randn((dy, dx), generator=gen, device=device)
        parts = []
        for name, fn, _ in pairs:
            v, s = fn(x)
            if start:
                store = torch.empty(r * dy + start, dtype=v.dtype,
                                    device=device)
                v = store[start:].view(r, dy).copy_(v)
            got = tq.dequant_matmul(v, s, w)
            want = tq.dequant_matmul_reference(v, s, w)
            dq_layouts[(r, dy, dx, start)] = tq.device_dequant_layout(v, got)
            torch.cuda.synchronize()
            n_diff = int((got.view(torch.int32)
                          != want.view(torch.int32)).sum())
            ea = float((got - want).abs().max())
            worst["dequant_matmul"] = max(worst["dequant_matmul"], ea)
            parts.append(f"{v.dtype}: {n_diff} outputs differ, max abs "
                         f"{ea:.3g}")
            if n_diff:
                failures.append(f"(R,dy,dx)=({r},{dy},{dx}) {parts[-1]}")
        log(f"[check] K8 (R,dy,dx)=({r},{dy},{dx}) start {start}, "
            f"{dq_layouts[(r, dy, dx, start)]}: " + "; ".join(parts)
            + " (must be EQUAL)")
        del x
    taken = {(lay.variant, lay.rows_per_thread)
             for lay in dq_layouts.values()}
    if not {("vector", 4), ("vector", 1), ("general", 1)} <= taken:
        failures.append(f"the K8 check shapes took only the layouts {taken}")
    for (r, dy, dx, start), lay in dq_layouts.items():
        if start % 16 and lay.variant != "general":
            failures.append(f"K8 (R,dy,dx)=({r},{dy},{dx}) {start} bytes into "
                            f"its storage took {lay}, not the general layout")
    if failures:
        raise AssertionError("quantization kernels disagree with their plain "
                             "versions: " + "; ".join(failures))
    n_q, n_d = len(QUANT_CHECK_SHAPES), len(DEQUANT_CHECK_SHAPES)
    rose = {k: tq.LAUNCHES[k] - before[k] for k in before}
    if rose != {"quantize_rows": n_q + n_d, "quantize_rows_fp8": n_q + n_d,
                "dequant_matmul": 2 * n_d}:
        raise AssertionError(f"quantized launch counters rose by {rose}")
    return worst, {"quantize": layouts, "dequant": dq_layouts}


def filter_path(device, b: int, t_len: int, d: int, reps: int,
                log=print) -> dict:
    """Phase 7, path A: the continuous-batching filter at (B, T, d)."""
    import torch

    from rxinfer_tpu_torch.ops import fused_filter as ff
    from rxinfer_tpu_torch.parallel.filtering import (
        FilterState,
        make_sharded_filtering,
    )

    f, q, h, r, m0, p0 = lgssm_constants(d)
    rng = np.random.default_rng(0)
    ys_host = rng.standard_normal((t_len, b, d)).astype(np.float32)
    ys = torch.as_tensor(ys_host, device=device)
    state = FilterState(
        torch.zeros((b, d), device=device),
        torch.as_tensor(p0, device=device).expand((b, d, d)).contiguous())
    fn = make_sharded_filtering(None, f, q, h, r, fused=True)

    reset_launches()
    final, means = fn(state, ys)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[filter] launches in one call: {launches}")
    expect_launches(launches, fused_filter=1)
    if tuple(means.shape) != (t_len, b, d) or tuple(final.m.shape) != (b, d) \
            or tuple(final.p.shape) != (b, d, d):
        raise AssertionError("filter outputs have the wrong shape")
    if not all(bool(torch.isfinite(a).all())
               for a in (means, final.m, final.p)):
        raise AssertionError("non-finite filter outputs")

    rows = sorted({0, 1, b // 2, b - 1})
    o_means, o_m, o_p = filter_float64(
        np.zeros((len(rows), d)), np.broadcast_to(p0, (len(rows), d, d)),
        ys_host[:, rows], f, q, h, r)
    errs = {
        "means": float(np.abs(means[:, rows].cpu().numpy() - o_means).max()),
        "final_m": float(np.abs(final.m[rows].cpu().numpy() - o_m).max()),
        "final_p": float(np.abs(final.p[rows].cpu().numpy() - o_p).max()),
    }
    log(f"[filter] float64 filter, chains {rows}: {errs} (tol {ORACLE_TOL})")
    if max(errs.values()) > ORACLE_TOL:
        raise AssertionError(f"path A disagrees with the float64 filter: {errs}")

    # the kernel against its plain version on the path's own inputs
    w_obs, hr = ff.evidence_operators(h, r)
    m_soa, p_soa = _soa_state(state.m, state.p)
    ys_soa = ys.transpose(1, 2).contiguous()
    got = ff.fused_filter(m_soa, p_soa, ys_soa, f, q, hr, w_obs)
    # the plain version's one call (2-4 s: thousands of small launches) is
    # its time as well
    want, plain_kernel_ms = _once_ms(lambda: ff.fused_filter_reference(
        m_soa, p_soa, ys_soa, f, q, hr, w_obs))
    kernel_err = 0.0
    for label, g, w in zip(("means", "final m", "final P"), got, want):
        ea, er, ok = _max_err(g.cpu().numpy(), w.cpu().numpy())
        kernel_err = max(kernel_err, ea)
        if not ok:
            raise AssertionError(f"K3 disagrees with its plain version on "
                                 f"path A's inputs, {label}: abs {ea:.3g}")
    log(f"[filter] K3 vs plain version on the path's inputs: max abs "
        f"{kernel_err:.3g} (rtol=atol={RTOL})")

    out = {"errs": errs, "launches": launches, "kernel_err": kernel_err,
           "plain_kernel_ms": plain_kernel_ms}
    out["call_ms"] = _cuda_ms(lambda: fn(state, ys), reps)
    out["updates_per_s"] = b * t_len / (out["call_ms"] / 1e3)
    k3 = lambda: ff.fused_filter(m_soa, p_soa, ys_soa, f, q, hr, w_obs)
    with SmClock() as clk:
        end = time.perf_counter() + 0.5     # launches that bring the clock up
        while time.perf_counter() < end:
            k3()
        out["kernel_ms"] = _cuda_ms(k3, reps, inner=20)
    out["sm_clock_mhz"] = clk.mhz
    out["layout_ms"] = _cuda_ms(lambda: ys.transpose(1, 2).contiguous(), reps,
                                inner=20)
    out["profile"] = _device_profile(lambda: fn(state, ys),
                                     FILTER_KERNEL_NAMES)
    busy = out["profile"]["busy_ms"]
    out["cycles_per_step"] = _cycles_per_step(
        out["profile"]["kernels"]["fused_filter"]["ms_per_launch"],
        out["sm_clock_mhz"], t_len)
    log(f"[filter] call {out['call_ms']:.4f} ms ({out['updates_per_s']:.4g} "
        f"chain-updates/s); K3 {out['cycles_per_step']} cycles a step in "
        f"the call at {out['sm_clock_mhz']:.0f} MHz; alone: K3 "
        f"{out['kernel_ms']:.4f} ms, observation "
        f"layout copy {out['layout_ms']:.4f} ms; K3's plain version "
        f"{out['plain_kernel_ms']:.1f} ms; device busy {busy} ms per call, "
        f"idle {_idle_share(out['call_ms'], busy)}; in the call "
        f"{out['profile']['kernels']}")
    return out


def quantized_program_path(device, b: int, t_len: int, d: int, reps: int,
                           log=print) -> dict:
    """Phase 8 (i), path B: the LGSSM program on quantized observations."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.engine.batched import quantize_observations
    from rxinfer_tpu_torch.models import zoo
    from rxinfer_tpu_torch.ops import quantized as tq

    f, q, h, r, m0, p0 = lgssm_constants(d)
    model = zoo.lgssm(f, q, h, r, m0, p0)
    rng = np.random.default_rng(0)
    y = torch.as_tensor(rng.standard_normal((b, t_len, d), dtype=np.float32),
                        device=device)
    dtypes = {"int8": ("quantize_rows", INT8_LEVEL),
              "float8_e4m3fn": ("quantize_rows_fp8", FP8_LEVEL)}
    out: dict = {"launches": {}, "program_ms": {}, "errs": {}}

    built: dict = {}

    def program(iterations, obs_dtype=None):
        key = (iterations, obs_dtype)
        if key not in built:
            opts = {"observation_dtype": obs_dtype} if obs_dtype else None
            built[key] = rt.batched_program(
                model, {"y": y}, iterations=iterations, free_energy=False,
                options=opts, device=device)[1]
        return built[key]

    for iterations in QUANT_ITERATIONS:
        n_reps = reps if iterations == 1 else max(3, reps // 2)
        prog_f = program(iterations)
        mu_f = prog_f({"y": y})[0]["x"].mu
        scale = float(mu_f.abs().max())
        out["program_ms"][("float32", iterations)] = _cuda_ms(
            lambda: prog_f({"y": y}), n_reps)
        for obs_dtype, (kname, level) in dtypes.items():
            prog_q = program(iterations, obs_dtype)
            reset_launches()
            mu_q = prog_q({"y": y})[0]["x"].mu
            torch.cuda.synchronize()
            launches = read_launches()
            expect_launches(launches, fused_smoother_fwd=iterations,
                            fused_smoother_bwd=iterations, **{kname: 1})
            out["launches"][(obs_dtype, iterations)] = launches
            vals, scales = quantize_observations(y, obs_dtype)
            y_hat = (vals.to(torch.float32) * scales).transpose(1, 2)
            mu_hat = prog_f({"y": y_hat.contiguous()})[0]["x"].mu
            torch.cuda.synchronize()
            errs = {
                "vs_float32_share": float((mu_q - mu_f).abs().max()) / scale,
                "vs_float32_on_dequantized": float(
                    (mu_q - mu_hat).abs().max()),
            }
            out["errs"][(obs_dtype, iterations)] = errs
            if not bool(torch.isfinite(mu_q).all()) \
                    or errs["vs_float32_share"] > level \
                    or errs["vs_float32_on_dequantized"] > DEQ_TOL:
                raise AssertionError(
                    f"path B, {obs_dtype} at {iterations} iterations: {errs} "
                    f"(levels {level} and {DEQ_TOL})")
            out["program_ms"][(obs_dtype, iterations)] = _cuda_ms(
                lambda: prog_q({"y": y}), n_reps)
            del mu_q, mu_hat, y_hat, vals, scales
        log(f"[quant] iterations={iterations}: program ms "
            + ", ".join(f"{k} {out['program_ms'][(k, iterations)]:.3f}"
                        for k in ("float32", *dtypes))
            + "; launches "
            + ", ".join(f"{k} {out['launches'][(k, iterations)][v[0]]} x {v[0]}"
                        for k, v in dtypes.items())
            + "; errors "
            + ", ".join(f"{k} {out['errs'][(k, iterations)]}" for k in dtypes))

    # stages alone at the engine's shapes: the quantize kernels on the rows
    # (B*F, T), and the evidence einsum on the payload and on float32
    rows = y.transpose(1, 2).reshape(b * d, t_len).contiguous()
    ek = torch.as_tensor((h.T @ np.linalg.inv(r)).astype(np.float32),
                         device=device)
    out["einsum_ms"] = {"float32": _cuda_ms(
        lambda: torch.einsum("if,btf->tbi", ek, y), reps)}
    out["kernel_ms"], out["plain_ms"] = {}, {}
    for obs_dtype, fn, ref in (
            ("int8", tq.quantize_rows, tq.quantize_rows_reference),
            ("float8_e4m3fn", tq.quantize_rows_fp8,
             tq.quantize_rows_fp8_reference)):
        kname = dtypes[obs_dtype][0]
        out["kernel_ms"][kname] = _cuda_ms(lambda: fn(rows), reps, inner=20)
        out["plain_ms"][kname] = _cuda_ms(lambda: ref(rows), reps)
        out["layout"] = _layout_name(tq.device_quant_layout(rows,
                                                            fn(rows)[0]))
        vals, scales = quantize_observations(y, obs_dtype)
        out["einsum_ms"][obs_dtype] = _cuda_ms(
            lambda: torch.einsum("if,bft->tbi", ek,
                                 vals.to(torch.float32) * scales), reps)
    # yardstick only: a device copy of the same rows, read and write counted
    out["copy_ms"] = _cuda_ms(lambda: torch.empty_like(rows).copy_(rows),
                              reps, inner=20)
    out["copy_bytes_per_s"] = 2 * rows.numel() * 4 / (out["copy_ms"] / 1e3)
    out["profile"] = {}
    for obs_dtype in dtypes:
        prog_q = program(QUANT_ITERATIONS[-1], obs_dtype)
        out["profile"][obs_dtype] = _device_profile(
            lambda: prog_q({"y": y}),
            {**SMOOTHER_KERNEL_NAMES,
             dtypes[obs_dtype][0]: QUANT_KERNEL_NAMES[dtypes[obs_dtype][0]]})
    log(f"[quant] alone at rows {tuple(rows.shape)}, {out['layout']}: "
        + ", ".join(f"{k} {v:.4f} ms (plain {out['plain_ms'][k]:.3f} ms)"
                    for k, v in out["kernel_ms"].items())
        + f"; copy of the rows {out['copy_ms']:.4f} ms = "
        f"{out['copy_bytes_per_s'] / 1e9:.0f} GB/s"
        + "; evidence einsum ms " + ", ".join(
            f"{k} {v:.3f}" for k, v in out["einsum_ms"].items())
        + f"; in the {QUANT_ITERATIONS[-1]}-iteration program "
        + ", ".join(f"{k}: busy {v['busy_ms']} ms, {v['kernels']}"
                    for k, v in out["profile"].items()))
    return out


def quantized_ingest_path(device, shape, reps: int, log=print) -> dict:
    """Phase 8 (ii), path B: ``quantized_evidence`` and its fp8 form at
    (R, dy, dx)."""
    import torch

    from rxinfer_tpu_torch.ops import quantized as tq

    r, dy, dx = shape
    rng = np.random.default_rng(2)
    y = torch.as_tensor(
        3.0 * rng.standard_normal((r, dy), dtype=np.float32), device=device)
    w = torch.as_tensor(rng.standard_normal((dy, dx)).astype(np.float32),
                        device=device)
    exact = y @ w
    scale = float(exact.abs().max())
    nbytes = r * (dy + 4 + dx * 4)          # the JAX package's bench count
    out: dict = {"launches": {}, "errs": {}, "call_ms": {}, "quantize_ms": {},
                 "dequant_ms": {}, "dequant_plain_ms": {},
                 "dequant_bytes_per_s": {}, "quantize_plain_ms": {},
                 "dequant_device_ms": {}}
    for label, fn, quant, ref, kname, level in (
            ("int8", tq.quantized_evidence, tq.quantize_rows,
             tq.quantize_rows_reference, "quantize_rows", INT8_LEVEL),
            ("float8_e4m3fn", tq.quantized_evidence_fp8, tq.quantize_rows_fp8,
             tq.quantize_rows_fp8_reference, "quantize_rows_fp8", FP8_LEVEL)):
        reset_launches()
        xi = fn(y, w)
        torch.cuda.synchronize()
        launches = read_launches()
        expect_launches(launches, dequant_matmul=1, **{kname: 1})
        out["launches"][label] = launches
        err = float((xi - exact).abs().max()) / scale
        out["errs"][label] = err
        if tuple(xi.shape) != (r, dx) or not bool(torch.isfinite(xi).all()) \
                or err > level:
            raise AssertionError(f"quantized ingest, {label}: error share "
                                 f"{err:.3g} (level {level})")
        vals, scales = quant(y)
        out["call_ms"][label] = _cuda_ms(lambda: fn(y, w), reps, inner=10)
        out["quantize_ms"][label] = _cuda_ms(lambda: quant(y), reps, inner=20)
        out["quantize_plain_ms"][label] = _cuda_ms(lambda: ref(y), reps)
        out["layout"] = _layout_name(tq.device_quant_layout(y, vals))
        out["dequant_ms"][label] = _cuda_ms(
            lambda: tq.dequant_matmul(vals, scales, w), reps, inner=20)
        out["dequant_layout"] = str(tq.device_dequant_layout(vals, xi))
        # the wrapper's Python takes about as long as the kernel, so the
        # events above time the host: the device time of 20 launches
        out["dequant_device_ms"][label] = _device_profile(
            lambda: [tq.dequant_matmul(vals, scales, w) for _ in range(20)],
            {"dequant_matmul": QUANT_KERNEL_NAMES["dequant_matmul"]})[
            "kernels"]["dequant_matmul"]["ms_per_launch"]
        out["dequant_plain_ms"][label] = _cuda_ms(
            lambda: tq.dequant_matmul_reference(vals, scales, w), reps)
        dq_ms = out["dequant_device_ms"][label]
        out["dequant_bytes_per_s"][label] = nbytes / (
            (dq_ms if isinstance(dq_ms, float) else out["dequant_ms"][label])
            / 1e3)
        if label == "int8":
            # yardstick only: the product alone, on the matrix already
            # dequantized to float32
            deq = vals.to(torch.float32) * scales
            out["library_ms"] = _cuda_ms(lambda: torch.matmul(deq, w), reps,
                                         inner=20)
            del deq
    # yardstick only: a device copy of the same rows, read and write counted
    out["copy_ms"] = _cuda_ms(lambda: torch.empty_like(y).copy_(y), reps,
                              inner=20)
    out["copy_bytes_per_s"] = 2 * y.numel() * 4 / (out["copy_ms"] / 1e3)
    # and of K8's payload and output
    out["copy_payload_ms"] = _cuda_ms(
        lambda: torch.empty_like(vals).copy_(vals), reps, inner=20)
    out["copy_out_ms"] = _cuda_ms(lambda: torch.empty_like(xi).copy_(xi),
                                  reps, inner=20)
    out["copy_dequant_bytes_per_s"] = 2 * (vals.numel() + xi.numel() * 4) / (
        (out["copy_payload_ms"] + out["copy_out_ms"]) / 1e3)
    # three calls a recorded step: the profiler can lose the device event
    # of a step's first launch, and the per-launch time is over those found
    out["profile"] = _device_profile(
        lambda: [tq.quantized_evidence(y, w) for _ in range(3)],
        QUANT_KERNEL_NAMES)
    out["profile_fp8"] = _device_profile(
        lambda: [tq.quantized_evidence_fp8(y, w) for _ in range(3)],
        QUANT_KERNEL_NAMES)
    log(f"[ingest] (R,dy,dx)={shape}: "
        + "; ".join(
            f"{k}: call {out['call_ms'][k]:.4f} ms, quantize "
            f"{out['quantize_ms'][k]:.4f} ms (plain "
            f"{out['quantize_plain_ms'][k]:.3f}), dequant+product "
            f"{out['dequant_device_ms'][k]} ms device, "
            f"{out['dequant_ms'][k]:.4f} between events (plain "
            f"{out['dequant_plain_ms'][k]:.3f}) = "
            f"{out['dequant_bytes_per_s'][k]:.4g} B/s, error share "
            f"{out['errs'][k]:.3g}" for k in out["call_ms"])
        + f"; float32 matmul on the dequantized matrix {out['library_ms']:.4f}"
        f" ms; dequantize layout {out['dequant_layout']}; copy of the payload"
        f" and of the output {out['copy_dequant_bytes_per_s'] / 1e9:.0f} "
        f"GB/s; quantize layout {out['layout']}; copy of y "
        f"{out['copy_ms']:.4f} ms = {out['copy_bytes_per_s'] / 1e9:.0f} GB/s"
        f"; in three int8 calls {out['profile']['kernels']}, in three fp8 "
        f"calls {out['profile_fp8']['kernels']}")
    return out


# -- the single-dataset infer and the unfused chain path -------------------------

def _lgssm_oracle(y_host, d, w_steps=None):
    """Smoothed means (n, T, d) and covariances (n, T, d, d) of the LGSSM
    with ``lgssm_constants`` for the chains y_host (n, T, d), float64;
    ``w_steps`` (T, n) zeroes the evidence of the steps where it is 0."""
    f, q, h, r, m0, p0 = lgssm_constants(d)
    n, t_len, _ = y_host.shape
    hinv = (h.T @ np.linalg.inv(r)).astype(np.float64)
    xi = np.einsum("ij,ntj->tni", hinv, np.nan_to_num(y_host).astype(
        np.float64))
    w = hinv @ h
    if w_steps is not None:
        xi = xi * w_steps[..., None]
        w = w_steps[..., None, None] * w
    o_m, o_p = rts_float64(np.broadcast_to(m0, (n, d)),
                           np.broadcast_to(p0, (n, d, d)), xi, f,
                           np.zeros(d), q, w)
    return np.moveaxis(o_m, 0, 1), np.moveaxis(o_p, 0, 1)


def infer_lgssm_path(device, t_len: int, d: int, reps: int,
                     log=print) -> dict:
    """Phase 9 (a): ``rxinfer_tpu_torch.infer`` on one LGSSM dataset of T
    steps (the JAX package's single-chain row): the associative-scan
    smoother in torch, no kernel."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo

    model = zoo.lgssm(*lgssm_constants(d))
    y_host = np.random.default_rng(1).standard_normal(
        (t_len, d)).astype(np.float32)
    y = torch.as_tensor(y_host, device=device)
    call = lambda: rt.infer(model, data={"y": y}, device=device)
    reset_launches()
    res = call()
    torch.cuda.synchronize()
    launches = read_launches()
    expect_launches(launches)
    post = res.posteriors["x"]
    means, covs = post.mean().cpu().numpy(), post.cov().cpu().numpy()
    if means.shape != (t_len, d) or covs.shape != (t_len, d, d) or not (
            np.isfinite(means).all() and np.isfinite(covs).all()):
        raise AssertionError("infer's LGSSM posterior has the wrong shape or "
                             "is not finite")
    o_m, o_p = _lgssm_oracle(y_host[None], d)
    errs = {"means": float(np.abs(means - o_m[0]).max()),
            "covs": float(np.abs(covs - o_p[0]).max())}
    if max(errs.values()) > ORACLE_TOL:
        raise AssertionError(f"infer disagrees with the float64 RTS: {errs}")
    out = {"errs": errs, "launches": launches}
    out["ms"] = _cuda_ms(call, reps)
    out["updates_per_s"] = 3 * t_len / (out["ms"] / 1e3)
    out["profile"] = _device_profile(call, {})
    busy = out["profile"]["busy_ms"]
    log(f"[infer] zoo.lgssm T={t_len} d={d}: {out['ms']:.3f} ms a call, "
        f"{out['updates_per_s']:.6g} updates/s; float64 RTS max abs err "
        f"means {errs['means']:.3g}, covs {errs['covs']:.3g} (tol "
        f"{ORACLE_TOL}); kernel launches {launches}; device busy {busy} ms "
        f"a call, idle {_idle_share(out['ms'], busy)}")
    return out


def infer_hmm_path(device, t_len: int, iterations: int, reps: int,
                   log=print) -> dict:
    """Phase 9 (b): ``infer`` on one dataset of the HMM path (phase 5's
    initialization): the associative-scan forward-backward in torch."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo

    y_host = simulate_hmm(1, t_len, seed=3)
    y = torch.as_tensor(y_host[0], device=device)
    a0 = np.full((3, 3), 1.0, np.float32)
    b0 = np.float32(np.eye(3) * 5.0 + 1.0)
    init = {"A": rt.DirichletCollection(a0), "B": rt.DirichletCollection(b0)}
    model = zoo.hmm(3, 3)
    call = lambda: rt.infer(model, data={"y": y}, iterations=iterations,
                            initialization=init, returnvars=rt.KeepLast(),
                            device=device)
    reset_launches()
    post = call().posteriors
    torch.cuda.synchronize()
    launches = read_launches()
    expect_launches(launches)
    o_g, o_a, o_b = hmm_vmp_float64(y_host, a0, b0, iterations)
    errs = {
        "gammas": float(np.abs(post["s"].probs().cpu().numpy()
                               - o_g[0]).max()),
        "A_rel": float((np.abs(post["A"].alpha.cpu().numpy() - o_a[0])
                        / o_a[0]).max()),
        "B_rel": float((np.abs(post["B"].alpha.cpu().numpy() - o_b[0])
                        / o_b[0]).max()),
    }
    if errs["gammas"] > HMM_ORACLE_TOL["gammas"] or max(
            errs["A_rel"], errs["B_rel"]) > HMM_ORACLE_TOL["conc_rel"]:
        raise AssertionError(f"infer disagrees with the float64 VMP: {errs}")
    out = {"errs": errs, "launches": launches, "ms": _cuda_ms(call, reps)}
    log(f"[infer] zoo.hmm(3, 3) T={t_len}, {iterations} iterations: "
        f"{out['ms']:.3f} ms a call; float64 VMP {errs} (tol "
        f"{HMM_ORACLE_TOL}); kernel launches {launches}")
    return out


def unfused_path(device, main: dict, reps: int, log=print) -> dict:
    """Phase 9 (c): phase 4's LGSSM cell with ``fused_kernels=False``: the
    batched scans in torch against the fused program on the same data; the
    median of ``reps`` calls, the checked one among them."""
    import torch

    import rxinfer_tpu_torch as rt

    model, y = main["model"], main["y"]
    b, t_len, d = y.shape
    _, fused = rt.batched_program(model, {"y": y}, iterations=1,
                                  free_energy=False, device=device)
    compiled, prog = rt.batched_program(
        model, {"y": y}, iterations=1, free_energy=False, device=device,
        options={"fused_kernels": False})
    report = compiled.plan_report()["x"]
    if report.get("fused") is not False or "fused_kernels" not in report.get(
            "reason", ""):
        raise AssertionError(f"chain x is not on the unfused path: {report}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    reset_launches()
    (state, _, _), first_ms = _once_ms(lambda: prog({"y": y}))
    launches = read_launches()
    expect_launches(launches)
    peak = torch.cuda.max_memory_allocated(device) - base
    want, _, _ = fused({"y": y})
    errs = {"means": float((state["x"].mu - want["x"].mu).abs().max()),
            "covs": float((state["x"].sigma - want["x"].sigma).abs().max())}
    if not max(errs.values()) <= ORACLE_TOL:
        raise AssertionError(f"the unfused program disagrees with the fused "
                             f"one: {errs}")
    del state, want
    out = {"errs": errs, "launches": launches, "peak_bytes": peak,
           "bytes_per_step": peak / (b * t_len)}
    # the checked call is one of the ``reps`` timed (1.7 s a call on an
    # H100); the fused program's time is phase 4's, in this run
    out["ms"] = statistics.median([first_ms] + [
        _once_ms(lambda: prog({"y": y}))[1] for _ in range(reps - 1)])
    out["fused_ms"] = main["program_ms"]
    log(f"[unfused] LGSSM B={b} T={t_len} d={d}, fused_kernels=False: "
        f"{out['ms']:.3f} ms a call against the fused program's "
        f"{out['fused_ms']:.3f} ms ({out['ms'] / out['fused_ms']:.1f}x); "
        f"max |diff| to the fused posteriors {errs} (tol {ORACLE_TOL}); "
        f"peak {peak / 1e9:.2f} GB above the inputs "
        f"({out['bytes_per_step']:.0f} bytes a chain-step); kernel launches "
        f"{launches}")
    torch.cuda.empty_cache()
    return out


def nan_batch_path(device, b: int, t_len: int, d: int, log=print) -> dict:
    """Phase 9 (d): ``infer_batched`` on B LGSSM chains with 10% of the
    steps missing (NaN): the plan sends the chain to its scans, and sampled
    chains match the float64 RTS with no evidence at the missing steps."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo

    model = zoo.lgssm(*lgssm_constants(d))
    rng = np.random.default_rng(5)
    y_host = rng.standard_normal((b, t_len, d)).astype(np.float32)
    y_host[rng.random((b, t_len)) < 0.1] = np.nan
    y = torch.as_tensor(y_host, device=device)
    compiled, _ = rt.batched_program(model, {"y": y}, device=device)
    report = compiled.plan_report()["x"]
    if report.get("fused") is not False or "missing" not in report.get(
            "reason", ""):
        raise AssertionError(f"the NaN batch is not on the unfused path: "
                             f"{report}")
    reset_launches()
    res, call_ms = _once_ms(lambda: rt.infer_batched(model, {"y": y},
                                                     device=device))
    launches = read_launches()
    expect_launches(launches)
    rows = [0, 1, b // 2, b - 1]
    seen = np.isfinite(y_host[rows]).all(-1).T.astype(np.float64)  # (T, n)
    o_m, o_p = _lgssm_oracle(y_host[rows], d, w_steps=seen)
    post = res.posteriors["x"]
    errs = {"means": float(np.abs(post.mu[rows].cpu().numpy() - o_m).max()),
            "covs": float(np.abs(post.sigma[rows].cpu().numpy()
                                 - o_p).max())}
    if max(errs.values()) > ORACLE_TOL:
        raise AssertionError(f"the NaN batch disagrees with the float64 RTS:"
                             f" {errs}")
    log(f"[nan] infer_batched B={b} T={t_len} d={d}, "
        f"{100 * (1 - seen.mean()):.1f}% of the sampled steps missing: "
        f"{call_ms:.1f} ms (one call); float64 RTS with W = 0 at the missing "
        f"steps, chains {rows}: {errs} (tol {ORACLE_TOL}); kernel launches "
        f"{launches}")
    return {"errs": errs, "launches": launches, "ms": call_ms}


def side_checks() -> tuple[list, dict, dict]:
    """Phase 3's K4/K5 checks and phase 6's K3, K6-K8 checks, in a second
    process beside the K1/K2 checks.  The plain versions the checks hold the
    kernels against are host-bound Python loops (seconds a call), so the two
    processes overlap about half of the script's checking time.  Returns the
    log lines, each kernel's max error against its plain version and the
    layouts K6-K8 took."""
    import torch

    device = torch.device("cuda")
    lines: list = []
    worst = check_fb_kernels(device, FB_CHECK_SHAPES, log=lines.append)
    worst["fused_filter"] = check_filter_kernel(device, FILTER_CHECK_SHAPES,
                                                log=lines.append)
    quant_worst, layouts = check_quant_kernels(device, log=lines.append)
    worst.update(quant_worst)
    return lines, worst, layouts


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

    # 3. and 6. kernels vs plain versions: K1/K2 here, K3-K8 in a second
    # process at the same time (a check that fails there raises here)
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        side = pool.apply_async(side_checks)
        worst, plain = check_kernels(device, CHECK_SHAPES)
        _elapsed("K1/K2 checks", t_start)
        side_lines, side_worst, quant_layouts = side.get()
    for line in side_lines:
        print(line)
    worst.update(side_worst)
    _elapsed("K3-K8 checks", t_start)

    # 4. LGSSM path at full width
    main = main_path(device, MAIN_B, MAIN_T, MAIN_D, reps=10)
    bounds = kernel_bounds(MAIN_B, MAIN_T, MAIN_D)
    plain_bounds = kernel_bounds(*PLAIN_SHAPE)
    _elapsed("LGSSM path", t_start)

    # 5. HMM path at the bench size
    hmm = hmm_path(device, HMM_B, HMM_T, HMM_IT, reps=10)
    hmm_shape = (HMM_B, HMM_T, HMM_K)
    fb_alone = time_fb_alone(device, [hmm_shape], smi)
    fbb = fb_bounds(*hmm_shape)
    _elapsed("HMM path", t_start)
    for name, ms_key in (("fused_fb_fwd", "fwd_ms"),
                         ("fused_fb_bwd", "bwd_ms")):
        print(f"[hmm] {name}: {hmm[ms_key]:.4f} ms, bound "
              f"{fbb[name]['bound_ms']:.6f} ms ({fbb[name]['bound_by']}), "
              f"roofline share {100 * fbb[name]['bound_ms'] / hmm[ms_key]:.3f}%;"
              f" plain {hmm['plain_ms'][name]:.2f} ms (its one call on the "
              f"path's inputs) at (B,T,K)={hmm_shape}")

    # 7. path A: the continuous-batching filter at full width
    filt = filter_path(device, FILTER_B, FILTER_T, FILTER_D, reps=10)
    filt_bound = filter_bound(FILTER_B, FILTER_T, FILTER_D, FILTER_D)
    _elapsed("path A", t_start)

    # 8. path B: quantized ingest, through the engine and through the
    # evidence entry points
    quant = quantized_program_path(device, MAIN_B, MAIN_T, MAIN_D, reps=10)
    ingest = quantized_ingest_path(device, INGEST_SHAPE, reps=10)
    q_bound = quantize_bound(*QUANT_SHAPE)
    q_ingest_bound = quantize_bound(*INGEST_SHAPE[:2])
    dq_bound = dequant_bound(*INGEST_SHAPE)
    _elapsed("path B", t_start)

    # 9. the single-dataset infer and the unfused chain path: no kernel
    inf = infer_lgssm_path(device, MAIN_T, MAIN_D, reps=5)
    inf_hmm = infer_hmm_path(device, HMM_T, HMM_IT, reps=5)
    unf = unfused_path(device, main, reps=3)
    del main["y"]
    nan_b = nan_batch_path(device, NAN_B, MAIN_T, MAIN_D)
    _elapsed("infer and the unfused path", t_start)
    print(f"[filter] fused_filter: {filt['kernel_ms']:.4f} ms, bound "
          f"{filt_bound['bound_ms']:.4f} ms ({filt_bound['bound_by']}), "
          f"roofline share "
          f"{100 * filt_bound['bound_ms'] / filt['kernel_ms']:.2f}%")
    for name, label in (("quantize_rows", "int8"),
                        ("quantize_rows_fp8", "float8_e4m3fn")):
        print(f"[quant] {name}: {quant['kernel_ms'][name]:.4f} ms at rows "
              f"{QUANT_SHAPE} ({quant['layout']}), bound "
              f"{q_bound['bound_ms']:.4f} ms ({q_bound['bound_by']}), "
              f"roofline share "
              f"{100 * q_bound['bound_ms'] / quant['kernel_ms'][name]:.2f}%; "
              f"{ingest['quantize_ms'][label]:.4f} ms at rows "
              f"{INGEST_SHAPE[:2]} ({ingest['layout']}), bound "
              f"{q_ingest_bound['bound_ms']:.4f} ms, roofline share "
              f"{100 * q_ingest_bound['bound_ms'] / ingest['quantize_ms'][label]:.2f}%")
    print(f"[ingest] dequant_matmul ({ingest['dequant_layout']}): "
          f"{ingest['dequant_device_ms']['int8']} ms device, bound "
          f"{dq_bound['bound_ms']:.4f} ms ({dq_bound['bound_by']}), share of "
          f"the bound {_share(dq_bound['bound_ms'], ingest['dequant_device_ms']['int8'])}")

    for name, ms_key in (("fused_smoother_fwd", "fwd_ms"),
                         ("fused_smoother_bwd", "bwd_ms")):
        print(f"[main] {name}: {main[ms_key]:.4f} ms, bound "
              f"{bounds[name]['bound_ms']:.4f} ms ({bounds[name]['bound_by']}),"
              f" roofline share {100 * bounds[name]['bound_ms'] / main[ms_key]:.2f}%;"
              f" plain {plain[name]['plain_ms']:.2f} ms vs kernel "
              f"{plain[name]['ms']:.4f} ms at (B,T,d)={PLAIN_SHAPE}")

    # 10. the kernels line
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
            "ms_in_path_by_pass": main["profile"]["kernels"][name].get("parts"),
            "blocks": main["blocks"],
            "scratch_bytes": main["scratch_bytes"][name],
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
    from rxinfer_tpu_torch.ops import fused_fb as ffb

    main_alone = fb_alone[hmm_shape]
    marg_tile = main_alone["tile"]
    fb_tiles = {
        "fused_fb_fwd": {"staged_steps": ffb.STAGED_STEPS},
        "fused_fb_bwd": {"staged_steps": ffb.STAGED_STEPS,
                         "marginal_steps": marg_tile,
                         "marginal_tiles": -(-HMM_T // marg_tile)}}
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
            "ms_in_path_by_pass": hmm["profile"]["kernels"][name].get(
                "parts"),
            "tile": fb_tiles[name],
            "cycles_per_step": _cycles_per_step(
                hmm["profile"]["kernels"][name]["ms_per_launch"],
                main_alone["sm_clock_mhz"], HMM_T),
            "sm_clock_mhz": main_alone["sm_clock_mhz"],
            "ms_alone": {"x".join(map(str, shp)): row[name]
                         for shp, row in fb_alone.items()},
            "ms_alone_wall": {"x".join(map(str, shp)): row["wall_ms"][name]
                              for shp, row in fb_alone.items()},
            "plain_ms": hmm["plain_ms"][name],
            "bound_ms": fbb[name]["bound_ms"],
            "bound_by": fbb[name]["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes an HMM "
                            "forward-backward",
            "shape_BTK": list(hmm_shape),
            "bytes": fbb[name]["bytes"], "ops": fbb[name]["ops"],
            "plain_shape_BTK": list(hmm_shape),
        })
    rows.append({
        "name": "fused_filter", "route": "cuda",
        "source": "rxinfer_tpu_torch/csrc/fused_filter.cu",
        "replaces": "rxinfer_tpu/ops/pallas_filter.py:84",
        "launches": filt["launches"]["fused_filter"],
        "max_abs_err": max(worst["fused_filter"], filt["kernel_err"]),
        "max_abs_err_on_path": filt["kernel_err"],
        "ms": filt["kernel_ms"],
        "ms_in_path": filt["profile"]["kernels"]["fused_filter"][
            "ms_per_launch"],
        "plain_ms": filt["plain_kernel_ms"],
        "bound_ms": filt_bound["bound_ms"],
        "bound_by": filt_bound["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call computes a Kalman filter",
        "shape_BTddy": [FILTER_B, FILTER_T, FILTER_D, FILTER_D],
        "bytes": filt_bound["bytes"], "ops": filt_bound["ops"],
        "cycles_per_step": filt["cycles_per_step"],
        "sm_clock_mhz": filt["sm_clock_mhz"],
        "share_of_bound": filt_bound["bound_ms"] / filt["kernel_ms"],
    })
    q_source = "rxinfer_tpu_torch/csrc/quantized.cu"
    for name, replaces, label in (
            ("quantize_rows", "rxinfer_tpu/ops/quantized.py:50", "int8"),
            ("quantize_rows_fp8", "rxinfer_tpu/ops/quantized.py:153",
             "float8_e4m3fn")):
        it_last = QUANT_ITERATIONS[-1]
        rows.append({
            "name": name, "route": "cuda", "source": q_source,
            "replaces": replaces,
            "launches": quant["launches"][(label, it_last)][name],
            "launches_in_ingest_call": ingest["launches"][label][name],
            "max_abs_err": worst[name], "ms": quant["kernel_ms"][name],
            "ms_in_path": quant["profile"][label]["kernels"][name][
                "ms_per_launch"],
            "plain_ms": quant["plain_ms"][name],
            "bound_ms": q_bound["bound_ms"], "bound_by": q_bound["bound_by"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes a per-row "
                            "scaled quantization",
            "shape_RC": list(QUANT_SHAPE),
            "bytes": q_bound["bytes"], "ops": q_bound["ops"],
            "ingest_shape_RC": list(INGEST_SHAPE[:2]),
            "ms_at_ingest_shape": ingest["quantize_ms"][label],
            "ms_in_path_at_ingest_shape": ingest[
                "profile" if label == "int8" else "profile_fp8"]["kernels"][
                name]["ms_per_launch"],
            "plain_ms_at_ingest_shape": ingest["quantize_plain_ms"][label],
            "bound_ms_at_ingest_shape": q_ingest_bound["bound_ms"],
            "variant": quant["layout"],
            "variant_at_ingest_shape": ingest["layout"],
            "share_of_bound": q_bound["bound_ms"] / quant["kernel_ms"][name],
            "share_of_bound_at_ingest_shape":
                q_ingest_bound["bound_ms"] / ingest["quantize_ms"][label],
            "variants_checked": {
                "x".join(map(str, k)): _layout_name(v)
                for k, v in quant_layouts["quantize"].items()},
            "copy_gb_per_s": quant["copy_bytes_per_s"] / 1e9,
            "copy_gb_per_s_at_ingest_shape": ingest["copy_bytes_per_s"] / 1e9,
        })
    rows.append({
        "name": "dequant_matmul", "route": "cuda", "source": q_source,
        "replaces": "rxinfer_tpu/ops/quantized.py:107",
        "launches": ingest["launches"]["int8"]["dequant_matmul"],
        "launches_in_fp8_call": ingest["launches"]["float8_e4m3fn"][
            "dequant_matmul"],
        "max_abs_err": worst["dequant_matmul"],
        "ms": ingest["dequant_device_ms"]["int8"],
        "ms_fp8": ingest["dequant_device_ms"]["float8_e4m3fn"],
        "ms_events": ingest["dequant_ms"]["int8"],
        "ms_events_fp8": ingest["dequant_ms"]["float8_e4m3fn"],
        "ms_in_path": ingest["profile"]["kernels"]["dequant_matmul"][
            "ms_per_launch"],
        "plain_ms": ingest["dequant_plain_ms"]["int8"],
        "bound_ms": dq_bound["bound_ms"], "bound_by": dq_bound["bound_by"],
        "library_ms": ingest["library_ms"],
        "library_note": "torch.matmul on the matrix already dequantized to "
                        "float32: the product alone",
        "shape_Rdydx": list(INGEST_SHAPE),
        "bytes": dq_bound["bytes"], "ops": dq_bound["ops"],
        "bytes_per_s": ingest["dequant_bytes_per_s"]["int8"],
        "variant": ingest["dequant_layout"],
        "share_of_bound": _share(dq_bound["bound_ms"],
                                 ingest["dequant_device_ms"]["int8"]),
        "share_of_bound_fp8": _share(
            dq_bound["bound_ms"], ingest["dequant_device_ms"]["float8_e4m3fn"]),
        "copy_gb_per_s": ingest["copy_dequant_bytes_per_s"] / 1e9,
        "variants_checked": {"x".join(map(str, k)): str(v)
                             for k, v in quant_layouts["dequant"].items()},
    })
    print(f"[filter] call_ms {filt['call_ms']:.4f} chain_updates_per_s "
          f"{filt['updates_per_s']:.6g} (B={FILTER_B}, T={FILTER_T}, "
          f"d={FILTER_D})")
    print(f"[hmm] program_ms {hmm['program_ms']:.4f} updates_per_s "
          f"{hmm['updates_per_s']:.6g} (B={HMM_B}, T={HMM_T}, "
          f"iterations={HMM_IT})")
    print(f"[infer] lgssm_ms {inf['ms']:.4f} updates_per_s "
          f"{inf['updates_per_s']:.6g} (T={MAIN_T}, d={MAIN_D}); hmm_ms "
          f"{inf_hmm['ms']:.4f} (T={HMM_T}, iterations={HMM_IT}); unfused "
          f"program_ms {unf['ms']:.4f} against fused {unf['fused_ms']:.4f} "
          f"(B={MAIN_B}); NaN batch ms {nan_b['ms']:.1f} (B={NAN_B})")
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
