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
the state in registers); any other d <= ``WIDE_MAX_DIM``, at any dy,
launches ``wide_filter_tc_kernel`` of ``csrc/fused_filter_wide.cu`` (a chain
a warp, the state padded to 16, the wide smoother's tensor-core step of
``csrc/wide_step.cuh``, the evidence of the block's eight chains one
tensor-core tile a step, the means staged in shared memory and written a
row of the block's chains at a time; ``wide_filter_shape``); any
larger d, at any dy, launches a kernel of ``csrc/fused_filter_warp.cu`` (a
chain on
a warp; ``warp_plan`` picks the tier): to d = 32 ``warp_filter_tc_kernel``
(the matrices in registers, the products and the Schur blocks of the
inverses on the tensor cores in 3xTF32), to d = 64
``warp_filter_tc64_kernel`` (the same arithmetic on 16 x 16 blocks of
matrices that sit in shared memory), to d = 128 ``warp_filter_tc128_kernel``
of ``csrc/fused_filter_tc128.cu`` (the same, a chain on a block of eight
warps), past it ``warp_filter_kernel`` (the matrices in shared memory or,
past what a block holds, in a device-memory scratch).  The
wrapper takes the plain version when its tensors lie on the CPU and launches
a kernel when they lie on a CUDA device; there is no fallback from a kernel
to the plain version.  ``LAUNCHES`` counts kernel launches under
``launch_key``: ``fused_filter``, ``fused_filter_wide`` and
``fused_filter_warp``.

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
import functools

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
# any observation dimension.  Larger d go to the warp kernel, which takes
# any d and dy.
WIDE_MAX_DIM = 16
# The warp kernel: lanes a chain, at most this many chains (warps) a block,
# observations staged this many at a time.
WARP_LANES = 32
WARP_MAX_CHAINS = 8
WARP_Y_CHUNK = 32
# The warp kernel's tensor-core tier, d up to TC_DIM: the state padded to
# TC_DIM, F (float32 and its two TF32 parts), Q and W in shared memory at
# rows TC_STRIDE floats apart, each chain's m, m_pred, h, observation chunk
# and a parked 16 x 16 block (TC_VEC_FLOATS) beside them; at most
# TC_MAX_REGISTERS a thread (its launch bounds: TC_MIN_BLOCKS blocks of
# WARP_MAX_CHAINS warps an SM).
TC_DIM = 32
TC_SMALL_DIM = 24      # to this d the products are formed to 24, not 32
TC_STRIDE = 40
TC_VEC_FLOATS = 3 * TC_DIM + WARP_Y_CHUNK + 8 * WARP_LANES
TC_MIN_BLOCKS = 2
TC_MAX_REGISTERS = 65_536 // (TC_MIN_BLOCKS * WARP_MAX_CHAINS * WARP_LANES)
# The tensor-core tier past TC_DIM, d up to TC64_DIM: the state padded to 48
# (d <= TC64_SMALL_DIM) or 64, both of a chain's matrices in shared memory at
# rows padded + 8 floats apart, F's two TF32 parts, Q and W once a block;
# TC64_CHAINS[padded] chains of TC64_WARPS[padded] warps a block, one block
# an SM.
TC64_DIM = 64
TC64_SMALL_DIM = 48
TC64_CHAINS = {48: 8, 64: 4}
TC64_WARPS = {48: 1, 64: 2}    # warps a chain
# The tensor-core tier past TC64_DIM, d up to TC128_DIM: the state padded to
# TC128_DIM, a chain on a block of TC128_WARPS warps, its two matrices and F
# in shared memory at rows TC128_STRIDE floats apart, Q and W read from
# device memory (``csrc/fused_filter_tc128.cu``).
TC128_DIM = 128
TC128_STRIDE = TC128_DIM + 8
TC128_WARPS = 8

# kernel launches on CUDA tensors (the plain version on CPU tensors counts none)
LAUNCHES = {"fused_filter": 0, "fused_filter_wide": 0, "fused_filter_warp": 0}


def launch_key(d: int, dy: int) -> str:
    """The ``LAUNCHES`` key of a ``fused_filter`` call at (d, dy)."""
    if d <= REG_MAX_DIM and dy <= REG_MAX_OBS_DIM:
        return "fused_filter"
    return "fused_filter_wide" if d <= WIDE_MAX_DIM else "fused_filter_warp"


def tc64_plan(d: int) -> dict:
    """How ``warp_filter_tc64_kernel`` (``tier`` "tensor_cores_64") runs at
    state dim ``d`` (32 < d <= 64): a chain on ``warps_per_chain`` warps
    (one at DP = 48, two at 64: the block products of a step split between
    them), the state padded to ``padded_dim`` (48 to d = 48, else 64), both
    of a chain's matrices in shared memory at rows ``stride`` = padded + 8
    floats apart (8 or 24 modulo the 32 banks: a quad's float2 fragment
    loads take distinct banks), F's two TF32 parts, Q and W there once a
    block, each chain's m, m_pred, h, each warp's observation chunk and
    partial sum beside its matrices; their products and every Schur block
    of the inverses on the tensor cores in 3xTF32.  ``chains_per_block``
    chains a block and one block an SM: shared memory sets the occupancy
    (``smem_bytes``, within an H100 block's 232,448)."""
    dp = TC64_SMALL_DIM if d <= TC64_SMALL_DIM else TC64_DIM
    stride = dp + 8
    chains, warps = TC64_CHAINS[dp], TC64_WARPS[dp]
    mat = dp * stride
    vec = 3 * dp + warps * WARP_Y_CHUNK + 4
    return {"tier": "tensor_cores_64", "lanes_per_chain": warps * WARP_LANES,
            "warps_per_chain": warps, "padded_dim": dp, "stride": stride,
            "chains_per_block": chains, "params": "shared",
            "chain_matrices": "shared", "tensor_dim": dp,
            "smem_bytes": 4 * (4 * mat + chains * (2 * mat + vec)),
            "warps_per_sm": chains * warps}


def tc128_plan(d: int) -> dict:
    """How ``warp_filter_tc128_kernel`` (``tier`` "tensor_cores_128") runs
    at state dim ``d`` (64 < d <= 128): a chain a block of
    ``warps_per_chain`` = 8 warps (the block products of a step spread over
    them, the 32 x 32 inverses on the first), the state padded to 128, the
    chain's two matrices and F in shared memory at rows ``stride`` = 136
    floats apart (8 modulo the 32 banks), Q and W read from device memory
    (``params``: six matrices of 69,632 B do not fit a block's 232,448 on
    an H100), the chain's m, m_pred, h, each warp's observation chunk and
    partial sum beside them (``smem_bytes``), one block an SM; the products
    and every Schur block of the inverses on the tensor cores in 3xTF32,
    the second inverse refined by one Newton step."""
    dp, stride, warps = TC128_DIM, TC128_STRIDE, TC128_WARPS
    mat = dp * stride
    vec = 3 * dp + warps * WARP_Y_CHUNK + warps
    return {"tier": "tensor_cores_128", "lanes_per_chain": warps * WARP_LANES,
            "warps_per_chain": warps, "padded_dim": dp, "stride": stride,
            "chains_per_block": 1, "params": "F shared, Q and W device",
            "chain_matrices": "shared", "tensor_dim": dp,
            "smem_bytes": 4 * (3 * mat + vec), "warps_per_sm": warps}


def warp_plan(d: int, smem_limit: int) -> dict:
    """How the warp kernels run at state dim ``d`` (> 16) on a device whose
    blocks may take ``smem_limit`` bytes of shared memory (232,448 on an
    H100).  To d = ``TC_DIM`` the tensor-core tier (``tier``
    "tensor_cores", ``warp_filter_tc_kernel``): a chain a warp, its two
    matrices padded to 32 and held in registers in ``mma``'s accumulator
    layout (``chain_matrices`` "registers"), their products formed to
    ``tensor_dim`` (24 to d = 24, else 32: the tiles past it are padding),
    F, Q and W in shared memory (``smem_bytes``, within any sm_90 block's
    limit), at most ``max_registers`` a thread, so ``warps_per_sm`` warps
    an SM or more.  To d = ``TC64_DIM`` ``tc64_plan``'s tier, which needs
    an H100's shared memory (the launcher refuses a smaller limit); to d =
    ``TC128_DIM`` ``tc128_plan``'s tier, the same.  Past it,
    ``sweep_warp_plan``'s tiers."""
    if d > TC128_DIM:
        return sweep_warp_plan(d, smem_limit)
    if d > TC64_DIM:
        return tc128_plan(d)
    if d > TC_DIM:
        return tc64_plan(d)
    return {"tier": "tensor_cores", "lanes_per_chain": WARP_LANES,
            "columns_per_lane": 1, "padded_dim": TC_DIM,
            "stride": TC_DIM + 4, "chains_per_block": WARP_MAX_CHAINS,
            "params": "shared", "chain_matrices": "registers",
            "tensor_dim": TC_SMALL_DIM if d <= TC_SMALL_DIM else TC_DIM,
            "smem_bytes": 4 * (5 * TC_DIM * TC_STRIDE
                               + WARP_MAX_CHAINS * TC_VEC_FLOATS),
            "max_registers": TC_MAX_REGISTERS,
            "warps_per_sm": TC_MIN_BLOCKS * WARP_MAX_CHAINS}


def sweep_warp_plan(d: int, smem_limit: int) -> dict:
    """How ``warp_filter_kernel`` (``tier`` "sweep") runs at state dim
    ``d``: a chain a warp, each lane ``columns_per_lane`` of its matrices'
    columns; the matrices padded to ``padded_dim`` (a multiple of 8) with
    rows ``stride`` floats apart (+4: whole float4s, column reads over 8
    banks).  F, F^T, Q and W (``params``) sit in shared memory while they fit
    beside one chain, else they are read from device memory; a chain's two
    matrices (``chain_matrices``) sit in shared memory while one chain fits,
    else in a device-memory scratch.  ``chains_per_block`` is as many chains
    as fit, at most ``WARP_MAX_CHAINS``; ``smem_bytes`` what a block takes
    (``rxt_warp_filter_smem_bytes`` computes the same).  The inverses sweep
    the matrix where it lies."""
    dp = -(-d // 8) * 8
    stride = dp + 4
    mat = dp * stride * 4
    vec = (4 * dp + WARP_Y_CHUNK) * 4
    params, chain = 4 * mat, 2 * mat + vec
    if params + chain <= smem_limit:
        where_params, where_chain = "shared", "shared"
        chains = (smem_limit - params) // chain
    elif chain <= smem_limit:
        where_params, where_chain = "device", "shared"
        chains = smem_limit // chain
    else:
        where_params, where_chain = "device", "device"
        chains = smem_limit // vec
    chains = min(WARP_MAX_CHAINS, chains)
    smem = (params if where_params == "shared" else 0) + chains * (
        chain if where_chain == "shared" else vec)
    return {"tier": "sweep", "lanes_per_chain": WARP_LANES,
            "columns_per_lane": -(-d // WARP_LANES), "padded_dim": dp,
            "stride": stride, "chains_per_block": chains,
            "params": where_params, "chain_matrices": where_chain,
            "smem_bytes": smem}


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

def _library(key: str):
    lib = kernels.load(key)
    if not getattr(lib, "_rxt_typed", False):
        p = ctypes.c_void_p
        i64 = ctypes.c_int64
        ci = ctypes.c_int
        if key == "fused_filter_warp":
            lib.rxt_warp_filter.argtypes = [
                ci, ci, p, p, p, p, p, p, p, p, p, i64, i64, ci, ci, ci, ci,
                ci, p]
            lib.rxt_warp_filter.restype = ci
            lib.rxt_warp_filter_smem_bytes.argtypes = [ci] * 5
            lib.rxt_warp_filter_smem_bytes.restype = i64
            lib.rxt_warp_filter_smem_optin.restype = ci
            lib.rxt_warp_filter_tc.argtypes = [
                ci, ci, p, p, p, p, p, p, p, p, i64, i64, ci, ci, p]
            lib.rxt_warp_filter_tc.restype = ci
            lib.rxt_warp_filter_tc_smem_bytes.argtypes = [ci]
            lib.rxt_warp_filter_tc_smem_bytes.restype = i64
            lib.rxt_warp_filter_tc_blocks_per_sm.argtypes = [ci, ci]
            lib.rxt_warp_filter_tc_blocks_per_sm.restype = ci
            lib.rxt_warp_filter_tc64.argtypes = [
                ci, ci, p, p, p, p, p, p, p, p, i64, i64, ci, p]
            lib.rxt_warp_filter_tc64.restype = ci
            lib.rxt_warp_filter_tc64_blocks_per_sm.argtypes = [ci]
            lib.rxt_warp_filter_tc64_blocks_per_sm.restype = ci
            lib.rxt_warp_filter_tc64_smem_bytes.argtypes = [ci]
            lib.rxt_warp_filter_tc64_smem_bytes.restype = i64
        elif key == "fused_filter_tc128":
            lib.rxt_warp_filter_tc128.argtypes = [
                ci, ci, p, p, p, p, p, p, p, p, i64, i64, ci, p]
            lib.rxt_warp_filter_tc128.restype = ci
            lib.rxt_warp_filter_tc128_smem_bytes.restype = i64
            lib.rxt_warp_filter_tc128_blocks_per_sm.restype = ci
        elif key == "fused_filter_wide":
            lib.rxt_wide_filter.argtypes = [
                ctypes.c_int, ctypes.c_int, p, p, p, p, p, p, p, i64, i64, p,
                p, p, p]
            lib.rxt_wide_filter.restype = ctypes.c_int
            lib.rxt_wide_filter_max_dim.restype = ctypes.c_int
            if lib.rxt_wide_filter_max_dim() != WIDE_MAX_DIM:
                raise RuntimeError(
                    "csrc/fused_filter_wide.cu takes d up to "
                    f"{lib.rxt_wide_filter_max_dim()}, the wrapper expects "
                    f"{WIDE_MAX_DIM}")
        else:
            lib.rxt_fused_filter.argtypes = [
                ctypes.c_int, ctypes.c_int, p, p, p, p, p, p, i64, i64, p, p,
                p, p, p]
            lib.rxt_fused_filter.restype = ctypes.c_int
        lib._rxt_typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    lib = _library("fused_filter_warp")
    with torch.cuda.device(index):
        return lib.rxt_warp_filter_smem_optin()


def device_warp_plan(d: int, device) -> dict:
    """``warp_plan`` at state dim ``d`` with the shared-memory limit of the
    CUDA ``device``."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return warp_plan(d, _smem_optin(index))


def wide_filter_shape(device) -> dict:
    """The wide kernel's shape as built (card only): chains a block (a
    chain a warp), steps staged between the block's barriers, whether the
    inverses' leaves sweep pivot pairs, shared bytes a block, and the warps
    an SM holds by occupancy."""
    lib = _library("fused_filter_wide")
    vals = (ctypes.c_int * 4)()
    lib.rxt_wide_filter_shape(vals)
    out = dict(zip(("chains_per_block", "staged_steps", "pivot_pairs",
                    "smem_bytes"), vals))
    with torch.cuda.device(torch.device(device)):
        out["warps_per_sm"] = lib.rxt_wide_filter_blocks_per_sm() \
            * out["chains_per_block"]
    return out


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``, copied from pinned memory without a host
    synchronisation."""
    return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
        device, non_blocking=True)


def _launch_warp(lib, m0, p0, ys, fh, qh, hrh, wh, means, mf, pf, stream):
    """A warp kernel on the plan of ``device_warp_plan``: F, F^T, Q and W as
    one padded (4, dp, stride) device tensor, HR^T (dy, d) on the device,
    and the chains' scratch when their matrices sit in device memory.  The
    tier to d = 128 is a library of its own (``fused_filter_tc128``).
    Returns the library that launched and its CUDA error code."""
    t_len, dy, bsz = ys.shape
    d = m0.shape[0]
    plan = device_warp_plan(d, ys.device)
    dp, stride, chains = (plan["padded_dim"], plan["stride"],
                          plan["chains_per_block"])
    tc = plan["tier"] == "tensor_cores"
    tc64 = plan["tier"] == "tensor_cores_64"
    tc128 = plan["tier"] == "tensor_cores_128"
    ps, cs = plan["params"] == "shared", plan["chain_matrices"] == "shared"
    if tc128:
        lib = _library("fused_filter_tc128")
        smem = lib.rxt_warp_filter_tc128_smem_bytes()
    elif tc:
        smem = lib.rxt_warp_filter_tc_smem_bytes(chains)
    elif tc64:
        smem = lib.rxt_warp_filter_tc64_smem_bytes(d)
    else:
        smem = lib.rxt_warp_filter_smem_bytes(dp, stride, chains, ps, cs)
    if smem != plan["smem_bytes"]:
        raise RuntimeError("csrc/fused_filter_warp.cu and warp_plan disagree "
                           f"on the shared bytes of {plan}")
    prm = np.zeros((4, dp, stride), np.float32)
    for k, a in enumerate((fh, fh.T, qh, wh)):
        prm[k, :d, :d] = a
    params = _to_device(prm, ys.device)
    hr_t = _to_device(hrh.T, ys.device)
    if tc:
        return lib, lib.rxt_warp_filter_tc(
            d, dy, ys.data_ptr(), m0.data_ptr(), p0.data_ptr(),
            hr_t.data_ptr(), params.data_ptr(), means.data_ptr(),
            mf.data_ptr(), pf.data_ptr(), t_len, bsz, stride, chains, stream)
    if tc64 or tc128:
        fn = lib.rxt_warp_filter_tc128 if tc128 else lib.rxt_warp_filter_tc64
        return lib, fn(
            d, dy, ys.data_ptr(), m0.data_ptr(), p0.data_ptr(),
            hr_t.data_ptr(), params.data_ptr(), means.data_ptr(),
            mf.data_ptr(), pf.data_ptr(), t_len, bsz, stride, stream)
    scratch = None if cs else torch.empty(
        (-(-bsz // chains) * chains * 2 * dp * stride,), dtype=torch.float32,
        device=ys.device)
    return lib, lib.rxt_warp_filter(
        d, dy, ys.data_ptr(), m0.data_ptr(), p0.data_ptr(), hr_t.data_ptr(),
        params.data_ptr(), means.data_ptr(), mf.data_ptr(), pf.data_ptr(),
        None if scratch is None else scratch.data_ptr(), t_len, bsz, dp,
        stride, chains, ps, cs, stream)


def fused_filter(m0, p0, ys, f, q, hr, w):
    """K3 wrapper, batch-minor layout: m0 (d, B), p0 (nsym, B), ys (T, dy, B);
    F, Q, W (d, d) and HR (d, dy) shared by every chain.  Returns means
    (T, d, B), final m (d, B) and final packed P (nsym, B)."""
    t_len, dy, bsz = ys.shape
    d = m0.shape[0]
    if t_len < 1:
        raise ValueError("the filter needs at least one time step")
    if d < 1 or dy < 1:
        raise ValueError(f"state dim {d}, observation dim {dy}: the filter "
                         "takes d >= 1 and dy >= 1")
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
    lib = _library(key)
    stream = torch.cuda.current_stream(ys.device).cuda_stream
    if key == "fused_filter_warp":
        lib, rc = _launch_warp(lib, m0, p0, ys, fh, qh, hrh, wh, means, mf,
                               pf, stream)
    elif key == "fused_filter":
        rc = lib.rxt_fused_filter(
            d, dy, ys.data_ptr(), m0.data_ptr(), p0.data_ptr(),
            means.data_ptr(), mf.data_ptr(), pf.data_ptr(), t_len, bsz,
            _host_ptr(fh), _host_ptr(qh), _host_ptr(wh), _host_ptr(hrh),
            stream)
    else:
        # HR^T (dy, d) on the device (lane r of a chain reads column r)
        hr_t = _to_device(hrh.T, ys.device)
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
