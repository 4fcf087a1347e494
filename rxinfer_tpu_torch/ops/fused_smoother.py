"""Fused batched Kalman (RTS) smoother: the CUDA kernel pair and its plain
PyTorch version (counterpart of ``rxinfer_tpu/ops/pallas_smoother.py``).

Math per forward step (information form; no transition at t = 0):
    m_pred = F m + b ; P_pred = F P F^T + Q
    L = P_pred^-1 ; P = (L + W)^-1 ; m = P (L m_pred + xi_t)
Backward (RTS with recomputed prediction; smoothed == filtered at T-1):
    P_pred = F P_f F^T + Q ; G = P_f F^T P_pred^-1
    m_s = m_f + G (m_s' - F m_f - b) ; P_s = P_f + G (P_s' - P_pred) G^T
    cross_t = G P_s'            [Cov(x_t, x_{t+1} | all evidence)]

Kernels (``csrc/fused_smoother.cuh``, built by ``fused_smoother.cu`` for
float32 moments and ``fused_smoother_bf16.cu`` for bf16 ones):
  * ``fused_forward``  replaces ``_fwd_kernel`` (pallas_smoother.py:76-136);
  * ``fused_backward`` replaces ``_bwd_kernel`` (pallas_smoother.py:139-203).
Each wrapper takes its plain version when its tensors lie on the CPU and
launches its kernels when they lie on a CUDA device (any other device
raises); there is no fallback from the kernels to the plain version.
``LAUNCHES`` counts wrapper calls that launched, one per call.

What bounds the kernels on an H100 is the latency of one step, not bytes or
operations: a step is a dependent chain of about a thousand operations, and
one thread per chain leaves most of the card's 528 warp schedulers without
a warp (1,024 chains are 32 warps).  The recursion is serial in time, so the
wrappers cut time instead: S blocks of L = ceil(T / S) steps, one thread per
(chain, block), in three passes.  *Fold* composes each block's associative
elements (``ops/kalman.py``) into one composite; *carry*, one thread per
chain, applies the S composites in order and leaves each block's entry
state; *replay* runs the step loop above over each block from its entry
state and writes the moments.  Inside a block the result differs from the
one-block recursion only through the entry state.  S comes from
``pick_blocks`` (B, T, d and the card's SM count), is 1 when the batch
alone fills the card, T is short or d has no fold kernel
(d > ``FOLD_MAX_DIM``), and at S = 1 the replay pass alone runs: the
one-thread-per-chain recursion.  ``fused_forward_blocked_reference`` /
``fused_backward_blocked_reference`` are the plain version of the three
passes, with the number of blocks as an argument.

Moments travel between the two kernels in struct-of-arrays layout, batch
minor: means (T, d, B), upper-triangle covariances (T, nsym, B) in
``sym_idx`` order, cross (T-1, d*d, B) row-major.  ``fused_batched_smoother``
keeps the JAX wrapper's contract: m0 (B, d), p0 (B, d, d), xi (T, B, d) ->
means (T, B, d), covs (T, B, d, d), cross (T-1, B, d, d).  Unlike the JAX
wrapper it accepts T = 1 (cross is then (0, B, d, d)).

Per-chain W and Q (V1, the dynamic-precision tier of the TPU kernels).
``w_batch`` / ``q_batch`` (B, d, d) replace the shared W / Q: the evidence
precision and the transition noise COVARIANCE of each chain, re-closed
every VMP sweep when they are bound to a random variable.  The kernels read
them as (nsym, B) sym-packed tiles (upper triangle: the plain versions read
the same entries), one read a thread, and the backward pass reads Q only.
Launches of the per-chain instantiations count under
``fused_smoother_fwd_dyn`` / ``fused_smoother_bwd_dyn``; the launchers pick
them from which tiles are given.  With W alone per chain the backward pass
is the static one (it reads Q only), as in the JAX package.

State dims 9..16 (V3).  The replay kernels keep a chain's state in one
thread's registers and are instantiated for d <= ``REG_MAX_DIM``; for d in
(``REG_MAX_DIM``, ``MAX_DIM``] the wrappers launch the wide kernels of
``csrc/fused_smoother_wide.cu`` instead (one time block, shared or
per-chain W / Q), counted under the ``_wide`` keys: K1 a chain a warp, its
16 x 16 matrices in ``mma.sync``'s accumulator layout; K2 a consumer warp
a chain beside producer warps that form the gain ahead of it.  Their plain
version is the same d-generic one (``forward_step``, ``backward_step``);
the wide kernels multiply in 3xTF32 on the tensor cores and invert by the
Schur blocks at 8 with Gauss-Jordan leaves, the plain version by the Schur
recursion split at d / 2, so the two agree to rounding, not bit for bit.
``wide_kernel_shape`` reads their shape as built on the card.

bf16 moments (V2, ``moment_dtype=torch.bfloat16``).  The packed filtered
and smoothed covariances and the cross are stored in bf16, rounded to
nearest even where the JAX kernels round (``pallas_smoother.py:127, 194,
196``): K1 carries its state in float32 and stores pf rounded; K2 reads pf
rounded and upcast, carries the smoothed state in float32 and stores ps and
cross rounded; at T-1 the smoothed moment is the rounded filtered one.
Means and arithmetic stay float32, and ``fused_batched_smoother`` returns
float32 covariances and cross, as the JAX wrapper does.  Launches count
under the ``_bf16`` keys.  Every wrapper call counts under one key of
``LAUNCHES``: ``launch_key(direction, d, dyn, bf16)``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels
from . import entrywise as ew
from . import kalman

# Largest chain state of the register kernels (``csrc/fused_smoother.cuh``).
# Each thread keeps one chain's state (d + d(d+1)/2 floats) and the
# Schur-inverse temporaries in registers; the replay kernels are
# instantiated for d = 1..8, and at d = 8 the backward one already needs 255
# registers.  At d = 16 the state alone is 152 floats, so d in (8, 16] runs
# on the wide kernels (``csrc/fused_smoother_wide.cu``: a chain a warp, its
# 16 x 16 matrices eight registers a lane).
REG_MAX_DIM = 8
# Largest chain state any smoother kernel takes: the JAX tier's (d <= 16).
MAX_DIM = 16
# Storage types of the packed covariances and the cross.
MOMENT_DTYPES = (torch.float32, torch.bfloat16)
# Largest d with a fold and a carry kernel (``kFoldMaxDim`` in the source).
# A fold thread carries a whole composite, d*d + 2d + d(d+1) floats forward,
# beside the general inverse's temporaries: up to d = 5 no fold or carry
# kernel spills (K1's fold uses 168 registers at d = 4 and 255 at d = 5), at
# d = 6 K1's fold spills 112 bytes and at d = 8 2,304 (ptxas, sm_90a).  Above
# this d the wrappers launch one block.
FOLD_MAX_DIM = 5

# The rule that picks the number of time blocks (``pick_blocks``).
WARPS_PER_SCHEDULER = 4     # fill the card this deep: B * S threads
SCHEDULERS_PER_SM = 4
MIN_BLOCK_STEPS = 32        # a block is never shorter (but for the last one)
MIN_BLOCKS = 8              # fold + replay cost ~2.3-4 steps per step: below
                            # this many blocks one block is as fast
MAX_BLOCKS = 128            # the carry pass is serial in S


def launch_key(direction: str, d: int, dyn: bool, bf16: bool) -> str:
    """The ``LAUNCHES`` key of a wrapper call: ``fused_smoother_<fwd|bwd>``,
    then ``_wide`` for the wide kernels (d > ``REG_MAX_DIM``), ``_dyn`` for
    per-chain W / Q, ``_bf16`` for bf16 moments."""
    return (f"fused_smoother_{direction}" + ("_wide" if d > REG_MAX_DIM else "")
            + ("_dyn" if dyn else "") + ("_bf16" if bf16 else ""))


# wrapper calls that launched on CUDA tensors, one per call whatever the
# number of passes (the plain version on CPU tensors counts none), under
# the key of the instantiation that ran (``launch_key``)
LAUNCHES = {launch_key(direction, d, dyn, bf16): 0
            for d in (REG_MAX_DIM, MAX_DIM) for direction in ("fwd", "bwd")
            for dyn in (False, True) for bf16 in (False, True)}


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
    """(T, nsym, B) -> (T, B, d, d) float32: gather each full-matrix entry
    from its upper-triangle slot (bf16 moments upcast, as the JAX wrapper
    returns them)."""
    _, _, full = _sym_indices(d, x.device)
    gathered = x[:, full, :].float()                          # (T, d*d, B)
    return gathered.reshape(x.shape[0], d, d, x.shape[-1]).permute(0, 3, 1, 2)


def _host_params(f, b, q, w, d):
    """The shared parameters as float32 numpy; Q or W may be None (given
    per chain instead), and is then zeros."""
    cast = lambda a: np.zeros((d, d), np.float32) if a is None else \
        np.ascontiguousarray(np.asarray(
            a.detach().cpu() if isinstance(a, torch.Tensor) else a,
            dtype=np.float32))
    f, b, q, w = cast(f), cast(b), cast(q), cast(w)
    if f.shape != (d, d) or q.shape != (d, d) or w.shape != (d, d) \
            or b.shape != (d,):
        raise ValueError(
            f"smoother parameters must be F, Q, W ({d}, {d}) and b ({d},); got "
            f"{f.shape}, {q.shape}, {w.shape}, {b.shape}")
    return f, b, q, w


def _check_per_chain(name, x, shared, bsz, d):
    """A per-chain parameter is (B, d, d) and replaces a shared one."""
    if x is None:
        if shared is None:
            raise ValueError(f"{name}: give the shared matrix or the "
                             "per-chain one")
        return
    if tuple(x.shape) != (bsz, d, d):
        raise ValueError(f"{name}_batch has shape {tuple(x.shape)}, "
                         f"expected {(bsz, d, d)}")


def _param_entries(shared_entries, per_chain):
    """Entry lists of a parameter: the shared matrix's floats, or the
    per-chain (B, d, d) tensor's upper-triangle entries, aliased below the
    diagonal (the kernels read the sym-packed upper triangle)."""
    if per_chain is None:
        return shared_entries
    d = per_chain.shape[-1]
    return ew.sym_alias([[per_chain[:, i, j] if i <= j else None
                          for j in range(d)] for i in range(d)])


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


def check_moment_dtype(moment_dtype) -> torch.dtype:
    """``moment_dtype`` (None: float32) if the kernels store moments in it,
    else raise."""
    md = torch.float32 if moment_dtype is None else moment_dtype
    if md not in MOMENT_DTYPES:
        raise ValueError(f"moment_dtype {moment_dtype!r}: the smoother "
                         "stores its moments in torch.float32 or "
                         "torch.bfloat16")
    return md


def _pf_moment_dtype(pf, moment_dtype) -> torch.dtype:
    """K2's moment dtype: pf's, which ``moment_dtype`` may restate."""
    md = check_moment_dtype(pf.dtype)
    if moment_dtype is not None and check_moment_dtype(moment_dtype) != md:
        raise ValueError(f"pf is {pf.dtype}, moment_dtype {moment_dtype}")
    return md


def _entries(m, p):
    """(B, d), (B, d, d) tensors -> the step functions' entry lists."""
    d = m.shape[-1]
    return [m[:, i] for i in range(d)], ew.sym_alias(
        [[p[:, i, j] if i <= j else None for j in range(d)] for i in range(d)])


def fused_forward_reference(m0, p0, xi, f, b, q, w, w_batch=None,
                            q_batch=None, moment_dtype=None):
    """Plain forward pass on (B,) entry tensors; returns mf (T, d, B) and
    pf (T, nsym, B) in ``moment_dtype`` (float32 by default; the state is
    carried in float32 and rounded as it is stored).  Same recurrence and
    operation order as the register kernels.  ``w_batch`` / ``q_batch``
    (B, d, d) replace W / Q per chain."""
    t_len, bsz, d = xi.shape
    md = check_moment_dtype(moment_dtype)
    _check_per_chain("w", w_batch, w, bsz, d)
    _check_per_chain("q", q_batch, q, bsz, d)
    f, b, q, w = _host_params(f, b, q, w, d)
    fe, be = f.tolist(), b.tolist()
    qe = _param_entries(q.tolist(), q_batch)
    we = _param_entries(w.tolist(), w_batch)
    m, p = _entries(m0, p0)
    mf = torch.empty((t_len, d, bsz), dtype=xi.dtype, device=xi.device)
    pf = torch.empty((t_len, d * (d + 1) // 2, bsz), dtype=md,
                     device=xi.device)
    for t in range(t_len):
        xi_t = [xi[t, :, k] for k in range(d)]
        m, p = forward_step(m, p, xi_t, fe, be, qe, we, first=t == 0)
        mf[t] = torch.stack(m)
        pf[t] = torch.stack([p[i][j] for i, j in sym_idx(d)])
    return mf, pf


def fused_backward_reference(mf, pf, f, b, q, q_batch=None,
                             moment_dtype=None):
    """Plain RTS pass over the filtered SoA streams; returns ms (T, d, B),
    ps (T, nsym, B) and cross (T-1, d*d, B), ps and cross in pf's dtype
    (``moment_dtype`` may restate it): pf is read upcast, the smoothed state
    carried in float32 and rounded as it is stored.  ``q_batch`` (B, d, d)
    replaces Q per chain."""
    t_len, d, bsz = mf.shape
    md = _pf_moment_dtype(pf, moment_dtype)
    _check_per_chain("q", q_batch, q, bsz, d)
    f, b, q, _ = _host_params(f, b, q, None, d)
    fe, be = f.tolist(), b.tolist()
    qe = _param_entries(q.tolist(), q_batch)
    nsym = d * (d + 1) // 2
    pf32 = pf.float()
    ms = torch.empty_like(mf)
    ps = torch.empty_like(pf)
    cross = torch.empty((t_len - 1, d * d, bsz), dtype=md, device=mf.device)
    ms[t_len - 1] = mf[t_len - 1]
    ps[t_len - 1] = pf[t_len - 1]
    m_s = [mf[t_len - 1, i] for i in range(d)]
    p_s = _unpack_entries([pf32[t_len - 1, k] for k in range(nsym)], d)
    for t in range(t_len - 2, -1, -1):
        m_f = [mf[t, i] for i in range(d)]
        p_f = _unpack_entries([pf32[t, k] for k in range(nsym)], d)
        m_s, p_s, cr = backward_step(m_f, p_f, m_s, p_s, fe, be, qe)
        cross[t] = torch.stack([cr[i][j] for i in range(d) for j in range(d)])
        ms[t] = torch.stack(m_s)
        ps[t] = torch.stack([p_s[i][j] for i, j in sym_idx(d)])
    return ms, ps, cross


# -- the time-blocked design: block rule and plain version -------------------------

def time_blocks(t_len: int, blocks: int) -> list:
    """[(t0, t1)) spans of the time axis cut into at most ``blocks`` blocks of
    ceil(T / blocks) steps; the last one may be shorter."""
    length = -(-t_len // max(1, min(blocks, t_len)))
    return [(t0, min(t0 + length, t_len)) for t0 in range(0, t_len, length)]


def pick_blocks(bsz: int, t_len: int, d: int, sm_count: int) -> int:
    """Number of time blocks S the kernels take at (B, T, d) on a card with
    ``sm_count`` SMs: enough that B * S threads fill every warp scheduler
    ``WARPS_PER_SCHEDULER`` deep, at most ``MAX_BLOCKS``, no block shorter
    than ``MIN_BLOCK_STEPS``; 1 when that leaves fewer than ``MIN_BLOCKS``
    (the batch alone fills the card, or T is short) or d has no fold kernel.
    The result is exact: cutting T into S blocks gives S non-empty blocks."""
    if d > FOLD_MAX_DIM or bsz < 1:
        return 1
    threads = sm_count * SCHEDULERS_PER_SM * 32 * WARPS_PER_SCHEDULER
    blocks = min(-(-threads // bsz), t_len // MIN_BLOCK_STEPS, MAX_BLOCKS)
    if blocks < MIN_BLOCKS:
        return 1
    return len(time_blocks(t_len, blocks))


def forward_scratch_rows(d: int) -> int:
    """Rows of one block's slot in the forward scratch (S, rows, B): the
    composite (A, b, C, eta, J) and the block's entry state (m, P)."""
    return d * d + 3 * d + 3 * (d * (d + 1) // 2)


def backward_scratch_rows(d: int) -> int:
    """Rows of one block's slot in the backward scratch: the composite
    (E, g, L) and the block's entry state (m, P)."""
    return d * d + 2 * d + 2 * (d * (d + 1) // 2)


def _shared(params, like):
    return [torch.as_tensor(a, dtype=like.dtype, device=like.device)
            for a in params]


def _sym_upper(x):
    """A (B, d, d) per-chain parameter as the kernels read it: its upper
    triangle, mirrored."""
    return torch.triu(x) + torch.triu(x, 1).transpose(-1, -2)


def fused_forward_blocked_reference(m0, p0, xi, f, b, q, w, blocks: int,
                                    w_batch=None, q_batch=None,
                                    moment_dtype=None):
    """Plain version of the time-blocked forward pass: fold, carry and replay
    over ``time_blocks(T, blocks)`` on tensors.  Same result layout as
    ``fused_forward_reference``, to which it is equal at ``blocks`` = 1 and
    equal up to the rounding of the carried entry states otherwise (the
    carried states are float32 whatever ``moment_dtype``).  ``w_batch`` /
    ``q_batch`` (B, d, d) replace W / Q per chain."""
    t_len, bsz, d = xi.shape
    md = check_moment_dtype(moment_dtype)
    _check_per_chain("w", w_batch, w, bsz, d)
    _check_per_chain("q", q_batch, q, bsz, d)
    fh, bh, qh, wh = _host_params(f, b, q, w, d)
    fe, be = fh.tolist(), bh.tolist()
    qe = _param_entries(qh.tolist(), q_batch)
    we = _param_entries(wh.tolist(), w_batch)
    ft, bt, qt, wt = _shared((fh, bh, qh, wh), xi)
    if q_batch is not None:
        qt = _sym_upper(q_batch)
    if w_batch is not None:
        wt = _sym_upper(w_batch)
    spans = time_blocks(t_len, blocks)

    # fold: one composite per block but the last, whose composite has no reader
    composites = []
    for s, (t0, t1) in enumerate(spans[:-1]):
        if s == 0:
            comp = kalman.filter_first_element(m0, p0, xi[0], wt)
        else:
            comp = kalman.filter_step_element(ft, bt, qt, xi[t0], wt)
        for t in range(t0 + 1, t1):
            comp = kalman.filter_compose(
                comp, kalman.filter_step_element(ft, bt, qt, xi[t], wt))
        composites.append(comp)

    # carry: the filtered state just before each block (block 0: the prior;
    # its composite has A = 0, so it forgets the state it is applied to)
    entry = [(m0, p0)]
    for comp in composites:
        entry.append(kalman.filter_apply(*entry[-1], comp))

    # replay: the step recursion inside each block
    mf = torch.empty((t_len, d, bsz), dtype=xi.dtype, device=xi.device)
    pf = torch.empty((t_len, d * (d + 1) // 2, bsz), dtype=md,
                     device=xi.device)
    for (t0, t1), (m_in, p_in) in zip(spans, entry):
        m, p = _entries(m_in, p_in)
        for t in range(t0, t1):
            xi_t = [xi[t, :, k] for k in range(d)]
            m, p = forward_step(m, p, xi_t, fe, be, qe, we, first=t == 0)
            mf[t] = torch.stack(m)
            pf[t] = torch.stack([p[i][j] for i, j in sym_idx(d)])
    return mf, pf


def fused_backward_blocked_reference(mf, pf, f, b, q, blocks: int,
                                     q_batch=None, moment_dtype=None):
    """Plain version of the time-blocked RTS pass; same result layout and
    moment dtype as ``fused_backward_reference``.  The fold and the replay
    both read pf upcast, so a blocked run holds the inputs of one block.
    ``q_batch`` (B, d, d) replaces Q per chain."""
    t_len, d, bsz = mf.shape
    md = _pf_moment_dtype(pf, moment_dtype)
    _check_per_chain("q", q_batch, q, bsz, d)
    fh, bh, qh, _ = _host_params(f, b, q, None, d)
    fe, be = fh.tolist(), bh.tolist()
    qe = _param_entries(qh.tolist(), q_batch)
    ft, bt, qt = _shared((fh, bh, qh), mf)
    if q_batch is not None:
        qt = _sym_upper(q_batch)
    nsym = d * (d + 1) // 2
    spans = time_blocks(t_len, blocks)
    means = mf.permute(0, 2, 1)                               # (T, B, d)
    covs = sym_unfold_t(pf, d)                                # (T, B, d, d)

    def element(t):
        if t == t_len - 1:
            return kalman.smoother_last_element(means[t], covs[t])
        return kalman.smoother_step_element(means[t], covs[t], ft, bt, qt)

    # fold, last step first; block 0's composite has no reader
    composites = {}
    for s in range(1, len(spans)):
        t0, t1 = spans[s]
        comp = element(t1 - 1)
        for t in range(t1 - 2, t0 - 1, -1):
            comp = kalman.smooth_compose(comp, element(t))
        composites[s] = comp

    # carry, back to front: the smoothed state just after each block (the
    # last block's composite has E = 0 and forgets the state it is applied to)
    state = (torch.zeros_like(means[0]), torch.zeros_like(covs[0]))
    entry = {}
    for s in range(len(spans) - 1, 0, -1):
        state = kalman.smooth_apply(*state, composites[s])
        entry[s - 1] = state

    # replay
    ms = torch.empty_like(mf)
    ps = torch.empty_like(pf)
    cross = torch.empty((t_len - 1, d * d, bsz), dtype=md, device=mf.device)
    ms[t_len - 1] = mf[t_len - 1]
    ps[t_len - 1] = pf[t_len - 1]
    pf32 = pf.float()
    for s, (t0, t1) in enumerate(spans):
        if t1 == t_len:
            m_s, p_s = _entries(means[t_len - 1], covs[t_len - 1])
            t_hi = t_len - 2
        else:
            m_s, p_s = _entries(*entry[s])
            t_hi = t1 - 1
        for t in range(t_hi, t0 - 1, -1):
            m_f = [mf[t, i] for i in range(d)]
            p_f = _unpack_entries([pf32[t, k] for k in range(nsym)], d)
            m_s, p_s, cr = backward_step(m_f, p_f, m_s, p_s, fe, be, qe)
            cross[t] = torch.stack([cr[i][j] for i in range(d)
                                    for j in range(d)])
            ms[t] = torch.stack(m_s)
            ps[t] = torch.stack([p_s[i][j] for i, j in sym_idx(d)])
    return ms, ps, cross


# -- kernel launches ----------------------------------------------------------------

def _library(bf16: bool = False):
    """The register kernels' library for float32 moments
    (``csrc/fused_smoother.cu``) or bf16 ones (``fused_smoother_bf16.cu``):
    the same kernels (``fused_smoother.cuh``), one storage type each."""
    name = "fused_smoother_bf16" if bf16 else "fused_smoother"
    lib = kernels.load(name)
    if not getattr(lib, "_rxt_typed", False):
        p = ctypes.c_void_p
        i64 = ctypes.c_int64
        lib.rxt_fused_smoother_fwd.argtypes = [
            ctypes.c_int, p, p, p, p, p, i64, i64, p, p, p, p, p, p, i64, i64,
            p, p]
        lib.rxt_fused_smoother_fwd.restype = ctypes.c_int
        lib.rxt_fused_smoother_bwd.argtypes = [
            ctypes.c_int, p, p, p, p, p, i64, i64, p, p, p, p, i64, i64, p, p]
        lib.rxt_fused_smoother_bwd.restype = ctypes.c_int
        lib.rxt_fused_smoother_fold_max_dim.restype = ctypes.c_int
        lib.rxt_fused_smoother_moment_bytes.restype = ctypes.c_int
        if lib.rxt_fused_smoother_fold_max_dim() != FOLD_MAX_DIM:
            raise RuntimeError(
                f"csrc/{name}.cu folds up to d = "
                f"{lib.rxt_fused_smoother_fold_max_dim()}, the wrapper "
                f"expects {FOLD_MAX_DIM}")
        if lib.rxt_fused_smoother_moment_bytes() != (2 if bf16 else 4):
            raise RuntimeError(f"csrc/{name}.cu stores moments of "
                               f"{lib.rxt_fused_smoother_moment_bytes()} "
                               "bytes")
        lib._rxt_typed = True
    return lib


def _wide_library():
    lib = kernels.load("fused_smoother_wide")
    if not getattr(lib, "_rxt_typed", False):
        p = ctypes.c_void_p
        i64 = ctypes.c_int64
        lib.rxt_wide_smoother_fwd.argtypes = [
            ctypes.c_int, p, p, p, p, p, i64, i64, p, p, p, p, p, p,
            ctypes.c_int, p]
        lib.rxt_wide_smoother_fwd.restype = ctypes.c_int
        lib.rxt_wide_smoother_bwd.argtypes = [
            ctypes.c_int, p, p, p, p, p, i64, i64, p, p, p, p, ctypes.c_int,
            p]
        lib.rxt_wide_smoother_bwd.restype = ctypes.c_int
        lib.rxt_wide_smoother_max_dim.restype = ctypes.c_int
        lib.rxt_wide_smoother_shape.argtypes = [p]
        lib.rxt_wide_smoother_blocks_per_sm.argtypes = [ctypes.c_int] * 2
        lib.rxt_wide_smoother_blocks_per_sm.restype = ctypes.c_int
        if lib.rxt_wide_smoother_max_dim() != MAX_DIM:
            raise RuntimeError(
                "csrc/fused_smoother_wide.cu takes d up to "
                f"{lib.rxt_wide_smoother_max_dim()}, the wrapper expects "
                f"{MAX_DIM}")
        lib._rxt_typed = True
    return lib


def wide_kernel_shape(device) -> dict:
    """The wide kernels' shape as built (card only): K1's chains a warp and
    warps a block; K2's producer warps a chain, steps a producer takes a
    round, chains a block, threads and shared bytes a block; and the warps
    an SM holds of each by occupancy (float32 moments)."""
    lib = _wide_library()
    vals = (ctypes.c_int * 7)()
    lib.rxt_wide_smoother_shape(vals)
    keys = ("fwd_chains_per_warp", "fwd_warps_per_block", "bwd_producers",
            "bwd_steps_per_round", "bwd_chains_per_block",
            "bwd_threads_per_block", "bwd_smem_bytes")
    out = dict(zip(keys, vals))
    with torch.cuda.device(device):
        out["fwd_warps_per_sm"] = lib.rxt_wide_smoother_blocks_per_sm(
            0, 0) * out["fwd_warps_per_block"]
        out["bwd_warps_per_sm"] = lib.rxt_wide_smoother_blocks_per_sm(
            1, 0) * out["bwd_threads_per_block"] // 32
    return out


def _device_blocks(bsz, t_len, d, device) -> int:
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    return pick_blocks(bsz, t_len, d, sm_count)


def _block_scratch(blocks, rows, t_len, bsz, device):
    """(block length, a fresh (blocks, rows, B) scratch tensor or None at one
    block).  The caller holds the tensor until its kernels are queued; after
    that the allocator hands the memory out again only to work queued later
    on the same stream."""
    length = -(-t_len // blocks)
    if blocks == 1:
        return length, None
    return length, torch.empty((blocks, rows, bsz), dtype=torch.float32,
                               device=device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _host_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _check_dims(t_len, d):
    if t_len < 1:
        raise ValueError("the smoother needs at least one time step")
    if not 1 <= d <= MAX_DIM:
        raise ValueError(
            f"state dim {d}: the CUDA smoother kernels take d = 1..{MAX_DIM} "
            f"(the register kernels 1..{REG_MAX_DIM}, the wide ones above)")


def _tile(name, x, bsz, d):
    """A per-chain (B, d, d) parameter as the kernels' (nsym, B) tile, or
    None."""
    if x is None:
        return None
    kernels.check_tensor(f"{name}_batch", x, (bsz, d, d))
    tile = sym_fold(x).contiguous()
    kernels.check_tensor(f"{name}_batch tile", tile, (d * (d + 1) // 2, bsz))
    return tile


def fused_forward(m0, p0, xi, f, b, q, w, w_batch=None, q_batch=None,
                  moment_dtype=None):
    """K1 wrapper: filtered moments mf (T, d, B), pf (T, nsym, B) in
    ``moment_dtype`` (float32 or bfloat16; None: float32).  ``w_batch`` /
    ``q_batch`` (B, d, d) give W / Q per chain (pass ``w`` / ``q`` as None
    beside them).  d <= ``REG_MAX_DIM`` launches the register kernels, d up
    to ``MAX_DIM`` the wide ones."""
    t_len, bsz, d = xi.shape
    _check_dims(t_len, d)
    md = check_moment_dtype(moment_dtype)
    if xi.device.type == "cpu":
        return fused_forward_reference(m0, p0, xi, f, b, q, w, w_batch,
                                       q_batch, md)
    kernels.check_tensor("xi", xi, (t_len, bsz, d))
    if d > REG_MAX_DIM:
        return _forward_wide(m0, p0, xi, f, b, q, w, w_batch, q_batch, md)
    return _forward_cuda(m0, p0, xi, f, b, q, w,
                         _device_blocks(bsz, t_len, d, xi.device), w_batch,
                         q_batch, md)


def _forward_outputs(m0, p0, xi, f, b, q, w, w_batch, q_batch, md):
    """Checked inputs of a K1 launch: the per-chain tiles, the shared
    parameters on the host and the empty outputs mf, pf."""
    t_len, bsz, d = xi.shape
    kernels.check_tensor("m0", m0, (bsz, d))
    kernels.check_tensor("p0", p0, (bsz, d, d))
    _check_per_chain("w", w_batch, w, bsz, d)
    _check_per_chain("q", q_batch, q, bsz, d)
    w_tile = _tile("w", w_batch, bsz, d)
    q_tile = _tile("q", q_batch, bsz, d)
    params = _host_params(f, b, q, w, d)
    nsym = d * (d + 1) // 2
    mf = torch.empty((t_len, d, bsz), dtype=torch.float32, device=xi.device)
    pf = torch.empty((t_len, nsym, bsz), dtype=md, device=xi.device)
    return w_tile, q_tile, params, mf, pf


def _forward_cuda(m0, p0, xi, f, b, q, w, blocks: int, w_batch=None,
                  q_batch=None, moment_dtype=None):
    """Launch K1's register kernels over ``blocks`` time blocks (fold,
    carry, replay; the replay pass alone at 1).  ``blocks`` must be what
    ``time_blocks`` yields."""
    t_len, bsz, d = xi.shape
    md = check_moment_dtype(moment_dtype)
    w_tile, q_tile, (fh, bh, qh, wh), mf, pf = _forward_outputs(
        m0, p0, xi, f, b, q, w, w_batch, q_batch, md)
    if bsz == 0:
        return mf, pf
    bf16 = md == torch.bfloat16
    lib = _library(bf16)
    stream = torch.cuda.current_stream(xi.device).cuda_stream
    length, scratch = _block_scratch(
        blocks, forward_scratch_rows(d), t_len, bsz, xi.device)
    rc = lib.rxt_fused_smoother_fwd(
        d, xi.data_ptr(), m0.data_ptr(), p0.data_ptr(), mf.data_ptr(),
        pf.data_ptr(), t_len, bsz, _host_ptr(fh), _host_ptr(bh),
        _host_ptr(qh), _host_ptr(wh), _ptr(w_tile), _ptr(q_tile), length,
        blocks, _ptr(scratch), stream)
    kernels.check(lib, rc, "fused_smoother forward kernels")
    dyn = w_tile is not None or q_tile is not None
    LAUNCHES[launch_key("fwd", d, dyn, bf16)] += 1
    return mf, pf


def _forward_wide(m0, p0, xi, f, b, q, w, w_batch=None, q_batch=None,
                  moment_dtype=None):
    """Launch K1's wide kernel (d up to ``MAX_DIM``, one time block)."""
    t_len, bsz, d = xi.shape
    md = check_moment_dtype(moment_dtype)
    w_tile, q_tile, (fh, bh, qh, wh), mf, pf = _forward_outputs(
        m0, p0, xi, f, b, q, w, w_batch, q_batch, md)
    if bsz == 0:
        return mf, pf
    lib = _wide_library()
    stream = torch.cuda.current_stream(xi.device).cuda_stream
    bf16 = md == torch.bfloat16
    rc = lib.rxt_wide_smoother_fwd(
        d, xi.data_ptr(), m0.data_ptr(), p0.data_ptr(), mf.data_ptr(),
        pf.data_ptr(), t_len, bsz, _host_ptr(fh), _host_ptr(bh),
        _host_ptr(qh), _host_ptr(wh), _ptr(w_tile), _ptr(q_tile), int(bf16),
        stream)
    kernels.check(lib, rc, "fused_smoother wide forward kernel")
    dyn = w_tile is not None or q_tile is not None
    LAUNCHES[launch_key("fwd", d, dyn, bf16)] += 1
    return mf, pf


def fused_backward(mf, pf, f, b, q, q_batch=None, moment_dtype=None):
    """K2 wrapper: smoothed ms (T, d, B), ps (T, nsym, B), cross
    (T-1, d*d, B) from the forward kernel's streams, ps and cross in pf's
    dtype (``moment_dtype`` may restate it).  ``q_batch`` (B, d, d) gives Q
    per chain (pass ``q`` as None beside it)."""
    t_len, d, bsz = mf.shape
    _check_dims(t_len, d)
    md = _pf_moment_dtype(pf, moment_dtype)
    if mf.device.type == "cpu":
        return fused_backward_reference(mf, pf, f, b, q, q_batch, md)
    if d > REG_MAX_DIM:
        return _backward_wide(mf, pf, f, b, q, q_batch)
    return _backward_cuda(mf, pf, f, b, q,
                          _device_blocks(bsz, t_len, d, mf.device), q_batch)


def _backward_outputs(mf, pf, f, b, q, q_batch):
    """Checked inputs of a K2 launch: the per-chain Q tile, the shared
    parameters on the host and the empty outputs ms, ps, cross."""
    t_len, d, bsz = mf.shape
    nsym = d * (d + 1) // 2
    md = _pf_moment_dtype(pf, None)
    kernels.check_tensor("mf", mf, (t_len, d, bsz))
    kernels.check_tensor("pf", pf, (t_len, nsym, bsz), dtype=md)
    _check_per_chain("q", q_batch, q, bsz, d)
    q_tile = _tile("q", q_batch, bsz, d)
    params = _host_params(f, b, q, None, d)
    ms = torch.empty_like(mf)
    ps = torch.empty_like(pf)
    cross = torch.empty((t_len - 1, d * d, bsz), dtype=md, device=mf.device)
    return q_tile, params, ms, ps, cross


def _backward_cuda(mf, pf, f, b, q, blocks: int, q_batch=None):
    """Launch K2's register kernels over ``blocks`` time blocks (see
    ``_forward_cuda``); the moment dtype is pf's."""
    t_len, d, bsz = mf.shape
    q_tile, (fh, bh, qh, _), ms, ps, cross = _backward_outputs(
        mf, pf, f, b, q, q_batch)
    if bsz == 0:
        return ms, ps, cross
    bf16 = pf.dtype == torch.bfloat16
    lib = _library(bf16)
    stream = torch.cuda.current_stream(mf.device).cuda_stream
    length, scratch = _block_scratch(
        blocks, backward_scratch_rows(d), t_len, bsz, mf.device)
    rc = lib.rxt_fused_smoother_bwd(
        d, mf.data_ptr(), pf.data_ptr(), ms.data_ptr(), ps.data_ptr(),
        cross.data_ptr(), t_len, bsz, _host_ptr(fh), _host_ptr(bh),
        _host_ptr(qh), _ptr(q_tile), length, blocks, _ptr(scratch), stream)
    kernels.check(lib, rc, "fused_smoother backward kernels")
    LAUNCHES[launch_key("bwd", d, q_tile is not None, bf16)] += 1
    return ms, ps, cross


def _backward_wide(mf, pf, f, b, q, q_batch=None):
    """Launch K2's wide kernel (d up to ``MAX_DIM``, one time block)."""
    t_len, d, bsz = mf.shape
    q_tile, (fh, bh, qh, _), ms, ps, cross = _backward_outputs(
        mf, pf, f, b, q, q_batch)
    if bsz == 0:
        return ms, ps, cross
    lib = _wide_library()
    stream = torch.cuda.current_stream(mf.device).cuda_stream
    bf16 = pf.dtype == torch.bfloat16
    rc = lib.rxt_wide_smoother_bwd(
        d, mf.data_ptr(), pf.data_ptr(), ms.data_ptr(), ps.data_ptr(),
        cross.data_ptr(), t_len, bsz, _host_ptr(fh), _host_ptr(bh),
        _host_ptr(qh), _ptr(q_tile), int(bf16), stream)
    kernels.check(lib, rc, "fused_smoother wide backward kernel")
    LAUNCHES[launch_key("bwd", d, q_tile is not None, bf16)] += 1
    return ms, ps, cross


def _unpack(ms, ps, cross, d):
    """SoA streams -> contract layout, float32 (views of float32 streams
    except the covariance gather; bf16 streams upcast)."""
    t_len = ms.shape[0]
    means = ms.permute(0, 2, 1)                               # (T, B, d)
    covs = sym_unfold_t(ps, d)                                # (T, B, d, d)
    crossm = cross.float().reshape(t_len - 1, d, d, cross.shape[-1]).permute(
        0, 3, 1, 2)
    return means, covs, crossm


def fused_batched_smoother(m0, p0, xi, f, b, q, w, w_batch=None,
                           q_batch=None, moment_dtype=None):
    """Batch-axis smoother: m0 (B, d), p0 (B, d, d), xi (T, B, d); F, Q, W
    (d, d) and b (d,) shared, or W / Q per chain as ``w_batch`` /
    ``q_batch`` (B, d, d) (with ``w`` / ``q`` None beside them).  Returns
    smoothed means (T, B, d), covs (T, B, d, d), cross (T-1, B, d, d) =
    Cov(x_t, x_{t+1}), all float32; ``moment_dtype`` (float32 or bfloat16)
    is what the kernels store the covariances and the cross in between.
    CUDA tensors go through the kernels (d <= ``MAX_DIM``); CPU tensors
    through their plain versions."""
    d = xi.shape[-1]
    mf, pf = fused_forward(m0, p0, xi, f, b, q, w, w_batch, q_batch,
                           moment_dtype)
    ms, ps, cross = fused_backward(mf, pf, f, b, q, q_batch)
    return _unpack(ms, ps, cross, d)


def fused_batched_smoother_reference(m0, p0, xi, f, b, q, w, w_batch=None,
                                     q_batch=None, moment_dtype=None):
    """The plain version of ``fused_batched_smoother`` on any device (the
    card-side yardstick the kernels are held against)."""
    d = xi.shape[-1]
    mf, pf = fused_forward_reference(m0, p0, xi, f, b, q, w, w_batch,
                                     q_batch, moment_dtype)
    ms, ps, cross = fused_backward_reference(mf, pf, f, b, q, q_batch)
    return _unpack(ms, ps, cross, d)
