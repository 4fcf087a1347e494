"""Fused batched HMM forward-backward: the CUDA kernels and their plain
PyTorch versions (counterpart of ``rxinfer_tpu/ops/pallas_discrete.py``).

Exact alpha-beta over B independent categorical chains given expected
log-potentials (the inner solver of structured VMP on an HMM).  Convention:
``log_trans[b, i, j]`` = E[log p(s_{t+1} = i | s_t = j)] ([out, in]);
``xi_t[i, j]`` = q(s_{t+1} = i, s_t = j).  Alphas and betas are
max-normalised each step (gammas and xis are shift-invariant); the forward
shifts accumulate into logZ.

Kernels (``csrc/fused_fb.cu`` for K <= ``REG_MAX_STATES``,
``csrc/fused_fb_wide.cu`` above):
  * ``fb_forward``  replaces ``_fb_fwd_kernel`` (pallas_discrete.py:48-84):
    one device kernel, the forward recursion;
  * ``fb_backward`` replaces ``_fb_bwd_kernel`` (pallas_discrete.py:87-167):
    the beta recursion, then the marginals in parallel over (time tile,
    chain), then, with more than one tile, xi_sum from the per-tile partials
    in tile order (``pick_tile`` sets the tile; ``pick_tile_wide`` for the
    wide kernels, whose marginal pass runs a half-warp a tile and chain at
    K <= 16).
The register kernels keep a chain's states on up to 8 lanes; the wide ones
run a chain on a warp and take any K the tensors' memory allows, as the JAX
kernels do.  Above 8 states ``fused_fb_batched`` launches the wide kernels
as two calls: ``fb_serial_wide`` runs the forward and the beta recursion
side by side in one launch (the beta recursion reads no alphas), then
``fb_marginals_wide`` the marginals and xi_sum; ``fb_forward`` and
``fb_backward`` there launch the same kernels, one recursion each.  Each
wrapper takes its plain version when its tensors lie on the CPU and
launches its kernels when they lie on a CUDA device (any other device
raises); there is no fallback from a kernel to a plain version.
``LAUNCHES`` counts wrapper calls that launched, one per call whatever the
number of device kernels, under ``fused_fb_{fwd,bwd}`` for the register
kernels, ``fused_fb_{fwd,bwd}_wide`` for ``fb_forward`` / ``fb_backward``
on the wide ones and ``fused_fb_{serial,marg}_wide`` for
``fb_serial_wide`` / ``fb_marginals_wide``.

From 9 to ``HALF_WARP_STATES`` (16) states the wide kernels split a step
over the two half-warps, and the plain versions take their order there:
each log-sum-exp sums the exps of terms 0..7 and of terms 8..K-1 apart and
adds the two; the scores are logA[i][j] + (le_{t+1}[i] + beta_{t+1}[i]);
gamma's sum and the sum of xi's row sums are butterflies over 16 slots
(``_tree_sum16``), a row sum that of its four column quads.  Other K keep
index order.

``fused_fb_batched`` keeps the JAX wrapper's contract: log_prior (B, K),
log_trans (B, K, K), log_evidence (T, B, K) -> gammas (T, B, K), xi_sum
(B, K, K), logZ (B,) and, with ``per_step_xi=True``, xi_steps (T-1, B, K, K)
(empty at T = 1).  The kernels read and write these layouts directly.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

# Largest state count of the register kernels (``csrc/fused_fb.cu``).  A
# lane of their serial passes keeps a row (or column) of its chain's K x K
# table and the alpha/beta vector in registers, a thread of the marginal
# pass the whole table and the K x K xi partial; they are instantiated for
# K = 1..8.  Larger K launches the wide kernels (``csrc/fused_fb_wide.cu``).
REG_MAX_STATES = 8
# Steps of a time tile that the serial passes stage in shared memory
# (``kTileSteps`` in the source; the numbers do not depend on it).
STAGED_STEPS = 32

# The wide kernels' half-warp design runs K in (REG_MAX_STATES,
# HALF_WARP_STATES]; the low half-warp takes HALF_TERMS terms of a sum.
HALF_WARP_STATES = 16
HALF_TERMS = 8

# The rule that picks the marginal pass's tile (``pick_tile``).
MARGINAL_WARPS_PER_SCHEDULER = 2   # fill the card this deep: B * tiles threads
SCHEDULERS_PER_SM = 4
MIN_TILE_STEPS = 4                 # a partial per tile costs K*K floats a chain
# Warps an SM holds of the wide marginal kernel at K <= 16 (its launch
# bounds, ``kMargBlocksPerSM`` CTAs of four warps); ``pick_tile_wide`` puts
# all (tile, chain) half-warps on the card in one wave of this many.
MARGINAL_WARPS_PER_SM = 20

# wrapper calls that launched on CUDA tensors (the plain version on CPU
# tensors counts none)
LAUNCHES = {"fused_fb_fwd": 0, "fused_fb_bwd": 0, "fused_fb_fwd_wide": 0,
            "fused_fb_bwd_wide": 0, "fused_fb_serial_wide": 0,
            "fused_fb_marg_wide": 0}


def launch_key(direction: str, k: int) -> str:
    """The ``LAUNCHES`` key of a ``direction`` wrapper call at K states:
    "fwd" / "bwd" (``fb_forward`` / ``fb_backward``), or, above eight
    states, "serial" / "marg" (``fb_serial_wide`` / ``fb_marginals_wide``,
    the two calls of ``fused_fb_batched``)."""
    wide = k > REG_MAX_STATES
    if direction in ("serial", "marg") and not wide:
        raise ValueError(f"fused_fb_{direction}_wide runs K > "
                         f"{REG_MAX_STATES} states only, not K={k}")
    return f"fused_fb_{direction}" + ("_wide" if wide else "")


def halves(k: int) -> bool:
    """Whether K states run the wide kernels' half-warp design, and the
    plain versions its order of sums."""
    return REG_MAX_STATES < k <= HALF_WARP_STATES


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- plain PyTorch versions -------------------------------------------------------
#
# The step functions work on entry lists (K lists of tensors, or of anything
# with the same arithmetic), in the kernels' operation order, so the same
# code serves the plain versions and an exact operation count.  An entry may
# be a (B,) tensor (one step) or a (T, B) one (all steps at once: the table's
# (B,) entries broadcast).  The plain versions themselves run every state
# at once on (B, K) tensors (``alpha_step``, ``beta_step``, ``_softmax_last``,
# ``_xi_from_logits``), each entry in the entry lists' order, so that their
# operation count does not grow with K^2 per step; ``forward_step`` and
# ``backward_step`` count the same operations.

def _exp_sum(terms, m):
    s = torch.exp(terms[0] - m)
    for t in terms[1:]:
        s = s + torch.exp(t - m)
    return s


def _lse(terms, split: bool = False):
    """log-sum-exp: running maximum, then exp sums in index order; with
    ``split`` the sum of terms 0..7 plus that of the rest (the half-warps)."""
    m = terms[0]
    for t in terms[1:]:
        m = torch.maximum(m, t)
    if split:
        s = _exp_sum(terms[:HALF_TERMS], m) + _exp_sum(terms[HALF_TERMS:], m)
    else:
        s = _exp_sum(terms, m)
    return m + torch.log(s)


def _max(xs):
    m = xs[0]
    for x in xs[1:]:
        m = torch.maximum(m, x)
    return m


def _sum(xs):
    s = xs[0]
    for x in xs[1:]:
        s = s + x
    return s


def _softmax(logits):
    m = _max(logits)
    e = [torch.exp(x - m) for x in logits]
    total = _sum(e)
    return [x / total for x in e]


def alpha_step(alpha, le_t, log_trans, first: bool):
    """Max-normalised alpha_t (B, K) and its shift (B,) from alpha_{t-1}
    (B, K) (or the log prior at t = 0); every state at once, each entry in
    ``forward_step``'s order."""
    k = log_trans.shape[-1]
    if first:
        a_new = alpha + le_t
    else:
        a_new = _lse([log_trans[:, :, j] + alpha[:, j, None]
                      for j in range(k)], halves(k)) + le_t
    m = _max([a_new[:, i] for i in range(k)])
    return a_new - m[:, None], m


def _tree_sum16(x):
    """Sum over the last axis (at most 16 long) as the half-warp butterfly
    forms it: zeros pad it to 16 slots, then v[i] + v[i + o] for o = 8, 4,
    2, 1."""
    v = torch.nn.functional.pad(x, (0, HALF_WARP_STATES - x.shape[-1]))
    o = HALF_WARP_STATES // 2
    while o:
        v = v[..., :o] + v[..., o:2 * o]
        o //= 2
    return v[..., 0]


def _softmax_last(logits):
    """``_softmax`` over the last axis of a tensor, entry by entry in its
    order (the maximum is exact in any order); at ``halves(k)`` the sum is
    ``_tree_sum16``."""
    k = logits.shape[-1]
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    if halves(k):
        return e / _tree_sum16(e)[..., None]
    return e / _sum([e[..., i] for i in range(k)])[..., None]


def _xi_from_logits(x):
    """``xi_from_scores`` on x[..., i, j] = alpha_t[j] + s[i][j]: exps
    against the maximum over (i, j), divided by the row sums (each in j
    order) summed in row order.  At ``halves(k)`` in the half-warp order: on
    the block padded to 16 x 16 with zeros, a row's sum is (q0 + q1) + (q2 +
    q3) over its column quads (each summed in order), and the total
    (T0 + T1) + (T2 + T3) with Tq = (R_q + R_{4+q}) + (R_{8+q} + R_{12+q})."""
    k = x.shape[-1]
    e = torch.exp(x - x.amax((-2, -1), keepdim=True))
    if halves(k):
        pad = HALF_WARP_STATES - k
        quads = torch.nn.functional.pad(e, (0, pad, 0, pad)).unflatten(
            -1, (4, 4))                              # (..., row, c, k)
        p = ((quads[..., 0] + quads[..., 1]) + quads[..., 2]) + quads[..., 3]
        rows = (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])
        rq = rows.unflatten(-1, (4, 4))              # [m, q]: row 4m + q
        tq = (rq[..., 0, :] + rq[..., 1, :]) + (rq[..., 2, :] + rq[..., 3, :])
        total = (tq[..., 0] + tq[..., 1]) + (tq[..., 2] + tq[..., 3])
        return e / total[..., None, None]
    rows = _sum([e[..., j] for j in range(k)])
    return e / _sum([rows[..., i] for i in range(k)])[..., None, None]


def forward_step(alpha, le_t, lt, first: bool):
    """Max-normalised alpha_t and its shift, from alpha_{t-1} (or the log
    prior at t = 0, where there is no transition)."""
    k = len(alpha)
    if first:
        a_new = [alpha[i] + le_t[i] for i in range(k)]
    else:
        a_new = [_lse([lt[i][j] + alpha[j] for j in range(k)], halves(k))
                 + le_t[i] for i in range(k)]
    m = _max(a_new)
    return [a - m for a in a_new], m


def _scores(beta_next, le_next, lt):
    """s[i][j] = logA[i][j] + le_{t+1}[i] + beta_{t+1}[i]."""
    k = len(beta_next)
    return [[lt[i][j] + le_next[i] + beta_next[i] for j in range(k)]
            for i in range(k)]


def _beta_from_scores(s):
    k = len(s)
    b_raw = [_lse([s[i][j] for i in range(k)]) for j in range(k)]
    mb = _max(b_raw)
    return [b - mb for b in b_raw]


def beta_step(beta_next, le_next, log_trans):
    """Max-normalised beta_t (B, K) from beta_{t+1} and le_{t+1} (B, K);
    t < T-1.  Every state at once (a tenth of the launches of the entry
    lists at K = 8), each entry in the kernel's order: s[i][j] as in
    ``_scores`` (at ``halves(k)``: logA[i][j] + (le[i] + beta[i])),
    beta_t[j] = lse_i s[i][j], max-normalised over j."""
    k = log_trans.shape[-1]
    if halves(k):
        s = log_trans + (le_next + beta_next)[..., None]
    else:
        s = log_trans + le_next[..., None] + beta_next[..., None]
    b_raw = _lse([s[:, i] for i in range(k)], halves(k))
    return b_raw - _max([b_raw[:, j] for j in range(k)])[:, None]


def xi_from_scores(alpha, s):
    """xi_t[i][j] = softmax_ij(alpha_t[j] + s[i][j]): maximum over (i, j) in
    row-major order, divided by the sum of the row sums."""
    k = len(alpha)
    x_log = [[alpha[j] + s[i][j] for j in range(k)] for i in range(k)]
    mx = _max([x for row in x_log for x in row])
    x_exp = [[torch.exp(x - mx) for x in row] for row in x_log]
    x_sum = _sum([_sum(row) for row in x_exp])
    return [[e / x_sum for e in row] for row in x_exp]


def backward_step(alpha, beta, le_next, lt):
    """gamma_t, max-normalised beta_t and xi_t from alpha_t and the step
    after it (beta_{t+1}, le_{t+1}); t < T-1.  The algorithm's operations of
    one backward chain-step, each once."""
    s = _scores(beta, le_next, lt)
    b_new = _beta_from_scores(s)
    gamma = _softmax([a + b for a, b in zip(alpha, b_new)])
    return gamma, b_new, xi_from_scores(alpha, s)


def _entries(lt):
    k = lt.shape[-1]
    return [[lt[:, i, j] for j in range(k)] for i in range(k)]


def _stack_table(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def fb_forward_reference(log_prior, log_trans, log_evidence):
    """Plain forward pass: alphas (T, B, K) max-normalised and logZ (B,).
    Same recurrence and operation order as the kernels."""
    t_len, _, k = log_evidence.shape
    alpha = log_prior
    cum = torch.zeros_like(log_prior[:, 0])
    alphas = torch.empty_like(log_evidence)
    for t in range(t_len):
        alpha, m = alpha_step(alpha, log_evidence[t], log_trans,
                              first=t == 0)
        cum = cum + m
        alphas[t] = alpha
    last = [alpha[:, i] for i in range(k)]
    m = _max(last)
    logz = cum + m + torch.log(_sum([torch.exp(a - m) for a in last]))
    return alphas, logz


# -- K5's marginal tiles --------------------------------------------------------------

def _tile_for(slots: int, bsz: int, t_len: int) -> int:
    """T // n for the n tiles that give B * n (tile, chain) pairs ``slots``
    of them, but at least ``MIN_TILE_STEPS`` and at most T."""
    wanted = -(-slots // max(bsz, 1))
    return max(1, min(t_len, max(MIN_TILE_STEPS, t_len // wanted)))


def pick_tile(bsz: int, t_len: int, sm_count: int) -> int:
    """Steps per tile of K5's marginal pass at (B, T) on a card with
    ``sm_count`` SMs: T // n for the n tiles that let B * n threads fill
    every warp scheduler ``MARGINAL_WARPS_PER_SCHEDULER`` deep, but at least
    ``MIN_TILE_STEPS`` and at most T."""
    return _tile_for(
        sm_count * SCHEDULERS_PER_SM * 32 * MARGINAL_WARPS_PER_SCHEDULER,
        bsz, t_len)


def pick_tile_wide(bsz: int, t_len: int, sm_count: int) -> int:
    """Steps per tile of the wide kernels' marginal pass, which runs a
    half-warp a (tile, chain) (at K <= 16; a warp above): the fewest steps
    a tile, ceil(T / n), for the most tiles n whose B * n half-warps the
    card holds at once (``MARGINAL_WARPS_PER_SM`` warps an SM, one wave),
    but at least ``MIN_TILE_STEPS`` and at most T."""
    units = sm_count * MARGINAL_WARPS_PER_SM * 2
    n = max(1, units // max(bsz, 1))
    return max(1, min(t_len, max(MIN_TILE_STEPS, -(-t_len // n))))


def _tile_xi_sum(xi_steps, t_len: int, tile: int):
    """xi_sum as the kernels form it: each tile of ``tile`` steps sums its
    xi_t in step order from zero, then the tile partials are summed in tile
    order from zero.  Steps past T-2 (no xi) add nothing."""
    bsz, k = xi_steps.shape[1], xi_steps.shape[-1]
    tiles = -(-t_len // tile)
    padded = xi_steps.new_zeros((tiles * tile, bsz, k, k))
    padded[:t_len - 1] = xi_steps
    padded = padded.view(tiles, tile, bsz, k, k)
    parts = padded.new_zeros((tiles, bsz, k, k))
    for r in range(tile):               # every tile at once, in step order
        parts = parts + padded[:, r]
    total = padded.new_zeros((bsz, k, k))
    for s in range(tiles):
        total = total + parts[s]
    return total


def beta_pass_reference(log_trans, log_evidence):
    """Plain beta recursion: max-normalised betas (T, B, K), beta_{T-1} = 0,
    step by step as the kernel runs it."""
    betas = torch.zeros_like(log_evidence)
    for t in range(log_evidence.shape[0] - 2, -1, -1):
        betas[t] = beta_step(betas[t + 1], log_evidence[t + 1], log_trans)
    return betas


def marginals_reference(log_trans, log_evidence, alphas, betas,
                        per_step_xi: bool = False, tile: int | None = None):
    """Plain marginal pass in the kernels' order: gammas (T, B, K) and the
    xis over all steps at once from alphas and betas, and xi_sum (B, K, K)
    summed in tiles of ``tile`` steps (one tile when None) as the marginal
    and xi_sum passes sum it.  Returns gammas, xi_sum and, with
    ``per_step_xi``, xi_steps (T-1, B, K, K) (else None)."""
    t_len, _, k = log_evidence.shape
    gammas = _softmax_last(alphas + betas)
    # x[t, b, i, j] = alpha_t[j] + ((logA[i][j] + le_{t+1}[i]) + beta_{t+1}[i])
    # (at halves(k): alpha_t[j] + (logA[i][j] + (le_{t+1}[i] + beta_{t+1}[i])))
    if halves(k):
        scores = log_trans + (log_evidence[1:] + betas[1:])[..., None]
    else:
        scores = (log_trans + log_evidence[1:, ..., None]
                  + betas[1:, ..., None])
    xi_steps = _xi_from_logits(alphas[:-1, :, None, :] + scores)
    xi_sum = _tile_xi_sum(xi_steps, t_len, tile or t_len)
    return gammas, xi_sum, xi_steps if per_step_xi else None


def fb_backward_reference(log_trans, log_evidence, alphas,
                          per_step_xi: bool = False, tile: int | None = None):
    """Plain backward pass in the kernels' order: the beta recursion step by
    step, then ``marginals_reference``.  Returns gammas, xi_sum and, with
    ``per_step_xi``, xi_steps (T-1, B, K, K) (else None)."""
    betas = beta_pass_reference(log_trans, log_evidence)
    return marginals_reference(log_trans, log_evidence, alphas, betas,
                               per_step_xi, tile)


def _fb_backward_stepwise(log_trans, log_evidence, alphas,
                          per_step_xi: bool = False):
    """The backward pass as one recursion, gamma and xi inside each step and
    xi_sum accumulated from t = T-2 down (the design before the marginals
    moved into their own pass).  Kept as a yardstick for the tests."""
    t_len, bsz, k = log_evidence.shape
    lt = _entries(log_trans)
    gammas = torch.empty_like(alphas)
    xi_steps = (alphas.new_empty((t_len - 1, bsz, k, k)) if per_step_xi
                else None)
    acc = [[torch.zeros_like(alphas[0, :, 0]) for _ in range(k)]
           for _ in range(k)]
    alpha = [alphas[t_len - 1, :, i] for i in range(k)]
    gammas[t_len - 1] = torch.stack(_softmax(alpha), dim=-1)
    beta = [torch.zeros_like(a) for a in alpha]
    for t in range(t_len - 2, -1, -1):
        alpha = [alphas[t, :, i] for i in range(k)]
        le_next = [log_evidence[t + 1, :, i] for i in range(k)]
        gamma, beta, xi = backward_step(alpha, beta, le_next, lt)
        gammas[t] = torch.stack(gamma, dim=-1)
        acc = [[a + x for a, x in zip(ra, rx)] for ra, rx in zip(acc, xi)]
        if xi_steps is not None:
            xi_steps[t] = _stack_table(xi)
    return gammas, _stack_table(acc), xi_steps


# -- kernel launches ----------------------------------------------------------------

def _library(wide: bool):
    lib = kernels.load("fused_fb_wide" if wide else "fused_fb")
    if not getattr(lib, "_rxt_typed", False):
        p = ctypes.c_void_p
        i64 = ctypes.c_int64
        ci = ctypes.c_int
        if wide:
            pi = ctypes.POINTER(ci)
            lib.rxt_fb_wide_serial.argtypes = [ci, ci, p, p, p, p, p, p, i64,
                                               i64, p]
            lib.rxt_fb_wide_marg.argtypes = [ci, ci, p, p, p, p, p, p, p, p,
                                             i64, i64, i64, i64, p]
            lib.rxt_fb_wide_serial_plan.argtypes = [ci, pi, pi]
            lib.rxt_fb_wide_marg_blocks_per_sm.argtypes = []
            for fn in (lib.rxt_fb_wide_serial, lib.rxt_fb_wide_marg,
                       lib.rxt_fb_wide_serial_plan,
                       lib.rxt_fb_wide_marg_warps_per_sm,
                       lib.rxt_fb_wide_marg_blocks_per_sm):
                fn.restype = ci
            if lib.rxt_fb_wide_marg_warps_per_sm() != MARGINAL_WARPS_PER_SM:
                raise RuntimeError(
                    "csrc/fused_fb_wide.cu bounds its marginal kernel to "
                    f"{lib.rxt_fb_wide_marg_warps_per_sm()} warps an SM, "
                    f"the tile rule expects {MARGINAL_WARPS_PER_SM}")
        else:
            lib.rxt_fb_fwd.argtypes = [ci, p, p, p, p, p, i64, i64, p]
            lib.rxt_fb_fwd.restype = ci
            lib.rxt_fb_bwd.argtypes = [ci, ci, p, p, p, p, p, p, p, p,
                                       i64, i64, i64, i64, p]
            lib.rxt_fb_bwd.restype = ci
            lib.rxt_fb_staged_steps.restype = ci
            if lib.rxt_fb_staged_steps() != STAGED_STEPS:
                raise RuntimeError(
                    "csrc/fused_fb.cu stages "
                    f"{lib.rxt_fb_staged_steps()} steps a tile, the wrapper "
                    f"expects {STAGED_STEPS}")
        lib._rxt_typed = True
    return lib


def wide_serial_plan(k: int, device) -> dict:
    """How the wide serial kernel (both recursions) runs at K states on
    ``device``: the steps of a staged evidence tile and where the K x K
    table sits (registers to K = 32; above, shared memory while it fits
    beside the ring, else device memory)."""
    lib = _library(wide=True)
    with torch.cuda.device(device):
        ts, table = ctypes.c_int(), ctypes.c_int()
        rc = lib.rxt_fb_wide_serial_plan(k, ctypes.byref(ts),
                                         ctypes.byref(table))
    kernels.check(lib, rc, f"fused_fb_wide plan at K={k}")
    return {"staged_steps": ts.value,
            "table": "shared" if table.value else
            ("device" if k > 32 else "registers")}


def wide_marginal_warps_per_sm(device) -> int:
    """Warps an SM of ``device`` holds of the K <= 16 marginal kernel with
    the per-step xi, as the CUDA occupancy calculator reads its registers
    (``pick_tile_wide`` assumes ``MARGINAL_WARPS_PER_SM``)."""
    lib = _library(wide=True)
    with torch.cuda.device(device):
        return 4 * lib.rxt_fb_wide_marg_blocks_per_sm()


def _check_dims(t_len, k):
    if t_len < 1:
        raise ValueError("forward-backward needs at least one time step")
    if k < 1:
        raise ValueError("forward-backward needs at least one state")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _serial_cuda(log_prior, log_trans, log_evidence, forward: bool,
                 beta: bool):
    """The wide serial kernel on CUDA tensors: alphas (T, B, K) and logZ
    (B,) with ``forward``, betas (T, B, K) with ``beta`` (None otherwise),
    one launch.  Counts nothing."""
    t_len, bsz, k = log_evidence.shape
    dev = log_evidence.device
    kernels.check_tensor("log_evidence", log_evidence, (t_len, bsz, k))
    kernels.check_tensor("log_trans", log_trans, (bsz, k, k))
    alphas = logz = betas = None
    if forward:
        kernels.check_tensor("log_prior", log_prior, (bsz, k))
        alphas = torch.empty_like(log_evidence)
        logz = torch.empty((bsz,), dtype=torch.float32, device=dev)
    if beta:
        betas = torch.empty_like(log_evidence)
    if bsz == 0:
        return alphas, logz, betas
    lib = _library(wide=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.rxt_fb_wide_serial(k, int(forward) + 2 * int(beta),
                                _ptr(log_prior), log_trans.data_ptr(),
                                log_evidence.data_ptr(), _ptr(alphas),
                                _ptr(logz), _ptr(betas), t_len, bsz, stream)
    kernels.check(lib, rc, "fused_fb_wide serial kernel")
    return alphas, logz, betas


def _marginals_cuda(log_trans, log_evidence, alphas, betas,
                    per_step_xi: bool):
    """The wide marginal kernel (and, with more than one tile, xi_sum's) on
    CUDA tensors.  Counts nothing."""
    t_len, bsz, k = log_evidence.shape
    dev = log_evidence.device
    kernels.check_tensor("log_evidence", log_evidence, (t_len, bsz, k))
    kernels.check_tensor("log_trans", log_trans, (bsz, k, k))
    kernels.check_tensor("alphas", alphas, (t_len, bsz, k))
    kernels.check_tensor("betas", betas, (t_len, bsz, k))
    gammas = torch.empty_like(alphas)
    xi_sum = torch.empty((bsz, k, k), dtype=torch.float32, device=dev)
    xi_steps = (torch.empty((t_len - 1, bsz, k, k), dtype=torch.float32,
                            device=dev) if per_step_xi else None)
    if bsz == 0:
        return gammas, xi_sum, xi_steps
    tile = device_tile(bsz, t_len, dev, k)
    tiles = -(-t_len // tile)
    # scratch: held until the kernels are queued; the allocator then hands
    # the memory out again only to work queued later on the same stream
    part = (torch.empty((tiles, bsz, k, k), dtype=torch.float32, device=dev)
            if tiles > 1 else xi_sum)
    lib = _library(wide=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.rxt_fb_wide_marg(k, int(per_step_xi), log_trans.data_ptr(),
                              log_evidence.data_ptr(), alphas.data_ptr(),
                              betas.data_ptr(), gammas.data_ptr(),
                              part.data_ptr(), xi_sum.data_ptr(),
                              _ptr(xi_steps), t_len, bsz, tile, tiles, stream)
    kernels.check(lib, rc, "fused_fb_wide marginal kernels")
    return gammas, xi_sum, xi_steps


def fb_forward(log_prior, log_trans, log_evidence):
    """K4 wrapper: alphas (T, B, K) and logZ (B,)."""
    t_len, bsz, k = log_evidence.shape
    _check_dims(t_len, k)
    if log_evidence.device.type == "cpu":
        return fb_forward_reference(log_prior, log_trans, log_evidence)
    if k > REG_MAX_STATES:
        alphas, logz, _ = _serial_cuda(log_prior, log_trans, log_evidence,
                                       forward=True, beta=False)
        if bsz:
            LAUNCHES[launch_key("fwd", k)] += 1
        return alphas, logz
    kernels.check_tensor("log_evidence", log_evidence, (t_len, bsz, k))
    kernels.check_tensor("log_prior", log_prior, (bsz, k))
    kernels.check_tensor("log_trans", log_trans, (bsz, k, k))
    alphas = torch.empty_like(log_evidence)
    logz = torch.empty((bsz,), dtype=torch.float32, device=log_evidence.device)
    if bsz == 0:
        return alphas, logz
    lib = _library(wide=False)
    stream = torch.cuda.current_stream(log_evidence.device).cuda_stream
    rc = lib.rxt_fb_fwd(k, log_prior.data_ptr(), log_trans.data_ptr(),
                        log_evidence.data_ptr(), alphas.data_ptr(),
                        logz.data_ptr(), t_len, bsz, stream)
    kernels.check(lib, rc, "fused_fb forward kernel")
    LAUNCHES[launch_key("fwd", k)] += 1
    return alphas, logz


def device_tile(bsz: int, t_len: int, device, k: int) -> int:
    """The marginal tile ``fb_backward`` takes at (B, T, K) on ``device``."""
    rule = pick_tile_wide if k > REG_MAX_STATES else pick_tile
    return rule(bsz, t_len, kernels.sm_count(device))


def fb_backward(log_trans, log_evidence, alphas, per_step_xi: bool = False):
    """K5 wrapper: gammas (T, B, K), xi_sum (B, K, K) and, with
    ``per_step_xi``, xi_steps (T-1, B, K, K) (else None)."""
    t_len, bsz, k = log_evidence.shape
    _check_dims(t_len, k)
    if log_evidence.device.type == "cpu":
        return fb_backward_reference(log_trans, log_evidence, alphas,
                                     per_step_xi)
    if k > REG_MAX_STATES:
        _, _, betas = _serial_cuda(None, log_trans, log_evidence,
                                   forward=False, beta=True)
        out = _marginals_cuda(log_trans, log_evidence, alphas, betas,
                              per_step_xi)
        if bsz:
            LAUNCHES[launch_key("bwd", k)] += 1
        return out
    kernels.check_tensor("log_evidence", log_evidence, (t_len, bsz, k))
    kernels.check_tensor("log_trans", log_trans, (bsz, k, k))
    kernels.check_tensor("alphas", alphas, (t_len, bsz, k))
    dev = log_evidence.device
    gammas = torch.empty_like(alphas)
    xi_sum = torch.empty((bsz, k, k), dtype=torch.float32, device=dev)
    xi_steps = (torch.empty((t_len - 1, bsz, k, k), dtype=torch.float32,
                            device=dev) if per_step_xi else None)
    if bsz == 0:
        return gammas, xi_sum, xi_steps
    tile = device_tile(bsz, t_len, dev, k)
    tiles = -(-t_len // tile)
    # scratch: held until the kernels are queued; the allocator then hands
    # the memory out again only to work queued later on the same stream
    betas = torch.empty_like(alphas)
    part = (torch.empty((tiles, bsz, k, k), dtype=torch.float32, device=dev)
            if tiles > 1 else xi_sum)
    lib = _library(wide=False)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.rxt_fb_bwd(k, int(per_step_xi), log_trans.data_ptr(),
                        log_evidence.data_ptr(), alphas.data_ptr(),
                        betas.data_ptr(), gammas.data_ptr(), part.data_ptr(),
                        xi_sum.data_ptr(), _ptr(xi_steps), t_len, bsz, tile,
                        tiles, stream)
    kernels.check(lib, rc, "fused_fb backward kernels")
    LAUNCHES[launch_key("bwd", k)] += 1
    return gammas, xi_sum, xi_steps


def _check_wide(k):
    if k <= REG_MAX_STATES:
        raise ValueError(f"the wide forward-backward takes K > "
                         f"{REG_MAX_STATES} states, not K={k}")


def fb_serial_wide(log_prior, log_trans, log_evidence):
    """The forward recursion (K4) and the beta recursion (K5's first pass)
    for K > 8 states in one launch, a warp of each a chain side by side:
    alphas (T, B, K), logZ (B,) and betas (T, B, K)."""
    t_len, bsz, k = log_evidence.shape
    _check_dims(t_len, k)
    _check_wide(k)
    if log_evidence.device.type == "cpu":
        alphas, logz = fb_forward_reference(log_prior, log_trans,
                                            log_evidence)
        return alphas, logz, beta_pass_reference(log_trans, log_evidence)
    out = _serial_cuda(log_prior, log_trans, log_evidence, True, True)
    if bsz:
        LAUNCHES[launch_key("serial", k)] += 1
    return out


def fb_marginals_wide(log_trans, log_evidence, alphas, betas,
                      per_step_xi: bool = False):
    """K5's marginals for K > 8 states from alphas and betas: gammas
    (T, B, K), xi_sum (B, K, K) and, with ``per_step_xi``, xi_steps
    (T-1, B, K, K) (else None); the marginal kernel, then xi_sum's when the
    tile rule gives more than one tile."""
    t_len, bsz, k = log_evidence.shape
    _check_dims(t_len, k)
    _check_wide(k)
    if log_evidence.device.type == "cpu":
        return marginals_reference(log_trans, log_evidence, alphas, betas,
                                   per_step_xi)
    out = _marginals_cuda(log_trans, log_evidence, alphas, betas,
                          per_step_xi)
    if bsz:
        LAUNCHES[launch_key("marg", k)] += 1
    return out


def fused_fb_batched(log_prior, log_trans, log_evidence,
                     per_step_xi: bool = False):
    """Batch-axis forward-backward: log_prior (B, K), log_trans (B, K, K)
    [out, in], log_evidence (T, B, K).  Returns gammas (T, B, K), xi_sum
    (B, K, K), logZ (B,) and, with ``per_step_xi=True``, xi_steps
    (T-1, B, K, K).  CUDA tensors go through the kernels (K > 8: the serial
    launch, then the marginals); CPU tensors through their plain
    versions."""
    k = log_evidence.shape[-1]
    if k > REG_MAX_STATES:
        alphas, logz, betas = fb_serial_wide(log_prior, log_trans,
                                             log_evidence)
        gammas, xi_sum, xi_steps = fb_marginals_wide(
            log_trans, log_evidence, alphas, betas, per_step_xi)
    else:
        alphas, logz = fb_forward(log_prior, log_trans, log_evidence)
        gammas, xi_sum, xi_steps = fb_backward(log_trans, log_evidence,
                                               alphas, per_step_xi)
    if per_step_xi:
        return gammas, xi_sum, logz, xi_steps
    return gammas, xi_sum, logz
