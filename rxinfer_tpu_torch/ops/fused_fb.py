"""Fused batched HMM forward-backward: the CUDA kernels and their plain
PyTorch versions (counterpart of ``rxinfer_tpu/ops/pallas_discrete.py``).

Exact alpha-beta over B independent categorical chains given expected
log-potentials (the inner solver of structured VMP on an HMM).  Convention:
``log_trans[b, i, j]`` = E[log p(s_{t+1} = i | s_t = j)] ([out, in]);
``xi_t[i, j]`` = q(s_{t+1} = i, s_t = j).  Alphas and betas are
max-normalised each step (gammas and xis are shift-invariant); the forward
shifts accumulate into logZ.

Kernels (``csrc/fused_fb.cu``):
  * ``fb_forward``  replaces ``_fb_fwd_kernel`` (pallas_discrete.py:48-84):
    one device kernel, the forward recursion;
  * ``fb_backward`` replaces ``_fb_bwd_kernel`` (pallas_discrete.py:87-167):
    the beta recursion, then the marginals in parallel over (time tile,
    chain), then, with more than one tile, xi_sum from the per-tile partials
    in tile order (``pick_tile`` sets the tile).
Each wrapper takes its plain version when its tensors lie on the CPU and
launches its kernels when they lie on a CUDA device (any other device
raises); there is no fallback from a kernel to a plain version.
``LAUNCHES`` counts wrapper calls that launched, one per call whatever the
number of device kernels.

``fused_fb_batched`` keeps the JAX wrapper's contract: log_prior (B, K),
log_trans (B, K, K), log_evidence (T, B, K) -> gammas (T, B, K), xi_sum
(B, K, K), logZ (B,) and, with ``per_step_xi=True``, xi_steps (T-1, B, K, K)
(empty at T = 1).  The kernels read and write these layouts directly.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

# Largest state count the CUDA kernels take.  A lane of the serial passes
# keeps a row (or column) of its chain's K x K table and the alpha/beta
# vector in registers, a thread of the marginal pass the whole table and the
# K x K xi partial; the kernels are instantiated for K = 1..8.  Larger K
# needs the table in shared memory (ROADMAP B2).
MAX_STATES = 8
# Steps of a time tile that the serial passes stage in shared memory
# (``kTileSteps`` in the source; the numbers do not depend on it).
STAGED_STEPS = 32

# The rule that picks the marginal pass's tile (``pick_tile``).
MARGINAL_WARPS_PER_SCHEDULER = 2   # fill the card this deep: B * tiles threads
SCHEDULERS_PER_SM = 4
MIN_TILE_STEPS = 4                 # a partial per tile costs K*K floats a chain

# wrapper calls that launched on CUDA tensors (the plain version on CPU
# tensors counts none)
LAUNCHES = {"fused_fb_fwd": 0, "fused_fb_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- plain PyTorch versions -------------------------------------------------------
#
# The step functions work on entry lists (K lists of tensors, or of anything
# with the same arithmetic), in the kernels' operation order, so the same
# code serves the plain versions and an exact operation count.  An entry may
# be a (B,) tensor (one step) or a (T, B) one (all steps at once: the table's
# (B,) entries broadcast).  ``beta_step`` alone works on (B, K) tensors: the
# plain beta recursion is its only caller, and ``backward_step`` counts the
# same operations.

def _lse(terms):
    """log-sum-exp: running maximum, then exp sums in index order."""
    m = terms[0]
    for t in terms[1:]:
        m = torch.maximum(m, t)
    s = torch.exp(terms[0] - m)
    for t in terms[1:]:
        s = s + torch.exp(t - m)
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


def forward_step(alpha, le_t, lt, first: bool):
    """Max-normalised alpha_t and its shift, from alpha_{t-1} (or the log
    prior at t = 0, where there is no transition)."""
    k = len(alpha)
    if first:
        a_new = [alpha[i] + le_t[i] for i in range(k)]
    else:
        a_new = [_lse([lt[i][j] + alpha[j] for j in range(k)]) + le_t[i]
                 for i in range(k)]
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
    ``_scores``, beta_t[j] = lse_i s[i][j], max-normalised over j."""
    k = log_trans.shape[-1]
    s = log_trans + le_next[..., None] + beta_next[..., None]
    b_raw = _lse([s[:, i] for i in range(k)])
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
    Same recurrence and operation order as the kernel."""
    t_len, _, k = log_evidence.shape
    lt = _entries(log_trans)
    alpha = [log_prior[:, i] for i in range(k)]
    cum = torch.zeros_like(log_prior[:, 0])
    alphas = torch.empty_like(log_evidence)
    for t in range(t_len):
        alpha, m = forward_step(alpha, [log_evidence[t, :, i] for i in range(k)],
                                lt, first=t == 0)
        cum = cum + m
        alphas[t] = torch.stack(alpha, dim=-1)
    m = _max(alpha)
    logz = cum + m + torch.log(_sum([torch.exp(a - m) for a in alpha]))
    return alphas, logz


# -- K5's marginal tiles --------------------------------------------------------------

def pick_tile(bsz: int, t_len: int, sm_count: int) -> int:
    """Steps per tile of K5's marginal pass at (B, T) on a card with
    ``sm_count`` SMs: T // n for the n tiles that let B * n threads fill
    every warp scheduler ``MARGINAL_WARPS_PER_SCHEDULER`` deep, but at least
    ``MIN_TILE_STEPS`` and at most T."""
    threads = sm_count * SCHEDULERS_PER_SM * 32 * MARGINAL_WARPS_PER_SCHEDULER
    wanted = -(-threads // max(bsz, 1))
    return max(1, min(t_len, max(MIN_TILE_STEPS, t_len // wanted)))


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


def fb_backward_reference(log_trans, log_evidence, alphas,
                          per_step_xi: bool = False, tile: int | None = None):
    """Plain backward pass in the kernels' order: the beta recursion step by
    step, then gammas (T, B, K) and the xis over all steps at once, and
    xi_sum (B, K, K) summed in tiles of ``tile`` steps (one tile when None)
    as the marginal and xi_sum passes sum it.  Returns gammas, xi_sum and,
    with ``per_step_xi``, xi_steps (T-1, B, K, K) (else None)."""
    t_len, _, k = log_evidence.shape
    betas = beta_pass_reference(log_trans, log_evidence)
    al = [alphas[..., i] for i in range(k)]
    be = [betas[..., i] for i in range(k)]
    gammas = torch.stack(_softmax([a + b for a, b in zip(al, be)]), dim=-1)
    s = _scores([b[1:] for b in be],
                [log_evidence[1:, :, i] for i in range(k)],
                _entries(log_trans))
    xi_steps = _stack_table(xi_from_scores([a[:-1] for a in al], s))
    xi_sum = _tile_xi_sum(xi_steps, t_len, tile or t_len)
    return gammas, xi_sum, xi_steps if per_step_xi else None


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

def _library():
    lib = kernels.load("fused_fb")
    if not getattr(lib, "_rxt_typed", False):
        p = ctypes.c_void_p
        i64 = ctypes.c_int64
        lib.rxt_fb_fwd.argtypes = [ctypes.c_int, p, p, p, p, p, i64, i64, p]
        lib.rxt_fb_fwd.restype = ctypes.c_int
        lib.rxt_fb_bwd.argtypes = [ctypes.c_int, ctypes.c_int, p, p, p, p, p,
                                   p, p, p, i64, i64, i64, i64, p]
        lib.rxt_fb_bwd.restype = ctypes.c_int
        lib.rxt_fb_staged_steps.restype = ctypes.c_int
        if lib.rxt_fb_staged_steps() != STAGED_STEPS:
            raise RuntimeError(
                "csrc/fused_fb.cu stages "
                f"{lib.rxt_fb_staged_steps()} steps a tile, the wrapper "
                f"expects {STAGED_STEPS}")
        lib._rxt_typed = True
    return lib


def _check_dims(t_len, k):
    if t_len < 1:
        raise ValueError("forward-backward needs at least one time step")
    if not 1 <= k <= MAX_STATES:
        raise NotImplementedError(
            f"{k} states: the CUDA forward-backward kernels keep each chain's "
            f"K x K table and xi accumulators in registers and are "
            f"instantiated for K = 1..{MAX_STATES}; larger K needs the table "
            "in shared memory, which is not written yet")


def fb_forward(log_prior, log_trans, log_evidence):
    """K4 wrapper: alphas (T, B, K) and logZ (B,)."""
    t_len, bsz, k = log_evidence.shape
    _check_dims(t_len, k)
    if log_evidence.device.type == "cpu":
        return fb_forward_reference(log_prior, log_trans, log_evidence)
    kernels.check_tensor("log_evidence", log_evidence, (t_len, bsz, k))
    kernels.check_tensor("log_prior", log_prior, (bsz, k))
    kernels.check_tensor("log_trans", log_trans, (bsz, k, k))
    alphas = torch.empty_like(log_evidence)
    logz = torch.empty((bsz,), dtype=torch.float32, device=log_evidence.device)
    if bsz == 0:
        return alphas, logz
    lib = _library()
    stream = torch.cuda.current_stream(log_evidence.device).cuda_stream
    rc = lib.rxt_fb_fwd(k, log_prior.data_ptr(), log_trans.data_ptr(),
                        log_evidence.data_ptr(), alphas.data_ptr(),
                        logz.data_ptr(), t_len, bsz, stream)
    kernels.check(lib, rc, "fused_fb forward kernel")
    LAUNCHES["fused_fb_fwd"] += 1
    return alphas, logz


def device_tile(bsz: int, t_len: int, device) -> int:
    """The marginal tile ``fb_backward`` takes at (B, T) on ``device``."""
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    return pick_tile(bsz, t_len, sm_count)


def fb_backward(log_trans, log_evidence, alphas, per_step_xi: bool = False):
    """K5 wrapper: gammas (T, B, K), xi_sum (B, K, K) and, with
    ``per_step_xi``, xi_steps (T-1, B, K, K) (else None)."""
    t_len, bsz, k = log_evidence.shape
    _check_dims(t_len, k)
    if log_evidence.device.type == "cpu":
        return fb_backward_reference(log_trans, log_evidence, alphas,
                                     per_step_xi)
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
    tile = device_tile(bsz, t_len, dev)
    tiles = -(-t_len // tile)
    # scratch: held until the kernels are queued; the allocator then hands
    # the memory out again only to work queued later on the same stream
    betas = torch.empty_like(alphas)
    part = (torch.empty((tiles, bsz, k, k), dtype=torch.float32, device=dev)
            if tiles > 1 else xi_sum)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.rxt_fb_bwd(k, int(per_step_xi), log_trans.data_ptr(),
                        log_evidence.data_ptr(), alphas.data_ptr(),
                        betas.data_ptr(), gammas.data_ptr(), part.data_ptr(),
                        xi_sum.data_ptr(),
                        xi_steps.data_ptr() if per_step_xi else None,
                        t_len, bsz, tile, tiles, stream)
    kernels.check(lib, rc, "fused_fb backward kernels")
    LAUNCHES["fused_fb_bwd"] += 1
    return gammas, xi_sum, xi_steps


def fused_fb_batched(log_prior, log_trans, log_evidence,
                     per_step_xi: bool = False):
    """Batch-axis forward-backward: log_prior (B, K), log_trans (B, K, K)
    [out, in], log_evidence (T, B, K).  Returns gammas (T, B, K), xi_sum
    (B, K, K), logZ (B,) and, with ``per_step_xi=True``, xi_steps
    (T-1, B, K, K).  CUDA tensors go through the two kernels; CPU tensors
    through their plain versions."""
    alphas, logz = fb_forward(log_prior, log_trans, log_evidence)
    gammas, xi_sum, xi_steps = fb_backward(log_trans, log_evidence, alphas,
                                           per_step_xi)
    if per_step_xi:
        return gammas, xi_sum, logz, xi_steps
    return gammas, xi_sum, logz
