"""Fused batched HMM forward-backward: the CUDA kernel pair and its plain
PyTorch version (counterpart of ``rxinfer_tpu/ops/pallas_discrete.py``).

Exact alpha-beta over B independent categorical chains given expected
log-potentials (the inner solver of structured VMP on an HMM).  Convention:
``log_trans[b, i, j]`` = E[log p(s_{t+1} = i | s_t = j)] ([out, in]);
``xi_t[i, j]`` = q(s_{t+1} = i, s_t = j).  Alphas and betas are
max-normalised each step (gammas and xis are shift-invariant); the forward
shifts accumulate into logZ.

Kernels (``csrc/fused_fb.cu``, one thread per chain, time loop inside):
  * ``fb_forward``  replaces ``_fb_fwd_kernel`` (pallas_discrete.py:48-84);
  * ``fb_backward`` replaces ``_fb_bwd_kernel`` (pallas_discrete.py:87-167).
Each wrapper takes its plain version when its tensors lie on the CPU and
launches its kernel when they lie on a CUDA device (any other device raises);
there is no fallback from the kernel to the plain version.  ``LAUNCHES``
counts kernel launches.

``fused_fb_batched`` keeps the JAX wrapper's contract: log_prior (B, K),
log_trans (B, K, K), log_evidence (T, B, K) -> gammas (T, B, K), xi_sum
(B, K, K), logZ (B,) and, with ``per_step_xi=True``, xi_steps (T-1, B, K, K)
(empty at T = 1).  The kernels read and write these layouts directly.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

# Largest state count the CUDA kernels take.  Each thread keeps its chain's
# K x K table, the K x K xi accumulators and the alpha/beta carries in
# registers; the kernels are instantiated for K = 1..8.  Larger K needs the
# table in shared memory (ROADMAP B2).
MAX_STATES = 8

# kernel launches on CUDA tensors (the plain version on CPU tensors counts none)
LAUNCHES = {"fused_fb_fwd": 0, "fused_fb_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- plain PyTorch versions -------------------------------------------------------
#
# One step of each pass works on entry lists (K lists of (B,) tensors, or of
# anything with the same arithmetic), in the kernels' operation order, so the
# same code serves the plain versions and an exact operation count.

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


def backward_step(alpha, beta, le_next, lt):
    """gamma_t, max-normalised beta_t and xi_t from alpha_t and the step
    after it (beta_{t+1}, le_{t+1}); t < T-1."""
    k = len(alpha)
    s = [[lt[i][j] + le_next[i] + beta[i] for j in range(k)]
         for i in range(k)]
    b_raw = [_lse([s[i][j] for i in range(k)]) for j in range(k)]
    mb = _max(b_raw)
    b_new = [b - mb for b in b_raw]
    gamma = _softmax([alpha[i] + b_new[i] for i in range(k)])
    x_log = [[alpha[j] + s[i][j] for j in range(k)] for i in range(k)]
    mx = _max([x for row in x_log for x in row])
    x_exp = [[torch.exp(x - mx) for x in row] for row in x_log]
    x_sum = _sum([_sum(row) for row in x_exp])
    xi = [[e / x_sum for e in row] for row in x_exp]
    return gamma, b_new, xi


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


def _entries(lt):
    k = lt.shape[-1]
    return [[lt[:, i, j] for j in range(k)] for i in range(k)]


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


def fb_backward_reference(log_trans, log_evidence, alphas,
                          per_step_xi: bool = False):
    """Plain backward pass: gammas (T, B, K), xi_sum (B, K, K) and, with
    ``per_step_xi``, xi_steps (T-1, B, K, K) (else None)."""
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
            xi_steps[t] = torch.stack([torch.stack(r, dim=-1) for r in xi],
                                      dim=-2)
    xi_sum = torch.stack([torch.stack(r, dim=-1) for r in acc], dim=-2)
    return gammas, xi_sum, xi_steps


# -- kernel launches ----------------------------------------------------------------

def _library():
    lib = kernels.load("fused_fb")
    if not getattr(lib, "_rxt_typed", False):
        p = ctypes.c_void_p
        lib.rxt_fb_fwd.argtypes = [ctypes.c_int, p, p, p, p, p,
                                   ctypes.c_int64, ctypes.c_int64, p]
        lib.rxt_fb_fwd.restype = ctypes.c_int
        lib.rxt_fb_bwd.argtypes = [ctypes.c_int, ctypes.c_int, p, p, p, p, p,
                                   p, ctypes.c_int64, ctypes.c_int64, p]
        lib.rxt_fb_bwd.restype = ctypes.c_int
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
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.rxt_fb_bwd(k, int(per_step_xi), log_trans.data_ptr(),
                        log_evidence.data_ptr(), alphas.data_ptr(),
                        gammas.data_ptr(), xi_sum.data_ptr(),
                        xi_steps.data_ptr() if per_step_xi else None,
                        t_len, bsz, stream)
    kernels.check(lib, rc, "fused_fb backward kernel")
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
