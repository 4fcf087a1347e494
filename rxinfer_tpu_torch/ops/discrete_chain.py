"""Discrete-chain (HMM) forward-backward in log space (counterpart of
``rxinfer_tpu/ops/discrete_chain.py``).

Exact sum-product over a categorical Markov chain given expected
log-potentials: the structured-VMP solver of the unfused chain path.
``forward_backward`` is the alpha-beta recursion as a loop over T (the
oracle, and the path for short chains); ``parallel_forward_backward`` runs
both recursions as associative scans of K x K log-matmuls
(``ops/scan.py``), O(log T) levels.  Every function takes leading batch
axes: log_prior (..., K), log_trans (..., T-1, K, K) in [out, in] order,
log_evidence (..., T, K).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .scan import associative_scan


class DiscreteChainResult(NamedTuple):
    gammas: torch.Tensor  # (..., T, K) marginals q(s_t)
    xis: torch.Tensor     # (..., T-1, K, K) pair marginals q(s_{t+1}, s_t) [out, in]
    logZ: torch.Tensor    # (...) log partition of the chain potentials


def _log_matmul(a, b):
    """(a (.) b)[i, j] = logsumexp_k a[i, k] + b[k, j]."""
    return torch.logsumexp(a[..., :, :, None] + b[..., None, :, :], dim=-2)


def _marginals(alphas, betas, log_trans, log_evidence):
    logz = torch.logsumexp(alphas[..., -1, :], dim=-1)
    gammas = torch.softmax(alphas + betas, dim=-1)
    # xi_t[i, j] ~ alpha_t[j] trans[i, j] evidence_{t+1}[i] beta_{t+1}[i]
    log_xi = (alphas[..., :-1, None, :] + log_trans
              + (log_evidence[..., 1:, :] + betas[..., 1:, :])[..., :, None])
    xis = torch.exp(log_xi - torch.logsumexp(log_xi, dim=(-2, -1),
                                             keepdim=True))
    return DiscreteChainResult(gammas, xis, logz)


def forward_backward(log_prior, log_trans, log_evidence) -> DiscreteChainResult:
    """Alpha-beta recursion in log space as loops over T."""
    log_prior = log_prior.expand(log_evidence.shape[:-2]
                                 + log_prior.shape[-1:])
    t_len = log_evidence.shape[-2]
    a = log_prior + log_evidence[..., 0, :]
    alphas = [a]
    for t in range(t_len - 1):
        a = (torch.logsumexp(log_trans[..., t, :, :] + a[..., None, :],
                             dim=-1) + log_evidence[..., t + 1, :])
        alphas.append(a)
    beta = torch.zeros_like(a)
    betas = [beta]
    for t in range(t_len - 2, -1, -1):
        beta = torch.logsumexp(
            log_trans[..., t, :, :]
            + (beta + log_evidence[..., t + 1, :])[..., :, None], dim=-2)
        betas.append(beta)
    alphas = torch.stack(alphas, dim=-2)
    betas = torch.stack(betas[::-1], dim=-2)
    return _marginals(alphas, betas, log_trans, log_evidence)


def parallel_forward_backward(log_prior, log_trans,
                              log_evidence) -> DiscreteChainResult:
    """Both recursions as associative scans.  M_t = log_trans_t +
    log_evidence_{t+1} maps alpha_t to alpha_{t+1} in the (log, +) semiring.
    The alphas are a prefix scan over the transposed elements (N_0 (.) ...
    (.) N_t is the transposed composite); the betas a reverse scan over the
    elements themselves, which the scan feeds with the later chunk on the
    left: beta_t = colsum(M_{T-2} (.) ... (.) M_t)."""
    k = log_evidence.shape[-1]
    m_fwd = log_trans + log_evidence[..., 1:, :, None]   # (..., T-1, K, K)
    dim = m_fwd.ndim - 3
    a0 = (log_prior + log_evidence[..., 0, :]).expand(
        m_fwd.shape[:-3] + (k,))
    combine = lambda x, y: (_log_matmul(x[0], y[0]),)
    prefix, = associative_scan(combine, (m_fwd.transpose(-1, -2),), dim)
    alphas_rest = torch.logsumexp(prefix + a0[..., None, :, None], dim=-2)
    alphas = torch.cat([a0[..., None, :], alphas_rest], dim=-2)
    suffix, = associative_scan(combine, (m_fwd,), dim, reverse=True)
    betas = torch.cat([torch.logsumexp(suffix, dim=-2),
                       torch.zeros_like(a0)[..., None, :]], dim=-2)
    return _marginals(alphas, betas, log_trans, log_evidence)
