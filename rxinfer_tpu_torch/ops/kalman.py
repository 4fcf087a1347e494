"""Dense Kalman operations (counterpart of ``rxinfer_tpu/ops/kalman.py``).

Ported subset: ``filter_step``, the batch-major predict + update that
``parallel/filtering.filtering_scan`` takes for state dimensions above 8.
Not ported yet: ``ChainParams``, the sequential and parallel smoothers and
``chain_log_evidence`` (the single-dataset ``infer`` path).
"""

from __future__ import annotations

import torch

from .smallmat import small_inv


def _symmetrize(m):
    return 0.5 * (m + m.transpose(-1, -2))


def filter_step(m, P, F, b, Q, xi, W):
    """One predict + update in information form, batched over leading axes:
    m (..., d), P (..., d, d), evidence vector xi (..., d) and precision W.
    Returns the posterior (m, P)."""
    m_pred = torch.einsum("...ij,...j->...i", F, m) + b
    p_pred = _symmetrize(torch.einsum("...ij,...jk,...lk->...il", F, P, F) + Q)
    p_pred_inv = _symmetrize(small_inv(p_pred))
    w_post = p_pred_inv + W
    p_new = _symmetrize(small_inv(w_post))
    xi_tot = torch.einsum("...ij,...j->...i", p_pred_inv, m_pred) + xi
    m_new = torch.einsum("...ij,...j->...i", p_new, xi_tot)
    return m_new, p_new
