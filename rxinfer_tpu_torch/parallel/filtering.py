"""Streaming online filtering over many parallel chains: continuous batching
(counterpart of ``rxinfer_tpu/parallel/filtering.py``).

B independent linear-Gaussian chains share one model (F, Q, H, R) and are
filtered together over a (T, B, dy) observation stream; the final
``FilterState`` is what the caller feeds to the next call when more
observations arrive.  ``filtering_scan`` is the plain form, a Python loop
over time of the batched information-form step (where the JAX package runs a
``lax.scan``); ``make_sharded_filtering(..., fused=True)`` runs the whole
stream in the hand-written CUDA kernel of ``ops/fused_filter.py``.

Ported: one device.  A mesh (the batch axis sharded over devices) raises
``NotImplementedError``.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from ..ops import entrywise as ew
from ..ops.fused_filter import evidence_operators
from ..ops.kalman import filter_step


class FilterState(NamedTuple):
    m: torch.Tensor  # (B, d)
    p: torch.Tensor  # (B, d, d)


def filtering_scan(state: FilterState, ys, f_mat, q_cov, h, r):
    """Run the batched filter over a (T, B, dy) observation stream; returns
    ``(FilterState, means (T, B, d))``.  F, Q (d, d), H (dy, d) and R
    (dy, dy) are numpy arrays or tensors.

    For d <= 8 the loop body runs in the entry-wise representation
    (ops/entrywise.py): the carry is d + d*d separate (B,) tensors and every
    operation, the closed-form Schur inverse included, is scalar arithmetic
    on whole (B,) vectors.  d > 8 takes the batch-major dense step
    (``ops/kalman.filter_step``)."""
    d = state.m.shape[-1]
    device = ys.device
    w_obs, hr = evidence_operators(h, r)
    cast = lambda a: torch.as_tensor(
        a.detach().cpu() if isinstance(a, torch.Tensor) else np.asarray(a),
        dtype=torch.float32)
    f_mat, q_cov = cast(f_mat), cast(q_cov)

    if d > 8:
        f_d, q_d, w_d, hr_d = (a.to(device) for a in (f_mat, q_cov, w_obs, hr))
        m, p = state.m, state.p
        b = torch.zeros_like(m)
        means = []
        for y_t in ys:
            xi = torch.einsum("ik,bk->bi", hr_d, y_t)
            m, p = filter_step(m, p, f_d, b, q_d, xi, w_d)
            means.append(m)
        return FilterState(m, p), torch.stack(means)

    # static (d, d) parameters as scalar entries, broadcast against (B,) carries
    f_e, q_e, w_e, hr_e = (a.tolist() for a in (f_mat, q_cov, w_obs, hr))
    m = ew.unstack_vec(state.m)                        # d entries of (B,)
    p = [[state.p[:, i, j] for j in range(d)] for i in range(d)]
    means = []
    for y_t in ys:
        xi = ew.mat_vec(hr_e, ew.unstack_vec(y_t))
        m_pred = ew.mat_vec(f_e, m)
        p_pred = ew.mat_sym(ew.mat_add(
            ew.mat_mul(ew.mat_mul(f_e, p), ew.mat_t(f_e)), q_e))
        p_pred_inv = ew.mat_sym(ew.mat_inv_scaled(p_pred))
        w_post = ew.mat_add(p_pred_inv, w_e)
        p = ew.mat_sym(ew.mat_inv_scaled(w_post))
        m = ew.mat_vec(p, ew.vec_add(ew.mat_vec(p_pred_inv, m_pred), xi))
        means.append(ew.stack_vec(m))
    final = FilterState(
        ew.stack_vec(m),
        torch.stack([torch.stack(row, dim=-1) for row in p], dim=-2))
    return final, torch.stack(means)


def make_sharded_filtering(mesh: Any, f_mat, q_cov, h, r, axis_name="batch",
                           fused=False, device: Any = None):
    """The filtering function ``(state, ys) -> (FilterState, means)`` of one
    model, on ``device`` (``"cuda"`` unless the caller passes another; with
    none given and no CUDA device present it raises ``RuntimeError``).  The
    state and the observations may be numpy arrays or tensors; they are moved
    to the device as float32.

    ``fused=True`` runs the whole stream in a CUDA filter kernel
    (ops/fused_filter.py: any state and observation dim, d > 16 on the warp
    kernel) on a CUDA device, and in the kernels' plain version with
    ``device="cpu"``;
    ``fused=False`` runs ``filtering_scan``.

    ``mesh=None`` means the one device.  Sharding the batch axis over a mesh
    of devices is not ported yet and raises ``NotImplementedError``.  The JAX
    function's ``interpret`` and ``chunk`` arguments belong to the TPU kernel
    (its CPU interpreter and its time-chunk size) and have no counterpart."""
    from ..inference import _resolve_device

    if mesh is not None:
        raise NotImplementedError(
            "make_sharded_filtering(mesh=...) is not ported to the PyTorch "
            f"package yet (axis {axis_name!r}); pass mesh=None to run on one "
            "device.")
    device = _resolve_device(device)
    if fused:
        from ..ops.fused_filter import fused_filtering_scan

        # the model is fixed: W = H^T R^-1 H and HR = H^T R^-1 are formed once
        scan = functools.partial(fused_filtering_scan,
                                 operators=evidence_operators(h, r))
    else:
        scan = filtering_scan

    def fn(state, ys):
        to_dev = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                           device=device)
        state = FilterState(to_dev(state.m), to_dev(state.p))
        return scan(state, to_dev(ys), f_mat, q_cov, h, r)

    return fn
