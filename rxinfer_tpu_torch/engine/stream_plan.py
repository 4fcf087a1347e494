"""Fused stream plan (counterpart of ``rxinfer_tpu/engine/stream_plan.py``):
run the batched streaming engine's offline loop as one filter recursion when
the tick is linear-Gaussian filtering.

The generic batched tick evaluates message rules, builds distribution
objects and extracts posteriors every tick.  This module probes the tick
and the user's autoupdates numerically, as the batched program's planner
probes a chain's linear evidence (engine/batched.py), and, when the pattern
holds, runs the whole (T, B) stream as

  tick:        q(x) ~ N(x; pm, pc) * evidence(y), with a constant evidence
               precision W_obs and xi = E y + c affine in the observation,
  autoupdates: pm' = F m_post + g,  pc' = F V_post F^T + Q.

A probe that does not match falls back to the generic engine path, which is
right for every model.  The semantics are the engine's: tick 0 reads the
initial arguments, the prediction applies between ticks, and the
posteriors are the per-tick filtered marginals.

The JAX package runs the recursion as an entrywise ``lax.scan`` (every
matrix entry a full-width vector, closed-form inverses), which XLA fuses.
Here it is a Python loop over ticks of batched (B, d, d) tensor operations
(two batched inverses, products, symmetrizations; about forty device
kernels a tick); it calls no hand-written kernel, as the JAX plan calls no
Pallas kernel.  The inverses are ``linalg.inv_ex``: ``linalg.inv`` reads
its error flags back to the host, which would make the host wait for the
device twice a tick.  The streaming filter kernel
(``csrc/fused_filter.cu``) does not fit as it stands: it predicts before
the first observation and has no offset g.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..dists import MvNormalMeanCovariance
from ..dists.gaussian import as_mv_weighted_mean_precision


@dataclasses.dataclass(frozen=True)
class FusedStreamPlan:
    var: str              # the single latent's name
    obs: str              # the observation data argument
    pm_arg: str           # autoupdated prior-mean argument
    pc_arg: str           # autoupdated prior-covariance argument
    d: int
    W_obs: np.ndarray     # (d, d) constant evidence precision
    E: np.ndarray         # (d, feat): xi = E @ y + c
    c: np.ndarray         # (d,)
    F: np.ndarray         # (d, d) prediction map
    g: np.ndarray         # (d,) prediction offset
    Q: np.ndarray         # (d, d) prediction noise


def _make_tick_probe(compiled, var: str, device):
    """One cold single-stream tick -> the information-form posterior."""
    prog = compiled.make_tick_program(1, False, False, cold=True,
                                      device=device)

    def fn(data_el: dict):
        state, _, _, _ = prog({k: v[None] for k, v in data_el.items()})
        f = as_mv_weighted_mean_precision(state[var])
        return f.xi[0], f.w[0]

    return fn


def plan_fused_stream(compiled, au, obs_example: dict,
                      device) -> Optional[FusedStreamPlan]:
    """Probe the tick and the autoupdates on ``device``; None when the
    pattern does not hold (any probe failure included).  ``obs_example``
    holds one stream's one observation."""
    try:
        return _plan(compiled, au, obs_example, torch.device(device))
    except Exception:  # noqa: BLE001 — any probe failure: the generic path
        return None


def _plan(compiled, au, obs_example: dict, device):
    rvs = [v for v in compiled.graph.random_variables()
           if not v.name.startswith("_")]
    if len(rvs) != 1 or compiled.chains:
        return None
    var = rvs[0].name
    info = compiled.infos.get(var)
    ev = info.event_shape if info is not None else None
    if not ev or len(ev) != 1 or ev[0] > 8:
        return None  # the JAX plan's entrywise tier: vector states d <= 8
    d = int(ev[0])
    if len(au.mapping) != 2:
        return None
    # which autoupdated argument is the prior mean and which the covariance,
    # by their (batched) shapes
    pm_arg = pc_arg = None
    for k, v in au.initial.items():
        s = tuple(v.shape)
        if len(s) == 2 and s[-1] == d:
            pm_arg = k
        elif len(s) == 3 and s[-2:] == (d, d):
            pc_arg = k
    if pm_arg is None or pc_arg is None:
        return None
    obs_names = [k for k in obs_example if k not in au.initial]
    if len(obs_names) != 1:
        return None
    obs = obs_names[0]
    y_shape = tuple(np.shape(obs_example[obs]))
    feat = int(np.prod(y_shape, dtype=np.int64)) or 1

    rng = np.random.default_rng(0)
    probe = _make_tick_probe(compiled, var, device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)

    def tick_nat(pm, pc, y):
        xi, w = probe({pm_arg: f32(pm), pc_arg: f32(pc),
                       obs: f32(np.reshape(y, y_shape))})
        return (xi.cpu().numpy().astype(np.float64),
                w.cpu().numpy().astype(np.float64))

    eye = np.eye(d)
    # evidence: W(pc) = inv(pc) + W_obs, independent of y
    _, w_i = tick_nat(np.zeros(d), eye, np.zeros(feat))
    w_obs = w_i - eye
    pc2 = np.diag(np.linspace(0.5, 2.0, d)) + 0.1
    pc2 = (pc2 + pc2.T) / 2 + d * np.eye(d)
    _, w_2 = tick_nat(np.zeros(d), pc2, np.zeros(feat))
    if not np.allclose(w_2, np.linalg.inv(pc2) + w_obs, rtol=1e-4,
                       atol=1e-5):
        return None
    y_r = rng.standard_normal(feat)
    _, w_y = tick_nat(np.zeros(d), eye, y_r)
    if not np.allclose(w_y, w_i, rtol=1e-5, atol=1e-6):
        return None
    # xi = inv(pc) pm + E y + c
    c, _ = tick_nat(np.zeros(d), eye, np.zeros(feat))
    cols = []
    for j in range(feat):
        e = np.zeros(feat)
        e[j] = 1.0
        cols.append(tick_nat(np.zeros(d), eye, e)[0] - c)
    e_map = np.stack(cols, axis=1)
    pm_r = rng.standard_normal(d)
    xi_r, _ = tick_nat(pm_r, pc2, y_r)
    if not np.allclose(xi_r, np.linalg.solve(pc2, pm_r) + e_map @ y_r + c,
                       rtol=1e-4, atol=1e-4):
        return None

    # autoupdates: pm' = F m + g, pc' = F V F^T + Q, on a batch of one
    def au_maps(m, v):
        out = au({var: MvNormalMeanCovariance(f32(m)[None], f32(v)[None])})
        return (out[pm_arg].cpu().numpy().astype(np.float64)[0],
                out[pc_arg].cpu().numpy().astype(np.float64)[0])

    g, q = au_maps(np.zeros(d), np.zeros((d, d)))
    f_map = np.stack([au_maps(eye[j], np.zeros((d, d)))[0] - g
                      for j in range(d)], axis=1)
    v_r = rng.standard_normal((d, d))
    v_r = v_r @ v_r.T + np.eye(d)
    m_r = rng.standard_normal(d)
    pm_p, pc_p = au_maps(m_r, v_r)
    if not np.allclose(pm_p, f_map @ m_r + g, rtol=1e-4, atol=1e-5):
        return None
    if not np.allclose(pc_p, f_map @ v_r @ f_map.T + q, rtol=1e-4, atol=1e-4):
        return None
    # the mean map must not read V, nor the covariance map m
    pm_v, pc_m = au_maps(m_r, np.zeros((d, d)))
    if not np.allclose(pm_v, f_map @ m_r + g, rtol=1e-5, atol=1e-6):
        return None
    if not np.allclose(pc_m, q, rtol=1e-5, atol=1e-6):
        return None
    f32n = lambda a: np.asarray(a, np.float32)
    return FusedStreamPlan(var=var, obs=obs, pm_arg=pm_arg, pc_arg=pc_arg,
                           d=d, W_obs=f32n(w_obs), E=f32n(e_map), c=f32n(c),
                           F=f32n(f_map), g=f32n(g), Q=f32n(q))


def _sym(a):
    return 0.5 * (a + a.transpose(-1, -2))


def make_fused_stream_fn(plan: FusedStreamPlan, device):
    """The whole-stream executor: ``fn(ys (T, B, feat...), pm (B, d), pc
    (B, d, d)) -> (means (T, B, d), covs (T, B, d, d), final_pm,
    final_pc)``, the final pair being the prediction for the next tick."""
    device = torch.device(device)
    t = lambda a: torch.as_tensor(a, device=device)
    w_obs, e_map, c, f, g, q = (t(plan.W_obs), t(plan.E), t(plan.c),
                                t(plan.F), t(plan.g), t(plan.Q))

    def fn(ys, pm, pc):
        ys = torch.as_tensor(ys, dtype=torch.float32, device=device)
        t_len, b = ys.shape[0], ys.shape[1]
        # the information stream of every tick: one product
        xi_all = torch.einsum("if,tbf->tbi", e_map,
                              ys.reshape(t_len, b, -1)) + c
        m = torch.as_tensor(pm, dtype=torch.float32, device=device)
        p = torch.as_tensor(pc, dtype=torch.float32, device=device)
        means = xi_all.new_empty((t_len, b, plan.d))
        covs = xi_all.new_empty((t_len, b, plan.d, plan.d))
        for k in range(t_len):
            w_prior = _sym(torch.linalg.inv_ex(p).inverse)
            p_new = _sym(torch.linalg.inv_ex(w_prior + w_obs).inverse)
            xi = torch.einsum("bij,bj->bi", w_prior, m) + xi_all[k]
            m_new = torch.einsum("bij,bj->bi", p_new, xi)
            means[k] = m_new
            covs[k] = p_new
            # the prediction for the next tick (the autoupdates)
            m = m_new @ f.T + g
            p = _sym(f @ p_new @ f.T + q)
        return means, covs, m, p

    return fn
