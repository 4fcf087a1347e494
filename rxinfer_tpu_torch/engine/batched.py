"""Batched-program lowering onto the fused kernels (counterpart of
``rxinfer_tpu/engine/batched.py``).

``batched_program`` / ``infer_batched`` run B independent datasets through
one program.  Per sweep, in the compiled sweep order:

* A Gaussian chain block whose transition, prior and evidence parameters are
  compile-time constants (the static tier) lowers to one einsum over the raw
  observations, xi[t] = E y[t] + c, with the affine map (E, c) extracted once
  at plan time from the block's own message rules and validated on the
  example dataset and a random probe, then to
  ``ops/fused_smoother.fused_batched_smoother``.  Plan-time evaluation (the
  constants F, b, Q, W, m0, P0 and the map E, c) runs in float32 on the CPU
  whatever the program's device.
* A discrete chain block assembles its inputs over the batch
  (``DiscreteChainBlock._inputs``) and runs
  ``ops/fused_fb.fused_fb_batched(..., per_step_xi=True)``; its per-step pair
  marginals become ``chain_cross`` (B, T-1, K, K) in [out, in] order.
* A plain conjugate group multiplies its factors' messages over the batch
  (``PlainGroup.update``).

The fused kernels are the CUDA kernels on a CUDA device and their plain
versions on the CPU.  A batch with missing observations (NaN) is zero-filled
once per call and its factor copies masked; the Gaussian tier refuses such a
batch (its constant W cannot express the masks), the discrete and plain
paths take it.

With ``options={"observation_dtype": "int8" | "float8_e4m3fn"}`` a program
quantizes, once per call, every observation array that feeds a fused
Gaussian chain's evidence einsum (``ops/quantized.py``: one scale per chain
and channel, taken over time), and every sweep's einsum reads the 1-byte
payload and its scales instead of the float32 observations.

Ported subset: ``FusedGaussianPlan``, the static branches of
``_plan_fused_gaussian``, ``_extract_linear_evidence``,
``_fused_gaussian_update``, ``_fused_discrete_update``, ``build_plans``,
``chain_hbm_bytes_per_element``, ``batch_chunk_size`` and
``make_batched_program`` (with quantized observation ingest) without
shared variables or free energy.  A chain that is not eligible is not routed
to a vmapped scan (that path is not ported): the program raises
``NotImplementedError`` with the plan report's reason.  So does
``options={"fused_kernels": False}``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import numpy as np
import torch

from ..dists import Categorical, MvNormalMeanCovariance, NormalMeanVariance
from ..graph.ir import Const, Ref
from .blocks import (
    BatchContext,
    DiscreteChainBlock,
    GaussianChainBlock,
    factor_data_mask,
)

# Chain-moment budget of one batched program: three quarters of the H100's
# 80 GB, as the JAX package kept 12 of a TPU v5e's 16 GB.  The per-element
# estimate below already carries a 2x working-set headroom.
DEFAULT_HBM_BUDGET = 60_000_000_000


@dataclasses.dataclass(frozen=True)
class FusedGaussianPlan:
    """Compile-time constants of an eligible Gaussian chain, shared across
    batch and time: transition A, b, Q; evidence precision W; prior m0, p0;
    and the affine evidence map xi[t] = sum_k E[k] vec(data_k[t]) + c[t]."""

    A: np.ndarray
    b: np.ndarray
    Q: np.ndarray
    W: np.ndarray
    m0: np.ndarray
    p0: np.ndarray
    E: dict            # data name -> (dim, feat) ndarray
    c: np.ndarray      # (T, dim)


def _plan_fused_gaussian(block: GaussianChainBlock, data0: dict):
    """``(FusedGaussianPlan, None)`` when the chain's parameters are
    compile-time constants (transition A/b/noise Const, prior Const, evidence
    factors whose only non-Const input is the observed value), else
    ``(None, reason)``.

    Data-valued refs are admitted only at an evidence factor's ``out`` slot,
    where they feed xi but never W; the surviving W is evaluated on the
    example dataset and verified time-invariant."""
    from ..ops.fused_smoother import MAX_DIM
    from ..rules.registry import get_node

    if block.dim > MAX_DIM:
        return None, (
            f"state dim {block.dim} > {MAX_DIM}: the CUDA smoother kernels "
            "keep the chain state in registers and are instantiated for "
            f"d <= {MAX_DIM}"
        )
    f = block.transition
    for name, v in f.interfaces.items():
        if name == "in" or isinstance(v, Const):
            continue
        return None, (
            f"transition interface {name!r} is not a compile-time constant "
            "(random/data-valued transition parameters; the dynamic W/Q "
            "tier is not ported yet)"
        )
    for name, v in block.prior.interfaces.items():
        if not isinstance(v, Const):
            return None, (
                f"prior interface {name!r} is not a compile-time constant"
            )
    for ef, iface in block.evidence:
        node_cls = get_node(ef.fform)
        if getattr(node_cls, "needs_self_marginal", False):
            return None, (
                f"evidence factor {ef.fform} reads the chain's own marginal "
                "(state-dependent message)"
            )
        chain_ref = ef.out if iface == "out" else ef.interfaces[iface]
        for name, v in ef.all_interfaces().items():
            if v is chain_ref or isinstance(v, Const):
                continue
            if isinstance(v, Ref) and v.var.kind == "data":
                if v is ef.out and chain_ref is not ef.out:
                    continue  # observed value: enters xi only, never W
                return None, (
                    f"evidence factor {ef.fform} has data-valued interface "
                    f"{name!r}: per-dataset parameters make the evidence "
                    "precision W batch-dependent, which the constant-W "
                    "kernel cannot express"
                )
            return None, (
                f"evidence factor {ef.fform} interface {name!r} is bound to "
                "a random variable (the dynamic W tier is not ported yet)"
            )

    length = block.var.length
    d0 = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in data0.items()}
    try:
        # at T = 1 the chain applies no transition, so the (T-1)-row tables
        # are empty; the constants come from the factor's Const interfaces
        # all the same, so ask for one row
        a, bb, q = block._transition_params({}, d0, max(length, 2))
        m0, p0 = block._prior_moments({}, d0)
        _, w = block._evidence({}, d0, length)
    except Exception as exc:  # noqa: BLE001 — any assembly failure: reason
        return None, (
            f"constant-parameter assembly failed ({type(exc).__name__}: "
            f"{exc})"
        )
    w = w.numpy()
    if w.shape[0] < 1 or not np.allclose(w, w[:1], rtol=1e-5, atol=1e-6):
        return None, (
            "evidence precision W varies across time slots (unary slot "
            "evidence or partial coverage); the kernel requires one shared W"
        )
    E, c = _extract_linear_evidence(block, d0, length)
    if E is None:
        return None, (
            "the evidence information vector is not an affine, "
            "time-invariant map of the observations (the vmapped rule path "
            "is not ported yet)"
        )
    plan = FusedGaussianPlan(
        A=np.asarray(a[0], np.float32), b=np.asarray(bb[0], np.float32),
        Q=np.asarray(q[0], np.float32), W=np.asarray(w[0], np.float32),
        m0=np.asarray(m0, np.float32), p0=np.asarray(p0, np.float32),
        E=E, c=c,
    )
    return plan, None


def _extract_linear_evidence(block: GaussianChainBlock, d0: dict,
                             length: int):
    """Extract the evidence information vector as a per-slot AFFINE map of
    the data: xi[t] = sum_k E_k vec(data_k[t]) + c[t].  Columns come from
    ``torch.func.jvp`` with time-broadcast basis tangents; each column's time
    invariance and the affine map itself (on the example dataset and on a
    deterministic random probe) are verified.  Returns (None, None) on any
    mismatch."""

    def xi_of(dd):
        xi, _ = block._evidence({}, dd, length)
        return xi

    try:
        zeros = {k: torch.zeros_like(v) for k, v in d0.items()}
        c = xi_of(zeros).numpy()                        # (T, dim)
        E: dict = {}
        for name, v in d0.items():
            if v.ndim < 1 or v.shape[0] != length:
                continue  # not per-slot data for this chain
            feat = int(np.prod(v.shape[1:], dtype=np.int64)) or 1
            cols = []
            for j in range(feat):
                basis = torch.zeros((feat,))
                basis[j] = 1.0
                tangent = {
                    k: (basis.reshape(v.shape[1:]).expand(vv.shape).clone()
                        if k == name else torch.zeros_like(vv))
                    for k, vv in zeros.items()
                }
                _, dxi = torch.func.jvp(xi_of, (zeros,), (tangent,))
                dxi = dxi.numpy()                       # (T, dim)
                if not np.allclose(dxi, dxi[:1], rtol=1e-5, atol=1e-6):
                    return None, None                   # time-varying map
                cols.append(dxi[0])
            if cols and np.any(np.asarray(cols)):
                E[name] = np.asarray(cols, np.float32).T   # (dim, feat)
        # affine consistency on the example dataset AND a deterministic
        # random probe: element 0 alone may be degenerate (e.g. all zeros)
        rng = np.random.default_rng(0)
        probe = {
            k: torch.as_tensor(
                rng.standard_normal(tuple(v.shape)).astype(np.float32))
            for k, v in d0.items()
        }
        for dd in (d0, probe):
            xi_ref = xi_of(dd).numpy()
            xi_lin = c.copy()
            for name, Ek in E.items():
                flat = dd[name].numpy().reshape(length, -1)
                xi_lin = xi_lin + flat @ Ek.T
            if not np.allclose(xi_lin, xi_ref, rtol=1e-4, atol=1e-5):
                return None, None
        return E, np.asarray(c, np.float32)
    except Exception:  # noqa: BLE001 — any failure: no affine map
        return None, None


def quantize_observations(v, obs_dtype: str):
    """The quantized payload of one observation array v (B, T, ...): the
    quantization axis is TIME, one scale per (chain, channel), so the rows
    handed to ``ops/quantized.py`` are (B * F, T).  Returns vals (B, F, T)
    int8 or float8_e4m3fn and scales (B, F, 1) float32."""
    from ..ops import quantized as qops

    qfn = (qops.quantize_rows if obs_dtype == "int8"
           else qops.quantize_rows_fp8)
    b_sz, t_len = v.shape[0], v.shape[1]
    feat = int(np.prod(v.shape[2:], dtype=np.int64)) or 1
    rows = v.reshape(b_sz, t_len, feat).transpose(1, 2).reshape(
        b_sz * feat, t_len).contiguous()
    vals, scales = qfn(rows)
    return vals.reshape(b_sz, feat, t_len), scales.reshape(b_sz, feat, 1)


def run_fused_plan(plan: FusedGaussianPlan, data: dict, batch: int,
                   length: int, scalar: bool = False, qpayload=None):
    """Evidence einsum + fused smoother for one static-tier plan.  ``data``
    maps names to (B, T, ...) float32 tensors on the program's device;
    ``qpayload`` maps the names whose observations were quantized to their
    ``(vals (B, F, T), scales (B, F, 1))``, which the einsum then reads
    instead.  Returns the chain posterior (batched over B) and
    ``chain_cross`` Cov(x_{t+1}, x_t) of shape (B, T-1, d, d) (scalar
    chains: (B, T-1))."""
    from ..ops.fused_smoother import fused_batched_smoother

    dim = plan.A.shape[-1]
    xi_t = None
    for name, Ek in plan.E.items():
        if qpayload is not None and name in qpayload:
            vals, scales = qpayload[name]
            ek = torch.as_tensor(Ek, device=vals.device)
            term = torch.einsum("if,bft->tbi", ek,
                                vals.to(torch.float32) * scales)
        else:
            ek = torch.as_tensor(Ek, device=data[name].device)
            flat = data[name].reshape(batch, length, -1)        # (B, T, feat)
            term = torch.einsum("if,btf->tbi", ek, flat)
        xi_t = term if xi_t is None else xi_t + term
    ref = next(iter(data.values()))
    if xi_t is None:
        xi_t = torch.zeros((length, batch, dim), device=ref.device)
    if np.any(plan.c):
        xi_t = xi_t + torch.as_tensor(plan.c, device=xi_t.device)[:, None, :]
    xi_t = xi_t.contiguous()
    m0 = torch.as_tensor(plan.m0, device=xi_t.device).expand(
        (batch, dim)).contiguous()
    p0 = torch.as_tensor(plan.p0, device=xi_t.device).expand(
        (batch, dim, dim)).contiguous()
    means, covs, cross = fused_batched_smoother(
        m0, p0, xi_t, plan.A, plan.b, plan.Q, plan.W)
    means_b = means.movedim(0, 1)                    # (B, T, dim)
    covs_b = covs.movedim(0, 1)
    cross_b = cross.movedim(0, 1)                    # (B, T-1, d, d)
    if scalar:
        return NormalMeanVariance(means_b[..., 0], covs_b[..., 0, 0]), \
            cross_b[..., 0, 0]
    # engine convention: chain_cross stores Cov(out, in), the transpose of
    # the smoother's Cov(x_t, x_{t+1})
    return MvNormalMeanCovariance(means_b, covs_b), cross_b.transpose(-1, -2)


def _fused_gaussian_update(block: GaussianChainBlock, plan: FusedGaussianPlan,
                           data: dict, batch: int, qpayload=None):
    return run_fused_plan(plan, data, batch, block.var.length, block.scalar,
                          qpayload)


def _fused_discrete_update(block: DiscreteChainBlock, state: dict,
                           data: dict, chain_cross: dict, ctx: BatchContext):
    """The discrete chain's marginal (B, T, K) and its per-step pair
    marginals (B, T-1, K, K) from the forward-backward kernels."""
    from ..ops.fused_fb import fused_fb_batched

    lp, elog_a, le_t = block._inputs(state, data, chain_cross, ctx)
    g, _, _, xis = fused_fb_batched(lp, elog_a, le_t, per_step_xi=True)
    marg = Categorical(torch.log(torch.clamp(g.transpose(0, 1), min=1e-37)))
    return marg, xis.transpose(0, 1)


def chain_hbm_bytes_per_element(compiled) -> int:
    """Estimated device bytes ONE batch element's chain blocks stream
    through the fused kernels (smoother: filtered + smoothed means/covs,
    cross, xi payload; forward-backward: log-evidence, gammas and per-step
    xis; fp32 with 2x working-set headroom)."""
    per_elem = 0
    for kind, block in compiled.blocks:
        if kind != "chain":
            continue
        t = block.var.length
        if isinstance(block, DiscreteChainBlock):
            k = block.k
            per_elem += t * (2 * k + k * k) * 4 * 2
            continue
        d = block.dim
        sym = d * (d + 1) // 2
        per_elem += t * (2 * d + 2 * sym + d * d + d) * 4 * 2
    return per_elem


def batch_chunk_size(compiled, batch: int, budget_bytes: int):
    """Largest batch chunk that fits the budget (None = no chunking
    needed).  Raises when even one element exceeds it."""
    per_elem = chain_hbm_bytes_per_element(compiled)
    if per_elem == 0 or per_elem * batch <= budget_bytes:
        return None
    c = int(budget_bytes // per_elem)
    if c < 1:
        t_max = max((b.var.length for k, b in compiled.blocks if k == "chain"),
                    default=0)
        raise ValueError(
            f"A single batch element's chain moments (~{per_elem / 1e9:.2f} "
            f"GB at T={t_max}) exceed the device-memory budget "
            f"({budget_bytes / 1e9:.1f} GB); raise "
            "options={'hbm_budget_bytes': ...}."
        )
    return c


def build_plans(compiled, data0: dict, all_finite: bool = True,
                device: Any = "cuda") -> dict:
    """Decide, per chain block, whether the fused kernel tier applies, and
    record ``compiled._plan_report``.  ``all_finite=False`` (the batch holds
    missing observations) keeps Gaussian chains off the fused tier; discrete
    chains stream their masked evidence and stay fused."""
    from ..ops.fused_fb import MAX_STATES

    plans: dict[str, Any] = {}
    report: dict[str, dict] = {}
    compiled._plan_report = report
    route = "cuda" if torch.device(device).type == "cuda" else "plain"
    for kind, block in compiled.blocks:
        if kind != "chain":
            continue
        name = block.var.name
        if not compiled.use_fused:
            report[name] = {
                "fused": False,
                "reason": 'disabled via options={"fused_kernels": False}',
            }
            continue
        if isinstance(block, DiscreteChainBlock):
            if block.k > MAX_STATES:
                report[name] = {"fused": False, "reason": (
                    f"{block.k} states > {MAX_STATES}: the CUDA "
                    "forward-backward kernels keep each chain's K x K table "
                    "in registers and are instantiated for "
                    f"K <= {MAX_STATES}")}
                continue
            plans[name] = "discrete"
            report[name] = {"fused": True, "kernel": "fused_fb",
                            "route": route}
            continue
        if not all_finite:
            report[name] = {
                "fused": False,
                "reason": (
                    "batch contains missing observations (NaN): the "
                    "constant-W kernel cannot express per-slot masks"
                ),
            }
            continue
        plan, reason = _plan_fused_gaussian(block, data0)
        if plan is not None:
            plans[name] = plan
            report[name] = {"fused": True, "kernel": "fused_smoother",
                            "route": route}
        else:
            report[name] = {"fused": False, "reason": reason}
    return plans


def make_batched_program(compiled, data0: dict, iterations: int,
                         free_energy: bool, keep_each: bool = False,
                         all_finite: bool = True, device: Any = "cuda"):
    """Build the function (batched_data) -> (state, fe, history) where every
    data leaf and every state leaf carries a leading batch axis.  The data
    may be numpy arrays or tensors; they are moved to ``device`` as float32.
    ``fe`` is an empty (0, B) tensor (free energy is not ported yet).  A
    program built on finite data (``all_finite=True``) skips the NaN masks,
    as the JAX package's fused tier does."""
    if free_energy:
        raise NotImplementedError(
            "free_energy=True is not ported to the PyTorch package yet.")
    device = torch.device(device)
    data0 = compiled._with_derived(data0)
    plans = build_plans(compiled, data0, all_finite=all_finite, device=device)
    for kind, block in compiled.blocks:
        name = block.var.name
        if kind == "chain" and name not in plans:
            raise NotImplementedError(
                f"chain {name!r} does not lower to the fused kernels: "
                f"{compiled._plan_report[name]['reason']}. The vmapped "
                "per-dataset path is not ported yet."
            )
    # quantized observation ingest: the names that feed a fused Gaussian
    # plan's evidence einsum
    obs_dtype = compiled.observation_dtype
    qnames: set = set()
    if obs_dtype != "float32":
        for plan in plans.values():
            if isinstance(plan, FusedGaussianPlan):
                qnames |= set(plan.E)
        if not qnames and compiled.warn:
            warnings.warn(
                f'options={{"observation_dtype": "{obs_dtype}"}} has no '
                "effect: no chain block lowered to the fused linear-evidence "
                "plan (inspect compiled.plan_report()); observations stay "
                "float32.",
                stacklevel=2,
            )
    from ..dists import tree_map

    init0 = {name: tree_map(lambda a: a.to(device), d)
             for name, d in compiled._init_state().items()}
    consts: dict = {}   # model constants on the device, kept across calls

    def sweep(state, chain_cross, data, ctx, qpayload):
        for kind, block in compiled.blocks:
            name = block.var.name
            if kind == "plain":
                state[name] = block.update(state, data, chain_cross, ctx)
                continue
            if plans[name] == "discrete":
                marg, cross = _fused_discrete_update(block, state, data,
                                                     chain_cross, ctx)
            else:
                marg, cross = _fused_gaussian_update(block, plans[name], data,
                                                     ctx.batch, qpayload)
            state[name] = marg
            chain_cross[name] = cross
        return state, chain_cross

    def program(data: dict):
        data = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                for k, v in data.items()}
        data = compiled._with_derived(data)
        batch = next(iter(data.values())).shape[0]
        masks = {}
        if not all_finite:
            for f in compiled.graph.factors:
                m = factor_data_mask(f, data)
                if m is not None:
                    masks[f.id] = m
            data = {k: torch.nan_to_num(v) for k, v in data.items()}
        # once per call, not per sweep: every sweep re-reads the payload
        qpayload = {name: quantize_observations(data[name], obs_dtype)
                    for name in sorted(qnames)} or None
        ctx = BatchContext(device, batch, consts, masks)
        state = {name: tree_map(lambda a: a.expand((batch,) + tuple(a.shape)),
                                d) for name, d in init0.items()}
        chain_cross: dict = {}
        history = []
        for _ in range(iterations):
            state, chain_cross = sweep(dict(state), dict(chain_cross), data,
                                       ctx, qpayload)
            if keep_each:
                history.append(dict(state))
        fe = torch.zeros((0, batch), device=device)
        return state, fe, history

    return program
