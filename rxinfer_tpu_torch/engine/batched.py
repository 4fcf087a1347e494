"""Batched-program lowering onto the fused kernels (counterpart of
``rxinfer_tpu/engine/batched.py``).

``batched_program`` / ``infer_batched`` run B independent datasets through
one program.  Per sweep, in the compiled sweep order
(``CompiledModel._sweep_once``):

* A Gaussian chain block whose transition, prior and evidence parameters are
  compile-time constants (the static tier) lowers to one einsum over the raw
  observations, xi[t] = E y[t] + c, with the affine map (E, c) extracted once
  at plan time from the block's own message rules and validated on the
  example dataset and a random probe, then to
  ``ops/fused_smoother.fused_batched_smoother``.  Plan-time evaluation (the
  constants F, b, Q, W, m0, P0 and the map E, c) runs in float32 on the CPU
  whatever the program's device.
* The dynamic tier: a chain whose evidence precision W and/or transition
  noise Q is bound to a random variable that is not the chain (an unknown
  observation or process-noise precision, a ``Gamma`` / ``Wishart`` group)
  re-closes them from the current state every sweep, per chain, and hands
  them to the smoother kernels as per-chain (B, d, d) matrices
  (``w_batch`` / ``q_batch``, the V1 kernels).  W and xi come from the
  W-linear map when the probes at plan time validate it (one precision
  variable: xi = (E0 + J^T E[v]_b) y + c0, W = W0 + J^T E[v]_b J), else
  from the evidence rules over the batch; Q from the block's transition
  rule with its float32 guard.  The plan report reads ``dynamic`` and, with
  a dynamic W, ``w_linear`` and the probe's reason when it is False.
* A discrete chain block assembles its inputs over the batch
  (``DiscreteChainBlock._inputs``) and runs
  ``ops/fused_fb.fused_fb_batched(..., per_step_xi=True)``; its per-step pair
  marginals become ``chain_cross`` (B, T-1, K, K) in [out, in] order.
* A chain the plan leaves off the kernels runs its block's batch-major
  ``update`` instead: the associative-scan smoother or forward-backward of
  ``ops/kalman.py`` / ``ops/discrete_chain.py`` over the whole batch (the
  counterpart of the JAX package's vmapped chain step).  ``build_plans``
  decides which, and ``compiled.plan_report()`` gives each chain's reason:
  ``options={"fused_kernels": False}``, missing observations in a Gaussian
  batch, a state dimension beyond the kernels' (a discrete chain of any
  state count is fused, as in the JAX planner), parameters that are not
  compile-time constants.  It is a decision of the plan only:
  a kernel that fails to build or launch raises, and nothing reroutes its
  chain.  One program may mix fused and unfused chains.
* A plain conjugate group multiplies its factors' messages over the batch
  (``PlainGroup.update``).

The fused kernels are the CUDA kernels on a CUDA device and their plain
versions on the CPU.  A batch with missing observations (NaN) is zero-filled
once per call and its factor copies masked; the Gaussian kernel tier
refuses such a batch (its constant W cannot express the masks), the
discrete kernels, the unfused chains and the plain groups take it.

With ``options={"observation_dtype": "int8" | "float8_e4m3fn"}`` a program
quantizes, once per call, every observation array that feeds a fused
Gaussian chain's evidence einsum (``ops/quantized.py``: one scale per chain
and channel, taken over time), and every sweep's einsum reads the 1-byte
payload and its scales instead of the float32 observations.

With ``free_energy=True`` the program computes the Bethe free energy of
every dataset after every sweep (``CompiledModel._free_energy``, batch-major)
from the marginals and the pair statistics the chains returned: K2's cross
for a fused Gaussian chain, K5's per-step pair marginals for a fused discrete
one.  Under quantized ingest the free-energy terms read the dequantized
observations, ``vals * scales`` in the observation's layout, so that they see
what the evidence saw; without free energy that copy is not made.

State dims up to 16 run on the kernels (the register kernels to d = 8, the
wide ones above), behind the JAX planner's gate on the moment streams'
device bytes for d > 8 (``fused_moment_bytes``); d > 16 runs on the scans.
``options={"fused_moment_dtype": "bfloat16"}`` stores the covariances and
the cross between the two kernels in bf16 (``run_fused_plan``); the
posteriors, the chain cross and the free energy read them upcast to
float32, as the JAX package's do.

Ported subset: ``FusedGaussianPlan``, ``_plan_fused_gaussian`` (the static
and dynamic tiers; d <= 16), ``_extract_linear_evidence``,
``_extract_wlinear_evidence``, ``_fused_gaussian_update``,
``_fused_discrete_update``, ``build_plans``,
``chain_hbm_bytes_per_element``, ``batch_chunk_size`` and
``make_batched_program`` (with quantized observation ingest, the unfused
chain path, free energy and ``shared=`` pooling on one device: the
partition, validation, pooled update and free-energy correction of
``rxinfer_tpu/engine/batched.py`` and ``make_chunked_shared_program``;
``psum_axis`` waits for ROADMAP A7b).  Two guards
the JAX planner lacks: a dynamic precision must be a single-copy variable,
and the per-slot evidence signature of a dynamic W holds the values of the
factors' constant interfaces (``_external_random``, ``_slot_signature``).
"""

from __future__ import annotations

import copy

import dataclasses
import hashlib
import warnings
from typing import Any

import numpy as np
import torch

from ..dists import (
    Categorical,
    MvNormalMeanCovariance,
    NormalMeanVariance,
    tree_leaves,
    tree_map,
)
from ..dists.natural import (
    NAT_EVENT_RANKS,
    family_key,
    from_natural,
    prod_all,
    prod_reduce,
    to_natural,
)
from ..graph.ir import Const, Ref
from .blocks import (
    BatchContext,
    DiscreteChainBlock,
    GaussianChainBlock,
    PlainGroup,
    cpu_context,
)

# Chain-moment budget of one batched program: three quarters of the H100's
# 80 GB, as the JAX package kept 12 of a TPU v5e's 16 GB.  The per-element
# estimate below already carries a 2x working-set headroom.
DEFAULT_HBM_BUDGET = 60_000_000_000
# Element-sizes of working set a step of an unfused chain holds at its peak
# (see chain_hbm_bytes_per_element): the Gaussian scans at B=1024, T=10,000,
# d=4 peaked at 865 bytes a chain-step on an H100 (chip_smoke.py, phase 9),
# 3.9 element-sizes; 4 with the estimate's 2x headroom over it.
UNFUSED_SCAN_FLOATS = 4
# Joint-sizes (2d x 2d floats) of working set a step of a Gaussian chain's
# free energy adds at its peak (see chain_hbm_bytes_per_element): the pair
# entropy's joint and the log-determinant's column-major copy of it.  The
# LGSSM at B=1024, T=10,000, d=4 peaked at 8.07 GB above its inputs with
# free energy and 2.62 GB without on an H100 (chip_smoke.py, phase 12 (a)):
# 2.1 joint-sizes a chain-step more.
FE_PAIR_FLOATS = 2


@dataclasses.dataclass(frozen=True)
class FusedGaussianPlan:
    """Compile-time constants of an eligible Gaussian chain, shared across
    batch and time: transition A, b, Q; evidence precision W; prior m0, p0;
    and the affine evidence map xi[t] = sum_k E[k] vec(data_k[t]) + c[t].

    The dynamic tier: ``dyn_w`` / ``dyn_q`` mark an evidence precision /
    transition noise bound to a random variable, re-closed every sweep and
    per chain (``W`` / ``Q`` are then None, and ``E``, ``c`` too under
    ``dyn_w``: xi depends on the state).  ``wlin`` is the W-linear map of a
    dynamic W, (variable name, scalar_v, E0 dict, J^T dict, c0, W0, dW or
    None), or None when the evidence rules are evaluated every sweep."""

    A: np.ndarray
    b: np.ndarray
    Q: Any             # (d, d) ndarray, or None when dyn_q
    W: Any             # (d, d) ndarray, or None when dyn_w
    m0: np.ndarray
    p0: np.ndarray
    E: Any             # data name -> (dim, feat) ndarray; None when dyn_w
    c: Any             # (T, dim); None when dyn_w
    dyn_w: bool = False
    dyn_q: bool = False
    wlin: Any = None


def _const_fingerprint(v: Const) -> tuple:
    """Shape and a hash of the value of a constant interface."""
    a = np.ascontiguousarray(np.asarray(v.value, np.float32))
    return a.shape, hashlib.sha1(a.tobytes()).hexdigest()


def _slot_signature(ef, iface: str, chain_ref) -> tuple:
    """What an evidence factor contributes to a slot's W: its node, the
    chain's interface, its random interfaces and the values of its constant
    ones.  Two factors that differ only in a constant (a per-slot gain)
    differ here, so slot uniformity is structural, not an accident of the
    initial state."""
    items = ef.all_interfaces().items()
    return (ef.fform, iface,
            tuple(sorted((n, v.var.name) for n, v in items
                         if isinstance(v, Ref) and v.var.kind == "random"
                         and v is not chain_ref)),
            tuple(sorted((n, _const_fingerprint(v)) for n, v in items
                         if isinstance(v, Const))))


def fused_moment_bytes(d: int, t_len: int, batch: int,
                       moment_dtype: str = "float32") -> int:
    """Device bytes of a fused chain's moment streams, with the JAX
    planner's 2x headroom (``rxinfer_tpu/engine/batched.py:130-133``) in the
    port's own layout (no lane padding): filtered and smoothed means in
    float32, filtered and smoothed packed covariances and the cross in
    ``moment_dtype``."""
    nsym = d * (d + 1) // 2
    msize = torch.finfo(getattr(torch, moment_dtype)).bits // 8
    return t_len * (2 * d * 4 + (2 * nsym + d * d) * msize) * batch * 2


def _plan_fused_gaussian(block: GaussianChainBlock, data0: dict,
                         state0: dict | None = None,
                         batch_hint: int | None = None,
                         hbm_budget: int | None = None,
                         moment_dtype: str = "float32"):
    """``(FusedGaussianPlan, None)`` when the chain's parameters are
    compile-time constants (transition A/b/noise Const, prior Const, evidence
    factors whose only non-Const input is the observed value) or, in the
    dynamic tier, an evidence precision / transition noise bound to a random
    variable other than the chain, re-closed every sweep; else
    ``(None, reason)``.  A dynamic-W plan without the W-linear map comes
    with the probe's reason instead of None.  ``state0`` (the compiled
    model's initial state) feeds the plan-time checks of a dynamic plan.

    Data-valued refs are admitted only at an evidence factor's ``out`` slot,
    where they feed xi but never W; the surviving W is evaluated on the
    example dataset (at the initial state) and verified time-invariant.

    A state dim above ``MAX_DIM`` (16) is refused with the JAX planner's
    reason; one in (``REG_MAX_DIM``, ``MAX_DIM``] (the wide kernels) must
    keep its moment streams (``fused_moment_bytes`` at ``batch_hint``
    chains, 1024 without one, as in the JAX planner) within ``hbm_budget``
    (``DEFAULT_HBM_BUDGET`` without one)."""
    from ..ops.fused_smoother import MAX_DIM, REG_MAX_DIM
    from ..rules.registry import get_node
    from .blocks import _coverage, in_cavity_cluster

    if block.dim > MAX_DIM:
        return None, (
            f"state dim {block.dim} > {MAX_DIM}: beyond the closed-form "
            "Schur inverse tier; the batched scan path applies"
        )
    if block.dim > REG_MAX_DIM:
        budget = hbm_budget or DEFAULT_HBM_BUDGET
        lanes = batch_hint or 1024
        nbytes = fused_moment_bytes(block.dim, block.var.length, lanes,
                                    moment_dtype)
        if nbytes > budget:
            return None, (
                f"state dim {block.dim}: the fused kernel's moment streams "
                f"(~{nbytes / 1e9:.1f} GB at T={block.var.length}, {lanes} "
                f"chains) exceed the device-memory budget "
                f"({budget / 1e9:.1f} GB); batched scan path"
            )

    def _external_random(v):
        """A whole-variable reference to one random variable other than the
        chain: one marginal a sweep, which the dynamic tier re-closes.  A
        slot-indexed ref would make the precision time-varying, and a
        reference to a whole array variable (several copies, a marginal a
        slot) is not one precision either."""
        return (isinstance(v, Ref) and v.var.kind == "random"
                and v.idx is None and not v.var.is_array
                and v.var.name != block.var.name)

    dyn_w = dyn_q = False
    dyn_ev: list = []   # (interface name, variable name) of dynamic evidence
    f = block.transition
    for name, v in f.interfaces.items():
        if name == "in" or isinstance(v, Const):
            continue
        if name in ("prec", "cov", "var") and _external_random(v):
            dyn_q = True   # unknown process noise: re-closed every sweep
            continue
        return None, (
            f"transition interface {name!r} is not a compile-time constant "
            "(random/data-valued transition parameters)"
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
            if _external_random(v):
                # the dynamic tier re-assembles xi and W from the state every
                # sweep; a cavity division over stored messages (another
                # random interface in the factor's BP cluster) and damping
                # blend against state the fused path does not carry
                cav_random = any(
                    n != iface and in_cavity_cluster(node_cls, n)
                    and isinstance(vv, Ref) and vv.var.kind == "random"
                    for n, vv in ef.all_interfaces().items())
                if cav_random:
                    return None, (
                        f"evidence factor {ef.fform} interface {name!r} is "
                        "random AND the factor's BP cluster holds another "
                        "random interface (cavity division over stored "
                        "messages); the dynamic kernel tier covers "
                        "conjugate evidence only"
                    )
                if (ef.meta or {}).get("damping"):
                    return None, (
                        f"evidence factor {ef.fform} has EP damping meta; "
                        "damped messages blend against stored state the "
                        "fused path does not carry"
                    )
                dyn_w = True
                dyn_ev.append((name, v.var.name))
                continue
            return None, (
                f"evidence factor {ef.fform} interface {name!r} is bound to "
                "a random variable with per-slot indexing, or to a variable "
                "of several copies (time-varying evidence precision)"
            )

    length = block.var.length
    if dyn_w:
        # every slot must see the same evidence factors, random precisions
        # and constants, else W would vary across slots once the precisions
        # move away from their (uniform) initial state
        per_slot: list = [[] for _ in range(length)]
        for ef, iface in block.evidence:
            chain_ref = ef.out if iface == "out" else ef.interfaces[iface]
            sig = _slot_signature(ef, iface, chain_ref)
            cov = _coverage(ef, chain_ref)
            slots = (range(length) if cov is None or cov == "grid"
                     else ([cov] if isinstance(cov, int)
                           else range(cov[0], cov[1])))
            for t in slots:
                per_slot[t].append(sig)
        canon = sorted(per_slot[0])
        if any(sorted(p) != canon for p in per_slot[1:]):
            return None, (
                "evidence structure varies across time slots (different "
                "factors, random precisions or constants per slot); the "
                "dynamic kernel tier requires one shared per-sweep W"
            )

    state0 = dict(state0 or {}) if (dyn_w or dyn_q) else {}
    d0 = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in data0.items()}
    try:
        # at T = 1 the chain applies no transition, so the (T-1)-row tables
        # are empty; the constants come from the factor's Const interfaces
        # all the same, so ask for one row
        a, bb, q = block._transition_params(_one(state0), _one(d0),
                                            max(length, 2))
        m0, p0 = block._prior_moments(_one(state0), _one(d0))
        _, w = _probe_evidence(block, state0, d0)
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
    wlin = None
    wlin_reason = None
    if dyn_w:
        vnames = {vn for _, vn in dyn_ev}
        if len(vnames) != 1:
            wlin_reason = (f"{len(vnames)} precision variables "
                           f"{sorted(vnames)}: the W-linear map takes one")
        elif any(n != "prec" for n, _ in dyn_ev):
            wlin_reason = ("a random evidence interface other than 'prec' "
                           f"({sorted({n for n, _ in dyn_ev})})")
        else:
            vname = next(iter(vnames))
            res, wlin_reason = _extract_wlinear_evidence(
                block, d0, length, state0, vname)
            if res is not None:
                wlin = (vname,) + res
        E, c = None, None
    else:
        E, c = _extract_linear_evidence(block, d0, length)
        if E is None:
            return None, (
                "the evidence information vector is not an affine, "
                "time-invariant map of the observations (the vmapped rule "
                "path is not ported yet)"
            )
    plan = FusedGaussianPlan(
        A=np.asarray(a[0], np.float32), b=np.asarray(bb[0], np.float32),
        Q=None if dyn_q else np.asarray(q[0], np.float32),
        W=None if dyn_w else np.asarray(w[0], np.float32),
        m0=np.asarray(m0, np.float32), p0=np.asarray(p0, np.float32),
        E=E, c=c, dyn_w=dyn_w, dyn_q=dyn_q, wlin=wlin,
    )
    return plan, wlin_reason


def _one(tree: dict) -> dict:
    """One dataset's data or state as a batch of one."""
    return {k: tree_map(lambda a: a[None], v) for k, v in tree.items()}


def _probe_evidence(block: GaussianChainBlock, state: dict, d0: dict):
    """One dataset's evidence xi (T, d) and W (T, d, d) at ``state``: the
    block's batch-major evidence on a batch of one on the CPU."""
    xi, w = block._evidence_batch(_one(state), _one(d0), cpu_context())
    return xi[0], w[0]


def _extract_linear_evidence(block: GaussianChainBlock, d0: dict,
                             length: int, state: dict | None = None):
    """Extract the evidence information vector as a per-slot AFFINE map of
    the data: xi[t] = sum_k E_k vec(data_k[t]) + c[t].  Columns come from
    ``torch.func.jvp`` with time-broadcast basis tangents; each column's time
    invariance and the affine map itself (on the example dataset and on a
    deterministic random probe) are verified.  Returns (None, None) on any
    mismatch.  ``state``: marginals the evidence rules read (the dynamic
    tier's probe states); the map is extracted at that state."""
    state = state or {}

    def xi_of(dd):
        xi, _ = _probe_evidence(block, state, dd)
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


def _extract_wlinear_evidence(block: GaussianChainBlock, d0: dict,
                              length: int, state0: dict, vname: str):
    """The W-linear evidence map of a dynamic plan.  Conjugate Gaussian
    evidence is linear in the precision value v (``y ~ Normal(H x,
    prec=v)``: xi = H^T v y, W = H^T v H), and its VMP messages read q(v)
    through E[v] only.  Probing the rules at point-mass precisions v in
    {I, I + S, R2} recovers, per data stream k,

        E_k(v) = E0_k + J_k^T v          c(v) = c0
        W(v)   = W0 + sum_k J_k^T v J_k  (matrix v), W0 + v dW (scalar v)

    and every equation is validated at an independent point and at the
    initial state's own marginal (which proves the rules read q(v) through
    E[v] alone).  Each sweep then costs one small per-chain product,
    M_b = E0 + J^T E[v]_b, feeding the evidence einsum, instead of the
    rules' (B, T, d, d) intermediates.  The probes run on the CPU in
    float32, as the plan does.

    Returns ``((scalar_v, E0, JT, c0, W0, dW or None), None)`` or
    ``(None, reason)``."""
    from ..dists import PointMass
    from ..rules.expectations import e_precision

    try:
        return _wlinear_map(block, d0, length, state0, vname, PointMass,
                            e_precision)
    except Exception as exc:  # noqa: BLE001 — reported in the plan
        return None, (f"the W-linear probe failed ({type(exc).__name__}: "
                      f"{exc})")


def _wlinear_map(block, d0, length, state0, vname, PointMass, e_precision):
    v0 = e_precision(state0[vname]).numpy()
    scalar_v = v0.ndim == 0
    dv = 1 if scalar_v else v0.shape[-1]
    if not scalar_v and v0.shape != (dv, dv):
        return None, (f"E[{vname}] has shape {v0.shape}, neither a scalar "
                      "nor one square matrix")
    eye = np.float32(1.0) if scalar_v else np.eye(dv, dtype=np.float32)
    rng = np.random.default_rng(3)
    # probe points must be non-singular: some rules round-trip the message
    # through a covariance.  Probe at I and I + S (S and I + S invertible by
    # construction), validate at an independent SPD point R2.
    if scalar_v:
        ra, r2 = np.float32(1.7), np.float32(0.6)
    else:
        rm = 0.25 * rng.standard_normal((dv, dv)).astype(np.float32)
        s_mat = rm @ rm.T + np.eye(dv, dtype=np.float32)
        ra = eye + s_mat
        rm2 = rng.standard_normal((dv, dv)).astype(np.float32)
        r2 = rm2 @ rm2.T / dv + 0.5 * np.eye(dv, dtype=np.float32)

    def probe(vval):
        st = dict(state0)
        st[vname] = PointMass(torch.as_tensor(vval, dtype=torch.float32))
        e, c = _extract_linear_evidence(block, d0, length, state=st)
        _, w = _probe_evidence(block, st, d0)
        return e, c, w.numpy()[0]

    e1, c1, w1 = probe(eye)
    ea, ca, wa = probe(ra)
    e2, c2, w2 = probe(r2)
    if c1 is None or ca is None or c2 is None:
        return None, ("the evidence is not an affine, time-invariant map of "
                      "the observations at a probe precision")
    ok = lambda a, b: np.allclose(a, b, rtol=1e-4, atol=1e-5)
    if not (ok(ca, c1) and ok(c2, c1)):
        return None, "the evidence's constant offset depends on the precision"
    names = sorted(set(e1) | set(ea) | set(e2))
    jt_all, e0_all = {}, {}
    for k in names:
        zero = 0.0 * np.asarray((e1.get(k) if k in e1 else ea.get(k, e2.get(k))))
        k1, ka, k2 = (np.asarray(e.get(k, zero)) for e in (e1, ea, e2))
        if not scalar_v and k1.shape[-1] != dv:
            return None, (f"data {k!r} has {k1.shape[-1]} features, the "
                          f"precision is {dv} x {dv}")
        if scalar_v:
            jt = (ka - k1) / (float(ra) - 1.0)
            e0 = k1 - jt
            k2_pred = e0 + float(r2) * jt
        else:
            jt = (ka - k1) @ np.linalg.inv(s_mat)      # E(I+S) - E(I) = J^T S
            e0 = k1 - jt @ eye
            k2_pred = e0 + jt @ r2
        if not ok(k2, k2_pred):
            return None, (f"the evidence map of {k!r} is not linear in the "
                          "precision")
        jt_all[k] = jt.astype(np.float32)
        e0_all[k] = e0.astype(np.float32)
    if scalar_v:
        dw = (wa - w1) / (float(ra) - 1.0)
        w0 = w1 - dw
        if not ok(w2, w0 + float(r2) * dw):
            return None, "the evidence precision is not linear in v"
        extra = dw.astype(np.float32)
    else:
        lin = lambda v: sum((jt_all[k] @ v @ jt_all[k].T for k in names),
                            np.zeros_like(w1))
        w0 = w1 - lin(eye)
        if not (ok(wa, w0 + lin(ra)) and ok(w2, w0 + lin(r2))):
            return None, "the evidence precision is not J^T v J + W0"
        extra = None
    # the initial state's own marginal: the rules must read q(v) through
    # E[v] only, or the fused path would drift from the scan path
    es, cs = _extract_linear_evidence(block, d0, length, state=state0)
    _, ws = _probe_evidence(block, state0, d0)
    ws = ws.numpy()[0]
    if cs is None or not ok(cs, c1):
        return None, ("at the initial state the evidence's offset differs "
                      "from the probes'")
    for k in names:
        es_pred = (e0_all[k] + float(v0) * jt_all[k] if scalar_v
                   else e0_all[k] + jt_all[k] @ v0)
        if not ok((es or {}).get(k, e0_all[k]), es_pred):
            return None, (f"at the initial state the evidence map of {k!r} "
                          f"reads more of q({vname}) than its mean")
    ws_pred = (w0 + float(v0) * extra if scalar_v
               else w0 + sum(jt_all[k] @ v0 @ jt_all[k].T for k in names))
    if not ok(ws, ws_pred):
        return None, ("at the initial state the evidence precision reads "
                      f"more of q({vname}) than its mean")
    return (scalar_v, e0_all, jt_all, np.asarray(c1, np.float32),
            np.asarray(w0, np.float32), extra), None


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


def _static_xi(plan: FusedGaussianPlan, data: dict, batch: int,
               length: int, dim: int, qpayload=None):
    """The static evidence einsum: xi (T, B, dim) from the observations (or
    their quantized payload) through the plan's affine map (E, c)."""
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
    return xi_t


def _wlinear_inputs(plan: FusedGaussianPlan, state: dict, data: dict,
                    batch: int, length: int, dim: int):
    """xi (T, B, dim) and the per-chain W (B, dim, dim) of a dynamic plan
    through its W-linear map: M_b = E0 + J^T E[v]_b feeds the evidence
    einsum, W_b = W0 + J^T E[v]_b J (or W0 + E[v]_b dW for a scalar v)."""
    from ..rules.expectations import e_precision

    vname, scalar_v, e0d, jtd, c0, w0, dw = plan.wlin
    vb = e_precision(state[vname])           # (B,) or (B, dv, dv)
    dev = vb.device
    xi_t = None
    for name in sorted(e0d):
        e0k = torch.as_tensor(e0d[name], device=dev)
        jtk = torch.as_tensor(jtd[name], device=dev)
        if scalar_v:
            mb = e0k[None] + vb[:, None, None] * jtk[None]
        else:
            mb = e0k[None] + torch.einsum("iv,bvw->biw", jtk, vb)
        flat = data[name].reshape(batch, length, -1)
        term = torch.einsum("bif,btf->tbi", mb, flat)
        xi_t = term if xi_t is None else xi_t + term
    if xi_t is None:
        xi_t = torch.zeros((length, batch, dim), device=dev)
    if np.any(c0):
        xi_t = xi_t + torch.as_tensor(c0, device=dev)[:, None, :]
    if scalar_v:
        w_b = (torch.as_tensor(w0, device=dev)[None]
               + vb[:, None, None] * torch.as_tensor(dw, device=dev))
    else:
        w_b = torch.as_tensor(w0, device=dev)[None].expand(batch, dim, dim)
        for k in sorted(jtd):
            jtk = torch.as_tensor(jtd[k], device=dev)
            w_b = w_b + torch.einsum("iv,bvw,jw->bij", jtk, vb, jtk)
    return xi_t, w_b


def dynamic_inputs(block: GaussianChainBlock, plan: FusedGaussianPlan,
                   state: dict, data: dict, ctx: BatchContext):
    """Re-close a dynamic plan's per-chain parameters from the current state
    (the Gauss-Seidel point the scan path reads too): (xi (T, B, d) or None
    when W is static, W (B, d, d) or None, Q (B, d, d) or None).  A dynamic
    W comes with its xi: from the W-linear map, or from the evidence rules
    over the batch (``_evidence_batch``, W of slot 0: the plan proved the
    slots alike).  A dynamic Q is the transition noise covariance of the
    block's rule, (E[W_q] + 1e-4 I)^-1."""
    length, dim = block.var.length, block.dim
    xi_t = w_b = q_b = None
    if plan.dyn_w and plan.wlin is not None:
        xi_t, w_b = _wlinear_inputs(plan, state, data, ctx.batch, length,
                                    dim)
    elif plan.dyn_w:
        xi, w = block._evidence_batch(state, data, ctx)
        xi_t, w_b = xi.transpose(0, 1), w[:, 0]
    if plan.dyn_q:
        _, _, q = block._transition_params(state, data, max(length, 2), ctx)
        q_b = q[:, 0]
    return xi_t, w_b, q_b


def run_fused_plan(plan: FusedGaussianPlan, data: dict, batch: int,
                   length: int, scalar: bool = False, qpayload=None,
                   dynamic=None, moment_dtype: str = "float32"):
    """Evidence einsum + fused smoother for one plan.  ``data`` maps names
    to (B, T, ...) float32 tensors on the program's device; ``qpayload``
    maps the names whose observations were quantized to their
    ``(vals (B, F, T), scales (B, F, 1))``, which the einsum then reads
    instead.  A dynamic plan takes ``dynamic`` = (xi, W, Q) from
    ``dynamic_inputs``.  ``moment_dtype`` ("float32" or "bfloat16") is what
    the kernels store the covariances and the cross in between them.
    Returns the chain posterior (batched over B) and ``chain_cross``
    Cov(x_{t+1}, x_t) of shape (B, T-1, d, d) (scalar chains: (B, T-1)),
    float32 either way."""
    from ..ops.fused_smoother import fused_batched_smoother

    dim = plan.A.shape[-1]
    xi_t, w_b, q_b = dynamic if dynamic is not None else (None, None, None)
    if (w_b is None) != (plan.W is not None) or \
            (q_b is None) != (plan.Q is not None):
        raise ValueError("a dynamic plan needs its per-chain W / Q "
                         "(dynamic_inputs), a static one none")
    if xi_t is None:
        xi_t = _static_xi(plan, data, batch, length, dim, qpayload)
    xi_t = xi_t.contiguous()
    m0 = torch.as_tensor(plan.m0, device=xi_t.device).expand(
        (batch, dim)).contiguous()
    p0 = torch.as_tensor(plan.p0, device=xi_t.device).expand(
        (batch, dim, dim)).contiguous()
    means, covs, cross = fused_batched_smoother(
        m0, p0, xi_t, plan.A, plan.b, plan.Q, plan.W,
        w_batch=None if w_b is None else w_b.contiguous(),
        q_batch=None if q_b is None else q_b.contiguous(),
        moment_dtype=getattr(torch, moment_dtype))
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
                           data: dict, batch: int, qpayload=None,
                           state: dict | None = None,
                           ctx: BatchContext | None = None,
                           moment_dtype: str = "float32"):
    """The planned chain's update in a sweep; a dynamic plan reads the
    sweep's ``state`` (and the program's ``ctx``, made here when absent)."""
    dynamic = None
    if plan.dyn_w or plan.dyn_q:
        if state is None:
            raise ValueError("a dynamic fused plan needs the sweep state")
        if ctx is None:
            ctx = BatchContext(next(iter(data.values())).device, batch, {})
        dynamic = dynamic_inputs(block, plan, state, data, ctx)
    return run_fused_plan(plan, data, batch, block.var.length, block.scalar,
                          qpayload, dynamic, moment_dtype)


def _fused_discrete_update(block: DiscreteChainBlock, state: dict,
                           data: dict, chain_cross: dict, ctx: BatchContext):
    """The discrete chain's marginal (B, T, K) and its per-step pair
    marginals (B, T-1, K, K) from the forward-backward kernels."""
    from ..ops.fused_fb import fused_fb_batched

    lp, elog_a, le_t = block._inputs(state, data, chain_cross, ctx)
    g, _, _, xis = fused_fb_batched(lp, elog_a, le_t, per_step_xi=True)
    marg = Categorical(torch.log(torch.clamp(g.transpose(0, 1), min=1e-37)))
    return marg, xis.transpose(0, 1)


def chain_hbm_bytes_per_element(compiled, free_energy: bool = False) -> int:
    """Estimated device bytes ONE batch element's chain blocks hold at once
    (fp32 with 2x working-set headroom).  A fused chain streams its moments
    through the kernels (smoother: filtered + smoothed means/covs, cross, xi
    payload; forward-backward: log-evidence, gammas and per-step xis).  A
    chain the last plan left unfused (``compiled.plan_report()``) holds the
    scan path's working set instead: its evidence, the associative elements
    (filter (A, b, C, eta, J): 3d^2 + 2d floats a step) with the scan's
    levels, its compose temporaries and its outputs, UNFUSED_SCAN_FLOATS
    element-sizes in all; a discrete chain its K x K elements and the
    K x K x K log-matmul temporaries of the scan's levels.  With
    ``free_energy`` a Gaussian chain adds the pair entropy's working set,
    FE_PAIR_FLOATS joint-sizes (2d x 2d) a step, and a discrete chain one
    K x K temporary a step (the JAX version counts no free energy)."""
    report = compiled._plan_report or {}
    per_elem = 0
    for kind, block in compiled.blocks:
        if kind != "chain":
            continue
        t = block.var.length
        fused = report.get(block.var.name, {}).get("fused", True)
        if isinstance(block, DiscreteChainBlock):
            k = block.k
            floats = (2 * k + k * k) if fused \
                else UNFUSED_SCAN_FLOATS * k * k + 2 * k ** 3
            if free_energy:
                floats += k * k
            per_elem += t * floats * 4 * 2
            continue
        d = block.dim
        sym = d * (d + 1) // 2
        floats = (2 * d + 2 * sym + d * d + d) if fused \
            else UNFUSED_SCAN_FLOATS * (3 * d * d + 2 * d)
        if free_energy:
            floats += FE_PAIR_FLOATS * 4 * d * d
        per_elem += t * floats * 4 * 2
    return per_elem


def batch_chunk_size(compiled, batch: int, budget_bytes: int,
                     free_energy: bool = False):
    """Largest batch chunk that fits the budget (None = no chunking
    needed).  Raises when even one element exceeds it."""
    per_elem = chain_hbm_bytes_per_element(compiled, free_energy)
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
                device: Any = "cuda", batch_hint: int | None = None) -> dict:
    """Decide, per chain block, whether the fused kernel tier applies, and
    record ``compiled._plan_report``.  ``all_finite=False`` (the batch holds
    missing observations) keeps Gaussian chains off the fused tier; discrete
    chains stream their masked evidence and stay fused.  ``batch_hint``
    (the program's batch) sizes the device-memory gate of d > 8."""
    plans: dict[str, Any] = {}
    report: dict[str, dict] = {}
    compiled._plan_report = report
    route = "cuda" if torch.device(device).type == "cuda" else "plain"
    state0 = None   # the initial state for dynamic plans' checks, built lazily
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
            plans[name] = "discrete"
            report[name] = {"fused": True, "kernel": "fused_fb",
                            "route": route}
            continue
        if type(block) is not GaussianChainBlock:
            report[name] = {
                "fused": False,
                "reason": (
                    f"{type(block).__name__} has state-dependent transition "
                    "parameters (re-assembled every sweep); XLA scan path"
                ),
            }
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
        if state0 is None:
            state0 = compiled._init_state()
        plan, note = _plan_fused_gaussian(
            block, data0, state0, batch_hint=batch_hint,
            hbm_budget=getattr(compiled, "hbm_budget", None),
            moment_dtype=getattr(compiled, "fused_moment_dtype", "float32"))
        if plan is not None:
            plans[name] = plan
            report[name] = {"fused": True, "kernel": "fused_smoother",
                            "route": route}
            dyn = [k for k, on in (("W", plan.dyn_w), ("Q", plan.dyn_q))
                   if on]
            if dyn:
                report[name]["dynamic"] = dyn
            if plan.dyn_w:
                report[name]["w_linear"] = plan.wlin is not None
                if plan.wlin is None:
                    report[name]["w_linear_reason"] = note
        else:
            report[name] = {"fused": False, "reason": note}
    unfused = {n: r["reason"] for n, r in report.items() if not r["fused"]}
    if unfused and compiled.warn and compiled.use_fused:
        details = "; ".join(f"{n}: {r}" for n, r in unfused.items())
        warnings.warn(
            "batched program: chain block(s) run off the fused kernels, on "
            f"the batched scan path — {details}. Inspect "
            "compiled.plan_report() for the full plan; silence with "
            'options={"warn": False}.', stacklevel=3)
    return plans


def _partition_shared_adjacency(block, shared: set):
    """Split a shared plain group's adjacency into REPLICATED factors
    (touching only constants and shared variables: their message is the
    same for every dataset and counts ONCE in the pooled product, e.g. the
    shared variable's prior) and PER-DATASET factors (touching data or
    latents that are not shared: their messages are summed over the batch
    in natural parameters)."""
    rep, per_ds = [], []
    for entry in block.adjacency:
        replicated = all(
            not isinstance(v, Ref)
            or (v.var.kind == "random" and v.var.name in shared)
            for v in entry[0].all_interfaces().values())
        (rep if replicated else per_ds).append(entry)
    return rep, per_ds


def _with_adjacency(blk: PlainGroup, adjacency: list) -> PlainGroup:
    """A copy of ``blk`` over part of its adjacency."""
    part = copy.copy(blk)
    part.adjacency = adjacency
    return part


def shared_groups(compiled, shared: tuple) -> dict:
    """The pooled groups of ``shared=``: each name -> (group, its
    per-dataset part, its replicated part, the number of replicated
    factors), validated as the JAX package validates them: a projecting
    form constraint (``ProjectedTo``) is refused, the pooled sum needs
    closed-form natural-parameter products.  Both parts keep the group's
    constraints (mean-field factors, forms, message forms)."""
    plain = {b.var.name: b for k, b in compiled.blocks if k == "plain"}
    shared_set = set(shared)
    groups = {}
    for nm in shared:
        if nm not in plain:
            kinds = {b.var.name: k for k, b in compiled.blocks}
            raise ValueError(
                f"shared={shared!r}: {nm!r} is "
                f"{'a ' + kinds[nm] + ' block' if nm in kinds else 'unknown'}"
                " — shared aggregation covers non-chain (conjugate "
                "parameter) variables.")
        blk = plain[nm]
        if hasattr(blk.form_constraint, "project_product"):
            raise NotImplementedError(
                f"shared variable {nm!r} has a projection form constraint; "
                "shared aggregation needs closed-form natural-parameter "
                "products.")
        rep_adj, pd_adj = _partition_shared_adjacency(blk, shared_set)
        plated_rep = [e[0] for e in rep_adj if e[0].plate is not None]
        if plated_rep:
            # a plated replicated factor adds plate-many edges to the shared
            # variable's Bethe degree; the pooled correction counts one
            # energy and one entropy share per adjacency entry
            raise NotImplementedError(
                f"shared variable {nm!r} has plated replicated factor(s) "
                f"{[f.fform for f in plated_rep]}; the pooled-FE correction "
                "assumes unplated priors — unroll the plate or move the "
                "factor's data-bearing interfaces into the batch.")
        if not pd_adj:
            raise ValueError(
                f"shared variable {nm!r} has no per-dataset factors; sharing "
                "it is a no-op.")
        groups[nm] = (blk, _with_adjacency(blk, pd_adj),
                      _with_adjacency(blk, rep_adj), len(rep_adj))
    return groups


def _first_element(state: dict, data: dict, chain_cross: dict,
                   ctx: BatchContext):
    """The batch's first dataset as a batch of one, with its context."""
    one = lambda d: {k: tree_map(lambda a: a[:1], v) for k, v in d.items()}
    return (one(state), one(data), one(chain_cross),
            BatchContext(ctx.device, 1, ctx._consts))


def _broadcast(q, batch: int):
    """A pooled posterior (no batch axis) as every dataset's."""
    return tree_map(lambda a: a.expand((batch,) + tuple(a.shape)), q)


def pooled_posterior(group: tuple, nat_total: tuple, key: str,
                     state: dict, data: dict, chain_cross: dict,
                     ctx: BatchContext):
    """A shared group's pooled q over the batch: the per-dataset messages'
    natural parameters summed over every dataset (``nat_total``, family
    ``key``) times the replicated factors' message, counted once (read at
    the first dataset), finalized and broadcast to (B, ...)."""
    blk, _, blk_rep, _ = group
    msgs = [from_natural(key, nat_total)]
    if blk_rep.adjacency:
        st1, d1, cc1, ctx1 = _first_element(state, data, chain_cross, ctx)
        msgs.append(prod_reduce(
            blk_rep.update(st1, d1, cc1, ctx1, raw_product=True), 1))
    return _broadcast(blk.finalize(prod_all(msgs)), ctx.batch)


def shared_update(group: tuple, state: dict, data: dict, chain_cross: dict,
                  ctx: BatchContext):
    """The pooled update of one shared group in a sweep (the plain-group
    entry of the sweep's update mapping): the per-dataset messages' product
    of every dataset, unfinalized, reduced over the batch."""
    carrier = group[1].update(state, data, chain_cross, ctx,
                              raw_product=True)
    total = prod_reduce(carrier, ctx.batch)
    return pooled_posterior(group, to_natural(total), family_key(total),
                            state, data, chain_cross, ctx)


def shared_fe_correction(compiled, groups: dict, state: dict, data: dict,
                         chain_cross: dict, ctx: BatchContext):
    """The per-dataset free energies count each shared variable's
    replicated factors (its prior) once PER DATASET, and one entropy share
    per replicated factor beyond the first; the pooled model counts them
    once.  With the shared variable's pooled degree B k + r, from Bethe
    FE = sum AE_a - sum H_a + sum (d_i - 1) H_i:
        sum_b fe_b - FE_pooled = (B - 1) sum_v [sum_{a in rep(v)} FFE_a
                                                + (r_v - 1) H(q_v)]."""
    st1, d1, cc1, ctx1 = _first_element(state, data, chain_cross, ctx)
    ffe_by_id = {ffe.factor.id: ffe for ffe in compiled.fe_factors}
    corr = torch.zeros((), device=ctx.device)
    for nm, (_, _, blk_rep, r) in groups.items():
        for entry in blk_rep.adjacency:
            corr = corr + ffe_by_id[entry[0].id](st1, d1, cc1, ctx1)[0]
        if r != 1:   # r == 0 (no replicated prior) contributes -H
            corr = corr + (r - 1) * st1[nm].entropy().sum()
    return corr


def concat_rows(parts: list):
    """Tensors or distributions of several chunks of a batch, joined along
    the batch axis."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts, dim=0)
    cols = list(zip(*[tree_leaves(p) for p in parts]))
    return type(first)(*[torch.cat(list(c), dim=0) for c in cols])


def _plan_updates(plans: dict, blocks: dict, qpayload,
                  moment_dtype: str) -> dict:
    """The planned chains' updates, in the blocks' update signature."""
    fused = {}
    for name, plan in plans.items():
        if plan == "discrete":
            fused[name] = (lambda st, d, cc, ctx, _b=blocks[name]:
                           _fused_discrete_update(_b, st, d, cc, ctx))
        else:
            fused[name] = (lambda st, d, cc, ctx, _b=blocks[name], _p=plan:
                           _fused_gaussian_update(_b, _p, d, ctx.batch,
                                                  qpayload, st, ctx,
                                                  moment_dtype))
    return fused


def make_batched_program(compiled, data0: dict, iterations: int,
                         free_energy: bool, keep_each: bool = False,
                         all_finite: bool = True, device: Any = "cuda",
                         batch_hint: int | None = None, shared: tuple = ()):
    """Build the function (batched_data) -> (state, fe, history) where every
    data leaf and every state leaf carries a leading batch axis.  The data
    may be numpy arrays or tensors; they are moved to ``device`` as float32.
    ``fe`` is the free energy of every dataset after every sweep,
    (iterations, B), with ``free_energy`` (else an empty (0, B) tensor).  A
    chain in the plan runs on the fused kernels; every other chain runs its
    block's batch-major update in the same sweep.  A program built on
    finite data (``all_finite=True``) skips the NaN masks, as the JAX
    package's fused tier does.  ``batch_hint``: the batch the program will
    see, for the planner's device-memory gate (``build_plans``).

    ``shared``: names of plain groups whose posterior is POOLED over the
    batch: each sweep their per-dataset messages are summed over the batch
    in natural parameters and their replicated factors (the prior) counted
    once (``shared_update``), and ``fe`` is the pooled model's Bethe free
    energy, (iterations,)."""
    if free_energy:
        # built now, so that an unported branch raises before a sweep
        _ = compiled.fe_factors
    device = torch.device(device)
    data0 = compiled._with_derived(data0)
    plans = build_plans(compiled, data0, all_finite=all_finite, device=device,
                        batch_hint=batch_hint)
    groups = shared_groups(compiled, tuple(shared)) if shared else {}
    moment_dtype = getattr(compiled, "fused_moment_dtype", "float32")
    # quantized observation ingest: the names that feed a fused Gaussian
    # plan's evidence einsum
    obs_dtype = compiled.observation_dtype
    qnames: set = set()
    if obs_dtype != "float32":
        for plan in plans.values():
            if isinstance(plan, FusedGaussianPlan):
                qnames |= set(plan.E or {})
        if not qnames and compiled.warn:
            warnings.warn(
                f'options={{"observation_dtype": "{obs_dtype}"}} has no '
                "effect: no chain block lowered to the fused linear-evidence "
                "plan (inspect compiled.plan_report()); observations stay "
                "float32.",
                stacklevel=2,
            )
    init = compiled._device_init(device)
    consts: dict = {}   # model constants on the device, kept across calls
    blocks = {block.var.name: block for kind, block in compiled.blocks}

    pooled = {nm: (lambda st, d, cc, ctx, _g=group:
                   shared_update(_g, st, d, cc, ctx))
              for nm, group in groups.items()}

    def pooled_fe(state, chain_cross, data, ctx):
        fe_b = compiled._free_energy(state, chain_cross, data, ctx)
        return fe_b.sum() - (ctx.batch - 1.0) * shared_fe_correction(
            compiled, groups, state, data, chain_cross, ctx)

    def program(data: dict):
        data, masks = compiled._device_data(data, all_finite, device)
        batch = next(iter(data.values())).shape[0]
        # once per call, not per sweep: every sweep re-reads the payload
        qpayload = {name: quantize_observations(data[name], obs_dtype)
                    for name in sorted(qnames)} or None
        if free_energy and qpayload is not None:
            # the free-energy terms must see the observations the evidence
            # saw: the dequantized payload in the observation's layout
            data = dict(data)
            for name, (vals, scales) in qpayload.items():
                data[name] = (vals.to(torch.float32) * scales).transpose(
                    1, 2).reshape(data[name].shape)
        ctx = BatchContext(device, batch, consts, masks)
        updates = _plan_updates(plans, blocks, qpayload, moment_dtype)
        updates.update(pooled)
        state, history, fe = compiled._iterate(
            data, ctx, init, iterations, keep_each, updates,
            free_energy=free_energy, fe_fn=pooled_fe if groups else None)
        return state, fe, history

    return compiled.matmul_precision.wrap(program)


def make_chunked_shared_program(compiled, data0: dict, iterations: int,
                                free_energy: bool, shared: tuple, chunk: int,
                                all_finite: bool = True,
                                device: Any = "cuda"):
    """Pooled (``shared=``) inference when the batch exceeds the chain
    moments' device budget: the batch runs as sequential chunks of
    ``chunk`` datasets, and the shared groups' per-dataset natural
    parameters are ACCUMULATED over the chunks (additive, as they are over
    the batch).  Per sweep: every chunk recomputes its chains at the current
    shared posterior and adds its datasets' natural parameters; then each
    shared posterior updates once from the total and the replicated prior,
    the unchunked sweep's order (chains come before shared parameters in the
    sweep).  The free energy is the unchunked ``pooled_fe``'s: chains at the
    pre-update shared posterior, its entropy at the post-update one, the
    pooled correction once.  Exact for the supported topology, validated
    here: every block but the shared groups is a chain that reads only data,
    constants and shared variables, so a chain's moments carry nothing from
    one sweep to the next and are not kept between chunks.  Returns
    (batched data) -> (state, fe (iterations,) or (0,), [])."""
    device = torch.device(device)
    data0 = compiled._with_derived(data0)
    plans = build_plans(compiled, data0, all_finite=all_finite,
                        device=device, batch_hint=chunk)
    shared_set = set(shared)
    for kind, block in compiled.blocks:
        name = block.var.name
        if kind == "plain" and name in shared_set:
            continue
        if kind != "chain":
            raise ValueError(
                f"infer_batched(shared=..., chunked): non-shared {kind} "
                f"block {name!r} — chunked pooled aggregation supports the "
                "hierarchical topology (per-dataset chains + shared "
                "parameters only). Shard over devices with mesh=, or raise "
                "options={'hbm_budget_bytes': ...}.")
        for f in [block.prior, block.transition] + [
                e[0] for e in block.evidence]:
            for v in f.all_interfaces().values():
                if (isinstance(v, Ref) and v.var.kind == "random"
                        and v.var.name != name
                        and v.var.name not in shared_set):
                    raise ValueError(
                        f"infer_batched(shared=..., chunked): chain {name!r}"
                        f" references non-shared random variable "
                        f"{v.var.name!r}; chunked pooled aggregation needs "
                        "chains that close over data/constants/shared "
                        "variables.")
    groups = shared_groups(compiled, tuple(shared))
    blocks = {block.var.name: block for _, block in compiled.blocks}
    updates = _plan_updates(plans, blocks, None,
                            getattr(compiled, "fused_moment_dtype",
                                    "float32"))
    init = compiled._device_init(device)
    consts: dict = {}

    def chain_pass(shared_q: dict, data: dict, ctx: BatchContext):
        state = compiled._broadcast_init(init, ctx.batch)
        state.update(shared_q)
        chain_cross: dict = {}
        for kind, block in compiled.blocks:
            name = block.var.name
            if kind == "chain":
                state[name], chain_cross[name] = updates.get(
                    name, block.update)(state, data, chain_cross, ctx)
        return state, chain_cross

    def rows_natural(carrier, n: int) -> tuple:
        """The natural parameters of a chunk's first n datasets, summed (a
        leaf without the batch axis stands for each of them)."""
        ranks = NAT_EVENT_RANKS[family_key(carrier)]
        return tuple(a[:n].sum(0) if a.ndim > r else n * a
                     for a, r in zip(to_natural(carrier), ranks))

    def program(full_data: dict):
        batch = int(np.shape(next(iter(full_data.values())))[0])
        chunks = []
        for i in range(-(-batch // chunk)):
            sl = {k: torch.as_tensor(v[i * chunk:(i + 1) * chunk],
                                     dtype=torch.float32, device=device)
                  for k, v in full_data.items()}
            n = next(iter(sl.values())).shape[0]
            if n < chunk:   # the last chunk edge-padded to the chunk's shape
                sl = {k: torch.cat([v, v[-1:].expand(
                    (chunk - n,) + tuple(v.shape[1:]))]) for k, v in
                    sl.items()}
            d, masks = compiled._device_data(sl, all_finite, device)
            chunks.append((d, BatchContext(device, chunk, consts, masks), n))
        shared_q = {nm: _broadcast(init[nm], chunk) for nm in groups}
        fes = []
        for _ in range(iterations):
            prev = shared_q
            totals: dict = {}
            for d, ctx, n in chunks:
                state, chain_cross = chain_pass(prev, d, ctx)
                for nm, group in groups.items():
                    carrier = group[1].update(state, d, chain_cross, ctx,
                                              raw_product=True)
                    part = rows_natural(carrier, n)
                    key = family_key(carrier)
                    totals[nm] = (key, part if nm not in totals else tuple(
                        a + b for a, b in zip(totals[nm][1], part)))
            d0, ctx0, _ = chunks[0]
            seed = compiled._broadcast_init(init, chunk)
            seed.update(prev)
            shared_q = {nm: pooled_posterior(groups[nm], nat, key, seed, d0,
                                             {}, ctx0)
                        for nm, (key, nat) in totals.items()}
            if free_energy:
                fe_sum = torch.zeros((), device=device)
                for d, ctx, n in chunks:
                    state, chain_cross = chain_pass(prev, d, ctx)
                    state.update(shared_q)
                    fe_sum = fe_sum + compiled._free_energy(
                        state, chain_cross, d, ctx)[:n].sum()
                seed = compiled._broadcast_init(init, chunk)
                seed.update(shared_q)
                fes.append(fe_sum - (batch - 1.0) * shared_fe_correction(
                    compiled, groups, seed, d0, {}, ctx0))
        parts = []
        for d, ctx, n in chunks:
            state, _ = chain_pass(prev, d, ctx)
            state.update(shared_q)
            parts.append({k: tree_map(lambda a: a[:n], v)
                          for k, v in state.items()})
        state = {k: concat_rows([p[k] for p in parts]) for k in parts[0]}
        fe = torch.stack(fes) if fes else torch.zeros((0,), device=device)
        return state, fe, []

    return compiled.matmul_precision.wrap(program)
