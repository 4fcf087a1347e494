"""Executable blocks of the compiled plan (counterpart of
``rxinfer_tpu/engine/blocks.py``).

Two ways of evaluating rules, chosen by the ``ctx`` argument:

* plan time (``ctx=None``): one dataset on the CPU, slots on axis 0.  The
  batched program evaluates ``GaussianChainBlock``'s plan-time methods
  (``_prior_moments``, ``_transition_params``, ``_evidence_msg``,
  ``_evidence``) this way, once, to extract the fused plan's constants
  (engine/batched.py); the chain itself is then solved by the fused smoother
  kernels.
* every sweep (``ctx`` a ``BatchContext``): the whole batch on the program's
  device, batch on axis 0 and slots on axis 1.  A value that a plated factor
  shares across its copies (a scalar group, an indexed slot, a whole data
  array) gets a unit plate axis, so that batched rules broadcast.
  ``PlainGroup.update``, ``DiscreteChainBlock._inputs`` and both chain
  blocks' ``update`` run this way, over the batch rather than under a
  per-dataset ``vmap``; ``infer`` runs one dataset as a batch of one.

Ported: ``build_q`` (with the structured ``joint`` of a chain transition from
``chain_cross``), ``resolve_iface``, ``factor_data_mask`` and
``mask_message`` (NaN observations are zero-filled by the program and their
factor copies masked out), ``in_cavity_cluster``, ``_coverage``,
``PlainGroup`` for the mean-field path (scalar groups plate-reduced, array
groups padded over their slots), ``GaussianChainBlock`` (its ``update``
with the Kalman scans of ``ops/kalman.py``) and ``DiscreteChainBlock`` (its
``update`` with ``ops/discrete_chain.py``), each solving with the
associative scans from 48 slots and the loops below.
``PlainGroup.finalize`` is the identity here: its two branches (the Wishart
inverse-scale carrier and form constraints) belong to families and
constraints that are not ported.  Not ported: the ``time_mesh`` branch of
``GaussianChainBlock.update`` (time sharding), the AR/GCV chain blocks, EP
damping of evidence messages, and the ``PlainGroup`` branches that
``engine/compile.py`` refuses when it builds a group: grid (nested-plate)
factors, cavity (EP) message stores, required-message dependencies,
mean-field splits, form and message-form constraints and function-form
fallback messages.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..dists import PointMass, pd_inverse, tree_map
from ..dists.gaussian import (
    as_mv_weighted_mean_precision,
    as_weighted_mean_precision,
)
from ..dists.natural import (
    NAT_EVENT_RANKS,
    family_key,
    from_natural,
    nat_div,
    pad_plate,
    prod_all,
    prod_reduce,
    to_natural,
)
from ..graph.ir import Const, Factor, Ref
from ..rules.registry import get_message_rule, get_node


class BatchContext:
    """What evaluating rules over the whole batch needs besides state and
    data: the device, the batch size, the model constants already on the
    device (``consts`` is kept by the program across calls, so a constant is
    copied to the device once rather than on every sweep) and the per-factor
    observation masks of a batch with missing values (factor id -> mask;
    empty when every observation is finite)."""

    def __init__(self, device, batch: int, consts: dict,
                 masks: Optional[dict] = None):
        self.device = torch.device(device)
        self.batch = batch
        self._consts = consts
        self.masks = masks or {}

    def const(self, c: Const) -> torch.Tensor:
        hit = self._consts.get(id(c))
        if hit is None:
            hit = (c, torch.as_tensor(np.asarray(c.value, np.float32),
                                      device=self.device))
            self._consts[id(c)] = hit
        return hit[1]


def _coverage(f: Factor, ref: Ref):
    """Slot range of ``ref`` as used by factor ``f``: None (whole), an int
    slot, an (lo, hi) range over the variable's axis, or 'grid'."""
    if ref.idx is None:
        return None
    if isinstance(ref.idx, tuple):
        return "grid"
    if isinstance(ref.idx, int):
        return ref.idx
    p = ref.idx.plate
    return (p.lo + ref.idx.offset, p.hi + ref.idx.offset)


def _device_of(data: dict) -> torch.device:
    for v in data.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def resolve_iface(value, f: Factor, state: dict, data: dict,
                  ctx: Optional[BatchContext] = None):
    """Resolve an interface value to a marginal: one dataset's (slots on
    axis 0) at plan time, the whole batch's (slots on axis 1) under
    ``ctx``."""
    if isinstance(value, Const):
        if ctx is not None:
            return PointMass(ctx.const(value))
        return PointMass(torch.as_tensor(np.asarray(value.value, np.float32),
                                         device=_device_of(data)))
    ref = value
    cov = _coverage(f, ref)
    if cov == "grid":
        raise NotImplementedError(
            "grid (nested-plate) interfaces are not ported yet.")
    q = PointMass(data[ref.var.name]) if ref.var.kind == "data" \
        else state[ref.var.name]
    if cov is None:
        return q
    axis = 0 if ctx is None else 1
    if isinstance(cov, int):
        return tree_map(lambda a: a.select(axis, cov), q)
    lo, hi = cov
    return tree_map(lambda a: a.narrow(axis, lo, hi - lo), q)


def build_q(f: Factor, state: dict, data: dict,
            exclude: Optional[str] = None,
            chain_cross: Optional[dict] = None,
            ctx: Optional[BatchContext] = None) -> dict:
    """The rule-input marginal dict of factor ``f`` (all interfaces but
    ``exclude``).  When ``f`` is a chain's transition and ``chain_cross``
    holds that chain's pair statistics, they ride along as ``q["joint"]``
    (the structured cluster marginal q(out, in))."""
    q = {}
    for name, v in f.all_interfaces().items():
        if name == exclude:
            continue
        x = resolve_iface(v, f, state, data, ctx)
        if (ctx is not None and f.plate is not None and isinstance(v, Ref)
                and not isinstance(_coverage(f, v), tuple)):
            # shared by every plate copy: a unit plate axis after the batch
            x = tree_map(lambda a: a.unsqueeze(1), x)
        q[name] = x
    if f.meta is not None:
        q["_meta"] = {**f.meta, "_plated": f.plate is not None}
    if chain_cross:
        in_ref = f.interfaces.get("in")
        if (isinstance(in_ref, Ref) and f.out.var is in_ref.var
                and f.out.var.name in chain_cross):
            q["joint"] = chain_cross[f.out.var.name]
    return q


def factor_data_mask(f: Factor, data: dict):
    """Per-copy observation mask of factor ``f`` over the batch (``data``
    leaves carry the batch on axis 0): 1.0 where every data interface is
    finite, 0.0 where any is NaN (missing).  Shape (B, P) for a plated
    factor, (B,) otherwise; None when the factor touches no data."""
    masks = []
    for v in f.all_interfaces().values():
        if not (isinstance(v, Ref) and v.var.kind == "data"):
            continue
        arr = data[v.var.name]
        cov = _coverage(f, v)
        if cov == "grid":
            raise NotImplementedError(
                "grid (nested-plate) interfaces are not ported yet.")
        if isinstance(cov, tuple):
            sl = arr[:, cov[0]:cov[1]]
            finite = torch.isfinite(sl).reshape(
                sl.shape[0], sl.shape[1], -1).all(-1)
        else:
            sl = arr if cov is None else arr[:, cov]
            finite = torch.isfinite(sl).reshape(sl.shape[0], -1).all(-1)
            if f.plate is not None:
                finite = finite[:, None]
        masks.append(finite)
    if not masks:
        return None
    total = masks[0]
    for m in masks[1:]:
        total = total & m
    return total.to(torch.float32)


def mask_message(msg, mask):
    """Zero the natural parameters of masked-out factor copies (zero natural
    parameters are the multiplicative identity: a missing observation
    contributes no evidence)."""
    if mask is None:
        return msg
    key = family_key(msg)
    out = []
    for n, r in zip(to_natural(msg), NAT_EVENT_RANKS[key]):
        lead = n.ndim - r
        if 0 < lead < mask.ndim:   # batched leaf shared by every plate copy
            n = n.reshape(n.shape[:lead] + (1,) * (mask.ndim - lead)
                          + n.shape[lead:])
        out.append(n * mask.reshape(mask.shape + (1,) * r))
    return from_natural(key, tuple(out))


def in_cavity_cluster(node_cls, iface: str) -> bool:
    """True when ``iface`` belongs to the node's BP cluster (``uses_cavity``
    puts every interface in it; ``cavity_cluster`` names interfaces, a
    digit-suffixed name matching its prefix)."""
    if getattr(node_cls, "uses_cavity", False):
        return True
    cluster = getattr(node_cls, "cavity_cluster", None)
    if cluster is None:
        return False
    return any(
        iface == c or (iface.startswith(c) and iface[len(c):].isdigit())
        for c in cluster
    )


class PlainGroup:
    """A non-chain random-variable group updated by conjugate VMP: q(v) is
    the product of every adjacent factor's message to v (natural-parameter
    sums), plate-reduced for a scalar group and padded over the slots for an
    array group.  ``adjacency`` lists (factor, interface, rule) with the rule
    resolved at compile time; ``engine/compile.py`` has already refused the
    branches this port lacks."""

    def __init__(self, var, adjacency: list):
        self.var = var
        self.adjacency = adjacency

    def update(self, state: dict, data: dict, chain_cross: dict,
               ctx: BatchContext):
        msgs = []
        length = self.var.length
        for f, iface, rule in self.adjacency:
            q = build_q(f, state, data, exclude=iface,
                        chain_cross=chain_cross, ctx=ctx)
            msg = mask_message(rule(q), ctx.masks.get(f.id))
            if length is None:
                if f.plate is not None:
                    msg = prod_reduce(msg, f.plate.size, batch_ndim=1)
            else:
                ref = f.out if iface == "out" else f.interfaces[iface]
                cov = _coverage(f, ref)
                lo, hi = cov if isinstance(cov, tuple) else (cov, cov + 1)
                msg = pad_plate(msg, lo, hi, length, batch_ndim=1)
            msgs.append(msg)
        return prod_all(msgs)


def _place(total: int, lo: int, hi: int, x: torch.Tensor,
           event: tuple) -> torch.Tensor:
    """Embed a message batch covering slots [lo, hi) into ``total`` slots
    (zeros elsewhere) without in-place writes, so ``torch.func.jvp`` can
    differentiate through it."""
    x = x.expand((hi - lo,) + event)
    parts = []
    if lo > 0:
        parts.append(x.new_zeros((lo,) + event))
    parts.append(x)
    if hi < total:
        parts.append(x.new_zeros((total - hi,) + event))
    return torch.cat(parts) if len(parts) > 1 else x


class GaussianChainBlock:
    """Gaussian chain: prior factor at slot 0, lag-1 linear-Gaussian
    transition over a plate, Gaussian evidence factors attached to slots.
    ``update`` solves the chain exactly over the whole batch by Kalman
    smoothing (``ops/kalman.py``): the associative-scan smoother when
    ``use_parallel`` and the chain has 48 slots or more, the sequential one
    below that."""

    def __init__(self, var, dim: int, scalar: bool, prior: Factor,
                 transition: Factor, evidence: list,
                 use_parallel: bool = True):
        self.var = var
        self.dim = dim
        self.scalar = scalar
        self.prior = prior
        self.transition = transition
        self.evidence = evidence  # (factor, chain-interface-name)
        self.use_parallel = use_parallel

    def _lift_vec(self, x):
        return x[..., None] if self.scalar else x

    def _lift_mat(self, x):
        return x[..., None, None] if self.scalar else x

    def _prior_moments(self, state, data, ctx=None):
        q = build_q(self.prior, state, data, exclude="out", ctx=ctx)
        msg = get_message_rule(self.prior.fform, "out")(q)
        if self.scalar:
            m0 = self._lift_vec(msg.mean())
            p0 = self._lift_mat(msg.var())
        else:
            m0, p0 = msg.mean(), msg.cov()
        # float32 guard: a state-fed prior noise can give P0 ~ 1e9+, whose
        # cancellation leaves negative smoothed variances; cap at ~1e4
        if any(
            isinstance(self.prior.interfaces.get(k), Ref)
            and self.prior.interfaces[k].var.kind == "random"
            for k in ("prec", "var", "cov")
        ):
            d = p0.shape[-1]
            p0 = pd_inverse(pd_inverse(p0) + 1e-4 * torch.eye(
                d, dtype=p0.dtype, device=p0.device))
        return m0, p0

    def _transition_params(self, state, data, length, ctx=None):
        """A, b, Q of the T-1 transitions, (..., T-1, d, d) and (..., T-1, d):
        no leading axes when they are constants, the batch's under ``ctx``
        when the noise is a random variable's marginal."""
        f = self.transition
        dev = _device_of(data) if ctx is None else ctx.device

        def const(name, default):
            v = f.interfaces.get(name)
            if not isinstance(v, Const):
                return torch.as_tensor(default, device=dev)
            if ctx is not None:
                return ctx.const(v)
            return torch.as_tensor(np.asarray(v.value, np.float32),
                                   device=dev)

        a = const("A", np.eye(self.dim, dtype=np.float32))
        if self.scalar and a.ndim == 0:
            a = a[None, None]
        b = const("b", np.float32(0.0))
        if self.scalar and b.ndim == 0:
            b = b[None]
        if not self.scalar and b.ndim == 0:
            b = torch.zeros((self.dim,), device=dev)
        if "cov" in f.interfaces or "var" in f.interfaces:
            noise = f.interfaces.get("cov", f.interfaces.get("var"))
            nq = resolve_iface(noise, f, state, data, ctx)
            qv = nq.point if isinstance(nq, PointMass) else nq.mean()
            q_cov = self._lift_mat(qv)
        else:
            from ..rules.expectations import e_precision

            nq = resolve_iface(f.interfaces["prec"], f, state, data, ctx)
            w = self._lift_mat(e_precision(nq))
            if not isinstance(nq, PointMass):
                # float32 guard: a near-zero expected precision gives
                # Q ~ 1e9+; Q <= 1e4 keeps roundoff ~1e-3 while staying vague
                d = w.shape[-1]
                w = w + 1e-4 * torch.eye(d, dtype=w.dtype, device=w.device)
            q_cov = pd_inverse(w)
        tm1 = length - 1
        steps = lambda x, ev: x.unsqueeze(-ev - 1).expand(
            x.shape[:-ev] + (tm1,) + x.shape[-ev:])
        return steps(a, 2), steps(b, 1), steps(q_cov, 2)

    def _evidence_msg(self, f, iface, state, data, ctx=None):
        """One evidence factor's Gaussian message to the chain as lifted
        information-form tensors ``(mxi, mw, coverage)``."""
        rule = get_message_rule(f.fform, iface)
        node_cls = get_node(f.fform)
        needs_self = (getattr(node_cls, "needs_self_marginal", False)
                      and self.var.name in state)
        q = build_q(f, state, data, exclude=None if needs_self else iface,
                    ctx=ctx)
        if in_cavity_cluster(node_cls, iface):
            # EP cavity: same-cluster random neighbours are divided by this
            # factor's stored message (none on the static tier, where every
            # other interface is a constant or data)
            for name, v in f.all_interfaces().items():
                if name == iface or name not in q:
                    continue
                if not in_cavity_cluster(node_cls, name):
                    continue
                key = f"_msg:{f.id}:{name}"
                if isinstance(v, Ref) and v.var.kind == "random" \
                        and key in state:
                    q[name] = nat_div(q[name], state[key])
        if (f.meta or {}).get("damping"):
            raise NotImplementedError(
                "damped evidence messages are not ported yet.")
        msg = rule(q)
        if self.scalar:
            m = as_weighted_mean_precision(msg)
            mxi, mw = self._lift_vec(m.xi), self._lift_mat(m.w)
        else:
            m = as_mv_weighted_mean_precision(msg)
            mxi, mw = m.xi, m.w
        ref = f.out if iface == "out" else f.interfaces[iface]
        return mxi, mw, _coverage(f, ref)

    def _evidence(self, state, data, length):
        """Per-slot evidence information vectors xi (T, d) and precisions
        W (T, d, d): the sum of every evidence factor's message."""
        d = self.dim
        dev = _device_of(data)
        xi = torch.zeros((length, d), device=dev)
        w = torch.zeros((length, d, d), device=dev)
        for f, iface in self.evidence:
            mxi, mw, cov = self._evidence_msg(f, iface, state, data)
            if isinstance(cov, tuple):
                lo, hi = cov
            elif isinstance(cov, int):
                lo, hi = cov, cov + 1
                mxi, mw = mxi[None], mw[None]
            else:
                raise AssertionError("chain evidence must be indexed")
            xi = xi + _place(length, lo, hi, mxi, (d,))
            w = w + _place(length, lo, hi, mw, (d, d))
        return xi, w

    def _evidence_batch(self, state, data, ctx: BatchContext):
        """The batch's evidence xi (B, T, d) and W (B, T, d, d), masked
        where an observation is missing (zero natural parameters: no
        evidence)."""
        d, length = self.dim, self.var.length
        xi = torch.zeros((ctx.batch, length, d), device=ctx.device)
        w = torch.zeros((ctx.batch, length, d, d), device=ctx.device)
        for f, iface in self.evidence:
            mxi, mw, cov = self._evidence_msg(f, iface, state, data, ctx)
            mask = ctx.masks.get(f.id)
            if mask is not None:
                mxi = mxi * mask.reshape(mask.shape + (1,))
                mw = mw * mask.reshape(mask.shape + (1, 1))
            if isinstance(cov, tuple):
                slots = slice(*cov)
            elif isinstance(cov, int):
                slots = cov
            else:
                raise AssertionError("chain evidence must be indexed")
            xi[:, slots] += mxi
            w[:, slots] += mw
        return xi, w

    def update(self, state: dict, data: dict, chain_cross: dict,
               ctx: BatchContext):
        """The chain's marginal over the batch and its rule-ready pair
        statistics Cov(out, in) (B, T-1, d, d) (scalar chains (B, T-1))."""
        from ..dists import MvNormalMeanCovariance, NormalMeanVariance
        from ..ops.kalman import (
            ChainParams,
            parallel_smoother,
            sequential_smoother,
        )

        d, length = self.dim, self.var.length
        m0, p0 = self._prior_moments(state, data, ctx)
        a, b, q = self._transition_params(state, data, length, ctx)
        xi, w = self._evidence_batch(state, data, ctx)
        params = ChainParams(m0.expand(ctx.batch, d),
                             p0.expand(ctx.batch, d, d), a, b, q, xi, w)
        solver = (parallel_smoother if self.use_parallel and length >= 48
                  else sequential_smoother)
        res = solver(params)
        if self.scalar:
            return (NormalMeanVariance(res.means[..., 0], res.covs[..., 0, 0]),
                    res.cross[..., 0, 0])
        # engine convention: chain_cross stores Cov(out, in), the transpose
        # of the smoother's Cov(x_t, x_{t+1})
        return (MvNormalMeanCovariance(res.means, res.covs),
                res.cross.transpose(-1, -2))


class DiscreteChainBlock:
    """Exact discrete-chain block (HMM backbone): forward-backward given the
    expected log-potentials of its neighbours (structured VMP).  The batched
    program hands ``_inputs`` to the fused forward-backward kernels
    (engine/batched.py); ``update`` solves the chain over the batch with
    ``ops/discrete_chain.py`` instead (the scan version when ``use_parallel``
    and the chain has 48 slots or more)."""

    def __init__(self, var, k: int, prior: Factor, transition: Factor,
                 evidence: list, use_parallel: bool = True):
        self.var = var
        self.k = k
        self.prior = prior
        self.transition = transition
        self.evidence = evidence  # (factor, chain-interface-name)
        self.use_parallel = use_parallel

    def update(self, state: dict, data: dict, chain_cross: dict,
               ctx: BatchContext):
        """The chain's marginal over the batch (B, T, K) and its pair
        marginals (B, T-1, K, K) in [out, in] order."""
        from ..dists import Categorical
        from ..ops.discrete_chain import (
            forward_backward,
            parallel_forward_backward,
        )

        length, k = self.var.length, self.k
        lp, elog_a, le_t = self._inputs(state, data, chain_cross, ctx)
        log_trans = elog_a[:, None].expand(ctx.batch, length - 1, k, k)
        solver = (parallel_forward_backward
                  if self.use_parallel and length >= 48 else forward_backward)
        res = solver(lp, log_trans, le_t.transpose(0, 1))
        return (Categorical(torch.log(torch.clamp(res.gammas, min=1e-37))),
                res.xis)

    def _inputs(self, state: dict, data: dict, chain_cross: dict,
                ctx: BatchContext):
        """log_prior (B, K), E[log A] (B, K, K) in [out, in] order and
        log-evidence (T, B, K) over the whole batch, each contiguous: the
        layout the forward-backward kernels read."""
        batch, k, length = ctx.batch, self.k, self.var.length
        q = build_q(self.prior, state, data, exclude="out", ctx=ctx)
        prior_msg = get_message_rule(self.prior.fform, "out")(q)
        log_prior = prior_msg.logits.expand(batch, k).contiguous()

        f = self.transition
        mq = resolve_iface(f.interfaces["matrix"], f, state, data, ctx)
        if isinstance(mq, PointMass):
            elog_a = torch.log(torch.clamp(mq.point, min=1e-37))
        else:
            elog_a = mq.mean_log()
        elog_a = elog_a.expand(batch, k, k).contiguous()

        log_ev = None
        for ef, iface in self.evidence:
            rule = get_message_rule(ef.fform, iface)
            eq = build_q(ef, state, data, exclude=iface,
                         chain_cross=chain_cross, ctx=ctx)
            logits = rule(eq).logits
            mask = ctx.masks.get(ef.id)
            if mask is not None:
                logits = logits * mask[..., None]
            ref = ef.out if iface == "out" else ef.interfaces[iface]
            cov = _coverage(ef, ref)
            if isinstance(cov, tuple):
                lo, hi = cov
            else:
                lo, hi = cov, cov + 1
                logits = logits.unsqueeze(-2)
            term = logits.expand(batch, hi - lo, k).transpose(0, 1)
            if lo > 0 or hi < length:
                term = torch.cat([term.new_zeros((lo, batch, k)), term,
                                  term.new_zeros((length - hi, batch, k))])
            log_ev = term if log_ev is None else log_ev + term
        if log_ev is None:
            log_ev = torch.zeros((length, batch, k), device=ctx.device)
        return log_prior, elog_a, log_ev.contiguous()
