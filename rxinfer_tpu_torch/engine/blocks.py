"""Executable blocks of the compiled plan (counterpart of
``rxinfer_tpu/engine/blocks.py``).

Every rule is evaluated over a batch (``ctx``, a ``BatchContext``): batch
on axis 0 and slots on axis 1.  A value that a plated factor shares across
its copies (a scalar group, an indexed slot, a whole data array) gets a
unit plate axis, so that batched rules broadcast.  ``PlainGroup.update``,
``DiscreteChainBlock._inputs`` and the chain blocks' ``update`` run this
way over the whole batch on the program's device rather than under a
per-dataset ``vmap``; ``infer`` runs one dataset as a batch of one, and the
batched program's plan-time probes (engine/batched.py) evaluate
``GaussianChainBlock``'s ``_prior_moments``, ``_transition_params`` and
``_evidence_batch`` on one dataset as a batch of one on the CPU
(``cpu_context``), once, to extract the fused plan's constants.

Ported: ``build_q`` (with the structured ``joint`` of a chain transition from
``chain_cross``, and of a single-step GCV factor from its stored cavity
messages, ``attach_gcv_pair_cross``), ``resolve_iface``,
``factor_data_mask`` and ``mask_message`` (NaN observations are zero-filled
by the program and their factor copies masked out), ``in_cavity_cluster``,
``_coverage``, ``divide_cavities``, ``PlainGroup`` (scalar groups
plate-reduced, array groups padded over their slots; a rule that reads its
own marginal sees it once the group has one; the EP cavity store of every
node that declares ``cavity_cluster`` or ``uses_cavity`` (the deterministic
``Sum`` / ``LinComb`` among them), which a mean-field factor skips; the
required message on a factor's own edge, ``require_message``; form and
message-form constraints; function-form fallback messages, which a
projecting form must absorb),
``GaussianChainBlock`` (its ``update`` with the
Kalman scans of ``ops/kalman.py``, its evidence with the damping of
``meta={...: {"damping": lam}}`` and the cavity store of its evidence
factors' clusters), ``GCVChainBlock`` and ``ARChainBlock``
(per-chain transitions re-assembled from the state every sweep, on the same
scans) and ``DiscreteChainBlock`` (its ``update`` with
``ops/discrete_chain.py``), each solving with the associative scans from 48
slots and the loops below.
``PlainGroup.update`` ends with ``PlainGroup.finalize``: a product in the
Wishart inverse-scale carrier becomes a ``Wishart``, then the form
constraint applies; with ``raw_product`` it returns the product before
it, for pooled ``shared=`` sums.  The cavity stores are state entries
``_msg:<factor id>:<interface>``, as in the JAX package.
A nested-plate factor's copy grid (``_grid``) sits after the batch axis:
a grid slot ``y[i, j]`` / ``z[i, j]`` resolves to the whole (B, N, M, ...)
array, a single-axis slot gets unit axes for the other plates
(``_expand_for_grid``), and ``PlainGroup._grid_message`` broadcasts the
factor's messages to the whole grid, masks them and product-reduces the
axes that do not index the group; such a factor takes plain VMP, with no
cavity store.
Not ported: the ``time_mesh`` branch of ``GaussianChainBlock.update``
(time sharding).
As in the JAX package, a required-message dependency acts on plain groups
only: a chain's evidence factor reads the chain's marginal.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..dists import (
    PointMass,
    WishartInverseScale,
    pd_inverse,
    tree_leaves,
    tree_map,
)
from ..dists.gaussian import (
    ScalarGaussians,
    as_mv_weighted_mean_precision,
    as_weighted_mean_precision,
)
from ..dists.natural import (
    NAT_EVENT_RANKS,
    broadcast_batch,
    coerce_message_family,
    family_key,
    from_natural,
    nat_div,
    pad_plate,
    prod_all,
    prod_reduce,
    prod_reduce_axes,
    to_natural,
)
from ..graph.ir import Const, Factor, Ref, SymIndex
from ..rules.registry import get_message_rule, get_node, trace_messages


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


def _grid(f: Factor) -> Optional[tuple]:
    """The copy grid of a nested-plate factor, one size per plate, outer
    first (None for one plate or none)."""
    plates = getattr(f, "plates", ())
    if len(plates) < 2:
        return None
    return tuple(p.size for p in plates)


def _plate_axes(f: Factor) -> int:
    """The copy axes of a plated factor after the batch axis: one a nested
    plate."""
    return max(1, len(getattr(f, "plates", ())))


def _grid_pos(f: Factor, ref: Ref) -> int:
    """The axis of ``f``'s copy grid that the plate indexing ``ref`` is."""
    return [p.id for p in f.plates].index(ref.idx.plate.id)


def _expand_for_grid(x, f: Factor, ref: Ref):
    """Unit axes inserted after the batch axis, so that a single-axis
    marginal, covariate or mask lines up with its own plate's axis of the
    factor's copy grid."""
    pos = _grid_pos(f, ref)
    for ax in range(len(_grid(f))):
        if ax != pos:
            x = tree_map(lambda a, _d=1 + ax: a.unsqueeze(_d), x)
    return x


def cpu_context() -> "BatchContext":
    """The context of a batch of one on the CPU: how the batched program's
    plan-time probes (engine/batched.py) evaluate one dataset's rules."""
    return BatchContext(torch.device("cpu"), 1, {})


def resolve_iface(value, f: Factor, state: dict, data: dict,
                  ctx: BatchContext):
    """Resolve an interface value to a marginal over the batch (batch on
    axis 0, slots on axis 1)."""
    if isinstance(value, Const):
        return PointMass(ctx.const(value))
    ref = value
    cov = _coverage(f, ref)
    q = PointMass(data[ref.var.name]) if ref.var.kind == "data" \
        else state[ref.var.name]
    if cov is None or cov == "grid":
        # a grid slot y[i, j] / z[i, j] is the whole (B, N, M, ...) array
        return q
    if isinstance(cov, int):
        return tree_map(lambda a: a.select(1, cov), q)
    lo, hi = cov
    q = tree_map(lambda a: a.narrow(1, lo, hi - lo), q)
    if _grid(f) is not None:
        q = _expand_for_grid(q, f, ref)
    return q


def build_q(f: Factor, state: dict, data: dict,
            exclude: Optional[str] = None,
            chain_cross: Optional[dict] = None, *,
            ctx: BatchContext) -> dict:
    """The rule-input marginal dict of factor ``f`` (all interfaces but
    ``exclude``) over the batch.  A value that a plated factor shares
    across its copies gets a unit plate axis after the batch axis.  When
    ``f`` is a chain's transition and ``chain_cross`` holds that chain's
    pair statistics, they ride along as ``q["joint"]`` (the structured
    cluster marginal q(out, in))."""
    q = {}
    for name, v in f.all_interfaces().items():
        if name == exclude:
            continue
        q[name] = factor_marginal(f, v, state, data, ctx)
    if f.meta is not None:
        q["_meta"] = {**f.meta, "_plated": f.plate is not None}
    if chain_cross:
        in_ref = f.interfaces.get("in")
        if (isinstance(in_ref, Ref) and f.out.var is in_ref.var
                and f.out.var.name in chain_cross):
            q["joint"] = chain_cross[f.out.var.name]
    if "joint" not in q:
        attach_gcv_pair_cross(q, f, state)
    return q


def factor_marginal(f: Factor, v, state: dict, data: dict,
                    ctx: BatchContext):
    """The marginal at one interface value ``v`` of ``f`` as ``build_q``
    hands it to a rule: a value that a plated factor shares across its
    copies gets a unit plate axis after the batch axis."""
    x = resolve_iface(v, f, state, data, ctx)
    if f.plate is not None and isinstance(v, Ref):
        cov = _coverage(f, v)
        if cov is None or isinstance(cov, int):
            for _ in range(_plate_axes(f)):
                x = tree_map(lambda a: a.unsqueeze(1), x)
    return x


def require_message(f: Factor, iface: str, q: dict, state: dict,
                    data: dict, ctx: BatchContext) -> bool:
    """A ``RequireMessage`` dependency on ``f``'s own edge ``iface`` (the
    reference's ``RequireMessageFunctionalDependencies``): the rule reads
    the inbound message there, the marginal divided by the factor's
    previous message (``_msg:<factor id>:<interface>``), seeded on the
    first sweep by the message the model gave (a ``None`` seed leaves the
    rule without it).  Returns whether the edge has the dependency, so that
    its message is stored."""
    deps = f.dependencies
    if deps is None or iface not in deps.interfaces:
        return False
    key = f"_msg:{f.id}:{iface}"
    if key in state:
        own = factor_marginal(f, f.all_interfaces()[iface], state, data, ctx)
        q[iface] = nat_div(own, state[key])
    elif deps.interfaces[iface] is not None:
        q[iface] = tree_map(
            lambda a: torch.as_tensor(a, dtype=torch.float32,
                                      device=ctx.device),
            deps.interfaces[iface])
    return True


def attach_gcv_pair_cross(q: dict, f: Factor, state: dict) -> None:
    """Structured single-step GCV: Cov(out, in) of the cluster q(out, in)
    from the stored cavity messages and the expected volatility precision
    w, attached as ``q["joint"]``.  The pair's joint precision is
    [[w_out_cav + w, -w], [-w, w_in_cav + w]], so Cov(out, in) =
    w / det.  This is the reference HGF constraint ``q(xt, zt, xt_min) =
    q(xt, xt_min)q(zt)`` on a GCV factor that is not a chain's transition
    (a chain's carries its exact cross in ``chain_cross``); a mean-field
    factor stores no cavity messages, so it gets none."""
    if f.fform != "GCV" or "out" not in q or "in" not in q or "z" not in q:
        return
    ko, ki = f"_msg:{f.id}:out", f"_msg:{f.id}:in"
    if ko not in state or ki not in state:
        return
    from ..rules.gcv import expected_precision

    w_o = as_weighted_mean_precision(nat_div(q["out"], state[ko])).w
    w_i = as_weighted_mean_precision(nat_div(q["in"], state[ki])).w
    wbar = expected_precision(q)
    det = (w_o + wbar) * (w_i + wbar) - wbar * wbar
    q["joint"] = wbar / det


def factor_data_mask(f: Factor, data: dict):
    """Per-copy observation mask of factor ``f`` over the batch (``data``
    leaves carry the batch on axis 0): 1.0 where every data interface is
    finite, 0.0 where any is NaN (missing).  Shape (B, P) for a plated
    factor, (B,) + (the copy grid's axes, unit where a data interface does
    not index them) for a nested-plate one, (B,) otherwise; None when the
    factor touches no data."""
    masks = []
    for v in f.all_interfaces().values():
        if not (isinstance(v, Ref) and v.var.kind == "data"):
            continue
        arr = data[v.var.name]
        cov = _coverage(f, v)
        grid = _grid(f)
        if cov == "grid":
            lead = 1 + len(v.idx)
            finite = torch.isfinite(arr).reshape(
                arr.shape[:lead] + (-1,)).all(-1)
        elif isinstance(cov, tuple):
            sl = arr[:, cov[0]:cov[1]]
            finite = torch.isfinite(sl).reshape(
                sl.shape[0], sl.shape[1], -1).all(-1)
            if grid is not None:
                finite = _expand_for_grid(finite, f, v)
        else:
            sl = arr if cov is None else arr[:, cov]
            finite = torch.isfinite(sl).reshape(sl.shape[0], -1).all(-1)
            if f.plate is not None:
                finite = finite.reshape(finite.shape + (1,) * _plate_axes(f))
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


def with_batch_axis(d, batch: int, plated: bool = False):
    """``d`` with the batch axis on every natural-parameter leaf (and,
    ``plated``, a plate or slot axis after it): a leaf computed from
    constants alone lacks it and is broadcast (a view), so that a stored
    message or a marginal leads with the batch whatever its inputs.  A
    distribution without a natural-parameter view (a mixture) is returned
    as it is, and so is one whose leaves all have the axes."""
    try:
        key = family_key(d)
    except TypeError:
        return d
    need = 2 if plated else 1
    ranks = NAT_EVENT_RANKS[key]
    # every family's fields have its natural leaves' ranks, in their order:
    # the shapes are read without computing anything
    leaves = tree_leaves(d)
    if len(leaves) == len(ranks) and all(
            a.ndim - r >= need for a, r in zip(leaves, ranks)):
        return d
    nat = to_natural(d)
    if all(n.ndim - r >= need for n, r in zip(nat, ranks)):
        # the natural leaves have the axes where a field lacks them (a
        # constant mean beside a batched variance)
        return from_natural(key, nat)
    out = []
    for n, r in zip(nat, ranks):
        if n.ndim - r < need:
            if need == 2 and n.ndim == r:
                n = n.unsqueeze(0)          # shared by every copy
            n = n.expand((batch,) + tuple(n.shape))
        out.append(n)
    return from_natural(key, tuple(out))


def divide_cavities(f: Factor, iface: str, q: dict, state: dict,
                    node_cls) -> None:
    """The EP cavity of a factor's rule towards ``iface``: each other random
    interface of its BP cluster sees its marginal divided by the factor's
    last message there (``_msg:<factor id>:<interface>`` in the state, once
    there is one), so that the rule reads messages, not beliefs."""
    for name, v in f.all_interfaces().items():
        if name == iface or name not in q:
            continue
        if not in_cavity_cluster(node_cls, name):
            continue
        key = f"_msg:{f.id}:{name}"
        if isinstance(v, Ref) and v.var.kind == "random" and key in state:
            q[name] = nat_div(q[name], state[key])


class PlainGroup:
    """A non-chain random-variable group updated by conjugate VMP: q(v) is
    the product of every adjacent factor's message to v (natural-parameter
    sums), plate-reduced for a scalar group and padded over the slots for an
    array group.  ``adjacency`` lists (factor, interface, rule) with the rule
    resolved at compile time (the mean-field ``vmp_`` variant of a factor in
    ``mf_ids``, a ``NodeFunctionRuleFallback`` rule where the node has
    none); ``engine/compile.py`` has already refused the branches this port
    lacks.  A factor outside ``mf_ids`` whose node declares this interface
    in its BP cluster (``in_cavity_cluster``) sees, on the other random
    edges of its cluster, the marginal divided by its last message there
    (``divide_cavities``), and keeps its message to this group in the state
    under ``_msg:<factor id>:<interface>``.  A rule that reads its own
    marginal (``needs_self_marginal``) sees it once the group has one.
    Messages are coerced to the group's ``family`` (a two-class Categorical
    to a Bernoulli).  ``message_form`` constrains each inbound message
    before the product (mu(x)::C), ``form_constraint`` the product (q(x)::C;
    a projecting one, such as ``ProjectedTo``, takes the messages
    themselves and the previous marginal as its warm start)."""

    def __init__(self, var, adjacency: list, family=None,
                 form_constraint=None, mf_ids=None, message_form=None,
                 event_ndim: int = 0):
        self.var = var
        self.adjacency = adjacency
        self.family = family
        self.form_constraint = form_constraint
        self.mf_ids = frozenset(mf_ids or ())
        self.message_form = message_form
        self.event_ndim = event_ndim

    def finalize(self, q):
        """The family conversion and form constraint of a message product
        (split out of ``update`` so that pooled ``shared=`` aggregation can
        sum the products over the batch before it): a product in the
        Wishart inverse-scale carrier becomes a ``Wishart``."""
        if isinstance(q, WishartInverseScale):
            q = q.to_wishart()
        if self.form_constraint is not None:
            q = self.form_constraint.constrain(q)
        return q

    def update(self, state: dict, data: dict, chain_cross: dict,
               ctx: BatchContext, raw_product: bool = False):
        """q(v) over the batch; with ``raw_product`` the product of the
        messages before ``finalize`` (a conjugate carrier such as the
        Wishart inverse-scale one, summed over the batch before it is
        normalized)."""
        from ..dists import LogPdfMessage
        from ..dists.base import ProductError

        msgs = []
        length = self.var.length
        for f, iface, rule in self.adjacency:
            node_cls = get_node(f.fform)
            # a rule that reads its own marginal (GCV's message to z, a
            # delta's backward rules) sees it once this group has one
            # (initialization or a sweep)
            needs_self = (getattr(node_cls, "needs_self_marginal", False)
                          and self.var.name in state)
            q = build_q(f, state, data, exclude=None if needs_self else iface,
                        chain_cross=chain_cross, ctx=ctx)
            grid = _grid(f)
            # a nested-plate factor takes plain VMP, no cavity store (its
            # outputs are observations or grid slots, where the cavity is a
            # no-op on trees), as in the JAX package
            cavity = (f.id not in self.mf_ids and grid is None
                      and in_cavity_cluster(node_cls, iface))
            if cavity:
                divide_cavities(f, iface, q, state, node_cls)
            required = require_message(f, iface, q, state, data, ctx)
            trace_messages.record(node=f.fform, interface=iface,
                                  mean_field=f.id in self.mf_ids)
            raw = coerce_message_family(rule(q), self.family)
            if isinstance(raw, LogPdfMessage):
                # function-form fallback: the plate is folded into its
                # log-density; a form constraint must project it
                msgs.append(raw)
                continue
            if tree_leaves(raw)[0].device != ctx.device:
                # a message of no input at all (the flat Uninformative
                # prior's) is made on the CPU
                raw = tree_map(lambda a: a.to(ctx.device), raw)
            if grid is not None:
                msgs.append(self._grid_message(f, iface, raw, grid, ctx))
                continue
            msg = mask_message(raw, ctx.masks.get(f.id))
            if cavity or required:
                state[f"_msg:{f.id}:{iface}"] = with_batch_axis(
                    msg, ctx.batch, f.plate is not None)
            if length is None:
                if f.plate is not None:
                    msg = prod_reduce(msg, f.plate.size, batch_ndim=1)
            else:
                ref = f.out if iface == "out" else f.interfaces[iface]
                cov = _coverage(f, ref)
                lo, hi = cov if isinstance(cov, tuple) else (cov, cov + 1)
                msg = pad_plate(msg, lo, hi, length, batch_ndim=1)
            msgs.append(msg)
        mform = self.message_form
        if mform is not None:
            # mu(x)::C on each inbound message; a projecting constraint
            # absorbs fallback messages too
            if hasattr(mform, "project_product"):
                msgs = [mform.project_product([m]) for m in msgs]
            else:
                msgs = [m if isinstance(m, LogPdfMessage)
                        else mform.constrain(m) for m in msgs]
        if self.form_constraint is not None and hasattr(
                self.form_constraint, "project_product"):
            # a product without a closed form, projected; the previous
            # sweep's marginal warm-starts it (the reference's
            # ProjectionContext)
            return self._batched(self.form_constraint.project_product(
                msgs, prev=state.get(self.var.name)), ctx.batch)
        if any(isinstance(m, LogPdfMessage) for m in msgs):
            raise ProductError(
                f"Variable {self.var.name} receives a function-form fallback "
                "message (NodeFunctionRuleFallback); add a functional-form "
                "constraint for it, e.g. constraints(forms={"
                f"{self.var.name!r}: ProjectedTo(...)}}) — the reference "
                "likewise requires q(x)::ProjectedTo(...) with the fallback "
                "(docs/src/manuals/inference/undefinedrules.md).")
        q = prod_all(msgs)
        if raw_product:
            return q
        return self._batched(self.finalize(q), ctx.batch)

    def _grid_message(self, f: Factor, iface: str, raw, grid: tuple,
                      ctx: BatchContext):
        """A nested-plate factor's message to this group: broadcast to the
        whole (B,) + grid batch of copies, masked, then product-reduced over
        every grid axis that does not index this variable (a grid latent
        keeps one message per slot; an array group is padded over its
        slots)."""
        msg = broadcast_batch(raw, (ctx.batch,) + grid)
        msg = mask_message(msg, ctx.masks.get(f.id))
        ref = f.out if iface == "out" else f.interfaces[iface]
        if self.var.grid_axes:
            if not isinstance(ref.idx, tuple):
                raise NotImplementedError(
                    f"Grid latent {self.var.name} must be referenced with a "
                    f"full grid index (factor {f.fform}).")
            plate_ids = [p.id for p in f.plates]
            pos = [plate_ids.index(k.plate.id) for k in ref.idx]
            if pos != sorted(pos):
                raise NotImplementedError(
                    f"Grid latent {self.var.name}: transposed use inside "
                    f"factor {f.fform} is not supported.")
            other = [1 + ax for ax in range(len(grid)) if ax not in pos]
            return prod_reduce_axes(msg, other) if other else msg
        if self.var.length is None:
            return prod_reduce_axes(msg, range(1, len(grid) + 1))
        if not isinstance(ref.idx, SymIndex):
            raise NotImplementedError(
                f"Array group {self.var.name}: grid factor {f.fform} must "
                "index it by a plate symbol.")
        pos = _grid_pos(f, ref)
        lo, hi = _coverage(f, ref)
        msg = prod_reduce_axes(
            msg, [1 + ax for ax in range(len(grid)) if ax != pos])
        return pad_plate(msg, lo, hi, self.var.length, batch_ndim=1)

    def _batched(self, q, batch: int):
        """The marginal with the batch axis on every leaf: a product of
        messages computed from constants alone (mean-field rules), a pinned
        or collapsed form (``FixedMarginalFormConstraint``, a point mass of
        constants) lacks it on some."""
        from ..dists import SampleList

        need = 1 if self.var.length is None else 2
        expand = lambda a, lead: a.expand((batch,) + tuple(a.shape)) \
            if lead < need else a
        if isinstance(q, PointMass):
            return PointMass(expand(q.point, q.point.ndim - self.event_ndim))
        if isinstance(q, SampleList):
            lead = q.log_weights.ndim - 1
            return SampleList(expand(q.samples, lead),
                              expand(q.log_weights, lead))
        return with_batch_axis(q, batch, self.var.length is not None)


class GaussianChainBlock:
    """Gaussian chain: prior factor at slot 0, lag-1 linear-Gaussian
    transition over a plate, Gaussian evidence factors attached to slots.
    ``update`` solves the chain exactly over the whole batch by Kalman
    smoothing (``ops/kalman.py``): the associative-scan smoother when
    ``use_parallel`` and the chain has 48 slots or more, the sequential one
    below that.  The methods that assemble its parameters take the batch's
    ``BatchContext``; without one they evaluate a batch of one on the CPU
    (``cpu_context``), as the batched program's plan-time probes do."""

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
        ctx = ctx or cpu_context()
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

    def _steps(self, a, b, q, length):
        """A, b, Q broadcast over the T-1 transitions: (..., T-1, d, d) and
        (..., T-1, d), expanded views of the one-step values."""
        tm1 = length - 1
        steps = lambda x, ev: x.unsqueeze(-ev - 1).expand(
            x.shape[:-ev] + (tm1,) + x.shape[-ev:])
        return steps(a, 2), steps(b, 1), steps(q, 2)

    def _transition_params(self, state, data, length, ctx=None):
        """A, b, Q of the T-1 transitions, (..., T-1, d, d) and (..., T-1, d):
        no leading axes when they are constants, the batch's when the noise
        is a random variable's marginal."""
        ctx = ctx or cpu_context()
        f = self.transition

        def const(name, default):
            v = f.interfaces.get(name)
            if not isinstance(v, Const):
                return torch.as_tensor(default, device=ctx.device)
            return ctx.const(v)

        a = const("A", np.eye(self.dim, dtype=np.float32))
        if self.scalar and a.ndim == 0:
            a = a[None, None]
        b = const("b", np.float32(0.0))
        if self.scalar and b.ndim == 0:
            b = b[None]
        if not self.scalar and b.ndim == 0:
            b = torch.zeros((self.dim,), device=ctx.device)
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
        return self._steps(a, b, q_cov, length)

    def _evidence_msg(self, f, iface, state, data, ctx=None,
                      chain_cross=None):
        """One evidence factor's Gaussian message to the chain as lifted
        information-form tensors ``(mxi, mw, coverage)``.  A rule that
        reads its own marginal (``needs_self_marginal``: GCV's message to
        z, a delta's backward rules) sees the chain's current marginal once
        it has one, and a chain transition's pair statistics ride along
        (``chain_cross``).  A factor whose node declares ``iface`` in its
        BP cluster divides the other random interfaces of the cluster by
        its stored messages
        (``divide_cavities``) and keeps this message in the state under
        ``_msg:<factor id>:<interface>`` for its neighbours.  With
        ``meta={...: {"damping": lam}}`` the message is blended with the
        previous sweep's in natural parameters, (1 - lam) new + lam old,
        and stored in the state under ``_msg:<factor id>:<interface>``."""
        ctx = ctx or cpu_context()
        rule = get_message_rule(f.fform, iface)
        node_cls = get_node(f.fform)
        needs_self = (getattr(node_cls, "needs_self_marginal", False)
                      and self.var.name in state)
        q = build_q(f, state, data, exclude=None if needs_self else iface,
                    chain_cross=chain_cross, ctx=ctx)
        uses_cavity = in_cavity_cluster(node_cls, iface)
        if uses_cavity:
            # EP cavity: same-cluster random neighbours are divided by this
            # factor's stored messages
            divide_cavities(f, iface, q, state, node_cls)
        msg = rule(q)
        damping = (f.meta or {}).get("damping")
        if not damping and uses_cavity:
            # kept (before any missing-data mask) for the neighbours'
            # cavities and the free energy
            state[f"_msg:{f.id}:{iface}"] = with_batch_axis(
                msg, ctx.batch, f.plate is not None)
        if damping:
            key = f"_msg:{f.id}:{iface}"
            stored = msg if f.plate is None else pad_plate(
                msg, 0, f.plate.size, f.plate.size, batch_ndim=1)
            # the first sweep keeps the raw rule message and stores it for
            # the next sweep's blend, as the JAX package does
            if key in state:
                lam = float(damping)
                stored = msg = from_natural(family_key(stored), tuple(
                    (1.0 - lam) * a + lam * b for a, b in
                    zip(to_natural(stored), to_natural(state[key]))))
            state[key] = stored
        if self.scalar:
            m = as_weighted_mean_precision(msg)
            mxi, mw = self._lift_vec(m.xi), self._lift_mat(m.w)
        else:
            m = as_mv_weighted_mean_precision(msg)
            mxi, mw = m.xi, m.w
        ref = f.out if iface == "out" else f.interfaces[iface]
        return mxi, mw, _coverage(f, ref)

    def _evidence_batch(self, state, data, ctx=None, chain_cross=None):
        """The batch's evidence xi (B, T, d) and W (B, T, d, d), masked
        where an observation is missing (zero natural parameters: no
        evidence)."""
        ctx = ctx or cpu_context()
        d, length = self.dim, self.var.length
        xi = torch.zeros((ctx.batch, length, d), device=ctx.device)
        w = torch.zeros((ctx.batch, length, d, d), device=ctx.device)
        for f, iface in self.evidence:
            mxi, mw, cov = self._evidence_msg(f, iface, state, data, ctx,
                                              chain_cross)
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
        xi, w = self._evidence_batch(state, data, ctx, chain_cross)
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


class GCVChainBlock(GaussianChainBlock):
    """A scalar Gaussian chain whose per-step transition variance is set by
    a higher-level latent: Q_t = 1 / E[exp(-(kappa z_t + omega))] (the HGF's
    x level; ``rules/gcv.py``), per chain and step, (B, T-1, 1, 1)."""

    def _transition_params(self, state, data, length, ctx=None):
        from ..rules.gcv import expected_precision

        ctx = ctx or cpu_context()
        f = self.transition
        # only the volatility side: out and in are this chain
        q = {name: resolve_iface(v, f, state, data, ctx)
             for name, v in f.interfaces.items()
             if name in ("z", "kappa", "omega")}
        q_cov = (1.0 / expected_precision(q))[..., None, None]
        eye = torch.eye(1, device=ctx.device)
        a, b, _ = self._steps(eye, torch.zeros((1,), device=ctx.device),
                              eye, length)
        return a, b, q_cov


class ARChainBlock(GaussianChainBlock):
    """An order-k autoregressive chain: the companion transition built from
    the current E[theta], the innovation variance from E[gamma]
    (``rules/ar.py``), per chain, (B, T-1, k, k) views of (B, k, k).  The
    diagonal JITTER keeps the embedded (singular) process noise invertible
    for the smoother's algebra: Q = JITTER I + e_1 e_1^T / E[gamma]."""

    JITTER = 1e-6

    def _transition_params(self, state, data, length, ctx=None):
        from ..rules.expectations import e_mean, e_precision

        ctx = ctx or cpu_context()
        f = self.transition
        theta_q = resolve_iface(f.interfaces["theta"], f, state, data, ctx)
        gamma_q = resolve_iface(f.interfaces["gamma"], f, state, data, ctx)
        k = self.dim
        th = e_mean(theta_q)
        if isinstance(theta_q, ScalarGaussians) or th.ndim == 0:
            th = th[..., None]    # a scalar coefficient (order 1)
        lead = th.shape[:-1]
        a = torch.zeros(lead + (k, k), device=ctx.device)
        a[..., 0, :] = th
        if k > 1:
            idx = torch.arange(1, k, device=ctx.device)
            a[..., idx, idx - 1] = 1.0
        g = e_precision(gamma_q)
        q_cov = self.JITTER * torch.eye(k, device=ctx.device).expand(
            g.shape + (k, k)).clone()
        q_cov[..., 0, 0] += 1.0 / g
        b = torch.zeros((k,), device=ctx.device)
        return self._steps(a, b, q_cov, length)


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
