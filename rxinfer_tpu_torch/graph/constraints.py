"""Constraints (counterpart of ``rxinfer_tpu/graph/constraints.py``; the
reference's GraphPPL ``@constraints`` and ``src/constraints/form/*.jl``).

Factorization.  The engine's default factorization is the reference's
common operating point: structured pairwise clusters on each node's BP
cluster (chains exactly, by their blocks; a single-step Gaussian or GCV
pair through its cavity messages, e.g. the HGF's joint q(xt, xt_min)),
mean field across parameter links.  A ``factorize()`` pair that cuts
INSIDE a node's cluster makes that factor mean-field (its ``vmp_`` rules,
no cavity store, mean-field free-energy accounting); a pair across the
default boundary, as the reference HGF constraint ``q(xt, zt, xt_min) =
q(xt, xt_min)q(zt)``, is a no-op that keeps the pair.  ``MeanField()``
splits every factor; exact chain blocks stay structured (and fused).

Functional forms, applied to a plain group's marginal after each product
(``forms=``) or to each inbound message before it (``message_forms=``):
``PointMassFormConstraint`` (the MAP point), ``SampleListFormConstraint``
(importance samples of a product without a closed form),
``FixedMarginalFormConstraint`` (a pinned marginal) and, in
``engine/projection.py``, ``ProjectedTo``.

Submodel-scoped blocks: ``constraints(submodel={"walk": ...})`` applies a
block's factorization, forms and message forms to the variables and factors
of every instance of the scope ``walk`` (``"walk:2"``: that instance only),
and a submodel's ``default_constraints`` to every instance no user block
targets (``expand_submodel_constraints``).

Everything runs batch-major: a marginal's leaves carry the batch first.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


class MeanField:
    """Fully factorized variational family (reference ``MeanField()``):
    every factor's messages take the nodes' mean-field (``vmp_``) variants
    and the Bethe free energy its mean-field entropies.  Exact chain blocks
    (Kalman / forward-backward) stay structured: they are exact and
    strictly tighter than the mean-field approximation on chains."""


class FullFactorization:
    """The engine default (structured pairwise clusters on Gaussian
    mean/out and deterministic nodes; mean field across parameter links)."""


def factorize(*pairs: tuple) -> list:
    """``q(x, y) = q(x) q(y)`` splits: each tuple names variables whose
    joint is forced to factorize (reference ``@constraints q(x, y) =
    q(x)q(y)``)."""
    out = []
    for p in pairs:
        if len(p) < 2:
            raise ValueError(f"factorize() pairs need >= 2 names, got {p!r}")
        out.append(tuple(p))
    return out


def factorize_slots(*names: str) -> list:
    """``q(x) = q(x[begin]) .. q(x[end])``: mean field across the slots of
    an array variable.  Non-chain array groups are slot-factored already
    (per-slot natural-parameter products), so the spec validates and
    records intent; on an exactly solved chain it raises."""
    return list(names)


@dataclasses.dataclass
class Constraints:
    """What ``infer(constraints=...)`` takes."""

    factorization: Any = None  # MeanField() | list of name tuples | None
    forms: Optional[dict] = None  # var name -> form constraint (q(x)::C)
    slot_factorized: Optional[list] = None  # arrays mean-field over slots
    # scope name -> Constraints inside that submodel scope ('name:2': one
    # instance)
    submodel: Optional[dict] = None
    # var name -> form constraint on each inbound message (mu(x)::C)
    message_forms: Optional[dict] = None
    # filled by expansion: scope prefixes whose factors go mean-field
    mf_scopes: Optional[list] = None


def constraints(factorization: Any = None, forms: Optional[dict] = None,
                slot_factorized: Optional[list] = None,
                submodel: Optional[dict] = None,
                message_forms: Optional[dict] = None) -> Constraints:
    return Constraints(factorization, forms or {}, slot_factorized or [],
                       submodel or {}, message_forms or {})


def _scope_base(segment: str) -> str:
    return segment.split(":")[0]


def expand_submodel_constraints(graph, cons: Constraints,
                                defaults: Optional[dict] = None
                                ) -> Constraints:
    """Flatten submodel-scoped constraint blocks against the traced graph:
    each block's local variable names become full scoped names
    (``walk:2/x``) for every matching scope instance.  A key ``walk``
    matches every instance of the scope, ``walk:2`` exactly one; a key that
    matches none raises ``ValueError``.  ``defaults`` maps submodel base
    names to the ``default_constraints`` of ``@submodel``, applied to every
    instance no user block targeted."""
    if not cons.submodel and not defaults:
        return cons
    prefixes: set = set()
    for v in list(graph.variables) + list(graph.factors):
        for i in range(len(v.scope)):
            prefixes.add(v.scope[:i + 1])

    flat = Constraints(
        factorization=(cons.factorization
                       if isinstance(cons.factorization, MeanField)
                       or cons.factorization is None
                       else list(cons.factorization)),
        forms=dict(cons.forms or {}),
        slot_factorized=list(cons.slot_factorized or []),
        message_forms=dict(cons.message_forms or {}),
        mf_scopes=[],
    )
    known = {v.name for v in graph.variables if v.kind == "random"}

    def _apply_block(key, sub, p):
        prefix = "/".join(p)
        if isinstance(sub.factorization, MeanField):
            flat.mf_scopes.append(prefix)
        elif sub.factorization:
            if flat.factorization is None:
                flat.factorization = []
            if not isinstance(flat.factorization, MeanField):
                # (a global MeanField dominates)
                for tup in sub.factorization:
                    flat.factorization.append(
                        tuple(f"{prefix}/{n}" for n in tup))
        for local, form in (sub.forms or {}).items():
            full = f"{prefix}/{local}"
            if full not in known:
                raise ValueError(
                    f"submodel constraint block {key!r}: no variable "
                    f"{local!r} in scope {prefix!r}.")
            flat.forms[full] = form
        for local in (sub.slot_factorized or []):
            flat.slot_factorized.append(f"{prefix}/{local}")
        for local, form in (getattr(sub, "message_forms", None)
                            or {}).items():
            flat.message_forms[f"{prefix}/{local}"] = form

    user_matched: set = set()
    for key, sub in (cons.submodel or {}).items():
        if getattr(sub, "submodel", None):
            raise NotImplementedError(
                "nested submodel constraint blocks: scope the inner block "
                "directly by its path key instead.")
        matched = [p for p in prefixes
                   if (p[-1] == key if ":" in key
                       else _scope_base(p[-1]) == key)]
        if not matched:
            raise ValueError(
                f"constraints submodel block {key!r} matches no scope in the "
                "model (scopes present: "
                f"{sorted('/'.join(p) for p in prefixes) or 'none'}).")
        user_matched.update(matched)
        for p in sorted(matched):
            _apply_block(key, sub, p)
    for base, sub in (defaults or {}).items():
        for p in sorted(prefixes):
            if _scope_base(p[-1]) == base and p not in user_matched:
                _apply_block(base, sub, p)
    return flat


# -- functional form constraints ---------------------------------------------

class AbstractFormConstraint:
    def constrain(self, dist):
        raise NotImplementedError


class UnspecifiedFormConstraint(AbstractFormConstraint):
    """No-op form constraint (reference ``UnspecifiedFormConstraint``)."""

    def constrain(self, dist):
        return dist


class ComposedFormConstraint(AbstractFormConstraint):
    """Stacked form constraints applied left to right (``q(x) :: C1 ::
    C2``)."""

    def __init__(self, parts):
        self.parts = list(parts)

    def constrain(self, dist):
        for p in self.parts:
            dist = p.constrain(dist)
        return dist


def as_form_constraint(spec):
    """A form-constraint spec normalized: a tuple or list composes."""
    if spec is None:
        return None
    if isinstance(spec, (tuple, list)):
        return ComposedFormConstraint(spec) if len(spec) > 1 else spec[0]
    return spec


def _event_ndim(d) -> int:
    return int(getattr(d, "event_ndim", 0)) if d is not None else 0


class PointMassFormConstraint(AbstractFormConstraint):
    """MAP collapse (reference ``PointMassFormConstraint``,
    src/constraints/form/form_point_mass.jl:53-205).

    A family with a closed-form mode collapses to it.  Otherwise, and
    whenever ``optimizer=``, ``boundaries=`` or ``starting_point=`` is
    given, the MAP point of every batch element is found at once by
    ``n_iters`` damped Newton steps on -log q(x) (saddle-free: the
    Hessian's eigenvalues taken by magnitude; each step halved until it
    does not increase the objective), in place of the JAX package's
    ``optax.lbfgs``:

    - ``optimizer``: None (the Newton steps) or a callable ``(neg_logpdf,
      x0) -> x``; ``neg_logpdf`` maps points shaped like ``x0`` (batch...,
      event...) to the batch's values.  An optax ``GradientTransformation``
      has no counterpart here and anything else raises ``TypeError``.
    - ``starting_point``: a tensor, array or callable returning one;
      defaults to the previous marginal's mean (warm start), else the
      first message's mean.
    - ``boundaries``: a (lo, hi) box the iterates are clipped into (the
      Fminbox equivalent)."""

    def __init__(self, optimizer=None, starting_point=None, boundaries=None,
                 n_iters: int = 60):
        if optimizer is not None and not callable(optimizer):
            raise TypeError(
                "PointMassFormConstraint(optimizer=...): the PyTorch package "
                "takes None or a callable (neg_logpdf, x0) -> x; an optax "
                "GradientTransformation has no counterpart here.")
        self.optimizer = optimizer
        self.starting_point = starting_point
        self.boundaries = boundaries
        self.n_iters = n_iters

    @property
    def _wants_optimizer(self) -> bool:
        return (self.optimizer is not None or self.boundaries is not None
                or self.starting_point is not None)

    def _x0(self, msgs, prev, device):
        if self.starting_point is not None:
            x0 = (self.starting_point() if callable(self.starting_point)
                  else self.starting_point)
            return torch.as_tensor(x0, dtype=torch.float32, device=device)
        for cand in ([prev] if prev is not None else []) + list(msgs):
            try:
                return cand.mean().to(torch.float32)
            except (AttributeError, NotImplementedError):  # no mean
                continue
        raise ValueError(
            "PointMassFormConstraint: no starting point derivable from the "
            "messages; pass starting_point=.")

    def _clip(self, x):
        if self.boundaries is None:
            return x
        lo, hi = self.boundaries
        return torch.clamp(x, lo, hi)

    def _optimize(self, msgs, prev=None):
        from ..dists import PointMass
        from ..dists.sampling import batch_shape_of, device_of_messages, logpdf

        device = device_of_messages([prev] + list(msgs))
        event = max([_event_ndim(prev)] + [_event_ndim(m) for m in msgs])

        def neg_logpdf(x):
            # one point per batch element: a sample axis of one in front
            return -sum(logpdf(m, x[None]) for m in msgs)[0]

        x0 = self._clip(self._x0(msgs, prev, device))
        if self.optimizer is not None:
            return PointMass(torch.as_tensor(self.optimizer(neg_logpdf, x0),
                                             dtype=torch.float32))
        # one point per batch element of the product
        lead = torch.broadcast_shapes(
            batch_shape_of(msgs + ([prev] if prev is not None else [])),
            x0.shape[:x0.ndim - event])
        x0 = x0.expand(tuple(lead) + tuple(x0.shape[x0.ndim - event:]))
        return PointMass(newton_minimize(neg_logpdf, x0, event,
                                         self.n_iters, self._clip))

    def constrain(self, dist):
        from ..dists import PointMass
        from ..dists.sampling import mode

        if not self._wants_optimizer:
            try:
                return PointMass(mode(dist))
            except NotImplementedError:  # no analytic mode: optimize
                pass
        return self._optimize([dist])

    def project_product(self, msgs, prev=None):
        """The MAP point of a message product without a closed form
        (``NodeFunctionRuleFallback`` carriers among them)."""
        from ..dists import PointMass
        from ..dists.base import ProductError
        from ..dists.natural import prod_all
        from ..dists.sampling import mode

        if not self._wants_optimizer:
            try:
                return PointMass(mode(prod_all(msgs)))
            except (ProductError, TypeError, NotImplementedError):
                pass
        return self._optimize(msgs, prev=prev)


_HALVINGS = 20   # a Newton step's trials, each half the one before


def newton_minimize(fn, x0, event_ndim: int, n_iters: int, clip=None):
    """Minimize ``fn`` (points (batch..., event...) -> (batch...)) from
    ``x0`` for every batch element at once: ``n_iters`` saddle-free Newton
    steps, each halved up to ``_HALVINGS`` times until the objective does
    not increase (an element whose every trial increases it stays put)."""
    clip = clip or (lambda x: x)
    x = x0.detach().clone()
    for _ in range(n_iters):
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = fn(xg)
            (g,) = torch.autograd.grad(f.sum(), xg, create_graph=True)
            if event_ndim == 0:
                (h,) = torch.autograd.grad(g.sum(), xg)
                step = -g.detach() / torch.clamp(torch.abs(h), min=1e-12)
            else:
                d = x.shape[-1]
                rows = [torch.autograd.grad(g[..., j].sum(), xg,
                                            retain_graph=j < d - 1)[0]
                        for j in range(d)]
                h = torch.stack(rows, dim=-2)
                evals, evecs = torch.linalg.eigh(0.5 * (h + h.transpose(-1,
                                                                        -2)))
                inv = 1.0 / torch.clamp(torch.abs(evals), min=1e-12)
                step = -torch.einsum("...ij,...j,...kj,...k->...i", evecs,
                                     inv, evecs, g.detach())
        f = f.detach()
        t = torch.ones_like(f)
        accepted = torch.zeros_like(f, dtype=torch.bool)
        new_x = x
        for _ in range(_HALVINGS):
            tt = t.reshape(t.shape + (1,) * event_ndim)
            cand = clip(x + tt * step)
            with torch.no_grad():
                fc = fn(cand)
            ok = torch.isfinite(fc) & ((fc <= f) | ~torch.isfinite(f)) \
                & ~accepted
            okr = ok.reshape(ok.shape + (1,) * event_ndim)
            new_x = torch.where(okr, cand, new_x)
            accepted = accepted | ok
            if bool(accepted.all()):
                break
            t = torch.where(accepted, t, 0.5 * t)
        x = new_x.detach()
    return x


class FixedMarginalFormConstraint(AbstractFormConstraint):
    """Pin the marginal (reference ``FixedMarginalFormConstraint``)."""

    def __init__(self, dist):
        self.dist = dist

    def constrain(self, dist):
        del dist
        return self.dist


class LeftProposal:
    """The FIRST message is the sample-list proposal."""


class RightProposal:
    """The LAST message is the sample-list proposal."""


class AutoProposal:
    """The first proper (sampleable, not function-form) message is the
    proposal."""


class SampleListFormConstraint(AbstractFormConstraint):
    """Importance-sampled approximation of a message product without a
    closed form (reference ``SampleListFormConstraint``,
    src/constraints/form/form_sample_list.jl:29-104): ``n_samples`` draws
    from a proposal chosen among the product's factors (Left / Right /
    Auto), weighted by the other factors.  Closed-form products and
    proper distributions pass through unchanged.  The draws come from a
    ``torch.Generator`` on the messages' device seeded with ``seed``; the
    result holds (batch..., n_samples) samples and log-weights."""

    def __init__(self, n_samples: int = 256, seed: int = 0, strategy=None):
        self.n_samples = n_samples
        self.seed = seed
        self.strategy = strategy if strategy is not None else AutoProposal()

    def _pick_proposal(self, msgs):
        if isinstance(self.strategy, LeftProposal):
            return 0
        if isinstance(self.strategy, RightProposal):
            return len(msgs) - 1
        for i, m in enumerate(msgs):
            if not hasattr(m, "log_fn"):
                return i
        raise ValueError(
            "Cannot approximate the product as a sample list: the "
            "AutoProposal strategy cannot choose a proposal distribution "
            "(no factor is a proper distribution). Use LeftProposal or "
            "RightProposal (reference: form_sample_list.jl:88-96).")

    def project_product(self, msgs, prev=None):
        from ..dists import SampleList
        from ..dists.base import ProductError
        from ..dists.natural import prod_all
        from ..dists.sampling import (
            device_of_messages,
            generator,
            logpdf,
            sample,
        )

        try:
            return prod_all(msgs)
        except (ProductError, TypeError):
            pass
        idx = self._pick_proposal(msgs)
        proposal = msgs[idx]
        device = device_of_messages([prev] + list(msgs))
        z = sample(proposal, self.n_samples,
                   generator(self.seed, device))          # (S, batch..., ev)
        logw = torch.zeros((self.n_samples,), device=device)
        for i, m in enumerate(msgs):
            if i != idx:
                logw = logw + logpdf(m, z)
        ev = _event_ndim(proposal)
        lead = torch.broadcast_shapes(logw.shape[1:],
                                      z.shape[1:z.ndim - ev])
        z = z.expand((self.n_samples,) + tuple(lead)
                     + tuple(z.shape[z.ndim - ev:]))
        logw = logw.expand((self.n_samples,) + tuple(lead))
        # the sample axis after the batch axes
        return SampleList(z.movedim(0, len(lead)), logw.movedim(0, -1))

    def constrain(self, dist):
        return dist


class InitMessage:
    """``mu(x) = dist`` initialization.  Under the static schedule an
    initial edge message and an initial marginal play the same role, so
    ``initialization={"x": InitMessage(d)}`` equals ``{"x": d}``."""

    def __init__(self, dist):
        self.dist = dist
