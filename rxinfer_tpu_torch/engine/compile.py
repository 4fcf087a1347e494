"""Graph -> static schedule compiler (counterpart of
``rxinfer_tpu/engine/compile.py``).

Lowering pipeline, as in the JAX package: contract Gaussian means over
anonymous deltas, fold plain-Gaussian lag transitions into LinearGaussian
fforms, detect chain blocks, schedule the sweep, and build the programs:
the single-dataset program of ``infer`` (``make_program`` / ``run`` /
``run_iterative``) and the batched program (engine/batched.py).

Ported subset: ``contract_deltas``, ``normalize_transitions``,
``detect_chains``, ``schedule_sweep`` (with the JAX package's tree
schedule of a chain-free deadlock, ``_try_tree_schedule``, and the
ancestral or vague seeds of its variables, ``_prior_init`` /
``_vague_for``), ``attach_meta`` (``meta=``),
``_mean_field_factor_ids`` (factorization constraints) and the
parts of ``CompiledModel`` that models of Gaussian, AR, GCV and discrete
chains and plain conjugate groups need: block construction with
compile-time rule resolution (the mean-field ``vmp_`` variants of a
factor split by a factorization constraint, ``options={"rulefallback":
NodeFunctionRuleFallback()}`` where a node has no rule, the form and
message-form constraints of each plain group, the slot-factorization
checks), ``_init_state``, ``plan_report``, ``_with_derived``, the sweep
(``_sweep_once``, batch-major under a ``BatchContext``: one dataset is a
batch of one), the Bethe free energy after each sweep (``degrees``,
``fe_factors``, ``_free_energy``; ``options={"check_objective": True}``
stops a host-driven run at a non-finite value), ``make_program``, ``run``,
``run_iterative`` (host loop with per-iteration callbacks), ``predict``,
``options={"matmul_precision": ...}`` (``matmul_precision_scope``), the
event ranks of the Delta / NonlinearGaussian factors' point-mass
interfaces (``attach_delta_ranks``),
``make_batched_program`` and the streaming engine's tick surface
(``make_tick_program``, ``run_tick``, ``make_sweep_fn``: ticks over a batch
of streams, warm-started from the previous tick's state and pair
statistics, the initialization read at the first tick only; and
``variable_outbound_message``, the mu(x) of two-argument autoupdates).  A
plain group is built for every random variable that is not a chain, in a
family the port has a natural-parameter view for (``gaussian``,
``mv_gaussian``, ``beta``, ``bernoulli``, ``categorical``, ``dirichlet``,
``dirichlet_collection``, ``gamma``, ``inverse_gamma``, ``wishart``,
``inverse_wishart``, ``poisson``), with the required-message dependencies
of ``where(dependencies=RequireMessage(...))``; a grid latent's
initialization is one slot's, broadcast over its ``grid_axes``, and a
nested-plate factor that defines an anonymous latent is refused, as in the
JAX package.  Submodel-scoped constraint blocks and a submodel's
``default_constraints`` are expanded against the traced graph
(``expand_submodel_constraints``; a scope under ``MeanField()`` splits
every factor created in it), and a tuple key ``("walk", "tau")`` of
``initialization=`` or a submodel's ``default_init`` initializes the
variable ``tau`` of every instance of ``walk`` that the user's
initialization does not name.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

import numpy as np
import torch

from ..dists import tree_map
from ..dists.natural import NAT_EVENT_RANKS
from ..graph.constraints import _scope_base
from ..graph.ir import Const, Factor, ModelGraph, Ref, SymIndex
from ..rules.registry import get_message_rule, get_node, trace_messages
from .bethe import (
    FactorFE,
    slot_degrees,
    variable_entropies,
    variable_entropy_term,
)
from .blocks import (
    ARChainBlock,
    BatchContext,
    DiscreteChainBlock,
    GaussianChainBlock,
    GCVChainBlock,
    PlainGroup,
    _coverage,
    build_q,
    factor_data_mask,
    in_cavity_cluster,
    mask_message,
)
from .shapes import resolve_groups

_GAUSSIAN_TRANS = {
    "LinearGaussianCovariance",
    "LinearGaussianPrecision",
    "MvLinearGaussianCovariance",
    "MvLinearGaussianPrecision",
}

_PLAIN_GAUSS = {
    "NormalMeanVariance": ("LinearGaussianCovariance", "var"),
    "NormalMeanPrecision": ("LinearGaussianPrecision", "prec"),
    "MvNormalMeanCovariance": ("MvLinearGaussianCovariance", "cov"),
    "MvNormalMeanPrecision": ("MvLinearGaussianPrecision", "prec"),
}

_GAUSS_MEAN_CONTRACT = {
    "NormalMeanVariance": "NonlinearGaussianCovariance",
    "NormalMeanPrecision": "NonlinearGaussianPrecision",
    "MvNormalMeanCovariance": "NonlinearGaussianCovariance",
    "MvNormalMeanPrecision": "NonlinearGaussianPrecision",
}

# options the JAX package accepts; the port implements the subset below and
# raises NotImplementedError for the others' non-default values
_KNOWN_OPTIONS = {"parallel_scans", "rulefallback", "check_objective", "warn",
                  "limit_stack_depth", "force_marginal_computation",
                  "fused_kernels", "hbm_budget_bytes", "fused_moment_dtype",
                  "matmul_precision", "observation_dtype"}


def _lag_ref(f: Factor):
    """Return (iface, Ref) of a lag-1 self-reference, if f is a transition."""
    if not isinstance(f.out.idx, SymIndex):
        return None
    for name, v in f.interfaces.items():
        if (
            isinstance(v, Ref)
            and v.var is f.out.var
            and isinstance(v.idx, SymIndex)
            and v.idx.offset == f.out.idx.offset - 1
        ):
            return name, v
    return None


def contract_deltas(graph: ModelGraph) -> None:
    """Fold ``Normal(mean=Delta(fn, ...), noise)`` pairs into
    NonlinearGaussian factors."""
    for delta_f in [f for f in graph.factors if f.fform == "Delta"]:
        w = delta_f.out.var
        if not w.name.startswith("_"):
            continue
        neighbors = []
        for f in graph.factors:
            if f is delta_f:
                continue
            for v in f.all_interfaces().values():
                if isinstance(v, Ref) and v.var is w:
                    neighbors.append(f)
                    break
        if len(neighbors) != 1:
            continue
        g = neighbors[0]
        mean_ref = g.interfaces.get("mean")
        if g.fform not in _GAUSS_MEAN_CONTRACT or not isinstance(mean_ref, Ref):
            continue
        if mean_ref.var is not w or g.plate is not delta_f.plate:
            continue
        noise_key = [k for k in g.interfaces if k != "mean"][0]
        new_interfaces = dict(delta_f.interfaces)
        new_interfaces[noise_key] = g.interfaces[noise_key]
        g.fform = _GAUSS_MEAN_CONTRACT[g.fform]
        g.interfaces = new_interfaces
        g.meta = delta_f.meta
        graph.factors.remove(delta_f)
        graph.variables.remove(w)


def normalize_transitions(graph: ModelGraph, infos) -> None:
    """Fold plain-Gaussian lag transitions into LinearGaussian fforms
    (A = I, b = 0)."""
    for f in graph.factors:
        lag = _lag_ref(f)
        if lag is None:
            continue
        if f.fform in _PLAIN_GAUSS and lag[0] == "mean":
            new_ff, noise_name = _PLAIN_GAUSS[f.fform]
            shape = infos[f.out.var.name].event_shape
            dim = shape[0] if shape else None
            noise_key = [k for k in f.interfaces if k != "mean"][0]
            noise = f.interfaces[noise_key]
            f.fform = new_ff
            f.interfaces = {
                "in": lag[1],
                "A": Const(np.eye(dim, dtype=np.float32) if dim
                           else np.float32(1.0)),
                "b": Const(np.zeros(dim, dtype=np.float32) if dim
                           else np.float32(0.0)),
                noise_name: noise,
            }


def attach_meta(graph: ModelGraph, meta: Optional[dict]) -> None:
    """The ``meta=`` argument (the reference's ``@meta``): a dict keyed by
    node type, e.g. ``{"GCV": {"damping": 0.8}}``, or by ``(fform, (names,
    ...))`` for the nodes of that type whose interfaces are bound to
    variables of those names, the reference's per-neighbourhood form
    ``GCV(x, z) -> ...``.  Each matching factor's ``meta`` gets the entries
    (a value that is not a dict as ``{"meta": value}``)."""
    if not meta:
        return

    def _neighbor_names(f):
        return {v.var.name.split("/")[-1] for v in f.all_interfaces().values()
                if isinstance(v, Ref)}

    for f in graph.factors:
        extra = meta.get(f.fform)
        for key, val in meta.items():
            if (isinstance(key, tuple) and key[0] == f.fform
                    and set(key[1]) <= _neighbor_names(f)):
                extra = val
        if extra is not None:
            merged = dict(f.meta or {})
            merged.update(extra if isinstance(extra, dict)
                          else {"meta": extra})
            f.meta = merged


_DELTA_NODES = {"Delta", "NonlinearGaussianCovariance",
                "NonlinearGaussianPrecision"}


def attach_delta_ranks(graph: ModelGraph) -> None:
    """Give every Delta / NonlinearGaussian factor the event rank of each
    constant or data interface (``meta["_ranks"]``): a point-mass input
    carries no class that tells a vector from a plate of scalars, and the
    rules (``rules/delta.py``) broadcast the leading axes of the rest."""
    for f in graph.factors:
        if f.fform not in _DELTA_NODES:
            continue
        ranks = {}
        for name, v in f.all_interfaces().items():
            if isinstance(v, Const):
                ranks[name] = int(np.ndim(v.value))
            elif isinstance(v, Ref) and v.var.kind == "data":
                ev = len(v.var.event_shape or ())
                whole = v.idx is None and v.var.is_array
                ranks[name] = ev + 1 if whole else ev
        f.meta = {**(f.meta or {}), "_ranks": ranks}


_MATMUL_PRECISION = {"highest": "highest", "float32": "highest",
                     "high": "high", "tensorfloat32": "high",
                     "bfloat16": "medium", "default": None}


class matmul_precision_scope:
    """``options={"matmul_precision": name}``: the program's torch matmuls
    run under ``torch.set_float32_matmul_precision`` for the call, and the
    caller's setting comes back after it, on every exit path.  The JAX
    names map as "highest" / "float32" -> "highest", "high" /
    "tensorfloat32" -> "high", "bfloat16" -> "medium"; "default" and None
    leave the setting alone.  The CUDA kernels (K1-K8) compute in float32
    (or 3xTF32 on the tensor cores) whatever the option."""

    def __init__(self, name: Optional[str]):
        if name is not None and name not in _MATMUL_PRECISION:
            raise ValueError(
                f"matmul_precision {name!r} not supported; choose one of "
                f"{sorted(_MATMUL_PRECISION)}.")
        self.setting = _MATMUL_PRECISION.get(name) if name else None
        self._prev = []

    def __enter__(self):
        self._prev.append(torch.get_float32_matmul_precision())
        if self.setting is not None:
            torch.set_float32_matmul_precision(self.setting)
        return self

    def __exit__(self, *exc):
        torch.set_float32_matmul_precision(self._prev.pop())
        return False

    def wrap(self, program):
        """``program`` run inside the scope (itself when it sets nothing)."""
        if self.setting is None:
            return program

        def scoped(*args, **kwargs):
            with self:
                return program(*args, **kwargs)

        return scoped


def check_gcv_factors(graph: ModelGraph, chains: dict) -> None:
    """A GCV chain's volatility z must be indexed a step: a chain
    transition with one z for every step is not a model the JAX package's
    GCVChainBlock can assemble.  (A GCV factor that is no chain's
    transition is a single-step GCV: its (out, in) pair is kept from the
    stored cavity messages, ``engine/blocks.py`` ``attach_gcv_pair_cross``.)"""
    for spec in chains.values():
        f = spec.transition
        if f.fform != "GCV":
            continue
        z = f.interfaces.get("z")
        if not (isinstance(z, Ref) and isinstance(z.idx, SymIndex)):
            raise NotImplementedError(
                f"GCV chain {f.out.var.name!r}: its volatility z must be "
                "indexed a step (z[t]); a volatility shared by the steps is "
                "not a model the JAX package's GCV chain block assembles.")


def _mean_field_factor_ids(graph: ModelGraph, constraints) -> set:
    """Ids of the factors whose neighbourhood a factorization constraint
    splits.  ``MeanField()`` splits every factor.  A ``factorize()`` group
    splits a factor when it names two variables of the factor's structured
    (cavity) cluster, or of its random interfaces when the node declares
    none; a split across the default mean-field boundary (the reference
    HGF's ``q(xt, zt, xt_min) = q(xt, xt_min)q(zt)``: zt is across the GCV
    cluster already) is the engine default, a no-op that keeps the pair."""
    ids: set = set()
    # submodel-scoped MeanField blocks: the factors created under the scope
    for prefix in (getattr(constraints, "mf_scopes", None) or []):
        for f in graph.factors:
            fp = "/".join(f.scope)
            if fp == prefix or fp.startswith(prefix + "/"):
                ids.add(f.id)
    fac = getattr(constraints, "factorization", None) if constraints else None
    if fac is None:
        return ids
    from ..graph.constraints import MeanField

    if isinstance(fac, MeanField):
        return {f.id for f in graph.factors}
    known = {v.name for v in graph.random_variables()}
    groups = []
    for names in fac:
        unknown = set(names) - known
        if unknown:
            raise ValueError(
                "factorization constraint names unknown variables "
                f"{sorted(unknown)}")
        groups.append(set(names))
    for f in graph.factors:
        rvars = {v.var.name for v in f.all_interfaces().values()
                 if isinstance(v, Ref) and v.var.kind == "random"}
        try:
            node_cls = get_node(f.fform)
        except KeyError:   # an unregistered fform: its random interfaces
            node_cls = None
        cluster = set()
        if node_cls is not None:
            cluster = {v.var.name for name, v in f.all_interfaces().items()
                       if isinstance(v, Ref) and v.var.kind == "random"
                       and in_cavity_cluster(node_cls, name)}
        relevant = cluster if cluster else rvars
        if any(len(relevant & g) >= 2 for g in groups):
            ids.add(f.id)
    return ids


@dataclasses.dataclass
class ChainSpec:
    var: Any
    kind: str  # 'gaussian' | 'ar' | 'gcv' | 'discrete'
    prior: Factor
    transition: Factor
    evidence: list


def detect_chains(graph: ModelGraph, infos) -> dict[str, ChainSpec]:
    chains: dict[str, ChainSpec] = {}
    for var in graph.random_variables():
        if not var.is_array:
            continue
        transitions = [f for f in graph.factors
                       if f.out.var is var and _lag_ref(f) is not None]
        if not transitions:
            continue
        trans = transitions[0]
        if len(transitions) > 1:
            kind = None
        elif trans.fform in _GAUSSIAN_TRANS:
            kind = "gaussian"
        elif trans.fform == "AR":
            kind = "ar"
        elif trans.fform == "GCV":
            kind = "gcv"
        elif trans.fform == "DiscreteTransition":
            kind = "discrete"
        else:
            kind = None
        if kind is None:
            warnings.warn(
                f"Chain over {var.name}: transition {trans.fform} has no "
                "chain solver; it is left to iterative message passing.",
                stacklevel=2,
            )
            continue
        prior = None
        evidence = []
        for f in graph.factors:
            if f is trans:
                continue
            if f.out.var is var:
                if f.out.idx == 0 and f.plate is None and prior is None:
                    prior = f
                elif f.plate is None and isinstance(f.out.idx, int):
                    # extra unary factor pinning a non-initial slot: enters
                    # the chain solve as out-message evidence at that slot
                    evidence.append((f, "out"))
                else:
                    raise NotImplementedError(
                        f"Chain {var.name}: extra defining factor {f.fform} "
                        f"at {f.out.idx} (plated second definitions are not "
                        "supported)."
                    )
                continue
            for name, v in f.interfaces.items():
                if isinstance(v, Ref) and v.var is var:
                    if len(getattr(f, "plates", ())) >= 2:
                        raise NotImplementedError(
                            f"Chain {var.name}: nested-plate evidence factor "
                            f"{f.fform} is not supported."
                        )
                    evidence.append((f, name))
                    break
        if prior is None:
            raise ValueError(f"Chain {var.name} has no prior factor at slot 0.")
        chains[var.name] = ChainSpec(var, kind, prior, trans, evidence)
    return chains


def _read_deps(var, graph: ModelGraph, chains) -> set[str]:
    """Random groups whose marginals this group's update reads."""
    deps: set[str] = set()
    if var.name in chains:
        spec = chains[var.name]
        factors = [spec.prior, spec.transition] + [f for f, _ in spec.evidence]
    else:
        factors = [
            f for f in graph.factors
            if any(isinstance(v, Ref) and v.var is var
                   for v in f.all_interfaces().values())
        ]
    for f in factors:
        for v in f.all_interfaces().values():
            if isinstance(v, Ref) and v.var.kind == "random" \
                    and v.var.name != var.name:
                deps.add(v.var.name)
    return deps


def _try_tree_schedule(remaining, graph: ModelGraph) -> Optional[list]:
    """The deadlocked variables as a tree sweep, or None when they are
    loopy.  When the factor graph restricted to them is acyclic (checked by
    union-find over each factor's deadlocked neighbourhood; a plated factor
    is one factor), exact BP needs no initialization: a leaves-to-root pass
    followed by the reverse root-to-leaves pass gives every marginal in one
    sweep.  The variables are then auto-initialized (``_prior_init`` /
    ``_vague_for``) so that the not-yet-informed side of each update is a
    neutral message."""
    names = {v.name for v in remaining}
    fac_adj: dict = {n: [] for n in names}
    fac_vars: list = []
    for f in graph.factors:
        vs = sorted({v.var.name for v in f.all_interfaces().values()
                     if isinstance(v, Ref) and v.var.kind == "random"
                     and v.var.name in names})
        if len(vs) >= 2:
            fid = len(fac_vars)
            fac_vars.append((fid, vs))
            for n in vs:
                fac_adj[n].append(fid)

    parent = {n: n for n in names}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for _, vs in fac_vars:
        for other in vs[1:]:
            rb, ro = find(vs[0]), find(other)
            if rb == ro:
                return None  # a cycle: a loopy model
            parent[ro] = rb

    # depth-first post-order over the forest: leaves first
    post: list = []
    seen_v: set = set()
    seen_f: set = set()
    for root in sorted(names):
        if root in seen_v:
            continue
        stack = [(root, iter(fac_adj[root]))]
        seen_v.add(root)
        while stack:
            var, fac_iter = stack[-1]
            advanced = False
            for fid in fac_iter:
                if fid in seen_f:
                    continue
                seen_f.add(fid)
                for child in fac_vars[fid][1]:
                    if child not in seen_v:
                        seen_v.add(child)
                        stack.append((child, iter(fac_adj[child])))
                        advanced = True
                        break
                if advanced:
                    break
            if not advanced:
                post.append(var)
                stack.pop()
    return post + post[-2::-1]


def schedule_sweep(graph, chains, init_names: set) -> tuple:
    """Greedy topological sweep order; initialized groups count as
    available.  Returns ``(order, auto_init)``: the variables of
    ``auto_init`` were deadlocked on each other but form a tree, scheduled
    as an exact forward and backward BP sweep (``_try_tree_schedule``), or
    are plain groups that a factor touches at two interfaces (they read
    their own marginal on the first sweep); each must be auto-initialized.
    A deadlock that blocks a chain, or a loopy one, is the caller's to
    break with an initialization (``ValueError``, as in the JAX
    package)."""
    remaining = list(graph.random_variables())
    available: set = set(init_names)
    updated: set = set()
    order: list = []
    deps_map = {v.name: _read_deps(v, graph, chains) for v in remaining}
    self_dep: set = set()
    for v in remaining:
        if v.name in chains or v.name in init_names:
            continue
        for f in graph.factors:
            touches = sum(1 for iv in f.all_interfaces().values()
                          if isinstance(iv, Ref) and iv.var is v)
            if touches >= 2:
                self_dep.add(v.name)
                break
    while remaining:
        progressed = False
        for v in list(remaining):
            if all(d in updated or d in available for d in deps_map[v.name]):
                order.append(v.name)
                updated.add(v.name)
                remaining.remove(v)
                progressed = True
        if not progressed:
            tree_order = None
            if not any(v.name in chains for v in remaining):
                tree_order = _try_tree_schedule(remaining, graph)
            if tree_order is None:
                blocked = {v.name: sorted(deps_map[v.name] - updated
                                          - available)
                           for v in remaining}
                raise ValueError(
                    "Model contains initialization cycles; provide "
                    f"initialization for some of: {blocked}. (Reference "
                    "equivalent: @initialization is required for "
                    "variational iterations.)"
                )
            return (order + tree_order,
                    {v.name for v in remaining} | self_dep)
    return order, self_dep


def _prior_init(graph: ModelGraph, name: str, _memo=None, _stack=None):
    """The ancestral seed of an auto-initialized variable: its unplated,
    whole-variable defining factor's ``message_to_out`` with constant
    interfaces as point masses and random inputs seeded the same way,
    recursively (the message the reference's reactive schedule would
    deliver first).  None when the variable has no such factor or the
    cascade fails (the vague marginal is then taken)."""
    from ..dists import PointMass

    _memo = {} if _memo is None else _memo
    _stack = set() if _stack is None else _stack
    if name in _memo:
        return _memo[name]
    if name in _stack:   # a cycle: the vague marginal breaks it
        return None
    _stack = _stack | {name}
    for f in graph.factors:
        if not (f.out.var.kind == "random" and f.out.var.name == name
                and f.out.idx is None and f.plate is None):
            continue
        try:
            q = {}
            for k, v in f.interfaces.items():
                if isinstance(v, Const):
                    q[k] = PointMass(torch.as_tensor(
                        np.asarray(v.value, np.float32)))
                    continue
                seed = None
                if (isinstance(v, Ref) and v.var.kind == "random"
                        and v.idx is None):
                    seed = _prior_init(graph, v.var.name, _memo, _stack)
                if seed is None:
                    raise LookupError(k)
                q[k] = seed
            if f.meta is not None:
                q["_meta"] = {**f.meta, "_plated": False}
            with torch.no_grad():
                out = get_message_rule(f.fform, "out")(q)
            _memo[name] = out
            return out
        except Exception:  # noqa: BLE001 -- any failure: the vague seed
            continue
    _memo[name] = None
    return None


def _vague_for(family: str, event_shape: tuple):
    """The non-informative marginal of an auto-initialized tree-schedule
    variable (the reference's ``vague(T)``).  The Gaussian scale is 1e6,
    not 1e12: cavities are natural-parameter differences in float32, where
    a 1e-12 precision beside an informative one cancels to an exactly flat
    cavity; 1e-6 stays representable and biases a posterior by O(1e-5)
    relative."""
    from .. import dists as D

    f32 = torch.float32
    if family == "gaussian":
        return D.NormalMeanVariance(torch.tensor(0.0), torch.tensor(1.0e6))
    if family == "mv_gaussian":
        d = event_shape[0]
        return D.MvNormalMeanCovariance(torch.zeros(d), 1.0e6 * torch.eye(d))
    if family == "bernoulli":
        return D.BernoulliLogits(torch.tensor(0.0))
    if family == "beta":
        return D.Beta(torch.tensor(1.0), torch.tensor(1.0))
    if family == "gamma":
        return D.GammaShapeRate.vague(f32)
    if family == "inverse_gamma":
        return D.InverseGamma.vague(f32)
    if family == "categorical":
        return D.Categorical(torch.zeros(event_shape[0]))
    if family == "dirichlet":
        return D.Dirichlet.vague(event_shape[0], f32)
    if family == "wishart":
        return D.Wishart.vague(event_shape[0], f32)
    if family == "inverse_wishart":
        return D.InverseWishart.vague(event_shape[0], f32)
    raise ValueError(
        f"No vague initializer for family {family!r}; provide an explicit "
        "initialization for the tree-scheduled variables.")


def _all_finite(data: dict) -> bool:
    """No floating-point leaf holds a NaN or an infinity."""
    for v in data.values():
        if isinstance(v, torch.Tensor):
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                return False
        else:
            a = np.asarray(v)
            if (np.issubdtype(a.dtype, np.floating)
                    and not np.all(np.isfinite(a))):
                return False
    return True


class CompiledModel:
    """Compiled inference plan for one model x data-shape signature."""

    def __init__(self, graph: ModelGraph, init: Optional[dict] = None,
                 options: Optional[dict] = None, constraints: Any = None,
                 meta: Optional[dict] = None):
        options = options or {}
        self.graph = graph
        defaults = graph.default_submodel_constraints
        if defaults or getattr(constraints, "submodel", None):
            from ..graph.constraints import (
                Constraints,
                expand_submodel_constraints,
            )

            if constraints is None:
                constraints = Constraints(factorization=None, forms={},
                                          slot_factorized=[], submodel={})
            constraints = expand_submodel_constraints(graph, constraints,
                                                      defaults)
        self.constraints = constraints
        attach_meta(graph, meta)
        contract_deltas(graph)
        for f in graph.factors:
            if (len(getattr(f, "plates", ())) >= 2
                    and f.out.var.kind == "random"
                    and not isinstance(f.out.idx, tuple)):
                raise NotImplementedError(
                    f"Nested-plate factor {f.fform} defines an anonymous "
                    f"latent ({f.out.var.name}): declare a grid latent "
                    "(z = latent((N, M))) and assign z[i, j] = ... instead."
                )
        # factors a factorization constraint splits: mean-field rule
        # variants, no cavity store, mean-field free-energy accounting
        self.mf_factor_ids = _mean_field_factor_ids(graph, constraints)
        self.infos = resolve_groups(graph)
        attach_delta_ranks(graph)
        normalize_transitions(graph, self.infos)
        self.chains = detect_chains(graph, self.infos)
        check_gcv_factors(graph, self.chains)
        # q(x) = q(x[begin])..q(x[end]): non-chain arrays are slot-factored
        # by construction; a chain is solved exactly, which is strictly
        # tighter, so a request to degrade it raises
        for name in (getattr(constraints, "slot_factorized", None) or []):
            if name not in {v.name for v in graph.random_variables()}:
                raise ValueError(
                    f"slot factorization names unknown variable {name!r}")
            if name in self.chains:
                raise NotImplementedError(
                    f"q({name}) = q({name}[begin])..q({name}[end]) requested "
                    "on a chain variable: the engine solves chains exactly "
                    "(Kalman/forward-backward blocks), which is strictly "
                    "tighter than slot factorization. Remove the constraint.")

        from ..graph.constraints import InitMessage

        init = dict(init or {})
        rv_names = {v.name for v in graph.random_variables()}

        def instances(base: str, local: str) -> list:
            # the variable ``local`` of every instance of the submodel
            # type ``base`` (``base/local``, ``base:2/local``, ...)
            return [n for n in rv_names if n.endswith("/" + local)
                    and _scope_base(n[:-len(local) - 1].split("/")[-1])
                    == base]

        # a ("walk", "tau") key initializes tau in every instance of walk
        for key in [k for k in init if isinstance(k, tuple)]:
            base, local = key
            val = init.pop(key)
            matched = instances(base, local)
            if not matched:
                raise ValueError(
                    f"initialization block ({base!r}, {local!r}) matches no "
                    "variable in the model.")
            for n in matched:
                init.setdefault(n, val)
        # a submodel's default_init fills the instances the user's
        # initialization does not name
        for base, spec in graph.default_submodel_init.items():
            for local, val in spec.items():
                for n in instances(base, local):
                    init.setdefault(n, val)
        init = {k: (v.dist if isinstance(v, InitMessage) else v)
                for k, v in init.items()}
        unknown = set(init) - {v.name for v in graph.random_variables()}
        if unknown:
            raise ValueError(
                f"initialization given for unknown variables {unknown}")
        self.sweep, auto_init = schedule_sweep(graph, self.chains, set(init))
        from ..dists.natural import family_key

        for name in sorted(auto_init - set(init)):
            gi = self.infos[name]
            seed = _prior_init(graph, name)
            if seed is not None:
                # the seed must be of the group's conjugate family (a
                # mixture's out message is not)
                try:
                    if family_key(seed) != gi.family:
                        seed = None
                except TypeError:
                    seed = None
            init[name] = (seed if seed is not None
                          else _vague_for(gi.family, gi.event_shape))
        self.init = init

        unknown = set(options) - _KNOWN_OPTIONS
        if unknown:
            raise ValueError(
                f"Unknown inference options {sorted(unknown)}; available: "
                f"{sorted(_KNOWN_OPTIONS)}."
            )
        # chains solved by the scans of ops/kalman.py and
        # ops/discrete_chain.py: the associative-scan versions from 48
        # slots on unless this is False
        self.use_parallel = options.get("parallel_scans", True)
        # False keeps every chain of a batched program off the fused kernels:
        # build_plans reports it and each block's batch-major update runs
        self.use_fused = options.get("fused_kernels", True)
        # "bfloat16": the smoother kernels store the covariances and the
        # cross between their two passes in bf16 (ops/fused_smoother.py)
        self.fused_moment_dtype = options.get("fused_moment_dtype",
                                              "float32")
        if self.fused_moment_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"fused_moment_dtype {self.fused_moment_dtype!r} not "
                "supported; choose 'float32' or 'bfloat16'.")
        # device-memory budget of a batched program's chain moments (None:
        # engine/batched.py DEFAULT_HBM_BUDGET)
        self.hbm_budget = options.get("hbm_budget_bytes")
        self.warn = options.get("warn", True)
        # a host-driven run (callbacks) stops at a non-finite free energy
        self.check_objective = options.get("check_objective", False)
        # "int8" / "float8_e4m3fn": a batched program quantizes its
        # observations once per call, per (chain, channel) over time
        # (ops/quantized.py), and the chain-evidence einsum of every sweep
        # reads the 1-byte payload and its scales instead of the float32
        # observations (engine/batched.py)
        self.observation_dtype = options.get("observation_dtype", "float32")
        if self.observation_dtype not in ("float32", "int8", "float8_e4m3fn"):
            raise ValueError(
                f"observation_dtype {self.observation_dtype!r} not supported;"
                " choose 'float32', 'int8', or 'float8_e4m3fn'."
            )
        # infer(options={"rulefallback": NodeFunctionRuleFallback()})
        self.rulefallback = options.get("rulefallback")
        if self.rulefallback is not None and not callable(
                getattr(self.rulefallback, "make_rule", None)):
            raise TypeError(
                "options={'rulefallback': ...} takes a "
                "NodeFunctionRuleFallback() (an object with make_rule(fform, "
                f"iface)); got {type(self.rulefallback).__name__}.")
        # strict accuracy mode: every program of this model runs its torch
        # matmuls under the named precision (matmul_precision_scope)
        self.matmul_precision = matmul_precision_scope(
            options.get("matmul_precision"))

        self.blocks: list[tuple[str, Any]] = []
        varmap = {v.name: v for v in graph.random_variables()}
        for name in self.sweep:
            spec = self.chains.get(name)
            shape = self.infos[name].event_shape
            if spec is None:
                self.blocks.append(("plain", self._plain_group(varmap[name])))
            elif spec.kind in ("gaussian", "ar", "gcv"):
                scalar = shape == ()
                cls = {"ar": ARChainBlock, "gcv": GCVChainBlock,
                       "gaussian": GaussianChainBlock}[spec.kind]
                self.blocks.append(("chain", cls(
                    varmap[name], 1 if scalar else shape[0], scalar,
                    spec.prior, spec.transition, spec.evidence,
                    self.use_parallel)))
            elif spec.kind == "discrete":
                m = spec.transition.interfaces["matrix"]
                if isinstance(m, Ref) and m.idx is not None:
                    raise NotImplementedError(
                        f"chain {name!r}: a transition matrix indexed per "
                        "slot is not ported to the PyTorch package yet.")
                self.blocks.append(("chain", DiscreteChainBlock(
                    varmap[name], shape[0], spec.prior, spec.transition,
                    spec.evidence, self.use_parallel)))
        # free-energy plan: the degrees now (static), the factor evaluators
        # when free_energy=True first asks for them
        self._chain_factor_ids = {id(spec.transition)
                                  for spec in self.chains.values()}
        self.degrees = {v.name: slot_degrees(graph, v)
                        for v in graph.random_variables()}
        self._fe_factors = None
        self._fe_degrees: dict = {}
        self._plan_report: Optional[dict] = None
        self._programs: dict = {}

    @property
    def fe_factors(self) -> list:
        if self._fe_factors is None:
            self._fe_factors = [
                FactorFE(
                    f,
                    is_chain_transition=id(f) in self._chain_factor_ids,
                    chain_scalar=(f.out.var.kind == "random"
                                  and f.out.var.name in self.chains
                                  and self.infos[f.out.var.name].event_shape
                                  == ()),
                    mean_field=f.id in self.mf_factor_ids,
                    event_shape=(self.infos[f.out.var.name].event_shape
                                 if f.out.var.kind == "random"
                                 and f.out.var.name in self.infos
                                 else None),
                )
                for f in self.graph.factors
            ]
        return self._fe_factors

    def _free_energy(self, state: dict, chain_cross: dict, data: dict,
                     ctx: BatchContext):
        """The Bethe free energy of the batch at ``state``, (B,): the
        variables' entropy term, then each factor's, in the graph's order
        (``data`` zero-filled where missing, ``ctx.masks`` its masks)."""
        data = self._with_derived(data)
        degrees = self._fe_degrees.get(ctx.device)
        if degrees is None:
            # an array variable's degrees on the device once, not a host
            # copy per sweep
            degrees = self._fe_degrees[ctx.device] = {
                v.name: (torch.as_tensor(self.degrees[v.name],
                                         dtype=torch.float32,
                                         device=ctx.device)
                         if v.is_array else self.degrees[v.name])
                for v in self.graph.random_variables()}
        entropies = variable_entropies(self.graph, state)
        total = variable_entropy_term(self.graph, state, degrees, ctx.batch,
                                      entropies)
        for ffe in self.fe_factors:
            total = total + ffe(state, data, chain_cross, ctx, entropies)
        return total

    def _plain_group(self, var) -> PlainGroup:
        """The conjugate group of a non-chain variable: every interface at
        which a factor touches it, with that interface's rule (the
        ``vmp_`` variant for a mean-field factor; the rule fallback's where
        the node has none), and the variable's form and message-form
        constraints.  Branches of the JAX ``PlainGroup`` this port lacks
        raise here, at compile time."""
        from ..graph.constraints import as_form_constraint
        from ..rules.registry import RuleNotFoundError

        family = self.infos[var.name].family
        if family not in NAT_EVENT_RANKS:
            raise NotImplementedError(
                f"random variable {var.name!r} is a plain conjugate group of "
                f"family {family!r}, which has no natural-parameter view in "
                "the PyTorch package yet (ported: "
                f"{sorted(NAT_EVENT_RANKS)}).")
        adjacency = []
        for f in self.graph.factors:
            # no break: a factor touching the variable at several interfaces
            # sends a message from each of them
            for iface, v in f.all_interfaces().items():
                if isinstance(v, Ref) and v.var is var:
                    self._check_plain_edge(var, f, iface, v)
                    try:
                        rule = get_message_rule(
                            f.fform, iface, vmp=f.id in self.mf_factor_ids)
                    except RuleNotFoundError:
                        if self.rulefallback is None:
                            raise
                        rule = self.rulefallback.make_rule(
                            f.fform, iface, plated=f.plate is not None,
                            batched=tuple(
                                n for n, w in f.all_interfaces().items()
                                if isinstance(w, Ref)))
                    adjacency.append((f, iface, rule))
        cons = self.constraints
        forms = getattr(cons, "forms", None) or {}
        mforms = getattr(cons, "message_forms", None) or {}
        return PlainGroup(var, adjacency, family,
                          form_constraint=as_form_constraint(
                              forms.get(var.name)),
                          mf_ids=self.mf_factor_ids,
                          message_form=as_form_constraint(
                              mforms.get(var.name)),
                          event_ndim=len(self.infos[var.name].event_shape
                                         or ()))

    @staticmethod
    def _check_plain_edge(var, f, iface: str, ref: Ref) -> None:
        where = f"plain group {var.name!r}, factor {f.fform} ({iface})"
        if len(getattr(f, "plates", ())) >= 2:
            return   # PlainGroup._grid_message refuses what it cannot take
        if var.is_array:
            cov = _coverage(f, ref)
            if cov is None or (isinstance(cov, int) and f.plate is not None):
                raise NotImplementedError(
                    f"{where}: an array group must be indexed by a plate "
                    "symbol, or by one slot from an unplated factor.")

    def plan_report(self) -> dict:
        """Per-chain-block kernel-lowering report of the last batched
        program: ``{var: {"fused": bool, "kernel": ... | "reason": ...}}``.
        The single-dataset program has no kernel tier to report."""
        if self._plan_report is None:
            raise ValueError(
                "plan_report() is available after a batched program was "
                "built (batched_program / infer_batched); the single-dataset "
                "path does not lower to the fused kernel tier."
            )
        return dict(self._plan_report)

    def _init_state(self) -> dict:
        """Initial marginals (float32 tensors on the CPU).  An array
        variable's initialization is one slot's, broadcast across the slots,
        or one per slot (its mean has the slot axis in front of the
        variable's event shape).  The JAX package broadcasts a per-slot
        initialization across the slots once more, and a delta rule then
        fails on the doubled slot axis (ROADMAP C10)."""
        state = {}
        for name, spec in self.init.items():
            var = next(v for v in self.graph.random_variables()
                       if v.name == name)
            d = spec() if callable(spec) else spec
            d = tree_map(lambda a: torch.as_tensor(a, dtype=torch.float32), d)
            if var.grid_axes:
                # one slot's initialization broadcast over the grid
                d = tree_map(lambda a: a.expand(tuple(var.grid_axes)
                                                + tuple(a.shape)), d)
            elif var.is_array:
                event = tuple(self.infos[name].event_shape or ())
                mean_shape = tuple(d.mean().shape)
                if mean_shape == (var.length,) + event:
                    state[name] = d
                    continue
                if mean_shape != event:
                    raise ValueError(
                        f"initialization of {name!r}: mean of shape "
                        f"{mean_shape}, expected one slot's {event} or one "
                        f"per slot, {(var.length,) + event}.")
                d = tree_map(
                    lambda a: a.expand((var.length,) + tuple(a.shape)), d)
            state[name] = d
        return state

    def _with_derived(self, data: dict) -> dict:
        """Extend the data dict with folded data expressions (none can be
        built by the port's DSL yet; kept for the program's structure)."""
        dd = getattr(self.graph, "derived_data", None)
        if not dd:
            return data
        out = dict(data)
        for name, fn in dd.items():
            if name not in out:
                out[name] = fn(out)
        return out

    def _device_data(self, data: dict, all_finite: bool, device):
        """The batch's data as float32 tensors on ``device`` (leading batch
        axis on every leaf), with the folded data expressions, and the
        per-factor observation masks.  Data that may hold missing values
        (``all_finite=False``) is zero-filled once here and its factor copies
        masked (``factor_data_mask``); finite data skips both passes."""
        data = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                for k, v in data.items()}
        data = self._with_derived(data)
        masks = {}
        if not all_finite:
            for f in self.graph.factors:
                m = factor_data_mask(f, data)
                if m is not None:
                    masks[f.id] = m
            data = {k: torch.nan_to_num(v) for k, v in data.items()}
        return data, masks

    def _sweep_once(self, state: dict, chain_cross: dict, data: dict,
                    ctx: BatchContext, fused: Optional[dict] = None):
        """One VMP sweep in the compiled order over the batch.  A block
        whose name is in ``fused`` takes that update (a chain: the fused
        kernels of a batched program's plan; a plain group: the pooled
        ``shared=`` update); every other block runs its batch-major
        ``update``.  ``chain_cross`` receives the rule-ready
        pair statistics: Cov(out, in) for Gaussian chains, pair marginals
        for discrete ones."""
        fused = fused or {}
        for kind, block in self.blocks:
            name = block.var.name
            update = fused.get(name, block.update)
            if kind == "chain":
                trace_messages.record(
                    node=f"<chain:{type(block).__name__}>", interface=name,
                    mean_field=False)
            if kind == "plain":
                state[name] = update(state, data, chain_cross, ctx)
                continue
            state[name], chain_cross[name] = update(state, data, chain_cross,
                                                    ctx)
        return state, chain_cross

    def _device_init(self, device) -> dict:
        """The initial marginals on ``device``, without a batch axis."""
        return {name: tree_map(lambda a: a.to(device), d)
                for name, d in self._init_state().items()}

    @staticmethod
    def _broadcast_init(init: dict, batch: int) -> dict:
        """``init`` (``_device_init``) broadcast over a batch."""
        return {name: tree_map(lambda a: a.expand((batch,) + tuple(a.shape)),
                               d) for name, d in init.items()}

    def _iterate(self, data: dict, ctx: BatchContext, init: dict,
                 iterations: int, keep_each: bool,
                 fused: Optional[dict] = None, registry=None,
                 free_energy: bool = False, fe_fn=None):
        """``iterations`` sweeps from ``init`` (``_device_init``) broadcast
        over the batch.  Returns the final state, under ``keep_each`` the
        state after every sweep, and with ``free_energy`` the free energy
        after every sweep, (iterations, B) (else (0, B)); ``fe_fn`` (same
        arguments as ``_free_energy``) replaces the per-dataset free energy
        (the pooled one of ``shared=``: (iterations,)).  With a
        ``registry`` each sweep fires ``before_iteration`` /
        ``after_iteration`` (with the free energy of a batch of one, or
        None) and a handler may stop the loop (``event.stop_iteration``);
        ``check_objective`` then raises at a non-finite free energy."""
        state, _, history, fe = self._sweeps(
            self._broadcast_init(init, ctx.batch), {}, data, ctx, iterations,
            keep_each, fused, registry, free_energy, fe_fn)
        return state, history, fe

    def _sweeps(self, state: dict, chain_cross: dict, data: dict,
                ctx: BatchContext, iterations: int, keep_each: bool,
                fused: Optional[dict] = None, registry=None,
                free_energy: bool = False, fe_fn=None):
        """``iterations`` sweeps from ``state`` and ``chain_cross`` (a
        streaming tick warm-starts from the previous tick's): the final
        state and pair statistics, the per-sweep history and the free
        energy (see ``_iterate``)."""
        history = []
        fes = []
        for i in range(iterations):
            if registry is not None:
                registry.invoke("before_iteration", iteration=i)
            state, chain_cross = self._sweep_once(
                dict(state), dict(chain_cross), data, ctx, fused)
            if free_energy:
                fes.append((fe_fn or self._free_energy)(state, chain_cross,
                                                        data, ctx))
            if keep_each:
                # the cavity stores stay out of the history
                history.append({k: v for k, v in state.items()
                                if not k.startswith("_msg:")})
            if registry is not None:
                fe_host = (float(fes[-1][0]) if free_energy
                           and ctx.batch == 1 else None)
                if (free_energy and self.check_objective
                        and not bool(torch.isfinite(fes[-1]).all())):
                    raise FloatingPointError(
                        f"Bethe free energy became non-finite at iteration "
                        f"{i} ({fes[-1].tolist()}). Reference diagnostic: "
                        "ObjectiveDiagnosticCheckNaNs/Infs "
                        "(src/score/diagnostics.jl) — check the model "
                        "parametrization and initialization.")
                ev = registry.invoke("after_iteration", iteration=i,
                                     free_energy=fe_host)
                if ev.stop_iteration:
                    break
        fe = (torch.stack(fes) if fes
              else torch.zeros((0, ctx.batch), device=ctx.device))
        return state, chain_cross, history, fe

    def make_program(self, iterations: int, free_energy: bool,
                     keep_each: bool, all_finite: bool = True,
                     device: Any = "cuda", registry=None):
        """The single-dataset program: data dict (no batch axis) ->
        (state, fe, history), every chain solved by its block's update
        (the scans of ops/kalman.py and ops/discrete_chain.py, never the
        fused kernels) as a batch of one.  ``fe`` is the free energy after
        each sweep, (iterations,) (an empty (0,) tensor without
        ``free_energy``)."""
        if free_energy:
            # built now, so that an unported branch raises before a sweep
            _ = self.fe_factors
        device = torch.device(device)
        init = self._device_init(device)
        consts: dict = {}   # model constants on the device, kept across calls
        unbatch = lambda st: {k: tree_map(lambda a: a[0], v)
                              for k, v in st.items()}

        def program(data: dict):
            data, masks = self._device_data(
                {k: np.asarray(v)[None] if not isinstance(v, torch.Tensor)
                 else v[None] for k, v in data.items()}, all_finite, device)
            ctx = BatchContext(device, 1, consts, masks)
            state, history, fe = self._iterate(
                data, ctx, init, iterations, keep_each, registry=registry,
                free_energy=free_energy)
            return unbatch(state), fe[:, 0], [unbatch(h) for h in history]

        return self.matmul_precision.wrap(program)

    def run(self, data: dict, iterations: int = 1, free_energy: bool = False,
            keep_each: bool = False, device: Any = "cuda"):
        """Run the single-dataset program (built once per setting)."""
        all_finite = _all_finite(data)
        key = (iterations, free_energy, keep_each, all_finite, str(device))
        if key not in self._programs:
            self._programs[key] = self.make_program(
                iterations, free_energy, keep_each, all_finite, device)
        return self._programs[key](data)

    def run_iterative(self, data: dict, iterations: int, free_energy: bool,
                      registry, keep_each: bool = False,
                      device: Any = "cuda"):
        """Host-driven iterations firing the per-iteration callbacks of
        ``registry``; an ``after_iteration`` handler may stop early."""
        return self.make_program(iterations, free_energy, keep_each,
                                 _all_finite(data), device, registry)(data)

    def predict(self, state: dict, data: dict, varname: str,
                ctx: BatchContext, structured: bool = False):
        """Posterior-predictive distribution of a data variable's slots over
        the batch: its defining factor's forward message under the
        posterior marginals (``state`` and ``data`` batch-major, data
        zero-filled where missing).  ``structured=True`` (data wrapped in
        ``UnfactorizedData``) takes the node's ``message_to_out_structured``
        where it has one, else the out rule, as the JAX package does."""
        data = self._with_derived(data)
        var = self.graph.data_vars[varname]
        factors = [f for f in self.graph.factors if f.out.var is var]
        if len(factors) != 1:
            raise ValueError(
                f"predictvars: data variable {varname} has {len(factors)} "
                "defining factors; prediction needs exactly one."
            )
        f = factors[0]
        rule = None
        if structured:
            rule = getattr(get_node(f.fform), "message_to_out_structured",
                           None)
        if rule is None:
            rule = get_message_rule(f.fform, "out")
        return rule(build_q(f, state, data, exclude="out", ctx=ctx))

    # -- streaming ticks -------------------------------------------------------

    def _tick_context(self, data: dict, all_finite: bool, device,
                      consts: dict):
        """A tick's device data (leading batch axis on every leaf) and its
        ``BatchContext``."""
        data, masks = self._device_data(data, all_finite, device)
        batch = next(iter(data.values())).shape[0]
        return data, BatchContext(device, batch, consts, masks)

    def make_tick_program(self, iterations: int, free_energy: bool,
                          keep_each: bool, cold: bool, device: Any = "cuda",
                          all_finite: bool = True):
        """Streaming-tick program over a batch of streams (every data leaf,
        the autoupdated arguments included, with a leading batch axis) with
        persistent marginals: the engine's marginals keep their latest
        values across observations, only the autoupdated priors change.

        ``cold=True``: ``program(data)`` runs ``iterations`` sweeps from the
        initialization (the first tick).  ``cold=False``:
        ``program(data, state, chain_cross)`` runs them warm-started from
        the previous tick's state and pair statistics.  Both return
        ``(state, fe, history, chain_cross)``, ``fe`` (iterations, B) with
        ``free_energy`` (else (0, B))."""
        if free_energy:
            _ = self.fe_factors
        device = torch.device(device)
        init = self._device_init(device)
        consts: dict = {}

        def run(data, state, chain_cross):
            data, ctx = self._tick_context(data, all_finite, device, consts)
            if state is None:
                state = self._broadcast_init(init, ctx.batch)
            state, chain_cross, history, fe = self._sweeps(
                dict(state), dict(chain_cross or {}), data, ctx, iterations,
                keep_each, free_energy=free_energy)
            return state, fe, history, chain_cross

        run = self.matmul_precision.wrap(run)
        if cold:
            return lambda data: run(data, None, None)
        return lambda data, state, chain_cross: run(data, state, chain_cross)

    def run_tick(self, data: dict, iterations: int, free_energy: bool,
                 keep_each: bool = False, carry=None, device: Any = "cuda",
                 all_finite: bool = True):
        """One streaming tick; ``carry`` is the previous tick's ``(state,
        chain_cross)`` or None for a cold start.  Returns ``(state, fe,
        history, carry')``; the programs are built once per setting."""
        cold = carry is None
        key = ("tick", cold, iterations, free_energy, keep_each, str(device),
               all_finite)
        if key not in self._programs:
            self._programs[key] = self.make_tick_program(
                iterations, free_energy, keep_each, cold, device, all_finite)
        prog = self._programs[key]
        state, fe, history, cross = (prog(data) if cold
                                     else prog(data, *carry))
        return state, fe, history, (state, cross)

    def make_sweep_fn(self, free_energy: bool, device: Any = "cuda",
                      all_finite: bool = True):
        """One VMP sweep as a carry function, ``fn((state, chain_cross),
        data) -> ((state, chain_cross), fe)`` with ``fe`` (B,) (an empty
        tensor without ``free_energy``): the host loop of a streaming tick
        with per-iteration events."""
        if free_energy:
            _ = self.fe_factors
        device = torch.device(device)
        consts: dict = {}

        def fn(carry, data):
            data, ctx = self._tick_context(data, all_finite, device, consts)
            state, chain_cross = self._sweep_once(
                dict(carry[0]), dict(carry[1]), data, ctx)
            fe = (self._free_energy(state, chain_cross, data, ctx)
                  if free_energy else torch.zeros((0,), device=device))
            return (state, chain_cross), fe

        return self.matmul_precision.wrap(fn)

    def variable_outbound_message(self, state: dict, data: dict,
                                  varname: str, ctx: BatchContext):
        """mu(x) over the batch: the outbound message from variable x along
        its last edge, the marginal divided by the message of the factor
        attached last (``data`` as ``_device_data`` gives it).

        A chain variable returns the per-slot outbound message: the
        marginal divided by the last evidence factor's message at every
        slot (the plate DSL folds a loop into one factor, so the last edge
        is the last evidence factor in graph order; for the usual
        state-space form this is the observation likelihood, and mu(x) is
        the smoothed state with its own observation left out)."""
        from ..dists.natural import nat_div

        for kind, block in self.blocks:
            if block.var.name != varname:
                continue
            if kind == "plain":
                f, iface, rule = block.adjacency[-1]
                # a rule that reads its own marginal sees it here too
                needs_self = getattr(get_node(f.fform),
                                     "needs_self_marginal", False)
                q = build_q(f, state, data,
                            exclude=None if needs_self else iface, ctx=ctx)
                msg = mask_message(rule(q), ctx.masks.get(f.id))
                return nat_div(state[varname], msg)
            return self._chain_outbound_message(block, state, data, ctx)
        raise ValueError(
            f"mu({varname}): the model has no random variable named "
            f"{varname!r}.")

    def _chain_outbound_message(self, block, state: dict, data: dict,
                                ctx: BatchContext):
        """Per-slot mu of a chain block: marginal / last evidence message."""
        from ..dists import (
            Categorical,
            MvNormalWeightedMeanPrecision,
            NormalWeightedMeanPrecision,
        )
        from ..dists.gaussian import (
            as_mv_weighted_mean_precision,
            as_weighted_mean_precision,
        )

        spec = self.chains[block.var.name]
        order = {id(f): i for i, f in enumerate(self.graph.factors)}
        if not spec.evidence:
            raise NotImplementedError(
                f"mu({block.var.name}): the chain has no evidence factors; "
                "its last edge is the transition, whose outbound is the "
                "filtered forward message — use the filtering model form "
                "instead (reference performance-tips.md:36-38).")
        f, iface = max(spec.evidence, key=lambda fi: order[id(fi[0])])
        if order[id(spec.transition)] > order[id(f)] or (
                order[id(spec.prior)] > order[id(f)]):
            raise NotImplementedError(
                f"mu({block.var.name}): the chain's last-created factor is "
                "its prior/transition; per-edge messages toward transitions "
                "are not exposed (write the observation plate last, or use "
                "q() arguments).")
        ref = f.out if iface == "out" else f.interfaces[iface]
        if _coverage(f, ref) != (0, block.var.length):
            raise NotImplementedError(
                f"mu({block.var.name}): the last evidence factor covers "
                f"slots {_coverage(f, ref)}, not the full chain; "
                "partial-coverage mu is not supported.")
        marg = state[block.var.name]
        mask = ctx.masks.get(f.id)
        if isinstance(block, DiscreteChainBlock):
            q = build_q(f, state, data, exclude=iface, ctx=ctx)
            logits = get_message_rule(f.fform, iface)(q).logits
            if mask is not None:
                logits = logits * mask[..., None]
            return Categorical(marg.logits - logits)
        mxi, mw, _ = block._evidence_msg(f, iface, state, data, ctx)
        if mask is not None:
            mxi = mxi * mask[..., None]
            mw = mw * mask[..., None, None]
        if block.scalar:
            nat = as_weighted_mean_precision(marg)
            return NormalWeightedMeanPrecision(nat.xi - mxi[..., 0],
                                               nat.w - mw[..., 0, 0])
        nat = as_mv_weighted_mean_precision(marg)
        return MvNormalWeightedMeanPrecision(nat.xi - mxi, nat.w - mw)

    def make_batched_program(self, data0: dict, iterations: int,
                             free_energy: bool, keep_each: bool = False,
                             all_finite: bool = True,
                             device: Any = "cuda",
                             batch_hint: Optional[int] = None,
                             shared: tuple = ()):
        """Batch-native program over B independent datasets whose chain
        blocks run on the fused kernels (engine/batched.py); ``batch_hint``
        is the batch it will see (the planner's memory gate), ``shared``
        the plain groups pooled over it."""
        from .batched import make_batched_program

        return make_batched_program(
            self, data0, iterations, free_energy, keep_each=keep_each,
            all_finite=all_finite, device=device, batch_hint=batch_hint,
            shared=shared)
