"""Graph -> static schedule compiler (counterpart of
``rxinfer_tpu/engine/compile.py``).

Lowering pipeline, as in the JAX package: contract Gaussian means over
anonymous deltas, fold plain-Gaussian lag transitions into LinearGaussian
fforms, detect chain blocks, schedule the sweep, and build the programs:
the single-dataset program of ``infer`` (``make_program`` / ``run`` /
``run_iterative``) and the batched program (engine/batched.py).

Ported subset: ``contract_deltas``, ``normalize_transitions``,
``detect_chains``, ``schedule_sweep`` and the parts of ``CompiledModel`` that
models of Gaussian chains, discrete chains and plain conjugate groups need
with ``constraints=None``: block construction with compile-time rule
resolution, ``_init_state``, ``plan_report``, ``_with_derived``, the sweep
(``_sweep_once``, batch-major under a ``BatchContext``: one dataset is a
batch of one), ``make_program``, ``run``, ``run_iterative`` (host loop with
per-iteration callbacks), ``predict`` and ``make_batched_program``.  A plain
group is built for every random variable that is not a chain, in a family
the port has a natural-parameter view for (``gaussian``, ``mv_gaussian``,
``categorical``, ``dirichlet_collection``).  Not ported yet (they raise
``NotImplementedError``): plain groups of other families (``gamma``,
``wishart``, ...), the plain-group branches listed in ``engine/blocks.py``,
AR/GCV chains, constraints, meta, tree-scheduled (auto-initialized) loopy
models, free energy, streaming ticks and ``mu()`` outbound messages.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

import numpy as np
import torch

from ..dists import tree_map
from ..dists.natural import NAT_EVENT_RANKS
from ..graph.ir import Const, Factor, ModelGraph, Ref, SymIndex
from ..rules.registry import get_message_rule, get_node
from .blocks import (
    BatchContext,
    DiscreteChainBlock,
    GaussianChainBlock,
    PlainGroup,
    _coverage,
    build_q,
    factor_data_mask,
    in_cavity_cluster,
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


def schedule_sweep(graph, chains, init_names: set[str]) -> list[str]:
    """Greedy topological sweep order; initialized groups count as
    available.  A deadlock that blocks a chain is the caller's to break with
    an initialization (``ValueError``, as in the JAX package); a chain-free
    deadlock would take the JAX package's exact tree schedule, which is not
    ported yet (``NotImplementedError``)."""
    remaining = list(graph.random_variables())
    available: set[str] = set(init_names)
    updated: set[str] = set()
    order: list[str] = []
    deps_map = {v.name: _read_deps(v, graph, chains) for v in remaining}
    while remaining:
        progressed = False
        for v in list(remaining):
            if all(d in updated or d in available for d in deps_map[v.name]):
                order.append(v.name)
                updated.add(v.name)
                remaining.remove(v)
                progressed = True
        if not progressed:
            blocked = {v.name: sorted(deps_map[v.name] - updated - available)
                       for v in remaining}
            if any(v.name in chains for v in remaining):
                raise ValueError(
                    "Model contains initialization cycles; provide "
                    f"initialization for some of: {blocked}. (Reference "
                    "equivalent: @initialization is required for "
                    "variational iterations.)"
                )
            raise NotImplementedError(
                "Model contains initialization cycles "
                f"({blocked}); tree schedules and loopy models are not "
                "ported to the PyTorch package yet."
            )
    return order


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
        if constraints is not None:
            raise NotImplementedError(
                "constraints are not ported to the PyTorch package yet.")
        if meta:
            raise NotImplementedError(
                "meta is not ported to the PyTorch package yet.")
        self.graph = graph
        contract_deltas(graph)
        for f in graph.factors:
            if (len(getattr(f, "plates", ())) >= 2
                    and f.out.var.kind == "random"
                    and not isinstance(f.out.idx, tuple)):
                raise NotImplementedError(
                    f"Nested-plate factor {f.fform} defines an anonymous "
                    f"latent ({f.out.var.name}); grid latents are not ported "
                    "yet."
                )
        self.infos = resolve_groups(graph)
        normalize_transitions(graph, self.infos)
        self.chains = detect_chains(graph, self.infos)

        from ..graph.constraints import InitMessage

        init = {k: (v.dist if isinstance(v, InitMessage) else v)
                for k, v in dict(init or {}).items()}
        unknown = set(init) - {v.name for v in graph.random_variables()}
        if unknown:
            raise ValueError(
                f"initialization given for unknown variables {unknown}")
        self.sweep = schedule_sweep(graph, self.chains, set(init))
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
        if options.get("fused_moment_dtype", "float32") != "float32":
            raise NotImplementedError(
                'options={"fused_moment_dtype": '
                f'{options["fused_moment_dtype"]!r}}} is not ported to the '
                "PyTorch package yet (float32 only)."
            )
        self.warn = options.get("warn", True)
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
        for key in ("rulefallback", "matmul_precision"):
            if options.get(key) is not None:
                raise NotImplementedError(
                    f"options={{{key!r}: ...}} is not ported to the PyTorch "
                    "package yet.")

        self.blocks: list[tuple[str, Any]] = []
        varmap = {v.name: v for v in graph.random_variables()}
        for name in self.sweep:
            spec = self.chains.get(name)
            shape = self.infos[name].event_shape
            if spec is None:
                self.blocks.append(("plain", self._plain_group(varmap[name])))
            elif spec.kind == "gaussian":
                scalar = shape == ()
                self.blocks.append(("chain", GaussianChainBlock(
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
            else:
                raise NotImplementedError(
                    f"chain {name!r} is a {spec.kind} chain: only Gaussian "
                    "and discrete chains are ported to the PyTorch package "
                    "yet."
                )
        self._plan_report: Optional[dict] = None
        self._programs: dict = {}

    def _plain_group(self, var) -> PlainGroup:
        """The conjugate group of a non-chain variable: every interface at
        which a factor touches it, with that interface's rule.  Branches of
        the JAX ``PlainGroup`` this port lacks raise here, at compile
        time."""
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
                    adjacency.append(
                        (f, iface, get_message_rule(f.fform, iface)))
        return PlainGroup(var, adjacency)

    @staticmethod
    def _check_plain_edge(var, f, iface: str, ref: Ref) -> None:
        where = f"plain group {var.name!r}, factor {f.fform} ({iface})"
        if len(getattr(f, "plates", ())) >= 2:
            raise NotImplementedError(
                f"{where}: grid (nested-plate) factors are not ported yet.")
        if f.dependencies is not None:
            raise NotImplementedError(
                f"{where}: required-message dependencies are not ported "
                "yet.")
        node_cls = get_node(f.fform)
        if getattr(node_cls, "needs_self_marginal", False):
            raise NotImplementedError(
                f"{where}: rules that read their own marginal are not "
                "ported yet.")
        if in_cavity_cluster(node_cls, iface):
            for name, v in f.all_interfaces().items():
                if (name != iface and in_cavity_cluster(node_cls, name)
                        and isinstance(v, Ref) and v.var.kind == "random"):
                    raise NotImplementedError(
                        f"{where}: its cavity cluster also holds the random "
                        f"variable {v.var.name!r}, which needs the EP "
                        "message store (cavity division); it is not ported "
                        "yet.")
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
        """Initial marginals (float32 tensors on the CPU), broadcast across
        the slots of array variables."""
        state = {}
        for name, spec in self.init.items():
            var = next(v for v in self.graph.random_variables()
                       if v.name == name)
            d = spec() if callable(spec) else spec
            d = tree_map(lambda a: torch.as_tensor(a, dtype=torch.float32), d)
            if var.is_array:
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
        """One VMP sweep in the compiled order over the batch.  A chain
        whose name is in ``fused`` takes that update (the fused kernels of a
        batched program's plan); every other chain runs its block's
        batch-major ``update``.  ``chain_cross`` receives the rule-ready
        pair statistics: Cov(out, in) for Gaussian chains, pair marginals
        for discrete ones."""
        fused = fused or {}
        for kind, block in self.blocks:
            name = block.var.name
            if kind == "plain":
                state[name] = block.update(state, data, chain_cross, ctx)
                continue
            update = fused.get(name, block.update)
            state[name], chain_cross[name] = update(state, data, chain_cross,
                                                    ctx)
        return state, chain_cross

    def _device_init(self, device) -> dict:
        """The initial marginals on ``device``, without a batch axis."""
        return {name: tree_map(lambda a: a.to(device), d)
                for name, d in self._init_state().items()}

    def _iterate(self, data: dict, ctx: BatchContext, init: dict,
                 iterations: int, keep_each: bool,
                 fused: Optional[dict] = None, registry=None):
        """``iterations`` sweeps from ``init`` (``_device_init``) broadcast
        over the batch.  Returns the final state and, under ``keep_each``,
        the state after every sweep.  With a ``registry`` each sweep fires
        ``before_iteration`` / ``after_iteration`` and a handler may stop
        the loop (``event.stop_iteration``)."""
        state = {name: tree_map(
            lambda a: a.expand((ctx.batch,) + tuple(a.shape)), d)
            for name, d in init.items()}
        chain_cross: dict = {}
        history = []
        for i in range(iterations):
            if registry is not None:
                registry.invoke("before_iteration", iteration=i)
            state, chain_cross = self._sweep_once(
                dict(state), dict(chain_cross), data, ctx, fused)
            if keep_each:
                history.append(dict(state))
            if registry is not None:
                ev = registry.invoke("after_iteration", iteration=i,
                                     free_energy=None)
                if ev.stop_iteration:
                    break
        return state, history

    def make_program(self, iterations: int, free_energy: bool,
                     keep_each: bool, all_finite: bool = True,
                     device: Any = "cuda", registry=None):
        """The single-dataset program: data dict (no batch axis) ->
        (state, fe, history), every chain solved by its block's update
        (the scans of ops/kalman.py and ops/discrete_chain.py, never the
        fused kernels) as a batch of one.  ``fe`` is an empty (0,) tensor:
        free energy is not ported yet."""
        if free_energy:
            raise NotImplementedError(
                "free_energy=True is not ported to the PyTorch package yet "
                "(ROADMAP A2).")
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
            state, history = self._iterate(data, ctx, init, iterations,
                                           keep_each, registry=registry)
            return (unbatch(state), torch.zeros((0,), device=device),
                    [unbatch(h) for h in history])

        return program

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

    def make_batched_program(self, data0: dict, iterations: int,
                             free_energy: bool, keep_each: bool = False,
                             all_finite: bool = True,
                             device: Any = "cuda"):
        """Batch-native program over B independent datasets whose chain
        blocks run on the fused kernels (engine/batched.py)."""
        from .batched import make_batched_program

        return make_batched_program(
            self, data0, iterations, free_energy, keep_each=keep_each,
            all_finite=all_finite, device=device)
