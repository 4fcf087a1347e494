"""Factor-graph intermediate representation (counterpart of
``rxinfer_tpu/graph/ir.py``, which imports no JAX; the port keeps its own copy
so that it never imports the JAX package).

The text below is the JAX package's; "XLA program" and ``lax.scan`` read as
"the port's batched program" and its kernels.

The reference builds a bipartite variable/factor graph at runtime via GraphPPL and
hangs ReactiveMP runtime objects off it (src/model/plugins/reactivemp_inference.jl).
Here the graph is a *static, plate-aware* IR produced by tracing a Python ``@model``
function once per data-shape signature, then compiled ahead of time to an XLA
program (SURVEY.md §7 architecture stance).

Plate-awareness is the load-bearing difference: a T-step chain is ONE plated factor
with a lag-1 self-reference, not T factor objects — which is what lets the compiler
lower chains to ``lax.scan`` / associative scans instead of discovering schedules
reactively at runtime (reference: Rocket push streams, src/inference/streaming.jl).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np


class Plate:
    """A replication axis: factors/variables tagged with a plate represent
    ``size`` isomorphic copies indexed by t ∈ [lo, hi).

    Reference equivalents: broadcasting ``.~`` and indexed loops in @model bodies
    (docs/src/manuals/model-specification.md:255-274)."""

    _counter = 0

    def __init__(self, lo: int, hi: int, name: Optional[str] = None):
        Plate._counter += 1
        self.id = Plate._counter
        self.lo = int(lo)
        self.hi = int(hi)
        self.name = name or f"plate{self.id}"

    @property
    def size(self) -> int:
        return self.hi - self.lo

    def __repr__(self):
        return f"Plate({self.name}, [{self.lo},{self.hi}))"


@dataclasses.dataclass(frozen=True)
class SymIndex:
    """Symbolic index ``t + offset`` into a variable array, relative to a plate."""

    plate: Plate
    offset: int = 0

    def __add__(self, k: int) -> "SymIndex":
        return SymIndex(self.plate, self.offset + int(k))

    def __sub__(self, k: int) -> "SymIndex":
        return SymIndex(self.plate, self.offset - int(k))

    def __repr__(self):
        sign = "+" if self.offset >= 0 else ""
        return f"{self.plate.name}{sign}{self.offset if self.offset else ''}"


Index = Union[None, int, SymIndex]


class Variable:
    """A model variable (scalar or array over one axis).

    kind: 'random' (latent), 'data' (observed, value injected at run time),
    'const' (hyperparameter baked at trace time).

    Reference: randomvar/datavar/constvar runtime objects
    (src/model/plugins/reactivemp_inference.jl:328-354); here just IR records."""

    def __init__(self, name: str, kind: str, length: Optional[int] = None):
        assert kind in ("random", "data", "const")
        self.name = name
        self.kind = kind
        self.length = length  # None => scalar variable; int => array variable
        # Submodel scope path: instance segments like ("walk", "inner:2") for a
        # variable created inside nested ``with rx.scope(...)`` blocks (reference:
        # GraphPPL nested contexts; used by submodel-scoped constraints).
        self.scope: tuple = ()
        # For grid variables (``y[i, j]`` data / ``z[i, j]`` latents): the
        # leading plate-axis sizes; such variables have length None (their
        # state/posterior carries the full grid batch).
        self.grid_axes: Optional[tuple] = None
        # Filled during lowering:
        self.event_shape: Optional[tuple] = None
        self.dtype: Any = None

    @property
    def is_array(self) -> bool:
        return self.length is not None

    def __repr__(self):
        suffix = f"[{self.length}]" if self.is_array else ""
        return f"{self.kind}:{self.name}{suffix}"


@dataclasses.dataclass(frozen=True)
class Ref:
    """Reference to a variable (slot): (variable, index)."""

    var: Variable
    idx: Index = None

    def __repr__(self):
        if self.idx is None:
            return self.var.name
        return f"{self.var.name}[{self.idx}]"


@dataclasses.dataclass(frozen=True)
class Const:
    """A constant interface value, baked into the compiled program at trace time.

    ``value`` is a host numpy array (or scalar).  If ``plate_indexed`` is set the
    constant is an array over the plate axis and each plate copy sees its slice."""

    value: Any
    plate_indexed: bool = False

    def __repr__(self):
        v = np.asarray(self.value)
        return f"Const(shape={v.shape})" if v.ndim else f"Const({v})"


InterfaceValue = Union[Ref, Const]


class Factor:
    """A factor node: named interfaces → variable refs or constants.

    ``fform`` is the canonical node-function name used for rule lookup, mirroring
    the reference's node types after alias resolution (src/model/graphppl.jl:340-423)
    — e.g. ``Normal(mean=, precision=)`` canonicalizes to 'NormalMeanPrecision'.

    ``out`` is the sample interface (the variable this factor "defines" when used as
    a generative statement)."""

    _counter = 0

    def __init__(
        self,
        fform: str,
        out: Ref,
        interfaces: dict[str, InterfaceValue],
        plate: Optional[Plate] = None,
        meta: Any = None,
    ):
        Factor._counter += 1
        self.id = Factor._counter
        self.fform = fform
        self.out = out
        self.interfaces = dict(interfaces)  # does NOT include 'out'
        self.plate = plate
        # Full active plate stack (outer→inner).  len >= 2 marks a NESTED-plate
        # factor: one factor object standing for a grid of
        # prod(p.size) copies, lowered to batched rules + per-axis
        # natural-parameter reductions (reference: replication over products of
        # loop indices in @model bodies).
        self.plates: tuple = (plate,) if plate is not None else ()
        self.meta = meta
        # Optional RequireMessage functional-dependencies override (reference
        # `where {dependencies = RequireMessageFunctionalDependencies(...)}`,
        # docs/src/manuals/model-specification.md:471-480).
        self.dependencies = None
        # Submodel scope path of the creating context (see Variable.scope).
        self.scope: tuple = ()
        # True for factors attached to an already-defined variable (reference:
        # a second `x ~ ...` statement on the same variable — soft evidence);
        # excluded from the one-generative-statement-per-slot validation.
        self.evidence = False

    def all_interfaces(self) -> dict[str, InterfaceValue]:
        return {"out": self.out, **self.interfaces}

    def random_interfaces(self) -> dict[str, Ref]:
        return {
            k: v
            for k, v in self.all_interfaces().items()
            if isinstance(v, Ref) and v.var.kind == "random"
        }

    def __repr__(self):
        ifc = ", ".join(f"{k}={v}" for k, v in self.interfaces.items())
        p = f" @{self.plate.name}" if self.plate else ""
        return f"{self.fform}(out={self.out}, {ifc}){p}"


class ModelGraph:
    """The complete traced model: variables, factors, plates, and the data slots."""

    def __init__(self, name: str = "model"):
        self.name = name
        self.variables: list[Variable] = []
        self.factors: list[Factor] = []
        self.plates: list[Plate] = []
        self.data_vars: dict[str, Variable] = {}
        # derived data entries: name -> fn(data_dict) -> tensor, evaluated
        # with the data (CompiledModel._with_derived) (reference: data variables fold
        # automatically, test/models/models_tests.jl:221+ — `x ~ Normal(mean=
        # a + b, ...)` with data-valued a, b creates anonymous folded data)
        self.derived_data: dict[str, Any] = {}
        # submodel base name -> the Constraints / initialization dict that
        # ``@submodel(default_constraints=, default_init=)`` declared for
        # every instance of that submodel type
        self.default_submodel_constraints: dict[str, Any] = {}
        self.default_submodel_init: dict[str, dict] = {}

    # -- construction ------------------------------------------------------------
    def add_variable(self, v: Variable) -> Variable:
        self.variables.append(v)
        if v.kind == "data":
            self.data_vars[v.name] = v
        return v

    def add_factor(self, f: Factor) -> Factor:
        self.factors.append(f)
        return f

    def add_plate(self, p: Plate) -> Plate:
        self.plates.append(p)
        return p

    # -- queries -----------------------------------------------------------------
    def random_variables(self) -> list[Variable]:
        return [v for v in self.variables if v.kind == "random"]

    def defining_factors(self, var: Variable) -> list[Factor]:
        return [f for f in self.factors if f.out.var is var]

    def using_factors(self, var: Variable) -> list[Factor]:
        out = []
        for f in self.factors:
            for k, v in f.interfaces.items():
                if isinstance(v, Ref) and v.var is var:
                    out.append(f)
                    break
        return out

    def neighbors(self, var: Variable) -> list[Factor]:
        """All factors touching ``var`` on any interface (degree counts slots)."""
        res = []
        for f in self.factors:
            for v in f.all_interfaces().values():
                if isinstance(v, Ref) and v.var is var:
                    res.append(f)
                    break
        return res

    def degree(self, var: Variable) -> int:
        """Per-slot degree: number of factor copies touching each slot.

        For plated variables this is the degree of an interior slot (used by the
        Bethe entropy term (d_i - 1) H(q_i),
        reference src/model/plugins/reactivemp_free_energy.jl:71-78)."""
        deg = 0
        for f in self.factors:
            for v in f.all_interfaces().values():
                if isinstance(v, Ref) and v.var is var:
                    deg += 1
        return deg

    # -- validation ----------------------------------------------------------------
    def validate(self):
        """Every random/data slot must be defined exactly once (coverage check).

        This is the compile-time equivalent of the reference's update-flag protocol
        (src/inference/inference.jl:46-86): instead of checking at runtime that every
        marginal updated, we prove at compile time that every slot has exactly one
        generative definition."""
        for v in self.variables:
            if v.kind == "const":
                continue
            slots = np.zeros(v.length if v.is_array else 1, dtype=np.int64)
            for f in self.factors:
                if f.out.var is not v or f.evidence:
                    continue
                idx = f.out.idx
                if isinstance(idx, tuple):
                    # grid slot y[i, j] / z[i, j]: full-coverage by construction
                    # (the DSL enforces zero offsets over full plates)
                    slots[0] += 1
                elif idx is None:
                    slots[0] += 1
                elif isinstance(idx, int):
                    slots[idx] += 1
                elif isinstance(idx, SymIndex):
                    lo = f.plate.lo + idx.offset
                    hi = f.plate.hi + idx.offset
                    slots[lo:hi] += 1
            if v.kind == "random":
                if not np.all(slots == 1):
                    bad = np.where(slots != 1)[0][:5]
                    raise ValueError(
                        f"Random variable {v.name}: slots {bad.tolist()} defined "
                        f"{slots[bad].tolist()} times (each latent slot needs exactly "
                        "one generative statement)."
                    )
            else:  # data
                if not np.all(slots <= 1):
                    bad = np.where(slots > 1)[0][:5]
                    raise ValueError(
                        f"Data variable {v.name}: slots {bad.tolist()} observed more "
                        "than once."
                    )

    def __repr__(self):
        lines = [f"ModelGraph({self.name})"]
        for v in self.variables:
            lines.append(f"  var {v}")
        for f in self.factors:
            lines.append(f"  factor {f}")
        return "\n".join(lines)
