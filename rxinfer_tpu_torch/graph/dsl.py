"""Python ``@model`` DSL (counterpart of ``rxinfer_tpu/graph/dsl.py``).

``@model``, ``latent``, ``plate``, ``Normal``/``MvNormal`` with their
keyword aliases (``gamma=`` the scale precision: ``MvNormalMeanScalePrecision``,
or a scalar ``NormalMeanPrecision``), data assignment ``y[t] = ...`` and
``y.observe(...)`` (a whole data variable, as a streaming tick observes),
``numpy_array @ x[t]`` (or ``a * x[t] + b``) folding into a LinearGaussian
factor, ``dot(a, x)`` with a constant vector or a data slot ``a`` folding
into a GaussianDot factor, sums of random terms (``a + b`` folding into a
GaussianSum factor under a Gaussian mean, ``A @ x + B @ u`` into a
``LinComb`` node, ``Sum(...)`` and ``lincomb(...)`` standalone),
``Categorical``, ``Dirichlet``, ``DirichletCollection``, ``Transition``
(alias ``DiscreteTransition``), ``Gamma`` (shape/rate or shape/scale, with
the aliases ``a=``, ``b=``), ``InverseGamma``, ``Wishart``,
``InverseWishart``, ``Beta``, ``Bernoulli``, ``Binomial``, ``Poisson``,
``Multinomial``, ``Uniform``, ``Uninformative``, ``NormalMixture`` (the
multivariate mixture when the component means are vectors),
``GammaMixture``, ``Mixture``, ``AR`` (with ``ARMeta`` / ``ARsafe`` /
``ARunsafe``), ``GCV``, ``Delta`` (its output feeding a Gaussian mean
contracts to a NonlinearGaussian factor), ``Probit``, ``SoftDot``,
``factor_node`` (a user-registered node) and ``with where(meta=,
dependencies=RequireMessage(...)):`` blocks.  Model constants stay numpy
arrays, as in the JAX package; numpy defers ``A @ x`` to
``RVRef.__rmatmul__``.  Outside a trace the node constructors build
distributions of torch tensors, and such a distribution object used inside
a trace becomes a prior factor of its own (one per object, as the JAX
package's ``_lift_dist`` does).

Nested plates: ``y[i, j]`` indexes grid data and ``z = latent((N, M))``
declares a grid latent, ``z[i, j] = Node(...)`` defining every slot at once
(``_check_grid_key``: symbolic indices over full plates, in the nesting
order); a factor emitted inside nested plates records them all in
``plates``.  The logic nodes ``OR``, ``AND``, ``NOT``, ``IMPLY`` and
``tie`` (a second factor on an existing random variable), the Polya
regressions ``BinomialPolya`` / ``MultinomialPolya`` and
``ContinuousTransition``.  Nested calls emit their inner factors first
(``x = IMPLY(a, NOT(b))`` emits NOT before IMPLY), so the assignment target
names the last emit of its statement.

Submodels: ``with scope("walk"):`` prefixes the names of the variables
created inside with ``walk/`` (instances of a repeated name are ``walk``,
``walk:2``, ...) and records the scope path on the IR; ``@submodel`` opens
such a scope at every call of a function and attaches its
``default_constraints`` / ``default_init`` to every instance; under
``trace(data, allow_node_contraction=True)`` a submodel whose name is a
registered node becomes one factor of that node.  Data arithmetic (``a + b
- 1``, ``a * b``, ``-a``, ``a / b`` over data variables and numbers) folds
into a derived data variable, a torch function of the runtime data dict
(``graph.derived_data``).  ``dot`` with two random arguments raises
``TypeError``, as in the JAX package: the model writes ``SoftDot``.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np

from .ir import Const, Factor, ModelGraph, Plate, Ref, SymIndex, Variable

_STATE = threading.local()


def _builder() -> "ModelBuilder":
    b = getattr(_STATE, "builder", None)
    if b is None:
        raise RuntimeError(
            "Node constructors can only be used inside an @model function trace."
        )
    return b


def _active() -> Optional["ModelBuilder"]:
    return getattr(_STATE, "builder", None)


# -- symbolic expressions over random variables -----------------------------------

class RVRef:
    """Reference to a random-variable (or data) slot; ``A @ x`` and
    ``a * x + b`` build linear expressions folded into LinearGaussian factors."""

    __array_ufunc__ = None  # make numpy defer binary ops to us

    def __init__(self, ref: Ref):
        self.ref = ref

    def __rmatmul__(self, a):
        return LinearExpr(np.asarray(a), self, None)

    def __mul__(self, c):
        c = np.asarray(c)
        if c.ndim > 2:
            raise TypeError("rv multipliers must be scalar, vector, or matrix.")
        return LinearExpr(c, self, None)

    __rmul__ = __mul__

    def __add__(self, b):
        if isinstance(b, (RVRef, LinearExpr)):
            return AddExpr((self, b))
        return LinearExpr(None, self, np.asarray(b))

    __radd__ = __add__

    def __sub__(self, b):
        return LinearExpr(None, self, -np.asarray(b))

    def __neg__(self):
        return LinearExpr(np.asarray(-1.0), self, None)

    def __repr__(self):
        return f"RVRef({self.ref})"


class LinearExpr:
    """a @ x + b (or scalar a * x + b)."""

    __array_ufunc__ = None

    def __init__(self, a, x: RVRef, b):
        self.a = a
        self.x = x
        self.b = b

    def __add__(self, b2):
        if isinstance(b2, (RVRef, LinearExpr)):
            # a combination of random terms: A @ x + B @ u (+ ...)
            return AddExpr((self, b2))
        b2 = np.asarray(b2)
        b = b2 if self.b is None else self.b + b2
        return LinearExpr(self.a, self.x, b)

    __radd__ = __add__

    def __rmatmul__(self, a2):
        a2 = np.asarray(a2)
        if self.b is not None:
            b = a2 @ self.b if np.ndim(self.b) else a2 * self.b
        else:
            b = None
        a = a2 if self.a is None else (
            a2 @ self.a if np.ndim(self.a) >= 2 else a2 * self.a)
        return LinearExpr(a, self.x, b)

    def __mul__(self, c):
        c = np.asarray(c)
        a = c if self.a is None else c * self.a
        b = None if self.b is None else c * self.b
        return LinearExpr(a, self.x, b)

    __rmul__ = __mul__


class AddExpr:
    """A sum of random terms: plain random variables (a ``Sum`` node, or a
    GaussianSum factor under a Gaussian mean) or linear-map terms ``A @ x``
    (a ``LinComb`` node)."""

    __array_ufunc__ = None

    def __init__(self, terms):
        self.terms = tuple(terms)

    def __add__(self, other):
        if isinstance(other, (RVRef, LinearExpr)):
            return AddExpr(self.terms + (other,))
        raise TypeError("rv-sum expressions support rv / A @ rv terms only.")

    __radd__ = __add__

    @property
    def has_linear_terms(self):
        return any(isinstance(t, LinearExpr) for t in self.terms)


def dot(a, x: RVRef) -> LinearExpr:
    """Inner product of a known vector with a random vector (the
    reference's ``dot``).  ``a`` is a constant vector or a slot of a data
    array, e.g. regression features: ``y[i] = Normal(mean=dot(phi[i],
    theta), var=1.0)``."""
    if isinstance(a, RVRef):
        if a.ref.var.kind != "data":
            raise TypeError(
                "dot() with two random arguments needs the SoftDot node "
                "(reference SoftDot); pass features as data or constants."
            )
        return LinearExpr(a.ref, x, None)
    a = np.asarray(a)
    if a.ndim != 1:
        raise TypeError("dot() expects a vector first argument.")
    return LinearExpr(a, x, None)


# -- variable containers exposed to the model body --------------------------------

class LatentArray:
    """Array of latent random variables; ``x[t] = Node(...)`` defines slot t."""

    def __init__(self, var: Variable):
        self._var = var

    def __len__(self):
        return self._var.length

    def _norm_idx(self, key):
        if isinstance(key, SymIndex):
            return key
        key = int(key)
        if key < 0:
            key += self._var.length
        return key

    def __getitem__(self, key) -> RVRef:
        return RVRef(Ref(self._var, self._norm_idx(key)))

    def __setitem__(self, key, value):
        if not isinstance(value, RVRef):
            raise TypeError(
                f"x[t] = ... expects a node constructor call (got {type(value)})."
            )
        _builder().rebind(value.ref, Ref(self._var, self._norm_idx(key)))


def _check_grid_key(key: tuple, axes: tuple, name: str) -> tuple:
    """Validate a grid index ``[i, j]``: zero-offset symbolic indices over
    full plates, outer first, matching the array's leading axes."""
    if not all(isinstance(k, SymIndex) for k in key):
        raise TypeError(
            "multi-axis grid indexing supports symbolic plate indices only "
            "(mixed concrete/symbolic grid slots are not supported).")
    if len(axes) < len(key):
        raise ValueError(
            f"{name} has {len(axes)} grid axes, indexed with {len(key)}.")
    stack = _builder().plate_stack
    if tuple(stack[-len(key):]) != tuple(k.plate for k in key):
        raise ValueError(
            "grid index plate order must match the nesting order of the "
            "active plates (outer first); transpose the array if its axes "
            "are ordered differently.")
    for ax, k in enumerate(key):
        if k.offset != 0 or k.plate.lo != 0 or k.plate.hi != axes[ax]:
            raise NotImplementedError(
                "grid slots need zero-offset indices over full plates "
                f"(axis {ax}: plate [{k.plate.lo},{k.plate.hi}) vs axis "
                f"length {axes[ax]}); lagged grid references are not "
                "supported.")
    return key


class GridLatentArray:
    """Multi-axis latent array: ``z[i, j] = Node(...)`` inside nested plates
    defines the whole grid at once."""

    def __init__(self, var: Variable, axes: tuple):
        self._var = var
        self.axes = axes

    def __getitem__(self, key) -> RVRef:
        if not isinstance(key, tuple):
            raise TypeError(
                f"grid latent {self._var.name} must be indexed with "
                f"{len(self.axes)} indices.")
        return RVRef(Ref(self._var,
                         _check_grid_key(key, self.axes, self._var.name)))

    def __setitem__(self, key, value):
        if not isinstance(value, RVRef):
            raise TypeError("z[i, j] = ... expects a node constructor call.")
        _builder().rebind(value.ref, Ref(
            self._var, _check_grid_key(key, self.axes, self._var.name)))


class DataArray:
    """Observed-data placeholder; ``y[t] = Node(...)`` observes slot t.
    Indexing marks the leading axis as a plate; passing the array whole makes
    its full shape one event."""

    def __init__(self, var: Variable, shape: tuple, dtype):
        self._var = var
        self.shape = shape
        self.dtype = dtype
        var.length = None
        var.event_shape = shape
        var.dtype = dtype

    def __len__(self):
        return self.shape[0]

    def _norm_grid_idx(self, key: tuple) -> tuple:
        """A nested-plate grid index ``y[i, j]``: the leading axes it
        indexes become the variable's ``grid_axes``, the rest its event."""
        key = _check_grid_key(key, self.shape, self._var.name)
        if self._var.length is not None:
            raise ValueError(
                f"data array {self._var.name} is used with both single and "
                "grid indexing.")
        self._var.grid_axes = tuple(self.shape[:len(key)])
        self._var.event_shape = self.shape[len(key):]
        return key

    def _norm_idx(self, key):
        if isinstance(key, tuple):
            return self._norm_grid_idx(key)
        if self._var.length is None:
            self._var.length = self.shape[0]
            self._var.event_shape = self.shape[1:]
        if isinstance(key, SymIndex):
            return key
        key = int(key)
        if key < 0:
            key += self._var.length
        return key

    def __getitem__(self, key) -> RVRef:
        return RVRef(Ref(self._var, self._norm_idx(key)))

    def __setitem__(self, key, value):
        if not isinstance(value, RVRef):
            raise TypeError("y[t] = ... expects a node constructor call.")
        _builder().rebind(value.ref, Ref(self._var, self._norm_idx(key)))

    def observe(self, value: RVRef):
        """Observe the whole data variable: ``y.observe(Normal(...))``."""
        _builder().rebind(value.ref, Ref(self._var, None))

    # folded arithmetic: data-variable expressions become derived data
    def __add__(self, o):
        return DataExpr._lift(self)._bin(o, "add")

    __radd__ = __add__

    def __sub__(self, o):
        return DataExpr._lift(self)._bin(o, "sub")

    def __rsub__(self, o):
        return DataExpr._lift(o)._bin(self, "sub")

    def __mul__(self, o):
        return DataExpr._lift(self)._bin(o, "mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return DataExpr._lift(self)._bin(o, "div")

    def __rtruediv__(self, o):
        return DataExpr._lift(o)._bin(self, "div")

    def __neg__(self):
        return DataExpr._lift(self)._bin(-1.0, "mul")


def _fold_operands(x, y):
    """A folded operation's operands: a number or numpy constant meeting a
    tensor becomes a float32 tensor on the tensor's device (at run time the
    data are tensors; when a program is planned, numpy arrays)."""
    import torch

    if isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    elif isinstance(y, torch.Tensor) and not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=torch.float32, device=y.device)
    return x, y


class DataExpr:
    """Elementwise arithmetic over data variables, recorded at trace time
    and materialized as a derived data variable: ``graph.derived_data[name]``
    maps to a function of the runtime data dict, evaluated with the data
    (``CompiledModel._with_derived``), so a new value of a source variable
    moves the fold without a new program."""

    __array_ufunc__ = None

    _OPS = {
        "add": lambda x, y: x + y,
        "sub": lambda x, y: x - y,
        "mul": lambda x, y: x * y,
        "div": lambda x, y: x / y,
    }

    def __init__(self, fn, srcs, shape):
        self.fn = fn        # (data dict) -> tensor or array
        self.srcs = srcs    # names of the source data variables
        self.shape = shape

    @staticmethod
    def _lift(v) -> "DataExpr":
        if isinstance(v, DataExpr):
            return v
        if isinstance(v, DataArray):
            name = v._var.name
            return DataExpr(lambda data, n=name: data[n], {name}, v.shape)
        arr = np.asarray(v)
        if arr.dtype == object:
            raise TypeError(
                f"`{type(v).__name__}` cannot appear in a data-variable "
                "expression inside @model.")
        arr = arr.astype(np.float32)
        return DataExpr(lambda data, a=arr: a, set(), arr.shape)

    def _bin(self, other, opname) -> "DataExpr":
        o = DataExpr._lift(other)
        op = DataExpr._OPS[opname]
        shape = np.broadcast_shapes(self.shape, o.shape)
        f1, f2 = self.fn, o.fn
        return DataExpr(lambda data: op(*_fold_operands(f1(data), f2(data))),
                        self.srcs | o.srcs, shape)

    def __add__(self, o):
        return self._bin(o, "add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin(o, "sub")

    def __rsub__(self, o):
        return DataExpr._lift(o)._bin(self, "sub")

    def __mul__(self, o):
        return self._bin(o, "mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._bin(o, "div")

    def __rtruediv__(self, o):
        return DataExpr._lift(o)._bin(self, "div")

    def __neg__(self):
        return self._bin(-1.0, "mul")


def latent(length, name: Optional[str] = None):
    """Declare an array of latent variables; a tuple ``length`` declares a
    grid latent (``latent((N, M))``, defined inside nested plates by ``z[i,
    j] = Node(...)``)."""
    b = _builder()
    name = b.scoped_name(name) if name else b.fresh_name("x")
    if isinstance(length, tuple):
        axes = tuple(int(a) for a in length)
        var = b.graph.add_variable(Variable(name, "random", None))
        var.grid_axes = axes
        var.scope = tuple(b.scope_stack)
        return GridLatentArray(var, axes)
    var = b.graph.add_variable(Variable(name, "random", int(length)))
    var.scope = tuple(b.scope_stack)
    return LatentArray(var)


def scope(name: str):
    """Submodel scope: ``with scope("walk"): ...`` prefixes the names of
    the variables created inside with ``walk/`` and records the scope path
    on the IR, so posteriors appear as ``"walk/x"`` and
    ``constraints(submodel={"walk": ...})`` targets the block.  Repeated
    uses of one name are instances ``walk``, ``walk:2``, ...: a constraint
    keyed ``"walk"`` applies to every instance, ``"walk:2"`` to that one."""
    import contextlib

    @contextlib.contextmanager
    def _cm():
        b = _builder()
        b.enter_scope(name)
        try:
            yield
        finally:
            b.scope_stack.pop()

    return _cm()


def submodel(fn=None, *, name: Optional[str] = None, default_constraints=None,
             default_init=None):
    """Declare a function a named submodel: every call opens a scope named
    after it (instances ``name``, ``name:2``, ... as with ``scope``).
    ``default_constraints`` apply to every instance the user's
    ``constraints(submodel={...})`` does not target, ``default_init`` (a
    dict of local variable names) initializes every instance the user's
    ``initialization=`` does not.  Under node contraction
    (``allow_node_contraction=True``) a submodel whose name is a registered
    node is emitted as one factor of that node, its keyword arguments
    naming the interfaces, and its body is not traced."""
    import functools

    def deco(f):
        sm_name = name or f.__name__

        @functools.wraps(f)
        def wrapped(*args, **kwargs):
            b = _builder()
            if b.allow_node_contraction:
                from ..rules.registry import has_node

                if has_node(sm_name):
                    if args:
                        raise TypeError(
                            f"node contraction of submodel {sm_name!r} "
                            "requires keyword arguments (they name the "
                            "factor's interfaces).")
                    return b.emit(sm_name, {k: _as_interface(v)
                                            for k, v in kwargs.items()})
            b.enter_scope(sm_name)
            if default_constraints is not None:
                b.graph.default_submodel_constraints[sm_name] = \
                    default_constraints
            if default_init is not None:
                b.graph.default_submodel_init[sm_name] = dict(default_init)
            try:
                return f(*args, **kwargs)
            finally:
                b.scope_stack.pop()

        wrapped.__rx_submodel__ = sm_name
        return wrapped

    return deco(fn) if fn is not None else deco


def plate(*args, name: Optional[str] = None):
    """Symbolic plate iterator: ``for t in plate(T)`` or ``plate(lo, hi)``.
    The body runs ONCE with a symbolic index; every node created inside
    becomes one plated factor."""
    if len(args) == 1:
        lo, hi = 0, int(args[0])
    else:
        lo, hi = int(args[0]), int(args[1])
    b = _builder()
    p = Plate(lo, hi, name)
    b.graph.add_plate(p)
    b.plate_stack.append(p)
    try:
        yield SymIndex(p, 0)
    finally:
        b.plate_stack.pop()


# -- builder ---------------------------------------------------------------------

class RequireMessage:
    """Per-node functional-dependencies override (the reference's
    ``RequireMessageFunctionalDependencies``): the rule towards a named
    interface also receives the inbound message on that same edge (the
    marginal divided by the factor's previous message there) instead of
    the marginal, seeded by the given message on the first sweep (None: the
    marginal).  Python cannot take ``in`` as a keyword, so a trailing
    underscore is stripped: ``RequireMessage(in_=prior)``."""

    def __init__(self, **interfaces):
        self.interfaces = {
            (k[:-1] if k.endswith("_") else k): v
            for k, v in interfaces.items()}

    def __repr__(self):
        return f"RequireMessage({', '.join(self.interfaces)})"


RequireMessageFunctionalDependencies = RequireMessage


class where:
    """Block-scoped node options, the reference's ``where {...}``::

        with where(dependencies=RequireMessage(in_=prior)):
            y[k] = factor_node("ProbitEP", **{"in": x})

    ``meta`` merges into (without overriding) a node's own meta dict (a
    value that is not a dict as ``{"method": value}``); ``dependencies``
    attaches a ``RequireMessage`` to every factor emitted in the block."""

    def __init__(self, meta=None, dependencies=None):
        self.meta = meta
        self.dependencies = dependencies

    def __enter__(self):
        b = _active()
        if b is None:
            raise RuntimeError("where(...) is only valid inside @model.")
        b.options_stack.append(self)
        return self

    def __exit__(self, *exc):
        _builder().options_stack.pop()
        return False


class ModelBuilder:
    def __init__(self, name: str):
        self.graph = ModelGraph(name)
        self.plate_stack: list[Plate] = []
        self.options_stack: list[where] = []
        self.scope_stack: list[str] = []
        self._scope_counts: dict[str, int] = {}
        self.allow_node_contraction = False
        self._name_counter = 0
        # (file, line, name) -> Variable holding that source-line name hint
        self._line_hints: dict = {}
        self._pending_hint_key = None

    def fresh_name(self, prefix: str) -> str:
        self._name_counter += 1
        return f"_{prefix}{self._name_counter}"

    def scoped_name(self, name: str) -> str:
        """A user-facing name under the active scope path (``walk/x``)."""
        if not self.scope_stack or name.startswith("_"):
            return name
        return "/".join(self.scope_stack) + "/" + name

    def enter_scope(self, name: str) -> str:
        """Open a scope instance: repeated uses of a name are ``name``,
        ``name:2``, ``name:3``, ..."""
        if "/" in name or ":" in name:
            raise ValueError("scope names may not contain '/' or ':'")
        n = self._scope_counts.get(name, 0) + 1
        self._scope_counts[name] = n
        seg = name if n == 1 else f"{name}:{n}"
        self.scope_stack.append(seg)
        return seg

    def _guess_target_name(self) -> Optional[str]:
        """Best-effort capture of the assignment target (``theta =
        Normal(...)``) so unplated latents get user-facing names; falls back
        to anonymous on any mismatch."""
        import linecache
        import re
        import sys

        frame = sys._getframe(2)
        while frame is not None and frame.f_code.co_filename == __file__:
            frame = frame.f_back
        if frame is None:
            return None
        line = linecache.getline(frame.f_code.co_filename, frame.f_lineno)
        m = re.match(r"\s*([A-Za-z_]\w*)\s*=[^=]", line)
        if not m:
            return None
        name = self.scoped_name(m.group(1))
        # nested calls emit inner factors first and loops re-emit from the
        # same line: the assignment target is the last emit of the
        # statement, so it takes the name back from an earlier one
        key = (frame.f_code.co_filename, frame.f_lineno, name)
        prev = self._line_hints.get(key)
        if prev is not None and prev.name == name:
            prev.name = self.fresh_name("v")
        elif any(v.name == name for v in self.graph.variables):
            return None
        self._pending_hint_key = key
        return name

    def emit(self, fform: str, interfaces: dict, meta=None) -> RVRef:
        """Create a factor with a fresh anonymous output variable."""
        p = self.plate_stack[-1] if self.plate_stack else None
        guessed = None if p is not None else self._guess_target_name()
        if p is not None:
            var = self.graph.add_variable(
                Variable(self.fresh_name("v"), "random", p.size)
            )
            # slot (t - lo) of the anonymous plated array belongs to step t
            out = Ref(var, SymIndex(p, -p.lo))
        else:
            var = self.graph.add_variable(
                Variable(guessed or self.fresh_name("v"), "random")
            )
            if guessed is not None:
                self._line_hints[self._pending_hint_key] = var
            out = Ref(var, None)
        var.scope = tuple(self.scope_stack)
        f = Factor(fform, out, interfaces, plate=p, meta=meta)
        f.plates = tuple(self.plate_stack)
        f.scope = tuple(self.scope_stack)
        for opt in self.options_stack:
            if opt.meta is not None:
                extra = (opt.meta if isinstance(opt.meta, dict)
                         else {"method": opt.meta})
                f.meta = {**extra, **(f.meta or {})}
            if opt.dependencies is not None:
                f.dependencies = opt.dependencies
        self.graph.add_factor(f)
        return RVRef(out)

    def rebind(self, anon_ref: Ref, target: Ref):
        """Rebind a just-created anonymous output to a named latent/data slot."""
        anon_var = anon_ref.var
        for f in self.graph.factors:
            if f.out.var is anon_var:
                f.out = target
            for k, v in list(f.interfaces.items()):
                if isinstance(v, Ref) and v.var is anon_var:
                    idx = target.idx
                    if isinstance(v.idx, SymIndex) and isinstance(idx, SymIndex):
                        delta = v.idx.offset - anon_ref.idx.offset
                        idx = SymIndex(idx.plate, idx.offset + delta)
                    f.interfaces[k] = Ref(target.var, idx)
        self.graph.variables.remove(anon_var)


def _as_interface(v) -> Any:
    """Normalize a node argument to Ref or Const."""
    from ..dists import Distribution, PointMass

    if isinstance(v, RVRef):
        return v.ref
    if isinstance(v, DataArray):
        return Ref(v._var, None)
    if isinstance(v, (LinearExpr, AddExpr)):
        return v
    if isinstance(v, DataExpr):
        # a folded data expression: an anonymous derived data variable,
        # computed from the runtime data dict with the data
        b = _builder()
        name = b.fresh_name("fold")
        var = b.graph.add_variable(Variable(name, "data", None))
        var.event_shape = tuple(v.shape)
        var.dtype = np.float32
        b.graph.derived_data[name] = v.fn
        return Ref(var, None)
    if isinstance(v, PointMass):
        return Const(np.asarray(v.point.detach().cpu()))
    if isinstance(v, Distribution):
        # a distribution object where a random variable is expected: a prior
        # factor of its own, one per object
        return _lift_dist(v).ref
    arr = np.asarray(v)
    if arr.dtype == object:
        raise TypeError(
            f"`{type(v).__name__}` cannot be used as a factor-node argument "
            "inside @model: it is neither a random variable, data, nor a "
            "numeric constant."
        )
    return Const(arr)


def _direct_dist(fform: str, *args):
    """Distribution object for a node constructor called outside a trace."""
    import torch

    from .. import dists as D

    table = {
        "NormalMeanVariance": D.NormalMeanVariance,
        "NormalMeanPrecision": D.NormalMeanPrecision,
        "MvNormalMeanCovariance": D.MvNormalMeanCovariance,
        "MvNormalMeanPrecision": D.MvNormalMeanPrecision,
        "MvNormalMeanScalePrecision": D.MvNormalMeanScalePrecision,
        "Beta": D.Beta,
        "Bernoulli": D.Bernoulli,
        "Binomial": D.Binomial,
        "Categorical": D.Categorical.from_probs,
        "Dirichlet": D.Dirichlet,
        "DirichletCollection": D.DirichletCollection,
        "GammaShapeRate": D.GammaShapeRate,
        "GammaShapeScale": D.GammaShapeScale,
        "InverseGamma": D.InverseGamma,
        "Wishart": D.Wishart,
        "InverseWishart": D.InverseWishart,
        "Poisson": D.Poisson,
        "Uniform": D.Uniform,
    }
    return table[fform](*[torch.as_tensor(np.asarray(a, np.float32))
                          for a in args])


def _lift_dist(d) -> RVRef:
    """The prior factor of a distribution object used inside a trace: its
    parameters become the factor's constants.  One random variable per
    object (memoized by identity), emitted outside the active plates, as a
    ``theta ~ prior`` above the loop."""
    from .. import dists as D

    b = _builder()
    memo = b.__dict__.setdefault("_dist_lift_memo", {})
    hit = memo.get(id(d))
    if hit is not None:
        return hit[1]

    def c(t):
        return np.asarray(t.detach().cpu(), np.float32)

    table = {
        D.NormalMeanVariance: lambda: Normal(mean=c(d.mu), var=c(d.v)),
        D.NormalMeanPrecision: lambda: Normal(mean=c(d.mu), precision=c(d.w)),
        D.MvNormalMeanCovariance: lambda: MvNormal(mean=c(d.mu),
                                                   cov=c(d.sigma)),
        D.MvNormalMeanPrecision: lambda: MvNormal(mean=c(d.mu),
                                                  precision=c(d.w)),
        D.MvNormalMeanScalePrecision: lambda: MvNormal(mean=c(d.mu),
                                                       gamma=c(d.gamma)),
        D.Beta: lambda: Beta(c(d.a), c(d.b)),
        D.Bernoulli: lambda: Bernoulli(c(d.p)),
        D.Binomial: lambda: Binomial(c(d.n), c(d.p)),
        D.GammaShapeRate: lambda: Gamma(shape=c(d.a), rate=c(d.b)),
        D.GammaShapeScale: lambda: Gamma(shape=c(d.a), scale=c(d.theta)),
        D.InverseGamma: lambda: InverseGamma(c(d.a), c(d.b)),
        D.Categorical: lambda: Categorical(c(d.probs())),
        D.Dirichlet: lambda: Dirichlet(c(d.alpha)),
        D.DirichletCollection: lambda: DirichletCollection(c(d.alpha)),
        D.Wishart: lambda: Wishart(c(d.nu), c(d.s)),
        D.InverseWishart: lambda: InverseWishart(c(d.nu), c(d.psi)),
        D.Poisson: lambda: Poisson(c(d.lam)),
        D.Uniform: lambda: Uniform(c(d.lo), c(d.hi)),
    }
    ctor = table.get(type(d))
    if ctor is None:
        raise TypeError(
            f"`{type(d).__name__}` cannot be used as a prior inside @model: "
            "no factor node matches this distribution family.")
    saved, b.plate_stack = b.plate_stack, []
    try:
        ref = ctor()
    finally:
        b.plate_stack = saved
    memo[id(d)] = (d, ref)  # keeps d alive, so its id stays unique
    return ref


def _gaussian(kind_scalar: str, kwargs: dict) -> RVRef:
    """Canonicalize Normal/MvNormal keyword aliases and fold linear means
    into LinearGaussian factors."""
    mean = kwargs.pop("mean", None)
    if mean is None and "m" in kwargs:
        mean = kwargs.pop("m")
    noise_kinds = [
        ("var", "Variance"),
        ("variance", "Variance"),
        ("v", "Variance"),
        ("cov", "Covariance"),
        ("covariance", "Covariance"),
        ("precision", "Precision"),
        ("prec", "Precision"),
        ("tau", "Precision"),
        ("w", "Precision"),
        ("gamma", "ScalePrecision"),
    ]
    noise_val, noise_kind = None, None
    for key, kind in noise_kinds:
        if key in kwargs:
            if noise_val is not None:
                raise TypeError("Specify exactly one of var/cov/precision.")
            noise_val, noise_kind = kwargs.pop(key), kind
    if kwargs:
        raise TypeError(f"Unknown Normal arguments: {list(kwargs)}")
    if mean is None or noise_val is None:
        raise TypeError("Normal requires mean and one of var/cov/precision.")

    mv = kind_scalar == "MvNormal"
    if mv:
        base = {"Variance": "MvNormalMeanCovariance",
                "Covariance": "MvNormalMeanCovariance",
                "Precision": "MvNormalMeanPrecision",
                "ScalePrecision": "MvNormalMeanScalePrecision"}[noise_kind]
    else:
        base = {"Variance": "NormalMeanVariance",
                "Covariance": "NormalMeanVariance",
                "Precision": "NormalMeanPrecision",
                "ScalePrecision": "NormalMeanPrecision"}[noise_kind]
    noise_name = {"MvNormalMeanCovariance": "cov",
                  "MvNormalMeanPrecision": "prec",
                  "MvNormalMeanScalePrecision": "gamma",
                  "NormalMeanVariance": "var",
                  "NormalMeanPrecision": "prec"}[base]

    if _active() is None:
        return _direct_dist(base, mean, noise_val)

    if isinstance(mean, AddExpr):
        # Normal(mean = a + b, ...) with random terms: one GaussianSum factor
        # (exact BP messages and an average energy); linear-map terms make a
        # LinComb node, and the scale-precision form a Sum node, feeding the
        # mean
        if mean.has_linear_terms:
            mean = lincomb(mean)
        elif noise_name in ("var", "cov", "prec"):
            interfaces = {f"in{i}": _as_interface(t)
                          for i, t in enumerate(mean.terms)}
            interfaces[noise_name] = _as_interface(noise_val)
            fform = ("Mv" if mv else "") + "GaussianSum" + (
                "Covariance" if noise_name in ("var", "cov") else "Precision")
            return _builder().emit(fform, interfaces)
        else:
            mean = Sum(*mean.terms)

    if isinstance(mean, LinearExpr):
        a_val = mean.a
        # a dot-product mean (scalar out, vector random in): GaussianDot
        is_dot = (not mv) and (isinstance(a_val, Ref) or (
            a_val is not None and np.ndim(a_val) == 1))
        interfaces = {
            "in": mean.x.ref,
            "A": a_val if isinstance(a_val, Ref)
            else Const(np.asarray(a_val)) if a_val is not None
            else Const(np.asarray(1.0)),
            "b": Const(np.asarray(mean.b)) if mean.b is not None
            else Const(np.asarray(0.0)),
            noise_name: _as_interface(noise_val),
        }
        if is_dot:
            fform = "GaussianDot" + (
                "Covariance" if noise_name == "var" else "Precision")
        else:
            fform = ("Mv" if mv else "") + "LinearGaussian" + (
                "Covariance" if noise_name in ("cov", "var") else "Precision"
            )
        return _builder().emit(fform, interfaces)

    return _builder().emit(base, {"mean": _as_interface(mean),
                                  noise_name: _as_interface(noise_val)})


def Normal(**kwargs) -> RVRef:
    return _gaussian("Normal", dict(kwargs))


def MvNormal(**kwargs) -> RVRef:
    return _gaussian("MvNormal", dict(kwargs))


def Gamma(shape=None, rate=None, scale=None, a=None, b=None) -> RVRef:
    sh = shape if shape is not None else a
    if rate is None and b is not None:
        rate = b
    if sh is None or (rate is None and scale is None):
        raise TypeError("Gamma requires shape and rate (or scale).")
    if scale is not None:
        if _active() is None:
            return _direct_dist("GammaShapeScale", sh, scale)
        return _builder().emit(
            "GammaShapeScale", {"shape": _as_interface(sh),
                                "scale": _as_interface(scale)})
    if _active() is None:
        return _direct_dist("GammaShapeRate", sh, rate)
    return _builder().emit(
        "GammaShapeRate", {"shape": _as_interface(sh),
                           "rate": _as_interface(rate)})


def Wishart(nu, S) -> RVRef:
    """Wishart(nu, S) prior of a precision matrix; E = nu S.  Outside a
    model it returns the ``Wishart`` distribution (for
    ``initialization=``)."""
    if _active() is None:
        return _direct_dist("Wishart", nu, S)
    return _builder().emit("Wishart", {"nu": _as_interface(nu),
                                       "S": _as_interface(S)})


def InverseGamma(shape, scale) -> RVRef:
    """InverseGamma(shape, scale) prior of a variance; E = scale / (shape -
    1)."""
    if _active() is None:
        return _direct_dist("InverseGamma", shape, scale)
    return _builder().emit("InverseGamma", {"shape": _as_interface(shape),
                                            "scale": _as_interface(scale)})


def InverseWishart(nu, Psi) -> RVRef:
    """InverseWishart(nu, Psi) prior of a covariance matrix; E = Psi / (nu -
    d - 1)."""
    if _active() is None:
        return _direct_dist("InverseWishart", nu, Psi)
    return _builder().emit("InverseWishart", {"nu": _as_interface(nu),
                                              "Psi": _as_interface(Psi)})


def Beta(a, b) -> RVRef:
    if _active() is None:
        return _direct_dist("Beta", a, b)
    return _builder().emit("Beta", {"a": _as_interface(a),
                                    "b": _as_interface(b)})


def Bernoulli(p) -> RVRef:
    if _active() is None:
        return _direct_dist("Bernoulli", p)
    return _builder().emit("Bernoulli", {"p": _as_interface(p)})


def Binomial(n, p) -> RVRef:
    if _active() is None:
        return _direct_dist("Binomial", n, p)
    return _builder().emit("Binomial", {"n": _as_interface(n),
                                        "p": _as_interface(p)})


def Poisson(rate) -> RVRef:
    if _active() is None:
        return _direct_dist("Poisson", rate)
    return _builder().emit("Poisson", {"rate": _as_interface(rate)})


def Multinomial(n, p) -> RVRef:
    """Multinomial(n, p): counts over the K outcomes of the simplex p."""
    if _active() is None:
        import torch

        from .. import dists as D

        return D.Multinomial(
            torch.as_tensor(np.asarray(n, np.float32)),
            torch.log(torch.clamp(torch.as_tensor(np.asarray(p, np.float32)),
                                  min=1e-37)))
    return _builder().emit("Multinomial", {"n": _as_interface(n),
                                           "p": _as_interface(p)})


def Uniform(lo=0.0, hi=1.0) -> RVRef:
    if _active() is None:
        return _direct_dist("Uniform", lo, hi)
    return _builder().emit("Uniform", {"lo": _as_interface(lo),
                                       "hi": _as_interface(hi)})


def BinomialPolya(x, n, beta) -> RVRef:
    """Binomial regression through Polya-Gamma augmentation (the
    reference's BinomialPolya): out ~ Binomial(n, logistic(x^T beta))."""
    return _builder().emit(
        "BinomialPolya",
        {"x": _as_interface(x), "n": _as_interface(n),
         "beta": _as_interface(beta)})


def MultinomialPolya(x, n, beta) -> RVRef:
    """The two-class Multinomial regression (``rules/polya.py``)."""
    return _builder().emit(
        "MultinomialPolya",
        {"x": _as_interface(x), "n": _as_interface(n),
         "beta": _as_interface(beta)})


def ContinuousTransition(x, theta, prec) -> RVRef:
    """out = reshape(theta) @ x + noise with a random row-major vectorized
    transition matrix (the reference's ContinuousTransition)."""
    return _builder().emit(
        "ContinuousTransition",
        {"in": _as_interface(x), "theta": _as_interface(theta),
         "prec": _as_interface(prec)})


def OR(a, b) -> RVRef:
    """Boolean OR node (the reference's alias ``a || b``)."""
    return _builder().emit("OR", {"in1": _as_interface(a),
                                  "in2": _as_interface(b)})


def AND(a, b) -> RVRef:
    return _builder().emit("AND", {"in1": _as_interface(a),
                                   "in2": _as_interface(b)})


def NOT(a) -> RVRef:
    return _builder().emit("NOT", {"in": _as_interface(a)})


def IMPLY(a, b) -> RVRef:
    return _builder().emit("IMPLY", {"in1": _as_interface(a),
                                     "in2": _as_interface(b)})


def tie(x: RVRef, node: RVRef) -> RVRef:
    """Attach a further factor to an existing random variable: the
    reference's second ``~`` on one variable (``x ~ IMPLY(...)`` then ``x ~
    Bernoulli(y)``).  ``node`` is a just-created factor output; its
    anonymous variable is rebound to ``x`` and the factor marked as
    evidence."""
    if not isinstance(x, RVRef) or not isinstance(node, RVRef):
        raise TypeError("tie(x, node) expects two random-variable references.")
    b = _builder()
    anon_var = node.ref.var
    for f in b.graph.factors:
        if f.out.var is anon_var:
            f.evidence = True
    b.rebind(node.ref, x.ref)
    return x


def Uninformative() -> RVRef:
    """Flat prior (the reference's Uninformative node)."""
    return _builder().emit("Uninformative", {})


def Sum(*terms) -> RVRef:
    """Deterministic sum of random variables (the reference's ``+``
    node)."""
    return _builder().emit(
        "Sum", {f"in{i}": _as_interface(t) for i, t in enumerate(terms)})


def lincomb(expr) -> RVRef:
    """A deterministic linear combination of random variables as a node:
    ``x_next = lincomb(A @ x + B @ u)`` (the reference's composed ``*`` and
    ``+`` deterministic nodes)."""
    if isinstance(expr, RVRef):
        return expr
    if isinstance(expr, LinearExpr):
        expr = AddExpr((expr,))
    if not isinstance(expr, AddExpr):
        raise TypeError("lincomb() expects a sum of rv / A @ rv terms.")
    interfaces = {}
    bias = None
    for i, t in enumerate(expr.terms):
        if isinstance(t, RVRef):
            interfaces[f"in{i}"] = t.ref
            interfaces[f"A{i}"] = Const(np.asarray(1.0))
            continue
        if isinstance(t.a, Ref):
            raise TypeError("lincomb() with data-indexed maps not supported.")
        interfaces[f"in{i}"] = t.x.ref
        interfaces[f"A{i}"] = Const(np.asarray(t.a if t.a is not None
                                               else 1.0))
        if t.b is not None:
            bias = t.b if bias is None else bias + t.b
    if bias is not None:
        interfaces["b"] = Const(np.asarray(bias))
    return _builder().emit("LinComb", interfaces)


def Categorical(p) -> RVRef:
    if _active() is None:
        return _direct_dist("Categorical", p)
    return _builder().emit("Categorical", {"p": _as_interface(p)})


def Dirichlet(alpha) -> RVRef:
    if _active() is None:
        return _direct_dist("Dirichlet", alpha)
    return _builder().emit("Dirichlet", {"alpha": _as_interface(alpha)})


def DirichletCollection(alpha) -> RVRef:
    if _active() is None:
        return _direct_dist("DirichletCollection", alpha)
    return _builder().emit("DirichletCollection",
                           {"alpha": _as_interface(alpha)})


def Transition(state_in, matrix) -> RVRef:
    """Discrete transition: out ~ Categorical(P[:, state_in])."""
    return _builder().emit(
        "DiscreteTransition",
        {"in": _as_interface(state_in), "matrix": _as_interface(matrix)},
    )


DiscreteTransition = Transition


def _is_mv_component(v) -> bool:
    """A mixture component mean is vector-valued: a random variable defined
    by a multivariate node, or a constant of rank >= 1."""
    if isinstance(v, RVRef):
        for f in _builder().graph.factors:
            if f.out.var is v.ref.var:
                return f.fform.startswith("Mv")
        return False
    return np.ndim(np.asarray(v)) >= 1


def NormalMixture(switch, means, precisions) -> RVRef:
    """Gaussian mixture likelihood: interfaces ``switch``, ``mean0..``,
    ``prec0..``; the multivariate node (MvNormal means, Wishart precisions)
    when the component means are vectors."""
    mv = any(_is_mv_component(m) for m in means)
    interfaces = {"switch": _as_interface(switch)}
    for i, m in enumerate(means):
        interfaces[f"mean{i}"] = _as_interface(m)
    for i, p in enumerate(precisions):
        interfaces[f"prec{i}"] = _as_interface(p)
    return _builder().emit("MvNormalMixture" if mv else "NormalMixture",
                           interfaces, meta={"K": len(means)})


def GammaMixture(switch, shapes, rates) -> RVRef:
    """Gamma mixture: out ~ prod_k Gamma(out; shape_k, rate_k)^{s_k};
    interfaces ``switch``, ``shape0..``, ``rate0..``."""
    interfaces = {"switch": _as_interface(switch)}
    for i, a in enumerate(shapes):
        interfaces[f"shape{i}"] = _as_interface(a)
    for i, b in enumerate(rates):
        interfaces[f"rate{i}"] = _as_interface(b)
    return _builder().emit("GammaMixture", interfaces,
                           meta={"K": len(shapes)})


def Mixture(switch, components) -> RVRef:
    """Generic mixture: out is the component the switch selects
    (interfaces ``switch``, ``comp0..``; ``rules/special.py``
    ``MixtureNode``)."""
    interfaces = {"switch": _as_interface(switch)}
    for i, c in enumerate(components):
        interfaces[f"comp{i}"] = _as_interface(c)
    return _builder().emit("Mixture", interfaces,
                           meta={"K": len(components)})


class ARsafe:
    """Stability variant marker (the reference ARMeta's ARsafe).  The AR
    chain block is solved by an exact Kalman smoother, which is always the
    safe path: ARunsafe is accepted and ignored."""


class ARunsafe:
    pass


class ARMeta:
    """The reference's ``ARMeta(Multivariate|Univariate, order, ARsafe())``;
    the variate kind follows from the order and the latents' shape."""

    def __init__(self, variate_or_order=None, order=None, stability=None):
        if order is None and isinstance(variate_or_order, int):
            order = variate_or_order
        if not isinstance(order, int):
            raise TypeError("ARMeta requires an integer order.")
        self.order = order
        self.stability = stability if stability is not None else ARsafe()


def AR(prev, theta, gamma, order: int = None, meta: "ARMeta" = None) -> RVRef:
    """Autoregressive node (the reference's AR + ARMeta + ARsafe)."""
    if meta is not None:
        order = meta.order
    if order is None:
        raise TypeError("AR requires order= (or meta=ARMeta(order)).")
    return _builder().emit(
        "AR",
        {"in": _as_interface(prev), "theta": _as_interface(theta),
         "gamma": _as_interface(gamma)},
        meta={"order": order},
    )


def GCV(x_prev, z, kappa=1.0, omega=0.0) -> RVRef:
    """Gaussian controlled-variance node, out ~ N(x_prev, exp(kappa z +
    omega)) (the HGF's building block; the reference's GCV)."""
    return _builder().emit(
        "GCV",
        {"in": _as_interface(x_prev), "z": _as_interface(z),
         "kappa": _as_interface(kappa), "omega": _as_interface(omega)},
    )


def factor_node(fform: str, **interfaces) -> RVRef:
    """A user-registered node, by name (register its rules with
    ``rxinfer_tpu_torch.rules.registry.node("Name")`` first; a node that
    defines only ``logpdf`` runs with ``infer(options={"rulefallback":
    NodeFunctionRuleFallback()})``)."""
    return _builder().emit(
        fform, {k: _as_interface(v) for k, v in interfaces.items()})


def Probit(x) -> RVRef:
    """Probit link: out in {0, 1} ~ Bernoulli(Phi(x)) (``rules/special.py``
    ``ProbitNode``)."""
    return _builder().emit("Probit", {"in": _as_interface(x)})


def SoftDot(theta, x, gamma) -> RVRef:
    """out ~ N(theta^T x, 1 / gamma) with theta and x both random (the
    reference's SoftDot; ``dot`` takes a known vector only)."""
    return _builder().emit(
        "SoftDot",
        {"theta": _as_interface(theta), "x": _as_interface(x),
         "gamma": _as_interface(gamma)},
    )


def Delta(fn, *args, method=None, inverse=None) -> RVRef:
    """Nonlinear deterministic node out = fn(args...) with an approximation
    method (the reference's DeltaMeta(method=Linearization() / Unscented() /
    CVIProjection(), inverse=...); ``rules/delta.py``).  ``fn`` and
    ``inverse`` are pure torch functions of single values (a scalar argument
    as a 0-d tensor, a vector as a 1-d one), evaluated under
    ``torch.func.vmap``.  ``Normal(mean=Delta(...), ...)`` contracts to a
    NonlinearGaussian factor when the delta's output has no other use."""
    interfaces = {f"in{i}": _as_interface(a) for i, a in enumerate(args)}
    return _builder().emit(
        "Delta", interfaces,
        meta={"fn": fn, "method": method, "inverse": inverse})


# -- @model decorator and generator -------------------------------------------------

class ModelGenerator:
    """Lazy model: function + bound hyperparameters.  Conditioning on data
    traces the graph."""

    def __init__(self, fn, bound: dict[str, Any]):
        self.fn = fn
        self.bound = dict(bound)
        self.name = fn.__name__

    def __call__(self, **kwargs) -> "ModelGenerator":
        return ModelGenerator(self.fn, {**self.bound, **kwargs})

    def __or__(self, data: dict) -> ModelGraph:
        return self.trace(data)

    def trace(self, data: dict[str, Any],
              allow_node_contraction: bool = False) -> ModelGraph:
        """Build the factor graph for the given data (shapes taken from
        values).  ``allow_node_contraction``: a ``submodel`` whose name is a
        registered node is one factor of that node."""
        builder = ModelBuilder(self.name)
        builder.allow_node_contraction = allow_node_contraction
        prev = getattr(_STATE, "builder", None)
        _STATE.builder = builder
        try:
            call_kwargs: dict[str, Any] = {}
            for k, v in self.bound.items():
                call_kwargs[k] = v if callable(v) or np.isscalar(v) \
                    else np.asarray(v)
            for k, v in data.items():
                if v is None:
                    raise ValueError(f"Data entry {k} is None")
                shape = tuple(np.shape(v))
                var = builder.graph.add_variable(
                    Variable(k, "data", shape[0] if shape else None))
                call_kwargs[k] = DataArray(var, shape, np.float32)
            ret = self.fn(**call_kwargs)
            if isinstance(ret, dict):
                for k, v in ret.items():
                    if isinstance(v, RVRef):
                        v.ref.var.name = k
                    elif isinstance(v, LatentArray):
                        v._var.name = k
            builder.graph.returnval = ret
        finally:
            _STATE.builder = prev
        builder.graph.validate()
        return builder.graph


def model(fn) -> ModelGenerator:
    """Decorator: ``@model def m(y): ...``.  Arguments bound via
    ``m(A=...)`` are hyperparameters; the rest are data variables."""
    return ModelGenerator(fn, {})
