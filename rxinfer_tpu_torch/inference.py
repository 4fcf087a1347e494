"""Inference entry points (counterpart of ``rxinfer_tpu/inference.py``).

Ported: ``infer`` in batch mode (one dataset; ``InferenceResult``,
``UnfactorizedData``, ``issuccess`` / ``iserror`` / ``getreturnval``,
``catch_exception``, the reference's ``returnvars`` / ``predictvars``
defaults, callbacks, ``benchmark=``, ``trace=`` and ``showprogress=``),
``batched_program``, ``infer_batched`` (with ``predictvars``),
``BatchedInferenceResult``, ``KeepLast`` / ``KeepEach`` and
``_extract_posteriors``, with the port's own caches, and ``free_energy=True``
on all three entry points: the Bethe free energy after every sweep,
(iterations,) for ``infer`` and (iterations, B) for the batched ones, with
``infer(free_energy_diagnostics=)`` (``diagnostics.py``).  ``infer`` solves
every chain with the scans of ``ops/kalman.py`` / ``ops/discrete_chain.py``,
never with the fused kernels, as the JAX package does.  Posteriors are
whatever the blocks produce (batched: every leaf with the batch axis
first): Gaussian chains, ``Categorical`` chains, ``DirichletCollection``,
Gaussian, ``Beta``, ``Dirichlet``, ``GammaShapeRate``, ``InverseGamma``,
``Wishart`` and ``InverseWishart`` plain groups (the Sum / LinComb outs
among the Gaussians).  Every
entry point runs on ``"cuda"`` unless the caller passes another ``device``;
with no device given and no CUDA device present it raises ``RuntimeError``
rather than carry on on the CPU.

``infer(datastream=, autoupdates=)`` returns the streaming engine
(``inference_streaming.py``), as the JAX package's does.

``annotations=LogScaleAnnotations()`` and ``postprocess=`` on ``infer`` and
``infer_batched`` (``engine/logscale.py``, ``postprocess.py``), with the free
energy of a generic ``Mixture`` model composed from exact mixture evidences
(``_mixture_fe_plan``); ``batched_program`` / ``infer_batched(shared=)``
pool plain groups over the batch on one device (``engine/batched.py``),
chunked beyond the device budget.

``meta=`` (per node type, or per neighbourhood; ``engine/compile.py``
``attach_meta``) and ``constraints=`` (factorization, form and
message-form constraints, submodel-scoped blocks; ``graph/constraints.py``)
on ``infer``, ``batched_program`` and ``infer_batched``; the program caches
tell meta and constraint values apart (``_value_equal``).
``infer(allow_node_contraction=True)`` traces a submodel whose name is a
registered node as one factor of it (a key of the compile cache); the
batched entry points do not take the keyword, as in the JAX package.
``infer`` and the streaming engine log every call to ``session=`` (the
default session unless another or None is given; ``utils/session.py``),
a failed call with ``status="failure"``.

Not ported yet: ``mesh=`` and ``psum_axis`` (A7b) raise
``NotImplementedError`` naming it.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
import types
import warnings
from typing import Any, Optional

import numpy as np
import torch

from .dists import PointMass
from .engine.blocks import BatchContext
from .engine.compile import CompiledModel, _all_finite
from .graph.ir import Ref


class UnfactorizedData:
    """Mark a data array as not factorized out of the posterior: with
    missing entries the data behaves as a latent kept jointly with its
    defining factor's inputs, so predictions marginalize the node exactly
    (``message_to_out_structured``) rather than through the mean-field out
    message."""

    def __init__(self, data):
        self.data = data


class KeepLast:
    """Return only the final iteration's posterior."""


class KeepEach:
    """Return posteriors from every iteration."""


def getreturnval(model):
    """The ``@model`` function's return value; accepts ``result.model`` or a
    traced graph."""
    g = getattr(model, "graph", model)
    return getattr(g, "returnval", None)


def issuccess(result) -> bool:
    """True when inference completed without error (errors attach only
    under ``catch_exception=True``)."""
    return getattr(result, "error", None) is None


def iserror(result) -> bool:
    return not issuccess(result)


class InferenceResult:
    """Posteriors, the free-energy trace (None without ``free_energy=True``),
    the compiled model and the wall time of one ``infer`` call."""

    def __init__(self, posteriors, free_energy, model, elapsed_s):
        self.posteriors = posteriors
        self.free_energy = free_energy
        self.model = model
        self.elapsed_s = elapsed_s

    @property
    def log_evidence(self):
        """-(final Bethe free energy); needs ``free_energy=True``."""
        if self.free_energy is None or self.free_energy.numel() == 0:
            raise ValueError("log_evidence requires infer(free_energy=True)")
        return -self.free_energy[-1]

    def __repr__(self):
        return f"InferenceResult(posteriors=[{', '.join(self.posteriors)}])"


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the PyTorch port runs on the "
                "GPU by default; pass device='cpu' explicitly to run the "
                "plain (non-kernel) versions on the CPU."
            )
        return torch.device("cuda")
    return torch.device(device)


def _shape_sig(data: dict) -> tuple:
    return tuple(sorted((k, tuple(np.shape(v))) for k, v in data.items()))


def _value_equal(a, b) -> bool:
    """Structural value equality for cache keys: programs close over
    constraint, meta and initialization values, so equal but fresh objects
    hit the cache and any change of value misses it.  Functions compare by
    code and closure values (a loop re-creating the same lambda hits),
    other objects by their attributes."""
    if a is b:
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return set(a) == set(b) and all(_value_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_value_equal(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and bool(torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return all(_value_equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    if isinstance(a, types.MethodType):
        return (a.__func__.__code__ is b.__func__.__code__
                and _value_equal(a.__self__, b.__self__))
    if isinstance(a, types.FunctionType):
        ca, cb = a.__closure__ or (), b.__closure__ or ()
        return (a.__code__ is b.__code__ and len(ca) == len(cb)
                and all(_value_equal(x.cell_contents, y.cell_contents)
                        for x, y in zip(ca, cb)))
    if callable(a) and not hasattr(a, "__dict__"):
        return a is b
    if hasattr(a, "__dict__") and not isinstance(a, type):
        return _value_equal(vars(a), vars(b))
    try:
        return bool(a == b)
    except Exception:  # noqa: BLE001 — incomparable values never match
        return False


def _first_element(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v[0].detach().cpu().numpy()
    return np.asarray(v)[0]


class ProgramCache:
    """Compiled batched programs keyed by model, data shapes and settings;
    a hit also needs value-equal bound hyperparameters, initialization and
    options."""

    def __init__(self):
        self._entries: dict = {}

    def get(self, sig, values):
        hit = self._entries.get(sig)
        if hit is None:
            return None
        compiled, prog, c_values = hit
        if _value_equal(c_values, values):
            return compiled, prog
        return None

    def put(self, sig, values, compiled, prog):
        self._entries[sig] = (compiled, prog, values)


_PROGRAMS = ProgramCache()
_COMPILED = ProgramCache()     # infer's compiled models (programs inside)


def batched_program(model, data: dict, iterations: Optional[int] = None,
                    free_energy: bool = False,
                    initialization: Optional[dict] = None,
                    constraints: Any = None, meta: Any = None,
                    options: Optional[dict] = None, keep_each: bool = False,
                    shared: tuple = (), psum_axis: Optional[str] = None,
                    device: Any = None):
    """Compile (and cache) the batch-native inference program for ``data``
    (every leaf carrying a leading batch axis).  Returns ``(compiled_model,
    program)``; the program maps the batched data dict to ``(state,
    free_energy, history)``, the free energy (iterations, B) with
    ``free_energy=True`` and (0, B) without.  Eligible chain blocks run on
    the fused kernels (engine/batched.py).  ``shared``: plain groups pooled
    over the batch (``make_batched_program``); the free energy is then the
    pooled model's, (iterations,).  ``psum_axis`` (the pooled sum over a
    device mesh) is not ported."""
    device = _resolve_device(device)
    if psum_axis is not None:
        raise NotImplementedError(
            "batched_program(psum_axis=...): shared= pooling over a device "
            "mesh is not ported to the PyTorch package yet (ROADMAP A7b).")
    shared = (shared,) if isinstance(shared, str) else tuple(shared)
    iterations = iterations or 1
    init_dists = dict(initialization or {})
    first = {k: _first_element(v) for k, v in data.items()}
    all_finite = _all_finite(data)
    sig = (model.fn, tuple(sorted(model.bound)), _shape_sig(data),
           tuple(sorted(init_dists, key=repr)), iterations, free_energy,
           keep_each,
           all_finite, tuple(sorted(shared)), str(device))
    # the bound hyperparameters, the meta and the constraints are traced
    # into the program, so a hit needs their values, not only their names
    values = (dict(model.bound), init_dists, options, meta, constraints)
    cached = _PROGRAMS.get(sig, values)
    if cached is not None:
        return cached
    graph = model.trace(first)
    compiled = CompiledModel(graph, init=init_dists, options=options,
                             constraints=constraints, meta=meta)
    prog = compiled.make_batched_program(
        first, iterations, free_energy, keep_each=keep_each,
        all_finite=all_finite, device=device,
        batch_hint=int(np.shape(next(iter(data.values())))[0]),
        shared=shared)
    _PROGRAMS.put(sig, values, compiled, prog)
    return compiled, prog


_UNPORTED_INFER = (("mesh", "A7b"),)


def _has_missing(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.is_floating_point() and bool(torch.isnan(v).any())
    arr = np.asarray(v)
    return np.issubdtype(arr.dtype, np.floating) and bool(np.isnan(arr).any())


def _batch_of_one(d):
    from .dists import tree_map

    return tree_map(lambda a: a[None], d)


def _unbatch(d):
    from .dists import tree_map

    return tree_map(lambda a: a[0], d)


def infer(model, data: Optional[dict] = None, datastream: Any = None,
          autoupdates: Any = None, initialization: Optional[dict] = None,
          constraints: Any = None, meta: Any = None,
          options: Optional[dict] = None, iterations: Optional[int] = None,
          free_energy: bool = False, free_energy_diagnostics: Any = "default",
          predictvars: Any = None,
          returnvars: Any = None, keephistory: int = 0,
          historyvars: Any = None, showprogress: bool = False,
          callbacks: Optional[dict] = None, benchmark: bool = False,
          trace: bool = False, catch_exception: bool = False,
          annotations: Any = None, postprocess: Any = None,
          session: Any = "default", uselock: Any = False,
          allow_node_contraction: bool = False,
          mesh: Any = None, batched: bool = False, device: Any = None):
    """Inference on one dataset (batch mode): trace the model on the data's
    shapes, compile the schedule once per shape and setting, run
    ``iterations`` sweeps and return an ``InferenceResult``.  Every chain is
    solved by its block's scans (``ops/kalman.py``, ``ops/discrete_chain.py``:
    associative scans from 48 slots, loops below), as a batch of one.

    The reference's defaults: ``returnvars`` is ``KeepEach()`` when
    ``iterations`` is given and ``KeepLast()`` otherwise; a dict selects
    variables (unknown names warn).  ``predictvars`` defaults to every data
    entry holding NaN (missing) values; a list keeps final-state
    predictions.  ``free_energy=True`` returns the Bethe free energy after
    every sweep, checked by ``free_energy_diagnostics`` (NaN and Inf by
    default; ``None`` checks nothing).  ``catch_exception=True`` returns a
    result carrying ``error`` and ``traceback`` instead of raising.

    With ``autoupdates`` (or a ``datastream``) it is streaming inference
    instead: it returns the ``RxInferenceEngine`` of
    ``inference_streaming.py``, which has run ``datastream`` to its end when
    one is given (``batched=True``: B streams in lockstep, every
    observation and autoupdated value with a leading batch axis).

    Every call is logged to ``session`` (``"default"``: the default
    session; None: none), with ``status="failure"`` when it fails.
    ``allow_node_contraction=True``: a ``submodel`` whose name is a
    registered node is traced as one factor of that node."""
    device = _resolve_device(device)
    if autoupdates is not None or datastream is not None:
        if mesh is not None:
            raise NotImplementedError(
                "infer(mesh=...) is not ported to the PyTorch package yet "
                "(ROADMAP A7b).")
        from .inference_streaming import streaming_infer

        return streaming_infer(
            model=model, datastream=datastream, autoupdates=autoupdates,
            initialization=initialization, iterations=iterations or 1,
            free_energy=free_energy,
            free_energy_diagnostics=free_energy_diagnostics,
            keephistory=keephistory, options=options, uselock=uselock,
            constraints=constraints, meta=meta, callbacks=callbacks,
            returnvars=returnvars, historyvars=historyvars,
            annotations=annotations, postprocess=postprocess,
            benchmark=benchmark, trace=trace,
            catch_exception=catch_exception, session=session,
            allow_node_contraction=allow_node_contraction,
            batched=batched, device=device)
    if data is None:
        raise ValueError(
            "Batch inference requires data= (or use datastream=).")
    if data is not None and not isinstance(data, dict):
        raise TypeError(
            "Keyword argument `data` expects a dict mapping data-variable "
            f"names to arrays; got {type(data).__name__}.")
    warn_opt = True if options is None else options.get("warn", True)
    if (keephistory or historyvars is not None) and warn_opt:
        warnings.warn(
            "keephistory/historyvars are streaming-only (reference parity); "
            "ignored in batch mode. Use returnvars=KeepEach() for "
            "per-iteration posteriors.", stacklevel=2)
    kwargs = dict(
        model=model, data=data, initialization=initialization,
        constraints=constraints, meta=meta, options=options,
        iterations=iterations, free_energy=free_energy,
        free_energy_diagnostics=free_energy_diagnostics,
        predictvars=predictvars, returnvars=returnvars,
        showprogress=showprogress, callbacks=callbacks,
        benchmark=benchmark, trace=trace, annotations=annotations,
        postprocess=postprocess, mesh=mesh, device=device,
        allow_node_contraction=allow_node_contraction)
    from .utils.session import resolve_session

    sess = resolve_session(session)
    log = dict(label="inference", model=getattr(model, "name", str(model)),
               data_keys=sorted(data), iterations=iterations or 1)
    t0 = time.perf_counter()
    try:
        result = _infer(warn_opt, **kwargs)
    except Exception as exc:  # noqa: BLE001 — logged, then raised or kept
        if sess is not None:
            sess.log_invoke(**log, status="failure", error=repr(exc),
                            duration_s=time.perf_counter() - t0)
        if not catch_exception:
            raise
        import traceback

        result = InferenceResult({}, None, None, 0.0)
        result.error = exc
        result.traceback = traceback.format_exc()
        result.predictions = {}
        result.benchmark = None
        result.trace = None
        return result
    if sess is not None:
        sess.log_invoke(**log, status="success", duration_s=result.elapsed_s)
    return result


def _infer(warn_opt: bool, model, data, initialization, options, iterations,
           free_energy, free_energy_diagnostics, predictvars, returnvars,
           showprogress, callbacks, benchmark, trace, device, annotations,
           postprocess, meta, constraints, allow_node_contraction,
           **unported):
    for name, item in _UNPORTED_INFER:
        val = unported[name]
        if val is not None and val is not False and not (
                isinstance(val, (dict, list, tuple)) and not val):
            raise NotImplementedError(
                f"infer({name}=...) is not ported to the PyTorch package "
                f"yet (ROADMAP {item}).")
    from .utils.callbacks import (
        BenchmarkCallbacks,
        CallbackRegistry,
        TraceCallbacks,
    )

    unfactorized = {k for k, v in data.items()
                    if isinstance(v, UnfactorizedData)}
    data = {k: (v.data if isinstance(v, UnfactorizedData) else v)
            for k, v in data.items()}
    iterations_given = iterations is not None
    iterations = iterations or 1
    default_keep = KeepEach() if iterations_given else KeepLast()

    # predictvars: a global KeepEach/KeepLast applies to every data
    # variable; None derives predictions for every entry holding missing
    # values; a list keeps final-state predictions; a dict is taken as it
    # is, and entries with missing values absent from it are added
    derived_pv: set = set()
    if isinstance(predictvars, (KeepEach, KeepLast)):
        predictvars = {k: predictvars for k in data}
    elif predictvars is None:
        predictvars = {k: default_keep for k, v in data.items()
                       if _has_missing(v)}
        derived_pv = set(predictvars)
    elif isinstance(predictvars, dict):
        predictvars = dict(predictvars)
    else:
        predictvars = {k: KeepLast() for k in predictvars}
    absent_pv = [k for k in predictvars if k not in data]
    if absent_pv:
        raise ValueError(
            f"predictvars name data variables absent from data=: {absent_pv}."
            " This engine traces the model from the data SHAPES, so predict-"
            "only variables must be passed as all-NaN arrays of the desired "
            "shape.")
    for k, v in data.items():
        if k not in predictvars and _has_missing(v):
            predictvars[k] = default_keep
            derived_pv.add(k)
    t0 = time.perf_counter()

    registry = CallbackRegistry(callbacks)
    bench_cb = BenchmarkCallbacks().attach(registry) if benchmark else None
    trace_cb = TraceCallbacks().attach(registry) if trace else None
    if showprogress:
        def _progress(event):
            i = event.payload.get("iteration", 0) + 1
            done = int(30 * i / iterations)
            sys.stderr.write(
                f"\rinference: [{'=' * done}{' ' * (30 - done)}] "
                f"{i}/{iterations}" + ("\n" if i == iterations else ""))
            sys.stderr.flush()

        registry.add("after_iteration", _progress)

    init_dists = dict(initialization or {})
    sig = (model.fn, tuple(sorted(model.bound)), _shape_sig(data),
           tuple(sorted(init_dists, key=repr)), bool(allow_node_contraction),
           str(device))
    values = (dict(model.bound), init_dists, options, meta, constraints)
    hit = _COMPILED.get(sig, values)
    if hit is not None:
        compiled = hit[0]
    else:
        registry.invoke("before_model_creation")
        graph = model.trace({k: np.asarray(v.cpu() if isinstance(
            v, torch.Tensor) else v) for k, v in data.items()},
            allow_node_contraction=allow_node_contraction)
        compiled = CompiledModel(graph, init=init_dists, options=options,
                                 constraints=constraints, meta=meta)
        _COMPILED.put(sig, values, compiled, None)
        registry.invoke("after_model_creation")

    if returnvars is None:
        returnvars = default_keep
    rv_dict = returnvars if isinstance(returnvars, dict) else None
    rv_keep_each = isinstance(returnvars, KeepEach) or (
        rv_dict is not None
        and any(isinstance(v, KeepEach) for v in rv_dict.values()))
    keep_each = rv_keep_each or any(
        isinstance(v, KeepEach) for v in predictvars.values())

    # annotations read -FE as every non-mixture variable's log-scale; a
    # generic Mixture has no average energy, so its model's free energy is
    # composed from exact mixture evidences (checked here, before a sweep)
    has_mixture = any(f.fform == "Mixture" for f in compiled.graph.factors)
    mixture_plan = (_mixture_fe_plan(compiled) if has_mixture and free_energy
                    else None)
    need_fe = (free_energy and mixture_plan is None) or (
        annotations is not None and not has_mixture)
    registry.invoke("before_inference")
    if registry.empty:
        state, fe, history = compiled.run(
            data, iterations=iterations, free_energy=need_fe,
            keep_each=keep_each, device=device)
    else:
        state, fe, history = compiled.run_iterative(
            data, iterations=iterations, free_energy=need_fe,
            registry=registry, keep_each=keep_each, device=device)
    registry.invoke("after_inference")
    if annotations is not None or mixture_plan is not None:
        data_b, masks = compiled._device_data(
            {k: _batch_of_one(torch.as_tensor(v)) for k, v in data.items()},
            _all_finite(data), device)
        ctx_b = BatchContext(device, 1, {}, masks)
        state_b = {k: _batch_of_one(v) for k, v in state.items()}
    if mixture_plan is not None:
        fe = _composed_mixture_fe(compiled, mixture_plan, state_b, data_b,
                                  ctx_b)[:, 0]
    if free_energy:
        from .diagnostics import (
            DefaultObjectiveDiagnosticChecks,
            apply_fe_diagnostics,
        )

        apply_fe_diagnostics(
            DefaultObjectiveDiagnosticChecks
            if free_energy_diagnostics == "default"
            else free_energy_diagnostics, fe)

    posteriors = _extract_posteriors(compiled, state)
    predictions = {}
    if predictvars:
        data_b, masks = compiled._device_data(
            {k: _batch_of_one(torch.as_tensor(v)) for k, v in data.items()},
            _all_finite(data), device)
        ctx = BatchContext(device, 1, {}, masks)

        def predict(st, name):
            st = {k: _batch_of_one(v) for k, v in st.items()}
            return _unbatch(compiled.predict(st, data_b, name, ctx,
                                             structured=name in unfactorized))

        for name, opt in predictvars.items():
            try:
                if isinstance(opt, KeepEach) and history:
                    predictions[name] = [predict(h, name) for h in history]
                else:
                    predictions[name] = predict(state, name)
            except (ValueError, NotImplementedError):
                # auto-derived predictions (entries with missing values)
                # must not fail inference when the node has no rule for
                # them; the ones asked for propagate the error
                if name not in derived_pv:
                    raise
                if warn_opt:
                    warnings.warn(
                        f"prediction for missing-data variable {name!r} is "
                        "unavailable (no single defining factor / prediction"
                        " rule); skipped.", stacklevel=3)
    if rv_keep_each:
        posteriors = {
            name: [_extract_posteriors(compiled, h)[name] for h in history]
            for name in posteriors
        }
    if rv_dict is not None:
        unknown = set(rv_dict) - set(posteriors)
        if unknown and warn_opt:
            warnings.warn(
                f"returnvars names unknown variables {sorted(unknown)}; "
                "ignored.", stacklevel=3)
        posteriors = {
            name: (p[-1] if isinstance(rv_dict[name], KeepLast)
                   and isinstance(p, list) else p)
            for name, p in posteriors.items() if name in rv_dict
        }
    from .postprocess import (
        Marginal,
        default_postprocess,
        inference_postprocess,
    )

    strategy = postprocess if postprocess is not None \
        else default_postprocess(annotations)
    scales = {}
    if annotations is not None:
        from .engine.logscale import compute_logscales

        fe_last = fe[-1:] if need_fe and fe.numel() else None
        scales = {k: None if v is None else v[0] for k, v in
                  compute_logscales(compiled, state_b, data_b, ctx_b,
                                    fe_last).items()}

    def _wrap(d, it, name):
        if annotations is None:
            return d
        s = scales.get(name) if it in (-1, iterations - 1) else (
            -fe[it] if need_fe else None)
        # no scale (no free energy, not next to a mixture): a Marginal
        # without annotations, so that getlogscale says why
        return Marginal(d, {"log_scale": s} if s is not None else {})

    posteriors = {
        name: ([inference_postprocess(strategy, _wrap(d, i, name))
                for i, d in enumerate(p)] if isinstance(p, list)
               else inference_postprocess(strategy, _wrap(p, -1, name)))
        for name, p in posteriors.items()}
    result = InferenceResult(posteriors, fe if free_energy else None,
                             compiled, time.perf_counter() - t0)
    result.predictions = predictions
    result.benchmark = bench_cb
    result.trace = trace_cb
    return result


def _extract_posteriors(compiled: CompiledModel, state: dict) -> dict:
    """User-facing marginals: named (non-anonymous) random variables."""
    return {v.name: state[v.name] for v in compiled.graph.random_variables()
            if not v.name.startswith("_")}


def _slice_rows(x, n: int):
    from .dists import tree_map

    return tree_map(lambda a: a[:n], x)




def _mixture_fe_plan(compiled) -> dict:
    """The free energy of a generic-Mixture model, decomposed when the
    program is planned: each Mixture factor's neighbourhood {out, switch,
    comps} must close over constants and data (no variable shared by two
    Mixture factors; every other factor next to a mixture variable touches
    that one random variable only).  Then Z factorizes into the mixtures'
    evidences times the rest, and FE = sum_mix(-log Z_mix) + the Bethe FE
    of the rest.  Raises ``NotImplementedError`` otherwise, before any
    sweep."""
    g = compiled.graph
    mix_fs = [f for f in g.factors if f.fform == "Mixture"]
    owner: dict = {}
    for mf in mix_fs:
        names = [mf.out.var.name, mf.interfaces["switch"].var.name] + [
            mf.interfaces[f"comp{i}"].var.name for i in range(mf.meta["K"])]
        for nm in names:
            if nm in owner and owner[nm] is not mf:
                raise NotImplementedError(
                    f"free_energy=True: variable {nm!r} is shared by two "
                    "Mixture factors; the exact-evidence decomposition "
                    "needs disjoint mixture neighborhoods. Use "
                    "annotations=LogScaleAnnotations() or free_energy=False.")
            owner[nm] = mf
    plain_factors = []
    for f in g.factors:
        if f.fform == "Mixture":
            continue
        rand = {v.var.name for v in f.all_interfaces().values()
                if isinstance(v, Ref) and v.var.kind == "random"}
        touched = sorted(rand & set(owner))
        if not touched:
            plain_factors.append(f)
            continue
        others = sorted(rand - set(owner))
        if others or len(touched) > 1:
            raise NotImplementedError(
                f"free_energy=True on this Mixture model: factor {f.fform!r} "
                f"connects mixture variable(s) {touched} to "
                f"{others or 'each other'} — the exact-evidence "
                "decomposition needs each mixture neighborhood to close "
                "over constants/data. Use annotations=LogScaleAnnotations() "
                "for per-component evidence, or free_energy=False.")
    plain_vars = {v.name for v in g.random_variables()
                  if v.name not in owner and not v.name.startswith("_")}
    return {"mix_fs": mix_fs, "plain_factors": plain_factors,
            "plain_vars": plain_vars}


def _composed_mixture_fe(compiled, plan: dict, state: dict, data: dict,
                         ctx: BatchContext):
    """FE = Bethe FE of the plain factors and variables - sum_mix log Z_mix
    at the final state, (1, B) (``data`` on the device, ``ctx`` its
    context).  A plain chain's pair statistics come from one more sweep from
    the fixed point (a no-op for a converged run)."""
    from .engine.bethe import FactorFE, variable_entropy_term
    from .engine.logscale import compute_logscales

    plain_vars = plan["plain_vars"]
    plain_fes = [
        FactorFE(f, is_chain_transition=id(f) in compiled._chain_factor_ids,
                 chain_scalar=(f.out.var.kind == "random"
                               and f.out.var.name in compiled.chains
                               and compiled.infos[f.out.var.name].event_shape
                               == ()),
                 mean_field=f.id in compiled.mf_factor_ids)
        for f in plan["plain_factors"]]
    chain_cross: dict = {}
    if any(nm in compiled.chains for nm in plain_vars):
        state, chain_cross = compiled._sweep_once(dict(state), chain_cross,
                                                  data, ctx)
    entropies = {nm: state[nm].entropy() for nm in plain_vars
                 if not isinstance(state[nm], PointMass)}
    total = variable_entropy_term(compiled.graph, state, compiled.degrees,
                                  ctx.batch, entropies)
    for ffe in plain_fes:
        total = total + ffe(state, data, chain_cross, ctx, entropies)
    scales = compute_logscales(compiled, state, data, ctx)
    for mf in plan["mix_fs"]:
        scale = scales.get(mf.out.var.name)
        if scale is None:
            raise NotImplementedError(
                "free_energy=True on this Mixture model: the exact-evidence "
                "logscale analysis does not support its inbound structure "
                "(see the warning above). Use "
                "annotations=LogScaleAnnotations() for per-component "
                "evidence, or free_energy=False.")
        total = total - scale
    return torch.as_tensor(total, dtype=torch.float32,
                           device=ctx.device).expand(ctx.batch)[None]


def _annotate_batched(compiled, state: dict, data_dev: dict, ctx, fe,
                      need_fe: bool, shared: tuple, posteriors: dict,
                      annotations, postprocess) -> dict:
    """``infer_batched``'s annotations and postprocess: every final
    posterior a ``Marginal`` with its (B,) log-scale (under ``shared=`` the
    pooled model's one evidence, -FE), then the strategy."""
    from .postprocess import (
        Marginal,
        default_postprocess,
        inference_postprocess,
    )

    strategy = postprocess if postprocess is not None \
        else default_postprocess(annotations)
    scales = {}
    if annotations is not None:
        from .engine.logscale import compute_logscales

        fe_row = fe[-1] if need_fe and fe.numel() else None
        if shared and fe_row is not None:
            scales = {name: -fe_row for name in posteriors}
        else:
            scales = compute_logscales(compiled, state, data_dev, ctx,
                                       fe_row)

    def wrap(d, name):
        if annotations is None:
            return d
        s = scales.get(name)
        return Marginal(d, {"log_scale": s} if s is not None else {})

    return {name: ([inference_postprocess(strategy, wrap(d, name)
                                          if i == len(p) - 1 else d)
                    for i, d in enumerate(p)] if isinstance(p, list)
                   else inference_postprocess(strategy, wrap(p, name)))
            for name, p in posteriors.items()}


def infer_batched(model, data: dict, iterations: Optional[int] = None,
                  free_energy: bool = False,
                  initialization: Optional[dict] = None,
                  constraints: Any = None, meta: Any = None,
                  options: Optional[dict] = None, returnvars: Any = None,
                  predictvars: Any = None, annotations: Any = None,
                  mesh: Any = None, mesh_axis: str = "dp",
                  shared: Any = (), device: Any = None,
                  free_energy_diagnostics: Any = None,
                  postprocess: Any = None):
    """Batched inference over B independent datasets.

    Every value in ``data`` carries a leading batch axis; the model is traced
    once on the first element, its Gaussian chains run on the fused smoother
    kernels, its discrete chains on the fused forward-backward kernels and
    its plain conjugate groups on natural-parameter message products over
    the batch; a chain the plan leaves off the kernels (see
    ``compiled.plan_report()``) runs its block's batch-major scans in the
    same sweep.  Returns a ``BatchedInferenceResult`` that unpacks as
    ``(posteriors, free_energy)``; every posterior's tensors carry the
    leading batch axis (lists per iteration under ``returnvars=KeepEach()``);
    ``predictvars`` (names of data variables) gives each one's
    posterior-predictive distribution over the batch from the final state,
    under ``.predictions``.  ``free_energy=True`` gives every dataset's
    Bethe free energy after every sweep, (iterations, B), checked by
    ``free_energy_diagnostics`` when given (the JAX package checks none
    here, so nothing by default).  A batch whose chain moments (and free
    energy's working set) exceed ``options["hbm_budget_bytes"]`` runs as
    sequential chunks of one program.

    ``shared=("tau",)``: the named plain groups are POOLED over the batch,
    one posterior (broadcast over the batch axis) in place of B: their
    per-dataset messages are summed over the batch in natural parameters
    each sweep, their replicated factors (the prior) counted once, and the
    free energy is the pooled model's, (iterations,).  Beyond the budget the
    pooled sum accumulates over sequential chunks
    (``make_chunked_shared_program``; not with ``KeepEach``).

    ``annotations=LogScaleAnnotations()``: every final posterior becomes a
    ``Marginal`` carrying its (B,) log-scale (``engine/logscale.py``): -FE
    per dataset, exact per-component evidences next to a generic
    ``Mixture``, the pooled scalar -FE under ``shared=``.  ``postprocess``
    (``postprocess.py``) then maps every posterior; by default it unpacks
    the annotations unless they were asked for."""
    device = _resolve_device(device)
    if mesh:
        raise NotImplementedError(
            "infer_batched(mesh=...) is not ported to the PyTorch package "
            "yet (ROADMAP A7b).")
    del mesh_axis
    keep_each = isinstance(returnvars, KeepEach)
    shared = (shared,) if isinstance(shared, str) else tuple(shared)
    kw = dict(iterations=iterations, initialization=initialization,
              constraints=constraints, meta=meta, options=options,
              keep_each=keep_each, device=device)
    compiled, prog = batched_program(model, data, free_energy=free_energy,
                                     shared=shared, **kw)
    # annotations read -FE as every non-mixture posterior's log-scale; a
    # generic-Mixture model's free energy is composed from exact evidences
    has_mixture = any(f.fform == "Mixture" for f in compiled.graph.factors)
    mixture_plan = (_mixture_fe_plan(compiled) if has_mixture and free_energy
                    else None)
    need_fe = (free_energy and mixture_plan is None) or (
        annotations is not None and not has_mixture)
    if need_fe != free_energy:
        compiled, prog = batched_program(model, data, free_energy=need_fe,
                                         shared=shared, **kw)
    from .engine.batched import (
        DEFAULT_HBM_BUDGET,
        batch_chunk_size,
        concat_rows,
        make_chunked_shared_program,
    )

    batch = int(np.shape(next(iter(data.values())))[0])
    budget = (options or {}).get("hbm_budget_bytes") or DEFAULT_HBM_BUDGET
    chunk = batch_chunk_size(compiled, batch, budget, need_fe)
    if chunk is None:
        state, fe, history = prog(data)
    elif shared:
        # the pooled update is additive in natural parameters, so it
        # accumulates over sequential chunks
        if keep_each:
            raise NotImplementedError(
                "infer_batched(shared=..., returnvars=KeepEach()) beyond the "
                "HBM budget: per-iteration history of chunked pooled runs is "
                "not kept. Use KeepLast or raise "
                "options={'hbm_budget_bytes': ...}.")
        warnings.warn(
            f"infer_batched(shared=...): batch {batch} exceeds the "
            f"chain-moment budget ({budget / 1e9:.1f} GB); pooled "
            f"aggregation runs in sequential chunks of {chunk} with "
            "cross-chunk natural-parameter accumulation.", stacklevel=2)
        key = ("chunked_shared", shared, chunk, iterations or 1, need_fe,
               _all_finite(data), str(device))
        if key not in compiled._programs:
            compiled._programs[key] = make_chunked_shared_program(
                compiled, {k: _first_element(v) for k, v in data.items()},
                iterations or 1, need_fe, shared, chunk,
                all_finite=key[5], device=device)
        state, fe, history = compiled._programs[key](data)
    else:
        # chain moments exceed the budget: run sequential chunks of one
        # program (the last chunk edge-padded to keep its shape)
        nch = math.ceil(batch / chunk)
        warnings.warn(
            f"infer_batched: batch {batch} exceeds the chain-moment budget "
            f"({budget / 1e9:.1f} GB); processing {nch} sequential chunks "
            f"of {chunk}.", stacklevel=2)
        rows = lambda v, lo, hi: v[lo:hi]
        chunk0 = {k: rows(v, 0, chunk) for k, v in data.items()}
        compiled, prog = batched_program(model, chunk0, free_energy=need_fe,
                                         **kw)
        states, fes, hists = [], [], []
        for i in range(nch):
            sl = {k: torch.as_tensor(rows(v, i * chunk, (i + 1) * chunk),
                                     dtype=torch.float32, device=device)
                  for k, v in data.items()}
            n = next(iter(sl.values())).shape[0]
            if n < chunk:
                sl = {k: torch.cat([v, v[-1:].expand(
                    (chunk - n,) + tuple(v.shape[1:]))]) for k, v in sl.items()}
            st, f, h = prog(sl)
            states.append({k: _slice_rows(v, n) for k, v in st.items()})
            fes.append(f[:, :n])
            hists.append([{k: _slice_rows(v, n) for k, v in hj.items()}
                          for hj in h])
        state = {k: concat_rows([s[k] for s in states]) for k in states[0]}
        fe = torch.cat(fes, dim=1)
        history = [
            {k: concat_rows([hp[j][k] for hp in hists]) for k in hists[0][j]}
            for j in range(len(hists[0]))
        ]
    posteriors = _extract_posteriors(compiled, state)
    if keep_each:
        posteriors = {
            name: [_extract_posteriors(compiled, h)[name] for h in history]
            for name in posteriors
        }
    if annotations is not None or postprocess is not None or predictvars \
            or mixture_plan is not None:
        # the data on the device, zero-filled where it is missing
        data_dev, masks = compiled._device_data(data, _all_finite(data),
                                                device)
        ctx = BatchContext(device, batch, {}, masks)
    if mixture_plan is not None:
        fe = _composed_mixture_fe(compiled, mixture_plan, state, data_dev,
                                  ctx)
    if annotations is not None or postprocess is not None:
        posteriors = _annotate_batched(compiled, state, data_dev, ctx, fe,
                                       need_fe, shared, posteriors,
                                       annotations, postprocess)
    predictions = {}
    if predictvars:
        # the final state's forward messages over the batch
        for name in predictvars:
            predictions[name] = compiled.predict(state, data_dev, name, ctx)
    if free_energy:
        from .diagnostics import apply_fe_diagnostics

        apply_fe_diagnostics(free_energy_diagnostics, fe)
    return BatchedInferenceResult(posteriors, fe if free_energy else None,
                                  predictions)


class BatchedInferenceResult(tuple):
    """``(posteriors, free_energy)`` pair that always unpacks 2-ary;
    predictions ride along as an attribute."""

    def __new__(cls, posteriors, free_energy, predictions):
        obj = super().__new__(cls, (posteriors, free_energy))
        obj._predictions = predictions
        return obj

    @property
    def posteriors(self):
        return self[0]

    @property
    def free_energy(self):
        return self[1]

    @property
    def predictions(self):
        return self._predictions
