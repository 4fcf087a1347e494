"""Inference entry points (counterpart of ``rxinfer_tpu/inference.py``).

Ported: ``infer`` in batch mode (one dataset; ``InferenceResult``,
``UnfactorizedData``, ``issuccess`` / ``iserror`` / ``getreturnval``,
``catch_exception``, the reference's ``returnvars`` / ``predictvars``
defaults, callbacks, ``benchmark=``, ``trace=`` and ``showprogress=``),
``batched_program``, ``infer_batched`` (with ``predictvars``),
``BatchedInferenceResult``, ``KeepLast`` / ``KeepEach`` and
``_extract_posteriors``, with the port's own caches.  ``infer`` solves every
chain with the scans of ``ops/kalman.py`` / ``ops/discrete_chain.py``, never
with the fused kernels, as the JAX package does.  Posteriors are whatever
the blocks produce (batched: every leaf with the batch axis first): Gaussian
chains, ``Categorical`` chains, ``DirichletCollection`` and Gaussian plain
groups.  Every entry point runs on ``"cuda"`` unless the caller passes
another ``device``; with no device given and no CUDA device present it
raises ``RuntimeError`` rather than carry on on the CPU.

Not ported yet (they raise ``NotImplementedError``, each naming its ROADMAP
item): streaming (``datastream`` / ``autoupdates``), ``free_energy=True``,
``annotations``, ``constraints``, ``meta``, a ``postprocess`` strategy,
``shared=`` and ``mesh=``.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
import warnings
from typing import Any, Optional

import numpy as np
import torch

from .engine.blocks import BatchContext
from .engine.compile import CompiledModel, _all_finite


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
    """Posteriors, free energy (None until free energy is ported), the
    compiled model and the wall time of one ``infer`` call."""

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
    """Structural value equality for cache keys."""
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
    free_energy (0, B), history)``.  Eligible chain blocks run on the fused
    kernels (engine/batched.py)."""
    device = _resolve_device(device)
    if shared or psum_axis is not None:
        raise NotImplementedError(
            "shared= aggregation is not ported to the PyTorch package yet.")
    iterations = iterations or 1
    init_dists = dict(initialization or {})
    first = {k: _first_element(v) for k, v in data.items()}
    all_finite = _all_finite(data)
    sig = (model.fn, tuple(sorted(model.bound)), _shape_sig(data),
           tuple(sorted(init_dists)), iterations, free_energy, keep_each,
           all_finite, str(device))
    # the bound hyperparameters are traced into the program as constants,
    # so a hit needs their values, not only their names; constraints and
    # meta are not ported (CompiledModel raises on them), so every cached
    # program was built without them
    values = (dict(model.bound), init_dists, options)
    cached = _PROGRAMS.get(sig, values)
    if cached is not None and constraints is None and not meta:
        return cached
    graph = model.trace(first)
    compiled = CompiledModel(graph, init=init_dists, options=options,
                             constraints=constraints, meta=meta)
    prog = compiled.make_batched_program(
        first, iterations, free_energy, keep_each=keep_each,
        all_finite=all_finite, device=device)
    _PROGRAMS.put(sig, values, compiled, prog)
    return compiled, prog


_UNPORTED_INFER = (
    ("datastream", "A5"), ("autoupdates", "A5"), ("free_energy", "A2"),
    ("annotations", "A2/A4"), ("mesh", "A7"), ("constraints", "A6"),
    ("meta", "A6"), ("postprocess", "A6"),
)


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
          free_energy: bool = False, predictvars: Any = None,
          returnvars: Any = None, keephistory: int = 0,
          historyvars: Any = None, showprogress: bool = False,
          callbacks: Optional[dict] = None, benchmark: bool = False,
          trace: bool = False, catch_exception: bool = False,
          annotations: Any = None, postprocess: Any = None,
          mesh: Any = None, device: Any = None):
    """Inference on one dataset (batch mode): trace the model on the data's
    shapes, compile the schedule once per shape and setting, run
    ``iterations`` sweeps and return an ``InferenceResult``.  Every chain is
    solved by its block's scans (``ops/kalman.py``, ``ops/discrete_chain.py``:
    associative scans from 48 slots, loops below), as a batch of one.

    The reference's defaults: ``returnvars`` is ``KeepEach()`` when
    ``iterations`` is given and ``KeepLast()`` otherwise; a dict selects
    variables (unknown names warn).  ``predictvars`` defaults to every data
    entry holding NaN (missing) values; a list keeps final-state
    predictions.  ``catch_exception=True`` returns a result carrying
    ``error`` and ``traceback`` instead of raising."""
    device = _resolve_device(device)
    if data is None and datastream is None and autoupdates is None:
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
        model=model, data=data, datastream=datastream,
        autoupdates=autoupdates, initialization=initialization,
        constraints=constraints, meta=meta, options=options,
        iterations=iterations, free_energy=free_energy,
        predictvars=predictvars, returnvars=returnvars,
        showprogress=showprogress, callbacks=callbacks,
        benchmark=benchmark, trace=trace, annotations=annotations,
        postprocess=postprocess, mesh=mesh, device=device)
    if not catch_exception:
        return _infer(warn_opt, **kwargs)
    try:
        return _infer(warn_opt, **kwargs)
    except Exception as exc:  # noqa: BLE001 — the result carries the error
        import traceback

        result = InferenceResult({}, None, None, 0.0)
        result.error = exc
        result.traceback = traceback.format_exc()
        result.predictions = {}
        result.benchmark = None
        result.trace = None
        return result


def _infer(warn_opt: bool, model, data, initialization, options, iterations,
           predictvars, returnvars, showprogress, callbacks, benchmark,
           trace, device, **unported):
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
           tuple(sorted(init_dists)), str(device))
    values = (dict(model.bound), init_dists, options)
    hit = _COMPILED.get(sig, values)
    if hit is not None:
        compiled = hit[0]
    else:
        registry.invoke("before_model_creation")
        graph = model.trace({k: np.asarray(v.cpu() if isinstance(
            v, torch.Tensor) else v) for k, v in data.items()})
        compiled = CompiledModel(graph, init=init_dists, options=options)
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

    registry.invoke("before_inference")
    if registry.empty:
        state, _, history = compiled.run(data, iterations=iterations,
                                         keep_each=keep_each, device=device)
    else:
        state, _, history = compiled.run_iterative(
            data, iterations=iterations, free_energy=False,
            registry=registry, keep_each=keep_each, device=device)
    registry.invoke("after_inference")

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
    result = InferenceResult(posteriors, None, compiled,
                             time.perf_counter() - t0)
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


def _concat_rows(parts: list):
    from .dists import tree_leaves

    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts, dim=0)
    cols = list(zip(*[tree_leaves(p) for p in parts]))
    return type(first)(*[torch.cat(list(c), dim=0) for c in cols])


def infer_batched(model, data: dict, iterations: Optional[int] = None,
                  free_energy: bool = False,
                  initialization: Optional[dict] = None,
                  constraints: Any = None, meta: Any = None,
                  options: Optional[dict] = None, returnvars: Any = None,
                  predictvars: Any = None, annotations: Any = None,
                  mesh: Any = None, mesh_axis: str = "dp",
                  shared: Any = (), device: Any = None):
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
    under ``.predictions``.  A batch whose chain moments exceed
    ``options["hbm_budget_bytes"]`` runs as sequential chunks of one
    program."""
    device = _resolve_device(device)
    for name, val, item in (("annotations", annotations, "A2/A4"),
                            ("mesh", mesh, "A7")):
        if val:
            raise NotImplementedError(
                f"infer_batched({name}=...) is not ported to the PyTorch "
                f"package yet (ROADMAP {item}).")
    del mesh_axis
    keep_each = isinstance(returnvars, KeepEach)
    shared = (shared,) if isinstance(shared, str) else tuple(shared)
    compiled, prog = batched_program(
        model, data, iterations=iterations, free_energy=free_energy,
        initialization=initialization, constraints=constraints, meta=meta,
        options=options, keep_each=keep_each, shared=shared, device=device)
    from .engine.batched import DEFAULT_HBM_BUDGET, batch_chunk_size

    batch = int(np.shape(next(iter(data.values())))[0])
    budget = (options or {}).get("hbm_budget_bytes") or DEFAULT_HBM_BUDGET
    chunk = batch_chunk_size(compiled, batch, budget)
    if chunk is None:
        state, fe, history = prog(data)
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
        compiled, prog = batched_program(
            model, chunk0, iterations=iterations, free_energy=free_energy,
            initialization=initialization, constraints=constraints,
            meta=meta, options=options, keep_each=keep_each, device=device)
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
        state = {k: _concat_rows([s[k] for s in states]) for k in states[0]}
        fe = torch.cat(fes, dim=1)
        history = [
            {k: _concat_rows([hp[j][k] for hp in hists]) for k in hists[0][j]}
            for j in range(len(hists[0]))
        ]
    posteriors = _extract_posteriors(compiled, state)
    if keep_each:
        posteriors = {
            name: [_extract_posteriors(compiled, h)[name] for h in history]
            for name in posteriors
        }
    predictions = {}
    if predictvars:
        # the final state's forward messages, over the batch, on the data
        # zero-filled where it is missing
        data_dev, masks = compiled._device_data(data, _all_finite(data),
                                                device)
        ctx = BatchContext(device, batch, {}, masks)
        for name in predictvars:
            predictions[name] = compiled.predict(state, data_dev, name, ctx)
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
