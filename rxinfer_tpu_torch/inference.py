"""Batched inference entry points (counterpart of
``rxinfer_tpu/inference.py``).

Ported subset: ``batched_program``, ``infer_batched``,
``BatchedInferenceResult``, ``KeepLast``/``KeepEach`` and
``_extract_posteriors``, with the port's own program cache.  Posteriors are
whatever the blocks produce, every leaf with the batch axis first: Gaussian
chains, ``Categorical`` chains, ``DirichletCollection`` and Gaussian plain
groups; initializations of scalar groups are broadcast over the batch by
the program.  Both entry points run on ``"cuda"`` unless the caller passes
another ``device``; with no device given and no CUDA device present they
raise ``RuntimeError`` rather than carry on on the CPU.

Not ported yet (they raise ``NotImplementedError``): the single-dataset
``infer``, streaming, ``free_energy=True``, ``annotations``,
``predictvars``, ``shared=`` and ``mesh=``.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Optional

import numpy as np
import torch

from .engine.compile import CompiledModel


class KeepLast:
    """Return only the final iteration's posterior."""


class KeepEach:
    """Return posteriors from every iteration."""


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


def _all_finite(data: dict) -> bool:
    for v in data.values():
        if isinstance(v, torch.Tensor):
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                return False
        else:
            a = np.asarray(v)
            if np.issubdtype(a.dtype, np.floating) and not np.all(np.isfinite(a)):
                return False
    return True


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
    the batch.  Returns a ``BatchedInferenceResult`` that unpacks as
    ``(posteriors, free_energy)``; every posterior's tensors carry the
    leading batch axis (lists per iteration under ``returnvars=KeepEach()``).
    A batch whose chain moments exceed ``options["hbm_budget_bytes"]`` runs
    as sequential chunks of one program."""
    device = _resolve_device(device)
    for name, val in (("predictvars", predictvars),
                      ("annotations", annotations), ("mesh", mesh)):
        if val:
            raise NotImplementedError(
                f"infer_batched({name}=...) is not ported to the PyTorch "
                "package yet.")
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
    return BatchedInferenceResult(posteriors, fe if free_energy else None, {})


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
