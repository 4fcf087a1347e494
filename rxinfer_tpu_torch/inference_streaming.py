"""Streaming inference engine (counterpart of
``rxinfer_tpu/inference_streaming.py``; the reference's RxInferenceEngine
and ``@autoupdates``).

The posterior-to-prior feedback (``autoupdates``) is a function
``new_prior_args = f(posteriors)``, so an observation step is
``args' = step(args, observation)``.  The engine runs it on one stream, or
on B independent streams in lockstep (``batched=True``: every observation
and every autoupdated argument carries a leading batch axis; the model
describes one stream).  ``on_next`` runs one tick from a Python event loop;
``run_offline`` runs a whole observation array.  Ticks keep the marginals
and the chains' pair statistics of the previous tick (warm start); the
``initialization`` is read at the first tick only.

Every tick is the compiled model's batch-major sweep (a single stream is a
batch of one), so the batched engine needs no per-stream map.  A batched
``run_offline`` whose tick is linear-Gaussian filtering runs the whole
stream through the fused stream plan (``engine/stream_plan.py``) instead.
Autoupdate mappings receive the posteriors as torch tensors on the engine's
device (with the batch axis when batched) and return tensors or numbers.

Ported: ``autoupdates`` (with its required ``initial`` and the
two-argument form, whose second argument resolves mu(x) messages),
``RxInferenceEvent``, ``RxInferenceEngine`` (the engine events of
``utils/callbacks.ENGINE_EVENTS``, ``on_next``, the one-program tick and
the host loop with per-iteration events and ``stop_iteration``,
``keephistory`` / ``historyvars`` / ``returnvars``, the free energy of
every tick, ``run_offline`` single and batched, ``start`` / ``stop``,
``is_errored`` and the ``on_error`` event, ``uselock``) and
``streaming_infer`` with ``benchmark=`` / ``trace=``, ``constraints=``
and ``meta=`` (the tick's compiled model takes them; its cavity stores,
``_msg:`` state entries, carry from tick to tick with the marginals),
``annotations=`` / ``postprocess=`` on every tick's posteriors
(``LogScaleAnnotations()`` with ``free_energy=True``: each posterior a
``Marginal`` whose log-scale is minus the tick's free energy, one per
stream when batched), ``allow_node_contraction=`` and ``session=`` (the
engine's creation is logged as ``"streaming_inference"``).  ``run_offline``
returns the raw per-tick posteriors, as the JAX engine's does; with
annotations or a postprocess a batched one takes the generic tick, not
the fused stream plan.  Not ported: ``mesh=`` (A7b) raises
``NotImplementedError`` naming it.
"""

from __future__ import annotations

import inspect
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from .dists import tree_map
from .engine.blocks import BatchContext
from .engine.compile import CompiledModel, _all_finite
from .utils.callbacks import ENGINE_EVENTS

# events whose registration runs a tick as a host loop, one sweep at a time
_PER_ITERATION_EVENTS = ("before_iteration", "after_iteration")


def _as_f32(v, device=None) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(dtype=torch.float32, device=device or v.device)
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def _n_required_positional(fn) -> int:
    """Required positional parameters of a mapping (closure defaults such
    as ``lambda q, k=k: ...`` do not count)."""
    try:
        return len([p for p in inspect.signature(fn).parameters.values()
                    if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                    and p.default is p.empty])
    except (TypeError, ValueError):
        return 1


class autoupdates:
    """Posterior-to-prior feedback (the reference's ``@autoupdates``)::

        au = autoupdates(
            initial={"pm": m0, "pc": P0},
            pm=lambda q: q["x"].mean(),
            pc=lambda q: q["x"].cov(),
        )

    ``initial`` gives the first tick's values of every autoupdated
    argument.  A mapping with two required positional parameters receives
    ``(q, mu)``, where ``mu[name]`` is the variable's outbound message along
    its last edge."""

    def __init__(self, initial: Optional[dict] = None,
                 **mapping: Callable[[dict], Any]):
        if not mapping:
            # reference: "`@autoupdates` did not find any auto-updates
            # specifications" (test/inference/autoupdates_tests.jl:249-254)
            raise ValueError(
                "autoupdates() did not find any auto-update specifications; "
                "pass keyword mappings, e.g. autoupdates(initial={'a': ...}, "
                "a=lambda q: q['theta'].mean()).")
        self.mapping = dict(mapping)
        self.initial = {k: _as_f32(v) for k, v in (initial or {}).items()}
        missing = sorted(set(self.mapping) - set(self.initial))
        if missing:
            # reference: "The initial value for `θ` has not been specified,
            # but is required in the `@autoupdates`."
            raise ValueError(
                f"The initial value for {missing} has not been specified, but "
                "is required in the autoupdates. Pass initial={...} covering "
                "every autoupdated argument.")
        self._nargs = {k: _n_required_positional(fn)
                       for k, fn in self.mapping.items()}

    def __call__(self, posteriors: dict, messages=None) -> dict:
        out = {}
        for k, fn in self.mapping.items():
            val = (fn(posteriors, messages) if self._nargs[k] >= 2
                   else fn(posteriors))
            out[k] = _as_f32(val)
        return out


def _strip_batch(d):
    """A batch of one without its batch axis (a distribution, a tensor or a
    dict of them)."""
    if isinstance(d, dict):
        return {k: _strip_batch(v) for k, v in d.items()}
    return tree_map(lambda a: a[0], d)


class _MessageFetch:
    """Lazy mu(x) resolver handed to two-argument autoupdate mappings."""

    def __init__(self, compiled: CompiledModel, state: dict, data: dict,
                 ctx: BatchContext, batched: bool):
        self._compiled = compiled
        self._state = state
        self._data = data
        self._ctx = ctx
        self._batched = batched

    def __getitem__(self, name):
        msg = self._compiled.variable_outbound_message(
            self._state, self._data, name, self._ctx)
        return msg if self._batched else _strip_batch(msg)


class RxInferenceEvent:
    def __init__(self, name: str, payload=None):
        self.name = name
        self.payload = payload
        self.timestamp_ns = time.perf_counter_ns()
        self.span_id = f"{id(self) & 0xffffffff:08x}"
        self.stop_iteration = False  # settable by after_iteration handlers

    def __repr__(self):
        return f"RxInferenceEvent({self.name})"


def _unported(what: str, item: str):
    return NotImplementedError(
        f"streaming inference with {what} is not ported to the PyTorch "
        f"package yet (ROADMAP {item}).")


class RxInferenceEngine:
    """Streaming engine: the compiled model of one tick and the current
    autoupdated arguments; ``on_next(obs)`` runs one tick (the reference's
    executor ``on_next!``, src/inference/streaming.jl:311-436).  Runs on
    ``"cuda"`` unless ``device`` says otherwise."""

    def __init__(self, model, autoupdates_spec: autoupdates,
                 iterations: int = 1, free_energy: bool = False,
                 free_energy_diagnostics="default",
                 keephistory: int = 0, options: Optional[dict] = None,
                 event_callbacks: Optional[dict] = None,
                 initialization: Optional[dict] = None,
                 constraints: Any = None, meta: Any = None,
                 returnvars: Any = None, historyvars: Any = None,
                 annotations: Any = None, postprocess: Any = None,
                 uselock=False, warn: bool = True,
                 allow_node_contraction: bool = False,
                 batched: bool = False, mesh: Any = None,
                 device: Any = None):
        from .inference import KeepEach, _resolve_device

        if mesh is not None:
            raise _unported("mesh=", "A7b")
        self.device = _resolve_device(device)
        self.model = model
        self.allow_node_contraction = allow_node_contraction
        self._batched = bool(batched)
        self.autoupdates = autoupdates_spec
        self.args = {k: v.to(self.device)
                     for k, v in autoupdates_spec.initial.items()}
        self.iterations = iterations
        self.free_energy = free_energy
        self.free_energy_diagnostics = free_energy_diagnostics
        self.keephistory = keephistory
        self.options = options
        self.initialization = initialization
        self.constraints = constraints
        self.meta = meta
        self.returnvars = returnvars
        self.annotations = annotations
        self.postprocess = postprocess
        self.history: list[dict] = []
        self.fe_history: list = []
        self.posteriors: Optional[dict] = None
        self._compiled: Optional[CompiledModel] = None
        self._stream_plan = None  # None: not probed; False: ineligible
        self._fused_fn = None
        # the previous tick's (state, chain_cross): marginals keep their
        # latest values across observations
        self._carry = None
        self._sweep_fns: dict = {}
        self.events: list[RxInferenceEvent] = []
        self._callbacks: dict[str, list] = {}
        for name, cb in (event_callbacks or {}).items():
            if name not in ENGINE_EVENTS:
                raise ValueError(
                    f"Unknown streaming event '{name}'; available: "
                    f"{ENGINE_EVENTS}")
            self._callbacks.setdefault(name, []).extend(
                cb if isinstance(cb, (list, tuple)) else [cb])
        self._recorders: list = []
        # historyvars (reference streaming.jl:737-763): needs keephistory >
        # 0; a KeepEach / KeepLast applies to every returned variable, a
        # dict per variable; the default (with keephistory) is KeepLast
        if historyvars is not None and not keephistory:
            if warn:
                import warnings

                warnings.warn(
                    "`historyvars` requires `keephistory > 0`; ignoring "
                    "(reference parity: src/inference/streaming.jl:761-763).",
                    stacklevel=3)
            historyvars = None
        self._historyvars = historyvars
        self._need_keep_each = bool(keephistory) and (
            isinstance(historyvars, KeepEach)
            or (isinstance(historyvars, dict)
                and any(isinstance(v, KeepEach)
                        for v in historyvars.values())))
        self.is_running = False
        self.is_errored = False
        # opt-in tick serialization against concurrent producers (reference
        # `uselock`): True for a fresh lock, or a lock object to share
        import threading

        self._lock = ((threading.Lock() if uselock is True else uselock)
                      if uselock else None)

    def _fire(self, name: str, payload=None) -> RxInferenceEvent:
        ev = RxInferenceEvent(name, payload)
        self.events.append(ev)
        for rec in self._recorders:
            rec(ev)
        for cb in self._callbacks.get(name, ()):
            cb(ev)
        return ev

    @property
    def _host_loop(self) -> bool:
        return any(self._callbacks.get(n) for n in _PER_ITERATION_EVENTS)

    # -- batch axis ---------------------------------------------------------------

    def _device_batch(self, data: dict) -> dict:
        """Data as float32 tensors on the device, with the batch axis."""
        out = {k: _as_f32(v, self.device) for k, v in data.items()}
        return out if self._batched else {k: v[None] for k, v in out.items()}

    def _user(self, d):
        """A batch-major value as the user sees it (no batch axis for a
        single stream)."""
        return d if self._batched else _strip_batch(d)

    def _ensure_compiled(self, obs: dict):
        if self._compiled is None:
            self._fire("before_model_creation")
            data = {**obs, **self.args}
            # the model describes one stream: trace it on stream 0
            data = {k: (v.detach().cpu().numpy() if isinstance(
                v, torch.Tensor) else np.asarray(v)) for k, v in data.items()}
            if self._batched:
                data = {k: v[0] for k, v in data.items()}
            self._compiled = CompiledModel(
                self.model.trace(
                    data, allow_node_contraction=self.allow_node_contraction),
                init=self.initialization, options=self.options,
                constraints=self.constraints, meta=self.meta)
            self._carry = None
            self._fire("after_model_creation")

    def _extract(self, state: dict) -> dict:
        from .inference import _extract_posteriors

        out = _extract_posteriors(self._compiled, state)
        if self.returnvars is not None:
            names = ([self.returnvars] if isinstance(self.returnvars, str)
                     else list(self.returnvars))
            out = {k: v for k, v in out.items() if k in names}
        return out

    def _postprocess(self, posteriors: dict, fe) -> dict:
        """A tick's posteriors as the user gets them: under
        ``annotations`` with the free energy each one a ``Marginal`` whose
        log-scale is minus the tick's last free energy (``fe`` in the user's
        layout: one value per stream when batched), then ``postprocess``
        (by default: keep the annotations when asked for, else unwrap)."""
        if self.annotations is None and self.postprocess is None:
            return posteriors
        from .postprocess import (
            Marginal,
            default_postprocess,
            inference_postprocess,
        )

        strategy = (self.postprocess if self.postprocess is not None
                    else default_postprocess(self.annotations))
        if self.annotations is not None and fe is not None and fe.numel():
            scale = -fe[..., -1]
            wrap = lambda d: Marginal(d, {"log_scale": scale})
        else:
            wrap = lambda d: d
        return {k: inference_postprocess(strategy, wrap(v))
                for k, v in posteriors.items()}

    def _fetch(self, state: dict, data: dict, all_finite: bool):
        data, ctx = self._compiled._tick_context(data, all_finite,
                                                 self.device, {})
        return _MessageFetch(self._compiled, state, data, ctx, self._batched)

    def _fe_out(self, fe):
        """(iterations, B) -> the user's layout: (iterations,) for a single
        stream, (B, iterations) batched."""
        return fe.transpose(0, 1) if self._batched else fe[:, 0]

    # -- ticks --------------------------------------------------------------------

    def on_next(self, obs: dict):
        """Process one observation: one autoupdate-fed tick (reference
        executor on_next!, src/inference/streaming.jl:311-436)."""
        clash = sorted(set(obs) & set(self.args))
        if clash:
            # reference: "`a` is present both in the `data` and in the
            # `autoupdates`." (test/inference/inference_tests.jl:1489-1514)
            raise ValueError(
                f"`{clash[0]}` is present both in the `data` and in the "
                "`autoupdates`.")
        if self._lock is not None:
            with self._lock:
                return self._on_next(obs)
        return self._on_next(obs)

    def _tick_compiled(self, data: dict, obs: dict, all_finite: bool):
        """Every iteration of the tick in one program; the per-iteration
        event pair fires once a tick (register a before/after_iteration
        callback for true per-iteration events)."""
        self._fire("before_iteration", {"iteration": 0})
        # the autoupdate computed from the previous tick's posteriors is
        # applied here: the arguments are already merged into ``data``
        self._fire("before_auto_update")
        self._fire("after_auto_update")
        self._fire("before_data_update", obs)
        state, fe, history_states, self._carry = self._compiled.run_tick(
            data, iterations=self.iterations, free_energy=self.free_energy,
            keep_each=self._need_keep_each, carry=self._carry,
            device=self.device, all_finite=all_finite)
        raw = self._extract(state)
        fe = self._fe_out(fe)
        self.posteriors = self._postprocess(
            self._user(raw), fe if self.free_energy else None)
        self._fire("on_marginal_update", self.posteriors)
        self._fire("after_data_update", obs)
        self._fire("after_iteration", {"iteration": self.iterations - 1})
        return state, raw, fe, history_states

    def _tick_host_loop(self, data: dict, obs: dict, all_finite: bool):
        """One sweep per VMP iteration with true per-iteration events and
        ``stop_iteration`` (reference streaming.jl:349-407)."""
        compiled = self._compiled
        key = (self.free_energy, all_finite)
        if key not in self._sweep_fns:
            self._sweep_fns[key] = compiled.make_sweep_fn(
                self.free_energy, self.device, all_finite)
        fn = self._sweep_fns[key]
        if self._carry is not None:
            carry = self._carry
        else:
            batch = next(iter(data.values())).shape[0]
            carry = (compiled._broadcast_init(
                compiled._device_init(self.device), batch), {})
        fes, history_states = [], []
        for i in range(self.iterations):
            self._fire("before_iteration", {"iteration": i})
            self._fire("before_auto_update")
            self._fire("after_auto_update")
            self._fire("before_data_update", obs)
            carry, fe = fn(carry, data)
            self._fire("on_marginal_update")
            self._fire("after_data_update", obs)
            if self.free_energy:
                fes.append(fe)
            if self._need_keep_each:
                history_states.append(dict(carry[0]))
            fe_user = None
            if self.free_energy:
                fe_user = (fe.cpu().numpy() if self._batched
                           else float(fe[0]))
            ev = self._fire("after_iteration",
                            {"iteration": i, "free_energy": fe_user})
            if ev.stop_iteration:
                break
        batch = next(iter(data.values())).shape[0]
        fe_arr = (torch.stack(fes) if fes
                  else torch.zeros((0, batch), device=self.device))
        self._carry = carry
        state = carry[0]
        raw = self._extract(state)
        fe_arr = self._fe_out(fe_arr)
        self.posteriors = self._postprocess(
            self._user(raw), fe_arr if self.free_energy else None)
        return state, raw, fe_arr, history_states

    def _on_next(self, obs: dict):
        # the reference engine's events (src/inference/streaming.jl:847-866)
        self._ensure_compiled(obs)
        self._fire("on_new_data", obs)
        data = self._device_batch({**obs, **self.args})
        all_finite = _all_finite(data)
        if self._host_loop:
            state, raw, fe, history_states = self._tick_host_loop(
                data, obs, all_finite)
        else:
            state, raw, fe, history_states = self._tick_compiled(
                data, obs, all_finite)
        # the next tick's arguments from this tick's posteriors (the
        # reference fetches them at the next tick's start: the same values)
        self.args = self.autoupdates(self._user(raw),
                                     self._fetch(state, data, all_finite))
        if self.free_energy:
            from .diagnostics import (
                DefaultObjectiveDiagnosticChecks,
                apply_fe_diagnostics,
            )

            apply_fe_diagnostics(
                DefaultObjectiveDiagnosticChecks
                if self.free_energy_diagnostics == "default"
                else self.free_energy_diagnostics, fe)
            self.fe_history.append(fe)
        if self.keephistory:
            self._fire("before_history_save")
            self.history.append(self._history_entry(raw, history_states))
            if len(self.history) > self.keephistory:
                self.history.pop(0)
            self._fire("after_history_save")
        self._fire("on_tick")
        return self.posteriors

    def _history_entry(self, raw: dict, history_states: list) -> dict:
        from .inference import KeepEach

        hv = self._historyvars
        entry = {}
        for name, final in raw.items():
            if isinstance(hv, dict) and name not in hv:
                continue
            opt = hv.get(name) if isinstance(hv, dict) else hv
            if isinstance(opt, KeepEach) and history_states:
                entry[name] = [self._user(self._extract(hs)[name])
                               for hs in history_states]
            else:
                entry[name] = self._user(final)
        return entry

    # -- offline ------------------------------------------------------------------

    def run_offline(self, observations: dict):
        """Run a whole observation array (name -> (T, ...); batched: (T, B,
        ...)) tick by tick with no events: the engine fed a complete static
        datastream (src/inference/streaming.jl:562-575).  Tick 0 starts cold
        from the initialization, later ticks warm-start from the previous
        tick's marginals.  Returns the per-tick posteriors stacked on a
        leading time axis and the free energies ((T, iterations); batched
        (T, B, iterations)).  A batched engine whose tick is linear-Gaussian
        filtering runs the fused stream plan (``engine/stream_plan.py``)."""
        obs = {k: _as_f32(v, self.device) for k, v in observations.items()}
        first = {k: v[0] for k, v in obs.items()}
        self._ensure_compiled(first)
        if self._batched:
            plan = self._ensure_stream_plan(first)
            if plan is not None:
                return self._run_fused(plan, obs)
        compiled = self._compiled
        lift = (lambda d: d) if self._batched else (
            lambda d: {k: v[None] for k, v in d.items()})
        all_finite = _all_finite(obs)
        t_total = next(iter(obs.values())).shape[0]
        args = dict(self.args)
        carry = None
        posts, fes = [], []
        for t in range(t_total):
            data_t = lift({**{k: v[t] for k, v in obs.items()}, **args})
            state, fe, _, carry = compiled.run_tick(
                data_t, iterations=self.iterations,
                free_energy=self.free_energy, keep_each=False, carry=carry,
                device=self.device, all_finite=all_finite)
            post = self._user(self._extract(state))
            args = self.autoupdates(post, self._fetch(state, data_t,
                                                      all_finite))
            posts.append(post)
            fes.append(self._fe_out(fe))
        self.args = args
        stacked = {name: _stack([p[name] for p in posts]) for name in posts[0]}
        return stacked, torch.stack(fes)

    def _ensure_stream_plan(self, first: dict):
        """Probe once whether the fused stream plan applies."""
        if (self.free_energy or self._need_keep_each or self.iterations != 1
                or self.returnvars is not None or self.annotations is not None
                or self.postprocess is not None):
            return None
        if self._stream_plan is None:
            from .engine.stream_plan import make_fused_stream_fn, \
                plan_fused_stream

            example = {k: v[0] for k, v in first.items()}
            self._stream_plan = plan_fused_stream(
                self._compiled, self.autoupdates, example,
                self.device) or False
            if self._stream_plan:
                self._fused_fn = self._compiled.matmul_precision.wrap(
                    make_fused_stream_fn(self._stream_plan, self.device))
        return self._stream_plan or None

    def _run_fused(self, plan, obs: dict):
        from .dists import MvNormalMeanCovariance

        means, covs, fpm, fpc = self._fused_fn(
            obs[plan.obs], self.args[plan.pm_arg], self.args[plan.pc_arg])
        self.args = {plan.pm_arg: fpm, plan.pc_arg: fpc}
        t_total, batch = means.shape[0], means.shape[1]
        return ({plan.var: MvNormalMeanCovariance(means, covs)},
                torch.zeros((t_total, batch, 0), device=self.device))

    # -- lifecycle ------------------------------------------------------------------

    def start(self, datastream: Iterable[dict]):
        self.is_running = True
        self._fire("before_autostart")
        self._fire("before_start")
        self._fire("after_start")
        completed = False
        try:
            for obs in datastream:
                if not self.is_running:
                    break
                self.on_next(obs)
            completed = self.is_running
        except Exception:
            self.is_errored = True
            self._fire("on_error")
            raise
        finally:
            if completed:
                self._fire("on_complete")
            self._fire("after_autostart")
        return self

    def stop(self):
        self._fire("before_stop")
        self.is_running = False
        self._fire("after_stop")


def _stack(values: list):
    """Per-tick distributions (or tensors) stacked on a leading time axis."""
    from .dists import tree_leaves

    first = values[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(values)
    cols = zip(*[tree_leaves(v) for v in values])
    return type(first)(*[torch.stack(list(c)) for c in cols])


def streaming_infer(model, datastream, autoupdates, initialization=None,
                    iterations=1, free_energy=False,
                    free_energy_diagnostics="default", keephistory=0,
                    options=None, uselock=False, constraints=None, meta=None,
                    callbacks=None, returnvars=None, historyvars=None,
                    annotations=None, postprocess=None, benchmark=False,
                    trace=False, catch_exception=False, session="default",
                    allow_node_contraction=False, batched=False, mesh=None,
                    device=None):
    """The streaming branch of ``infer`` (reference
    src/inference/inference.jl:700-731): builds the engine and, when a
    ``datastream`` is given, runs it to its end."""
    if autoupdates is None:
        raise ValueError("streaming inference requires autoupdates=")
    if catch_exception:
        raise ValueError(
            "catch_exception= is batch-only; streaming errors flip "
            "engine.is_errored and fire the 'on_error' event (reference: "
            "src/inference/streaming.jl:438-452).")
    warn = True if options is None else options.get("warn", True)
    engine = RxInferenceEngine(
        model, autoupdates, iterations=iterations, free_energy=free_energy,
        free_energy_diagnostics=free_energy_diagnostics,
        keephistory=keephistory, options=options,
        initialization=initialization, uselock=uselock,
        constraints=constraints, meta=meta, event_callbacks=callbacks,
        returnvars=returnvars, historyvars=historyvars,
        annotations=annotations, postprocess=postprocess, warn=warn,
        allow_node_contraction=allow_node_contraction,
        batched=batched, mesh=mesh, device=device)
    if benchmark:
        from .utils.callbacks import BenchmarkCallbacks

        bench = BenchmarkCallbacks()
        engine._recorders.append(
            lambda ev: bench.timestamps[ev.name].append(ev.timestamp_ns))
        engine.benchmark = bench
    if trace:
        from .utils.callbacks import TraceCallbacks

        tr = TraceCallbacks()
        engine._recorders.append(tr.events.append)
        engine.trace = tr
    from .utils.session import resolve_session

    sess = resolve_session(session)
    if sess is not None:
        sess.log_invoke(label="streaming_inference",
                        model=getattr(model, "name", str(model)),
                        data_keys=sorted(autoupdates.initial),
                        iterations=iterations, status="created",
                        duration_s=0.0)
    if datastream is not None:
        engine.start(datastream)
    return engine
