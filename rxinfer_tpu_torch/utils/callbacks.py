"""Callbacks, events, and benchmark and trace instrumentation (counterpart
of ``rxinfer_tpu/utils/callbacks.py``).

Event names mirror the reference's typed events; ``infer`` fires
before/after_model_creation, before/after_inference and
before/after_iteration (an ``after_iteration`` handler may stop the
iterations); the streaming engine fires ``ENGINE_EVENTS``, the reference
engine's events.  ``EVENT_NAMES``, ``ENGINE_EVENTS``, ``Event``,
``CallbackRegistry``, ``BenchmarkCallbacks`` with ``benchmark_table``,
``TraceCallbacks`` with ``convert_to_tensorboard``,
``StopEarlyIterationStrategy`` (free-energy convergence through the
``stop_iteration`` hook) and ``profile_trace`` (``torch.profiler`` around
inference calls, a Chrome trace in a log directory).
"""

from __future__ import annotations

import json
import time
import uuid
from collections import defaultdict, deque
from typing import Callable, Optional

import numpy as np

EVENT_NAMES = (
    "before_model_creation",
    "after_model_creation",
    "before_inference",
    "after_inference",
    "before_iteration",
    "after_iteration",
    "before_data_update",
    "after_data_update",
    "on_marginal_update",
    "before_autostart",
    "after_autostart",
)

# the streaming engine's events (reference src/inference/streaming.jl:847-866)
ENGINE_EVENTS = (
    "on_new_data", "before_iteration", "before_auto_update",
    "after_auto_update", "before_data_update", "on_marginal_update",
    "after_data_update", "after_iteration", "before_history_save",
    "after_history_save", "on_tick", "on_error", "on_complete",
    "before_autostart", "after_autostart", "before_start", "after_start",
    "before_stop", "after_stop", "before_model_creation",
    "after_model_creation",
)


class Event:
    """A lifecycle event; ``span_id`` pairs a before with its after."""

    def __init__(self, name: str, payload: Optional[dict] = None,
                 span_id: Optional[str] = None):
        self.name = name
        self.payload = payload or {}
        self.span_id = span_id or uuid.uuid4().hex[:8]
        self.timestamp_ns = time.perf_counter_ns()
        self.stop_iteration = False  # settable by after_iteration handlers

    def __repr__(self):
        return f"Event({self.name}, span={self.span_id})"


class CallbackRegistry:
    """Handlers by event name; ``callbacks`` maps names to one handler each,
    an unknown name raises ``ValueError``."""

    def __init__(self, callbacks: Optional[dict] = None):
        self._handlers: dict[str, list[Callable]] = defaultdict(list)
        for name, fn in (callbacks or {}).items():
            if name not in EVENT_NAMES:
                raise ValueError(
                    f"Unknown callback '{name}'; available: {EVENT_NAMES}")
            self.add(name, fn)

    def add(self, name: str, fn: Callable):
        self._handlers[name].append(fn)

    def invoke(self, name: str, **payload) -> Event:
        ev = Event(name, payload)
        for fn in self._handlers.get(name, ()):
            fn(ev)
        return ev

    @property
    def empty(self) -> bool:
        return not any(self._handlers.values())


class BenchmarkCallbacks:
    """Wall-clock time stamps of every event in ring buffers, and a summary
    of each before/after pair (min, max, mean, median, std in ms)."""

    def __init__(self, capacity: int = 1000):
        self.timestamps: dict[str, deque] = defaultdict(
            lambda: deque(maxlen=capacity))

    def attach(self, registry: CallbackRegistry):
        for name in EVENT_NAMES:
            registry.add(name, self._record(name))
        return self

    def _record(self, name: str):
        def fn(ev: Event):
            self.timestamps[name].append(ev.timestamp_ns)

        return fn

    def durations_ms(self, start: str, stop: str) -> np.ndarray:
        a = np.asarray(self.timestamps[start], dtype=np.float64)
        b = np.asarray(self.timestamps[stop], dtype=np.float64)
        n = min(len(a), len(b))
        return (b[:n] - a[:n]) / 1e6

    def stats(self) -> dict:
        """min/max/mean/median/std per before/after pair, in ms."""
        out = {}
        for pre, post in (
            ("before_model_creation", "after_model_creation"),
            ("before_inference", "after_inference"),
            ("before_iteration", "after_iteration"),
            ("before_data_update", "after_data_update"),
        ):
            d = self.durations_ms(pre, post)
            if len(d):
                out[pre.replace("before_", "")] = {
                    "n": len(d),
                    "min_ms": float(d.min()),
                    "max_ms": float(d.max()),
                    "mean_ms": float(d.mean()),
                    "median_ms": float(np.median(d)),
                    "std_ms": float(d.std()),
                }
        return out


class TraceCallbacks:
    """Every event with its time stamp, filterable and exportable as
    JSON."""

    def __init__(self):
        self.events: list[Event] = []

    def attach(self, registry: CallbackRegistry):
        for name in EVENT_NAMES:
            registry.add(name, self.events.append)
        return self

    def traced(self, name: Optional[str] = None) -> list[Event]:
        if name is None:
            return list(self.events)
        return [e for e in self.events if e.name == name]

    def export_json(self, path: str):
        with open(path, "w") as f:
            json.dump([{"name": e.name, "span": e.span_id,
                        "t_ns": e.timestamp_ns} for e in self.events], f)


def benchmark_table(bench: BenchmarkCallbacks) -> str:
    """A plain-text table of ``bench.stats()`` (reference: PrettyTablesExt
    over the benchmark stats, ext/PrettyTablesExt/PrettyTablesExt.jl:22)."""
    stats = bench.stats()
    if not stats:
        return "(no benchmark samples recorded)"
    header = (f"{'stage':<18}{'n':>6}{'min ms':>10}{'median ms':>11}"
              f"{'mean ms':>10}{'max ms':>10}{'std ms':>9}")
    lines = [header, "-" * len(header)]
    for stage, row in stats.items():
        lines.append(
            f"{stage:<18}{row['n']:>6}{row['min_ms']:>10.3f}"
            f"{row['median_ms']:>11.3f}{row['mean_ms']:>10.3f}"
            f"{row['max_ms']:>10.3f}{row['std_ms']:>9.3f}")
    return "\n".join(lines)


class profile_trace:
    """``torch.profiler`` around inference calls, host and device::

        with profile_trace("/path/to/logdir") as pt:
            infer_batched(...)
        pt.profile.key_averages()   # the profile itself

    On leaving the block a Chrome trace (``*.pt.trace.json``) is written
    into ``logdir`` by ``tensorboard_trace_handler``, which needs no
    ``tensorboard`` package; it opens in chrome://tracing, Perfetto or
    TensorBoard's profiler plugin.  The CUDA activity is recorded when a
    CUDA device is present."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.profile = None

    def __enter__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.profile = torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                self.logdir))
        self.profile.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.profile.__exit__(*exc)
        return False

    def trace_files(self) -> list:
        """The trace files in ``logdir``."""
        import os

        return sorted(os.path.join(self.logdir, f)
                      for f in os.listdir(self.logdir)
                      if ".pt.trace.json" in f)


def convert_to_tensorboard(trace: TraceCallbacks, logdir: str):
    """Write traced events into a TensorBoard log directory (reference
    TensorBoardLoggerExt.convert_to_tensorboard,
    ext/TensorBoardLoggerExt/TensorBoardLoggerExt.jl:241): each event a text
    entry, each free energy a scalar.  Needs the ``tensorboard`` package."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as exc:
        raise ImportError(
            "convert_to_tensorboard needs the `tensorboard` package "
            "(torch.utils.tensorboard writes through it); install "
            "`tensorboard` or export the trace with "
            "TraceCallbacks.export_json.") from exc

    writer = SummaryWriter(log_dir=logdir)
    try:
        t0 = trace.events[0].timestamp_ns if trace.events else 0
        fe_step = 0
        for step, e in enumerate(trace.events):
            dt_us = (e.timestamp_ns - t0) / 1e3
            writer.add_text(
                f"rxinfer/{e.name}",
                f"span={e.span_id} t+{dt_us:.1f}us payload={e.payload}",
                global_step=step)
            fe = (e.payload or {}).get("free_energy")
            if fe is not None:
                writer.add_scalar("rxinfer/free_energy", float(fe), fe_step)
                fe_step += 1
    finally:
        writer.close()


class StopEarlyIterationStrategy:
    """Free-energy convergence stopping (reference
    StopEarlyIterationStrategy, src/callbacks/stop_early.jl:20-74): as an
    ``after_iteration`` handler it compares the sweep's free energy with the
    previous one and sets ``stop_iteration`` once they are within ``atol +
    rtol * |previous|``.  Needs ``free_energy=True``."""

    def __init__(self, atol: float = 1e-6, rtol: float = 1e-8):
        self.atol = atol
        self.rtol = rtol
        self._prev: Optional[float] = None

    def __call__(self, ev: Event):
        fe = (ev.payload or {}).get("free_energy")
        if fe is None:
            return
        fe = float(fe)
        if self._prev is not None and (
                abs(fe - self._prev) <= self.atol + self.rtol * abs(self._prev)):
            ev.stop_iteration = True
        self._prev = fe
