"""Callbacks, events, and benchmark and trace instrumentation (counterpart
of ``rxinfer_tpu/utils/callbacks.py``).

Event names mirror the reference's typed events; ``infer`` fires
before/after_model_creation, before/after_inference and
before/after_iteration (an ``after_iteration`` handler may stop the
iterations).  Ported: ``EVENT_NAMES``, ``Event``, ``CallbackRegistry``,
``BenchmarkCallbacks`` and ``TraceCallbacks``.  Not ported: the profiler
context, the TensorBoard export and ``StopEarlyIterationStrategy``, which
reads the free energy (not ported yet).
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
