"""Session logging (counterpart of ``rxinfer_tpu/utils/session.py``; the
reference's src/session.jl): per-invoke records in capacity-bounded ring
buffers, thread-safe, with a default session that ``infer`` and the
streaming engine log to.

No telemetry endpoint is contacted: ``Session.share_session_data`` writes
the records to a local JSON file.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from collections import deque
from typing import Optional

DEFAULT_CAPACITY = 1000


class SessionInvoke:
    """One logged call: its label and context (model, data keys,
    iterations, status, duration)."""

    def __init__(self, label: str, context: dict):
        self.id = str(uuid.uuid4())
        self.label = label
        self.context = context
        self.timestamp = time.time()

    def to_dict(self) -> dict:
        return {"id": self.id, "label": self.label,
                "timestamp": self.timestamp, **self.context}


class SessionStats:
    """Aggregate statistics of one label (reference ``SessionStats``): the
    last ``capacity`` invokes, the totals and failures."""

    def __init__(self, label: str, capacity: int = DEFAULT_CAPACITY):
        self.label = label
        self.invokes: deque = deque(maxlen=capacity)
        self.total = 0
        self.failed = 0
        self.total_duration_s = 0.0

    def add(self, invoke: SessionInvoke):
        self.invokes.append(invoke)
        self.total += 1
        if invoke.context.get("status") == "failure":
            self.failed += 1
        self.total_duration_s += invoke.context.get("duration_s", 0.0)

    def summary(self) -> dict:
        return {"label": self.label, "total": self.total,
                "failed": self.failed,
                "mean_duration_s": (self.total_duration_s / self.total
                                    if self.total else 0.0)}


class Session:
    """A log of inference calls by label (reference ``Session``,
    src/session.jl:122-128)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.id = str(uuid.uuid4())
        self.created = time.time()
        self.capacity = capacity
        self.stats: dict[str, SessionStats] = {}
        self._lock = threading.Lock()

    def log_invoke(self, label: str, **context):
        with self._lock:
            stats = self.stats.setdefault(
                label, SessionStats(label, self.capacity))
            stats.add(SessionInvoke(label, context))

    def get_session_stats(self, label: str) -> SessionStats:
        with self._lock:
            return self.stats.setdefault(
                label, SessionStats(label, self.capacity))

    def summarize(self) -> dict:
        with self._lock:
            return {label: s.summary() for label, s in self.stats.items()}

    def share_session_data(self, path: str):
        """Write every record to a local JSON file (the reference's opt-in
        session sharing, without its endpoint)."""
        with self._lock:
            payload = {
                "session_id": self.id, "created": self.created,
                "stats": {label: [i.to_dict() for i in s.invokes]
                          for label, s in self.stats.items()},
            }
        with open(path, "w") as f:
            json.dump(payload, f, default=str)


_DEFAULT: Optional[Session] = None
_ENABLED = True


def get_default_session() -> Optional[Session]:
    """The process's default session (None while logging is off)."""
    global _DEFAULT
    if not _ENABLED:
        return None
    if _DEFAULT is None:
        _DEFAULT = Session()
    return _DEFAULT


def set_session_logging(enabled: bool):
    global _ENABLED
    _ENABLED = enabled


def create_session(capacity: int = DEFAULT_CAPACITY) -> Session:
    return Session(capacity)


def resolve_session(session) -> Optional[Session]:
    """An entry point's ``session=``: ``"default"`` the default session,
    None no logging, or a ``Session``."""
    return get_default_session() if session == "default" else session


def summarize_session(session: Optional[Session] = None) -> dict:
    s = session or get_default_session()
    return s.summarize() if s else {}


def summarize_session_table(session: Optional[Session] = None) -> str:
    """A plain-text table of ``summarize_session`` (reference:
    PrettyTablesExt's summary table)."""
    summary = summarize_session(session)
    if not summary:
        return "(no invocations logged)"
    header = f"{'label':<20}{'total':>8}{'failed':>8}{'mean ms':>12}"
    lines = [header, "-" * len(header)]
    for label, row in summary.items():
        lines.append(f"{label:<20}{row['total']:>8}{row['failed']:>8}"
                     f"{row['mean_duration_s'] * 1e3:>12.2f}")
    return "\n".join(lines)
