"""Telemetry (counterpart of ``rxinfer_tpu/utils/telemetry.py``; the
reference's src/telemetry.jl usage ping and opt-in session sharing).

The API keeps the reference's shape (an endpoint, an opt-in switch, the
session's records) but only ever appends JSON lines to a local file: the
"endpoint" is a path, and no network endpoint is contacted.  Usage records
are written only after ``enable_telemetry()`` (or
``LOG_USING_RXINFER_TPU=1`` in the environment) and
``set_telemetry_endpoint(path)``.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Optional

_ENDPOINT: Optional[str] = None
_ENABLED = os.environ.get("LOG_USING_RXINFER_TPU", "0") == "1"


def set_telemetry_endpoint(path: Optional[str]):
    """The local file that usage records and shared session data go to."""
    global _ENDPOINT
    _ENDPOINT = path


def enable_telemetry(enabled: bool = True):
    global _ENABLED
    _ENABLED = enabled


def log_using(event: str = "import", payload: Optional[dict] = None):
    """Append one usage record (reference ``log_using_rxinfer``) to the
    endpoint file, when telemetry is enabled and an endpoint is set."""
    if not _ENABLED or not _ENDPOINT:
        return
    record = {"id": str(uuid.uuid4()), "ts": time.time(), "event": event,
              **(payload or {})}
    try:
        with open(_ENDPOINT, "a") as f:
            f.write(json.dumps(record, default=str) + "\n")
    except OSError:
        pass


def share_session_data(session=None, path: Optional[str] = None):
    """Write a session's records (the default session's unless given) to
    ``path`` or the endpoint file; returns the path written, or None when
    session logging is off (reference ``share_session_data``,
    src/telemetry.jl:373-474)."""
    from .session import get_default_session

    s = session or get_default_session()
    if s is None:
        return None
    target = path or _ENDPOINT
    if target is None:
        raise ValueError("No telemetry endpoint configured; pass path=.")
    s.share_session_data(target)
    return target
