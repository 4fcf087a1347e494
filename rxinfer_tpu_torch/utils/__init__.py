"""Instrumentation of the PyTorch port (counterpart of ``rxinfer_tpu/utils``):
callbacks, sessions, telemetry and checkpoints."""

from .session import (  # noqa: F401
    Session,
    create_session,
    get_default_session,
    set_session_logging,
    summarize_session,
    summarize_session_table,
)
from .telemetry import (  # noqa: F401
    enable_telemetry,
    log_using,
    set_telemetry_endpoint,
    share_session_data,
)
