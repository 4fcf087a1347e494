"""Message rules of the PyTorch port; importing this package registers the
ported nodes."""

from . import ar, delta, gcv, nodes, special  # noqa: F401  (registers the node rules)
from .delta import (  # noqa: F401
    CVI,
    CVIProjection,
    DeltaMeta,
    Linearization,
    Unscented,
)
