"""Message rules of the PyTorch port; importing this package registers the
ported nodes."""

from . import (  # noqa: F401  (registers the node rules)
    ar,
    boolean,
    ctransition,
    delta,
    gcv,
    nodes,
    polya,
    special,
)
from .delta import (  # noqa: F401
    CVI,
    CVIProjection,
    DeltaMeta,
    Linearization,
    Unscented,
)
