"""Message rules of the PyTorch port; importing this package registers the
ported nodes."""

from . import ar, gcv, nodes, special  # noqa: F401  (registers the node rules)
