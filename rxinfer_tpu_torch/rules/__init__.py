"""Message rules of the PyTorch port; importing this package registers the
ported nodes."""

from . import nodes, special  # noqa: F401  (registers the ported node rules)
