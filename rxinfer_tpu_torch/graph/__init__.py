"""Model graph: IR, ``@model`` DSL and constraints of the PyTorch port."""

from .dsl import Delta, Probit, SoftDot  # noqa: F401
