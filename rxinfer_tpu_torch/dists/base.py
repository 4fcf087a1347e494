"""Distribution substrate: exponential-family distributions as plain
dataclasses of torch tensors (counterpart of ``rxinfer_tpu/dists/base.py``).

Ported subset: the ``Distribution`` marker class, the ``dist_dataclass``
decorator, the closed-form pairwise product registry and the ``HUGE``/``TINY``
constants.  Every field is a tensor that may carry leading batch dimensions;
the event shape is trailing.  Products of exponential-family messages are
natural-parameter sums (see ``natural.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

# Reference constants (ReactiveMP huge / tiny).
HUGE = 1e12
TINY = 1e-12


def dist_dataclass(cls):
    """Frozen dataclass whose fields are all tensors (leading batch dims)."""
    return dataclasses.dataclass(frozen=True)(cls)


def tree_map(fn, d):
    """Apply ``fn`` to every tensor field of a distribution (or the tensor
    itself), returning a distribution of the same family; a field holding a
    tuple of distributions (a mixture's components) is mapped through."""
    if isinstance(d, torch.Tensor):
        return fn(d)
    if isinstance(d, tuple):
        return tuple(tree_map(fn, x) for x in d)
    return type(d)(*[tree_map(fn, getattr(d, f.name))
                     for f in dataclasses.fields(d)])


def tree_leaves(d) -> list:
    if isinstance(d, torch.Tensor):
        return [d]
    return [getattr(d, f.name) for f in dataclasses.fields(d)]


class Distribution:
    """Marker base class for all distributions."""

    def mean(self):  # noqa: D102
        raise NotImplementedError(type(self).__name__)

    def var(self):  # noqa: D102
        raise NotImplementedError(type(self).__name__)

    def cov(self):  # noqa: D102
        return self.var()

    @property
    def event_ndim(self) -> int:
        return 0


class ProductError(TypeError):
    """No closed-form product between the two distribution families."""


_PROD_TABLE: dict[tuple[type, type], Callable[[Any, Any], Any]] = {}


def register_prod(t1: type, t2: type, symmetric: bool = True):
    """Register a closed-form pairwise product for a pair of families."""

    def deco(fn):
        _PROD_TABLE[(t1, t2)] = fn
        if symmetric and t1 is not t2:
            _PROD_TABLE[(t2, t1)] = lambda a, b: fn(b, a)
        return fn

    return deco


def prod(a: Distribution, b: Distribution) -> Distribution:
    """Closed-form (normalized) product of two distributions."""
    fn = _PROD_TABLE.get((type(a), type(b)))
    if fn is None:
        raise ProductError(
            f"No closed-form product for {type(a).__name__} x "
            f"{type(b).__name__}."
        )
    return fn(a, b)
