"""Parallel prefix scan over an associative combine (counterpart of
``jax.lax.associative_scan``).

The odd/even pairing JAX uses: combine adjacent pairs, scan the half
recursively, then fill in the even positions from the odd results.  That is
O(log T) levels, each one batched call of ``fn`` over all of its elements,
so the time axis costs about 2 log2(T) calls of ``fn`` rather than T.

``reverse=True`` scans from the end, and, as in JAX, feeds the temporally
LATER chunk as the LEFT operand of ``fn``: the elements are reversed, scanned
forward with the same ``fn`` and the result reversed back.  The Kalman and
forward-backward scans of ``ops/kalman.py`` and ``ops/discrete_chain.py``
depend on that order.
"""

from __future__ import annotations

import torch


def _slice(x: torch.Tensor, dim: int, start: int, stop, step: int = 1):
    idx = (slice(None),) * dim + (slice(start, stop, step),)
    return x[idx]


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int):
    """even[0], odd[0], even[1], ... along ``dim``; ``even`` has as many
    entries as ``odd`` or one more."""
    shape = list(even.shape)
    shape[dim] += odd.shape[dim]
    out = even.new_empty(shape)
    out[(slice(None),) * dim + (slice(0, None, 2),)] = even
    out[(slice(None),) * dim + (slice(1, None, 2),)] = odd
    return out


def associative_scan(fn, elems, dim: int, reverse: bool = False):
    """Inclusive scan of ``elems`` (a tuple of tensors of one length along
    ``dim``) under the associative ``fn(earlier, later) -> combined``, where
    ``fn`` takes and returns tuples of tensors batched over every axis.
    Returns a tuple: entry t of each tensor holds elems[0] x ... x elems[t]
    (``reverse=True``: elems[t] x ... x elems[T-1], the later chunk the left
    operand of ``fn``)."""
    elems = tuple(elems)
    dim = dim % elems[0].ndim
    n = elems[0].shape[dim]
    if any(e.shape[dim] != n for e in elems):
        raise ValueError(
            "associative_scan: every element needs the same length along "
            f"dim {dim}; got {[tuple(e.shape) for e in elems]}")
    if reverse:
        elems = tuple(torch.flip(e, (dim,)) for e in elems)

    def scan(xs):
        num = xs[0].shape[dim]
        if num < 2:
            return xs
        reduced = fn(tuple(_slice(x, dim, 0, -1, 2) for x in xs),
                     tuple(_slice(x, dim, 1, None, 2) for x in xs))
        odd = scan(tuple(reduced))
        if num % 2 == 0:
            even = fn(tuple(_slice(o, dim, 0, -1) for o in odd),
                      tuple(_slice(x, dim, 2, None, 2) for x in xs))
        else:
            even = fn(odd, tuple(_slice(x, dim, 2, None, 2) for x in xs))
        even = tuple(torch.cat([_slice(x, dim, 0, 1), e], dim=dim)
                     for x, e in zip(xs, even))
        return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))

    out = scan(elems)
    if reverse:
        out = tuple(torch.flip(o, (dim,)) for o in out)
    return out
