"""Posterior annotations and postprocess strategies (counterpart of
``rxinfer_tpu/postprocess.py``; the reference's ``LogScaleAnnotations``,
``Marginal`` and ``inference_postprocess``).

Every posterior ``infer`` / ``infer_batched`` emit under
``annotations=LogScaleAnnotations()`` is a ``Marginal`` carrying its
log-scale: the log normalizer of the message product at the variable (log Z
on a tree, the -FE estimate on a variational model; per-component
evidences next to a generic ``Mixture``, ``engine/logscale.py``).  The
postprocess strategy then strips the wrapper (``UnpackMarginalPostprocess``,
the default without annotations) or keeps it (``NoopPostprocess``, the
default with them).
"""

from __future__ import annotations

from typing import Any, Optional


class LogScaleAnnotations:
    """Ask for per-posterior log-scale annotations."""

    def __repr__(self):
        return "LogScaleAnnotations()"


class Marginal:
    """An annotated posterior: attribute access forwards to the wrapped
    distribution; ``getdata`` unwraps it, ``getannotations`` gives the
    annotations."""

    __slots__ = ("dist", "annotations")

    def __init__(self, dist: Any, annotations: Optional[dict] = None):
        self.dist = dist
        self.annotations = dict(annotations or {})

    def __getattr__(self, name):
        return getattr(self.dist, name)

    def __repr__(self):
        keys = ", ".join(sorted(self.annotations))
        return f"Marginal({self.dist!r}, annotations=[{keys}])"


def getdata(marginal):
    """The distribution a ``Marginal`` wraps (anything else as it is)."""
    return marginal.dist if isinstance(marginal, Marginal) else marginal


def getannotations(marginal) -> dict:
    """A posterior's annotations; empty for a bare distribution."""
    return marginal.annotations if isinstance(marginal, Marginal) else {}


def getlogscale(marginal):
    """A posterior's log-scale; needs ``annotations=LogScaleAnnotations()``."""
    ann = getannotations(marginal)
    if "log_scale" not in ann:
        raise ValueError(
            "posterior carries no log-scale annotation; run "
            "infer(..., annotations=LogScaleAnnotations()).")
    return ann["log_scale"]


class UnpackMarginalPostprocess:
    """Strip the ``Marginal`` wrapper (the default without annotations)."""

    def __call__(self, marginal):
        return getdata(marginal)


class NoopPostprocess:
    """Keep posteriors as they are, annotations included (the default with
    annotations)."""

    def __call__(self, marginal):
        return marginal


def default_postprocess(annotations) -> Any:
    """Unpack without annotations, keep with them."""
    return NoopPostprocess() if annotations is not None \
        else UnpackMarginalPostprocess()


def inference_postprocess(strategy, marginal):
    """Apply a strategy (any callable of one posterior) to one posterior."""
    return strategy(marginal)
