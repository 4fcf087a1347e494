"""PointMass, SampleList and LogPdfMessage (counterpart of
``rxinfer_tpu/dists/pointmass.py``).

``PointMass`` carries observed values and constants through the message
rules, and is what ``PointMassFormConstraint`` collapses a marginal to.
``SampleList`` is the weighted-sample marginal of
``SampleListFormConstraint``; ``LogPdfMessage`` the function-form message
of ``NodeFunctionRuleFallback``, which only a projecting form constraint
turns into a marginal.

Batch axes, as everywhere in the port, lead: a ``SampleList`` holds
samples (batch..., N, event...) and log-weights (batch..., N), and a
``LogPdfMessage``'s ``log_fn`` takes points (S, batch..., event...) with
the sample axis first, as the projections of ``engine/projection.py``
draw them.
"""

from __future__ import annotations

import torch

from .base import Distribution, dist_dataclass, register_prod


@dist_dataclass
class PointMass(Distribution):
    point: torch.Tensor

    def mean(self):
        return self.point

    def mode(self):
        return self.point

    def var(self):
        return torch.zeros_like(self.point)

    def cov(self):
        p = self.point
        if p.ndim == 0:
            return torch.zeros_like(p)
        d = p.shape[-1]
        return torch.zeros(p.shape[:-1] + (d, d), dtype=p.dtype, device=p.device)


def register_pointmass_products(*types):
    """A point mass absorbs the product with any family."""
    for t in types:
        register_prod(PointMass, t, symmetric=False)(lambda a, b: a)
        register_prod(t, PointMass, symmetric=False)(lambda a, b: b)


register_prod(PointMass, PointMass)(lambda a, b: a)


@dist_dataclass
class SampleList(Distribution):
    """Weighted sample approximation: samples (..., N, event...) and
    log_weights (..., N)."""

    samples: torch.Tensor
    log_weights: torch.Tensor

    def _w(self):
        return torch.softmax(self.log_weights, dim=-1)

    def _wr(self):
        w = self._w()
        return w.reshape(w.shape + (1,) * (self.samples.ndim - w.ndim))

    def mean(self):
        return torch.sum(self._wr() * self.samples,
                         dim=self.log_weights.ndim - 1)

    def var(self):
        ax = self.log_weights.ndim - 1
        centered = self.samples - self.mean().unsqueeze(ax)
        return torch.sum(self._wr() * centered ** 2, dim=ax)

    def cov(self):
        centered = self.samples - self.mean()[..., None, :]
        return torch.einsum("...n,...ni,...nj->...ij", self._w(), centered,
                            centered)

    def entropy(self):
        """The entropy of the weights, the estimate the JAX package takes
        (a sample list has no density)."""
        w = self._w()
        return -torch.sum(w * torch.log(torch.clamp(w, min=1e-37)), dim=-1)

    def mode(self):
        """The sample of the highest weight."""
        ax = self.log_weights.ndim - 1
        idx = torch.argmax(self.log_weights, dim=-1)
        idx = idx.reshape(idx.shape + (1,) * (self.samples.ndim - idx.ndim))
        idx = idx.expand(idx.shape[:ax + 1] + self.samples.shape[ax + 1:])
        return torch.take_along_dim(self.samples, idx, dim=ax).squeeze(ax)


class LogPdfMessage:
    """Function-form message: an unnormalized log-density over the target
    edge, produced by ``NodeFunctionRuleFallback`` when a node defines only
    its ``logpdf``.  It enters no conjugate product: a functional-form
    constraint (``ProjectedTo`` / ``SampleListFormConstraint`` /
    ``PointMassFormConstraint``) must project the product.

    ``log_fn(x)`` takes points (S, batch..., event...) and may return extra
    trailing plate axes, ``plate_axes`` of them, which are summed: the
    log-density of a plate of factor copies is the sum of the copies'.
    ``batch_shape`` is the batch it spans (what a projection draws for)."""

    def __init__(self, log_fn, plate_axes: int = 0, batch_shape: tuple = ()):
        self.log_fn = log_fn
        self.plate_axes = plate_axes
        self.batch_shape = tuple(batch_shape)

    def logpdf(self, x):
        val = self.log_fn(x)
        if self.plate_axes:
            val = torch.sum(val, dim=tuple(range(-self.plate_axes, 0)))
        return val
