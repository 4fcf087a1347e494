"""Finite mixture of same-family exponential components (counterpart of
``rxinfer_tpu/dists/mixture.py``): the posterior of a generic ``Mixture``
node's output.  Its product with a same-family message distributes over the
components and re-weights them by their evidences (``natural.prod_all``), so
``component(k)`` is the posterior of the model with component k alone and
``weights`` the switch's posterior."""

from __future__ import annotations

from typing import Any

import torch

from .base import Distribution, dist_dataclass


@dist_dataclass
class MixtureDist(Distribution):
    """``log_weights`` (..., K), kept normalized, and a tuple of K
    same-family components."""

    log_weights: Any
    components: Any   # tuple of K distributions

    @property
    def k(self) -> int:
        return len(self.components)

    def component(self, k: int) -> Distribution:
        """The k-th component (0-based)."""
        return self.components[k]

    @property
    def weights(self):
        """The normalized mixing weights."""
        return torch.softmax(self.log_weights, dim=-1)

    def _wsum(self, fn):
        w = self.weights
        return sum(w[..., i] * fn(c) for i, c in enumerate(self.components))

    def mean(self):
        return self._wsum(lambda c: c.mean())

    def var(self):
        m = self.mean()
        return self._wsum(lambda c: c.var() + c.mean() ** 2) - m * m

    def mean_log(self):
        """E[log x]: a mixture's expectation is the weighted sum of its
        components'."""
        return self._wsum(lambda c: c.mean_log())

    def mean_mirrorlog(self):
        return self._wsum(lambda c: c.mean_mirrorlog())

    def entropy(self):
        raise NotImplementedError(
            "A finite mixture has no closed-form entropy; Bethe free energy "
            "is unsupported on generic-Mixture models (BP-only, reference "
            "parity) — use annotations=LogScaleAnnotations() for evidence / "
            "Bayes factors instead of free_energy=True.")

    def logpdf(self, x):
        from .natural import logpdf

        lw = torch.log_softmax(self.log_weights, dim=-1)
        terms = torch.stack([lw[..., i] + logpdf(c, x)
                             for i, c in enumerate(self.components)], dim=-1)
        return torch.logsumexp(terms, dim=-1)
