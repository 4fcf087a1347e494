"""Carry parameters and state of the JAX package across to the port as plain
numpy, without importing the JAX package.

* ``fused_plan_from_numpy(fields)`` takes the numpy fields of a JAX
  ``FusedGaussianPlan`` (A, b, Q, W, m0, p0, E, c; ``chunk`` and the
  dynamic-tier fields are accepted and ignored — the CUDA kernels have no
  time chunking) and returns the port's plan, which
  ``engine.batched.run_fused_plan`` runs.
* ``dist_from_numpy(family, params)`` builds a port distribution from the
  class name of a JAX distribution and its numpy parameters, in field order
  or by field name.
* ``filter_state_from_numpy(m, p)`` builds the ``FilterState`` of
  ``parallel.filtering`` from the numpy fields of the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import dists as D
from .engine.batched import FusedGaussianPlan
from .parallel.filtering import FilterState

_FAMILIES = {
    "NormalMeanVariance": D.NormalMeanVariance,
    "NormalMeanPrecision": D.NormalMeanPrecision,
    "NormalWeightedMeanPrecision": D.NormalWeightedMeanPrecision,
    "MvNormalMeanCovariance": D.MvNormalMeanCovariance,
    "MvNormalMeanPrecision": D.MvNormalMeanPrecision,
    "MvNormalWeightedMeanPrecision": D.MvNormalWeightedMeanPrecision,
    "PointMass": D.PointMass,
    "Categorical": D.Categorical,
    "DirichletCollection": D.DirichletCollection,
}

_IGNORED_PLAN_FIELDS = ("chunk", "dyn_w", "dyn_q", "wlin")


def fused_plan_from_numpy(fields: dict) -> FusedGaussianPlan:
    """The port's static-tier plan from a JAX plan's numpy fields."""
    if fields.get("dyn_w") or fields.get("dyn_q") or fields.get("wlin"):
        raise NotImplementedError(
            "dynamic-tier plans (per-sweep W/Q) are not ported yet.")
    if fields.get("E") is None:
        raise NotImplementedError(
            "plans without the linear-evidence map (vmapped rule path) are "
            "not ported yet.")
    names = [f.name for f in dataclasses.fields(FusedGaussianPlan)]
    unknown = set(fields) - set(names) - set(_IGNORED_PLAN_FIELDS)
    if unknown:
        raise ValueError(f"unknown plan fields {sorted(unknown)}")
    f32 = lambda a: np.array(a, np.float32)  # a writable copy
    return FusedGaussianPlan(
        A=f32(fields["A"]), b=f32(fields["b"]), Q=f32(fields["Q"]),
        W=f32(fields["W"]), m0=f32(fields["m0"]), p0=f32(fields["p0"]),
        E={k: f32(v) for k, v in fields["E"].items()}, c=f32(fields["c"]),
    )


def dist_from_numpy(family: str, params, device="cpu") -> D.Distribution:
    """A port distribution of the named family from numpy parameters (a
    sequence in field order or a dict by field name)."""
    cls = _FAMILIES.get(family)
    if cls is None:
        raise NotImplementedError(
            f"family {family!r} is not ported; ported: {sorted(_FAMILIES)}")
    field_names = [f.name for f in dataclasses.fields(cls)]
    if isinstance(params, dict):
        params = [params[n] for n in field_names]
    if len(params) != len(field_names):
        raise ValueError(
            f"{family} takes {field_names}, got {len(params)} parameters")
    return cls(*[torch.as_tensor(np.array(p, np.float32), device=device)
                 for p in params])


def filter_state_from_numpy(m, p, device="cpu") -> FilterState:
    """The port's filter state from means m (B, d) and covariances p
    (B, d, d) given as numpy arrays."""
    m = np.array(m, np.float32)
    p = np.array(p, np.float32)
    if m.ndim != 2 or p.shape != m.shape + m.shape[-1:]:
        raise ValueError(
            f"filter state takes m (B, d) and p (B, d, d); got {m.shape} and "
            f"{p.shape}")
    return FilterState(torch.as_tensor(m, device=device),
                       torch.as_tensor(p, device=device))
