"""Carry parameters and state of the JAX package across to the port as plain
numpy, without importing the JAX package.

* ``fused_plan_from_numpy(fields)`` takes the numpy fields of a JAX
  ``FusedGaussianPlan`` (A, b, Q, W, m0, p0, E, c and the dynamic tier's
  dyn_w, dyn_q, wlin; ``chunk`` is accepted and ignored — the CUDA kernels
  have no time chunking) and returns the port's plan, which
  ``engine.batched._fused_gaussian_update`` runs (a dynamic plan with the
  sweep's state).
* ``dist_from_numpy(family, params)`` builds a port distribution from the
  class name of a JAX distribution and its numpy parameters, in field order
  or by field name.
* ``dist_to_numpy(d)`` is the way back: the family's name and its fields
  as numpy arrays.  Both keep whatever leading axes the fields carry (a
  batch, a plate, the (N, M) of a grid latent).
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
    "Beta": D.Beta,
    "Bernoulli": D.Bernoulli,
    "GammaShapeRate": D.GammaShapeRate,
    "GammaShapeScale": D.GammaShapeScale,
    "InverseGamma": D.InverseGamma,
    "Poisson": D.Poisson,
    "Binomial": D.Binomial,
    "Uniform": D.Uniform,
    "Wishart": D.Wishart,
    "WishartInverseScale": D.WishartInverseScale,
    "InverseWishart": D.InverseWishart,
    "NormalMeanVariance": D.NormalMeanVariance,
    "NormalMeanPrecision": D.NormalMeanPrecision,
    "NormalWeightedMeanPrecision": D.NormalWeightedMeanPrecision,
    "MvNormalMeanCovariance": D.MvNormalMeanCovariance,
    "MvNormalMeanPrecision": D.MvNormalMeanPrecision,
    "MvNormalWeightedMeanPrecision": D.MvNormalWeightedMeanPrecision,
    "MvNormalMeanScalePrecision": D.MvNormalMeanScalePrecision,
    "PointMass": D.PointMass,
    "Categorical": D.Categorical,
    "Multinomial": D.Multinomial,
    "Dirichlet": D.Dirichlet,
    "DirichletCollection": D.DirichletCollection,
}

_IGNORED_PLAN_FIELDS = ("chunk",)


def fused_plan_from_numpy(fields: dict) -> FusedGaussianPlan:
    """The port's plan from a JAX plan's numpy fields, static or dynamic."""
    dyn_w, dyn_q = bool(fields.get("dyn_w")), bool(fields.get("dyn_q"))
    if fields.get("E") is None and not dyn_w:
        raise NotImplementedError(
            "static plans without the linear-evidence map (vmapped rule "
            "path) are not ported yet.")
    names = [f.name for f in dataclasses.fields(FusedGaussianPlan)]
    unknown = set(fields) - set(names) - set(_IGNORED_PLAN_FIELDS)
    if unknown:
        raise ValueError(f"unknown plan fields {sorted(unknown)}")
    f32 = lambda a: np.array(a, np.float32)  # a writable copy
    opt = lambda a: None if a is None else f32(a)
    arrays = lambda d: None if d is None else {k: f32(v) for k, v in d.items()}
    wlin = fields.get("wlin")
    if wlin is not None:
        vname, scalar_v, e0, jt, c0, w0, dw = wlin
        wlin = (str(vname), bool(scalar_v), arrays(e0), arrays(jt), f32(c0),
                f32(w0), opt(dw))
    return FusedGaussianPlan(
        A=f32(fields["A"]), b=f32(fields["b"]), Q=opt(fields["Q"]),
        W=opt(fields["W"]), m0=f32(fields["m0"]), p0=f32(fields["p0"]),
        E=arrays(fields.get("E")), c=opt(fields.get("c")),
        dyn_w=dyn_w, dyn_q=dyn_q, wlin=wlin,
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


def dist_to_numpy(d: D.Distribution) -> tuple:
    """``(family, {field: numpy array})`` of a port distribution, the
    inverse of ``dist_from_numpy``."""
    family = type(d).__name__
    if _FAMILIES.get(family) is not type(d):
        raise NotImplementedError(
            f"family {family!r} is not ported; ported: {sorted(_FAMILIES)}")
    return family, {f.name: getattr(d, f.name).detach().cpu().numpy()
                    for f in dataclasses.fields(d)}


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
