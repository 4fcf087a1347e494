"""Compile-time shape and family inference over the factor graph
(counterpart of ``rxinfer_tpu/engine/shapes.py``).

Event shapes and marginal families of every random variable are resolved
statically from constant hyperparameters and data shapes, with the tables
of the port's node set (``rules/nodes.py``, ``rules/special.py``,
``rules/ar.py``, ``rules/gcv.py``, ``rules/delta.py``): the Gaussian nodes
(the scale-precision one too), a random precision resolved to a ``gamma``
(scalar) or ``wishart`` (d x d) group and a random variance or covariance
to an ``inverse_gamma`` or ``inverse_wishart`` group; ``Beta`` /
``Bernoulli`` / ``Binomial`` (a random ``p`` is a ``beta`` group),
``Poisson`` (a random rate a ``gamma`` group), ``Categorical`` /
``Multinomial`` (a random ``p`` a ``dirichlet`` group), the priors
``GammaShapeRate`` / ``GammaShapeScale``, ``InverseGamma``, ``Wishart``,
``InverseWishart``, ``Uniform`` and ``Uninformative``; the sums ``Sum`` /
``LinComb`` (the out's shape from the maps or the terms, its family
Gaussian or multivariate Gaussian by that shape) and ``GaussianSum*``; the
mixtures (``switch`` categorical, ``mean{i}`` Gaussian, ``prec{i}`` gamma or
wishart; ``GammaMixture``'s ``shape{i}`` / ``rate{i}`` gamma; the generic
``Mixture``'s out and components of the family their other factors give),
``AR`` (out, ``in`` and ``theta`` vectors of the order, ``gamma`` gamma),
the logic nodes ``OR`` / ``AND`` / ``NOT`` / ``IMPLY`` (Bernoulli out and
inputs), ``BinomialPolya`` / ``MultinomialPolya`` (``beta`` a vector as long
as the features ``x``), ``ContinuousTransition`` (out, ``in`` and ``theta``
multivariate Gaussian, ``prec`` Wishart),
``GCV`` (scalar out, ``in`` and ``z``), ``GaussianDot*`` (scalar out,
``in`` a vector as long as ``A``, ``prec`` gamma), ``Probit`` (a Bernoulli
out, a Gaussian ``in``), ``SoftDot`` (scalar out, ``theta`` and ``x``
vectors, ``gamma`` gamma) and ``Delta`` / ``NonlinearGaussian*`` (the out's
shape by calling ``fn`` on zeros of its inputs' shapes, its family Gaussian
or multivariate Gaussian by that shape; a random input's family by the
shape its other factors give it); variables reached only through nodes that
are not ported yet stay unresolved and raise.
"""

from __future__ import annotations

import numpy as np

from ..graph.ir import Const, Factor, ModelGraph, Ref, Variable

_OUT_FAMILY = {
    "NormalMeanVariance": "gaussian",
    "NormalMeanPrecision": "gaussian",
    "LinearGaussianCovariance": "gaussian",
    "LinearGaussianPrecision": "gaussian",
    "MvNormalMeanCovariance": "mv_gaussian",
    "MvNormalMeanPrecision": "mv_gaussian",
    "MvNormalMeanScalePrecision": "mv_gaussian",
    "MvLinearGaussianCovariance": "mv_gaussian",
    "MvLinearGaussianPrecision": "mv_gaussian",
    "Beta": "beta",
    "Bernoulli": "bernoulli",
    "Binomial": "poisson",     # counts: the carrier of a data out, unused
    "Multinomial": "poisson",  # likewise
    "Poisson": "poisson",
    "GammaShapeRate": "gamma",
    "GammaShapeScale": "gamma",
    "InverseGamma": "inverse_gamma",
    "Wishart": "wishart",
    "InverseWishart": "inverse_wishart",
    "Uniform": "gaussian",     # a continuous scalar carrier
    "Uninformative": "gaussian",
    "GaussianSumCovariance": "gaussian",
    "GaussianSumPrecision": "gaussian",
    "MvGaussianSumCovariance": "mv_gaussian",
    "MvGaussianSumPrecision": "mv_gaussian",
    "Categorical": "categorical",
    "Dirichlet": "dirichlet",
    "DirichletCollection": "dirichlet_collection",
    "DiscreteTransition": "categorical",
    "NormalMixture": "gaussian",
    "MvNormalMixture": "mv_gaussian",
    "GammaMixture": "gamma",
    "GaussianDotCovariance": "gaussian",
    "GaussianDotPrecision": "gaussian",
    "AR": "mv_gaussian",
    "GCV": "gaussian",
    "Probit": "bernoulli",
    "SoftDot": "gaussian",
    "OR": "bernoulli",
    "AND": "bernoulli",
    "NOT": "bernoulli",
    "IMPLY": "bernoulli",
    "BinomialPolya": "poisson",       # counts: the carrier of a data out
    "MultinomialPolya": "poisson",
    "ContinuousTransition": "mv_gaussian",
}

# the out of a deterministic node: Gaussian or multivariate Gaussian by the
# shape its function gives
_SHAPE_FAMILY = {"Delta", "NonlinearGaussianCovariance",
                 "NonlinearGaussianPrecision"}
# and the out of a sum node, by the shape its maps or terms give
_SUM_NODES = {"Sum", "LinComb"}

_INPUT_FAMILY = {
    ("NormalMeanPrecision", "mean"): "gaussian",
    ("NormalMeanVariance", "mean"): "gaussian",
    ("MvNormalMeanPrecision", "mean"): "mv_gaussian",
    ("MvNormalMeanCovariance", "mean"): "mv_gaussian",
    ("MvLinearGaussianCovariance", "in"): "mv_gaussian",
    ("MvLinearGaussianPrecision", "in"): "mv_gaussian",
    ("LinearGaussianCovariance", "in"): "gaussian",
    ("LinearGaussianPrecision", "in"): "gaussian",
    ("NormalMeanPrecision", "prec"): "gamma",
    ("NormalMeanVariance", "var"): "inverse_gamma",
    ("MvNormalMeanPrecision", "prec"): "wishart",
    ("MvNormalMeanCovariance", "cov"): "inverse_wishart",
    ("MvNormalMeanScalePrecision", "mean"): "mv_gaussian",
    ("MvNormalMeanScalePrecision", "gamma"): "gamma",
    ("GaussianSumPrecision", "prec"): "gamma",
    ("MvGaussianSumPrecision", "prec"): "wishart",
    ("Binomial", "p"): "beta",
    ("Poisson", "rate"): "gamma",
    ("GammaShapeRate", "rate"): "gamma",
    ("Multinomial", "p"): "dirichlet",
    ("MvLinearGaussianPrecision", "prec"): "wishart",
    ("LinearGaussianPrecision", "prec"): "gamma",
    ("DiscreteTransition", "in"): "categorical",
    ("DiscreteTransition", "matrix"): "dirichlet_collection",
    ("Bernoulli", "p"): "beta",
    ("Categorical", "p"): "dirichlet",
    ("Dirichlet", "alpha"): None,
    ("NormalMixture", "switch"): "categorical",
    ("MvNormalMixture", "switch"): "categorical",
    ("GammaMixture", "switch"): "categorical",
    ("Mixture", "switch"): "categorical",
    ("GaussianDotCovariance", "in"): "mv_gaussian",
    ("GaussianDotPrecision", "in"): "mv_gaussian",
    ("GaussianDotPrecision", "prec"): "gamma",
    ("AR", "in"): "mv_gaussian",
    ("AR", "theta"): "mv_gaussian",
    ("AR", "gamma"): "gamma",
    ("GCV", "in"): "gaussian",
    ("GCV", "z"): "gaussian",
    ("Probit", "in"): "gaussian",
    ("SoftDot", "theta"): "mv_gaussian",
    ("SoftDot", "x"): "mv_gaussian",
    ("SoftDot", "gamma"): "gamma",
    ("NonlinearGaussianPrecision", "prec"): "gamma",
    ("OR", "in1"): "bernoulli",
    ("OR", "in2"): "bernoulli",
    ("AND", "in1"): "bernoulli",
    ("AND", "in2"): "bernoulli",
    ("IMPLY", "in1"): "bernoulli",
    ("IMPLY", "in2"): "bernoulli",
    ("NOT", "in"): "bernoulli",
    ("BinomialPolya", "beta"): "mv_gaussian",
    ("MultinomialPolya", "beta"): "mv_gaussian",
    ("ContinuousTransition", "in"): "mv_gaussian",
    ("ContinuousTransition", "theta"): "mv_gaussian",
    ("ContinuousTransition", "prec"): "wishart",
}

# a mixture's component interfaces carry their index (mean0, prec1, ...)
_COMPONENT_FAMILY = {
    "NormalMixture": {"mean": "gaussian", "prec": "gamma"},
    "MvNormalMixture": {"mean": "mv_gaussian", "prec": "wishart"},
    "GammaMixture": {"shape": "gamma", "rate": "gamma"},
}


def input_family(f: Factor, iface: str) -> str | None:
    """Family of a random variable at interface ``iface`` of ``f``."""
    if iface.startswith("in") and iface[2:].isdigit():
        if f.fform.startswith("GaussianSum"):
            return "gaussian"
        if f.fform.startswith("MvGaussianSum"):
            return "mv_gaussian"
        return None   # Sum / LinComb / Delta: the shape decides
    comps = _COMPONENT_FAMILY.get(f.fform)
    if comps is not None:
        for prefix, fam in comps.items():
            if iface.startswith(prefix):
                return fam
    return _INPUT_FAMILY.get((f.fform, iface))


class GroupInfo:
    """Static metadata for one random-variable group."""

    def __init__(self, var: Variable):
        self.var = var
        self.family: str | None = None
        self.event_shape: tuple | None = None

    def __repr__(self):
        return f"GroupInfo({self.var.name}, {self.family}, {self.event_shape})"


def _const_shape(v) -> tuple:
    return tuple(np.shape(v.value))


def infer_event_shape(f: Factor, graph: ModelGraph, known: dict) -> tuple | None:
    """Event shape of f.out from its constant/known interfaces."""
    ifc = f.interfaces
    ff = f.fform

    def shape_of(name):
        v = ifc.get(name)
        if isinstance(v, Const):
            return _const_shape(v)
        if isinstance(v, Ref):
            if v.var.kind == "data":
                return tuple(v.var.event_shape or ())
            g = known.get(v.var.name)
            return g.event_shape if g else None
        return None

    if ff in ("NormalMeanVariance", "NormalMeanPrecision",
              "LinearGaussianCovariance", "LinearGaussianPrecision",
              "GammaShapeRate", "GammaShapeScale", "InverseGamma",
              "Poisson", "Uniform", "Binomial", "Uninformative", "Beta",
              "Bernoulli", "NormalMixture", "GammaMixture",
              "GaussianDotCovariance", "GaussianDotPrecision",
              "GaussianSumCovariance", "GaussianSumPrecision", "GCV",
              "Probit", "SoftDot", "OR", "AND", "NOT", "IMPLY"):
        return ()
    if ff in _SUM_NODES:
        if ff == "LinComb":
            for k, v in ifc.items():
                if k.startswith("A") and k[1:].isdigit() \
                        and isinstance(v, Const):
                    sh = _const_shape(v)
                    if len(sh) == 2:
                        return (sh[0],)
                    if len(sh) == 1:
                        return ()
        # scalar multipliers or a Sum: the terms' shape
        for k in ifc:
            if k.startswith("in"):
                s = shape_of(k)
                if s is not None:
                    return s
        return None
    if ff in _SHAPE_FAMILY:
        return _delta_out_shape(f, shape_of)
    if ff == "AR":
        k = (f.meta or {}).get("order")
        return (int(k),) if k else None
    if ff == "MvNormalMixture":
        for key in f.interfaces:
            if key.startswith("mean"):
                s = shape_of(key)
                if s:
                    return s
            if key.startswith("prec"):
                s = shape_of(key)
                if s:
                    return (s[-1],)
        return None
    if ff == "Categorical":
        s = shape_of("p")
        return (s[-1],) if s else None
    if ff in ("Dirichlet", "DirichletCollection"):
        return shape_of("alpha")
    if ff == "Wishart":
        return shape_of("S")
    if ff == "InverseWishart":
        return shape_of("Psi")
    if ff == "DiscreteTransition":
        s = shape_of("matrix")
        return (s[0],) if s else None
    if ff in ("MvNormalMeanCovariance", "MvNormalMeanPrecision",
              "MvNormalMeanScalePrecision"):
        s = shape_of("mean")
        if s:
            return s
        for key in ("cov", "prec"):
            s = shape_of(key)
            if s:
                return (s[-1],)
        return None
    if ff in ("MvGaussianSumCovariance", "MvGaussianSumPrecision"):
        for key in ("cov", "prec"):
            s = shape_of(key)
            if s:
                return (s[-1],)
        for k in ifc:
            if k.startswith("in"):
                s = shape_of(k)
                if s:
                    return s
        return None
    if ff in ("MvLinearGaussianCovariance", "MvLinearGaussianPrecision"):
        a = shape_of("A")
        if a and len(a) == 2:
            return (a[0],)
        for key in ("cov", "prec"):
            s = shape_of(key)
            if s:
                return (s[-1],)
        return None
    return None


def _delta_out_shape(f: Factor, shape_of) -> tuple | None:
    """The out's event shape of a deterministic node: ``fn`` called on zeros
    of its inputs' event shapes (None while an input's is unknown or when
    ``fn`` does not take the probe)."""
    import torch

    fn = (f.meta or {}).get("fn")
    keys = sorted((k for k in f.interfaces if k.startswith("in")),
                  key=lambda k: int(k[2:]))
    shapes = [shape_of(k) for k in keys]
    if fn is None or any(s is None for s in shapes):
        return None
    try:
        with torch.no_grad():
            out = fn(*[torch.zeros(s) for s in shapes])
    except Exception:  # noqa: BLE001 -- a probe the function refuses
        return None
    return tuple(torch.as_tensor(out).shape)


def infer_input_shape(f: Factor, iface: str, out_shape) -> tuple | None:
    """Event shape of a random *input* interface, where derivable."""
    ff = f.fform
    if ff == "DiscreteTransition" and iface == "in":
        m = f.interfaces.get("matrix")
        if isinstance(m, Const):
            return (_const_shape(m)[1],)
    if ff in ("BinomialPolya", "MultinomialPolya") and iface == "beta":
        x = f.interfaces.get("x")
        if isinstance(x, Const):
            return (_const_shape(x)[-1],)
        if isinstance(x, Ref) and x.var.kind == "data":
            return (tuple(x.var.event_shape)[-1],)
        return None
    if ff in ("MvLinearGaussianCovariance", "MvLinearGaussianPrecision") \
            and iface == "in":
        a = f.interfaces.get("A")
        if isinstance(a, Const):
            s = _const_shape(a)
            if len(s) == 2:
                return (s[1],)
    if ff in ("MvNormalMeanCovariance", "MvNormalMeanPrecision",
              "MvNormalMeanScalePrecision") and iface == "mean":
        return out_shape
    if ff in ("GaussianSumCovariance", "GaussianSumPrecision") \
            and iface.startswith("in"):
        return ()
    if ff in ("MvGaussianSumCovariance", "MvGaussianSumPrecision", "Sum") \
            and iface.startswith("in"):
        return out_shape
    if ff == "LinComb" and iface.startswith("in"):
        a = f.interfaces.get("A" + iface[2:])
        if isinstance(a, Const):
            sh = _const_shape(a)
            if len(sh) >= 1:
                # a trailing 1: a column map from a scalar input
                return (sh[-1],) if sh[-1] > 1 else ()
            return out_shape   # a scalar multiplier: the out's space
        return None
    if ff in ("NormalMeanVariance", "NormalMeanPrecision") and iface == "mean":
        return ()
    if ff == "AR" and iface in ("in", "theta"):
        k = (f.meta or {}).get("order")
        return (int(k),) if k else None
    if ff in ("GaussianDotCovariance", "GaussianDotPrecision") \
            and iface == "in":
        a = f.interfaces.get("A")
        if isinstance(a, Const):
            return (_const_shape(a)[-1],)
        if isinstance(a, Ref) and a.var.kind == "data":
            return (tuple(a.var.event_shape)[-1],)
    if ff == "MvNormalMixture":
        if iface.startswith("mean"):
            return out_shape
        if iface.startswith("prec") and out_shape:
            return (out_shape[-1], out_shape[-1])
        if iface == "switch":
            k = (f.meta or {}).get("K")
            return (int(k),) if k else None
    return None


def resolve_groups(graph: ModelGraph) -> dict[str, GroupInfo]:
    """Fixed-point pass assigning (family, event_shape) to every random group."""
    infos = {v.name: GroupInfo(v) for v in graph.random_variables()}

    for _ in range(8):
        changed = False
        for f in graph.factors:
            if f.out.var.kind == "random":
                gi = infos[f.out.var.name]
                fam = _OUT_FAMILY.get(f.fform)
                if gi.family is None and fam is not None:
                    gi.family = fam
                    changed = True
                if gi.event_shape is None:
                    s = infer_event_shape(f, graph, infos)
                    if s is not None:
                        gi.event_shape = s
                        changed = True
                if (f.fform in _SHAPE_FAMILY | _SUM_NODES
                        and gi.family is None
                        and gi.event_shape is not None):
                    gi.family = ("mv_gaussian" if len(gi.event_shape) == 1
                                 else "gaussian")
                    changed = True
            for name, v in f.interfaces.items():
                if isinstance(v, Ref) and v.var.kind == "random":
                    gi = infos[v.var.name]
                    fam = input_family(f, name)
                    if gi.family is None and fam is not None:
                        gi.family = fam
                        changed = True
                    if gi.event_shape is None:
                        out_gi = infos.get(f.out.var.name)
                        out_shape = out_gi.event_shape if out_gi else (
                            tuple(f.out.var.event_shape or ())
                            if f.out.var.kind == "data" else None)
                        s = infer_input_shape(f, name, out_shape)
                        if s is None and fam in ("gamma", "beta",
                                                 "bernoulli", "poisson",
                                                 "inverse_gamma"):
                            s = ()
                        if (s is None and out_shape
                                and fam in ("wishart", "inverse_wishart")):
                            s = (out_shape[-1], out_shape[-1])
                        if s is not None:
                            gi.event_shape = s
                            changed = True
        if not changed:
            break

    missing = [n for n, gi in infos.items()
               if gi.family is None or gi.event_shape is None]
    if missing:
        raise ValueError(
            f"Could not infer family/event-shape for variables: {missing}. "
            "(The PyTorch port resolves the Gaussian and discrete node sets "
            "only.)"
        )
    return infos
