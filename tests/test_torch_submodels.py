"""Submodels (ROADMAP A6i) through both packages on the CPU: ``scope`` and
``submodel`` (instance suffixes, scoped posterior names), submodel-scoped
constraint blocks and a submodel's ``default_constraints`` /
``default_init``, submodel-type initialization keys, node contraction
(``infer(allow_node_contraction=True)``) and folded data arithmetic.  The
cases of tests/models/test_submodel_scopes.py, test_default_constraints.py,
test_zoo_submodels.py, test_node_contraction.py and test_data_folding.py,
each held against the JAX package at 1e-5; the LGSSM written as submodels is
held bit for bit against the flat ``zoo.lgssm`` inside the port, on the
batched program's fused plan.  The chain cases ``mu(x)`` refuses are the
JAX package's.  Inputs come from numpy seeds; the port runs with
``device="cpu"``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu import dists as jd
from rxinfer_tpu.engine.compile import CompiledModel as JCompiled
from rxinfer_tpu.models import zoo as jzoo
from rxinfer_tpu.rules.registry import node as jnode
from rxinfer_tpu_torch import dists as td
from rxinfer_tpu_torch.engine.compile import CompiledModel as TCompiled
from rxinfer_tpu_torch.models import zoo as tzoo
from rxinfer_tpu_torch.rules.registry import node as tnode

CPU = torch.device("cpu")
# float32 in both packages, the same schedule
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _dev(rx):
    return {} if rx is jrx else {"device": CPU}


def _gamma(rx, a, b):
    return (jd.GammaShapeRate(np.float32(a), np.float32(b)) if rx is jrx
            else td.GammaShapeRate(torch.tensor(np.float32(a)),
                                   torch.tensor(np.float32(b))))


def _nmv(rx, m, v):
    return (jd.NormalMeanVariance(np.float32(m), np.float32(v)) if rx is jrx
            else td.NormalMeanVariance(torch.tensor(np.float32(m)),
                                       torch.tensor(np.float32(v))))


def _infer(rx, model, data, **kw):
    return rx.infer(model=model, data=data, returnvars=rx.KeepLast(),
                    **kw, **_dev(rx))


def _same_posteriors(jp: dict, tp: dict):
    assert set(jp) == set(tp)
    for k in jp:
        assert type(jp[k]).__name__ == type(tp[k]).__name__, k
        np.testing.assert_allclose(_np(tp[k].mean()), _np(jp[k].mean()),
                                   **TOL, err_msg=k)
        if not isinstance(tp[k], td.PointMass):
            np.testing.assert_allclose(_np(tp[k].var()), _np(jp[k].var()),
                                       **TOL, err_msg=k)


def _same_result(jres, tres):
    _same_posteriors(jres.posteriors, tres.posteriors)
    if jres.free_energy is not None:
        np.testing.assert_allclose(_np(tres.free_energy),
                                   _np(jres.free_energy), **TOL)


# -- scopes and submodel-scoped constraint blocks -------------------------------------

def _gauss_block(rx, y, tag):
    with rx.scope(tag):
        mu = rx.Normal(mean=0.0, var=100.0)
        tau = rx.Gamma(shape=0.01, rate=0.01)
        for i in rx.plate(len(y)):
            y[i] = rx.Normal(mean=mu, precision=tau)


def _two_blocks(rx, tags):
    @rx.model
    def m(y1, y2):
        _gauss_block(rx, y1, tags[0])
        _gauss_block(rx, y2, tags[1])

    return m


def _one_block(rx):
    @rx.model
    def m(y):
        _gauss_block(rx, y, "blk")

    return m


def _two_data(seed, loc1, sc1, loc2, sc2, n):
    rng = np.random.default_rng(seed)
    return {"y1": (loc1 + sc1 * rng.standard_normal(n)).astype(np.float32),
            "y2": (loc2 + sc2 * rng.standard_normal(n)).astype(np.float32)}


def _pm_block(rx, key):
    return rx.constraints(submodel={key: rx.constraints(
        forms={"tau": rx.PointMassFormConstraint()})})


# name -> (model tags, data, iterations, constraints (rx -> ...), init keys)
SCOPE_CASES = {
    "prefixes": (("a", "b"), (0, 2.0, 0.5, -1.0, 2.0, 60), 15, None,
                 ("a/tau", "b/tau")),
    "instance_suffixes": (("blk", "blk"), (1, 0.0, 1.0, 0.0, 1.0, 30), 5,
                          None, ("blk/tau", "blk:2/tau")),
    "form_every_instance": (("blk", "blk"), (2, 1.0, 1.0, 3.0, 1.0, 40), 15,
                            lambda rx: _pm_block(rx, "blk"),
                            ("blk/tau", "blk:2/tau")),
    "form_one_instance": (("blk", "blk"), (3, 0.0, 1.0, 0.0, 1.0, 40), 10,
                          lambda rx: _pm_block(rx, "blk:2"),
                          ("blk/tau", "blk:2/tau")),
}


@pytest.mark.parametrize("case", sorted(SCOPE_CASES))
def test_scoped_blocks_match_jax(case):
    tags, dspec, its, cons, init_keys = SCOPE_CASES[case]
    data = _two_data(*dspec)
    res = {}
    for rx in (jrx, trx):
        res[rx] = _infer(rx, _two_blocks(rx, tags), data, iterations=its,
                         constraints=cons(rx) if cons else None,
                         initialization={k: _gamma(rx, 1.0, 1.0)
                                         for k in init_keys})
    _same_result(res[jrx], res[trx])
    post = res[trx].posteriors
    assert set(post) == {f"{p}/{v}" for p in {k.split("/")[0]
                                              for k in init_keys}
                         for v in ("mu", "tau")}
    if case == "prefixes":
        assert abs(float(post["a/mu"].mean()) - 2.0) < 0.3
        assert abs(float(post["b/mu"].mean()) + 1.0) < 0.8
    if case == "form_every_instance":
        assert isinstance(post["blk/tau"], td.PointMass)
        assert isinstance(post["blk:2/tau"], td.PointMass)
    if case == "form_one_instance":
        assert isinstance(post["blk:2/tau"], td.PointMass)
        assert not isinstance(post["blk/tau"], td.PointMass)


def test_scoped_meanfield_equals_global_meanfield():
    """MeanField scoped to the one submodel equals the global MeanField when
    the model is that submodel, in both packages."""
    rng = np.random.default_rng(4)
    data = {"y": (0.5 + rng.standard_normal(50)).astype(np.float32)}
    out = {}
    for rx in (jrx, trx):
        init = {"blk/tau": _gamma(rx, 1.0, 1.0)}
        for kind, cons in (
                ("scoped", rx.constraints(submodel={"blk": rx.constraints(
                    factorization=rx.MeanField())})),
                ("global", rx.constraints(factorization=rx.MeanField()))):
            out[rx, kind] = _infer(rx, _one_block(rx), data, iterations=12,
                                   free_energy=True, constraints=cons,
                                   initialization=init)
    _same_result(out[jrx, "scoped"], out[trx, "scoped"])
    np.testing.assert_allclose(_np(out[trx, "scoped"].free_energy),
                               _np(out[trx, "global"].free_energy),
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(out[trx, "scoped"].posteriors["blk/mu"].mean()),
        float(out[trx, "global"].posteriors["blk/mu"].mean()), rtol=1e-6)


def test_unknown_scope_key_and_type_init_raise_as_in_jax():
    y = np.zeros(10, np.float32)
    for rx in (jrx, trx):
        cons = rx.constraints(submodel={"nope": rx.constraints(
            factorization=rx.MeanField())})
        with pytest.raises(ValueError, match="nope"):
            _infer(rx, _one_block(rx), {"y": y}, iterations=2,
                   constraints=cons,
                   initialization={"blk/tau": _gamma(rx, 1.0, 1.0)})

        @rx.model
        def m(y):
            mu = rx.Normal(mean=0.0, var=1.0)
            y.observe(rx.Normal(mean=mu, var=1.0))
            return {"mu": mu}

        with pytest.raises(ValueError, match="matches no"):
            rx.infer(model=m, data={"y": np.float32(0.3)},
                     initialization={("nope", "tau"): _gamma(rx, 1.0, 1.0)},
                     **_dev(rx))


def test_submodel_type_initialization_matches_jax():
    rng = np.random.default_rng(0)
    y1 = (1.5 + 0.5 * rng.standard_normal(80)).astype(np.float32)
    y2 = (-1.0 + 0.5 * rng.standard_normal(80)).astype(np.float32)
    res = {}
    for rx in (jrx, trx):
        @rx.model
        def two_blocks(y1, y2):
            out = {}
            for name, y in (("a", y1), ("b", y2)):
                with rx.scope("blk"):
                    mu = rx.Normal(mean=0.0, var=100.0)
                    tau = rx.Gamma(shape=1.0, rate=1.0)
                    for i in rx.plate(len(y)):
                        y[i] = rx.Normal(mean=mu, precision=tau)
                    out[name] = mu
            return out

        res[rx] = _infer(rx, two_blocks, {"y1": y1, "y2": y2},
                         iterations=15, initialization={
                             ("blk", "tau"): _gamma(rx, 1.0, 1.0)})
    _same_result(res[jrx], res[trx])
    assert abs(float(res[trx].posteriors["a"].mean()) - 1.5) < 0.2
    assert abs(float(res[trx].posteriors["b"].mean()) + 1.0) < 0.2


# -- default constraints and default initialization -----------------------------------

def _default_blocks(rx):
    @rx.submodel(default_constraints=rx.constraints(
        forms={"tau": rx.PointMassFormConstraint()}))
    def gauss_block(y):
        mu = rx.Normal(mean=0.0, var=100.0)
        tau = rx.Gamma(shape=0.01, rate=0.01)
        for i in rx.plate(len(y)):
            y[i] = rx.Normal(mean=mu, precision=tau)
        return mu, tau

    @rx.submodel(default_init={"tau": _gamma(rx, 1.0, 1.0)})
    def init_block(y):
        mu = rx.Normal(mean=0.0, var=100.0)
        tau = rx.Gamma(shape=0.01, rate=0.01)
        for i in rx.plate(len(y)):
            y[i] = rx.Normal(mean=mu, precision=tau)
        return mu, tau

    @rx.model
    def two_gauss(y1, y2):
        gauss_block(y1)
        gauss_block(y2)

    @rx.model
    def two_init(y1, y2):
        init_block(y1)
        init_block(y2)

    return two_gauss, two_init


def _gauss_init(rx):
    return {"gauss_block/tau": _gamma(rx, 1.0, 1.0),
            "gauss_block:2/tau": _gamma(rx, 1.0, 1.0)}


# name -> (model index, data seed, iterations, kwargs (rx -> dict))
DEFAULT_CASES = {
    "constraints_every_instance": (0, 0, 15, lambda rx: dict(
        initialization=_gauss_init(rx))),
    "user_block_overrides_default": (0, 1, 15, lambda rx: dict(
        initialization=_gauss_init(rx),
        constraints=rx.constraints(submodel={
            "gauss_block:2": rx.constraints()}))),
    "init_every_instance": (1, 3, 15, lambda rx: dict(free_energy=True)),
    "init_user_override_wins": (1, 4, 1, lambda rx: dict(
        free_energy=True, initialization={
            "init_block:2/tau": _gamma(rx, 1000.0, 0.001)})),
}


@pytest.mark.parametrize("case", sorted(DEFAULT_CASES))
def test_submodel_defaults_match_jax(case):
    which, seed, its, kw = DEFAULT_CASES[case]
    data = _two_data(seed, 2.0, 0.5, -1.0, 2.0, 60)
    res = {rx: _infer(rx, _default_blocks(rx)[which], data, iterations=its,
                      **kw(rx)) for rx in (jrx, trx)}
    _same_result(res[jrx], res[trx])
    post = res[trx].posteriors
    if case == "constraints_every_instance":
        assert isinstance(post["gauss_block/tau"], td.PointMass)
        assert isinstance(post["gauss_block:2/tau"], td.PointMass)
    if case == "user_block_overrides_default":
        assert isinstance(post["gauss_block/tau"], td.PointMass)
        assert isinstance(post["gauss_block:2/tau"], td.GammaShapeRate)
    if case == "init_every_instance":
        assert abs(float(post["init_block/mu"].mean()) - 2.0) < 0.3
        assert (np.diff(_np(res[trx].free_energy)) <= 1e-3).all()
    if case == "init_user_override_wins":
        default = _infer(trx, _default_blocks(trx)[1], data, iterations=1,
                         free_energy=True)
        assert abs(float(res[trx].free_energy[0])
                   - float(default.free_energy[0])) > 1e-3


# -- the zoo, flat against composed ---------------------------------------------------

def test_zoo_models_match_jax():
    rng = np.random.default_rng(0)
    y = (rng.uniform(size=50) < 0.7).astype(np.float32)
    th = np.pi / 20
    a = np.float32([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    eye = np.eye(2, dtype=np.float32)
    yy = rng.standard_normal((40, 2)).astype(np.float32)
    for jm, tm, data in (
            (jzoo.beta_bernoulli(2.0, 2.0), tzoo.beta_bernoulli(2.0, 2.0),
             {"y": y}),
            (jzoo.lgssm(a, eye, eye, eye, np.zeros(2, np.float32), 10 * eye),
             tzoo.lgssm(a, eye, eye, eye, np.zeros(2, np.float32), 10 * eye),
             {"y": yy})):
        _same_result(_infer(jrx, jm, data, free_energy=True),
                     _infer(trx, tm, data, free_energy=True))
    res = _infer(trx, tzoo.beta_bernoulli(2.0, 2.0), {"y": y})
    assert np.isclose(float(res.posteriors["theta"].a), 2 + y.sum())


def _walk_models(rx, t_len):
    def emission(y, x, t):
        y[t] = rx.Normal(mean=x[t], var=0.25)

    def random_walk(x, t):
        x[t] = rx.Normal(mean=x[t - 1], var=1.0)

    @rx.model
    def flat(y):
        x = rx.latent(t_len, name="x")
        x[0] = rx.Normal(mean=0.0, var=25.0)
        for t in rx.plate(1, t_len):
            x[t] = rx.Normal(mean=x[t - 1], var=1.0)
        for t in rx.plate(t_len):
            y[t] = rx.Normal(mean=x[t], var=0.25)

    @rx.model
    def composed(y):
        x = rx.latent(t_len, name="x")
        x[0] = rx.Normal(mean=0.0, var=25.0)
        for t in rx.plate(1, t_len):
            random_walk(x, t)
        for t in rx.plate(t_len):
            emission(y, x, t)

    return flat, composed


def test_flat_and_composed_walk_are_bit_equal_and_match_jax():
    rng = np.random.default_rng(1)
    t_len = 30
    y = (np.cumsum(rng.standard_normal(t_len))
         + 0.5 * rng.standard_normal(t_len)).astype(np.float32)
    res = {}
    for rx in (jrx, trx):
        flat, composed = _walk_models(rx, t_len)
        res[rx] = [_infer(rx, m, {"y": y}, free_energy=True)
                   for m in (flat, composed)]
    _same_result(res[jrx][1], res[trx][1])
    r1, r2 = res[trx]
    assert torch.equal(r1.posteriors["x"].mean(), r2.posteriors["x"].mean())
    assert torch.equal(r1.free_energy, r2.free_energy)


def test_fe_nan_diagnostic_run_matches_jax():
    rng = np.random.default_rng(0)
    y = rng.standard_normal(10).astype(np.float32)
    res = {}
    for rx, zoo in ((jrx, jzoo), (trx, tzoo)):
        res[rx] = _infer(rx, zoo.gaussian_unknown_mean_precision(), {"y": y},
                         iterations=3, free_energy=True,
                         initialization={"tau": _gamma(rx, 1.0, 1.0)},
                         options={"check_objective": True},
                         callbacks={"after_iteration": lambda ev: None})
    _same_result(res[jrx], res[trx])
    assert torch.isfinite(res[trx].free_energy).all()


def _lgssm_submodels(rx, a, q, b, r, m0, v0, prior):
    """``zoo.lgssm`` written as submodels inside ``scope("track")``: the
    state chain (with ``default_init`` for x) and the observations."""

    @rx.submodel(default_init={"x": prior})
    def transition(t_len):
        x = rx.latent(t_len, name="x")
        x[0] = rx.MvNormal(mean=m0, cov=v0)
        for t in rx.plate(1, t_len):
            x[t] = rx.MvNormal(mean=a @ x[t - 1], cov=q)
        return x

    @rx.submodel
    def emission(y, x):
        for t in rx.plate(len(y)):
            y[t] = rx.MvNormal(mean=b @ x[t], cov=r)

    @rx.model
    def lgssm_track(y):
        with rx.scope("track"):
            x = transition(len(y))
            emission(y, x)

    return lgssm_track


def test_lgssm_as_submodels_is_bit_equal_to_flat_on_the_fused_plan():
    """The batched program of the submodel form takes the fused plan and
    gives the flat model's posteriors, free energy and message trace bit
    for bit."""
    d, b_n, t_len = 2, 3, 12
    rng = np.random.default_rng(5)
    th = 0.3
    a = np.float32([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    q, r = 0.1 * np.eye(d, dtype=np.float32), np.eye(d, dtype=np.float32)
    m0, v0 = np.zeros(d, np.float32), 10 * np.eye(d, dtype=np.float32)
    y = torch.as_tensor(rng.standard_normal((b_n, t_len, d)).astype(
        np.float32))
    prior = td.MvNormalMeanCovariance(torch.zeros(d), 5 * torch.eye(d))
    out = {}
    for kind, model in (
            ("flat", tzoo.lgssm(a, q, a, r, m0, v0)),
            ("sub", _lgssm_submodels(trx, a, q, a, r, m0, v0, prior))):
        compiled, _ = trx.batched_program(model, {"y": y}, iterations=2,
                                          free_energy=True, device=CPU)
        with trx.trace_messages() as mt:
            post, fe = trx.infer_batched(model, {"y": y}, iterations=2,
                                         free_energy=True, device=CPU)
        out[kind] = (compiled, post, fe, mt.records)
    fc, fpost, ffe, frec = out["flat"]
    sc, spost, sfe, srec = out["sub"]
    assert set(spost) == {"track/transition/x"}
    assert sc.init["track/transition/x"] is prior       # default_init
    assert sc.plan_report()["track/transition/x"]["fused"]
    assert fc.plan_report()["x"]["fused"]
    q_f, q_s = fpost["x"], spost["track/transition/x"]
    assert torch.equal(q_f.mean(), q_s.mean())
    assert torch.equal(q_f.cov(), q_s.cov())
    assert torch.equal(ffe, sfe)
    assert [dict(r, interface=None) for r in frec] == \
        [dict(r, interface=None) for r in srec]
    assert [r["interface"] for r in srec] == ["track/transition/x"] * 2


# -- node contraction -----------------------------------------------------------------

KAPPA, OMEGA = 1.0, -1.0


def _register_gcv_sub(rx, node):
    """The JAX test's contracted node, in each package: its rules forward
    to GCV through ``call_rule`` (x is GCV's ``in``)."""
    if rx is jrx:
        pm = lambda v: jd.PointMass(jnp.asarray(v, jnp.float32))
    else:
        pm = lambda v: td.PointMass(torch.tensor(np.float32(v)))
    consts = lambda: {"kappa": pm(KAPPA), "omega": pm(OMEGA)}

    def fwd(q):
        fw = {"in": q["x"], "z": q["z"]}
        if "out" in q:
            fw["out"] = q["out"]
        return fw

    @node("gcv_sub")
    class GcvSubNode:
        interfaces = ("out", "x", "z")
        needs_self_marginal = True
        cavity_cluster = ("out", "x")

        @staticmethod
        def message_to_out(q):
            return rx.call_rule("GCV", "out", **fwd(q), **consts())

        @staticmethod
        def message_to_x(q):
            return rx.call_rule("GCV", "in", **fwd(q), **consts())

        @staticmethod
        def message_to_z(q):
            return rx.call_rule("GCV", "z", **{"in": q["x"],
                                               "out": q["out"],
                                               "z": q["z"]}, **consts())

        @staticmethod
        def average_energy(q):
            return rx.call_rule("GCV", "average_energy", **fwd(q),
                                **consts())


def _gcv_chain(rx):
    @rx.submodel
    def gcv_sub(x=None, z=None):
        return rx.GCV(x, z, kappa=KAPPA, omega=OMEGA)

    @rx.model
    def m(y):
        named = {}
        x_prev = rx.Normal(mean=0.0, var=1.0)
        named["x0"] = x_prev
        for t in range(len(y)):
            z = rx.Normal(mean=0.0, var=0.5)
            x = gcv_sub(x=x_prev, z=z)
            y[t] = rx.Normal(mean=x, var=0.1)
            named[f"z{t}"] = z
            named[f"x{t + 1}"] = x
            x_prev = x
        return named

    return m, gcv_sub


def _gcv_init(rx, t_len):
    d = {f"x{t}": _nmv(rx, 0.0, 1.0) for t in range(t_len + 1)}
    d.update({f"z{t}": _nmv(rx, 0.0, 0.5) for t in range(t_len)})
    return d


@pytest.fixture(scope="module")
def gcv_sub_nodes():
    _register_gcv_sub(jrx, jnode)
    _register_gcv_sub(trx, tnode)


@pytest.mark.parametrize("contract", [True, False])
def test_node_contraction_matches_jax(gcv_sub_nodes, contract):
    y = np.random.default_rng(11).normal(0.0, 1.0, size=4).astype(np.float32)
    res = {}
    for rx in (jrx, trx):
        res[rx] = _infer(rx, _gcv_chain(rx)[0], {"y": y}, iterations=15,
                         free_energy=True, constraints=rx.MeanField(),
                         initialization=_gcv_init(rx, len(y)),
                         allow_node_contraction=contract)
    _same_result(res[jrx], res[trx])
    if contract:
        fe = _np(res[trx].free_energy)
        assert np.isfinite(fe).all() and (np.diff(fe) <= 1e-4).all()
        flat = _infer(trx, _gcv_chain(trx)[0], {"y": y}, iterations=15,
                      free_energy=True, constraints=trx.MeanField(),
                      initialization=_gcv_init(trx, len(y)))
        assert abs(fe[-1] - float(flat.free_energy[-1])) < 0.5
        for k, qf in flat.posteriors.items():
            np.testing.assert_allclose(
                float(res[trx].posteriors[k].mean()), float(qf.mean()),
                atol=0.15)


def test_contraction_traces_one_factor_and_needs_keywords(gcv_sub_nodes):
    y = np.zeros(4, np.float32)
    for rx in (jrx, trx):
        m, gcv_sub = _gcv_chain(rx)
        off = {f.fform for f in m.trace({"y": y}).factors}
        on = {f.fform for f in m.trace(
            {"y": y}, allow_node_contraction=True).factors}
        assert "GCV" in off and "gcv_sub" not in off
        assert "gcv_sub" in on and "GCV" not in on

        @rx.model
        def positional(y):
            x0 = rx.Normal(mean=0.0, var=1.0)
            z = rx.Normal(mean=0.0, var=0.5)
            x = gcv_sub(x0, z=z)
            y.observe(rx.Normal(mean=x, var=0.1))
            return {}

        with pytest.raises(TypeError, match="keyword arguments"):
            positional.trace({"y": np.float32(0.0)},
                             allow_node_contraction=True)


def test_batched_entry_points_refuse_node_contraction_as_in_jax():
    model = tzoo.beta_bernoulli(1.0, 1.0)
    data = {"y": np.ones((2, 3), np.float32)}
    for rx, kw in ((jrx, {}), (trx, {"device": CPU})):
        with pytest.raises(TypeError, match="allow_node_contraction"):
            rx.infer_batched(model, data, allow_node_contraction=True, **kw)
        with pytest.raises(TypeError, match="allow_node_contraction"):
            rx.batched_program(model, data, allow_node_contraction=True,
                               **kw)


# -- folded data arithmetic -----------------------------------------------------------

def _fold_model(rx, case):
    @rx.model
    def m(y, a, b):
        if case == "sum_1":
            x = rx.Normal(mean=a + b + 1 - 1, precision=1.0)
        elif case == "sum_2":
            c = 1.0
            x = rx.Normal(mean=(a + b) + c - c, var=1.0)
        else:
            x = rx.Normal(mean=(a * b + (-b) + b / b) / 1.0, precision=1.0)
        y.observe(rx.Normal(mean=x, var=1.0))
        return {"x": x}

    return m


# name -> (a, b, posterior mean, free energy the reference asserts)
FOLD_CASES = {"sum_1": (2.0, 1.0, 1.5, 3.51551),
              "sum_2": (2.0, 1.0, 1.5, 3.51551),
              "mul_div_neg": (3.0, 2.0, 2.5, None)}


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_folded_data_matches_jax(case):
    a, b, mean, fe = FOLD_CASES[case]
    data = {"a": np.float32(a), "b": np.float32(b), "y": np.float32(0.0)}
    res = {rx: _infer(rx, _fold_model(rx, case), data, free_energy=True)
           for rx in (jrx, trx)}
    _same_result(res[jrx], res[trx])
    assert float(res[trx].posteriors["x"].mean()) == pytest.approx(
        mean, abs=1e-4)
    if fe is not None:
        assert float(res[trx].free_energy[-1]) == pytest.approx(fe, abs=0.1)


def test_indexed_data_sum_matches_jax():
    data = {"v": np.array([2.0, 1.0], np.float32), "y": np.float32(0.0)}
    res = {}
    for rx in (jrx, trx):
        @rx.model
        def m(y, v):
            x = rx.Normal(mean=v[0] + v[1], precision=1.0)
            y.observe(rx.Normal(mean=x, var=1.0))
            return {"x": x}

        res[rx] = _infer(rx, m, data, free_energy=True)
    _same_result(res[jrx], res[trx])
    assert float(res[trx].posteriors["x"].mean()) == pytest.approx(
        1.5, abs=0.1)


def test_folding_on_infer_batched_and_from_runtime_data():
    """infer_batched resolves the fold per dataset, equal to infer on each
    one and to the JAX package; the fold reads the runtime data: new a, b
    reuse the compiled program and move the answer."""
    a = np.array([2.0, -1.0, 0.5, 3.0], np.float32)
    b = np.array([2.0, 1.0, 0.5, -1.0], np.float32)
    data = {"a": a, "b": b, "y": np.zeros(4, np.float32)}
    res = {}
    for rx in (jrx, trx):
        @rx.model
        def m(y, a, b):
            x = rx.Normal(mean=a + b, precision=1.0)
            y.observe(rx.Normal(mean=x, var=1.0))
            return {"x": x}

        res[rx] = rx.infer_batched(m, data=data, free_energy=True,
                                   **_dev(rx))
    (jp, jfe), (tp, tfe) = res[jrx], res[trx]
    np.testing.assert_allclose(_np(tp["x"].mean()), _np(jp["x"].mean()),
                               **TOL)
    np.testing.assert_allclose(_np(tfe), _np(jfe), **TOL)
    np.testing.assert_allclose(_np(tp["x"].mean()), (a + b) / 2.0,
                               atol=1e-4)
    first = _infer(trx, m, {k: v[0] for k, v in data.items()},
                   free_energy=True)
    assert float(tp["x"].mean()[0]) == pytest.approx(
        float(first.posteriors["x"].mean()), abs=1e-4)
    again = _infer(trx, m, {"a": np.float32(-1.0), "b": np.float32(1.0),
                            "y": np.float32(0.0)})
    assert again.model is first.model           # the cached program
    assert float(again.posteriors["x"].mean()) == pytest.approx(0.0,
                                                                abs=1e-4)


# -- mu(x) of a chain: the cases both packages refuse ---------------------------------

def _chain_case(rx, case):
    @rx.model
    def m(y, y0):
        x = rx.latent(4, name="x")
        if case == "transition_last":
            for t in rx.plate(4):
                y[t] = rx.Normal(mean=x[t], var=1.0)
        x[0] = rx.Normal(mean=0.0, var=1.0)
        for t in rx.plate(1, 4):
            x[t] = rx.Normal(mean=x[t - 1], var=1.0)
        if case == "partial":
            for t in rx.plate(4):
                y[t] = rx.Normal(mean=x[t], var=1.0)
            y0.observe(rx.Normal(mean=x[0], var=1.0))
        elif case == "no_evidence":
            y0.observe(rx.Normal(mean=rx.Normal(mean=0.0, var=1.0),
                                 var=1.0))
            for t in rx.plate(4):
                y[t] = rx.Normal(mean=0.0, var=1.0)
        return {"x": x}

    return m


@pytest.mark.parametrize("case", ["no_evidence", "transition_last",
                                  "partial"])
def test_chain_mu_refusals_are_the_jax_packages(case):
    data = {"y": np.zeros(4, np.float32), "y0": np.float32(0.0)}
    msgs = []
    for rx, compiled_cls in ((jrx, JCompiled), (trx, TCompiled)):
        compiled = compiled_cls(_chain_case(rx, case).trace(data))
        block = next(b for kind, b in compiled.blocks if kind == "chain")
        args = (block, {}, {}) + (() if rx is jrx else (None,))
        with pytest.raises(NotImplementedError) as err:
            compiled._chain_outbound_message(*args)
        # the port spells the Greek mu out
        msgs.append(str(err.value).replace("\u03bc", "mu"))
    assert msgs[0] == msgs[1]
