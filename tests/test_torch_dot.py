"""The dot-product mean (ROADMAP A6a) through both packages on the CPU:
``rx.dot`` and its lowering to ``GaussianDotCovariance`` /
``GaussianDotPrecision``, their rules (a constant vector and per-copy data
features, a batch of random marginals), ``zoo.linear_regression`` through
``infer_batched`` and ``infer`` (posterior, free energy, ``plan_report()``)
against the JAX package and the float64 closed form, a regression with a
random noise precision, and ``dot``'s refusals, which are the JAX
package's.  Inputs come from numpy seeds; the port runs with
``device="cpu"``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu import dists as jd
from rxinfer_tpu.models import zoo as jzoo
from rxinfer_tpu.rules import nodes as jnodes
from rxinfer_tpu_torch import dists as td
from rxinfer_tpu_torch.models import zoo as tzoo
from rxinfer_tpu_torch.rules import nodes as tnodes

CPU = torch.device("cpu")
# one rule: a few float32 einsums in two libraries
RULE_TOL = 1e-5
# posteriors and free energies: one conjugate update of a few hundred
# float32 terms in two libraries (measured on a CPU at 3.1e-7 for the
# covariance, 2e-7 for the free energy)
POST_TOL = 1e-5
FE_TOL = dict(rtol=1e-5, atol=1e-4)
# against the float64 closed form: float32 sums of N = 60 rank-one terms
ORACLE_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_rel(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def leaves(d):
    if isinstance(d, (jnp.ndarray, np.ndarray, torch.Tensor)):
        return [np.asarray(d)]
    return [np.asarray(getattr(d, f)) for f in d.__dataclass_fields__]


def regression_data(b, n, d, seed):
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal((b, n, d)).astype(np.float32)
    w = rng.standard_normal((b, d))
    y = (np.einsum("bnd,bd->bn", phi, w)
         + rng.standard_normal((b, n))).astype(np.float32)
    return phi, y


# -- the rules --------------------------------------------------------------------

def rule_inputs(dists, n, d, seed, features, precision):
    """q of n copies: out (random or observed), in, A (one constant vector
    or per-copy features), b and the noise (a variance or a Gamma
    precision)."""
    t = jnp.asarray if dists is jd else torch.as_tensor
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    a = f32(rng.standard_normal((n, d) if features else d))
    c = rng.standard_normal((d, d)) / np.sqrt(d)
    q = {"out": dists.NormalMeanVariance(t(f32(rng.standard_normal(n))),
                                         t(f32(rng.uniform(0.1, 1.0, n)))),
         "in": dists.MvNormalMeanCovariance(
             t(f32(rng.standard_normal(d))), t(f32(c @ c.T + 0.5 * np.eye(d)))),
         "A": dists.PointMass(t(a)), "b": dists.PointMass(t(f32(0.3)))}
    if precision:
        q["prec"] = dists.GammaShapeRate(t(f32(2.5)), t(f32(1.5)))
    else:
        q["var"] = dists.PointMass(t(f32(0.7)))
    return q


CASES = [("GaussianDotCovariance", rule) for rule in
         ("message_to_out", "message_to_in", "average_energy")] + [
    ("GaussianDotPrecision", rule) for rule in
    ("message_to_out", "message_to_in", "message_to_prec", "average_energy")]


@pytest.mark.parametrize("features", [False, True])
@pytest.mark.parametrize("node,rule", CASES)
def test_dot_rules_match_jax(node, rule, features):
    precision = node.endswith("Precision")
    jq = rule_inputs(jd, 6, 4, seed=2, features=features,
                     precision=precision)
    tq = rule_inputs(td, 6, 4, seed=2, features=features,
                     precision=precision)
    cls = node + "Node"
    jout = getattr(getattr(jnodes, cls), rule)(jq)
    tout = getattr(getattr(tnodes, cls), rule)(tq)
    if not isinstance(tout, torch.Tensor):
        assert type(tout).__name__ == type(jout).__name__
    for tl, jl in zip(leaves(tout), leaves(jout)):
        assert_rel(tl, jl, RULE_TOL)


# -- the DSL ----------------------------------------------------------------------

def test_dot_lowers_to_gaussian_dot_as_in_jax():
    phi, y = regression_data(1, 5, 3, seed=1)
    jg = jzoo.linear_regression(3).trace({"phi": phi[0], "y": y[0]})
    tg = tzoo.linear_regression(3).trace({"phi": phi[0], "y": y[0]})
    assert [f.fform for f in tg.factors] == [f.fform for f in jg.factors]
    assert "GaussianDotCovariance" in [f.fform for f in tg.factors]
    dot_f = next(f for f in tg.factors if f.fform.startswith("GaussianDot"))
    assert dot_f.interfaces["A"].var.name == "phi"

    @trx.model
    def const_dot(y):
        theta = trx.MvNormal(mean=np.zeros(2, np.float32),
                             cov=np.eye(2, dtype=np.float32))
        for i in trx.plate(len(y)):
            y[i] = trx.Normal(mean=trx.dot(np.array([1.0, -2.0]), theta),
                              precision=4.0)
        return {"theta": theta}

    g = const_dot.trace({"y": np.zeros(3, np.float32)})
    f = next(f for f in g.factors if f.fform.startswith("GaussianDot"))
    assert f.fform == "GaussianDotPrecision"
    np.testing.assert_array_equal(f.interfaces["A"].value, [1.0, -2.0])


@pytest.mark.parametrize("rx", [jrx, trx], ids=["jax", "port"])
def test_dot_refuses_two_random_arguments_and_a_matrix(rx):
    @rx.model
    def two_random(y):
        a = rx.MvNormal(mean=np.zeros(2, np.float32),
                        cov=np.eye(2, dtype=np.float32))
        theta = rx.MvNormal(mean=np.zeros(2, np.float32),
                            cov=np.eye(2, dtype=np.float32))
        for i in rx.plate(len(y)):
            y[i] = rx.Normal(mean=rx.dot(a, theta), var=1.0)

    with pytest.raises(TypeError, match="SoftDot"):
        two_random.trace({"y": np.zeros(3, np.float32)})

    @rx.model
    def matrix(y):
        theta = rx.MvNormal(mean=np.zeros(2, np.float32),
                            cov=np.eye(2, dtype=np.float32))
        for i in rx.plate(len(y)):
            y[i] = rx.Normal(mean=rx.dot(np.eye(2), theta), var=1.0)

    with pytest.raises(TypeError, match="vector first argument"):
        matrix.trace({"y": np.zeros(3, np.float32)})


# -- end to end -------------------------------------------------------------------

def test_linear_regression_infer_batched_matches_jax_and_the_closed_form():
    phi, y = regression_data(4, 60, 3, seed=4)
    data = {"phi": phi, "y": y}
    jc, _ = jrx.batched_program(jzoo.linear_regression(3), data,
                                free_energy=True)
    jpost, jfe = jrx.infer_batched(jzoo.linear_regression(3), data,
                                   free_energy=True)
    tc, _ = trx.batched_program(tzoo.linear_regression(3), data,
                                free_energy=True, device=CPU)
    tpost, tfe = trx.infer_batched(tzoo.linear_regression(3), data,
                                   free_energy=True, device=CPU)
    assert tc.plan_report() == jc.plan_report() == {}
    assert_rel(tpost["theta"].mean().numpy(), jpost["theta"].mean(),
               POST_TOL)
    assert_rel(tpost["theta"].cov().numpy(), jpost["theta"].cov(), POST_TOL)
    np.testing.assert_allclose(tfe.numpy(), np.asarray(jfe), **FE_TOL)
    # the one conjugate update is exact: the closed-form posterior, and the
    # free energy is -log p(y)
    mean, cov, nlz = chip_smoke.linreg_closed_form(phi, y)
    assert_rel(tpost["theta"].mean().numpy(), mean, ORACLE_TOL)
    assert_rel(tpost["theta"].cov().numpy(), cov, ORACLE_TOL)
    np.testing.assert_allclose(tfe.numpy()[-1], nlz, rtol=1e-5)


def test_linear_regression_infer_matches_jax():
    phi, y = regression_data(1, 40, 4, seed=6)
    data = {"phi": phi[0], "y": y[0]}
    jres = jrx.infer(jzoo.linear_regression(4), data=data, free_energy=True)
    tres = trx.infer(tzoo.linear_regression(4), data=data, free_energy=True,
                     device=CPU)
    assert_rel(tres.posteriors["theta"].mean().numpy(),
               jres.posteriors["theta"].mean(), POST_TOL)
    assert_rel(tres.posteriors["theta"].cov().numpy(),
               jres.posteriors["theta"].cov(), POST_TOL)
    np.testing.assert_allclose(tres.free_energy.numpy(),
                               np.asarray(jres.free_energy), **FE_TOL)


def noisy_regression(rx, d):
    """A regression with an unknown noise precision: the GaussianDotPrecision
    node's message to it."""
    @rx.model
    def noisy(phi, y):
        theta = rx.MvNormal(mean=np.zeros(d, np.float32),
                            cov=10.0 * np.eye(d, dtype=np.float32))
        tau = rx.Gamma(shape=1.0, rate=1.0)
        for i in rx.plate(len(y)):
            y[i] = rx.Normal(mean=rx.dot(phi[i], theta), precision=tau)
        return {"theta": theta, "tau": tau}

    return noisy


def test_regression_with_a_random_precision_matches_jax():
    phi, y = regression_data(3, 50, 2, seed=8)
    data = {"phi": phi, "y": y}
    jinit = {"tau": jd.GammaShapeRate(1.0, 1.0)}
    tinit = {"tau": td.GammaShapeRate(torch.tensor(1.0), torch.tensor(1.0))}
    jpost, jfe = jrx.infer_batched(noisy_regression(jrx, 2), data,
                                   iterations=4, free_energy=True,
                                   initialization=jinit)
    tpost, tfe = trx.infer_batched(noisy_regression(trx, 2), data,
                                   iterations=4, free_energy=True,
                                   initialization=tinit, device=CPU)
    for name in ("theta", "tau"):
        assert_rel(tpost[name].mean().numpy(), jpost[name].mean(), 1e-4)
    np.testing.assert_allclose(tfe.numpy(), np.asarray(jfe), **FE_TOL)
