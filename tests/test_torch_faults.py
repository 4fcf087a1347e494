"""Faults of the PyTorch port found against the JAX package, each pinned
with both packages (or, where the JAX package cannot serve, a float64 numpy
reference):

* the program cache tells bound hyperparameters apart by value (the JAX
  package's cache keys them by name only, and returns the first program);
* a one-step chain (T = 1) plans without a transition, since step 0 applies
  none (the JAX package fails before planning);
* a deadlock that blocks a chain raises ``ValueError`` asking for an
  initialization, as the JAX package does; a chain-free deadlock takes the
  tree schedule, as in the JAX package."""

import numpy as np
import pytest
import torch

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu.models import zoo as jzoo
from rxinfer_tpu_torch.models import zoo as tzoo

TOL = dict(rtol=3e-4, atol=3e-4)   # the engine parity tests' tolerance
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def bound_transition_source(rx):
    """A two-state LGSSM whose transition A is a bound argument.  Every
    call makes a new model function, so each package's cache sees a new
    model."""
    eye = np.eye(2, dtype=np.float32)

    @rx.model
    def lgssm(y, A):
        T = len(y)
        x = rx.latent(T, name="x")
        x[0] = rx.MvNormal(mean=np.zeros(2, np.float32), cov=4.0 * eye)
        for t in rx.plate(1, T):
            x[t] = rx.MvNormal(mean=A @ x[t - 1], cov=0.5 * eye)
        for t in rx.plate(T):
            y[t] = rx.MvNormal(mean=x[t], cov=0.3 * eye)
        return {"x": x}

    return lgssm


A1 = np.array([[0.9, 0.2], [-0.1, 0.95]], np.float32)
A2 = np.array([[0.2, -0.7], [0.6, 0.1]], np.float32)


def _y(seed=0, b=3, t=12, d=2):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(
        np.float32)


def test_port_program_cache_tells_bound_values_apart():
    y = _y()
    model = bound_transition_source(trx)
    p1, _ = trx.infer_batched(model(A=A1), {"y": y}, device=CPU)
    p2, _ = trx.infer_batched(model(A=A2), {"y": y}, device=CPU)
    fresh, _ = jrx.infer_batched(bound_transition_source(jrx)(A=A2),
                                 {"y": y})
    np.testing.assert_allclose(p2["x"].mu.numpy(), np.asarray(fresh["x"].mu),
                               **TOL)
    np.testing.assert_allclose(p2["x"].sigma.numpy(),
                               np.asarray(fresh["x"].sigma), **TOL)
    assert float((p2["x"].mu - p1["x"].mu).abs().max()) > 0.1
    # the same bound values still hit the cache
    _, prog_a = trx.batched_program(model(A=A1.copy()), {"y": y}, device=CPU)
    _, prog_b = trx.batched_program(model(A=A1), {"y": y}, device=CPU)
    assert prog_a is prog_b


def test_jax_program_cache_returns_the_first_bound_values():
    """The reference's own fault, pinned: its cache keys the bound
    hyperparameters by name, so the call with A2 returns A1's posterior."""
    y = _y()
    model = bound_transition_source(jrx)
    p1, _ = jrx.infer_batched(model(A=A1), {"y": y})
    p2, _ = jrx.infer_batched(model(A=A2), {"y": y})
    fresh, _ = jrx.infer_batched(bound_transition_source(jrx)(A=A2),
                                 {"y": y})
    np.testing.assert_array_equal(np.asarray(p2["x"].mu),
                                  np.asarray(p1["x"].mu))
    assert np.abs(np.asarray(p2["x"].mu)
                  - np.asarray(fresh["x"].mu)).max() > 0.1


def _one_step_system(d, seed):
    rng = np.random.default_rng(seed)
    a = (0.9 * np.eye(d) + 0.05 * rng.standard_normal((d, d))).astype(
        np.float32)
    h = (np.eye(d) + 0.2 * rng.standard_normal((d, d))).astype(np.float32)
    q = (0.5 * np.eye(d)).astype(np.float32)
    r = (0.3 * np.eye(d) + 0.05 * np.ones((d, d))).astype(np.float32)
    m0 = rng.standard_normal(d).astype(np.float32)
    v0 = (2.0 * np.eye(d) + 0.3 * np.ones((d, d))).astype(np.float32)
    return a, q, h, r, m0, v0


@pytest.mark.parametrize("d", [1, 2, 4])
def test_one_step_chain_matches_the_closed_form_update(d):
    a, q, h, r, m0, v0 = _one_step_system(d, seed=d)
    y = np.random.default_rng(10 + d).standard_normal((5, 1, d)).astype(
        np.float32)
    post, _ = trx.infer_batched(tzoo.lgssm(a, q, h, r, m0, v0), {"y": y},
                                device=CPU)
    h64, r64, v64 = (np.asarray(x, np.float64) for x in (h, r, v0))
    prec = np.linalg.inv(v64) + h64.T @ np.linalg.solve(r64, h64)
    cov = np.linalg.inv(prec)
    eta = np.linalg.solve(v64, m0.astype(np.float64)) \
        + (h64.T @ np.linalg.solve(r64, y[:, 0].T.astype(np.float64))).T
    mu = eta @ cov.T
    assert tuple(post["x"].mu.shape) == (5, 1, d)
    np.testing.assert_allclose(post["x"].mu.numpy()[:, 0], mu, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(post["x"].sigma.numpy()[:, 0],
                               np.broadcast_to(cov, (5, d, d)), rtol=1e-4,
                               atol=1e-5)


def test_jax_fails_before_planning_a_one_step_chain():
    """The reference's own fault, pinned: the Bethe slot degrees divide by
    the empty plate's size."""
    a, q, h, r, m0, v0 = _one_step_system(2, seed=2)
    y = np.zeros((2, 1, 2), np.float32)
    with pytest.raises(ZeroDivisionError):
        jrx.infer_batched(jzoo.lgssm(a, q, h, r, m0, v0), {"y": y})


def _hmm_data(seed=3, b=2, t=12, k=3):
    idx = np.random.default_rng(seed).integers(0, k, size=(b, t))
    return np.eye(k, dtype=np.float32)[idx]


@pytest.mark.parametrize("rx,kwargs", [(trx, {"device": CPU}), (jrx, {})],
                         ids=["port", "jax"])
def test_a_blocked_chain_asks_for_an_initialization(rx, kwargs):
    with pytest.raises(ValueError, match="provide initialization") as exc:
        rx.infer_batched(rx.models.zoo.hmm(3, 3), {"y": _hmm_data()},
                         **kwargs)
    assert "'s'" in str(exc.value)


def test_a_chain_free_cycle_is_not_ported_yet():
    """No chain is blocked, so the JAX package's tree schedule runs the
    model (one plated factor over m and tau: a tree), auto-initialized from
    the priors; the port refused it until the tree schedule was ported and
    now gives the same posteriors."""
    def source(rx):
        @rx.model
        def iid(y):
            m = rx.Normal(mean=0.0, var=100.0)
            tau = rx.Gamma(shape=1.0, rate=1.0)
            for t in rx.plate(len(y)):
                y[t] = rx.Normal(mean=m, precision=tau)
            return {"m": m, "tau": tau}
        return iid

    y = np.random.default_rng(4).standard_normal((2, 5)).astype(np.float32)
    jpost, _ = jrx.infer_batched(source(jrx), {"y": y})
    assert np.all(np.isfinite(np.asarray(jpost["m"].mean())))
    tpost, _ = trx.infer_batched(source(trx), {"y": y}, device=CPU)
    for name in ("m", "tau"):
        np.testing.assert_allclose(tpost[name].mean().numpy(),
                                   np.asarray(jpost[name].mean()),
                                   rtol=1e-5, atol=1e-6)
