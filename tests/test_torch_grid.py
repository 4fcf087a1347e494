"""Grid data and grid latents over nested plates through both packages: the
models of ``tests/models/test_grid_latents.py`` and
``tests/models/test_nested_plates.py`` on ``infer`` (the port on the CPU,
the JAX package as its own tests run it), their closed forms, the same
refusals, ``infer_batched`` over a batch with missing grid cells against
the JAX package's, a grid of readings a tick on the streaming engine, and
grid-shaped posteriors carried across by ``convert``.  Inputs come from
numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu import dists as jd
from rxinfer_tpu_torch import convert
from rxinfer_tpu_torch import dists as td

CPU = torch.device("cpu")
# posteriors and free energies of one model in both packages: float32 sums
# over a grid in each library's order
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _gamma(rx, a, b):
    if rx is trx:
        return td.GammaShapeRate(torch.tensor(a), torch.tensor(b))
    return jd.GammaShapeRate(jnp.float32(a), jnp.float32(b))


def run_both(source, data, **kw):
    """The model ``source(rx)`` through ``infer`` of both packages (the last
    sweep's posteriors); ``init(rx)`` in ``kw`` builds the
    initialization."""
    init = kw.pop("init", None)
    out = []
    for rx in (trx, jrx):
        extra = dict(device="cpu") if rx is trx else {}
        out.append(rx.infer(model=source(rx), data=data,
                            returnvars=rx.KeepLast(),
                            initialization=init(rx) if init else None,
                            **kw, **extra))
    return out


def same(t, j, *names, tol=TOL):
    for name in names:
        for stat in ("mean", "var"):
            np.testing.assert_allclose(
                np.asarray(getattr(t.posteriors[name], stat)()),
                np.asarray(getattr(j.posteriors[name], stat)()), **tol)
    if j.free_energy is not None:
        np.testing.assert_allclose(np.asarray(t.free_energy),
                                   np.asarray(j.free_energy), **tol)


# -- tests/models/test_grid_latents.py ------------------------------------------------

def _exact_grid(n, m, v0=4.0, vy=1.0):
    def source(rx):
        @rx.model
        def grid(y):
            z = rx.latent((n, m), name="z")
            for i in rx.plate(n):
                for j in rx.plate(m):
                    z[i, j] = rx.Normal(mean=0.0, var=v0)
                    y[i, j] = rx.Normal(mean=z[i, j], var=vy)
            return {"z": z}
        return grid
    return source


def test_grid_latent_exact_posterior_and_evidence():
    rng = np.random.default_rng(0)
    n, m, v0, vy = 9, 6, 4.0, 1.0
    y = rng.standard_normal((n, m)).astype(np.float32)
    t, j = run_both(_exact_grid(n, m), {"y": y}, iterations=4,
                    free_energy=True)
    same(t, j, "z")
    zm = np.asarray(t.posteriors["z"].mean())
    assert zm.shape == (n, m)
    np.testing.assert_allclose(zm, y * v0 / (v0 + vy), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(t.posteriors["z"].var()),
                               np.full((n, m), v0 * vy / (v0 + vy)),
                               rtol=1e-5)
    log_z = norm.logpdf(y, 0.0, np.sqrt(v0 + vy)).sum()
    np.testing.assert_allclose(-float(t.free_energy[-1]), log_z, rtol=1e-5)


def test_grid_latent_exact_model_batched_equals_closed_form():
    """``infer_batched`` over three datasets: the grid latent's posterior
    is (B, N, M) and each dataset's FE is its own -log Z."""
    rng = np.random.default_rng(5)
    n, m, v0, vy = 4, 7, 4.0, 1.0
    y = rng.standard_normal((3, n, m)).astype(np.float32)
    post, fe = trx.infer_batched(_exact_grid(n, m)(trx), {"y": y},
                                 iterations=2, free_energy=True,
                                 device="cpu")
    assert tuple(post["z"].mean().shape) == (3, n, m)
    np.testing.assert_allclose(post["z"].mean().numpy(),
                               y * v0 / (v0 + vy), rtol=1e-5)
    log_z = norm.logpdf(y, 0.0, np.sqrt(v0 + vy)).sum(axis=(1, 2))
    np.testing.assert_allclose(-fe[-1].numpy(), log_z, rtol=1e-5)


def _hier(n, m):
    def source(rx):
        @rx.model
        def hier(y):
            tau = rx.Gamma(shape=1.0, rate=1.0)
            mu = rx.latent(n, name="mu")
            for i in rx.plate(n):
                mu[i] = rx.Normal(mean=0.0, var=100.0)
            z = rx.latent((n, m), name="z")
            for i in rx.plate(n):
                for j in rx.plate(m):
                    z[i, j] = rx.Normal(mean=mu[i], precision=1.0)
                    y[i, j] = rx.Normal(mean=z[i, j], precision=tau)
            return {"mu": mu, "z": z, "tau": tau}
        return hier
    return source


def _hier_y(rng, n, m, lead=()):
    mu = np.linspace(-2, 2, n).astype(np.float32)
    z = mu[:, None] + rng.standard_normal(lead + (n, m)).astype(np.float32)
    return (z + 0.3 * rng.standard_normal(lead + (n, m))).astype(np.float32)


def test_grid_latent_hierarchical_row_means():
    rng = np.random.default_rng(1)
    n, m = 5, 120
    y = _hier_y(rng, n, m)
    t, j = run_both(_hier(n, m), {"y": y}, iterations=30, free_energy=True,
                    init=lambda rx: {"tau": _gamma(rx, 1.0, 1.0)})
    same(t, j, "mu", "z", "tau")
    fe = t.free_energy.numpy()
    assert (np.diff(fe) <= 5e-5 * np.abs(fe[:-1]) + 1e-3).all(), fe


def test_grid_hierarchy_batched_with_missing_cells_matches_jax():
    """The hierarchy over a batch with 10% of its grid cells missing (NaN):
    ``infer_batched`` of both packages, every posterior and the FE after
    every sweep."""
    rng = np.random.default_rng(7)
    n, m, b = 4, 30, 3
    y = _hier_y(rng, n, m, lead=(b,))
    y[rng.random(y.shape) < 0.1] = np.nan
    out = []
    for rx in (trx, jrx):
        extra = dict(device="cpu") if rx is trx else {}
        out.append(rx.infer_batched(
            _hier(n, m)(rx), {"y": y}, iterations=6, free_energy=True,
            initialization={"tau": _gamma(rx, 1.0, 1.0)}, **extra))
    (tp, tfe), (jp, jfe) = out
    for name in ("mu", "z", "tau"):
        for stat in ("mean", "var"):
            np.testing.assert_allclose(
                np.asarray(getattr(tp[name], stat)()),
                np.asarray(getattr(jp[name], stat)()), **TOL)
    np.testing.assert_allclose(tfe.numpy(), np.asarray(jfe), **TOL)
    assert tuple(tp["z"].mean().shape) == (b, n, m)


def test_grid_latent_requires_full_index():
    def source(rx):
        @rx.model
        def bad(y):
            z = rx.latent((3, 4), name="z")
            for i in rx.plate(3):
                for j in rx.plate(4):
                    z[i, j] = rx.Normal(mean=0.0, var=1.0)
            for i in rx.plate(3):
                y[i] = rx.Normal(mean=z[i], var=1.0)   # a partial index
        return bad

    y = np.zeros(3, np.float32)
    for rx in (trx, jrx):
        with pytest.raises(TypeError, match="indexed"):
            rx.infer(model=source(rx), data={"y": y}, iterations=1,
                     **(dict(device="cpu") if rx is trx else {}))


def test_grid_latent_lagged_reference_rejected():
    def source(rx):
        @rx.model
        def bad(y):
            z = rx.latent((3, 4), name="z")
            for i in rx.plate(3):
                for j in rx.plate(1, 4):
                    z[i, j] = rx.Normal(mean=0.0, var=1.0)   # partial plate
            for i in rx.plate(3):
                for j in rx.plate(4):
                    y[i, j] = rx.Normal(mean=z[i, j], var=1.0)
        return bad

    y = np.zeros((3, 4), np.float32)
    for rx in (trx, jrx):
        with pytest.raises(NotImplementedError, match="full plates"):
            rx.infer(model=source(rx), data={"y": y}, iterations=1,
                     **(dict(device="cpu") if rx is trx else {}))


def test_grid_index_must_follow_the_plate_nesting():
    """A transposed grid index ``y[j, i]`` is refused in both packages."""
    def source(rx):
        @rx.model
        def bad(y):
            mu = rx.Normal(mean=0.0, var=1.0)
            for i in rx.plate(3):
                for j in rx.plate(3):
                    y[j, i] = rx.Normal(mean=mu, var=1.0)
        return bad

    y = np.zeros((3, 3), np.float32)
    for rx in (trx, jrx):
        with pytest.raises(ValueError, match="nesting order"):
            source(rx).trace({"y": y})


# -- tests/models/test_nested_plates.py -----------------------------------------------

def test_grid_iid_matches_flat_model():
    rng = np.random.default_rng(0)
    n, m = 12, 7
    y = (1.5 + 0.7 * rng.standard_normal((n, m))).astype(np.float32)

    def grid(rx):
        @rx.model
        def g(y):
            mu = rx.Normal(mean=0.0, var=100.0)
            tau = rx.Gamma(shape=0.01, rate=0.01)
            for i in rx.plate(n):
                for j in rx.plate(m):
                    y[i, j] = rx.Normal(mean=mu, precision=tau)
            return {"mu": mu, "tau": tau}
        return g

    def flat(rx):
        @rx.model
        def f(y):
            mu = rx.Normal(mean=0.0, var=100.0)
            tau = rx.Gamma(shape=0.01, rate=0.01)
            for i in rx.plate(n * m):
                y[i] = rx.Normal(mean=mu, precision=tau)
            return {"mu": mu, "tau": tau}
        return f

    kw = dict(iterations=15, free_energy=True,
              init=lambda rx: {"tau": _gamma(rx, 1.0, 1.0)})
    t, j = run_both(grid, {"y": y}, **kw)
    same(t, j, "mu", "tau")
    tf = trx.infer(model=flat(trx), data={"y": y.reshape(-1)},
                   returnvars=trx.KeepLast(), iterations=15,
                   free_energy=True,
                   initialization={"tau": _gamma(trx, 1.0, 1.0)},
                   device="cpu")
    for name in ("mu", "tau"):
        np.testing.assert_allclose(float(t.posteriors[name].mean()),
                                   float(tf.posteriors[name].mean()),
                                   rtol=1e-6)
    np.testing.assert_allclose(t.free_energy.numpy(), tf.free_energy.numpy(),
                               rtol=1e-5)


def test_grid_row_means_shared_precision():
    rng = np.random.default_rng(1)
    n, m = 6, 200
    rows = np.linspace(-3.0, 3.0, n).astype(np.float32)
    y = (rows[:, None] + 0.5 * rng.standard_normal((n, m))).astype(np.float32)

    def source(rx):
        @rx.model
        def r(y):
            tau = rx.Gamma(shape=0.01, rate=0.01)
            mu = rx.latent(n, name="mu")
            for i in rx.plate(n):
                mu[i] = rx.Normal(mean=0.0, var=100.0)
            for i in rx.plate(n):
                for j in rx.plate(m):
                    y[i, j] = rx.Normal(mean=mu[i], precision=tau)
            return {"mu": mu, "tau": tau}
        return r

    t, j = run_both(source, {"y": y}, iterations=20, free_energy=True,
                    init=lambda rx: {"tau": _gamma(rx, 1.0, 1.0)})
    same(t, j, "mu", "tau")
    np.testing.assert_allclose(t.posteriors["mu"].mean().numpy(),
                               y.mean(axis=1), atol=0.05)
    assert abs(float(t.posteriors["tau"].mean()) - 4.0) < 0.5


def test_grid_column_effects():
    rng = np.random.default_rng(2)
    n, m = 300, 5
    col = np.array([2.0, -1.0, 0.5, 3.0, -2.5], np.float32)
    y = (col[None, :] + rng.standard_normal((n, m))).astype(np.float32)

    def source(rx):
        @rx.model
        def c(y):
            beta = rx.latent(m, name="beta")
            for j in rx.plate(m):
                beta[j] = rx.Normal(mean=0.0, var=100.0)
            for i in rx.plate(n):
                for j in rx.plate(m):
                    y[i, j] = rx.Normal(mean=beta[j], precision=1.0)
            return {"beta": beta}
        return c

    t, j = run_both(source, {"y": y}, iterations=5, free_energy=True)
    same(t, j, "beta")
    np.testing.assert_allclose(t.posteriors["beta"].mean().numpy(),
                               y.mean(axis=0), atol=0.01)


def test_grid_missing_data_mask():
    rng = np.random.default_rng(3)
    n, m = 10, 8
    y = (0.8 + rng.standard_normal((n, m))).astype(np.float32)
    y[1, 2] = y[7, 5] = y[4, 0] = np.nan

    def grid(rx):
        @rx.model
        def g(y):
            mu = rx.Normal(mean=0.0, var=100.0)
            for i in rx.plate(n):
                for j in rx.plate(m):
                    y[i, j] = rx.Normal(mean=mu, var=1.0)
            return {"mu": mu}
        return g

    def flat(rx):
        @rx.model
        def f(y):
            mu = rx.Normal(mean=0.0, var=100.0)
            for i in rx.plate(n * m - 3):
                y[i] = rx.Normal(mean=mu, var=1.0)
            return {"mu": mu}
        return f

    t, j = run_both(grid, {"y": y}, iterations=3, free_energy=True)
    same(t, j, "mu")
    obs = y[np.isfinite(y)].astype(np.float32)
    tf = trx.infer(model=flat(trx), data={"y": obs}, iterations=3,
                   returnvars=trx.KeepLast(), free_energy=True, device="cpu")
    for stat in ("mean", "var"):
        np.testing.assert_allclose(
            float(getattr(t.posteriors["mu"], stat)()),
            float(getattr(tf.posteriors["mu"], stat)()), rtol=1e-6)
    np.testing.assert_allclose(t.free_energy.numpy(), tf.free_energy.numpy(),
                               rtol=1e-5)


def _cube(a, b, c):
    def source(rx):
        @rx.model
        def cube(y):
            theta = rx.Beta(1.0, 1.0)
            for i in rx.plate(a):
                for j in rx.plate(b):
                    for k in rx.plate(c):
                        y[i, j, k] = rx.Bernoulli(theta)
            return {"theta": theta}
        return cube
    return source


def test_grid_beta_bernoulli_three_axes():
    rng = np.random.default_rng(4)
    a, b, c = 4, 5, 6
    y = (rng.random((a, b, c)) < 0.3).astype(np.float32)
    t, j = run_both(_cube(a, b, c), {"y": y}, iterations=1, free_energy=True)
    same(t, j, "theta")
    exact = (1.0 + y.sum()) / (2.0 + a * b * c)
    np.testing.assert_allclose(float(t.posteriors["theta"].mean()), exact,
                               rtol=1e-5)


def test_grid_latent_not_supported_error():
    def source(rx):
        @rx.model
        def bad(y):
            tau = rx.Gamma(shape=1.0, rate=1.0)
            for i in rx.plate(3):
                for j in rx.plate(4):
                    z = rx.Normal(mean=0.0, var=1.0)
                    y[i, j] = rx.Normal(mean=z, precision=tau)
        return bad

    y = np.zeros((3, 4), np.float32)
    for rx in (trx, jrx):
        with pytest.raises(NotImplementedError, match="latent"):
            rx.infer(model=source(rx), data={"y": y}, iterations=1,
                     **(dict(device="cpu") if rx is trx else {}))


# -- convert.py --------------------------------------------------------------------------

def test_grid_posteriors_cross_between_packages():
    """A grid-shaped posterior, (N, M) leading axes, carried from the JAX
    package to the port and back as numpy fields."""
    rng = np.random.default_rng(11)
    q = jd.NormalMeanVariance(jnp.asarray(rng.standard_normal((3, 4)),
                                          jnp.float32),
                              jnp.asarray(rng.random((3, 4)) + 0.5,
                                          jnp.float32))
    t = convert.dist_from_numpy(
        "NormalMeanVariance", [np.asarray(q.mu), np.asarray(q.v)])
    family, fields = convert.dist_to_numpy(t)
    assert family == "NormalMeanVariance"
    back = jd.NormalMeanVariance(*[jnp.asarray(fields[k]) for k in ("mu", "v")])
    np.testing.assert_array_equal(np.asarray(back.mu), np.asarray(q.mu))
    np.testing.assert_array_equal(np.asarray(back.v), np.asarray(q.v))
    assert fields["mu"].shape == (3, 4)


# -- the streaming engine ------------------------------------------------------------------

def test_streaming_tick_over_a_grid_of_readings_like_jax():
    """A tick observes a (N, M) grid of readings of one level mu, its prior
    autoupdated from its posterior: the engine's tick program runs the grid
    factor's plain group; tick by tick against the JAX engine and the
    closed form after T ticks."""
    rng = np.random.default_rng(21)
    t_len, n, m = 6, 3, 4
    ys = (1.2 + rng.standard_normal((t_len, n, m))).astype(np.float32)

    def source(rx):
        @rx.model
        def tick(y, pm, pv):
            mu = rx.Normal(mean=pm, var=pv)
            for i in rx.plate(n):
                for j in rx.plate(m):
                    y[i, j] = rx.Normal(mean=mu, var=1.0)
            return {"mu": mu}
        return tick

    au = dict(initial={"pm": 0.0, "pv": 100.0},
              pm=lambda q: q["mu"].mean(), pv=lambda q: q["mu"].var())
    tposts, _ = trx.RxInferenceEngine(
        source(trx), trx.autoupdates(**au), device=CPU).run_offline({"y": ys})
    jposts, _ = jrx.RxInferenceEngine(
        source(jrx), jrx.autoupdates(**au)).run_offline({"y": ys})
    for stat in ("mean", "var"):
        np.testing.assert_allclose(
            np.asarray(getattr(tposts["mu"], stat)()),
            np.asarray(getattr(jposts["mu"], stat)()), **TOL)
    w = 0.01 + ys.size
    np.testing.assert_allclose(float(tposts["mu"].var()[-1]), 1.0 / w,
                               rtol=1e-5)
    np.testing.assert_allclose(float(tposts["mu"].mean()[-1]),
                               ys.astype(np.float64).sum() / w, rtol=1e-5)
