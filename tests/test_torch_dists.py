"""Parity of the PyTorch port's distribution substrate with the JAX package:
Gaussian natural-parameter products, the zero-natural identity, pd_inverse /
pd_logdet, the zero-precision mean guard and the entry-wise Schur inverse.
Inputs come from a numpy seed and cross between the packages as numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rxinfer_tpu.dists as jd
import rxinfer_tpu_torch.dists as td
from rxinfer_tpu.ops import entrywise as jew
from rxinfer_tpu.ops import smallmat as jsm
from rxinfer_tpu_torch import convert
from rxinfer_tpu_torch.dists import natural as tnat
from rxinfer_tpu_torch.ops import entrywise as tew
from rxinfer_tpu_torch.ops import smallmat as tsm

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _spd(rng, batch, d, scale=1.0):
    a = rng.standard_normal(batch + (d, d))
    return (scale * (a @ np.swapaxes(a, -1, -2) + d * np.eye(d))).astype(np.float32)


def _mv_params(family, rng, batch, d):
    m = rng.standard_normal(batch + (d,)).astype(np.float32)
    return [m, _spd(rng, batch, d)]


def _scalar_params(family, rng, batch):
    return [rng.standard_normal(batch).astype(np.float32),
            (0.5 + rng.random(batch)).astype(np.float32)]


MV = ["MvNormalMeanCovariance", "MvNormalMeanPrecision",
      "MvNormalWeightedMeanPrecision"]
SCALAR = ["NormalMeanVariance", "NormalMeanPrecision",
          "NormalWeightedMeanPrecision"]


def _both(family, params):
    j = getattr(jd, family)(*[jnp.asarray(p) for p in params])
    t = convert.dist_from_numpy(family, params)
    return j, t


@pytest.mark.parametrize("fa", MV)
@pytest.mark.parametrize("fb", MV)
def test_mv_gaussian_product_matches_jax(fa, fb):
    rng = np.random.default_rng(0)
    ja, ta = _both(fa, _mv_params(fa, rng, (5,), 3))
    jb, tb = _both(fb, _mv_params(fb, rng, (5,), 3))
    jp, tp = jd.prod(ja, jb), td.prod(ta, tb)
    assert type(tp).__name__ == type(jp).__name__
    np.testing.assert_allclose(tp.xi.numpy(), np.asarray(jp.xi), **TOL)
    np.testing.assert_allclose(tp.w.numpy(), np.asarray(jp.w), **TOL)
    np.testing.assert_allclose(tp.mean().numpy(), np.asarray(jp.mean()),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tp.cov().numpy(), np.asarray(jp.cov()),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fa", SCALAR)
@pytest.mark.parametrize("fb", SCALAR)
def test_scalar_gaussian_product_matches_jax(fa, fb):
    rng = np.random.default_rng(1)
    ja, ta = _both(fa, _scalar_params(fa, rng, (7,)))
    jb, tb = _both(fb, _scalar_params(fb, rng, (7,)))
    jp, tp = jd.prod(ja, jb), td.prod(ta, tb)
    np.testing.assert_allclose(tp.xi.numpy(), np.asarray(jp.xi), **TOL)
    np.testing.assert_allclose(tp.w.numpy(), np.asarray(jp.w), **TOL)
    np.testing.assert_allclose(tp.mean().numpy(), np.asarray(jp.mean()), **TOL)


@pytest.mark.parametrize("family", MV + SCALAR)
def test_zero_natural_is_the_product_identity(family):
    rng = np.random.default_rng(2)
    params = (_mv_params(family, rng, (4,), 3) if family.startswith("Mv")
              else _scalar_params(family, rng, (4,)))
    _, t = _both(family, params)
    key = tnat.family_key(t)
    zero = tnat.from_natural(key, tuple(torch.zeros_like(n)
                                        for n in tnat.to_natural(t)))
    for prod in (tnat.prod_all([t, zero]), td.prod(zero, t)):
        for a, b in zip(tnat.to_natural(prod), tnat.to_natural(t)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_nat_div_inverts_the_product():
    rng = np.random.default_rng(3)
    _, ta = _both("MvNormalMeanCovariance", _mv_params("", rng, (6,), 4))
    _, tb = _both("MvNormalMeanPrecision", _mv_params("", rng, (6,), 4))
    back = tnat.nat_div(tnat.prod_all([ta, tb]), tb)
    np.testing.assert_allclose(back.mean().numpy(), ta.mean().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 8, 12, 16])
def test_pd_inverse_and_logdet_match_jax(d):
    rng = np.random.default_rng(10 + d)
    m = _spd(rng, (9,), d, scale=0.3)
    m[0] *= 1e10  # vague scale: the mean-|diag| normalization keeps fp32 range
    np.testing.assert_allclose(
        td.pd_inverse(torch.as_tensor(m)).numpy(),
        np.asarray(jd.pd_inverse(jnp.asarray(m))), rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(
        td.pd_logdet(torch.as_tensor(m)).numpy(),
        np.asarray(jd.pd_logdet(jnp.asarray(m))), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("d", [2, 3, 4, 7])
def test_small_inv_general_matrix_matches_jax(d):
    rng = np.random.default_rng(20 + d)
    m = (rng.standard_normal((6, d, d)) + 3 * np.eye(d)).astype(np.float32)
    np.testing.assert_allclose(tsm.small_inv(torch.as_tensor(m)).numpy(),
                               np.asarray(jsm.small_inv(jnp.asarray(m))),
                               rtol=1e-5, atol=1e-6)


def test_mean_at_zero_precision_is_zero():
    xi = np.zeros((2, 3), np.float32)
    w = np.zeros((2, 3, 3), np.float32)
    j = jd.MvNormalWeightedMeanPrecision(jnp.asarray(xi), jnp.asarray(w))
    t = td.MvNormalWeightedMeanPrecision(torch.as_tensor(xi), torch.as_tensor(w))
    np.testing.assert_array_equal(t.mean().numpy(), np.asarray(j.mean()))
    assert np.all(t.mean().numpy() == 0.0)
    s = td.NormalWeightedMeanPrecision(torch.zeros(4), torch.zeros(4))
    assert torch.all(s.mean() == 0.0)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 8])
def test_entrywise_sym_inv_scaled_matches_jax(d):
    rng = np.random.default_rng(30 + d)
    m = _spd(rng, (11,), d)
    je = [[jnp.asarray(m[:, i, j]) for j in range(d)] for i in range(d)]
    te = [[torch.as_tensor(m[:, i, j]) for j in range(d)] for i in range(d)]
    ji, ti = jew.sym_inv_scaled(je), tew.sym_inv_scaled(te)
    for i in range(d):
        for j in range(d):
            np.testing.assert_allclose(ti[i][j].numpy(), np.asarray(ji[i][j]),
                                       rtol=1e-6, atol=1e-7)


def test_dist_from_numpy_takes_jax_fields():
    rng = np.random.default_rng(4)
    mu, sigma = _mv_params("", rng, (3,), 2)
    j = jd.MvNormalMeanCovariance(jnp.asarray(mu), jnp.asarray(sigma))
    t = convert.dist_from_numpy(
        "MvNormalMeanCovariance",
        {"mu": np.asarray(j.mu), "sigma": np.asarray(j.sigma)})
    np.testing.assert_array_equal(t.sigma.numpy(), sigma)
    # a family without a counterpart in the port
    with pytest.raises(NotImplementedError):
        convert.dist_from_numpy("JointGaussian", [np.zeros(2), np.eye(2)])
