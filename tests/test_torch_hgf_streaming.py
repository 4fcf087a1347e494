"""The online HGF on the streaming engine (ROADMAP A6c) through both
packages on the CPU: tests/models/test_hgf_streaming.py's single-step GCV
tick (``chip_smoke.hgfs_model``) over a few streams in lockstep
(``batched=True``; the JAX engine takes it too) with the reference
constraint q(xt, zt, xt_min) = q(xt, xt_min)q(zt) passed explicitly, the
cavity stores carried from tick to tick; the constraint as a no-op, bit for
bit; the reference's envelope and free-energy checks of
tests/models/test_joint_pairs.py:139-154 on stream 0; ``MeanField()`` on
the same tick.  Streams from ``chip_smoke.hgfs_data`` (stream 0 the JAX
test's seed-42 series); the port runs with ``device="cpu"``."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu import dists as jd
from rxinfer_tpu_torch import dists as td

CPU = torch.device("cpu")
B, T = 3, 30
# posteriors after a tick's sweeps, relative to the largest value (the
# GCV pair feeds each sweep's float32 rounding to the next: measured on a
# CPU at up to 1.3e-6)
POST_TOL = 1e-4
# free energies: the Gaussian nodes' average energy E[(out - mean)^2] is
# E[out^2] - 2 E[out] mean + mean^2 in both packages, which cancels at
# |y| ~ 9 down to ~1e-5 and is then divided by a variance of ~0.01: each
# package's float32 term is ~3.5e-4 off its float64 value at such a state
# (two such terms), so the packages differ by up to ~1.1e-3 (measured on a
# CPU) where their posteriors agree to 1e-6
FE_TOL = dict(rtol=1e-4, atol=2e-3)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tdist(m, v):
    return td.NormalMeanVariance(torch.tensor(m), torch.tensor(v))


def _jdist(m, v):
    return jd.NormalMeanVariance(np.float32(m), np.float32(v))


def _run(rx, y, constrained=True, factorization=None):
    kw = cs.hgfs_engine_kw(rx, y.shape[1], _jdist if rx is jrx else _tdist,
                           constrained)
    if factorization is not None:
        kw["constraints"] = rx.constraints(factorization=factorization)
    eng = rx.infer(model=cs.hgfs_model(rx), datastream=None,
                   **({} if rx is jrx else {"device": CPU}), **kw)
    posts, fes = eng.run_offline({"y": y})
    return eng, {n: (np.asarray(posts[n].mean()), np.asarray(posts[n].var()))
                 for n in ("xt", "zt")}, np.asarray(fes)


@pytest.fixture(scope="module")
def fleet():
    z, x, y = cs.hgfs_data(B, T)
    return z, x, y, _run(trx, y), _run(jrx, y)


def test_online_hgf_fleet_matches_jax(fleet):
    *_, (_, tpost, tfe), (_, jpost, jfe) = fleet
    for n in ("xt", "zt"):
        for got, want in zip(tpost[n], jpost[n]):
            assert got.shape == (T, B)
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= POST_TOL, (n, err)
    assert tfe.shape == (T, B, cs.HGFS_IT)
    np.testing.assert_allclose(tfe, jfe, **FE_TOL)


def test_cavity_stores_carry_from_tick_to_tick(fleet):
    """The (out, mean) and GCV (out, in) stores are state entries
    ``_msg:<factor id>:<interface>`` with the batch axis, carried to the
    next tick with the marginals (``on_next`` ticks, as a datastream's)."""
    y = fleet[2]
    eng = trx.infer(model=cs.hgfs_model(trx), datastream=None, device=CPU,
                    **cs.hgfs_engine_kw(trx, B, _tdist))
    eng.on_next({"y": y[0]})
    first = {k for k in eng._carry[0] if k.startswith("_msg:")}
    eng.on_next({"y": y[1]})
    stores = {k: v for k, v in eng._carry[0].items()
              if k.startswith("_msg:")}
    assert set(stores) == first and len(stores) >= 4
    assert any(k.endswith(":in") for k in stores)      # the GCV pair's
    assert all(v.mean().shape[0] == B for v in stores.values())


def test_the_reference_constraint_is_a_noop_bit_for_bit(fleet):
    """q(xt, zt, xt_min) = q(xt, xt_min)q(zt) splits no factor's cluster:
    the same program, the same bits, as without it."""
    *_, y, (eng, tpost, tfe), _ = fleet
    assert eng._compiled.mf_factor_ids == set()
    _, post, fe = _run(trx, y, constrained=False)
    for n in ("xt", "zt"):
        for got, want in zip(post[n], tpost[n]):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(fe, tfe)


def test_reference_envelopes_on_stream_zero(fleet):
    z, x, _, (_, post, fe), _ = fleet
    ref = cs.hgfs_reference_checks(
        z[:, 0], x[:, 0], {n: (p[0][:, 0], p[1][:, 0])
                           for n, p in post.items()}, fe[:, 0])
    assert ref["ok"], ref


def test_mean_field_tick_matches_jax():
    """MeanField() splits the GCV pair and the Gaussian links: the
    mean-field rules on every tick, against the JAX engine."""
    _, _, y = cs.hgfs_data(B, 20)
    _, tpost, tfe = _run(trx, y, factorization=trx.MeanField())
    _, jpost, jfe = _run(jrx, y, factorization=jrx.MeanField())
    for n in ("xt", "zt"):
        for got, want in zip(tpost[n], jpost[n]):
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= POST_TOL, (n, err)
    np.testing.assert_allclose(tfe, jfe, **FE_TOL)
