"""The PyTorch port's precision families and the per-chain-parameter
smoother (V1) against the JAX package: ``GammaShapeRate``, ``Wishart`` and
its inverse-scale carrier, their natural-parameter views with leading batch
axes, the conjugate ``message_to_prec`` rules and the precision priors,
and the plain versions of K1/K2 with per-chain W and Q against the JAX
package's ``fused_batched_smoother(w_batch=, q_batch=)`` in interpret mode
(as its own tests run it on the CPU) and against the port's static plain
version.  Inputs come from a numpy seed and cross between the packages as
numpy.  The CUDA kernels are held against the same plain versions by the
``gpu``-marked test below and by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rxinfer_tpu.dists as jd
import rxinfer_tpu_torch.dists as td
from rxinfer_tpu.dists import natural as jnat
from rxinfer_tpu.dists.matrix import _mv_digamma as j_mv_digamma
from rxinfer_tpu.dists.matrix import _mv_gammaln as j_mv_gammaln
from rxinfer_tpu.ops.pallas_smoother import (
    fused_batched_smoother as jax_fused_batched_smoother,
)
from rxinfer_tpu.rules import expectations as jexp
from rxinfer_tpu.rules.registry import get_message_rule as jrule
from rxinfer_tpu_torch.dists import natural as tnat
from rxinfer_tpu_torch.dists.matrix import _mv_digamma as t_mv_digamma
from rxinfer_tpu_torch.dists.matrix import _mv_gammaln as t_mv_gammaln
from rxinfer_tpu_torch.ops import fused_smoother as fs
from rxinfer_tpu_torch.rules import expectations as texp
from rxinfer_tpu_torch.rules.registry import get_message_rule as trule

# Float32 in two libraries: digamma / lgamma and the closed-form inverses
# round differently in the last bits.
TOL = dict(rtol=1e-5, atol=1e-5)
# The smoother's tolerance against the JAX Pallas kernels
# (tests/test_torch_smoother.py).
SMOOTH_TOL = dict(rtol=3e-4, atol=3e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _spd(rng, batch, d, scale=1.0):
    a = rng.standard_normal(batch + (d, d))
    return (scale * (a @ np.swapaxes(a, -1, -2) / d + np.eye(d))).astype(
        np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# -- families -------------------------------------------------------------------------

def test_gamma_statistics_and_product_match_jax():
    rng = np.random.default_rng(0)
    a = (0.5 + 3 * rng.random(6)).astype(np.float32)
    b = (0.2 + 2 * rng.random(6)).astype(np.float32)
    j, t = jd.GammaShapeRate(jnp.asarray(a), jnp.asarray(b)), \
        td.GammaShapeRate(_t(a), _t(b))
    for name in ("mean", "var", "mean_log", "entropy"):
        _close(getattr(t, name)(), getattr(j, name)())
    j2 = jd.GammaShapeRate(jnp.asarray(b + 1.0), jnp.asarray(a))
    t2 = td.GammaShapeRate(_t(b + 1.0), _t(a))
    jp, tp = jd.prod(j, j2), td.prod(t, t2)
    _close(tp.a, jp.a)
    _close(tp.b, jp.b)
    v, jv = td.GammaShapeRate.vague(), jd.GammaShapeRate.vague()
    assert float(v.a) == float(jv.a) and float(v.b) == float(jv.b)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_wishart_statistics_and_product_match_jax(d):
    rng = np.random.default_rng(d)
    nu = (d + 1.0 + 5 * rng.random(3)).astype(np.float32)
    s = _spd(rng, (3,), d)
    j, t = jd.Wishart(jnp.asarray(nu), jnp.asarray(s)), \
        td.Wishart(_t(nu), _t(s))
    for name in ("mean", "mean_logdet", "entropy"):
        _close(getattr(t, name)(), getattr(j, name)())
    s2 = _spd(rng, (3,), d, 0.5)
    jp = jd.prod(j, jd.Wishart(jnp.asarray(nu + 2.0), jnp.asarray(s2)))
    tp = td.prod(t, td.Wishart(_t(nu + 2.0), _t(s2)))
    _close(tp.nu, jp.nu)
    _close(tp.s, jp.s)
    ji = jd.WishartInverseScale(jnp.asarray(nu), jnp.asarray(s))
    ti = td.WishartInverseScale(_t(nu), _t(s))
    _close(ti.mean(), ji.mean())
    _close(ti.to_wishart().s, ji.to_wishart().s)
    v = td.Wishart.vague(d)
    assert float(v.nu) == d
    _close(v.s, jd.Wishart.vague(d).s, dict(rtol=1e-6, atol=0))


@pytest.mark.parametrize("d", [1, 3])
def test_mv_gammaln_and_digamma_match_jax(d):
    a = np.linspace(d + 0.5, 40.0, 7).astype(np.float32)
    _close(t_mv_gammaln(d, _t(a)), j_mv_gammaln(d, jnp.asarray(a)))
    _close(t_mv_digamma(d, _t(a)), j_mv_digamma(d, jnp.asarray(a)))


# -- natural-parameter views with batch axes -----------------------------------------

def _gamma_pair(rng, shape):
    a = (0.5 + 3 * rng.random(shape)).astype(np.float32)
    b = (0.2 + 2 * rng.random(shape)).astype(np.float32)
    return (jd.GammaShapeRate(jnp.asarray(a), jnp.asarray(b)),
            td.GammaShapeRate(_t(a), _t(b)))


def _wishart_pair(rng, shape, d, carrier=False):
    nu = (d + 2.0 + rng.random(shape)).astype(np.float32)
    s = _spd(rng, shape, d)
    jcls, tcls = ((jd.WishartInverseScale, td.WishartInverseScale) if carrier
                  else (jd.Wishart, td.Wishart))
    return jcls(jnp.asarray(nu), jnp.asarray(s)), tcls(_t(nu), _t(s))


def _leaves_close(tdist, jdist):
    for a, b in zip(tnat.to_natural(tdist), jnat.to_natural(jdist)):
        _close(a, b)


@pytest.mark.parametrize("family", ["gamma", "wishart", "wishart_carrier"])
def test_natural_views_match_jax(family):
    rng = np.random.default_rng(7)
    make = {"gamma": lambda sh: _gamma_pair(rng, sh),
            "wishart": lambda sh: _wishart_pair(rng, sh, 3),
            "wishart_carrier": lambda sh: _wishart_pair(rng, sh, 3, True)}[
        family]
    key = "gamma" if family == "gamma" else "wishart"
    j1, t1 = make((2,))
    j2, t2 = make((2,))
    assert tnat.family_key(t1) == key
    _leaves_close(t1, j1)
    # the product of messages and the round trip through the view
    _leaves_close(tnat.prod_all([t1, t2]), jnat.prod_all([j1, j2]))
    back = tnat.from_natural(key, tnat.to_natural(t1))
    _leaves_close(back, j1)
    # a plate of 5 messages over a batch of 2: the port reduces over the
    # axis after the batch, the JAX package (under vmap) per batch element
    jp, tp = make((2, 5))
    red = tnat.prod_reduce(tp, 5, batch_ndim=1)
    pad = tnat.pad_plate(tp, 1, 6, 8, batch_ndim=1)
    for i in range(2):
        ji = jnat.from_natural(key, tuple(n[i] for n in jnat.to_natural(jp)))
        for a, b in zip(tnat.to_natural(red), jnat.to_natural(
                jnat.prod_reduce(ji, 5))):
            _close(a[i], b)
        for a, b in zip(tnat.to_natural(pad), jnat.to_natural(
                jnat.pad_plate(ji, 1, 6, 8))):
            _close(a[i], b)


# -- rules ------------------------------------------------------------------------------

def _scalar_marginal(rng, shape):
    m = rng.standard_normal(shape).astype(np.float32)
    v = (0.2 + rng.random(shape)).astype(np.float32)
    return (jd.NormalMeanVariance(jnp.asarray(m), jnp.asarray(v)),
            td.NormalMeanVariance(_t(m), _t(v)))


def _mv_marginal(rng, shape, d):
    m = rng.standard_normal(shape + (d,)).astype(np.float32)
    s = _spd(rng, shape, d, 0.3)
    return (jd.MvNormalMeanCovariance(jnp.asarray(m), jnp.asarray(s)),
            td.MvNormalMeanCovariance(_t(m), _t(s)))


def _point(a):
    return jd.PointMass(jnp.asarray(a)), td.PointMass(_t(a))


def _msg_close(tmsg, jmsg):
    assert type(tmsg).__name__ == type(jmsg).__name__
    _leaves_close(tmsg, jmsg)


@pytest.mark.parametrize("joint", [False, True])
def test_scalar_message_to_prec_matches_jax(joint):
    rng = np.random.default_rng(11)
    jo, to = _scalar_marginal(rng, (3, 6))
    jm, tm = _scalar_marginal(rng, (3, 6))
    jq = {"out": jo, "mean": jm}
    tq = {"out": to, "mean": tm}
    _msg_close(trule("NormalMeanPrecision", "prec")(tq),
               jrule("NormalMeanPrecision", "prec")(jq))
    ja, ta = _point(np.float32(0.8))
    jb, tb = _point(np.float32(0.1))
    jq = {"out": jo, "in": jm, "A": ja, "b": jb}
    tq = {"out": to, "in": tm, "A": ta, "b": tb}
    if joint:
        c = (0.05 * rng.standard_normal((3, 6))).astype(np.float32)
        jq["joint"], tq["joint"] = jnp.asarray(c), _t(c)
    _msg_close(trule("LinearGaussianPrecision", "prec")(tq),
               jrule("LinearGaussianPrecision", "prec")(jq))


@pytest.mark.parametrize("joint", [False, True])
def test_mv_message_to_prec_matches_jax(joint):
    rng = np.random.default_rng(12)
    d = 3
    jo, to = _mv_marginal(rng, (2, 5), d)
    jm, tm = _mv_marginal(rng, (2, 5), d)
    _msg_close(trule("MvNormalMeanPrecision", "prec")({"out": to, "mean": tm}),
               jrule("MvNormalMeanPrecision", "prec")({"out": jo, "mean": jm}))
    ja, ta = _point((0.9 * np.eye(d)
                     + 0.1 * rng.standard_normal((d, d))).astype(np.float32))
    jb, tb = _point((0.1 * np.arange(d)).astype(np.float32))
    jq = {"out": jo, "in": jm, "A": ja, "b": jb}
    tq = {"out": to, "in": tm, "A": ta, "b": tb}
    if joint:
        c = (0.05 * rng.standard_normal((2, 5, d, d))).astype(np.float32)
        jq["joint"], tq["joint"] = jnp.asarray(c), _t(c)
    _msg_close(trule("MvLinearGaussianPrecision", "prec")(tq),
               jrule("MvLinearGaussianPrecision", "prec")(jq))


def test_precision_priors_and_expectations_match_jax():
    rng = np.random.default_rng(13)
    js, ts = _point(np.float32(2.5))
    jr, tr = _point(np.float32(0.7))
    _msg_close(trule("GammaShapeRate", "out")({"shape": ts, "rate": tr}),
               jrule("GammaShapeRate", "out")({"shape": js, "rate": jr}))
    jn, tn = _point(np.float32(4.0))
    jS, tS = _point(_spd(rng, (), 3))
    _msg_close(trule("Wishart", "out")({"nu": tn, "S": tS}),
               jrule("Wishart", "out")({"nu": jn, "S": jS}))
    jg, tg = _gamma_pair(rng, (4,))
    jw, tw = _wishart_pair(rng, (4,), 3)
    jc, tc = _wishart_pair(rng, (4,), 3, carrier=True)
    for jdist, tdist in ((jg, tg), (jw, tw), (jc, tc), (jS, tS)):
        _close(texp.e_precision(tdist), jexp.e_precision(jdist))
    jo, to = _scalar_marginal(rng, (4,))
    _close(texp.e_sq(to), jexp.e_sq(jo))


# -- V1: the smoother's plain versions with per-chain W and Q -------------------------

MODES = ["W", "Q", "WQ"]


def _system(b, d, t, seed):
    rng = np.random.default_rng(seed)
    qm, _ = np.linalg.qr(rng.standard_normal((d, d)))
    f = (0.97 * qm).astype(np.float32)
    bvec = (0.1 * np.arange(d)).astype(np.float32)
    q = _spd(rng, (), d, 0.4)
    w = _spd(rng, (), d, 0.8)
    xi = rng.standard_normal((t, b, d)).astype(np.float32)
    m0 = rng.standard_normal((b, d)).astype(np.float32)
    p0 = np.broadcast_to(9.0 * np.eye(d, dtype=np.float32), (b, d, d)).copy()
    wb = _spd(rng, (b,), d, 0.8)
    qb = _spd(rng, (b,), d, 0.4)
    return m0, p0, xi, f, bvec, q, w, wb, qb


def _mode_args(mode, q, w, wb, qb):
    """(shared Q, shared W, per-chain W, per-chain Q) of a mode."""
    return (None if "Q" in mode else q, None if "W" in mode else w,
            wb if "W" in mode else None, qb if "Q" in mode else None)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d,b,t", [(1, 5, 11), (2, 4, 9), (4, 3, 10)])
def test_per_chain_plain_version_matches_jax_pallas(mode, d, b, t):
    m0, p0, xi, f, bvec, q, w, wb, qb = _system(b, d, t, seed=20 + d)
    q_sh, w_sh, w_b, q_b = _mode_args(mode, q, w, wb, qb)
    got = fs.fused_batched_smoother(
        _t(m0), _t(p0), _t(xi), f, bvec, q_sh, w_sh,
        w_batch=None if w_b is None else _t(w_b),
        q_batch=None if q_b is None else _t(q_b))
    want = jax_fused_batched_smoother(
        jnp.asarray(m0), jnp.asarray(p0), jnp.asarray(xi), f, bvec, q_sh,
        w_sh, interpret=True,
        w_batch=None if w_b is None else jnp.asarray(w_b),
        q_batch=None if q_b is None else jnp.asarray(q_b))
    for g, wa in zip(got, want):
        _close(g.numpy(), wa, SMOOTH_TOL)


@pytest.mark.parametrize("blocks", [1, 4])
@pytest.mark.parametrize("d", [1, 3])
def test_per_chain_plain_version_equals_static_on_equal_tiles(d, blocks):
    """Per-chain W and Q equal to the shared ones give the static plain
    version's numbers: exactly at one block (the same entry-wise
    operations), within float32 roundoff at several (the fold and carry's
    matrix products run batched over the chains' own W and Q instead of
    broadcast against one shared matrix, and sum in another order)."""
    b, t = 4, 40
    m0, p0, xi, f, bvec, q, w, _, _ = _system(b, d, t, seed=30 + d)
    wt = _t(np.broadcast_to(w, (b, d, d)).copy())
    qt = _t(np.broadcast_to(q, (b, d, d)).copy())
    args = (_t(m0), _t(p0), _t(xi), f, bvec)
    tol = 0.0 if blocks == 1 else 1e-6
    mf, pf = fs.fused_forward_blocked_reference(*args, q, w, blocks)
    mfd, pfd = fs.fused_forward_blocked_reference(*args, None, None, blocks,
                                                  w_batch=wt, q_batch=qt)
    torch.testing.assert_close(mfd, mf, rtol=tol, atol=tol)
    torch.testing.assert_close(pfd, pf, rtol=tol, atol=tol)
    back = fs.fused_backward_blocked_reference(mf, pf, f, bvec, q, blocks)
    backd = fs.fused_backward_blocked_reference(mf, pf, f, bvec, None, blocks,
                                                q_batch=qt)
    for g, want in zip(backd, back):
        torch.testing.assert_close(g, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", MODES)
def test_per_chain_blocked_plain_version_matches_one_block(mode):
    """The time-blocked plain version (fold, carry, replay) with per-chain
    W / Q against the one-block recursion: equal at one block, within
    float32 roundoff of the carried entry states at several."""
    d, b, t = 3, 5, 64
    m0, p0, xi, f, bvec, q, w, wb, qb = _system(b, d, t, seed=40)
    q_sh, w_sh, w_b, q_b = _mode_args(mode, q, w, wb, qb)
    w_b = None if w_b is None else _t(w_b)
    q_b = None if q_b is None else _t(q_b)
    args = (_t(m0), _t(p0), _t(xi), f, bvec, q_sh, w_sh)
    one = fs.fused_forward_reference(*args, w_b, q_b)
    for blocks, tol in ((1, 0.0), (8, 1e-5)):
        got = fs.fused_forward_blocked_reference(*args, blocks, w_b, q_b)
        for g, want in zip(got, one):
            torch.testing.assert_close(g, want, rtol=tol, atol=tol)
    mf, pf = one
    one_b = fs.fused_backward_reference(mf, pf, f, bvec, q_sh, q_b)
    got_b = fs.fused_backward_blocked_reference(mf, pf, f, bvec, q_sh, 8,
                                                q_b)
    for g, want in zip(got_b, one_b):
        torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5)


def test_per_chain_wrappers_refuse_what_the_kernels_do_not_take():
    m0, p0, xi, f, bvec, q, w, wb, _ = _system(3, 2, 5, seed=50)
    with pytest.raises(ValueError, match="shared matrix or the per-chain"):
        fs.fused_forward(_t(m0), _t(p0), _t(xi), f, bvec, q, None)
    with pytest.raises(ValueError, match="w_batch has shape"):
        fs.fused_forward(_t(m0), _t(p0), _t(xi), f, bvec, q, None,
                         w_batch=_t(wb[:2]))
    with pytest.raises(ValueError, match="q_batch has shape"):
        fs.fused_backward(_t(xi).permute(0, 2, 1).contiguous(),
                          _t(np.zeros((5, 3, 3), np.float32)), f, bvec, None,
                          q_batch=_t(wb[:2]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the per-chain W/Q kernels run only "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d,b,t", [(4, 8, 1056), (1, 37, 64), (8, 64, 32)])
def test_per_chain_kernels_match_plain_version_on_the_card(cuda_device, mode,
                                                           d, b, t):
    m0, p0, xi, f, bvec, q, w, wb, qb = _system(b, d, t, seed=60 + d)
    q_sh, w_sh, w_b, q_b = _mode_args(mode, q, w, wb, qb)
    dev = lambda a: None if a is None else torch.as_tensor(a,
                                                           device=cuda_device)
    args = (dev(m0), dev(p0), dev(xi), f, bvec, q_sh, w_sh)
    before = dict(fs.LAUNCHES)
    mf, pf = fs.fused_forward(*args, dev(w_b), dev(q_b))
    mf_r, pf_r = fs.fused_forward_reference(*args, dev(w_b), dev(q_b))
    ms, ps, cr = fs.fused_backward(mf, pf, f, bvec, q_sh, dev(q_b))
    ms_r, ps_r, cr_r = fs.fused_backward_reference(mf, pf, f, bvec, q_sh,
                                                   dev(q_b))
    torch.cuda.synchronize()
    for got, want in ((mf, mf_r), (pf, pf_r), (ms, ms_r), (ps, ps_r),
                      (cr, cr_r)):
        torch.testing.assert_close(got, want, **SMOOTH_TOL)
    bwd = "fused_smoother_bwd_dyn" if "Q" in mode else "fused_smoother_bwd"
    for k in ("fused_smoother_fwd_dyn", bwd):
        assert fs.LAUNCHES[k] == before[k] + 1


@pytest.mark.parametrize("mode", MODES)
def test_the_backward_pass_takes_q_per_chain_only_when_it_is(mode,
                                                             monkeypatch):
    """``fused_batched_smoother`` hands K2 what the JAX package's
    ``_bwd_kernel`` reads: the shared Q unless Q is per chain, so a plan
    with W alone per chain runs the static backward pass."""
    m0, p0, xi, f, bvec, q, w, wb, qb = _system(3, 2, 6, seed=70)
    q_sh, w_sh, w_b, q_b = _mode_args(mode, q, w, wb, qb)
    seen = []
    real = fs.fused_backward

    def spy(mf, pf, f_, b_, q_, q_batch=None):
        seen.append((q_, q_batch))
        return real(mf, pf, f_, b_, q_, q_batch)

    monkeypatch.setattr(fs, "fused_backward", spy)
    fs.fused_batched_smoother(
        _t(m0), _t(p0), _t(xi), f, bvec, q_sh, w_sh,
        w_batch=None if w_b is None else _t(w_b),
        q_batch=None if q_b is None else _t(q_b))
    (q_seen, q_batch_seen), = seen
    if "Q" in mode:
        assert q_seen is None
        torch.testing.assert_close(q_batch_seen, _t(qb), rtol=0, atol=0)
    else:
        assert q_batch_seen is None
        np.testing.assert_array_equal(q_seen, q)
