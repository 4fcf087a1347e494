"""The smoother at state dims 9..16 (the wide kernels' tier, ROADMAP V3).

The port's plain smoother is d-generic (``ops/entrywise.py``'s Schur
recursion); on the card d in 9..16 launches ``csrc/fused_smoother_wide.cu``.
On the CPU it is held against the JAX package's sequential smoother
(``rxinfer_tpu/ops/kalman.py``) and a float64 RTS smoother, and the port's
``batched_program`` (its fused plan, plain versions) against the JAX
package's ``batched_program``, which on the CPU takes its scan path at
d > 8 (the JAX interpret-mode kernel executes its ~20k-operation step body
per step: a minute a call).  Static and per-chain (V1) precisions, with the
free energy.  The ``gpu``-marked tests hold the wide kernels against their
plain version on the card and count their launches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu.ops import kalman as jk
from rxinfer_tpu_torch.ops import fused_smoother as fs

# Port against JAX: the JAX package's smoother-test tolerance (float32 in
# two libraries, Schur recursion against solves).  Against the float64
# oracle the same: a few steps of well-conditioned 16 x 16 inverses.
TOL = dict(rtol=3e-4, atol=3e-4)
# The free-energy trace, relative: sums of T * d log-determinants and
# quadratic forms in float32 (the JAX engine-test level).
FE_TOL = dict(rtol=1e-5, atol=1e-4)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _params(b, d, t, seed=0):
    rng = np.random.default_rng(seed)
    qm, _ = np.linalg.qr(rng.standard_normal((d, d)))
    f = (0.97 * qm).astype(np.float32)
    q = (0.4 * np.eye(d)).astype(np.float32)
    a = 0.3 * rng.standard_normal((d, d))
    w = (0.8 * np.eye(d) + a @ a.T / d).astype(np.float32)
    bvec = (0.1 * np.arange(d)).astype(np.float32)
    xi = rng.standard_normal((t, b, d)).astype(np.float32)
    m0 = rng.standard_normal((b, d)).astype(np.float32)
    p0 = np.broadcast_to(9.0 * np.eye(d, dtype=np.float32), (b, d, d)).copy()
    return m0, p0, xi, f, bvec, q, w


def _spd(rng, n, d, scale):
    a = 0.3 * rng.standard_normal((n, d, d))
    return (scale * np.eye(d) + a @ np.swapaxes(a, -1, -2) / d).astype(
        np.float32)


def _oracle(m0, p0, xi, f, bvec, q, w):
    """Float64 information-form filter + RTS smoother; q, w shared (d, d)
    or per chain (B, d, d)."""
    t_len, b, d = xi.shape
    f, bvec = np.float64(f), np.float64(bvec)
    q = np.broadcast_to(np.float64(q), (b, d, d))
    w = np.broadcast_to(np.float64(w), (b, d, d))
    mf = np.empty((t_len, b, d))
    pf = np.empty((t_len, b, d, d))
    m, p = m0.astype(np.float64), p0.astype(np.float64)
    for t in range(t_len):
        if t:
            m, p = m @ f.T + bvec, f @ p @ f.T + q
        lam = np.linalg.inv(p)
        p = np.linalg.inv(lam + w)
        m = np.einsum("bij,bj->bi", p, np.einsum("bij,bj->bi", lam, m) + xi[t])
        mf[t], pf[t] = m, p
    ms, ps = mf.copy(), pf.copy()
    cross = np.empty((t_len - 1, b, d, d))
    for t in range(t_len - 2, -1, -1):
        pp = f @ pf[t] @ f.T + q
        g = pf[t] @ f.T @ np.linalg.inv(pp)
        ms[t] = mf[t] + np.einsum("bij,bj->bi", g,
                                  ms[t + 1] - mf[t] @ f.T - bvec)
        ps[t] = pf[t] + g @ (ps[t + 1] - pp) @ np.swapaxes(g, -1, -2)
        cross[t] = g @ ps[t + 1]
    return ms, ps, cross


def _jax_sequential(m0, p0, xi, f, bvec, q, w):
    """The JAX package's sequential smoother, vmapped over the chains."""
    t_len, b, d = xi.shape
    fields = jk.ChainParams(
        jnp.asarray(m0), jnp.asarray(p0),
        jnp.broadcast_to(jnp.asarray(f), (t_len - 1, d, d)),
        jnp.broadcast_to(jnp.asarray(bvec), (t_len - 1, d)),
        jnp.broadcast_to(jnp.asarray(q), (t_len - 1, d, d)),
        jnp.asarray(np.moveaxis(xi, 1, 0)),
        jnp.broadcast_to(jnp.asarray(w), (b, t_len, d, d)))
    axes = jk.ChainParams(0, 0, None, None, None, 0, 0)
    res = jax.vmap(jk.sequential_smoother, in_axes=(axes,))(fields)
    return (np.moveaxis(np.asarray(res.means), 0, 1),
            np.moveaxis(np.asarray(res.covs), 0, 1),
            np.moveaxis(np.asarray(res.cross), 0, 1))


def _port(m0, p0, xi, f, bvec, q, w, **kw):
    out = fs.fused_batched_smoother(
        torch.as_tensor(m0), torch.as_tensor(p0), torch.as_tensor(xi),
        f, bvec, q, w, **kw)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("d", [9, 12, 16])
def test_plain_wide_smoother_matches_jax_and_float64(d):
    m0, p0, xi, f, bvec, q, w = _params(3, d, 5, seed=d)
    before = dict(fs.LAUNCHES)
    got = _port(m0, p0, xi, f, bvec, q, w)
    assert fs.LAUNCHES == before             # the plain version counts none
    assert [g.shape for g in got] == [(5, 3, d), (5, 3, d, d), (4, 3, d, d)]
    for want in (_jax_sequential(m0, p0, xi, f, bvec, q, w),
                 _oracle(m0, p0, xi, f, bvec, q, w)):
        for g, wnt in zip(got, want):
            np.testing.assert_allclose(g, wnt, **TOL)


def test_plain_wide_smoother_takes_per_chain_w_and_q():
    d, b = 10, 3
    m0, p0, xi, f, bvec, _, _ = _params(b, d, 4, seed=3)
    rng = np.random.default_rng(4)
    wb, qb = _spd(rng, b, d, 0.8), _spd(rng, b, d, 0.4)
    got = _port(m0, p0, xi, f, bvec, None, None, w_batch=torch.as_tensor(wb),
                q_batch=torch.as_tensor(qb))
    for g, want in zip(got, _oracle(m0, p0, xi, f, bvec, qb, wb)):
        np.testing.assert_allclose(g, want, **TOL)


def test_wide_dims_count_under_the_wide_keys():
    assert fs.launch_key("fwd", 16, False, False) == "fused_smoother_fwd_wide"
    assert fs.launch_key("bwd", 9, True, True) == \
        "fused_smoother_bwd_wide_dyn_bf16"
    assert fs.launch_key("fwd", 8, True, False) == "fused_smoother_fwd_dyn"
    # every instantiation has its key: {fwd, bwd} x {register, wide} x
    # {static, per-chain} x {float32, bf16}
    assert len(fs.LAUNCHES) == 16
    assert {fs.launch_key(dr, d, dyn, bf) for dr in ("fwd", "bwd")
            for d in (4, 12) for dyn in (False, True)
            for bf in (False, True)} == set(fs.LAUNCHES)


# -- the engine at d = 10 and 16 -------------------------------------------------------

def lgssm_source(rx, A, Q, H, R, m0, V0):
    @rx.model
    def lgssm(y):
        T = len(y)
        x = rx.latent(T, name="x")
        x[0] = rx.MvNormal(mean=m0, cov=V0)
        for t in rx.plate(1, T):
            x[t] = rx.MvNormal(mean=A @ x[t - 1], cov=Q)
        for t in rx.plate(T):
            y[t] = rx.MvNormal(mean=H @ x[t], cov=R)
        return {"x": x}

    return lgssm


def wide_constants(d, seed=0):
    """bench.py's d16 system (F = kron(I, rot(pi/35))) with a mixing H and
    a correlated R, cut to d."""
    rng = np.random.default_rng(seed)
    th = np.pi / 35
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    a = np.kron(np.eye((d + 1) // 2), rot)[:d, :d].astype(np.float32)
    q = (0.5 * np.eye(d)).astype(np.float32)
    h = (1.3 * np.eye(d) + 0.1 * rng.standard_normal((d, d))).astype(
        np.float32)
    r = (np.eye(d) + 0.2 * np.ones((d, d))).astype(np.float32)
    m0 = (0.1 * np.arange(d)).astype(np.float32)
    v0 = (25.0 * np.eye(d)).astype(np.float32)
    return a, q, h, r, m0, v0


def wishart_source(rx, d, random_q):
    """An LGSSM whose observation precision is an unknown Wishart (W per
    chain, the V1 tier) and, with ``random_q``, its process-noise precision
    too (W and Q per chain)."""
    a, q, _, _, m0, v0 = wide_constants(d)
    eye = np.eye(d, dtype=np.float32)

    @rx.model
    def noisy(y):
        T = len(y)
        wr = rx.Wishart(float(d) + 2.0, eye)
        wq = rx.Wishart(float(d) + 2.0, 2.0 * eye) if random_q else None
        x = rx.latent(T, name="x")
        x[0] = rx.MvNormal(mean=m0, cov=v0)
        for t in rx.plate(1, T):
            if random_q:
                x[t] = rx.MvNormal(mean=a @ x[t - 1], precision=wq)
            else:
                x[t] = rx.MvNormal(mean=a @ x[t - 1], cov=q)
        for t in rx.plate(T):
            y[t] = rx.MvNormal(mean=x[t], precision=wr)
        return {"x": x}

    return noisy


def _wishart_init(pkg, d, random_q):
    eye = np.eye(d, dtype=np.float32)
    if pkg is trx:
        mk = lambda nu, s: trx.Wishart(torch.tensor(nu), torch.as_tensor(s))
    else:
        mk = lambda nu, s: jrx.Wishart(nu, s)
    init = {"wr": mk(float(d) + 2.0, eye)}
    if random_q:
        init["wq"] = mk(float(d) + 2.0, 2.0 * eye)
    return init


@pytest.mark.parametrize("d", [10, 16])
def test_batched_program_at_wide_dims_matches_jax(d):
    """Static precisions: the port's fused plan against the JAX package's
    program (its scan path on the CPU), posteriors and the FE trace."""
    c = wide_constants(d, seed=d)
    y = np.random.default_rng(d).standard_normal((2, 6, d)).astype(np.float32)
    _, jprog = jrx.batched_program(lgssm_source(jrx, *c), {"y": y},
                                   iterations=2, free_energy=True)
    jstate, jfe, _ = jprog({"y": jnp.asarray(y)})
    tcomp, tprog = trx.batched_program(lgssm_source(trx, *c), {"y": y},
                                       iterations=2, free_energy=True,
                                       device=CPU)
    assert tcomp.plan_report()["x"] == {"fused": True,
                                        "kernel": "fused_smoother",
                                        "route": "plain"}
    tstate, tfe, _ = tprog({"y": y})
    np.testing.assert_allclose(tstate["x"].mu.numpy(),
                               np.asarray(jstate["x"].mu), **TOL)
    np.testing.assert_allclose(tstate["x"].sigma.numpy(),
                               np.asarray(jstate["x"].sigma), **TOL)
    np.testing.assert_allclose(tfe.numpy(), np.asarray(jfe), **FE_TOL)


@pytest.mark.parametrize("random_q", [False, True])
def test_per_chain_precisions_at_d10_match_jax(random_q):
    """V1 at d = 10: an unknown Wishart observation precision (W per chain)
    and, with ``random_q``, process-noise precision (W and Q per chain),
    against the JAX package's program; the FE trace where the JAX package's
    is the Bethe FE (not with a random transition precision: ROADMAP C6)."""
    d = 10
    y = np.random.default_rng(7).standard_normal((2, 5, d)).astype(np.float32)
    _, jprog = jrx.batched_program(
        wishart_source(jrx, d, random_q), {"y": y}, iterations=2,
        free_energy=not random_q,
        initialization=_wishart_init(jrx, d, random_q))
    jstate, jfe, _ = jprog({"y": jnp.asarray(y)})
    tcomp, tprog = trx.batched_program(
        wishart_source(trx, d, random_q), {"y": y}, iterations=2,
        free_energy=not random_q,
        initialization=_wishart_init(trx, d, random_q), device=CPU)
    report = tcomp.plan_report()["x"]
    assert report["fused"] is True
    assert report["dynamic"] == (["W", "Q"] if random_q else ["W"])
    tstate, tfe, _ = tprog({"y": y})
    np.testing.assert_allclose(tstate["x"].mu.numpy(),
                               np.asarray(jstate["x"].mu), **TOL)
    np.testing.assert_allclose(tstate["x"].sigma.numpy(),
                               np.asarray(jstate["x"].sigma), **TOL)
    np.testing.assert_allclose(tstate["wr"].mean().numpy(),
                               np.asarray(jstate["wr"].mean()), rtol=1e-4,
                               atol=1e-4)
    if not random_q:
        np.testing.assert_allclose(tfe.numpy(), np.asarray(jfe), **FE_TOL)


# -- on the card --------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the wide smoother kernels run only "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("d,b,t,dyn", [(9, 37, 12, False),
                                       (16, 256, 6, False),
                                       (12, 64, 8, True)])
def test_wide_kernels_match_plain_version_on_the_card(cuda_device, d, b, t,
                                                      dyn):
    """The wide kernels (a ragged last block of chains at B = 37) against
    their plain version on the same CUDA tensors, each wrapper call counted
    once under its ``_wide`` key."""
    m0, p0, xi, f, bvec, q, w = _params(b, d, t, seed=20 + d)
    rng = np.random.default_rng(21)
    dev = lambda a: torch.as_tensor(a, device=cuda_device)
    wb = dev(_spd(rng, b, d, 0.8)) if dyn else None
    qb = dev(_spd(rng, b, d, 0.4)) if dyn else None
    q_sh, w_sh = (None, None) if dyn else (q, w)
    args = (dev(m0), dev(p0), dev(xi), f, bvec, q_sh, w_sh, wb, qb)
    before = dict(fs.LAUNCHES)
    mf, pf = fs.fused_forward(*args)
    ms, ps, cr = fs.fused_backward(mf, pf, f, bvec, q_sh, qb)
    torch.cuda.synchronize()
    mf_r, pf_r = fs.fused_forward_reference(*args)
    ms_r, ps_r, cr_r = fs.fused_backward_reference(mf, pf, f, bvec, q_sh, qb)
    for got, want in ((mf, mf_r), (pf, pf_r), (ms, ms_r), (ps, ps_r),
                      (cr, cr_r)):
        torch.testing.assert_close(got, want, **TOL)
    for direction in ("fwd", "bwd"):
        key = fs.launch_key(direction, d, dyn, False)
        assert fs.LAUNCHES[key] == before[key] + 1
