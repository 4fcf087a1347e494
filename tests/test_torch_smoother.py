"""The PyTorch port's fused smoother against the JAX package's Pallas
smoother (interpret mode on the CPU, as the JAX package's own tests run it)
and against a float64 numpy oracle where the JAX wrapper cannot go (T=1,
where it raises ZeroDivisionError; d=8, where interpret mode is slow).

On the CPU the port's wrappers take their plain versions; the CUDA kernels
are held against the same plain versions on the card by the ``gpu``-marked
test below and by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxinfer_tpu.ops.pallas_smoother import (
    fused_batched_smoother as jax_fused_batched_smoother,
)
from rxinfer_tpu_torch.ops import fused_smoother as fs

TOL = dict(rtol=3e-4, atol=3e-4)   # the JAX package's smoother-test tolerance


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
    w = (0.8 * np.eye(d) + a @ a.T).astype(np.float32)
    bvec = (0.1 * np.arange(d)).astype(np.float32)
    xi = rng.standard_normal((t, b, d)).astype(np.float32)
    m0 = rng.standard_normal((b, d)).astype(np.float32)
    p0 = np.broadcast_to(9.0 * np.eye(d, dtype=np.float32), (b, d, d)).copy()
    return m0, p0, xi, f, bvec, q, w


def _oracle(m0, p0, xi, f, bvec, q, w):
    """Float64 information-form filter + RTS smoother (no transition at t=0)."""
    t_len, b, d = xi.shape
    f, bvec, q, w = (np.asarray(x, np.float64) for x in (f, bvec, q, w))
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
        ms[t] = mf[t] + np.einsum("bij,bj->bi", g, ms[t + 1] - mf[t] @ f.T - bvec)
        ps[t] = pf[t] + g @ (ps[t + 1] - pp) @ np.swapaxes(g, -1, -2)
        cross[t] = g @ ps[t + 1]
    return ms, ps, cross


def _port(m0, p0, xi, f, bvec, q, w):
    out = fs.fused_batched_smoother(
        torch.as_tensor(m0), torch.as_tensor(p0), torch.as_tensor(xi),
        f, bvec, q, w)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("d,b,t", [(1, 5, 23), (2, 5, 23), (3, 5, 23),
                                   (4, 5, 23), (4, 3, 2)])
def test_matches_jax_pallas_smoother(d, b, t):
    m0, p0, xi, f, bvec, q, w = _params(b, d, t, seed=d + t)
    jm, jp, jc = jax_fused_batched_smoother(
        jnp.asarray(m0), jnp.asarray(p0), jnp.asarray(xi), f, bvec, q, w,
        chunk=4, interpret=True)
    tm, tp, tc = _port(m0, p0, xi, f, bvec, q, w)
    assert tm.shape == (t, b, d) and tp.shape == (t, b, d, d)
    assert tc.shape == (t - 1, b, d, d)
    np.testing.assert_allclose(tm, np.asarray(jm), **TOL)
    np.testing.assert_allclose(tp, np.asarray(jp), **TOL)
    np.testing.assert_allclose(tc, np.asarray(jc), **TOL)


@pytest.mark.parametrize("d,b,t", [(4, 3, 1), (1, 2, 1), (8, 3, 9), (8, 2, 2)])
def test_matches_float64_oracle(d, b, t):
    m0, p0, xi, f, bvec, q, w = _params(b, d, t, seed=40 + d + t)
    om, op, oc = _oracle(m0, p0, xi, f, bvec, q, w)
    tm, tp, tc = _port(m0, p0, xi, f, bvec, q, w)
    assert tc.shape == (t - 1, b, d, d)
    np.testing.assert_allclose(tm, om, **TOL)
    np.testing.assert_allclose(tp, op, **TOL)
    np.testing.assert_allclose(tc, oc, **TOL)


def test_jax_wrapper_fails_at_one_step_and_the_port_does_not():
    """Reference fault recorded in ROADMAP queue C: the JAX wrapper's
    empty-cross reshape divides by zero at T=1."""
    m0, p0, xi, f, bvec, q, w = _params(2, 2, 1, seed=3)
    with pytest.raises(ZeroDivisionError):
        jax_fused_batched_smoother(jnp.asarray(m0), jnp.asarray(p0),
                                   jnp.asarray(xi), f, bvec, q, w,
                                   chunk=4, interpret=True)
    _, _, tc = _port(m0, p0, xi, f, bvec, q, w)
    assert tc.shape == (0, 2, 2, 2)


def test_sym_fold_and_unfold_round_trip():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, 6, 4, 4)).astype(np.float32)
    p = torch.as_tensor(a + np.swapaxes(a, -1, -2))          # (T, B, d, d)
    packed = fs.sym_fold(p)                                  # (T, nsym, B)
    assert packed.shape == (3, 10, 6)
    torch.testing.assert_close(fs.sym_unfold_t(packed, 4), p)


def test_cpu_tensors_take_the_plain_version():
    m0, p0, xi, f, bvec, q, w = _params(3, 2, 5, seed=6)
    before = dict(fs.LAUNCHES)
    args = (torch.as_tensor(m0), torch.as_tensor(p0), torch.as_tensor(xi))
    mf, pf = fs.fused_forward(*args, f, bvec, q, w)
    mf_r, pf_r = fs.fused_forward_reference(*args, f, bvec, q, w)
    torch.testing.assert_close(mf, mf_r, rtol=0, atol=0)
    assert fs.LAUNCHES == before


def test_unsupported_dims_raise():
    m0, p0, xi, f, bvec, q, w = _params(2, 17, 3, seed=7)
    with pytest.raises(ValueError, match="d = 1..16"):
        fs.fused_forward(torch.as_tensor(m0), torch.as_tensor(p0),
                         torch.as_tensor(xi), f, bvec, q, w)
    with pytest.raises(ValueError, match="parameters"):
        fs.fused_forward(torch.as_tensor(m0[:, :2]),
                         torch.as_tensor(p0[:, :2, :2]),
                         torch.as_tensor(xi[..., :2]), f, bvec, q, w)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the smoother kernels run only on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("d,b,t", [(4, 1000, 257), (1, 37, 64), (8, 64, 32),
                                   (4, 50, 1)])
def test_kernels_match_plain_version_on_the_card(cuda_device, d, b, t):
    m0, p0, xi, f, bvec, q, w = _params(b, d, t, seed=9)
    args = [torch.as_tensor(a, device=cuda_device) for a in (m0, p0, xi)]
    before = dict(fs.LAUNCHES)
    mf, pf = fs.fused_forward(*args, f, bvec, q, w)
    mf_r, pf_r = fs.fused_forward_reference(*args, f, bvec, q, w)
    ms, ps, cr = fs.fused_backward(mf, pf, f, bvec, q)
    ms_r, ps_r, cr_r = fs.fused_backward_reference(mf, pf, f, bvec, q)
    torch.cuda.synchronize()
    for got, want in ((mf, mf_r), (pf, pf_r), (ms, ms_r), (ps, ps_r),
                      (cr, cr_r)):
        torch.testing.assert_close(got, want, **TOL)
    assert fs.LAUNCHES["fused_smoother_fwd"] == before["fused_smoother_fwd"] + 1
    assert fs.LAUNCHES["fused_smoother_bwd"] == before["fused_smoother_bwd"] + 1
