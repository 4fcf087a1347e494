"""The single-chain solvers of the PyTorch port against the JAX package: the
port's ``associative_scan`` against a sequential fold and against
``jax.lax.associative_scan`` (operand order included), the parallel and
sequential Kalman filters and smoothers and ``chain_log_evidence`` of
``rxinfer_tpu_torch/ops/kalman.py``, and both forward-backward functions of
``rxinfer_tpu_torch/ops/discrete_chain.py``.  Inputs come from numpy seeds;
the port takes a leading batch of 3 natively, JAX is vmapped over it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxinfer_tpu.ops import discrete_chain as jdc
from rxinfer_tpu.ops import kalman as jk
from rxinfer_tpu_torch.ops import discrete_chain as tdc
from rxinfer_tpu_torch.ops import kalman as tk
from rxinfer_tpu_torch.ops.scan import associative_scan

# float32 roundoff of a scan of orthogonal 2x2 products
SCAN_ATOL = 1e-6
# Kalman moments of two float32 implementations of one algebra
KALMAN_TOL = dict(rtol=1e-4, atol=1e-4)
# the JAX package's fused-vs-scan forward-backward tolerance
# (tests/engine/test_batched_engine.py:232-235), as tests/test_torch_hmm.py
FB_TOL = dict(rtol=2e-5, atol=2e-5)
LOGZ_RTOL = 1e-5
BATCH = 3


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- associative_scan ------------------------------------------------------------

def _orthogonal(t_len, seed):
    """(B, T, 2, 2) random orthogonal matrices, rotations and reflections:
    they do not commute, so the operand order shows, and their products stay
    orthogonal, so a long scan stays O(1)."""
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.standard_normal((BATCH, t_len, 2, 2)))
    return (q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[..., None, :]
            ).astype(np.float32)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t_len", [1, 2, 3, 47, 48, 129])
def test_associative_scan_matches_a_fold_and_jax(t_len, reverse):
    x = _orthogonal(t_len, seed=t_len + 1000 * reverse)
    tx = torch.as_tensor(x)
    # the left operand is the earlier chunk, or under reverse the later one
    combine = lambda a, b: (a[0] @ b[0],)
    got, = associative_scan(combine, (tx,), dim=1, reverse=reverse)

    # the fold in float64: the scan's own float32 roundoff grows with its
    # log-depth, a float32 fold's with T
    x64 = tx.double()
    order = range(t_len - 1, -1, -1) if reverse else range(t_len)
    fold = torch.empty_like(x64)
    acc = None
    for t in order:
        acc = x64[:, t] if acc is None else combine((acc,), (x64[:, t],))[0]
        fold[:, t] = acc
    want = jax.lax.associative_scan(lambda a, b: a @ b, jnp.asarray(x),
                                    axis=1, reverse=reverse)
    assert tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), fold.numpy(), rtol=0,
                               atol=SCAN_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=SCAN_ATOL)


def test_associative_scan_refuses_ragged_elements():
    with pytest.raises(ValueError, match="same length"):
        associative_scan(lambda a, b: a, (torch.zeros(3, 2), torch.zeros(4)),
                         dim=0)


# -- Kalman filters and smoothers ------------------------------------------------

def _chain(d, t_len, seed):
    """A stable chain with time-varying offsets and evidence precisions,
    batched over BATCH (the transition shared, as the engine builds it)."""
    rng = np.random.default_rng(seed)
    qm, _ = np.linalg.qr(rng.standard_normal((d, d)))
    a = rng.standard_normal((BATCH, t_len, d, d)) * 0.3
    return dict(
        m0=rng.standard_normal((BATCH, d)).astype(np.float32),
        P0=np.broadcast_to(4.0 * np.eye(d), (BATCH, d, d)).astype(np.float32),
        F=np.broadcast_to(0.95 * qm, (t_len - 1, d, d)).astype(np.float32),
        b=(0.1 * rng.standard_normal((BATCH, t_len - 1, d))).astype(
            np.float32),
        Q=np.broadcast_to(0.3 * np.eye(d), (t_len - 1, d, d)).astype(
            np.float32),
        xi=rng.standard_normal((BATCH, t_len, d)).astype(np.float32),
        W=(0.5 * np.eye(d) + a @ np.swapaxes(a, -1, -2)).astype(np.float32),
    )


def _torch_params(c):
    return tk.ChainParams(*(torch.as_tensor(np.ascontiguousarray(c[k]))
                            for k in tk.ChainParams._fields))


def _jax_vmapped(fn, c):
    """``fn`` of the JAX package over the batch (the transition shared),
    jitted as the JAX package's programs run it."""
    axes = jk.ChainParams(0, 0, None, 0, None, 0, 0)
    return jax.jit(jax.vmap(fn, in_axes=(axes,)))(
        jk.ChainParams(*(jnp.asarray(c[k]) for k in jk.ChainParams._fields)))


KALMAN_CASES = [(d, t) for d in (1, 2, 4) for t in (1, 2, 47, 48, 200)]


@pytest.mark.parametrize("d,t_len", KALMAN_CASES)
def test_filters_and_smoothers_match_jax(d, t_len):
    c = _chain(d, t_len, seed=10 * d + t_len)
    p = _torch_params(c)
    # the JAX package's parallel smoother cannot scan one step (its reverse
    # scan sees leaves of unequal length at T = 1); its sequential one is
    # the reference there
    par = "parallel" if t_len > 1 else "sequential"
    want_s = _jax_vmapped(getattr(jk, f"{par}_smoother"), c)
    want_f = _jax_vmapped(getattr(jk, f"{par}_filter"), c)
    want_seq = _jax_vmapped(jk.sequential_smoother, c)
    for got_f in (tk.parallel_filter(p), tk.sequential_filter(p)):
        for name, g, w in zip(("filt_means", "filt_covs"), got_f, want_f):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=name, **KALMAN_TOL)
    for got, want in ((tk.parallel_smoother(p), want_s),
                      (tk.sequential_smoother(p), want_seq)):
        for name in tk.SmoothResult._fields:
            g, w = getattr(got, name), np.asarray(getattr(want, name))
            assert tuple(g.shape) == w.shape, name
            np.testing.assert_allclose(g.numpy(), w, err_msg=name,
                                       **KALMAN_TOL)


@pytest.mark.parametrize("d,dy,t_len", [(1, 1, 2), (2, 3, 47), (4, 4, 48),
                                        (4, 6, 200), (2, 2, 1)])
def test_chain_log_evidence_matches_jax(d, dy, t_len):
    c = _chain(d, t_len, seed=d + dy + t_len)
    rng = np.random.default_rng(7 * t_len + dy)
    H = rng.standard_normal((t_len, dy, d)).astype(np.float32)
    off = (0.1 * rng.standard_normal((t_len, dy))).astype(np.float32)
    a = rng.standard_normal((dy, dy)) * 0.3
    R = np.broadcast_to(np.eye(dy) + a @ a.T, (t_len, dy, dy)).astype(
        np.float32)
    y = rng.standard_normal((BATCH, t_len, dy)).astype(np.float32)
    mask = rng.random((BATCH, t_len)) > 0.2
    p = _torch_params(c)
    fm, fc = tk.sequential_filter(p)
    got = tk.chain_log_evidence(
        p, fm, fc, *(torch.as_tensor(x) for x in (H, off, R, y, mask)))

    def one(pp, yy, mm):
        jfm, jfc = jk.sequential_filter(pp)
        return jk.chain_log_evidence(pp, jfm, jfc, jnp.asarray(H),
                                     jnp.asarray(off), jnp.asarray(R), yy,
                                     mm)

    axes = jk.ChainParams(0, 0, None, 0, None, 0, 0)
    want = jax.jit(jax.vmap(one, in_axes=(axes, 0, 0)))(
        jk.ChainParams(*(jnp.asarray(c[k]) for k in jk.ChainParams._fields)),
        jnp.asarray(y), jnp.asarray(mask))
    assert tuple(got.shape) == (BATCH,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


# -- forward-backward ------------------------------------------------------------

@pytest.mark.parametrize("solver", ["forward_backward",
                                    "parallel_forward_backward"])
@pytest.mark.parametrize("k,t_len", [(k, t) for k in (2, 3, 5)
                                     for t in (1, 2, 47, 48, 200)])
def test_forward_backward_matches_jax(solver, k, t_len):
    rng = np.random.default_rng(100 * k + t_len)
    lp = rng.standard_normal((BATCH, k)).astype(np.float32)
    lt = rng.standard_normal((BATCH, t_len - 1, k, k)).astype(np.float32)
    le = rng.standard_normal((BATCH, t_len, k)).astype(np.float32)
    got = getattr(tdc, solver)(*(torch.as_tensor(x) for x in (lp, lt, le)))
    want = jax.jit(jax.vmap(getattr(jdc, solver)))(
        jnp.asarray(lp), jnp.asarray(lt), jnp.asarray(le))
    for name in ("gammas", "xis"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **FB_TOL)
    np.testing.assert_allclose(got.logZ.numpy(), np.asarray(want.logZ),
                               rtol=LOGZ_RTOL, atol=0)
