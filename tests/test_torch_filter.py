"""The PyTorch port's continuous-batching filter against the JAX package:
``filtering_scan`` against JAX ``filtering_scan``, and the fused filter
(plain route on the CPU) against the JAX Pallas filter in interpret mode, as
the JAX package's own tests run it on the CPU.  Both packages get the same
state and observations from a numpy seed.

On the CPU the port's ``fused_filter`` takes its plain version; the CUDA
kernel is held against the same plain version on the card by the
``gpu``-marked test below and by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxinfer_tpu.ops.kalman import filter_step as jax_filter_step
from rxinfer_tpu.ops.pallas_filter import (
    fused_filtering_scan as jax_fused_filtering_scan,
)
from rxinfer_tpu.parallel.filtering import (
    FilterState as JaxFilterState,
    filtering_scan as jax_filtering_scan,
)
from rxinfer_tpu_torch import convert
from rxinfer_tpu_torch.ops import fused_filter as ff
from rxinfer_tpu_torch.ops import fused_smoother as fs
from rxinfer_tpu_torch.ops.kalman import filter_step
from rxinfer_tpu_torch.parallel.filtering import (
    FilterState,
    filtering_scan,
    make_sharded_filtering,
)

TOL = dict(rtol=2e-4, atol=2e-4)   # the JAX package's filter-test tolerance


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _setup(b, d, t, dy=None, seed=0):
    """A stable system (rotation blocks for even d, a contraction otherwise),
    H (dy, d) with a random part so that dy != d is a real projection."""
    dy = d if dy is None else dy
    rng = np.random.default_rng(seed)
    theta = np.pi / 30
    rot = np.array([[np.cos(theta), -np.sin(theta)],
                    [np.sin(theta), np.cos(theta)]], np.float32)
    f = (np.kron(np.eye(d // 2, dtype=np.float32), rot) if d % 2 == 0
         else 0.9 * np.eye(d, dtype=np.float32))
    q = 0.3 * np.eye(d, dtype=np.float32)
    h = (1.2 * np.eye(dy, d) + 0.2 * rng.standard_normal((dy, d))).astype(
        np.float32)
    r = (0.8 * np.eye(dy) + 0.1 * np.ones((dy, dy))).astype(np.float32)
    ys = rng.standard_normal((t, b, dy)).astype(np.float32)
    m = rng.standard_normal((b, d)).astype(np.float32)
    p = np.broadcast_to(5.0 * np.eye(d, dtype=np.float32), (b, d, d)).copy()
    return m, p, ys, f, q, h, r


def _jax_args(m, p, ys, f, q, h, r):
    return (JaxFilterState(jnp.asarray(m), jnp.asarray(p)), jnp.asarray(ys),
            jnp.asarray(f), jnp.asarray(q), jnp.asarray(h), jnp.asarray(r))


def _assert_same(port, ref):
    (final, means), (jfinal, jmeans) = port, ref
    np.testing.assert_allclose(means.numpy(), np.asarray(jmeans), **TOL)
    np.testing.assert_allclose(final.m.numpy(), np.asarray(jfinal.m), **TOL)
    np.testing.assert_allclose(final.p.numpy(), np.asarray(jfinal.p), **TOL)


CASES = [(7, 4, 37, None), (16, 2, 32, None), (5, 3, 9, 2), (4, 1, 1, None)]


@pytest.mark.parametrize("b,d,t,dy", CASES + [(3, 10, 6, None)])
def test_filtering_scan_matches_jax(b, d, t, dy):
    m, p, ys, f, q, h, r = _setup(b, d, t, dy, seed=b + t)
    ref = jax_filtering_scan(*_jax_args(m, p, ys, f, q, h, r))
    state = convert.filter_state_from_numpy(m, p)
    final, means = filtering_scan(state, torch.as_tensor(ys), f, q, h, r)
    assert tuple(means.shape) == (t, b, d)
    assert tuple(final.m.shape) == (b, d) and tuple(final.p.shape) == (b, d, d)
    _assert_same((final, means), ref)


# d and dy across {1, 2, 4, 8}
WIDE_CASES = [(6, 8, 10, 8), (9, 1, 12, 2), (5, 2, 7, 8), (4, 8, 5, 1)]


@pytest.mark.parametrize("b,d,t,dy", CASES + WIDE_CASES)
def test_fused_filtering_scan_matches_jax_pallas(b, d, t, dy):
    m, p, ys, f, q, h, r = _setup(b, d, t, dy, seed=10 + b + t)
    ref = jax_fused_filtering_scan(*_jax_args(m, p, ys, f, q, h, r),
                                   chunk=8, interpret=True)
    state = convert.filter_state_from_numpy(m, p)
    final, means = ff.fused_filtering_scan(state, torch.as_tensor(ys),
                                           f, q, h, r)
    assert tuple(means.shape) == (t, b, d)
    _assert_same((final, means), ref)


def test_dense_filter_step_matches_jax():
    rng = np.random.default_rng(3)
    d, b = 10, 4
    a = rng.standard_normal((b, d, d)).astype(np.float32)
    p = a @ np.swapaxes(a, -1, -2) + 3.0 * np.eye(d, dtype=np.float32)
    m, xi, bias = (rng.standard_normal((b, d)).astype(np.float32)
                   for _ in range(3))
    f = (0.3 * rng.standard_normal((d, d))).astype(np.float32)
    q = 0.5 * np.eye(d, dtype=np.float32)
    w = 1.7 * np.eye(d, dtype=np.float32)
    jm, jp = jax_filter_step(*(jnp.asarray(x) for x in (m, p, f, bias, q, xi, w)))
    tm, tp = filter_step(*(torch.as_tensor(x) for x in (m, p, f, bias, q, xi, w)))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


@pytest.mark.parametrize("fused", [True, False])
def test_make_sharded_filtering_on_one_cpu_device_equals_filtering_scan(fused):
    m, p, ys, f, q, h, r = _setup(6, 4, 12, seed=4)
    state = convert.filter_state_from_numpy(m, p)
    want_final, want_means = filtering_scan(state, torch.as_tensor(ys),
                                            f, q, h, r)
    fn = make_sharded_filtering(None, f, q, h, r, fused=fused, device="cpu")
    # numpy state and observations are moved to the device by the function
    final, means = fn(FilterState(m, p), ys)
    torch.testing.assert_close(means, want_means, **TOL)
    torch.testing.assert_close(final.m, want_final.m, **TOL)
    torch.testing.assert_close(final.p, want_final.p, **TOL)


def test_a_mesh_is_not_ported_and_the_default_device_is_the_card(monkeypatch):
    _, _, _, f, q, h, r = _setup(2, 2, 2)
    with pytest.raises(NotImplementedError, match="mesh"):
        make_sharded_filtering(object(), f, q, h, r, fused=True, device="cpu")
    if torch.cuda.is_available():
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sharded_filtering(None, f, q, h, r, fused=True)


def test_a_stream_filtered_in_two_calls_equals_one_call():
    """Continuous batching: the final state of one call is the state of the
    next."""
    m, p, ys, f, q, h, r = _setup(5, 4, 20, seed=5)
    fn = make_sharded_filtering(None, f, q, h, r, fused=True, device="cpu")
    whole_final, whole_means = fn(FilterState(m, p), ys)
    mid, first = fn(FilterState(m, p), ys[:8])
    last_final, second = fn(mid, ys[8:])
    torch.testing.assert_close(torch.cat([first, second]), whole_means,
                               rtol=0, atol=0)
    torch.testing.assert_close(last_final.p, whole_final.p, rtol=0, atol=0)


def test_the_filter_predicts_at_step_zero_and_the_smoother_does_not():
    """The smoother's forward pass (K1) treats the state it is given as the
    prior OF step 0; the filter (K3) treats it as the posterior BEFORE step
    0 and applies the transition first.  On the same chain the two differ at
    step 0, and agree once K1 is handed the transitioned state."""
    b, d, t = 4, 3, 6
    m, p, ys, f, q, h, r = _setup(b, d, t, seed=6)
    w_obs, hr = ff.evidence_operators(h, r)
    ys_t, m_t, p_t = (torch.as_tensor(a) for a in (ys, m, p))
    means, _, _ = ff.fused_filter_reference(
        m_t.t().contiguous(), fs.sym_fold(p_t), ys_t.transpose(1, 2), f, q,
        hr, w_obs)
    xi = torch.einsum("ik,tbk->tbi", hr, ys_t)
    zero = np.zeros(d, np.float32)
    k1_same_state, _ = fs.fused_forward_reference(m_t, p_t, xi, f, zero, q,
                                                  w_obs)
    assert float((means[0] - k1_same_state[0]).abs().max()) > 1e-2
    f_t = torch.as_tensor(f)
    m_pred = m_t @ f_t.T
    p_pred = f_t @ p_t @ f_t.T + torch.as_tensor(q)
    k1_predicted, _ = fs.fused_forward_reference(m_pred, p_pred, xi, f, zero,
                                                 q, w_obs)
    torch.testing.assert_close(means, k1_predicted, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    m, p, ys, f, q, h, r = _setup(3, 2, 5, seed=7)
    w_obs, hr = ff.evidence_operators(h, r)
    args = (torch.as_tensor(m).t().contiguous(),
            fs.sym_fold(torch.as_tensor(p)).contiguous(),
            torch.as_tensor(ys).transpose(1, 2).contiguous())
    before = dict(ff.LAUNCHES)
    got = ff.fused_filter(*args, f, q, hr, w_obs)
    want = ff.fused_filter_reference(*args, f, q, hr, w_obs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert tuple(got[0].shape) == (5, 2, 3) and tuple(got[2].shape) == (3, 3)
    assert ff.LAUNCHES == before


def test_unsupported_dims_raise():
    # every d >= 1 and dy >= 1 runs (d > 16 on the warp kernel); an empty
    # state or observation is refused
    with pytest.raises(ValueError, match="d >= 1 and dy >= 1"):
        ff.fused_filter(torch.zeros((0, 2)), torch.zeros((0, 2)),
                        torch.zeros((3, 1, 2)), np.zeros((0, 0)),
                        np.zeros((0, 0)), np.zeros((0, 1)), np.zeros((0, 0)))
    with pytest.raises(ValueError, match="d >= 1 and dy >= 1"):
        ff.fused_filter(torch.zeros((2, 2)), torch.zeros((3, 2)),
                        torch.zeros((3, 0, 2)), np.eye(2), np.eye(2),
                        np.zeros((2, 0)), np.eye(2))
    m, p, ys, f, q, h, r = _setup(2, 2, 3, seed=8)
    state = convert.filter_state_from_numpy(m, p)
    with pytest.raises(ValueError, match="parameters"):
        ff.fused_filtering_scan(state, torch.as_tensor(ys), f[:1], q, h, r)
    with pytest.raises(ValueError, match="m \\(B, d\\)"):
        convert.filter_state_from_numpy(m, p[:, :1])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the filter kernel runs only on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,t,dy", [(1000, 4, 257, 4), (37, 2, 64, 3),
                                      (64, 8, 33, 8), (50, 3, 1, 3)])
def test_kernel_matches_plain_version_on_the_card(cuda_device, b, d, t, dy):
    m, p, ys, f, q, h, r = _setup(b, d, t, dy, seed=9)
    w_obs, hr = ff.evidence_operators(h, r)
    args = (torch.as_tensor(m, device=cuda_device).t().contiguous(),
            fs.sym_fold(torch.as_tensor(p, device=cuda_device)).contiguous(),
            torch.as_tensor(ys, device=cuda_device).transpose(1, 2).contiguous())
    before = ff.LAUNCHES["fused_filter"]
    got = ff.fused_filter(*args, f, q, hr, w_obs)
    want = ff.fused_filter_reference(*args, f, q, hr, w_obs)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=3e-4, atol=3e-4)
    assert ff.LAUNCHES["fused_filter"] == before + 1
