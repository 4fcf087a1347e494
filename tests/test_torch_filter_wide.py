"""The fused filter at the (d, dy) the register kernel does not take (ROADMAP
V5): state dims 9 to 16 at any observation dim, and more than eight
observations at any d <= 8.  On the card these launch the wide kernel of
``csrc/fused_filter_wide.cu``; on the CPU the plain version runs, which
this file holds against the JAX package: its Pallas filter in interpret mode
at d = dy = 9 (one case: the interpreter traces a d^3 step body) and its
``filtering_scan`` elsewhere, through ``fused_filtering_scan`` and
``make_sharded_filtering(fused=True)``.  The routing between the two kernels
is pinned, and the ``gpu``-marked test holds the wide kernel against the
plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from rxinfer_tpu_torch.parallel.filtering import make_sharded_filtering

TOL = dict(rtol=2e-4, atol=2e-4)   # the JAX package's filter-test tolerance
# The wide kernel against the plain version on the card: RTOL / ATOL of
# chip_smoke.py (Gauss-Jordan against the Schur recursion, fused
# multiply-adds: rounding only).
KERNEL_TOL = dict(rtol=3e-4, atol=3e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _setup(b, d, t, dy, seed=0):
    """A stable system (rotation blocks for even d, a contraction
    otherwise), H (dy, d) with a random part, as in test_torch_filter.py."""
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


def test_plain_filter_at_nine_dims_matches_the_jax_kernel():
    m, p, ys, f, q, h, r = _setup(4, 9, 5, 9, seed=9)
    ref = jax_fused_filtering_scan(*_jax_args(m, p, ys, f, q, h, r),
                                   chunk=8, interpret=True)
    state = convert.filter_state_from_numpy(m, p)
    port = ff.fused_filtering_scan(state, torch.as_tensor(ys), f, q, h, r)
    assert tuple(port[1].shape) == (5, 4, 9)
    _assert_same(port, ref)


@pytest.mark.parametrize("d,dy", [(12, 3), (16, 16), (4, 12), (16, 40)])
def test_plain_filter_matches_jax_filtering_scan(d, dy):
    b, t = 5, 7
    m, p, ys, f, q, h, r = _setup(b, d, t, dy, seed=d + dy)
    ref = jax_filtering_scan(*_jax_args(m, p, ys, f, q, h, r))
    state = convert.filter_state_from_numpy(m, p)
    port = ff.fused_filtering_scan(state, torch.as_tensor(ys), f, q, h, r)
    assert tuple(port[1].shape) == (t, b, d)
    _assert_same(port, ref)


def test_sharded_filtering_fused_at_sixteen_dims_matches_jax():
    """``make_sharded_filtering(fused=True)`` at d = 16 on the CPU (the
    kernel's plain version), twice in a row as continuous batching calls it:
    the state of the first call carries into the second."""
    m, p, ys, f, q, h, r = _setup(3, 16, 8, 16, seed=4)
    fn = make_sharded_filtering(None, f, q, h, r, fused=True, device="cpu")
    state = convert.filter_state_from_numpy(m, p)
    before = dict(ff.LAUNCHES)
    mid, first = fn(state, ys[:4])
    final, second = fn(mid, ys[4:])
    assert ff.LAUNCHES == before
    jfinal, jmeans = jax_filtering_scan(*_jax_args(m, p, ys, f, q, h, r))
    _assert_same((final, torch.cat([first, second])), (jfinal, jmeans))


@pytest.mark.parametrize("d,dy,key", [(1, 1, "fused_filter"),
                                      (8, 8, "fused_filter"),
                                      (8, 9, "fused_filter_wide"),
                                      (9, 1, "fused_filter_wide"),
                                      (16, 40, "fused_filter_wide")])
def test_launch_key_routes_past_the_register_kernel(d, dy, key):
    assert ff.launch_key(d, dy) == key


def test_seventeen_dims_run_past_the_wide_kernel_and_match_jax():
    """One state dim past the wide kernel: routed to the warp kernel's key,
    and on the CPU its plain version matches the JAX ``filtering_scan``."""
    assert ff.launch_key(17, 2) == "fused_filter_warp"
    m, p, ys, f, q, h, r = _setup(2, 17, 3, 2, seed=17)
    ref = jax_filtering_scan(*_jax_args(m, p, ys, f, q, h, r))
    state = convert.filter_state_from_numpy(m, p)
    port = ff.fused_filtering_scan(state, torch.as_tensor(ys), f, q, h, r)
    assert tuple(port[1].shape) == (3, 2, 17)
    _assert_same(port, ref)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the wide filter kernel runs only on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,t,dy", [(37, 9, 65, 1), (100, 12, 33, 9),
                                      (40, 4, 20, 12), (33, 16, 9, 40)])
def test_wide_kernel_matches_plain_version_on_the_card(cuda_device, b, d, t,
                                                       dy):
    m, p, ys, f, q, h, r = _setup(b, d, t, dy, seed=9)
    w_obs, hr = ff.evidence_operators(h, r)
    args = (torch.as_tensor(m, device=cuda_device).t().contiguous(),
            fs.sym_fold(torch.as_tensor(p, device=cuda_device)).contiguous(),
            torch.as_tensor(ys, device=cuda_device).transpose(1, 2).contiguous())
    before = ff.LAUNCHES["fused_filter_wide"]
    got = ff.fused_filter(*args, f, q, hr, w_obs)
    want = ff.fused_filter_reference(*args, f, q, hr, w_obs)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **KERNEL_TOL)
    assert ff.LAUNCHES["fused_filter_wide"] == before + 1
