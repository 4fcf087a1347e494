"""The fused filter at state dims above 16 (ROADMAP V6): on the card these
launch the warp kernel of ``csrc/fused_filter_warp.cu``; on the CPU the
plain version runs, which this file holds against the JAX package's
``filtering_scan`` through ``fused_filtering_scan`` and
``make_sharded_filtering(fused=True)`` (two calls that carry the state).
The JAX Pallas filter in interpret mode traces a d^3 step body and takes
minutes at d = 17, so it is not the reference here.  The routing at the
tier edges and the warp kernel's plan rule (``warp_plan``) are pinned, and
the ``gpu``-marked test holds the warp kernel against the plain version on
the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxinfer_tpu.parallel.filtering import (
    FilterState as JaxFilterState,
    filtering_scan as jax_filtering_scan,
)
from rxinfer_tpu_torch import convert
from rxinfer_tpu_torch.ops import fused_filter as ff
from rxinfer_tpu_torch.ops import fused_smoother as fs
from rxinfer_tpu_torch.parallel.filtering import make_sharded_filtering

TOL = dict(rtol=2e-4, atol=2e-4)   # the JAX package's filter-test tolerance
# The warp kernel against the plain version on the card: RTOL / ATOL of
# chip_smoke.py (Gauss-Jordan against the Schur recursion, fused
# multiply-adds: rounding only).
KERNEL_TOL = dict(rtol=3e-4, atol=3e-4)
H100_SMEM = 232_448   # shared bytes an H100 block may opt in to
# (d, dy): the first warp d with one observation-chunk's worth, a square
# model, two observation chunks, and the first d with two columns a lane
SHAPES = [(17, 4), (24, 24), (32, 40), (33, 5)]


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


_REFS: dict = {}


def _case(d, dy):
    """The inputs of (d, dy) and the JAX ``filtering_scan`` on them, traced
    once for both entry points' tests."""
    if (d, dy) not in _REFS:
        m, p, ys, f, q, h, r = _setup(4, d, 3, dy, seed=d + dy)
        ref = jax_filtering_scan(
            JaxFilterState(jnp.asarray(m), jnp.asarray(p)), jnp.asarray(ys),
            jnp.asarray(f), jnp.asarray(q), jnp.asarray(h), jnp.asarray(r))
        _REFS[(d, dy)] = (m, p, ys, f, q, h, r), ref
    return _REFS[(d, dy)]


def _assert_same(port, ref):
    (final, means), (jfinal, jmeans) = port, ref
    np.testing.assert_allclose(means.numpy(), np.asarray(jmeans), **TOL)
    np.testing.assert_allclose(final.m.numpy(), np.asarray(jfinal.m), **TOL)
    np.testing.assert_allclose(final.p.numpy(), np.asarray(jfinal.p), **TOL)


@pytest.mark.parametrize("d,dy", SHAPES)
def test_plain_filter_matches_jax_filtering_scan(d, dy):
    (m, p, ys, f, q, h, r), ref = _case(d, dy)
    state = convert.filter_state_from_numpy(m, p)
    before = dict(ff.LAUNCHES)
    port = ff.fused_filtering_scan(state, torch.as_tensor(ys), f, q, h, r)
    assert ff.LAUNCHES == before
    assert tuple(port[1].shape) == (3, 4, d)
    _assert_same(port, ref)


@pytest.mark.parametrize("d,dy", SHAPES)
def test_sharded_filtering_fused_in_two_calls_matches_jax(d, dy):
    """``make_sharded_filtering(fused=True)`` on the CPU (the kernel's plain
    version), twice in a row as continuous batching calls it: the state of
    the first call carries into the second."""
    (m, p, ys, f, q, h, r), ref = _case(d, dy)
    fn = make_sharded_filtering(None, f, q, h, r, fused=True, device="cpu")
    state = convert.filter_state_from_numpy(m, p)
    before = dict(ff.LAUNCHES)
    mid, first = fn(state, ys[:2])
    final, second = fn(mid, ys[2:])
    assert ff.LAUNCHES == before
    _assert_same((final, torch.cat([first, second])), ref)


@pytest.mark.parametrize("d,dy,key", [(8, 8, "fused_filter"),
                                      (16, 1, "fused_filter_wide"),
                                      (16, 40, "fused_filter_wide"),
                                      (17, 1, "fused_filter_warp"),
                                      (17, 40, "fused_filter_warp"),
                                      (64, 64, "fused_filter_warp"),
                                      (200, 3, "fused_filter_warp")])
def test_launch_key_routes_by_state_dim(d, dy, key):
    assert ff.launch_key(d, dy) == key
    assert key in ff.LAUNCHES


@pytest.mark.parametrize("d", [17, 32, 33, 64, 96, 97, 160, 161, 300])
def test_warp_plan_fits_an_h100_block(d):
    plan = ff.warp_plan(d, H100_SMEM)
    assert plan["smem_bytes"] <= H100_SMEM
    # to d = 32 the tensor-core tier (tests/test_torch_filter_tensor.py);
    # the sweep tiers' plan below still holds at those d
    assert plan["tier"] == ("tensor_cores" if d <= 32 else "sweep")
    plan = ff.sweep_warp_plan(d, H100_SMEM)
    dp, stride = plan["padded_dim"], plan["stride"]
    assert dp % 8 == 0 and d <= dp < d + 8
    # whole float4 rows; a column read spreads over 8 banks
    assert stride % 4 == 0 and stride % 8 == 4 and stride > dp
    assert plan["lanes_per_chain"] == 32
    assert plan["columns_per_lane"] == -(-d // 32)
    assert 1 <= plan["chains_per_block"] <= ff.WARP_MAX_CHAINS
    assert plan["smem_bytes"] <= H100_SMEM
    # the parameters sit in shared memory to d = 96, the chains' matrices to
    # d = 160; past that both are read from device memory
    assert plan["params"] == ("shared" if d <= 96 else "device")
    assert plan["chain_matrices"] == ("shared" if d <= 160 else "device")


def test_warp_plan_bytes_and_tiers_follow_the_limit():
    """The shared bytes are the parameters' (if shared) plus each chain's
    vectors and (if shared) two matrices; a smaller limit moves the
    parameters, then the chain matrices, to device memory."""
    d = 20
    mat = 24 * 28 * 4
    vec = (4 * 24 + ff.WARP_Y_CHUNK) * 4
    # an H100 takes the tensor-core tier at d = 20, the sweep's plan below
    assert ff.warp_plan(d, H100_SMEM)["tier"] == "tensor_cores"
    full = ff.sweep_warp_plan(d, H100_SMEM)
    assert full["chains_per_block"] == 8
    assert full["smem_bytes"] == 4 * mat + 8 * (2 * mat + vec)
    mid = ff.sweep_warp_plan(d, 4 * mat + 2 * mat + vec - 1)
    assert (mid["params"], mid["chain_matrices"]) == ("device", "shared")
    assert mid["smem_bytes"] == mid["chains_per_block"] * (2 * mat + vec)
    low = ff.sweep_warp_plan(d, 2 * mat + vec - 1)
    assert (low["params"], low["chain_matrices"]) == ("device", "device")
    assert low["smem_bytes"] == low["chains_per_block"] * vec
    assert 1 <= low["chains_per_block"] <= 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the warp filter kernel runs only on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,t,dy", [(37, 17, 5, 1), (33, 32, 4, 40),
                                      (10, 33, 3, 5), (9, 64, 2, 8)])
def test_warp_kernel_matches_plain_version_on_the_card(cuda_device, b, d, t,
                                                       dy):
    m, p, ys, f, q, h, r = _setup(b, d, t, dy, seed=9)
    w_obs, hr = ff.evidence_operators(h, r)
    args = (torch.as_tensor(m, device=cuda_device).t().contiguous(),
            fs.sym_fold(torch.as_tensor(p, device=cuda_device)).contiguous(),
            torch.as_tensor(ys, device=cuda_device).transpose(1, 2).contiguous())
    before = ff.LAUNCHES["fused_filter_warp"]
    got = ff.fused_filter(*args, f, q, hr, w_obs)
    want = ff.fused_filter_reference(*args, f, q, hr, w_obs)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **KERNEL_TOL)
    assert ff.LAUNCHES["fused_filter_warp"] == before + 1
