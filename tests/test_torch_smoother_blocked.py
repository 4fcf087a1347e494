"""The time-blocked smoother of the PyTorch port: the associative element
algebra (``rxinfer_tpu_torch/ops/kalman.py``) against the JAX package's
(``rxinfer_tpu/ops/kalman.py``), the plain version of the fold / carry /
replay passes against the step-by-step plain version and against the JAX
package's Pallas smoother (interpret mode on the CPU), and the rule that
picks the number of time blocks.

The CUDA kernels are held against the step-by-step plain version on the
card by the ``gpu``-marked test below and by ``chip_smoke.py``."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxinfer_tpu.ops import kalman as jk
from rxinfer_tpu.ops.pallas_smoother import (
    fused_batched_smoother as jax_fused_batched_smoother,
)
from rxinfer_tpu_torch.ops import fused_smoother as fs
from rxinfer_tpu_torch.ops import kalman as tk

# The element algebra runs the same closed-form inverses in both packages;
# what differs is the order of summation inside the matrix products.
ELEM_TOL = dict(rtol=1e-5, atol=1e-5)
# Blocked against step-by-step plain version: they differ only through the
# carried entry states, a few float32 roundoffs on these stable systems; and
# the file-wide tolerance of test_torch_smoother.py against the JAX kernels.
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=3e-4, atol=3e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _system(d, seed):
    rng = np.random.default_rng(seed)
    qm, _ = np.linalg.qr(rng.standard_normal((d, d)))
    f = (0.97 * qm).astype(np.float32)
    q = (0.4 * np.eye(d)).astype(np.float32)
    a = 0.3 * rng.standard_normal((d, d))
    w = (0.8 * np.eye(d) + a @ a.T).astype(np.float32)
    bvec = (0.1 * np.arange(d)).astype(np.float32)
    return f, bvec, q, w


@functools.lru_cache(maxsize=None)
def _inputs(b, d, t):
    rng = np.random.default_rng(1000 * d + t)
    xi = rng.standard_normal((t, b, d)).astype(np.float32)
    m0 = rng.standard_normal((b, d)).astype(np.float32)
    p0 = np.broadcast_to(9.0 * np.eye(d, dtype=np.float32), (b, d, d)).copy()
    return (m0, p0, xi) + _system(d, seed=d + t)


def _chain(d, t, seed):
    """One chain with time-varying parameters, as ChainParams fields."""
    rng = np.random.default_rng(seed)
    fs_, bs, qs, ws = [], [], [], []
    for k in range(t):
        f, bvec, q, w = _system(d, seed=seed + 17 * k)
        fs_.append(f), bs.append(bvec), qs.append(q * (1 + 0.1 * k)), ws.append(w)
    m0 = rng.standard_normal(d).astype(np.float32)
    a = 0.5 * rng.standard_normal((d, d))
    p0 = (2.0 * np.eye(d) + a @ a.T).astype(np.float32)
    xi = rng.standard_normal((t, d)).astype(np.float32)
    return dict(m0=m0, P0=p0, F=np.stack(fs_[1:]), b=np.stack(bs[1:]),
                Q=np.stack(qs[1:]), xi=xi, W=np.stack(ws))


def _to_torch(tree):
    return tuple(torch.as_tensor(np.array(x)) for x in tree)


def _assert_trees_close(got, want, **tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


# -- (a) element constructors and composes against the JAX package ---------------

@pytest.mark.parametrize("d", [1, 2, 3, 4, 5])
def test_filter_elements_match_jax(d):
    c = _chain(d, 6, seed=d)
    want = jk._make_filter_elements(
        jk.ChainParams(**{k: jnp.asarray(v) for k, v in c.items()}))
    got = tk.make_filter_elements(*_to_torch(
        [c[k] for k in ("m0", "P0", "F", "b", "Q", "xi", "W")]))
    _assert_trees_close(got, want, **ELEM_TOL)
    # element 0 is the exact filtered state at t = 0: A = eta = J = 0
    assert not got[0][0].any() and not got[3][0].any() and not got[4][0].any()


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5])
def test_filter_compose_matches_jax(d):
    c = _chain(d, 6, seed=20 + d)
    elems = jk._make_filter_elements(
        jk.ChainParams(**{k: jnp.asarray(v) for k, v in c.items()}))
    pick = lambda t: tuple(e[t] for e in elems)
    for i, j in ((0, 1), (1, 2), (3, 5)):
        want = jk._filter_compose(pick(i), pick(j))
        got = tk.filter_compose(_to_torch(pick(i)), _to_torch(pick(j)))
        _assert_trees_close(got, want, **ELEM_TOL)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5])
def test_smoother_elements_and_compose_match_jax(d):
    c = _chain(d, 6, seed=40 + d)
    p = jk.ChainParams(**{k: jnp.asarray(v) for k, v in c.items()})
    fm, fc = jk.sequential_filter(p)
    want = jk._make_smoother_elements(p, fm, fc)
    got = tk.make_smoother_elements(*_to_torch((fm, fc, c["F"], c["b"], c["Q"])))
    _assert_trees_close(got, want, **ELEM_TOL)
    assert not got[0][-1].any()                       # the last step's E is 0
    pick = lambda t: tuple(e[t] for e in want)
    for later, earlier in ((5, 4), (3, 2), (1, 0)):
        w = jk._smooth_compose(pick(later), pick(earlier))
        g = tk.smooth_compose(_to_torch(pick(later)), _to_torch(pick(earlier)))
        _assert_trees_close(g, w, **ELEM_TOL)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_folded_filter_elements_give_the_filtered_moments(d):
    """The (b, C) of the prefix composites are the filtered moments (what
    ``parallel_filter`` reads off its scan), and ``filter_apply`` continues a
    filter from a state."""
    c = _chain(d, 7, seed=60 + d)
    p = jk.ChainParams(**{k: jnp.asarray(v) for k, v in c.items()})
    fm, fc = jk.sequential_filter(p)
    elems = tk.make_filter_elements(*_to_torch(
        [c[k] for k in ("m0", "P0", "F", "b", "Q", "xi", "W")]))
    pick = lambda t: tuple(e[t] for e in elems)
    comp = pick(0)
    for t in range(1, 7):
        comp = tk.filter_compose(comp, pick(t))
        np.testing.assert_allclose(comp[1].numpy(), np.asarray(fm[t]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(comp[2].numpy(), np.asarray(fc[t]),
                                   rtol=1e-4, atol=1e-4)
    tail = tk.filter_compose(tk.filter_compose(pick(4), pick(5)), pick(6))
    m, pm = tk.filter_apply(torch.as_tensor(np.asarray(fm[3])),
                            torch.as_tensor(np.asarray(fc[3])), tail)
    np.testing.assert_allclose(m.numpy(), np.asarray(fm[6]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pm.numpy(), np.asarray(fc[6]), rtol=1e-4, atol=1e-4)


# -- (c) composing is associative ---------------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 4])
def test_filter_compose_is_associative(d):
    c = _chain(d, 10, seed=80 + d)
    elems = tk.make_filter_elements(*_to_torch(
        [c[k] for k in ("m0", "P0", "F", "b", "Q", "xi", "W")]))

    def fold(t0, t1):
        comp = tuple(e[t0] for e in elems)
        for t in range(t0 + 1, t1):
            comp = tk.filter_compose(comp, tuple(e[t] for e in elems))
        return comp

    x, y, z = fold(1, 4), fold(4, 7), fold(7, 10)
    left = tk.filter_compose(tk.filter_compose(x, y), z)
    right = tk.filter_compose(x, tk.filter_compose(y, z))
    for g, w in zip(left, right):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_smooth_compose_is_associative(d):
    c = _chain(d, 10, seed=90 + d)
    p = jk.ChainParams(**{k: jnp.asarray(v) for k, v in c.items()})
    fm, fc = jk.sequential_filter(p)
    elems = tk.make_smoother_elements(*_to_torch((fm, fc, c["F"], c["b"], c["Q"])))

    def fold(t0, t1):                      # last step first
        comp = tuple(e[t1 - 1] for e in elems)
        for t in range(t1 - 2, t0 - 1, -1):
            comp = tk.smooth_compose(comp, tuple(e[t] for e in elems))
        return comp

    x, y, z = fold(0, 3), fold(3, 6), fold(6, 10)      # z is the latest
    left = tk.smooth_compose(tk.smooth_compose(z, y), x)
    right = tk.smooth_compose(z, tk.smooth_compose(y, x))
    for g, w in zip(left, right):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


# -- (b) the blocked plain versions ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _stepwise(b, d, t):
    m0, p0, xi, f, bvec, q, w = _inputs(b, d, t)
    args = [torch.as_tensor(a) for a in (m0, p0, xi)]
    mf, pf = fs.fused_forward_reference(*args, f, bvec, q, w)
    return (mf, pf) + tuple(fs.fused_backward_reference(mf, pf, f, bvec, q))


@functools.lru_cache(maxsize=None)
def _jax_smoother(b, d, t):
    m0, p0, xi, f, bvec, q, w = _inputs(b, d, t)
    out = jax_fused_batched_smoother(
        jnp.asarray(m0), jnp.asarray(p0), jnp.asarray(xi), f, bvec, q, w,
        chunk=4, interpret=True)
    return tuple(np.asarray(o) for o in out)


def _block_counts(t):
    return sorted({1, 2, 5, t})


CASES = [(d, t, blocks) for d in (1, 2, 4) for t in (1, 2, 3, 64)
         for blocks in _block_counts(t)]


@pytest.mark.parametrize("d,t,blocks", CASES)
def test_blocked_plain_version_matches_stepwise_and_jax(d, t, blocks):
    b = 3
    m0, p0, xi, f, bvec, q, w = _inputs(b, d, t)
    args = [torch.as_tensor(a) for a in (m0, p0, xi)]
    mf_r, pf_r, ms_r, ps_r, cr_r = _stepwise(b, d, t)
    mf, pf = fs.fused_forward_blocked_reference(*args, f, bvec, q, w, blocks)
    # the backward pass on the step-by-step filtered moments, so that each
    # pass is held on its own
    ms, ps, cr = fs.fused_backward_blocked_reference(mf_r, pf_r, f, bvec, q,
                                                     blocks)
    for got, want in ((mf, mf_r), (pf, pf_r), (ms, ms_r), (ps, ps_r),
                      (cr, cr_r)):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, **BLOCK_TOL)
    if t == 1:
        return          # the JAX wrapper raises at T = 1 (ROADMAP queue C)
    # both passes chained, in the contract layout, against the JAX kernels
    ms2, ps2, cr2 = fs.fused_backward_blocked_reference(mf, pf, f, bvec, q,
                                                        blocks)
    jm, jp, jc = _jax_smoother(b, d, t)
    tm, tp, tc = (o.numpy() for o in fs._unpack(ms2, ps2, cr2, d))
    np.testing.assert_allclose(tm, jm, **JAX_TOL)
    np.testing.assert_allclose(tp, jp, **JAX_TOL)
    np.testing.assert_allclose(tc, jc, **JAX_TOL)


def test_one_block_is_the_stepwise_recursion_exactly():
    b, d, t = 3, 4, 9
    m0, p0, xi, f, bvec, q, w = _inputs(b, d, t)
    args = [torch.as_tensor(a) for a in (m0, p0, xi)]
    mf_r, pf_r, ms_r, ps_r, cr_r = _stepwise(b, d, t)
    mf, pf = fs.fused_forward_blocked_reference(*args, f, bvec, q, w, 1)
    ms, ps, cr = fs.fused_backward_blocked_reference(mf, pf, f, bvec, q, 1)
    for got, want in ((mf, mf_r), (pf, pf_r), (ms, ms_r), (ps, ps_r),
                      (cr, cr_r)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("t,blocks,want", [
    (10, 1, [(0, 10)]),
    (10, 3, [(0, 4), (4, 8), (8, 10)]),          # ragged last block
    (64, 5, [(0, 13), (13, 26), (26, 39), (39, 52), (52, 64)]),
    (3, 5, [(0, 1), (1, 2), (2, 3)]),            # more blocks than steps
    (1, 1, [(0, 1)]),
    (10, 4, [(0, 3), (3, 6), (6, 9), (9, 10)]),
    (9, 4, [(0, 3), (3, 6), (6, 9)]),            # 4 asked, 3 non-empty
])
def test_time_blocks(t, blocks, want):
    assert fs.time_blocks(t, blocks) == want


# -- (d) the rule that picks the number of blocks -------------------------------------

H100_SMS = 132


def test_pick_blocks_fills_the_card_at_the_main_shape():
    s = fs.pick_blocks(1024, 10_000, 4, H100_SMS)
    warps = 1024 * s / 32
    assert 32 <= s <= fs.MAX_BLOCKS
    assert 1000 <= warps <= 4 * H100_SMS * fs.SCHEDULERS_PER_SM
    assert len(fs.time_blocks(10_000, s)) == s


@pytest.mark.parametrize("b,t", [(30_000, 10_000), (100_000, 200),
                                 (10_000, 200), (1024, 100), (8, 1), (8, 2),
                                 (50, 255)])
def test_pick_blocks_is_one_for_large_batches_and_short_chains(b, t):
    assert fs.pick_blocks(b, t, 4, H100_SMS) == 1


@pytest.mark.parametrize("b", [1, 8, 64, 1000, 1024, 4096, 8000])
@pytest.mark.parametrize("t", [256, 257, 1000, 2000, 10_000, 100_003])
def test_pick_blocks_never_cuts_below_the_least_block_length(b, t):
    s = fs.pick_blocks(b, t, 4, H100_SMS)
    spans = fs.time_blocks(t, s)
    assert len(spans) == s and 1 <= s <= fs.MAX_BLOCKS
    if s > 1:
        assert s >= fs.MIN_BLOCKS
        assert all(t1 - t0 >= fs.MIN_BLOCK_STEPS for t0, t1 in spans[:-1])
        assert spans[-1][1] - spans[-1][0] >= 1


@pytest.mark.parametrize("d", range(1, fs.MAX_DIM + 1))
def test_pick_blocks_is_one_for_every_d_without_a_fold(d):
    s = fs.pick_blocks(1024, 10_000, d, H100_SMS)
    if d > fs.FOLD_MAX_DIM:
        assert s == 1
    else:
        assert s > 1


def test_small_batches_take_the_most_blocks():
    assert fs.pick_blocks(8, 2000, 4, H100_SMS) == len(
        fs.time_blocks(2000, 2000 // fs.MIN_BLOCK_STEPS))
    assert fs.pick_blocks(8, 100_000, 4, H100_SMS) == fs.MAX_BLOCKS


def test_scratch_rows_hold_a_composite_and_an_entry_state():
    for d in range(1, fs.MAX_DIM + 1):
        nsym = d * (d + 1) // 2
        assert fs.forward_scratch_rows(d) == (d * d + 2 * d + 2 * nsym) + d + nsym
        assert fs.backward_scratch_rows(d) == (d * d + d + nsym) + d + nsym


def test_cpu_tensors_never_reach_the_block_rule(monkeypatch):
    """On CPU tensors the wrappers take the step-by-step plain version and
    count no launch, whatever the shape."""
    monkeypatch.setattr(fs, "_device_blocks", lambda *a: pytest.fail(
        "the block rule was asked for CPU tensors"))
    m0, p0, xi, f, bvec, q, w = _inputs(3, 2, 64)
    before = dict(fs.LAUNCHES)
    out = fs.fused_batched_smoother(torch.as_tensor(m0), torch.as_tensor(p0),
                                    torch.as_tensor(xi), f, bvec, q, w)
    assert out[0].shape == (64, 3, 2) and fs.LAUNCHES == before


# -- the kernels on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the smoother kernels run only on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("d,b,t,blocks", [(4, 8, 2000, None), (3, 40, 1001, 7),
                                          (4, 1024, 300, 9), (1, 5, 77, 77),
                                          (2, 50, 2, 2)])
def test_blocked_kernels_match_plain_version_on_the_card(cuda_device, d, b, t,
                                                         blocks):
    """``blocks`` None: whatever the rule picks (more than one block at this
    shape); else that many blocks through the launchers."""
    m0, p0, xi, f, bvec, q, w = _inputs(b, d, t)
    args = [torch.as_tensor(a, device=cuda_device) for a in (m0, p0, xi)]
    before = dict(fs.LAUNCHES)
    if blocks is None:
        assert fs._device_blocks(b, t, d, cuda_device) > 1
        mf, pf = fs.fused_forward(*args, f, bvec, q, w)
        ms, ps, cr = fs.fused_backward(mf, pf, f, bvec, q)
    else:
        assert len(fs.time_blocks(t, blocks)) == blocks
        mf, pf = fs._forward_cuda(*args, f, bvec, q, w, blocks)
        ms, ps, cr = fs._backward_cuda(mf, pf, f, bvec, q, blocks)
    mf_r, pf_r = fs.fused_forward_reference(*args, f, bvec, q, w)
    ms_r, ps_r, cr_r = fs.fused_backward_reference(mf, pf, f, bvec, q)
    torch.cuda.synchronize()
    for got, want in ((mf, mf_r), (pf, pf_r), (ms, ms_r), (ps, ps_r),
                      (cr, cr_r)):
        torch.testing.assert_close(got, want, **JAX_TOL)
    assert fs.LAUNCHES["fused_smoother_fwd"] == before["fused_smoother_fwd"] + 1
    assert fs.LAUNCHES["fused_smoother_bwd"] == before["fused_smoother_bwd"] + 1
