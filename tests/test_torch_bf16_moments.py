"""bf16 moments (ROADMAP V2): the smoother stores the packed filtered and
smoothed covariances and the cross in bf16, rounded where the JAX kernels
round them (``rxinfer_tpu/ops/pallas_smoother.py:127, 194, 196``), and
keeps means and arithmetic in float32.

On the CPU the port's plain versions are held against the JAX package's
Pallas smoother with ``moment_dtype=bfloat16`` in interpret mode (as the
JAX package's own tests run it), the blocked plain versions at one time
block against several, and the engine with
``options={"fused_moment_dtype": "bfloat16"}`` against the JAX package's
engine on the CPU, with the free energy.  The ``gpu``-marked tests hold the
bf16 kernels against their plain versions on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu.ops.pallas_smoother import (
    fused_batched_smoother as jax_fused_batched_smoother,
)
from rxinfer_tpu_torch.ops import fused_smoother as fs

BF16 = torch.bfloat16
# float32 values (means) against JAX or a float32 path: the JAX package's
# smoother-test tolerance.
TOL = dict(rtol=3e-4, atol=3e-4)
# bf16 moments against bf16 moments: two bf16 ulps relative.  Both sides
# round the same float32 recursion at the same places, and here they agree
# bit for bit; a float32 rounding difference between the two libraries can
# still put an entry on the other side of a bf16 rounding boundary, one
# ulp (2^-8 to 2^-7 relative) away, which the next step carries along.
MOMENT_TOL = dict(rtol=1.6e-2, atol=3e-4)
# bf16 against float32: the JAX package's own levels
# (tests/parallel/test_pallas_smoother.py:82-85).
MEAN_VS_F32, COV_VS_F32, CROSS_VS_F32 = 3e-2, 3e-2, 5e-2
# The free-energy trace: a sum over T steps of log-determinants and
# quadratic forms of the (upcast) bf16 moments, in float32.
FE_TOL = dict(rtol=1e-5, atol=1e-3)
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
    w = (0.8 * np.eye(d) + a @ a.T).astype(np.float32)
    bvec = (0.1 * np.arange(d)).astype(np.float32)
    xi = rng.standard_normal((t, b, d)).astype(np.float32)
    m0 = rng.standard_normal((b, d)).astype(np.float32)
    p0 = np.broadcast_to(9.0 * np.eye(d, dtype=np.float32), (b, d, d)).copy()
    return m0, p0, xi, f, bvec, q, w


def _spd(rng, n, d, scale):
    a = 0.3 * rng.standard_normal((n, d, d))
    return (scale * np.eye(d) + a @ np.swapaxes(a, -1, -2)).astype(np.float32)


@pytest.mark.parametrize("d,b,t", [(2, 5, 23), (4, 5, 23), (4, 3, 9)])
def test_plain_bf16_smoother_matches_jax_interpret(d, b, t):
    m0, p0, xi, f, bvec, q, w = _params(b, d, t, seed=d + t)
    jm, jp, jc = jax_fused_batched_smoother(
        jnp.asarray(m0), jnp.asarray(p0), jnp.asarray(xi), f, bvec, q, w,
        chunk=4, interpret=True, moment_dtype=jnp.bfloat16)
    tm, tp, tc = fs.fused_batched_smoother(
        torch.as_tensor(m0), torch.as_tensor(p0), torch.as_tensor(xi), f,
        bvec, q, w, moment_dtype=BF16)
    assert tm.dtype == tp.dtype == tc.dtype == torch.float32
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **MOMENT_TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **MOMENT_TOL)
    # and within the JAX package's bf16 levels of the float32 smoother
    fm, fp, fc = fs.fused_batched_smoother(
        torch.as_tensor(m0), torch.as_tensor(p0), torch.as_tensor(xi), f,
        bvec, q, w)
    np.testing.assert_allclose(tm.numpy(), fm.numpy(), rtol=0,
                               atol=MEAN_VS_F32)
    np.testing.assert_allclose(tp.numpy(), fp.numpy(), rtol=COV_VS_F32,
                               atol=COV_VS_F32)
    np.testing.assert_allclose(tc.numpy(), fc.numpy(), rtol=0,
                               atol=CROSS_VS_F32)


def test_bf16_rounds_where_the_jax_kernels_round():
    """K1 stores pf rounded, K2 reads it rounded; at T-1 the smoothed
    moment is the rounded filtered one, and the smoothed state is carried in
    float32 (rounding it at each step would differ)."""
    m0, p0, xi, f, bvec, q, w = _params(3, 3, 12, seed=5)
    args = (torch.as_tensor(m0), torch.as_tensor(p0), torch.as_tensor(xi),
            f, bvec, q, w)
    mf, pf = fs.fused_forward(*args, moment_dtype=BF16)
    mf32, pf32 = fs.fused_forward(*args)
    assert pf.dtype == BF16 and mf.dtype == torch.float32
    torch.testing.assert_close(mf, mf32, rtol=0, atol=0)   # state in float32
    torch.testing.assert_close(pf, pf32.to(BF16), rtol=0, atol=0)
    ms, ps, cr = fs.fused_backward(mf, pf, f, bvec, q)
    assert ps.dtype == cr.dtype == BF16
    torch.testing.assert_close(ps[-1], pf[-1], rtol=0, atol=0)
    torch.testing.assert_close(ms[-1], mf[-1], rtol=0, atol=0)
    # the backward pass of the float32 stream upcast from bf16 gives the
    # same float32 recursion; only the stores round
    ms2, ps2, cr2 = fs.fused_backward(mf, pf.float(), f, bvec, q)
    torch.testing.assert_close(ms, ms2, rtol=0, atol=0)
    torch.testing.assert_close(ps, ps2.to(BF16), rtol=0, atol=0)
    torch.testing.assert_close(cr, cr2.to(BF16), rtol=0, atol=0)
    assert fs.sym_unfold_t(ps, 3).dtype == torch.float32


@pytest.mark.parametrize("dyn", [False, True])
def test_bf16_blocked_plain_versions_match_one_block(dyn):
    """S > 1 against S = 1: the carried entry states (float32) differ in
    rounding only, so the means agree at float32 level and the moments
    within two bf16 ulps."""
    d, b, t = 3, 4, 70
    m0, p0, xi, f, bvec, q, w = _params(b, d, t, seed=11)
    rng = np.random.default_rng(12)
    wb = torch.as_tensor(_spd(rng, b, d, 0.8)) if dyn else None
    qb = torch.as_tensor(_spd(rng, b, d, 0.4)) if dyn else None
    w_sh, q_sh = (None, None) if dyn else (w, q)
    args = (torch.as_tensor(m0), torch.as_tensor(p0), torch.as_tensor(xi),
            f, bvec, q_sh, w_sh)
    one = fs.fused_forward_blocked_reference(*args, 1, wb, qb, BF16)
    many = fs.fused_forward_blocked_reference(*args, 5, wb, qb, BF16)
    torch.testing.assert_close(one[0], fs.fused_forward_reference(
        *args, wb, qb, BF16)[0], rtol=0, atol=0)
    torch.testing.assert_close(many[0], one[0], **TOL)
    torch.testing.assert_close(many[1].float(), one[1].float(), **MOMENT_TOL)
    bone = fs.fused_backward_blocked_reference(*one, f, bvec, q_sh, 1, qb)
    bmany = fs.fused_backward_blocked_reference(*one, f, bvec, q_sh, 4, qb)
    assert bmany[1].dtype == bmany[2].dtype == BF16
    torch.testing.assert_close(bmany[0], bone[0], **TOL)
    for got, want in zip(bmany[1:], bone[1:]):
        torch.testing.assert_close(got.float(), want.float(), **MOMENT_TOL)


def test_moment_dtype_is_checked():
    m0, p0, xi, f, bvec, q, w = _params(2, 2, 3)
    args = (torch.as_tensor(m0), torch.as_tensor(p0), torch.as_tensor(xi))
    with pytest.raises(ValueError, match="bfloat16"):
        fs.fused_forward(*args, f, bvec, q, w, moment_dtype=torch.float16)
    mf, pf = fs.fused_forward(*args, f, bvec, q, w, moment_dtype=BF16)
    with pytest.raises(ValueError, match="pf is torch.bfloat16"):
        fs.fused_backward(mf, pf, f, bvec, q, moment_dtype=torch.float32)


# -- the engine -------------------------------------------------------------------

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


def constants(d, seed=0):
    rng = np.random.default_rng(seed)
    th = np.pi / 35
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                   np.float32)
    A = np.kron(np.eye(d // 2, dtype=np.float32), rot)
    Q = (0.5 * np.eye(d)).astype(np.float32)
    H = (1.3 * np.eye(d) + 0.1 * rng.standard_normal((d, d))).astype(np.float32)
    R = (np.eye(d) + 0.2 * np.ones((d, d))).astype(np.float32)
    m0 = (0.1 * np.arange(d)).astype(np.float32)
    V0 = (25.0 * np.eye(d)).astype(np.float32)
    return A, Q, H, R, m0, V0


BF16_OPTS = {"fused_moment_dtype": "bfloat16"}


@pytest.mark.parametrize("d", [2, 4])
def test_bf16_engine_matches_jax_with_free_energy(d):
    c = constants(d, seed=d)
    y = np.random.default_rng(3).standard_normal((3, 20, d)).astype(
        np.float32)
    _, jprog = jrx.batched_program(lgssm_source(jrx, *c), {"y": y},
                                   iterations=2, free_energy=True,
                                   options=BF16_OPTS)
    jstate, jfe, _ = jprog({"y": jnp.asarray(y)})
    tcomp, tprog = trx.batched_program(lgssm_source(trx, *c), {"y": y},
                                       iterations=2, free_energy=True,
                                       options=BF16_OPTS, device=CPU)
    assert tcomp.fused_moment_dtype == "bfloat16"
    assert tcomp.plan_report()["x"]["fused"] is True
    tstate, tfe, _ = tprog({"y": y})
    np.testing.assert_allclose(tstate["x"].mu.numpy(),
                               np.asarray(jstate["x"].mu), **TOL)
    np.testing.assert_allclose(tstate["x"].sigma.numpy(),
                               np.asarray(jstate["x"].sigma), **MOMENT_TOL)
    np.testing.assert_allclose(tfe.numpy(), np.asarray(jfe), **FE_TOL)
    # and the float32 program within the bf16 levels
    _, t32 = trx.batched_program(lgssm_source(trx, *c), {"y": y},
                                 iterations=2, free_energy=True, device=CPU)
    s32, fe32, _ = t32({"y": y})
    np.testing.assert_allclose(tstate["x"].mu.numpy(), s32["x"].mu.numpy(),
                               rtol=0, atol=MEAN_VS_F32)
    np.testing.assert_allclose(tfe.numpy(), fe32.numpy(), rtol=1e-3)


def test_bf16_engine_with_per_chain_precisions_matches_jax():
    """The dynamic tier (W and Q per chain) with bf16 moments, against the
    JAX package's engine (interpret mode)."""
    d = 2
    a = (0.9 * np.eye(d)).astype(np.float32)
    eye = np.eye(d, dtype=np.float32)

    def source(rx):
        @rx.model
        def hier(y):
            T = len(y)
            wq = rx.Wishart(float(d) + 1.0, eye)
            wr = rx.Wishart(float(d) + 1.0, eye)
            x = rx.latent(T, name="x")
            x[0] = rx.MvNormal(mean=np.zeros(d, np.float32), cov=10.0 * eye)
            for t in rx.plate(1, T):
                x[t] = rx.MvNormal(mean=a @ x[t - 1], precision=wq)
            for t in rx.plate(T):
                y[t] = rx.MvNormal(mean=x[t], precision=wr)
            return {"x": x}

        return hier

    y = np.cumsum(np.random.default_rng(9).standard_normal((2, 16, d)),
                  axis=1).astype(np.float32)
    jinit = {"wq": jrx.Wishart(3.0, eye), "wr": jrx.Wishart(3.0, eye)}
    tinit = {k: trx.Wishart(torch.tensor(3.0), torch.as_tensor(eye))
             for k in ("wq", "wr")}
    _, jprog = jrx.batched_program(source(jrx), {"y": y}, iterations=3,
                                   initialization=jinit, options=BF16_OPTS)
    jstate, _, _ = jprog({"y": jnp.asarray(y)})
    tcomp, tprog = trx.batched_program(source(trx), {"y": y}, iterations=3,
                                       initialization=tinit,
                                       options=BF16_OPTS, device=CPU)
    assert tcomp.plan_report()["x"]["dynamic"] == ["W", "Q"]
    tstate, _, _ = tprog({"y": y})
    np.testing.assert_allclose(tstate["x"].mu.numpy(),
                               np.asarray(jstate["x"].mu), **TOL)
    np.testing.assert_allclose(tstate["x"].sigma.numpy(),
                               np.asarray(jstate["x"].sigma), **MOMENT_TOL)
    np.testing.assert_allclose(tstate["wr"].mean().numpy(),
                               np.asarray(jstate["wr"].mean()), rtol=1e-3)


def test_the_memory_gate_reads_the_moment_dtype():
    """d > 8 behind the device-memory gate: bf16 moments need fewer bytes,
    and a budget below the moment streams keeps the chain on the scans."""
    from rxinfer_tpu_torch.engine.batched import fused_moment_bytes

    assert fused_moment_bytes(16, 2048, 1024, "bfloat16") < \
        fused_moment_bytes(16, 2048, 1024, "float32")
    nsym = 16 * 17 // 2
    assert fused_moment_bytes(16, 2048, 1024) == \
        2048 * (2 * 16 + 2 * nsym + 16 * 16) * 4 * 1024 * 2
    c = tuple(np.eye(10, dtype=np.float32) if x.ndim == 2 else
              np.zeros(10, np.float32) for x in constants(10))
    y = np.zeros((2, 5, 10), np.float32)
    small = fused_moment_bytes(10, 5, 2) - 1
    comp, _ = trx.batched_program(
        lgssm_source(trx, *c), {"y": y}, device=CPU,
        options={"hbm_budget_bytes": small, "warn": False})
    report = comp.plan_report()["x"]
    assert report["fused"] is False
    assert "exceed the device-memory budget" in report["reason"]
    comp, _ = trx.batched_program(
        lgssm_source(trx, *c), {"y": y}, device=CPU,
        options={"hbm_budget_bytes": small + 1, "warn": False})
    assert comp.plan_report()["x"]["fused"] is True


# -- on the card --------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bf16 smoother kernels run only "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("d,b,t,dyn", [(4, 1000, 257, False),
                                       (3, 40, 1001, True), (8, 64, 32, False),
                                       (12, 64, 8, True)])
def test_bf16_kernels_match_plain_version_on_the_card(cuda_device, d, b, t,
                                                      dyn):
    """The bf16 instantiations (the register kernels' fold, carry and replay
    at the wrapper's number of time blocks; the wide kernels at d = 12)
    against the plain version of the same passes, each wrapper call counted
    once under its ``_bf16`` key."""
    m0, p0, xi, f, bvec, q, w = _params(b, d, t, seed=30 + d)
    rng = np.random.default_rng(31)
    dev = lambda a: torch.as_tensor(a, device=cuda_device)
    wb = dev(_spd(rng, b, d, 0.8)) if dyn else None
    qb = dev(_spd(rng, b, d, 0.4)) if dyn else None
    q_sh, w_sh = (None, None) if dyn else (q, w)
    args = (dev(m0), dev(p0), dev(xi), f, bvec, q_sh, w_sh)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    blocks = fs.pick_blocks(b, t, d, sms)
    before = dict(fs.LAUNCHES)
    mf, pf = fs.fused_forward(*args, wb, qb, moment_dtype=BF16)
    ms, ps, cr = fs.fused_backward(mf, pf, f, bvec, q_sh, qb)
    torch.cuda.synchronize()
    mf_r, pf_r = fs.fused_forward_blocked_reference(*args, blocks, wb, qb,
                                                    BF16)
    ms_r, ps_r, cr_r = fs.fused_backward_blocked_reference(
        mf, pf, f, bvec, q_sh, blocks, qb)
    torch.testing.assert_close(mf, mf_r, **TOL)
    torch.testing.assert_close(ms, ms_r, **TOL)
    for got, want in ((pf, pf_r), (ps, ps_r), (cr, cr_r)):
        assert got.dtype == BF16
        torch.testing.assert_close(got.float(), want.float(), **MOMENT_TOL)
    for direction in ("fwd", "bwd"):
        key = fs.launch_key(direction, d, dyn, True)
        assert fs.LAUNCHES[key] == before[key] + 1
