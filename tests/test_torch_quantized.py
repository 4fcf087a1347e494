"""The PyTorch port's quantized payloads against the JAX package: the
quantize wrappers, ``dequant_matmul`` and ``quantized_evidence*`` on the same
seeded inputs (the JAX kernels interpret themselves off the TPU), and the
engine's ``observation_dtype`` option through ``infer_batched`` in both
packages.  Payloads are compared as integers (fp8 through its bytes) and
are expected EQUAL: both sides divide in IEEE float32 and round to nearest
even.

On the CPU the port's wrappers take their plain versions; the CUDA kernels
are held against the same plain versions on the card by the ``gpu``-marked
test below and by ``chip_smoke.py``."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu.ops import quantized as jq
from rxinfer_tpu_torch.models import zoo
from rxinfer_tpu_torch.ops import quantized as tq

CPU = torch.device("cpu")
TOL = dict(rtol=3e-4, atol=3e-4)   # the engine parity tests' tolerance


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rows(case):
    rng = np.random.default_rng(11)
    if case == "scaled":      # per-row scales spread over e^-3 .. e^3
        x = rng.standard_normal((64, 8)) * np.exp(rng.uniform(-3, 3, (64, 1)))
    elif case == "ragged":
        x = rng.standard_normal((777, 6))
    elif case == "wide":
        x = 3.0 * rng.standard_normal((8, 1000))
    elif case == "zero_row":
        x = rng.standard_normal((5, 7))
        x[2] = 0.0
    elif case == "ties":      # x / scale lands exactly on .5 steps
        x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 63.5],
                      [448.0, 17.0, 19.0, 21.0, -17.0, 0.001, -0.001, 1e-4]])
    # one shape for each of the kernels' layouts (pick_quant_layout)
    elif case == "narrow":    # the ingest rows: 4 lanes a row
        x = rng.standard_normal((64, 16)) * np.exp(rng.uniform(-3, 3, (64, 1)))
        x[5] = 0.0
    elif case == "wide_rows":  # a CTA a row, 4 float4 a thread
        x = 2.0 * rng.standard_normal((8, 4096))
    elif case == "over_cap":  # past the wide layout's register cap
        x = rng.standard_normal((3, 16388)) * np.array([[1e-3], [1.0], [1e3]])
    return x.astype(np.float32)


CASES = ["scaled", "ragged", "wide", "zero_row", "ties", "narrow",
         "wide_rows", "over_cap"]


@pytest.mark.parametrize("case", CASES)
def test_quantize_rows_matches_jax(case):
    x = _rows(case)
    jv, js = jq.quantize_rows(jnp.asarray(x))
    tv, ts = tq.quantize_rows(torch.as_tensor(x))
    assert tv.dtype == torch.int8 and tuple(ts.shape) == (x.shape[0], 1)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if case == "zero_row":
        assert not tv[2].any()
        assert float(ts[2]) == pytest.approx(1e-12 / 127, rel=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_quantize_rows_fp8_matches_jax(case):
    x = _rows(case)
    jv, js = jq.quantize_rows_fp8(jnp.asarray(x))
    tv, ts = tq.quantize_rows_fp8(torch.as_tensor(x))
    assert tv.dtype == torch.float8_e4m3fn
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tv.view(torch.uint8).numpy(),
                                  np.asarray(jv).view(np.uint8))
    if case == "zero_row":
        assert not tv[2].view(torch.uint8).any()


def test_reconstruction_error_is_at_the_payloads_resolution():
    x = _rows("scaled")
    t = torch.as_tensor(x)
    absmax = np.abs(x).max(axis=1, keepdims=True)
    v, s = tq.quantize_rows(t)
    assert (np.abs((v.float() * s).numpy() - x) / absmax).max() < 1 / 127 + 1e-3
    v, s = tq.quantize_rows_fp8(t)
    assert (np.abs((v.float() * s).numpy() - x) / absmax).max() < 0.07


@pytest.mark.parametrize("fp8", [False, True], ids=["int8", "fp8"])
@pytest.mark.parametrize("b,dy,dx", [
    (128, 8, 4), (1000, 3, 5), (7, 1, 1),
    # the shapes of the kernel's layouts: 16- and 32-byte rows, dx = 1, 4, 8
    (512, 16, 4), (64, 32, 8), (96, 16, 1), (40, 7, 3), (80, 12, 8)])
def test_dequant_matmul_matches_jax(fp8, b, dy, dx):
    rng = np.random.default_rng(b + dy)
    y = (2.0 * rng.standard_normal((b, dy))).astype(np.float32)
    w = rng.standard_normal((dy, dx)).astype(np.float32)
    jquant = jq.quantize_rows_fp8 if fp8 else jq.quantize_rows
    tquant = tq.quantize_rows_fp8 if fp8 else tq.quantize_rows
    jv, js = jquant(jnp.asarray(y))
    tv, ts = tquant(torch.as_tensor(y))
    jout = jq.dequant_matmul(jv, js, jnp.asarray(w))
    tout = tq.dequant_matmul(tv, ts, torch.as_tensor(w))
    assert tuple(tout.shape) == (b, dx) and tout.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("fp8", [False, True], ids=["int8", "fp8"])
@pytest.mark.parametrize("b,dy,dx", [(64, 128, 128), (8, 20_000, 3)])
def test_dequant_matmul_at_large_w_matches_jax(fp8, b, dy, dx):
    """W of 64 KB, which the kernel holds whole once it opts in to more than
    48 KB of shared memory, and of 240 KB, past an H100 block's 232,448
    bytes, which it stages in row tiles.  The plain version sums over dy in
    index order, the JAX one by ``jnp.dot``: the two may differ by the
    float32 rounding of two sums of dy terms, at most 2 dy 2^-24 times the
    sum of the terms' magnitudes."""
    rng = np.random.default_rng(dy + dx)
    y = (2.0 * rng.standard_normal((b, dy))).astype(np.float32)
    w = rng.standard_normal((dy, dx)).astype(np.float32)
    jquant = jq.quantize_rows_fp8 if fp8 else jq.quantize_rows
    tquant = tq.quantize_rows_fp8 if fp8 else tq.quantize_rows
    jv, js = jquant(jnp.asarray(y))
    tv, ts = tquant(torch.as_tensor(y))
    jout = np.asarray(jq.dequant_matmul(jv, js, jnp.asarray(w)))
    tout = tq.dequant_matmul(tv, ts, torch.as_tensor(w)).numpy()
    assert tout.shape == (b, dx)
    mags = np.abs(tv.double().numpy() * ts.double().numpy()) @ np.abs(w)
    np.testing.assert_array_less(np.abs(tout - jout),
                                 2 * dy * 2.0 ** -24 * mags + 1e-30)
    exact = (tv.double() * ts.double()).numpy() @ w.astype(np.float64)
    np.testing.assert_array_less(np.abs(tout - exact),
                                 dy * 2.0 ** -24 * mags + 1e-30)


@pytest.mark.parametrize("fp8", [False, True], ids=["int8", "fp8"])
def test_quantized_evidence_matches_jax(fp8):
    rng = np.random.default_rng(2)
    b, d = 256, 4
    y = (3.0 * rng.standard_normal((b, d))).astype(np.float32)
    hr_t = (1.3 * np.eye(d) + 0.1 * rng.standard_normal((d, d))).astype(
        np.float32)
    jfn = jq.quantized_evidence_fp8 if fp8 else jq.quantized_evidence
    tfn = tq.quantized_evidence_fp8 if fp8 else tq.quantized_evidence
    tout = tfn(torch.as_tensor(y), torch.as_tensor(hr_t))
    np.testing.assert_allclose(tout.numpy(),
                               np.asarray(jfn(jnp.asarray(y),
                                              jnp.asarray(hr_t))),
                               rtol=1e-5, atol=1e-5)
    exact = y @ hr_t
    assert np.abs(tout.numpy() - exact).max() < (0.07 if fp8 else 0.05) \
        * np.abs(exact).max()


def test_cpu_tensors_take_the_plain_versions_and_bad_inputs_raise():
    x = torch.as_tensor(_rows("ragged"))
    before = dict(tq.LAUNCHES)
    v, s = tq.quantize_rows(x)
    v_r, s_r = tq.quantize_rows_reference(x)
    assert torch.equal(v, v_r) and torch.equal(s, s_r)
    w = torch.ones((6, 2))
    assert torch.equal(tq.dequant_matmul(v, s, w),
                       tq.dequant_matmul_reference(v, s, w))
    assert tq.LAUNCHES == before
    with pytest.raises(TypeError, match="int8 or float8_e4m3fn"):
        tq.dequant_matmul(x, s, w)
    with pytest.raises(ValueError, match="matrix"):
        tq.quantize_rows(x[0])


# -- the quantize kernels' launch rule ----------------------------------------------

SMS = 132                          # an H100 SXM
DEEP_ROWS = 4 * SMS * 64 * 8       # 4 row groups a thread fill 64 warps an SM


@pytest.mark.parametrize("rows,cols,aligned,want", [
    (1000, 1, False, ("general", 1, 1, 0)),
    (1000, 3, False, ("general", 4, 1, 0)),
    (1000, 4, True, ("narrow", 1, 1, 1)),
    (1000, 12, True, ("narrow", 4, 1, 1)),
    (1 << 21, 16, True, ("narrow", 4, 4, 1)),      # the ingest shape
    (100_001, 16, True, ("narrow", 4, 1, 1)),
    (DEEP_ROWS, 16, True, ("narrow", 4, 4, 1)),
    (DEEP_ROWS - 8, 16, True, ("narrow", 4, 1, 1)),
    (1, 16, True, ("narrow", 4, 1, 1)),
    (1000, 128, True, ("narrow", 32, 1, 1)),
    (1000, 129, False, ("general", 32, 1, 0)),
    (1000, 132, True, ("narrow", 32, 1, 2)),
    (4096, 200, True, ("narrow", 32, 1, 2)),       # the engine's rows, T=200
    (4096, 1024, True, ("narrow", 32, 1, 8)),
    (4096, 1028, True, ("wide", 256, 1, 2)),
    (4096, 10_000, True, ("wide", 256, 1, 10)),    # the engine's rows
    (1, 10_000, True, ("wide", 256, 1, 10)),
    (8, 16_384, True, ("wide", 256, 1, 16)),       # the register cap
    (8, 16_388, True, ("general", 32, 1, 0)),      # the cap + 4
    (64, 16, False, ("general", 16, 1, 0)),        # a misaligned pointer
    (4096, 10_000, False, ("general", 32, 1, 0)),
    (1024, 1001, False, ("general", 32, 1, 0)),
    ((1 << 31) // 16 - 1, 16, True, ("narrow", 4, 4, 1)),   # R*C about 2^31
    ((1 << 31) // 16 + 1, 16, True, ("narrow", 4, 4, 1)),
    ((1 << 31) // 10_000, 10_000, True, ("wide", 256, 1, 10)),
    ((1 << 31) // 10_000 + 1, 10_000, True, ("wide", 256, 1, 10)),
])
def test_pick_quant_layout(rows, cols, aligned, want):
    assert tq.pick_quant_layout(rows, cols, aligned, SMS) \
        == tq.QuantLayout(*want)


def test_quant_layouts_cover_their_rows():
    """Every layout the rule picks is one the launcher instantiates, holds
    the whole row, and wastes less than half its lanes' loads: a lane takes
    ``vecs`` float4 of a row, a narrow row ``group`` lanes, a wide row
    ``WIDE_THREADS``."""
    for cols in list(range(1, 1100)) + list(range(1100, 17_000, 97)):
        for aligned in (cols % 4 == 0, False):
            for rows in (1, 5000, 1 << 21):
                lay = tq.pick_quant_layout(rows, cols, aligned, SMS)
                if lay.variant == "narrow":
                    assert aligned and lay.vecs in tq.NARROW_VECS
                    assert lay.group in (1, 2, 4, 8, 16, 32)
                    assert lay.rows_per_thread in (1, tq.NARROW_ROW_GROUPS)
                    assert lay.vecs == 1 or (lay.group, lay.rows_per_thread) \
                        == (32, 1)
                    assert cols <= 4 * lay.group * lay.vecs < 2 * max(cols, 4)
                elif lay.variant == "wide":
                    assert aligned and lay.vecs in tq.WIDE_VECS
                    assert (lay.group, lay.rows_per_thread) \
                        == (tq.WIDE_THREADS, 1)
                    smaller = [v for v in tq.WIDE_VECS if v < lay.vecs]
                    assert tq.NARROW_MAX_COLS < cols \
                        <= 4 * tq.WIDE_THREADS * lay.vecs
                    assert not smaller \
                        or cols > 4 * tq.WIDE_THREADS * smaller[-1]
                else:
                    assert not aligned or cols > tq.WIDE_MAX_COLS
                    assert (lay.group, lay.rows_per_thread, lay.vecs) \
                        == (min(32, 1 << (cols - 1).bit_length()), 1, 0)


def test_vector_alignment_is_read_from_the_tensors():
    x = torch.zeros((8, 16))
    vals = torch.empty((8, 16), dtype=torch.int8)
    assert tq.vector_aligned(x, vals)
    inside = torch.zeros(8 * 16 + 1)[1:].view(8, 16)    # starts 4 bytes in
    assert inside.is_contiguous() and not tq.vector_aligned(inside, vals)
    assert not tq.vector_aligned(x, torch.zeros(8 * 16 + 1,
                                                dtype=torch.int8)[1:].view(8, 16))
    assert not tq.vector_aligned(torch.zeros((8, 18)),
                                 torch.empty((8, 18), dtype=torch.int8))


# -- through the engine -----------------------------------------------------------

def _lgssm(rx, d=2):
    """The LGSSM of the JAX package's quantized-engine test, in either
    package."""
    F = np.array([[0.99, -0.1], [0.1, 0.99]], np.float32)[:d, :d]
    eye = np.eye(d, dtype=np.float32)

    @rx.model
    def m(y):
        T_ = len(y)
        x = rx.latent(T_, name="x")
        x[0] = rx.MvNormal(mean=np.zeros(d, np.float32), cov=25.0 * eye)
        for t in rx.plate(1, T_):
            x[t] = rx.MvNormal(mean=F @ x[t - 1], cov=eye)
        for t in rx.plate(T_):
            y[t] = rx.MvNormal(mean=x[t], cov=eye)
        return {"x": x}

    return m


def _observations(seed, B=8, T=64, d=2):
    return (3.0 * np.random.default_rng(seed).standard_normal((B, T, d))
            ).astype(np.float32)


@pytest.mark.parametrize("obs_dtype,level", [("int8", 0.05),
                                             ("float8_e4m3fn", 0.07)])
def test_engine_observation_dtype_matches_jax(obs_dtype, level):
    y = _observations(5)
    opts = {"observation_dtype": obs_dtype}
    jpost, _ = jrx.infer_batched(_lgssm(jrx), {"y": y}, iterations=2,
                                 options=opts)
    tpost, _ = trx.infer_batched(_lgssm(trx), {"y": y}, iterations=2,
                                 options=opts, device=CPU)
    np.testing.assert_allclose(tpost["x"].mu.numpy(),
                               np.asarray(jpost["x"].mu), **TOL)
    np.testing.assert_allclose(tpost["x"].sigma.numpy(),
                               np.asarray(jpost["x"].sigma), **TOL)
    # and close to the float32 run at the payload's resolution
    fpost, _ = trx.infer_batched(_lgssm(trx), {"y": y}, iterations=2,
                                 device=CPU)
    mu_f = fpost["x"].mu
    assert float((tpost["x"].mu - mu_f).abs().max()) \
        < level * float(mu_f.abs().max())


@pytest.mark.parametrize("obs_dtype", ["int8", "float8_e4m3fn"])
def test_engine_on_quantized_observations_equals_float32_on_dequantized(
        obs_dtype):
    """Consistent inference on quantized observations: the quantized run on y
    equals the float32 run on the dequantized observations (quantization
    axis: time, one scale per chain and channel)."""
    y = _observations(6)
    B, T, d = y.shape
    quant = tq.quantize_rows if obs_dtype == "int8" else tq.quantize_rows_fp8
    rows = torch.as_tensor(y.transpose(0, 2, 1).reshape(B * d, T).copy())
    vals, scales = quant(rows)
    y_hat = (vals.float() * scales).reshape(B, d, T).transpose(1, 2).numpy()
    pq, _ = trx.infer_batched(_lgssm(trx), {"y": y}, iterations=2, device=CPU,
                              options={"observation_dtype": obs_dtype})
    ph, _ = trx.infer_batched(_lgssm(trx), {"y": y_hat}, iterations=2,
                              device=CPU)
    np.testing.assert_allclose(pq["x"].mu.numpy(), ph["x"].mu.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_unknown_observation_dtype_raises():
    with pytest.raises(ValueError, match="observation_dtype"):
        trx.infer_batched(_lgssm(trx), {"y": _observations(7)}, device=CPU,
                          options={"observation_dtype": "int4"})


def test_observation_dtype_warns_without_a_fused_gaussian_plan():
    rng = np.random.default_rng(8)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=(2, 12))]
    init = {"A": trx.DirichletCollection(np.ones((3, 3), np.float32)),
            "B": trx.DirichletCollection(np.float32(np.eye(3) * 5.0 + 1.0))}
    kwargs = dict(iterations=2, initialization=init, device=CPU)
    with pytest.warns(UserWarning, match="observation_dtype"):
        post, _ = trx.infer_batched(
            zoo.hmm(3, 3), {"y": y},
            options={"observation_dtype": "int8"}, **kwargs)
    plain, _ = trx.infer_batched(zoo.hmm(3, 3), {"y": y}, **kwargs)
    assert torch.equal(post["s"].probs(), plain["s"].probs())
    # "warn": False silences it
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        trx.infer_batched(zoo.hmm(3, 3), {"y": y}, **kwargs,
                          options={"observation_dtype": "int8", "warn": False})


def test_the_payload_is_built_once_per_call(monkeypatch):
    calls = []
    real = tq.quantize_rows

    def counting(x):
        calls.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr(tq, "quantize_rows", counting)
    y = _observations(9, B=3, T=20)
    _, prog = trx.batched_program(_lgssm(trx), {"y": y}, iterations=3,
                                  options={"observation_dtype": "int8"},
                                  device=CPU)
    prog({"y": y})
    assert calls == [(3 * 2, 20)]      # rows (B * F, T), one call for 3 sweeps
    prog({"y": y})
    assert len(calls) == 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the quantize and dequantize kernels "
                    "run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_kernels_match_plain_versions_on_the_card(cuda_device, case):
    x = torch.as_tensor(_rows(case), device=cuda_device)
    w = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (x.shape[1], 3)).astype(np.float32), device=cuda_device)
    before = dict(tq.LAUNCHES)
    for quant, ref in ((tq.quantize_rows, tq.quantize_rows_reference),
                       (tq.quantize_rows_fp8, tq.quantize_rows_fp8_reference)):
        v, s = quant(x)
        v_r, s_r = ref(x)
        assert torch.equal(s, s_r)
        assert torch.equal(v.view(torch.uint8), v_r.view(torch.uint8))
        assert torch.equal(tq.dequant_matmul(v, s, w),
                           tq.dequant_matmul_reference(v, s, w))
    assert tq.LAUNCHES == {"quantize_rows": before["quantize_rows"] + 1,
                           "quantize_rows_fp8": before["quantize_rows_fp8"] + 1,
                           "dequant_matmul": before["dequant_matmul"] + 2}
