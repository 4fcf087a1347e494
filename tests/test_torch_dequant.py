"""The dequantize + product kernel K8's layouts: the rules
(``pick_dequant_layout``, ``dequant_tiles``) and the alignment it reads from
the tensors, on the CPU, and each layout and W whole or in tiles against the
plain version on the card, bit for bit (``gpu``-marked; they decide inside a fixture whether there is a
card).  This file imports neither JAX nor the JAX package, so the card
tests run on a machine without them:

    python -m pytest --noconftest -m gpu tests/test_torch_dequant.py
"""

import pytest
import torch

from rxinfer_tpu_torch.ops import quantized as tq

SMS = 132                                   # an H100 SXM
FULL = SMS * tq.WARPS_PER_SM * 32           # threads that fill every SM


@pytest.mark.parametrize("rows,dy,dx,aligned,want", [
    (1 << 21, 16, 4, True, ("vector", 4)),    # the ingest shape
    (100_001, 16, 4, True, ("vector", 1)),
    (4 * FULL, 16, 4, True, ("vector", 4)),
    (4 * FULL - 4, 16, 4, True, ("vector", 1)),
    (4 * FULL - 3, 16, 4, True, ("vector", 4)),   # ragged last row group
    (2 * FULL, 16, 4, True, ("vector", 1)),
    (4096, 32, 8, True, ("vector", 1)),
    (4096, 16, 1, True, ("general", 1)),      # dx = 1
    (4096, 16, 5, True, ("general", 1)),      # odd dx
    (65_536, 8, 3, True, ("general", 1)),     # rows of 8 bytes
    (65_536, 12, 8, True, ("general", 1)),
    (1000, 3, 5, True, ("general", 1)),       # odd dy
    (1000, 1, 1, True, ("general", 1)),       # dy = 1
    (1000, 6, 4, True, ("general", 1)),
    (1 << 21, 16, 4, False, ("general", 1)),  # a misaligned view
    (1, 16, 4, True, ("vector", 1)),
])
def test_pick_dequant_layout(rows, dy, dx, aligned, want):
    assert tq.pick_dequant_layout(rows, dy, dx, aligned,
                                  SMS) == tq.DequantLayout(*want)


def test_dequant_layouts_are_ones_the_launcher_takes():
    for dy in range(1, 70):
        for dx in (1, 2, 3, 4, 5, 8, 12):
            for rows in (1, 999, FULL, 4 * FULL - 4, 5 * FULL):
                for aligned in (True, False):
                    lay = tq.pick_dequant_layout(rows, dy, dx, aligned, SMS)
                    vector = aligned and dy % 16 == 0 and dx % 4 == 0
                    assert lay.variant == ("vector" if vector else "general")
                    deep = -(-rows // tq.DEQUANT_ROWS_PER_THREAD) >= FULL
                    assert lay.rows_per_thread == (
                        tq.DEQUANT_ROWS_PER_THREAD if vector and deep else 1)


H100_SMEM = 232_448                         # shared bytes a block may opt in to


@pytest.mark.parametrize("dy,dx,limit,want", [
    (16, 4, H100_SMEM, (16, 4)),              # the ingest W: whole
    (128, 128, H100_SMEM, (128, 128)),        # 64 KB: whole, opted in
    (400, 128, H100_SMEM, (400, 128)),        # 200 KB: whole
    (454, 128, H100_SMEM, (454, 128)),        # 232,448 bytes exactly
    (455, 128, H100_SMEM, (455, 4)),          # column tiles, one row tile
    (20_000, 3, H100_SMEM, (14_528, 4)),      # past the limit: row tiles
    (100_000, 1, H100_SMEM, (14_528, 4)),
    (16, 4000, H100_SMEM, (16, 4)),           # short and wide: column tiles
    (5000, 100, 48 * 1024, (3072, 4)),        # a smaller limit
])
def test_dequant_tiles(dy, dx, limit, want):
    assert tq.dequant_tiles(dy, dx, limit) == want


@pytest.mark.parametrize("limit", [48 * 1024, 100_000, H100_SMEM])
def test_dequant_tiles_fit_the_limit_and_cover_w(limit):
    for dy in (1, 15, 16, 17, 255, 1024, 4096, 14_529, 40_000):
        for dx in (1, 3, 4, 5, 64, 128, 1000):
            kt, ct = tq.dequant_tiles(dy, dx, limit)
            assert kt * ct * 4 <= limit
            if dy * dx * 4 <= limit:
                assert (kt, ct) == (dy, dx)
            else:
                assert ct == tq.DEQUANT_TILE_COLS and 1 <= kt <= dy
                # whole 16-byte payload loads in every tile but the last
                assert kt == dy or kt % tq.DEQUANT_TILE_ROW_ALIGN == 0
                # as many rows as fit
                assert kt == dy or (kt + tq.DEQUANT_TILE_ROW_ALIGN) \
                    * ct * 4 > limit


def test_dequant_alignment_is_read_from_the_tensors():
    vals = torch.zeros((8, 16), dtype=torch.int8)
    out = torch.empty((8, 4))
    assert tq.dequant_aligned(vals, out)
    inside = torch.zeros(8 * 16 + 4, dtype=torch.int8)[4:].view(8, 16)
    assert inside.is_contiguous() and not tq.dequant_aligned(inside, out)
    assert not tq.dequant_aligned(vals, torch.empty(8 * 4 + 1)[1:].view(8, 4))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the dequantize kernel runs only on "
                    "the card")
    return torch.device("cuda")


def _payload(rows, dy, device, fp8, start=0):
    gen = torch.Generator(device=device).manual_seed(rows + dy)
    x = torch.randn((rows, dy), generator=gen, device=device)
    x.mul_(torch.exp(6.0 * torch.rand((rows, 1), generator=gen,
                                      device=device) - 3.0))
    if rows > 1:
        x[1] = 0.0
    vals, scales = (tq.quantize_rows_fp8 if fp8 else tq.quantize_rows)(x)
    if start:
        store = torch.empty(rows * dy + start, dtype=vals.dtype,
                            device=device)
        view = store[start:].view(rows, dy)
        view.copy_(vals)
        vals = view
    return vals, scales


@pytest.mark.gpu
@pytest.mark.parametrize("fp8", [False, True], ids=["int8", "fp8"])
@pytest.mark.parametrize("rows,dy,dx,start", [
    (100_001, 16, 4, 0), (4096, 32, 8, 0), (1000, 3, 5, 0),
    (65_536, 8, 3, 0), (4099, 12, 8, 0), (777, 16, 1, 0), (5000, 16, 4, 4),
    (33, 1, 1, 0)])
def test_each_layout_equals_the_plain_version(cuda_device, fp8, rows, dy, dx,
                                              start):
    vals, scales = _payload(rows, dy, cuda_device, fp8, start)
    w = torch.randn((dy, dx), generator=torch.Generator(
        device=cuda_device).manual_seed(dx), device=cuda_device)
    want = tq.dequant_matmul_reference(vals, scales, w)
    got = tq.dequant_matmul(vals, scales, w)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    out = torch.empty_like(got)
    aligned = tq.dequant_aligned(vals, out)
    layouts = {tq.pick_dequant_layout(rows, dy, dx, aligned, SMS),
               tq.DequantLayout("general", 1)}
    if aligned and dy % 16 == 0 and dx % 4 == 0:
        layouts |= {tq.DequantLayout("vector", u)
                    for u in (1, tq.DEQUANT_ROWS_PER_THREAD)}
    for lay in sorted(layouts, key=str):
        got = tq._dequant_cuda(vals, scales, w, lay)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), lay


@pytest.mark.gpu
@pytest.mark.parametrize("fp8", [False, True], ids=["int8", "fp8"])
@pytest.mark.parametrize("rows,dy,dx", [
    (4096, 128, 128),     # W of 64 KB: whole, past the default 48 KB
    (2048, 400, 128),     # 200 KB: whole, near the opt-in limit
    (4096, 455, 128),     # just past it: column tiles, one row tile
    (1000, 20_000, 3),    # 240 KB, odd dx: row tiles, general layout
    (3000, 16_384, 4),    # 256 KB, aligned: row tiles, vector layout
])
def test_any_w_equals_the_plain_version(cuda_device, fp8, rows, dy, dx):
    vals, scales = _payload(rows, dy, cuda_device, fp8)
    w = torch.randn((dy, dx), generator=torch.Generator(
        device=cuda_device).manual_seed(dy), device=cuda_device)
    want = tq.dequant_matmul_reference(vals, scales, w)
    before = tq.LAUNCHES["dequant_matmul"]
    got = tq.dequant_matmul(vals, scales, w)
    torch.cuda.synchronize()
    assert tq.LAUNCHES["dequant_matmul"] == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        tq.device_dequant_tiles(dy, dx, cuda_device)


@pytest.mark.gpu
def test_the_launcher_refuses_a_layout_the_tensors_do_not_allow(cuda_device):
    vals, scales = _payload(64, 16, cuda_device, False, start=4)
    w = torch.ones((16, 4), device=cuda_device)
    with pytest.raises(RuntimeError, match="dequant_matmul kernel"):
        tq._dequant_cuda(vals, scales, w, tq.DequantLayout("vector", 1))
    vals, scales = _payload(64, 8, cuda_device, False)
    with pytest.raises(RuntimeError, match="dequant_matmul kernel"):
        tq._dequant_cuda(vals, scales, torch.ones((8, 4), device=cuda_device),
                         tq.DequantLayout("vector", 1))
    vals, scales = _payload(64, 16, cuda_device, False)
    with pytest.raises(RuntimeError, match="dequant_matmul kernel"):
        tq._dequant_cuda(vals, scales, w, tq.DequantLayout("vector", 2))
    # W tiles other than the rule's at the device's limit
    lib = tq._library()
    out = torch.empty((64, 4), device=cuda_device)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    for tiles in ((8, 4), (16, 2), (0, 4)):
        assert lib.rxt_dequant_matmul(
            0, 1, 1, *tiles, vals.data_ptr(), scales.data_ptr(),
            w.data_ptr(), out.data_ptr(), 64, 16, 4, stream) != 0
