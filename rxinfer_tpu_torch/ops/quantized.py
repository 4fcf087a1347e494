"""Quantized observation payloads: per-row int8 / fp8 (e4m3) quantization and
the fused dequantize + small matrix product, each as a CUDA kernel with its
plain PyTorch version (counterpart of ``rxinfer_tpu/ops/quantized.py``).

A payload is ``(vals, scales)`` with ``x ~= float(vals) * scales``: vals
(R, C) in one byte per element, scales (R, 1) float32, one scale per row.

    int8: scale = max(absmax, 1e-12) / 127 ; vals = clip(round(x / scale), +-127)
    fp8 : scale = max(absmax, 1e-12) / 448 ; vals = float8_e4m3fn(x / scale)

Rounding is to nearest, ties to even, in both.  The evidence projection
``xi = (float(vals) * scales) @ W`` of a (R, dy) payload against a (dy, dx)
operator is the streaming-ingest message: ``quantized_evidence`` quantizes a
batch of observations and projects it in two kernel launches.

Kernels (``csrc/quantized.cu``): ``quantize_rows`` replaces
``_quantize_kernel`` (quantized.py:50-56), ``quantize_rows_fp8`` replaces
``_quantize_fp8_kernel`` (:153-158), ``dequant_matmul`` replaces
``_dequant_matmul_kernel`` (:107-109).  Each wrapper takes its plain version
when its tensors lie on the CPU and launches its kernel when they lie on a
CUDA device; there is no fallback from a kernel to its plain version.
``LAUNCHES`` counts kernel launches.  The kernels take any (R, C), so the
row blocks and the zero-padded tail of the TPU wrappers have no counterpart.

The quantize kernels come in three variants, and ``pick_quant_layout``
picks one before the launch from the shape, the alignment of the tensors
and the card's SM count: ``narrow`` (a warp or less a row, ``float4``
loads; rows of at most ``NARROW_MAX_COLS`` columns), ``wide`` (a CTA a row
held in registers; up to ``WIDE_MAX_COLS`` columns) and ``general`` (any
rows, two passes).  Each computes the same function; a layout is never
retried.  The dequantize + product kernel takes a thread per payload row
in one of two layouts that ``pick_dequant_layout`` picks the same way:
``vector`` (16-byte payload loads, U rows a thread, ``float4`` stores) and
``general`` (byte loads, scalar stores, any rows).  W sits in a block's
shared memory whole while it fits the device's opt-in limit, else in tiles
of rows by ``DEQUANT_TILE_COLS`` columns (``dequant_tiles``), so it takes
any W.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from .. import kernels

INT8_MAX = 127.0
FP8_MAX = 448.0   # largest finite float8_e4m3fn

# The quantize kernels' layouts (csrc/quantized.cu numbers the variants so).
VARIANTS = {"general": 0, "narrow": 1, "wide": 2}
NARROW_VECS = (1, 2, 4, 8)     # float4 a lane: the instances
NARROW_MAX_COLS = 4 * 32 * NARROW_VECS[-1]   # a warp a row, 1024
NARROW_ROW_GROUPS = 4          # row groups a thread when rows are plenty
WARPS_PER_SM = 64              # resident warps an SM holds at most
WIDE_THREADS = 256             # a CTA a row
WIDE_VECS = (2, 4, 8, 10, 12, 16)   # float4 a thread: the instances
WIDE_MAX_COLS = 4 * WIDE_THREADS * WIDE_VECS[-1]   # the register cap, 16384

# The dequantize + product kernel's layouts (csrc/quantized.cu numbers them).
DEQUANT_VARIANTS = {"general": 0, "vector": 1}
DEQUANT_ROWS_PER_THREAD = 4        # rows a thread where rows are plenty
DEQUANT_TILE_COLS = 4              # W's columns a block takes past the limit
DEQUANT_TILE_ROW_ALIGN = 16        # a row tile is whole 16-byte payload loads

# kernel launches on CUDA tensors (the plain versions on CPU tensors count none)
LAUNCHES = {"quantize_rows": 0, "quantize_rows_fp8": 0, "dequant_matmul": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- plain PyTorch versions -----------------------------------------------------

def _row_scale(x, qmax: float):
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    # the divisor is a tensor on x's device: on a CUDA device torch divides a
    # tensor by a Python number as a multiplication by its reciprocal, which
    # is not the IEEE quotient the CPU, the JAX package and the kernel give
    return torch.clamp(absmax, min=1e-12) / absmax.new_full((), qmax)


def quantize_rows_reference(x):
    """Plain per-row symmetric int8 quantization: ``(vals int8, scales)``."""
    scale = _row_scale(x, INT8_MAX)
    q = torch.clamp(torch.round(x / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def quantize_rows_fp8_reference(x):
    """Plain per-row scaled fp8 (e4m3) quantization."""
    scale = _row_scale(x, FP8_MAX)
    return (x / scale).to(torch.float8_e4m3fn), scale


def dequant_matmul_reference(vals, scales, w):
    """Plain ``(float(vals) * scales) @ w``, summed in index order over dy
    with every product and sum rounded on its own, as the kernel does."""
    v = vals.to(torch.float32) * scales
    acc = v[:, 0:1] * w[0]
    for k in range(1, v.shape[1]):
        acc = acc + v[:, k:k + 1] * w[k]
    return acc


# -- launch rule ----------------------------------------------------------------

@dataclass(frozen=True)
class QuantLayout:
    """A quantize launch: the ``variant``, the lanes a row (``group``), the
    rows a thread takes (``rows_per_thread``: row groups of its warp, for
    ``narrow``) and the ``float4`` a lane holds of each (``vecs``; 0 for
    ``general``, which holds none)."""

    variant: str
    group: int
    rows_per_thread: int
    vecs: int


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@functools.lru_cache(maxsize=256)
def pick_quant_layout(rows: int, cols: int, aligned: bool,
                      sm_count: int) -> QuantLayout:
    """The quantize kernels' layout for x (rows, cols) on a card with
    ``sm_count`` SMs.  ``aligned``: cols % 4 == 0 and both x and the payload
    start on 16 bytes, so that a lane may load a row's columns as
    ``float4`` and store its payload bytes as one 32-bit word.

    * ``narrow`` for aligned rows of at most 128 columns: cols / 4 lanes a
      row, rounded up to a power of two, a float4 a lane; each thread takes
      ``NARROW_ROW_GROUPS`` row groups when that still leaves every SM its
      ``WARPS_PER_SM`` warps, else one.  Up to ``NARROW_MAX_COLS``: a warp
      a row, the fewest ``NARROW_VECS`` float4 a lane that hold it.
    * ``wide`` for aligned rows up to ``WIDE_MAX_COLS``: a CTA of
      ``WIDE_THREADS`` a row, the fewest ``WIDE_VECS`` float4 a thread that
      hold the row.
    * ``general`` for the rest: the power of two covering min(cols, 32)
      lanes a row, two passes."""
    if aligned and cols <= 4 * 32:
        group = _pow2_at_least(max(1, cols // 4))
        row_groups = -(-rows // (32 // group))
        deep = row_groups >= NARROW_ROW_GROUPS * sm_count * WARPS_PER_SM
        return QuantLayout("narrow", group,
                           NARROW_ROW_GROUPS if deep else 1, 1)
    if aligned and cols <= NARROW_MAX_COLS:
        need = -(-cols // (4 * 32))
        return QuantLayout("narrow", 32, 1,
                           min(v for v in NARROW_VECS if v >= need))
    if aligned and cols <= WIDE_MAX_COLS:
        need = -(-cols // (4 * WIDE_THREADS))
        return QuantLayout("wide", WIDE_THREADS, 1,
                           min(v for v in WIDE_VECS if v >= need))
    return QuantLayout("general", _pow2_at_least(min(cols, 32)), 1, 0)


@dataclass(frozen=True)
class DequantLayout:
    """A dequantize + product launch: the ``variant`` and the payload rows
    a thread takes (``rows_per_thread``)."""

    variant: str
    rows_per_thread: int


@functools.lru_cache(maxsize=256)
def pick_dequant_layout(rows: int, dy: int, dx: int, aligned: bool,
                        sm_count: int) -> DequantLayout:
    """The dequantize + product kernel's layout for a payload (rows, dy)
    against W (dy, dx) on a card with ``sm_count`` SMs.  ``aligned``: the
    payload and the output both start on 16 bytes (``dequant_aligned``).

    * ``vector`` for aligned payloads with dy % 16 == 0 and dx % 4 == 0
      (the ingest rows): each row read in 16-byte loads, the outputs
      stored a ``float4`` at a time; each thread takes
      ``DEQUANT_ROWS_PER_THREAD`` rows where that still leaves every SM
      ``WARPS_PER_SM`` warps, else one.
    * ``general`` for the rest: a thread a row, byte loads, scalar stores."""
    if aligned and dy % 16 == 0 and dx % 4 == 0:
        full = sm_count * WARPS_PER_SM * 32
        deep = -(-rows // DEQUANT_ROWS_PER_THREAD) >= full
        return DequantLayout("vector",
                             DEQUANT_ROWS_PER_THREAD if deep else 1)
    return DequantLayout("general", 1)


@functools.lru_cache(maxsize=256)
def dequant_tiles(dy: int, dx: int, smem_limit: int) -> tuple[int, int]:
    """``(row_tile, col_tile)``: the part of W (dy, dx) float32 that a block
    of the dequantize + product kernel stages in shared memory on a device
    whose blocks may take ``smem_limit`` bytes (232,448 on an H100).  W
    whole, ``(dy, dx)``, while it fits; else each block takes
    ``DEQUANT_TILE_COLS`` output columns (the column tiles of one block of
    rows are neighbouring blocks, so they share its payload in L2) and walks dy
    in row tiles of as many rows as fit, a multiple of
    ``DEQUANT_TILE_ROW_ALIGN``, its sums carried across them in k order
    (csrc/quantized.cu computes the same and refuses another plan)."""
    if dy * dx * 4 <= smem_limit:
        return dy, dx
    rows = smem_limit // (4 * DEQUANT_TILE_COLS)
    rows -= rows % DEQUANT_TILE_ROW_ALIGN
    return min(dy, rows), DEQUANT_TILE_COLS


def dequant_aligned(vals, out) -> bool:
    """Whether the payload ``vals`` and the output ``out`` both start on 16
    bytes (a contiguous view that starts inside its storage may not)."""
    return vals.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0


def device_dequant_layout(vals, out) -> DequantLayout:
    """The layout ``dequant_matmul`` takes for the payload ``vals`` (R, dy)
    and its output ``out`` (R, dx) on their CUDA device."""
    rows, dy = vals.shape
    return pick_dequant_layout(rows, dy, out.shape[1],
                               dequant_aligned(vals, out),
                               kernels.sm_count(vals.device))


def vector_aligned(x, vals) -> bool:
    """Whether x (R, C) and its payload may be read and written a vector
    at a time: C % 4 == 0 and both start on 16 bytes (a contiguous view
    that starts inside its storage may not)."""
    return (x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0
            and vals.data_ptr() % 16 == 0)


def device_quant_layout(x, vals) -> QuantLayout:
    """The layout the quantize wrappers take for x and its payload ``vals``
    on their CUDA device."""
    rows, cols = x.shape
    return pick_quant_layout(rows, cols, vector_aligned(x, vals),
                             kernels.sm_count(x.device))


# -- kernel launches ------------------------------------------------------------

def _library():
    lib = kernels.load("quantized")
    if not getattr(lib, "_rxt_typed", False):
        p = ctypes.c_void_p
        lib.rxt_quantize_rows.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, p, p, p, ctypes.c_int64, ctypes.c_int64, p]
        lib.rxt_quantize_rows.restype = ctypes.c_int
        lib.rxt_dequant_matmul.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, p, p, p, p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, p]
        lib.rxt_dequant_matmul.restype = ctypes.c_int
        lib.rxt_dequant_smem_optin.restype = ctypes.c_int
        lib._rxt_typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    lib = _library()
    with torch.cuda.device(index):
        return lib.rxt_dequant_smem_optin()


def device_dequant_tiles(dy: int, dx: int, device) -> tuple[int, int]:
    """``dequant_tiles`` with the shared-memory limit of the CUDA
    ``device``."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return dequant_tiles(dy, dx, _smem_optin(index))


def _quantize(x, name: str, dtype, reference):
    if x.ndim != 2:
        raise ValueError(f"{name} takes a (rows, columns) matrix, got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return reference(x)
    rows, cols = x.shape
    kernels.check_tensor("x", x, (rows, cols))
    vals = torch.empty((rows, cols), dtype=dtype, device=x.device)
    scales = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows == 0:
        return vals, scales
    layout = device_quant_layout(x, vals)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.rxt_quantize_rows(
        int(dtype == torch.float8_e4m3fn), VARIANTS[layout.variant],
        layout.group, layout.rows_per_thread, layout.vecs, x.data_ptr(),
        vals.data_ptr(), scales.data_ptr(), rows, cols, stream)
    if rc:
        kernels.check(lib, rc, f"{name} kernel, {layout}")
    LAUNCHES[name] += 1
    return vals, scales


def quantize_rows(x):
    """K6 wrapper.  Per-row symmetric int8 quantization of x (R, C) float32:
    ``(vals (R, C) int8, scales (R, 1) float32)``."""
    return _quantize(x, "quantize_rows", torch.int8, quantize_rows_reference)


def quantize_rows_fp8(x):
    """K7 wrapper.  Per-row scaled fp8 quantization of x (R, C) float32:
    ``(vals (R, C) float8_e4m3fn, scales (R, 1) float32)``."""
    return _quantize(x, "quantize_rows_fp8", torch.float8_e4m3fn,
                     quantize_rows_fp8_reference)


def dequant_matmul(vals, scales, w):
    """K8 wrapper.  ``xi = dequant(vals, scales) @ w`` in one kernel: vals
    (R, dy) int8 or float8_e4m3fn, scales (R, 1) float32, w (dy, dx) float32
    -> (R, dx) float32, equal bit for bit to ``dequant_matmul_reference``.
    On a CUDA device the kernel takes ``device_dequant_layout``'s layout."""
    if vals.dtype not in (torch.int8, torch.float8_e4m3fn):
        raise TypeError(
            f"vals must be int8 or float8_e4m3fn (got {vals.dtype})")
    if vals.shape[1] < 1:
        raise ValueError("dequant_matmul needs at least one payload column")
    if vals.device.type == "cpu":
        return dequant_matmul_reference(vals, scales, w)
    return _dequant_cuda(vals, scales, w)


def _dequant_cuda(vals, scales, w, layout: DequantLayout | None = None):
    """Launch K8 on CUDA tensors in ``layout`` (``device_dequant_layout``'s
    when None); the launcher refuses a layout the tensors do not allow."""
    rows, dy = vals.shape
    dx = w.shape[1]
    kernels.check_tensor("vals", vals, (rows, dy), dtype=vals.dtype)
    kernels.check_tensor("scales", scales, (rows, 1))
    kernels.check_tensor("w", w, (dy, dx))
    out = torch.empty((rows, dx), dtype=torch.float32, device=vals.device)
    if rows == 0 or dx == 0:
        return out
    if layout is None:
        layout = device_dequant_layout(vals, out)
    tiles = device_dequant_tiles(dy, dx, vals.device)
    lib = _library()
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    rc = lib.rxt_dequant_matmul(
        int(vals.dtype == torch.float8_e4m3fn),
        DEQUANT_VARIANTS[layout.variant], layout.rows_per_thread, *tiles,
        vals.data_ptr(), scales.data_ptr(), w.data_ptr(), out.data_ptr(),
        rows, dy, dx, stream)
    kernels.check(lib, rc, f"dequant_matmul kernel, {layout}, W tiles {tiles}")
    LAUNCHES["dequant_matmul"] += 1
    return out


def quantized_evidence(y, hr_t):
    """Quantize a batch of observations y (R, dy) to int8 and project it to
    information-form evidence ``xi = y_q @ hr_t``, hr_t = (R^-1 H) (dy, dx):
    the streaming-ingest message."""
    vals, scales = quantize_rows(y)
    return dequant_matmul(vals, scales, hr_t)


def quantized_evidence_fp8(y, hr_t):
    """The fp8-payload evidence projection (same contract as
    ``quantized_evidence``)."""
    vals, scales = quantize_rows_fp8(y)
    return dequant_matmul(vals, scales, hr_t)
