"""Build and load the port's hand-written CUDA kernels.

Every ``*.cu`` file under ``rxinfer_tpu_torch/csrc/`` is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C interface, which
the op modules load with ``ctypes``.  Builds happen at first use, never at
import, into ``rxinfer_tpu_torch/_build/`` (listed in ``.gitignore``); a
library is keyed by the hash of its source, of every ``csrc/`` header the
source includes (directly or through another header) and of the flags, so an
edited source or header is rebuilt and an unchanged one is reused.
``-Xptxas -v`` output (registers, spills per instantiation) is kept beside
each library.

Flags: ``-O3`` without ``--use_fast_math``, so division and square roots stay
IEEE like the plain PyTorch versions the kernels are held against;
``-split-compile=0`` runs the optimizer over a source's instantiations on
every core (``fused_smoother.cu``, with its per-chain W/Q instantiations:
60.5 s as one process, 25.4 s split, on an 8-core H100 host;
``scripts/time_builds.py``).  A source whose instantiations are many may
be built as several libraries from one header, which start together:
``fused_smoother.cu`` and ``fused_smoother_bf16.cu`` build
``fused_smoother.cuh`` for float32 and for bf16 moments (one library with
both types took 29.3 s alone on that host).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """Locate ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the port's CUDA kernels are built from rxinfer_tpu_torch/csrc at "
        "first use and need the CUDA toolkit."
    )


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def source_files(name: str, csrc: Path = CSRC) -> list[Path]:
    """``csrc/<name>.cu`` followed by the ``csrc/`` headers it includes with
    ``#include "..."``, directly or through another header, sorted by name.
    System headers (``<...>``) belong to the toolkit and are not followed."""
    seen: dict[Path, None] = {}
    todo = [csrc / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen[path] = None
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = (path.parent / inc.decode()).resolve()
            if header.is_file() and csrc.resolve() in header.parents:
                todo.append(header)
    first = csrc / f"{name}.cu"
    return [first] + sorted(p for p in seen if p != first)


def library_key(name: str, csrc: Path = CSRC) -> str:
    """Hash of everything the library for ``csrc/<name>.cu`` is built from:
    the source, the ``csrc/`` headers it includes, and the flags."""
    digest = hashlib.sha256()
    for path in source_files(name, csrc):
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{library_key(name)}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp path, final path)
    or None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    out.with_suffix(".ptxas.txt").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all() -> dict[str, Path]:
    """Build every kernel source, all ``nvcc`` processes started together.
    Returns name -> library path."""
    with _LOCK:
        started = {n: _start_build(n) for n in sources()}
        errors = []
        for n, s in started.items():
            if s is None:
                continue
            try:
                _finish_build(n, s)
            except RuntimeError as exc:
                errors.append(str(exc))
        if errors:
            raise RuntimeError("\n".join(errors))
    return {n: _lib_path(n) for n in sources()}


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines of a built library (registers, spills)."""
    path = _lib_path(name).with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        started = _start_build(name)
        if started is not None:
            _finish_build(name, started)
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.rxt_error_string.argtypes = [ctypes.c_int]
        lib.rxt_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The SM count of a CUDA device, read once a device (the launch rules
    take it at every wrapper call)."""
    device = torch.device(device)
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def check_tensor(name: str, t, shape, dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``shape`` and
    ``dtype`` (float32 unless the launcher takes a quantized payload)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must lie on the CUDA device (got {t.device})")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} (got {t.dtype})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launcher reported a CUDA error."""
    if rc != 0:
        msg = lib.rxt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
