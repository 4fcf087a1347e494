"""Boundaries of the PyTorch port: it never imports JAX nor the JAX package,
its entry points never fall back to the CPU when a CUDA device is expected,
its kernels build with IEEE arithmetic for sm_90a, and ``chip_smoke.py``
refuses to report anything without a card or outside a checkout."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
# the package, chip_smoke.py and the scripts that drive the port (the other
# scripts belong to the JAX package)
PORT_FILES = sorted((REPO / "rxinfer_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"] + sorted(
    p for p in (REPO / "scripts").glob("*.py")
    if "rxinfer_tpu_torch" in p.read_text())


def _imported_modules(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module or "")
    return mods


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_never_imports_jax_or_the_jax_package(path):
    bad = {m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "rxinfer_tpu")}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_importing_the_port_leaves_jax_unloaded():
    code = ("import sys, rxinfer_tpu_torch, rxinfer_tpu_torch.convert, "
            "rxinfer_tpu_torch.kernels, rxinfer_tpu_torch.models.zoo, "
            "rxinfer_tpu_torch.parallel.filtering, "
            "rxinfer_tpu_torch.parallel.mesh, "
            "rxinfer_tpu_torch.parallel.time_blocked, "
            "rxinfer_tpu_torch.parallel.hierarchical, "
            "rxinfer_tpu_torch.ops.quantized, rxinfer_tpu_torch.ops.kalman, "
            "rxinfer_tpu_torch.inference_streaming, "
            "rxinfer_tpu_torch.engine.stream_plan; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'rxinfer_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _tiny_model():
    from rxinfer_tpu_torch.models import zoo

    d = 2
    eye = np.eye(d, dtype=np.float32)
    return zoo.lgssm(eye, eye, eye, eye, np.zeros(d, np.float32), eye), \
        {"y": np.zeros((2, 5, d), np.float32)}


def test_entry_points_refuse_to_run_on_the_cpu_by_default(monkeypatch):
    import rxinfer_tpu_torch as trx

    if torch.cuda.is_available():
        # decide inside the test: on a machine with a card, hide it
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, data = _tiny_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trx.batched_program(model, data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trx.infer_batched(model, data)
    # an explicit CPU device runs the plain versions
    post, _ = trx.infer_batched(model, data, device="cpu")
    assert tuple(post["x"].mu.shape) == (2, 5, 2)


def test_kernel_build_flags():
    from rxinfer_tpu_torch import kernels

    flags = " ".join(kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert set(kernels.sources()) == {"fused_smoother", "fused_smoother_bf16",
                                      "fused_smoother_wide", "fused_fb",
                                      "fused_fb_wide", "fused_filter",
                                      "fused_filter_wide", "fused_filter_warp",
                                      "fused_filter_tc128", "quantized"}
    # every source under csrc/ is one that sources() builds, and every header
    # there is reached from a source
    assert {p.stem for p in kernels.CSRC.glob("*.cu")} == set(kernels.sources())
    reached = {p for n in kernels.sources() for p in kernels.source_files(n)}
    assert set(kernels.CSRC.iterdir()) == reached
    assert kernels.BUILD_DIR.relative_to(REPO).as_posix() + "/" in (
        REPO / ".gitignore").read_text().split()


def test_library_key_covers_the_headers_a_source_includes(tmp_path):
    """Editing a header shared by two sources rebuilds both: the key of a
    library hashes its source and every csrc/ header the source includes."""
    from rxinfer_tpu_torch import kernels

    names = [p.name for p in kernels.source_files("fused_filter")]
    assert names == ["fused_filter.cu", "smallmat.cuh"]
    assert [p.name for p in kernels.source_files("fused_smoother")] == [
        "fused_smoother.cu", "fused_smoother.cuh", "smallmat.cuh"]
    assert [p.name for p in kernels.source_files("fused_smoother_bf16")] == [
        "fused_smoother_bf16.cu", "fused_smoother.cuh", "smallmat.cuh"]
    assert [p.name for p in kernels.source_files("quantized")] == [
        "quantized.cu"]
    assert [p.name for p in kernels.source_files("fused_filter_warp")] == [
        "fused_filter_warp.cu", "tc16.cuh", "tc_blocks.cuh"]
    assert [p.name for p in kernels.source_files("fused_filter_tc128")] == [
        "fused_filter_tc128.cu", "tc16.cuh", "tc_blocks.cuh"]
    assert [p.name for p in kernels.source_files("fused_smoother_wide")] == [
        "fused_smoother_wide.cu", "smallmat.cuh", "tc16.cuh", "wide_step.cuh"]
    assert [p.name for p in kernels.source_files("fused_filter_wide")] == [
        "fused_filter_wide.cu", "tc16.cuh", "wide_step.cuh"]

    copy = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, copy)
    keys = {n: kernels.library_key(n, copy) for n in kernels.sources()}
    assert keys == {n: kernels.library_key(n) for n in kernels.sources()}
    header = copy / "smallmat.cuh"
    header.write_bytes(header.read_bytes() + b"// edited\n")
    after = {n: kernels.library_key(n, copy) for n in kernels.sources()}
    changed = {n for n in keys if after[n] != keys[n]}
    assert changed == {"fused_filter", "fused_smoother",
                       "fused_smoother_bf16", "fused_smoother_wide"}
    # a header included through another header counts too
    (copy / "inner.cuh").write_text("// inner\n")
    header.write_bytes(b'#include "inner.cuh"\n' + header.read_bytes())
    nested = kernels.library_key("fused_filter", copy)
    (copy / "inner.cuh").write_text("// inner, edited\n")
    assert kernels.library_key("fused_filter", copy) != nested


def test_check_tensor_takes_the_payload_dtypes():
    from rxinfer_tpu_torch import kernels

    import inspect

    assert inspect.signature(kernels.check_tensor).parameters[
        "dtype"].default is torch.float32
    # the device is checked first: a CPU payload is refused before its type
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.check_tensor("vals", torch.zeros((2, 3), dtype=torch.int8),
                             (2, 3), dtype=torch.int8)


def test_package_is_packaged():
    text = (REPO / "pyproject.toml").read_text()
    assert '"rxinfer_tpu_torch*"' in text
    assert "csrc/*.cu" in text and "csrc/*.cuh" in text


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
