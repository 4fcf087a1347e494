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
PORT_FILES = sorted((REPO / "rxinfer_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


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
            "rxinfer_tpu_torch.kernels, rxinfer_tpu_torch.models.zoo; "
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
    assert {"fused_smoother", "fused_fb"} <= set(kernels.sources())
    assert kernels.BUILD_DIR.relative_to(REPO).as_posix() + "/" in (
        REPO / ".gitignore").read_text().split()


def test_package_is_packaged():
    text = (REPO / "pyproject.toml").read_text()
    assert '"rxinfer_tpu_torch*"' in text
    assert "csrc/*.cu" in text


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
