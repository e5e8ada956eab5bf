"""The port stands alone: no file of shgvqa_tpu_torch/, nothing in
chip_smoke.py and nothing in the weight-file writers it imports from the
tests imports jax, flax, msgpack or shgvqa_tpu; its entry points refuse to
run without a card unless asked for the CPU; the kernel build has no
fallback; chip_smoke.py fails without a card and outside the repo."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from shgvqa_tpu_torch import entry
from shgvqa_tpu_torch.kernels import _build

REPO = Path(__file__).resolve().parent.parent
# chip_smoke.py imports the weight-file writers of the tests on the card
PORT_FILES = sorted((REPO / "shgvqa_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "test_torch_reference_writer.py"]
FORBIDDEN = ("jax", "flax", "msgpack", "shgvqa_tpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_entry_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.device_batch(entry.flagship_cfg(), 1)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("ffn_train")
    assert not (tmp_path / "build").exists()


def test_library_path_follows_the_headers(monkeypatch, tmp_path):
    """A library's name hashes its source, every csrc/*.cuh header and the
    flags: an edit to a header the sources include gives a new library, so
    a stale build is never loaded."""
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build._library_path("k")
    assert _build._library_path("k") == first
    header.write_text("// v2\n")
    second = _build._library_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert _build._library_path("k") not in (first, second)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edit\n')
    assert _build._library_path("k") not in (first, second)


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
