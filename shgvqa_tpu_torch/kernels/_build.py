"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
into ``shgvqa_tpu_torch/_build/lib<name>-<hash>.so`` (a directory git
ignores)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

The hash is of the source, so an edited kernel is rebuilt.  ``build`` starts
one ``nvcc`` per source, all at once.  There is no fallback: a missing
``nvcc`` or a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install path; raises RuntimeError when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(DEFAULT_NVCC)
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH and "
        f"{DEFAULT_NVCC}); the port's CUDA kernels are built with it on "
        "first use and have no fallback")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(*names: str) -> Tuple[Dict[str, Path], Dict[str, str]]:
    """Compile the named sources (default: every ``csrc/*.cu``) that are not
    built yet, one ``nvcc`` each, all started together.  Returns the library
    path of each name and the compiler output of each source built now
    (ptxas registers and spills); raises RuntimeError with the compiler
    output on failure."""
    names = names or tuple(sorted(p.stem for p in CSRC_DIR.glob("*.cu")))
    libs = {name: _library_path(name) for name in names}
    todo = {name: lib for name, lib in libs.items() if not lib.exists()}
    logs: Dict[str, str] = {}
    if not todo:
        return libs, logs
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name, lib in todo.items():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp)
        failures = []
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            logs[name] = out
            if proc.returncode != 0:
                failures.append(f"nvcc failed on csrc/{name}.cu "
                                f"(rc {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, todo[name])
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs, logs


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (building it if needed); its
    caller keeps it (``kernels/ffn.py`` caches it with its signatures)."""
    return ctypes.CDLL(str(build(name)[0][name]))
