"""Build and load the port's CUDA library at first use.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The library
lands in ``build/repro_torch/`` at the checkout root (a per-user cache for an
installed package, see `_build_dir`), named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one loads
at once. The compiler's resource report (``-Xptxas -v``) is kept beside the
library as ``lib<name>_<key>.ptxas.txt`` and read back on a cached load, so
`kernels.budgets` always has a report to check. Nothing here runs at import
time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"


def _build_dir() -> Path:
    """``build/repro_torch/`` at the checkout root when the package runs
    from a checkout's ``src/``; for an installed package, a per-user cache
    (``$XDG_CACHE_HOME/repro_torch``, else ``~/.cache/repro_torch``)."""
    pkg = CSRC.parent
    if pkg.parent.name == "src":
        return pkg.parent.parent / "build" / "repro_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or str(Path.home() / ".cache")
    return Path(cache) / "repro_torch"


BUILD_DIR = _build_dir()
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time (0.0 when loaded from the cache),
#          "ptxas": the compiler's resource report ("" when a cached build
#          has none), "path": the library}
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its hashed build is missing, then load it."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    text = src.read_bytes()
    key = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"lib{name}_{key}.so"
    report = out_dir / f"lib{name}_{key}.ptxas.txt"
    info = {"seconds": 0.0, "ptxas": "", "path": str(lib_path)}
    if not lib_path.exists():
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        # the report first: a library on disk always has its report beside it
        fd, tmp_report = tempfile.mkstemp(suffix=".txt", dir=out_dir)
        with os.fdopen(fd, "w") as f:
            f.write(proc.stderr)
        os.replace(tmp_report, report)
        os.replace(tmp, lib_path)
        info["seconds"] = time.perf_counter() - t0
    if report.exists():
        info["ptxas"] = report.read_text()
    lib = ctypes.CDLL(str(lib_path))
    _LIBS[name] = lib
    BUILD_INFO[name] = info
    return lib
