"""Build and load the package's CUDA kernels as a plain-C shared library.

``nvcc`` compiles ``rvpt_tpu_torch/csrc/<name>.cu`` for Hopper (sm_90a)
into ``build/rvpt_tpu_torch/`` at the checkout root, at first use; the file
name carries a hash of the source and flags, so an edit rebuilds it.  The
library is loaded with ``ctypes``: no PyTorch headers are compiled, which
keeps a build to seconds.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rvpt_tpu_torch"

# No fast math: IEEE division, sqrt and sin/cos, and no fused multiply-add,
# so the kernel rounds like the plain PyTorch version's unfused ops.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when the library was already built),
#          "log": nvcc's output, "path": the library}
BUILD_INFO: dict[str, dict] = {}


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; raises with nvcc's
    output when the build fails."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    info = {"seconds": 0.0, "log": "", "path": str(lib_path)}
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - t0
        info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                + info["log"])
        os.replace(tmp, lib_path)
    _LIBS[name] = ctypes.CDLL(str(lib_path))
    BUILD_INFO[name] = info
    return _LIBS[name]
