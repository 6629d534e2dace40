"""Build and load the package's CUDA kernels as a plain-C shared library.

``nvcc`` compiles ``rvpt_tpu_torch/csrc/<name>.cu`` for Hopper (sm_90a)
into ``build/rvpt_tpu_torch/`` at the checkout root, at first use; the file
name carries a hash of the source, the shared headers and the flags, so an
edit rebuilds it.  The
library is loaded with ``ctypes``: no PyTorch headers are compiled, which
keeps a build to seconds.  ``build_all`` starts one ``nvcc`` per source at
once.  Nothing here runs at import time.  Every library exports
``int rvpt_error_string(int)``: the CUDA error name of a launch's return
code.
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


def _lib_path(name: str) -> Path:
    """The library's path; its name carries a hash of the source, every
    header under csrc/ and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names) -> None:
    """Compile every named source that is not built yet, one ``nvcc`` each,
    all started together; raises with nvcc's output if any build fails."""
    jobs = []
    for name in names:
        lib_path = _lib_path(name)
        if lib_path.exists() or name in BUILD_INFO:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, lib_path, tmp, proc, time.perf_counter()))
    failed = []
    for name, lib_path, tmp, proc, t0 in jobs:
        log, _ = proc.communicate()
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log,
                            "path": str(lib_path)}
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, lib_path)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; raises with nvcc's
    output when the build fails."""
    if name in _LIBS:
        return _LIBS[name]
    build_all([name])
    lib_path = _lib_path(name)
    BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "", "path": str(lib_path)})
    lib = ctypes.CDLL(str(lib_path))
    lib.rvpt_error_string.argtypes = [ctypes.c_int]
    lib.rvpt_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: {lib.rvpt_error_string(err).decode()}")


def check_cuda(x, dtype, name: str, n: int | None = None, device=None) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` CUDA tensor (of ``n``
    elements, on ``device``, where given)."""
    if x.device.type != "cuda" or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {dtype} CUDA tensor, got "
            f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})")
    if n is not None and x.numel() != n:
        raise ValueError(f"{name}: need {n} elements, got {x.numel()}")
    if device is not None and x.device != device:
        raise ValueError(f"{name}: on {x.device}, need {device}")
