"""Build and load the package's CUDA kernels as a plain-C shared library,
and build the native C++ scene-ingest library.

``nvcc`` compiles ``rvpt_tpu_torch/csrc/<name>.cu`` for Hopper (sm_90a)
into ``build/rvpt_tpu_torch/`` at the checkout root, at first use; the file
name carries a hash of the source, the shared headers and the flags, so an
edit rebuilds it.  The
library is loaded with ``ctypes``: no PyTorch headers are compiled, which
keeps a build to seconds.  ``build_all`` starts one ``nvcc`` per source at
once.  Nothing here runs at import time.  Every library exports
``int rvpt_error_string(int)``: the CUDA error name of a launch's return
code.  ``build_native`` compiles ``native/rvpt_native.cpp`` (the BVH
builder and OBJ parser, beside both packages) with ``g++`` into the same
directory; it runs on the host and needs no card.
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
NATIVE_SOURCE = Path(__file__).resolve().parents[2] / "native" / "rvpt_native.cpp"
# Every kernel source under csrc/: K1, K2, B8, B3, B4, B5, B6 and B7.
KERNELS = ("path_kernel", "bwd_kernel", "closest_hit", "primary_kernel",
           "hart_kernel", "bigmesh_kernel", "bigmesh_hart", "replay_lookup")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

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


def unload() -> list[str]:
    """Forget every loaded kernel library and its build record, so that
    the next ``load_library`` loads it again, or builds it anew when its
    sources changed (hot reload).  Returns the names dropped."""
    names = sorted(_LIBS)
    _LIBS.clear()
    BUILD_INFO.clear()
    return names


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


def build_native() -> Path:
    """Build (if needed) the native library from ``native/rvpt_native.cpp``
    with ``g++`` (``$CXX`` overrides) and return its path; the name carries
    a hash of the source and the flags.  Raises ``RuntimeError`` with the
    compiler's output when it cannot be built."""
    digest = hashlib.sha256(NATIVE_SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    path = BUILD_DIR / f"librvpt_native_{digest.hexdigest()[:16]}.so"
    if path.exists():
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++, or $CXX) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE_SOURCE)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{cxx} failed: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed to build {NATIVE_SOURCE.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    return path
