"""ctypes bindings to the native C++ scene-ingest library (mirror of
``rvpt_tpu/native``).

``native/rvpt_native.cpp`` at the checkout root (beside both packages, part
of neither) holds the binned-SAH BVH builder and the OBJ parser.  ``g++``
builds it at first use (``ops.build.build_native``) into
``build/rvpt_tpu_torch/``, which git ignores.  Every
consumer has a NumPy twin that produces the same result, so the library is
a fast path, never a requirement: ``get_lib`` returns None when it cannot
be built, and ``BUILD["error"]`` says why.
"""

from __future__ import annotations

import ctypes

_lib = None
# "path": the library, "error": why it is unavailable (None once loaded).
BUILD: dict = {"path": None, "error": None}


def get_lib():
    """The loaded native library, building it first if needed
    (``ops.build.build_native``); None when it cannot be built or loaded
    (``BUILD["error"]`` says why)."""
    global _lib
    if _lib is not None or BUILD["error"] is not None:
        return _lib
    from ..ops.build import build_native

    try:
        path = build_native()
        lib = ctypes.CDLL(str(path))
    except (RuntimeError, OSError) as e:
        BUILD["error"] = str(e)
        return None
    f64p = ctypes.POINTER(ctypes.c_double)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.rvpt_build_bvh.restype = ctypes.c_int64
    lib.rvpt_build_bvh.argtypes = [ctypes.c_int64, f64p, f64p, f64p, u32p, u32p,
                                   f64p, u32p]
    lib.rvpt_obj_open.restype = ctypes.c_int32
    lib.rvpt_obj_open.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int64)]
    lib.rvpt_obj_read.restype = ctypes.c_int32
    lib.rvpt_obj_read.argtypes = [ctypes.POINTER(ctypes.c_float),
                                  ctypes.POINTER(ctypes.c_int32)]
    BUILD["path"] = str(path)
    _lib = lib
    return _lib
