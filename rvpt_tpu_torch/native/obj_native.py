"""Native OBJ parser binding (mirror of ``rvpt_tpu/native/obj_native.py``,
the fast path of ``scene.obj_io.load_obj``)."""

from __future__ import annotations

import ctypes
import os

import numpy as np

from . import get_lib


def parse_obj_file(path: str):
    """(vertices f32[V,3], faces i32[F,3]) via the C++ parser, or None when
    the native library is unavailable or cannot parse the file."""
    lib = get_lib()
    if lib is None or not os.path.exists(path):
        return None
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    if lib.rvpt_obj_open(str(path).encode(), ctypes.byref(nv), ctypes.byref(nf)) != 0:
        return None
    verts = np.zeros((nv.value, 3), np.float32)
    faces = np.zeros((nf.value, 3), np.int32)
    lib.rvpt_obj_read(verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return verts, faces
