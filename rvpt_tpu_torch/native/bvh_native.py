"""Native BVH builder binding (mirror of ``rvpt_tpu/native/bvh_native.py``,
the fast path of ``scene.bvh.attach_bvh``)."""

from __future__ import annotations

import ctypes

import numpy as np

from . import get_lib


def build(centers: np.ndarray, bmin: np.ndarray, bmax: np.ndarray):
    """``BvhHost`` built by the C++ binned-SAH builder, or None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from ..scene.bvh import BvhHost

    n = len(centers)
    centers = np.ascontiguousarray(centers, np.float64)
    bmin64 = np.ascontiguousarray(bmin, np.float64)
    bmax64 = np.ascontiguousarray(bmax, np.float64)
    if not (centers.shape == bmin64.shape == bmax64.shape == (n, 3)):
        raise ValueError("centers, bmin and bmax must all be [n, 3]")
    max_nodes = max(2 * n - 1, 1)
    first = np.zeros(max_nodes, np.uint32)
    count = np.zeros(max_nodes, np.uint32)
    bounds = np.zeros(max_nodes * 6, np.float64)
    prim = np.zeros(n, np.uint32)

    def ptr(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty))

    written = lib.rvpt_build_bvh(
        n, ptr(centers, ctypes.c_double), ptr(bmin64, ctypes.c_double),
        ptr(bmax64, ctypes.c_double), ptr(first, ctypes.c_uint32),
        ptr(count, ctypes.c_uint32), ptr(bounds, ctypes.c_double),
        ptr(prim, ctypes.c_uint32))
    if written <= 0:
        return None
    b = bounds[: written * 6].reshape(written, 6)
    return BvhHost(
        first=first[:written].copy(),
        count=count[:written].copy(),
        bmin=b[:, :3].astype(np.float32),
        bmax=b[:, 3:].astype(np.float32),
        prim_indices=prim.copy(),
    )
