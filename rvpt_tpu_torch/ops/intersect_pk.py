"""Brute-force closest triangle hit: the port of the Pallas kernel B8.

``rvpt_tpu/ops/intersect_pk.py`` fuses the pairwise ray/triangle test and
its min-reduction into one Pallas kernel (closest_hit_pallas :174).  Here
the same function is ``csrc/closest_hit.cu``, hand-written CUDA for Hopper:
one thread per ray over triangle rows staged in shared memory as four
aligned float4, with a t-first reject.  Its plain
version is ``ops.intersect.closest_hit_triangles``; ``closest_hit_scene``
launches this kernel for rays on the card and takes the plain version for
rays on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import annotate
from .build import check_cuda, check_launch, load_library
from .intersect import triangle_precompute

# Packed triangle fields, one f32 row per triangle (intersect_pk.py FIELDS).
FIELDS = (
    "nx", "ny", "nz",
    "e0x", "e0y", "e0z",
    "e1x", "e1y", "e1z",
    "v0n", "v0e0", "v0e1",
    "g00", "g11", "g01", "inv_det",
)


def pack_triangles(v0, v1, v2) -> torch.Tensor:
    """[T, 16] f32 rows of the precomputed triangle fields, in ``FIELDS``
    order, on the vertices' device."""
    pre = triangle_precompute(v0, v1, v2)
    return torch.cat([
        pre["n"], pre["e0"], pre["e1"],
        torch.stack([pre["v0n"], pre["v0e0"], pre["v0e1"], pre["g00"],
                     pre["g11"], pre["g01"], pre["inv_det"]], dim=-1),
    ], dim=-1).to(torch.float32).contiguous()


def _lib():
    lib = load_library("closest_hit")
    if not hasattr(lib, "_rvpt_bound"):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rvpt_closest_hit.argtypes = [ptr, ptr, ptr, i32, i32, f32, f32,
                                         ptr, ptr, ptr]
        lib.rvpt_closest_hit.restype = i32
        lib._rvpt_bound = True
    return lib


def launch_closest_hit(origin, direction, packed, mint, maxt):
    """Closest hit of N rays against the packed triangles on the card:
    (t f32[N], +inf on a miss; idx int64[N], -1 on a miss).  ``origin`` and
    ``direction`` are f32[N, 3]; ``packed`` from ``pack_triangles``.
    Counts one launch in ``launch_closest_hit.launches``."""
    with annotate("launch_closest_hit"):
        n = origin.shape[0]
        dev = origin.device
        check_cuda(origin, torch.float32, "origin", 3 * n)
        check_cuda(direction, torch.float32, "direction", 3 * n, dev)
        check_cuda(packed, torch.float32, "packed triangles", device=dev)
        if packed.dim() != 2 or packed.shape[1] != len(FIELDS):
            raise ValueError(f"packed triangles: need [T, 16], got {tuple(packed.shape)}")
        if packed.data_ptr() % 16:
            raise ValueError("packed triangles: the kernel loads 16-byte rows, need a "
                             "16-byte aligned tensor")
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        idx = torch.empty((n,), dtype=torch.int64, device=dev)
        lib = _lib()
        err = lib.rvpt_closest_hit(
            origin.data_ptr(), direction.data_ptr(), packed.data_ptr(),
            packed.shape[0], n, float(mint), float(maxt), t.data_ptr(),
            idx.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        check_launch(lib, err, "closest-hit kernel")
        launch_closest_hit.launches += 1
        return t, idx


launch_closest_hit.launches = 0

