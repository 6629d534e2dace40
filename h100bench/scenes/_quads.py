"""Building blocks the scene makers share: the triangle soup of a list of
quads and triangles, and the scene tensors on a device."""

from __future__ import annotations

import torch

from ..reference.kajiya import Scene


def quad(v0, v1, v2, v3):
    """Two triangles (v0, v1, v2) and (v0, v2, v3)."""
    return [(v0, v1, v2), (v0, v2, v3)]


def make_scene(tris, tri_mat, spheres, planes, materials, camera, bvh,
               device) -> Scene:
    """``tris`` [T, 3, 3] (float32 array or nested lists), ``tri_mat`` [T],
    spheres as (center, radius, material), planes as (normal, d,
    material), materials as (albedo, emission, kind, ior), camera as
    (translation, rotation, fov)."""
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    t = torch.as_tensor(tris, **f32).reshape(-1, 3, 3)

    def rows(items, k, width, kw):
        if not items:
            return torch.zeros((0, width) if width else (0,), **kw)
        return torch.tensor([it[k] for it in items], **kw)

    return Scene(
        v0=t[:, 0].contiguous(), v1=t[:, 1].contiguous(), v2=t[:, 2].contiguous(),
        tri_mat=torch.as_tensor(tri_mat, **i64),
        sph_center=rows(spheres, 0, 3, f32), sph_radius=rows(spheres, 1, 0, f32),
        sph_mat=rows(spheres, 2, 0, i64),
        pln_normal=rows(planes, 0, 3, f32), pln_d=rows(planes, 1, 0, f32),
        pln_mat=rows(planes, 2, 0, i64),
        albedo=rows(materials, 0, 3, f32), emission=rows(materials, 1, 3, f32),
        kind=rows(materials, 2, 0, i64), ior=rows(materials, 3, 0, f32),
        cam_translation=tuple(camera[0]), cam_rotation=tuple(camera[1]),
        cam_fov=float(camera[2]), bvh=bool(bvh))
