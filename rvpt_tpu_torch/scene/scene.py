"""Scene as a structure of arrays plus a host-side builder (mirror of
``rvpt_tpu/scene/scene.py``).  The field names are the JAX ``Scene``'s, so
``convert.scene_from_numpy`` maps one onto the other by name."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .materials import Materials

ARRAY_FIELDS = (
    "tri_v0", "tri_v1", "tri_v2", "tri_mat",
    "sph_center", "sph_radius", "sph_mat",
    "pln_normal", "pln_d", "pln_mat",
)


@dataclass(frozen=True)
class Scene:
    # Triangles, SoA over [T]: vertices and per-face material id.
    tri_v0: torch.Tensor  # f32[T,3]
    tri_v1: torch.Tensor  # f32[T,3]
    tri_v2: torch.Tensor  # f32[T,3]
    tri_mat: torch.Tensor  # i64[T]
    # Spheres, SoA over [S].
    sph_center: torch.Tensor  # f32[S,3]
    sph_radius: torch.Tensor  # f32[S]
    sph_mat: torch.Tensor  # i64[S]
    # Planes <p,n> = d, SoA over [P].
    pln_normal: torch.Tensor  # f32[P,3]
    pln_d: torch.Tensor  # f32[P]
    pln_mat: torch.Tensor  # i64[P]
    materials: Materials
    # BVH over the triangle family: always None until BVH scenes are ported.
    bvh: object = None

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def num_planes(self) -> int:
        return self.pln_normal.shape[0]


class SceneBuilder:
    """Host-side mutable builder (RVPT::add_triangle / add_material,
    src/rvpt/rvpt.cpp:1041-1043)."""

    def __init__(self):
        self._tris: list[tuple] = []
        self._sphs: list[tuple] = []
        self._plns: list[tuple] = []
        self._mats: list[dict] = []

    def add_material(self, albedo, emission=(0.0, 0.0, 0.0), kind=0, ior=1.5) -> int:
        self._mats.append(
            dict(albedo=tuple(albedo), emission=tuple(emission), kind=int(kind),
                 ior=float(ior))
        )
        return len(self._mats) - 1

    def add_triangle(self, v0, v1, v2, mat: int) -> "SceneBuilder":
        self._tris.append((tuple(v0), tuple(v1), tuple(v2), int(mat)))
        return self

    def add_quad(self, v0, v1, v2, v3, mat: int) -> "SceneBuilder":
        """Adds two triangles (v0,v1,v2) and (v0,v2,v3)."""
        self.add_triangle(v0, v1, v2, mat)
        self.add_triangle(v0, v2, v3, mat)
        return self

    def add_sphere(self, center, radius: float, mat: int) -> "SceneBuilder":
        self._sphs.append((tuple(center), float(radius), int(mat)))
        return self

    def add_plane(self, normal, d: float, mat: int) -> "SceneBuilder":
        self._plns.append((tuple(normal), float(d), int(mat)))
        return self

    def build(self, device=None) -> Scene:
        f32 = dict(dtype=torch.float32, device=device)
        i64 = dict(dtype=torch.int64, device=device)

        def vec3(rows):
            return torch.tensor(rows, **f32) if rows else torch.zeros((0, 3), **f32)

        def scal(rows, kw):
            return torch.tensor(rows, **kw) if rows else torch.zeros((0,), **kw)

        return Scene(
            tri_v0=vec3([t[0] for t in self._tris]),
            tri_v1=vec3([t[1] for t in self._tris]),
            tri_v2=vec3([t[2] for t in self._tris]),
            tri_mat=scal([t[3] for t in self._tris], i64),
            sph_center=vec3([s[0] for s in self._sphs]),
            sph_radius=scal([s[1] for s in self._sphs], f32),
            sph_mat=scal([s[2] for s in self._sphs], i64),
            pln_normal=vec3([p[0] for p in self._plns]),
            pln_d=scal([p[1] for p in self._plns], f32),
            pln_mat=scal([p[2] for p in self._plns], i64),
            materials=Materials.from_list(self._mats, device),
        )
