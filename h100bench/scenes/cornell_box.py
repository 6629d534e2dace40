"""The Cornell box of the port's ``scene/builtin.py:28-72``: 12 triangles
(five walls and the ceiling light, as quads), a mirror and a glass sphere,
6 materials, no BVH; camera at the origin looking down +z."""

from __future__ import annotations

from ._quads import make_scene, quad

LAMBERT, MIRROR, DIELECTRIC = 0, 1, 2


def build(params: dict, device):
    e = float(params.get("light_emission", 12.0))
    materials = [
        ((0.73, 0.73, 0.73), (0.0, 0.0, 0.0), LAMBERT, 1.5),  # white
        ((0.65, 0.05, 0.05), (0.0, 0.0, 0.0), LAMBERT, 1.5),  # red
        ((0.12, 0.45, 0.15), (0.0, 0.0, 0.0), LAMBERT, 1.5),  # green
        ((0.0, 0.0, 0.0), (e, e, e), LAMBERT, 1.5),  # light
        ((0.9, 0.9, 0.9), (0.0, 0.0, 0.0), MIRROR, 1.5),
        ((0.98, 0.98, 0.98), (0.0, 0.0, 0.0), DIELECTRIC, 1.5),
    ]
    s, z0, z1 = 1.0, 2.0, 4.0
    quads = [
        (quad((-s, -s, z0), (s, -s, z0), (s, -s, z1), (-s, -s, z1)), 0),  # floor
        (quad((-s, s, z0), (-s, s, z1), (s, s, z1), (s, s, z0)), 0),  # ceiling
        (quad((-s, -s, z1), (s, -s, z1), (s, s, z1), (-s, s, z1)), 0),  # back
        (quad((-s, -s, z0), (-s, -s, z1), (-s, s, z1), (-s, s, z0)), 1),  # left
        (quad((s, -s, z0), (s, s, z0), (s, s, z1), (s, -s, z1)), 2),  # right
    ]
    l, lz0, lz1, eps = 0.35, 2.65, 3.35, 1e-3
    quads.append((quad((-l, s - eps, lz0), (-l, s - eps, lz1),
                       (l, s - eps, lz1), (l, s - eps, lz0)), 3))
    tris = [t for q, _ in quads for t in q]
    tri_mat = [m for q, m in quads for _ in q]
    spheres = [((-0.45, -0.62, 3.3), 0.38, 4), ((0.45, -0.62, 2.8), 0.38, 5)]
    camera = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 68.0)
    return make_scene(tris, tri_mat, spheres, [], materials, camera,
                      params.get("bvh", False), device)
