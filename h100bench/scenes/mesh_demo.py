"""The port's ``mesh_demo(subdiv)`` (``scene/builtin.py:75-95``): an
icosphere of 20 x 4^subdiv triangles (``scene/obj_io.py:69-110``) at z = 4
on a floor plane, under a 2-triangle area light; the port attaches a BVH.
Faces keep the subdivision's order, so consecutive triangles lie together."""

from __future__ import annotations

import numpy as np

from ._quads import make_scene, quad

LAMBERT = 0


def icosphere(subdiv: int, radius: float = 1.0):
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
                  [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
                  [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]],
                 np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [tuple(p) for p in v]
    cache: dict = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in cache:
            m = np.asarray(verts[a]) + np.asarray(verts[b])
            verts.append(tuple(m / np.linalg.norm(m)))
            cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdiv):
        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        f = nf
    return (np.asarray(verts) * radius).astype(np.float32), np.asarray(f, np.int64)


def build(params: dict, device):
    v, f = icosphere(int(params["subdiv"]))
    v = v + np.asarray([0.0, 0.0, 4.0], np.float32)
    tris = np.stack([v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]], axis=1)
    light = np.asarray(quad((-1.2, 2.4, 3.0), (-1.2, 2.4, 5.0), (1.2, 2.4, 5.0),
                            (1.2, 2.4, 3.0)), np.float32)
    tris = np.concatenate([tris, light])
    tri_mat = [1] * len(f) + [2, 2]
    materials = [((0.75, 0.75, 0.75), (0.0, 0.0, 0.0), LAMBERT, 1.5),  # floor
                 ((0.7, 0.25, 0.2), (0.0, 0.0, 0.0), LAMBERT, 1.5),  # body
                 ((0.0, 0.0, 0.0), (10.0, 10.0, 10.0), LAMBERT, 1.5)]  # light
    planes = [((0.0, 1.0, 0.0), -1.0, 0)]
    camera = ((0.0, 0.4, 0.0), (0.0, 0.0, 0.0), 70.0)
    return make_scene(tris, tri_mat, [], planes, materials, camera,
                      params.get("bvh", True), device)
