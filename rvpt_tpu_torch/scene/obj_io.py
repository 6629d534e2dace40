"""Wavefront OBJ ingest (mirror of ``rvpt_tpu/scene/obj_io.py``, the same
NumPy code: meshes are host data until ``SceneBuilder.build``).

The reference uses tinyobjloader with triangulation enabled and rejects
non-triangle faces after the fact (src/rvpt/main.cpp:12-62, 44-48).  This is
an independent parser: supports v/f records, polygon fan triangulation,
negative (relative) indices, and ignores normals/uvs/materials — exactly the
subset the reference consumes (positions only; it derives geometric normals
from winding, main.cpp:50-58).

A native C++ fast path (rvpt_tpu_torch.native) parses large OBJ files;
this pure-Python version is the always-available fallback and oracle.
"""

from __future__ import annotations

import numpy as np


def parse_obj(text: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse OBJ text -> (vertices f32[V,3], faces i32[F,3]).

    Polygon faces are fan-triangulated (tinyobjloader's default behavior that
    the reference relies on).  Indices may be 1-based or negative-relative.
    """
    verts: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif tag == "f":
            idx = []
            for tok in parts[1:]:
                i = int(tok.split("/")[0])
                idx.append(i - 1 if i > 0 else len(verts) + i)
            for k in range(1, len(idx) - 1):
                faces.append((idx[0], idx[k], idx[k + 1]))
    v = np.asarray(verts, np.float32) if verts else np.zeros((0, 3), np.float32)
    f = np.asarray(faces, np.int32) if faces else np.zeros((0, 3), np.int32)
    if len(f) and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("OBJ face index out of range")
    return v, f


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Load an OBJ file; prefers the native C++ parser when built."""
    from ..native import obj_native

    out = obj_native.parse_obj_file(path)
    if out is not None:
        return out
    with open(path) as f:
        return parse_obj(f.read())


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write(f"v {v[0]:.6g} {v[1]:.6g} {v[2]:.6g}\n")
        for face in np.asarray(faces):
            f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")


def make_icosphere(subdiv: int = 2, radius: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """Procedural test mesh (our own demo asset; the reference ships a 143-tri
    rabbit — an icosphere at subdiv 2 has a comparable 320 triangles)."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        np.float64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [tuple(p) for p in v]
    cache: dict[tuple[int, int], int] = {}

    def midpoint(a: int, b: int) -> int:
        key = (min(a, b), max(a, b))
        if key in cache:
            return cache[key]
        m = np.asarray(verts[a]) + np.asarray(verts[b])
        m /= np.linalg.norm(m)
        verts.append(tuple(m))
        cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdiv):
        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        f = nf
    return (
        (np.asarray(verts) * radius).astype(np.float32),
        np.asarray(f, np.int32),
    )


def make_terrain(n: int = 225, size: float = 8.0, height: float = 1.0,
                 seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Procedural heightfield mesh: (n-1)^2 * 2 triangles on an n x n grid.

    The >=100k-triangle workload the reference's BVH traversal could take
    (assets/shaders/intersection.glsl:361-463 walks arbitrary mesh sizes) —
    n=225 gives 100,352 triangles.  Heights are a fixed sum of sinusoids
    (deterministic per seed) so goldens and benchmarks are reproducible.
    """
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(0.5, 2.5, size=(4, 2))
    phases = rng.uniform(0, 2 * np.pi, size=4)
    amps = rng.uniform(0.3, 1.0, size=4)
    amps /= amps.sum()

    axis = np.linspace(-size / 2, size / 2, n, dtype=np.float64)
    X, Z = np.meshgrid(axis, axis, indexing="ij")
    Y = np.zeros_like(X)
    for (fx, fz), ph, a in zip(freqs, phases, amps):
        Y += a * np.sin(fx * X + ph) * np.cos(fz * Z + ph * 0.7)
    Y *= height

    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float32)
    i = np.arange(n * n).reshape(n, n)
    a = i[:-1, :-1].ravel()
    b = i[1:, :-1].ravel()
    c = i[:-1, 1:].ravel()
    d = i[1:, 1:].ravel()
    faces = np.concatenate(
        [np.stack([a, b, c], axis=-1), np.stack([b, d, c], axis=-1)]
    ).astype(np.int32)
    return verts, faces
