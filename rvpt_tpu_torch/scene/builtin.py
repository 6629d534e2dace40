"""Built-in demo scenes (mirror of ``rvpt_tpu/scene/builtin.py``): the two
analytic scenes of the Kajiya slice.  The mesh scenes wait for the BVH port."""

from __future__ import annotations

from ..models.camera import Camera
from .materials import DIELECTRIC, LAMBERT, MIRROR
from .scene import Scene, SceneBuilder


def sphere_plane(aspect: float = 1.0, device=None) -> tuple[Scene, Camera]:
    """Config 1: single sphere + ground plane, analytic intersections."""
    b = SceneBuilder()
    m_ground = b.add_material(albedo=(0.8, 0.8, 0.8), kind=LAMBERT)
    m_ball = b.add_material(albedo=(0.7, 0.3, 0.2), kind=LAMBERT)
    b.add_plane((0.0, 1.0, 0.0), -1.0, m_ground)
    b.add_sphere((0.0, 0.0, 4.0), 1.0, m_ball)
    cam = Camera.create(translation=(0, 0, 0), fov=90.0, aspect=aspect,
                        device=device)
    return b.build(device), cam


def cornell_box(aspect: float = 1.0, light_emission: float = 12.0,
                device=None) -> tuple[Scene, Camera]:
    """Config 2: Cornell box from quads + two spheres, area light in the
    ceiling: 12 triangles, 2 spheres, 6 materials."""
    b = SceneBuilder()
    white = b.add_material(albedo=(0.73, 0.73, 0.73), kind=LAMBERT)
    red = b.add_material(albedo=(0.65, 0.05, 0.05), kind=LAMBERT)
    green = b.add_material(albedo=(0.12, 0.45, 0.15), kind=LAMBERT)
    light = b.add_material(
        albedo=(0.0, 0.0, 0.0),
        emission=(light_emission, light_emission, light_emission),
        kind=LAMBERT,
    )
    mirror = b.add_material(albedo=(0.9, 0.9, 0.9), kind=MIRROR)
    glass = b.add_material(albedo=(0.98, 0.98, 0.98), kind=DIELECTRIC, ior=1.5)

    s = 1.0  # half-extent; box spans [-1,1]^2 in x,y and [2,4] in z
    z0, z1 = 2.0, 4.0
    # floor (y=-1)
    b.add_quad((-s, -s, z0), (s, -s, z0), (s, -s, z1), (-s, -s, z1), white)
    # ceiling (y=+1)
    b.add_quad((-s, s, z0), (-s, s, z1), (s, s, z1), (s, s, z0), white)
    # back wall (z=z1)
    b.add_quad((-s, -s, z1), (s, -s, z1), (s, s, z1), (-s, s, z1), white)
    # left wall (x=-1), red
    b.add_quad((-s, -s, z0), (-s, -s, z1), (-s, s, z1), (-s, s, z0), red)
    # right wall (x=+1), green
    b.add_quad((s, -s, z0), (s, s, z0), (s, s, z1), (s, -s, z1), green)
    # ceiling light patch
    l = 0.35
    lz0, lz1 = 2.65, 3.35
    eps = 1e-3
    b.add_quad(
        (-l, s - eps, lz0), (-l, s - eps, lz1), (l, s - eps, lz1), (l, s - eps, lz0),
        light,
    )
    # two spheres
    b.add_sphere((-0.45, -0.62, 3.3), 0.38, mirror)
    b.add_sphere((0.45, -0.62, 2.8), 0.38, glass)

    cam = Camera.create(translation=(0, 0, 0), fov=68.0, aspect=aspect,
                        device=device)
    return b.build(device), cam
