"""The system under test, reached through its public entry points only:
the benchmark's scene handed to the port as the port's ``Scene`` and
``Camera``.  Imported by the loops, never by the reference."""

from __future__ import annotations

from .reference.kajiya import Scene


def port_scene(s: Scene):
    """The port's ``Scene`` holding copies of ``s``'s tensors, with a BVH
    attached where ``s`` asks for one (its triangles then in leaf order)."""
    from rvpt_tpu_torch.scene.bvh import attach_bvh
    from rvpt_tpu_torch.scene.materials import Materials
    from rvpt_tpu_torch.scene.scene import Scene as PortScene

    c = (lambda x: x.detach().clone())
    scene = PortScene(
        tri_v0=c(s.v0), tri_v1=c(s.v1), tri_v2=c(s.v2), tri_mat=c(s.tri_mat),
        sph_center=c(s.sph_center), sph_radius=c(s.sph_radius),
        sph_mat=c(s.sph_mat), pln_normal=c(s.pln_normal), pln_d=c(s.pln_d),
        pln_mat=c(s.pln_mat),
        materials=Materials(albedo=c(s.albedo), emission=c(s.emission),
                            ior=c(s.ior), kind=c(s.kind)))
    return attach_bvh(scene) if s.bvh else scene


def port_camera(s: Scene, width: int, height: int):
    from rvpt_tpu_torch.models.camera import Camera

    return Camera.create(translation=s.cam_translation, rotation=s.cam_rotation,
                         fov=s.cam_fov, aspect=width / height, device=s.device)


def settings(bounces: int, style: str, integrator: int = 9):
    from rvpt_tpu_torch.config import RenderSettings

    quads = ("top_left_render_mode", "top_right_render_mode",
             "bottom_left_render_mode", "bottom_right_render_mode")
    return RenderSettings(max_bounces=int(bounces), style=style,
                          **dict.fromkeys(quads, int(integrator)))


def film(width: int, height: int):
    from rvpt_tpu_torch.config import FilmConfig

    return FilmConfig(int(width), int(height))


def build_kernels() -> None:
    """Build every kernel library that is not in the checkout's cache yet
    (all at once; a cached library costs a file check)."""
    from rvpt_tpu_torch.ops import build

    build.build_all(build.KERNELS)
