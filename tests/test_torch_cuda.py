"""The CUDA path kernel of rvpt_tpu_torch against its plain PyTorch version,
on the card.  Every test here needs an NVIDIA card and skips without one.
This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Bar: >= 99.5% of pixel channels within 1e-4 (the tests/test_megakernel.py
bar); the kernel is built with --fmad=false and rounds like the plain
version's unfused ops, so it usually agrees exactly.
"""

import dataclasses

import pytest
import torch

from rvpt_tpu_torch import FilmConfig, RenderSettings
from rvpt_tpu_torch.models import camera as tcam
from rvpt_tpu_torch.ops import pathkernel as tpk
from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays, render_sample_fast_chw
from rvpt_tpu_torch.scene import builtin
from rvpt_tpu_torch.scene.scene import SceneBuilder

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _share(got, want):
    return torch.isclose(got, want, rtol=1e-4, atol=1e-4).float().mean().item()


def _kernel_and_plain(scene, cam, cfg, dev, gen_rays, bounces=3, style="standard"):
    pt = tpk.PathTracer(scene)
    pixel, xs, ys = _pixel_grid(cfg, dev)
    ray = jittered_camera_rays(cam, cfg, pixel, xs, ys, 2, 0)
    comps = tuple(c.contiguous() for c in (
        ray.origin[:, 0], ray.origin[:, 1], ray.origin[:, 2],
        ray.direction[:, 0], ray.direction[:, 1], ray.direction[:, 2]))
    cam_params = tpk.camera_params(cam, cfg)
    kw = dict(rays=None if gen_rays else comps, cam_params=cam_params,
              cam_mode=cam.mode, jitter_salt=0)
    got = tpk.launch_path_kernel(pt.tables, pt.counts, pixel, cfg.num_pixels, 2,
                                 16, bounces, style, **kw)
    want = tpk.trace_plain(pt.tables, pt.counts, pixel, 2, 16, bounces, style, **kw)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("gen_rays", [False, True])
@pytest.mark.parametrize("mode", [tcam.PINHOLE, tcam.ORTHO, tcam.SPHERICAL])
@pytest.mark.parametrize("scene_name", ["cornell_box", "sphere_plane"])
def test_kernel_matches_plain(dev, scene_name, mode, gen_rays):
    cfg = FilmConfig(width=320, height=180)
    scene, cam = getattr(builtin, scene_name)(aspect=cfg.aspect, device=dev)
    cam = dataclasses.replace(cam, mode=mode)
    got, want = _kernel_and_plain(scene, cam, cfg, dev, gen_rays)
    assert torch.isfinite(got).all()
    share = _share(got, want)
    assert share >= 0.995, f"only {share:.4%} of pixel channels match"


@pytest.mark.parametrize("style", ["reference", "standard"])
def test_kernel_deep_paths_and_styles(dev, style):
    """12 bounces, past the JAX kernel's 8-bounce group split."""
    cfg = FilmConfig(width=160, height=90)
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device=dev)
    got, want = _kernel_and_plain(scene, cam, cfg, dev, True, bounces=12,
                                  style=style)
    share = _share(got, want)
    assert share >= 0.995, f"only {share:.4%} of pixel channels match"


def test_kernel_single_family_scenes(dev):
    """Triangles only, and one sphere with no materials at all."""
    b = SceneBuilder()
    m = b.add_material(albedo=(0.5, 0.5, 0.5))
    b.add_triangle((-5, -5, 3), (5, -5, 3), (0, 8, 3), m)
    tri_only = b.build(dev)
    b2 = SceneBuilder()
    b2.add_sphere((0, 0, 4), 1.0, 0)
    no_mats = b2.build(dev)
    cfg = FilmConfig(width=64, height=32)
    cam = tcam.Camera.create(fov=90.0, aspect=cfg.aspect, device=dev)
    for scene in (tri_only, no_mats):
        got, want = _kernel_and_plain(scene, cam, cfg, dev, True)
        assert torch.isfinite(got).all()
        assert _share(got, want) >= 0.995


def test_fast_route_counts_launches_and_matches_cpu(dev):
    """render_sample_fast_chw on the card: one launch per AA sample, and the
    film agrees with the CPU plain version of the same frame."""
    cfg = FilmConfig(width=64, height=32)
    st = RenderSettings(max_bounces=3, aa=2, style="standard")
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device=dev)
    cpu_scene, cpu_cam = builtin.cornell_box(aspect=cfg.aspect)
    before = tpk.launch_path_kernel.launches
    got = render_sample_fast_chw(scene, cam, st, cfg, 4)
    assert tpk.launch_path_kernel.launches == before + 2
    want = render_sample_fast_chw(cpu_scene, cpu_cam, st, cfg, 4)
    assert _share(got.cpu(), want) >= 0.995


def test_kernel_rejects_bad_inputs(dev):
    cfg = FilmConfig(width=8, height=4)
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device=dev)
    pt = tpk.PathTracer(scene)
    big = torch.zeros(20_000, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="shared-memory"):
        tpk.launch_path_kernel(big, (0, 0, 0, 2500), None, 32, 0, 16, 2,
                               "standard", cam_params=tpk.camera_params(cam, cfg))
    with pytest.raises(ValueError, match="cam_params"):
        tpk.launch_path_kernel(pt.tables, pt.counts, None, 32, 0, 16, 2, "standard")
    with pytest.raises(ValueError, match="pixel"):
        tpk.launch_path_kernel(pt.tables, pt.counts,
                               torch.arange(32, dtype=torch.int32, device=dev),
                               32, 0, 16, 2, "standard",
                               cam_params=tpk.camera_params(cam, cfg))
