"""The camera-ray kernel (``csrc/camera_rays.cu``, ``ops/camera_rays.py``)
against the plain PyTorch arithmetic it replaces, bit for bit.

The CPU tests hold ``jittered_camera_rays`` on the CPU to the arithmetic
the renderer and the trainer wrote inline before the kernel (the display's
reciprocal multiply, the trainer's division) and check that no launch is
counted there.  The card tests (``-m cuda``, skipped without a card) count
the differing bits between the kernel's rays and the plain arithmetic run
on the card (``interpret_kernels``), which must be zero, in every camera
mode, both roundings, raster ids and id tensors; count its launches per
draw and per trainer step; and hold a camera that requires grad to the
autograd arithmetic.  This file imports no JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_camera_rays.py
"""

import dataclasses

import pytest
import torch

from rvpt_tpu_torch import FilmConfig, RenderSettings
from rvpt_tpu_torch.core import rng
from rvpt_tpu_torch.models import camera as tcam
from rvpt_tpu_torch.models.integrators import AA_STRIDE
from rvpt_tpu_torch.ops.camera_rays import launch_camera_rays
from rvpt_tpu_torch.parallel.sharded import _padded_grid
from rvpt_tpu_torch.render import (_JITTER_SITE, _pixel_grid, _rect_pixels,
                                   _split_partition, jittered_camera_rays)
from rvpt_tpu_torch.scene import builtin
from rvpt_tpu_torch.utils.debug import interpret_kernels

HD = FilmConfig(width=1920, height=1080)


def _inline_rays(cam, cfg, pixel, xs, ys, frame, salt0, divide):
    """The rays as ``render.jittered_camera_rays`` (reciprocal multiply)
    and ``train.inverse._make_fast_render`` (division) wrote them inline."""
    ju, jv = rng.uniform2(pixel, frame, salt0 + _JITTER_SITE)
    if divide:
        cx = (xs.to(torch.float32) + ju) / cfg.width
        cy = 1.0 - (ys.to(torch.float32) + jv) / cfg.height
    else:
        cx = (xs.to(torch.float32) + ju) * (1.0 / cfg.width)
        cy = 1.0 - (ys.to(torch.float32) + jv) * (1.0 / cfg.height)
    return tcam.generate_rays(cam, cx, cy)


def _differing_bits(a, b) -> int:
    """Components of two rays whose f32 bits differ (-0 against +0 too)."""
    n = 0
    for x, y in ((a.origin, b.origin), (a.direction, b.direction)):
        x, y = x.expand(y.shape).contiguous(), y.expand(x.shape).contiguous()
        n += int((x.view(torch.int32) != y.view(torch.int32)).sum())
    return n


def _rows_apart(ray) -> bool:
    """Rays laid out by rows: origin and direction each row-major or one
    vector broadcast to every row (the pinhole's origin, the ortho
    camera's direction), never the columns of a [6, N] buffer."""
    return all(x.is_contiguous() or x.stride(0) == 0
               for x in (ray.origin, ray.direction))


def _camera(kind, dev, aspect):
    if kind == "cornell":
        return builtin.cornell_box(aspect=aspect, device=dev)[1]
    mode = {"pinhole": tcam.PINHOLE, "ortho": tcam.ORTHO,
            "spherical": tcam.SPHERICAL}[kind]
    return tcam.Camera.create(translation=(0.3, 1.1, -2.5),
                              rotation=(23.0, -11.5, 4.0), fov=63.0, scale=2.5,
                              aspect=aspect, mode=mode, device=dev)


# --- CPU: the plain arithmetic, unchanged ---------------------------------


@pytest.mark.parametrize("divide", [False, True])
@pytest.mark.parametrize("kind", ["cornell", "ortho", "spherical"])
def test_cpu_rays_are_the_inline_arithmetic(kind, divide):
    cfg = FilmConfig(width=37, height=23)
    cam = _camera(kind, "cpu", cfg.width / cfg.height)
    pixel, xs, ys = _pixel_grid(cfg, "cpu")
    before = launch_camera_rays.launches
    want = _inline_rays(cam, cfg, pixel, xs, ys, 5, 3 * AA_STRIDE, divide)
    for args in ((pixel, xs, ys), (pixel, None, None), (cfg.num_pixels, None, None)):
        for planes in (False, True):  # no buffer views off the card
            got = jittered_camera_rays(cam, cfg, *args, 5, 3 * AA_STRIDE,
                                       divide=divide, planes=planes)
            assert _rows_apart(got) and _differing_bits(got, want) == 0
    assert launch_camera_rays.launches == before


# --- the card ---------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _kernel_and_plain(cam, cfg, pixel, xs, ys, frame, salt0, divide):
    before = launch_camera_rays.launches
    got = jittered_camera_rays(cam, cfg, pixel, xs, ys, frame, salt0, divide=divide)
    assert launch_camera_rays.launches == before + 1
    with interpret_kernels():
        want = jittered_camera_rays(cam, cfg, pixel, xs, ys, frame, salt0,
                                    divide=divide)
    assert launch_camera_rays.launches == before + 1
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("divide", [False, True])
@pytest.mark.parametrize("kind", ["cornell", "mesh", "pinhole", "ortho", "spherical"])
def test_kernel_rays_bit_for_bit_1080p(dev, kind, divide):
    if kind == "mesh":
        cam = builtin.mesh_demo(1, aspect=16 / 9, device=dev)[1]
    else:
        cam = _camera(kind, dev, 16 / 9)
    got, want = _kernel_and_plain(cam, HD, HD.num_pixels, None, None, 1, 0, divide)
    assert got.origin.shape == want.origin.shape == (HD.num_pixels, 3)
    assert _differing_bits(got, want) == 0
    # The raster ids as a tensor take the same rays.
    pixel, xs, ys = _pixel_grid(HD, dev)
    ids, _ = _kernel_and_plain(cam, HD, pixel, xs, ys, 1, 0, divide)
    assert _differing_bits(ids, want) == 0


def _quadrant(cfg, dev):
    st = RenderSettings(top_left_render_mode=5, top_right_render_mode=9,
                        bottom_left_render_mode=2, bottom_right_render_mode=9)
    _, (y0, y1, x0, x1) = _split_partition(cfg, st)[3]
    return _rect_pixels(y0, y1, x0, x1, cfg.width, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("divide", [False, True])
@pytest.mark.parametrize("kind", ["cornell", "ortho", "spherical"])
@pytest.mark.parametrize("case", ["quadrant", "tile", "odd", "frame0", "big_frame",
                                  "salt_near_2_32"])
def test_kernel_rays_bit_for_bit_edges(dev, case, kind, divide):
    cfg, frame, salt0 = HD, 7, AA_STRIDE
    xs = ys = None
    if case == "quadrant":
        pixel = _quadrant(cfg, dev)
    elif case == "tile":  # a sharded tile whose last lanes wrap around
        pixel, xs, ys = _padded_grid(cfg, 7, 6, dev)
        assert 7 * pixel.shape[0] > cfg.num_pixels
    elif case == "odd":  # a ragged last block
        cfg = FilmConfig(width=333, height=197)
        pixel = cfg.num_pixels
    elif case == "frame0":
        pixel, frame = cfg.num_pixels, 0
    elif case == "big_frame":
        pixel, frame = cfg.num_pixels, 2**32 + 2**31 + 12345
    else:
        pixel, salt0 = cfg.num_pixels, 2**32 - 3
    cam = _camera(kind, dev, cfg.width / cfg.height)
    got, want = _kernel_and_plain(cam, cfg, pixel, xs, ys, frame, salt0, divide)
    assert _differing_bits(got, want) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("divide", [False, True])
def test_kernel_rays_layout(dev, divide):
    """Rays laid out by rows by default, whose directions' last-axis sums
    are the plain rays' bit for bit; the kernel's buffer views with
    ``planes``, same bits, each ``.T`` contiguous for a rays-in tracer."""
    cam = _camera("cornell", dev, 16 / 9)
    got, want = _kernel_and_plain(cam, HD, HD.num_pixels, None, None, 1, 0, divide)
    assert got.origin.is_contiguous() and _rows_apart(want)
    sa, sb = (r.direction.square().sum(dim=-1) for r in (got, want))
    assert torch.equal(sa.view(torch.int32), sb.view(torch.int32))
    before = launch_camera_rays.launches
    views = jittered_camera_rays(cam, HD, HD.num_pixels, None, None, 1, 0,
                                 divide=divide, planes=True)
    assert launch_camera_rays.launches == before + 1
    assert views.origin.T.is_contiguous() and views.direction.T.is_contiguous()
    assert views.origin.T.data_ptr() + 3 * 4 * HD.num_pixels == views.direction.T.data_ptr()
    assert _differing_bits(views, want) == 0


@pytest.mark.cuda
def test_camera_constants_follow_in_place_changes(dev):
    cam = _camera("pinhole", dev, 16 / 9)
    cfg = FilmConfig(width=64, height=36)
    got, want = _kernel_and_plain(cam, cfg, cfg.num_pixels, None, None, 1, 0, False)
    with torch.no_grad():
        cam.rotation.add_(torch.tensor([5.0, 0.0, -2.0], device=dev))
        cam.fov.fill_(48.0)
    moved, want2 = _kernel_and_plain(cam, cfg, cfg.num_pixels, None, None, 1, 0, False)
    assert _differing_bits(moved, want2) == 0
    assert _differing_bits(moved, want) > 0


@pytest.mark.cuda
def test_one_launch_per_big_mesh_draw(dev):
    from rvpt_tpu_torch.renderer import Renderer

    scene, cam = builtin.mesh_demo(3, aspect=2.0, device=dev)
    r = Renderer(scene, cam, RenderSettings(max_bounces=4),
                 FilmConfig(width=256, height=128))
    r.draw()
    torch.cuda.synchronize()
    before = launch_camera_rays.launches
    for _ in range(3):
        r.draw()
    torch.cuda.synchronize()
    assert launch_camera_rays.launches - before == 3


@pytest.mark.cuda
def test_two_launches_per_cornell_step_and_none_for_a_trained_camera(dev):
    from rvpt_tpu_torch.train import inverse

    scene, cam = builtin.cornell_box(aspect=2.0, device=dev)
    cfg = FilmConfig(width=128, height=64)
    st = RenderSettings(max_bounces=3, style="standard")
    target = torch.full((3, cfg.height, cfg.width), 0.3, device=dev)
    for groups, launches in ((("albedo", "emission"), 2), (("camera",), 0)):
        step, opt = inverse.make_train_step(scene, cam, st, cfg, None, target,
                                            groups=groups)
        params = inverse.trainable_params(scene, groups, cam)
        params, opt, _ = step(params, opt, 0)
        torch.cuda.synchronize()
        before = launch_camera_rays.launches
        params, opt, loss = step(params, opt, 1)
        torch.cuda.synchronize()
        assert launch_camera_rays.launches - before == launches
        assert torch.isfinite(loss)


@pytest.mark.cuda
@pytest.mark.parametrize("divide", [False, True])
def test_a_camera_that_requires_grad_takes_autograd(dev, divide):
    cfg = FilmConfig(width=96, height=54)
    pixel, xs, ys = _pixel_grid(cfg, dev)
    wo = torch.linspace(-1.0, 1.0, 3 * cfg.num_pixels, device=dev).reshape(-1, 3)
    wd = torch.linspace(0.5, -2.0, 3 * cfg.num_pixels, device=dev).reshape(-1, 3)
    grads = []
    for rays in (jittered_camera_rays, _inline_rays):
        cam = _camera("pinhole", dev, cfg.width / cfg.height)
        cam = dataclasses.replace(cam,
                                  translation=cam.translation.requires_grad_(True),
                                  rotation=cam.rotation.requires_grad_(True))
        before = launch_camera_rays.launches
        ray = rays(cam, cfg, pixel, xs, ys, 3, 0, divide)
        assert launch_camera_rays.launches == before
        ((ray.origin * wo).sum() + (ray.direction * wd).sum()).backward()
        grads.append((cam.translation.grad, cam.rotation.grad))
    for a, b in zip(*grads):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_plain_path_and_soa_gradient_unchanged_by_the_kernel_rays(dev):
    """The plain integrator path and the SoA replay's gradient on the
    kernel's rays equal those on the plain arithmetic's rays, bit for bit:
    the plain path takes row-major rays, the SoA trace the kernel's views
    (``planes``, as the trainer hands them) and replays on row-major
    copies."""
    from rvpt_tpu_torch.ops.fast_grad import make_fast_kajiya
    from rvpt_tpu_torch.render import render_pixels

    cfg = FilmConfig(width=160, height=96)
    pixel, xs, ys = _pixel_grid(cfg, dev)
    scene, cam = builtin.cornell_box(aspect=cfg.width / cfg.height, device=dev)
    st = RenderSettings(max_bounces=3, style="standard")
    img = render_pixels(scene, cam, st, cfg, 2, pixel, xs, ys)
    with interpret_kernels():
        ray = jittered_camera_rays(cam, cfg, pixel, xs, ys, 2, 0)
    from rvpt_tpu_torch.models.integrators import eval_integrator
    from rvpt_tpu_torch.render import _INTEGRATOR_SITE

    col = eval_integrator(9, scene, ray, pixel, 2, st, _INTEGRATOR_SITE)
    want = (torch.zeros_like(col) + col) / st.aa  # render_pixels' AA mean
    assert torch.equal(img.view(torch.int32), want.view(torch.int32))

    ms, mcam = builtin.mesh_demo(3, aspect=cfg.width / cfg.height, device=dev)
    trace = make_fast_kajiya(ms, _INTEGRATOR_SITE, 4, style="standard",
                             backward="soa")
    grads = []
    for plain in (False, True):
        if plain:
            with interpret_kernels():
                ray = jittered_camera_rays(mcam, cfg, pixel, xs, ys, 1, 0, divide=True)
        else:
            ray = jittered_camera_rays(mcam, cfg, pixel, xs, ys, 1, 0, divide=True,
                                       planes=True)
        albedo = ms.materials.albedo.detach().clone().requires_grad_(True)
        s = dataclasses.replace(ms, materials=dataclasses.replace(ms.materials,
                                                                  albedo=albedo))
        trace(s, ray.origin, ray.direction, pixel, 1).square().sum().backward()
        grads.append(albedo.grad)
    assert torch.equal(grads[0].view(torch.int32), grads[1].view(torch.int32))
