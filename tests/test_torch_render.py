"""The Kajiya display slice of rvpt_tpu_torch as a whole: goldens, the
Renderer against the JAX Renderer, and the no-JAX import rule."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rvpt_tpu.utils.image import read_png
from rvpt_tpu_torch import FilmConfig, RenderSettings
from rvpt_tpu_torch.models.camera import CAMERA_MODE_NAMES
from rvpt_tpu_torch.ops.film import Film, chw_to_hwc, to_srgb_u8
from rvpt_tpu_torch.render import render_frame
from rvpt_tpu_torch.renderer import Renderer
from rvpt_tpu_torch.scene import builtin

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (scene, camera mode, size, frames, bounces), as tests/make_goldens.py
GOLDENS = {
    "cornell_kajiya": ("cornell_box", "pinhole", 64, 4, 4),
    "sphere_plane_kajiya": ("sphere_plane", "pinhole", 64, 4, 4),
    "cornell_ortho": ("cornell_box", "ortho", 64, 2, 3),
    "cornell_spherical": ("cornell_box", "spherical", 64, 2, 3),
}


def _frac_off(got, want):
    """The tests/test_goldens.py measure: share of u8 subpixels more than
    2 steps apart (the bar is < 0.2%)."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return (diff > 2).mean()


def _render_golden(name, fast):
    import dataclasses

    scene_name, cam_mode, size, frames, bounces = GOLDENS[name]
    cfg = FilmConfig(width=size, height=size)
    scene, cam = getattr(builtin, scene_name)(aspect=cfg.aspect)
    cam = dataclasses.replace(cam, mode=CAMERA_MODE_NAMES[cam_mode])
    st = RenderSettings(max_bounces=bounces,
                        camera_mode=CAMERA_MODE_NAMES[cam_mode])
    film = Film.create(cfg.height, cfg.width)
    for f in range(frames):
        film, img = render_frame(scene, cam, st, cfg, film, f == 0, fast=fast)
    return to_srgb_u8(chw_to_hwc(img)).numpy()


@pytest.mark.parametrize("fast", [False, True], ids=["plain_path", "trace_plain"])
@pytest.mark.parametrize("name", list(GOLDENS))
def test_render_frame_reproduces_golden(name, fast):
    """Both routes on the CPU: the plain integrator path and the plain
    version of the whole-path kernel."""
    got = _render_golden(name, fast)
    want = read_png(os.path.join(GOLDEN_DIR, f"{name}.png"))
    assert got.shape == want.shape
    frac = _frac_off(got, want)
    assert frac < 0.002, f"golden {name}: {frac:.4%} of subpixels differ by >2"


def test_renderer_matches_jax_renderer():
    """4 draws at 64x64 with the display settings (4 bounces, standard)."""
    from rvpt_tpu import FilmConfig as JFilmConfig
    from rvpt_tpu import RenderSettings as JRenderSettings
    from rvpt_tpu.ops.film import to_srgb_u8 as j_srgb
    from rvpt_tpu.renderer import Renderer as JRenderer
    from rvpt_tpu.scene import builtin as jbuiltin

    js, jc = jbuiltin.cornell_box(aspect=1.0)
    jr = JRenderer(js, jc, JRenderSettings(max_bounces=4, style="standard"),
                   JFilmConfig(64, 64))
    ts, tc = builtin.cornell_box(aspect=1.0)
    tr = Renderer(ts, tc, RenderSettings(max_bounces=4, style="standard"),
                  FilmConfig(64, 64))
    for _ in range(4):
        jr.draw()
        tr.draw()
    tr.flush()
    assert tr.film.frame == int(jr.film.frame) == 4
    want = np.asarray(j_srgb(np.moveaxis(np.asarray(jr.film.accum), 0, -1)))
    got = to_srgb_u8(chw_to_hwc(tr.film.accum)).numpy()
    frac = _frac_off(got, want)
    assert frac < 0.002, f"{frac:.4%} of subpixels differ by >2"
    s = tr.stats()
    assert s["frames"] == 4 and s["accumulated_frames"] == 4
    assert tr.rays_per_frame == 64 * 64 * 4


def test_renderer_dirty_reset_and_save(tmp_path):
    cfg = FilmConfig(width=16, height=8)
    scene, cam = builtin.sphere_plane(aspect=cfg.aspect)
    r = Renderer(scene, cam, RenderSettings(max_bounces=2), cfg)
    r.draw()
    r.draw()
    assert r.film.frame == 2
    r.update_camera(translation=(0.0, 0.0, -0.5))
    r.draw()
    assert r.film.frame == 1
    r.settings = r.settings.replace(max_bounces=3)
    r.draw()
    assert r.film.frame == 1
    path = tmp_path / "frame.png"
    r.save_image(str(path))
    img = read_png(str(path))
    assert img.shape == (8, 16, 3) and img.max() > 0


def test_port_imports_no_jax():
    """Import every module of rvpt_tpu_torch in a fresh interpreter in
    which importing jax or rvpt_tpu raises."""
    code = r"""
import importlib, pkgutil, sys
BANNED = ("jax", "jaxlib", "rvpt_tpu")
for k in [k for k in sys.modules if k.split(".")[0] in BANNED]:
    del sys.modules[k]
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("banned import: " + name)
        return None
sys.meta_path.insert(0, Block())
import rvpt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rvpt_tpu_torch.__path__, "rvpt_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not [k for k in sys.modules if k.split(".")[0] in BANNED]
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
