"""Split-screen in rvpt_tpu_torch against rvpt_tpu: the quadrant
partition, a 4-mode split frame through both routes, and the Renderer.

The partition must reproduce the per-pixel selection of ``_mode_masks``
exactly (tests/test_render.py:75), at split ratios that land on pixel
edges.  The split frame (AO, Whitted, Hart, Kajiya at 3 bounces, 24x16)
goes through ``render_sample_fast_chw`` (each quadrant's kernel, here its
plain version, on that quadrant's pixels) and ``render_sample_chw`` (every
integrator on every pixel, then a select), both against JAX
``render_sample_chw``: >= 99.5% of channels within rtol/atol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvpt_tpu import FilmConfig as JFilmConfig
from rvpt_tpu import RenderSettings as JRenderSettings
from rvpt_tpu import render as jrender
from rvpt_tpu.scene import builtin as jbuiltin
from rvpt_tpu_torch import FilmConfig, RenderSettings
from rvpt_tpu_torch import render as trender
from rvpt_tpu_torch.ops import pathkernel as tpk
from rvpt_tpu_torch.renderer import Renderer
from rvpt_tpu_torch.scene import builtin as tbuiltin

# (ao, whitted, hart, kajiya): the split of chip_smoke.py's display phase.
SPLIT = dict(top_left_render_mode=5, top_right_render_mode=7,
             bottom_left_render_mode=10, bottom_right_render_mode=9)

# (width, height, split ratio): odd sizes, ratios on pixel edges (0.5 of
# 32 is x = 16 exactly, where the top and bottom halves split apart), and
# the degenerate ratios that empty whole quadrants.
PARTITIONS = [
    (31, 17, (0.3, 0.6)),
    (32, 16, (0.5, 0.5)),
    (32, 16, (0.25, 0.75)),
    (20, 10, (0.0, 0.0)),
    (20, 10, (1.0, 1.0)),
    (7, 5, (0.6, 0.2)),
]


@pytest.mark.parametrize("width,height,ratio", PARTITIONS)
def test_split_partition_matches_mode_masks(width, height, ratio):
    cfg = FilmConfig(width, height)
    st = RenderSettings(top_left_render_mode=3, top_right_render_mode=0,
                        bottom_left_render_mode=1, bottom_right_render_mode=9,
                        split_ratio=ratio)
    pixel, xs, ys = trender._pixel_grid(cfg, "cpu")
    want = trender._mode_masks(st, xs, ys, cfg).numpy()
    jst = JRenderSettings(**{k: getattr(st, k) for k in (
        "top_left_render_mode", "top_right_render_mode",
        "bottom_left_render_mode", "bottom_right_render_mode", "split_ratio")})
    jcfg = JFilmConfig(width, height)
    _, jxs, jys = jrender._pixel_grid(jcfg)
    assert np.array_equal(want, np.asarray(jrender._mode_masks(jst, jxs, jys, jcfg)))
    got = np.full_like(want, -1)
    for m, (y0, y1, x0, x1) in trender._split_partition(cfg, st):
        pix = trender._rect_pixels(y0, y1, x0, x1, width, "cpu").numpy()
        ys2, xs2 = np.mgrid[y0:y1, x0:x1]
        assert np.array_equal(pix, (xs2 + ys2 * width).ravel())
        assert (got[pix] == -1).all()  # rectangles do not overlap
        got[pix] = m
    assert np.array_equal(got, want)
    assert trender._split_partition(cfg, st) == jrender._split_partition(jcfg, jst)


@pytest.fixture(scope="module")
def split_frame():
    """JAX render_sample_chw of the 4-mode split, 24x16, 3 bounces, once."""
    cfg = JFilmConfig(24, 16)
    js, jc = jbuiltin.cornell_box(aspect=cfg.aspect)
    st = JRenderSettings(max_bounces=3, **SPLIT)
    frame = int(np.random.default_rng(9).integers(0, 1000))
    return frame, np.asarray(jrender.render_sample_chw(js, jc, st, cfg,
                                                       jnp.uint32(frame)))


@pytest.mark.parametrize("route", ["fast", "plain"])
def test_split_frame_matches_jax(split_frame, route):
    frame, want = split_frame
    cfg = FilmConfig(24, 16)
    ts, tc = tbuiltin.cornell_box(aspect=cfg.aspect, device="cpu")
    st = RenderSettings(max_bounces=3, **SPLIT)
    render = (trender.render_sample_fast_chw if route == "fast"
              else trender.render_sample_chw)
    got = render(ts, tc, st, cfg, frame).numpy()
    assert got.shape == want.shape == (3, 16, 24)
    share = np.isclose(got, want, rtol=1e-4, atol=1e-4).mean()
    assert share >= 0.995, f"{route}: only {share:.4%} of channels match"


def test_split_frame_aa_routes_agree():
    """Two AA samples per pixel: each quadrant's kernel averages its own
    samples, as the plain path averages the selected integrators'."""
    cfg = FilmConfig(24, 16)
    ts, tc = tbuiltin.cornell_box(aspect=cfg.aspect, device="cpu")
    st = RenderSettings(max_bounces=2, aa=2, split_ratio=(0.4, 0.3), **SPLIT)
    fast = trender.render_sample_fast_chw(ts, tc, st, cfg, 3)
    plain = trender.render_sample_chw(ts, tc, st, cfg, 3)
    share = torch.isclose(fast, plain, rtol=1e-4, atol=1e-4).float().mean().item()
    assert share >= 0.995, f"only {share:.4%} of channels match"


def test_fast_route_serves_every_mode_and_keeps_scope():
    """Every integrator id is in the kernels' scope; an id outside the
    table is not (it takes the plain path's Hart fallback), and the
    trainer's paired trace stays Kajiya-only."""
    from rvpt_tpu_torch.train.inverse import _fast_eligible

    ts, _ = tbuiltin.cornell_box(device="cpu")
    for mode in range(11):
        st = RenderSettings(top_left_render_mode=mode)
        assert trender._megakernel_eligible(ts, st)
        assert _fast_eligible(ts, st) == (mode == 9)
    assert not trender._megakernel_eligible(ts, RenderSettings(top_left_render_mode=11))


def test_display_scope_is_the_staging_not_the_backward_limit():
    """A 1,500-triangle scene without a BVH stays on the kernels' route for
    display (on the CPU their plain versions, which stage anything), and
    the trainer's paired trace serves it past the backward kernel's 1,024
    with the SoA replay."""
    from rvpt_tpu_torch.scene.scene import SceneBuilder
    from rvpt_tpu_torch.train.inverse import _fast_eligible

    r = np.random.default_rng(4)
    b = SceneBuilder()
    m = b.add_material(albedo=(0.6, 0.6, 0.6))
    for c in r.uniform(-2, 2, (tpk.MAX_BWD_TRIANGLES + 476, 3)):
        b.add_triangle(tuple(c), tuple(c + 0.1), tuple(c + (0.1, -0.1, 0.0)), m)
    big = b.build("cpu")
    kajiya = RenderSettings()
    assert big.num_triangles == 1500
    assert trender._megakernel_eligible(big, kajiya)
    assert trender._megakernel_eligible(big, RenderSettings(**SPLIT))
    assert _fast_eligible(big, kajiya)
    assert not _fast_eligible(big, RenderSettings(**SPLIT))
    small, _ = tbuiltin.cornell_box(device="cpu")
    assert _fast_eligible(small, kajiya)


def test_records_are_kajiya_only():
    ts, _ = tbuiltin.cornell_box(device="cpu")
    tables, counts = tpk.pack_fwd(ts)
    pix = torch.arange(8)
    rays = tuple(torch.zeros(8) for _ in range(6))
    with pytest.raises(ValueError, match="Kajiya-only"):
        tpk.trace_plain(tables, counts, pix, 0, 16, 2, "standard", rays=rays,
                        collect=True, integ="whitted")
    with pytest.raises(ValueError, match="Kajiya-only"):
        tpk.PathTracer(ts).trace(pix, torch.zeros(8, 3), torch.ones(8, 3), 0,
                                 16, 2, collect_states=True, integ="cook")
    with pytest.raises(ValueError, match="Kajiya-only"):
        tpk.launch_path_kernel(tables, counts, None, 8, 0, 16, 2, "standard",
                               rays=rays, collect=True, integ="whitted")


def test_renderer_draws_split_screen(tmp_path):
    """Renderer.draw with the 4-way split on the CPU: the film accumulates,
    each quadrant holds its own integrator's image, and a PNG is written."""
    cfg = FilmConfig(24, 16)
    ts, tc = tbuiltin.cornell_box(aspect=cfg.aspect, device="cpu")
    st = RenderSettings(max_bounces=2, style="standard", **SPLIT)
    r = Renderer(ts, tc, st, cfg)
    first = r.draw().clone()
    # The first frame after a reset is the sample itself: its bottom-left
    # quadrant is the all-Hart frame's.
    hart = trender.render_sample_fast_chw(
        ts, tc, st.replace(**dict.fromkeys(SPLIT, 10)), cfg, 0)
    assert torch.equal(first[:, 9:, :12], hart[:, 9:, :12])
    assert not torch.equal(first[:, :9, 12:], hart[:, :9, 12:])
    for _ in range(2):
        img = r.draw()
    assert r.film.frame == 3 and torch.isfinite(img).all()
    path = tmp_path / "split.png"
    r.save_image(str(path))
    assert path.stat().st_size > 0
