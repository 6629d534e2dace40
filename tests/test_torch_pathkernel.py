"""The whole-path tracer of rvpt_tpu_torch against the JAX kernel K1.

On the CPU the port's PathTracer runs its plain PyTorch version; the JAX
side runs the Pallas kernel in interpret mode, as tests/test_megakernel.py
and tests/test_bench_smoke.py run it.  Bar (tests/test_megakernel.py): at 3
bounces >= 99.5% of pixel channels within 1e-4; the two sides round
differently (fused vs unfused multiply-adds), which flips a rare discrete
hit or material decision.  tests/test_torch_cuda.py holds the CUDA kernel
against this plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvpt_tpu import FilmConfig as JFilmConfig
from rvpt_tpu import RenderSettings as JRenderSettings
from rvpt_tpu.ops.pathkernel import PathTracer as JPathTracer
from rvpt_tpu.scene import builtin as jbuiltin
from rvpt_tpu_torch import FilmConfig, RenderSettings
from rvpt_tpu_torch.models import camera as tcam
from rvpt_tpu_torch.ops import pathkernel as tpk
from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays, render_sample_fast_chw
from rvpt_tpu_torch.scene import builtin as tbuiltin

MAKERS = {"cornell": "cornell_box", "sphere_plane": "sphere_plane"}


def _close_share(got, want):
    return np.isclose(got, want, rtol=1e-4, atol=1e-4).mean()


@pytest.mark.parametrize("style", ["reference", "standard"])
@pytest.mark.parametrize("scene_name", ["cornell", "sphere_plane"])
def test_plain_trace_matches_jax_kernel(scene_name, style):
    """Rays passed in (gen_rays=False): both sides get identical rays."""
    cfg = FilmConfig(width=24, height=16)
    ts, tc = getattr(tbuiltin, MAKERS[scene_name])(aspect=cfg.aspect, device="cpu")
    js, _ = getattr(jbuiltin, MAKERS[scene_name])(aspect=cfg.aspect)
    pixel, xs, ys = _pixel_grid(cfg, "cpu")
    ray = jittered_camera_rays(tc, cfg, pixel, xs, ys, 0, 0)
    o, d = ray.origin.numpy(), ray.direction.numpy()

    got = tpk.PathTracer(ts).trace(
        pixel, ray.origin, ray.direction, 3, salt_base=16, max_bounces=3,
        style=style)
    want = JPathTracer(js).trace(
        jnp.asarray(pixel.numpy().astype(np.uint32)), jnp.asarray(o),
        jnp.asarray(d), jnp.uint32(3), salt_base=16, max_bounces=3,
        style=style, interpret=True)
    got = np.stack([g.numpy() for g in got])
    want = np.stack([np.asarray(w) for w in want])
    assert np.isfinite(got).all()
    share = _close_share(got, want)
    assert share >= 0.995, f"only {share:.4%} of pixel channels match"


@pytest.mark.parametrize("mode", [tcam.PINHOLE, tcam.ORTHO, tcam.SPHERICAL])
def test_plain_gen_rays_matches_jax_fast_chw(mode, monkeypatch):
    """Camera rays made inside the trace: the port's render_sample_fast_chw
    (plain version on the CPU) against the JAX one with the Pallas kernel
    forced (interpret mode), 32x16, 3 bounces, AA 1."""
    import dataclasses

    from rvpt_tpu.ops import intersect as jint
    from rvpt_tpu.render import render_sample_fast_chw as j_fast

    monkeypatch.setattr(jint, "_BACKEND", "pallas")
    cfg = FilmConfig(width=32, height=16)
    st = RenderSettings(max_bounces=3, style="standard")
    ts, tc = tbuiltin.cornell_box(aspect=cfg.aspect, device="cpu")
    js, jc = jbuiltin.cornell_box(aspect=cfg.aspect)
    tc = dataclasses.replace(tc, mode=mode)
    jc = dataclasses.replace(jc, mode=mode)
    got = render_sample_fast_chw(ts, tc, st, cfg, 5).numpy()
    want = np.asarray(j_fast(js, jc, JRenderSettings(max_bounces=3, style="standard"),
                             JFilmConfig(width=32, height=16), 5))
    assert got.shape == want.shape == (3, 16, 32)
    share = _close_share(got, want)
    assert share >= 0.995, f"only {share:.4%} of pixel channels match"


def test_pack_fwd_rows():
    ts, _ = tbuiltin.cornell_box(device="cpu")
    tables, counts = tpk.pack_fwd(ts)
    assert counts == (12, 2, 0, 6)
    assert tables.shape == (12 * 17 + 2 * 5 + 6 * 8,)
    tri = tables[:12 * 17].reshape(12, 17)
    assert torch.equal(tri[:, 16], ts.tri_mat.float())
    mat = tables[12 * 17 + 10:].reshape(6, 8)
    assert torch.equal(mat[:, 6], ts.materials.ior)


def test_cpu_tensors_take_the_plain_version():
    """A CPU scene never reaches the CUDA library; the launcher refuses CPU
    tensors instead of falling back."""
    cfg = FilmConfig(width=8, height=4)
    ts, tc = tbuiltin.cornell_box(aspect=cfg.aspect, device="cpu")
    before = tpk.launch_path_kernel.launches
    img = render_sample_fast_chw(ts, tc, RenderSettings(max_bounces=2), cfg, 0)
    assert img.shape == (3, 4, 8) and torch.isfinite(img).all()
    assert tpk.launch_path_kernel.launches == before
    tables, counts = tpk.pack_fwd(ts)
    with pytest.raises(ValueError, match="CUDA"):
        tpk.launch_path_kernel(tables, counts, None, 32, 0, 16, 2, "standard",
                               cam_params=tpk.camera_params(tc, cfg))
