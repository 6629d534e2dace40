"""The plain versions of the primary-hit kernel (B3) and the Hart march
kernel (B4) against the JAX kernels.

On the CPU the port's ``PathTracer.trace_primary`` / ``trace_hart`` run
``primary_plain`` / ``hart_plain``; the JAX side runs the Pallas kernels
in interpret mode, as tests/test_megakernel.py:271 and :381 do, once per
module.  Camera rays are made inside both traces from each package's own
camera vector; the frame numbers come from a seeded numpy generator.
Films are 24x16.  Bars (tests/test_megakernel.py): B3 >= 99.5% of pixel
channels within rtol/atol 1e-4, B4 >= 99%.  tests/test_torch_cuda.py holds
the CUDA kernels against these plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvpt_tpu import FilmConfig as JFilmConfig
from rvpt_tpu.ops import pathkernel as jpk
from rvpt_tpu.render import _pixel_grid as j_pixel_grid
from rvpt_tpu.scene import builtin as jbuiltin
from rvpt_tpu_torch import FilmConfig, RenderSettings
from rvpt_tpu_torch.core.types import Ray
from rvpt_tpu_torch.models.integrators import INTEGRATOR_NAMES, eval_integrator
from rvpt_tpu_torch.ops import pathkernel as tpk
from rvpt_tpu_torch.scene import builtin as tbuiltin

SCENES = ("cornell_box", "sphere_plane")
PRIMARY = ("binary", "color", "depth", "normal", "utah", "ao", "appel")
W, H = 24, 16
SALT, NRAYS = 16, 3
FRAMES = dict(zip(("primary", "hart"),
                  (int(f) for f in np.random.default_rng(3).integers(0, 1000, 2))))


def _share(got, want):
    return np.isclose(got, want, rtol=1e-4, atol=1e-4).mean()


def _scenes(scene_name):
    js, jc = getattr(jbuiltin, scene_name)(aspect=W / H)
    ts, tc = getattr(tbuiltin, scene_name)(aspect=W / H, device="cpu")
    return (js, jpk.camera_params(jc, JFilmConfig(W, H)), jc.mode,
            tpk.PathTracer(ts), tpk.camera_params(tc, FilmConfig(W, H)), tc.mode)


@pytest.fixture(scope="module")
def jax_kernels():
    """JAX B3 (modes 0-6, nrays 3, Cornell) and B4 (both scenes) in
    interpret mode, once."""
    pixel, _, _ = j_pixel_grid(JFilmConfig(W, H))
    out = {}
    js, jcp, jmode, *_ = _scenes("cornell_box")
    pt = jpk.PathTracer(js)
    for name in PRIMARY:
        rgb = pt.trace_primary(pixel, jnp.uint32(FRAMES["primary"]),
                               INTEGRATOR_NAMES[name], cam_params=jcp,
                               cam_mode=jmode, salt_base=SALT, jitter_salt=0,
                               nrays=NRAYS, interpret=True)
        out[name] = np.stack([np.asarray(c) for c in rgb])
    for scene_name in SCENES:
        js, jcp, jmode, *_ = _scenes(scene_name)
        rgb = jpk.trace_hart(js, pixel, jnp.uint32(FRAMES["hart"]),
                             cam_params=jcp, cam_mode=jmode, jitter_salt=0,
                             interpret=True)
        out["hart", scene_name] = np.stack([np.asarray(c) for c in rgb])
    return out


@pytest.mark.parametrize("name", PRIMARY)
def test_primary_plain_matches_jax_kernel(jax_kernels, name):
    *_, pt, cp, mode = _scenes("cornell_box")
    got = pt.trace_primary(
        W * H, FRAMES["primary"], INTEGRATOR_NAMES[name], cam_params=cp,
        cam_mode=mode, salt_base=SALT, jitter_salt=0, nrays=NRAYS).numpy()
    want = jax_kernels[name]
    assert got.shape == want.shape == (3, W * H)
    share = _share(got, want)
    assert share >= 0.995, f"{name}: only {share:.4%} of channels match"


@pytest.mark.parametrize("scene_name", SCENES)
def test_hart_plain_matches_jax_kernel(jax_kernels, scene_name):
    *_, pt, cp, mode = _scenes(scene_name)
    got = pt.trace_hart(torch.arange(W * H), FRAMES["hart"], cam_params=cp,
                        cam_mode=mode, jitter_salt=0).numpy()
    share = _share(got, jax_kernels["hart", scene_name])
    assert share >= 0.99, f"only {share:.4%} of channels match"


def test_hart_without_triangles_is_constant():
    """sphere_plane has no triangles: the march never stops, so both routes
    give 32/31 everywhere (golden sphere_plane_hart.png)."""
    ts, tc = tbuiltin.sphere_plane(aspect=W / H, device="cpu")
    assert ts.num_triangles == 0
    pt = tpk.PathTracer(ts)
    assert pt.hart_tables.shape == (0,) and pt.hart_count == 0
    cp = tpk.camera_params(tc, FilmConfig(W, H))
    kernel_plain = pt.trace_hart(W * H, 0, cam_params=cp, cam_mode=tc.mode,
                                 jitter_salt=0)
    d = np.random.default_rng(0).normal(size=(W * H, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    integ = eval_integrator(10, ts, Ray(torch.zeros((W * H, 3)), torch.from_numpy(d)),
                            torch.arange(W * H), 0, RenderSettings(max_bounces=1))
    want = np.float32(32) / np.float32(31)
    assert (kernel_plain == torch.tensor(want)).all()
    assert (integ == torch.tensor(want)).all()


def test_pack_hart_rows():
    ts, _ = tbuiltin.cornell_box(device="cpu")
    rows, count = tpk.pack_hart(ts)
    assert count == 12 and rows.shape == (12 * 9,)
    v = rows.reshape(12, 9)
    assert torch.equal(v[:, 0:3], ts.tri_v0) and torch.equal(v[:, 6:9], ts.tri_v2)


def test_primary_and_hart_launchers_refuse_cpu_tensors():
    """A CPU scene never reaches a CUDA library: the launchers raise
    instead of falling back."""
    ts, tc = tbuiltin.cornell_box(aspect=W / H, device="cpu")
    pt = tpk.PathTracer(ts)
    cp = tpk.camera_params(tc, FilmConfig(W, H))
    before = (tpk.launch_primary_kernel.launches, tpk.launch_hart_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tpk.launch_primary_kernel(pt.tables, pt.counts, None, W * H, 0, SALT,
                                  3, 1, cp)
    with pytest.raises(ValueError, match="CUDA"):
        tpk.launch_hart_kernel(pt.hart_tables, pt.hart_count, None, W * H, 0, cp)
    with pytest.raises(ValueError, match="primary-hit mode"):
        pt.trace_primary(W * H, 0, 7, cam_params=cp, cam_mode=tc.mode,
                         salt_base=SALT, jitter_salt=0)
    assert (tpk.launch_primary_kernel.launches,
            tpk.launch_hart_kernel.launches) == before
