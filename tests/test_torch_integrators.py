"""The port's integrators and K1's Whitted/Cook forms against rvpt_tpu.

Every integrator of ``rvpt_tpu_torch.models.integrators`` against JAX
``eval_integrator`` on the same camera rays (made in JAX from seeded numpy
jitter and handed to both as numpy arrays), and ``trace_plain`` with
``integ="whitted"|"cook"`` (the plain version of K1's forms) against the
JAX kernel ``PathTracer.trace(..., integ=...)`` in Pallas interpret mode,
as tests/test_megakernel.py:330 and :358 run it.  Films are 24x16 (Cook at
10 bounces: 16x8).  Bars (tests/test_megakernel.py): >= 99.5% of pixel
channels within rtol/atol 1e-4, Hart >= 99%; the two sides round
differently (fused vs unfused multiply-adds), which can flip a rare
discrete hit or material decision.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvpt_tpu import RenderSettings as JRenderSettings
from rvpt_tpu.core.types import Ray as JRay
from rvpt_tpu.models import camera as jcam
from rvpt_tpu.models.integrators import eval_integrator as j_eval_integrator
from rvpt_tpu.ops.pathkernel import PathTracer as JPathTracer
from rvpt_tpu.scene import builtin as jbuiltin
from rvpt_tpu_torch import RenderSettings
from rvpt_tpu_torch.core.types import Ray
from rvpt_tpu_torch.models.integrators import INTEGRATOR_NAMES, eval_integrator
from rvpt_tpu_torch.ops import pathkernel as tpk
from rvpt_tpu_torch.scene import builtin as tbuiltin

SCENES = ("cornell_box", "sphere_plane")
NEW_MODES = tuple(name for name in INTEGRATOR_NAMES if name != "kajiya")
FRAME, SALT, BOUNCES = 2, 16, 3


def _share(got, want):
    return np.isclose(got, want, rtol=1e-4, atol=1e-4).mean()


def _case(scene_name, width, height, seed):
    """(JAX scene, port scene, pixel ids u32, origins, directions): camera
    rays through seeded numpy jitter, made once in JAX."""
    js, jc = getattr(jbuiltin, scene_name)(aspect=width / height)
    ts, _ = getattr(tbuiltin, scene_name)(aspect=width / height, device="cpu")
    r = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:height, 0:width]
    n = width * height
    cx = ((xs.ravel() + r.random(n)) / width).astype(np.float32)
    cy = (1.0 - (ys.ravel() + r.random(n)) / height).astype(np.float32)
    ray = jcam.generate_rays(jc, jnp.asarray(cx), jnp.asarray(cy))
    return (js, ts, np.arange(n, dtype=np.uint32), np.array(ray.origin),
            np.array(ray.direction))


def _port_ray(o, d):
    return Ray(torch.from_numpy(o.copy()), torch.from_numpy(d.copy()))


@pytest.fixture(scope="module")
def cases():
    return {name: _case(name, 24, 16, seed=11 + k)
            for k, name in enumerate(SCENES)}


@pytest.fixture(scope="module")
def jax_integrators(cases):
    """JAX eval_integrator of every new mode on both scenes, once."""
    out = {}
    for scene_name, (js, _, pixel, o, d) in cases.items():
        ray = JRay(jnp.asarray(o), jnp.asarray(d))
        for name in NEW_MODES:
            out[scene_name, name] = np.asarray(j_eval_integrator(
                INTEGRATOR_NAMES[name], js, ray, jnp.asarray(pixel),
                jnp.uint32(FRAME), JRenderSettings(max_bounces=BOUNCES),
                jnp.uint32(SALT)))
    return out


@pytest.mark.parametrize("scene_name", SCENES)
@pytest.mark.parametrize("name", NEW_MODES)
def test_integrator_matches_jax(cases, jax_integrators, scene_name, name):
    _, ts, pixel, o, d = cases[scene_name]
    got = eval_integrator(INTEGRATOR_NAMES[name], ts, _port_ray(o, d),
                          torch.from_numpy(pixel.astype(np.int64)), FRAME,
                          RenderSettings(max_bounces=BOUNCES), SALT).numpy()
    want = jax_integrators[scene_name, name]
    assert got.shape == want.shape == (pixel.shape[0], 3)
    assert np.isfinite(got).all()
    share = _share(got, want)
    bar = 0.99 if name == "hart" else 0.995
    assert share >= bar, f"{name}: only {share:.4%} of channels match"


def test_unknown_mode_falls_back_to_hart(cases):
    """Ids outside the table take Hart, like the reference's default case."""
    _, ts, pixel, o, d = cases["cornell_box"]
    args = (ts, _port_ray(o, d), torch.from_numpy(pixel.astype(np.int64)),
            FRAME, RenderSettings(max_bounces=1), SALT)
    assert torch.equal(eval_integrator(42, *args), eval_integrator(10, *args))


@pytest.fixture(scope="module")
def jax_bounce_kernels(cases):
    """JAX K1 with integ whitted/cook (interpret mode) at 3 bounces."""
    out = {}
    for scene_name, (js, _, pixel, o, d) in cases.items():
        pt = JPathTracer(js)
        for integ in ("whitted", "cook"):
            rgb = pt.trace(jnp.asarray(pixel), jnp.asarray(o), jnp.asarray(d),
                           jnp.uint32(FRAME), salt_base=SALT,
                           max_bounces=BOUNCES, interpret=True, integ=integ)
            out[scene_name, integ] = np.stack([np.asarray(c) for c in rgb])
    return out


@pytest.mark.parametrize("integ", ["whitted", "cook"])
@pytest.mark.parametrize("scene_name", SCENES)
def test_trace_plain_integ_matches_jax_kernel(cases, jax_bounce_kernels,
                                              scene_name, integ):
    _, ts, pixel, o, d = cases[scene_name]
    got = tpk.PathTracer(ts).trace(
        torch.from_numpy(pixel.astype(np.int64)), torch.from_numpy(o.copy()),
        torch.from_numpy(d.copy()), FRAME, SALT, BOUNCES, integ=integ)
    got = torch.stack(got).numpy()
    want = jax_bounce_kernels[scene_name, integ]
    share = _share(got, want)
    assert share >= 0.995, f"{integ}: only {share:.4%} of channels match"


@pytest.mark.parametrize("style", ["reference", "standard"])
def test_cook_ten_bounces_matches_jax_integrator(style):
    """Cook's flag and its tail search over 10 bounces, past the JAX
    kernel's 8-bounce group split (tests/test_megakernel.py:358)."""
    js, ts, pixel, o, d = _case("cornell_box", 16, 8, seed=5)
    want = np.asarray(j_eval_integrator(
        8, js, JRay(jnp.asarray(o), jnp.asarray(d)), jnp.asarray(pixel),
        jnp.uint32(1), JRenderSettings(max_bounces=10, style=style),
        jnp.uint32(SALT)))
    got = tpk.trace_plain(*tpk.pack_fwd(ts), torch.from_numpy(pixel.astype(np.int64)),
                          1, SALT, 10, style,
                          rays=tuple(torch.from_numpy(np.ascontiguousarray(c))
                                     for c in (*o.T, *d.T)),
                          integ="cook")
    share = _share(got.numpy().T, want)
    assert share >= 0.995, f"only {share:.4%} of channels match"


def test_trace_plain_counts_its_searches(cases):
    """The ``work`` counts: Kajiya's searches are the records' active
    lanes, of which the hits scatter and the misses end; every lane a
    bounce search sees scatters, ends, or (Whitted) takes the Lambert
    branch with its own shadow search; Cook's tail search ends its lanes."""
    _, ts, pixel, o, d = cases["cornell_box"]
    tables, counts = tpk.pack_fwd(ts)
    n = pixel.shape[0]
    args = (tables, counts, torch.from_numpy(pixel.astype(np.int64)), FRAME,
            SALT, BOUNCES, "standard")
    rays = tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in (*o.T, *d.T))
    work = {}
    _, rec = tpk.trace_plain(*args, rays=rays, collect=True, work=work)
    live = rec.fields[:, 12] > 0
    hit = rec.hits[:, 0] >= 0
    assert work == {"search": int(live.sum()), "scatter": int((live & hit).sum()),
                    "end": int((live & ~hit).sum())}
    for integ in ("whitted", "cook"):
        work = {}
        tpk.trace_plain(*args, rays=rays, integ=integ, work=work)
        assert 0 < work["end"] <= n and work["scatter"] > 0
        if integ == "whitted":
            assert work["lambert"] > 0
            assert work["search"] == (work["end"] + work["scatter"]
                                      + 2 * work["lambert"])
        else:
            assert "lambert" not in work
            assert work["search"] == work["end"] + work["scatter"]
