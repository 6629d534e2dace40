"""K1's ``stats`` form in rvpt_tpu_torch against the JAX package, on the
CPU: ``pack_cull``'s bounds, the culled walk's per-tile counters of
``PathTracer.trace(stats=True)`` (the plain version, ``cull_stats_plain``
through trace_plain's ``on_search`` hook) against the JAX culled kernel's
in interpret mode, and ``PathTracer`` on a BVH scene of any size.

Rays: the JAX package's jittered camera rays (frame 3) passed to both,
salt 16, films of one or two whole 8,192-ray tiles (JAX counts the lanes
that pad a last partial tile; the port counts real lanes only).  Bars:
bounds equal bit for bit; at 1 bounce every counter equal per tile; at 3
bounces (Kajiya, Whitted, Cook) each counter within 2% of JAX's per tile,
processed == listed and still <= listed; the radiance >= 99.5% of channels
within 1e-4 (tests/test_megakernel.py).  tests/test_torch_cuda.py holds
the counting CUDA instance against this plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvpt_tpu import FilmConfig as JFilmConfig
from rvpt_tpu.ops import pathkernel as jpk
from rvpt_tpu.render import _pixel_grid as j_grid
from rvpt_tpu.render import jittered_camera_rays as j_rays
from rvpt_tpu.scene import builtin as jbuiltin
from rvpt_tpu_torch.ops import pathkernel as tpk
from rvpt_tpu_torch.render import make_tracer
from rvpt_tpu_torch.scene import builtin as tbuiltin

FRAME, SALT = 3, 16
ONE_BOUNCE = [(1, 64), (1, 128), (3, 64), (3, 128)]


def _share(got, want):
    return np.isclose(got, want, rtol=1e-4, atol=1e-4).mean()


def _rays(w, h, js_cam):
    """The JAX jittered camera rays of a w x h film, for both packages."""
    cfg = JFilmConfig(w, h)
    pixel, xs, ys = j_grid(cfg)
    ray = j_rays(js_cam, cfg, pixel, xs, ys, jnp.uint32(FRAME), 0)
    port = (torch.from_numpy(np.asarray(pixel).astype(np.int64)),
            torch.from_numpy(np.array(ray.origin)),
            torch.from_numpy(np.array(ray.direction)))
    return (pixel, ray), port


def _jax_trace(subdiv, h, nb, integ):
    js, jcam = jbuiltin.mesh_demo(subdiv=subdiv, aspect=128 / h)
    (pixel, ray), _ = _rays(128, h, jcam)
    rgb, agg = jpk.PathTracer(js).trace(
        pixel, ray.origin, ray.direction, jnp.uint32(FRAME), SALT, nb,
        interpret=True, stats=True, integ=integ)
    return (np.stack([np.asarray(c) for c in rgb]),
            np.stack([np.asarray(a) for a in agg]))


def _port_trace(subdiv, h, nb, integ):
    ts, _ = tbuiltin.mesh_demo(subdiv=subdiv, aspect=128 / h, device="cpu")
    jcam = jbuiltin.mesh_demo(subdiv=subdiv, aspect=128 / h)[1]
    _, (pix, o, d) = _rays(128, h, jcam)
    rgb, agg = tpk.PathTracer(ts).trace(pix, o, d, FRAME, SALT, nb,
                                        stats=True, integ=integ)
    return torch.stack(rgb).numpy(), torch.stack(agg).numpy()


@pytest.fixture(scope="module")
def jax_stats():
    """The JAX culled kernel's radiance and counters, once per module."""
    out = {("kajiya", 1, s, h): _jax_trace(s, h, 1, "kajiya") for s, h in ONE_BOUNCE}
    for integ in ("kajiya", "whitted", "cook"):
        out[integ, 3, 3, 128] = _jax_trace(3, 128, 3, integ)
    return out


@pytest.mark.parametrize("name,kw", [("mesh_demo", dict(subdiv=1)),
                                     ("mesh_demo", dict(subdiv=3)),
                                     ("rabbit", {})])
def test_pack_cull_matches_jax(name, kw):
    js, _ = getattr(jbuiltin, name)(**kw)
    ts, _ = getattr(tbuiltin, name)(device="cpu", **kw)
    tabs, meta = jpk.pack_cull(js)
    cb = tpk.pack_cull(ts)
    assert (cb.n_clu, cb.n_sup) == (meta["n_clu"], meta["n_sup"])
    for k in range(6):
        assert np.array_equal(cb.sup[:, k].numpy(), np.asarray(tabs[17 + k]))
        assert np.array_equal(cb.clu[:, k].numpy(), np.asarray(tabs[23 + k]))
    rows = tpk.cull_rows(cb)
    assert rows.shape == (cb.n_clu + 1, 8)
    assert torch.equal(rows[0, :3], cb.clu[:, :3].amin(0))
    assert torch.equal(rows[0, 3:6], cb.clu[:, 3:].amax(0))


@pytest.mark.parametrize("subdiv,h", ONE_BOUNCE)
def test_stats_one_bounce_equal_jax(jax_stats, subdiv, h):
    want_rgb, want = jax_stats["kajiya", 1, subdiv, h]
    got_rgb, got = _port_trace(subdiv, h, 1, "kajiya")
    assert got.shape == want.shape == (3, 128 * h // tpk.CULL_TILE)
    np.testing.assert_array_equal(got, want)
    assert _share(got_rgb, want_rgb) >= 0.995


@pytest.mark.parametrize("integ", ["kajiya", "whitted", "cook"])
def test_stats_three_bounces_match_jax(jax_stats, integ):
    want_rgb, want = jax_stats[integ, 3, 3, 128]
    got_rgb, got = _port_trace(3, 128, 3, integ)
    assert got.shape == want.shape == (3, 2)
    np.testing.assert_allclose(got, want, rtol=0.02)
    assert np.array_equal(got[1], got[0]) and (got[2] <= got[0]).all()
    assert (got[0] > 0).all()
    assert _share(got_rgb, want_rgb) >= 0.995


def test_stats_zeros_off_the_culled_form():
    """A scene JAX does not cull (no BVH) returns zero counters of shape
    [ceil(N / CULL_TILE)], the radiance unchanged; with records, the triple
    (radiance, record, counters)."""
    ts, cam = tbuiltin.cornell_box(aspect=1.5, device="cpu")
    pt = tpk.PathTracer(ts)
    assert pt.cull is None
    n = 24 * 16
    o = cam.translation.expand(n, 3).contiguous()
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=torch.Generator().manual_seed(0)), dim=1)
    rgb, agg = pt.trace(n, o, d, FRAME, SALT, 2, stats=True)
    assert len(agg) == 3 and all(a.shape == (1,) and (a == 0).all() for a in agg)
    want = pt.trace(n, o, d, FRAME, SALT, 2)
    assert all(torch.equal(a, b) for a, b in zip(rgb, want))
    rgb2, rec, agg2 = pt.trace(n, o, d, FRAME, SALT, 2, stats=True,
                               collect_states=True)
    assert rec.hits.shape == (2, 2, n) and agg2[0].shape == (1,)


def test_stats_with_records_on_a_culled_scene():
    ts, _ = tbuiltin.mesh_demo(subdiv=1, aspect=2.0, device="cpu")
    jcam = jbuiltin.mesh_demo(subdiv=1, aspect=2.0)[1]
    _, (pix, o, d) = _rays(128, 64, jcam)
    pt = tpk.PathTracer(ts)
    rgb, agg = pt.trace(pix, o, d, FRAME, SALT, 2, stats=True)
    rgb2, rec, agg2 = pt.trace(pix, o, d, FRAME, SALT, 2, stats=True,
                               collect_states=True)
    assert all(torch.equal(a, b) for a, b in zip(rgb, rgb2))
    assert all(torch.equal(a, b) for a, b in zip(agg, agg2))
    assert rec.fields.shape == (2, len(tpk.RECORD_FIELDS), 128 * 64)


def test_stats_kernel_needs_the_card():
    ts, _ = tbuiltin.mesh_demo(subdiv=1, device="cpu")
    pt = tpk.PathTracer(ts)
    with pytest.raises(ValueError, match="CUDA"):
        tpk.launch_path_stats(pt.tables, pt.counts, pt.tree, pt.cull, None, 8,
                              0, 0, 1, "reference",
                              rays=tuple(torch.zeros(8) for _ in range(6)))


def test_pathtracer_takes_any_bvh_scene():
    """PathTracer(mesh_demo(3)) traces on K1's BVH form and matches the
    JAX PathTracer (its culled form) by the bar of
    tests/test_megakernel.py:84; make_tracer still sends the big mesh to
    BigMeshTracer.  Past CULL_MAX_TRIS the BVH form still traces (JAX's
    tracer takes its row form there), with zero counters."""
    js, jcam = jbuiltin.mesh_demo(subdiv=3, aspect=1.5)
    ts, _ = tbuiltin.mesh_demo(subdiv=3, aspect=1.5, device="cpu")
    cfg = JFilmConfig(24, 16)
    pixel, xs, ys = j_grid(cfg)
    ray = j_rays(jcam, cfg, pixel, xs, ys, jnp.uint32(FRAME), 0)
    want = np.stack([np.asarray(c) for c in jpk.PathTracer(js).trace(
        pixel, ray.origin, ray.direction, jnp.uint32(FRAME), SALT, 3,
        interpret=True)])
    assert tpk.is_bigmesh(ts) and isinstance(make_tracer(ts), tpk.BigMeshTracer)
    pt = tpk.PathTracer(ts)
    assert pt.bvh_form and pt.cull is not None
    got = torch.stack(pt.trace(
        torch.from_numpy(np.asarray(pixel).astype(np.int64)),
        torch.from_numpy(np.array(ray.origin)),
        torch.from_numpy(np.array(ray.direction)), FRAME, SALT, 3)).numpy()
    assert _share(got, want) >= 0.995

    big, _ = tbuiltin.mesh_demo(subdiv=5, aspect=1.5, device="cpu")
    assert big.num_triangles > tpk.CULL_MAX_TRIS and not tpk.is_culled(big)
    o = torch.from_numpy(np.array(ray.origin))
    d = torch.from_numpy(np.array(ray.direction))
    pix = torch.from_numpy(np.asarray(pixel).astype(np.int64))
    rgb, agg = tpk.PathTracer(big).trace(pix, o, d, FRAME, SALT, 2, stats=True)
    ref = tpk.BigMeshTracer(big).trace(pix, o, d, FRAME, SALT, 2)
    assert torch.equal(torch.stack(rgb), ref)
    assert all((a == 0).all() for a in agg)
