"""The shell of rvpt_tpu_torch against the JAX package, on the CPU: the
vector math and sample mappings, the camera moves, the utilities
(checkpoints in the shared file format, hot reload, metrics, profiling,
debug switches, debug overlays) and the Renderer (mirrors of
tests/test_math.py, test_sampling.py, test_utils.py, test_metrics.py and
test_renderer.py).

Bars: elementwise functions within rtol 1e-5, atol 1e-6 of the JAX ones on
the same seeded inputs (float32; the cube root rounds differently); debug
overlays pixel for pixel; a film saved by either package's Renderer
resumes in the other's with the same accumulation and frame count.
"""

import dataclasses
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvpt_tpu import FilmConfig as JFilmConfig
from rvpt_tpu import RenderSettings as JRenderSettings
from rvpt_tpu.core import math as jmath
from rvpt_tpu.core import sampling as jsamp
from rvpt_tpu.models import camera as jcam
from rvpt_tpu.render import render_sample as j_render_sample
from rvpt_tpu.renderer import Renderer as JRenderer
from rvpt_tpu.scene import builtin as jbuiltin
from rvpt_tpu.scene.bvh import build_bvh as j_build_bvh
from rvpt_tpu.scene.bvh import triangle_bounds as j_triangle_bounds
from rvpt_tpu.utils import debug_draw as jdraw
from rvpt_tpu_torch import FilmConfig, RenderSettings
from rvpt_tpu_torch.core import math as tmath
from rvpt_tpu_torch.core import sampling as tsamp
from rvpt_tpu_torch.models import camera as tcam
from rvpt_tpu_torch.ops import build
from rvpt_tpu_torch.ops import pathkernel as tpk
from rvpt_tpu_torch.render import render_sample
from rvpt_tpu_torch.renderer import Renderer
from rvpt_tpu_torch.scene import builtin as tbuiltin
from rvpt_tpu_torch.scene.bvh import build_bvh, triangle_bounds
from rvpt_tpu_torch.utils import checkpoint as tckpt
from rvpt_tpu_torch.utils import debug, debug_draw, metrics, profiling
from rvpt_tpu_torch.utils.hot_reload import SourceWatcher

N = 4096


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _unit(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _uniform(k, seed):
    r = np.random.default_rng(seed)
    return [r.uniform(size=N).astype(np.float32) for _ in range(k)]


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays])


# ---------------------------------------------------------------- math


@pytest.mark.parametrize("name", ["reflect", "refract", "spherical_to_cartesian",
                                  "orthonormal_basis", "hemisphere_around_normal"])
def test_math_matches_jax(name):
    d = _unit(N, 0)
    n = _unit(N, 1)
    n = np.where((np.sum(d * n, -1) > 0)[:, None], -n, n).astype(np.float32)
    u = _uniform(3, 2)
    args = {
        "reflect": (d, n),
        # Glass-like index ratios 1/1.5..1/1.1: at eta near 1 a grazing
        # ray's cos_b = sqrt(~0) amplifies the last-bit differences that
        # XLA's fused multiply-adds make on some hosts.
        "refract": (d, n, np.float32(1.0) / (1.1 + 0.4 * u[0])),
        "spherical_to_cartesian": (1.0 + u[0], 6.28 * u[1], 3.14 * u[2]),
        "orthonormal_basis": (n,),
        "hemisphere_around_normal": (6.28 * u[0], u[1], np.sqrt(1 - u[1] ** 2), n),
    }[name]
    jargs, targs = _both(*(np.asarray(a, np.float32) for a in args))
    want = getattr(jmath, name)(*jargs)
    got = getattr(tmath, name)(*targs)
    if name == "orthonormal_basis":
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


def test_refract_tir_and_snell():
    n = torch.tensor([[0.0, 1.0, 0.0]])
    tir = tmath.refract(torch.tensor([[0.99, -0.14106736, 0.0]]), n, torch.tensor([1.5]))
    assert torch.equal(tir, torch.zeros_like(tir))
    s = np.sin(np.pi / 4)
    r = tmath.refract(torch.tensor([[s, -s, 0.0]]), n, torch.tensor([1.0 / 1.5]))[0]
    assert abs(float(r[0] / r.norm()) - s / 1.5) < 1e-6


# ---------------------------------------------------------------- sampling


@pytest.mark.parametrize("name", ["map_uniform_sphere", "map_uniform_hemisphere_simple",
                                  "map_uniform_hemisphere", "map_cosine_hemisphere_simple",
                                  "map_cosine_hemisphere", "map_uniform_ball"])
def test_sampling_matches_jax(name):
    u = _uniform(3, 3)
    n = _unit(N, 4)
    args = {"map_uniform_sphere": u[:2], "map_uniform_ball": u}.get(name, [u[0], u[1], n])
    jargs, targs = _both(*args)
    _close(getattr(tsamp, name)(*targs), getattr(jsamp, name)(*jargs))


def test_cosine_hemisphere_moments():
    u, v = (torch.from_numpy(a) for a in _uniform(2, 5))
    nrm = torch.tensor([0.6, -0.64, 0.48]).expand(N, 3)
    cos = tmath.vdot(tsamp.map_cosine_hemisphere(u, v, nrm), nrm)
    assert cos.min() >= -1e-5 and abs(cos.mean().item() - 2.0 / 3.0) < 0.02


# ---------------------------------------------------------------- camera


@pytest.mark.parametrize("clamp", [False, True])
def test_camera_translate_rotate_match_jax(clamp):
    jc = jcam.Camera.create(translation=(0.5, 1.0, -3.0), rotation=(30.0, 80.0, 10.0))
    tc = tcam.Camera.create(translation=(0.5, 1.0, -3.0), rotation=(30.0, 80.0, 10.0),
                            device="cpu")
    jc, tc = jcam.translate(jc, (0.3, -0.2, 1.5)), tcam.translate(tc, (0.3, -0.2, 1.5))
    _close(tc.translation, jc.translation)
    jc = jcam.rotate(jc, (5.0, 20.0, -3.0), clamp_vertical=clamp)
    tc = tcam.rotate(tc, (5.0, 20.0, -3.0), clamp_vertical=clamp)
    _close(tc.rotation, jc.rotation)
    assert (float(tc.rotation[1]) == 90.0) == clamp


# ---------------------------------------------------------------- utils


def test_checkpoint_tree_roundtrip(tmp_path):
    @dataclasses.dataclass(frozen=True)
    class Node:
        a: torch.Tensor
        n: int
        tag: str = dataclasses.field(default="x", metadata=tckpt.STATIC)
        skip: object = None

    tree = {"nested": {"b": torch.tensor([1, 2, 3], dtype=torch.int32)},
            "node": Node(torch.arange(6.0).reshape(2, 3), 7)}
    p = str(tmp_path / "t.npz")
    tckpt.save(p, tree, meta={"note": "hi"})
    with np.load(p) as data:
        assert sorted(k for k in data if k != "__meta__") == [
            "['nested']/['b']", "['node']/.a", "['node']/.n"]
    like = {"nested": {"b": torch.zeros(3, dtype=torch.int32)},
            "node": Node(torch.zeros(2, 3), 0, tag="kept")}
    out, meta = tckpt.load(p, like)
    assert meta == {"note": "hi"}
    assert torch.equal(out["node"].a, tree["node"].a) and out["node"].n == 7
    assert out["node"].tag == "kept" and out["nested"]["b"].dtype == torch.int32
    with pytest.raises(KeyError, match="missing leaf"):
        tckpt.load(p, {**like, "c": torch.zeros(1)})


def test_checkpoint_reads_jax_files(tmp_path):
    from rvpt_tpu.utils import checkpoint as jckpt

    p = str(tmp_path / "j.npz")
    jckpt.save(p, {"a": jnp.arange(4.0), "n": {"k": jnp.asarray([3], jnp.int32)}},
               meta={"m": 1})
    out, meta = tckpt.load(p, {"a": torch.zeros(4), "n": {"k": torch.zeros(1, dtype=torch.int64)}})
    assert meta == {"m": 1} and torch.equal(out["a"], torch.arange(4.0))
    assert out["n"]["k"].dtype == torch.int64 and int(out["n"]["k"]) == 3
    q = str(tmp_path / "t.npz")
    tckpt.save(q, {"a": torch.arange(4.0)})
    back, _ = jckpt.load(q, {"a": jnp.zeros(4)})
    assert np.array_equal(np.asarray(back["a"]), np.arange(4.0))


def test_hot_reload_watcher_drops_the_kernel_libraries(monkeypatch):
    import rvpt_tpu_torch.core.sampling as mod

    dropped = []
    monkeypatch.setattr(build, "unload", lambda: dropped.append(1) or [])
    w = SourceWatcher()
    assert w.package == "rvpt_tpu_torch" and w.dirty_modules() == []
    t = time.time() + 5
    os.utime(mod.__file__, (t, t))
    try:
        assert "rvpt_tpu_torch.core.sampling" in w.dirty_modules()
        assert "rvpt_tpu_torch.core.sampling" in w.reload_if_changed()
        assert dropped == [1] and w.dirty_modules() == []
    finally:
        os.utime(mod.__file__)


def test_build_unload_forgets_libraries(monkeypatch):
    monkeypatch.setitem(build._LIBS, "fake", object())
    monkeypatch.setitem(build.BUILD_INFO, "fake", {})
    assert "fake" in build.unload()
    assert "fake" not in build._LIBS and "fake" not in build.BUILD_INFO


def test_metrics_rolling_and_jsonl(tmp_path):
    p = str(tmp_path / "m.jsonl")
    m = metrics.Metrics(window=3, jsonl_path=p)
    for i in range(5):
        m.log(loss=float(i), rays=100.0)
    assert m.last("loss") == 4.0 and m.mean("loss") == 3.0
    assert m.summary()["rays"] == 100.0
    m.close()
    lines = [json.loads(line) for line in open(p)]
    assert len(lines) == 5 and lines[-1]["step"] == 5
    metrics.setup_logging("DEBUG")
    metrics.setup_logging("INFO")
    import logging

    assert len(logging.getLogger("rvpt_tpu_torch").handlers) == 1


def test_profiling_helpers(tmp_path):
    from rvpt_tpu.utils.profiling import mrays_per_second as j_mrays

    assert profiling.mrays_per_second(1920, 1088, 8, 1, 0.1) == j_mrays(1920, 1088, 8, 1, 0.1)
    prof = profiling.StepProfile(window=3)
    for _ in range(5):
        with prof.phase("render"):
            pass
    assert prof.summary()["render"]["count"] == 3
    with profiling.device_trace(str(tmp_path / "tr")) as p:
        with profiling.annotate("rvpt_region"):
            torch.ones(8).sum()
    assert os.path.exists(tmp_path / "tr" / "trace.json")
    assert any(e.key == "rvpt_region" for e in p.key_averages())


def test_debug_validation_and_plain_routing():
    x = torch.tensor(-1.0, requires_grad=True)
    with debug.validation():
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).backward()
    calls = []
    card = torch.device("cuda")
    kernel, plain = (lambda: calls.append("kernel")), (lambda: calls.append("plain"))
    tpk._on_device(card, kernel, plain)
    with debug.interpret_kernels():
        tpk._on_device(card, kernel, plain)
        tpk._on_device(torch.device("cpu"), kernel, plain)
    tpk._on_device(card, kernel, plain)
    assert calls == ["kernel", "plain", "plain", "kernel"]


@pytest.mark.parametrize("kind", ["triangles", "bvh"])
def test_debug_overlays_match_jax(kind):
    js, jc = jbuiltin.mesh_demo(subdiv=1, aspect=1.0)
    ts, tc = tbuiltin.mesh_demo(subdiv=1, aspect=1.0, device="cpu")
    img = np.zeros((64, 64, 3), np.float32)
    if kind == "triangles":
        want = jdraw.overlay_triangles(img, js, jc)
        got = debug_draw.overlay_triangles(img, ts, tc)
    else:
        tri = [np.asarray(getattr(js, k)) for k in ("tri_v0", "tri_v1", "tri_v2")]
        want = jdraw.overlay_bvh(img, j_build_bvh(*j_triangle_bounds(*tri)), jc)
        got = debug_draw.overlay_bvh(img, build_bvh(*triangle_bounds(*tri)), tc)
    assert (got > 0).any(axis=-1).sum() > 20 and (img == 0).all()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- renderer


def _renderers(**kw):
    cfg = FilmConfig(width=24, height=16)
    ts, tc = tbuiltin.sphere_plane(aspect=cfg.aspect, device="cpu")
    js, jc = jbuiltin.sphere_plane(aspect=cfg.aspect)
    r = Renderer(ts, tc, RenderSettings(max_bounces=2), cfg, **kw)
    jr = JRenderer(js, jc, JRenderSettings(max_bounces=2), JFilmConfig(24, 16), **kw)
    return r, jr


def test_renderer_draw_matches_jax_and_resets():
    r, jr = _renderers()
    for _ in range(2):
        r.draw()
        jr.draw()
    assert r.film.frame == int(jr.film.frame) == 2
    share = np.isclose(r.film.accum.numpy(), np.asarray(jr.film.accum),
                       rtol=1e-4, atol=1e-4).mean()
    assert share >= 0.995
    r.update_camera(translation=(0.0, 0.0, -0.5))
    r.draw()
    assert r.film.frame == 1
    r.settings = r.settings.replace(max_bounces=3)
    r.draw()
    assert r.film.frame == 1
    s = r.stats()
    assert s["frames"] == 4 and s["avg_ms"] > 0 and s["accumulated_frames"] == 1


def test_renderer_frames_in_flight_and_flush():
    r, _ = _renderers()
    r2 = Renderer(r.scene, r.camera, r.settings, r.film_cfg, frames_in_flight=1)
    for _ in range(3):
        r.draw()
        r2.draw()
        assert len(r._inflight) <= r.frames_in_flight - 1
    r.flush()
    assert not r._inflight and torch.equal(r.film.accum, r2.film.accum)


def test_renderer_reload_first_press(monkeypatch):
    r, _ = _renderers()
    monkeypatch.setattr(r._watcher, "reload_if_changed",
                        lambda clear_caches=True: ["rvpt_tpu_torch.fake_module"])
    assert r.reload() == ["rvpt_tpu_torch.fake_module"]


def test_renderer_use_bvh_and_mesh():
    ts, tc = tbuiltin.cornell_box(device="cpu")
    r = Renderer(ts, tc, RenderSettings(max_bounces=1), FilmConfig(8, 8), use_bvh=True)
    assert r.scene.bvh is not None and isinstance(r.tracer, tpk.PathTracer)
    assert r.tracer.bvh_form and r.tracer.cull is not None
    r.draw()
    r.set_scene(ts)
    assert r._prev_state is None and r.scene.bvh is None and not r.tracer.bvh_form
    with pytest.raises(TypeError, match="DeviceMesh"):
        Renderer(ts, tc, mesh=object())


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_renderer_checkpoint_crosses_packages(tmp_path, direction):
    r, jr = _renderers()
    src, dst = (jr, r) if direction == "jax_to_port" else (r, jr)
    for _ in range(2):
        src.draw()
    src.settings = src.settings.replace(style="standard")
    p = str(tmp_path / "ck.npz")
    src.save_checkpoint(p)
    dst.load_checkpoint(p)
    assert int(dst.film.frame) == 2 and dst.settings.style == "standard"
    np.testing.assert_array_equal(np.asarray(dst.film.accum), np.asarray(src.film.accum))
    np.testing.assert_array_equal(np.asarray(dst.camera.translation),
                                  np.asarray(src.camera.translation))
    dst.draw()  # resuming continues accumulation
    assert int(dst.film.frame) == 3


def test_renderer_save_image_and_debug_views(tmp_path):
    from rvpt_tpu_torch.utils.image import read_png

    cfg = FilmConfig(width=48, height=32)
    ts, tc = tbuiltin.mesh_demo(subdiv=1, aspect=cfg.aspect, device="cpu")
    r = Renderer(ts, tc, RenderSettings(max_bounces=1), cfg)
    r.draw()
    p = str(tmp_path / "img.png")
    r.save_image(p)
    assert read_png(p).shape == (32, 48, 3)
    base = r.image.numpy()
    for kind in ("triangles", "bvh"):
        view = r.debug_view(kind)
        assert view.shape == (32, 48, 3) and (np.abs(view - base) > 1e-3).any()
    with pytest.raises(ValueError, match="unknown debug view"):
        r.debug_view("nope")


def test_render_sample_matches_jax():
    cfg = FilmConfig(24, 16)
    ts, tc = tbuiltin.cornell_box(aspect=cfg.aspect, device="cpu")
    js, jc = jbuiltin.cornell_box(aspect=cfg.aspect)
    got = render_sample(ts, tc, RenderSettings(max_bounces=3), cfg, 5)
    want = np.asarray(j_render_sample(js, jc, JRenderSettings(max_bounces=3),
                                      JFilmConfig(24, 16), jnp.uint32(5)))
    assert got.shape == (16, 24, 3)
    assert np.isclose(got.numpy(), want, rtol=1e-4, atol=1e-4).mean() >= 0.995
