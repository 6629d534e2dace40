"""Scene, camera and intersection of rvpt_tpu_torch against rvpt_tpu."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvpt_tpu.core.types import Ray as JRay
from rvpt_tpu.models import camera as jcam
from rvpt_tpu.ops import intersect as jint
from rvpt_tpu.scene import builtin as jbuiltin
from rvpt_tpu_torch import convert
from rvpt_tpu_torch.core.types import Ray as TRay
from rvpt_tpu_torch.models import camera as tcam
from rvpt_tpu_torch.ops import intersect as tint
from rvpt_tpu_torch.scene import builtin as tbuiltin
from rvpt_tpu_torch.scene.scene import ARRAY_FIELDS


def jax_scene_dict(scene):
    d = {k: np.asarray(getattr(scene, k)) for k in ARRAY_FIELDS}
    for k in ("albedo", "emission", "ior", "kind"):
        d[f"materials.{k}"] = np.asarray(getattr(scene.materials, k))
    return d


def jax_camera_dict(cam):
    d = {k: np.asarray(getattr(cam, k))
         for k in ("translation", "rotation", "fov", "scale")}
    d.update(aspect=cam.aspect, mode=cam.mode)
    return d


@pytest.mark.parametrize("name", ["cornell_box", "sphere_plane"])
def test_scene_from_numpy_equals_builtin(name):
    js, jc = getattr(jbuiltin, name)(aspect=1.5)
    ts, tc = getattr(tbuiltin, name)(aspect=1.5, device="cpu")
    conv = convert.scene_from_numpy(jax_scene_dict(js), "cpu")
    for k in ARRAY_FIELDS:
        a, b = getattr(conv, k), getattr(ts, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    for k in ("albedo", "emission", "ior", "kind"):
        assert torch.equal(getattr(conv.materials, k), getattr(ts.materials, k)), k
    cc = convert.camera_from_numpy(jax_camera_dict(jc), "cpu")
    for k in ("translation", "rotation", "fov", "scale"):
        assert torch.equal(getattr(cc, k), getattr(tc, k)), k
    assert (cc.aspect, cc.mode) == (tc.aspect, tc.mode)


@pytest.mark.parametrize("mode", [tcam.PINHOLE, tcam.ORTHO, tcam.SPHERICAL])
def test_generate_rays_matches_jax(mode):
    r = np.random.default_rng(mode)
    x = r.uniform(0, 1, 4096).astype(np.float32)
    y = r.uniform(0, 1, 4096).astype(np.float32)
    kw = dict(translation=(0.3, -0.2, 1.0), rotation=(20.0, -10.0, 5.0),
              fov=68.0, scale=2.0, aspect=1.5, mode=mode)
    jr = jcam.generate_rays(jcam.Camera.create(**kw), jnp.asarray(x), jnp.asarray(y))
    tr = tcam.generate_rays(tcam.Camera.create(**kw, device="cpu"), torch.from_numpy(x),
                            torch.from_numpy(y))
    np.testing.assert_allclose(tr.origin.numpy(), np.asarray(jr.origin), atol=1e-6)
    np.testing.assert_allclose(tr.direction.numpy(), np.asarray(jr.direction),
                               atol=1e-6)


def _random_tris(n, seed):
    r = np.random.default_rng(seed)
    v0 = r.uniform(-2, 2, (n, 3)).astype(np.float32)
    v1 = v0 + r.uniform(-1, 1, (n, 3)).astype(np.float32)
    v2 = v0 + r.uniform(-1, 1, (n, 3)).astype(np.float32)
    return v0, v1, v2


def test_triangle_precompute_matches_jax():
    vs = _random_tris(64, 0)
    want = jint.triangle_precompute(*(jnp.asarray(v) for v in vs))
    got = tint.triangle_precompute(*(torch.from_numpy(v) for v in vs))
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_closest_hit_scene_matches_jax():
    """Cornell box plus 40 random triangles and a plane, 4096 random rays:
    (family, index) equal on >= 99.9% of rays, t within rtol 1e-5."""
    js, _ = jbuiltin.cornell_box()
    d = jax_scene_dict(js)
    v0, v1, v2 = _random_tris(40, 1)
    for k, v in (("tri_v0", v0), ("tri_v1", v1), ("tri_v2", v2)):
        d[k] = np.concatenate([d[k], v])
    d["tri_mat"] = np.concatenate([d["tri_mat"], np.zeros(40, np.int32)])
    d["pln_normal"] = np.asarray([[0.0, 1.0, 0.0]], np.float32)
    d["pln_d"] = np.asarray([-1.5], np.float32)
    d["pln_mat"] = np.asarray([0], np.int32)
    js = dataclasses.replace(js, **{k: jnp.asarray(d[k]) for k in (
        "tri_v0", "tri_v1", "tri_v2", "tri_mat", "pln_normal", "pln_d", "pln_mat")})
    ts = convert.scene_from_numpy(d, "cpu")

    r = np.random.default_rng(2)
    o = r.uniform(-0.9, 0.9, (4096, 3)).astype(np.float32)
    o[:, 2] = r.uniform(2.1, 3.9, 4096)
    dvec = r.normal(size=(4096, 3)).astype(np.float32)
    dvec /= np.linalg.norm(dvec, axis=1, keepdims=True)
    jf, ji, jt = jint.closest_hit_scene(
        js, JRay(jnp.asarray(o), jnp.asarray(dvec)), 0.0, jnp.inf)
    tf, ti, tt = tint.closest_hit_scene(
        ts, TRay(torch.from_numpy(o), torch.from_numpy(dvec)), 0.0, float("inf"))
    same = (tf.numpy() == np.asarray(jf)) & (ti.numpy() == np.asarray(ji))
    assert same.mean() >= 0.999, f"only {same.mean():.4%} of hits agree"
    assert (tf.numpy() >= 0).mean() > 0.9  # the rays mostly hit something
    np.testing.assert_allclose(tt.numpy()[same], np.asarray(jt)[same], rtol=1e-5)
