"""The closest-triangle search of rvpt_tpu_torch (kernel B8's plain route)
against the JAX Pallas kernel B8 in interpret mode.

On the CPU ``closest_hit_scene`` takes the plain search
``closest_hit_triangles``; on the card it launches ``csrc/closest_hit.cu``
(tests/test_torch_cuda.py holds the two together there).  Bar (the
tests/test_torch_scene_camera.py bar): index equal on >= 99.9% of rays, t
within rtol 1e-5 where the indices agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvpt_tpu.ops import intersect_pk as jipk
from rvpt_tpu_torch.core.types import Ray
from rvpt_tpu_torch.ops import intersect as tint
from rvpt_tpu_torch.ops import intersect_pk as tipk
from rvpt_tpu_torch.scene import builtin as tbuiltin


def _soup(n, seed):
    """n triangles, about 12 of them across a ray's path on average."""
    r = np.random.default_rng(seed)
    c = r.uniform(-2, 2, (n, 3)).astype(np.float32)
    c[:, 2] += 4.0
    size = 2.0 * np.sqrt(12.0 / n)
    v1 = c + r.normal(0, size, (n, 3)).astype(np.float32)
    v2 = c + r.normal(0, size, (n, 3)).astype(np.float32)
    return c, v1, v2


def _rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.5  # mostly toward the soup
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("n_tri", [12, 300])  # 300: two of JAX's 256-row chunks
def test_plain_search_matches_jax_kernel(n_tri):
    """(f) closest_hit_triangles against closest_hit_pallas(interpret=True)
    on seeded rays."""
    vs = _soup(n_tri, n_tri)
    o, d = _rays(4096, 1)
    jt, ji = jipk.closest_hit_pallas(
        jnp.asarray(o), jnp.asarray(d),
        jipk.pack_triangles(*(jnp.asarray(v) for v in vs)), 0.0, np.inf,
        interpret=True)
    tt, ti = tint.closest_hit_triangles(
        torch.from_numpy(o), torch.from_numpy(d),
        *(torch.from_numpy(v) for v in vs), 0.0, float("inf"))
    ji, jt = np.asarray(ji), np.asarray(jt)
    same = ti.numpy() == ji
    assert same.mean() >= 0.999, f"only {same.mean():.4%} of indices agree"
    assert (ji >= 0).mean() > 0.2, (ji >= 0).mean()  # many rays hit something
    hit = same & (ji >= 0)
    np.testing.assert_allclose(tt.numpy()[hit], jt[hit], rtol=1e-5)
    assert np.isinf(tt.numpy()[ti.numpy() < 0]).all()


def test_pack_triangles_matches_jax():
    vs = _soup(40, 2)
    want = jipk.pack_triangles(*(jnp.asarray(v) for v in vs))
    got = tipk.pack_triangles(*(torch.from_numpy(v) for v in vs))
    assert got.shape == (40, len(tipk.FIELDS)) and got.is_contiguous()
    for k, name in enumerate(tipk.FIELDS):
        np.testing.assert_allclose(got[:, k].numpy(), np.asarray(want[name])[:40, 0],
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_cpu_rays_take_the_plain_search():
    """A CPU scene never reaches the CUDA library; the launcher refuses CPU
    tensors instead of falling back."""
    scene, _ = tbuiltin.cornell_box(device="cpu")
    o, d = _rays(256, 3)
    o[:, 2] += 3.0  # inside the box
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    before = tipk.launch_closest_hit.launches
    fam, idx, t = tint.closest_hit_scene(scene, Ray(o, d), 0.0, float("inf"))
    assert tipk.launch_closest_hit.launches == before
    assert (fam >= 0).float().mean() > 0.5
    packed = tipk.pack_triangles(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    with pytest.raises(ValueError, match="CUDA"):
        tipk.launch_closest_hit(o, d, packed, 0.0, float("inf"))
