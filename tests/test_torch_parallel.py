"""The sharded path of rvpt_tpu_torch (``parallel/``) against the unsharded
port and against the JAX package's shard_map path.

One gloo job of 4 CPU processes (``parallel.dryrun.parity_job``, a module
fixture) renders every case on (4, 1) and (2, 2) meshes, 32x16 (and the
unaligned 30x9), 2 bounces, standard, and saves each rank's results beside
rank 0's unsharded references.  Bars: with one spp rank the sharded image
is the unsharded one bit for bit (plain path; the kernels' plain versions
in Kajiya, AO, Hart, the split-screen, a BVH scene and a big mesh); with
two, the mean of the two salt streams within atol 1e-6
(tests/test_parallel.py:30); the albedo gradient of the mean image,
summed over the ranks, within rtol 1e-5, atol 1e-7 of the unsharded one
(tests/test_parallel.py:57); a train step's parameters bit for bit equal on
every rank and within rtol 1e-5 of the unsharded step.  Against JAX's
``render_sample_sharded`` on the 8-device virtual mesh (sphere_plane,
16x16): the image by the render bar of tests/test_torch_render.py (< 0.2%
of u8 subpixels more than 2 steps off) and the gradient by the paired
trace's JAX bar (rtol 2e-2, atol 1e-5, tests/test_torch_fast_grad.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvpt_tpu import FilmConfig as JFilmConfig
from rvpt_tpu import RenderSettings as JRenderSettings
from rvpt_tpu.parallel import mesh as jmesh
from rvpt_tpu.parallel.sharded import render_sample_sharded as j_sharded
from rvpt_tpu.scene import builtin as jbuiltin
from rvpt_tpu_torch import FilmConfig, RenderSettings
from rvpt_tpu_torch.ops import pathkernel as tpk
from rvpt_tpu_torch.ops.film import to_srgb_u8
from rvpt_tpu_torch.parallel import dryrun
from rvpt_tpu_torch.scene import builtin

WORLD = 4
FILM = (32, 16)
UNALIGNED = (30, 9)  # 270 pixels: the last of 4 tiles is padded
CASES = (
    [(f"{route}_9_cornell", (4, 1), FILM) for route in ("plain", "fast")]
    + [(f"fast_{m}_cornell", (4, 1), FILM) for m in ("5", "10", "split")]
    + [("fast_9_mesh1", (4, 1), FILM), ("fast_9_mesh3", (4, 1), FILM)]
    + [(f"{route}_9_cornell", (4, 1), UNALIGNED) for route in ("plain", "fast")]
    + [(f"{route}_9_cornell", (2, 2), FILM) for route in ("plain", "fast")]
    + [("grad_sphere", (4, 1), (16, 16))]
    + [(f"train_{route}_cornell", (4, 1), FILM) for route in ("fast", "plain")]
    + [("train_fast_cornell", (2, 2), FILM)]
)


def _key(name, shape, size):
    return f"{name}@{shape[0]}x{shape[1]}@{size[0]}x{size[1]}"


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("parity")
    dryrun.spawn(dryrun.parity_job, WORLD, args=(str(out), CASES), timeout=300)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def _same_on_every_rank(job, key):
    for r in range(1, WORLD):
        assert np.array_equal(job[0][key], job[r][key]), f"rank {r}: {key}"
    return job[0][key]


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_make_mesh_dims_and_row_major_layout(job, shape):
    """``make_mesh``: dims named (tiles, spp), the asked shape, and rank =
    tile * n_spp + spp (rvpt_tpu/parallel/mesh.py:31)."""
    key = f"mesh@{shape[0]}x{shape[1]}"
    for r in range(WORLD):
        assert tuple(job[r][f"{key}.names"]) == ("tiles", "spp")
        assert tuple(job[r][f"{key}.shape"]) == shape
        assert tuple(job[r][f"{key}.coords"]) == divmod(r, shape[1])


@pytest.mark.parametrize("name,size", [
    ("plain_9_cornell", FILM), ("fast_9_cornell", FILM),
    ("fast_5_cornell", FILM), ("fast_10_cornell", FILM),
    ("fast_split_cornell", FILM), ("fast_9_mesh1", FILM),
    ("fast_9_mesh3", FILM), ("plain_9_cornell", UNALIGNED),
    ("fast_9_cornell", UNALIGNED)])
def test_sharded_image_is_the_unsharded_one(job, name, size):
    """One spp rank: every rank holds the unsharded image bit for bit
    (``render_sample_chw`` for the plain route, ``render_sample_fast_chw``
    for the kernels')."""
    key = _key(name, (4, 1), size)
    got = _same_on_every_rank(job, f"{key}.got.image")
    want = job[0][f"{key}.want.image"]
    assert got.shape == (3, size[1], size[0])
    assert np.array_equal(got, want), f"max diff {np.abs(got - want).max()}"


def test_route_scenes():
    """The BVH case takes PathTracer's BVH form and the big-mesh case
    BigMeshTracer (``pathkernel.is_bigmesh``)."""
    small, _ = builtin.mesh_demo(1, device="cpu")
    big, _ = builtin.mesh_demo(3, device="cpu")
    assert small.bvh is not None and not tpk.is_bigmesh(small)
    assert tpk.is_bigmesh(big)


@pytest.mark.parametrize("route", ["plain", "fast"])
def test_spp_ranks_average_their_salt_streams(job, route):
    """(2, 2): the mean of the aa_offset 0 and 1 renders within atol 1e-6."""
    key = _key(f"{route}_9_cornell", (2, 2), FILM)
    got = _same_on_every_rank(job, f"{key}.got.image")
    want = job[0][f"{key}.want.image"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    one = job[0][_key(f"{route}_9_cornell", (4, 1), FILM) + ".want.image"]
    assert not np.array_equal(got, one)  # the second stream is in it


def test_gradient_counts_once(job):
    """The albedo gradient of the sharded mean image, summed over the 4
    ranks, is the unsharded gradient (each pixel's share counted once)."""
    key = _key("grad_sphere", (4, 1), (16, 16))
    got = _same_on_every_rank(job, f"{key}.got.grad")
    want = job[0][f"{key}.want.grad"]
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's sharded image and mean-image albedo gradient on the 8-device
    virtual mesh (tests/test_parallel.py:57's setting)."""
    cfg = JFilmConfig(width=16, height=16)
    st = JRenderSettings(max_bounces=2, style="standard")
    scene, cam = jbuiltin.sphere_plane(aspect=1.0)
    mesh = jmesh.make_mesh(8, 1)

    def loss(albedo):
        s = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials, albedo=albedo))
        img = j_sharded(s, cam, st, cfg, 0, mesh)
        return jnp.mean(img), img

    (_, img), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        scene.materials.albedo)
    return np.asarray(img), np.asarray(grad)


def test_sharded_image_and_gradient_match_jax(job, jax_sharded):
    key = _key("grad_sphere", (4, 1), (16, 16))
    img, grad = jax_sharded
    got = to_srgb_u8(torch.from_numpy(job[0][f"{key}.got.image"])).numpy()
    want = to_srgb_u8(torch.tensor(img)).numpy()
    off = (np.abs(got.astype(int) - want.astype(int)) > 2).mean()
    assert off < 0.002, f"{off:.4%} of subpixels differ by >2"
    np.testing.assert_allclose(job[0][f"{key}.got.grad"], grad, rtol=2e-2,
                               atol=1e-5)


@pytest.mark.parametrize("route,shape", [("fast", (4, 1)), ("plain", (4, 1)),
                                         ("fast", (2, 2))])
def test_train_step_equal_on_every_rank(job, route, shape):
    """Parameters after one sharded step are bit for bit equal on every
    rank; with one spp rank they and the loss are the unsharded step's
    within rtol 1e-5."""
    key = _key(f"train_{route}_cornell", shape, FILM)
    for leaf in ("materials.albedo", "materials.emission"):
        got = _same_on_every_rank(job, f"{key}.got.{leaf}")
        if shape[1] == 1:
            np.testing.assert_allclose(got, job[0][f"{key}.want.{leaf}"],
                                       rtol=1e-5, atol=0, err_msg=leaf)
    loss = _same_on_every_rank(job, f"{key}.got.loss")
    assert np.isfinite(loss)
    if shape[1] == 1:
        np.testing.assert_allclose(loss, job[0][f"{key}.want.loss"], rtol=1e-5)


def _renderers(mesh):
    from rvpt_tpu_torch.renderer import Renderer

    cfg = FilmConfig(*FILM)
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device="cpu")
    st = RenderSettings(max_bounces=2, style="standard")
    return [Renderer(scene, cam, st, cfg, mesh=m) for m in (None, mesh)]


def test_world_of_one_in_process():
    """``make_mesh(1, 1)`` with no process group makes a group of one on its
    own store; ``Renderer(mesh=...)``'s draws, a ``make_train_step`` step
    and ``recover`` with that mesh are then the unsharded ones bit for bit;
    a mesh that is not a DeviceMesh raises TypeError."""
    import torch.distributed as dist

    from rvpt_tpu_torch.parallel.mesh import make_mesh
    from rvpt_tpu_torch.train import inverse

    assert not dist.is_initialized()
    mesh = make_mesh(1, 1, device="cpu")
    try:
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        plain, sharded = _renderers(mesh)
        for _ in range(2):
            plain.draw()
            sharded.draw()
        assert sharded.film.frame == 2
        assert torch.equal(plain.film.accum, sharded.film.accum)
        assert torch.equal(plain.image, sharded.image)

        scene, cam, st, cfg = plain.scene, plain.camera, plain.settings, plain.film_cfg
        target = 0.5 * plain.film.accum
        for fast in (True, False):
            runs = [inverse.recover(scene, cam, st, cfg, m, target, steps=2,
                                    fast=fast) for m in (None, mesh)]
            for k in ("albedo", "emission"):
                assert torch.equal(getattr(runs[0][0].materials, k),
                                   getattr(runs[1][0].materials, k)), (fast, k)
            np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=1e-6)
        with pytest.raises(TypeError):
            inverse.make_train_step(scene, cam, st, cfg, object(), target)
    finally:
        dist.destroy_process_group()
