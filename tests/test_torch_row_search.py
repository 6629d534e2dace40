"""The any-hit occlusion search of K1's and B3's row forms
(csrc/scene_search.cuh's ``occluded``: the Cornell box's, and every scene
without a BVH) on the CPU, through its plain version ``_any_hit_plain``.

An occlusion search (K1's Whitted shadow rays, B3's AO probes and Appel
shadow rays) answers whether the ray hits anything, and the kernels stop
it at the first triangle that passes the closest-hit acceptance against
the miss sentinel, after the spheres and planes.  ``_any_hit_plain``
finds a hit exactly where the closest-hit search returns a family >= 0:
the port's (``_search_plain``) and the JAX reference's (``_search`` of
rvpt_tpu/ops/pathkernel.py, in a Pallas call run in interpret mode), on
the probe and shadow rays of a 24x16 Cornell frame and of a 40-triangle
soup with spheres and a plane, and on seeded rays from inside and outside
the scenes.

The kernels themselves run only on the card (tests/test_torch_cuda.py
holds them bit for bit against the plain versions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rvpt_tpu.ops import pathkernel as jpk
from rvpt_tpu.scene import builtin as jbuiltin
from rvpt_tpu.scene.scene import SceneBuilder as JSceneBuilder
from rvpt_tpu_torch import FilmConfig
from rvpt_tpu_torch.models import camera as tcam
from rvpt_tpu_torch.ops import pathkernel as tpk
from rvpt_tpu_torch.scene import builtin
from rvpt_tpu_torch.scene.scene import SceneBuilder


def _row_soup(n_tri, seed=5, builder=SceneBuilder):
    """A seeded soup of ``n_tri`` triangles with a light and a glass
    sphere and a floor plane, in front of a pinhole camera; ``builder``
    either package's SceneBuilder (the JAX one's scene has no camera)."""
    r = np.random.default_rng(seed)
    b = builder()
    mats = [b.add_material(albedo=(0.7, 0.6, 0.5)),
            b.add_material(albedo=(0.9, 0.9, 0.9), kind=1)]
    light = b.add_material(albedo=(0.0, 0.0, 0.0), emission=(5.0, 5.0, 5.0))
    size = 2.0 * (12.0 / n_tri) ** 0.5
    for k in range(n_tri):
        c = r.uniform(-2, 2, 3)
        c[2] += 4.0
        b.add_triangle(tuple(c), tuple(c + r.normal(0, size, 3)),
                       tuple(c + r.normal(0, size, 3)), mats[k % 2])
    b.add_sphere((0.0, 2.5, 4.0), 0.8, light)
    b.add_sphere((0.5, -0.5, 3.5), 0.5, mats[1])
    b.add_plane((0.0, 1.0, 0.0), -2.0, mats[0])
    if builder is JSceneBuilder:
        return b.build(), None
    return b.build("cpu"), tcam.Camera.create(fov=90.0, aspect=1.5, device="cpu")


def _scene(name):
    if name == "cornell_box":
        return builtin.cornell_box(aspect=1.5, device="cpu")
    return _row_soup(40)


def _occlusion_rays(name, source):
    """The rays of one kind of occlusion search on a 24x16 frame of the
    scene (caught by the plain versions' ``on_search`` hook, the lanes
    that cast them), or 400 seeded rays ("random": origins in and around
    the scene, unit directions)."""
    scene, cam = _scene(name)
    tables, counts = tpk.pack_fwd(scene)
    if source == "random":
        r = np.random.default_rng(3)
        o = r.uniform((-2.5, -2.5, 0.0), (2.5, 2.5, 6.0), (400, 3))
        d = r.normal(size=(400, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        comps = [torch.from_numpy(np.ascontiguousarray(c, np.float32))
                 for c in (*o.T, *d.T)]
        return tables, counts, comps[:3], comps[3:]
    cfg = FilmConfig(24, 16)
    cp = tpk.camera_params(cam, cfg)
    pix = torch.arange(cfg.num_pixels)
    seen = []

    def keep(o3, d3, live=None):
        lanes = torch.ones_like(o3[0], dtype=torch.bool) if live is None else live
        seen.append(([c[lanes] for c in o3], [c[lanes] for c in d3]))

    if source == "whitted":
        tpk.trace_plain(tables, counts, pix, 1, 16, 4, "standard", cam_params=cp,
                        integ="whitted", on_search=keep)
        # Whitted's shadow searches are every other one after the camera's.
        picked = [s for k, s in enumerate(seen) if k % 2]
    else:
        mode = {"ao": 5, "appel": 6}[source]
        tpk.primary_plain(tables, counts, pix, 1, 16, mode, 4, cp, on_search=keep)
        picked = seen[1:]
    o3 = [torch.cat([s[0][k] for s in picked]) for k in range(3)]
    d3 = [torch.cat([s[1][k] for s in picked]) for k in range(3)]
    return tables, counts, o3, d3


@pytest.mark.parametrize("mint", [0.0, 1e-3])
@pytest.mark.parametrize("source", ["ao", "appel", "whitted", "random"])
@pytest.mark.parametrize("name", ["cornell_box", "soup40"])
def test_any_hit_row_search_equals_closest_hit(name, source, mint):
    tables, counts, o3, d3 = _occlusion_rays(name, source)
    assert o3[0].numel() >= 100, "too few occlusion rays to test"
    tri, sph, pln, _ = tpk._unpack_fwd(tables, counts)
    rows = tpk._unpack_fwd(tables, counts, tri_rows=True)[0]
    closest = tpk._search_plain(tri, sph, pln, *o3, *d3, mint)
    hit, opened, full = tpk._any_hit_plain(rows, sph, pln, *o3, *d3, mint)
    assert torch.equal(hit, closest[5] >= 0)
    if source == "random":  # both answers occur
        assert hit.any() and (~hit).any()
    t = counts[0]
    sp_hit = tpk._search_plain([], sph, pln, *o3, *d3, mint)[5] >= 0
    assert torch.equal(opened[sp_hit], torch.zeros_like(opened[sp_hit]))
    tri_only = ~sp_hit
    # A lane that hits nothing opens every row; one that hits a triangle
    # tests at least that row in full.
    assert (opened[tri_only & ~hit] == t).all()
    assert ((opened >= 0) & (opened <= t) & (full <= opened)).all()
    assert (full[tri_only & hit] >= 1).all()


def _jax_hits(name, o3, d3, mint):
    """The JAX reference's closest-hit search (``_search`` over
    ``pack_fwd``'s columns, in a Pallas call in interpret mode, as the JAX
    kernels run it on the CPU) on the same rays -> its family >= 0."""
    if name == "cornell_box":
        scene = jbuiltin.cornell_box(aspect=1.5)[0]
    else:
        scene = _row_soup(40, builder=JSceneBuilder)[0]
    cols, meta = jpk.pack_fwd(scene)
    nt, ns, npl = len(jpk.TRI_FIELDS), len(jpk.SPH_FIELDS), len(jpk.PLN_FIELDS)
    rays = [jnp.asarray(c.numpy()).reshape(1, -1) for c in (*o3, *d3)]

    def kernel(*refs):
        tri = dict(zip(jpk.TRI_FIELDS, refs[:nt]))
        sph = {k: r[...] for k, r in zip(jpk.SPH_FIELDS, refs[nt:nt + ns])}
        pln = {k: r[...] for k, r in zip(jpk.PLN_FIELDS, refs[nt + ns:nt + ns + npl])}
        winner, _ = jpk._search(tri, sph, pln, meta, *(r[...] for r in refs[-7:-1]), mint)
        refs[-1][...] = winner[5]

    fam = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(rays[0].shape, jnp.int32),
                         interpret=True)(*cols[:nt + ns + npl], *rays)
    return torch.from_numpy(np.asarray(fam)[0] >= 0)


@pytest.mark.parametrize("source", ["ao", "appel", "whitted", "random"])
@pytest.mark.parametrize("name", ["cornell_box", "soup40"])
def test_any_hit_row_search_equals_jax_search(name, source):
    tables, counts, o3, d3 = _occlusion_rays(name, source)
    mint = 0.0  # PathTracer's, the kernels' on the main path
    _, sph, pln, _ = tpk._unpack_fwd(tables, counts)
    rows = tpk._unpack_fwd(tables, counts, tri_rows=True)[0]
    hit = tpk._any_hit_plain(rows, sph, pln, *o3, *d3, mint)[0]
    assert torch.equal(hit, _jax_hits(name, o3, d3, mint))
