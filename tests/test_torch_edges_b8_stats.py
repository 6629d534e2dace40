"""The inputs that the exactness of B8's and of K1's counting walk rests
on, with the plain versions of rvpt_tpu_torch against the JAX package on
the CPU.

B8 (csrc/closest_hit.cu) keeps the first index of the smallest t in
(mint, maxt) and, with its t-first reject, skips the barycentrics of a
triangle whose t cannot beat the winner.  ``closest_hit_triangles`` (its
plain version) is held against ``closest_hit_pallas(interpret=True)`` on
duplicate triangles (every hit a tie, the first copy wins), on a mint equal
to a hit's t, on rays parallel to the triangles' planes (the DENOM_EPS
branch), on a finite maxt, and on 512 and 513 triangles (the kernel's
512-row chunk and one row past it, that row the nearest for some rays).
Bar (tests/test_torch_intersect_pk.py): index equal on >= 99.9% of rays,
t within rtol 1e-5 where the indices agree; on ties every hit is a first
copy in both.

K1's counting walk (csrc/path_kernel.cu count_clusters) reads only the
best t and exits once its masks are full.  ``cull_stats_hook`` (through
``PathTracer.trace(stats=True)`` on the CPU) is held against the JAX
culled kernel's ``stats`` in interpret mode on mesh_demo(1) (82 triangles,
6 clusters: the bounce search lists every cluster of each tile, so the
masks fill) on a 128x96 film, one whole 8,192-ray tile and one partial
one.  JAX counts the lanes that pad a partial tile, so it gets two whole
tiles, the second filled up with rays that miss the root box (they list
nothing).  Bars (tests/test_torch_stats.py): at 1 bounce every counter
equal per tile, at 2 bounces within 2% per tile.

CPU cost: about 20 s, most of it JAX compiling its kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvpt_tpu import FilmConfig as JFilmConfig
from rvpt_tpu.ops import intersect_pk as jipk
from rvpt_tpu.ops import pathkernel as jpk
from rvpt_tpu.render import _pixel_grid as j_grid
from rvpt_tpu.render import jittered_camera_rays as j_rays
from rvpt_tpu.scene import builtin as jbuiltin
from rvpt_tpu_torch.ops import intersect as tint
from rvpt_tpu_torch.ops import pathkernel as tpk
from rvpt_tpu_torch.scene import builtin as tbuiltin

INF = float("inf")
N_RAYS = 2048


def _soup(n, seed):
    """n triangles in front of the rays' origins."""
    r = np.random.default_rng(seed)
    c = r.uniform(-2, 2, (n, 3)).astype(np.float32)
    c[:, 2] += 4.0
    size = 2.0 * np.sqrt(12.0 / n)
    return [c, c + r.normal(0, size, (n, 3)).astype(np.float32),
            c + r.normal(0, size, (n, 3)).astype(np.float32)]


def _rays(seed):
    r = np.random.default_rng(seed)
    o = r.uniform(-0.5, 0.5, (N_RAYS, 3)).astype(np.float32)
    d = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _search_both(o, d, vs, mint, maxt):
    jt, ji = jipk.closest_hit_pallas(
        jnp.asarray(o), jnp.asarray(d), jipk.pack_triangles(*(jnp.asarray(v) for v in vs)),
        mint, maxt, interpret=True)
    tt, ti = tint.closest_hit_triangles(torch.from_numpy(o), torch.from_numpy(d),
                                        *(torch.from_numpy(v) for v in vs), mint, maxt)
    return (tt.numpy(), ti.numpy()), (np.asarray(jt), np.asarray(ji))


def _b8_case(case):
    """(o, d, triangles, mint, maxt) of one edge case."""
    o, d = _rays(1)
    vs = _soup(128, 3)
    mint, maxt = 0.0, INF
    if case == "ties":
        vs = [np.concatenate([v[:64], v[:64]]) for v in vs]
    elif case == "at_mint":
        (t, i), _ = _search_both(o, d, vs, 0.0, INF)
        mint = float(t[i >= 0][0])  # that ray's winner sits exactly at mint
    elif case == "parallel":
        # triangles in planes z = const, half the rays with d.z == 0: dn == 0
        z = np.round(vs[0][:, 2])
        for v in vs:
            v[:, 2] = z
        d = d.copy()
        d[: N_RAYS // 2, 2] = 0.0
    elif case == "maxt":
        maxt = 4.0
    elif case in ("rows512", "rows513"):
        vs = _soup(512, 5)
        if case == "rows513":
            # one more row, nearer than the soup for the rays it covers
            near = np.array([[-3.0, -3.0, 1.0], [3.0, -3.0, 1.0], [0.0, 0.5, 1.0]],
                            dtype=np.float32)
            vs = [np.concatenate([v, near[k][None]]) for k, v in enumerate(vs)]
    return o, d, vs, mint, maxt


@pytest.mark.parametrize("case", ["ties", "at_mint", "parallel", "maxt", "rows512",
                                  "rows513"])
def test_closest_hit_edges_match_jax(case):
    o, d, vs, mint, maxt = _b8_case(case)
    (tt, ti), (jt, ji) = _search_both(o, d, vs, mint, maxt)
    same = ti == ji
    assert same.mean() >= 0.999, f"only {same.mean():.4%} of indices agree"
    hit = same & (ji >= 0)
    assert hit.any()
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=1e-5)
    assert np.isinf(tt[ti < 0]).all() and (tt[ti >= 0] > mint).all()
    assert (tt[ti >= 0] < maxt).all()
    if case == "ties":
        assert (ti < 64).all() and (ji < 64).all()
    if case == "rows513":
        assert (ti == 512).sum() > 0
    if case == "at_mint":
        first = np.flatnonzero(_search_both(o, d, vs, 0.0, INF)[0][1] >= 0)[0]
        assert tt[first] != mint


FILM_W, FILM_H = 128, 96  # 12,288 rays: one whole 8,192-ray tile and half of one


def _stats_rays():
    """The JAX jittered camera rays of the film, for the port, and for JAX
    the same rays filled up to two whole tiles with rays that miss."""
    js, jcam = jbuiltin.mesh_demo(subdiv=1, aspect=FILM_W / FILM_H)
    cfg = JFilmConfig(FILM_W, FILM_H)
    pixel, xs, ys = j_grid(cfg)
    ray = j_rays(jcam, cfg, pixel, xs, ys, jnp.uint32(3), 0)
    n = FILM_W * FILM_H
    fill = 2 * tpk.CULL_TILE - n
    o = np.concatenate([np.asarray(ray.origin), np.full((fill, 3), 1e3, np.float32)])
    d = np.concatenate([np.asarray(ray.direction),
                        np.tile(np.float32([[1.0, 0.0, 0.0]]), (fill, 1))])
    jpix = np.arange(2 * tpk.CULL_TILE, dtype=np.uint32)
    port = (torch.arange(n, dtype=torch.int64), torch.from_numpy(o[:n].copy()),
            torch.from_numpy(d[:n].copy()))
    return js, (jpix, o, d), port


@pytest.fixture(scope="module")
def stats_pair():
    """The JAX counters and the port's plain counters, per (integ, bounces)."""
    js, (jpix, jo, jd), (pix, o, d) = _stats_rays()
    ts, _ = tbuiltin.mesh_demo(subdiv=1, aspect=FILM_W / FILM_H, device="cpu")
    pt = tpk.PathTracer(ts)
    out = {}
    for integ, nb in (("kajiya", 1), ("kajiya", 2), ("whitted", 2), ("cook", 2)):
        _, jagg = jpk.PathTracer(js).trace(
            jnp.asarray(jpix), jnp.asarray(jo), jnp.asarray(jd), jnp.uint32(3), 16, nb,
            interpret=True, stats=True, integ=integ)
        _, agg = pt.trace(pix, o, d, 3, 16, nb, stats=True, integ=integ)
        out[integ, nb] = (torch.stack(agg).numpy(), np.stack([np.asarray(a) for a in jagg]))
    return pt, out


@pytest.mark.parametrize("integ,nb", [("kajiya", 1), ("kajiya", 2), ("whitted", 2),
                                      ("cook", 2)])
def test_stats_whole_and_partial_tile_match_jax(stats_pair, integ, nb):
    _, out = stats_pair
    got, want = out[integ, nb]
    assert got.shape == want.shape == (3, 2)
    if nb == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0.02)
    assert np.array_equal(got[1], got[0]) and (got[2] <= got[0]).all()
    assert (got[0] > 0).all()


def test_stats_masks_fill_in_the_bounce_search(stats_pair):
    """The second search lists every cluster of each tile (the masks fill,
    the case count_clusters' exit takes), and a cluster a lane lists but
    no longer passes is counted as listed only."""
    pt, out = stats_pair
    n_clu = pt.cull.shape[0] - 1
    one, two = out["kajiya", 1][0], out["kajiya", 2][0]
    assert (two[0] - one[0] == n_clu).all()
    assert (two[2] <= two[0]).all()
