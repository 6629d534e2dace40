"""Component-SoA differentiable replay of the Kajiya bounce chain (mirror of
``rvpt_tpu/ops/replay_soa.py``), with the triangle-table lookups of the
mesh backward in CUDA.

``kajiya_replay_soa`` replays a traced path from its per-bounce hit
records with every intermediate a flat [N] component tensor: the winner's
geometry is rebuilt from the recorded (family, index), so autograd through
it gives the gradient of the image with respect to the rays and the scene
without any search.  It is the backward of ``make_fast_kajiya``'s "soa"
route, which serves big meshes.

Scene tables are read through ``_lookup_group``: one index, several [T]
tables.  Tables of at most ``_LOOKUP_UNROLL`` rows (materials, spheres,
planes, a small scene's triangles) take ``_SmallLookup``: plain indexing,
and as its transpose the one-hot contraction that the TPU's select-sum
``_lookup`` (:43) has, one matrix product (autograd's own transpose of
indexing sums each row's duplicates one by one: seconds per 1080p step and
percent-level f32 error when every ray reads one of three material rows).
Larger tables, a mesh's triangles, take ``_LookupGroup``, whose forward is
the gather and whose backward is the segment sum:

* ``csrc/replay_lookup.cu``, hand-written CUDA for Hopper
  (``launch_gather``, ``launch_segsum``), the port of the Pallas kernels
  B7a-d (``_gather_mm`` :309, ``_segsum_mm`` :244, ``_gather_mm_big`` :105,
  ``_segsum_mm_big`` :170, and the chunking of ``_gather_mm_huge`` :359 and
  ``_segsum_mm_huge`` :381): one kernel of each kind for any row count;
* ``gather_plain`` (per-column ``index_select``) and ``segsum_plain``
  (``index_add_`` in float64, cast to f32): the plain versions, the
  references the kernels are held against.

``gather`` and ``segsum`` dispatch on the device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import rng
from ..core.math import TWO_PI
from .build import check_cuda, check_launch, load_library
from .pathkernel import _on_device

_EPSILON = 5e-3
_DENOM_EPS = 1e-30
_WHITE = (1.0, 1.0, 1.0)
_BLUE = (0.2, 0.3, 0.7)

# Tables at or below this row count use plain indexing; larger ones the
# gather and segment-sum kernels (replay_soa.py:40).
_LOOKUP_UNROLL = 64


# ---------------------------------------------------------------------------
# The gather and the segment sum
# ---------------------------------------------------------------------------


def gather_plain(tables: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tables`` f32[C, T] at ``idx`` int32[N] -> f32[C, N], one
    ``index_select`` per column."""
    return torch.stack([col.index_select(0, idx) for col in tables.unbind(0)])


def segsum_plain(idx: torch.Tensor, g: torch.Tensor, t_rows: int) -> torch.Tensor:
    """The transpose of ``gather_plain``: ``g`` f32[C, N] summed into the
    rows ``idx`` int32[N] -> f32[C, T], in float64 (``index_add_``) and then
    cast to f32, so it is the exact sum up to that one rounding."""
    out = torch.zeros((g.shape[0], t_rows), dtype=torch.float64, device=g.device)
    return out.index_add_(1, idx, g.to(torch.float64)).to(torch.float32)


def _lookup_lib():
    lib = load_library("replay_lookup")
    if not hasattr(lib, "_rvpt_bound"):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rvpt_gather.argtypes = [ptr, i32, i32, ptr, ptr, i32, ptr]
        lib.rvpt_gather.restype = i32
        lib.rvpt_segsum.argtypes = [ptr, ptr, i32, i32, i32, ptr, ptr, ptr]
        lib.rvpt_segsum.restype = i32
        lib._rvpt_bound = True
    return lib


def _check_tables(tables):
    if tables.dim() != 2:
        raise ValueError(f"tables: need [C, T], got {tuple(tables.shape)}")
    check_cuda(tables, torch.float32, "tables")


def launch_gather(tables: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA gather on the tables' card -> f32[C, N], as
    ``gather_plain`` (bit for bit).  ``idx`` int32[N] must lie in [0, T).
    Counts one launch in ``launch_gather.launches``."""
    _check_tables(tables)
    check_cuda(idx, torch.int32, "idx", device=tables.device)
    c, t = tables.shape
    n = idx.numel()
    out = torch.empty((c, n), dtype=torch.float32, device=tables.device)
    lib = _lookup_lib()
    err = lib.rvpt_gather(tables.data_ptr(), c, t, idx.data_ptr(), out.data_ptr(),
                          n, torch.cuda.current_stream(tables.device).cuda_stream)
    check_launch(lib, err, "gather")
    launch_gather.launches += 1
    return out


launch_gather.launches = 0


def launch_segsum(idx: torch.Tensor, g: torch.Tensor, t_rows: int) -> torch.Tensor:
    """Launch the CUDA segment sum on ``g``'s card -> f32[C, T], as
    ``segsum_plain``: each block of 4,096 rays sums into a table of rows
    in shared memory (``csrc/replay_lookup.cu``), then into a float64
    scratch this wrapper allocates, by atomics in no fixed order; then
    rounded to f32.  Counts one launch in ``launch_segsum.launches``."""
    if g.dim() != 2:
        raise ValueError(f"g: need [C, N], got {tuple(g.shape)}")
    check_cuda(g, torch.float32, "g")
    n = g.shape[1]
    check_cuda(idx, torch.int32, "idx", n, g.device)
    c = g.shape[0]
    out = torch.empty((c, int(t_rows)), dtype=torch.float32, device=g.device)
    acc = torch.empty((c, int(t_rows)), dtype=torch.float64, device=g.device)
    lib = _lookup_lib()
    err = lib.rvpt_segsum(idx.data_ptr(), g.data_ptr(), c, n, int(t_rows),
                          acc.data_ptr(), out.data_ptr(),
                          torch.cuda.current_stream(g.device).cuda_stream)
    check_launch(lib, err, "segment sum")
    launch_segsum.launches += 1
    return out


launch_segsum.launches = 0


def gather(tables, idx):
    """``tables`` f32[C, T] at ``idx`` int32[N] -> f32[C, N]: the kernel on
    the card, ``gather_plain`` on the CPU."""
    return _on_device(tables.device, lambda: launch_gather(tables, idx),
                      lambda: gather_plain(tables, idx))


def segsum(idx, g, t_rows):
    """``g`` f32[C, N] summed into the rows ``idx`` -> f32[C, T]: the kernel
    on the card, ``segsum_plain`` on the CPU."""
    return _on_device(g.device, lambda: launch_segsum(idx, g, t_rows),
                      lambda: segsum_plain(idx, g, t_rows))


class _LookupGroup(torch.autograd.Function):
    """f32[C, N] lookup of C same-length [T] tables at one index; the
    cotangent of the leading ``n_diff`` tables comes back from one segment
    sum (``_lookup_group_mm`` :396)."""

    @staticmethod
    def forward(ctx, idx, n_diff, *tables):
        ctx.save_for_backward(idx)
        ctx.n_diff, ctx.t_rows = n_diff, tables[0].shape[0]
        return gather(torch.stack(tables).contiguous(), idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        grads = [None] * (g.shape[0])
        cols = [c for c in range(ctx.n_diff) if ctx.needs_input_grad[2 + c]]
        if cols:
            rows = segsum(idx, g[cols].contiguous(), ctx.t_rows)
            for c, row in zip(cols, rows.unbind(0)):
                grads[c] = row
        return (None, None, *grads)


class _SmallLookup(torch.autograd.Function):
    """f32[C, N] lookup of C same-length tables of at most
    ``_LOOKUP_UNROLL`` rows at one index; the cotangent of the tables is the
    one-hot contraction g @ onehot(idx) (the transpose of ``_lookup``'s
    select-sum :43, a masked reduction there)."""

    @staticmethod
    def forward(ctx, idx, *tables):
        ctx.save_for_backward(idx)
        ctx.t_rows = tables[0].shape[0]
        return torch.stack(tables)[:, idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        grads = [None] * g.shape[0]
        cols = [c for c in range(g.shape[0]) if ctx.needs_input_grad[1 + c]]
        if cols:
            rows = torch.arange(ctx.t_rows, device=idx.device)
            onehot = (idx[:, None] == rows).to(g.dtype)
            for c, row in zip(cols, (g[cols] @ onehot).unbind(0)):
                grads[c] = row
        return (None, *grads)


def _lookup(table, idx):
    """``table[idx]`` without a gradient (an id table); zeros for an empty
    table."""
    if table.shape[0] == 0:
        return torch.zeros(idx.shape, dtype=table.dtype, device=idx.device)
    return table[idx]


def _lookup_group(tables, idx, n_diff=None):
    """Shared-index lookup across several same-length [T] float tables -> a
    tuple of f32[N].  ``idx`` int64[N] must be clipped to [0, T).  Tables
    of at most ``_LOOKUP_UNROLL`` rows take ``_SmallLookup``; larger ones
    ``_LookupGroup`` (the gather kernel, and in the backward the segment sum
    of the leading ``n_diff`` tables only: the rest have a zero
    cotangent)."""
    if tables[0].shape[0] == 0:
        return tuple(_lookup(t, idx) for t in tables)
    if tables[0].shape[0] <= _LOOKUP_UNROLL:
        return _SmallLookup.apply(idx, *tables).unbind(0)
    n = len(tables) if n_diff is None else n_diff
    return _LookupGroup.apply(idx.to(torch.int32).contiguous(), n,
                              *tables).unbind(0)


# ---------------------------------------------------------------------------
# The replay
# ---------------------------------------------------------------------------


def _safe_div(num, den):
    return num / torch.where(torch.abs(den) < _DENOM_EPS,
                             torch.full_like(den, _DENOM_EPS), den)


def _rsqrt_safe(x):
    return torch.rsqrt(torch.clamp(x, min=1e-30))


def kajiya_replay_soa(scene, origin, direction, pixel, frame, salt_base,
                      fams, idxs, style="reference"):
    """Radiance f32[N, 3] of a Kajiya trace from its hit records ``fams``/
    ``idxs`` int[B, N] (-1 where dead or missed), with flat [N] component
    internals (``kajiya_replay_soa`` :444).  ``origin``/``direction``
    f32[N, 3], ``pixel`` int64[N]; bounce b draws with the salt
    ``salt_base + 4 b``.  Differentiable with respect to the rays and the
    scene's leaves; equal to ``fast_grad.kajiya_from_hits`` up to
    rounding."""
    n = origin.shape[0]
    dev = origin.device
    nbounce = fams.shape[0]
    n_tri, n_sph, n_pln = scene.num_triangles, scene.num_spheres, scene.num_planes
    mats = scene.materials
    n_mat = max(mats.count, 1)

    if n_tri:
        tri_tabs = (*scene.tri_v0.unbind(1), *scene.tri_v1.unbind(1),
                    *scene.tri_v2.unbind(1))
        # A big table's material id rides the same gather (exact for
        # integers) behind n_diff = 9, so its column takes no segment sum.
        group_mat = n_tri > _LOOKUP_UNROLL
        if group_mat:
            tri_tabs = tri_tabs + (scene.tri_mat.to(torch.float32),)
    if n_sph:
        sph_tabs = (*scene.sph_center.unbind(1), scene.sph_radius)
    if n_pln:
        pln_tabs = (*scene.pln_normal.unbind(1), scene.pln_d)
    mat_tabs = (*mats.albedo.unbind(1), *mats.emission.unbind(1), mats.ior)

    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    ox, oy, oz = origin.unbind(1)
    dx, dy, dz = direction.unbind(1)
    tr = tg = tb = ones
    cr = cg = cb = rr = rg = rb = zeros
    active = torch.ones((n,), dtype=torch.bool, device=dev)

    for bounce in range(nbounce):
        fam, idx = fams[bounce], idxs[bounce]
        t = wnx = wny = wnz = zeros
        mat_id = torch.zeros((n,), dtype=torch.int64, device=dev)

        if n_tri:
            m = fam == 0
            safe = torch.clamp(idx, 0, n_tri - 1).long()
            looked = _lookup_group(tri_tabs, safe, 9 if group_mat else None)
            v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z = looked[:9]
            e0x, e0y, e0z = v1x - v0x, v1y - v0y, v1z - v0z
            e1x, e1y, e1z = v2x - v0x, v2y - v0y, v2z - v0z
            nx = e0y * e1z - e0z * e1y
            ny = e0z * e1x - e0x * e1z
            nz = e0x * e1y - e0y * e1x
            dn = dx * nx + dy * ny + dz * nz
            t_t = _safe_div((v0x - ox) * nx + (v0y - oy) * ny + (v0z - oz) * nz,
                            dn)
            t = torch.where(m, torch.clamp(t_t, -1e6, 1e6), t)
            wnx = torch.where(m, nx, wnx)
            wny = torch.where(m, ny, wny)
            wnz = torch.where(m, nz, wnz)
            tri_mid = (looked[9].detach().to(torch.int64) if group_mat
                       else _lookup(scene.tri_mat, safe))
            mat_id = torch.where(m, tri_mid, mat_id)

        if n_sph:
            m = fam == 1
            safe = torch.clamp(idx, 0, n_sph - 1).long()
            cx, cy, cz, r = _lookup_group(sph_tabs, safe)
            ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
            dd = dx * dx + dy * dy + dz * dz
            bh = dx * ocx + dy * ocy + dz * ocz
            ct = ocx * ocx + ocy * ocy + ocz * ocz - r * r
            disc = torch.clamp(bh * bh - dd * ct, min=1e-12)
            sq = torch.sqrt(disc)
            t0 = _safe_div(-bh - sq, dd)
            t1 = _safe_div(-bh + sq, dd)
            t_s = torch.where(t0 > 0.0, t0, t1)
            t_s = torch.where(m, torch.clamp(t_s, -1e6, 1e6), zeros)
            t = torch.where(m, t_s, t)
            wnx = torch.where(m, ox + t_s * dx - cx, wnx)
            wny = torch.where(m, oy + t_s * dy - cy, wny)
            wnz = torch.where(m, oz + t_s * dz - cz, wnz)
            mat_id = torch.where(m, _lookup(scene.sph_mat, safe), mat_id)

        if n_pln:
            m = fam == 2
            safe = torch.clamp(idx, 0, n_pln - 1).long()
            nx, ny, nz, doff = _lookup_group(pln_tabs, safe)
            dn = dx * nx + dy * ny + dz * nz
            t_p = _safe_div(doff - (ox * nx + oy * ny + oz * nz), dn)
            t = torch.where(m, torch.clamp(t_p, -1e6, 1e6), t)
            wnx = torch.where(m, nx, wnx)
            wny = torch.where(m, ny, wny)
            wnz = torch.where(m, nz, wnz)
            mat_id = torch.where(m, _lookup(scene.pln_mat, safe), mat_id)

        hit = fam >= 0
        miss_now = active & ~hit

        # The sky on a miss, d.y shifted into [0, 1].
        sky_t = dy * 0.5 + 0.5
        sky = [w + (bl - w) * sky_t for w, bl in zip(_WHITE, _BLUE)]
        rr = torch.where(miss_now, rr + cr + tr * sky[0], rr)
        rg = torch.where(miss_now, rg + cg + tg * sky[1], rg)
        rb = torch.where(miss_now, rb + cb + tb * sky[2], rb)
        active = active & hit

        # The material.
        msafe = torch.clamp(mat_id, 0, n_mat - 1)
        alb_r, alb_g, alb_b, em_r, em_g, em_b, ior = _lookup_group(mat_tabs, msafe)
        kind = _lookup(mats.kind, msafe)

        cr = torch.where(active, cr + tr * em_r, cr)
        cg = torch.where(active, cg + tg * em_g, cg)
        cb = torch.where(active, cb + tb * em_b, cb)

        # The hit's geometry.
        px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
        inv_nl = _rsqrt_safe(wnx * wnx + wny * wny + wnz * wnz)
        nX, nY, nZ = wnx * inv_nl, wny * inv_nl, wnz * inv_nl
        inv_dl = _rsqrt_safe(dx * dx + dy * dy + dz * dz)
        iX, iY, iZ = dx * inv_dl, dy * inv_dl, dz * inv_dl

        cos_view = iX * nX + iY * nY + iZ * nZ
        flipped = cos_view > 0.0
        cos_in = torch.abs(cos_view)
        nX = torch.where(flipped, -nX, nX)
        nY = torch.where(flipped, -nY, nY)
        nZ = torch.where(flipped, -nZ, nZ)
        eta = torch.where(flipped, ior, 1.0 / torch.clamp(ior, min=1e-8))

        u, v, w = rng.uniform3(pixel, frame, salt_base + 4 * bounce)

        phi = TWO_PI * u
        cos_t = 1.0 - 2.0 * v
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=1e-12))
        lamX = nX + sin_t * torch.cos(phi)
        lamY = nY + sin_t * torch.sin(phi)
        lamZ = nZ + cos_t

        refX = iX + 2.0 * cos_in * nX
        refY = iY + 2.0 * cos_in * nY
        refZ = iZ + 2.0 * cos_in * nZ

        cos_out_sqr = 1.0 - eta * eta * (1.0 - cos_in * cos_in)
        cos_out = torch.sqrt(torch.clamp(cos_out_sqr, min=1e-12))
        r_perp = (eta * cos_in - cos_out) / (eta * cos_in + cos_out)
        r_par = (cos_in - eta * cos_out) / (cos_in + eta * cos_out)
        f_refl = 0.5 * (r_perp * r_perp + r_par * r_par)
        refl = (cos_out_sqr <= 0.0) | (w < f_refl)
        k = eta * cos_in - cos_out
        dieX = torch.where(refl, refX, eta * iX + k * nX)
        dieY = torch.where(refl, refY, eta * iY + k * nY)
        dieZ = torch.where(refl, refZ, eta * iZ + k * nZ)
        die_off = torch.where(refl, torch.full_like(k, _EPSILON), torch.full_like(k, -_EPSILON))

        is_lam = kind == 0
        is_mir = kind == 1
        out_dx = torch.where(is_lam, lamX, torch.where(is_mir, refX, dieX))
        out_dy = torch.where(is_lam, lamY, torch.where(is_mir, refY, dieY))
        out_dz = torch.where(is_lam, lamZ, torch.where(is_mir, refZ, dieZ))
        off = torch.where(is_lam | is_mir, torch.full_like(k, _EPSILON), die_off)

        ox = torch.where(active, px + off * nX, ox)
        oy = torch.where(active, py + off * nY, oy)
        oz = torch.where(active, pz + off * nZ, oz)
        dx = torch.where(active, out_dx, dx)
        dy = torch.where(active, out_dy, dy)
        dz = torch.where(active, out_dz, dz)
        tr = torch.where(active, tr * alb_r, tr)
        tg = torch.where(active, tg * alb_g, tg)
        tb = torch.where(active, tb * alb_b, tb)

    if style == "standard":
        rr = torch.where(active, rr + cr, rr)
        rg = torch.where(active, rg + cg, rg)
        rb = torch.where(active, rb + cb, rb)
    return torch.stack([rr, rg, rb], dim=-1)
