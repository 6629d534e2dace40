"""Hand-paired forward/backward for the Kajiya path tracer (mirror of
``rvpt_tpu/ops/fast_grad.py``).

``make_fast_kajiya`` builds a ``torch.autograd.Function`` that pairs

  forward   = the whole-path tracer with records (K1 in collect mode on the
              card, ``trace_plain`` on the CPU): radiance plus, per bounce,
              the 13 bounce-input fields and the (family, index) hit;
  backward  = the whole-chain pullback from that record (K2 on the card,
              ``bwd_plain`` on the CPU): cotangents of the ray origins and
              directions and of the 10 differentiable scene leaves.

That is the "pallas" route of the JAX package (up to 1,024 triangles, with
or without a BVH).  Its "soa" route, for big meshes and larger scenes,
pairs the tracer with hit records (K1's hits-only collect instance, in its
BVH form on a BVH scene, one launch per trace) with autograd through
``ops.replay_soa.kajiya_replay_soa`` on the recorded hits, whose
triangle-table lookups run the gather and segment-sum kernels (B7) on the
card.

``kajiya_from_hits`` is the differentiable replay from hit records through
``isect_from_hit``: the oracle both are held against.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.math import normalize
from ..core.types import Ray
from ..models import brdf
from ..models.integrators import _bounce_rands, _sky
from ..scene.materials import gather
from .intersect import isect_from_hit
from .pathkernel import (MAX_BWD_TRIANGLES, PathTracer, _pixels, _raster, bwd_path,
                         is_bigmesh, scene_grads_from_tables)
from .replay_soa import kajiya_replay_soa

SCENE_LEAVES = ("tri_v0", "tri_v1", "tri_v2", "sph_center", "sph_radius",
                "pln_normal", "pln_d")
MATERIAL_LEAVES = ("albedo", "emission", "ior")


def kajiya_from_hits(scene, ray, pixel, frame, salt_base, fams, idxs,
                     style="reference"):
    """Differentiable replay of a Kajiya trace given per-bounce hit records
    ``fams``/``idxs`` int64[B, N] (``PathTracer.hits_from_record``).
    Returns radiance f32[N, 3]; matches the tracer up to rounding and is
    differentiable with respect to the scene and the rays."""
    n = ray.origin.shape[0]
    dev = ray.origin.device
    o, d = ray.origin, ray.direction
    col = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    thr = torch.ones((n, 3), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    result = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    zero3 = torch.zeros_like(col)
    for bounce in range(fams.shape[0]):
        fam, idx = fams[bounce], idxs[bounce]
        isect = isect_from_hit(scene, Ray(o, d), fam, idx, mint=0.0)
        hit = fam >= 0
        miss_now = active & ~hit
        sky = _sky(d, half_shift=True)
        result = result + torch.where(miss_now[:, None], col + thr * sky, zero3)
        active = active & hit

        mat = gather(scene.materials, isect.mat)
        col = col + torch.where(active[:, None], thr * mat.emission, zero3)

        dir_in = normalize(d)
        u, v, w = _bounce_rands(pixel, frame, salt_base, bounce)
        pos_out, dir_out, fac = brdf.shade_and_scatter(
            isect.pos, isect.normal, dir_in, mat, u, v, w)
        a3 = active[:, None]
        thr = torch.where(a3, thr * fac, thr)
        o = torch.where(a3, pos_out, o)
        d = torch.where(a3, dir_out, d)
    if style == "standard":
        result = result + torch.where(active[:, None], col, zero3)
    return result


def _scene_leaves(scene):
    return ([getattr(scene, k) for k in SCENE_LEAVES]
            + [getattr(scene.materials, k) for k in MATERIAL_LEAVES])


def _with_leaves(scene, leaves):
    n = len(SCENE_LEAVES)
    mats = dataclasses.replace(scene.materials,
                               **dict(zip(MATERIAL_LEAVES, leaves[n:])))
    return dataclasses.replace(scene, materials=mats,
                               **dict(zip(SCENE_LEAVES, leaves[:n])))


class _PathTrace(torch.autograd.Function):
    """Radiance f32[N,3] of the whole-path tracer; backward = the
    whole-chain pullback of its record."""

    @staticmethod
    def forward(ctx, spec, scene, pixel, frame, salt, origin, direction,
                *leaves):
        salt_base, max_bounces, style = spec
        s = _with_leaves(scene, [x.detach() for x in leaves])
        (r, g, b), record = PathTracer(s).trace(
            pixel, origin.detach(), direction.detach(), frame, salt_base + salt,
            max_bounces, style=style, collect_states=True)
        ctx.spec, ctx.scene, ctx.record = spec, s, record
        ctx.pixel, ctx.frame, ctx.salt = pixel, frame, salt
        return torch.stack([r, g, b], dim=-1)

    @staticmethod
    def backward(ctx, g):
        salt_base, _, style = ctx.spec
        pixel = ctx.pixel if isinstance(ctx.pixel, torch.Tensor) else None
        gtabs, go, gd = bwd_path(ctx.scene, ctx.record, ctx.frame, g,
                                 salt_base + ctx.salt, style, pixel)
        grads = scene_grads_from_tables(ctx.scene, gtabs)
        leaf_grads = [grads[k] for k in SCENE_LEAVES + MATERIAL_LEAVES]
        return (None, None, None, None, None, go, gd, *leaf_grads)


class _SoaTrace(torch.autograd.Function):
    """Radiance f32[N,3] of the tracer with hit records (K1's hits-only
    collect instance, in its BVH form on a BVH scene, a big mesh
    included); backward = autograd through the SoA replay from those
    records (``ops.replay_soa``)."""

    @staticmethod
    def forward(ctx, spec, scene, pixel, frame, salt, origin, direction,
                *leaves):
        salt_base, max_bounces, style = spec
        s = _with_leaves(scene, [x.detach() for x in leaves])
        o, d = origin.detach(), direction.detach()
        (r, g, b), (fams, idxs) = PathTracer(s).trace(
            pixel, o, d, frame, salt_base + salt, max_bounces, style=style,
            collect_hits=True)
        ctx.save_for_backward(o, d, fams, idxs, *leaves)
        ctx.spec, ctx.scene, ctx.pixel, ctx.frame, ctx.salt = (
            spec, s, pixel, frame, salt)
        return torch.stack([r, g, b], dim=-1)

    @staticmethod
    def backward(ctx, g):
        salt_base, _, style = ctx.spec
        o, d, fams, idxs, *leaves = ctx.saved_tensors
        want = ctx.needs_input_grad[5:]
        if not any(want):
            return (None,) * (5 + len(want))
        inputs = [x.detach().requires_grad_(w) for x, w in zip((o, d, *leaves), want)]
        with torch.enable_grad():
            out = kajiya_replay_soa(
                _with_leaves(ctx.scene, inputs[2:]), inputs[0], inputs[1],
                _raster_ids(ctx.pixel, o.device), ctx.frame, salt_base + ctx.salt,
                fams, idxs, style)
            wrt = [x for x, w in zip(inputs, want) if w]
            got = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
        grads = [next(got) if w else None for w in want]
        return (None, None, None, None, None, *grads)


def _raster_ids(pixel, dev):
    """int64[N] pixel ids of a ``pixel`` argument (a tensor, or an int N for
    the raster ids 0..N-1)."""
    n, pix = _pixels(pixel)
    return _raster(pix, n, dev)


def make_fast_kajiya(scene_template, salt_base: int, max_bounces: int,
                     style: str = "reference", backward: str = "auto"):
    """Build the paired Kajiya trace for scenes with this template's
    static shape.  Returns ``trace(scene, origin, direction, pixel, frame,
    salt=0) -> f32[N,3]``; ``pixel`` is an int64[N] tensor of pixel ids or
    an int N for the raster ids 0..N-1, ``salt`` an int added to
    ``salt_base``.  Gradients flow to ``origin``/``direction`` (so camera
    parameters train through ``generate_rays``) and to the 10
    differentiable scene leaves.

    ``backward`` selects the pullback (``make_fast_kajiya`` :73):
      - "pallas": the whole-chain pullback of K1's record (K2 on the card),
        for scenes of at most 1,024 triangles (``MAX_BWD_TRIANGLES``),
        without a BVH or in K1's BVH form;
      - "soa": autograd through the SoA replay of the hit records
        (``ops.replay_soa``: on the card its triangle lookups run the
        gather and segment-sum kernels), from K1's hits-only collect
        instance (its BVH form on a BVH scene, big meshes included);
      - "auto": the JAX rule (:106-109): "soa" for a big mesh
        (``pathkernel.is_bigmesh``), else "pallas" up to 1,024 triangles
        and "soa" past them."""
    if backward not in ("auto", "pallas", "soa"):
        raise ValueError(f"unknown backward {backward!r}")
    bigmesh = is_bigmesh(scene_template)
    if backward == "auto":
        backward = ("soa" if bigmesh
                    or scene_template.num_triangles > MAX_BWD_TRIANGLES
                    else "pallas")
    if backward == "pallas" and bigmesh:
        raise ValueError("the kernel pullback serves no big mesh "
                         f"({scene_template.num_triangles} triangles, BVH): "
                         "use backward=\"soa\"")
    spec = (int(salt_base), int(max_bounces), style)
    paired = _PathTrace if backward == "pallas" else _SoaTrace

    def trace(scene, origin, direction, pixel, frame, salt=0):
        leaves = _scene_leaves(scene)
        if not (torch.is_grad_enabled()
                and any(x.requires_grad for x in (origin, direction, *leaves))):
            # Nothing to differentiate: the tracer without records.
            r, g, b = PathTracer(scene).trace(
                pixel, origin, direction, frame, spec[0] + salt, spec[1],
                style=style)
            return torch.stack([r, g, b], dim=-1)
        return paired.apply(spec, scene, pixel, frame, salt, origin, direction,
                            *leaves)

    return trace
