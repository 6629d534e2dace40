"""BVH traversal, vectorized over ray batches (mirror of
``rvpt_tpu/ops/traverse.py``): the CPU oracle of the BVH search.

The reference's per-thread stack walk (assets/shaders/intersection.glsl:
361-463) in lockstep: every ray keeps its own 64-entry stack in an
[N, 64] tensor and all rays advance together in one Python loop until
every lane is done; a leaf's triangles run as a masked fixed-trip loop over
the tree's largest leaf (2-8 primitives, bvh_builder.h:45-50).  Node ids
and stack entries are int64 with sentinel -1 (the reference's u32 ~0,
intersection.glsl:371).  The left child is visited first and a hit needs a
strictly smaller t, as in the JAX walk, so the two agree hit for hit.  The
kernels walk the same tree one thread per ray (``csrc/bvh_search.cuh``).
"""

from __future__ import annotations

import torch

from .intersect import INF, _safe_div, triangle_isect_single

STACK_DEPTH = 64  # reference: intersection.glsl:363
SENTINEL = -1  # bottom-of-stack marker (the reference uses ~0)


def _walk(scene, bvh, origin, direction, mint, maxt, any_hit):
    """The lockstep walk: (t_best f32[N], i_best int64[N], found bool[N]).
    ``any_hit`` stops a lane at its first valid hit
    (intersect_bvh_any's early return, intersection.glsl:417-463)."""
    n = origin.shape[0]
    dev = origin.device
    max_leaf = int(bvh.max_leaf)
    n_tri = scene.num_triangles
    node_first = bvh.first.to(torch.int64)
    node_count = bvh.count.to(torch.int64)
    inv_d = _safe_div(torch.ones_like(direction), direction)
    lane = torch.arange(n, device=dev)

    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    stack = torch.full((n, STACK_DEPTH), SENTINEL, dtype=torch.int64, device=dev)
    ptr = torch.ones((n,), dtype=torch.int64, device=dev)  # slot 0: the sentinel
    t_best = torch.full((n,), INF, device=dev)
    i_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)

    while not bool(done.all()):
        nsafe = torch.clamp(node, 0, node_first.shape[0] - 1)
        first = node_first[nsafe]
        count = node_count[nsafe]
        f = (bvh.bmax[nsafe] - origin) * inv_d
        nr = (bvh.bmin[nsafe] - origin) * inv_d
        t1 = torch.amin(torch.maximum(f, nr), dim=-1)
        t0 = torch.amax(torch.minimum(f, nr), dim=-1)
        far = torch.clamp(t1, max=maxt) if any_hit else torch.minimum(t1, t_best)
        box_hit = (far >= torch.clamp(t0, min=mint)) & ~done
        is_leaf = count > 0

        for k in range(max_leaf):
            tri = torch.clamp(first + k, 0, n_tri - 1)
            active = box_hit & is_leaf & (k < count)
            if any_hit:
                active = active & ~found
            t, u, v, _ = triangle_isect_single(
                origin, direction, scene.tri_v0[tri], scene.tri_v1[tri],
                scene.tri_v2[tri])
            limit = torch.full_like(t, maxt) if any_hit else torch.clamp(t_best, max=maxt)
            valid = (active & (mint < t) & (t < limit) & (u > 0.0) & (v > 0.0)
                     & (u + v < 1.0))
            if any_hit:
                found = found | valid
            else:
                t_best = torch.where(valid, t, t_best)
                i_best = torch.where(valid, tri, i_best)
        if any_hit:
            done = done | found

        # Interior hit: descend into the left child, push the right sibling.
        descend = box_hit & ~is_leaf
        if any_hit:
            descend = descend & ~done
        slot = torch.clamp(ptr, 0, STACK_DEPTH - 1)
        stack[lane, slot] = torch.where(descend, first + 1, stack[lane, slot])
        ptr = torch.where(descend, ptr + 1, ptr)
        # A miss or a finished leaf: pop.
        pop = ~done & ~descend
        pop_ptr = torch.clamp(ptr - 1, min=0)
        popped = stack[lane, pop_ptr]
        node = torch.where(descend, first, torch.where(pop, popped, node))
        ptr = torch.where(pop, pop_ptr, ptr)
        done = done | (pop & (popped == SENTINEL))
    return t_best, i_best, found


def closest_hit_bvh(scene, bvh, origin, direction, mint, maxt):
    """Closest triangle hit via the BVH: (t f32[N], inf on a miss; idx
    int64[N], -1 on a miss, into the leaf-ordered triangle arrays)."""
    t_best, i_best, _ = _walk(scene, bvh, origin, direction, mint, maxt, False)
    return t_best, torch.where(torch.isfinite(t_best), i_best, -1)


def any_hit_bvh(scene, bvh, origin, direction, mint, maxt):
    """Occlusion query with per-lane early exit: bool[N]."""
    return _walk(scene, bvh, origin, direction, mint, maxt, True)[2]
