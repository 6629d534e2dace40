"""On-card smoke run of rvpt_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one NVIDIA card (Hopper, sm_90a) and nvcc; there is no CPU path.
Phases, each of which raises on failure:

1. device: the card, its power limit, torch/CUDA/nvcc versions;
2. build: the nine kernel sources (path_kernel K1, bwd_kernel K2,
   closest_hit B8, primary_kernel B3, hart_kernel B4, bigmesh_kernel B5,
   bigmesh_hart B6, replay_lookup B7, camera_rays) from rvpt_tpu_torch/csrc, one nvcc
   each, started together, and the native scene-ingest library (g++);
2b. the row census of K1's and B3's row forms on the 1080p Cornell box
   (4 bounces; AO 4 probes): every search of the Kajiya, Whitted and Cook
   frames and of B3's camera, AO-probe and Appel-shadow searches, counted
   on the card from the plain versions' searches (row_census_hook): per
   kind the live lanes, the warps' SIMD efficiency, the rows the t-first
   reject drops per lane and for whole warps, on occlusion searches the
   rows the any-hit search opens and leaves untested (and its answer
   equal to the closest-hit search's fam >= 0, checked), and the path
   loop's SIMD efficiency; the row-form instances' -Xptxas -v and the
   loops of their SASS (cuobjdump -sass); the bounds of phases 3 and 11
   count these searches' own operations;
3. kernel vs plain: the CUDA kernel against its plain PyTorch version on
   the card, Cornell box at 1920x1080 (rays passed in: 3 bounces, both
   styles, >= 99.5% of pixel channels within 1e-4; rays made in the
   kernel: 4 bounces, standard, per-channel film mean within 1% and
   >= 99.5% of pixel channels within 1e-4), and
   both timed with CUDA events at the display shape;
4. goldens, for the record: the kernel route against
   tests/goldens/cornell_kajiya.png (printed, not asserted: the kernel and
   the XLA path that made the golden round differently);
5. the display slice: Renderer.draw x16 of the Cornell box at 1920x1080,
   4 bounces, style standard, through the kernel (its launch count must
   rise by exactly 16), then save_image;
6. records: K1 with collect at 1080p x 4 bounces (rays passed in) gives
   radiance equal to K1 without it, and records that agree with
   trace_plain's (>= 99.5% of ray-bounce hits equal, >= 99.5% of fields
   within 1e-4);
7. K2 against bwd_plain on the same kernel record, with g = 1/(3N) (the
   mean loss) and a seeded g at that scale: per-ray o/d cotangents, in
   units of g's scale, >= 99.5% within rtol 1e-4, atol 1e-6, over all
   entries and over those the plain version makes non-zero (at least 0.1%
   of them); the 24 table columns within rtol 1e-3, atol 1e-7 (f32 sums of
   2M terms in other orders); timed beside its bound (the record's slots
   counted by kind: dead, miss, triangle, sphere or plane hit, dielectric),
   with the distinct family and material rows per warp at each bounce;
8. B8 against closest_hit_triangles on 1080p camera rays and bounced rays:
   index equal on >= 99.9%, t within rtol 1e-5 where they agree;
9. the headline step (bench.py:63-90 on the port): value and gradient of
   the mean image over trainable_params (albedo, emission) through
   make_fast_kajiya, one K1 and one K2 launch per step, gradients finite,
   non-zero and within rtol 2e-2, atol 1e-5 of autograd through
   integrator_kajiya (which runs B8), and the camera's translation and fov
   gradients of the same loss within rtol 2e-2, atol 1e-7; timed over 10
   steps;
10. the trainer, the setup of examples/inverse_rendering.py at 1920x1080:
   target = mean of 8 render_sample_chw frames (B8), init albedo 0.5 and
   emission x 0.25, recover(steps=50, learning_rate=3e-2); the loss stays
   finite and the mean absolute albedo and emission errors fall.  This
   slice's main path: the launch counts are zeroed before it and read
   after it, and each of the three kernels must have run;
11. the other integrators' kernels against their plain versions on the
   1080p Cornell box, camera rays made in the kernels: B3 in modes 0-6 (AO
   with 4 probes) and K1's Whitted and Cook forms (4 bounces, standard),
   bit for bit; each timed with CUDA events (the plain version over 1-2
   iterations) beside its bound (the row searches' own work, phase 2b;
   closest_hit_bound_ms, closest-hit searches without the reject, beside
   it); then (11b) K1's and B3's row forms bit for bit on the Cornell box,
   sphere_plane and hart_soup's 600- and 1,000-triangle soups with a
   pinhole, an ortho and a spherical camera (Kajiya, Whitted, Cook, the
   full and hits-only collect instances, modes 0-6; the plain versions on
   every 4th, the soups' every 16th, row of pixel ids), the soups' Kajiya
   and AO frames timed; B4 bit for bit
   on the 1080p Cornell box, rabbit at 1024x512 and a 600-triangle soup
   (two staged chunks; every 8th row), its counting instance
   (count_hart_sweep) with the same film, no skipped triangle below the
   running minimum and no stop after an escape, timed beside the bound of
   its own work and the parent's full sweep; sphere_plane 32/31;
12. goldens, for the record: the kernel route against the 10 analytic
   goldens of the other integrators (printed, not asserted, as phase 4);
13. this slice's main path: one split frame (AO, Whitted, Hart, Kajiya) of
   render_sample_fast_chw at 1920x1080 against the plain versions of its
   quadrants' kernels on the same pixel ids (B3 and K1 >= 99.5% of
   channels within 1e-4, B4 bit for bit; the quadrants must reproduce
   _mode_masks), each quadrant's kernel pass timed on its pixel ids
   (CUDA events), then Renderer.draw x16 with that split-screen, 4
   bounces, standard: the
   launch counts are zeroed before it and read after it, and must show one
   B3, one B4 and two K1 launches per frame; the film is finite and not
   black and save_image writes it; then Renderer.draw x8 in each single
   mode 0-8 and 10, each with its own zeroed counts and its ms/frame;
14. BVH ingest: rabbit, mesh_demo(3), mesh_demo(5) and terrain_demo(225)
   built on the card's host, with the builder that ran, the build time,
   the node count and max_depth; validate holds for each tree;
15. the mesh kernels against their plain versions on the card: K1's BVH
   form on rabbit at 1024x512 x 8 bounces and B3's in modes 0-6 (AO with 4
   probes), B5's bounce (8 bounces) and search-only instances on
   mesh_demo(3) at 1920x1080, and on mesh_demo(5) and terrain_demo(225)
   with the plain version on every 8th (16th) row of pixel ids (the RNG
   keys by the global id, so the subsample is an exact check), one step
   of B6's per-step instance on mesh_demo(5) (march step 4, live lanes,
   every 8th row), and B6's march, the whole 1080p Hart march in one
   launch, against bigmesh_march_plain on every 64th row (the plain march
   runs 32 brute-force steps): >= 99.5% of channels within 1e-4, B6 >=
   99% (bit-identity printed); each timed with CUDA events beside its
   bound, which counts the walks' node and triangle tests on this run's
   data with the kernels' counting instances (count_bvh_walk,
   count_hart_walk; for the march count_hart_march's warm-started walk up
   to each ray's escape or stop, the parent's work, the cold-start walk of
   every step, printed beside it); then the big-mesh route, one K1 or B3
   BVH-form launch per frame on rays passed in (BigMeshTracer), in modes
   0-9 at 1080p x 8, standard, on mesh_demo(5) and terrain_demo(225), and
   on rabbit at 1024x512 x 8: bit for bit B5's per-bounce route
   (BigMeshTracer.search and .bounce, the binary walk) on the whole film
   and its plain composition (bigmesh_bounce_plain, bigmesh_search_plain
   and the shading between) on every 8th (16th, 4th) row of pixel ids;
   both routes timed, the launch beside its bound (this frame's searches,
   the redesigned walk's own tests and the shading, counted on the card;
   walk_bounds) with the binary walk's bound beside it (not the bound,
   comparable with the bounds before the walk's redesign), and the walk
   census of every search (census_hook: per kind of search the binary
   walk's node and triangle tests and its warps' SIMD efficiency, the
   redesigned walk's, and its any-hit walk's on occlusion searches);
16. this slice's main path: Renderer.draw x8 at 1920x1080, 8 bounces,
   standard, Kajiya on mesh_demo(5) and mesh_demo(3) (one K1 launch per
   frame), rabbit at 1024x512 x 8 (one K1 launch per frame) and in modes
   0-6 (one B3 launch per frame), on mesh_demo(5) each single mode 0-8 and
   10 (one B3 launch per mode 0-6 frame, one K1 launch per Whitted or Cook
   frame, Hart one B6 march launch; no B5 launch in any draw) and the
   split-screen (AO, Whitted, Hart, Kajiya), terrain_demo(225) x2; every loop with zeroed counts,
   a finite film that is not black, and its ms/frame; then the
   rabbit_kajiya and mesh2_kajiya goldens through the kernels (printed,
   not asserted, as phase 4); the camera-ray kernel's launches counted in
   every loop (one per single-mode big-mesh frame);
16b. the camera-ray kernel (csrc/camera_rays.cu) against the plain
   arithmetic it replaces (camera_rays_plain, under interpret_kernels) on
   the card: mesh_demo(5)'s camera at 1920x1080 on the raster ids and on
   each split-screen quadrant's id tensor, the display's reciprocal
   multiply and the trainer's division, with no differing bit; the
   kernel's and the plain version's device time (profiler), on the raster
   ids and on an id tensor, the bound of 24 B written per ray (32 B with
   ids) at the HBM rate beside them, and the wall per call of the route
   and of the plain version;
17. B7 against its plain versions: the gather (bit for bit) and the
   segment sum (within rtol 1e-5, atol 1e-5 of the float64 sum, in units
   of the cotangent's scale, in two calls) on mesh_demo(5)'s triangle
   tables at the 2,073,600 indices its 1080p replay reads at bounce 2, and
   on a 140,000-row table at 2,073,600 pixel-coherent ids; each timed
   beside its plain version, the PyTorch call (index_select, index_add_)
   and its bound, the segment sum's memset, summing kernel and rounding
   pass timed apart (torch.profiler), and its ids' rows counted (distinct
   rows per warp and per chunk of 2,048 and 8,192 rays, the chunks' row
   spans);
18. records: K1's BVH form with records on rabbit at 1024x512 x 8 (rays
   in), K1's hits-only collect instance on the Cornell box (row form,
   1080p x 4), rabbit, mesh_demo(5) and terrain_demo(225) (1080p x 8,
   every 8th (16th) row of pixel ids for the plain version; the BVH
   scenes' hits also bit for bit B5's collect instance bounce by bounce
   on the whole film), and B5's collect instance on mesh_demo(5)
   at 1080p x 8 (every 8th row): bit-identical to trace_plain's (the
   hits-only instance also to the full collect instance's rec_i) and
   bigmesh_bounce_plain(collect=True)'s, the radiance and states those of
   the instances without records; each timed beside its bound;
19. this slice's main path: one fwd+bwd step of the mean image over
   albedo, emission and the vertices through make_fast_kajiya on
   mesh_demo(3) and on mesh_demo(5) at 1920x1080 x 8, standard, with the
   launch counts zeroed before it and read after it (one K1 hits-only
   collect launch, 8 gathers, 7 segment sums, no B5); the primal bit-identical to the
   tracer without records, the gradients within rtol 1e-3, atol 1e-6 (in
   units of each gradient's scale) of autograd through kajiya_from_hits
   in float64 on the same records; the step time (CUDA events over 5 steps
   after 2)
   and its peak memory; and on mesh_demo(3) at 320x180 the gradients
   within rtol 2e-2, atol 1e-5 (in units of their scale) of autograd
   through integrator_kajiya; and the step's 7 segment sums: their ids'
   rows counted as in phase 17, their device time inside the step
   (torch.profiler);
20. rabbit at 1024x512 x 8: the step through "auto" (K1's BVH-form
   records, then K2) and through "soa" (records, then the replay with B7),
   each against autograd through kajiya_from_hits as in phase 19;
21. the trainer on mesh_demo(3) at 1920x1080 x 8: target = mean of 4
   kernel-route frames, init albedo 0.5 and emission x 1.2,
   recover(steps=30, learning_rate=3e-2) with zeroed counts (two K1
   launches, a trace and a hits-only collect, and one replay's 8 gathers
   per step, no B5); the loss and both mean parameter errors fall;
22. K1's stats form: PathTracer.trace(stats=True) on rabbit at 1024x512 x 8
   and mesh_demo(3) at 1920x1080 x 8, camera rays passed in, Kajiya,
   Whitted and Cook, with the counts zeroed before the six traces and
   read after them (six launches of the counting instance, no other K1
   launch); then for each the radiance bit for bit that of K1 without
   stats, the per-tile (listed, processed, still passed) counters equal
   to the plain version's (cull_stats_hook on the card) on >= 99% of
   every 8th tile, processed == listed, still <= listed, and both
   launches timed beside the bound of this run's data (K1's work plus the
   stats walk's root, cluster-box and triangle tests);
23. this slice's main path, the CLI in-process through cli.main(argv) at
   1920x1080 with --stats: Cornell 16 frames x 4 bounces standard, Cornell
   --bvh 8 frames with --debug-view bvh, the split-screen (AO, Whitted,
   Hart, Kajiya) 8 frames, mesh:5 x 8 bounces 8 frames with --checkpoint,
   then --resume of it for 4 more (the film reaches frame 12); the counts
   zeroed before each run and read after it (K1 row form, K1 BVH form,
   B3 + K1 + B4, and K1 on mesh:5 must each have run), ms/frame and rays/s of each
   run from --stats, every PNG of the right shape and not black;
24. the viewer, headless: Viewer(Renderer, backend=callable) x32 steps on
   the 1080p Cornell box, a scripted W press at step 16 moves the camera
   and accumulation restarts (film.frame back to 1); ms/step;
25. this slice's main path, the sharded path (parallel/): (a) world 1
   under NCCL in this process (initialize_distributed on a free localhost
   port, make_mesh(1, 1)): Renderer(mesh=...) x16 of the 1080p Cornell
   Kajiya frame with the counts zeroed before it and read after it (K1
   exactly 16), its film phase 5's bit for bit; a split frame (AO,
   Whitted, Hart, Kajiya) and a mesh_demo(5) Kajiya frame at 1080p x 8
   through render_sample_sharded_fast, and one make_train_step(mesh=...)
   step at 1080p, each bit for bit its unsharded counterpart and timed
   beside it (CUDA events); the collectives' time per frame and per step;
   (b) world 2 on the one card: two spawned processes under gloo on
   cuda:0 (parallel.dryrun.parity_job): a (2, 1) mesh's 1080p Cornell
   Kajiya sample bit for bit the unsharded one, a (1, 2) mesh's within
   atol 1e-6 of the two salt streams' mean, a (2, 1) fast train step's
   parameters equal on both ranks and within rtol 1e-5 of the unsharded
   step's, each rank's K1 launches; the process group destroyed after;
26. the examples (rvpt_tpu_torch/examples) at the JAX examples' sizes:
   inverse_rendering, geometry_recovery and camera_pose_recovery in this
   process (the mean albedo and emission errors and the radius error below
   their start; the pose within 5e-3),
   multihost_render as two `python -m` processes under gloo on the card,
   its PNG the single-process render's bit for bit.

Prints the kernel record as a JSON line (launches of the main paths:
the trainer for K1, K2, B8 and the camera rays (two per step, counted
over phase 10's recover), the mesh_demo(5) Kajiya draws of phase 16 for
the camera rays too, the split-screen draws for B3 and B4, the
rabbit draws for K1's and B3's BVH forms, the mesh_demo(5) draws for the
big-mesh route's K1 and B3 launches and B6's march, the mesh_demo(3)
fwd+bwd step for B7 and K1's hits-only collect instance, the rabbit step
for K1's BVH-form records, the stats traces of phase 22 for the counting
instance; B5, on no main path, with the launches of its own checks in
phases 15 and 18; times, bounds and errors of this run; every K1 and B3
BVH-form row says what its walk's redesign is; K1's launches in the
sharded draws of phase 25), a JSON line of the CLI runs and the viewer,
a JSON line of phases 25 and 26, the
card's name and power limit, then, last, one JSON line {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters):
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


# Operations per unit of work, counted from the kernels' code (every FP32
# add, multiply, compare, divide, square root, sin/cos and rsqrt as one
# operation, and PCG3D's integer operations at the same rate: a lower bound
# on the time).  Per ray-bounce: one metric-tensor triangle test (6 dot
# products 30, t 3, barycentrics 14, tests 6), one sphere test, one plane
# test, the Kajiya shading of a hit (normals, Fresnel, three candidate
# directions, sin/cos, state update) and one PCG3D draw with its three
# unit conversions; per ray: the camera ray (PCG3D, film coordinates, the
# pinhole direction and its normalization).  K2 per live ray-bounce: the
# winner's geometry and shading recomputed plus their adjoint.
OPS_TRI, OPS_SPH, OPS_PLN = 53, 40, 15
OPS_SHADE, OPS_PCG, OPS_CAMERA = 120, 33, 69
# K2 per slot of the record, by kind of lane (csrc/bwd_kernel.cu, counted
# from its code): a dead slot tests its active flag (1); a miss adds the
# sky's pullback (28); a hit recomputes its winner's t and normal
# (triangle 33, sphere 46, plane 16) and the shading's forward (44), runs
# the shading's reverse for a Lambert or mirror hit (93) and the
# geometry's (triangle 89, sphere 87, plane 46), and tests its two row
# gradients for the warp's row groups (16); a dielectric hit adds the
# Fresnel draw and the refraction's reverse (96).
OPS_BWD = {"dead": 1, "miss": 28, "tri": 33 + 89, "sph": 46 + 87, "pln": 16 + 46}
OPS_BWD_HIT, OPS_BWD_GLASS = 44 + 93 + 16, 96
# K1 per lane that does not scatter: a Whitted Lambert hit (emission 6,
# hit point 6, normal and view normalized 20, facing 10, shadow origin 6,
# the shadowed sum 3; its shadow search is counted as a search), and a
# lane that ends on the sky or on Cook's emission (3 per channel, the
# cheaper of the two).  trace_plain(work=...) counts each kind of lane.
OPS_LAMBERT, OPS_END = 51, 9
# B3 per pixel, each mode's finalize as its kernel instance runs it: the
# hit test and normalized normal (11), then depth's rsqrt, max and divide
# (9), normal's 3 x (mul, mul, add) (9), Utah's facing, light and sky
# (22), AO's and Appel's view direction, facing and offset point (31),
# AO's average (2) and Appel's light (7); per AO probe its cosine
# direction and count (16, and a PCG3D draw).  B4 per live
# ray-step-triangle: the iq distance on its cheaper face branch (edges 27,
# cross product 9, three edge signs 48, their test 3, the face distance
# 13, the min 1) and per live ray-step its square root, test and advance.
OPS_FINALIZE = {0: 11, 1: 11, 2: 20, 3: 20, 4: 33, 5: 44, 6: 49}
OPS_PROBE = 16
OPS_HART_TRI, OPS_HART_STEP = 92, 8
# B4's full distance on its edge branch as the parent computed it: the
# face branch's set-up and signs (78) and three clamped edge distances
# (|e|^2 6, projection 8, residual and its square 11: 75), and the min.
OPS_HART_TRI_EDGE = 156
# B4 since its redesign, per unit of work its counting instance counts:
# a skip test, its plane half (p - a, dn, the bound and its test: 13) and
# sphere half (11); a full distance from the staged invariants on the face
# branch (p - b, p - c, three signs and their test, dn^2 / |nor|^2: 32) or
# the edge branch (the signs 30, three edge distances 57, the min 2); a
# warm seed's p - a and dn (8); per live ray-step of its own the escape
# test (15), the reach of the minimum (9), the square root, stop test and
# advance (8).
OPS_HART_TEST, OPS_HART_SPHERE = 13, 11
OPS_HART_FACE, OPS_HART_EDGE, OPS_HART_SEED, OPS_HART_OWN_STEP = 32, 89, 8, 32
# The BVH walk (csrc/bvh_search.cuh) per search: the reciprocal direction
# (9); per node slab test: 6 differences, 6 products, the entry's 6 and the
# exit's 5 min/max, the two tests (25); per triangle the metric-tensor test
# and its (t, index) tie rule (56).  B6 per node: the box distance (6
# differences, 6 max, 3 products, 2 sums, the test: 18); per triangle the
# iq distance and the min (93); per live point its square root and store.
OPS_INV, OPS_BOX, OPS_WALK_TRI = 9, 25, 56
# K1's and B3's redesigned walk (csrc/bvh_walk.cuh) per triangle row it
# opens: the t part (two dot products 10, the numerator, safe denominator
# and division 5, the (t, index) rule 2, mint < t: 18); a row that passes
# the t-first reject runs the rest of the 56.  Its node tests are the
# binary walk's 25.
OPS_ROW_T = 18
OPS_HBOX, OPS_HTRI, OPS_HPOINT = 18, OPS_HART_TRI + 1, 2
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): FP32
# outside the tensor cores and HBM3 bandwidth.
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12


def bound(bytes_moved, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the FP32 rate."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_ops(work, ops_search):
    """K1's operations on one run's data, from trace_plain's ``work``
    counts of the same inputs: every search of a live lane, the scatter
    shading and draw of every hit that scatters, and the cheaper tails of
    Whitted's Lambert hits and of the lanes that end."""
    return (work["search"] * ops_search
            + work.get("scatter", 0) * (OPS_SHADE + OPS_PCG)
            + work.get("lambert", 0) * OPS_LAMBERT + work.get("end", 0) * OPS_END)


def walk_ops(work):
    """Operations of the BVH walks counted in ``work`` (count_bvh_walk's
    "box"/"tri", count_hart_walk's "hart_box"/"hart_tri")."""
    return (work.get("box", 0) * OPS_BOX + work.get("tri", 0) * OPS_WALK_TRI
            + work.get("hart_box", 0) * OPS_HBOX + work.get("hart_tri", 0) * OPS_HTRI)


def own_walk_ops(own):
    """Operations of the redesigned walk's own tests (census_summary's
    "own": node slab tests, rows opened, rows tested in full)."""
    return (own["box"] * OPS_BOX + own["tri"] * OPS_ROW_T
            + own["full"] * (OPS_WALK_TRI - OPS_ROW_T))


def walk_bounds(bytes_moved, ops, work, own):
    """The bound of a K1 or B3 BVH-form launch: ``ops``, its operations
    but the walk's, plus the redesigned walk's own tests on this run's
    rays (census_summary's "own": any-hit on occlusion searches, each row
    opened at its t part, in full only past the t-first reject) ->
    {bound_ms, bound_by}; and beside it, not the bound, the same with the
    binary walk's tests (``work``'s "box" and "tri", count_bvh_walk), the
    bound as counted before the walk's redesign, whose share compares with
    the earlier runs' -> {binary_walk_bound_ms, binary_walk_bound_by}."""
    bnd, by = bound(bytes_moved, ops + own_walk_ops(own))
    b_bnd, b_by = bound(bytes_moved, ops + walk_ops(work))
    return dict(bound_ms=bnd, bound_by=by, binary_walk_bound_ms=b_bnd,
                binary_walk_bound_by=b_by)


def bounds_text(b, ms, work, own):
    """walk_bounds' two bounds beside a time, for a printed line."""
    return (f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} (the redesigned walk's own "
            f"tests: {own['box']} nodes, {own['tri']} rows opened, {own['full']} in "
            f"full), kernel at {b['bound_ms'] / ms:.1%} of it; the binary walk's bound, "
            f"not the bound: {b['binary_walk_bound_ms']:.4f} ms by "
            f"{b['binary_walk_bound_by']} ({work.get('box', 0)} nodes, "
            f"{work.get('tri', 0)} triangles), {b['binary_walk_bound_ms'] / ms:.1%}")


def walk_counter(tables, counts, nodes, work):
    """An ``on_search`` hook for the plain versions (or a call per search):
    counts the BVH walk's node and triangle tests on the search's rays with
    the kernels' counting instance, into ``work["box"]`` and
    ``work["tri"]``."""
    import torch

    from rvpt_tpu_torch.ops import pathkernel as pk

    def on_search(o3, d3, live=None):
        if live is None:
            live = torch.ones_like(o3[0], dtype=torch.bool)
        box, tri = pk.count_bvh_walk(tables, counts, nodes, (*o3, *d3), live)
        work["box"] = work.get("box", 0) + box
        work["tri"] = work.get("tri", 0) + tri

    return on_search


# The kinds of search whose answer is only whether something is hit: K1's
# and B3's BVH forms run them as any-hit walks (csrc/bvh_walk.cuh).
OCCLUSION = ("shadow", "probe")


def search_kind(mode, k):
    """The kind of the ``k``-th search of a frame of integrator ``mode``, in
    the order trace_plain, primary_plain and the per-bounce route run
    them: the camera search, then AO's probes, Appel's shadow ray, or per
    bounce a bounce search (Cook's tail too) and Whitted's shadow ray."""
    if k == 0:
        return "camera"
    if mode == 5:
        return "probe"
    if mode == 6 or (mode == 7 and k % 2):
        return "shadow"
    return "bounce"


def warp_simd(iters):
    """(sum of the lanes' loop iterations, 32 x the sum over warps of the
    warp's largest) for per-lane iterations, lane i on thread i of the
    launch, 32 to a warp, a lane that is not live at 0: their ratio is
    the warps' SIMD efficiency."""
    import torch

    it = _warps(iters.to(torch.int64))
    return int(it.sum().item()), 32 * int(it.amax(1).sum().item())


WALK_COUNTS = ("box", "tri", "full", "iter")
# What the kernels line says of every K1 and B3 BVH-form instance.
WALK_REDESIGN = ("the BVH walk of csrc/bvh_walk.cuh: any-hit occlusion searches, "
                 "aligned 64-byte triangle rows with a t-first reject (B3's camera "
                 "search in modes 0-3 loads them whole), the child's node row kept, "
                 "each kernel's own stack form (K1 two arrays, B3 one 64-bit entry "
                 "per node); bound_ms counts this walk's own tests, "
                 "binary_walk_bound_ms the binary walk's")


# What the kernels line says of K1's and B3's row-form instances.
ROW_REDESIGN = ("the row search of csrc/scene_search.cuh: triangle rows staged as four "
                "aligned float4 (128-bit broadcasts), any-hit occlusion searches "
                "(Whitted's and Appel's shadow rays, AO's probes), the t-first reject in "
                "those and in the closest-hit searches of B3 and of K1's Whitted and "
                "Cook; bound_ms counts its own tests (row census, phase 2b), "
                "closest_hit_bound_ms closest-hit searches without the reject")


# What the kernels line says of K1's counting instances and of B8.
STATS_REDESIGN = ("the counting walk of csrc/path_kernel.cu (count_clusters): cluster "
                  "boxes staged in shared memory, t-only triangle tests on pack_walk's "
                  "rows with the t-first reject, an exact early exit once the masks are "
                  "full; its path's walk that of csrc/bvh_walk.cuh; bound_ms counts the "
                  "counting walk's own tests (phase 22's census), parent_count_bound_ms "
                  "every row in full")
B8_REDESIGN = ("csrc/closest_hit.cu: rows loaded with 16-byte loads and staged as four "
               "aligned float4 in pack_walk's order, the t-first reject, one stage "
               "for a table of up to 512 rows; bound_ms counts its own tests (phase 8's "
               "census)")


def census_hook(pt, mode, work, census):
    """An ``on_search`` hook for a frame of ``mode`` on ``pt``'s BVH scene
    (a PathTracer in the BVH form), the walk census: per search, the
    binary walk's tests on the card (count_bvh_walk per lane, B5's
    counting instance) into ``work["box"]`` and ``work["tri"]`` (the
    binary walk's bound, walk_bounds), and into ``census[kind]`` (search_kind) the live lanes
    ("searches"), that walk's node tests, triangle tests, iterations and
    its warps' SIMD sums ("old_*"), the redesigned walk's on the same rays
    (count_walk's closest-hit search: "new_*", with the rows opened and
    the rows tested in full) and for an occlusion search its any-hit walk
    ("any_*"), which K1 and B3 run there."""
    import torch

    from rvpt_tpu_torch.ops import pathkernel as pk

    k = [0]

    def add(rec, key, v):
        rec[key] = rec.get(key, 0) + int(v)

    def put(rec, prefix, c, names):
        for name, row in zip(names, c):
            add(rec, f"{prefix}_{name}", row.sum(dtype=torch.int64).item())
        num, den = warp_simd(c[-1])
        add(rec, f"{prefix}_simd_num", num)
        add(rec, f"{prefix}_simd_den", den)

    def on_search(o3, d3, live=None):
        kind = search_kind(mode, k[0])
        k[0] += 1
        if live is None:
            live = torch.ones_like(o3[0], dtype=torch.bool)
        rays = (*o3, *d3)
        rec = census.setdefault(kind, {})
        add(rec, "searches", live.sum().item())
        old = pk.count_bvh_walk(pt.tables, pt.counts, pt.nodes, rays, live, pt.mint,
                                lanes=True)
        add(work, "box", old[0].sum(dtype=torch.int64).item())
        add(work, "tri", old[1].sum(dtype=torch.int64).item())
        put(rec, "old", old, ("box", "tri", "iter"))
        put(rec, "new", pk.count_walk(pt.tables, pt.counts, pt.tree, rays,
                                      live, mint=pt.mint), WALK_COUNTS)
        if kind in OCCLUSION:
            put(rec, "any", pk.count_walk(pt.tables, pt.counts, pt.tree, rays,
                                          live, any_hit=True, mint=pt.mint), WALK_COUNTS)

    return on_search


def census_summary(census):
    """Per search kind of a census_hook run: the searches, and for the
    binary walk ("old"), the redesigned walk's closest-hit search ("new")
    and, on occlusion searches, its any-hit search ("any"), the tests and
    iterations summed over the searches and the warps' SIMD efficiency;
    then "own", the tests the redesigned walk needs in K1 and B3 (any-hit
    on occlusion searches, closest-hit elsewhere, each with the t-first
    reject), summed over the kinds: the walk of every K1 and B3 BVH-form
    bound (walk_bounds)."""
    out, own = {}, dict.fromkeys(WALK_COUNTS, 0)
    for kind, rec in census.items():
        row = {"searches": rec["searches"]}
        for p in ("old", "new", "any"):
            if f"{p}_box" in rec:
                row[p] = {c: rec[f"{p}_{c}"] for c in WALK_COUNTS if f"{p}_{c}" in rec}
                row[p]["simd"] = rec[f"{p}_simd_num"] / max(rec[f"{p}_simd_den"], 1)
        ran = row["any" if kind in OCCLUSION else "new"]
        for c in WALK_COUNTS:
            own[c] += ran[c]
        out[kind] = row
    out["own"] = own
    return out


def census_text(summary):
    """One line of a census_summary: per kind the searches, the binary
    walk's node/triangle tests and SIMD efficiency, the redesigned walk's
    node tests, rows opened/tested in full and SIMD efficiency (any-hit on
    occlusion searches)."""
    parts = []
    for kind, row in summary.items():
        if kind == "own":
            continue
        o, r = row["old"], row.get("any", row["new"])
        walk = "any-hit" if "any" in row else "closest-hit"
        parts.append(
            f"{kind}: {row['searches']} searches, binary walk {o['box']} nodes "
            f"{o['tri']} triangles SIMD {o['simd']:.3f}; new walk ({walk}) {r['box']} "
            f"nodes, {r['tri']} rows opened, {r['full']} in full, SIMD {r['simd']:.3f}")
    return "; ".join(parts)


# K1's and B3's row form (csrc/scene_search.cuh) per staged triangle row
# it opens: the first float4's two dot products (10), t (3) and the
# t-first reject's two tests (2): 15; a row past the reject runs the rest
# of OPS_TRI (the other four dot products, the barycentrics and the u, v
# tests).
OPS_ROW_TRI_T = 15
OPS_ROW_TRI_REST = OPS_TRI - OPS_ROW_TRI_T
# The searches of a row-form frame whose answer is only whether something
# is hit: the kernels run them as any-hit row searches.
ROW_OCCLUSION = ("whitted shadow", "ao probe", "appel shadow")


def row_kind(what, k, nb):
    """The kind of the ``k``-th search of a row-form frame, in the order
    trace_plain and primary_plain run them: ``what`` a K1 integrator
    ("kajiya", "whitted", "cook") with ``nb`` bounces, or a B3 mode 0-6."""
    if what == "whitted":
        return "whitted shadow" if k % 2 else ("camera" if k == 0 else f"bounce {k // 2}")
    if what == "cook" and k == nb:
        return "cook tail"
    if k == 0:
        return "camera"
    if what in ("kajiya", "cook"):
        return f"bounce {k}"
    return {5: "ao probe", 6: "appel shadow"}[what]


def _warps(x):
    """Per-lane values x[N, ...], lane i on thread i of the launch, as
    [warps, 32, ...] (the lanes past the end at 0)."""
    import torch

    pad = [0, 0] * (x.dim() - 1) + [0, (-x.shape[0]) % 32]
    return torch.nn.functional.pad(x, pad).view(-1, 32, *x.shape[1:])


def row_census_hook(tables, counts, what, nb, census, mint=0.0):
    """An ``on_search`` hook for a row-form frame (trace_plain or
    primary_plain on the card), the row census: per kind of search
    (row_kind) into ``census[kind]`` the live lanes ("searches"), the warps
    with a live lane, the rows a search without the reject tests
    ("rows", T per live lane), the rows the closest-hit search tests in
    full past the t-first reject ("full"), the rows the reject drops for a
    whole warp ("warp_skip", of "warp_rows" = T per warp with a live
    lane); on occlusion searches the any-hit search's rows opened and in
    full ("any_opened", "any_full"), the rows its first acceptance leaves
    untested per lane ("untested") and for a whole warp ("warp_untested",
    in lanes: 32 per warp-row), the warp-rows the warps open (up to their
    slowest lane's first acceptance: "warp_any_opened") and test in full
    (where a lane still searching passes the reject: "warp_any_full"), and
    whether its answer equals the
    closest-hit search's family >= 0 on every lane ("any_equal").  The
    lanes' searches of the path loop (the camera and bounce searches)
    gather in ``census["_loop"]`` for the loop's SIMD efficiency."""
    import torch

    from rvpt_tpu_torch.ops import pathkernel as pk

    tri, sph, pln, _ = pk._unpack_fwd(tables, counts, tri_rows=True)
    n_tri = tri.shape[0]
    k = [0]

    def add(rec, key, v):
        rec[key] = rec.get(key, 0) + int(v)

    def on_search(o3, d3, live=None):
        kind = row_kind(what, k[0], nb)
        k[0] += 1
        if live is None:
            live = torch.ones_like(o3[0], dtype=torch.bool)
        rec = census.setdefault(kind, {})
        lw = _warps(live)
        warps = int(lw.any(1).sum().item())
        add(rec, "searches", live.sum().item())
        add(rec, "warps", warps)
        add(rec, "rows", live.sum().item() * n_tri)
        add(rec, "warp_rows", warps * n_tri)
        if kind not in ROW_OCCLUSION and kind != "cook tail":
            loop = census.setdefault("_loop", torch.zeros_like(live, dtype=torch.int32))
            loop += live.to(torch.int32)
        if n_tri == 0:
            return
        rb = [c[:, None] for c in (*o3, *d3)]
        t, ok = pk._tri_block(tri, *rb, mint)
        # The closest-hit search's best t before each row, and its reject.
        best = torch.cummin(torch.where(ok, t, pk._BIG), 1)[0]
        before = torch.cat([torch.full_like(best[:, :1], pk._BIG), best[:, :-1]], 1)
        passes = (mint < t) & (t < before) & live[:, None]
        add(rec, "full", passes.sum().item())
        # A warp drops a row whole where none of its live lanes passes.
        skip = ~_warps(passes).any(1) & lw.any(1)[:, None]
        add(rec, "warp_skip", skip.sum().item())
        if kind in ROW_OCCLUSION:
            hit, opened, full = pk._any_hit_plain(tri, sph, pln, *o3, *d3, mint)
            closest = pk._search_tris_last(tri, sph, pln, *o3, *d3, mint)[5] >= 0
            add(rec, "any_opened", opened[live].sum().item())
            add(rec, "any_full", full[live].sum().item())
            add(rec, "untested", (n_tri - opened[live]).sum().item())
            wmax = _warps(torch.where(live, opened, 0)).amax(1)
            add(rec, "warp_untested", 32 * (n_tri - wmax[lw.any(1)]).sum().item())
            # The warp's own issue: rows up to its slowest lane's first
            # acceptance, in full where a lane still searching passes.
            add(rec, "warp_any_opened", wmax.sum().item())
            searching = torch.arange(n_tri, device=t.device)[None, :] < opened[:, None]
            busy = (mint < t) & (t < pk._BIG) & searching & live[:, None]
            add(rec, "warp_any_full", _warps(busy).any(1).sum().item())
            rec["any_equal"] = rec.get("any_equal", True) and bool(
                torch.equal(hit[live], closest[live]))

    return on_search


def row_census_summary(census, counts, reject):
    """Per kind of a row_census_hook run: its counts, the SIMD efficiency
    of its search (live lanes over 32 per warp with a live lane), and
    "own", the search operations a row form runs on these searches (its
    closest-hit searches with the t-first reject when ``reject``, else
    every row in full; any-hit on occlusion searches; every sphere and
    plane test), "closest", the operations of a closest-hit search
    without the reject on each (the bound's search before the redesign),
    and "loop_simd", the path loop's SIMD efficiency (each lane's camera
    and bounce searches over 32 x each warp's most)."""
    _, s_, p_, _ = counts
    out, own, closest = {}, 0, 0
    for kind, rec in census.items():
        if kind == "_loop":
            num, den = warp_simd(rec)
            out["loop_simd"] = num / max(den, 1)
            continue
        row = dict(rec, simd=rec["searches"] / max(32 * rec["warps"], 1))
        sp = rec["searches"] * (s_ * OPS_SPH + p_ * OPS_PLN)
        closest += sp + rec["rows"] * OPS_TRI
        if kind in ROW_OCCLUSION:
            own += sp + rec["any_opened"] * OPS_ROW_TRI_T + rec["any_full"] * OPS_ROW_TRI_REST
        elif reject:
            own += sp + rec["rows"] * OPS_ROW_TRI_T + rec.get("full", 0) * OPS_ROW_TRI_REST
        else:
            own += sp + rec["rows"] * OPS_TRI
        out[kind] = row
    out["own"], out["closest"] = own, closest
    return out


def row_census_text(summary):
    """One line of a row_census_summary."""
    parts = []
    for kind, r in summary.items():
        if not isinstance(r, dict):
            continue
        line = (f"{kind}: {r['searches']} searches in {r['warps']} warps (SIMD "
                f"{r['simd']:.3f}), {r['rows']} rows, {r.get('full', 0)} past the "
                f"reject, {r.get('warp_skip', 0)} of {r['warp_rows']} warp-rows dropped "
                f"whole")
        if "any_opened" in r:
            line += (f"; any-hit {r['any_opened']} rows opened, {r['any_full']} in full, "
                     f"{r['untested']} left untested per lane, {r['warp_untested']} "
                     f"lane-rows for whole warps; warps open {r['warp_any_opened']} and "
                     f"test {r['warp_any_full']} warp-rows in full; equal to closest-hit "
                     f"fam >= 0: {r['any_equal']}")
        parts.append(line)
    return (f"path loop SIMD {summary.get('loop_simd', float('nan')):.3f}; "
            + "; ".join(parts) + f"; search ops own {summary['own']}, closest-hit "
            f"without the reject {summary['closest']}")


def ptxas_table(log):
    """{kernel function (mangled): {"registers", "stack", "spill_stores",
    "spill_loads"}} from nvcc's ``-Xptxas -v`` output."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        m = (re.search(r"Compiling entry function '([^']+)'", line)
             or re.search(r"Function properties for (\S+)", line))
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def demangle(names):
    """{mangled: readable} through c++filt where the toolkit's host has it."""
    names = list(names)
    try:
        res = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True, timeout=60)
        return dict(zip(names, res.stdout.splitlines()))
    except (OSError, subprocess.SubprocessError):
        return {n: n for n in names}


# The row-form instances of K1 and B3 (demangled template arguments): K1's
# <integrator, record, BVH=false, STATS=false>, B3's <mode, BVH=false>.
ROW_INSTANCE = r"(path_kernel<\d, \d, false, false>|primary_kernel<\d, false>)"


def sass_loops(lib, pattern):
    """The loops of each kernel function of the shared library ``lib``
    whose demangled name matches ``pattern``, from ``cuobjdump -sass``:
    {function: [{"start", "end", "instructions", "ops": {opcode: count}}]},
    a loop being the span from a backward branch's target to the branch."""
    import re
    from collections import Counter

    from rvpt_tpu_torch.ops import build

    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    names = demangle(funcs)
    out = {}
    for mangled, instrs in funcs.items():
        name = names.get(mangled, mangled)
        found = re.search(pattern, name)
        if not found:
            continue
        loops = []
        for addr, ins in instrs:
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
            if m and int(m.group(1), 16) < addr:
                lo = int(m.group(1), 16)
                body = [i for a, i in instrs if lo <= a <= addr]
                ops = Counter(re.sub(r"^@!?U?P\w+\s+", "", i).split()[0] for i in body)
                loops.append({"start": lo, "end": addr, "instructions": len(body),
                              "ops": dict(sorted(ops.items()))})
        out[found.group(1)] = loops
    return out


def sass_text(loops, loads=("LDS",)):
    """The loops of sass_loops that hold a load whose opcode starts with one
    of ``loads`` (by default the shared-memory loads of the row searches),
    one line each: span, size, the global and shared loads by width, local
    loads and stores (spill), FP32 operations, MUFU, FCHK, calls, constant
    loads and atomics."""
    lines = []
    for fn, ls in sorted(loops.items()):
        for lp in ls:
            ops = lp["ops"]
            if not any(k.startswith(loads) for k in ops):
                continue

            def count(*prefix):
                return sum(v for k, v in ops.items() if k.startswith(prefix))

            fp = sum(v for k, v in ops.items()
                     if k.split(".")[0] in ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX",
                                            "FSEL", "FSET"))
            ld = {k: v for k, v in ops.items() if k.startswith(("LDG", "LDS"))}
            lines.append(f"{fn} loop {lp['start']:#x}-{lp['end']:#x}: {lp['instructions']} "
                         f"instructions, loads {ld}, local {count('LDL', 'STL')}, FP32 {fp}, "
                         f"MUFU {count('MUFU')}, FCHK {count('FCHK')}, CALL {count('CALL')}, "
                         f"LDC {count('LDC', 'ULDC')}, atomics {count('ATOM', 'RED')}")
    return lines


def row_census_phase(smi, dev):
    """Phase 2b, the row census of K1's and B3's row forms on the 1080p
    Cornell frame (4 bounces, standard; AO 4 probes): every search of the
    Kajiya, Whitted and Cook frames and of B3's camera search, AO probes
    and Appel shadow rays, counted on the card from the plain versions'
    searches (row_census_hook); then the row-form instances' ``-Xptxas
    -v`` and the loops of their SASS (``cuobjdump -sass``: shared-memory
    loads, FP32, MUFU, the division's check and slow-path call).  Returns {what:
    row_census_summary}, whose "own" operations the row forms' bounds
    count."""
    import re

    import torch

    from rvpt_tpu_torch import FilmConfig
    from rvpt_tpu_torch.ops import build
    from rvpt_tpu_torch.ops import pathkernel as pk
    from rvpt_tpu_torch.scene import builtin

    cfg = FilmConfig(1920, 1080)
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device=dev)
    pt = pk.PathTracer(scene)
    cp = pk.camera_params(cam, cfg)
    pixel = torch.arange(cfg.num_pixels, device=dev)
    nb, out = 4, {}
    for what in ("kajiya", "whitted", "cook", 0, 5, 6):
        census = {}
        hook = row_census_hook(pt.tables, pt.counts, what, nb, census, pt.mint)
        if isinstance(what, str):
            pk.trace_plain(pt.tables, pt.counts, pixel, 1, 16, nb, "standard",
                           cam_params=cp, cam_mode=cam.mode, integ=what, on_search=hook)
        else:
            pk.primary_plain(pt.tables, pt.counts, pixel, 1, 16, what,
                             4 if what == 5 else 1, cp, cam.mode, on_search=hook)
        # B3's row form always takes the reject; K1's per integrator.
        reject = pk.row_reject(what) if isinstance(what, str) else True
        out[what] = row_census_summary(census, pt.counts, reject)
        for kind, r in out[what].items():
            if isinstance(r, dict) and "any_equal" in r:
                check(r["any_equal"], f"the any-hit row search disagrees with the "
                      f"closest-hit search's fam >= 0 on {what}'s {kind} rays")
        print(f"[row-census] {what}, 1920x1080 Cornell, {nb} bounces: "
              f"{row_census_text(out[what])} [{smi}]")
    for name in ("path_kernel", "primary_kernel"):
        info = build.BUILD_INFO[name]
        if not info["log"]:
            print(f"[row-ptxas] {name}: no -Xptxas -v output, the library was built "
                  f"before this run ({info['path']})")
        table = ptxas_table(info["log"])
        names = demangle(table)
        for mangled, row in sorted(table.items(), key=lambda kv: names[kv[0]]):
            m = re.search(ROW_INSTANCE, names[mangled])
            if m:
                print(f"[row-ptxas] {m.group(1)}: {row}")
        for line in sass_text(sass_loops(info["path"], ROW_INSTANCE)):
            print(f"[row-sass] {line}")
    return out


# The searches of a stats trace by call order (trace_plain's on_search):
# the camera search, then per bounce a bounce search and, for Whitted, a
# shadow search; Cook's tail last.
def stats_kind(integ, k, nb):
    if k == 0:
        return "camera"
    if integ == "whitted":
        return "shadow" if k % 2 else "bounce"
    return "tail" if integ == "cook" and k == nb else "bounce"


STATS_CENSUS = ("searches", "inside", "box", "passed", "opened", "full", "lane_work",
                "warp_work", "warp_rows", "fill_box", "exit_box", "exit_rows")


def stats_census_hook(tables, counts, rows, integ, nb, census, mint=0.0):
    """An ``on_search`` hook over whole CULL_TILE tiles of a stats trace's
    rays (lane i on thread i, 32 to a warp), the census of the counting
    walk (csrc/path_kernel.cu count_clusters), by kind of search
    (stats_kind) into ``census[kind]``: live searches, lanes inside the
    root box, cluster box tests (n_clu per lane inside), passed clusters,
    triangle rows opened (each passed cluster's) and rows past the t-first
    reject (mint < t < the lane's running best t); the scan's SIMD sums
    (lane iterations, box tests plus rows, against 32 x each warp's
    largest) and the rows its warps open (the union of their lanes'
    passed clusters); and how soon the (tile, search) masks fill, with the
    lanes taken warp by warp in launch order, each seeing the bits of the
    warps before it: the box tests made after every remaining bit of both
    masks is set ("fill_box"), and what an exit checked once per scan at
    its start (count_clusters' EXIT) skips of box tests and rows."""
    import torch

    from rvpt_tpu_torch.ops import pathkernel as pk

    tri, sph, pln, _ = pk._unpack_fwd(tables, counts, tri_rows=True)
    n_clu, k_ = rows.shape[0] - 1, pk.CULL_K
    dev = rows.device
    sizes = torch.clamp(counts[0] - k_ * torch.arange(n_clu, device=dev), max=k_)
    row_ok = torch.arange(k_, device=dev)[None, :] < sizes[:, None]
    calls = [0]

    def add(rec, key, v):
        rec[key] = rec.get(key, 0) + int(v)

    def on_search(o3, d3, live=None):
        kind = stats_kind(integ, calls[0], nb)
        calls[0] += 1
        n = o3[0].numel()
        if live is None:
            live = torch.ones(n, dtype=torch.bool, device=dev)
        rec = census.setdefault(kind, {})
        for start in range(0, n, pk.CULL_TILE):
            sl = slice(start, min(start + pk.CULL_TILE, n))
            lv = live[sl]
            if not bool(lv.any()):
                continue
            o_t, d_t = tuple(c[sl] for c in o3), tuple(c[sl] for c in d3)
            m = lv.numel()
            iv = [1.0 / pk._safe_den(c) for c in d_t]
            root, _ = pk._slab_plain(rows[:1], o_t, iv, mint)
            inside = root[:, 0] & lv
            hit, t0 = pk._slab_plain(rows[1:], o_t, iv, mint)
            listed = hit & inside[:, None]
            seed = pk._search_plain([], sph, pln, *o_t, *d_t, mint)[0]
            t, ok = pk._tri_block(tri, *(c[:, None] for c in (*o_t, *d_t)), mint)
            pad = n_clu * k_ - t.shape[1]
            t = torch.nn.functional.pad(t, (0, pad), value=pk._BIG).view(m, n_clu, k_)
            ok = torch.nn.functional.pad(ok, (0, pad), value=False).view(m, n_clu, k_)
            tv = torch.where(ok, t, pk._BIG)
            before = torch.cummin(torch.cat([seed[:, None], tv.amin(2)[:, :-1]], 1), 1)[0]
            passed = listed & (t0 < before)
            run = torch.cummin(torch.cat([before[:, :, None], tv[:, :, :-1]], 2), 2)[0]
            opened = passed[:, :, None] & row_ok[None]
            full = opened & (mint < t) & (t < run)
            lane_rows = opened.sum((1, 2))
            lane_work = inside * n_clu + lane_rows
            add(rec, "searches", lv.sum())
            add(rec, "inside", inside.sum())
            add(rec, "box", inside.sum() * n_clu)
            add(rec, "passed", passed.sum())
            add(rec, "opened", lane_rows.sum())
            add(rec, "full", full.sum())
            add(rec, "lane_work", lane_work.sum())
            add(rec, "warp_work", 32 * _warps(lane_work).amax(1).sum())
            add(rec, "warp_rows", (_warps(passed).any(1).to(torch.int64)
                                   * sizes[None]).sum())
            warp = torch.arange(m, device=dev) // 32
            never = m // 32 + 1

            def first(mask):
                return torch.where(mask, warp[:, None], never).amin(0)

            last = torch.maximum(first(listed), first(passed))
            suffix = torch.flip(torch.cummax(torch.flip(last, (0,)), 0)[0], (0,))
            # clusters scanned before every later bit is set, per lane
            c_fill = (suffix[None, :] >= warp[:, None]).sum(1)
            add(rec, "fill_box", (inside * (n_clu - c_fill)).sum())
            words = suffix[::32]
            scanned = torch.clamp(32 * (words[None, :] >= warp[:, None]).sum(1), max=n_clu)
            add(rec, "exit_box", (inside * (n_clu - scanned)).sum())
            after = torch.arange(n_clu, device=dev)[None, :] >= scanned[:, None]
            add(rec, "exit_rows", (opened.sum(2) * after).sum())

    return on_search


def stats_census_text(census):
    """One line per kind of search of a stats_census_hook census."""
    parts = []
    for kind in ("camera", "bounce", "shadow", "tail"):
        r = census.get(kind)
        if not r:
            continue

        def share(a, b):
            return a / b if b else float("nan")

        parts.append(
            f"{kind}: {r['searches']} searches, {r['inside']} inside the root, "
            f"{r['box']} box tests, {r['passed']} passed clusters, {r['opened']} rows "
            f"opened, {r['full']} past the reject ({share(r['full'], r['opened']):.3f}), "
            f"scan SIMD {share(r['lane_work'], r['warp_work']):.3f}, warps open "
            f"{r['warp_rows']} rows ({share(r['opened'], 32 * r['warp_rows']):.3f} of 32 "
            f"lanes), box tests after the masks fill {share(r['fill_box'], r['box']):.3f}, "
            f"the exit skips {share(r['exit_box'], r['box']):.3f} of box tests and "
            f"{share(r['exit_rows'], r['opened']):.3f} of rows")
    return "; ".join(parts)


def b8_census(o, d, packed, mint=0.0, maxt=float("inf"), chunk=1 << 15):
    """B8's tests on rays ``o``/``d`` f32[N, 3] against ``pack_triangles``
    rows, in the kernel's order (thread i = ray i, 32 to a warp, triangles
    in index order): {"rays", "tests", "reject": tests whose t cannot beat
    the winner so far, !(mint < t < maxt and t below it), "warp_tests",
    "warp_reject": (warp, triangle) pairs every lane rejects, "hits"}."""
    import torch

    n, n_tri = o.shape[0], packed.shape[0]
    (nx, ny, nz, e0x, e0y, e0z, e1x, e1y, e1z, v0n, v0e0, v0e1, g00, g11, g01,
     inv) = (c[None, :] for c in packed.unbind(1))
    out = dict(rays=n, tests=n * n_tri, reject=0, warp_tests=0, warp_reject=0, hits=0)
    for s in range(0, n, chunk):
        ox, oy, oz = (o[s:s + chunk, k:k + 1] for k in range(3))
        dx, dy, dz = (d[s:s + chunk, k:k + 1] for k in range(3))
        dn = nx * dx + ny * dy + nz * dz
        on = nx * ox + ny * oy + nz * oz
        de0 = e0x * dx + e0y * dy + e0z * dz
        de1 = e1x * dx + e1y * dy + e1z * dz
        oe0 = e0x * ox + e0y * oy + e0z * oz
        oe1 = e1x * ox + e1y * oy + e1z * oz
        t = (v0n - on) / torch.where(dn.abs() < 1e-30, torch.full_like(dn, 1e-30), dn)
        b0 = oe0 + t * de0 - v0e0
        b1 = oe1 + t * de1 - v0e1
        u = inv * (g11 * b0 - g01 * b1)
        v = inv * (g00 * b1 - g01 * b0)
        in_range = (mint < t) & (t < maxt)
        acc = in_range & (u > 0.0) & (v > 0.0) & (u + v < 1.0)
        ta = torch.where(acc, t, float("inf"))
        best = torch.cummin(torch.cat([torch.full_like(ta[:, :1], float("inf")),
                                       ta[:, :-1]], 1), 1)[0]
        rej = ~(in_range & (t < best))
        out["reject"] += int(rej.sum().item())
        out["hits"] += int(acc.any(1).sum().item())
        w = torch.nn.functional.pad(rej, (0, 0, 0, (-rej.shape[0]) % 32), value=True)
        w = w.view(-1, 32, n_tri).all(1)
        out["warp_tests"] += w.numel()
        out["warp_reject"] += int(w.sum().item())
    return out


def b8_census_text(c):
    return (f"{c['rays']} rays, {c['hits']} hit; {c['tests']} tests, {c['reject']} "
            f"rejectable by t ({c['reject'] / c['tests']:.3f}); {c['warp_tests']} "
            f"warp-tests, {c['warp_reject']} every lane rejects "
            f"({c['warp_reject'] / max(c['warp_tests'], 1):.3f})")


def device_ms(fn, iters, names):
    """Device time per call of ``fn`` from a torch.profiler trace of
    ``iters`` calls: ({name: ms of the device operations whose names hold
    it}, ms of every device operation)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    parts = {k: sum(e["dur"] for e in dev if k in e["name"]) / 1e3 / iters
             for k in names}
    return parts, sum(e["dur"] for e in dev) / 1e3 / iters


# The segment sum's device operations: the scratch's memset, the summing
# kernel and the rounding pass.
SEG_PARTS = ("Memset", "segsum_kernel", "round_kernel")


def row_stats(idx, g):
    """How the rows of ``idx`` int32[N] fall, over the rays whose
    cotangent column of ``g`` f32[C, N] is not all zero (the rays that add
    something): mean distinct rows per warp of 32 consecutive rays and per
    chunk of 2,048 and of 8,192, and the mean and largest row span (max -
    min + 1) of those chunks."""
    import torch

    adds = (g != 0).any(dim=0)
    out = {"rays": int(idx.numel()), "adding": int(adds.sum().item())}
    for size in (32, 2048, 8192):
        m = idx.numel() // size * size
        if m == 0:
            continue
        key = torch.where(adds[:m], idx[:m].long(), -1).view(-1, size)
        srt = key.sort(dim=1).values
        distinct = 1 + (srt[:, 1:] != srt[:, :-1]).sum(dim=1) - (srt[:, 0] < 0).long()
        tag = "warp" if size == 32 else str(size)
        out[f"distinct_per_{tag}"] = round(distinct.double().mean().item(), 2)
        hi = srt[:, -1]
        lo = torch.where(srt >= 0, srt, hi[:, None]).min(dim=1).values
        ok = hi >= 0
        if size > 32 and ok.any():
            span = (hi - lo + 1)[ok].double()
            out[f"span_mean_{tag}"] = round(span.mean().item(), 1)
            out[f"span_max_{tag}"] = int(span.max().item())
    return out


def k2_work(tables, counts, rec):
    """K2's slots of the record ``rec`` by kind (pack_bwd ``tables``): dead,
    miss, a triangle, sphere or plane hit, and the hits on a dielectric."""
    import torch

    from rvpt_tpu_torch.ops import pathkernel as pk

    live = rec.fields[:, 12] > 0.0
    fam, idx = rec.hits[:, 0].long(), rec.hits[:, 1].long()
    rows = pk._split_rows(tables, counts, pk.BWD_WIDTHS)
    kind = rows[3][:, 7]
    mat = torch.zeros_like(idx)
    for f in range(3):
        if counts[f]:
            on = fam == f
            mat = torch.where(on, rows[f][idx.clamp(0, counts[f] - 1), -1].long(), mat)
    hit = live & (fam >= 0)
    glass = hit & (kind[mat.clamp(0, counts[3] - 1)] == 2.0)
    out = {"dead": int((~live).sum()), "miss": int((live & (fam < 0)).sum()),
           "glass": int(glass.sum())}
    for f, name in enumerate(("tri", "sph", "pln")):
        out[name] = int((hit & (fam == f)).sum())
    return out, fam, idx, mat, hit


def k2_ops(work):
    """K2's operations on a record's slots counted by ``k2_work``."""
    hits = work["tri"] + work["sph"] + work["pln"]
    return (sum(OPS_BWD[k] * work[k] for k in OPS_BWD) + hits * OPS_BWD_HIT
            + work["glass"] * OPS_BWD_GLASS)


def k2_rows(tables, counts, rec):
    """Per bounce: the live hits, and the mean distinct family rows and
    material rows per warp of 32 consecutive rays among them (K2's row
    groups), over the warps that hold any."""
    import torch

    _, fam, idx, mat, hit = k2_work(tables, counts, rec)
    t, s = counts[0], counts[1]
    key = idx + torch.where(fam == 1, t, 0) + torch.where(fam == 2, t + s, 0)
    out = []
    for b in range(fam.shape[0]):
        n = fam.shape[1] // 32 * 32
        line = {"hits": int(hit[b].sum())}
        for name, k in (("rows", key[b]), ("mat_rows", mat[b])):
            w = torch.where(hit[b, :n], k[:n], -1).view(-1, 32)
            srt = w.sort(dim=1).values
            distinct = 1 + (srt[:, 1:] != srt[:, :-1]).sum(dim=1) - (srt[:, 0] < 0).long()
            any_hit = srt[:, -1] >= 0
            line[f"{name}_per_warp"] = round(distinct[any_hit].double().mean().item(), 2)
        out.append(line)
    return out


def share_close(a, b, rtol, atol):
    import torch

    return torch.isclose(a, b, rtol=rtol, atol=atol).float().mean().item()


def od_agreement(got, want, scale):
    """Per-ray o/d cotangents held to rtol 1e-4, atol 1e-6 in units of g's
    scale (they are linear in g, so got/scale is the cotangent of a g of
    order 1).  Returns the share within over all entries, the share within
    over the entries the plain version makes non-zero (most are exactly 0:
    a Lambert-only path has no origin gradient), their count, and the
    largest error in units of g."""
    import torch

    a, b = got / scale, want / scale
    close = torch.isclose(a, b, rtol=1e-4, atol=1e-6)
    nz = b != 0
    n_nz = int(nz.sum().item())
    nz_share = close[nz].float().mean().item() if n_nz else 0.0
    return (close.float().mean().item(), nz_share, n_nz,
            (a - b).abs().max().item())


def training_phases(smi, dev, cfg, scene, cam, pixel, xs, ys, rays):
    """Phases 6-10 (the training slice); returns the kernels' numbers."""
    import numpy as np
    import torch

    from rvpt_tpu_torch import RenderSettings
    from rvpt_tpu_torch.core import rng
    from rvpt_tpu_torch.models import camera as camera_mod
    from rvpt_tpu_torch.models.integrators import integrator_kajiya
    from rvpt_tpu_torch.ops import intersect as tint
    from rvpt_tpu_torch.ops import intersect_pk as ipk
    from rvpt_tpu_torch.ops import pathkernel as pk
    from rvpt_tpu_torch.ops.camera_rays import launch_camera_rays
    from rvpt_tpu_torch.ops.fast_grad import make_fast_kajiya
    from rvpt_tpu_torch.render import jittered_camera_rays, render_sample_chw
    from rvpt_tpu_torch.train import inverse

    n, nb, inf = cfg.num_pixels, 4, float("inf")
    pt = pk.PathTracer(scene)
    t_, s_, p_, _ = pt.counts
    ops_search = t_ * OPS_TRI + s_ * OPS_SPH + p_ * OPS_PLN
    out = {}

    # ---- 6. K1 records at 1080p x 4 bounces, rays passed in
    def k1_collect():
        return pk.launch_path_kernel(pt.tables, pt.counts, pixel, n, 1, 16, nb,
                                     "standard", rays=rays, collect=True)

    def plain_collect(work=None, on_search=None):
        return pk.trace_plain(pt.tables, pt.counts, pixel, 1, 16, nb, "standard",
                              rays=rays, collect=True, work=work, on_search=on_search)

    got, rec = k1_collect()
    bare = pk.launch_path_kernel(pt.tables, pt.counts, pixel, n, 1, 16, nb,
                                 "standard", rays=rays)
    work, census = {}, {}
    want, wrec = plain_collect(work, row_census_hook(pt.tables, pt.counts, "kajiya",
                                                     nb, census, pt.mint))
    torch.cuda.synchronize()
    same_rgb = torch.equal(got, bare)
    rgb_close = share_close(got, want, 1e-4, 1e-4)
    hits_eq = (rec.hits == wrec.hits).all(dim=1).float().mean().item()
    fields_close = share_close(rec.fields, wrec.fields, 1e-4, 1e-4)
    fields_err = (rec.fields - wrec.fields).abs().max().item()
    print(f"[records] K1 collect, {cfg.width}x{cfg.height} x {nb} bounces, rays in: radiance equal "
          f"to K1 without collect: {same_rgb}; vs trace_plain: radiance "
          f"{rgb_close:.6f} within 1e-4, (fam, idx) equal on {hits_eq:.6f} of "
          f"ray-bounces, fields {fields_close:.6f} within 1e-4 (bars 0.995), "
          f"max field |err| {fields_err:.3g}")
    check(same_rgb, "K1 radiance changes with collect")
    check(rgb_close >= 0.995, f"K1 collect radiance disagrees: {rgb_close:.6f}")
    check(hits_eq >= 0.995, f"K1 hit records disagree: {hits_eq:.6f}")
    check(fields_close >= 0.995, f"K1 record fields disagree: {fields_close:.6f}")
    del got, bare, want, wrec
    for _ in range(2):
        k1_collect()
    k1c_ms = cuda_ms(k1_collect, 10)
    k1c_plain_ms = cuda_ms(plain_collect, 2)
    live = int(rec.fields[:, 12].sum().item())
    # rays in (24 B) + pixel ids (8) + film (12) per ray, 60 B per record
    # slot; the searches' own operations (the row census of these rays)
    k1c_bytes = n * (24 + 8 + 12 + 60 * nb)
    own = row_census_summary(census, pt.counts, pk.row_reject("kajiya"))["own"]
    k1c_bound, k1c_by = bound(k1c_bytes, k1_ops(work, 0) + own)
    k1c_closest, _ = bound(k1c_bytes, k1_ops(work, ops_search))
    print(f"[time] K1 collect {k1c_ms:.4f} ms, plain {k1c_plain_ms:.4f} ms, bound "
          f"{k1c_bound:.4f} ms by {k1c_by} ({live} live ray-bounces, work {work}, "
          f"the searches' own {own} operations); closest-hit searches without the "
          f"reject, not the bound: {k1c_closest:.4f} ms [{smi}]")
    out["k1c"] = dict(ms=k1c_ms, plain_ms=k1c_plain_ms, bound_ms=k1c_bound,
                      bound_by=k1c_by, closest_hit_bound_ms=k1c_closest)

    # ---- 7. K2 against bwd_plain on the kernel's record
    tables, counts = pk.pack_bwd(scene)
    scale = 1.0 / (3 * n)  # the mean-image loss's cotangent
    g_mean = torch.full((n, 3), scale, device=dev)
    g_rand = torch.from_numpy(np.random.default_rng(7).normal(size=(n, 3))
                              .astype(np.float32) * np.float32(scale)).to(dev)
    k2_err = 0.0
    for gname, g in (("g = 1/(3N)", g_mean), ("seeded g at that scale", g_rand)):
        kf, kgo, kgd = pk.launch_bwd_kernel(tables, counts, rec, pixel, 1, 16,
                                            "standard", g)
        wf, wgo, wgd = pk.bwd_plain(tables, counts, rec, pixel, 1, 16,
                                    "standard", g)
        torch.cuda.synchronize()
        od_line = []
        for label, k, w in (("o", kgo, wgo), ("d", kgd, wgd)):
            share, nz_share, n_nz, err = od_agreement(k, w, scale)
            od_line.append(f"{label}: {share:.6f} of all, {nz_share:.6f} of the "
                           f"{n_nz} non-zero, max |err| {err:.3g}")
            check(share >= 0.995 and nz_share >= 0.995,
                  f"K2 {label} cotangents disagree: {share:.6f} of all, "
                  f"{nz_share:.6f} of the non-zero entries")
            # A non-zero cotangent on at least 0.1% of the entries, so that a
            # K2 that wrote zeros fails the share of the non-zero ones.
            check(n_nz >= 3 * n // 1000, f"the plain {label} cotangent is zero "
                  f"on all but {n_nz} entries")
            k2_err = max(k2_err, err * scale)
        tab_err = (kf - wf).abs().max().item()
        tab_rel = ((kf - wf).abs() / wf.abs().clamp_min(1e-30))[wf.abs() > 1e-6].max().item()
        tab_ok = torch.allclose(kf, wf, rtol=1e-3, atol=1e-7)
        print(f"[K2-vs-plain] {gname}: o/d cotangents within rtol 1e-4 atol 1e-6 in "
              f"units of g's scale (bars 0.995): {'; '.join(od_line)}; 24 table "
              f"columns ({kf.numel()} entries) within rtol 1e-3 atol 1e-7: {tab_ok}, "
              f"max |err| {tab_err:.3g}, max rel err {tab_rel:.3g} (entries > 1e-6)")
        check(bool(torch.isfinite(kf).all()) and bool(torch.isfinite(kgo).all())
              and bool(torch.isfinite(kgd).all()), "K2 output not finite")
        check(wf.abs().max().item() > 0, "plain table gradient is zero")
        check(tab_ok, f"K2 table gradients disagree: max |err| {tab_err:.3g}")
        k2_err = max(k2_err, tab_err)

    def k2():
        return pk.launch_bwd_kernel(tables, counts, rec, pixel, 1, 16, "standard",
                                    g_mean)

    def k2_plain():
        return pk.bwd_plain(tables, counts, rec, pixel, 1, 16, "standard", g_mean)

    for _ in range(2):
        k2()
    k2_ms = cuda_ms(k2, 10)
    k2_plain_ms = cuda_ms(k2_plain, 2)
    # The record slots K2 reads: 48 B per live ray-bounce (o, d, thr, the
    # active flag and the hit; it never reads the gathered color) and the
    # active flag (4 B) of a dead one; per ray g (12), the pixel id (8) and
    # the o/d cotangents written (24).  Its operations by kind of slot.
    k2w, *_ = k2_work(tables, counts, rec)
    k2_bound, k2_by = bound(live * 48 + (n * nb - live) * 4 + n * (12 + 8 + 24),
                            k2_ops(k2w))
    rows = k2_rows(tables, counts, rec)
    print(f"[time] K2 {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms, bound "
          f"{k2_bound:.4f} ms by {k2_by} ({k2_ops(k2w)} operations on the slots "
          f"{k2w}; the parent's count, 300 per live ray-bounce, "
          f"{live * 300}), kernel at {k2_bound / k2_ms:.1%} of it; per bounce the "
          f"live hits and distinct family and material rows per warp {rows} [{smi}]")
    out["k2"] = dict(max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms,
                     bound_ms=k2_bound, bound_by=k2_by, work=k2w, rows_per_bounce=rows)

    # ---- 8. B8 against closest_hit_triangles, camera and bounced rays
    v = (scene.tri_v0, scene.tri_v1, scene.tri_v2)
    packed = ipk.pack_triangles(*v)
    o_cam = torch.stack(rays[0:3], dim=-1).contiguous()
    d_cam = torch.stack(rays[3:6], dim=-1).contiguous()
    o_b = rec.fields[1, 0:3].T.contiguous()
    d_b = rec.fields[1, 3:6].T.contiguous()
    del rec
    b8_err = 0.0
    for label, o, d in (("camera rays", o_cam, d_cam), ("bounce-2 rays", o_b, d_b)):
        t, idx = ipk.launch_closest_hit(o, d, packed, 0.0, inf)
        wt, widx = tint.closest_hit_triangles(o, d, *v, 0.0, inf)
        torch.cuda.synchronize()
        same = idx == widx
        idx_eq = same.float().mean().item()
        hit = same & (widx >= 0)
        t_bad = int((~torch.isclose(t[hit], wt[hit], rtol=1e-5, atol=0.0)).sum().item())
        err = (t[hit] - wt[hit]).abs().max().item() if hit.any() else 0.0
        b8_err = max(b8_err, err)
        print(f"[B8-vs-plain] {label}: index equal on {idx_eq:.6f} (bar 0.999), "
              f"t outside rtol 1e-5 on {t_bad} of {int(hit.sum().item())} agreeing "
              f"hits, max |err| {err:.3g}; {(widx >= 0).float().mean().item():.4f} "
              f"of rays hit a triangle")
        check(idx_eq >= 0.999, f"B8 indices disagree on {label}: {idx_eq:.6f}")
        check(t_bad == 0, f"B8 t disagrees on {label} at {t_bad} hits")
    # Step 1's census of B8's tests: the t-first reject's share per ray and
    # per warp, on the camera and bounce-2 rays and on soups of 300, 600
    # and 1,000 triangles (camera rays), and a soup of 513, one row past a
    # 512-row chunk, against the plain version on every 16th row.
    b8c = {"camera": b8_census(o_cam, d_cam, packed), "bounce2": b8_census(o_b, d_b, packed)}
    b8_soups = {}
    for n_soup in (300, 513, 600, 1000):
        sscene, scam = hart_soup(dev, n_soup, cfg)
        sray = jittered_camera_rays(scam, cfg, pixel, xs, ys, 0, 0)
        so, sd = sray.origin.contiguous(), sray.direction.contiguous()
        spacked = ipk.pack_triangles(sscene.tri_v0, sscene.tri_v1, sscene.tri_v2)
        b8_soups[n_soup] = (so, sd, spacked)
        if n_soup != 513:
            b8c[f"soup{n_soup}"] = b8_census(so, sd, spacked)
            continue
        rows16 = (pixel // cfg.width) % 16 == 0
        t, idx = ipk.launch_closest_hit(so, sd, spacked, 0.0, inf)
        wt, widx = tint.closest_hit_triangles(so[rows16], sd[rows16], sscene.tri_v0,
                                              sscene.tri_v1, sscene.tri_v2, 0.0, inf)
        torch.cuda.synchronize()
        same = idx[rows16] == widx
        idx_eq = same.float().mean().item()
        hit = same & (widx >= 0)
        t_bad = int((~torch.isclose(t[rows16][hit], wt[hit], rtol=1e-5, atol=0.0)).sum().item())
        print(f"[B8-vs-plain] 513-triangle soup (one row past a 512-row chunk), every "
              f"16th row: index equal on {idx_eq:.6f} (bar 0.999), t outside rtol 1e-5 "
              f"on {t_bad} of {int(hit.sum().item())} agreeing hits; "
              f"{(widx >= 0).float().mean().item():.4f} of rays hit")
        check(idx_eq >= 0.999, f"B8 indices disagree on the 513-triangle soup: {idx_eq:.6f}")
        check(t_bad == 0, f"B8 t disagrees on the 513-triangle soup at {t_bad} hits")
    for label, c in b8c.items():
        print(f"[B8-census] {label}: {b8_census_text(c)} [{smi}]")
    from rvpt_tpu_torch.ops import build

    info = build.BUILD_INFO["closest_hit"]
    for mangled, row in ptxas_table(info["log"]).items():
        print(f"[B8-ptxas] {demangle([mangled])[mangled]}: {row}")
    for line in sass_text(sass_loops(info["path"], r"(closest_hit_kernel)"),
                          ("LDG", "LDS")):
        print(f"[B8-sass] {line}")

    def b8_ops(c):
        """B8's own tests: every test to its t; past the t-first reject, the
        rest (the row search's counts)."""
        return c["tests"] * OPS_ROW_TRI_T + (c["tests"] - c["reject"]) * OPS_ROW_TRI_REST

    b8_ms = cuda_ms(lambda: ipk.launch_closest_hit(o_cam, d_cam, packed, 0.0, inf), 20)
    b8_plain_ms = cuda_ms(lambda: tint.closest_hit_triangles(o_cam, d_cam, *v, 0.0, inf), 3)
    # Per ray the ray (24 B) in, t (4) and the index (4: an i32 holds it,
    # as in the TPU kernel, though the wrapper hands torch an int64) out;
    # the 16 triangle fields once.
    b8_bound, b8_by = bound(n * (24 + 4 + 4) + 64 * t_, b8_ops(b8c["camera"]))
    print(f"[time] B8 {b8_ms:.4f} ms, plain {b8_plain_ms:.4f} ms, bound "
          f"{b8_bound:.4f} ms by {b8_by}, kernel at {b8_bound / b8_ms:.1%} of it "
          f"({cfg.width}x{cfg.height} camera rays, {t_} triangles) [{smi}]")
    soups_out = {}
    for n_soup, (so, sd, spacked) in b8_soups.items():
        if n_soup == 513:
            continue
        ms_s = cuda_ms(lambda: ipk.launch_closest_hit(so, sd, spacked, 0.0, inf), 5)
        bnd_s, by_s = bound(n * 32 + 64 * n_soup, b8_ops(b8c[f"soup{n_soup}"]))
        soups_out[n_soup] = dict(ms=ms_s, bound_ms=bnd_s, bound_by=by_s)
        print(f"[time] B8 on the {n_soup}-triangle soup's camera rays: {ms_s:.4f} ms, "
              f"bound {bnd_s:.4f} ms by {by_s} ({bnd_s / ms_s:.1%}) [{smi}]")
    out["b8"] = dict(max_abs_err=b8_err, ms=b8_ms, plain_ms=b8_plain_ms,
                     bound_ms=b8_bound, bound_by=b8_by, census=b8c, soups=soups_out)
    del b8_soups
    del o_b, d_b

    # ---- 9. the headline step: bench.py's mean-image loss, value and grad
    st = RenderSettings(max_bounces=nb, style="standard")
    trace = make_fast_kajiya(scene, 16, nb, style="standard")
    params = {k: x.detach().clone().requires_grad_(True)
              for k, x in inverse.trainable_params(scene).items()}
    # The camera's leaves too, for the check: their gradients reach the
    # scene only through K2's origin and direction cotangents.
    checked = {**params, **{f"camera.{k}": getattr(cam, k).detach().clone()
                            .requires_grad_(True) for k in ("translation", "fov")}}

    def camera_rays(leaves):
        ju, jv = rng.uniform2(pixel, 0, 0)
        cx = (xs.to(torch.float32) + ju) / cfg.width
        cy = 1.0 - (ys.to(torch.float32) + jv) / cfg.height
        return camera_mod.generate_rays(inverse.apply_camera(cam, leaves), cx, cy)

    def step(frame, leaves=params):
        ray = camera_rays(leaves)
        s = inverse.apply_params(scene, leaves)
        loss = torch.mean(trace(s, ray.origin, ray.direction, pixel, frame))
        return loss, torch.autograd.grad(loss, list(leaves.values()))

    k1_0, k2_0 = pk.launch_path_kernel.launches, pk.launch_bwd_kernel.launches
    loss, grads = step(1, checked)
    torch.cuda.synchronize()
    k1_step = pk.launch_path_kernel.launches - k1_0
    k2_step = pk.launch_bwd_kernel.launches - k2_0
    check(k1_step == 1 and k2_step == 1,
          f"a step launched K1 {k1_step} and K2 {k2_step} times, not once each")
    for k, gr in zip(checked, grads):
        check(bool(torch.isfinite(gr).all()), f"gradient of {k} not finite")
        check(gr.abs().max().item() > 0, f"gradient of {k} is zero")
    ray = camera_rays(checked)
    ref_loss = torch.mean(integrator_kajiya(inverse.apply_params(scene, checked),
                                            ray, pixel, 1, st, salt_base=16))
    ref = torch.autograd.grad(ref_loss, list(checked.values()))
    torch.cuda.synchronize()
    for k, a, b in zip(checked, grads, ref):
        err = (a - b).abs().max().item()
        tol = 1e-7 if k.startswith("camera.") else 1e-5
        ok = torch.allclose(a, b, rtol=2e-2, atol=tol)
        print(f"[step] d loss / d {k}: paired trace vs autograd through "
              f"integrator_kajiya (B8): within rtol 2e-2 atol {tol:g}: {ok}, max "
              f"|err| {err:.3g}, max |grad| {b.abs().max().item():.4g}")
        check(ok, f"gradient of {k} disagrees with autograd: max |err| {err:.3g}")
    print(f"[step] loss {loss.item():.6f} (autograd route {ref_loss.item():.6f})")
    del ref, ref_loss, ray
    for f in range(2):
        step(2 + f)
    steps = 10
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for f in range(steps):
        step(4 + f)
    stop.record()
    stop.synchronize()
    step_ms = start.elapsed_time(stop) / steps
    rays_per_step = n * 1 * nb
    print(f"[step] fwd+bwd {cfg.width}x{cfg.height} x {nb} bounces, standard: {step_ms:.4f} ms/step, "
          f"{rays_per_step / step_ms / 1e3:.1f} Mrays/s (W*H*aa*bounces per step); "
          f"K1 collect {k1c_ms:.4f} ms ({k1c_ms / step_ms:.1%}), K2 {k2_ms:.4f} ms "
          f"({k2_ms / step_ms:.1%}) [{smi}]")

    # ---- 10. the trainer at 1920x1080: this slice's main path
    st10 = RenderSettings(max_bounces=nb, aa=1, style="standard")
    frames, train_steps = 8, 50
    mats = scene.materials
    init = inverse.apply_params(scene, {
        "materials.albedo": torch.full_like(mats.albedo, 0.5),
        "materials.emission": mats.emission * 0.25})
    # A 2-step run first, so the timed run pays no first-use costs (CUDA
    # modules loaded at first launch, the allocator's first blocks).
    inverse.recover(init, cam, st10, cfg, None,
                    render_sample_chw(scene, cam, st10, cfg, 0), steps=2,
                    learning_rate=3e-2)
    pk.launch_path_kernel.launches = 0
    pk.launch_bwd_kernel.launches = 0
    ipk.launch_closest_hit.launches = 0
    target = torch.zeros((3, cfg.height, cfg.width), device=dev)
    for f in range(frames):
        target = target + render_sample_chw(scene, cam, st10, cfg, f) / frames
    torch.cuda.synchronize()
    launch_camera_rays.launches = 0
    t0 = time.perf_counter()
    rec_scene, losses, _ = inverse.recover(init, cam, st10, cfg, None, target,
                                           steps=train_steps, learning_rate=3e-2)
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) / train_steps * 1e3
    launches = {"path_kernel": pk.launch_path_kernel.launches,
                "bwd_kernel": pk.launch_bwd_kernel.launches,
                "closest_hit": ipk.launch_closest_hit.launches,
                "camera_rays": launch_camera_rays.launches}

    def mean_err(a, b):
        return (a - b).abs().mean().item()

    alb0 = mean_err(init.materials.albedo, mats.albedo)
    em0 = mean_err(init.materials.emission, mats.emission)
    alb = mean_err(rec_scene.materials.albedo, mats.albedo)
    em = mean_err(rec_scene.materials.emission, mats.emission)
    print(f"[train] recover, {cfg.width}x{cfg.height} x {nb} bounces, {train_steps} steps, lr 3e-2: "
          f"{train_ms:.4f} ms/step (after a 2-step warm-up run); loss {losses[0]:.6f} -> {losses[-1]:.6f}; mean "
          f"|albedo err| {alb0:.4f} -> {alb:.4f}, mean |emission err| {em0:.4f} -> "
          f"{em:.4f}; launches {launches} [{smi}]")
    check(all(np.isfinite(losses)), "trainer loss not finite")
    check(alb < alb0, f"albedo error did not fall: {alb0:.4f} -> {alb:.4f}")
    check(em < em0, f"emission error did not fall: {em0:.4f} -> {em:.4f}")
    for name, count in launches.items():
        check(count > 0, f"{name} never launched on the trainer's path")
    check(launches["path_kernel"] == 2 * train_steps
          and launches["bwd_kernel"] == train_steps,
          f"the trainer launched {launches}: expected one K1 and one K2 per "
          f"rendered gradient and one K1 per stop-gradient buffer")
    check(launches["camera_rays"] == 2 * train_steps,
          f"the trainer launched the camera-ray kernel {launches['camera_rays']} "
          f"times in {train_steps} steps: expected one per rendered buffer")
    out["launches"] = launches
    return out


def hart_soup(dev, n_tri, cfg, seed=7):
    """A seeded soup of n_tri triangles in front of a pinhole camera (more
    than B4's 512-row chunk: the march restages its table every step)."""
    import numpy as np

    from rvpt_tpu_torch.models import camera as camera_mod
    from rvpt_tpu_torch.scene.scene import SceneBuilder

    r = np.random.default_rng(seed)
    b = SceneBuilder()
    m = b.add_material(albedo=(0.7, 0.6, 0.5))
    size = 2.0 * (12.0 / n_tri) ** 0.5
    for _ in range(n_tri):
        c = r.uniform(-2, 2, 3)
        c[2] += 4.0
        b.add_triangle(tuple(c), tuple(c + r.normal(0, size, 3)),
                       tuple(c + r.normal(0, size, 3)), m)
    cam = camera_mod.Camera.create(fov=90.0, aspect=cfg.aspect, device=dev)
    return b.build(dev), cam


def hart_check(smi, dev, label, pt, cfg, cp, cam_mode, every=1):
    """Phase 11's B4 check on one scene: the kernel's frame bit for bit
    against hart_plain on the pixel ids of every ``every``-th row, its
    counting instance's film equal to it with no skipped triangle below
    the running minimum and no stop after an escape; its time (CUDA
    events) beside the plain version's and beside its bound, the march's
    own work from the counting instance (live steps to each stop or
    escape, skip tests, full distances by branch, seeds); the parent's
    full sweep (every triangle's full distance at every step it ran) is
    printed beside it at peak, not as the bound."""
    import torch

    from rvpt_tpu_torch.ops import pathkernel as pk

    n = cfg.num_pixels

    def b4():
        return pk.launch_hart_kernel(pt.hart_tables, pt.hart_count, None, n, 1, cp,
                                     cam_mode, 0)

    rows = torch.arange(n, device=dev).view(cfg.height, cfg.width)[::every].reshape(-1)

    def b4_plain():
        return pk.hart_plain(pt.hart_tables, pt.hart_count, rows, 1, cp, cam_mode, 0)

    got, want = b4(), b4_plain()
    counted, work = pk.count_hart_sweep(pt.hart_tables, pt.hart_count, None, n, 1,
                                        cp, cam_mode, 0)
    torch.cuda.synchronize()
    close, err, same = equal_share(got[:, rows], want)
    same_count = bool(torch.equal(counted, got))
    ms = cuda_ms(b4, 20)
    plain_ms = cuda_ms(b4_plain, 1)
    own = (work["steps"] * OPS_HART_OWN_STEP + work["tests"] * OPS_HART_TEST
           + (work["tests"] - work["plane_skips"]) * OPS_HART_SPHERE
           + work["face"] * OPS_HART_FACE + work["edge"] * OPS_HART_EDGE
           + work["seeds"] * OPS_HART_SEED + n * OPS_CAMERA)
    parent = (work["parent_steps"] * OPS_HART_STEP + work["all_face"] * OPS_HART_TRI
              + work["all_edge"] * OPS_HART_TRI_EDGE + n * OPS_CAMERA)
    bnd, by = bound(12 * n, own)
    parent_ms = parent / PEAK_FP32 * 1e3
    print(f"[B4-vs-plain] Hart, {label}, {cfg.width}x{cfg.height}, {pt.hart_count} "
          f"triangles: bit-identical to hart_plain on {rows.numel()} pixels: {same} "
          f"({close:.6f} within 1e-4, max |err| {err:.3g}); counting instance's film "
          f"equal: {same_count}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bnd:.4f} ms by {by} (its own work {own} operations: {work}), kernel at "
          f"{bnd / ms:.1%} of it; the parent's full sweep {parent} operations, "
          f"{parent_ms:.4f} ms at peak (not the bound) [{smi}]")
    check(bool(torch.isfinite(got).all().item()), f"B4 on {label} not finite")
    check(same, f"B4 on {label} is not bit for bit hart_plain: {close:.6f}")
    check(same_count, f"B4's counting instance on {label} wrote another film")
    check(work["bad"] == 0, f"B4 on {label} skipped {work['bad']} triangles below "
          f"the running minimum")
    check(work["late"] == 0, f"B4 on {label}: {work['late']} rays stopped after "
          f"their escape")
    return dict(max_abs_err=err, within_1e_4=close, bit_identical=same, ms=ms,
                plain_ms=plain_ms, bound_ms=bnd, bound_by=by, parent_work_ms=parent_ms,
                work=work)


def row_form_check(smi, dev, cfg, nb=4):
    """Phase 11b: K1's and B3's row forms bit for bit against their plain
    versions at 1920x1080, camera rays made in the kernels, on the Cornell
    box, sphere_plane (no triangles) and hart_soup's 600- and
    1,000-triangle soups (40.8 KB of triangle rows, and 68 KB: past the 48
    KB default, in the opt-in shared memory), each with a pinhole, an ortho
    and a spherical camera: K1's Kajiya, Whitted and Cook frames, its
    Kajiya collect instances (the full record and hits only), and B3 in
    modes 0-6 (AO 4 probes); the plain versions on the pixel ids of every
    4th row (the soups' every 16th).  Returns the soups' Kajiya and AO
    kernel times (CUDA events) by scene."""
    import dataclasses

    import torch

    from rvpt_tpu_torch.models import camera as camera_mod
    from rvpt_tpu_torch.ops import pathkernel as pk
    from rvpt_tpu_torch.scene import builtin

    n = cfg.num_pixels
    scenes = [("cornell_box", *builtin.cornell_box(aspect=cfg.aspect, device=dev), 4),
              ("sphere_plane", *builtin.sphere_plane(aspect=cfg.aspect, device=dev), 4),
              ("soup600", *hart_soup(dev, 600, cfg), 16),
              ("soup1000", *hart_soup(dev, 1000, cfg), 16)]
    times, checked = {}, 0
    for name, scene, cam0, every in scenes:
        pt = pk.PathTracer(scene)
        rows = torch.arange(n, device=dev).view(cfg.height, cfg.width)[::every].reshape(-1)
        for cam_mode in (camera_mod.PINHOLE, camera_mod.ORTHO, camera_mod.SPHERICAL):
            cam = dataclasses.replace(cam0, mode=cam_mode)
            cp = pk.camera_params(cam, cfg)
            kw = dict(cam_params=cp, cam_mode=cam_mode, jitter_salt=0)
            cases = []
            for integ in ("kajiya", "whitted", "cook"):
                cases.append((integ, lambda integ=integ: pk.launch_path_kernel(
                    pt.tables, pt.counts, None, n, 1, 16, nb, "standard", integ=integ,
                    **kw), lambda integ=integ: pk.trace_plain(
                    pt.tables, pt.counts, rows, 1, 16, nb, "standard", integ=integ,
                    **kw)))
            for collect in (True, "hits"):
                cases.append((f"collect {collect}", lambda collect=collect:
                              pk.launch_path_kernel(pt.tables, pt.counts, None, n, 1, 16,
                                                    nb, "standard", collect=collect, **kw),
                              lambda collect=collect: pk.trace_plain(
                                  pt.tables, pt.counts, rows, 1, 16, nb, "standard",
                                  collect=collect, **kw)))
            for mode in range(7):
                nrays = 4 if mode == 5 else 1
                cases.append((f"mode {mode}", lambda mode=mode, nrays=nrays:
                              pk.launch_primary_kernel(pt.tables, pt.counts, None, n, 1,
                                                       16, mode, nrays, **kw),
                              lambda mode=mode, nrays=nrays: pk.primary_plain(
                                  pt.tables, pt.counts, rows, 1, 16, mode, nrays, **kw)))
            same = []
            for label, kernel, plain in cases:
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                if isinstance(got, tuple):  # (film, record or hits)
                    rec, wrec = got[1], want[1]
                    if isinstance(rec, pk.PathRecord):
                        ok = (torch.equal(rec.fields[..., rows], wrec.fields)
                              and torch.equal(rec.hits[..., rows], wrec.hits))
                    else:
                        ok = torch.equal(rec[..., rows], wrec)
                    ok = ok and torch.equal(got[0][:, rows], want[0])
                else:
                    ok = torch.equal(got[:, rows], want)
                check(ok, f"the row form's {label} on {name}, camera {cam_mode}, is not "
                      f"bit for bit its plain version")
                checked += 1
                same.append(label)
                if name.startswith("soup") and cam_mode == camera_mod.PINHOLE and (
                        label in ("kajiya", "mode 5")):
                    times[f"{name} {label}"] = cuda_ms(kernel, 10)
            print(f"[row-form] {name} ({pt.counts[0]} triangles), camera {cam_mode}, "
                  f"{cfg.width}x{cfg.height} x {nb}: bit for bit the plain version on "
                  f"every {every}th row: {', '.join(same)}")
    print(f"[row-form] {checked} row-form launches bit for bit their plain versions; "
          f"soup times (CUDA events, pinhole): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()) + f" [{smi}]")
    return times


def equal_share(got, want):
    """(share of channels within rtol/atol 1e-4, max |err|, bit-identical)
    of a kernel's film against its plain version."""
    import torch

    close = torch.isclose(got, want, rtol=1e-4, atol=1e-4).float().mean().item()
    return close, (got - want).abs().max().item(), bool(torch.equal(got, want))


def split_frame_against_plain(smi, dev, cfg, scene, cam, split, nb):
    """Phase 13's check: one split frame of render_sample_fast_chw at 1080p
    against the plain versions of its quadrants' kernels, each on its
    quadrant's pixel ids and placed into the film by those ids (not by the
    rectangle the frame writes); the quadrants must cover the film as
    _mode_masks selects it.  Bars: B3 and K1 >= 99.5% of channels within
    1e-4, B4 bit for bit.  Then each quadrant's kernel pass
    (render._trace_mode_kernel on its pixel ids) and the whole sample are
    timed with CUDA events -> {"quadrants": {mode name: ms}, "sample_ms"}."""
    import torch

    from rvpt_tpu_torch.models.integrators import INTEGRATOR_NAMES
    from rvpt_tpu_torch.ops import pathkernel as pk
    from rvpt_tpu_torch.render import (_mode_masks, _pixel_grid, _rect_pixels,
                                       _split_partition, _trace_mode_kernel,
                                       render_sample_fast_chw)

    names = {v: k for k, v in INTEGRATOR_NAMES.items()}
    frame, salt_base = 5, 16  # AA sample 0: jitter salt 0, integrator salt 16
    pt = pk.PathTracer(scene)
    cp = pk.camera_params(cam, cfg)
    got = render_sample_fast_chw(scene, cam, split, cfg, frame, tracer=pt,
                                 cam_params=cp).reshape(3, -1)
    _, xs, ys = _pixel_grid(cfg, dev)
    part = torch.full((cfg.num_pixels,), -1, dtype=torch.int64, device=dev)
    lines, quads = [], {}
    for m, rect in _split_partition(cfg, split):
        pix = _rect_pixels(*rect, cfg.width, dev)
        quads[names[m]] = (m, pix)
        part[pix] = m
        if m == 10:
            want, bar = pk.hart_plain(pt.hart_tables, pt.hart_count, pix, frame,
                                      cp, cam.mode, 0), 0.99
        elif m in pk.PRIMARY_MODES:
            want, bar = pk.primary_plain(pt.tables, pt.counts, pix, frame,
                                         salt_base, m, nb if m == 5 else 1, cp,
                                         cam.mode, 0), 0.995
        else:
            integ = {7: "whitted", 8: "cook"}.get(m, "kajiya")
            want, bar = pk.trace_plain(pt.tables, pt.counts, pix, frame, salt_base,
                                       nb, "standard", cam_params=cp,
                                       cam_mode=cam.mode, jitter_salt=0,
                                       integ=integ), 0.995
        close, err, same = equal_share(got[:, pix], want)
        lines.append(f"{names[m]} {rect}: {close:.6f} within 1e-4 (bar "
                     f"{'bit for bit' if m == 10 else bar}), max |err| {err:.3g}, "
                     f"bit-identical: {same}")
        check(same if m == 10 else close >= bar, f"split quadrant {names[m]} "
              f"{rect} disagrees with plain: {close:.6f}, bit-identical {same}")
    covered = torch.equal(part, _mode_masks(split, xs, ys, cfg).to(torch.int64))
    print(f"[split-vs-plain] render_sample_fast_chw, {cfg.width}x{cfg.height}, "
          f"frame {frame}, against the quadrants' plain versions on their pixel "
          f"ids: {'; '.join(lines)}; quadrants reproduce _mode_masks: {covered} "
          f"[{smi}]")
    check(covered, "the split quadrants do not reproduce _mode_masks")
    check(bool(torch.isfinite(got).all().item()), "split frame not finite")
    times = {name: cuda_ms(lambda m=m, pix=pix: _trace_mode_kernel(
        pt, cam, split, cp, pix, frame, 0, m), 20) for name, (m, pix) in quads.items()}
    sample_ms = cuda_ms(lambda: render_sample_fast_chw(scene, cam, split, cfg, frame,
                                                       tracer=pt, cam_params=cp), 20)
    print(f"[split-quadrants] each quadrant's kernel pass on its pixel ids, "
          f"{cfg.width}x{cfg.height} (CUDA events, x20): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
          + f"; their sum {sum(times.values()):.4f} ms; the whole sample "
          f"(render_sample_fast_chw) {sample_ms:.4f} ms [{smi}]")
    return {"quadrants": times, "sample_ms": sample_ms}


def integrator_phases(smi, dev, cfg, scene, cam, pixel, out_dir, here, row_census):
    """Phases 11-13 (the other integrators and split-screen); returns the
    kernels' numbers.  ``row_census`` (phase 2b) gives the row searches'
    own operations for the bounds."""
    import torch

    from rvpt_tpu_torch import FilmConfig, RenderSettings
    from rvpt_tpu_torch.models.integrators import INTEGRATOR_NAMES
    from rvpt_tpu_torch.ops import intersect_pk as ipk
    from rvpt_tpu_torch.ops import pathkernel as pk
    from rvpt_tpu_torch.ops.film import chw_to_hwc, to_srgb_u8
    from rvpt_tpu_torch.renderer import Renderer
    from rvpt_tpu_torch.scene import builtin
    from rvpt_tpu_torch.utils.image import read_png

    n, nb = cfg.num_pixels, 4
    pt = pk.PathTracer(scene)
    cp = pk.camera_params(cam, cfg)
    t_, s_, p_, _ = pt.counts
    ops_search = t_ * OPS_TRI + s_ * OPS_SPH + p_ * OPS_PLN
    names = {v: k for k, v in INTEGRATOR_NAMES.items()}
    modes = ("top_left_render_mode", "top_right_render_mode",
             "bottom_left_render_mode", "bottom_right_render_mode")
    out = {"primary": {}, "bounce": {}}

    # ---- 11. kernels against their plain versions, camera rays in kernel
    hits = None
    for mode in range(7):
        nrays = 4 if mode == 5 else 1

        def b3(mode=mode, nrays=nrays):
            return pk.launch_primary_kernel(pt.tables, pt.counts, None, n, 1, 16,
                                            mode, nrays, cp, cam.mode, 0)

        def b3_plain(mode=mode, nrays=nrays):
            return pk.primary_plain(pt.tables, pt.counts, pixel, 1, 16, mode,
                                    nrays, cp, cam.mode, 0)

        got, want = b3(), b3_plain()
        torch.cuda.synchronize()
        close, err, same = equal_share(got, want)
        if mode == 0:
            hits = int(want[0].sum().item())
        ms = cuda_ms(b3, 20)
        plain_ms = cuda_ms(b3_plain, 2)
        # Per pixel: the camera ray, the search, the mode's finalize; AO
        # adds nrays probes per hit pixel (a draw and the cosine direction
        # each), Appel one shadow search per hit pixel.  The searches count
        # the row search's own work (phase 2b: the reject, any-hit on AO's
        # probes and Appel's shadow rays); without the reject and any-hit,
        # as the bound was counted before the row search's redesign, beside.
        ops = n * (OPS_CAMERA + OPS_FINALIZE[mode])
        closest = ops + n * ops_search
        if mode == 5:
            ops += hits * nrays * (OPS_PCG + OPS_PROBE)
            closest += hits * nrays * (ops_search + OPS_PCG + OPS_PROBE)
        elif mode == 6:
            closest += hits * ops_search
        census = row_census[mode if mode in (5, 6) else 0]
        bnd, by = bound(12 * n, ops + census["own"])
        closest_bnd, _ = bound(12 * n, closest)
        print(f"[B3-vs-plain] mode {mode} ({names[mode]}"
              f"{', 4 probes' if mode == 5 else ''}): {close:.6f} of channels "
              f"within 1e-4, max |err| {err:.3g}, bit-identical: {same} (the bar); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd:.4f} ms by "
              f"{by}, kernel at {bnd / ms:.1%} of it; closest-hit searches without "
              f"the reject, not the bound: {closest_bnd:.4f} ms, "
              f"{closest_bnd / ms:.1%} [{smi}]")
        check(bool(torch.isfinite(got).all().item()), f"B3 mode {mode} not finite")
        check(same, f"B3 mode {mode} is not bit for bit plain: {close:.6f}")
        out["primary"][names[mode]] = dict(max_abs_err=err, within_1e_4=close,
                                           bit_identical=same, ms=ms,
                                           plain_ms=plain_ms, bound_ms=bnd,
                                           bound_by=by, closest_hit_bound_ms=closest_bnd)

    for integ in ("whitted", "cook"):
        kw = dict(cam_params=cp, cam_mode=cam.mode, jitter_salt=0, integ=integ)

        def k1(kw=kw):
            return pk.launch_path_kernel(pt.tables, pt.counts, None, n, 1, 16, nb,
                                         "standard", **kw)

        work = {}
        got = k1()
        want = pk.trace_plain(pt.tables, pt.counts, pixel, 1, 16, nb, "standard",
                              work=work, **kw)
        torch.cuda.synchronize()
        close, err, same = equal_share(got, want)
        ms = cuda_ms(k1, 20)
        plain_ms = cuda_ms(lambda kw=kw: pk.trace_plain(
            pt.tables, pt.counts, pixel, 1, 16, nb, "standard", **kw), 2)
        # The work the plain version did on live lanes of the same inputs,
        # the searches' own (phase 2b) or, beside it, without the reject
        # and any-hit.
        bnd, by = bound(12 * n, k1_ops(work, 0) + row_census[integ]["own"]
                        + n * OPS_CAMERA)
        closest_bnd, _ = bound(12 * n, k1_ops(work, ops_search) + n * OPS_CAMERA)
        print(f"[K1-vs-plain] {integ}, {nb} bounces, standard: {close:.6f} of "
              f"channels within 1e-4, max |err| {err:.3g}, bit-identical: {same} "
              f"(the bar); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bnd:.4f} ms by {by} (work {work}), kernel at "
              f"{bnd / ms:.1%} of it; closest-hit searches without the reject, not "
              f"the bound: {closest_bnd:.4f} ms, {closest_bnd / ms:.1%} [{smi}]")
        check(bool(torch.isfinite(got).all().item()), f"K1 {integ} not finite")
        check(same, f"K1 {integ} is not bit for bit plain: {close:.6f}")
        out["bounce"][integ] = dict(max_abs_err=err, within_1e_4=close,
                                    bit_identical=same, ms=ms, plain_ms=plain_ms,
                                    bound_ms=bnd, bound_by=by,
                                    closest_hit_bound_ms=closest_bnd)

    out["hart"] = hart_check(smi, dev, "Cornell", pt, cfg, cp, cam.mode)
    rcfg = FilmConfig(1024, 512)
    rabbit, rcam = builtin.rabbit(aspect=rcfg.aspect, device=dev)
    rpt = pk.PathTracer(rabbit)
    out["hart"]["rabbit"] = hart_check(smi, dev, "rabbit", rpt, rcfg,
                                       pk.camera_params(rcam, rcfg), rcam.mode)
    soup, scam = hart_soup(dev, 600, cfg)
    out["hart"]["soup600"] = hart_check(smi, dev, "a 600-triangle soup (2 chunks)",
                                        pk.PathTracer(soup), cfg,
                                        pk.camera_params(scam, cfg), scam.mode, every=8)
    sp_scene, sp_cam = builtin.sphere_plane(aspect=cfg.aspect, device=dev)
    sp = pk.PathTracer(sp_scene)
    flat = sp.trace_hart(n, 1, cam_params=pk.camera_params(sp_cam, cfg),
                         cam_mode=sp_cam.mode, jitter_salt=0)
    torch.cuda.synchronize()
    check(bool((flat == 32.0 / 31.0).all().item()),
          "B4 on the scene without triangles is not 32/31 everywhere")
    print("[B4] sphere_plane (no triangles): 32/31 on every pixel")

    # ---- 11b. the row forms bit for bit on every scene and camera model
    out["row_soups_ms"] = row_form_check(smi, dev, cfg, nb)

    # ---- 12. goldens, for the record
    goldens = {
        "cornell_normal": ("cornell_box", 64, 1, 1, "normal"),
        "cornell_color": ("cornell_box", 64, 1, 1, "color"),
        "cornell_depth": ("cornell_box", 64, 1, 1, "depth"),
        "cornell_binary": ("cornell_box", 64, 1, 1, "binary"),
        "cornell_utah": ("cornell_box", 64, 1, 1, "utah"),
        "cornell_ao": ("cornell_box", 64, 1, 8, "ao"),
        "cornell_appel": ("cornell_box", 64, 1, 1, "appel"),
        "cornell_whitted": ("cornell_box", 64, 2, 4, "whitted"),
        "cornell_cook": ("cornell_box", 64, 2, 4, "cook"),
        "sphere_plane_hart": ("sphere_plane", 32, 1, 1, "hart"),
    }
    for name, (scene_name, size, frames, bounces, integ) in goldens.items():
        gcfg = FilmConfig(size, size)
        gscene, gcam = getattr(builtin, scene_name)(aspect=gcfg.aspect, device=dev)
        mode = INTEGRATOR_NAMES[integ]
        gr = Renderer(gscene, gcam, RenderSettings(
            max_bounces=bounces, **dict.fromkeys(modes, mode)), gcfg)
        for _ in range(frames):
            gr.draw()
        gr.flush()
        img = to_srgb_u8(chw_to_hwc(gr.film.accum)).cpu().numpy().astype(int)
        golden = read_png(os.path.join(here, "tests", "goldens", f"{name}.png"))
        off = (abs(img - golden.astype(int)) > 2).mean()
        print(f"[goldens] {name} via the kernels: {off:.4%} of subpixels more than "
              f"2 u8 steps off (recorded, not asserted; the CPU bar is 0.2%)")

    # ---- 13. the slice: split-screen Renderer.draw at 1080p
    kernels = {"path_kernel": pk.launch_path_kernel,
               "bwd_kernel": pk.launch_bwd_kernel,
               "closest_hit": ipk.launch_closest_hit,
               "primary_kernel": pk.launch_primary_kernel,
               "hart_kernel": pk.launch_hart_kernel}
    split = RenderSettings(max_bounces=nb, style="standard",
                           **dict(zip(modes, (5, 7, 10, 9))))
    quads = split_frame_against_plain(smi, dev, cfg, scene, cam, split, nb)
    r = Renderer(scene, cam, split, cfg)
    r.draw()  # the first draw of a Renderer builds its camera vector
    r.flush()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(16):
        r.draw()
    r.flush()
    torch.cuda.synchronize()
    split_ms = (time.perf_counter() - t0) / 16 * 1e3
    launches = {name: k.launches for name, k in kernels.items()}
    check(launches["primary_kernel"] == 16 and launches["hart_kernel"] == 16
          and launches["path_kernel"] == 32,
          f"16 split-screen draws launched {launches}: expected 16 B3, 16 B4 "
          f"and 32 K1")
    accum = r.film.accum
    check(r.film.frame == 17, f"film accumulated {r.film.frame} frames, not 17")
    check(bool(torch.isfinite(accum).all().item()), "split film has non-finite values")
    check(accum.mean().item() > 0.01, "split film is black")
    png = os.path.join(out_dir, "torch_cornell_split_1080p.png")
    r.save_image(png)
    check(read_png(png).shape == (cfg.height, cfg.width, 3),
          "saved split image has the wrong shape")
    print(f"[slice] Renderer.draw x16 split-screen (AO, Whitted, Hart, Kajiya), "
          f"{cfg.width}x{cfg.height}, {nb} bounces, standard: {split_ms:.4f} ms/frame; "
          f"launches {launches}; film mean {accum.mean().item():.6f}; saved {png}; "
          f"its Hart quadrant {quads['quadrants']['hart']:.4f} ms [{smi}]")
    out["split"] = dict(ms=split_ms, launches=launches, **quads)

    out["modes_ms"] = {}
    for mode in (0, 1, 2, 3, 4, 5, 6, 7, 8, 10):
        st = RenderSettings(max_bounces=nb, style="standard",
                            **dict.fromkeys(modes, mode))
        r = Renderer(scene, cam, st, cfg)
        r.draw()
        r.flush()
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(8):
            r.draw()
        r.flush()
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) / 8 * 1e3
        ran = {name: c for name, k in kernels.items() if (c := k.launches)}
        want = ("hart_kernel" if mode == 10 else
                "primary_kernel" if mode < 7 else "path_kernel")
        check(ran == {want: 8}, f"8 draws of mode {mode} launched {ran}")
        check(bool(torch.isfinite(r.film.accum).all().item()),
              f"mode {mode} film has non-finite values")
        print(f"[modes] Renderer.draw x8, mode {mode} ({names[mode]}), "
              f"{cfg.width}x{cfg.height}, {nb} bounces, standard: {frame_ms:.4f} "
              f"ms/frame; launches {ran} [{smi}]")
        out["modes_ms"][names[mode]] = frame_ms
    return out


def bigmesh_check(smi, dev, name, scene, cam, cfg, nb, every, collect=False):
    """Phase 15's B5 check on one mesh: one 1080p frame of ``nb`` bounce
    launches (standard), the kernel's states against bigmesh_bounce_plain's
    on the pixel ids of every ``every``-th row, then the search-only
    instance on the camera rays; each timed beside its bound.  With
    ``collect`` (phase 18) the frame runs the collect instance instead:
    its states must equal the bounce instance's, and its states and hit
    records those of bigmesh_bounce_plain(collect=True) bit for bit; the
    bound adds the hit record written (8 B per ray and launch)."""
    import torch

    from rvpt_tpu_torch.ops import pathkernel as pk
    from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays

    bt = pk.BigMeshTracer(scene)
    n = cfg.num_pixels
    pixel, xs, ys = _pixel_grid(cfg, dev)
    ray = jittered_camera_rays(cam, cfg, pixel, xs, ys, 1, 0)
    start = pk._start_state(bt._rays(ray.origin, ray.direction), "kajiya")
    states = [torch.stack([*start[:15], start[15].to(torch.float32)])]
    hits = []
    # B5's launches in this check's frame (the bounce or collect instance,
    # and with collect the bounce instance beside it), reported as
    # check_launches: the kernels line's launches are the main path's.
    launches = pk.launch_bigmesh_kernel.launches
    for b in range(nb):
        st = pk.launch_bigmesh_kernel(bt.tables, bt.counts, bt.nodes, pixel,
                                      states[-1], 1, 16 + 4 * b, collect=collect)
        if collect:
            bare = pk.launch_bigmesh_kernel(bt.tables, bt.counts, bt.nodes, pixel,
                                            states[-1], 1, 16 + 4 * b)
            check(torch.equal(st[0], bare), f"B5's collect instance changes the "
                  f"state of {name} at bounce {b}")
            st, h = st
            hits.append(h)
        states.append(st)
    launches = pk.launch_bigmesh_kernel.launches - launches
    sub = torch.nonzero(ys % every == 0).squeeze(1)
    plain = states[0][:, sub]
    worst = 1.0
    err = 0.0
    same = True
    for b in range(nb):
        plain = pk.bigmesh_bounce_plain(bt.tables, bt.counts, pixel[sub], plain, 1,
                                        16 + 4 * b, collect=collect)
        if collect:
            plain, h = plain
            same = same and torch.equal(hits[b][:, sub], h)
        close, e, eq = equal_share(states[b + 1][:, sub], plain)
        worst, err, same = min(worst, close), max(err, e), same and eq
    torch.cuda.synchronize()
    kind = "collect" if collect else "bounce"
    print(f"[B5-vs-plain] {name} ({scene.num_triangles} triangles, {bt.nodes.shape[0]} "
          f"nodes), {cfg.width}x{cfg.height} x {nb} {kind} launches: states on "
          f"{sub.numel()} pixel ids (every {every}th row) within 1e-4 on "
          f"{worst:.6f} of entries at worst (bar 0.995), max |err| {err:.3g}"
          f"{f'; states and hit records bit-identical: {same}' if collect else ''}")
    check(worst >= 0.995, f"B5 on {name} disagrees with plain: {worst:.6f}")
    if collect:
        check(same, f"B5's collect instance on {name} is not bit-identical to plain")
    check(bool(torch.isfinite(states[-1]).all().item()), f"B5 state on {name} not finite")

    # Search-only on the camera rays.
    packed = torch.stack([*states[0][:6], states[0][15]]).contiguous()
    w, i = pk.launch_bigmesh_kernel(bt.tables, bt.counts, bt.nodes, None, packed, 0,
                                    0, search_only=True)
    ww, wi = pk.bigmesh_search_plain(bt.tables, bt.counts,
                                     tuple(c[sub] for c in states[0][:6]),
                                     states[0][15][sub] > 0)
    torch.cuda.synchronize()
    s_close, s_err, _ = equal_share(w[:, sub], ww)
    idx_eq = (i[:, sub] == wi).all(dim=0).float().mean().item()
    print(f"[B5-vs-plain] {name} search-only, camera rays: winner within 1e-4 on "
          f"{s_close:.6f}, (family, index) equal on {idx_eq:.6f} (bars 0.995), max "
          f"|err| {s_err:.3g}; {(i[0] >= 0).float().mean().item():.4f} of rays hit")
    check(s_close >= 0.995 and idx_eq >= 0.995, f"B5 search on {name} disagrees")

    # Times: each bounce launch on its own input state, summed per frame.
    iters = 10 if scene.num_triangles < 5000 else 4
    frame_ms = sum(cuda_ms(lambda st=st, b=b: pk.launch_bigmesh_kernel(
        bt.tables, bt.counts, bt.nodes, pixel, st, 1, 16 + 4 * b, collect=collect),
        iters) for b, st in enumerate(states[:-1]))
    search_ms = cuda_ms(lambda: pk.launch_bigmesh_kernel(
        bt.tables, bt.counts, bt.nodes, None, packed, 0, 0, search_only=True), iters)

    def plain_frame():
        st = states[0][:, sub]
        for b in range(nb):
            st = pk.bigmesh_bounce_plain(bt.tables, bt.counts, pixel[sub], st, 1,
                                         16 + 4 * b, collect=collect)
            st = st[0] if collect else st
        return st

    plain_ms = cuda_ms(plain_frame, 1)
    # The bound counts this frame's work: per bounce the live lanes' seed
    # search and walk (the counting instance on the kernel's own input
    # state), the shading of each hit that scatters and the end of each
    # that does not; per launch the state in and out (128 B) of every lane
    # and the tables and nodes once, and the pixel id (8 B) of each lane
    # that scatters, the only lanes that read it.
    t_, s_, p_, _ = bt.counts
    seed = s_ * OPS_SPH + p_ * OPS_PLN + OPS_INV
    work = {}
    count = walk_counter(bt.tables, bt.counts, bt.nodes, work)
    ops = 0
    scattered = 0
    for b in range(nb):
        live = states[b][15] > 0
        count(states[b][:3].unbind(0), states[b][3:6].unbind(0), live)
        n_live = int(live.sum().item())
        scatter = int((states[b + 1][15] > 0).sum().item())
        scattered += scatter
        ops += n_live * seed + scatter * (OPS_SHADE + OPS_PCG) + (n_live - scatter) * OPS_END
    ops += walk_ops(work)
    table_bytes = 4 * (bt.tables.numel() + bt.nodes.numel())
    bnd, by = bound(nb * (n * (136 if collect else 128) + table_bytes) + 8 * scattered,
                    ops)
    live0 = int(states[0][15].sum().item())
    s_work = {}
    walk_counter(bt.tables, bt.counts, bt.nodes, s_work)(
        states[0][:3].unbind(0), states[0][3:6].unbind(0), states[0][15] > 0)
    s_bnd, s_by = bound(n * 56 + table_bytes, live0 * seed + walk_ops(s_work))
    print(f"[time] B5 {name}: {frame_ms:.4f} ms per {cfg.width}x{cfg.height} frame of "
          f"{nb} {kind} launches, plain {plain_ms:.4f} ms on its {sub.numel()} rays; "
          f"bound {bnd:.4f} ms by {by} (walk {work}), kernel at {bnd / frame_ms:.1%} of "
          f"it; search-only {search_ms:.4f} ms, bound {s_bnd:.4f} ms by {s_by} "
          f"({s_work}), at {s_bnd / search_ms:.1%} [{smi}]")
    return dict(check_launches=launches, max_abs_err=max(err, s_err), within_1e_4=worst,
                bit_identical=same, ms=frame_ms,
                plain_ms=plain_ms, plain_rays=sub.numel(), bound_ms=bnd, bound_by=by,
                search_ms=search_ms, search_bound_ms=s_bnd, search_bound_by=s_by,
                walk=work)


def route_work(bt, mode, pix, rays, frame, salt_base, nb, nrays):
    """The work of one frame of ``mode`` on this run's rays, for a bound:
    the per-bounce route on the card (B5's search-only launches) with every
    search's walk counted by count_bvh_walk ("box", "tri") and the lanes of
    each kind of work counted as trace_plain(work=...) counts them
    ("search", "scatter", "lambert", "end"); for modes 0-6 the searches
    and the hit pixels ("hits") -> (work, the census_hook census of the
    same searches)."""
    import torch

    from rvpt_tpu_torch.ops import pathkernel as pk
    from rvpt_tpu_torch.ops.bigmesh_route import per_bounce

    work, census = {}, {}
    walk = census_hook(bt, mode, work, census)

    def count(key, mask):
        work[key] = work.get(key, 0) + int(mask.sum().item())

    def search(o3, d3, live=None):
        walk(o3, d3, live)
        if mode < 7:  # K1's searches are counted where they run
            count("search", torch.ones_like(o3[0], dtype=torch.bool)
                  if live is None else live)
        return bt.search(o3, d3, live)

    if mode < 7:
        winner = search(rays[:3], rays[3:])
        count("hits", winner[5] >= 0)
        pk._primary_finalize(mode, nrays, bt._mat, pix, frame, salt_base, rays, winner,
                             search)
    else:
        per_bounce(bt, mode, pix, rays, frame, salt_base, nb, "standard", nrays, search,
                   count=count)
    return work, census


def route_bound(bt, mode, work, own, n, nrays):
    """walk_bounds of one frame of ``mode`` through the one-launch route:
    per ray its six components in (24 B), the pixel id (8) and the film
    (12), the tables and nodes once; the operations of ``work``
    (route_work): K1's searches and shading (k1_ops), or B3's finalize per
    pixel, its searches and AO's probes; and the walk's (``own``)."""
    t_, s_, p_, _ = bt.counts
    seed = s_ * OPS_SPH + p_ * OPS_PLN + OPS_INV
    table_bytes = 4 * (bt.tables.numel() + bt.nodes.numel())
    if mode >= 7:
        ops = k1_ops(work, seed)
    else:
        ops = n * OPS_FINALIZE[mode] + work["search"] * seed
        if mode == 5:
            ops += work["hits"] * nrays * (OPS_PCG + OPS_PROBE)
    return walk_bounds(n * (24 + 8 + 12) + table_bytes, ops, work, own)


def route_check(smi, dev, name, scene, cam, cfg, nb, every):
    """Phase 15's check of the big-mesh route on one mesh, modes 0-9
    (standard, AO with ``nb`` probes as the draw casts them): the
    one-launch route (K1's or B3's BVH form, rays in, BigMeshTracer) on the
    whole 1080p film against the per-bounce route composed of B5's launches
    (BigMeshTracer.search and .bounce) on the whole film and against its
    plain composition (bigmesh_bounce_plain, bigmesh_search_plain and the
    shading) on the pixel ids of every ``every``-th row, bit for bit; each
    route timed with CUDA events, the one-launch route beside its bound of
    this frame's work (route_work, route_bound)."""
    import torch

    from rvpt_tpu_torch.models.integrators import INTEGRATOR_NAMES
    from rvpt_tpu_torch.ops import pathkernel as pk
    from rvpt_tpu_torch.ops.bigmesh_route import per_bounce, plain_bounce
    from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays

    names = {v: k for k, v in INTEGRATOR_NAMES.items()}
    bt = pk.BigMeshTracer(scene)
    n = cfg.num_pixels
    pixel, xs, ys = _pixel_grid(cfg, dev)
    ray = jittered_camera_rays(cam, cfg, pixel, xs, ys, 1, 0)
    o, d = ray.origin, ray.direction
    rays = bt._rays(o, d)
    sub = torch.nonzero(ys % every == 0).squeeze(1)
    sub_rays = tuple(c[sub] for c in rays)
    big = scene.num_triangles > 50_000
    out = {}
    for mode in range(10):
        nrays = nb if mode == 5 else 1
        args = (1, 16, nb, "standard", nrays)

        def route(mode=mode, nrays=nrays):
            return bt.trace_mode(pixel, o, d, 1, mode, salt_base=16, max_bounces=nb,
                                 style="standard", nrays=nrays)

        def b5_route(mode=mode, args=args):
            return per_bounce(bt, mode, pixel, rays, *args, bt.search, bt.bounce)

        got = route()
        b5 = b5_route()
        t0 = time.perf_counter()
        want = per_bounce(bt, mode, pixel[sub], sub_rays, *args,
                          bounce=plain_bounce(bt))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        same_b5 = bool(torch.equal(got, b5))
        close, err, same = equal_share(got[:, sub], want)
        check(bool(torch.isfinite(got).all().item()), f"{name} mode {mode}: not finite")
        check(same_b5, f"{name} mode {mode}: the one-launch route differs from B5's "
              f"per-bounce route ({equal_share(got, b5)[0]:.6f} within 1e-4)")
        check(same, f"{name} mode {mode}: the one-launch route differs from the "
              f"per-bounce plain composition ({close:.6f} within 1e-4)")
        iters = 4 if big else 10
        ms = cuda_ms(route, iters)
        b5_ms = cuda_ms(b5_route, 2 if big or mode in (5, 7, 8) else 4)
        work, census = route_work(bt, mode, pixel, rays, *args[:3], nrays)
        summary = census_summary(census)
        own = summary["own"]
        bnds = route_bound(bt, mode, work, own, n, nrays)
        kernel = "B3" if mode < 7 else "K1"
        print(f"[route-vs-per-bounce] {name}, {cfg.width}x{cfg.height} x {nb}, mode {mode} "
              f"({names[mode]}{f', {nrays} probes' if mode == 5 else ''}): one {kernel} "
              f"BVH-form launch, rays in, bit-identical to B5's per-bounce route on the "
              f"film: {same_b5}, to its plain composition on {sub.numel()} pixel ids "
              f"(every {every}th row): {same}; {ms:.4f} ms per frame, B5's route "
              f"{b5_ms:.4f} ms, plain {plain_ms:.1f} ms on the {sub.numel()}; "
              f"{bounds_text(bnds, ms, work, own)} (work {work}) [{smi}]")
        print(f"[walk-census] {name} mode {mode} ({names[mode]}): {census_text(summary)}")
        out[names[mode]] = dict(max_abs_err=err, bit_identical=same and same_b5, ms=ms,
                                b5_route_ms=b5_ms, plain_ms=plain_ms,
                                plain_rays=sub.numel(), **bnds,
                                walk={k: work.get(k, 0) for k in ("box", "tri")},
                                walk_own=own, census=summary)
        del got, b5, want
    return out


def mesh_phases(smi, dev, out_dir, here):
    """Phases 14-16 (the BVH mesh display path); returns the kernels'
    numbers and the main path's launches."""
    import numpy as np
    import torch

    from rvpt_tpu_torch import FilmConfig, RenderSettings
    from rvpt_tpu_torch.models.integrators import INTEGRATOR_NAMES
    from rvpt_tpu_torch.ops import intersect_pk as ipk
    from rvpt_tpu_torch.ops import pathkernel as pk
    from rvpt_tpu_torch.ops.camera_rays import launch_camera_rays
    from rvpt_tpu_torch.ops.film import chw_to_hwc, to_srgb_u8
    from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays
    from rvpt_tpu_torch.renderer import Renderer
    from rvpt_tpu_torch.scene import builtin
    from rvpt_tpu_torch.scene.bvh import triangle_bounds, validate
    from rvpt_tpu_torch.utils.image import read_png

    names = {v: k for k, v in INTEGRATOR_NAMES.items()}
    quads = ("top_left_render_mode", "top_right_render_mode",
             "bottom_left_render_mode", "bottom_right_render_mode")
    hd = FilmConfig(1920, 1080)
    rcfg = FilmConfig(1024, 512)
    out = {}

    # ---- 14. BVH ingest
    makers = {
        "rabbit": lambda: builtin.rabbit(aspect=rcfg.aspect, device=dev),
        "mesh_demo(3)": lambda: builtin.mesh_demo(3, aspect=hd.aspect, device=dev),
        "mesh_demo(5)": lambda: builtin.mesh_demo(5, aspect=hd.aspect, device=dev),
        "terrain_demo(225)": lambda: builtin.terrain_demo(225, aspect=hd.aspect,
                                                          device=dev),
    }
    scenes = {}
    for name, make in makers.items():
        t0 = time.perf_counter()
        scene, cam = make()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        bvh = scene.bvh
        v = [x.cpu().numpy() for x in (scene.tri_v0, scene.tri_v1, scene.tri_v2)]
        _, bmin, bmax = triangle_bounds(*v)
        t0 = time.perf_counter()
        validate(bvh.host_view(), bmin, bmax)
        vsecs = time.perf_counter() - t0
        print(f"[bvh] {name}: {scene.num_triangles} triangles, builder {bvh.builder}, "
              f"scene and BVH built in {secs:.3f} s, {bvh.num_nodes} nodes, max_depth "
              f"{bvh.depth} (stack {pk.BVH_STACK}), largest leaf {bvh.max_leaf}; "
              f"validate passed in {vsecs:.2f} s; big mesh: {pk.is_bigmesh(scene)}")
        check(bvh.depth < pk.BVH_STACK, f"{name}: BVH deeper than the walk's stack")
        scenes[name] = (scene, cam)

    # ---- 15. the mesh kernels against their plain versions on the card
    rscene, rcam = scenes["rabbit"]
    rpt = pk.PathTracer(rscene)
    check(rpt.bvh_form, "rabbit does not take the BVH form")
    rn = rcfg.num_pixels
    rpix = torch.arange(rn, device=dev)
    rcp = pk.camera_params(rcam, rcfg)
    t_, s_, p_, _ = rpt.counts
    seed = s_ * OPS_SPH + p_ * OPS_PLN + OPS_INV
    table_bytes = 4 * (rpt.tables.numel() + rpt.nodes.numel())
    kw = dict(cam_params=rcp, cam_mode=rcam.mode, jitter_salt=0)

    def k1b():
        return pk.launch_path_kernel(rpt.tables, rpt.counts, None, rn, 1, 16, 8,
                                     "reference", tree=rpt.tree,
                                     **kw)

    def k1b_plain(work=None, census=None):
        return pk.trace_plain(rpt.tables, rpt.counts, rpix, 1, 16, 8, "reference",
                              tris_last=True, work=work, on_search=None if work is None
                              else census_hook(rpt, 9, work, census), **kw)

    work, census = {}, {}
    got, want = k1b(), k1b_plain(work, census)
    own = census_summary(census)["own"]
    torch.cuda.synchronize()
    close, err, same = equal_share(got, want)
    ms = cuda_ms(k1b, 20)
    plain_ms = cuda_ms(k1b_plain, 1)
    bnds = walk_bounds(12 * rn + table_bytes, k1_ops(work, seed) + rn * OPS_CAMERA,
                       work, own)
    print(f"[K1-vs-plain] BVH form, rabbit {rcfg.width}x{rcfg.height} x 8 bounces, Kajiya: "
          f"{close:.6f} of channels within 1e-4 (bar 0.995), max |err| {err:.3g}, "
          f"bit-identical: {same}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"{bounds_text(bnds, ms, work, own)} (work {work}) [{smi}]")
    check(bool(torch.isfinite(got).all().item()), "K1 BVH form not finite")
    check(close >= 0.995, f"K1 BVH form disagrees with plain: {close:.6f}")
    out["k1_bvh"] = dict(max_abs_err=err, within_1e_4=close, bit_identical=same,
                         ms=ms, plain_ms=plain_ms, **bnds, walk_own=own)

    out["b3_bvh"] = {}
    hits = None
    for mode in range(7):
        nrays = 4 if mode == 5 else 1

        def b3(mode=mode, nrays=nrays):
            return pk.launch_primary_kernel(rpt.tables, rpt.counts, None, rn, 1, 16,
                                            mode, nrays, rcp, rcam.mode, 0,
                                            tree=rpt.tree)

        def b3_plain(mode=mode, nrays=nrays, work=None, census=None):
            return pk.primary_plain(rpt.tables, rpt.counts, rpix, 1, 16, mode, nrays,
                                    rcp, rcam.mode, 0, tris_last=True,
                                    on_search=None if work is None else census_hook(
                                        rpt, mode, work, census))

        work, census = {}, {}
        got, want = b3(), b3_plain(work=work, census=census)
        own = census_summary(census)["own"]
        torch.cuda.synchronize()
        close, err, same = equal_share(got, want)
        if mode == 0:
            hits = int(want[0].sum().item())
        ms = cuda_ms(b3, 20)
        plain_ms = cuda_ms(b3_plain, 1)
        searches = rn + (hits * nrays if mode == 5 else hits if mode == 6 else 0)
        ops = rn * (OPS_CAMERA + OPS_FINALIZE[mode]) + searches * seed
        if mode == 5:
            ops += hits * nrays * (OPS_PCG + OPS_PROBE)
        bnds = walk_bounds(12 * rn + table_bytes, ops, work, own)
        print(f"[B3-vs-plain] BVH form, rabbit, mode {mode} ({names[mode]}"
              f"{', 4 probes' if mode == 5 else ''}): {close:.6f} of channels within "
              f"1e-4 (bar 0.995), max |err| {err:.3g}, bit-identical: {same}; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, {bounds_text(bnds, ms, work, own)} "
              f"[{smi}]")
        check(bool(torch.isfinite(got).all().item()), f"B3 BVH mode {mode} not finite")
        check(close >= 0.995, f"B3 BVH mode {mode} disagrees with plain: {close:.6f}")
        out["b3_bvh"][names[mode]] = dict(max_abs_err=err, within_1e_4=close,
                                          bit_identical=same, ms=ms, plain_ms=plain_ms,
                                          **bnds, walk_own=own)

    out["b5"] = {}
    for name, every in (("mesh_demo(3)", 1), ("mesh_demo(5)", 8),
                        ("terrain_demo(225)", 16)):
        scene, cam = scenes[name]
        out["b5"][name] = bigmesh_check(smi, dev, name, scene, cam, hd, 8, every)
    # The big-mesh route: one K1 or B3 launch per frame, against B5's; on
    # rabbit too (BigMeshTracer takes any BVH scene), so that every
    # BVH-form instance is held bit for bit against the binary walk.
    out["route"] = {}
    for name, cfg, every in (("mesh_demo(5)", hd, 8), ("terrain_demo(225)", hd, 16),
                             ("rabbit", rcfg, 4)):
        scene, cam = scenes[name]
        out["route"][name] = route_check(smi, dev, name, scene, cam, cfg, 8, every)

    # One B6 step on mesh_demo(5): the march's points after 3 steps.
    scene, cam = scenes["mesh_demo(5)"]
    bt = pk.BigMeshTracer(scene)
    pixel, xs, ys = _pixel_grid(hd, dev)
    ray = jittered_camera_rays(cam, hd, pixel, xs, ys, 1, 0)
    d = ray.direction.T.contiguous()
    p = ray.origin.T.contiguous()
    done = torch.zeros(hd.num_pixels, dtype=torch.bool, device=dev)
    for _ in range(3):
        dist = bt.distance(p, ~done)
        stop = dist < pk.MARCH_EPS
        p = torch.where(~done & ~stop, p + dist * d, p)
        done = done | stop
    p = p.contiguous()
    live = (~done).to(torch.float32)

    def b6():
        return pk.launch_bigmesh_hart(bt.hart_tables, bt.hart_count, bt.nodes, p, live)

    sub = torch.nonzero((ys % 8 == 0) & ~done).squeeze(1)
    got = b6()
    want = pk.bigmesh_distance_plain(bt.hart_tables, bt.hart_count, p[:, sub],
                                     torch.ones_like(sub, dtype=torch.bool))
    torch.cuda.synchronize()
    close, err, same = equal_share(got[sub], want)
    ms = cuda_ms(b6, 20)
    plain_ms = cuda_ms(lambda: pk.bigmesh_distance_plain(
        bt.hart_tables, bt.hart_count, p[:, sub], torch.ones_like(sub, dtype=torch.bool)), 1)
    box, tri = pk.count_hart_walk(bt.hart_tables, bt.hart_count, bt.nodes, p, ~done)
    work = {"hart_box": box, "hart_tri": tri}
    n_live = int((~done).sum().item())
    bnd, by = bound(hd.num_pixels * 20 + 4 * (bt.hart_tables.numel() + bt.nodes.numel()),
                    walk_ops(work) + n_live * OPS_HPOINT)
    print(f"[B6-vs-plain] mesh_demo(5), march step 4, {hd.width}x{hd.height}: "
          f"{n_live} live points, {sub.numel()} of them checked (every 8th row): "
          f"{close:.6f} within 1e-4 (bar 0.99), max |err| {err:.3g}, bit-identical: "
          f"{same}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms on the {sub.numel()}, "
          f"bound {bnd:.4f} ms by {by} ({work}), kernel at {bnd / ms:.1%} of it [{smi}]")
    check(close >= 0.99, f"B6 disagrees with plain: {close:.6f}")
    check(bool(torch.isinf(got[done]).all().item()), "B6 wrote a distance on a dead lane")
    out["b6"] = dict(max_abs_err=err, within_1e_4=close, bit_identical=same, ms=ms,
                     plain_ms=plain_ms, plain_points=sub.numel(), bound_ms=bnd,
                     bound_by=by)

    # The whole march in one launch (the Hart frame's path) against
    # bigmesh_march_plain on every 64th row of pixel ids: the plain march
    # runs 32 brute-force steps, too slow on every 8th row.
    o3 = ray.origin.T.contiguous()

    def march():
        return pk.launch_bigmesh_march(bt.hart_tables, bt.hart_count, bt.nodes, o3, d)

    steps = march()
    sub = torch.nonzero(ys % 64 == 0).squeeze(1)

    def march_plain():
        return pk.bigmesh_march_plain(bt.hart_tables, bt.hart_count,
                                      o3[:, sub].contiguous(), d[:, sub].contiguous())

    want = march_plain()
    torch.cuda.synchronize()
    scale = 1.0 / (pk.MARCH_ITER - 1)
    close, err, same = equal_share(steps[sub].to(torch.float32) * scale,
                                   want.to(torch.float32) * scale)
    ms = cuda_ms(march, 5)
    plain_ms = cuda_ms(march_plain, 1)
    csteps, mwork = pk.count_hart_march(bt.hart_tables, bt.hart_count, bt.nodes, o3, d)
    check(torch.equal(csteps, steps), "B6's march counting instance changed the steps")
    check(mwork["late"] == 0, f"{mwork['late']} rays stopped after B6's escape test "
          f"had ended their march")
    # The bound counts the work the march needs: its own warm-started walk
    # up to each ray's escape or stop (mwork's warm distances, a point-step
    # per walk), 24 B of ray in and 4 B of step out per ray, the tables
    # once.  The parent's work (the per-step design: a cold-start walk at
    # every step until the ray stops, past the escape too) is printed
    # beside it, at the same rates, and is not the bound.
    bnd, by = bound(hd.num_pixels * 28 + 4 * (bt.hart_tables.numel() + bt.nodes.numel()),
                    mwork["warm_box"] * OPS_HBOX + mwork["warm_tri"] * OPS_HTRI
                    + mwork["walks"] * OPS_HPOINT)
    parent_steps = int(torch.clamp(steps.long() + 1, max=pk.MARCH_ITER).sum().item())
    parent_ops = (mwork["cold_box"] * OPS_HBOX + mwork["cold_tri"] * OPS_HTRI
                  + parent_steps * OPS_HPOINT)
    parent_peak_ms = parent_ops / PEAK_FP32 * 1e3
    print(f"[B6-march-vs-plain] mesh_demo(5), the whole march in one launch, "
          f"{hd.width}x{hd.height}: {sub.numel()} rays checked (every 64th row): "
          f"{close:.6f} within 1e-4 of the plain value (bar 0.99), max |err| {err:.3g}, "
          f"bit-identical: {same}; kernel {ms:.4f} ms per Hart frame, plain "
          f"{plain_ms:.4f} ms on the {sub.numel()}; the march's warm-started walk "
          f"{mwork['warm_box']} box and {mwork['warm_tri']} triangle distances in "
          f"{mwork['walks']} walks (up to each ray's escape or stop); parent work "
          f"(the cold-start walk of every step the per-step design ran) "
          f"{mwork['cold_box']} box and {mwork['cold_tri']} triangle distances, "
          f"{parent_steps} point-steps, {parent_peak_ms:.4f} ms at peak; steps whose "
          f"minima differ {mwork['differ']}, stops after an escape {mwork['late']}; "
          f"bound {bnd:.4f} ms by {by} (the march's own walk), kernel at "
          f"{bnd / ms:.1%} of it [{smi}]")
    check(close >= 0.99, f"B6's march disagrees with plain: {close:.6f}")
    out["b6_march"] = dict(max_abs_err=err, within_1e_4=close, bit_identical=same,
                           ms=ms, plain_ms=plain_ms, plain_rays=sub.numel(),
                           bound_ms=bnd, bound_by=by, walk=mwork,
                           parent_work=dict(box=mwork["cold_box"], tri=mwork["cold_tri"],
                                            point_steps=parent_steps,
                                            ms_at_peak=parent_peak_ms))
    del bt, p, d, o3, done, live, ray, pixel, xs, ys, steps, csteps

    # ---- 16. the slice: Renderer.draw on the mesh scenes
    kernels = {"path_kernel": pk.launch_path_kernel,
               "bwd_kernel": pk.launch_bwd_kernel,
               "closest_hit": ipk.launch_closest_hit,
               "primary_kernel": pk.launch_primary_kernel,
               "hart_kernel": pk.launch_hart_kernel,
               "bigmesh_kernel": pk.launch_bigmesh_kernel,
               "bigmesh_hart": pk.launch_bigmesh_hart,
               "bigmesh_march": pk.launch_bigmesh_march}

    # The camera-ray kernel's launches per loop, apart from the tracers':
    # the big-mesh routes make their rays with it, the other routes in K1
    # and B3 themselves.
    rays_launches = out["camera_rays_launches"] = {}

    def draw_loop(label, scene, cam, cfg, st, frames, per_frame, png=None):
        r = Renderer(scene, cam, st, cfg)
        r.draw()  # the first draw builds the camera vector and the kernels' state
        r.flush()
        for k in kernels.values():
            k.launches = 0
        launch_camera_rays.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(frames):
            r.draw()
        r.flush()
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) / frames * 1e3
        ran = {name: c for name, k in kernels.items() if (c := k.launches)}
        launches["bigmesh_kernel"] += pk.launch_bigmesh_kernel.launches
        rays_launches[label] = launch_camera_rays.launches
        want = {k: v * frames for k, v in per_frame.items()}
        check(ran == want, f"{label}: {frames} draws launched {ran}, expected {want}")
        accum = r.film.accum
        check(bool(torch.isfinite(accum).all().item()), f"{label}: film not finite")
        # Not black: the rabbit covers about 2% of its film, so a debug view
        # of it has a small mean; a lit pixel is enough.
        check(accum.max().item() > 0.01, f"{label}: film is black")
        saved = ""
        if png:
            path = os.path.join(out_dir, png)
            r.save_image(path)
            check(read_png(path).shape == (cfg.height, cfg.width, 3),
                  f"{label}: saved image has the wrong shape")
            saved = f"; saved {path}"
        print(f"[mesh-slice] {label}, {cfg.width}x{cfg.height}, {st.max_bounces} bounces, "
              f"{st.style}: Renderer.draw x{frames} {frame_ms:.4f} ms/frame; launches "
              f"{ran}, camera rays {rays_launches[label]}; film mean "
              f"{accum.mean().item():.6f}{saved} [{smi}]")
        return frame_ms, ran

    hd8 = RenderSettings(max_bounces=8, style="standard")
    launches = {"bigmesh_kernel": 0}  # B5: on no draw, so 0
    out["draw_ms"] = {}
    for name in ("mesh_demo(5)", "mesh_demo(3)"):
        scene, cam = scenes[name]
        png = f"torch_{name.replace('(', '').replace(')', '')}_1080p.png"
        ms, ran = draw_loop(f"{name} Kajiya", scene, cam, hd, hd8, 8,
                            {"path_kernel": 1}, png)
        out["draw_ms"][f"{name} kajiya"] = ms
        if name == "mesh_demo(5)":
            launches["path_kernel_bigmesh"] = ran["path_kernel"]
    rst = RenderSettings(max_bounces=8)
    ms, ran = draw_loop("rabbit Kajiya", rscene, rcam, rcfg, rst, 8,
                        {"path_kernel": 1}, "torch_rabbit_1024x512.png")
    out["draw_ms"]["rabbit kajiya"] = ms
    launches["path_kernel_bvh"] = ran["path_kernel"]
    launches["primary_kernel_bvh"] = 0
    for mode in range(7):
        st = rst.replace(**dict.fromkeys(quads, mode))
        ms, ran = draw_loop(f"rabbit mode {mode} ({names[mode]})", rscene, rcam, rcfg,
                            st, 2, {"primary_kernel": 1})
        launches["primary_kernel_bvh"] += ran["primary_kernel"]
        out["draw_ms"][f"rabbit {names[mode]}"] = ms
    # Launches per frame on a big mesh, any bounce count: one B3 launch
    # (BVH form, rays in) per debug frame, AO's probes and Appel's shadow
    # rays in it; one K1 launch (BVH form, rays in) per Whitted, Cook or
    # Kajiya frame; Hart one march launch per frame (B6's per-step
    # instance never: it is not on the display path); B5 never.
    scene, cam = scenes["mesh_demo(5)"]
    launches["primary_kernel_bigmesh"] = 0
    for mode in (0, 1, 2, 3, 4, 5, 6, 7, 8, 10):
        st = hd8.replace(**dict.fromkeys(quads, mode))
        per = ({"bigmesh_march": 1} if mode == 10 else {"path_kernel": 1} if mode >= 7
               else {"primary_kernel": 1})
        ms, ran = draw_loop(f"mesh_demo(5) mode {mode} ({names[mode]})", scene, cam, hd,
                            st, 2, per)
        out["draw_ms"][f"mesh_demo(5) {names[mode]}"] = ms
        if mode == 10:
            launches["bigmesh_hart"] = ran["bigmesh_march"]
        if mode < 7:
            launches["primary_kernel_bigmesh"] += ran["primary_kernel"]
    for label, count in rays_launches.items():
        if label.startswith("mesh_demo(5)"):  # the Kajiya draws x8, each mode x2
            check(count == (8 if label == "mesh_demo(5) Kajiya" else 2),
                  f"{label}: the camera-ray kernel launched {count} times, not "
                  f"once per frame")
    launches["camera_rays"] = rays_launches["mesh_demo(5) Kajiya"]
    split = hd8.replace(**dict(zip(quads, (5, 7, 10, 9))))
    ms, _ = draw_loop("mesh_demo(5) split-screen (AO, Whitted, Hart, Kajiya)", scene,
                      cam, hd, split, 2,
                      {"primary_kernel": 1, "path_kernel": 2, "bigmesh_march": 1},
                      "torch_mesh_demo5_split_1080p.png")
    out["draw_ms"]["mesh_demo(5) split"] = ms
    scene, cam = scenes["terrain_demo(225)"]
    ms, _ = draw_loop("terrain_demo(225) Kajiya", scene, cam, hd, hd8, 2,
                      {"path_kernel": 1}, "torch_terrain_1080p.png")
    out["draw_ms"]["terrain_demo(225) kajiya"] = ms
    out["launches"] = launches

    for gname, make, size in (
            ("rabbit_kajiya", lambda c: builtin.rabbit(aspect=c.aspect, device=dev),
             (256, 128)),
            ("mesh2_kajiya", lambda c: builtin.mesh_demo(2, aspect=c.aspect, device=dev),
             (128, 128))):
        gcfg = FilmConfig(*size)
        gscene, gcam = make(gcfg)
        gr = Renderer(gscene, gcam, RenderSettings(max_bounces=8), gcfg)
        for _ in range(2):
            gr.draw()
        gr.flush()
        img = to_srgb_u8(chw_to_hwc(gr.film.accum)).cpu().numpy().astype(int)
        golden = read_png(os.path.join(here, "tests", "goldens", f"{gname}.png"))
        off = (np.abs(img - golden.astype(int)) > 2).mean()
        print(f"[goldens] {gname} via the kernels: {off:.4%} of subpixels more than "
              f"2 u8 steps off (recorded, not asserted; the CPU bar is 0.2%)")
    return out


def lookup_check(smi, label, tables, idx, n_seg, live=None):
    """Phase 17 on one table: B7's gather on ``tables`` f32[C, T] at ``idx``
    against gather_plain (bit for bit) and its segment sum of a seeded
    cotangent of the mean loss's scale (``n_seg`` columns; zero outside
    ``live`` where given, as the replay's is on the lanes that hit no
    triangle) against segsum_plain's float64 sum (rtol 1e-5, atol 1e-5 in
    units of that scale), twice; each timed beside its plain version, the
    PyTorch call that computes it (index_select; index_add_ into a zeroed
    f32 buffer) and its bound."""
    import numpy as np
    import torch

    from rvpt_tpu_torch.ops import replay_soa as rs

    c, t = tables.shape
    n = idx.numel()
    scale = 1.0 / (3 * n)
    g = torch.from_numpy(np.random.default_rng(t).normal(size=(n_seg, n))
                         .astype(np.float32) * np.float32(scale)).to(tables.device)
    if live is not None:
        g = g * live
    got = rs.launch_gather(tables, idx)
    want = rs.gather_plain(tables, idx)
    s1 = rs.launch_segsum(idx, g, t)
    s2 = rs.launch_segsum(idx, g, t)
    ref = rs.segsum_plain(idx, g, t)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, want))
    seg_ok = torch.allclose(s1 / scale, ref / scale, rtol=1e-5, atol=1e-5)
    rep_ok = torch.allclose(s1 / scale, s2 / scale, rtol=1e-5, atol=1e-5)
    seg_err = ((s1 - ref).abs().max() / scale).item()
    rep_same = bool(torch.equal(s1, s2))
    rows = int(torch.unique(idx).numel())
    print(f"[B7-vs-plain] {label}: {c} columns x {t} rows, {n} indices ({rows} rows hit, "
          f"the busiest {int(torch.bincount(idx).max())} times): gather bit-identical: "
          f"{same}; segment sum of {n_seg} columns within rtol 1e-5 atol 1e-5 of the "
          f"float64 sum in units of g's scale: {seg_ok}, max |err| {seg_err:.3g}; a "
          f"second call within the bar: {rep_ok}, bit-identical: {rep_same}")
    check(same, f"B7 gather on {label} is not bit-identical to plain")
    check(seg_ok, f"B7 segment sum on {label} disagrees: max |err| {seg_err:.3g}")
    check(rep_ok, f"B7 segment sum on {label} is not reproducible within the bar")
    g_ms = cuda_ms(lambda: rs.launch_gather(tables, idx), 20)
    g_plain = cuda_ms(lambda: rs.gather_plain(tables, idx), 5)
    g_lib = cuda_ms(lambda: tables.index_select(1, idx), 20)
    s_ms = cuda_ms(lambda: rs.launch_segsum(idx, g, t), 20)
    s_plain = cuda_ms(lambda: rs.segsum_plain(idx, g, t), 5)
    s_lib = cuda_ms(lambda: torch.zeros((n_seg, t), device=g.device).index_add_(1, idx, g), 20)
    # Each input read once, each output written once: the index and the C
    # gathered values per ray and the tables once; the index and the
    # cotangents per ray and the [C, T] result once, one add per cotangent.
    g_bnd, g_by = bound(n * (4 + 4 * c) + 4 * c * t, 0)
    s_bnd, s_by = bound(n * (4 + 4 * n_seg) + 4 * n_seg * t, n * n_seg)
    parts, _ = device_ms(lambda: rs.launch_segsum(idx, g, t), 10, SEG_PARTS)
    rows_seen = row_stats(idx, g)
    print(f"[time] B7 {label}: gather {g_ms:.4f} ms, plain {g_plain:.4f} ms, "
          f"index_select {g_lib:.4f} ms, bound {g_bnd:.4f} ms by {g_by} (kernel at "
          f"{g_bnd / g_ms:.1%}); segment sum {s_ms:.4f} ms, plain {s_plain:.4f} ms, "
          f"index_add_ {s_lib:.4f} ms, bound {s_bnd:.4f} ms by {s_by} (kernel at "
          f"{s_bnd / s_ms:.1%}); device ms of its memset, summing kernel and rounding "
          f"pass {({k: round(v, 4) for k, v in parts.items()})} [{smi}]")
    print(f"[B7-rows] {label}: {rows_seen}")
    return ({"max_abs_err": 0.0 if same else float("inf"), "bit_identical": same,
             "ms": g_ms, "plain_ms": g_plain, "library_ms": g_lib, "bound_ms": g_bnd,
             "bound_by": g_by},
            {"max_abs_err": seg_err * scale, "max_abs_err_in_g_scale": seg_err,
             "repeat_bit_identical": rep_same, "ms": s_ms, "plain_ms": s_plain,
             "library_ms": s_lib, "bound_ms": s_bnd, "bound_by": s_by,
             "parts_ms": parts, "rows": rows_seen})


def hits_check(smi, dev, label, scene, cam, cfg, nb, every, timed=True):
    """Phase 18's check of K1's hits-only collect instance on one scene
    (rays in, standard): its hits bit for bit the full collect instance's
    rec_i on the whole film and trace_plain(collect=True)'s on the pixel
    ids of every ``every``-th row, its radiance that of the launches with
    the full record and without records; with ``timed`` (a BVH scene) it
    and the full collect instance timed beside its bound: the rays (24 B),
    pixel id (8), film (12) and 8 B of hits per ray-bounce, the tables and
    nodes once, and the work of the same trace (route_work)."""
    import torch

    from rvpt_tpu_torch.ops import pathkernel as pk
    from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays

    pt = pk.PathTracer(scene)
    n = cfg.num_pixels
    pixel, xs, ys = _pixel_grid(cfg, dev)
    ray = jittered_camera_rays(cam, cfg, pixel, xs, ys, 1, 0)
    rays = tuple(c.contiguous() for c in (*ray.origin.T, *ray.direction.T))

    def k1(collect=False):
        return pk.launch_path_kernel(pt.tables, pt.counts, pixel, n, 1, 16, nb,
                                     "standard", rays=rays, collect=collect,
                                     tree=pt.tree)

    got, hits = k1("hits")
    full, rec = k1(True)
    bare = k1()
    sub = torch.nonzero(ys % every == 0).squeeze(1)
    want, wrec = pk.trace_plain(pt.tables, pt.counts, pixel[sub], 1, 16, nb, "standard",
                                rays=tuple(c[sub] for c in rays), collect=True,
                                tris_last=pt.bvh_form)
    torch.cuda.synchronize()
    same_full = bool(torch.equal(hits, rec.hits))
    same_plain = bool(torch.equal(hits[:, :, sub], wrec.hits))
    same_b5 = True
    if pt.bvh_form:  # B5's per-bounce route: its collect instance, bounce by bounce
        bt = pk.BigMeshTracer(scene)
        start = pk._start_state(rays, "kajiya")
        st = torch.stack([*start[:15], start[15].to(torch.float32)])
        b5_hits = []
        for b in range(nb):
            st, h = bt.bounce(pixel, st, 1, 16 + 4 * b, collect=True)
            b5_hits.append(h)
        same_b5 = bool(torch.equal(hits, torch.stack(b5_hits)))
        del bt, st, b5_hits
    radiance = bool(torch.equal(got, bare) and torch.equal(got, full))
    close, err, _ = equal_share(got[:, sub], want)
    form = "BVH" if pt.bvh_form else "row"
    print(f"[records] K1's hits-only collect, {form} form, {label} {cfg.width}x{cfg.height} "
          f"x {nb}, rays in: hits bit-identical to the full collect instance's: "
          f"{same_full}, to trace_plain's on {sub.numel()} pixel ids: {same_plain}"
          f"{f', to B5 collect route on the film: {same_b5}' if pt.bvh_form else ''}; "
          f"radiance equal to the launches with the full record and without: {radiance}, "
          f"{close:.6f} of channels within 1e-4 of plain; "
          f"{(hits[:, 0] == 0).float().mean().item():.4f} of ray-bounces on a triangle")
    check(same_full and same_plain and same_b5, f"{label}: K1's hits-only records differ")
    check(radiance, f"{label}: K1's hits-only instance changes the radiance")
    check(close >= 0.995, f"{label}: K1 with hits disagrees with plain: {close:.6f}")
    del full, rec, bare, want, wrec
    if not timed:
        return dict(bit_identical=same_full and same_plain and same_b5, max_abs_err=err)
    iters = 10
    ms = cuda_ms(lambda: k1("hits"), iters)
    full_ms = cuda_ms(lambda: k1(True), iters)
    t0 = time.perf_counter()
    pk.trace_plain(pt.tables, pt.counts, pixel[sub], 1, 16, nb, "standard",
                   rays=tuple(c[sub] for c in rays), collect="hits", tris_last=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bt = pk.BigMeshTracer(scene)
    work, census = route_work(bt, 9, pixel, rays, 1, 16, nb, 1)
    own = census_summary(census)["own"]
    t_, s_, p_, _ = bt.counts
    seed = s_ * OPS_SPH + p_ * OPS_PLN + OPS_INV
    bnds = walk_bounds(n * (24 + 8 + 12 + 8 * nb)
                       + 4 * (bt.tables.numel() + bt.nodes.numel()),
                       k1_ops(work, seed), work, own)
    print(f"[time] K1 hits-only collect, {label}: {ms:.4f} ms, the full collect instance "
          f"{full_ms:.4f} ms, plain {plain_ms:.1f} ms on {sub.numel()} rays; "
          f"{bounds_text(bnds, ms, work, own)} (work {work}) [{smi}]")
    return dict(max_abs_err=err, bit_identical=same_full and same_plain and same_b5, ms=ms,
                full_collect_ms=full_ms, plain_ms=plain_ms, plain_rays=sub.numel(),
                **bnds, walk_own=own)


def mesh_step_check(smi, dev, label, scene, cam, cfg, nb, counters, backward="auto",
                    time_it=True):
    """One fwd+bwd step of the mean image over albedo, emission and the
    vertices through make_fast_kajiya (the main path of this slice), with
    every launch count zeroed before it and read after it; its primal
    against the tracer's output without records (bit for bit) and its
    gradients against autograd through kajiya_from_hits on the records of
    the same forward (rtol 1e-3, atol 1e-6 in units of each gradient's
    scale); then its time (CUDA events over 5 steps after 2) and its peak
    memory.  The reference runs in float64: autograd's transpose of
    indexing sums each row's duplicates one by one, and in f32 at 1080p
    (millions of rays on three material rows) that was 6% off."""
    import torch

    from rvpt_tpu_torch.core.types import Ray
    from rvpt_tpu_torch.ops import pathkernel as pk
    from rvpt_tpu_torch.ops import replay_soa as rs
    from rvpt_tpu_torch.ops.fast_grad import kajiya_from_hits, make_fast_kajiya
    from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays
    from rvpt_tpu_torch.train import inverse

    pixel, xs, ys = _pixel_grid(cfg, dev)
    ray = jittered_camera_rays(cam, cfg, pixel, xs, ys, 1, 0)
    ray = Ray(ray.origin.contiguous(), ray.direction.contiguous())
    trace = make_fast_kajiya(scene, 16, nb, style="standard", backward=backward)
    groups = ("albedo", "emission", "vertices")

    def leaves():
        return {k: x.detach().clone().requires_grad_(True)
                for k, x in inverse.trainable_params(scene, groups).items()}

    p = leaves()

    def step(frame):
        s = inverse.apply_params(scene, p)
        out = trace(s, ray.origin, ray.direction, pixel, frame)
        return out, torch.autograd.grad(torch.mean(out), list(p.values()))

    def reference(fams, idxs):
        q = {k: x.detach().double().requires_grad_(True)
             for k, x in inverse.trainable_params(scene, groups).items()}
        r64 = Ray(ray.origin.double(), ray.direction.double())
        out = kajiya_from_hits(inverse.apply_params(scene, q), r64, pixel, 1, 16,
                               fams, idxs, "standard")
        return [g.float() for g in torch.autograd.grad(torch.mean(out), list(q.values()))]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for k in counters.values():
        k.launches = 0
    out, grads = step(1)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in counters.items()}
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    bigmesh = pk.is_bigmesh(scene)
    if bigmesh:
        tracer = pk.BigMeshTracer(scene)
        bare = tracer.trace(pixel, ray.origin, ray.direction, 1, 16, nb,
                            style="standard").T
        _, (fams, idxs) = tracer.trace(pixel, ray.origin, ray.direction, 1, 16, nb,
                                       style="standard", collect_hits=True)
    else:
        pt = pk.PathTracer(scene)
        bare = torch.stack(pt.trace(pixel, ray.origin, ray.direction, 1, 16, nb,
                                    style="standard"), dim=-1)
        _, rec = pt.trace(pixel, ray.origin, ray.direction, 1, 16, nb,
                          style="standard", collect_states=True)
        fams, idxs = pt.hits_from_record(rec)
        del rec
    same = bool(torch.equal(out.detach(), bare))
    t0 = time.perf_counter()
    ref = reference(fams, idxs)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    del fams, idxs, bare
    errs = {}
    for k, a, b in zip(p, grads, ref):
        sc = b.abs().max().item()
        ok = bool(torch.isfinite(a).all()) and sc > 0 and torch.allclose(
            a / sc, b / sc, rtol=1e-3, atol=1e-6)
        errs[k] = (a - b).abs().max().item() / sc if sc > 0 else float("inf")
        check(ok, f"{label}: d loss / d {k} disagrees with autograd through "
              f"kajiya_from_hits: max |err| {errs[k]:.3g} of its scale {sc:.3g}")
    print(f"[mesh-step] {label}, {cfg.width}x{cfg.height} x {nb} bounces, standard, "
          f"backward {backward}: primal bit-identical to the tracer without records: "
          f"{same}; gradients (albedo, emission, vertices) within rtol 1e-3 atol 1e-6 "
          f"of autograd through kajiya_from_hits in float64 on the same records "
          f"({ref_s:.1f} s), max |err| in "
          f"units of each gradient's scale {({k: float(f'{v:.3g}') for k, v in errs.items()})}; "
          f"loss {torch.mean(out).item():.6f}; launches {launches}; peak memory "
          f"{peak_gb:.2f} GB above the {base / 1e9:.2f} GB held before [{smi}]")
    check(same, f"{label}: the paired trace's primal is not the tracer's output")
    del ref, out, grads
    res = dict(launches=launches, primal_bit_identical=same, grad_err=errs,
               peak_gb=peak_gb)
    if time_it:
        for f in range(2):
            step(2 + f)
        steps = 5
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for f in range(steps):
            step(4 + f)
        stop.record()
        stop.synchronize()
        res["step_ms"] = start.elapsed_time(stop) / steps
        print(f"[mesh-step] {label}: fwd+bwd {res['step_ms']:.4f} ms/step, "
              f"{cfg.num_pixels * nb / res['step_ms'] / 1e3:.1f} Mrays/s "
              f"(W*H*aa*bounces per step) [{smi}]")
        # B7's segment sums inside the step: their ids' rows (one more
        # step, through a wrapper of the replay's segsum that counts them
        # before each call) and their device time (torch.profiler over two
        # more steps).
        seen = []
        real = rs.segsum

        def counted(idx, g, t_rows):
            seen.append(row_stats(idx, g))
            return real(idx, g, t_rows)

        rs.segsum = counted
        try:
            step(9)
        finally:
            rs.segsum = real
        parts, total = device_ms(lambda: step(10), 2, SEG_PARTS)
        res.update(segsum_rows=seen, segsum_parts_ms=parts, device_ms=total,
                   segsum_ms=sum(parts.values()))
        for k, rows in enumerate(seen):
            print(f"[B7-rows] {label} step, segment sum {k}: {rows}")
        print(f"[mesh-step] {label}: the step's {len(seen)} segment sums take "
              f"{res['segsum_ms']:.4f} ms of its {total:.4f} ms device time (memset, "
              f"summing kernel, rounding pass: "
              f"{({k: round(v, 4) for k, v in parts.items()})}) [{smi}]")
    return res


def mesh_grad_phases(smi, dev, counters):
    """Phases 17-21 (the mesh gradient path); returns the kernels' numbers
    and the main paths' launches."""
    import numpy as np
    import torch

    from rvpt_tpu_torch import FilmConfig, RenderSettings
    from rvpt_tpu_torch.models.integrators import integrator_kajiya
    from rvpt_tpu_torch.ops import pathkernel as pk
    from rvpt_tpu_torch.ops.fast_grad import make_fast_kajiya
    from rvpt_tpu_torch.render import (_pixel_grid, jittered_camera_rays,
                                       render_sample_fast_chw)
    from rvpt_tpu_torch.scene import builtin
    from rvpt_tpu_torch.train import inverse

    hd = FilmConfig(1920, 1080)
    rcfg = FilmConfig(1024, 512)
    nb = 8
    mesh3, cam3 = builtin.mesh_demo(3, aspect=hd.aspect, device=dev)
    mesh5, cam5 = builtin.mesh_demo(5, aspect=hd.aspect, device=dev)
    rabbit, rcam = builtin.rabbit(aspect=rcfg.aspect, device=dev)
    out = {}

    # ---- 17. B7: the gather and the segment sum against their plain versions
    # mesh_demo(5)'s triangle tables (v0, v1, v2, material id) at the
    # indices the replay's second bounce gives them (B5's records, clipped
    # as the replay clips them: misses and other families read row 0), and a
    # 140,000-row table at 2,073,600 pixel-coherent ids.
    bt = pk.BigMeshTracer(mesh5)
    pixel, xs, ys = _pixel_grid(hd, dev)
    ray = jittered_camera_rays(cam5, hd, pixel, xs, ys, 1, 0)
    _, (fams, idxs) = bt.trace(pixel, ray.origin, ray.direction, 1, 16, 2,
                               collect_hits=True)
    t5 = mesh5.num_triangles
    tabs5 = torch.cat([mesh5.tri_v0.T, mesh5.tri_v1.T, mesh5.tri_v2.T,
                       mesh5.tri_mat.to(torch.float32)[None]]).contiguous()
    idx5 = idxs[1].clamp(0, t5 - 1).to(torch.int32).contiguous()
    on_tri = fams[1] == 0
    print(f"[B7] mesh_demo(5) bounce-2 records: {on_tri.float().mean().item():.4f} "
          f"of rays on a triangle")
    del fams, idxs, bt, ray
    r = np.random.default_rng(17)
    t_huge = 140_000
    base = np.arange(hd.num_pixels, dtype=np.int64) * t_huge // hd.num_pixels
    huge_idx = np.clip(base + r.integers(-300, 300, hd.num_pixels), 0, t_huge - 1)
    huge = torch.from_numpy(r.standard_normal((10, t_huge)).astype(np.float32)).to(dev)
    gat5, seg5 = lookup_check(smi, "mesh_demo(5) tables, 1080p bounce-2 ids", tabs5,
                              idx5, 9, on_tri)
    # The same ids with every cotangent non-zero: row 0 takes every lane
    # that hit no triangle (the hot row the zero skip spares the replay).
    lookup_check(smi, "mesh_demo(5) tables, 1080p bounce-2 ids, no zero cotangent",
                 tabs5, idx5, 9)
    gat_h, seg_h = lookup_check(smi, "140,000-row table, 1080p coherent ids", huge,
                                torch.from_numpy(huge_idx.astype(np.int32)).to(dev), 9)
    out["gather"] = {**gat5, "rows_140000": gat_h}
    out["segsum"] = {**seg5, "rows_140000": seg_h}
    del tabs5, idx5, huge, on_tri

    # ---- 18. records: K1's BVH form on rabbit, B5's collect instance
    rpt = pk.PathTracer(rabbit)
    rn = rcfg.num_pixels
    rpix, rxs, rys = _pixel_grid(rcfg, dev)
    rray = jittered_camera_rays(rcam, rcfg, rpix, rxs, rys, 1, 0)
    rays = tuple(c.contiguous() for c in (*rray.origin.T, *rray.direction.T))

    def k1bc():
        return pk.launch_path_kernel(rpt.tables, rpt.counts, rpix, rn, 1, 16, nb,
                                     "standard", rays=rays, collect=True,
                                     tree=rpt.tree)

    def k1bc_plain(work=None, census=None):
        return pk.trace_plain(rpt.tables, rpt.counts, rpix, 1, 16, nb, "standard",
                              rays=rays, collect=True, tris_last=True, work=work,
                              on_search=None if work is None else census_hook(
                                  rpt, 9, work, census))

    work, census = {}, {}
    (got, rec), (want, wrec) = k1bc(), k1bc_plain(work, census)
    own = census_summary(census)["own"]
    bare = pk.launch_path_kernel(rpt.tables, rpt.counts, rpix, rn, 1, 16, nb,
                                 "standard", rays=rays, tree=rpt.tree)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in ((got, want), (rec.hits, wrec.hits),
                                              (rec.fields, wrec.fields)))
    err = max((got - want).abs().max().item(),
              (rec.fields - wrec.fields).abs().max().item())
    print(f"[records] K1's BVH form with records, rabbit {rcfg.width}x{rcfg.height} x {nb} "
          f"bounces, rays in: radiance equal to the display instance's: "
          f"{torch.equal(got, bare)}; radiance, (family, index) and fields "
          f"bit-identical to trace_plain's: {same}, max |err| {err:.3g}; "
          f"{(rec.hits[:, 0] == 0).float().mean().item():.4f} of ray-bounces on a triangle")
    check(torch.equal(got, bare), "K1's BVH form changes its radiance with records")
    check(same, "K1's BVH-form records are not bit-identical to trace_plain's")
    del got, want, rec, wrec, bare
    ms = cuda_ms(k1bc, 20)
    plain_ms = cuda_ms(k1bc_plain, 1)
    t_, s_, p_, _ = rpt.counts
    seed = s_ * OPS_SPH + p_ * OPS_PLN + OPS_INV
    # rays in (24 B), pixel ids (8), the film (12), 60 B per record slot,
    # the tables and nodes once
    bnds = walk_bounds(rn * (24 + 8 + 12 + 60 * nb)
                       + 4 * (rpt.tables.numel() + rpt.nodes.numel()),
                       k1_ops(work, seed), work, own)
    print(f"[time] K1 BVH-form collect, rabbit: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"{bounds_text(bnds, ms, work, own)} (work {work}) [{smi}]")
    out["k1_bvh_collect"] = dict(max_abs_err=err, bit_identical=same, ms=ms,
                                 plain_ms=plain_ms, **bnds, walk_own=own)
    # K1's hits-only collect instance: the row form on the Cornell box,
    # the BVH form on rabbit and on mesh_demo(5), the mesh step's records.
    cornell, ccam = builtin.cornell_box(aspect=hd.aspect, device=dev)
    hits_check(smi, dev, "cornell", cornell, ccam, hd, 4, 8, timed=False)
    hits_check(smi, dev, "rabbit", rabbit, rcam, rcfg, nb, 1, timed=False)
    out["k1_hits"] = hits_check(smi, dev, "mesh_demo(5)", mesh5, cam5, hd, nb, 8)
    terrain, tcam = builtin.terrain_demo(225, aspect=hd.aspect, device=dev)
    hits_check(smi, dev, "terrain_demo(225)", terrain, tcam, hd, nb, 16, timed=False)
    del terrain
    del cornell
    out["b5_collect"] = bigmesh_check(smi, dev, "mesh_demo(5)", mesh5, cam5, hd, nb, 8,
                                      collect=True)

    # ---- 19. the mesh fwd+bwd step at 1080p x 8: this slice's main path
    out["steps"] = {}
    for label, scene, cam in (("mesh_demo(3)", mesh3, cam3),
                              ("mesh_demo(5)", mesh5, cam5)):
        res = mesh_step_check(smi, dev, label, scene, cam, hd, nb, counters)
        want = {"path_kernel": 1, "replay_gather": nb, "replay_segsum": nb - 1}
        ran = {k: v for k, v in res["launches"].items() if v}
        check(ran == want, f"{label}: a step launched {ran}, expected {want} (one K1 "
              f"hits-only collect launch, one gather per bounce, one segment sum per "
              f"bounce whose vertices reach the image, no B5)")
        out["steps"][label] = res
    # ... and at 320x180 against autograd through integrator_kajiya (B8)
    small = FilmConfig(320, 180)
    scene, cam = builtin.mesh_demo(3, aspect=small.aspect, device=dev)
    pixel, xs, ys = _pixel_grid(small, dev)
    ray = jittered_camera_rays(cam, small, pixel, xs, ys, 1, 0)
    st = RenderSettings(max_bounces=nb, style="standard")
    trace = make_fast_kajiya(scene, 16, nb, style="standard")
    groups = ("albedo", "emission", "vertices")

    def small_grads(run):
        p = {k: x.detach().clone().requires_grad_(True)
             for k, x in inverse.trainable_params(scene, groups).items()}
        return list(p), torch.autograd.grad(
            torch.mean(run(inverse.apply_params(scene, p))), list(p.values()))

    names, fast = small_grads(lambda s: trace(s, ray.origin, ray.direction, pixel, 1))
    _, ref = small_grads(lambda s: integrator_kajiya(s, ray, pixel, 1, st, salt_base=16))
    torch.cuda.synchronize()
    for k, a, b in zip(names, fast, ref):
        sc = b.abs().max().item()
        ok = sc > 0 and torch.allclose(a / sc, b / sc, rtol=2e-2, atol=1e-5)
        e = (a - b).abs().max().item() / max(sc, 1e-30)
        print(f"[mesh-step] mesh_demo(3) {small.width}x{small.height} x {nb}: d loss / d "
              f"{k} vs autograd through integrator_kajiya (B8): within rtol 2e-2 atol "
              f"1e-5 in units of its scale {sc:.4g}: {ok}, max |err| {e:.3g}")
        check(ok, f"mesh_demo(3) d loss / d {k} disagrees with integrator_kajiya")
    del fast, ref, scene

    # ---- 20. rabbit at 1024x512 x 8: K1's BVH-form records, then K2 or B7
    out["rabbit"] = {}
    for backward in ("auto", "soa"):
        res = mesh_step_check(smi, dev, "rabbit", rabbit, rcam, rcfg, nb, counters,
                              backward=backward, time_it=backward == "auto")
        ran = {k: v for k, v in res["launches"].items() if v}
        want = ({"path_kernel": 1, "bwd_kernel": 1} if backward == "auto" else
                {"path_kernel": 1, "replay_gather": nb, "replay_segsum": nb - 1})
        check(ran == want, f"rabbit {backward}: a step launched {ran}, expected {want}")
        out["rabbit"][backward] = res

    # ---- 21. the trainer on mesh_demo(3) at 1920x1080 x 8
    st21 = RenderSettings(max_bounces=nb, aa=1, style="standard")
    frames, train_steps = 4, 30
    mats = mesh3.materials
    # The light starts too bright (x1.2): started dim, the light's own
    # albedo, seen only where paths hit the quad, takes up the deficit.
    init = inverse.apply_params(mesh3, {
        "materials.albedo": torch.full_like(mats.albedo, 0.5),
        "materials.emission": mats.emission * 1.2})
    target = torch.zeros((3, hd.height, hd.width), device=dev)
    for f in range(frames):
        target = target + render_sample_fast_chw(mesh3, cam3, st21, hd, f) / frames
    inverse.recover(init, cam3, st21, hd, None, target, steps=2, learning_rate=3e-2)
    for k in counters.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec_scene, losses, _ = inverse.recover(init, cam3, st21, hd, None, target,
                                           steps=train_steps, learning_rate=3e-2)
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) / train_steps * 1e3
    launches = {k: c.launches for k, c in counters.items() if c.launches}

    def mean_err(a, b):
        return (a - b).abs().mean().item()

    alb0, em0 = mean_err(init.materials.albedo, mats.albedo), mean_err(
        init.materials.emission, mats.emission)
    alb, em = mean_err(rec_scene.materials.albedo, mats.albedo), mean_err(
        rec_scene.materials.emission, mats.emission)
    print(f"[train] recover on mesh_demo(3), {hd.width}x{hd.height} x {nb} bounces, "
          f"{train_steps} steps, lr 3e-2: {train_ms:.4f} ms/step (after a 2-step warm-up "
          f"run); loss {losses[0]:.6f} -> {losses[-1]:.6f}; mean |albedo err| "
          f"{alb0:.4f} -> {alb:.4f}, mean |emission err| {em0:.4f} -> {em:.4f}; "
          f"launches {launches} [{smi}]")
    check(all(np.isfinite(losses)), "mesh trainer loss not finite")
    check(losses[-1] < losses[0], f"mesh trainer loss did not fall: {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}")
    check(alb < alb0, f"mesh albedo error did not fall: {alb0:.4f} -> {alb:.4f}")
    check(em < em0, f"mesh emission error did not fall: {em0:.4f} -> {em:.4f}")
    check(launches == {"path_kernel": 2 * train_steps,
                       "replay_gather": nb * train_steps},
          f"the mesh trainer launched {launches}: expected two K1 launches (a trace "
          f"and a hits-only collect) and one replay's gathers per step (no vertex "
          f"gradient, no segment sum), and no B5")
    out["train"] = dict(ms_per_step=train_ms, losses=(losses[0], losses[-1]),
                        albedo_err=(alb0, alb), emission_err=(em0, em), launches=launches)
    return out


def stats_phase(smi, dev):
    """Phase 22: K1's stats form (``PathTracer.trace(stats=True)``, the
    counting instance and its summing kernel) on rabbit at 1024x512 x 8
    and mesh_demo(3) at 1920x1080 x 8, camera rays passed in, Kajiya,
    Whitted and Cook.  First the path: the launch counts zeroed, the six
    traces through the entry point, the counts read.  Then, per trace, the
    radiance bit for bit that of the launch without stats, the counters
    against the plain version's (cull_stats_hook through trace_plain's
    on_search, on the card) on every 8th tile, the counting walk's census
    on those tiles (stats_census_hook: box tests, rows opened and past the
    t-first reject, SIMD, how soon the masks fill), and both launches
    timed beside the bound of this run's data; last, the counting
    instances' ``-Xptxas -v`` and the loops of the Kajiya one's SASS."""
    import torch

    from rvpt_tpu_torch import FilmConfig
    from rvpt_tpu_torch.models.integrators import INTEGRATOR_NAMES
    from rvpt_tpu_torch.ops import pathkernel as pk
    from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays
    from rvpt_tpu_torch.scene import builtin

    cases = {
        "rabbit": (FilmConfig(1024, 512), builtin.rabbit),
        "mesh_demo(3)": (FilmConfig(1920, 1080),
                         lambda aspect, device: builtin.mesh_demo(3, aspect=aspect,
                                                                  device=device)),
    }
    frame, salt, nb = 3, 16, 8
    setups = {}
    for name, (cfg, make) in cases.items():
        scene, cam = make(aspect=cfg.aspect, device=dev)
        pt = pk.PathTracer(scene)
        check(pt.cull is not None, f"{name}: no culled form")
        pixel, xs, ys = _pixel_grid(cfg, dev)
        ray = jittered_camera_rays(cam, cfg, pixel, xs, ys, frame, 0)
        rays = tuple(c.contiguous() for c in (
            ray.origin[:, 0], ray.origin[:, 1], ray.origin[:, 2],
            ray.direction[:, 0], ray.direction[:, 1], ray.direction[:, 2]))
        setups[name] = (cfg, pt, pixel, rays)

    # The path: the entry point a user calls, counts zeroed and read.
    pk.launch_path_stats.launches = 0
    pk.launch_path_kernel.launches = 0
    for name, (cfg, pt, pixel, rays) in setups.items():
        for integ in ("kajiya", "whitted", "cook"):
            rgb, agg = pt.trace(pixel, rays[:3], rays[3:], frame, salt, nb,
                                integ=integ, stats=True)
            check(len(agg) == 3 and agg[0].shape == (-(-cfg.num_pixels // pk.CULL_TILE),),
                  f"{name} {integ}: counters of shape {tuple(agg[0].shape)}")
    torch.cuda.synchronize()
    launches = pk.launch_path_stats.launches
    check(launches == 6 and pk.launch_path_kernel.launches == 0,
          f"stats path: {launches} stats launches and {pk.launch_path_kernel.launches} "
          "plain K1 launches, expected 6 and 0")
    print(f"[stats-path] PathTracer.trace(stats=True) x6: {launches} launches of the "
          f"counting instance [{smi}]")

    out = {"launches": launches, "runs": {}}
    for name, (cfg, pt, pixel, rays) in setups.items():
        n = cfg.num_pixels
        grid = -(-n // pk.CULL_TILE)
        t_, s_, p_, _ = pt.counts
        seed = s_ * OPS_SPH + p_ * OPS_PLN + OPS_INV
        for integ in ("kajiya", "whitted", "cook"):
            def plain_k1():
                return pk.launch_path_kernel(pt.tables, pt.counts, pixel, n, frame, salt, nb,
                                             "reference", rays=rays, integ=integ,
                                             tree=pt.tree)

            def counted():
                return pk.launch_path_stats(pt.tables, pt.counts, pt.tree, pt.cull,
                                            pixel, n, frame, salt, nb, "reference",
                                            rays=rays, integ=integ)

            want_rgb = plain_k1()
            got_rgb, got = counted()
            torch.cuda.synchronize()
            same = torch.equal(got_rgb, want_rgb)
            check(same, f"{name} {integ}: stats radiance differs from the launch without")
            # The plain version on every 8th whole tile (the RNG keys by
            # pixel id, so a tile's paths do not depend on the others).
            tiles = torch.arange(0, grid, 8, device=dev)
            lanes = (tiles[:, None] * pk.CULL_TILE
                     + torch.arange(pk.CULL_TILE, device=dev)).reshape(-1)
            lanes = lanes[lanes < n]
            acc = torch.zeros((3, tiles.numel()), dtype=torch.float32, device=dev)
            work = {}
            hook = pk.cull_stats_hook(pt.tables, pt.counts, pt.cull, lanes.numel(), acc,
                                      work=work)

            def plain(hook=hook, lanes=lanes):
                return pk.trace_plain(pt.tables, pt.counts, pixel[lanes], frame, salt, nb,
                                      "reference", rays=tuple(c[lanes] for c in rays),
                                      integ=integ, tris_last=True, on_search=hook)

            t0 = time.perf_counter()
            plain()
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            k = got[:, tiles]
            eq = (k == acc).all(0).float().mean().item()
            check(eq >= 0.99, f"{name} {integ}: counters equal on {eq:.4f} of tiles")
            check(torch.equal(got[1], got[0]), f"{name} {integ}: processed != listed")
            check(bool((got[2] <= got[0]).all().item()), f"{name} {integ}: still > listed")
            check(got[0].sum().item() > 0, f"{name} {integ}: nothing listed")
            # Step 1's census of the counting walk on the same tiles.
            census = {}
            pk.trace_plain(pt.tables, pt.counts, pixel[lanes], frame, salt, nb, "reference",
                           rays=tuple(c[lanes] for c in rays), integ=integ, tris_last=True,
                           on_search=stats_census_hook(pt.tables, pt.counts, pt.cull, integ,
                                                       nb, census))
            print(f"[stats-census] {name} {cfg.width}x{cfg.height} x {nb}, {integ}, every "
                  f"8th tile: {stats_census_text(census)} [{smi}]")
            cs = {key: sum(r.get(key, 0) for r in census.values()) for key in STATS_CENSUS}
            check(cs["box"] == work["clusters"] and cs["opened"] == work["tris"],
                  f"{name} {integ}: the census and the counters' work disagree")
            # The bound: K1's BVH form on the whole film (its searches,
            # walks and shading, counted by the plain version and the walk's
            # counting instance) plus the stats walk's box, bit and triangle
            # tests, counted on the compared tiles and scaled to the film.
            kwork, census = {}, {}
            pk.trace_plain(pt.tables, pt.counts, pixel, frame, salt, nb, "reference",
                           rays=rays, integ=integ, tris_last=True, work=kwork,
                           on_search=census_hook(pt, INTEGRATOR_NAMES[integ], kwork,
                                                  census))
            own = census_summary(census)["own"]
            scale = n / lanes.numel()
            # The counting walk's own tests: box tests, bits, each passed
            # cluster's rows to their t and the rows past the reject in full
            # (the exit's savings depend on the order warps run in, and are
            # not taken off); the parent's count, every row in full, beside.
            stats_ops = scale * (work["root"] * OPS_BOX + work["clusters"] * OPS_BOX
                                 + work["bits"] + cs["opened"] * OPS_ROW_T
                                 + cs["full"] * (OPS_WALK_TRI - OPS_ROW_T))
            parent_ops = scale * (work["root"] * OPS_BOX + work["clusters"] * OPS_BOX
                                  + work["bits"] + work["tris"] * OPS_WALK_TRI)
            words = -(-(pt.cull.shape[0] - 1) // 32)
            mask_bytes = 2 * 4 * grid * pk.stats_slots(nb, integ) * words
            table_bytes = 4 * (pt.tables.numel() + pt.nodes.numel() + pt.cull.numel())
            bnds = walk_bounds(36 * n + 8 * n + table_bytes + mask_bytes + 12 * grid,
                               k1_ops(kwork, seed) + stats_ops, kwork, own)
            parent_bnd, _ = bound(36 * n + 8 * n + table_bytes + mask_bytes + 12 * grid,
                                  k1_ops(kwork, seed) + parent_ops + own_walk_ops(own))
            for _ in range(2):
                counted()
                plain_k1()
            k1_ms = cuda_ms(plain_k1, 10)
            ms = cuda_ms(counted, 10)
            k1_ms2 = cuda_ms(plain_k1, 10)
            print(f"[stats-vs-plain] {name} {cfg.width}x{cfg.height} x {nb}, {integ}: "
                  f"counters equal on {eq:.4f} of {tiles.numel()} tiles (bar 0.99); film "
                  f"sums listed {got[0].sum().item():.0f}, still {got[2].sum().item():.0f}; "
                  f"radiance bit-identical: {same}; stats launch {ms:.4f} ms, without "
                  f"stats {k1_ms:.4f}/{k1_ms2:.4f} ms, plain {plain_ms:.2f} ms on "
                  f"{lanes.numel()} rays; {bounds_text(bnds, ms, kwork, own)} (stats walk "
                  f"{ {k2: round(v * scale) for k2, v in work.items()} }, rows opened "
                  f"{round(cs['opened'] * scale)}, past the reject {round(cs['full'] * scale)}; "
                  f"every row in full, the parent's count, not the bound: "
                  f"{parent_bnd:.4f} ms, {parent_bnd / ms:.1%}) [{smi}]")
            out["runs"][f"{name} {integ}"] = dict(
                ms=ms, k1_ms=min(k1_ms, k1_ms2), plain_ms=plain_ms,
                plain_rays=lanes.numel(), **bnds, parent_count_bound_ms=parent_bnd,
                walk_own=own, tiles_equal=eq, census=census,
                max_abs_err=(k - acc).abs().max().item(), bit_identical=same)
    from rvpt_tpu_torch.ops import build

    info = build.BUILD_INFO["path_kernel"]
    table = ptxas_table(info["log"])
    names = demangle(table)
    for mangled, row in sorted(table.items(), key=lambda kv: names[kv[0]]):
        if re.search(r"path_kernel<\d, \d, true, true>|stats_scan_kernel|count_clusters",
                     names[mangled]):
            print(f"[stats-ptxas] {names[mangled]}: {row}")
    for line in sass_text(sass_loops(info["path"], r"(path_kernel<0, 0, true, true>)"),
                          ("LDG", "LDS")):
        print(f"[stats-sass] {line}")
    return out


def cli_phases(smi, dev, out_dir):
    """Phases 23-24: the CLI in-process through ``cli.main(argv)`` at
    1920x1080 (the counts zeroed before each run and read after it), then
    the headless Viewer on the Cornell box."""
    import ast
    import contextlib
    import io

    import numpy as np
    import torch

    from rvpt_tpu_torch import FilmConfig, RenderSettings, cli
    from rvpt_tpu_torch.ops import pathkernel as pk
    from rvpt_tpu_torch.renderer import Renderer
    from rvpt_tpu_torch.scene import builtin
    from rvpt_tpu_torch.scene.bvh import attach_bvh
    from rvpt_tpu_torch.utils.image import read_png
    from rvpt_tpu_torch.window import Action, Viewer

    counters = {"path_kernel": pk.launch_path_kernel,
                "primary_kernel": pk.launch_primary_kernel,
                "hart_kernel": pk.launch_hart_kernel,
                "bigmesh_kernel": pk.launch_bigmesh_kernel,
                "bigmesh_hart": pk.launch_bigmesh_hart,
                "bigmesh_march": pk.launch_bigmesh_march,
                "path_kernel_stats": pk.launch_path_stats}
    cornell_bvh = pk.PathTracer(attach_bvh(builtin.cornell_box(device=dev)[0]))
    check(cornell_bvh.bvh_form, "--bvh cornell would not take K1's BVH form")
    ck = os.path.join(out_dir, "cli_mesh5.npz")
    ck2 = os.path.join(out_dir, "cli_mesh5_resumed.npz")
    size = ["--size", "1920x1080"]
    runs = [
        ("cornell", ["--scene", "cornell", "--frames", "16", "--bounces", "4", "--style",
                     "standard"], {"path_kernel": 16}),
        ("cornell --bvh", ["--scene", "cornell", "--bvh", "--frames", "8",
                           "--debug-view", "bvh"], {"path_kernel": 8}),
        ("split", ["--split", "ao,whitted,hart,kajiya", "--frames", "8"],
         {"primary_kernel": 8, "path_kernel": 16, "hart_kernel": 8}),
        ("mesh:5", ["--scene", "mesh:5", "--bounces", "8", "--frames", "8",
                    "--checkpoint", ck], {"path_kernel": 8}),
        ("mesh:5 --resume", ["--scene", "mesh:5", "--bounces", "8", "--frames", "4",
                             "--resume", ck, "--checkpoint", ck2], {"path_kernel": 4}),
    ]
    out = {"runs": {}, "launches": {}}
    for label, args, want in runs:
        png = os.path.join(out_dir, "cli_" + label.replace(" ", "_").replace(":", "")
                           .replace("-", "") + ".png")
        for c in counters.values():
            c.launches = 0
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main([*args, *size, "--stats", "--out", png])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = {k: c.launches for k, c in counters.items() if c.launches}
        check(rc == 0, f"cli {label}: exit {rc}: {err.getvalue()[-500:]}")
        check(ran == want, f"cli {label}: launched {ran}, expected {want}")
        for k, v in ran.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        stats = next(ast.literal_eval(line) for line in err.getvalue().splitlines()
                     if line.startswith("{'frames'"))
        img = read_png(png)
        check(img.shape == (1080, 1920, 3), f"cli {label}: image of shape {img.shape}")
        check(np.isfinite(img).all() and img.max() > 0 and img.mean() > 1.0,
              f"cli {label}: the image is black (mean {img.mean():.3f})")
        if "--debug-view" in args:
            dbg = read_png(png.replace(".png", "_bvh.png"))
            check((dbg != img).any(axis=-1).sum() > 1000, f"cli {label}: no BVH overlay")
        print(f"[cli] {label}: {stats['avg_ms']:.4f} ms/frame, "
              f"{stats['mrays_per_s']:.1f} Mrays/s (--stats over {stats['frames']} "
              f"frames), accumulated {stats['accumulated_frames']}, launches {ran}, "
              f"{wall:.2f} s in cli.main, image mean {img.mean():.3f} [{smi}]")
        out["runs"][label] = dict(ms_per_frame=stats["avg_ms"],
                                  mrays_per_s=stats["mrays_per_s"],
                                  accumulated=stats["accumulated_frames"], launches=ran)
    check("resumed at frame 8" in err.getvalue(), "the resume did not start at frame 8")
    with np.load(ck2) as data:
        check(int(data["['film']/.frame"]) == 12, "the resumed film did not reach frame 12")
    check(out["runs"]["mesh:5 --resume"]["accumulated"] == 12,
          "the resumed run's --stats did not count 12 frames")

    # ---- 24. the viewer, headless: 32 steps, a W press at step 16
    cfg = FilmConfig(1920, 1080)
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device=dev)
    r = Renderer(scene, cam, RenderSettings(max_bounces=4, style="standard"), cfg)
    shown = []
    v = Viewer(r, backend=lambda img: shown.append(img.shape))
    frames = []
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    for step in range(32):
        if step == 16:
            v.input.on_key("w", Action.PRESS)
        if step == 18:
            v.input.on_key("w", Action.RELEASE)
        v.step(dt=1.0 / 60.0)
        frames.append(r.film.frame)
    r.flush()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 32 * 1e3
    check(pk.launch_path_kernel.launches == 32,
          f"viewer: {pk.launch_path_kernel.launches} K1 launches in 32 steps")
    check(frames[15] == 16 and frames[16] == 17 and frames[17] == 1,
          f"viewer: accumulation did not restart on the move: frames {frames}")
    check(len(shown) == 32 and shown[0] == (1080, 1920, 3), "viewer: frames not presented")
    check(bool(torch.isfinite(r.film.accum).all().item()), "viewer: film not finite")
    print(f"[viewer] Viewer(backend=callable) x32 steps, 1920x1080, 4 bounces, standard: "
          f"{step_ms:.4f} ms/step (draw, HWC copy to the host, present); W at step 16 "
          f"moved the camera at step 17: frames {frames[14:20]}..{frames[-1]} [{smi}]")
    out["viewer"] = dict(ms_per_step=step_ms, launches=pk.launch_path_kernel.launches)
    return out


def sharded_phase(smi, dev, out_dir, film5):
    """Phase 25: the sharded path (``parallel/``).  (a) World 1 under NCCL in
    this process: ``Renderer(mesh=...)`` x16 of the 1080p Cornell Kajiya
    frame (its film phase 5's bit for bit, K1's count up by exactly 16), a
    split frame (AO, Whitted, Hart, Kajiya), a mesh_demo(5) Kajiya frame at
    1080p x 8 and one ``make_train_step(mesh=...)`` step, each bit for bit
    its unsharded counterpart and timed beside it (CUDA events), and the
    collectives' time per frame and per step.  (b) World 2 on the one card:
    two spawned processes under gloo, both on cuda:0
    (``parallel.dryrun.parity_job``): a (2, 1) mesh's Cornell Kajiya sample
    bit for bit the unsharded one, a (1, 2) mesh's the mean of the two salt
    streams within atol 1e-6, and a (2, 1) fast train step equal on both
    ranks and within rtol 1e-5 of the unsharded step; each rank's K1
    launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rvpt_tpu_torch import FilmConfig, RenderSettings
    from rvpt_tpu_torch.ops import pathkernel as pk
    from rvpt_tpu_torch.parallel import dryrun
    from rvpt_tpu_torch.parallel import sharded as sh
    from rvpt_tpu_torch.parallel.distributed import initialize_distributed
    from rvpt_tpu_torch.parallel.mesh import SPP_AXIS, TILE_AXIS, make_mesh
    from rvpt_tpu_torch.render import make_tracer, render_sample_fast_chw
    from rvpt_tpu_torch.renderer import Renderer
    from rvpt_tpu_torch.scene import builtin
    from rvpt_tpu_torch.train import inverse

    t_phase = time.perf_counter()
    rec = {}
    cfg = FilmConfig(1920, 1080)
    n = cfg.num_pixels
    st = RenderSettings(max_bounces=4, style="standard")
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device=dev)

    # ---- (a) world 1, NCCL
    initialize_distributed(f"127.0.0.1:{dryrun.free_port()}", 1, 0)
    check(dist.get_backend() == "nccl", f"world 1 runs {dist.get_backend()}, not NCCL")
    mesh = make_mesh(1, 1)

    def draws(m):
        r = Renderer(scene, cam, st, cfg, mesh=m)
        r.draw()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(15):
            r.draw()
        stop.record()
        r.flush()
        stop.synchronize()
        return r, start.elapsed_time(stop) / 15

    plain_r, plain_ms = draws(None)
    pk.launch_path_kernel.launches = 0
    sharded_r, sharded_ms = draws(mesh)
    launches = pk.launch_path_kernel.launches
    check(launches == 16, f"K1 launched {launches} times in 16 sharded draws")
    check(sharded_r.film.frame == 16, f"sharded film at frame {sharded_r.film.frame}")
    check(torch.equal(sharded_r.film.accum, film5),
          "the sharded film is not phase 5's film bit for bit")
    check(torch.equal(plain_r.film.accum, film5), "the unsharded film is not phase 5's")
    rec["draw"] = {"ms": sharded_ms, "unsharded_ms": plain_ms, "launches": launches}
    print(f"[sharded] world 1 (NCCL, (1, 1) mesh): Renderer.draw x16, 1080p Cornell "
          f"Kajiya: film bit for bit phase 5's, K1 launches {launches}; "
          f"{sharded_ms:.4f} ms/frame (CUDA events over 15) against unsharded "
          f"{plain_ms:.4f} [{smi}]")
    del plain_r, sharded_r

    def frame_pair(label, scene_, cam_, st_, iters):
        tracer = make_tracer(scene_)
        cp = None if pk.is_bigmesh(scene_) else pk.camera_params(cam_, cfg)
        got = sh.render_sample_sharded_fast(scene_, cam_, st_, cfg, 0, mesh, tracer, cp)
        want = render_sample_fast_chw(scene_, cam_, st_, cfg, 0, tracer, cp)
        check(torch.equal(got, want), f"sharded {label} frame is not the unsharded one")
        ms = cuda_ms(lambda: sh.render_sample_sharded_fast(
            scene_, cam_, st_, cfg, 0, mesh, tracer, cp), iters)
        plain = cuda_ms(lambda: render_sample_fast_chw(
            scene_, cam_, st_, cfg, 0, tracer, cp), iters)
        rec[label] = {"ms": ms, "unsharded_ms": plain}
        print(f"[sharded] world 1: {label} sample bit for bit the unsharded one; "
              f"{ms:.4f} ms against {plain:.4f} (CUDA events over {iters}) [{smi}]")

    split = st.replace(top_left_render_mode=5, top_right_render_mode=7,
                       bottom_left_render_mode=10, bottom_right_render_mode=9)
    frame_pair("split", scene, cam, split, 10)
    mscene, mcam = builtin.mesh_demo(subdiv=5, aspect=cfg.aspect, device=dev)
    frame_pair("mesh_demo(5) kajiya x8", mscene, mcam,
               RenderSettings(max_bounces=8, style="standard"), 5)
    del mscene, mcam

    target = film5
    init = inverse.apply_params(scene, {
        "materials.albedo": torch.full_like(scene.materials.albedo, 0.5),
        "materials.emission": scene.materials.emission * 0.25})
    steps = {}
    for label, m in (("unsharded", None), ("sharded", mesh)):
        step, opt = inverse.make_train_step(init, cam, st, cfg, m, target,
                                            learning_rate=3e-2)
        params, opt, loss = step(inverse.trainable_params(init), opt, 0)
        first = {k: v.detach().clone() for k, v in params.items()}
        ms = cuda_ms(lambda: step(params, opt, 1), 5)
        steps[label] = (first, float(loss), ms)
    for k in steps["unsharded"][0]:
        check(torch.equal(steps["sharded"][0][k], steps["unsharded"][0][k]),
              f"sharded step's {k} is not the unsharded step's")
    rec["step"] = {"ms": steps["sharded"][2], "unsharded_ms": steps["unsharded"][2],
                   "loss": steps["sharded"][1], "unsharded_loss": steps["unsharded"][1]}
    print(f"[sharded] world 1: make_train_step(mesh=...) at 1080p: parameters bit for "
          f"bit the unsharded step's (loss {steps['sharded'][1]:.6f} against "
          f"{steps['unsharded'][1]:.6f}); {steps['sharded'][2]:.4f} ms/step against "
          f"{steps['unsharded'][2]:.4f} (CUDA events over 5) [{smi}]")

    # The path's collectives per frame and per step: none at world 1 (an
    # axis of one rank runs none); beside them what one NCCL all_reduce and
    # one list all_gather of the film cost on this group of one, checked.
    frame_coll, step_coll = dryrun.collectives_ms(mesh, n, dev, reps=20)
    x = torch.rand((3, n), device=dev)
    y, parts = x.clone(), [torch.empty_like(x)]

    def nccl_pair():
        dist.all_reduce(y, group=mesh.get_group(SPP_AXIS))
        dist.all_gather(parts, x, group=mesh.get_group(TILE_AXIS))

    pair_ms = cuda_ms(nccl_pair, 20)
    check(torch.equal(y, x) and torch.equal(parts[0], x),
          "NCCL's all_reduce or all_gather over one rank changed the film")
    rec["collectives_ms"] = {"frame": frame_coll, "step": step_coll,
                             "nccl_all_reduce_and_all_gather_of_the_film": pair_ms}
    print(f"[sharded] world 1: the path's collectives {frame_coll:.4f} ms per frame, "
          f"{step_coll:.4f} ms per step (none run; host clock over 20); one NCCL "
          f"all_reduce + all_gather of the 1080p film on this group: {pair_ms:.4f} ms "
          f"(CUDA events over 20) [{smi}]")
    dist.destroy_process_group()

    # ---- (b) world 2 on the one card, gloo
    job_dir = os.path.join(out_dir, "sharded_job")
    cases = [("fast_9_cornell", (2, 1), (1920, 1080)),
             ("fast_9_cornell", (1, 2), (1920, 1080)),
             ("train_fast_cornell", (2, 1), (1920, 1080)),
             ("collectives", (2, 1), (1920, 1080)),
             ("collectives", (1, 2), (1920, 1080))]
    t0 = time.perf_counter()
    dryrun.spawn(dryrun.parity_job, 2, args=(job_dir, cases, "cuda", "gloo", 4),
                 timeout=300)
    job_s = time.perf_counter() - t0
    ranks = [dict(np.load(os.path.join(job_dir, f"rank{r}.npz"))) for r in range(2)]

    def key(name, shape):
        return f"{name}@{shape[0]}x{shape[1]}@1920x1080"

    k21, k12 = key("fast_9_cornell", (2, 1)), key("fast_9_cornell", (1, 2))
    for k in (k21, k12):
        check(np.array_equal(ranks[0][f"{k}.got.image"], ranks[1][f"{k}.got.image"]),
              f"{k}: the ranks' images differ")
    check(np.array_equal(ranks[0][f"{k21}.got.image"], ranks[0][f"{k21}.want.image"]),
          "the (2, 1) mesh's sample is not the unsharded one bit for bit")
    spp_err = float(np.abs(ranks[0][f"{k12}.got.image"]
                           - ranks[0][f"{k12}.want.image"]).max())
    check(spp_err <= 1e-6, f"the (1, 2) mesh's sample is {spp_err} off the salt streams' mean")
    kt = key("train_fast_cornell", (2, 1))
    train_err = 0.0
    for leaf in ("materials.albedo", "materials.emission"):
        got = ranks[0][f"{kt}.got.{leaf}"]
        check(np.array_equal(got, ranks[1][f"{kt}.got.{leaf}"]),
              f"the ranks' {leaf} differ after the sharded step")
        want = ranks[0][f"{kt}.want.{leaf}"]
        check(np.allclose(got, want, rtol=1e-5, atol=0),
              f"the sharded step's {leaf} is off the unsharded step's")
        train_err = max(train_err, float((np.abs(got - want) / np.abs(want)).max()))
    k1 = {k: [int(ranks[r][f"{k}.got.k1_launches"]) for r in range(2)] for k in (k21, k12)}
    check(all(v == [1, 1] for v in k1.values()), f"K1 launches per rank {k1}")
    coll = {f"{shape[0]}x{shape[1]}": {
        part: [float(ranks[r][f"{key('collectives', shape)}.got.{part}_ms"]) for r in range(2)]
        for part in ("frame", "step")} for shape in ((2, 1), (1, 2))}
    rec["world2"] = {"seconds": job_s, "k1_launches": k1, "spp_max_abs_err": spp_err,
                     "train_max_rel_err": train_err, "collectives_ms": coll,
                     "rank_seconds": {k: [float(ranks[r][f"{k}.got.seconds"])
                                          for r in range(2)] for k in (k21, k12, kt)}}
    print(f"[sharded] world 2 (gloo, both ranks on cuda:0), {job_s:.1f} s: (2, 1) "
          f"Cornell Kajiya sample bit for bit the unsharded one, each rank one K1 "
          f"launch on half the pixels ({k1[k21]}); (1, 2) the salt streams' mean within "
          f"{spp_err:.3g} (bar 1e-6), K1 {k1[k12]}; (2, 1) fast train step equal on both "
          f"ranks, {train_err:.3g} relative off the unsharded step (bar 1e-5); the "
          f"collectives per rank, ms per frame and per step (host clock) {coll}; case "
          f"seconds per rank {rec['world2']['rank_seconds']} [{smi}]")
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[sharded] phase 25 in {rec['seconds']:.1f} s")
    return rec


def examples_phase(smi, dev, out_dir):
    """Phase 26: the trainer's and the distributed flow's examples at the
    JAX examples' sizes: inverse_rendering (96x96, 400 steps),
    geometry_recovery (48x48, 120), camera_pose_recovery (64x64, 300) in
    this process, and multihost_render (256x128, 8 frames) as two
    ``python -m`` processes under gloo on the one card, whose PNG must be
    the single-process render's bit for bit."""
    import contextlib
    import io

    import torch

    from rvpt_tpu_torch import FilmConfig, RenderSettings
    from rvpt_tpu_torch.examples import (camera_pose_recovery, geometry_recovery,
                                         inverse_rendering)
    from rvpt_tpu_torch.parallel.dryrun import free_port
    from rvpt_tpu_torch.render import _pixel_grid, render_pixels
    from rvpt_tpu_torch.scene import builtin
    from rvpt_tpu_torch.utils.image import read_png, write_png

    rec = {}
    for name, mod, argv in (
            ("inverse_rendering", inverse_rendering, ["--out-dir", out_dir]),
            ("geometry_recovery", geometry_recovery, []),
            ("camera_pose_recovery", camera_pose_recovery, [])):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as log:
            err = mod.main(argv)
        rec[name] = {"error": err, "seconds": time.perf_counter() - t0,
                     "last_line": log.getvalue().strip().splitlines()[-1]}
        print(f"[examples] {name} at its JAX size: {rec[name]['last_line']} "
              f"({rec[name]['seconds']:.1f} s) [{smi}]")
    inv = rec["inverse_rendering"]["error"]
    for k in ("albedo", "emission"):
        check(inv[f"{k}_mean"] < inv[f"{k}_mean_start"],
              f"inverse_rendering's mean {k} error did not fall: {inv}")
    check(rec["geometry_recovery"]["error"] < 0.3,
          f"geometry_recovery's radius error {rec['geometry_recovery']['error']}")
    check(rec["camera_pose_recovery"]["error"] < 5e-3, "camera pose not recovered")

    png = os.path.join(out_dir, "multihost.png")
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rvpt_tpu_torch.examples.multihost_render",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(r), "--backend", "gloo", "--out", png],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, o in zip(procs, outs):
        check(p.returncode == 0, f"multihost_render failed:\n{o}")
    cfg = FilmConfig(256, 128)
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device=dev)
    pixel, xs, ys = _pixel_grid(cfg, dev)
    acc = torch.zeros((cfg.num_pixels, 3), device=dev)
    for f in range(8):
        acc = (acc * f + render_pixels(scene, cam, RenderSettings(max_bounces=4), cfg, f,
                                       pixel, xs, ys)) / (f + 1)
    want = os.path.join(out_dir, "multihost_single.png")
    write_png(want, acc.cpu().numpy().reshape(128, 256, 3))
    check((read_png(png) == read_png(want)).all(),
          "multihost_render's PNG is not the single-process render's")
    rec["multihost_render"] = {"seconds": time.perf_counter() - t0}
    print(f"[examples] multihost_render, 2 ranks (gloo, cuda:0), 256x128 x 8 frames: "
          f"PNG bit for bit the single-process render's "
          f"({rec['multihost_render']['seconds']:.1f} s)")
    return rec


def camera_rays_phase(smi, dev):
    """Phase 16b: the camera-ray kernel bit for bit the plain arithmetic on
    the card, on the 1080p mesh_demo(5) camera's raster ids and on each
    split-screen quadrant's id tensor, in both roundings; timed beside its
    plain version and its bound."""
    import torch

    from rvpt_tpu_torch import FilmConfig, RenderSettings
    from rvpt_tpu_torch.ops.camera_rays import (camera_constants, camera_rays_plain,
                                                launch_camera_rays)
    from rvpt_tpu_torch.render import (_JITTER_SITE, _rect_pixels, _split_partition,
                                       jittered_camera_rays)
    from rvpt_tpu_torch.scene import builtin
    from rvpt_tpu_torch.utils.debug import interpret_kernels

    cfg = FilmConfig(1920, 1080)
    n = cfg.num_pixels
    cam = builtin.mesh_demo(5, aspect=cfg.aspect, device=dev)[1]
    split = RenderSettings(top_left_render_mode=5, top_right_render_mode=7,
                           bottom_left_render_mode=10, bottom_right_render_mode=9)
    quads = [_rect_pixels(*rect, cfg.width, dev)
             for _, rect in _split_partition(cfg, split)]

    def differing(a, b):
        bits = 0
        for x, y in ((a.origin, b.origin), (a.direction, b.direction)):
            x, y = x.expand(y.shape).contiguous(), y.expand(x.shape).contiguous()
            bits += int((x.view(torch.int32) != y.view(torch.int32)).sum())
        return bits

    out = {"differing_bits": 0, "rays_checked": 0}
    for divide in (False, True):
        for label, pixel in [("raster", n)] + [(f"quadrant {q}", p)
                                               for q, p in enumerate(quads)]:
            before = launch_camera_rays.launches
            got = jittered_camera_rays(cam, cfg, pixel, None, None, 1, 0,
                                       divide=divide, planes=True)
            with interpret_kernels():
                want = jittered_camera_rays(cam, cfg, pixel, None, None, 1, 0,
                                            divide=divide)
            torch.cuda.synchronize()
            launched = launch_camera_rays.launches - before
            bits = differing(got, want)
            rays = got.origin.shape[0]
            print(f"[camera-rays] mesh_demo(5) camera, {cfg.width}x{cfg.height}, {label} "
                  f"({rays} rays), {'division' if divide else 'reciprocal multiply'}: "
                  f"{bits} differing bits against the plain arithmetic; {launched} launch")
            check(launched == 1, f"camera rays ({label}): {launched} launches, not 1")
            check(bits == 0, f"camera rays ({label}, divide={divide}): {bits} components "
                  f"differ from the plain arithmetic")
            out["differing_bits"] += bits
            out["rays_checked"] += rays

    consts = camera_constants(cam)
    salt = _JITTER_SITE
    ids = torch.arange(n, device=dev)

    def kernel():
        return launch_camera_rays(consts, cam.mode, cam.aspect, None, n, cfg.width,
                                  cfg.height, 1, salt)

    def kernel_ids():
        return launch_camera_rays(consts, cam.mode, cam.aspect, ids, n, cfg.width,
                                  cfg.height, 1, salt)

    def route():
        return jittered_camera_rays(cam, cfg, n, None, None, 1, 0, planes=True)

    def plain():
        return camera_rays_plain(cam, cfg, n, None, None, 1, salt)

    # Device time from the profiler: back to back, a 0.02 ms launch through
    # ctypes is paced by the host, which CUDA events would time instead.
    name = "camera_rays_kernel"
    ms = device_ms(kernel, 50, (name,))[0][name]
    ids_ms = device_ms(kernel_ids, 50, (name,))[0][name]
    _, plain_ms = device_ms(plain, 10, ())
    route_wall_ms, plain_wall_ms = cuda_ms(route, 50), cuda_ms(plain, 10)
    bnd, by = bound(24 * n, OPS_CAMERA * n)
    ids_bnd, ids_by = bound(32 * n, OPS_CAMERA * n)
    print(f"[time] camera rays, {cfg.width}x{cfg.height}, device time: kernel {ms:.4f} ms "
          f"(bound {bnd:.4f} ms by {by}, 24 B written per ray; {bnd / ms:.1%} of it), on "
          f"an id tensor {ids_ms:.4f} ms (bound {ids_bnd:.4f} ms by {ids_by}, 32 B per "
          f"ray; {ids_bnd / ids_ms:.1%}), plain {plain_ms:.4f} ms; wall per call "
          f"(CUDA events, back to back): jittered_camera_rays {route_wall_ms:.4f} ms, "
          f"plain {plain_wall_ms:.4f} ms [{smi}]")
    out.update(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by, ids_ms=ids_ms,
               ids_bound_ms=ids_bnd, ids_bound_by=ids_by, route_wall_ms=route_wall_ms,
               plain_wall_ms=plain_wall_ms)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")

    from rvpt_tpu_torch import FilmConfig, RenderSettings
    from rvpt_tpu_torch.ops import build
    from rvpt_tpu_torch.ops import pathkernel as pk
    from rvpt_tpu_torch.ops.film import chw_to_hwc, to_srgb_u8
    from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays
    from rvpt_tpu_torch.renderer import Renderer
    from rvpt_tpu_torch.scene import builtin
    from rvpt_tpu_torch.utils.image import read_png

    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "out")  # gitignored render outputs
    dev = torch.device("cuda")
    # Full-f32 matmuls (camera rays) on both sides of every comparison.
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    nvcc_v = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | nvcc {nvcc_v} | "
          f"python {sys.version.split()[0]}")

    # ---- 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    build.build_all(build.KERNELS)
    for name in build.KERNELS:
        build.load_library(name)
        info = build.BUILD_INFO[name]
        print(f"[build] {name} built in {info['seconds']:.2f} s: {info['path']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] ptxas {name}: {line.strip()}")
    print(f"[build] all {len(build.KERNELS)} in {time.perf_counter() - t0:.2f} s")
    from rvpt_tpu_torch import native

    t0 = time.perf_counter()
    native_ok = native.get_lib() is not None
    print(f"[build] native scene-ingest library (g++): "
          f"{native.BUILD['path'] if native_ok else 'FAILED: ' + str(native.BUILD['error'])} "
          f"({time.perf_counter() - t0:.2f} s); the NumPy builder serves if it failed")

    # ---- 2b. the row census of K1's and B3's row forms
    row_census = row_census_phase(smi, dev)

    # ---- 3. kernel vs plain on the card
    cfg = FilmConfig(1920, 1080)
    n = cfg.num_pixels
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device=dev)
    pt = pk.PathTracer(scene)
    pixel, xs, ys = _pixel_grid(cfg, dev)
    ray = jittered_camera_rays(cam, cfg, pixel, xs, ys, 0, 0)
    rays = tuple(c.contiguous() for c in (
        ray.origin[:, 0], ray.origin[:, 1], ray.origin[:, 2],
        ray.direction[:, 0], ray.direction[:, 1], ray.direction[:, 2]))
    cam_params = pk.camera_params(cam, cfg)
    for style in ("reference", "standard"):
        got = pk.launch_path_kernel(pt.tables, pt.counts, pixel, n, 1, 16, 3,
                                    style, rays=rays)
        want = pk.trace_plain(pt.tables, pt.counts, pixel, 1, 16, 3, style,
                              rays=rays)
        torch.cuda.synchronize()
        close = torch.isclose(got, want, rtol=1e-4, atol=1e-4).float().mean().item()
        err = (got - want).abs().max().item()
        print(f"[kernel-vs-plain] rays in, 3 bounces, {style}: "
              f"{close:.6f} of channels within 1e-4 (bar 0.995), max |err| {err:.3g}")
        check(close >= 0.995, f"kernel disagrees with plain ({style}): {close:.6f}")

    main_kw = dict(rays=None, cam_params=cam_params, cam_mode=cam.mode,
                   jitter_salt=0)

    def kernel_frame():
        return pk.launch_path_kernel(pt.tables, pt.counts, None, n, 1, 16, 4,
                                     "standard", **main_kw)

    def plain_frame(work=None):
        return pk.trace_plain(pt.tables, pt.counts, pixel, 1, 16, 4, "standard",
                              work=work, **main_kw)

    disp_work = {}
    got, want = kernel_frame(), plain_frame(disp_work)
    torch.cuda.synchronize()
    close = torch.isclose(got, want, rtol=1e-4, atol=1e-4).float().mean().item()
    max_err = (got - want).abs().max().item()
    mean_k, mean_p = got.mean(dim=1), want.mean(dim=1)
    rel = ((mean_k - mean_p).abs() / mean_p.abs()).max().item()
    print(f"[kernel-vs-plain] camera rays in kernel, 4 bounces, standard: film "
          f"means {[round(v, 6) for v in mean_k.tolist()]} vs "
          f"{[round(v, 6) for v in mean_p.tolist()]} (max rel {rel:.3g}, bar 0.01); "
          f"{close:.6f} of channels within 1e-4; max |err| {max_err:.3g}")
    check(torch.isfinite(got).all().item(), "kernel film has non-finite values")
    check(rel <= 0.01, f"kernel film mean off the plain version's by {rel:.3g}")
    # Per pixel as well: the means alone would not see a mirrored, shifted
    # or unjittered image from the kernel's own camera rays.
    check(close >= 0.995, f"kernel camera-ray film disagrees with plain: {close:.6f}")

    for _ in range(3):
        kernel_frame()
    ms = cuda_ms(kernel_frame, 20)
    plain_frame()
    plain_ms = cuda_ms(plain_frame, 3)
    rays_per_frame = n * 4
    # K1's bound for this frame: the work of the same frame's data (dead
    # lanes leave the loop; misses add the sky and end), the camera rays
    # and the film it writes.
    t_, s_, p_, _ = pt.counts
    ops_search = t_ * OPS_TRI + s_ * OPS_SPH + p_ * OPS_PLN
    k1_bound, k1_by = bound(12 * n, k1_ops(disp_work, 0) + row_census["kajiya"]["own"]
                            + n * OPS_CAMERA)
    k1_closest, _ = bound(12 * n, k1_ops(disp_work, ops_search) + n * OPS_CAMERA)
    print(f"[time] 1920x1080 x 4 bounces: kernel {ms:.4f} ms "
          f"({rays_per_frame / ms / 1e3:.1f} Mrays/s), plain {plain_ms:.4f} ms "
          f"({rays_per_frame / plain_ms / 1e3:.1f} Mrays/s); bound {k1_bound:.4f} ms "
          f"by {k1_by} (work {disp_work}, the row searches' own "
          f"{row_census['kajiya']['own']} operations, + camera rays), kernel at "
          f"{k1_bound / ms:.1%} of it; closest-hit searches without the reject "
          f"({ops_search} ops each), not the bound: {k1_closest:.4f} ms, "
          f"{k1_closest / ms:.1%} [{smi}]")

    # ---- 4. goldens, for the record
    gcfg = FilmConfig(64, 64)
    gscene, gcam = builtin.cornell_box(aspect=gcfg.aspect, device=dev)
    gr = Renderer(gscene, gcam, RenderSettings(max_bounces=4), gcfg)
    for _ in range(4):
        gr.draw()
    gr.flush()
    img = to_srgb_u8(chw_to_hwc(gr.film.accum)).cpu().numpy().astype(int)
    golden = read_png(os.path.join(here, "tests", "goldens", "cornell_kajiya.png"))
    off = (abs(img - golden.astype(int)) > 2).mean()
    print(f"[goldens] cornell_kajiya via the kernel: {off:.4%} of subpixels "
          f"more than 2 u8 steps off (recorded, not asserted; the CPU bar is 0.2%)")

    # ---- 5. the slice: Renderer.draw at 1080p through the kernel
    r = Renderer(scene, cam, RenderSettings(max_bounces=4, style="standard"), cfg)
    pk.launch_path_kernel.launches = 0
    r.draw()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(15):
        r.draw()
    r.flush()
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) / 15 * 1e3
    launches = pk.launch_path_kernel.launches
    check(launches == 16, f"path kernel launched {launches} times in 16 draws")
    accum = r.film.accum
    film5 = accum.clone()  # phase 25's sharded draws must reproduce it
    check(r.film.frame == 16, f"film accumulated {r.film.frame} frames, not 16")
    check(bool(torch.isfinite(accum).all().item()), "film has non-finite values")
    check(accum.mean().item() > 0.01, "film is black")
    png = os.path.join(out_dir, "torch_cornell_1080p.png")
    r.save_image(png)
    check(read_png(png).shape == (1080, 1920, 3), "saved image has the wrong shape")
    st = r.stats()
    print(f"[slice] Renderer.draw x16, 1920x1080, 4 bounces, standard: "
          f"{frame_ms:.4f} ms/frame, {r.rays_per_frame / frame_ms / 1e3:.1f} Mrays/s "
          f"(timer avg {st['avg_ms']:.4f} ms); kernel launches {launches}; "
          f"film mean {accum.mean().item():.6f}; plain version {plain_ms:.4f} ms/frame, "
          f"{r.rays_per_frame / plain_ms / 1e3:.1f} Mrays/s; saved {png} [{smi}]")

    display_launches = launches
    train = training_phases(smi, dev, cfg, scene, cam, pixel, xs, ys, rays)
    integ = integrator_phases(smi, dev, cfg, scene, cam, pixel, out_dir, here,
                              row_census)
    split = integ["split"]["launches"]
    mesh = mesh_phases(smi, dev, out_dir, here)
    cam_rays = camera_rays_phase(smi, dev)
    del scene, pixel, xs, ys, rays, ray, got, want
    torch.cuda.empty_cache()
    from rvpt_tpu_torch.ops import intersect_pk as ipk
    from rvpt_tpu_torch.ops import replay_soa as rs

    counters = {"path_kernel": pk.launch_path_kernel,
                "bwd_kernel": pk.launch_bwd_kernel,
                "closest_hit": ipk.launch_closest_hit,
                "primary_kernel": pk.launch_primary_kernel,
                "hart_kernel": pk.launch_hart_kernel,
                "bigmesh_kernel": pk.launch_bigmesh_kernel,
                "bigmesh_hart": pk.launch_bigmesh_hart,
                "bigmesh_march": pk.launch_bigmesh_march,
                "replay_gather": rs.launch_gather,
                "replay_segsum": rs.launch_segsum}
    grad = mesh_grad_phases(smi, dev, counters)
    main3 = grad["steps"]["mesh_demo(3)"]["launches"]
    rabbit_auto = grad["rabbit"]["auto"]["launches"]
    torch.cuda.empty_cache()
    stats = stats_phase(smi, dev)
    app = cli_phases(smi, dev, out_dir)
    sharded = sharded_phase(smi, dev, out_dir, film5)
    examples = examples_phase(smi, dev, out_dir)

    # B5's launches on the main paths, each run's counts zeroed before it.
    b5_draws = mesh["launches"]["bigmesh_kernel"] + app["launches"].get("bigmesh_kernel", 0)
    b5_steps = (sum(r["launches"]["bigmesh_kernel"] for r in grad["steps"].values())
                + sum(r["launches"]["bigmesh_kernel"] for r in grad["rabbit"].values())
                + grad["train"]["launches"].get("bigmesh_kernel", 0))
    check(b5_draws == b5_steps == 0, f"B5 ran on a main path: {b5_draws} launches in "
          f"draws and CLI runs, {b5_steps} in steps and recover")
    kernels = [{
        "name": "path_kernel", "route": "cuda",
        "source": "rvpt_tpu_torch/csrc/path_kernel.cu",
        "replaces": "rvpt_tpu/ops/pathkernel.py:1115",
        "launches": train["launches"]["path_kernel"],
        "launches_display": display_launches,
        "launches_sharded": sharded["draw"]["launches"],
        "launches_split": split["path_kernel"],
        "max_abs_err": max_err, "within_1e-4": close,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
        "closest_hit_bound_ms": k1_closest, "redesign": ROW_REDESIGN,
        "row_soups_ms": integ["row_soups_ms"], "library_ms": None,
        "collect_ms": train["k1c"]["ms"], "collect_plain_ms": train["k1c"]["plain_ms"],
        "collect_bound_ms": train["k1c"]["bound_ms"],
        "collect_bound_by": train["k1c"]["bound_by"],
        "collect_closest_hit_bound_ms": train["k1c"]["closest_hit_bound_ms"],
        **{f"{integ_name}_{k}": v for integ_name, rec in integ["bounce"].items()
           for k, v in rec.items()},
    }, {
        "name": "bwd_kernel", "route": "cuda",
        "source": "rvpt_tpu_torch/csrc/bwd_kernel.cu",
        "replaces": "rvpt_tpu/ops/pathkernel.py:1346",
        "launches": train["launches"]["bwd_kernel"], **train["k2"],
        "library_ms": None,
    }, {
        "name": "closest_hit", "route": "cuda", "redesign": B8_REDESIGN,
        "source": "rvpt_tpu_torch/csrc/closest_hit.cu",
        "replaces": "rvpt_tpu/ops/intersect_pk.py:89",
        "launches": train["launches"]["closest_hit"], **train["b8"],
        "library_ms": None,
    }, {
        "name": "primary_kernel", "route": "cuda", "redesign": ROW_REDESIGN,
        "source": "rvpt_tpu_torch/csrc/primary_kernel.cu",
        "replaces": "rvpt_tpu/ops/pathkernel.py:3390",
        "launches": split["primary_kernel"],
        # The headline numbers are AO's, the mode on the split-screen path.
        **{k: v for k, v in integ["primary"]["ao"].items()},
        "library_ms": None,
        "modes": integ["primary"],
    }, {
        "name": "hart_kernel", "route": "cuda",
        "source": "rvpt_tpu_torch/csrc/hart_kernel.cu",
        "replaces": "rvpt_tpu/ops/pathkernel.py:3564",
        "launches": split["hart_kernel"], **integ["hart"],
        "library_ms": None,
    }, {
        "name": "path_kernel_bvh", "route": "cuda",
        "redesign": WALK_REDESIGN,
        "source": "rvpt_tpu_torch/csrc/path_kernel.cu",
        "replaces": "rvpt_tpu/ops/pathkernel.py:311",
        "launches": mesh["launches"]["path_kernel_bvh"], **mesh["k1_bvh"],
        "library_ms": None,
    }, {
        "name": "primary_kernel_bvh", "route": "cuda",
        "redesign": WALK_REDESIGN,
        "source": "rvpt_tpu_torch/csrc/primary_kernel.cu",
        "replaces": "rvpt_tpu/ops/pathkernel.py:3390",
        "launches": mesh["launches"]["primary_kernel_bvh"],
        # The headline numbers are AO's, as for the row form.
        **mesh["b3_bvh"]["ao"], "library_ms": None, "modes": mesh["b3_bvh"],
    }, {
        # The big-mesh route's Kajiya, Whitted and Cook frames: K1's BVH
        # form with rays in, one launch per frame.  Launches: the
        # mesh_demo(5) Kajiya draws of phase 16; the numbers those of one
        # 1080p x 8 mesh_demo(5) Kajiya frame (phase 15), every mode and
        # terrain beside them.
        "name": "path_kernel_bigmesh", "route": "cuda",
        "redesign": WALK_REDESIGN,
        "source": "rvpt_tpu_torch/csrc/path_kernel.cu",
        "replaces": "rvpt_tpu/ops/pathkernel.py:2366",
        "launches": mesh["launches"]["path_kernel_bigmesh"],
        **mesh["route"]["mesh_demo(5)"]["kajiya"], "library_ms": None,
        "routes": mesh["route"],
    }, {
        # The big-mesh route's modes 0-6: B3's BVH form with rays in.
        # Launches: the mesh_demo(5) draws of modes 0-6 in phase 16; the
        # numbers those of one mesh_demo(5) AO frame (8 probes).
        "name": "primary_kernel_bigmesh", "route": "cuda",
        "redesign": WALK_REDESIGN,
        "source": "rvpt_tpu_torch/csrc/primary_kernel.cu",
        "replaces": "rvpt_tpu/ops/pathkernel.py:2061",
        "launches": mesh["launches"]["primary_kernel_bigmesh"],
        **mesh["route"]["mesh_demo(5)"]["ao"], "library_ms": None,
    }, {
        # B5 is on no draw, step or recover: its launches are those of
        # the main paths (the draws of phase 16, the steps of phases 19
        # and 20, the recover of phase 21 and the CLI runs of phase 23,
        # each counted from 0), and read 0.  The numbers are those of its
        # own check in phase 15 (one 1080p frame of 8 bounce launches on
        # mesh_demo(3), where the plain version runs on every ray), the
        # check's own launches under check_launches; the other meshes and
        # the search-only instance beside them.
        "name": "bigmesh_kernel", "route": "cuda",
        "source": "rvpt_tpu_torch/csrc/bigmesh_kernel.cu",
        "replaces": "rvpt_tpu/ops/pathkernel.py:2366",
        "launches": b5_draws + b5_steps, **mesh["b5"]["mesh_demo(3)"],
        "library_ms": None, "b5": mesh["b5"],
    }, {
        # Launches: the mesh_demo(5) Hart draws of phase 16, one march
        # launch per frame; the numbers those of the march over one 1080p
        # mesh_demo(5) Hart frame, the per-step instance's at step 4 beside.
        "name": "bigmesh_hart", "route": "cuda",
        "source": "rvpt_tpu_torch/csrc/bigmesh_hart.cu",
        "replaces": "rvpt_tpu/ops/pathkernel.py:2820",
        "launches": mesh["launches"]["bigmesh_hart"], **mesh["b6_march"],
        "library_ms": None, "step": mesh["b6"],
    }, {
        # The launches of the main path of this slice, one mesh_demo(3)
        # fwd+bwd step at 1080p x 8; the numbers of mesh_demo(5)'s tables at
        # its replay's bounce-2 indices, the 140,000-row table beside them.
        "name": "replay_gather", "route": "cuda",
        "source": "rvpt_tpu_torch/csrc/replay_lookup.cu",
        "replaces": "rvpt_tpu/ops/replay_soa.py:309",
        "also_replaces": ["rvpt_tpu/ops/replay_soa.py:105",
                          "rvpt_tpu/ops/replay_soa.py:359"],
        "launches": main3["replay_gather"], **grad["gather"],
    }, {
        "name": "replay_segsum", "route": "cuda",
        "source": "rvpt_tpu_torch/csrc/replay_lookup.cu",
        "replaces": "rvpt_tpu/ops/replay_soa.py:244",
        "also_replaces": ["rvpt_tpu/ops/replay_soa.py:170",
                          "rvpt_tpu/ops/replay_soa.py:381"],
        "launches": main3["replay_segsum"], **grad["segsum"],
        "ms_in_mesh_steps": {k: r["segsum_ms"] for k, r in grad["steps"].items()},
    }, {
        # Launches: one rabbit fwd+bwd step (auto: records, then K2).
        "name": "path_kernel_bvh_collect", "route": "cuda",
        "redesign": WALK_REDESIGN,
        "source": "rvpt_tpu_torch/csrc/path_kernel.cu",
        "replaces": "rvpt_tpu/ops/pathkernel.py:1276",
        "launches": rabbit_auto["path_kernel"], **grad["k1_bvh_collect"],
        "library_ms": None,
    }, {
        # K1's hits-only collect instance, the mesh step's records.
        # Launches: one mesh_demo(3) fwd+bwd step; times and bound of one
        # 1080p x 8 mesh_demo(5) trace (phase 18).
        "name": "path_kernel_hits", "route": "cuda",
        "redesign": WALK_REDESIGN,
        "source": "rvpt_tpu_torch/csrc/path_kernel.cu",
        "replaces": "rvpt_tpu/ops/pathkernel.py:2366",
        "launches": main3["path_kernel"], **grad["k1_hits"], "library_ms": None,
    }, {
        # B5's collect instance, on no step since its records come from
        # K1's hits-only instance: launches those of the steps of phases
        # 19 and 20 and the recover of phase 21 (0); numbers, and the
        # check's own launches, those of its check in phase 18 (one 1080p
        # frame of 8 collect launches on mesh_demo(5)).
        "name": "bigmesh_kernel_collect", "route": "cuda",
        "source": "rvpt_tpu_torch/csrc/bigmesh_kernel.cu",
        "replaces": "rvpt_tpu/ops/pathkernel.py:2366",
        "launches": b5_steps, **grad["b5_collect"], "library_ms": None,
    }, {
        # Replaces no TPU kernel: the JAX package makes these rays with jnp
        # (rvpt_tpu/render.py:60).  Launches: phase 10's recover (two per
        # step) and the mesh_demo(5) Kajiya draws of phase 16 (one per
        # frame); the numbers those of phase 16b.
        "name": "camera_rays", "route": "cuda",
        "source": "rvpt_tpu_torch/csrc/camera_rays.cu", "replaces": None,
        "launches": train["launches"]["camera_rays"] + mesh["launches"]["camera_rays"],
        "launches_train": train["launches"]["camera_rays"],
        "launches_display": mesh["launches"]["camera_rays"],
        **cam_rays, "library_ms": None,
    }, {
        # Launches: the six PathTracer.trace(stats=True) calls of phase 22;
        # the headline numbers mesh_demo(3)'s Kajiya, every run beside them.
        "name": "path_kernel_stats", "route": "cuda",
        "redesign": STATS_REDESIGN,
        "source": "rvpt_tpu_torch/csrc/path_kernel.cu",
        "replaces": "rvpt_tpu/ops/pathkernel.py:1193",
        "launches": stats["launches"],
        **{k: v for k, v in stats["runs"]["mesh_demo(3) kajiya"].items()},
        "library_ms": None, "runs": stats["runs"],
    }]
    steps = {k: {m: v for m, v in r.items() if m != "launches"}
             for k, r in grad["steps"].items()}
    print(json.dumps({"mesh_steps": steps, "mesh_train": grad["train"]}))
    print(json.dumps({"cli": app["runs"], "cli_launches": app["launches"],
                      "viewer": app["viewer"]}))
    print(json.dumps({"sharded": sharded, "examples": examples}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
