// Whole-path kernel for Hopper (sm_90a): one thread per pixel, the whole
// bounce loop in registers, one launch per frame and AA sample.
//
// Replaces the Pallas kernel K1 of rvpt_tpu/ops/pathkernel.py
// (make_path_kernel :1115, launched by _path_call :1276) in its row and
// culled forms: in-kernel camera rays (_gen_rays_inkernel :1059) or rays passed in,
// closest hit over triangles, spheres and planes (_search :715, shared with
// the primary-hit kernel in scene_search.cuh), the style="standard" tail
// (:1254-1257), the collect records (:1202-1215), and three bounce
// integrators, each its own template instance (INTEG).  Each also has two
// search forms (BVH): the row form, with every table staged in shared
// memory and triangles searched first (scene_search.cuh: float4 rows, a
// t-first reject in Whitted's and Cook's searches, an any-hit search for
// Whitted's shadow rays), and the BVH form, the port of K1's
// culled form (meta["culled"], _culled_tris :311), which stages only the
// spheres, planes and materials and walks the tree for the triangles last
// (bvh_walk.cuh: pack_walk's float4 rows with a t-first reject, and an
// any-hit walk for Whitted's shadow rays, which use only whether something
// is hit).  The BVH form also serves the big
// meshes (more than 1,024 triangles), with their camera rays passed in:
// there it replaces the big-mesh kernels B5 (make_bigmesh_dma_kernel :2366 and
// make_bigmesh_kernel :2061, BigMeshTracer :2927), which run one launch per
// bounce or search with the ray state in device memory between launches;
// here the whole path, shadow searches and Cook's tail included, is one
// launch per frame with the state in registers.  The three integrators:
//
// - Kajiya (_shade :925, _shade_geom :857): the sky with d.y shifted into
//   [0,1], emission gathered along the path, Lambert/mirror/dielectric
//   scatter;
// - Whitted (_shade_whitted :961): the path color starts at the ambient
//   term (:1183-1186), the sky uses raw d.y, and a Lambert hit casts one
//   shadow ray toward the light from p + EPSILON n_f, adds the direct
//   term unless shadowed, and ends the path;
// - Cook (_shade_cook :1016): raw d.y sky; a lane whose previous bounce
//   scattered off a Lambert surface ends on this hit's emission, and a
//   Lambert scatter on the last bounce still gets one tail search
//   (:1235-1253).
//
// The TPU layout is not carried over: no [8,1024] tiles or padded lanes,
// no MAX_GROUP bounce split with its 16-field carry (so no 0/1/2 trit for
// Cook's flag across groups: it is a register), no one-hot table fetches.
//
// Collect mode (the Kajiya COLLECT instances of both search forms, for the
// gradient; the BVH form's mirrors the culled path's collect inside
// _path_call with cull_tables, whose triangle indices are leaf-order ids,
// the rows of the BVH scene's own tables): before
// each bounce's search the thread writes its 13 bounce-input fields (o, d,
// throughput, gathered color, active as 0/1) to rec_f[B][13][N], and after
// it the hit's (family, index) to rec_i[B][2][N], -1 where the lane missed.
// Bounces after the lane ended get its frozen state, active 0 and -1 hits,
// as the JAX kernel's masked lanes do.  That record, 60 bytes per
// ray-bounce (498 MB at 1920x1080 x 4 bounces), is the collect mode's main
// cost.  Collecting adds only stores, so the radiance is unchanged.
//
// Hits-only collect (the Kajiya HITS instances of both search forms, for
// the mesh gradient's SoA replay, which reads nothing of the record but
// the hits): rec_i alone, written exactly as the full collect writes it,
// 8 bytes per ray-bounce (133 MB at 1920x1080 x 8 bounces).  It replaces
// the big-mesh kernel's collect instance (make_bigmesh_dma_kernel(collect=
// True), outputs :2568-2600), one launch per bounce there, with one launch
// per trace.
//
// What bounds it on this card: arithmetic.  The scene tables are tiny
// (Cornell: 12x17 + 2x5 + 6x8 floats, under 1 KB) and are staged into
// shared memory at block start, where every lane of a warp reads the same
// word (a broadcast).  Each ray-bounce runs 12 triangle and 2 sphere tests
// plus shading (Whitted: and a shadow search per Lambert hit); the only
// ray-sized device-memory traffic is the f32[3,N] film write (24.9 MB at
// 1920x1080), or also the six f32[N] ray inputs when rays are passed in.
// Tables above the 48 KB default take the opt-in shared memory (up to 227
// KB on Hopper).  A lane that has terminated leaves the bounce loop at
// once, which is exact: a dead lane adds nothing.  The BVH form instead
// reads 32-byte nodes and 64-byte triangle rows (16 bytes of them for a
// row the t-first reject drops) from device memory along each ray's own
// walk (mostly from L2: rabbit's tree and rows are 19 KB, mesh_demo(5)'s
// 2.7 MB); neighbouring rays walk similar paths, but the warp diverges
// where they part.
//
// The counting instances (STATS, BVH form only: Kajiya, Whitted, Cook and
// Kajiya with records) replace the stats outputs of the culled form
// (make_path_kernel(stats=True) :1116, outputs :1193-1196 and :1265-1267):
// per tile of 8,192 consecutive rays, the clusters of 16 leaf-ordered
// triangles that some live lane of the tile lists (its slab test hits the
// root box and the cluster's box) and still passes (entry t0 below the
// lane's best t), summed over the launch's searches.  The TPU builds one
// work list per tile; here each thread walks the cluster boxes for its own
// ray after every search, in id order, with its own best t: the
// sphere/plane winner, tightened by the cluster's 16 triangle tests
// wherever the lane passes a cluster.  That is the tile's walk split by
// lane: a lane only hits a triangle inside a box it enters (the boxes are
// eps-padded), past that box's entry, so a cluster some other lane kept
// alive cannot tighten it.  A lane sets the cluster's bit of the (tile,
// search) listed and passed masks, one warp-aggregated atomicOr per word
// and group of lanes on one word; stats_sum_kernel counts the bits.  The
// walk reads the winner of no search, so the radiance and records are those
// of the instances without it, bit for bit.  Redesigned for Hopper
// (count_clusters): a block stages the boxes into shared memory after the
// tables (two float4 per row, read by a warp's lanes in step as
// broadcasts; 513 rows are 16.4 KB); a triangle is the row search's t-only
// test on pack_walk's aligned rows, with the t-first reject, and keeps no
// hit record; and a lane stops its scan once every remaining word of its
// masks is full (an exact early exit).  Its cost: per live
// lane and search one root and up to n_clu box tests from shared memory,
// and up to 16 triangle rows opened per passed cluster from L2.
//
// Rounding: every expression keeps the operation order of the JAX kernel
// and of the plain PyTorch version beside this wrapper
// (rvpt_tpu_torch/ops/pathkernel.py trace_plain).  Build with --fmad=false
// and without fast math: IEEE '/', sqrtf, sinf/cosf; rsqrtf where the JAX
// kernel uses lax.rsqrt.

#include <cstdint>
#include <cuda_runtime.h>

#include "bvh_search.cuh"
#include "bvh_walk.cuh"
#include "kajiya_shade.cuh"
#include "scene_search.cuh"

namespace {

using namespace scene;

constexpr int KAJIYA = 0, WHITTED = 1, COOK = 2;  // pathkernel.INTEGS
// What a Kajiya instance records per bounce: nothing, the 13 fields and the
// hit, or the hit alone.
constexpr int NO_RECORD = 0, FULL_RECORD = 1, HITS_RECORD = 2;
constexpr int THREADS = 256;
constexpr int CULL_K = 16;       // pathkernel.CULL_K
constexpr int CULL_TILE = 8192;  // pathkernel.CULL_TILE (a multiple of 32)
// The walk's stack form (bvh_walk.cuh, walk's PACKED): two arrays, which
// ran faster here than the packed entry.
constexpr bool PACKED_STACK = false;
// Whether integrator INTEG's row-form closest-hit searches take the
// t-first reject (scene_search.cuh, closest_hit's REJECT); the library
// reports it (rvpt_row_reject, pathkernel.row_reject).  Kajiya's (its
// collect instances too) do not: its frames ran as fast without it on the
// Cornell box and 5-21% faster on 600- and 1,000-triangle soups, its
// collect instances 3% faster; Whitted and Cook ran 6-8% faster with it
// (kernel_ab.py, NVIDIA H100 80GB HBM3 at 700 W).
__host__ __device__ constexpr bool row_reject(int integ) {
  return integ != KAJIYA;
}

// Or `bits` into `word` for every lane of the converged group that holds
// the same word: one atomicOr per word, none for zero bits.
__device__ __forceinline__ void or_word(uint32_t* word, uint32_t bits) {
  const unsigned group = __activemask();
  const unsigned peers =
      __match_any_sync(group, reinterpret_cast<unsigned long long>(word));
  const uint32_t all = __reduce_or_sync(peers, bits);
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1 && all != 0u) {
    atomicOr(word, all);
  }
}

// Row k of the staged cull_rows boxes (lo xyz, hi xyz, two unused), as a
// node for the slab test.
__device__ __forceinline__ bvh::Node box_node(const float4* boxes, int k) {
  const float4 a = boxes[2 * k], b = boxes[2 * k + 1];
  return bvh::Node{a.x, a.y, a.z, a.w, b.x, b.y, 0, 0};
}

// Floats of shared memory before the staged boxes (16-byte aligned) and
// of the boxes themselves: the counting instances' extra staging.
__host__ __device__ constexpr int boxes_at(int staged) {
  return (staged + 3) & ~3;
}

// The counting walk of one search for one lane (_culled_tris :371-470,
// split by lane): `boxes` cull_rows' rows staged in shared memory (the
// root, then n_clu clusters, two float4 each), `rows` pack_walk's triangle
// rows (leaf order, the clusters' order), the masks the (tile, search)
// words of the listed and passed bits, `seed` the sphere/plane winner's t.
//
// Two facts make it cheaper than a full search and keep every bit the
// parent's.  The scan reads only the best t: a cluster passes on t0 < ht,
// and the (t, index) tie rule never changes t, so each triangle is the row
// search's t-only test (test_tri_row with the t-first reject against ht)
// and no hit record is kept.  And mask bits are only ever set: a lane
// first reads its masks' words (L2 loads of the atomics' targets; a bit
// once seen set stays set) and scans only up to the first word from which
// every word of both masks is already full (the exact early exit), since
// nothing it could OR into those words changes them and nothing after the
// scan reads ht.  A lane reads the boxes in step with its warp's other
// lanes, so a box row is one shared-memory broadcast.
__device__ __forceinline__ void count_clusters(
    const float4* boxes, int n_clu, const float4* __restrict__ rows,
    int n_tri, float seed, float ox, float oy, float oz, float dx, float dy,
    float dz, float mint, uint32_t* listed, uint32_t* passed) {
  const bvh::InvDir iv = bvh::inv_dir(dx, dy, dz);
  float t0;
  if (!bvh::slab(box_node(boxes, 0), ox, oy, oz, iv, mint, t0)) return;
  const int words = (n_clu + 31) / 32;
  int stop = words;  // the scan ends before word `stop`
  for (; stop > 0; --stop) {
    const int w = stop - 1;
    const int hi = min(32, n_clu - 32 * w);
    const uint32_t all = hi == 32 ? ~0u : (1u << hi) - 1u;
    if ((__ldcg(listed + w) & __ldcg(passed + w) & all) != all) break;
  }
  float ht = seed;
  for (int w = 0; w < stop; ++w) {
    uint32_t lb = 0u, pb = 0u;
    const int hi = min(32, n_clu - 32 * w);
    for (int k = 0; k < hi; ++k) {
      const int c = 32 * w + k;
      if (!bvh::slab(box_node(boxes, 1 + c), ox, oy, oz, iv, mint, t0)) {
        continue;
      }
      lb |= 1u << k;
      if (!(t0 < ht)) continue;
      pb |= 1u << k;
      const int end = min(CULL_K * (c + 1), n_tri);
      for (int j = CULL_K * c; j < end; ++j) {
        float t;
        float4 a;
        if (scene::test_tri_row<true>(rows + walk::ROW * j, ox, oy, oz, dx,
                                      dy, dz, mint, ht, t, a)) {
          ht = t;
        }
      }
    }
    or_word(listed + w, lb);
    or_word(passed + w, pb);
  }
}

// Counters f32[3, grid] from the masks [grid][per_tile] words: listed,
// processed (= listed, :470) and still passed per tile.
__global__ void stats_sum_kernel(const uint32_t* __restrict__ listed,
                                 const uint32_t* __restrict__ passed,
                                 int grid, int per_tile,
                                 float* __restrict__ out) {
  const int tile = blockIdx.x * blockDim.x + threadIdx.x;
  if (tile >= grid) return;
  int nl = 0, np = 0;
  for (int k = 0; k < per_tile; ++k) {
    nl += __popc(listed[(int64_t)tile * per_tile + k]);
    np += __popc(passed[(int64_t)tile * per_tile + k]);
  }
  out[tile] = (float)nl;
  out[grid + tile] = (float)nl;
  out[2 * grid + tile] = (float)np;
}

// The counting walk's scan checked against the parent's: for ray i the
// sphere/plane winner's t, then every cluster in id order (no masks, no
// exit) by count_clusters' t-only test on pack_walk's rows and by the full
// bvh::test_triangle on pack_fwd's rows; writes both scans' final t and
// the number of clusters after which their running t differ in any bit.
__global__ void __launch_bounds__(THREADS) stats_scan_kernel(
    const float* __restrict__ tables, int n_tri, int n_sph, int n_pln,
    int n_mat, const float* __restrict__ walk_rows, int n_clu,
    const float* __restrict__ boxes, const float* __restrict__ ox_in,
    const float* __restrict__ oy_in, const float* __restrict__ oz_in,
    const float* __restrict__ dx_in, const float* __restrict__ dy_in,
    const float* __restrict__ dz_in, int n, float mint,
    float* __restrict__ t_ref, float* __restrict__ t_new,
    int32_t* __restrict__ differ) {
  extern __shared__ __align__(16) float smem[];
  const Tables s =
      stage(smem, nullptr, tables + TRI_STRIDE * n_tri, 0, n_sph, n_pln, n_mat);
  float4* box_s = reinterpret_cast<float4*>(
      smem + boxes_at(staged_floats(0, n_sph, n_pln, n_mat)));
  for (int k = threadIdx.x; k < 2 * (n_clu + 1); k += blockDim.x) {
    box_s[k] = __ldg(reinterpret_cast<const float4*>(boxes) + k);
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = ox_in[i], oy = oy_in[i], oz = oz_in[i];
  const float dx = dx_in[i], dy = dy_in[i], dz = dz_in[i];
  const float4* rows = reinterpret_cast<const float4*>(walk_rows);
  Hit h = miss();
  search_spheres(s, ox, oy, oz, dx, dy, dz, mint, h);
  search_planes(s, ox, oy, oz, dx, dy, dz, mint, h);
  float ht = h.t;
  int bad = 0;
  const bvh::InvDir iv = bvh::inv_dir(dx, dy, dz);
  float t0;
  if (bvh::slab(box_node(box_s, 0), ox, oy, oz, iv, mint, t0)) {
    for (int c = 0; c < n_clu; ++c) {
      if (!bvh::slab(box_node(box_s, 1 + c), ox, oy, oz, iv, mint, t0)) {
        continue;
      }
      const bool pass_ref = t0 < h.t, pass_new = t0 < ht;
      const int end = min(CULL_K * (c + 1), n_tri);
      for (int j = CULL_K * c; j < end; ++j) {
        if (pass_ref) {
          bvh::test_triangle(tables, j, ox, oy, oz, dx, dy, dz, mint, h);
        }
        float t;
        float4 a;
        if (pass_new &&
            scene::test_tri_row<true>(rows + walk::ROW * j, ox, oy, oz, dx,
                                      dy, dz, mint, ht, t, a)) {
          ht = t;
        }
      }
      bad += pass_ref != pass_new || __float_as_uint(h.t) != __float_as_uint(ht);
    }
  }
  t_ref[i] = h.t;
  t_new[i] = ht;
  differ[i] = bad;
}

template <int INTEG, int COLLECT, bool BVH, bool STATS>
__global__ void __launch_bounds__(THREADS) path_kernel(
    const float* __restrict__ tables, int n_tri, int n_sph, int n_pln,
    int n_mat, const float* __restrict__ nodes,
    const float* __restrict__ walk_rows, const float* __restrict__ cam_in,
    const int64_t* __restrict__ pix_ids, const float* __restrict__ ox_in,
    const float* __restrict__ oy_in, const float* __restrict__ oz_in,
    const float* __restrict__ dx_in, const float* __restrict__ dy_in,
    const float* __restrict__ dz_in, float* __restrict__ out,
    float* __restrict__ rec_f, int32_t* __restrict__ rec_i, int n,
    uint32_t frame, uint32_t salt_base, uint32_t jitter_salt,
    int max_bounces, int standard, int cam_mode, float mint, int n_clu,
    const float* __restrict__ boxes, uint32_t* __restrict__ st_listed,
    uint32_t* __restrict__ st_passed) {
  static_assert(!STATS || BVH, "the counters belong to the BVH form");
  extern __shared__ __align__(16) float smem[];
  // cam_in is null when the rays are passed in.  The BVH form stages all
  // but the triangles, which its walk reads from device memory (walk_rows,
  // pack_walk's rows and material ids).
  const Tables s =
      BVH ? stage(smem, cam_in, tables + TRI_STRIDE * n_tri, 0, n_sph, n_pln,
                  n_mat)
          : stage(smem, cam_in, tables, n_tri, n_sph, n_pln, n_mat);
  const walk::Tree tree =
      BVH ? walk::tree(walk_rows, n_tri, nodes) : walk::Tree{};
  // The counting instances stage the cluster boxes after the tables.
  float4* box_s = reinterpret_cast<float4*>(
      smem + boxes_at(staged_floats(0, n_sph, n_pln, n_mat)));
  if constexpr (STATS) {
    const float4* src = reinterpret_cast<const float4*>(boxes);
    for (int k = threadIdx.x; k < 2 * (n_clu + 1); k += blockDim.x) {
      box_s[k] = __ldg(src + k);
    }
    __syncthreads();
  }
  const float* cam = smem;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // Counter slots: bounce b's search, then Whitted's shadow search of
  // bounce b at max_bounces + b, Cook's tail at max_bounces
  // (pathkernel.stats_slots); each slot holds ceil(n_clu / 32) words.
  const int words = (n_clu + 31) / 32;
  const int slots = INTEG == WHITTED ? 2 * max_bounces
                    : INTEG == COOK  ? max_bounces + 1
                                     : max_bounces;
  // The counting walk of one search (STATS) from the sphere/plane winner.
  auto count_search = [&](int slot, float seed, float ox, float oy, float oz,
                          float dx, float dy, float dz) {
    const int64_t base = ((int64_t)(i / CULL_TILE) * slots + slot) * words;
    count_clusters(box_s, n_clu, tree.rows, n_tri, seed, ox, oy, oz, dx, dy,
                   dz, mint, st_listed + base, st_passed + base);
  };
  auto search = [&](int slot, float ox, float oy, float oz, float dx,
                    float dy, float dz) -> Hit {
    if constexpr (STATS) {
      // walk::closest_hit, with the seed of the counting walk kept.
      Hit h = miss();
      search_spheres(s, ox, oy, oz, dx, dy, dz, mint, h);
      search_planes(s, ox, oy, oz, dx, dy, dz, mint, h);
      const float seed = h.t;
      walk::walk<false, PACKED_STACK>(tree, ox, oy, oz, dx, dy, dz, mint, h);
      if (h.fam == 0) h.mat = __ldg(tree.mat + h.idx);
      count_search(slot, seed, ox, oy, oz, dx, dy, dz);
      return h;
    } else if constexpr (BVH) {
      return walk::closest_hit<PACKED_STACK>(s, tree, ox, oy, oz, dx, dy, dz,
                                             mint);
    } else {
      return closest_hit<row_reject(INTEG)>(s, ox, oy, oz, dx, dy, dz, mint);
    }
  };
  // Whether a shadow ray hits anything: search(...).fam >= 0, by the
  // any-hit walk in the BVH form, the any-hit row search in the row form.
  auto occluded = [&](int slot, float ox, float oy, float oz, float dx,
                      float dy, float dz) -> bool {
    if constexpr (STATS) {
      Hit h = miss();
      search_spheres(s, ox, oy, oz, dx, dy, dz, mint, h);
      search_planes(s, ox, oy, oz, dx, dy, dz, mint, h);
      const float seed = h.t;
      const bool hit =
          h.fam >= 0 || walk::walk<true, PACKED_STACK>(tree, ox, oy, oz, dx,
                                                       dy, dz, mint, h);
      count_search(slot, seed, ox, oy, oz, dx, dy, dz);
      return hit;
    } else if constexpr (BVH) {
      return walk::occluded<PACKED_STACK>(s, tree, ox, oy, oz, dx, dy, dz,
                                          mint);
    } else {
      return scene::occluded(s, ox, oy, oz, dx, dy, dz, mint);
    }
  };

  if (i >= n) return;
  const uint32_t pix = pix_ids ? (uint32_t)pix_ids[i] : (uint32_t)i;

  float ox, oy, oz, dx, dy, dz;
  if (ox_in) {
    ox = ox_in[i];
    oy = oy_in[i];
    oz = oz_in[i];
    dx = dx_in[i];
    dy = dy_in[i];
    dz = dz_in[i];
  } else {
    camera_ray(cam, cam_mode, pix, frame, jitter_salt, ox, oy, oz, dx, dy,
               dz);
  }

  float tr = 1.0f, tg = 1.0f, tb = 1.0f;  // throughput
  // Emission gathered on the path; Whitted starts at the ambient term.
  const float c0 = INTEG == WHITTED ? AMBIENT : 0.0f;
  float cr = c0, cg = c0, cb = c0;
  float rr = 0.0f, rg = 0.0f, rb = 0.0f;  // finished radiance
  bool active = true;
  bool final_ = false;  // Cook: the previous bounce scattered off Lambert
  int recorded = 0;  // bounces written to the record so far
  // Record slot f of bounce b for this ray.
  auto slot = [&](int b, int f) { return ((int64_t)b * 13 + f) * n + i; };
  auto write_fields = [&](int b, float act) {
    const float v[13] = {ox, oy, oz, dx, dy, dz, tr, tg, tb, cr, cg, cb, act};
    for (int f = 0; f < 13; ++f) rec_f[slot(b, f)] = v[f];
  };

  for (int bounce = 0; bounce < max_bounces && active; ++bounce) {
    if (COLLECT == FULL_RECORD) write_fields(bounce, 1.0f);
    const Hit h = search(bounce, ox, oy, oz, dx, dy, dz);
    if (COLLECT != NO_RECORD) {
      rec_i[((int64_t)bounce * 2) * n + i] = h.fam;
      rec_i[((int64_t)bounce * 2 + 1) * n + i] = h.idx;
      recorded = bounce + 1;
    }

    if (h.fam < 0) {  // the lane is active here: add the sky and end
      // Kajiya shifts d.y into [0,1]; Whitted and Cook use raw d.y.
      const float st = INTEG == KAJIYA ? dy * 0.5f + 0.5f : dy;
      rr = rr + cr + tr * (1.0f + SKY_R * st);
      rg = rg + cg + tg * (1.0f + SKY_G * st);
      rb = rb + cb + tb * (1.0f + SKY_B * st);
      active = false;
      break;
    }
    const float* M = material(s, h.mat);
    if (INTEG == COOK && final_) {  // end on this hit's emission
      rr = rr + cr + tr * M[3];
      rg = rg + cg + tg * M[4];
      rb = rb + cb + tb * M[5];
      active = false;
      break;
    }
    cr = cr + tr * M[3];
    cg = cg + tg * M[4];
    cb = cb + tb * M[5];

    // ---- shading geometry (_shade_geom)
    const shade::Frame f = shade::hit_frame(h, ox, oy, oz, dx, dy, dz);
    const float kind = M[7];
    if (INTEG == WHITTED && kind == 0.0f) {
      // Lambert: a shadow ray toward the light, the direct term unless
      // shadowed, and the path ends.
      if (occluded(max_bounces + bounce, f.px + EPSILON * f.nX,
                   f.py + EPSILON * f.nY, f.pz + EPSILON * f.nZ, LDIR_X,
                   LDIR_Y, LDIR_Z)) {
        rr = rr + cr;
        rg = rg + cg;
        rb = rb + cb;
      } else {
        const float cos_l =
            fmaxf(0.0f, LDIR_X * f.nX + LDIR_Y * f.nY + LDIR_Z * f.nZ);
        const float lit = LIGHT_I * cos_l;
        rr = rr + (cr + tr * M[0] * lit);
        rg = rg + (cg + tg * M[1] * lit);
        rb = rb + (cb + tb * M[2] * lit);
      }
      active = false;
      break;
    }
    shade::scatter(f, M, pix, frame, salt_base + 4u * (uint32_t)bounce, ox,
                   oy, oz, dx, dy, dz);
    if (INTEG == COOK) final_ = kind == 0.0f;
    tr = tr * M[0];
    tg = tg * M[1];
    tb = tb * M[2];
  }
  if (INTEG == COOK && active && final_) {
    // A Lambert scatter on the last bounce still resolves: one more
    // search, ending on its emission or the sky (raw d.y).
    const Hit h = search(max_bounces, ox, oy, oz, dx, dy, dz);
    if (h.fam >= 0) {
      const float* M = material(s, h.mat);
      rr = rr + cr + tr * M[3];
      rg = rg + cg + tg * M[4];
      rb = rb + cb + tb * M[5];
    } else {
      rr = rr + cr + tr * (1.0f + SKY_R * dy);
      rg = rg + cg + tg * (1.0f + SKY_G * dy);
      rb = rb + cb + tb * (1.0f + SKY_B * dy);
    }
    active = false;
  }
  if (COLLECT != NO_RECORD) {  // the lane ended early: frozen state, no hits
    for (int b = recorded; b < max_bounces; ++b) {
      if (COLLECT == FULL_RECORD) write_fields(b, 0.0f);
      rec_i[((int64_t)b * 2) * n + i] = -1;
      rec_i[((int64_t)b * 2 + 1) * n + i] = -1;
    }
  }
  if (standard && active) {
    rr = rr + cr;
    rg = rg + cg;
    rb = rb + cb;
  }
  out[i] = rr;
  out[(int64_t)n + i] = rg;
  out[2 * (int64_t)n + i] = rb;
}

template <int INTEG, int COLLECT, bool BVH, bool STATS>
int launch(const float* tables, int n_tri, int n_sph, int n_pln, int n_mat,
           const float* nodes, const float* walk_rows, const float* cam,
           const int64_t* pix_ids,
           const float* ox, const float* oy, const float* oz, const float* dx,
           const float* dy, const float* dz, float* out, float* rec_f, int32_t* rec_i, int n,
           uint32_t frame, uint32_t salt_base, uint32_t jitter_salt,
           int max_bounces, int standard, int cam_mode, float mint,
           void* stream, int n_clu, const float* boxes, uint32_t* st_listed,
           uint32_t* st_passed) {
  const int staged = staged_floats(BVH ? 0 : n_tri, n_sph, n_pln, n_mat);
  const size_t smem =
      sizeof(float) * (STATS ? boxes_at(staged) + 8 * (n_clu + 1) : staged);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        path_kernel<INTEG, COLLECT, BVH, STATS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n + THREADS - 1) / THREADS;
  path_kernel<INTEG, COLLECT, BVH, STATS>
      <<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      tables, n_tri, n_sph, n_pln, n_mat, nodes, walk_rows, cam, pix_ids, ox,
      oy, oz, dx, dy, dz, out, rec_f, rec_i, n, frame, salt_base, jitter_salt,
      max_bounces, standard, cam_mode, mint, n_clu, boxes, st_listed,
      st_passed);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rvpt_max_table_floats() { return max_table_floats(); }

// Whether integrator `integ`'s row-form closest-hit searches take the
// t-first reject (row_reject).
int rvpt_row_reject(int integ) { return row_reject(integ) ? 1 : 0; }

// Launch on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for an unknown integrator, records asked of Whitted
// or Cook, counters asked of the row form or with hits only.  With rec_f
// and rec_i non-null a Kajiya collect instance writes the record, with
// rec_i alone its hits-only instance the hits; with `nodes`
// non-null (pack_bvh's rows, with walk_rows pack_walk's) the BVH form
// runs, collect or not; with
// st_listed and st_passed non-null (zeroed int32[grid][slots][ceil(n_clu /
// 32)] masks, pathkernel.stats_slots) its counting instance also sets the
// cluster bits of the `boxes` (cull_rows) walk.
int rvpt_path_trace(const float* tables, int n_tri, int n_sph, int n_pln,
                    int n_mat, const float* nodes, const float* walk_rows,
                    const float* cam,
                    const int64_t* pix_ids,
                    const float* ox, const float* oy, const float* oz,
                    const float* dx, const float* dy, const float* dz,
                    float* out, float* rec_f, int32_t* rec_i, int n,
                    uint32_t frame, uint32_t salt_base, uint32_t jitter_salt,
                    int max_bounces, int standard, int cam_mode, float mint,
                    int integ, void* stream, int n_clu, const float* boxes,
                    uint32_t* st_listed, uint32_t* st_passed) {
  if (n <= 0) return 0;
  const bool collect = rec_i != nullptr;
  const bool hits_only = collect && rec_f == nullptr;
  const bool bvh_form = nodes != nullptr;
  const bool stats = st_listed != nullptr && st_passed != nullptr;
  if (bvh_form && walk_rows == nullptr) return (int)cudaErrorInvalidValue;
  if (stats && (!bvh_form || boxes == nullptr || n_clu <= 0 || hits_only)) {
    return (int)cudaErrorInvalidValue;
  }
#define RVPT_LAUNCH(I, C, B, S)                                               \
  launch<I, C, B, S>(tables, n_tri, n_sph, n_pln, n_mat, nodes, walk_rows,  \
                     cam, pix_ids, ox, oy, oz, dx, dy, dz, out, rec_f, rec_i, \
                     n, frame, salt_base, jitter_salt, max_bounces, standard, \
                     cam_mode, mint, stream, n_clu, boxes, st_listed,         \
                     st_passed)
  if (collect) {
    if (integ != KAJIYA) return (int)cudaErrorInvalidValue;
    if (hits_only) {
      return bvh_form ? RVPT_LAUNCH(KAJIYA, HITS_RECORD, true, false)
                      : RVPT_LAUNCH(KAJIYA, HITS_RECORD, false, false);
    }
    if (stats) return RVPT_LAUNCH(KAJIYA, FULL_RECORD, true, true);
    return bvh_form ? RVPT_LAUNCH(KAJIYA, FULL_RECORD, true, false)
                    : RVPT_LAUNCH(KAJIYA, FULL_RECORD, false, false);
  }
  if (integ == KAJIYA) {
    if (stats) return RVPT_LAUNCH(KAJIYA, NO_RECORD, true, true);
    return bvh_form ? RVPT_LAUNCH(KAJIYA, NO_RECORD, true, false)
                    : RVPT_LAUNCH(KAJIYA, NO_RECORD, false, false);
  }
  if (integ == WHITTED) {
    if (stats) return RVPT_LAUNCH(WHITTED, NO_RECORD, true, true);
    return bvh_form ? RVPT_LAUNCH(WHITTED, NO_RECORD, true, false)
                    : RVPT_LAUNCH(WHITTED, NO_RECORD, false, false);
  }
  if (integ == COOK) {
    if (stats) return RVPT_LAUNCH(COOK, NO_RECORD, true, true);
    return bvh_form ? RVPT_LAUNCH(COOK, NO_RECORD, true, false)
                    : RVPT_LAUNCH(COOK, NO_RECORD, false, false);
  }
#undef RVPT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Sum the counting instance's masks ([grid][per_tile] words) into
// out f32[3, grid]; returns cudaGetLastError() of the launch.
int rvpt_path_stats_sum(const uint32_t* listed, const uint32_t* passed,
                        int grid, int per_tile, float* out, void* stream) {
  if (grid <= 0) return 0;
  stats_sum_kernel<<<(grid + THREADS - 1) / THREADS, THREADS, 0,
                     (cudaStream_t)stream>>>(listed, passed, grid, per_tile,
                                             out);
  return (int)cudaGetLastError();
}

// stats_scan_kernel on n rays passed in (tables as the BVH form's,
// walk_rows pack_walk's, boxes cull_rows'); returns cudaGetLastError().
int rvpt_stats_scan(const float* tables, int n_tri, int n_sph, int n_pln,
                    int n_mat, const float* walk_rows, int n_clu,
                    const float* boxes, const float* ox, const float* oy,
                    const float* oz, const float* dx, const float* dy,
                    const float* dz, int n, float mint, float* t_ref,
                    float* t_new, int32_t* differ, void* stream) {
  if (n <= 0) return 0;
  const size_t smem =
      sizeof(float) * (boxes_at(staged_floats(0, n_sph, n_pln, n_mat)) +
                       8 * (n_clu + 1));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stats_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  stats_scan_kernel<<<(n + THREADS - 1) / THREADS, THREADS, smem,
                      (cudaStream_t)stream>>>(
      tables, n_tri, n_sph, n_pln, n_mat, walk_rows, n_clu, boxes, ox, oy, oz,
      dx, dy, dz, n, mint, t_ref, t_new, differ);
  return (int)cudaGetLastError();
}

const char* rvpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
