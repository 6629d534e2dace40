// The BVH walk of K1's and B3's BVH forms (path_kernel.cu,
// primary_kernel.cu), redesigned for Hopper beside the binary walk of
// bvh_search.cuh, which the big-mesh kernels B5 and B6 keep and with which
// count_bvh_walk counts every bound.  It walks the same tree (pack_bvh's
// padded boxes) in the same order, the nearer child first, under the same
// winner rule, so a closest-hit search returns what bvh::closest_hit_mesh
// returns, bit for bit.  Three changes:
//
// - Occlusion searches (B3's AO probes and Appel shadow ray, K1's Whitted
//   shadow ray) use only whether something is hit: `occluded` searches the
//   spheres and planes first and skips the walk when either hits; else it
//   walks until the first triangle that passes the closest-hit search's
//   acceptance against the miss sentinel (mint < t < BIG and the u, v
//   test), and stops there (the reference's intersect_bvh_any,
//   intersection.glsl:417-463).  Until its first acceptance a closest-hit
//   walk keeps the sentinel as its best t, so it visits the same nodes and
//   accepts the same first triangle: the answer is its fam >= 0.
// - Triangle rows: pack_walk's leaf-ordered [T,16] rows, four aligned
//   float4 (nx ny nz v0n | e0 v0e0 | e1 v0e1 | g00 g11 g01 inv_det), the
//   material in a side f32[T] read once per search, for a triangle winner.
//   A test loads the first float4, computes t with the row search's
//   arithmetic in its order, and rejects on !(mint < t) or on a t that
//   cannot beat the best under the (t, index) rule before it loads the
//   rest: exactly the cases in which the full test changes nothing.  With
//   EAGER it loads the whole row at once and tests it in full, for a
//   search whose rows nearly all pass the reject (B3's camera search in
//   modes 0-3), where the reject's dependent loads cost more than the
//   tests they save.
// - The loop: a child that the walk descends into keeps the node row its
//   slab test loaded, so only a node taken from the stack is loaded again;
//   the stack holds a waiting node either as one 64-bit entry (the entry
//   t's bits, the node) or in two arrays of node and entry t, as the
//   binary walk does, each kernel taking the form that ran faster in it.
//
// The counting instances (COUNT = true; primary_kernel.cu's
// walk_count_kernel, for chip_smoke.py's census and bounds) walk the same
// way with the t-first reject and also count the node slab tests, the
// triangle rows opened (first float4 and t), the rows tested in full and
// the loop's iterations; every display instance compiles to the walk
// alone.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "bvh_search.cuh"
#include "scene_search.cuh"

namespace walk {

using namespace scene;

using bvh::STACK;         // pathkernel.BVH_STACK
constexpr int ROW = 4;     // float4 per triangle row (pathkernel.WALK_FIELDS)

struct Tree {
  const float4* rows;  // [T,16] pack_walk rows, leaf order
  const float* mat;    // [T] material ids, leaf order
  const float* nodes;  // [M,8] pack_bvh rows
};

// pack_walk's flat buffer (the rows, then the material ids) and the nodes.
__device__ __forceinline__ Tree tree(const float* walk_rows, int n_tri,
                                     const float* nodes) {
  return Tree{reinterpret_cast<const float4*>(walk_rows),
              walk_rows + 16 * n_tri, nodes};
}

// Per-thread work: node slab tests (the root's included), triangle rows
// opened (the first float4 and t), rows tested in full, loop iterations.
struct Count {
  int box = 0, tri = 0, full = 0, iter = 0;
};

// Triangle j against the ray: true when it passes the acceptance and
// beats `h` under the (t, index) rule, which then holds it (all but the
// material).  EAGER: the whole row loaded at once, no t-first reject.
template <bool EAGER, bool COUNT>
__device__ __forceinline__ bool test_row(const float4* rows, int j, float ox,
                                         float oy, float oz, float dx,
                                         float dy, float dz, float mint,
                                         Hit& h, Count* c) {
  const float4* R = rows + ROW * j;
  const float4 a = __ldg(R);
  float4 e0, e1, g;
  if constexpr (EAGER) {
    e0 = __ldg(R + 1);
    e1 = __ldg(R + 2);
    g = __ldg(R + 3);
  }
  const float dn = a.x * dx + a.y * dy + a.z * dz;
  const float on = a.x * ox + a.y * oy + a.z * oz;
  const float t = (a.w - on) / safe_den(dn);
  if constexpr (COUNT) ++c->tri;
  const bool better = t < h.t || (t == h.t && h.fam == 0 && j < h.idx);
  if constexpr (!EAGER) {
    if (!(mint < t) || !better) return false;
    e0 = __ldg(R + 1);
    e1 = __ldg(R + 2);
    g = __ldg(R + 3);
  }
  if constexpr (COUNT) ++c->full;
  const float de0 = e0.x * dx + e0.y * dy + e0.z * dz;
  const float de1 = e1.x * dx + e1.y * dy + e1.z * dz;
  const float oe0 = e0.x * ox + e0.y * oy + e0.z * oz;
  const float oe1 = e1.x * ox + e1.y * oy + e1.z * oz;
  const float b0 = oe0 + t * de0 - e0.w;
  const float b1 = oe1 + t * de1 - e1.w;
  const float u = g.w * (g.y * b0 - g.z * b1);
  const float v = g.w * (g.x * b1 - g.z * b0);
  if (!(mint < t && better && u > 0.0f && v > 0.0f && u + v < 1.0f)) {
    return false;
  }
  h.t = t;
  h.nx = a.x;
  h.ny = a.y;
  h.nz = a.z;
  h.fam = 0;
  h.idx = j;
  return true;
}

__device__ __forceinline__ uint64_t entry(int node, float t) {
  return ((uint64_t)__float_as_uint(t) << 32) | (uint32_t)node;
}

// Fold the mesh's triangles into `h` by walking the tree (ANY: stop at the
// first acceptance and return true; EAGER: test_row's); with COUNT, add
// the walk's work to `c`.
//
// The stack holds the waiting nodes and their entry t, STACK deep (the
// binary walk's depth; a 32-deep stack timed the same): with PACKED one
// 64-bit entry per node, the entry t's bits over the node, else two
// arrays.  Both hold the same nodes in the same order.  Which runs faster
// depends on the kernel the walk is inlined into (kernel_ab.py on an
// NVIDIA H100 80GB HBM3 at 700 W: B3's AO frames faster packed, K1's
// Kajiya frames faster with the arrays, at the same registers and spill),
// so each kernel picks its own.  The stack pointer stays a variable of
// its own: in one struct with the arrays it cost 8 more bytes of stack
// frame (the pointer in local memory) and B3's frames ran 20-25% slower.
template <bool ANY, bool PACKED, bool EAGER = false, bool COUNT = false>
__device__ __forceinline__ bool walk(const Tree& m, float ox, float oy,
                                     float oz, float dx, float dy, float dz,
                                     float mint, Hit& h, Count* c = nullptr) {
  const bvh::InvDir iv = bvh::inv_dir(dx, dy, dz);
  uint64_t packed[PACKED ? STACK : 1];
  int node_at[PACKED ? 1 : STACK];
  float t_at[PACKED ? 1 : STACK];
  int sp = 0;
  float t0;
  if constexpr (COUNT) ++c->box;
  bvh::Node cur = bvh::load_node(m.nodes, 0);
  if (!bvh::slab(cur, ox, oy, oz, iv, mint, t0) || !(t0 < h.t)) return false;
  while (true) {
    if constexpr (COUNT) ++c->iter;
    bool next = false;
    if (cur.count > 0) {
      for (int j = cur.first; j < cur.first + cur.count; ++j) {
        if (test_row<EAGER, COUNT>(m.rows, j, ox, oy, oz, dx, dy, dz, mint,
                                   h, c) &&
            ANY) {
          return true;
        }
      }
    } else {
      if constexpr (COUNT) c->box += 2;
      const bvh::Node a = bvh::load_node(m.nodes, cur.first);
      const bvh::Node b = bvh::load_node(m.nodes, cur.first + 1);
      float ta, tb;
      const bool ha = bvh::slab(a, ox, oy, oz, iv, mint, ta) && ta < h.t;
      const bool hb = bvh::slab(b, ox, oy, oz, iv, mint, tb) && tb < h.t;
      if (ha && hb) {  // the nearer first; the other waits on the stack
        const bool b_first = tb < ta;
        if constexpr (PACKED) {
          packed[sp] =
              b_first ? entry(cur.first, ta) : entry(cur.first + 1, tb);
        } else {
          node_at[sp] = b_first ? cur.first : cur.first + 1;
          t_at[sp] = b_first ? ta : tb;
        }
        ++sp;
        cur = b_first ? b : a;
        next = true;
      } else if (ha || hb) {
        cur = ha ? a : b;
        next = true;
      }
    }
    while (!next && sp > 0) {  // the next waiting node still in front of h
      --sp;
      if constexpr (PACKED) {
        const uint64_t e = packed[sp];
        if (__uint_as_float((uint32_t)(e >> 32)) < h.t) {
          cur = bvh::load_node(m.nodes, (int)(uint32_t)e);
          next = true;
        }
      } else if (t_at[sp] < h.t) {
        cur = bvh::load_node(m.nodes, node_at[sp]);
        next = true;
      }
    }
    if (!next) return false;
  }
}

// Closest hit of a BVH scene: spheres and planes from the staged tables,
// then the triangles by the walk, then a triangle winner's material.
template <bool PACKED, bool EAGER = false, bool COUNT = false>
__device__ __forceinline__ Hit closest_hit(const Tables& s, const Tree& m,
                                           float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float mint, Count* c = nullptr) {
  Hit h = miss();
  search_spheres(s, ox, oy, oz, dx, dy, dz, mint, h);
  search_planes(s, ox, oy, oz, dx, dy, dz, mint, h);
  walk<false, PACKED, EAGER, COUNT>(m, ox, oy, oz, dx, dy, dz, mint, h, c);
  if (h.fam == 0) h.mat = __ldg(m.mat + h.idx);
  return h;
}

// Whether the ray hits anything: closest_hit(...).fam >= 0, bit for bit.
template <bool PACKED, bool COUNT = false>
__device__ __forceinline__ bool occluded(const Tables& s, const Tree& m,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float mint, Count* c = nullptr) {
  Hit h = miss();
  search_spheres(s, ox, oy, oz, dx, dy, dz, mint, h);
  search_planes(s, ox, oy, oz, dx, dy, dz, mint, h);
  return h.fam >= 0 ||
         walk<true, PACKED, false, COUNT>(m, ox, oy, oz, dx, dy, dz, mint, h,
                                          c);
}

}  // namespace walk
