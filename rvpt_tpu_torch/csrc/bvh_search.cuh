// The binary per-ray BVH walk of the big-mesh kernel B5 (bigmesh_kernel.cu)
// and its counting instance, and the node helpers B6 (bigmesh_hart.cu) and
// the redesigned walk of K1's and B3's BVH forms (bvh_walk.cuh) share.
// This walk is the reference: bvh_walk.cuh walks the same tree in the same
// order and is held against it bit for bit through B5's per-bounce route.
// It replaces the cluster-culled triangle searches of
// rvpt_tpu/ops/pathkernel.py (_culled_tris :311 for K1's and B3's culled
// form, _culled_tris_rows :472 for the big-mesh kernels): per-tile work
// lists over SMEM cluster boxes there; here one thread walks the tree for
// its own ray, the reference's own design (intersection.glsl:361-463).
//
// Tables: the triangles are pack_fwd's [T,17] rows (TRI_FIELDS) in the
// tree's leaf order, read from device memory (20,482 triangles are 1.4 MB,
// far past shared memory); the nodes are pack_bvh's [M,8] rows, the box
// padded by pack_cull's eps (:148) so that rounding never prunes a flat box
// such as a quad light, then first and count as int32 bit patterns.
//
// The winner rule is the culled search's, exactly: spheres and planes are
// searched first and the triangles last, and a triangle wins only with a
// strictly smaller t (:829-835), so a sphere or plane keeps an exact tie.
// Among triangles the lowest leaf-order index wins a tie; the walk does not
// visit triangles in ascending order, so it compares (t, index).  A node is
// pruned when its padded box is missed or entered at or past the current
// best t (the padding keeps every triangle's t strictly past its box's
// entry), so the prune never changes the winner.  The walk visits the
// nearer child first and keeps the other on a per-thread stack of node and
// entry t; pack_bvh checks on the host that the tree fits the stack.
//
// The counting instance (COUNT = true, used by the big-mesh kernel's
// counting entry for the bounds of chip_smoke.py) walks the same way and
// also counts the thread's node slab tests, triangle tests and loop
// iterations (one per node visited, for the warps' SIMD efficiency); every
// display instance leaves COUNT false and compiles to the walk alone.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "scene_search.cuh"

namespace bvh {

using namespace scene;

constexpr int STACK = 64;  // pathkernel.BVH_STACK
constexpr int NODE_STRIDE = 8;  // pathkernel.NODE_FIELDS

struct Mesh {
  const float* tri;    // [T,17] leaf-ordered triangle rows
  const float* nodes;  // [M,8] pack_bvh rows
  int n_tri;
};

// Per-thread work of a walk: node tests (the root's included), triangle
// (or, for the distance kernel, primitive) tests and loop iterations.
struct WalkCount {
  int box = 0, tri = 0, iter = 0;
};

struct Node {
  float lx, ly, lz, hx, hy, hz;
  int first, count;
};

__device__ __forceinline__ Node load_node(const float* nodes, int k) {
  const float4* p = reinterpret_cast<const float4*>(nodes + NODE_STRIDE * k);
  const float4 a = __ldg(p), b = __ldg(p + 1);
  return Node{a.x, a.y, a.z, a.w, b.x, b.y, __float_as_int(b.z),
              __float_as_int(b.w)};
}

// The ray's reciprocal direction for the slab test, a zero component
// clamped to the sign-keeping 1e-30 (_culled_tris' inv).
struct InvDir {
  float x, y, z;
};

__device__ __forceinline__ InvDir inv_dir(float dx, float dy, float dz) {
  return InvDir{1.0f / safe_den(dx), 1.0f / safe_den(dy), 1.0f / safe_den(dz)};
}

// Slab test of a box (_culled_tris' slab): true when the ray meets it at
// or past mint; t0 is the entry.
__device__ __forceinline__ bool slab(const Node& b, float ox, float oy,
                                     float oz, const InvDir& iv, float mint,
                                     float& t0) {
  const float fx0 = (b.lx - ox) * iv.x;
  const float fx1 = (b.hx - ox) * iv.x;
  const float fy0 = (b.ly - oy) * iv.y;
  const float fy1 = (b.hy - oy) * iv.y;
  const float fz0 = (b.lz - oz) * iv.z;
  const float fz1 = (b.hz - oz) * iv.z;
  t0 = fmaxf(fmaxf(fminf(fx0, fx1), fminf(fy0, fy1)),
             fmaxf(fminf(fz0, fz1), mint));
  const float t1 = fminf(fminf(fmaxf(fx0, fx1), fmaxf(fy0, fy1)),
                         fmaxf(fz0, fz1));
  return t1 >= t0;
}

// The metric-tensor test of leaf-order triangle j, folded into `h` by the
// (t, index) rule; the arithmetic of search_tri_rows.
__device__ __forceinline__ void test_triangle(const float* tri, int j,
                                              float ox, float oy, float oz,
                                              float dx, float dy, float dz,
                                              float mint, Hit& h) {
  const float* T = tri + TRI_STRIDE * j;
  const float nx = __ldg(T + 0), ny = __ldg(T + 1), nz = __ldg(T + 2);
  const float e0x = __ldg(T + 3), e0y = __ldg(T + 4), e0z = __ldg(T + 5);
  const float e1x = __ldg(T + 6), e1y = __ldg(T + 7), e1z = __ldg(T + 8);
  const float dn = nx * dx + ny * dy + nz * dz;
  const float on = nx * ox + ny * oy + nz * oz;
  const float de0 = e0x * dx + e0y * dy + e0z * dz;
  const float de1 = e1x * dx + e1y * dy + e1z * dz;
  const float oe0 = e0x * ox + e0y * oy + e0z * oz;
  const float oe1 = e1x * ox + e1y * oy + e1z * oz;
  const float t = (__ldg(T + 9) - on) / safe_den(dn);
  const float b0 = oe0 + t * de0 - __ldg(T + 10);
  const float b1 = oe1 + t * de1 - __ldg(T + 11);
  const float g00 = __ldg(T + 12), g11 = __ldg(T + 13), g01 = __ldg(T + 14);
  const float inv_det = __ldg(T + 15);
  const float u = inv_det * (g11 * b0 - g01 * b1);
  const float v = inv_det * (g00 * b1 - g01 * b0);
  const bool better = t < h.t || (t == h.t && h.fam == 0 && j < h.idx);
  if (mint < t && better && u > 0.0f && v > 0.0f && u + v < 1.0f) {
    h.t = t;
    h.nx = nx;
    h.ny = ny;
    h.nz = nz;
    h.mat = __ldg(T + 16);
    h.fam = 0;
    h.idx = j;
  }
}

// Fold the mesh's triangles into `h` by walking the tree; with COUNT, add
// the walk's tests to `c`.
template <bool COUNT = false>
__device__ __forceinline__ void walk(const Mesh& m, float ox, float oy,
                                     float oz, float dx, float dy, float dz,
                                     float mint, Hit& h,
                                     WalkCount* c = nullptr) {
  const InvDir iv = inv_dir(dx, dy, dz);
  int stack[STACK];
  float stack_t[STACK];
  int sp = 0;
  float t_root;
  if constexpr (COUNT) ++c->box;
  if (!slab(load_node(m.nodes, 0), ox, oy, oz, iv, mint, t_root) ||
      !(t_root < h.t)) {
    return;
  }
  int node = 0;
  while (true) {
    if constexpr (COUNT) ++c->iter;
    const Node nd = load_node(m.nodes, node);
    bool next = false;
    if (nd.count > 0) {
      for (int j = nd.first; j < nd.first + nd.count; ++j) {
        test_triangle(m.tri, j, ox, oy, oz, dx, dy, dz, mint, h);
      }
      if constexpr (COUNT) c->tri += nd.count;
    } else {
      if constexpr (COUNT) c->box += 2;
      float ta, tb;
      const bool ha = slab(load_node(m.nodes, nd.first), ox, oy, oz, iv, mint,
                           ta) && ta < h.t;
      const bool hb = slab(load_node(m.nodes, nd.first + 1), ox, oy, oz, iv,
                           mint, tb) && tb < h.t;
      if (ha && hb) {  // the nearer first; the other waits on the stack
        const bool b_first = tb < ta;
        stack[sp] = b_first ? nd.first : nd.first + 1;
        stack_t[sp] = b_first ? ta : tb;
        ++sp;
        node = b_first ? nd.first + 1 : nd.first;
        next = true;
      } else if (ha || hb) {
        node = ha ? nd.first : nd.first + 1;
        next = true;
      }
    }
    while (!next && sp > 0) {  // the next waiting node still in front of h
      --sp;
      if (stack_t[sp] < h.t) {
        node = stack[sp];
        next = true;
      }
    }
    if (!next) return;
  }
}

// Closest hit of a BVH scene: spheres and planes from the staged tables,
// then the triangles by the walk (the culled search, :828-835); with COUNT,
// the walk's tests go to `c`.
template <bool COUNT = false>
__device__ __forceinline__ Hit closest_hit_mesh(const Tables& s, const Mesh& m,
                                                float ox, float oy, float oz,
                                                float dx, float dy, float dz,
                                                float mint,
                                                WalkCount* c = nullptr) {
  Hit h = miss();
  search_spheres(s, ox, oy, oz, dx, dy, dz, mint, h);
  search_planes(s, ox, oy, oz, dx, dy, dz, mint, h);
  walk<COUNT>(m, ox, oy, oz, dx, dy, dz, mint, h, c);
  return h;
}

}  // namespace bvh
