// Big-mesh Hart kernels for Hopper (sm_90a) on a BVH mesh of more than
// 1,024 triangles, one thread per ray or point: the whole 32-step Hart
// march in one launch (the display path), and one step's scene distance
// (the per-step instance).
//
// Replaces the Pallas kernel B6 of rvpt_tpu/ops/pathkernel.py
// (make_bigmesh_hart_kernel :2820, launched by _bigmesh_hart_call :2900
// once per step of BigMeshTracer.trace_hart :3237): for each live point,
// sqrt of the minimum over all triangles of the iq unsigned squared
// distance (tri_dist.cuh, shared with the Hart march kernel B4), from 3e38
// down.  The TPU kernel streams triangle chunks and skips a cluster whose
// box distance is at least the running minimum; here the thread walks the
// tree (pack_bvh's nodes, boxes padded by pack_cull's eps) for its own
// point, nearer child first, and skips a node whose box squared distance
// is at least the running minimum.  That skip is exact (:2824-2829): a
// box's distance bounds below the distance of every triangle in it, and
// the minimum does not depend on the order of the triangles.
//
// The march (march_kernel): each thread starts at o + mint d and, for
// MARCH_ITER steps, takes the scene distance, stops at the first step with
// dist < MARCH_EPS (writing that step; MARCH_ITER where it never stops),
// else advances p + dist d (two roundings, as the PyTorch loop rounds).
// The point stays in registers: one launch per frame, where a launch per
// step would add 31 launches and about six PyTorch ops between each two,
// and a round trip of the points through device memory.  Warm start: each
// step's walk starts from the exact squared distance to the triangle that
// gave the previous step's minimum (the same tri_dist2 on the same inputs,
// so bit for bit the value the walk would find there), not from 3e38.  The
// minimum, and every bit of it, is unchanged wherever the walk's box bound
// holds (see the counting instances below); the walk only prunes every
// box at least that far, and the point moved by dist, so that triangle is
// at most 2 dist away.  Escape: before each step's walk, a point outside
// the ball that bounds the mesh with ESCAPE_MARGIN to spare (the caller's
// ball around the padded root box, pathkernel.march_escape) whose ray moves
// away from the ball's centre ((p - c).d >= 0) is done: the distance from
// a moving point to a centre it moves away from never falls, so every
// later step's distance stays at least the margin, far above MARCH_EPS
// and above any rounding of the distance, and the march would write
// MARCH_ITER.  The thread writes it now and skips the walks of the rest of
// its steps, which on a frame of rays that mostly miss the mesh are most
// of the work.  A lane that is not live writes MARCH_ITER and does no
// work.
//
// Counting instances (COUNT) walk the same way and also write each
// point's box and triangle distances as int32: the per-step instance
// [2,N]; the march [7,N], the cold-start walk's at every step the
// per-step design ran (from 3e38, marching on past the escape: the
// parent's work) and the warm walk's up to the escape (the march's own
// work, for the bound), each summed over the point's steps, the steps
// before the escape at which the two minima differ, 1 where the march,
// carried on past its escape, stopped after all (0 when the escape test
// holds), and the steps at which the march walked.  The walk's box bound
// holds under rounding only near the mesh: far from it, where a box's
// squared distance and a triangle's inside it are huge and nearly equal,
// the box can round above the triangle, and a cold and a warm walk can
// end one rounding apart; no march stops there, and the escape test keeps
// the march from walking there at all.
//
// What bounds it on this card: the walk, about 100 operations per
// triangle distance plus the box distances, with nodes and raw vertex rows
// (pack_hart, leaf order) read from device memory along each point's walk;
// the lanes of a warp diverge (neighbouring points walk different subtrees
// and stop at different steps).  Weighed and left out: a stack sized by the
// tree's depth (the stack lives in local memory either way, and only its
// touched top is cached), the top nodes staged in shared memory (they stay
// hot in L1 through __ldg), vector loads of the leaf rows (9-float rows,
// 4-byte aligned).
//
// Rounding: the operation order of the plain versions
// (rvpt_tpu_torch/ops/pathkernel.py bigmesh_distance_plain,
// bigmesh_march_plain and _tri_dist2).  Build with --fmad=false and
// without fast math.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "bvh_search.cuh"
#include "tri_dist.cuh"

namespace {

using bvh::Node;

constexpr int THREADS = 256;
constexpr int HART_STRIDE = 9;  // pathkernel.HART_FIELDS
constexpr float BIG = 3.0e38f;
constexpr int MARCH_ITER = 32;     // pathkernel.MARCH_ITER
constexpr float MARCH_EPS = 0.1f;  // pathkernel.MARCH_EPS

// Squared distance from p to a padded node box (0 inside it).
__device__ __forceinline__ float box_dist2(const Node& b, float px, float py,
                                           float pz) {
  const float ex = fmaxf(fmaxf(b.lx - px, px - b.hx), 0.0f);
  const float ey = fmaxf(fmaxf(b.ly - py, py - b.hy), 0.0f);
  const float ez = fmaxf(fmaxf(b.lz - pz, pz - b.hz), 0.0f);
  return ex * ex + ey * ey + ez * ez;
}

// The squared distance from p to the nearest triangle: the walk from
// `best` down (3e38 cold, or a triangle's exact squared distance warm);
// `tri` becomes the triangle that set it (unchanged when none beat the
// seed).  With COUNT, the walk's box and triangle distances go to `c`.
template <bool COUNT>
__device__ __forceinline__ float nearest2(const float* __restrict__ vtx,
                                          const float* __restrict__ nodes,
                                          float px, float py, float pz,
                                          float best, int& tri,
                                          bvh::WalkCount& c) {
  int stack[bvh::STACK];
  float stack_d[bvh::STACK];
  int sp = 0;
  int node = 0;
  if constexpr (COUNT) ++c.box;
  bool next = box_dist2(bvh::load_node(nodes, 0), px, py, pz) < best;
  while (next) {
    const Node nd = bvh::load_node(nodes, node);
    next = false;
    if (nd.count > 0) {
      for (int j = nd.first; j < nd.first + nd.count; ++j) {
        float v[HART_STRIDE];
        for (int k = 0; k < HART_STRIDE; ++k) {
          v[k] = __ldg(vtx + (int64_t)HART_STRIDE * j + k);
        }
        const float d2 = tri_dist::tri_dist2(px, py, pz, v);
        if (d2 < best) {
          best = d2;
          tri = j;
        }
      }
      if constexpr (COUNT) c.tri += nd.count;
    } else {
      if constexpr (COUNT) c.box += 2;
      const float da = box_dist2(bvh::load_node(nodes, nd.first), px, py, pz);
      const float db =
          box_dist2(bvh::load_node(nodes, nd.first + 1), px, py, pz);
      const bool ha = da < best, hb = db < best;
      if (ha && hb) {  // the nearer first; the other waits on the stack
        const bool b_first = db < da;
        stack[sp] = b_first ? nd.first : nd.first + 1;
        stack_d[sp] = b_first ? da : db;
        ++sp;
        node = b_first ? nd.first + 1 : nd.first;
        next = true;
      } else if (ha || hb) {
        node = ha ? nd.first : nd.first + 1;
        next = true;
      }
    }
    while (!next && sp > 0) {  // the next waiting node still nearer than best
      --sp;
      if (stack_d[sp] < best) {
        node = stack[sp];
        next = true;
      }
    }
  }
  return best;
}

// One step: the scene distance at each live point, +inf elsewhere.
template <bool COUNT>
__global__ void __launch_bounds__(THREADS) bigmesh_hart_kernel(
    const float* __restrict__ vtx, const float* __restrict__ nodes,
    const float* __restrict__ p, const float* __restrict__ live,
    float* __restrict__ out, int32_t* __restrict__ out_count, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bvh::WalkCount c;
  float d = INFINITY;
  if (live[i] > 0.0f) {
    int tri = -1;
    d = sqrtf(nearest2<COUNT>(vtx, nodes, p[i], p[(int64_t)n + i],
                              p[2 * (int64_t)n + i], BIG, tri, c));
  }
  out[i] = d;
  if constexpr (COUNT) {
    out_count[i] = c.box;
    out_count[(int64_t)n + i] = c.tri;
  }
}

// The ball that bounds the mesh, grown by ESCAPE_MARGIN: a ray whose
// point lies outside it and moves away from its centre never comes within
// MARCH_EPS of a triangle again.
struct Escape {
  float cx, cy, cz, r2;  // centre, squared radius
};

// The whole march: the step at which each live ray stops, MARCH_ITER
// where it never does (and on a lane that is not live).
template <bool COUNT>
__global__ void __launch_bounds__(THREADS) march_kernel(
    const float* __restrict__ vtx, const float* __restrict__ nodes,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ live, float mint, Escape esc,
    int32_t* __restrict__ out, int32_t* __restrict__ out_count, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bvh::WalkCount warm, cold;
  int differ = 0, late = 0, walks = 0;
  int iters = MARCH_ITER;
  if (live == nullptr || live[i] > 0.0f) {
    const int64_t n64 = n;
    const float dx = d[i], dy = d[n64 + i], dz = d[2 * n64 + i];
    float px = o[i] + mint * dx;
    float py = o[n64 + i] + mint * dy;
    float pz = o[2 * n64 + i] + mint * dz;
    int tri = -1;
    bool escaped = false;
    for (int step = 0; step < MARCH_ITER; ++step) {
      if (!escaped) {
        const float vx = px - esc.cx, vy = py - esc.cy, vz = pz - esc.cz;
        escaped = vx * dx + vy * dy + vz * dz >= 0.0f &&
                  vx * vx + vy * vy + vz * vz >= esc.r2;
        if (escaped && !COUNT) break;  // iters stays MARCH_ITER
      }
      float best = BIG;
      if (!escaped) {
        float seed = BIG;
        if (tri >= 0) {
          float v[HART_STRIDE];
          for (int k = 0; k < HART_STRIDE; ++k) {
            v[k] = __ldg(vtx + (int64_t)HART_STRIDE * tri + k);
          }
          seed = tri_dist::tri_dist2(px, py, pz, v);
        }
        best = nearest2<COUNT>(vtx, nodes, px, py, pz, seed, tri, warm);
        if constexpr (COUNT) ++walks;
      }
      if constexpr (COUNT) {
        // The cold-start walk at every step the per-step design ran (past
        // the escape too, to its end), the parent's work; past the escape
        // its minimum moves the point.
        int cold_tri = -1;
        const float b =
            nearest2<COUNT>(vtx, nodes, px, py, pz, BIG, cold_tri, cold);
        if (escaped) {
          best = b;
        } else {
          differ += __float_as_int(b) != __float_as_int(best);
        }
      }
      const float dist = sqrtf(best);
      if (dist < MARCH_EPS) {
        if (escaped) {
          late = 1;  // a stop past the escape: the escape test was wrong
        } else {
          iters = step;
        }
        break;
      }
      px = px + dist * dx;
      py = py + dist * dy;
      pz = pz + dist * dz;
    }
  }
  out[i] = iters;
  if constexpr (COUNT) {
    const int64_t n64 = n;
    out_count[i] = cold.box;
    out_count[n64 + i] = cold.tri;
    out_count[2 * n64 + i] = warm.box;
    out_count[3 * n64 + i] = warm.tri;
    out_count[4 * n64 + i] = differ;
    out_count[5 * n64 + i] = late;
    out_count[6 * n64 + i] = walks;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() of the launch.  `p` is
// f32[3,N], `live` f32[N] (0/1), `out` f32[N]; with `out_count` non-null
// the counting instance, which also writes each point's box and triangle
// distances to out_count int32[2,N].
int rvpt_bigmesh_hart(const float* vtx, const float* nodes, int n_tri,
                      const float* p, const float* live, float* out,
                      int32_t* out_count, int n, void* stream) {
  if (n <= 0) return 0;
  if (n_tri <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + THREADS - 1) / THREADS;
  if (out_count) {
    bigmesh_hart_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        vtx, nodes, p, live, out, out_count, n);
  } else {
    bigmesh_hart_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        vtx, nodes, p, live, out, nullptr, n);
  }
  return (int)cudaGetLastError();
}

// The march on `stream`; returns cudaGetLastError() of the launch.  `o`
// and `d` are f32[3,N], `live` f32[N] (0/1) or null (every lane), `out`
// int32[N]; (cx, cy, cz) and r2 the escape ball (the caller's bound of the
// mesh); with `out_count` non-null the counting instance, which also
// writes int32[7,N] (cold box, cold triangle, warm box, warm triangle
// distances, steps whose minima differ, a stop after the escape, the
// march's walks).
int rvpt_bigmesh_march(const float* vtx, const float* nodes, int n_tri,
                       const float* o, const float* d, const float* live,
                       float mint, float cx, float cy, float cz, float r2,
                       int32_t* out, int32_t* out_count, int n, void* stream) {
  if (n <= 0) return 0;
  if (n_tri <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + THREADS - 1) / THREADS;
  const Escape esc{cx, cy, cz, r2};
  if (out_count) {
    march_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        vtx, nodes, o, d, live, mint, esc, out, out_count, n);
  } else {
    march_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        vtx, nodes, o, d, live, mint, esc, out, nullptr, n);
  }
  return (int)cudaGetLastError();
}

const char* rvpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
