// Big-mesh Hart distance kernel for Hopper (sm_90a): one step of the Hart
// march on a BVH mesh of more than 1,024 triangles, one thread per point,
// one launch per march step (32 per Hart frame).
//
// Replaces the Pallas kernel B6 of rvpt_tpu/ops/pathkernel.py
// (make_bigmesh_hart_kernel :2820, launched by _bigmesh_hart_call :2900):
// for each live point, sqrt of the minimum over all triangles of the iq
// unsigned squared distance (tri_dist.cuh, shared with the Hart march
// kernel B4), from 3e38 down.  The TPU kernel streams triangle chunks and
// skips a cluster whose box distance is at least the running minimum; here
// the thread walks the tree (pack_bvh's nodes, boxes padded by pack_cull's
// eps) for its own point, nearer child first, and skips a node whose box
// squared distance is at least the running minimum.  That skip is exact
// (:2824-2829): a box's distance bounds below the distance of every
// triangle in it, and the minimum does not depend on the order of the
// triangles.  A dead lane writes +inf and does no work (the JAX kernel
// leaves whatever its tile held there).  The 32-step march itself stays in
// PyTorch (BigMeshTracer.trace_hart, as trace_hart :3237).  A counting
// instance (COUNT) walks the same way and also writes each point's box and
// triangle distances as int32[2,N], for the bounds of chip_smoke.py.
//
// What bounds it on this card: the walk, about 100 operations per
// triangle distance plus the box distances, with nodes and raw vertex rows
// (pack_hart, leaf order) read from device memory along each point's walk.
//
// Rounding: the operation order of the plain version
// (rvpt_tpu_torch/ops/pathkernel.py bigmesh_distance_plain and _tri_dist2).
// Build with --fmad=false and without fast math.

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

// Squared distance from p to a padded node box (0 inside it).
__device__ __forceinline__ float box_dist2(const Node& b, float px, float py,
                                           float pz) {
  const float ex = fmaxf(fmaxf(b.lx - px, px - b.hx), 0.0f);
  const float ey = fmaxf(fmaxf(b.ly - py, py - b.hy), 0.0f);
  const float ez = fmaxf(fmaxf(b.lz - pz, pz - b.hz), 0.0f);
  return ex * ex + ey * ey + ez * ez;
}

template <bool COUNT>
__global__ void __launch_bounds__(THREADS) bigmesh_hart_kernel(
    const float* __restrict__ vtx, const float* __restrict__ nodes,
    const float* __restrict__ p, const float* __restrict__ live,
    float* __restrict__ out, int32_t* __restrict__ out_count, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bvh::WalkCount c;
  if (!(live[i] > 0.0f)) {
    out[i] = INFINITY;
    if constexpr (COUNT) {
      out_count[i] = 0;
      out_count[(int64_t)n + i] = 0;
    }
    return;
  }
  const float px = p[i], py = p[(int64_t)n + i], pz = p[2 * (int64_t)n + i];
  float best = BIG;
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
        best = fminf(best, tri_dist::tri_dist2(px, py, pz, v));
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
  out[i] = sqrtf(best);
  if constexpr (COUNT) {
    out_count[i] = c.box;
    out_count[(int64_t)n + i] = c.tri;
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

const char* rvpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
