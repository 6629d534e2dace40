// Big-mesh bounce kernel for Hopper (sm_90a): one Kajiya bounce of a BVH
// mesh of more than 1,024 triangles, one thread per ray, one launch per
// bounce; or, search-only, the closest hit of each ray.
//
// Replaces the Pallas kernels B5a (make_bigmesh_dma_kernel :2366, launched
// by _bigmesh_dma_call :2605) and B5b (make_bigmesh_kernel :2061, launched
// by _bigmesh_call :2179; the same function on a (tiles, chunks) grid) of
// rvpt_tpu/ops/pathkernel.py.  Per ray: the seed search over spheres and
// planes, then the triangles by the BVH walk (bvh_search.cuh, the port of
// the cluster-culled _culled_tris_rows :472), then the Kajiya bounce of
// _shade (:925) through the whole-path kernel's own shading code
// (kajiya_shade.cuh).  A dead lane passes its state through exactly
// (:2593-2597); is_last is always false (the standard-style tail runs after
// the loop, as :3097-3101 does).  The search-only instance (search_tiles
// :3122) writes the winner: f32[5,N] (t, normal xyz, material id) and
// int32[2,N] (family, index); a lane not live does no search and gets the
// miss winner.  Its caller runs the debug finalize and the Whitted and Cook
// shading between launches as plain PyTorch (:3143-3235).  The collect
// instance (make_bigmesh_dma_kernel(collect=True), outputs :2418 and
// :2568-2600) is the bounce instance that also writes the bounce's hit
// record int32[2,N]: (family, index) of the winner, -1 on a lane that was
// dead or missed; the mesh gradient's SoA replay reads it.  A fourth
// instance, search-only with the walk's counting (bvh_search.cuh COUNT),
// also writes each ray's node and triangle tests and walk iterations as
// int32[3,N]; it serves the bounds of chip_smoke.py and its census of the
// walk, and no display path.
//
// No display frame, training step or recover launches this kernel any more:
// K1's and B3's BVH forms (path_kernel.cu, primary_kernel.cu) serve the big
// meshes with rays passed in, one launch per frame, and K1's hits-only
// collect instance writes the gradient's hit records in one launch.  The
// kernel stays as the per-bounce route BigMeshTracer.bounce and .search
// expose and chip_smoke.py checks, and for its counting instance, which
// every BVH-form bound counts the walk with.  Its binary walk
// (bvh_search.cuh) is the reference that K1's and B3's redesigned walk
// (bvh_walk.cuh) is held against, bit for bit, through this route.
//
// The TPU mechanism is not carried over: no chunk DMAs or SMEM clusters, no
// per-tile chunk work lists (_bigmesh_chunk_worklist :2734), no wavefront
// sort (_bigmesh_sort_key :2706).  None of them changes a ray's result (a
// cull never changes the winner, :2940-2943), so the per-ray walk gives the
// same winners.
//
// State: the f32[16,N] carries of pathkernel.STATE_FIELDS (the ray, the
// throughput, the gathered color, the radiance, active as 0/1), read and
// written SoA, so a warp's loads and stores are coalesced; the search-only
// instance reads the ray and its live flag from f32[7,N].  The spheres,
// planes and materials are staged in shared memory; the triangles (pack_fwd
// rows in leaf order) and the tree (pack_bvh) are read from device memory.
//
// What bounds it on this card: the walk.  Each live ray tests the boxes and
// triangles along its own path through the tree, loading 32-byte nodes and
// 68-byte triangle rows (mostly from L2: the 20,482-triangle mesh's rows
// and nodes are 2.7 MB); the state traffic is 128 bytes per ray in and
// out.  Warps diverge where their rays' walks part.
//
// Rounding: every expression keeps the operation order of the plain version
// (rvpt_tpu_torch/ops/pathkernel.py bigmesh_bounce_plain and
// bigmesh_search_plain).  Build with --fmad=false and without fast math.

#include <cstdint>
#include <cuda_runtime.h>

#include "bvh_search.cuh"
#include "kajiya_shade.cuh"
#include "scene_search.cuh"

namespace {

using namespace scene;

constexpr int THREADS = 256;
constexpr int N_STATE = 16;  // pathkernel.STATE_FIELDS

template <bool SEARCH_ONLY, bool COUNT, bool COLLECT>
__global__ void __launch_bounds__(THREADS) bigmesh_kernel(
    const float* __restrict__ tables, int n_tri, int n_sph, int n_pln,
    int n_mat, const float* __restrict__ nodes,
    const int64_t* __restrict__ pix_ids, const float* __restrict__ state,
    int live_row, float* __restrict__ out_state, float* __restrict__ out_w,
    int32_t* __restrict__ out_i, int32_t* __restrict__ out_count,
    int32_t* __restrict__ out_hits, int n, uint32_t frame, uint32_t salt,
    float mint) {
  extern __shared__ float smem[];
  const Tables s = stage(smem, nullptr, tables + TRI_STRIDE * n_tri, 0, n_sph,
                         n_pln, n_mat);
  const bvh::Mesh mesh{tables, nodes, n_tri};
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  auto row = [&](int r) { return state[(int64_t)r * n + i]; };
  float ox = row(0), oy = row(1), oz = row(2);
  float dx = row(3), dy = row(4), dz = row(5);
  const bool active = row(live_row) > 0.0f;

  if (SEARCH_ONLY) {
    bvh::WalkCount c;
    const Hit h = active ? bvh::closest_hit_mesh<COUNT>(s, mesh, ox, oy, oz,
                                                        dx, dy, dz, mint, &c)
                         : miss();
    if constexpr (COUNT) {
      out_count[i] = c.box;
      out_count[(int64_t)n + i] = c.tri;
      out_count[2 * (int64_t)n + i] = c.iter;
    }
    out_w[i] = h.t;
    out_w[(int64_t)n + i] = h.nx;
    out_w[2 * (int64_t)n + i] = h.ny;
    out_w[3 * (int64_t)n + i] = h.nz;
    out_w[4 * (int64_t)n + i] = h.mat;
    out_i[i] = h.fam;
    out_i[(int64_t)n + i] = h.idx;
    return;
  }

  auto put = [&](int r, float v) { out_state[(int64_t)r * n + i] = v; };
  if (!active) {  // a dead lane passes through
    for (int r = 0; r < N_STATE; ++r) put(r, row(r));
    if (COLLECT) {
      out_hits[i] = -1;
      out_hits[(int64_t)n + i] = -1;
    }
    return;
  }
  float tr = row(6), tg = row(7), tb = row(8);
  float cr = row(9), cg = row(10), cb = row(11);
  float rr = row(12), rg = row(13), rb = row(14);
  bool alive = true;
  const Hit h = bvh::closest_hit_mesh(s, mesh, ox, oy, oz, dx, dy, dz, mint);
  if (COLLECT) {  // a miss is -1 already
    out_hits[i] = h.fam;
    out_hits[(int64_t)n + i] = h.fam < 0 ? -1 : h.idx;
  }
  if (h.fam < 0) {  // the sky, with d.y shifted into [0,1], and the end
    const float st = dy * 0.5f + 0.5f;
    rr = rr + cr + tr * (1.0f + SKY_R * st);
    rg = rg + cg + tg * (1.0f + SKY_G * st);
    rb = rb + cb + tb * (1.0f + SKY_B * st);
    alive = false;
  } else {
    const float* M = material(s, h.mat);
    cr = cr + tr * M[3];
    cg = cg + tg * M[4];
    cb = cb + tb * M[5];
    const uint32_t pix = (uint32_t)pix_ids[i];
    shade::scatter(shade::hit_frame(h, ox, oy, oz, dx, dy, dz), M, pix, frame,
                   salt, ox, oy, oz, dx, dy, dz);
    tr = tr * M[0];
    tg = tg * M[1];
    tb = tb * M[2];
  }
  const float v[N_STATE] = {ox, oy, oz, dx, dy, dz, tr, tg, tb, cr, cg, cb,
                            rr, rg, rb, alive ? 1.0f : 0.0f};
  for (int r = 0; r < N_STATE; ++r) put(r, v[r]);
}

template <bool SEARCH_ONLY, bool COUNT, bool COLLECT>
int launch(const float* tables, int n_tri, int n_sph, int n_pln, int n_mat,
           const float* nodes, const int64_t* pix_ids, const float* state,
           int live_row, float* out_state, float* out_w, int32_t* out_i,
           int32_t* out_count, int32_t* out_hits, int n, uint32_t frame,
           uint32_t salt, float mint, void* stream) {
  const size_t smem = sizeof(float) * staged_floats(0, n_sph, n_pln, n_mat);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bigmesh_kernel<SEARCH_ONLY, COUNT, COLLECT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n + THREADS - 1) / THREADS;
  bigmesh_kernel<SEARCH_ONLY, COUNT, COLLECT>
      <<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
          tables, n_tri, n_sph, n_pln, n_mat, nodes, pix_ids, state, live_row,
          out_state, out_w, out_i, out_count, out_hits, n, frame, salt, mint);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rvpt_max_table_floats() { return max_table_floats(); }

// Launch on `stream`; returns cudaGetLastError() of the launch.  With
// out_state non-null: one bounce of `state` f32[16,N] (live row 15), and
// with out_hits non-null the collect instance, which also writes the hit
// record to out_hits int32[2,N]; else the search-only instance on `state`
// f32[7,N] (live row 6), writing out_w and out_i, and with out_count
// non-null its counting instance, which also writes each ray's node and
// triangle tests and walk iterations to out_count int32[3,N].
int rvpt_bigmesh(const float* tables, int n_tri, int n_sph, int n_pln,
                 int n_mat, const float* nodes, const int64_t* pix_ids,
                 const float* state, int live_row, float* out_state,
                 float* out_w, int32_t* out_i, int32_t* out_count,
                 int32_t* out_hits, int n, uint32_t frame, uint32_t salt,
                 float mint, void* stream) {
  if (n <= 0) return 0;
#define RVPT_LAUNCH(S, C, R)                                                  \
  launch<S, C, R>(tables, n_tri, n_sph, n_pln, n_mat, nodes, pix_ids, state, \
                  live_row, out_state, out_w, out_i, out_count, out_hits, n, \
                  frame, salt, mint, stream)
  if (out_state) {
    return out_hits ? RVPT_LAUNCH(false, false, true)
                    : RVPT_LAUNCH(false, false, false);
  }
  return out_count ? RVPT_LAUNCH(true, true, false)
                   : RVPT_LAUNCH(true, false, false);
#undef RVPT_LAUNCH
}

const char* rvpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
