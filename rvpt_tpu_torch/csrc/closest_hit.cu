// Brute-force closest triangle hit for Hopper (sm_90a): one thread per ray,
// looping over every triangle.
//
// Replaces the Pallas kernel B8 of rvpt_tpu/ops/intersect_pk.py
// (closest_hit_pallas :174 -> _closest_hit_padded :150, body _kernel :89):
// for each ray the smallest t over all triangles with mint < t < maxt and
// a hit inside the triangle, by the metric-tensor test of
// intersect_pk.py:113-139, and the index of the first triangle that
// reaches it; t = +inf and index -1 on a miss.  The TPU layout is not
// carried over: no [BT, BR] pairwise tiles, no per-chunk min + first-index
// select; a candidate replaces the winner only on a strictly smaller t,
// which keeps the first minimum exactly as that select does.
//
// Triangles arrive as [T, 16] f32 rows of precomputed fields
// (rvpt_tpu_torch/ops/intersect_pk.py FIELDS), 64 bytes each.  A block
// loads them with 16-byte loads, one row per thread at a time, and stores
// each row in shared memory as four aligned float4 in pack_walk's order
// (WALK_FIELDS: nx ny nz v0n | e0 v0e0 | e1 v0e1 | g00 g11 g01 inv_det),
// so a test reads them as four 128-bit broadcasts (every lane of a warp
// reads the same row) where the parent issued 16 scalar loads.  A table of
// at most CHUNK rows is staged once behind one barrier; a larger one in
// CHUNK-row chunks (32 KB), each behind two.  The test is the row search's
// (scene_search.cuh test_tri_row) against the running limit `lim`: maxt
// until the first hit, then the winner's t, since a triangle replaces the
// winner only with mint < t < maxt and t below the winner's.  With the
// t-first reject a test loads the first float4, computes t and stops where
// !(mint < t && t < lim), exactly the cases in which the full test changes
// nothing, before it loads the rest and computes the barycentrics.  On
// the 1080p Cornell camera rays 49% of the warp-tests stop there, on
// soups 29%; the reject ran 7-14% faster than the same kernel without it
// on every input timed (kernel_ab.py, NVIDIA H100 80GB HBM3 at 700 W).
//
// What bounds it on this card: the issue of its instructions.  Per
// ray-triangle pair it does 18 multiplies and 12 adds for the six dot
// products, one IEEE divide (MUFU.RCP, a refinement, FCHK and a slow-path
// call), and 14 more operations for the barycentrics and tests; per ray
// it reads 24 bytes and writes 12.  At the Cornell box (12 triangles) the
// byte bound is the larger, but the kernel runs at about one warp
// instruction per clock per scheduler, so instructions per test set its
// time.
//
// Rounding: every expression keeps the operation order of the plain
// version (rvpt_tpu_torch/ops/intersect.py closest_hit_triangles), so t
// and the index are bit for bit the parent kernel's.  Build with
// --fmad=false and IEEE division.

#include <cstdint>
#include <cuda_runtime.h>

#include "scene_search.cuh"

namespace {

constexpr int CHUNK = 512;
constexpr int THREADS = 256;

// Rows [base, base + cnt) of `tri` into `tab`, four float4 each in
// WALK_FIELDS order: column 9 (v0n) after the normal, 10 (v0e0) after e0,
// 11 (v0e1) after e1.
__device__ __forceinline__ void stage_rows(const float4* __restrict__ tri,
                                           int base, int cnt, float4* tab) {
  for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
    const float4* r = tri + (int64_t)(base + j) * 4;
    const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2),
                 g = __ldg(r + 3);
    // a: nx ny nz e0x | b: e0y e0z e1x e1y | c: e1z v0n v0e0 v0e1
    tab[4 * j] = make_float4(a.x, a.y, a.z, c.y);
    tab[4 * j + 1] = make_float4(a.w, b.x, b.y, c.z);
    tab[4 * j + 2] = make_float4(b.z, b.w, c.x, c.w);
    tab[4 * j + 3] = g;
  }
}

__global__ void __launch_bounds__(THREADS) closest_hit_kernel(
    const float4* __restrict__ tri, int n_tri, const float* __restrict__ origin,
    const float* __restrict__ direction, int n, float mint, float maxt,
    float* __restrict__ t_out, int64_t* __restrict__ i_out) {
  extern __shared__ float4 tab[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (live) {
    ox = origin[3 * (int64_t)i];
    oy = origin[3 * (int64_t)i + 1];
    oz = origin[3 * (int64_t)i + 2];
    dx = direction[3 * (int64_t)i];
    dy = direction[3 * (int64_t)i + 1];
    dz = direction[3 * (int64_t)i + 2];
  }
  float lim = maxt;  // maxt, then the winner's t
  int best = -1;
  for (int base = 0; base < n_tri; base += CHUNK) {
    const int cnt = min(CHUNK, n_tri - base);
    if (base > 0) __syncthreads();  // the previous chunk is done with tab
    stage_rows(tri, base, cnt, tab);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      float t;
      float4 a;
      if (scene::test_tri_row<true>(tab + 4 * j, ox, oy, oz, dx, dy, dz,
                                    mint, lim, t, a)) {
        lim = t;
        best = base + j;
      }
    }
  }
  if (live) {
    t_out[i] = best >= 0 ? lim : __int_as_float(0x7f800000);  // +inf
    i_out[i] = best;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() of the launch.  `tri` is
// 16-byte aligned (the wrapper checks).
int rvpt_closest_hit(const float* origin, const float* direction,
                     const float* tri, int n_tri, int n, float mint,
                     float maxt, float* t_out, int64_t* i_out, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  const int rows = n_tri < 1 ? 1 : n_tri < CHUNK ? n_tri : CHUNK;
  const size_t smem = sizeof(float4) * 4 * (size_t)rows;
  closest_hit_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(tri), n_tri, origin, direction, n, mint,
      maxt, t_out, i_out);
  return (int)cudaGetLastError();
}

const char* rvpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
