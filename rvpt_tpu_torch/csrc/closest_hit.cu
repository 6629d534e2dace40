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
// (rvpt_tpu_torch/ops/intersect_pk.py FIELDS).  A block stages them into
// shared memory CHUNK rows at a time (32 KB), where every lane of a warp
// reads the same word (a broadcast), so any triangle count runs.
//
// What bounds it on this card: arithmetic.  Per ray-triangle pair it does
// 18 multiplies and 12 adds for the six dot products, one divide, and 14
// more operations for the barycentrics and tests; per ray it reads 24 bytes
// and writes 12.  At the Cornell box (12 triangles) the bytes dominate.
//
// Rounding: every expression keeps the operation order of the plain
// version (rvpt_tpu_torch/ops/intersect.py closest_hit_triangles).  Build
// with --fmad=false and IEEE division.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int FIELDS = 16;
constexpr int CHUNK = 512;
constexpr int THREADS = 256;
constexpr float DENOM_EPS = 1e-30f;

__global__ void __launch_bounds__(THREADS) closest_hit_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ tri, int n_tri, int n, float mint, float maxt,
    float* __restrict__ t_out, int64_t* __restrict__ i_out) {
  __shared__ float tab[CHUNK * FIELDS];
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
  float t_best = __int_as_float(0x7f800000);  // +inf
  int64_t best = -1;
  for (int base = 0; base < n_tri; base += CHUNK) {
    const int cnt = min(CHUNK, n_tri - base);
    __syncthreads();  // the previous chunk is done with the table
    for (int k = threadIdx.x; k < cnt * FIELDS; k += blockDim.x) {
      tab[k] = tri[(int64_t)base * FIELDS + k];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      const float* T = tab + FIELDS * j;
      const float nx = T[0], ny = T[1], nz = T[2];
      const float dn = nx * dx + ny * dy + nz * dz;
      const float on = nx * ox + ny * oy + nz * oz;
      const float de0 = T[3] * dx + T[4] * dy + T[5] * dz;
      const float de1 = T[6] * dx + T[7] * dy + T[8] * dz;
      const float oe0 = T[3] * ox + T[4] * oy + T[5] * oz;
      const float oe1 = T[6] * ox + T[7] * oy + T[8] * oz;
      const float den = fabsf(dn) < DENOM_EPS ? DENOM_EPS : dn;
      const float t = (T[9] - on) / den;
      const float b0 = oe0 + t * de0 - T[10];
      const float b1 = oe1 + t * de1 - T[11];
      const float u = T[15] * (T[13] * b0 - T[14] * b1);
      const float v = T[15] * (T[12] * b1 - T[14] * b0);
      if (mint < t && t < maxt && u > 0.0f && v > 0.0f && u + v < 1.0f &&
          t < t_best) {
        t_best = t;
        best = base + j;
      }
    }
  }
  if (live) {
    t_out[i] = t_best;
    i_out[i] = best;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() of the launch.
int rvpt_closest_hit(const float* origin, const float* direction,
                     const float* tri, int n_tri, int n, float mint,
                     float maxt, float* t_out, int64_t* i_out, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  closest_hit_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      origin, direction, tri, n_tri, n, mint, maxt, t_out, i_out);
  return (int)cudaGetLastError();
}

const char* rvpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
