// Triangle-table lookups of the SoA replay for Hopper (sm_90a): a
// multi-column gather and its transpose, a segment sum, for any row count.
//
// Replaces the four Pallas kernels of rvpt_tpu/ops/replay_soa.py that serve
// _lookup_group on tables of more than _LOOKUP_UNROLL (64) rows:
//
// - gather (B7a _gather_mm :309 and B7c _gather_mm_big :105, with the
//   chunking of _gather_mm_huge :359): out[c][i] = tables[c][idx[i]] for C
//   columns of T rows;
// - segsum (B7b _segsum_mm :244 and B7d _segsum_mm_big :170, with the
//   chunking of _segsum_mm_huge :381): grad[c][t] = sum of g[c][i] over the
//   rays i with idx[i] = t.
//
// The TPU computes both as one-hot matrix products on its matrix unit, in
// three tiers (<= 4,096 rows, <= 131,072 rows with per-block range
// skipping, more in VMEM-sized chunks), because a gather or scatter fused
// into a loop serialises there.  None of that is carried over: here one
// thread per ray reads its row of each column (gather) or adds its
// cotangent into it (segsum), the same code for every T.  Offsets into the
// [C, N] and [C, T] arrays are 64-bit.
//
// What bounds them on this card: bytes.  The gather reads 4 bytes of index
// and writes 4C bytes per ray; its reads of the tables (4C bytes per row,
// 800 KB at 20,482 rows) come mostly from L2.  The segment sum reads the
// index and 4C bytes of cotangent per ray and writes the [C, T] result
// (with its float64 scratch, 20 bytes per entry: zeroed, summed into, read
// back).
//
// Hot rows: neighbouring rays hit the same triangles (BVH leaf order and
// pixel-coherent rays), and atomics on one address serialise.  A warp
// first groups its lanes by row (__match_any_sync); the lowest lane of each
// group sums the group's values in lane order and issues one atomicAdd per
// column, none where that sum is zero.  That matters in the replay: the
// lanes that did not hit a triangle read row 0 (the index is clipped) with
// a cotangent of exactly zero, and adding zero changes no sum.
//
// Precision and order: the sums run in float64, into a [C, T] scratch that
// a second launch rounds to the f32 result, as the plain version
// (index_add_ in float64) does.  An f32 sum of the ~200 cotangents each
// row of a 1,282-row table gets from 256K random ids was 1.7e-5 off the
// float64 sum in units of their scale on an H100; in float64 the atomics'
// order changes the sum by about 1e-16 of it, below the final rounding,
// so a result is reproducible from call to call but for a value that
// lands within that distance of an f32 rounding boundary.  The gather is
// exact.
//
// An index outside [0, T) (the caller clips them) gathers 0 and adds
// nothing; n = 0 launches nothing (the JAX side's idx[-1] padding is not
// needed: there is no padding).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS) gather_kernel(
    const float* __restrict__ tables, int n_col, int t_rows,
    const int32_t* __restrict__ idx, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = idx[i];
  const bool ok = k >= 0 && k < t_rows;
  for (int c = 0; c < n_col; ++c) {
    out[(int64_t)c * n + i] = ok ? tables[(int64_t)c * t_rows + k] : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS) segsum_kernel(
    const int32_t* __restrict__ idx, const float* __restrict__ g, int n_col,
    int n, int t_rows, double* __restrict__ acc) {
  __shared__ float vals[WARPS][32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool valid = i < n;
  int key = valid ? idx[i] : -1;
  if (key >= t_rows) key = -1;
  // Every lane of the warp takes part (the tail lanes with key -1), so the
  // full mask is right for the match.
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const bool leader = key >= 0 && (__ffs(peers) - 1) == lane;
  for (int c = 0; c < n_col; ++c) {
    vals[warp][lane] = key >= 0 ? g[(int64_t)c * n + i] : 0.0f;
    __syncwarp();
    if (leader) {
      double s = 0.0;
      for (unsigned m = peers; m; m &= m - 1) s += vals[warp][__ffs(m) - 1];
      if (s != 0.0) atomicAdd(&acc[(int64_t)c * t_rows + key], s);
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(THREADS) round_kernel(
    const double* __restrict__ acc, float* __restrict__ out, int64_t size) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < size) out[i] = (float)acc[i];
}

int blocks_for(int64_t n) { return (int)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// out f32[C, n] = tables f32[C, T] at idx int32[n], on `stream`; returns
// cudaGetLastError() of the launch.
int rvpt_gather(const float* tables, int n_col, int t_rows,
                const int32_t* idx, float* out, int n, void* stream) {
  if (n <= 0 || n_col <= 0) return 0;
  gather_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      tables, n_col, t_rows, idx, out, n);
  return (int)cudaGetLastError();
}

// out f32[C, T] = the segment sum of g f32[C, n] by idx int32[n], on
// `stream`, through the caller's float64 scratch acc[C, T]: zeroes acc,
// sums into it, rounds it into out; returns the first CUDA error.
int rvpt_segsum(const int32_t* idx, const float* g, int n_col, int n,
                int t_rows, double* acc, float* out, void* stream) {
  if (n_col <= 0 || t_rows <= 0) return 0;
  const int64_t size = (int64_t)n_col * t_rows;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(acc, 0, sizeof(double) * (size_t)size, s);
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    segsum_kernel<<<blocks_for(n), THREADS, 0, s>>>(idx, g, n_col, n, t_rows,
                                                     acc);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  round_kernel<<<blocks_for(size), THREADS, 0, s>>>(acc, out, size);
  return (int)cudaGetLastError();
}

const char* rvpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
