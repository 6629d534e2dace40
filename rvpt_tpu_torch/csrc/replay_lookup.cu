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
// pixel-coherent rays), and atomics on one address serialise.  How the
// rows fall (chip_smoke.py phase 17 counts them): on pixel-coherent ids
// into 140,000 rows a warp holds about 31 distinct rows of 32, so
// grouping within a warp saves almost no atomic, while a chunk of 2,048
// rays holds about 640 over a span of about 720 and one of 8,192 about
// 1,070 over 1,140; on a mesh replay's bounce ids the spans reach the
// whole 20,482-row table (no window of rows fits) while whole warps sit
// on one row (the miss lanes, clipped to row 0); in a mesh step most
// warps carry only zero cotangents.  So the segment sum aggregates rows
// across a whole block before it touches device memory: a block takes
// SEG_RAYS consecutive rays and sums them into a hash table in shared
// memory, `slots` rows of C float64 sums each, keyed by the row (seg_slots:
// the largest power of two up to SEG_SLOTS that fits SEG_SMEM; 0 when not
// one row fits, and then every row adds straight into device memory).  A
// sweep on an H100 of 1,024-8,192 rays per block and 512-2,048 rows picked
// 4,096 x 1,024, two blocks per SM.  The slot is k * 2654435761 mod slots,
// a bijection on the low bits, so rows within any window of `slots`
// consecutive ids never collide; other rows probe the next slots, and a
// row that finds no free slot in PROBES adds straight into device memory.  Then the block
// adds each occupied slot's non-zero sums into the float64 scratch: one
// global atomic per (row, column) the block touched.  Within a warp the
// lanes that add something are grouped by row (__match_any_sync) and each
// group sums in a shuffle tree (warp_sum.cuh, log2 of its size rounds),
// so one lane per group and column touches the table: a whole warp on one
// row is one shared atomic, not 32.  A warp whose rays all carry zero
// cotangents (the lanes that hit no triangle carry an exact zero) does
// nothing but read them.  Each ray's C cotangents are read into registers
// once.
//
// Precision and order: the sums run in float64, into a [C, T] scratch that
// a second launch rounds to the f32 result, as the plain version
// (index_add_ in float64) does.  An f32 sum of the ~200 cotangents each
// row of a 1,282-row table gets from 256K random ids was 1.7e-5 off the
// float64 sum in units of their scale on an H100; in float64 the order of
// the atomics (shared and global) changes the sum by about 1e-16 of it,
// below the final rounding, so a result is reproducible from call to call
// but for a value that lands within that distance of an f32 rounding
// boundary.  The gather is exact.
//
// An index outside [0, T) (the caller clips them) gathers 0 and adds
// nothing; n = 0 launches no segment-sum kernel (the JAX side's idx[-1]
// padding is not needed: there is no padding).

#include <cstdint>
#include <cuda_runtime.h>

#include "warp_sum.cuh"

namespace {

constexpr int THREADS = 256;

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

constexpr int SEG_THREADS = 512;
constexpr int SEG_RAYS = 4096;     // rays per block
constexpr int SEG_SLOTS = 1024;    // the most rows of a block's table
constexpr int SEG_SMEM = 113 * 1024;  // its bytes: two blocks per SM
constexpr int MAXC = 16;   // columns held in registers per pass
constexpr int PROBES = 8;  // hash slots tried before a row goes to memory
using warp_sum::FULL;

// Add the cotangents v[0..nc) of row k (columns c0..c0+nc) into the
// block's table, or into acc where the row finds no slot.
__device__ __forceinline__ void add_row(int k, const double* v, int nc, int c0,
                                        int slots, int* keys, double* vals,
                                        double* acc, int t_rows) {
  int s = -1;
  unsigned h = (unsigned)k * 2654435761u;
  for (int p = 0; p < PROBES && slots > 0; ++p, ++h) {
    const int at = (int)(h & (unsigned)(slots - 1));
    const int old = atomicCAS(&keys[at], -1, k);
    if (old == -1 || old == k) {
      s = at;
      break;
    }
  }
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < nc && v[c] != 0.0) {
      if (s >= 0) {
        atomicAdd(&vals[(int64_t)(c0 + c) * slots + s], v[c]);
      } else {
        atomicAdd(&acc[(int64_t)(c0 + c) * t_rows + k], v[c]);
      }
    }
  }
}

__global__ void __launch_bounds__(SEG_THREADS) segsum_kernel(
    const int32_t* __restrict__ idx, const float* __restrict__ g, int n_col,
    int n, int t_rows, int slots, double* __restrict__ acc) {
  extern __shared__ double smem[];
  double* vals = smem;  // [C, slots]
  int* keys = reinterpret_cast<int*>(vals + (int64_t)n_col * slots);
  for (int64_t j = threadIdx.x; j < (int64_t)n_col * slots; j += blockDim.x) {
    vals[j] = 0.0;
  }
  for (int j = threadIdx.x; j < slots; j += blockDim.x) keys[j] = -1;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * SEG_RAYS;
  const int64_t left = (int64_t)n - base;
  const int count = left < SEG_RAYS ? (int)left : SEG_RAYS;
  const int lane = threadIdx.x & 31;
  // Every thread runs the same number of rounds, so each warp stays whole
  // for its votes and shuffles (the tail lanes hold row -1).
  for (int r0 = 0; r0 < count; r0 += blockDim.x) {
    const int r = r0 + threadIdx.x;
    const int64_t i = base + r;
    int k = r < count ? idx[i] : -1;
    if (k >= t_rows || k < 0) k = -1;
    for (int c0 = 0; c0 < n_col; c0 += MAXC) {
      const int nc = min(MAXC, n_col - c0);
      double v[MAXC];
      bool any = false;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        v[c] = (c < nc && k >= 0) ? (double)g[(int64_t)(c0 + c) * n + i] : 0.0;
        any = any || v[c] != 0.0;
      }
      if (!__any_sync(FULL, any)) continue;  // the whole warp adds nothing
      // Group the lanes that add something by row; one lane per group
      // adds the group's sums.
      const int key = any ? k : -1;
      const unsigned peers = __match_any_sync(FULL, key);
      warp_sum::reduce_peers<MAXC>(peers, v, nc, lane);
      if (key >= 0 && __ffs(peers) - 1 == lane) {
        add_row(key, v, nc, c0, slots, keys, vals, acc, t_rows);
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < slots; j += blockDim.x) {
    const int k = keys[j];
    if (k < 0) continue;
    for (int c = 0; c < n_col; ++c) {
      const double s = vals[(int64_t)c * slots + j];
      if (s != 0.0) atomicAdd(&acc[(int64_t)c * t_rows + k], s);
    }
  }
}

__global__ void __launch_bounds__(THREADS) round_kernel(
    const double* __restrict__ acc, float* __restrict__ out, int64_t size) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < size) out[i] = (float)acc[i];
}

int blocks_for(int64_t n) { return (int)((n + THREADS - 1) / THREADS); }

// Rows of the segment sum's table for n_col columns: the largest power of
// two up to SEG_SLOTS whose float64 sums and int32 key fit SEG_SMEM, or 0.
int seg_slots(int n_col) {
  const int64_t fit = SEG_SMEM / ((int64_t)sizeof(double) * n_col + 4);
  int slots = 0;
  for (int s = 1; s <= SEG_SLOTS && s <= fit; s *= 2) slots = s;
  return slots;
}

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
  const int slots = seg_slots(n_col);
  const size_t smem = (size_t)slots * (sizeof(double) * n_col + sizeof(int));
  const int64_t size = (int64_t)n_col * t_rows;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(acc, 0, sizeof(double) * (size_t)size, s);
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    e = cudaFuncSetAttribute(segsum_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (int)(((int64_t)n + SEG_RAYS - 1) / SEG_RAYS);
    segsum_kernel<<<blocks, SEG_THREADS, smem, s>>>(idx, g, n_col, n, t_rows,
                                                    slots, acc);
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
