// Hart sphere-trace kernel for Hopper (sm_90a): the march-iteration heat
// map of integrator mode 10, one thread per pixel, one launch per frame and
// AA sample.
//
// Replaces the Pallas kernel B4 of rvpt_tpu/ops/pathkernel.py
// (make_hart_kernel :3564, launched by _hart_call :3632; pack_hart :3498,
// _tri_dist2 :3518): an in-kernel camera ray (scene_search.cuh), then
// MARCH_ITER = 32 steps, each the minimum over all triangles of the iq
// unsigned squared distance from 3e38 down, its square root, a stop below
// MARCH_EPS = 0.1 (maxt = inf, :3615) and otherwise an advance by that
// distance.  The output is the step of the stop times 1/31 on all three
// channels, 32/31 where the march never stopped, which is every pixel of a
// scene without triangles (the JAX kernel pads such a scene with 1e15
// rows; here the minimum stays 3e38 and the launch takes T = 0).  The TPU
// layout is not carried over: no SMEM scalar tables or [8,1024] tiles, no
// statically unrolled march.
//
// Triangles arrive as [T, 9] raw vertex rows (pathkernel.HART_FIELDS).  A
// block stages them into shared memory CHUNK rows at a time (18 KB), as
// the closest-hit kernel B8 does, so any count runs; a scene that fits one
// chunk is staged once for all 32 steps.  A thread whose march stopped
// does no more distance work; the block leaves the loop once all its
// threads have stopped.
//
// What bounds it on this card: arithmetic, about 100 operations per live
// ray-step-triangle (three edge signs, three clamped edge distances, the
// face distance); per pixel it writes f32[3] and reads an int64 id when
// given.
//
// Rounding: every expression keeps the operation order of the plain
// version (rvpt_tpu_torch/ops/pathkernel.py hart_plain and _tri_dist2).
// Build with --fmad=false and without fast math.

#include <cstdint>
#include <cuda_runtime.h>

#include "scene_search.cuh"
#include "tri_dist.cuh"

namespace {

using namespace scene;
using tri_dist::tri_dist2;

constexpr int THREADS = 256;
constexpr int HART_STRIDE = 9;  // HART_FIELDS
constexpr int CHUNK = 512;
constexpr int MARCH_ITER = 32;
constexpr float MARCH_EPS = 0.1f;
constexpr float INV_LAST = (float)(1.0 / (MARCH_ITER - 1));

__global__ void __launch_bounds__(THREADS) hart_kernel(
    const float* __restrict__ vtx, int n_tri, const float* __restrict__ cam_in,
    const int64_t* __restrict__ pix_ids, float* __restrict__ out, int n,
    uint32_t frame, uint32_t jitter_salt, int cam_mode, float mint) {
  __shared__ float cam[CAM_LEN];
  __shared__ float tab[CHUNK * HART_STRIDE];
  for (int k = threadIdx.x; k < CAM_LEN; k += blockDim.x) cam[k] = cam_in[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (live) {
    const uint32_t pix = pix_ids ? (uint32_t)pix_ids[i] : (uint32_t)i;
    camera_ray(cam, cam_mode, pix, frame, jitter_salt, ox, oy, oz, dx, dy, dz);
  }
  float px = ox + mint * dx, py = oy + mint * dy, pz = oz + mint * dz;
  int iters = MARCH_ITER;
  bool done = !live;  // a padding thread never marches
  const int n_chunks = (n_tri + CHUNK - 1) / CHUNK;
  for (int step = 0; step < MARCH_ITER; ++step) {
    if (!__syncthreads_or(!done)) break;  // every thread of the block stopped
    float best = BIG;
    for (int c = 0; c < n_chunks; ++c) {
      const int base = c * CHUNK;
      const int cnt = min(CHUNK, n_tri - base);
      if (n_chunks > 1 || step == 0) {  // one chunk stays staged
        __syncthreads();  // the previous chunk is done with the table
        for (int k = threadIdx.x; k < cnt * HART_STRIDE; k += blockDim.x) {
          tab[k] = vtx[(int64_t)base * HART_STRIDE + k];
        }
        __syncthreads();
      }
      if (done) continue;
      for (int j = 0; j < cnt; ++j) {
        best = fminf(best, tri_dist2(px, py, pz, tab + HART_STRIDE * j));
      }
    }
    if (done) continue;
    const float dist = sqrtf(best);
    if (dist < MARCH_EPS) {
      iters = step;
      done = true;
    } else {
      px = px + dist * dx;
      py = py + dist * dy;
      pz = pz + dist * dz;
    }
  }
  if (live) {
    const float val = (float)iters * INV_LAST;
    out[i] = val;
    out[(int64_t)n + i] = val;
    out[2 * (int64_t)n + i] = val;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() of the launch.  `vtx` may
// be null when n_tri is 0.
int rvpt_hart(const float* vtx, int n_tri, const float* cam,
              const int64_t* pix_ids, float* out, int n, uint32_t frame,
              uint32_t jitter_salt, int cam_mode, float mint, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  hart_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      vtx, n_tri, cam, pix_ids, out, n, frame, jitter_salt, cam_mode, mint);
  return (int)cudaGetLastError();
}

const char* rvpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
