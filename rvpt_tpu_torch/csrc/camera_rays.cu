// Camera rays of a pixel batch for Hopper (sm_90a): one thread per ray,
// the jitter, film coordinates, camera model and normalize in registers,
// one launch per batch.
//
// Replaces no TPU kernel: the JAX package makes these rays with jnp
// (rvpt_tpu/render.py jittered_camera_rays, models/camera.py), and the
// port made them with about 109 eager PyTorch ops per call
// (rvpt_tpu_torch/ops/camera_rays.py camera_rays_plain: PCG3D on int64
// lanes, the film coordinates, camera_matrix, a cuBLAS [N,3]@[3,3] and
// normalize), which cost the big-mesh frame 0.70 ms of device time and the
// host a launch each.  The kernels' own in-kernel camera rays
// (scene_search.cuh camera_ray) are not these rays: they differ in the
// last bit on 0.25-0.35% of the components, which flips branches, so
// this kernel reproduces the PyTorch arithmetic bit for bit:
//
// - PCG3D in u32 registers (kajiya_common.cuh): wrapping u32 products and
//   sums give exactly the int64 lanes masked to 32 bits;
// - the film scale is a factor the wrapper rounds as PyTorch does on the
//   card: float(1.0 / W) in double for the display's reciprocal multiply,
//   1.0f / float(W) for the trainer's division (PyTorch divides a CUDA
//   tensor by a CPU scalar as a multiply by that reciprocal);
// - the camera matrix, the pinhole's w = 1/tan(0.5 hfov) and the ortho
//   scale are the tensors PyTorch computed on the card (camera_constants),
//   read from device memory, never rebuilt here;
// - every 3-term product rounds as cuBLAS's sgemm rounds [N,3]@[3,3]: a
//   fused multiply-add chain over k = 0, 1, 2 from +0 (dot3); the squared
//   norm as torch.sum of the squares over a contiguous last axis of 3:
//   (x^2 + z^2) + y^2 (norm2); normalize's where(n2 > 0,
//   1/sqrt(clamp(n2, EPS^2)), 0) with IEEE square root and reciprocal.
//   Every operation is an explicit _rn intrinsic, so --fmad=false or not,
//   nothing is contracted.
//
// Output: six f32[N] planes in one [6, N] buffer (origin x y z, direction
// x y z), the layout K1's and B3's rays-in forms and B6's march read, so
// no transpose follows.
//
// What bounds it on this card: its writes, 24 bytes per ray (49.8 MB for
// a 1080p film, 0.0149 ms at 3.35 TB/s), plus 8 bytes read per ray when
// the pixel ids come as an int64 tensor (split-screen quadrants, sharded
// tiles); about 60 operations per ray are 0.002 ms at 67 TFLOP/s.  So a
// warp's 32 consecutive rays store 128 contiguous bytes to each plane, the
// grid covers the 132 SMs many times over with a grid-stride loop for
// large N, and the 14 camera floats are broadcast loads through L1; no
// shared memory.  Raster ids (no id tensor) are the lane index itself.

#include <cstdint>

#include <cuda_runtime.h>

#include "kajiya_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

constexpr int PINHOLE = 0;
constexpr int ORTHO = 1;

// camera_constants layout: the rotation R = camera_matrix(cam)[:3, :3]
// row-major, the translation, the pinhole's w, the ortho scale.
constexpr int CAM_T = 9;
constexpr int CAM_W = 12;
constexpr int CAM_SCALE = 13;
constexpr int CAM_LEN = 14;

// Python's EPS * EPS in double, then rounded as torch.clamp rounds it.
constexpr float NORM_FLOOR = (float)(1e-8 * 1e-8);
constexpr float TWO_PI_F = (float)6.283185307179586;
constexpr float PI_F = (float)3.141592653589793;

// Row j of R times (a0, a1, a2), as cuBLAS's sgemm sums k = 0..2.
__device__ __forceinline__ float dot3(const float* r, float a0, float a1,
                                      float a2) {
  float acc = __fmaf_rn(a0, r[0], 0.0f);
  acc = __fmaf_rn(a1, r[1], acc);
  return __fmaf_rn(a2, r[2], acc);
}

// torch.sum(v * v, dim=-1) over a contiguous last axis of 3.
__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(z, z)),
                   __fmul_rn(y, y));
}

__global__ void __launch_bounds__(THREADS) camera_rays_kernel(
    const int64_t* __restrict__ ids, int n, uint32_t width, uint32_t frame,
    uint32_t salt, float sx, float sy, float aspect, int mode,
    const float* __restrict__ cam_in, float* __restrict__ out) {
  float cam[CAM_LEN];
#pragma unroll
  for (int k = 0; k < CAM_LEN; ++k) cam[k] = __ldg(cam_in + k);
  const float* R = cam;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += gridDim.x * THREADS) {
    const uint32_t pix = ids != nullptr ? (uint32_t)__ldg(ids + i) : (uint32_t)i;
    uint32_t a = pix, b = frame, c = salt;
    kajiya::pcg3d(a, b, c);
    const float ju = kajiya::unit(a), jv = kajiya::unit(b);
    const uint32_t y = pix / width;
    const float xf = __uint2float_rn(pix - y * width);
    const float yf = __uint2float_rn(y);
    const float cx = __fmul_rn(__fadd_rn(xf, ju), sx);
    const float cy = __fsub_rn(1.0f, __fmul_rn(__fadd_rn(yf, jv), sy));
    float o[3], d[3];
    if (mode == PINHOLE) {
      const float u = __fmul_rn(__fsub_rn(__fmul_rn(2.0f, cx), 1.0f), aspect);
      const float v = __fsub_rn(__fmul_rn(2.0f, cy), 1.0f);
#pragma unroll
      for (int j = 0; j < 3; ++j) d[j] = dot3(R + 3 * j, u, v, cam[CAM_W]);
      const float n2 = norm2(d[0], d[1], d[2]);
      const float inv =
          n2 > 0.0f ? __frcp_rn(__fsqrt_rn(n2 < NORM_FLOOR ? NORM_FLOOR : n2))
                    : 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        o[j] = cam[CAM_T + j];
        d[j] = __fmul_rn(d[j], inv);
      }
    } else if (mode == ORTHO) {
      const float u = __fmul_rn(__fsub_rn(__fmul_rn(2.0f, cx), 1.0f), aspect);
      const float v = __fsub_rn(__fmul_rn(2.0f, cy), 1.0f);
      const float su = __fmul_rn(cam[CAM_SCALE], u);
      const float sv = __fmul_rn(cam[CAM_SCALE], v);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        o[j] = __fadd_rn(dot3(R + 3 * j, su, sv, 0.0f), cam[CAM_T + j]);
        d[j] = R[3 * j + 2];
      }
    } else {  // SPHERICAL, with the reference's .xzy swizzle
      const float phi = __fmul_rn(cx, TWO_PI_F);
      const float theta = __fmul_rn(cy, PI_F);
      const float st = sinf(theta);
      const float lx = __fmul_rn(st, cosf(phi));
      const float lz = __fmul_rn(st, sinf(phi));
      const float ly = cosf(theta);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        o[j] = cam[CAM_T + j];
        d[j] = dot3(R + 3 * j, lx, ly, lz);
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[(size_t)j * n + i] = o[j];
      out[(size_t)(3 + j) * n + i] = d[j];
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() of the launch.  `ids` is
// null for the raster ids 0..n-1; `out` holds 6 * n floats.
int rvpt_camera_rays(const int64_t* ids, int n, int width, uint32_t frame,
                     uint32_t salt, float sx, float sy, float aspect,
                     int mode, const float* cam, float* out, void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  camera_rays_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      ids, n, (uint32_t)width, frame, salt, sx, sy, aspect, mode, cam, out);
  return (int)cudaGetLastError();
}

const char* rvpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
