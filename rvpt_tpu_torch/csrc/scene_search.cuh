// The scene staging, camera rays and closest-hit search shared by the
// whole-path kernel (path_kernel.cu, K1) and the primary-hit kernel
// (primary_kernel.cu, B3); the camera rays also serve the Hart march
// (hart_kernel.cu, B4), and the sphere and plane searches the BVH forms of
// the search (bvh_search.cuh).  They mirror, in one thread per ray,
// _gen_rays_inkernel (:1059) and _search (:715) of
// rvpt_tpu/ops/pathkernel.py, and their plain versions in
// rvpt_tpu_torch/ops/pathkernel.py (_camera_rays_plain, _search_plain).
//
// Tables are the row form of pack_fwd: [T,17] triangle rows (TRI_FIELDS),
// [S,5] sphere, [P,5] plane and [M,8] material rows, one flat f32 buffer.
// A block stages them whole into dynamic shared memory after the f32[24]
// camera vector, where every lane of a warp reads the same word (a
// broadcast).  Rounding: every expression keeps the operation order of the
// plain versions; build with --fmad=false and without fast math.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "kajiya_common.cuh"

namespace scene {

using namespace kajiya;

constexpr int TRI_STRIDE = 17;  // TRI_FIELDS
constexpr int SPH_STRIDE = 5;   // SPH_FIELDS
constexpr int PLN_STRIDE = 5;   // PLN_FIELDS
constexpr int MAT_STRIDE = 8;   // MAT_FIELDS
constexpr int CAM_LEN = 24;     // camera_params layout
constexpr int CAM_ASPECT = 16, CAM_PROJ = 17, CAM_INV_W = 18, CAM_INV_H = 19;
constexpr int CAM_W = 20;
constexpr int PINHOLE = 0, ORTHO = 1;

constexpr float BIG = 3.0e38f;
constexpr float HALF_TURN = (float)(0.5 * 6.283185307179586);
// The debug integrators' and Whitted's directional light, normalize(0.5,
// 1.0, 0.3) in double and rounded once (pathkernel.py:3283-3286).
constexpr float LDIR_X = (float)0.43193421279068;
constexpr float LDIR_Y = (float)0.86386842558136;
constexpr float LDIR_Z = (float)0.259160527674408;
constexpr float AMBIENT = 0.1f;
constexpr float LIGHT_I = 1.0f;

struct Tables {
  const float* tri;
  const float* sph;
  const float* pln;
  const float* mat;
  int n_tri, n_sph, n_pln, n_mat;
};

// The winner of a search: t, the unnormalized normal, the material id, and
// the (family, index) of the hit; family and index are -1 on a miss.
struct Hit {
  float t, nx, ny, nz, mat;
  int fam, idx;
};

// Floats of dynamic shared memory a launch needs for the camera vector
// and the tables.
__host__ __device__ inline int staged_floats(int n_tri, int n_sph, int n_pln,
                                             int n_mat) {
  return CAM_LEN + TRI_STRIDE * n_tri + SPH_STRIDE * n_sph +
         PLN_STRIDE * n_pln + MAT_STRIDE * n_mat;
}

// Largest table (in floats) a block can stage into the card's opt-in
// shared memory after the camera vector.
inline int max_table_floats() {
  int dev = 0, bytes = 48 * 1024;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return bytes / 4 - CAM_LEN;
}

// Copy the camera vector (when given) and the tables into `smem`; every
// thread of the block calls it, before any thread leaves.
__device__ __forceinline__ Tables stage(float* smem, const float* cam_in,
                                       const float* tables, int n_tri,
                                       int n_sph, int n_pln, int n_mat) {
  const int n_tab = staged_floats(n_tri, n_sph, n_pln, n_mat) - CAM_LEN;
  if (cam_in) {
    for (int k = threadIdx.x; k < CAM_LEN; k += blockDim.x) smem[k] = cam_in[k];
  }
  float* tab = smem + CAM_LEN;
  for (int k = threadIdx.x; k < n_tab; k += blockDim.x) tab[k] = tables[k];
  __syncthreads();
  Tables s;
  s.tri = tab;
  s.sph = s.tri + TRI_STRIDE * n_tri;
  s.pln = s.sph + SPH_STRIDE * n_sph;
  s.mat = s.pln + PLN_STRIDE * n_pln;
  s.n_tri = n_tri;
  s.n_sph = n_sph;
  s.n_pln = n_pln;
  s.n_mat = n_mat;
  return s;
}

// The material row of a winner's id, clamped into the table.
__device__ __forceinline__ const float* material(const Tables& s, float wmat) {
  return s.mat + MAT_STRIDE * min(max((int)wmat, 0), s.n_mat - 1);
}

// The jittered camera ray of pixel `pix` (_gen_rays_inkernel :1059).
__device__ __forceinline__ void camera_ray(
    const float* cam, int mode, uint32_t pix, uint32_t frame,
    uint32_t jitter_salt, float& ox, float& oy, float& oz, float& dx,
    float& dy, float& dz) {
  uint32_t a = pix, b = frame, c = jitter_salt;
  pcg3d(a, b, c);
  const float ju = unit(a), jv = unit(b);
  const uint32_t width = (uint32_t)cam[CAM_W];
  const float xs = (float)(pix % width), ys = (float)(pix / width);
  const float cx = (xs + ju) * cam[CAM_INV_W];
  const float cy = 1.0f - (ys + jv) * cam[CAM_INV_H];
  const float* m = cam;  // row-major 4x4 camera matrix
  if (mode == PINHOLE) {
    const float u = cam[CAM_ASPECT] * (2.0f * cx - 1.0f);
    const float v = 2.0f * cy - 1.0f;
    const float w = cam[CAM_PROJ];
    dx = m[0] * u + m[1] * v + m[2] * w;
    dy = m[4] * u + m[5] * v + m[6] * w;
    dz = m[8] * u + m[9] * v + m[10] * w;
    const float inv = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-30f));
    ox = m[3];
    oy = m[7];
    oz = m[11];
    dx = dx * inv;
    dy = dy * inv;
    dz = dz * inv;
  } else if (mode == ORTHO) {
    const float u = cam[CAM_ASPECT] * (2.0f * cx - 1.0f) * cam[CAM_PROJ];
    const float v = (2.0f * cy - 1.0f) * cam[CAM_PROJ];
    ox = m[0] * u + m[1] * v + m[3];
    oy = m[4] * u + m[5] * v + m[7];
    oz = m[8] * u + m[9] * v + m[11];
    dx = m[2];
    dy = m[6];
    dz = m[10];
  } else {  // SPHERICAL, with the reference's .xzy swizzle
    const float phi = cx * TWO_PI;
    const float theta = cy * HALF_TURN;
    const float sin_t = sinf(theta);
    const float lx = sin_t * cosf(phi);
    const float lz = sin_t * sinf(phi);
    const float ly = cosf(theta);
    ox = m[3];
    oy = m[7];
    oz = m[11];
    dx = m[0] * lx + m[1] * ly + m[2] * lz;
    dy = m[4] * lx + m[5] * ly + m[6] * lz;
    dz = m[8] * lx + m[9] * ly + m[10] * lz;
  }
}

// The three families of the search, each folding its candidates into `h`:
// a candidate wins only with a strictly smaller t, which keeps the first
// minimum within a family and the earlier family across families.
__device__ __forceinline__ void search_tri_rows(const Tables& s, float ox,
                                                float oy, float oz, float dx,
                                                float dy, float dz, float mint,
                                                Hit& h) {
  for (int j = 0; j < s.n_tri; ++j) {
    const float* T = s.tri + TRI_STRIDE * j;
    const float nx = T[0], ny = T[1], nz = T[2];
    const float dn = nx * dx + ny * dy + nz * dz;
    const float on = nx * ox + ny * oy + nz * oz;
    const float de0 = T[3] * dx + T[4] * dy + T[5] * dz;
    const float de1 = T[6] * dx + T[7] * dy + T[8] * dz;
    const float oe0 = T[3] * ox + T[4] * oy + T[5] * oz;
    const float oe1 = T[6] * ox + T[7] * oy + T[8] * oz;
    const float t = (T[9] - on) / safe_den(dn);
    const float b0 = oe0 + t * de0 - T[10];
    const float b1 = oe1 + t * de1 - T[11];
    const float u = T[15] * (T[13] * b0 - T[14] * b1);
    const float v = T[15] * (T[12] * b1 - T[14] * b0);
    if (mint < t && t < h.t && u > 0.0f && v > 0.0f && u + v < 1.0f) {
      h.t = t;
      h.nx = nx;
      h.ny = ny;
      h.nz = nz;
      h.mat = T[16];
      h.fam = 0;
      h.idx = j;
    }
  }
}

__device__ __forceinline__ void search_spheres(const Tables& s, float ox,
                                               float oy, float oz, float dx,
                                               float dy, float dz, float mint,
                                               Hit& h) {
  for (int j = 0; j < s.n_sph; ++j) {
    const float* S = s.sph + SPH_STRIDE * j;
    const float ocx = ox - S[0], ocy = oy - S[1], ocz = oz - S[2];
    const float rad = S[3];
    const float dd = dx * dx + dy * dy + dz * dz;
    const float bh = dx * ocx + dy * ocy + dz * ocz;
    const float ct = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
    const float disc = bh * bh - dd * ct;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float dds = safe_den(dd);
    const float t0 = (-bh - sq) / dds;
    const float t1 = (-bh + sq) / dds;
    const float tn = (t0 > mint && t0 < h.t) ? t0 : BIG;
    const float tf = (t1 > mint && t1 < h.t) ? t1 : BIG;
    const float ts = (disc > 0.0f && rad > 0.0f) ? fminf(tn, tf) : BIG;
    if (ts < h.t) {
      h.t = ts;
      // unnormalized normal pos - center, as the JAX kernel
      h.nx = ox + ts * dx - S[0];
      h.ny = oy + ts * dy - S[1];
      h.nz = oz + ts * dz - S[2];
      h.mat = S[4];
      h.fam = 1;
      h.idx = j;
    }
  }
}

__device__ __forceinline__ void search_planes(const Tables& s, float ox,
                                              float oy, float oz, float dx,
                                              float dy, float dz, float mint,
                                              Hit& h) {
  for (int j = 0; j < s.n_pln; ++j) {
    const float* P = s.pln + PLN_STRIDE * j;
    const float nx = P[0], ny = P[1], nz = P[2];
    const float dn = nx * dx + ny * dy + nz * dz;
    const float on = nx * ox + ny * oy + nz * oz;
    const float tp = (P[3] - on) / safe_den(dn);
    const bool pvalid = (nx * nx + ny * ny + nz * nz) > 0.0f;
    if (tp > mint && tp < h.t && pvalid) {
      h.t = tp;
      h.nx = nx;
      h.ny = ny;
      h.nz = nz;
      h.mat = P[4];
      h.fam = 2;
      h.idx = j;
    }
  }
}

// The winner before any candidate: t 3e38, family and index -1.
__device__ __forceinline__ Hit miss() {
  Hit h;
  h.t = BIG;
  h.nx = h.ny = h.nz = h.mat = 0.0f;
  h.fam = h.idx = -1;
  return h;
}

// Closest hit over triangles, spheres and planes (_search :715), in the
// row form's order: triangles first.
__device__ __forceinline__ Hit closest_hit(const Tables& s, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz, float mint) {
  Hit h = miss();
  search_tri_rows(s, ox, oy, oz, dx, dy, dz, mint, h);
  search_spheres(s, ox, oy, oz, dx, dy, dz, mint, h);
  search_planes(s, ox, oy, oz, dx, dy, dz, mint, h);
  return h;
}

}  // namespace scene
