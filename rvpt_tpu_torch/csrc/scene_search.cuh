// The scene staging, camera rays and closest-hit search shared by the
// whole-path kernel (path_kernel.cu, K1) and the primary-hit kernel
// (primary_kernel.cu, B3); the camera rays also serve the Hart march
// (hart_kernel.cu, B4), and the sphere and plane searches the BVH forms of
// the search (bvh_search.cuh, bvh_walk.cuh).  They mirror, in one thread
// per ray, _gen_rays_inkernel (:1059) and _search (:715) of
// rvpt_tpu/ops/pathkernel.py, and their plain versions in
// rvpt_tpu_torch/ops/pathkernel.py (_camera_rays_plain, _search_plain,
// _any_hit_plain).
//
// Tables come in the row form of pack_fwd: [T,17] triangle rows
// (TRI_FIELDS), [S,5] sphere, [P,5] plane and [M,8] material rows, one
// flat f32 buffer.  A block stages them whole into dynamic shared memory
// after the f32[24] camera vector, where every lane of a warp reads the
// same word (a broadcast).  The row form's search (K1's and B3's row
// forms, the Cornell box's), redesigned for Hopper:
//
// - Triangle rows: `stage` lays each [17] row out as four aligned float4
//   (WALK_FIELDS: nx ny nz v0n | e0 v0e0 | e1 v0e1 | g00 g11 g01 inv_det,
//   pack_walk's order) and the material ids in a side array after them,
//   the same 17 floats a row, so the tables take the shared memory they
//   took before.  At pack_fwd's stride of 17 no row was 16-byte aligned
//   and a test issued 16-17 scalar shared-memory loads; now it issues
//   four 128-bit broadcasts.
// - The t-first reject (REJECT): a test loads the first float4, computes
//   t, and stops where !(mint < t) or !(t < h.t), exactly the cases in
//   which the full test changes nothing; the rest of the row is loaded
//   and tested only past it.  It pays where a warp's lanes reject a row
//   together and the loads after the branch are hidden; each kernel says
//   where it takes it (path_kernel.cu: row_reject; primary_kernel.cu).
// - Occlusion searches (`occluded`: K1's Whitted shadow ray, B3's AO
//   probes and Appel shadow ray) use only whether something is hit: the
//   spheres and planes first, then the triangles until the first one that
//   passes the closest-hit search's acceptance against the miss sentinel
//   (mint < t < BIG and the u, v test).  A closest-hit search ends with
//   fam >= 0 if and only if some candidate passes against BIG (a winner
//   only ever tightens h.t below BIG), so the answer is its fam >= 0, bit
//   for bit.
//
// Rounding: every expression keeps the operation order of the plain
// versions; build with --fmad=false and without fast math.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "kajiya_common.cuh"

namespace scene {

using namespace kajiya;

constexpr int TRI_STRIDE = 17;  // TRI_FIELDS
constexpr int ROW4 = 4;         // float4 per staged triangle row (WALK_FIELDS)
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
  const float4* tri;     // [T] staged rows, ROW4 float4 each (WALK_FIELDS)
  const float* tri_mat;  // [T] the triangles' material ids
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

// The column of pack_fwd's [17] triangle row that staged float f of a
// row (WALK_FIELDS) holds: nx ny nz, then v0n, e0, v0e0, e1, v0e1, and
// g00 g11 g01 inv_det.
__device__ __forceinline__ int walk_col(int f) {
  return f >= 12 ? f : ((f & 3) == 3 ? 9 + (f >> 2) : f - (f >> 2));
}

// Copy the camera vector (when given) and the tables into `smem` (16-byte
// aligned), the triangle rows as ROW4 float4 each and then their material
// ids, the other tables as they are; every thread of the block calls it,
// before any thread leaves.
__device__ __forceinline__ Tables stage(float* smem, const float* cam_in,
                                       const float* tables, int n_tri,
                                       int n_sph, int n_pln, int n_mat) {
  const int n_tab = staged_floats(n_tri, n_sph, n_pln, n_mat) - CAM_LEN;
  const int n_rows = 4 * ROW4 * n_tri;  // floats of the triangle rows
  if (cam_in) {
    for (int k = threadIdx.x; k < CAM_LEN; k += blockDim.x) smem[k] = cam_in[k];
  }
  float* tab = smem + CAM_LEN;
  for (int k = threadIdx.x; k < n_tab; k += blockDim.x) {
    const int j = k >> 4;
    tab[k] = k < n_rows ? tables[TRI_STRIDE * j + walk_col(k & 15)]
             : k < n_rows + n_tri
                 ? tables[TRI_STRIDE * (k - n_rows) + TRI_STRIDE - 1]
                 : tables[k];
  }
  __syncthreads();
  Tables s;
  s.tri = reinterpret_cast<const float4*>(tab);
  s.tri_mat = tab + n_rows;
  s.sph = s.tri_mat + n_tri;
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

// Staged triangle row j against the ray: t from the first float4 (the
// rest of the row is loaded into e0, e1, g only past the reject when
// REJECT, else at once), then the barycentric test.  Returns whether the
// triangle passes the acceptance with `tmax` as the best t so far (mint <
// t < tmax and the u, v test), with t in `t` and the first float4 (the
// normal, then v0n) in `a`.
template <bool REJECT>
__device__ __forceinline__ bool test_tri_row(const float4* R, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, float mint,
                                             float tmax, float& t, float4& a) {
  a = R[0];
  float4 e0, e1, g;
  if constexpr (!REJECT) {
    e0 = R[1];
    e1 = R[2];
    g = R[3];
  }
  const float dn = a.x * dx + a.y * dy + a.z * dz;
  const float on = a.x * ox + a.y * oy + a.z * oz;
  t = (a.w - on) / safe_den(dn);
  if constexpr (REJECT) {
    if (!(mint < t) || !(t < tmax)) return false;
    e0 = R[1];
    e1 = R[2];
    g = R[3];
  }
  const float de0 = e0.x * dx + e0.y * dy + e0.z * dz;
  const float de1 = e1.x * dx + e1.y * dy + e1.z * dz;
  const float oe0 = e0.x * ox + e0.y * oy + e0.z * oz;
  const float oe1 = e1.x * ox + e1.y * oy + e1.z * oz;
  const float b0 = oe0 + t * de0 - e0.w;
  const float b1 = oe1 + t * de1 - e1.w;
  const float u = g.w * (g.y * b0 - g.z * b1);
  const float v = g.w * (g.x * b1 - g.z * b0);
  return mint < t && t < tmax && u > 0.0f && v > 0.0f && u + v < 1.0f;
}

// The three families of the search, each folding its candidates into `h`:
// a candidate wins only with a strictly smaller t, which keeps the first
// minimum within a family and the earlier family across families.
template <bool REJECT>
__device__ __forceinline__ void search_tri_rows(const Tables& s, float ox,
                                                float oy, float oz, float dx,
                                                float dy, float dz, float mint,
                                                Hit& h) {
  for (int j = 0; j < s.n_tri; ++j) {
    float t;
    float4 a;
    if (test_tri_row<REJECT>(s.tri + ROW4 * j, ox, oy, oz, dx, dy, dz, mint,
                             h.t, t, a)) {
      h.t = t;
      h.nx = a.x;
      h.ny = a.y;
      h.nz = a.z;
      h.mat = s.tri_mat[j];
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
// row form's order: triangles first; REJECT: test_tri_row's.
template <bool REJECT>
__device__ __forceinline__ Hit closest_hit(const Tables& s, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz, float mint) {
  Hit h = miss();
  search_tri_rows<REJECT>(s, ox, oy, oz, dx, dy, dz, mint, h);
  search_spheres(s, ox, oy, oz, dx, dy, dz, mint, h);
  search_planes(s, ox, oy, oz, dx, dy, dz, mint, h);
  return h;
}

// Whether the ray hits anything: closest_hit(...).fam >= 0, bit for bit.
// The spheres and planes first (few, and a hit there skips every
// triangle), then the triangles, stopping at the first acceptance.
__device__ __forceinline__ bool occluded(const Tables& s, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float mint) {
  Hit h = miss();
  search_spheres(s, ox, oy, oz, dx, dy, dz, mint, h);
  search_planes(s, ox, oy, oz, dx, dy, dz, mint, h);
  if (h.fam >= 0) return true;
  for (int j = 0; j < s.n_tri; ++j) {
    float t;
    float4 a;
    if (test_tri_row<true>(s.tri + ROW4 * j, ox, oy, oz, dx, dy, dz, mint,
                           BIG, t, a)) {
      return true;
    }
  }
  return false;
}

}  // namespace scene
