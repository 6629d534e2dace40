// Primary-hit kernel for Hopper (sm_90a): the single-intersection debug
// integrators (modes 0-6), one thread per pixel, one launch per frame and
// AA sample.
//
// Replaces the Pallas kernel B3 of rvpt_tpu/ops/pathkernel.py
// (make_primary_kernel :3390, launched by _primary_call :3445): an
// in-kernel camera ray or one passed in, one closest-hit search over
// triangles, spheres and
// planes (scene_search.cuh, the search K1 runs), then the finalize of
// _primary_finalize (:3289-3387), each mode its own template instance:
// binary, color, depth (rsqrt(|d|^2)/max(t, 1e-30)), normal, Utah (raw d.y
// sky), AO (nrays cosine probes with salts salt_base + 4i, each a search)
// and Appel (one shadow search toward the light; a miss is white).  Hit
// normals are normalized and zeroed on a miss, as isect_from_hit does.
// Each mode has two search forms (BVH), as the whole-path kernel: the row
// form (scene_search.cuh: float4 rows and the t-first reject; AO's probes
// and Appel's shadow ray, which use only whether something is hit, as
// any-hit searches) and the BVH form, the port of B3's culled form
// (_primary_call's cull_tables), which walks the tree for the triangles
// after the spheres
// and planes (bvh_walk.cuh: pack_walk's float4 rows, with a t-first reject
// but in the camera search of modes 0-3, a 64-bit stack entry; AO's probes
// and Appel's shadow ray, which use only whether something is hit, walk
// until their first hit).  The BVH form
// with rays passed in serves the big meshes (more than 1,024 triangles),
// whose camera rays are made by the caller: there it replaces the big-mesh kernel B5's search-only instance
// (make_bigmesh_kernel :2061, BigMeshTracer.trace_primary :3143), one
// launch per search with the finalize between launches, by one launch per
// frame.
// The TPU layout is not carried over: no [8,1024] tiles, no one-hot table
// fetches.  Pixel ids are optional: the raster 0..n-1, or a split-screen
// rectangle's ids.
//
// What bounds it on this card: arithmetic.  The tables (under 1 KB for the
// Cornell box) sit in shared memory, read as broadcasts; per pixel the
// kernel writes f32[3] (24.9 MB at 1920x1080) and reads an int64 id when
// given, and the six f32 ray components when they are passed in.  AO's probe searches (nrays per hit pixel) and Appel's shadow
// search multiply the search work; a pixel that missed casts none.  The
// BVH form reads the nodes and triangle rows along each ray's walk from
// device memory.
//
// walk_count_kernel is the redesigned walk's counting instance
// (pathkernel.count_walk): per live ray one closest-hit or occlusion
// search with bvh_walk.cuh's COUNT, writing the node slab tests, triangle
// rows opened, rows tested in full and loop iterations as int32[4,N]; it
// serves chip_smoke.py's census of the walk and no display path.
//
// Rounding: every expression keeps the operation order of the plain
// version (rvpt_tpu_torch/ops/pathkernel.py primary_plain and
// _primary_finalize).  Build with --fmad=false and without fast math.

#include <cstdint>
#include <cuda_runtime.h>

#include "bvh_walk.cuh"
#include "scene_search.cuh"

namespace {

using namespace scene;

constexpr int THREADS = 256;
// The walk's stack form (bvh_walk.cuh, walk's PACKED): one 64-bit entry
// per node, which ran faster here than two arrays.
constexpr bool PACKED_STACK = true;

template <int MODE, bool BVH>
__global__ void __launch_bounds__(THREADS) primary_kernel(
    const float* __restrict__ tables, int n_tri, int n_sph, int n_pln,
    int n_mat, const float* __restrict__ nodes,
    const float* __restrict__ walk_rows, const float* __restrict__ cam_in,
    const int64_t* __restrict__ pix_ids, const float* __restrict__ ox_in,
    const float* __restrict__ oy_in, const float* __restrict__ oz_in,
    const float* __restrict__ dx_in, const float* __restrict__ dy_in,
    const float* __restrict__ dz_in, float* __restrict__ out, int n,
    uint32_t frame, uint32_t salt_base, uint32_t jitter_salt, int cam_mode,
    float mint, int nrays, float inv_nrays) {
  extern __shared__ __align__(16) float smem[];
  // cam_in is null when the rays are passed in.  The BVH form stages all
  // but the triangles, which its walk reads from device memory (walk_rows,
  // pack_walk's rows and material ids).
  const Tables s =
      BVH ? stage(smem, cam_in, tables + TRI_STRIDE * n_tri, 0, n_sph, n_pln,
                  n_mat)
          : stage(smem, cam_in, tables, n_tri, n_sph, n_pln, n_mat);
  const walk::Tree tree =
      BVH ? walk::tree(walk_rows, n_tri, nodes) : walk::Tree{};
  // The camera search.  In modes 0-3, the only search of the frame, its
  // triangle rows are loaded whole and tested in full (bvh_walk.cuh,
  // test_row's EAGER): a camera ray's rows nearly all pass the t-first
  // reject (about 93% on the builtin meshes), and there its dependent
  // loads cost more than the tests it saves.  Utah (mode 4) ran 4-6%
  // slower so (kernel_ab.py, NVIDIA H100 80GB HBM3 at 700 W) and keeps
  // the reject, as AO and Appel do.
  auto search = [&](float ox, float oy, float oz, float dx, float dy,
                    float dz) -> Hit {
    if constexpr (BVH) {
      return walk::closest_hit<PACKED_STACK, (MODE <= 3)>(s, tree, ox, oy, oz,
                                                         dx, dy, dz, mint);
    } else {
      // The t-first reject: modes 0-4 ran 10-12% faster with it on the
      // Cornell box, AO and Appel 3% (kernel_ab.py, NVIDIA H100 80GB HBM3
      // at 700 W).
      return closest_hit<true>(s, ox, oy, oz, dx, dy, dz, mint);
    }
  };
  // Whether a probe or shadow ray hits anything: search(...).fam >= 0, by
  // the any-hit walk in the BVH form, the any-hit row search in the row
  // form.
  auto occluded = [&](float ox, float oy, float oz, float dx, float dy,
                      float dz) -> bool {
    if constexpr (BVH) {
      return walk::occluded<PACKED_STACK>(s, tree, ox, oy, oz, dx, dy, dz,
                                          mint);
    } else {
      return scene::occluded(s, ox, oy, oz, dx, dy, dz, mint);
    }
  };
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t pix = pix_ids ? (uint32_t)pix_ids[i] : (uint32_t)i;

  float ox, oy, oz, dx, dy, dz;
  if (ox_in) {
    ox = ox_in[i];
    oy = oy_in[i];
    oz = oz_in[i];
    dx = dx_in[i];
    dy = dy_in[i];
    dz = dz_in[i];
  } else {
    camera_ray(smem, cam_mode, pix, frame, jitter_salt, ox, oy, oz, dx, dy,
               dz);
  }
  const Hit h = search(ox, oy, oz, dx, dy, dz);
  const bool hit = h.fam >= 0;
  const float hit_f = hit ? 1.0f : 0.0f;
  const float inv_nl =
      rsqrtf(fmaxf(h.nx * h.nx + h.ny * h.ny + h.nz * h.nz, 1e-30f));
  // Normalized, zeroed on a miss (isect_from_hit's convention).
  const float nX = hit ? h.nx * inv_nl : 0.0f;
  const float nY = hit ? h.ny * inv_nl : 0.0f;
  const float nZ = hit ? h.nz * inv_nl : 0.0f;
  const float* M = material(s, h.mat);

  float r, g, b;
  if (MODE == 0) {  // binary (integrators.glsl:24-38)
    r = g = b = hit_f;
  } else if (MODE == 1) {  // color (42-59)
    r = hit ? M[0] : 0.0f;
    g = hit ? M[1] : 0.0f;
    b = hit ? M[2] : 0.0f;
  } else if (MODE == 2) {  // depth (63-82): rsqrt(|d|^2)/t; a miss is 0
    const float inv_d = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-30f));
    r = g = b = hit ? inv_d / fmaxf(h.t, 1e-30f) : 0.0f;
  } else if (MODE == 3) {  // normal (86-102)
    r = 0.5f * nX + 0.5f * hit_f;
    g = 0.5f * nY + 0.5f * hit_f;
    b = 0.5f * nZ + 0.5f * hit_f;
  } else if (MODE == 4) {  // Utah (106-148): raster shading, no shadows
    const bool facing = (dx * nX + dy * nY + dz * nZ) < 0.0f;
    const float fX = facing ? nX : -nX;
    const float fY = facing ? nY : -nY;
    const float fZ = facing ? nZ : -nZ;
    const float cos_l = fmaxf(0.0f, LDIR_X * fX + LDIR_Y * fY + LDIR_Z * fZ);
    // The sky uses RAW d.y (glsl mix extrapolates outside [0,1]).
    r = hit ? AMBIENT + M[3] + M[0] * (LIGHT_I * cos_l) : 1.0f + SKY_R * dy;
    g = hit ? AMBIENT + M[4] + M[1] * (LIGHT_I * cos_l) : 1.0f + SKY_G * dy;
    b = hit ? AMBIENT + M[5] + M[2] * (LIGHT_I * cos_l) : 1.0f + SKY_B * dy;
  } else {
    const float inv_dl = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-30f));
    const float iX = dx * inv_dl, iY = dy * inv_dl, iZ = dz * inv_dl;
    const float cos_v = iX * nX + iY * nY + iZ * nZ;
    // AO faces the normal against the ray (cos < 0 keeps it); Appel flips
    // it where cos > 0: the two differ where cos is exactly 0.
    const bool keep = MODE == 5 ? cos_v < 0.0f : !(cos_v > 0.0f);
    const float fX = keep ? nX : -nX;
    const float fY = keep ? nY : -nY;
    const float fZ = keep ? nZ : -nZ;
    const float px = ox + h.t * dx + EPSILON * fX;
    const float py = oy + h.t * dy + EPSILON * fY;
    const float pz = oz + h.t * dz + EPSILON * fZ;
    if (MODE == 5) {  // AO (152-200): nrays cosine probes
      float acc = 0.0f;
      for (int k = 0; hit && k < nrays; ++k) {
        uint32_t ra = pix, rb = frame, rc = salt_base + 4u * (uint32_t)k;
        pcg3d(ra, rb, rc);
        const float ru = unit(ra), rv = unit(rb);
        const float phi = TWO_PI * ru;
        const float cos_t = 1.0f - 2.0f * rv;
        const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
        const bool p = occluded(px, py, pz, fX + sin_t * cosf(phi),
                                fY + sin_t * sinf(phi), fZ + cos_t);
        acc = acc + (p ? 1.0f : 0.0f);
      }
      const float ao = 1.0f - acc * inv_nrays;
      r = g = b = hit ? ao : 0.0f;
    } else {  // Appel (204-250): a hard shadow; a miss is white
      const bool shadow = hit && occluded(px, py, pz, LDIR_X, LDIR_Y, LDIR_Z);
      const float cos_l = fmaxf(0.0f, LDIR_X * fX + LDIR_Y * fY + LDIR_Z * fZ);
      const float lit = shadow ? 0.0f : LIGHT_I * cos_l;
      r = g = b = hit ? lit : 1.0f;
    }
  }
  out[i] = r;
  out[(int64_t)n + i] = g;
  out[2 * (int64_t)n + i] = b;
}

template <int MODE, bool BVH>
int launch(const float* tables, int n_tri, int n_sph, int n_pln, int n_mat,
           const float* nodes, const float* walk_rows, const float* cam,
           const int64_t* pix_ids,
           const float* const* rays, float* out, int n, uint32_t frame,
           uint32_t salt_base, uint32_t jitter_salt, int cam_mode, float mint,
           int nrays, float inv_nrays, void* stream) {
  const size_t smem =
      sizeof(float) * staged_floats(BVH ? 0 : n_tri, n_sph, n_pln, n_mat);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        primary_kernel<MODE, BVH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n + THREADS - 1) / THREADS;
  primary_kernel<MODE, BVH><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      tables, n_tri, n_sph, n_pln, n_mat, nodes, walk_rows, cam, pix_ids,
      rays[0], rays[1], rays[2], rays[3], rays[4], rays[5], out, n, frame,
      salt_base, jitter_salt, cam_mode, mint, nrays, inv_nrays);
  return (int)cudaGetLastError();
}

// The redesigned walk's counting instance: per live lane of `rays` (f32[7,N]:
// the ray, then live as 0/1) one search (ANY: an occlusion search), its
// work to out int32[4,N] (node slab tests, rows opened, rows tested in
// full, iterations); zeros on a lane that is not live.
template <bool ANY>
__global__ void __launch_bounds__(THREADS) walk_count_kernel(
    const float* __restrict__ tables, int n_tri, int n_sph, int n_pln,
    int n_mat, const float* __restrict__ nodes,
    const float* __restrict__ walk_rows, const float* __restrict__ rays,
    int32_t* __restrict__ out, int n, float mint) {
  extern __shared__ __align__(16) float smem[];
  const Tables s = stage(smem, nullptr, tables + TRI_STRIDE * n_tri, 0, n_sph,
                         n_pln, n_mat);
  const walk::Tree tree = walk::tree(walk_rows, n_tri, nodes);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  auto row = [&](int r) { return rays[(int64_t)r * n + i]; };
  walk::Count c;
  if (row(6) > 0.0f) {
    if constexpr (ANY) {
      walk::occluded<PACKED_STACK, true>(s, tree, row(0), row(1), row(2),
                                         row(3), row(4), row(5), mint, &c);
    } else {
      walk::closest_hit<PACKED_STACK, false, true>(s, tree, row(0), row(1),
                                                   row(2), row(3), row(4),
                                                   row(5), mint, &c);
    }
  }
  out[i] = c.box;
  out[(int64_t)n + i] = c.tri;
  out[2 * (int64_t)n + i] = c.full;
  out[3 * (int64_t)n + i] = c.iter;
}

}  // namespace

extern "C" {

int rvpt_max_table_floats() { return max_table_floats(); }

// Launch debug mode `mode` (0-6) on `stream`, in the BVH form when
// `nodes` (pack_bvh's rows, with walk_rows pack_walk's) is non-null, on
// the rays ox..dz (f32[n] each)
// when `ox` is non-null, else on camera rays from `cam`; returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for another
// mode or a BVH form without walk_rows.
int rvpt_primary(const float* tables, int n_tri, int n_sph, int n_pln,
                 int n_mat, const float* nodes, const float* walk_rows,
                 const float* cam,
                 const int64_t* pix_ids, const float* ox, const float* oy,
                 const float* oz, const float* dx, const float* dy,
                 const float* dz, float* out, int n, uint32_t frame,
                 uint32_t salt_base, uint32_t jitter_salt, int mode,
                 int cam_mode, float mint, int nrays, float inv_nrays,
                 void* stream) {
  if (n <= 0) return 0;
  if (nodes && !walk_rows) return (int)cudaErrorInvalidValue;
  const float* const rays[6] = {ox, oy, oz, dx, dy, dz};
#define RVPT_CASE(M)                                                         \
  case M:                                                                    \
    return nodes ? launch<M, true>(tables, n_tri, n_sph, n_pln, n_mat,     \
                                   nodes, walk_rows, cam, pix_ids, rays,   \
                                   out, n, frame, salt_base, jitter_salt,  \
                                   cam_mode, mint, nrays, inv_nrays,       \
                                   stream)                                 \
                 : launch<M, false>(tables, n_tri, n_sph, n_pln, n_mat,    \
                                    nodes, walk_rows, cam, pix_ids, rays,  \
                                    out, n, frame, salt_base, jitter_salt, \
                                    cam_mode, mint, nrays, inv_nrays,      \
                                    stream);
  switch (mode) {
    RVPT_CASE(0)
    RVPT_CASE(1)
    RVPT_CASE(2)
    RVPT_CASE(3)
    RVPT_CASE(4)
    RVPT_CASE(5)
    RVPT_CASE(6)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RVPT_CASE
}

// Launch the redesigned walk's counting instance on `stream` (ANY when
// `any_hit` is non-zero): `rays` f32[7,n], out int32[4,n]; returns
// cudaGetLastError() of the launch.
int rvpt_walk_count(const float* tables, int n_tri, int n_sph, int n_pln,
                    int n_mat, const float* nodes, const float* walk_rows,
                    const float* rays, int32_t* out, int n, int any_hit,
                    float mint, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = sizeof(float) * staged_floats(0, n_sph, n_pln, n_mat);
  const int blocks = (n + THREADS - 1) / THREADS;
  if (any_hit) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          walk_count_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    walk_count_kernel<true><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        tables, n_tri, n_sph, n_pln, n_mat, nodes, walk_rows, rays, out, n,
        mint);
  } else {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          walk_count_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    walk_count_kernel<false><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        tables, n_tri, n_sph, n_pln, n_mat, nodes, walk_rows, rays, out, n,
        mint);
  }
  return (int)cudaGetLastError();
}

const char* rvpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
