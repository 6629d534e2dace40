// Whole-path Kajiya kernel for Hopper (sm_90a): one thread per pixel, the
// whole bounce loop in registers, one launch per frame and AA sample.
//
// Replaces the Pallas kernel K1 of rvpt_tpu/ops/pathkernel.py
// (make_path_kernel :1115, launched by _path_call :1276) in its row form
// with integ="kajiya", collect=False: in-kernel camera rays
// (_gen_rays_inkernel :1059) or rays passed in, closest hit over triangles,
// spheres and planes (_search :715), Kajiya shading (_shade :925,
// _shade_geom :857), and the style="standard" tail (:1254-1257).  The TPU
// layout is not carried over: no [8,1024] tiles or padded lanes, no
// MAX_GROUP bounce split with its 16-field carry, no one-hot table fetches.
//
// What bounds it on this card: arithmetic.  The scene tables are tiny
// (Cornell: 12x17 + 2x5 + 6x8 floats, under 1 KB) and are staged into
// shared memory at block start, where every lane of a warp reads the same
// word (a broadcast).  Each ray-bounce runs 12 triangle and 2 sphere tests
// plus shading; the only ray-sized device-memory traffic is the f32[3,N]
// film write (24.9 MB at 1920x1080), or also the six f32[N] ray inputs
// when rays are passed in.  A lane that has terminated leaves the bounce
// loop at once, which is exact: a dead lane adds nothing.
//
// Rounding: every expression keeps the operation order of the JAX kernel
// and of the plain PyTorch version beside this wrapper
// (rvpt_tpu_torch/ops/pathkernel.py trace_plain).  Build with --fmad=false
// and without fast math: IEEE '/', sqrtf, sinf/cosf; rsqrtf where the JAX
// kernel uses lax.rsqrt.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TRI_STRIDE = 17;  // TRI_FIELDS
constexpr int SPH_STRIDE = 5;   // SPH_FIELDS
constexpr int PLN_STRIDE = 5;   // PLN_FIELDS
constexpr int MAT_STRIDE = 8;   // MAT_FIELDS
constexpr int CAM_LEN = 24;     // camera_params layout
constexpr int CAM_ASPECT = 16, CAM_PROJ = 17, CAM_INV_W = 18, CAM_INV_H = 19;
constexpr int CAM_W = 20;
constexpr int PINHOLE = 0, ORTHO = 1;
constexpr int THREADS = 256;

constexpr float BIG = 3.0e38f;
constexpr float DENOM_EPS = 1e-30f;
constexpr float TWO_PI = (float)6.283185307179586;
constexpr float HALF_TURN = (float)(0.5 * 6.283185307179586);
constexpr float EPSILON = 5e-3f;
// Sky gradient white + (blue - white) * t, the difference taken in double
// and rounded once, as the Python constants are.
constexpr float SKY_R = (float)(0.2 - 1.0);
constexpr float SKY_G = (float)(0.3 - 1.0);
constexpr float SKY_B = (float)(0.7 - 1.0);
constexpr float INV_2_24 = (float)(1.0 / 16777216.0);

__device__ __forceinline__ void pcg3d(uint32_t& x, uint32_t& y, uint32_t& z) {
  x = x * 1664525u + 1013904223u;
  y = y * 1664525u + 1013904223u;
  z = z * 1664525u + 1013904223u;
  x += y * z;
  y += z * x;
  z += x * y;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  x += y * z;
  y += z * x;
  z += x * y;
}

// Top 24 bits -> [0, 1), exact.
__device__ __forceinline__ float unit(uint32_t bits) {
  return (float)(int)(bits >> 8) * INV_2_24;
}

__device__ __forceinline__ float safe_den(float d) {
  return fabsf(d) < DENOM_EPS ? DENOM_EPS : d;
}

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

__global__ void __launch_bounds__(THREADS) path_kernel(
    const float* __restrict__ tables, int n_tri, int n_sph, int n_pln,
    int n_mat, const float* __restrict__ cam_in,
    const int64_t* __restrict__ pix_ids, const float* __restrict__ ox_in,
    const float* __restrict__ oy_in, const float* __restrict__ oz_in,
    const float* __restrict__ dx_in, const float* __restrict__ dy_in,
    const float* __restrict__ dz_in, float* __restrict__ out, int n,
    uint32_t frame, uint32_t salt_base, uint32_t jitter_salt,
    int max_bounces, int standard, int cam_mode, float mint) {
  extern __shared__ float smem[];
  const int n_tab = TRI_STRIDE * n_tri + SPH_STRIDE * n_sph +
                    PLN_STRIDE * n_pln + MAT_STRIDE * n_mat;
  float* cam = smem;
  float* tab = smem + CAM_LEN;
  if (cam_in) {  // null when the rays are passed in
    for (int k = threadIdx.x; k < CAM_LEN; k += blockDim.x) cam[k] = cam_in[k];
  }
  for (int k = threadIdx.x; k < n_tab; k += blockDim.x) tab[k] = tables[k];
  __syncthreads();
  const float* tri = tab;
  const float* sph = tri + TRI_STRIDE * n_tri;
  const float* pln = sph + SPH_STRIDE * n_sph;
  const float* mat = pln + PLN_STRIDE * n_pln;

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
    camera_ray(cam, cam_mode, pix, frame, jitter_salt, ox, oy, oz, dx, dy,
               dz);
  }

  float tr = 1.0f, tg = 1.0f, tb = 1.0f;  // throughput
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;  // emission gathered on the path
  float rr = 0.0f, rg = 0.0f, rb = 0.0f;  // finished radiance
  bool active = true;

  for (int bounce = 0; bounce < max_bounces && active; ++bounce) {
    // ---- closest hit: triangles, spheres, planes; strict '<' keeps the
    // first minimum within and across families.
    float t_best = BIG, wnx = 0.0f, wny = 0.0f, wnz = 0.0f, wmat = 0.0f;
    bool hit = false;
    for (int j = 0; j < n_tri; ++j) {
      const float* T = tri + TRI_STRIDE * j;
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
      if (mint < t && t < t_best && u > 0.0f && v > 0.0f && u + v < 1.0f) {
        t_best = t;
        wnx = nx;
        wny = ny;
        wnz = nz;
        wmat = T[16];
        hit = true;
      }
    }
    for (int j = 0; j < n_sph; ++j) {
      const float* S = sph + SPH_STRIDE * j;
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
      const float tn = (t0 > mint && t0 < t_best) ? t0 : BIG;
      const float tf = (t1 > mint && t1 < t_best) ? t1 : BIG;
      const float ts = (disc > 0.0f && rad > 0.0f) ? fminf(tn, tf) : BIG;
      if (ts < t_best) {
        t_best = ts;
        // unnormalized normal pos - center, as the JAX kernel
        wnx = ox + ts * dx - S[0];
        wny = oy + ts * dy - S[1];
        wnz = oz + ts * dz - S[2];
        wmat = S[4];
        hit = true;
      }
    }
    for (int j = 0; j < n_pln; ++j) {
      const float* P = pln + PLN_STRIDE * j;
      const float nx = P[0], ny = P[1], nz = P[2];
      const float dn = nx * dx + ny * dy + nz * dz;
      const float on = nx * ox + ny * oy + nz * oz;
      const float tp = (P[3] - on) / safe_den(dn);
      const bool pvalid = (nx * nx + ny * ny + nz * nz) > 0.0f;
      if (tp > mint && tp < t_best && pvalid) {
        t_best = tp;
        wnx = nx;
        wny = ny;
        wnz = nz;
        wmat = P[4];
        hit = true;
      }
    }

    // ---- Kajiya shading (_shade / _shade_geom)
    if (!hit) {  // the lane is active here: sky with d.y shifted into [0,1]
      const float st = dy * 0.5f + 0.5f;
      rr = rr + cr + tr * (1.0f + SKY_R * st);
      rg = rg + cg + tg * (1.0f + SKY_G * st);
      rb = rb + cb + tb * (1.0f + SKY_B * st);
      active = false;
      break;
    }
    const int mi = min(max((int)wmat, 0), n_mat - 1);
    const float* M = mat + MAT_STRIDE * mi;
    cr = cr + tr * M[3];
    cg = cg + tg * M[4];
    cb = cb + tb * M[5];

    const float px = ox + t_best * dx;
    const float py = oy + t_best * dy;
    const float pz = oz + t_best * dz;
    const float inv_nl = rsqrtf(fmaxf(wnx * wnx + wny * wny + wnz * wnz, 1e-30f));
    float nX = wnx * inv_nl, nY = wny * inv_nl, nZ = wnz * inv_nl;
    const float inv_dl = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-30f));
    const float iX = dx * inv_dl, iY = dy * inv_dl, iZ = dz * inv_dl;

    const float cos_view = iX * nX + iY * nY + iZ * nZ;
    const bool flipped = cos_view > 0.0f;
    const float cos_in = fabsf(cos_view);
    if (flipped) {
      nX = -nX;
      nY = -nY;
      nZ = -nZ;
    }
    const float ior = M[6];
    const float eta = flipped ? ior : 1.0f / fmaxf(ior, 1e-8f);

    uint32_t ra = pix, rb_ = frame, rc = salt_base + 4u * (uint32_t)bounce;
    pcg3d(ra, rb_, rc);
    const float ru = unit(ra), rv = unit(rb_), rw = unit(rc);

    const float phi = TWO_PI * ru;
    const float cos_t = 1.0f - 2.0f * rv;
    const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
    const float lamX = nX + sin_t * cosf(phi);
    const float lamY = nY + sin_t * sinf(phi);
    const float lamZ = nZ + cos_t;

    const float refX = iX + 2.0f * cos_in * nX;
    const float refY = iY + 2.0f * cos_in * nY;
    const float refZ = iZ + 2.0f * cos_in * nZ;

    const float cos_out_sqr = 1.0f - eta * eta * (1.0f - cos_in * cos_in);
    const float cos_out = sqrtf(fmaxf(0.0f, cos_out_sqr));
    const float r_perp = (eta * cos_in - cos_out) / (eta * cos_in + cos_out);
    const float r_par = (cos_in - eta * cos_out) / (cos_in + eta * cos_out);
    const float f_refl = 0.5f * (r_perp * r_perp + r_par * r_par);
    const bool refl = (cos_out_sqr <= 0.0f) || (rw < f_refl);
    const float k = eta * cos_in - cos_out;

    const float kind = M[7];
    float off, ndx, ndy, ndz;
    if (kind == 0.0f) {  // Lambert
      ndx = lamX;
      ndy = lamY;
      ndz = lamZ;
      off = EPSILON;
    } else if (kind == 1.0f) {  // mirror
      ndx = refX;
      ndy = refY;
      ndz = refZ;
      off = EPSILON;
    } else if (refl) {  // dielectric, reflected
      ndx = refX;
      ndy = refY;
      ndz = refZ;
      off = EPSILON;
    } else {  // dielectric, refracted
      ndx = eta * iX + k * nX;
      ndy = eta * iY + k * nY;
      ndz = eta * iZ + k * nZ;
      off = -EPSILON;
    }
    ox = px + off * nX;
    oy = py + off * nY;
    oz = pz + off * nZ;
    dx = ndx;
    dy = ndy;
    dz = ndz;
    tr = tr * M[0];
    tg = tg * M[1];
    tb = tb * M[2];
  }
  if (standard && active) {
    rr = rr + cr;
    rg = rg + cg;
    rb = rb + cb;
  }
  out[i] = rr;
  out[(int64_t)n + i] = rg;
  out[2 * (int64_t)n + i] = rb;
}

}  // namespace

extern "C" {

// Largest table (in floats) the kernel stages into its default 48 KB of
// shared memory, after the camera vector.
int rvpt_path_max_table_floats() { return 48 * 1024 / 4 - CAM_LEN; }

// Launch on `stream`; returns cudaGetLastError() of the launch.
int rvpt_path_trace(const float* tables, int n_tri, int n_sph, int n_pln,
                    int n_mat, const float* cam, const int64_t* pix_ids,
                    const float* ox, const float* oy, const float* oz,
                    const float* dx, const float* dy, const float* dz,
                    float* out, int n, uint32_t frame,
                    uint32_t salt_base, uint32_t jitter_salt, int max_bounces,
                    int standard, int cam_mode, float mint, void* stream) {
  if (n <= 0) return 0;
  const int n_tab = TRI_STRIDE * n_tri + SPH_STRIDE * n_sph +
                    PLN_STRIDE * n_pln + MAT_STRIDE * n_mat;
  const size_t smem = sizeof(float) * (CAM_LEN + n_tab);
  const int blocks = (n + THREADS - 1) / THREADS;
  path_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      tables, n_tri, n_sph, n_pln, n_mat, cam, pix_ids, ox, oy, oz, dx, dy, dz,
      out, n, frame, salt_base, jitter_salt, max_bounces, standard,
      cam_mode, mint);
  return (int)cudaGetLastError();
}

const char* rvpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
