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
// What bounds it on this card: instructions, not bytes.  Per pixel it
// writes f32[3] and reads an int64 id when given; the full iq distance of
// every triangle at every step is about 155 operations on its common edge
// branch, and the build forbids fused multiply-adds, so each is its own
// instruction.  The design cuts that work in four ways:
//
// 1. Triangle invariants once per launch.  A block stages the triangles
//    (raw [T, 9] vertex rows, pathkernel.HART_FIELDS) into shared memory
//    CHUNK rows at a time, as the closest-hit kernel B8 does, so any count
//    runs; a scene that fits one chunk (the Cornell box, rabbit) is staged
//    once for all 32 steps.  While staging it computes each triangle's
//    point-free terms (the edges, the normal, the three cross(e, nor), the
//    clamped |e|^2 and |nor|^2) with exactly tri_dist2's expressions
//    (tri_dist.cuh, shared with B6, which keeps using it), so inv_dist2
//    returns the same float as tri_dist2 on every input: IEEE division, no
//    reciprocal, no fusion.  A table of several chunks is restaged, and
//    its terms recomputed, at every step: about 100 operations per row
//    from its 36 bytes, where a copy of precomputed 176-byte rows would
//    move five times the bytes through L2.
// 2. An exact skip test.  Before the full distance, a triangle is skipped
//    when a lower bound of the distance that tri_dist2 would compute is
//    past the running minimum: the plane distance dn^2 / |nor|^2 (the face
//    branch's own value, from the same dn) and the distance to a bounding
//    sphere (for small triangles, such as a mesh's), each against the
//    running minimum grown by a margin (SLACK, REL: see `reach` and
//    make_inv).  A skipped triangle's distance is at least the minimum, so
//    the minimum, and every bit of the output, is that of the full sweep.
// 3. A warm seed.  Each step starts from the exact distance to the
//    triangle that gave the previous step's minimum (the point moved by
//    that distance, so the triangle stays near), as B6's march does
//    (bigmesh_hart.cu), which lets the tests skip from the first triangle.
// 4. An escape test, B6's: before each step, a point outside the ball
//    that holds every triangle with ESCAPE_MARGIN (ten MARCH_EPS) to spare,
//    whose ray moves away from the ball's centre, is done.  Its distance
//    to that centre never falls again, so no later step's distance comes
//    within the margin of MARCH_EPS and the march would write MARCH_ITER:
//    the thread writes it now.  Most pixels of a Hart frame (the Cornell
//    box's sides, rabbit's background) never stop, and the steps of those
//    rays were nine tenths of the parent's work.  Each block computes the
//    ball from the triangles' bounding box before its first step.
//
// A thread whose march stopped or escaped does no more distance work; the
// block leaves the loop once all its threads are done, which is why the
// blocks of a one-chunk table are small (128 threads: on an H100, faster
// than 256 on the Cornell frame and the same on rabbit's).  A block that
// stages full chunks holds 90 KB of shared memory, two blocks per SM, so
// there it takes 256 threads (on an H100, a 600-triangle table's frame
// took half again as long in blocks of 128).  The counting
// instance (COUNT) marches on past each escape, as the parent did, and
// also evaluates every triangle it skips.  It writes per pixel
// (HART_COUNTS of pathkernel.py) the march's own live ray-steps, skip
// tests, full distances by branch (face, edge), warm seeds and tests
// decided by the plane alone, up to its stop or escape; the skipped
// triangles whose distance is below the
// running minimum (0 unless the margin fails); the branch of every
// triangle's distance at every step the parent ran, and those steps (the
// parent's full sweep); and 1 where the march stopped after its escape (0
// unless the escape test fails).  Its output is the display instance's.
//
// Rounding: every expression keeps the operation order of the plain
// version (rvpt_tpu_torch/ops/pathkernel.py hart_plain and _tri_dist2).
// Build with --fmad=false and without fast math.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "scene_search.cuh"
#include "tri_dist.cuh"

namespace {

using namespace scene;
using tri_dist::sgn;

// Threads per block: 128 for a table of one chunk, 256 for more (see
// launch); THREADS bounds both.
constexpr int THREADS = 256;
constexpr int THREADS_ONE_CHUNK = 128;
constexpr int HART_STRIDE = 9;  // HART_FIELDS
constexpr int CHUNK = 512;
constexpr int MARCH_ITER = 32;
constexpr float MARCH_EPS = 0.1f;
constexpr float INV_LAST = (float)(1.0 / (MARCH_ITER - 1));
constexpr int NCOUNT = 11;  // rows of the counting instance's output
constexpr float ESCAPE_MARGIN = 1.0f;  // pathkernel.ESCAPE_MARGIN

// The staged form of one triangle: 11 float4s (176 B), read with 16-byte
// shared loads.  r[0] = (a, nor2), r[1] = (nor, plane margin), r[2] =
// (sphere centre, sphere margin), r[3] = (b, |ba|^2), r[4] = (c, |cb|^2),
// r[5] = (ba, |ac|^2), r[6] = cb, r[7] = ac, r[8..10] = cross(e, nor) of
// ba, cb and ac; the squared norms are clamped at 1e-20 as tri_dist2
// clamps them.
constexpr int INV4 = 11;

// Margins of the skip tests, in units of the distance.  The computed
// distance of a triangle can fall below the exact distance of the float
// triangle by rounding: about 10 u (|p| + |v|) for the point and vertex
// differences, dots and the clamped projection (u = 2^-24, |v| the
// vertices' largest L1 norm), and the computed normal can tilt out of the
// triangle's plane by 6 u l^2 / |nor| (l the longest edge), which moves
// the plane bound by that times l.  SLACK = 2^-18 = 64 u charges each of
// these with six times its estimate, REL = 1 + 2^-18 the few relative
// roundings of the squares, sums and the bound's own square root; a
// triangle whose |nor|^2 is below 2e-20 (where tri_dist2 clamps it, and
// its face value no longer bounds anything) is never skipped.  Checked on
// the card by the counting instance and on the CPU by
// tests/test_torch_hart_skip.py.
constexpr float SLACK = 0x1p-18f;
constexpr float REL = 1.0f + 0x1p-18f;

// The point-free terms of tri_dist2 for the vertex row V, in the same
// expressions, and B4's bounds' per-triangle constants.
__device__ __forceinline__ void make_inv(const float* V, float4* r) {
  const float ax = V[0], ay = V[1], az = V[2];
  const float bx = V[3], by = V[4], bz = V[5];
  const float cx = V[6], cy = V[7], cz = V[8];
  const float bax = bx - ax, bay = by - ay, baz = bz - az;
  const float cbx = cx - bx, cby = cy - by, cbz = cz - bz;
  const float acx = ax - cx, acy = ay - cy, acz = az - cz;
  // nor = cross(ba, ac)
  const float nx = bay * acz - baz * acy;
  const float ny = baz * acx - bax * acz;
  const float nz = bax * acy - bay * acx;
  const float raw = nx * nx + ny * ny + nz * nz;
  const float nor2 = fmaxf(raw, 1e-20f);
  const float e2ba = fmaxf(bax * bax + bay * bay + baz * baz, 1e-20f);
  const float e2cb = fmaxf(cbx * cbx + cby * cby + cbz * cbz, 1e-20f);
  const float e2ac = fmaxf(acx * acx + acy * acy + acz * acz, 1e-20f);
  // Margins: the longest edge l, the vertices' largest L1 norm, the
  // normal's tilt; the bounding sphere about the box's midpoint.
  const float l2 = fmaxf(fmaxf(e2ba, e2cb), e2ac);
  const float l = sqrtf(l2);
  const float vt = fmaxf(fmaxf(fabsf(ax) + fabsf(ay) + fabsf(az),
                               fabsf(bx) + fabsf(by) + fabsf(bz)),
                         fabsf(cx) + fabsf(cy) + fabsf(cz));
  const float kpl = raw >= 2e-20f ? SLACK * (l * (1.0f + l2 / sqrtf(raw)) + vt)
                                  : INFINITY;
  const float sx = 0.5f * (fminf(fminf(ax, bx), cx) + fmaxf(fmaxf(ax, bx), cx));
  const float sy = 0.5f * (fminf(fminf(ay, by), cy) + fmaxf(fmaxf(ay, by), cy));
  const float sz = 0.5f * (fminf(fminf(az, bz), cz) + fmaxf(fmaxf(az, bz), cz));
  auto d2 = [&](float x, float y, float z) {
    return (x - sx) * (x - sx) + (y - sy) * (y - sy) + (z - sz) * (z - sz);
  };
  const float rad = sqrtf(fmaxf(fmaxf(d2(ax, ay, az), d2(bx, by, bz)),
                                d2(cx, cy, cz)));
  r[0] = make_float4(ax, ay, az, nor2);
  r[1] = make_float4(nx, ny, nz, kpl);
  r[2] = make_float4(sx, sy, sz, rad * REL + kpl);
  r[3] = make_float4(bx, by, bz, e2ba);
  r[4] = make_float4(cx, cy, cz, e2cb);
  r[5] = make_float4(bax, bay, baz, e2ac);
  r[6] = make_float4(cbx, cby, cbz, 0.0f);
  r[7] = make_float4(acx, acy, acz, 0.0f);
  // cross(e, nor), as tri_dist::edge_sign forms it
  r[8] = make_float4(bay * nz - baz * ny, baz * nx - bax * nz,
                     bax * ny - bay * nx, 0.0f);
  r[9] = make_float4(cby * nz - cbz * ny, cbz * nx - cbx * nz,
                     cbx * ny - cby * nx, 0.0f);
  r[10] = make_float4(acy * nz - acz * ny, acz * nx - acx * nz,
                      acx * ny - acy * nx, 0.0f);
}

// tri_dist::edge_dist with the clamped |e|^2 given.
__device__ __forceinline__ float seg_dist2(const float4 e, float e2, float qx,
                                           float qy, float qz) {
  const float h = fminf(fmaxf((e.x * qx + e.y * qy + e.z * qz) / e2, 0.0f), 1.0f);
  const float rx = e.x * h - qx, ry = e.y * h - qy, rz = e.z * h - qz;
  return rx * rx + ry * ry + rz * rz;
}

// tri_dist2 of the staged triangle r at p, given pa = p - a and dn =
// nor . pa (the skip test's); `edge` says which branch it took.
__device__ __forceinline__ float inv_dist2(const float4* r, float px, float py,
                                           float pz, float pax, float pay,
                                           float paz, float dn, bool& edge) {
  const float4 b = r[3], c = r[4], ba = r[5];
  const float4 xba = r[8], xcb = r[9], xac = r[10];
  const float pbx = px - b.x, pby = py - b.y, pbz = pz - b.z;
  const float pcx = px - c.x, pcy = py - c.y, pcz = pz - c.z;
  edge = sgn(xba.x * pax + xba.y * pay + xba.z * paz) +
             sgn(xcb.x * pbx + xcb.y * pby + xcb.z * pbz) +
             sgn(xac.x * pcx + xac.y * pcy + xac.z * pcz) <
         2.0f;
  if (edge) {
    return fminf(fminf(seg_dist2(ba, b.w, pax, pay, paz),
                       seg_dist2(r[6], c.w, pbx, pby, pbz)),
                 seg_dist2(r[7], ba.w, pcx, pcy, pcz));
  }
  return dn * dn / r[0].w;
}

// pa = p - a and dn = nor . pa of the staged triangle r.
__device__ __forceinline__ float plane_dn(const float4* r, float px, float py,
                                          float pz, float& pax, float& pay,
                                          float& paz) {
  const float4 a = r[0], nor = r[1];
  pax = px - a.x;
  pay = py - a.y;
  paz = pz - a.z;
  return nor.x * pax + nor.y * pay + nor.z * paz;
}

// The running minimum's distance grown by the point's share of the margin:
// a triangle whose bound is past reach + its own margin is skipped.
__device__ __forceinline__ float reach(float best, float px, float py,
                                       float pz) {
  return (sqrtf(best) + SLACK * (fabsf(px) + fabsf(py) + fabsf(pz))) * REL;
}

// Nonzero when triangle r's distance at p cannot be below the running
// minimum (reach `t`): 1 when its plane is too far, else 2 when its
// bounding sphere is.
__device__ __forceinline__ int skip(const float4* r, float px, float py,
                                    float pz, float dn, float t) {
  const float4 a = r[0], nor = r[1];
  const float tp = t + nor.w;
  if (dn * dn > tp * tp * a.w) return 1;
  const float4 s = r[2];
  const float sx = px - s.x, sy = py - s.y, sz = pz - s.z;
  const float ts = t + s.w;
  return sx * sx + sy * sy + sz * sz > ts * ts ? 2 : 0;
}

// The escape ball {cx, cy, cz, r^2} of n_tri vertex rows: the centre of
// their bounding box and its half diagonal grown by ESCAPE_MARGIN and by
// the f32 rounding of the centre and the diagonal.  Every thread of the
// block calls it; a ball of no finite box (no triangles) is never left.
__device__ void escape_ball(const float* __restrict__ vtx, int n_tri,
                            float* ball) {
  __shared__ float part[THREADS / 32][6];
  float b[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int k = threadIdx.x; k < 3 * n_tri; k += blockDim.x) {
    for (int q = 0; q < 3; ++q) {
      const float x = vtx[3 * (int64_t)k + q];
      b[q] = fminf(b[q], x);
      b[3 + q] = fmaxf(b[3 + q], x);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    for (int q = 0; q < 3; ++q) {
      b[q] = fminf(b[q], __shfl_xor_sync(0xffffffffu, b[q], off));
      b[3 + q] = fmaxf(b[3 + q], __shfl_xor_sync(0xffffffffu, b[3 + q], off));
    }
  }
  if ((threadIdx.x & 31) == 0) {
    for (int q = 0; q < 6; ++q) part[threadIdx.x >> 5][q] = b[q];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x + 31) / 32; ++w) {
      for (int q = 0; q < 3; ++q) {
        b[q] = fminf(b[q], part[w][q]);
        b[3 + q] = fmaxf(b[3 + q], part[w][3 + q]);
      }
    }
    const float cx = 0.5f * (b[0] + b[3]), cy = 0.5f * (b[1] + b[4]),
                cz = 0.5f * (b[2] + b[5]);
    const float ex = b[3] - b[0], ey = b[4] - b[1], ez = b[5] - b[2];
    const float r = 0.5f * sqrtf(ex * ex + ey * ey + ez * ez);
    const float m = fmaxf(fmaxf(fabsf(cx), fabsf(cy)), fabsf(cz));
    const float rr = r * REL + ESCAPE_MARGIN + SLACK * (m + r);
    ball[0] = cx;
    ball[1] = cy;
    ball[2] = cz;
    ball[3] = rr * rr;
  }
  __syncthreads();
}

template <bool COUNT>
__global__ void __launch_bounds__(THREADS) hart_kernel(
    const float* __restrict__ vtx, int n_tri, const float* __restrict__ cam_in,
    const int64_t* __restrict__ pix_ids, float* __restrict__ out,
    int32_t* __restrict__ counts, int n, uint32_t frame, uint32_t jitter_salt,
    int cam_mode, float mint) {
  __shared__ float cam[CAM_LEN];
  __shared__ float ball[4];
  extern __shared__ float4 tab[];  // [min(n_tri, CHUNK)][INV4]
  for (int k = threadIdx.x; k < CAM_LEN; k += blockDim.x) cam[k] = cam_in[k];
  escape_ball(vtx, n_tri, ball);
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
  bool escaped = false;
  int near = -1;      // the triangle of the previous step's minimum
  // HART_COUNTS: steps, tests, face, edge, seeds, bad, all_face, all_edge,
  // parent_steps, late, plane_skips; steps, tests, face, edge, seeds and
  // plane_skips count the march's own work.
  int c[NCOUNT] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  const int n_chunks = (n_tri + CHUNK - 1) / CHUNK;
  for (int step = 0; step < MARCH_ITER; ++step) {
    if (!done && !escaped) {
      const float vx = px - ball[0], vy = py - ball[1], vz = pz - ball[2];
      escaped = vx * dx + vy * dy + vz * dz >= 0.0f &&
                vx * vx + vy * vy + vz * vz >= ball[3];
      if (escaped && !COUNT) done = true;  // iters stays MARCH_ITER
    }
    if (!__syncthreads_or(!done)) break;  // every thread of the block is done
    const bool own = COUNT && !escaped;   // the march's own work, counted
    float best = BIG;
    int cur = -1;
    if (!done) {
      if constexpr (COUNT) {
        c[0] += own;
        ++c[8];
      }
      if (near >= 0) {  // warm seed
        float4 row[INV4];
        const float4* r = tab + INV4 * near;
        if (n_chunks > 1) {  // the seed's chunk is not staged: its own row
          make_inv(vtx + (int64_t)HART_STRIDE * near, row);
          r = row;
        }
        float pax, pay, paz;
        const float dn = plane_dn(r, px, py, pz, pax, pay, paz);
        bool edge;
        best = inv_dist2(r, px, py, pz, pax, pay, paz, dn, edge);
        cur = near;
        if constexpr (COUNT) {
          c[4] += own;
          c[edge ? 3 : 2] += own;
          ++c[edge ? 7 : 6];
        }
      }
    }
    float t = reach(best, px, py, pz);
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int base = ch * CHUNK;
      const int cnt = min(CHUNK, n_tri - base);
      if (n_chunks > 1 || step == 0) {  // one chunk stays staged
        __syncthreads();  // the previous chunk is done with the table
        for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
          float4 r[INV4];
          make_inv(vtx + (int64_t)HART_STRIDE * (base + k), r);
#pragma unroll
          for (int q = 0; q < INV4; ++q) tab[INV4 * k + q] = r[q];
        }
        __syncthreads();
      }
      if (done) continue;
      for (int j = 0; j < cnt; ++j) {
        if (base + j == near) continue;  // the seed
        const float4* r = tab + INV4 * j;
        float pax, pay, paz;
        const float dn = plane_dn(r, px, py, pz, pax, pay, paz);
        if constexpr (COUNT) c[1] += own;
        if (const int why = skip(r, px, py, pz, dn, t)) {
          if constexpr (COUNT) {
            c[10] += own && why == 1;
            bool edge;
            const float d2 = inv_dist2(r, px, py, pz, pax, pay, paz, dn, edge);
            c[5] += d2 < best;
            ++c[edge ? 7 : 6];
          }
          continue;
        }
        bool edge;
        const float d2 = inv_dist2(r, px, py, pz, pax, pay, paz, dn, edge);
        if constexpr (COUNT) {
          c[edge ? 3 : 2] += own;
          ++c[edge ? 7 : 6];
        }
        if (d2 < best) {
          best = d2;
          cur = base + j;
          t = reach(best, px, py, pz);
        }
      }
    }
    if (done) continue;
    near = cur;
    const float dist = sqrtf(best);
    if (dist < MARCH_EPS) {
      if (!escaped) iters = step;
      if constexpr (COUNT) c[9] = escaped;  // a stop past the escape
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
    if constexpr (COUNT) {
      for (int k = 0; k < NCOUNT; ++k) counts[(int64_t)k * n + i] = c[k];
    }
  }
}

template <bool COUNT>
int launch(const float* vtx, int n_tri, const float* cam,
           const int64_t* pix_ids, float* out, int32_t* counts, int n,
           uint32_t frame, uint32_t jitter_salt, int cam_mode, float mint,
           void* stream) {
  if (n <= 0) return 0;
  const int rows = n_tri < CHUNK ? n_tri : CHUNK;
  const int smem = rows * INV4 * (int)sizeof(float4);
  cudaError_t e = cudaFuncSetAttribute(
      hart_kernel<COUNT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = n_tri > CHUNK ? THREADS : THREADS_ONE_CHUNK;
  const int blocks = (n + threads - 1) / threads;
  hart_kernel<COUNT><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      vtx, n_tri, cam, pix_ids, out, counts, n, frame, jitter_salt, cam_mode,
      mint);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() of the launch.  `vtx` may
// be null when n_tri is 0.
int rvpt_hart(const float* vtx, int n_tri, const float* cam,
              const int64_t* pix_ids, float* out, int n, uint32_t frame,
              uint32_t jitter_salt, int cam_mode, float mint, void* stream) {
  return launch<false>(vtx, n_tri, cam, pix_ids, out, nullptr, n, frame,
                       jitter_salt, cam_mode, mint, stream);
}

// The counting instance: as rvpt_hart, and int32 counts[8][n] (see the
// note at the top).
int rvpt_hart_count(const float* vtx, int n_tri, const float* cam,
                    const int64_t* pix_ids, float* out, int32_t* counts, int n,
                    uint32_t frame, uint32_t jitter_salt, int cam_mode,
                    float mint, void* stream) {
  return launch<true>(vtx, n_tri, cam, pix_ids, out, counts, n, frame,
                      jitter_salt, cam_mode, mint, stream);
}

const char* rvpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
