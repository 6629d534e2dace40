// Whole-chain Kajiya pullback for Hopper (sm_90a): one thread per ray,
// walking its recorded bounces in reverse.
//
// Replaces the Pallas kernel K2 of rvpt_tpu/ops/pathkernel.py
// (make_bwd_kernel :1346, launched by _bwd_call :1609 from bwd_path
// :1801).  Input: the record of a K1 trace (per bounce the 13 bounce-input
// fields and the (family, index) hit, rec_f[B][13][N], rec_i[B][2][N]),
// the radiance cotangent g[N][3], and the raw scene tables (pack_bwd
// rows).  Output: the cotangents of every ray's origin and direction
// (go, gd [N][3]) and the 24 DIFF_FIELDS table gradients summed over all
// rays, as [T][9] | [S][4] | [P][4] | [M][7] rows.
//
// The JAX kernel rebuilds each bounce's replay f (:1446-1560) and calls
// jax.vjp on it.  CUDA has no vjp, so each line of f has its hand-derived
// reverse below, with JAX's semantics where they matter: a where() sends
// zero to the branch not taken (so untaken branches are skipped); the
// clamped denominator of _safe_div gets no gradient; clip(t, +-1e6) and
// maximum(x, 1e-12 / 1e-30) pass gradient only where they do not clamp;
// the Fresnel choice refl is a stop-gradient; sin_t and cos_t depend only
// on the RNG; eta is ior or 1/max(ior, 1e-8) by the flip; a lane that
// misses at a bounce still sends g to col, thr and d.y through the sky
// term; a dead lane passes its cotangents through unchanged; and the
// standard tail seeds the color cotangent on lanes still active after the
// last bounce (:1375-1382).  The winner lookups are plain row reads; their
// pullback adds the row's gradient into the block's shared-memory sums.
// The TPU mechanism is not carried over: no [8,1024] tiles, no one-hot
// select-sums, no bounce groups or sequential-grid accumulators.
//
// Reduction order and tolerance.  Each block keeps f32 sums of the table
// gradient in shared memory; the grid is persistent (a grid-stride loop
// over rays, the same rounds for every lane of a warp), each block writes
// its sums as one column of partials[n_grad][blocks], and a second kernel
// reduces each row of partials in a fixed tree order.  Within a warp, the
// lanes that add to the same row are grouped after each bounce
// (__match_any_sync on the row's offset; the family's row, then the
// material's) and each group sums its row gradient in a shuffle tree
// (warp_sum.cuh, shared with B7's segment sum); the group's lowest lane
// adds the sums.  Where one copy of the sums per warp fits PRIVATE_BYTES
// (the Cornell box: 158 floats), each warp adds into its own copy with
// plain adds (its groups' rows are distinct) and the block adds the
// copies at the end; a larger table (up to 1,024 triangles) keeps one copy
// per block and shared-memory atomics.  On an H100, on the 1080p Cornell
// record, the warp's copies were about 5% faster than the block's.  Dead
// lanes,
// misses and all-zero gradients take no part.  The result is an
// f32 sum of up to 2M terms per entry in an order that differs from the
// plain version's, so it is held to rtol 1e-3, atol 1e-7; per-ray
// cotangents involve no sum across rays and are held to rtol 1e-4, atol
// 1e-6.
//
// What bounds it on this card: the record read (48 bytes per live
// ray-bounce: o, d, thr, the active flag and the hit, never the gathered
// color; the active flag alone of a dead one) plus arithmetic of the same
// order as K1's shading.  The Cornell box has 12 triangles, 2 spheres and
// 6 materials, so the 32 lanes of a warp mostly hit the same wall with the
// same material: per lane, up to 16 shared-memory atomics per bounce on
// the same few addresses serialised (the parent's design).  The warp's
// row groups turn them into log2(group size) rounds of shuffles and one
// add per group and column.  Tables and sums live in shared memory, up
// to MAX_TRI = 1024 triangles (about 78 KB, past the 48 KB default: the
// launcher raises the dynamic limit); the wrapper refuses larger scenes.
//
// Rounding: build with --fmad=false, IEEE division and sqrtf; rsqrtf where
// the JAX replay uses lax.rsqrt.

#include <cstdint>
#include <cuda_runtime.h>

#include "kajiya_common.cuh"
#include "warp_sum.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RED_THREADS = 256;
// Gradient tables whose copies, one per warp, fit in this many bytes of
// shared memory are summed per warp (the Cornell box: 158 floats, 5 KB);
// larger ones (up to 1,024 triangles) in one copy per block.
constexpr int PRIVATE_BYTES = 48 * 1024;
constexpr int NF = 13;  // record fields per bounce
constexpr int TRI_B = 10, SPH_B = 5, PLN_B = 5, MAT_B = 8;  // table rows
constexpr int TRI_G = 9, SPH_G = 4, PLN_G = 4, MAT_G = 7;   // gradient rows

constexpr float CLIP = 1e6f;
using namespace kajiya;
using warp_sum::FULL;

__device__ __forceinline__ float clip(float x) {
  return fminf(fmaxf(x, -CLIP), CLIP);
}

// clip passes gradient only strictly inside its range.
__device__ __forceinline__ float clip_grad(float x, float g) {
  return (x > -CLIP && x < CLIP) ? g : 0.0f;
}

struct Vec {
  float x, y, z;
};

// Ray state and its cotangent at one bounce.
struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// ---- winner geometry: forward (t, unnormalized normal) and reverse.

__device__ __forceinline__ void tri_fwd(const float* R, const Ray& r, float& t,
                                        Vec& wn) {
  const float e0x = R[3] - R[0], e0y = R[4] - R[1], e0z = R[5] - R[2];
  const float e1x = R[6] - R[0], e1y = R[7] - R[1], e1z = R[8] - R[2];
  wn.x = e0y * e1z - e0z * e1y;
  wn.y = e0z * e1x - e0x * e1z;
  wn.z = e0x * e1y - e0y * e1x;
  const float dn = r.dx * wn.x + r.dy * wn.y + r.dz * wn.z;
  const float num = (R[0] - r.ox) * wn.x + (R[1] - r.oy) * wn.y +
                    (R[2] - r.oz) * wn.z;
  t = clip(num / safe_den(dn));
}

// gt, gwn: cotangents of t and the normal; adds into go/gd and writes the
// row's gradient to v.
__device__ __forceinline__ void tri_bwd(const float* R, const Ray& r, float gt,
                                        Vec gwn, Ray& g, float* v) {
  const float e0x = R[3] - R[0], e0y = R[4] - R[1], e0z = R[5] - R[2];
  const float e1x = R[6] - R[0], e1y = R[7] - R[1], e1z = R[8] - R[2];
  const float nx = e0y * e1z - e0z * e1y;
  const float ny = e0z * e1x - e0x * e1z;
  const float nz = e0x * e1y - e0y * e1x;
  const float dn = r.dx * nx + r.dy * ny + r.dz * nz;
  const float ax = R[0] - r.ox, ay = R[1] - r.oy, az = R[2] - r.oz;
  const float num = ax * nx + ay * ny + az * nz;
  const float den = safe_den(dn);
  const float t_t = num / den;
  const float gnum = clip_grad(t_t, gt) / den;
  const float gdn = fabsf(dn) < DENOM_EPS ? 0.0f : -gnum * t_t;
  // num = (v0 - o).n, dn = d.n
  const float gnx = gwn.x + gnum * ax + gdn * r.dx;
  const float gny = gwn.y + gnum * ay + gdn * r.dy;
  const float gnz = gwn.z + gnum * az + gdn * r.dz;
  g.ox -= gnum * nx;
  g.oy -= gnum * ny;
  g.oz -= gnum * nz;
  g.dx += gdn * nx;
  g.dy += gdn * ny;
  g.dz += gdn * nz;
  // n = e0 x e1
  const float ge0x = gnz * e1y - gny * e1z;
  const float ge0y = gnx * e1z - gnz * e1x;
  const float ge0z = gny * e1x - gnx * e1y;
  const float ge1x = gny * e0z - gnz * e0y;
  const float ge1y = gnz * e0x - gnx * e0z;
  const float ge1z = gnx * e0y - gny * e0x;
  // e0 = v1 - v0, e1 = v2 - v0; v0 also enters num.
  v[0] = gnum * nx - ge0x - ge1x;
  v[1] = gnum * ny - ge0y - ge1y;
  v[2] = gnum * nz - ge0z - ge1z;
  v[3] = ge0x;
  v[4] = ge0y;
  v[5] = ge0z;
  v[6] = ge1x;
  v[7] = ge1y;
  v[8] = ge1z;
}

__device__ __forceinline__ void sph_fwd(const float* R, const Ray& r, float& t,
                                        Vec& wn) {
  const float ocx = r.ox - R[0], ocy = r.oy - R[1], ocz = r.oz - R[2];
  const float dd = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float bh = r.dx * ocx + r.dy * ocy + r.dz * ocz;
  const float ct = ocx * ocx + ocy * ocy + ocz * ocz - R[3] * R[3];
  const float sq = sqrtf(fmaxf(bh * bh - dd * ct, 1e-12f));
  const float dds = safe_den(dd);
  const float t0 = (-bh - sq) / dds;
  const float t1 = (-bh + sq) / dds;
  t = clip(t0 > 0.0f ? t0 : t1);
  wn.x = r.ox + t * r.dx - R[0];
  wn.y = r.oy + t * r.dy - R[1];
  wn.z = r.oz + t * r.dz - R[2];
}

__device__ __forceinline__ void sph_bwd(const float* R, const Ray& r, float gt,
                                        Vec gwn, Ray& g, float* v) {
  const float ocx = r.ox - R[0], ocy = r.oy - R[1], ocz = r.oz - R[2];
  const float dd = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float bh = r.dx * ocx + r.dy * ocy + r.dz * ocz;
  const float rad = R[3];
  const float ct = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  const float raw = bh * bh - dd * ct;
  const float sq = sqrtf(fmaxf(raw, 1e-12f));
  const float dds = safe_den(dd);
  const float t0 = (-bh - sq) / dds;
  const float t1 = (-bh + sq) / dds;
  const bool near = t0 > 0.0f;
  const float ts_raw = near ? t0 : t1;
  const float ts = clip(ts_raw);
  // wn = o + ts d - c
  float gcx = -gwn.x, gcy = -gwn.y, gcz = -gwn.z;
  g.ox += gwn.x;
  g.oy += gwn.y;
  g.oz += gwn.z;
  g.dx += ts * gwn.x;
  g.dy += ts * gwn.y;
  g.dz += ts * gwn.z;
  const float gts = clip_grad(ts_raw, gt + gwn.x * r.dx + gwn.y * r.dy +
                                          gwn.z * r.dz);
  // ts_raw = (-bh -+ sq) / dds
  const float gnum = gts / dds;
  const float gdds = -gnum * ts_raw;
  float gbh = -gnum;
  const float gsq = near ? -gnum : gnum;
  const float graw = raw > 1e-12f ? gsq * (0.5f / sq) : 0.0f;
  // raw = bh bh - dd ct
  gbh += 2.0f * bh * graw;
  float gdd = -graw * ct;
  const float gct = -graw * dd;
  if (fabsf(dd) >= DENOM_EPS) gdd += gdds;
  // ct = oc.oc - r r; bh = d.oc; dd = d.d
  const float gocx = 2.0f * gct * ocx + gbh * r.dx;
  const float gocy = 2.0f * gct * ocy + gbh * r.dy;
  const float gocz = 2.0f * gct * ocz + gbh * r.dz;
  g.dx += gbh * ocx + 2.0f * gdd * r.dx;
  g.dy += gbh * ocy + 2.0f * gdd * r.dy;
  g.dz += gbh * ocz + 2.0f * gdd * r.dz;
  // oc = o - c
  g.ox += gocx;
  g.oy += gocy;
  g.oz += gocz;
  gcx -= gocx;
  gcy -= gocy;
  gcz -= gocz;
  v[0] = gcx;
  v[1] = gcy;
  v[2] = gcz;
  v[3] = -2.0f * gct * rad;
}

__device__ __forceinline__ void pln_fwd(const float* R, const Ray& r, float& t,
                                        Vec& wn) {
  const float dn = r.dx * R[0] + r.dy * R[1] + r.dz * R[2];
  const float on = r.ox * R[0] + r.oy * R[1] + r.oz * R[2];
  t = clip((R[3] - on) / safe_den(dn));
  wn.x = R[0];
  wn.y = R[1];
  wn.z = R[2];
}

__device__ __forceinline__ void pln_bwd(const float* R, const Ray& r, float gt,
                                        Vec gwn, Ray& g, float* v) {
  const float dn = r.dx * R[0] + r.dy * R[1] + r.dz * R[2];
  const float on = r.ox * R[0] + r.oy * R[1] + r.oz * R[2];
  const float den = safe_den(dn);
  const float tp = (R[3] - on) / den;
  const float gnum = clip_grad(tp, gt) / den;
  const float gdn = fabsf(dn) < DENOM_EPS ? 0.0f : -gnum * tp;
  // num = doff - o.n, dn = d.n
  g.ox -= gnum * R[0];
  g.oy -= gnum * R[1];
  g.oz -= gnum * R[2];
  g.dx += gdn * R[0];
  g.dy += gdn * R[1];
  g.dz += gdn * R[2];
  v[0] = gwn.x - gnum * r.ox + gdn * r.dx;
  v[1] = gwn.y - gnum * r.oy + gdn * r.dy;
  v[2] = gwn.z - gnum * r.oz + gdn * r.dz;
  v[3] = gnum;
}

// Add each lane's row gradient v[0..w) into acc[key..key + w) (key -1, or
// a v of zeros, adds nothing): the warp's lanes on one row are summed in a
// shuffle tree over the first nc columns (warp_sum.cuh) and the group's
// lowest lane adds the sums, one add per row and column where each lane
// would have added its own.  Into the warp's own copy (PRIVATE) the adds
// are plain: the groups' rows are distinct and no other warp writes there;
// into the block's copy they are shared-memory atomics.  Every lane of
// the warp calls it.
template <int MAXC, bool PRIVATE>
__device__ __forceinline__ void add_grouped(float* acc, int key, int w, int nc,
                                            float* v, int lane) {
  bool any = false;
#pragma unroll
  for (int k = 0; k < MAXC; ++k) any = any || v[k] != 0.0f;
  if (!any) key = -1;
  if (!__any_sync(FULL, key >= 0)) return;  // the warp adds nothing
  const unsigned peers = __match_any_sync(FULL, key);
  warp_sum::reduce_peers<MAXC>(peers, v, nc, lane);
  if (key >= 0 && __ffs(peers) - 1 == lane) {
#pragma unroll
    for (int k = 0; k < MAXC; ++k) {
      if (k < w && v[k] != 0.0f) {
        if (PRIVATE) {
          acc[key + k] += v[k];
        } else {
          atomicAdd(acc + key + k, v[k]);
        }
      }
    }
  }
}

// The gradient sums: one copy per warp (PRIVATE) or one per block.
__host__ __device__ inline bool private_sums(int n_grad) {
  return (size_t)n_grad * WARPS * sizeof(float) <= (size_t)PRIVATE_BYTES;
}

template <bool PRIVATE>
__global__ void __launch_bounds__(THREADS) bwd_kernel(
    const float* __restrict__ tables, int n_tri, int n_sph, int n_pln,
    int n_mat, const int64_t* __restrict__ pix_ids,
    const float* __restrict__ rec_f, const int32_t* __restrict__ rec_i,
    const float* __restrict__ g, float* __restrict__ go_out,
    float* __restrict__ gd_out, float* __restrict__ partials, int n,
    int n_bounce, uint32_t frame, uint32_t salt_base, int standard) {
  extern __shared__ float smem[];
  const int n_tab = TRI_B * n_tri + SPH_B * n_sph + PLN_B * n_pln +
                    MAT_B * n_mat;
  const int n_grad = TRI_G * n_tri + SPH_G * n_sph + PLN_G * n_pln +
                     MAT_G * n_mat;
  float* tab = smem;
  float* sums = smem + n_tab;  // [WARPS][n_grad] (PRIVATE) or [n_grad]
  const int copies = PRIVATE ? WARPS : 1;
  for (int k = threadIdx.x; k < n_tab; k += blockDim.x) tab[k] = tables[k];
  for (int k = threadIdx.x; k < copies * n_grad; k += blockDim.x) sums[k] = 0.0f;
  __syncthreads();
  // This warp's gradient rows.
  float* gacc = PRIVATE ? sums + (threadIdx.x >> 5) * n_grad : sums;
  const float* tri = tab;
  const float* sph = tri + TRI_B * n_tri;
  const float* pln = sph + SPH_B * n_sph;
  const float* mat = pln + PLN_B * n_pln;
  // Offsets of each family's gradient rows in gacc: a row's offset is its
  // key when the warp groups its lanes.
  const int o_sph = TRI_G * n_tri, o_pln = o_sph + SPH_G * n_sph;
  float* g_mat = gacc + o_pln + PLN_G * n_pln;
  const int lane = threadIdx.x & 31;

  // Every lane of a warp runs the same rounds (a lane past n is not
  // valid), so the warp stays whole for its row groups.
  for (int base = blockIdx.x * blockDim.x; base < n;
       base += gridDim.x * blockDim.x) {
    const int i = base + threadIdx.x;
    const bool valid = i < n;
    auto F = [&](int b, int f) { return rec_f[((int64_t)b * NF + f) * n + i]; };
    auto H = [&](int b, int k) {
      return rec_i[((int64_t)b * 2 + k) * n + i];
    };
    uint32_t pix = 0;
    float grr = 0.0f, grg = 0.0f, grb = 0.0f;
    // Cotangents of the current bounce's outputs: o, d, thr, col.
    Ray c = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float gtr = 0.0f, gtg = 0.0f, gtb = 0.0f;
    float gcr = 0.0f, gcg = 0.0f, gcb = 0.0f;
    if (valid) {
      pix = pix_ids ? (uint32_t)pix_ids[i] : (uint32_t)i;
      grr = g[3 * (int64_t)i];
      grg = g[3 * (int64_t)i + 1];
      grb = g[3 * (int64_t)i + 2];
      const int bl = n_bounce - 1;
      if (standard && F(bl, 12) > 0.0f && H(bl, 0) >= 0) {
        gcr = grr;
        gcg = grg;
        gcb = grb;
      }
    }

    for (int b = n_bounce - 1; b >= 0; --b) {
      // This bounce's table-row gradient (v, to the row at gacc + key) and
      // material-row gradient (mv, to g_mat + mkey); -1: nothing to add.
      float v[TRI_G] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float mv[MAT_G] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      int key = -1, mkey = -1, width = 0;
      auto bounce = [&]() {
        if (!(F(b, 12) > 0.0f)) return;  // dead lane: identity
        const int fam = H(b, 0);
        const float tr = F(b, 6), tg = F(b, 7), tb = F(b, 8);
        if (fam < 0) {
          // Missed here: ra = col + thr (white + sky (d.y/2 + 1/2)).  The
          // outputs o, d, thr, col pass through.
          const float st = F(b, 4) * 0.5f + 0.5f;
          gcr += grr;
          gcg += grg;
          gcb += grb;
          gtr += grr * (1.0f + SKY_R * st);
          gtg += grg * (1.0f + SKY_G * st);
          gtb += grb * (1.0f + SKY_B * st);
          c.dy += 0.5f * (grr * tr * SKY_R + grg * tg * SKY_G + grb * tb * SKY_B);
          return;
        }

        const Ray r = {F(b, 0), F(b, 1), F(b, 2), F(b, 3), F(b, 4), F(b, 5)};
        const int idx = H(b, 1);
        const float* R;
        int mat_id;
        float t;
        Vec wn;
        if (fam == 0) {
          const int row = min(max(idx, 0), n_tri - 1);
          R = tri + TRI_B * row;
          key = TRI_G * row;
          width = TRI_G;
          mat_id = (int)R[9];
          tri_fwd(R, r, t, wn);
        } else if (fam == 1) {
          const int row = min(max(idx, 0), n_sph - 1);
          R = sph + SPH_B * row;
          key = o_sph + SPH_G * row;
          width = SPH_G;
          mat_id = (int)R[4];
          sph_fwd(R, r, t, wn);
        } else {
          const int row = min(max(idx, 0), n_pln - 1);
          R = pln + PLN_B * row;
          key = o_pln + PLN_G * row;
          width = PLN_G;
          mat_id = (int)R[4];
          pln_fwd(R, r, t, wn);
        }
        const int mrow = min(max(mat_id, 0), n_mat - 1);
        const float* M = mat + MAT_B * mrow;

        // ---- forward of the shading (f :1500-1558)
        const float nl2 = wn.x * wn.x + wn.y * wn.y + wn.z * wn.z;
        const float inv_nl = rsqrtf(fmaxf(nl2, 1e-30f));
        const float n0x = wn.x * inv_nl, n0y = wn.y * inv_nl, n0z = wn.z * inv_nl;
        const float dl2 = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
        const float inv_dl = rsqrtf(fmaxf(dl2, 1e-30f));
        const float iX = r.dx * inv_dl, iY = r.dy * inv_dl, iZ = r.dz * inv_dl;
        const float cos_view = iX * n0x + iY * n0y + iZ * n0z;
        const bool flipped = cos_view > 0.0f;
        const float cos_in = fabsf(cos_view);
        const float nX = flipped ? -n0x : n0x;
        const float nY = flipped ? -n0y : n0y;
        const float nZ = flipped ? -n0z : n0z;
        const float ior = M[6];
        const float eta = flipped ? ior : 1.0f / fmaxf(ior, 1e-8f);
        const float kind = M[7];
        const bool is_lam = kind == 0.0f;
        const bool is_mir = kind == 1.0f;
        const float cos_out_sqr = 1.0f - eta * eta * (1.0f - cos_in * cos_in);
        const float cos_out = sqrtf(fmaxf(1e-12f, cos_out_sqr));
        bool refl = false;
        if (!is_lam && !is_mir) {
          uint32_t ra = pix, rb = frame, rc = salt_base + 4u * (uint32_t)b;
          pcg3d(ra, rb, rc);
          const float rw = unit(rc);
          const float r_perp = (eta * cos_in - cos_out) / (eta * cos_in + cos_out);
          const float r_par = (cos_in - eta * cos_out) / (cos_in + eta * cos_out);
          const float f_refl = 0.5f * (r_perp * r_perp + r_par * r_par);
          refl = (cos_out_sqr <= 0.0f) || (rw < f_refl);
        }
        const float off = (is_lam || is_mir || refl) ? EPSILON : -EPSILON;

        // ---- reverse.  Outputs: o2 = p + off n, d2, thr2 = thr alb,
        // col2 = col + thr em.  Their cotangents are c, gt*, gc*.
        mkey = MAT_G * mrow;
        mv[0] = gtr * tr;
        mv[1] = gtg * tg;
        mv[2] = gtb * tb;
        mv[3] = gcr * tr;
        mv[4] = gcg * tg;
        mv[5] = gcb * tb;
        const float ntr = gtr * M[0] + gcr * M[3];
        const float ntg = gtg * M[1] + gcg * M[4];
        const float ntb = gtb * M[2] + gcb * M[5];

        float gnX = off * c.ox, gnY = off * c.oy, gnZ = off * c.oz;
        float giX = 0.0f, giY = 0.0f, giZ = 0.0f;
        float geta = 0.0f, gcos_in = 0.0f;
        bool reflect_dir = false;  // d2 is the mirror direction
        if (is_lam) {
          // lam = n + (sin_t cos phi, sin_t sin phi, cos_t): RNG-only terms
          gnX += c.dx;
          gnY += c.dy;
          gnZ += c.dz;
        } else if (is_mir || refl) {
          reflect_dir = true;
        } else {
          // refracted: eta i + k n, k = eta cos_in - cos_out
          const float k = eta * cos_in - cos_out;
          geta += c.dx * iX + c.dy * iY + c.dz * iZ;
          giX += eta * c.dx;
          giY += eta * c.dy;
          giZ += eta * c.dz;
          const float gk = c.dx * nX + c.dy * nY + c.dz * nZ;
          gnX += k * c.dx;
          gnY += k * c.dy;
          gnZ += k * c.dz;
          geta += gk * cos_in;
          gcos_in += gk * eta;
          if (cos_out_sqr > 1e-12f) {
            // cos_out = sqrt(1 - eta^2 (1 - cos_in^2))
            const float gcs = -gk * (0.5f / cos_out);
            geta -= gcs * (1.0f - cos_in * cos_in) * 2.0f * eta;
            gcos_in += gcs * (eta * eta) * 2.0f * cos_in;
          }
        }
        if (reflect_dir) {  // ref = i + 2 cos_in n
          giX += c.dx;
          giY += c.dy;
          giZ += c.dz;
          gcos_in += 2.0f * (c.dx * nX + c.dy * nY + c.dz * nZ);
          const float s2 = 2.0f * cos_in;
          gnX += s2 * c.dx;
          gnY += s2 * c.dy;
          gnZ += s2 * c.dz;
        }
        float gior;
        if (flipped) {
          gior = geta;
        } else {
          gior = ior > 1e-8f ? -geta / (ior * ior) : 0.0f;
        }
        mv[6] = gior;

        // flip, cos_in = |i.n0|
        float gn0x = flipped ? -gnX : gnX;
        float gn0y = flipped ? -gnY : gnY;
        float gn0z = flipped ? -gnZ : gnZ;
        const float gcv = cos_view > 0.0f ? gcos_in
                          : (cos_view < 0.0f ? -gcos_in : 0.0f);
        giX += gcv * n0x;
        giY += gcv * n0y;
        giZ += gcv * n0z;
        gn0x += gcv * iX;
        gn0y += gcv * iY;
        gn0z += gcv * iZ;

        // p = o + t d; o2 = p + off n
        Ray ng = {c.ox, c.oy, c.oz, t * c.ox, t * c.oy, t * c.oz};
        const float gt = c.ox * r.dx + c.oy * r.dy + c.oz * r.dz;
        // i = d rsqrt(d.d)
        ng.dx += giX * inv_dl;
        ng.dy += giY * inv_dl;
        ng.dz += giZ * inv_dl;
        if (dl2 > 1e-30f) {
          const float ginv = giX * r.dx + giY * r.dy + giZ * r.dz;
          const float gdl2 = ginv * (-0.5f * (inv_dl / dl2));
          ng.dx += 2.0f * gdl2 * r.dx;
          ng.dy += 2.0f * gdl2 * r.dy;
          ng.dz += 2.0f * gdl2 * r.dz;
        }
        // n0 = wn rsqrt(wn.wn)
        Vec gwn = {gn0x * inv_nl, gn0y * inv_nl, gn0z * inv_nl};
        if (nl2 > 1e-30f) {
          const float ginv = gn0x * wn.x + gn0y * wn.y + gn0z * wn.z;
          const float gnl2 = ginv * (-0.5f * (inv_nl / nl2));
          gwn.x += 2.0f * gnl2 * wn.x;
          gwn.y += 2.0f * gnl2 * wn.y;
          gwn.z += 2.0f * gnl2 * wn.z;
        }
        if (fam == 0) {
          tri_bwd(R, r, gt, gwn, ng, v);
        } else if (fam == 1) {
          sph_bwd(R, r, gt, gwn, ng, v);
        } else {
          pln_bwd(R, r, gt, gwn, ng, v);
        }
        c = ng;
        gtr = ntr;
        gtg = ntg;
        gtb = ntb;
        // col2 = col + ...: gcr, gcg, gcb pass through.
      };
      if (valid) bounce();
      // Only the triangle rows use more than 4 columns.
      const int nc = __any_sync(FULL, width == TRI_G) ? TRI_G : SPH_G;
      add_grouped<TRI_G, PRIVATE>(gacc, key, width, nc, v, lane);
      add_grouped<MAT_G, PRIVATE>(g_mat, mkey, MAT_G, MAT_G, mv, lane);
    }
    if (valid) {
      go_out[3 * (int64_t)i] = c.ox;
      go_out[3 * (int64_t)i + 1] = c.oy;
      go_out[3 * (int64_t)i + 2] = c.oz;
      gd_out[3 * (int64_t)i] = c.dx;
      gd_out[3 * (int64_t)i + 1] = c.dy;
      gd_out[3 * (int64_t)i + 2] = c.dz;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_grad; k += blockDim.x) {
    float sum = sums[k];
    for (int w = 1; w < copies; ++w) sum += sums[w * n_grad + k];
    partials[(int64_t)k * gridDim.x + blockIdx.x] = sum;
  }
}

// One block per gradient entry: sum its row of per-block partials in a
// fixed order (strided per thread, then a shared-memory tree).
__global__ void __launch_bounds__(RED_THREADS) table_sum_kernel(
    const float* __restrict__ partials, int n_blocks, float* __restrict__ out) {
  __shared__ float buf[RED_THREADS];
  const float* row = partials + (int64_t)blockIdx.x * n_blocks;
  float acc = 0.0f;
  for (int b = threadIdx.x; b < n_blocks; b += blockDim.x) acc += row[b];
  buf[threadIdx.x] = acc;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) buf[threadIdx.x] += buf[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = buf[0];
}

int grad_count(int n_tri, int n_sph, int n_pln, int n_mat) {
  return TRI_G * n_tri + SPH_G * n_sph + PLN_G * n_pln + MAT_G * n_mat;
}

size_t smem_bytes(int n_tri, int n_sph, int n_pln, int n_mat) {
  const int n_tab = TRI_B * n_tri + SPH_B * n_sph + PLN_B * n_pln +
                    MAT_B * n_mat;
  const int n_grad = grad_count(n_tri, n_sph, n_pln, n_mat);
  const int copies = private_sums(n_grad) ? WARPS : 1;
  return sizeof(float) * (size_t)(n_tab + copies * n_grad);
}

}  // namespace

extern "C" {

// Blocks of the persistent grid for n rays (as many as fit on the card at
// once, at most one per 256 rays); raises the dynamic shared-memory limit
// when the tables need it.  Returns -(CUDA error) on failure.
int rvpt_bwd_blocks(int n, int n_tri, int n_sph, int n_pln, int n_mat) {
  const size_t smem = smem_bytes(n_tri, n_sph, n_pln, n_mat);
  const auto kernel = private_sums(grad_count(n_tri, n_sph, n_pln, n_mat))
                          ? bwd_kernel<true>
                          : bwd_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return -(int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess) {
    return -(int)e;
  }
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, smem)) != cudaSuccess) {
    return -(int)e;
  }
  const int want = (n + THREADS - 1) / THREADS;
  const int fit = sms * (per_sm > 0 ? per_sm : 1);
  return want < 1 ? 1 : (want < fit ? want : fit);
}

// Launch the pullback and the partials' reduction on `stream` with the
// grid from rvpt_bwd_blocks; returns cudaGetLastError() of the launches.
int rvpt_bwd(const float* tables, int n_tri, int n_sph, int n_pln, int n_mat,
             const int64_t* pix_ids, const float* rec_f, const int32_t* rec_i,
             const float* g, float* go, float* gd, float* partials,
             float* gflat, int n, int n_bounce, int blocks, uint32_t frame,
             uint32_t salt_base, int standard, void* stream) {
  const size_t smem = smem_bytes(n_tri, n_sph, n_pln, n_mat);
  const int n_grad = grad_count(n_tri, n_sph, n_pln, n_mat);
  const auto kernel = private_sums(n_grad) ? bwd_kernel<true> : bwd_kernel<false>;
  kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      tables, n_tri, n_sph, n_pln, n_mat, pix_ids, rec_f, rec_i, g, go, gd,
      partials, n, n_bounce, frame, salt_base, standard);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (n_grad > 0) {
    table_sum_kernel<<<n_grad, RED_THREADS, 0, (cudaStream_t)stream>>>(
        partials, blocks, gflat);
  }
  return (int)cudaGetLastError();
}

const char* rvpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
