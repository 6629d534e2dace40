// The shading of a bounce integrator's hit, shared by the whole-path
// kernel (path_kernel.cu, K1) and the big-mesh kernel (bigmesh_kernel.cu,
// B5): _shade_geom (:857) of rvpt_tpu/ops/pathkernel.py, split where
// Whitted's Lambert hit leaves it.  hit_frame gives the hit point, the unit
// normal flipped against the ray and the unit view direction; scatter
// draws the Lambert, mirror or dielectric direction (the stochastic
// Fresnel choice) and the offset origin of the next bounce.  Rounding: the
// operation order of the plain version (_shade_geom_plain); build with
// --fmad=false and without fast math.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "scene_search.cuh"

namespace shade {

using namespace scene;

struct Frame {
  float px, py, pz;  // hit point
  float nX, nY, nZ;  // unit normal, flipped to face the ray
  float iX, iY, iZ;  // unit ray direction
  float cos_in;      // |cos| between the two
  bool flipped;      // the ray arrived from the normal's back side
};

__device__ __forceinline__ Frame hit_frame(const Hit& h, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz) {
  Frame f;
  f.px = ox + h.t * dx;
  f.py = oy + h.t * dy;
  f.pz = oz + h.t * dz;
  const float inv_nl =
      rsqrtf(fmaxf(h.nx * h.nx + h.ny * h.ny + h.nz * h.nz, 1e-30f));
  f.nX = h.nx * inv_nl;
  f.nY = h.ny * inv_nl;
  f.nZ = h.nz * inv_nl;
  const float inv_dl = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-30f));
  f.iX = dx * inv_dl;
  f.iY = dy * inv_dl;
  f.iZ = dz * inv_dl;
  const float cos_view = f.iX * f.nX + f.iY * f.nY + f.iZ * f.nZ;
  f.flipped = cos_view > 0.0f;
  f.cos_in = fabsf(cos_view);
  if (f.flipped) {
    f.nX = -f.nX;
    f.nY = -f.nY;
    f.nZ = -f.nZ;
  }
  return f;
}

// The next ray of a scattering hit with material row M: origin off the
// surface, direction by the material's kind, the random draw
// pcg3d(pix, frame, salt).
__device__ __forceinline__ void scatter(const Frame& f, const float* M,
                                        uint32_t pix, uint32_t frame,
                                        uint32_t salt, float& ox, float& oy,
                                        float& oz, float& dx, float& dy,
                                        float& dz) {
  const float kind = M[7];
  const float ior = M[6];
  const float eta = f.flipped ? ior : 1.0f / fmaxf(ior, 1e-8f);

  uint32_t ra = pix, rb = frame, rc = salt;
  pcg3d(ra, rb, rc);
  const float ru = unit(ra), rv = unit(rb), rw = unit(rc);

  const float phi = TWO_PI * ru;
  const float cos_t = 1.0f - 2.0f * rv;
  const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
  const float lamX = f.nX + sin_t * cosf(phi);
  const float lamY = f.nY + sin_t * sinf(phi);
  const float lamZ = f.nZ + cos_t;

  const float refX = f.iX + 2.0f * f.cos_in * f.nX;
  const float refY = f.iY + 2.0f * f.cos_in * f.nY;
  const float refZ = f.iZ + 2.0f * f.cos_in * f.nZ;

  const float cos_out_sqr = 1.0f - eta * eta * (1.0f - f.cos_in * f.cos_in);
  const float cos_out = sqrtf(fmaxf(0.0f, cos_out_sqr));
  const float r_perp =
      (eta * f.cos_in - cos_out) / (eta * f.cos_in + cos_out);
  const float r_par = (f.cos_in - eta * cos_out) / (f.cos_in + eta * cos_out);
  const float f_refl = 0.5f * (r_perp * r_perp + r_par * r_par);
  const bool refl = (cos_out_sqr <= 0.0f) || (rw < f_refl);
  const float k = eta * f.cos_in - cos_out;

  float off;
  if (kind == 0.0f) {  // Lambert
    dx = lamX;
    dy = lamY;
    dz = lamZ;
    off = EPSILON;
  } else if (kind == 1.0f) {  // mirror
    dx = refX;
    dy = refY;
    dz = refZ;
    off = EPSILON;
  } else if (refl) {  // dielectric, reflected
    dx = refX;
    dy = refY;
    dz = refZ;
    off = EPSILON;
  } else {  // dielectric, refracted
    dx = eta * f.iX + k * f.nX;
    dy = eta * f.iY + k * f.nY;
    dz = eta * f.iZ + k * f.nZ;
    off = -EPSILON;
  }
  ox = f.px + off * f.nX;
  oy = f.py + off * f.nY;
  oz = f.pz + off * f.nZ;
}

}  // namespace shade
