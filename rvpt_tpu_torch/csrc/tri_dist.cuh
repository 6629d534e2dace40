// The squared iq unsigned distance from a point to a triangle
// (distance_functions.glsl:28-61; _tri_dist2 :3518 of
// rvpt_tpu/ops/pathkernel.py), shared by the Hart march kernel
// (hart_kernel.cu, B4) and the big-mesh distance kernel (bigmesh_hart.cu,
// B6).  Rounding: the operation order of the plain version
// (rvpt_tpu_torch/ops/pathkernel.py _tri_dist2); build with --fmad=false
// and without fast math.
#pragma once

#include <cuda_runtime.h>

namespace tri_dist {

__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// sign(dot(cross(e, nor), q))
__device__ __forceinline__ float edge_sign(float ex, float ey, float ez,
                                           float nx, float ny, float nz,
                                           float qx, float qy, float qz) {
  const float cxx = ey * nz - ez * ny;
  const float cyy = ez * nx - ex * nz;
  const float czz = ex * ny - ey * nx;
  return sgn(cxx * qx + cyy * qy + czz * qz);
}

__device__ __forceinline__ float edge_dist(float ex, float ey, float ez,
                                           float qx, float qy, float qz) {
  const float e2 = fmaxf(ex * ex + ey * ey + ez * ez, 1e-20f);
  const float h = fminf(fmaxf((ex * qx + ey * qy + ez * qz) / e2, 0.0f), 1.0f);
  const float rx = ex * h - qx, ry = ey * h - qy, rz = ez * h - qz;
  return rx * rx + ry * ry + rz * rz;
}

// Squared iq unsigned distance from p to the triangle of row V
// (distance_functions.glsl:28-61).
__device__ __forceinline__ float tri_dist2(float px, float py, float pz,
                                           const float* V) {
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
  const float pax = px - ax, pay = py - ay, paz = pz - az;
  const float pbx = px - bx, pby = py - by, pbz = pz - bz;
  const float pcx = px - cx, pcy = py - cy, pcz = pz - cz;
  const bool edge_region =
      edge_sign(bax, bay, baz, nx, ny, nz, pax, pay, paz) +
          edge_sign(cbx, cby, cbz, nx, ny, nz, pbx, pby, pbz) +
          edge_sign(acx, acy, acz, nx, ny, nz, pcx, pcy, pcz) <
      2.0f;
  if (edge_region) {
    return fminf(fminf(edge_dist(bax, bay, baz, pax, pay, paz),
                       edge_dist(cbx, cby, cbz, pbx, pby, pbz)),
                 edge_dist(acx, acy, acz, pcx, pcy, pcz));
  }
  const float dn = nx * pax + ny * pay + nz * paz;
  return dn * dn / fmaxf(nx * nx + ny * ny + nz * nz, 1e-20f);
}

}  // namespace tri_dist
