// Device helpers shared by the whole-path kernel (path_kernel.cu) and its
// pullback (bwd_kernel.cu): the PCG3D hash, its exact top-24-bit unit
// float, the sign-keeping denominator clamp and the Kajiya constants, as
// rvpt_tpu/ops/pathkernel.py defines them (_pcg3d :266, _unit :284,
// _safe_div :293).
#pragma once

#include <cstdint>

namespace kajiya {

constexpr float DENOM_EPS = 1e-30f;
constexpr float TWO_PI = (float)6.283185307179586;
constexpr float EPSILON = 5e-3f;  // surface offset (compute_pass.comp:9)
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

}  // namespace kajiya
