// Device helpers shared by the intersection kernels of this directory.
//
// Every kernel is compiled with --fmad=false, so these expressions round
// exactly as the plain PyTorch versions that mirror them
// (clive2_tpu_torch/ops/intersect.py: safe_inverse, box_entry, _mt).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kDelta = 1e-4f;     // self-hit epsilon (constants.DELTA)

// 1 / d with |d| raised to at least 1e-30, keeping its sign.
__device__ __forceinline__ float safe_inverse(float d) {
  const float tiny = 1e-30f;
  const float x = fabsf(d) < tiny ? (d < 0.0f ? -tiny : tiny) : d;
  return 1.0f / x;
}

// Slab test of one AABB given by its corners; returns the entry distance, or
// +inf when the box is missed or lies beyond bt.
__device__ __forceinline__ float box_entry(float lox, float loy, float loz,
                                           float hix, float hiy, float hiz,
                                           float ox, float oy, float oz,
                                           float ix, float iy, float iz,
                                           float bt) {
  const float t0x = (lox - ox) * ix;
  const float t1x = (hix - ox) * ix;
  const float t0y = (loy - oy) * iy;
  const float t1y = (hiy - oy) * iy;
  const float t0z = (loz - oz) * iz;
  const float t1z = (hiz - oz) * iz;
  const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fmaxf(fminf(t0z, t1z), 0.0f));
  const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fminf(fmaxf(t0z, t1z), bt));
  return tmin <= tmax ? tmin : INFINITY;
}

// The same test of a box row b: min(3) max(3).
__device__ __forceinline__ float box_entry(const float* __restrict__ b,
                                           float ox, float oy, float oz,
                                           float ix, float iy, float iz,
                                           float bt) {
  return box_entry(b[0], b[1], b[2], b[3], b[4], b[5], ox, oy, oz, ix, iy,
                   iz, bt);
}

// Möller-Trumbore of one triangle given by v0, e1, e2: sets t, u, v and
// returns whether the ray hits it (inside the triangle, t past kDelta).
__device__ __forceinline__ bool moller_trumbore(
    float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, float ox, float oy, float oz, float dx,
    float dy, float dz, float& t, float& u, float& v) {
  const float hx = dy * e2z - dz * e2y;
  const float hy = dz * e2x - dx * e2z;
  const float hz = dx * e2y - dy * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const float f = 1.0f / a;
  const float sx = ox - v0x;
  const float sy = oy - v0y;
  const float sz = oz - v0z;
  u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  v = f * (dx * qx + dy * qy + dz * qz);
  t = f * (e2x * qx + e2y * qy + e2z * qz);
  return u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t > kDelta;
}

// The same test of a triangle row tr = v0(3) e1(3) e2(3).
__device__ __forceinline__ bool moller_trumbore(const float* __restrict__ tr,
                                                float ox, float oy, float oz,
                                                float dx, float dy, float dz,
                                                float& t, float& u, float& v) {
  return moller_trumbore(tr[0], tr[1], tr[2], tr[3], tr[4], tr[5], tr[6],
                         tr[7], tr[8], ox, oy, oz, dx, dy, dz, t, u, v);
}

// Pops the topmost stack entry whose entry distance is at most bt into ref,
// dropping the entries above it; returns false when none is left.
__device__ __forceinline__ bool pop_entry(const int* stack_ref,
                                          const float* stack_t, int& sp,
                                          float bt, int& ref) {
  while (sp > 0) {
    --sp;
    if (stack_t[sp] <= bt) {
      ref = stack_ref[sp];
      return true;
    }
  }
  return false;
}

}  // namespace
