// Three-float vectors and the row loads of the kernels that mirror the
// integrator's tensor code (connect.cu, shade.cu).
//
// Every kernel is compiled with --fmad=false, so each expression here rounds
// as the PyTorch op it mirrors: a 3-term dot is (x*x' + z*z') + y*y', the
// order in which PyTorch's reduce sums (a * b).sum(-1) over three floats on
// the card (measured on every row alignment, PyTorch 2.11 on the H100).
// Table rows outside [0, M) read as zero, as ops/gather.py:gather_rows does.

#pragma once

#include <math.h>

namespace {

constexpr float kTiny2 = 1e-30f;                // squared-length floor

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 scale(V3 a, float k) {
  return {a.x * k, a.y * k, a.z * k};
}
// origin + t * direction, as o + t[:, None] * d
__device__ __forceinline__ V3 along(V3 o, float t, V3 d) {
  return {o.x + t * d.x, o.y + t * d.y, o.z + t * d.z};
}
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return (a.x * b.x + a.z * b.z) + a.y * b.y;
}
// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
// ops/sampling.py:normalize
__device__ __forceinline__ V3 normalize3(V3 v) {
  const float n = clamp_min(sqrtf(dot3(v, v)), kTiny2);
  return {v.x / n, v.y / n, v.z / n};
}

__device__ __forceinline__ V3 load3(const float* __restrict__ p,
                                    long long row) {
  const float* q = p + 3 * row;
  return {__ldg(q), __ldg(q + 1), __ldg(q + 2)};
}

// Row m of an [M, 3] table, zero outside [0, M) (gather_rows).
__device__ __forceinline__ V3 table_row(const float* __restrict__ t, int m,
                                        int rows) {
  if (m < 0 || m >= rows) return {0.0f, 0.0f, 0.0f};
  return load3(t, m);
}

}  // namespace
