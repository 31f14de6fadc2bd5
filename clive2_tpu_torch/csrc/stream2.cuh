// Device code shared by the fat-leaf kernels: the per-thread walk
// (traverse_stream2.cu) and the queued traversal (stream2_queue.cu).
//
// Tables and their layout: clive2_tpu_torch/ops/traverse_stream2.py
// (pack_stream2).  The queued traversal keeps each ray's state between its
// launches in scratch the wrapper allocates (ops/traverse_stream2.py:
// QueueState):
//   ray       [n, 16]     f32  ox oy oz dx | dy dz ix iy | iz mx my mz |
//                              sx sy sz 0  (origin, direction, inverse
//                              direction, moment m = o' x d, shifted origin
//                              o' = o - ctr)
//   bt, bc    [n]         f32, i32  best t so far (cap clamped) and slot
//   ref       [n]         i32  >= 0 top node, -(f + 1) fat leaf f, kDone
//   sp        [n]         i32  stack depth
//   stack_ref, stack_t [depth, n]  i32, f32  the top-tree stack, one row per
//                              level so that neighbouring rays coalesce
// Every kernel is compiled with --fmad=false, so the sums round as the
// plain version's (ops/traverse_stream2.py: _leaf_best, walk_to_leaf_plain).

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr float kCapClamp = 1e30f;  // ops/traverse_stream2.py:CAP_CLAMP
constexpr int kFeatRow = 5;         // float4s per 20-float feature row
constexpr int kRayRow = 4;          // float4s per 16-float ray state row
constexpr int kDone = INT_MIN;      // ops/traverse_stream2.py:DONE

struct RayFeat {
  float dx, dy, dz, mx, my, mz, sx, sy, sz;
};

// The ray state row of a ray (layout above), from its origin and direction.
__device__ __forceinline__ void ray_row(float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        const float* __restrict__ ctr,
                                        float4* __restrict__ row) {
  const float sx = ox - ctr[0];
  const float sy = oy - ctr[1];
  const float sz = oz - ctr[2];
  row[0] = make_float4(ox, oy, oz, dx);
  row[1] = make_float4(dy, dz, safe_inverse(dx), safe_inverse(dy));
  row[2] = make_float4(safe_inverse(dz), sy * dz - sz * dy, sz * dx - sx * dz,
                       sx * dy - sy * dx);
  row[3] = make_float4(sx, sy, sz, 0.0f);
}

__device__ __forceinline__ RayFeat ray_feat(float4 q0, float4 q1, float4 q2,
                                            float4 q3) {
  return RayFeat{q0.w, q1.x, q1.y, q2.y, q2.z, q2.w, q3.x, q3.y, q3.z};
}

// The exact bilinear test of one slot's feature row: sets t and returns
// whether the slot passes (u, v, 1 - u - v >= 0 and t > kDelta).  The sums
// run in the plain version's order (ops/traverse_stream2.py:_leaf_best).
__device__ __forceinline__ bool slot_test(const float4* row, const RayFeat& r,
                                          float& t) {
  const float4 q0 = row[0], q1 = row[1], q2 = row[2], q3 = row[3],
               q4 = row[4];
  const float a = q0.x * r.dx + q0.y * r.dy + q0.z * r.dz;
  const float u_n = q0.w * r.dx + q1.x * r.dy + q1.y * r.dz + q1.z * r.mx +
                    q1.w * r.my + q2.x * r.mz;
  const float v_n = q2.y * r.dx + q2.z * r.dy + q2.w * r.dz + q3.x * r.mx +
                    q3.y * r.my + q3.z * r.mz;
  const float t_n = q3.w * r.sx + q4.x * r.sy + q4.y * r.sz + q4.z;
  const float finv = 1.0f / a;
  const float u = u_n * finv;
  const float v = v_n * finv;
  t = t_n * finv;
  const float w = 1.0f - u - v;
  return u >= 0.0f && v >= 0.0f && w >= 0.0f && t > kDelta;
}

// One top-tree step at inner node ref: the nearer hit child becomes ref and
// the farther hit child is returned in (push_ref, push_t) with push set;
// returns false when neither child is hit (the caller pops).
__device__ __forceinline__ bool node_step(const float* __restrict__ nodebox,
                                          const int* __restrict__ childs,
                                          float ox, float oy, float oz,
                                          float ix, float iy, float iz,
                                          float bt, int& ref, bool& push,
                                          int& push_ref, float& push_t) {
  const float* nb = nodebox + 12 * (long long)ref;
  const float ta = box_entry(nb, ox, oy, oz, ix, iy, iz, bt);
  const float tb = box_entry(nb + 6, ox, oy, oz, ix, iy, iz, bt);
  const int ca = childs[2 * ref];
  const int cb = childs[2 * ref + 1];
  const bool ha = ta < INFINITY;
  const bool hb = tb < INFINITY;
  push = ha && hb;
  if (push) {
    const bool a_near = ta <= tb;
    push_ref = a_near ? cb : ca;
    push_t = a_near ? tb : ta;
    ref = a_near ? ca : cb;
    return true;
  }
  if (ha || hb) {
    ref = ha ? ca : cb;
    return true;
  }
  return false;
}

}  // namespace
