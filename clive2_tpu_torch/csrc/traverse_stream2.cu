// Fat-leaf traversal for large scenes, closest-hit and any-hit.
//
// Replaces the TPU kernel clive2_tpu/ops/traverse_stream2.py:_kernel (entry
// intersect_stream2, packer pack_stream2, helper build_rayfeat).  The plain
// PyTorch version is clive2_tpu_torch/ops/traverse_stream2.py:stream2_plain.
//
// Tables (clive2_tpu_torch/ops/traverse_stream2.py:pack_stream2):
//   nodebox   [top, 12] f32  both children's AABBs, min(3) max(3) each
//   childs    [top, 2]  i32  child >= 0 is a top node, child < 0 is fat leaf
//                            -(child + 1); node 0 is the root
//   feat      [S, 20]   f32  per slot: the 19 bilinear Möller-Trumbore
//                            coefficients (a 0-2, u_n 3-8, v_n 9-14,
//                            t_n 15-18) and a zero pad
//   fat_start [F + 1]   i32  fat leaf f holds slots fat_start[f]..[f + 1]
//   slot_tri  [S]       i32  global triangle id of each slot
//   slot_mt   [S, 9]    f32  v0 e1 e2 of each slot, original coordinates
//   ctr       [3]       f32  the centre the features are shifted by
//
// What bounds it on the H100: the fat-leaf loop.  Each fat leaf a ray
// enters costs one 80-byte feature row and about 40 flops per triangle (up
// to 128 triangles), against one 48-byte node record per top-tree step.
// The tables of the largest scene (1.31M triangles: about 105 MB of
// feature rows) exceed the 50 MB L2, so incoherent rays read the rows from
// HBM; coherent rays in a warp share leaves and hit L1/L2.
//
// Design: one thread per ray with a short per-thread stack over the f32
// top tree, as in csrc/traverse_bvh2.cu: a step tests both children's
// boxes (slab test with tmin clamped at 0 and tmax at the current best t),
// descends into the nearer hit child and pushes the farther with its entry
// distance; a popped entry is skipped when that distance exceeds the best
// t.  A fat leaf runs the bilinear test of each of its slots in slot order
// from five 16-byte loads per row, in FP32 on the CUDA cores (TF32 tensor
// cores keep 10 mantissa bits, too few for sliver triangles).  A slot
// replaces the best when (t, slot) is lexicographically smaller, so ties
// resolve by slot, independent of visit order.  Any-hit stops after the
// first fat leaf that records a hit under the cap.  The winner's t, u and v
// are then recomputed by plain Möller-Trumbore on its slot_mt row.
//
// TPU workarounds dropped: 4096-ray packets sharing one SMEM stack, bf16
// packed boxes, the HBM->VMEM DMA ring and its chunk masks, the bf16x6
// residual split of both operands for the MXU, the per-(slot, ray)
// accumulators and their fold, padded 128-slot fat leaves, the Morton sort
// of rays and MAX_BLOCKS_PER_CALL launch splitting.
//
// Rounding: compiled with --fmad=false, in the plain version's expression
// order, so every decision and the recovered t, u, v match it exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kCapClamp = 1e30f;  // ops/traverse_stream2.py:CAP_CLAMP
constexpr int kThreads = 128;
constexpr int kStackSize = 64;      // ops/traverse_stream2.py:STACK_SIZE
constexpr int kFeatRow = 5;         // float4s per 20-float feature row

template <bool kAnyHit>
__global__ void stream2_kernel(const float* __restrict__ origin,
                               const float* __restrict__ direction,
                               const uint8_t* __restrict__ active,
                               const float* __restrict__ t_max,
                               long long n_rays,
                               const float* __restrict__ nodebox,
                               const int* __restrict__ childs,
                               const float4* __restrict__ feat,
                               const int* __restrict__ fat_start,
                               const int* __restrict__ slot_tri,
                               const float* __restrict__ slot_mt,
                               const float* __restrict__ ctr,
                               int* __restrict__ out_i,
                               float* __restrict__ out_t,
                               float* __restrict__ out_u,
                               float* __restrict__ out_v) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  int bc = -1;
  float ti = INFINITY, ui = 0.0f, vi = 0.0f;
  int tri = -1;
  if (active[r]) {
    const float ox = origin[3 * r + 0];
    const float oy = origin[3 * r + 1];
    const float oz = origin[3 * r + 2];
    const float dx = direction[3 * r + 0];
    const float dy = direction[3 * r + 1];
    const float dz = direction[3 * r + 2];
    const float ix = safe_inverse(dx);
    const float iy = safe_inverse(dy);
    const float iz = safe_inverse(dz);
    // ray features: shifted origin and its moment m = o' x d
    const float sx = ox - ctr[0];
    const float sy = oy - ctr[1];
    const float sz = oz - ctr[2];
    const float mx = sy * dz - sz * dy;
    const float my = sz * dx - sx * dz;
    const float mz = sx * dy - sy * dx;
    const float cap = t_max[r];
    float bt = cap < kCapClamp ? cap : kCapClamp;

    int stack_ref[kStackSize];
    float stack_t[kStackSize];
    int sp = 0;
    int ref = 0;                        // the root is top node 0
    while (true) {
      if (ref >= 0) {
        const float* nb = nodebox + 12 * (long long)ref;
        const float ta = box_entry(nb, ox, oy, oz, ix, iy, iz, bt);
        const float tb = box_entry(nb + 6, ox, oy, oz, ix, iy, iz, bt);
        const int ca = childs[2 * ref];
        const int cb = childs[2 * ref + 1];
        const bool ha = ta < INFINITY;
        const bool hb = tb < INFINITY;
        if (ha && hb) {
          const bool a_near = ta <= tb;
          stack_ref[sp] = a_near ? cb : ca;
          stack_t[sp] = a_near ? tb : ta;
          ++sp;
          ref = a_near ? ca : cb;
          continue;
        }
        if (ha || hb) {
          ref = ha ? ca : cb;
          continue;
        }
      } else {
        const int f = -(ref + 1);
        const int s1 = fat_start[f + 1];
        for (int s = fat_start[f]; s < s1; ++s) {
          const float4* row = feat + (long long)kFeatRow * s;
          const float4 q0 = row[0], q1 = row[1], q2 = row[2], q3 = row[3],
                       q4 = row[4];
          const float a = q0.x * dx + q0.y * dy + q0.z * dz;
          const float u_n = q0.w * dx + q1.x * dy + q1.y * dz + q1.z * mx +
                            q1.w * my + q2.x * mz;
          const float v_n = q2.y * dx + q2.z * dy + q2.w * dz + q3.x * mx +
                            q3.y * my + q3.z * mz;
          const float t_n = q3.w * sx + q4.x * sy + q4.y * sz + q4.z;
          const float finv = 1.0f / a;
          const float u = u_n * finv;
          const float v = v_n * finv;
          const float t = t_n * finv;
          const float w = 1.0f - u - v;
          if (u >= 0.0f && v >= 0.0f && w >= 0.0f && t > kDelta &&
              (t < bt || (t == bt && s < bc))) {
            bt = t;
            bc = s;
          }
        }
        if (kAnyHit && bc >= 0) break;
      }
      // pop the next entry that can still hold a better hit
      if (!pop_entry(stack_ref, stack_t, sp, bt, ref)) break;
    }

    if (bc >= 0) {
      // exact Möller-Trumbore on the winner (the plain version's _mt order)
      moller_trumbore(slot_mt + 9 * (long long)bc, ox, oy, oz, dx, dy, dz, ti,
                      ui, vi);
      tri = slot_tri[bc];
    }
  }
  out_i[r] = tri;
  out_t[r] = ti;
  out_u[r] = ui;
  out_v[r] = vi;
}

}  // namespace

extern "C" int clive2_stream2(const float* origin, const float* direction,
                              const uint8_t* active, const float* t_max,
                              long long n_rays, const float* nodebox,
                              const int* childs, const float* feat,
                              const int* fat_start, const int* slot_tri,
                              const float* slot_mt, const float* ctr,
                              int any_hit, int* out_i, float* out_t,
                              float* out_u, float* out_v, void* stream) {
  const long long blocks = (n_rays + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  const float4* feat4 = reinterpret_cast<const float4*>(feat);
  if (any_hit) {
    stream2_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        origin, direction, active, t_max, n_rays, nodebox, childs, feat4,
        fat_start, slot_tri, slot_mt, ctr, out_i, out_t, out_u, out_v);
  } else {
    stream2_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        origin, direction, active, t_max, n_rays, nodebox, childs, feat4,
        fat_start, slot_tri, slot_mt, ctr, out_i, out_t, out_u, out_v);
  }
  return (int)cudaGetLastError();
}
