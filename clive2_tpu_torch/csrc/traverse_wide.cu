// BVH8 (wide) traversal, closest-hit and any-hit.
//
// Replaces the TPU kernel clive2_tpu/ops/traverse_wide.py:_kernel (entry
// intersect_wide, helpers collapse_bvh8 and pack_bvh8).  The plain PyTorch
// version is clive2_tpu_torch/ops/traverse_wide.py:wide_plain.
//
// Tables (clive2_tpu_torch/ops/traverse_wide.py:pack_bvh8):
//   wbox   [W, 8, 6]  f32  each child's AABB, min(3) max(3); +BIG (1e30) in
//                          both corners for an empty slot
//   wchild [W, 8]     i32  child >= 0 is an inner wide node, child < 0 is
//                          leaf row -(child + 1), kEmpty an empty slot;
//                          wide node 0 is the root
//   leaves [L, 8, 10] f32  the gather walk's leaf rows: 8 slots of v0(3)
//                          e1(3) e2(3) tri id(1); tri id -1 marks padding
//
// What bounds it on the H100: memory latency and divergence, as for the
// binary kernel (csrc/traverse_bvh2.cu).  A visit reads one 192-byte box
// record and one 32-byte child record, against 48 bytes per binary node,
// but retires three to four binary levels; each hit leaf child costs a
// dependent 320-byte leaf row.  The tables of the dragon preset (47,758
// triangles: 0.5 MB of wide nodes, 2 MB of leaf rows) sit in L2.
//
// Design: one thread per ray in a grid-stride loop with a per-thread stack
// of (wide node, entry distance).  A visit slab-tests all 8 child boxes
// against the best t (tmin clamped at 0, tmax at the best t, with the
// 1e-30 direction nudge), pushes the hit inner children in child order
// with the nearest (the first of equal entry distances) pushed last, so it
// is popped first, and then runs Möller-Trumbore on each hit leaf child's
// 8 slots in child and slot order.  A slot replaces the best when (t,
// slot) is lexicographically smaller, slot = leaf * 8 + k, so ties resolve
// by slot, independent of visit order.  A popped entry is skipped when its
// entry distance exceeds the best t.  Any-hit stops after the first visit
// that leaves a hit under the cap.  The packer bounds the stack a ray can
// need by kStackSize, so it cannot overflow.
//
// TPU workarounds dropped: the [56, 128] lane tile of child boxes and its
// inner-flag rows, slot-aligned leaf pages with bin packing and child
// reordering, the compact 12-slot page layout, the group_gate, pop2 and
// bits variants, MAX_BLOCKS_PER_CALL launch splitting, and the Morton sort
// of rays.
//
// Rounding: compiled with --fmad=false, in the plain version's expression
// order, so every decision and t, u, v match it exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWide = 8;
constexpr int kLeafSlots = 8;
constexpr int kStackSize = 96;      // ops/traverse_wide.py:STACK_SIZE
constexpr int kEmpty = -2147483647 - 1;   // ops/traverse_wide.py:EMPTY

template <bool kAnyHit>
__global__ void wide_kernel(const float* __restrict__ origin,
                            const float* __restrict__ direction,
                            const uint8_t* __restrict__ active,
                            const float* __restrict__ t_max,
                            long long n_rays,
                            const float* __restrict__ wbox,
                            const int* __restrict__ wchild,
                            const float* __restrict__ leaves,
                            int* __restrict__ out_i,
                            float* __restrict__ out_t,
                            float* __restrict__ out_u,
                            float* __restrict__ out_v) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < n_rays; r += stride) {
    float bt = t_max[r];
    long long bs = -1;                  // best slot, leaf * 8 + k
    int bi = -1;
    float bu = 0.0f, bv = 0.0f;
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

      int stack_ref[kStackSize];
      float stack_t[kStackSize];
      int sp = 0;
      int ref = 0;                      // the root is wide node 0
      while (true) {
        const int* ch = wchild + (long long)kWide * ref;
        const float* bx = wbox + (long long)kWide * 6 * ref;
        int cc[kWide];
        float tc[kWide];
        int best = -1;
        float best_t = INFINITY;
#pragma unroll
        for (int c = 0; c < kWide; ++c) {
          cc[c] = ch[c];
          tc[c] = cc[c] == kEmpty
                      ? INFINITY
                      : box_entry(bx + 6 * c, ox, oy, oz, ix, iy, iz, bt);
          if (cc[c] >= 0 && tc[c] < best_t) {
            best = c;
            best_t = tc[c];
          }
        }
#pragma unroll
        for (int c = 0; c < kWide; ++c) {
          if (cc[c] >= 0 && tc[c] < INFINITY && c != best) {
            stack_ref[sp] = cc[c];
            stack_t[sp] = tc[c];
            ++sp;
          }
        }
        if (best >= 0) {
          stack_ref[sp] = cc[best];
          stack_t[sp] = best_t;
          ++sp;
        }
#pragma unroll
        for (int c = 0; c < kWide; ++c) {
          if (cc[c] >= 0 || tc[c] == INFINITY) continue;
          const long long leaf = -(long long)(cc[c] + 1);
          const float* lf = leaves + leaf * (kLeafSlots * 10);
          for (int k = 0; k < kLeafSlots; ++k) {
            const float* tr = lf + 10 * k;
            const long long slot = leaf * kLeafSlots + k;
            float t, u, v;
            if (moller_trumbore(tr, ox, oy, oz, dx, dy, dz, t, u, v) &&
                tr[9] >= 0.0f && (t < bt || (t == bt && slot < bs))) {
              bt = t;
              bs = slot;
              bi = (int)tr[9];
              bu = u;
              bv = v;
            }
          }
        }
        if (kAnyHit && bs >= 0) break;
        // pop the next entry that can still hold a better hit
        if (!pop_entry(stack_ref, stack_t, sp, bt, ref)) break;
      }
    }
    out_i[r] = bi;
    out_t[r] = bs >= 0 ? bt : INFINITY;
    out_u[r] = bs >= 0 ? bu : 0.0f;
    out_v[r] = bs >= 0 ? bv : 0.0f;
  }
}

}  // namespace

extern "C" int clive2_wide(const float* origin, const float* direction,
                           const uint8_t* active, const float* t_max,
                           long long n_rays, const float* wbox,
                           const int* wchild, const float* leaves,
                           int any_hit, int* out_i, float* out_t,
                           float* out_u, float* out_v, void* stream) {
  // a grid-stride loop: at most 2^20 blocks of 128 threads cover any cast
  long long blocks = (n_rays + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit) {
    wide_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        origin, direction, active, t_max, n_rays, wbox, wchild, leaves,
        out_i, out_t, out_u, out_v);
  } else {
    wide_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        origin, direction, active, t_max, n_rays, wbox, wchild, leaves,
        out_i, out_t, out_u, out_v);
  }
  return (int)cudaGetLastError();
}
