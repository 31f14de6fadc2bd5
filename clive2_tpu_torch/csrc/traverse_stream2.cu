// Fat-leaf traversal for large scenes, closest-hit and any-hit: the
// per-thread walk.  It carries the casts of fewer than QUEUE_MIN rays whole,
// and, from the state the queued traversal saved (csrc/stream2_queue.cu),
// the last rays of each chunk of the larger ones (the tail).
//
// Replaces the TPU kernel clive2_tpu/ops/traverse_stream2.py:_kernel (entry
// intersect_stream2, packer pack_stream2, helper build_rayfeat), with
// csrc/stream2_queue.cu.  The plain PyTorch versions are
// clive2_tpu_torch/ops/traverse_stream2.py:stream2_plain (the whole cast)
// and PlainSteps.tail (the tail).
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
// HBM; coherent rays in a warp share leaves and hit L1/L2.  On the 74.6M
// rays of sponza 1080p's connection cast this kernel takes 2.8x as long as
// the queued traversal (PERF.md), so it runs only where rounds do not pay:
// small casts and a chunk's last few rays, whose long walks it finishes in
// one launch on a side stream while the next chunk's rounds run.
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

#include "stream2.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStackSize = 64;      // ops/traverse_stream2.py:STACK_SIZE

// The per-ray loop from (ref, stack, bt, bc) to the end of the walk: a top
// node steps into the nearer hit child, a fat leaf runs the exact test of
// each of its slots in slot order.
template <bool kAnyHit>
__device__ __forceinline__ void walk_to_end(
    const float* __restrict__ nodebox, const int* __restrict__ childs,
    const float4* __restrict__ feat, const int* __restrict__ fat_start,
    float ox, float oy, float oz, float ix, float iy, float iz,
    const RayFeat& rf, int* stack_ref, float* stack_t, int sp, int ref,
    float& bt, int& bc) {
  while (true) {
    if (ref >= 0) {
      bool push;
      int push_ref;
      float push_t;
      if (node_step(nodebox, childs, ox, oy, oz, ix, iy, iz, bt, ref, push,
                    push_ref, push_t)) {
        if (push) {
          stack_ref[sp] = push_ref;
          stack_t[sp] = push_t;
          ++sp;
        }
        continue;
      }
    } else {
      const int f = -(ref + 1);
      const int s1 = fat_start[f + 1];
      for (int s = fat_start[f]; s < s1; ++s) {
        float t;
        if (slot_test(feat + (long long)kFeatRow * s, rf, t) &&
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
}

// Exact Möller-Trumbore on the winner (the plain version's _mt order) and
// the outputs of one ray.
__device__ __forceinline__ void finish(int bc, const int* __restrict__ slot_tri,
                                       const float* __restrict__ slot_mt,
                                       float ox, float oy, float oz, float dx,
                                       float dy, float dz, long long r,
                                       int* out_i, float* out_t, float* out_u,
                                       float* out_v) {
  float ti = INFINITY, ui = 0.0f, vi = 0.0f;
  int tri = -1;
  if (bc >= 0) {
    moller_trumbore(slot_mt + 9 * (long long)bc, ox, oy, oz, dx, dy, dz, ti,
                    ui, vi);
    tri = slot_tri[bc];
  }
  out_i[r] = tri;
  out_t[r] = ti;
  out_u[r] = ui;
  out_v[r] = vi;
}

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
  float4 q[kRayRow];
  ray_row(origin[3 * r], origin[3 * r + 1], origin[3 * r + 2],
          direction[3 * r], direction[3 * r + 1], direction[3 * r + 2], ctr,
          q);
  int bc = -1;
  if (active[r]) {
    const float cap = t_max[r];
    float bt = cap < kCapClamp ? cap : kCapClamp;
    int stack_ref[kStackSize];
    float stack_t[kStackSize];
    walk_to_end<kAnyHit>(nodebox, childs, feat, fat_start, q[0].x, q[0].y,
                         q[0].z, q[1].z, q[1].w, q[2].x,
                         ray_feat(q[0], q[1], q[2], q[3]), stack_ref,
                         stack_t, 0, 0, bt, bc);
  }
  finish(bc, slot_tri, slot_mt, q[0].x, q[0].y, q[0].z, q[0].w, q[1].x,
         q[1].y, r, out_i, out_t, out_u, out_v);
}

// The tail of the queued traversal (ops/traverse_stream2.py:queued_cast):
// each ray of a chunk resumes from its saved state (after a walk round:
// its ref is the fat leaf it waits at, not yet tested, or kDone), walks to
// the end as stream2_kernel does, and writes its outputs.
template <bool kAnyHit>
__global__ void stream2_tail_kernel(
    long long n, const float4* __restrict__ ray, const float* __restrict__ bt_s,
    const int* __restrict__ bc_s, const int* __restrict__ ref_s,
    const int* __restrict__ sp_s, const int* __restrict__ stack_ref_s,
    const float* __restrict__ stack_t_s, const float* __restrict__ nodebox,
    const int* __restrict__ childs, const float4* __restrict__ feat,
    const int* __restrict__ fat_start, const int* __restrict__ slot_tri,
    const float* __restrict__ slot_mt, int* __restrict__ out_i,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4 q0 = ray[kRayRow * i], q1 = ray[kRayRow * i + 1],
               q2 = ray[kRayRow * i + 2], q3 = ray[kRayRow * i + 3];
  int bc = bc_s[i];
  const int ref = ref_s[i];
  if (ref != kDone) {
    float bt = bt_s[i];
    const int sp = sp_s[i];
    int stack_ref[kStackSize];
    float stack_t[kStackSize];
    for (int k = 0; k < sp; ++k) {
      stack_ref[k] = stack_ref_s[k * n + i];
      stack_t[k] = stack_t_s[k * n + i];
    }
    walk_to_end<kAnyHit>(nodebox, childs, feat, fat_start, q0.x, q0.y, q0.z,
                         q1.z, q1.w, q2.x, ray_feat(q0, q1, q2, q3),
                         stack_ref, stack_t, sp, ref, bt, bc);
  }
  finish(bc, slot_tri, slot_mt, q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, i, out_i,
         out_t, out_u, out_v);
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
  auto kernel = any_hit ? stream2_kernel<true> : stream2_kernel<false>;
  kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      origin, direction, active, t_max, n_rays, nodebox, childs, feat4,
      fat_start, slot_tri, slot_mt, ctr, out_i, out_t, out_u, out_v);
  return (int)cudaGetLastError();
}

extern "C" int clive2_stream2_tail(long long n, const float* ray,
                                   const float* bt, const int* bc,
                                   const int* ref, const int* sp,
                                   const int* stack_ref, const float* stack_t,
                                   const float* nodebox, const int* childs,
                                   const float* feat, const int* fat_start,
                                   const int* slot_tri, const float* slot_mt,
                                   int any_hit, int* out_i, float* out_t,
                                   float* out_u, float* out_v, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  auto kernel =
      any_hit ? stream2_tail_kernel<true> : stream2_tail_kernel<false>;
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      n, reinterpret_cast<const float4*>(ray), bt, bc, ref, sp, stack_ref,
      stack_t, nodebox, childs, reinterpret_cast<const float4*>(feat),
      fat_start, slot_tri, slot_mt, out_i, out_t, out_u, out_v);
  return (int)cudaGetLastError();
}
