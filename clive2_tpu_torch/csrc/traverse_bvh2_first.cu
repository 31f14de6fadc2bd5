// Binary BVH traversal, closest-hit and any-hit: the first design (one
// thread per ray, a stack in local memory), kept as the "pr1" instance of
// ops/traverse_bvh2.py:intersect_bvh2 for the A/B against the redesigned
// kernel in traverse_bvh2.cu.  Nothing on the main path launches it.
//
// Replaces the TPU kernel clive2_tpu/ops/traverse_pallas2.py:_kernel (entry
// intersect_pallas2, packer pack_bvh2, helpers for_set_bits and
// bit_index16).  The plain PyTorch version is the gather walk,
// clive2_tpu_torch/ops/intersect.py:intersect_bvh_packed.
//
// Tables (clive2_tpu_torch/ops/traverse_bvh2.py:pack_bvh2):
//   nodebox [inner, 12] f32  both children's AABBs: min(3) max(3) of the
//                            left child, then of the right child
//   childs  [inner, 2]  i32  child >= 0 is an inner node id, child < 0 is
//                            leaf -(child + 1); node 0 is the root
//   leaves  [L, 8, 10]  f32  8 slots of v0(3) e1(3) e2(3) tri id(1);
//                            tri id -1 marks a padding slot
//
// What bounds it on the H100: memory latency and divergence, not flops.
// Every step is a dependent 48-byte node load or a 320-byte leaf load, and
// the lanes of a warp walk different nodes once rays decohere.  The scene
// tables of the mid-size scenes (the 6,320-triangle teapots: about 150 KB)
// fit in the 50 MB L2 many times over, so node fetches hit L1/L2.
//
// Design: one thread per ray with a short per-thread stack, which is the
// traversal of the reference renderer's Metal kernel.  A pop tests both
// children's boxes (slab test as in the TPU kernel: tmin clamped at 0, tmax
// clamped at the current best t, with the 1e-30 direction nudge), descends
// into the nearer hit child and pushes the farther one with its entry
// distance; a popped entry is skipped when that distance now exceeds the
// best t.  Leaves run the brute kernel's Möller-Trumbore per slot in slot
// order with a strict-< update.  The any-hit variant returns at the first
// leaf that records a hit under t_max.  The packer bounds the tree depth by
// kStackSize, so the stack cannot overflow.
//
// TPU workarounds dropped: 16 x 128-ray packets sharing one SMEM stack, the
// QUAD=8 batched pops, row gating of the leaf phase with for_set_bits and
// bit_index16, the tri-major [8, 16 * L] leaf layout, MAX_BLOCKS_PER_CALL
// launch splitting for the TPU watchdog, and the Morton sort of rays.
//
// Rounding: compiled with --fmad=false, in the plain version's expression
// order, so box decisions and hits match the gather walk exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStackSize = 64;      // ops/traverse_bvh2.py:STACK_SIZE
constexpr int kLeafSlots = 8;

template <bool kAnyHit>
__global__ void bvh2_kernel(const float* __restrict__ origin,
                            const float* __restrict__ direction,
                            const uint8_t* __restrict__ active,
                            const float* __restrict__ t_max,
                            long long n_rays,
                            const float* __restrict__ nodebox,
                            const int* __restrict__ childs,
                            const float* __restrict__ leaves,
                            int* __restrict__ out_i,
                            float* __restrict__ out_t,
                            float* __restrict__ out_u,
                            float* __restrict__ out_v) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  float bt = t_max[r];
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
    int ref = 0;                        // the root is inner node 0
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
        const float* lf = leaves + (long long)(-(ref + 1)) * (kLeafSlots * 10);
        for (int k = 0; k < kLeafSlots; ++k) {
          const float* tr = lf + 10 * k;
          float t, u, v;
          if (moller_trumbore(tr, ox, oy, oz, dx, dy, dz, t, u, v) &&
              t < bt && tr[9] >= 0.0f) {
            bt = t;
            bi = (int)tr[9];
            bu = u;
            bv = v;
          }
        }
        if (kAnyHit && bi >= 0) break;
      }
      // pop the next entry that can still hold a closer hit
      if (!pop_entry(stack_ref, stack_t, sp, bt, ref)) break;
    }
  }
  out_i[r] = bi;
  out_t[r] = bi >= 0 ? bt : INFINITY;
  out_u[r] = bu;
  out_v[r] = bv;
}

}  // namespace

extern "C" int clive2_bvh2_first(const float* origin,
                               const float* direction,
                               const uint8_t* active, const float* t_max,
                               long long n_rays, const float* nodebox,
                               const int* childs, const float* leaves,
                               int any_hit, int* out_i, float* out_t,
                               float* out_u, float* out_v, void* stream) {
  const long long blocks = (n_rays + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit) {
    bvh2_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        origin, direction, active, t_max, n_rays, nodebox, childs, leaves,
        out_i, out_t, out_u, out_v);
  } else {
    bvh2_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        origin, direction, active, t_max, n_rays, nodebox, childs, leaves,
        out_i, out_t, out_u, out_v);
  }
  return (int)cudaGetLastError();
}
