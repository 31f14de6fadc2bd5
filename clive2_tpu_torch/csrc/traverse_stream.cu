// Streaming fat-leaf traversal (stream1), closest-hit and any-hit.
//
// Replaces the TPU kernel clive2_tpu/ops/traverse_stream.py:_kernel (entry
// intersect_stream, packer pack_stream, helpers _cut_mask and
// _pack_minmax).  The plain PyTorch version is
// clive2_tpu_torch/ops/traverse_stream.py:stream_plain.
//
// Tables (clive2_tpu_torch/ops/traverse_stream.py:pack_stream, and the
// gather walk's rows, clive2_tpu_torch/ops/intersect.py:pack_gather_walk):
//   nodebox     [top, 12] f32  both children's AABBs, min(3) max(3) each
//   childs      [top, 2]  i32  child >= 0 is a top node, child < 0 is fat
//                              leaf -(child + 1); node 0 is the root
//   fat_start   [F + 1]   i32  fat leaf f holds sub-leaves
//                              fat_start[f] .. fat_start[f + 1] - 1
//   sub_node    [S]       i32  each sub-leaf's row in node_packed
//   node_packed [n, 8]    f32  min(3) max(3) miss leaf_id of every node
//   leaf_packed [L, 80]   f32  8 slots of v0(3) e1(3) e2(3) tri id(1) per
//                              SAH leaf; tri id -1 marks padding
//
// What bounds it on the H100: the fat-leaf loop.  A fat leaf holds up to
// 16 SAH leaves; each costs a dependent 32-byte node row, then, only when
// its box is hit before the best t, a 320-byte leaf row and 8
// Möller-Trumbore tests.  The sub-leaf boxes cull most of the ~67
// triangles per fat leaf that the stream2 kernel tests.  The tables of the
// largest scene (1.31M triangles: 105 MB of leaf rows, 21 MB of node rows)
// exceed the 50 MB L2, so incoherent rays read leaf rows from HBM.
//
// Design: one thread per ray in a grid-stride loop with a short per-thread
// stack over the f32 top tree, as in csrc/traverse_stream2.cu: a step tests
// both children's boxes (slab test with tmin clamped at 0 and tmax at the
// best t), descends into the nearer hit child and pushes the farther with
// its entry distance; a popped entry is skipped when that distance exceeds
// the best t.  At a fat leaf the thread runs through its sub-leaves in
// preorder, slab-tests each one's own box against the current best t and
// runs Möller-Trumbore on its 8 slots only when that box is hit.  A slot
// replaces the best when (t, slot) is lexicographically smaller, slot =
// leaf * 8 + k, so ties resolve by slot, independent of visit order.
// Any-hit stops after the first fat leaf that leaves a hit under the cap.
// The tables point into the gather walk's rows: no triangle is copied.
//
// TPU workarounds dropped: 4096-ray packets sharing one SMEM stack
// (RAY_ROWS), bf16-packed boxes (_pack_minmax, for the SMEM budget), the
// [16, 128] fat-leaf blocks and their HBM->VMEM DMA ring (NBUF), the three
// vectorised drains (v1/v2/v3), the SMEM-budget loop over blocks_per_leaf,
// MAX_BLOCKS_PER_CALL launch splitting, and the Morton sort of rays.
//
// Rounding: compiled with --fmad=false, in the plain version's expression
// order, so every decision and t, u, v match it exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStackSize = 64;      // ops/traverse_stream.py:STACK_SIZE
constexpr int kLeafSlots = 8;

template <bool kAnyHit>
__global__ void stream_kernel(const float* __restrict__ origin,
                              const float* __restrict__ direction,
                              const uint8_t* __restrict__ active,
                              const float* __restrict__ t_max,
                              long long n_rays,
                              const float* __restrict__ nodebox,
                              const int* __restrict__ childs,
                              const int* __restrict__ fat_start,
                              const int* __restrict__ sub_node,
                              const float* __restrict__ node_packed,
                              const float* __restrict__ leaf_packed,
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
      int ref = 0;                      // the root is top node 0
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
            const float* nd = node_packed + 8 * (long long)sub_node[s];
            if (!(box_entry(nd, ox, oy, oz, ix, iy, iz, bt) < INFINITY))
              continue;
            const long long leaf = (long long)nd[7];
            const float* lf = leaf_packed + leaf * (kLeafSlots * 10);
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
        }
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

extern "C" int clive2_stream(const float* origin, const float* direction,
                             const uint8_t* active, const float* t_max,
                             long long n_rays, const float* nodebox,
                             const int* childs, const int* fat_start,
                             const int* sub_node, const float* node_packed,
                             const float* leaf_packed, int any_hit,
                             int* out_i, float* out_t, float* out_u,
                             float* out_v, void* stream) {
  // a grid-stride loop: at most 2^20 blocks of 128 threads cover any cast
  long long blocks = (n_rays + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit) {
    stream_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        origin, direction, active, t_max, n_rays, nodebox, childs, fat_start,
        sub_node, node_packed, leaf_packed, out_i, out_t, out_u, out_v);
  } else {
    stream_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        origin, direction, active, t_max, n_rays, nodebox, childs, fat_start,
        sub_node, node_packed, leaf_packed, out_i, out_t, out_u, out_v);
  }
  return (int)cudaGetLastError();
}
