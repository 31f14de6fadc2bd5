// Binary BVH traversal for Hopper, closest-hit and any-hit: persistent warps
// that fetch rays, vector-loaded node and triangle records, a stack in
// shared memory, and the (t, slot) tie rule.
//
// Replaces the TPU kernel clive2_tpu/ops/traverse_pallas2.py:_kernel (:144,
// pallas_call in _traverse_blocks :396; entry intersect_pallas2, packer
// pack_bvh2).  The plain PyTorch version is the gather walk,
// clive2_tpu_torch/ops/intersect.py:intersect_bvh_packed.
//
// Tables (clive2_tpu_torch/ops/traverse_bvh2.py:pack_bvh2), 16-byte rows:
//   nodes [inner, 16] f32  one 64-byte record per inner node, read as four
//                          float4: (A.lo.x, A.hi.x, A.lo.y, A.hi.y),
//                          (B.lo.x, B.hi.x, B.lo.y, B.hi.y),
//                          (A.lo.z, A.hi.z, B.lo.z, B.hi.z) for the children
//                          A and B, then the two child references as int
//                          bits and two zeros.  A reference >= 0 is an inner
//                          node (node 0 is the root); a leaf is
//                          ~(first << kLeafBits | count): its triangles are
//                          rows first .. first + count - 1 of tris
//   tris  [rows, 12] f32   one 48-byte row per real slot of the gather
//                          walk's leaves, in slot order: v0(3) tri id(1),
//                          e1(3) 0, e2(3) 0; padding slots have no row
//
// What bounds it on the H100: the latency of dependent loads and the
// divergence of the lanes of a warp, not operations or bytes.  Every step
// is a node record or a leaf's rows that the next step waits for, and rays
// that finish early leave their lanes idle.  The tables of the scenes this
// kernel carries (teapots, 12,656 triangles: under 1 MB) sit in L2; on
// sponza's 1.3M triangles they are larger than the 50 MB L2.
//
// What the design does about it:
//  1. A node visit is four 16-byte loads of one aligned 64-byte record
//     (the first design: 14 scalar loads from two arrays, 48-byte box rows
//     across cache lines); a triangle is three 16-byte loads, and a leaf's
//     (first, count) reference skips its padding slots entirely.
//  2. Persistent warps: the grid is what the card holds resident (SMs x
//     the occupancy the runtime reports).  A warp takes the next rays from
//     a global counter (one atomicAdd by lane 0, broadcast by shuffle)
//     whenever at least kRefill of its lanes are free, so a warp no longer
//     lives as long as its slowest ray, and inactive rays are written as
//     misses when fetched, at no traversal cost.  kRefill = 8 was best or
//     within 3% of the best of 1, 8, 16, 24 and 32 on the BVH2 casts of
//     teapots, the dragons and sponza; 32, waiting for the whole warp, took
//     up to 43% longer, and one lane per ray by its index (no fetch) 33-41%
//     longer on the connection casts.  clive2_bvh2 zeroes the counter on
//     the launch's stream before each launch.  The fetch and the stack are
//     common.cuh's (fetch_ray, Stack), shared with traverse_stream.cu.
//  3. The stack: entry j of a lane lives in shared memory at
//     j * kWalkThreads + lane (no bank conflicts) for j < kSharedStack,
//     deeper entries in a local array that only the deepest paths touch.
//     Capacity kWalkStack matches the packer's depth bound, and a lane's
//     stack holds at most
//     one entry per level above its node, so it cannot overflow.  Entries
//     keep their f32 entry distance: nothing is rounded.
//  4. While-while traversal: a lane walks inner nodes until it finds a
//     leaf, postpones that leaf and walks on while other lanes of its warp
//     still search; the warp tests leaves once no lane is searching.  Node
//     and leaf work no longer alternate between lanes on every step.
//  5. Ties: a row replaces the best hit when (t, row) is lexicographically
//     smaller, so the answer does not depend on visit order or on the fetch
//     schedule.  It equals the gather walk's: (a) the gather walk visits
//     leaves in preorder, leaf ids are assigned in preorder, it keeps the
//     first minimum inside a leaf and replaces across leaves only on a
//     strictly smaller t, so it returns the lexicographic minimum of (t,
//     slot), slot = leaf * 8 + k, over the slots it tests; (b) the compact
//     rows list the real slots in slot order, so row order is slot order;
//     (c) no box or stack entry whose entry distance equals the best t is
//     culled (the slab test keeps tmin <= min(tmax, best t), a popped entry
//     is kept when its distance is <= best t), so a leaf that could hold a
//     tie is always tested.  Hits at exactly t_max are rejected, as there.
//  6. Any-hit stops a ray after the first leaf test that records a hit
//     under its cap.  Both casts walk the nearer child first: on any-hit
//     casts the left child first was slower on every cast measured.
//
// Rounding: compiled with --fmad=false; the slab test and Möller-Trumbore
// are common.cuh's, in the plain version's expression order, so every box
// decision and t, u, v match the gather walk exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kLeafBits = 4;        // ops/traverse_bvh2.py:LEAF_BITS

template <bool kAnyHit>
__global__ void __launch_bounds__(kWalkThreads)
bvh2_kernel(const float* __restrict__ origin,
            const float* __restrict__ direction,
            const uint8_t* __restrict__ active,
            const float* __restrict__ t_max, long long n_rays,
            const float4* __restrict__ nodes,
            const float4* __restrict__ tris,
            unsigned long long* __restrict__ next_ray,
            int* __restrict__ out_i,
            float* __restrict__ out_t, float* __restrict__ out_u,
            float* __restrict__ out_v) {
  Stack<kWalkStack> st;
  st.sp = 0;

  long long r = 0;          // this lane's ray while has_ray
  bool has_ray = false;
  bool drained = false;     // warp-uniform: no ray is left to fetch
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float ix = 0.0f, iy = 0.0f, iz = 0.0f;
  float bt = 0.0f, bu = 0.0f, bv = 0.0f;
  int bs = -1, bi = -1;     // best row (slot order) and its triangle id
  int ref = kNone;          // the node being walked
  int leaf = kNone;         // a postponed leaf

  while (true) {
    if (fetch_ray(has_ray, drained, r, next_ray, n_rays, active, out_i,
                  out_t, out_u, out_v)) {
      ox = origin[3 * r + 0];
      oy = origin[3 * r + 1];
      oz = origin[3 * r + 2];
      dx = direction[3 * r + 0];
      dy = direction[3 * r + 1];
      dz = direction[3 * r + 2];
      ix = safe_inverse(dx);
      iy = safe_inverse(dy);
      iz = safe_inverse(dz);
      bt = t_max[r];
      bs = -1;
      bi = -1;
      bu = 0.0f;
      bv = 0.0f;
      ref = 0;
      leaf = kNone;
      st.sp = 0;
      has_ray = true;
    }
    if (!__any_sync(kWarp, has_ray)) {
      if (drained) return;
      continue;
    }
    // ---- walk inner nodes until no lane of the warp searches a leaf ----
    while (true) {
      if (has_ray && ref >= 0) {
        const float4* nd = nodes + 4 * (long long)ref;
        const float4 xa = __ldg(nd);
        const float4 xb = __ldg(nd + 1);
        const float4 z = __ldg(nd + 2);
        const float4 c = __ldg(nd + 3);
        const float ta = box_entry(xa.x, xa.z, z.x, xa.y, xa.w, z.y, ox, oy,
                                   oz, ix, iy, iz, bt);
        const float tb = box_entry(xb.x, xb.z, z.z, xb.y, xb.w, z.w, ox, oy,
                                   oz, ix, iy, iz, bt);
        const int ca = __float_as_int(c.x);
        const int cb = __float_as_int(c.y);
        const bool ha = ta < INFINITY;
        const bool hb = tb < INFINITY;
        if (ha && hb) {
          const bool a_first = ta <= tb;
          st.push(a_first ? cb : ca, a_first ? tb : ta);
          ref = a_first ? ca : cb;
        } else if (ha || hb) {
          ref = ha ? ca : cb;
        } else {
          ref = st.pop(bt);
        }
        if (is_leaf(ref) && leaf == kNone) {   // postpone the first leaf
          leaf = ref;
          ref = st.pop(bt);
        }
      }
      if (!__any_sync(kWarp, has_ray && ref >= 0 && leaf == kNone)) break;
    }

    // ---- test the postponed leaves ----
    while (leaf != kNone) {
      const int code = ~leaf;
      const int first = code >> kLeafBits;
      const int count = code & ((1 << kLeafBits) - 1);
      const float4* row = tris + 3 * (long long)first;
      for (int k = 0; k < count; ++k) {
        const float4 p = __ldg(row + 3 * k);
        const float4 q = __ldg(row + 3 * k + 1);
        const float4 s = __ldg(row + 3 * k + 2);
        const int slot = first + k;
        float t, u, v;
        if (moller_trumbore(p.x, p.y, p.z, q.x, q.y, q.z, s.x, s.y, s.z, ox,
                            oy, oz, dx, dy, dz, t, u, v) &&
            (t < bt || (t == bt && slot < bs))) {
          bt = t;
          bs = slot;
          bi = (int)p.w;
          bu = u;
          bv = v;
        }
      }
      if (kAnyHit && bs >= 0) {
        ref = kNone;
        leaf = kNone;
      } else if (is_leaf(ref)) {        // a second leaf was found meanwhile
        leaf = ref;
        ref = st.pop(bt);
      } else {
        leaf = kNone;
      }
    }

    // ---- write finished rays ----
    if (has_ray && ref == kNone && leaf == kNone) {
      out_i[r] = bi;
      out_t[r] = bs >= 0 ? bt : INFINITY;
      out_u[r] = bu;
      out_v[r] = bv;
      has_ray = false;
    }
  }
}

}  // namespace

// next_ray: the ray counter, 8 bytes that this call zeroes on `stream`
// before the launch.
extern "C" int clive2_bvh2(const float* origin, const float* direction,
                           const uint8_t* active, const float* t_max,
                           long long n_rays, const float* nodes,
                           const float* tris, unsigned long long* next_ray,
                           int any_hit, int* out_i, float* out_t,
                           float* out_u, float* out_v, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* kernel = any_hit ? (const void*)bvh2_kernel<true>
                               : (const void*)bvh2_kernel<false>;
  unsigned blocks = 0;
  cudaError_t e = resident_grid(kernel, n_rays, &blocks);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(next_ray, 0, sizeof(*next_ray), s);
  if (e != cudaSuccess) return (int)e;
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  if (any_hit) {
    bvh2_kernel<true><<<blocks, kWalkThreads, 0, s>>>(
        origin, direction, active, t_max, n_rays, n4, t4, next_ray, out_i,
        out_t, out_u, out_v);
  } else {
    bvh2_kernel<false><<<blocks, kWalkThreads, 0, s>>>(
        origin, direction, active, t_max, n_rays, n4, t4, next_ray, out_i,
        out_t, out_u, out_v);
  }
  return (int)cudaGetLastError();
}

// What the runtime reports of the kernel (common.cuh:kernel_resources).
extern "C" int clive2_bvh2_info(int any_hit, int* out) {
  return (int)kernel_resources(any_hit ? (const void*)bvh2_kernel<true>
                                       : (const void*)bvh2_kernel<false>,
                               out);
}
