// Streaming fat-leaf traversal (stream1) for Hopper, closest-hit and
// any-hit: persistent warps that fetch rays, packed top-node, sub-leaf and
// triangle records read with 16-byte loads, a stack split between shared
// and local memory, and the (t, row) tie rule.
//
// Replaces the TPU kernel clive2_tpu/ops/traverse_stream.py:_kernel (entry
// intersect_stream, packer pack_stream, helpers _cut_mask and
// _pack_minmax).  The plain PyTorch version is
// clive2_tpu_torch/ops/traverse_stream.py:stream_plain, which walks the same
// records.
//
// Tables (clive2_tpu_torch/ops/traverse_stream.py:pack_stream), 16-byte
// rows:
//   nodes [top, 16] f32  one 64-byte record per top-tree node, as in
//                        traverse_bvh2.cu: the children's boxes
//                        interleaved, then both child references as int
//                        bits.  A reference >= 0 is a top node (node 0 is
//                        the root); a fat leaf is ~(first << kFatBits |
//                        count): sub-leaf records first .. first + count - 1
//   subs  [S, 8] f32     one 32-byte record per sub-leaf (SAH leaf), in
//                        preorder, contiguous within each fat leaf: box
//                        min(3) max(3), then its first triangle row and row
//                        count as int bits
//   tris  [R, 12] f32    one 48-byte row per real slot of the gather walk's
//                        leaves, in slot order: v0(3) tri id(1), e1(3) 0,
//                        e2(3) 0; padding slots have no row
//
// What bounds it on the H100: the latency of dependent loads and the
// divergence of the lanes of a warp, as for BVH2.  A fat leaf holds up to
// 16 sub-leaves; each costs one 32-byte record and, only when its box is hit
// before the best t, its rows and Möller-Trumbore tests.  On sponza (1.31M
// triangles) the triangle rows (63 MB) exceed the 50 MB L2, so incoherent
// rays read them from HBM.
//
// What the design does about it (the first design: one thread per ray in a
// grid-stride loop, a 64-entry local stack, 14 scalar loads per top node,
// a dependent sub_node -> node_packed row per sub-leaf, then a 320-byte
// leaf row read float by float, padding slots included):
//  1. Records: a top node is four 16-byte loads of one 64-byte record, a
//     sub-leaf two of one 32-byte record that also names its triangle rows
//     (no indirection), a triangle three of one 48-byte row; padding slots
//     are never read.
//  2. Persistent warps that fetch rays (common.cuh:fetch_ray, kRefill = 8,
//     as traverse_bvh2.cu): a warp does not live as long as its slowest
//     ray, and inactive rays are written as misses when fetched.
//     clive2_stream zeroes the counter on the launch's stream.
//  3. The stack (common.cuh:Stack): 16 entries per lane in shared memory,
//     one column per lane, the rest in local memory; kWalkStack matches the
//     packer's enforced top-tree depth bound.
//  4. While-while traversal: a lane walks top nodes until it finds a fat
//     leaf, postpones it and walks on while other lanes still search; the
//     warp scans fat leaves once no lane is searching.
//  5. Ties: a row replaces the best hit when (t, row) is lexicographically
//     smaller.  Rows list the gather walk's real slots in slot order, so
//     this is the (t, slot) rule of traverse_bvh2.cu, whose argument
//     carries over: the answer is the lexicographic minimum over every
//     triangle hit under the cap, because no box or stack entry whose entry
//     distance equals the best t is culled (the sub-leaf and top-node slab
//     tests keep tmin <= min(tmax, best t), a popped entry is kept when its
//     distance is <= best t).  It does not depend on visit order.
//  6. Any-hit keeps the reference's stop: after the first fat leaf that
//     leaves a hit under the cap.  A postponed fat leaf is the one the
//     plain walk reaches next (fat leaves are scanned in the walk's order,
//     and until a hit the best t, so every cull, is the plain walk's), so
//     the stop is at the same fat leaf and any-hit ids equal stream_plain's.
//
// Rounding: compiled with --fmad=false; the slab test and Möller-Trumbore
// are common.cuh's, in the plain version's expression order, so every box
// decision and t, u, v match stream_plain exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kFatBits = 6;         // ops/traverse_stream.py:FAT_BITS

template <bool kAnyHit>
__global__ void __launch_bounds__(kWalkThreads)
stream_kernel(const float* __restrict__ origin,
              const float* __restrict__ direction,
              const uint8_t* __restrict__ active,
              const float* __restrict__ t_max, long long n_rays,
              const float4* __restrict__ nodes,
              const float4* __restrict__ subs,
              const float4* __restrict__ tris,
              unsigned long long* __restrict__ next_ray,
              int* __restrict__ out_i, float* __restrict__ out_t,
              float* __restrict__ out_u, float* __restrict__ out_v) {
  Stack<kWalkStack> st;
  st.sp = 0;

  long long r = 0;          // this lane's ray while has_ray
  bool has_ray = false;
  bool drained = false;     // warp-uniform: no ray is left to fetch
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float ix = 0.0f, iy = 0.0f, iz = 0.0f;
  float bt = 0.0f, bu = 0.0f, bv = 0.0f;
  int bs = -1, bi = -1;     // best row (slot order) and its triangle id
  int ref = kNone;          // the top node being walked
  int fat = kNone;          // a postponed fat leaf

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
      fat = kNone;
      st.sp = 0;
      has_ray = true;
    }
    if (!__any_sync(kWarp, has_ray)) {
      if (drained) return;
      continue;
    }

    // ---- walk top nodes until no lane of the warp searches a fat leaf ----
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
        if (is_leaf(ref) && fat == kNone) {    // postpone the first fat leaf
          fat = ref;
          ref = st.pop(bt);
        }
      }
      if (!__any_sync(kWarp, has_ray && ref >= 0 && fat == kNone)) break;
    }

    // ---- scan the postponed fat leaves ----
    while (fat != kNone) {
      const int code = ~fat;
      const int first_sub = code >> kFatBits;
      const int n_sub = code & ((1 << kFatBits) - 1);
      for (int j = 0; j < n_sub; ++j) {
        const float4* sb = subs + 2 * (long long)(first_sub + j);
        const float4 lo = __ldg(sb);
        const float4 hi = __ldg(sb + 1);
        if (!(box_entry(lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, ox, oy, oz, ix,
                        iy, iz, bt) < INFINITY))
          continue;
        const int first = __float_as_int(hi.z);
        const int count = __float_as_int(hi.w);
        const float4* row = tris + 3 * (long long)first;
        for (int k = 0; k < count; ++k) {
          const float4 p = __ldg(row + 3 * k);
          const float4 q = __ldg(row + 3 * k + 1);
          const float4 s = __ldg(row + 3 * k + 2);
          const int slot = first + k;
          float t, u, v;
          if (moller_trumbore(p.x, p.y, p.z, q.x, q.y, q.z, s.x, s.y, s.z,
                              ox, oy, oz, dx, dy, dz, t, u, v) &&
              (t < bt || (t == bt && slot < bs))) {
            bt = t;
            bs = slot;
            bi = (int)p.w;
            bu = u;
            bv = v;
          }
        }
      }
      if (kAnyHit && bs >= 0) {
        ref = kNone;
        fat = kNone;
      } else if (is_leaf(ref)) {        // a second fat leaf was found
        fat = ref;
        ref = st.pop(bt);
      } else {
        fat = kNone;
      }
    }

    // ---- write finished rays ----
    if (has_ray && ref == kNone && fat == kNone) {
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
extern "C" int clive2_stream(const float* origin, const float* direction,
                             const uint8_t* active, const float* t_max,
                             long long n_rays, const float* nodes,
                             const float* subs, const float* tris,
                             unsigned long long* next_ray, int any_hit,
                             int* out_i, float* out_t, float* out_u,
                             float* out_v, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* kernel = any_hit ? (const void*)stream_kernel<true>
                               : (const void*)stream_kernel<false>;
  unsigned blocks = 0;
  cudaError_t e = resident_grid(kernel, n_rays, &blocks);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(next_ray, 0, sizeof(*next_ray), s);
  if (e != cudaSuccess) return (int)e;
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  const float4* s4 = reinterpret_cast<const float4*>(subs);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  if (any_hit) {
    stream_kernel<true><<<blocks, kWalkThreads, 0, s>>>(
        origin, direction, active, t_max, n_rays, n4, s4, t4, next_ray,
        out_i, out_t, out_u, out_v);
  } else {
    stream_kernel<false><<<blocks, kWalkThreads, 0, s>>>(
        origin, direction, active, t_max, n_rays, n4, s4, t4, next_ray,
        out_i, out_t, out_u, out_v);
  }
  return (int)cudaGetLastError();
}

// What the runtime reports of the kernel (common.cuh:kernel_resources).
extern "C" int clive2_stream_info(int any_hit, int* out) {
  return (int)kernel_resources(any_hit ? (const void*)stream_kernel<true>
                                       : (const void*)stream_kernel<false>,
                               out);
}
