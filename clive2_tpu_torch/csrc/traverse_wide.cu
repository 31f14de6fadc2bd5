// BVH8 (wide) traversal for Hopper, closest-hit and any-hit: persistent warps
// that fetch rays, 256-byte wide-node records and 48-byte triangle rows read
// with 16-byte loads, postponed leaf children, a 96-entry stack split
// between shared and local memory, and the (t, row) tie rule.
//
// Replaces the TPU kernel clive2_tpu/ops/traverse_wide.py:_kernel (:128,
// pallas_call in _traverse_blocks :453; entry intersect_wide, helpers
// collapse_bvh8 and pack_bvh8).  The plain PyTorch version is
// clive2_tpu_torch/ops/traverse_wide.py:wide_plain, which walks the same
// records.
//
// Tables (clive2_tpu_torch/ops/traverse_wide.py:pack_bvh8), 16-byte rows:
//   nodes [W, 64] f32  one 256-byte record per wide node (node 0 is the
//                      root), child-major, 32 bytes per child c:
//                      (lo.x, lo.y, lo.z, ref as int bits), (hi.x, hi.y,
//                      hi.z, 0).  A reference >= 0 is an inner wide node, a
//                      leaf is ~(first << kLeafBits | count): its triangles
//                      are rows first .. first + count - 1 of tris; kNone
//                      marks an empty child, whose box is min = max = +BIG
//                      (1e30).  Empty children come after the others.
//   tris  [R, 12] f32  the BVH2 kernel's triangle rows
//                      (ops/traverse_bvh2.py:triangle_rows): one per real
//                      slot of the gather walk's leaves, in slot order,
//                      v0(3) tri id(1), e1(3) 0, e2(3) 0
//
// What bounds it on the H100: the latency of dependent loads and the
// divergence of the lanes of a warp, as for BVH2 (csrc/traverse_bvh2.cu).
// A visit reads one 256-byte record (two 128-byte lines) and retires three
// to four binary levels; each hit leaf child costs its rows.  The tables of
// the dragon preset (47,758 triangles: 0.7 MB of wide nodes, 2.3 MB of
// triangle rows) sit in L2.  On the dragon's casts a ray takes 3.4x fewer
// steps than BVH2's walk (2.3 visits against 7.8 on the connection cast)
// but 10% more box tests and 11% more triangle tests, 7.6 boxes a visit,
// and a warp's visit runs to its widest lane: with 9 blocks per SM hiding
// the steps' latency, the work decides, and the kernel takes about 5%
// longer than BVH2 on that cast (PERF.md, "Settled A/Bs").
//
// What the design does about it (the first design: one thread per ray in a
// grid-stride loop, a 96-entry stack in local memory, 56 scalar loads per
// visit from a box and a child array, and every hit leaf child's 320-byte
// gather-walk row, padding slots included, tested during the visit):
//  1. Records, child-major: a child is two 16-byte loads, (lo, ref) then
//     (hi, 0), so a visit stops at the first empty child after one load,
//     and a child is tested as soon as its own 32 bytes arrive, with no
//     more than one child's box live in registers.  The axis-interleaved
//     layout (Ylitie et al., HPG 2017: each float4 holds one bound of four
//     children) needs the whole record before any child's test and pays
//     off with quantized 80-byte nodes, which this kernel does not use.  A
//     leaf child names its triangle rows (first, count), so padding slots
//     cost nothing.
//  2. Persistent warps that fetch rays (common.cuh:fetch_ray, kRefill = 8,
//     as traverse_bvh2.cu): a warp does not live as long as its slowest
//     ray, and inactive rays are written as misses when fetched.
//     clive2_wide zeroes the counter on the launch's stream.
//  3. The stack (common.cuh:Stack<kWideStack>): 16 entries per lane in
//     shared memory, one column per lane, the other 80 in local memory.
//     Only inner children are pushed: the packer's bound (stack_bound,
//     sponza's worst case 61) is checked against kWideStack = 96.
//  4. While-while traversal with postponed leaf children: a visit slab-tests
//     the children in order against the best t, keeps the hit ones' entry
//     distances, pushes the hit inner children but the nearest (the first
//     of equal distances) in child order, and goes on to the nearest.  Its
//     hit leaf children are kept as (node << 8 | 8-bit mask), not tested.
//     A lane with one such set walks on while other lanes of its warp still
//     search, until it finds a second set; the warp tests the sets once no
//     lane is searching.  A set's leaf child is slab-tested again against
//     the best t of that moment before its rows are read.  The sets are
//     tested in one loop of one row per step (a lane moves on to its next
//     leaf child, then its second set, when its rows run out), so lanes
//     with unequal leaves do not wait on each other child by child: 3-4%
//     off the dragon's connection cast against nested loops, and 56
//     registers against 64, which lets 9 blocks share an SM
//     (PERF.md, "Settled A/Bs").  The visit stays one unrolled loop over
//     the node's children: a walk of one child per step, which would spare
//     lanes at narrow nodes the wait for wide ones, was 21% slower.
//  5. Ties: a row replaces the best hit when (t, row) is lexicographically
//     smaller.  Rows list the gather walk's real slots in slot order, so
//     this is the (t, slot) rule of traverse_bvh2.cu, whose argument
//     carries over: no box or stack entry whose entry distance equals the
//     best t is culled, so the answer is the lexicographic minimum over
//     every triangle hit under the cap, whatever the visit order.
//  6. Any-hit stops after the first set of leaf children that leaves a hit
//     under the cap, where wide_plain stops: sets are tested in the order
//     the plain walk visits their nodes, and until a hit the best t, so
//     every cull and pop, is the plain walk's (which pushes the nearest
//     child and pops it again at once).
//
// Rounding: compiled with --fmad=false; the slab test and Möller-Trumbore
// are common.cuh's, in the plain version's expression order, so every box
// decision and t, u, v match wide_plain exactly.
//
// TPU workarounds dropped: the [56, 128] lane tile of child boxes and its
// inner-flag rows, slot-aligned leaf pages with bin packing and child
// reordering, the compact 12-slot page layout, the group_gate, pop2 and
// bits variants, MAX_BLOCKS_PER_CALL launch splitting, and the Morton sort
// of rays.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWide = 8;            // children per wide node
constexpr int kLeafBits = 4;        // ops/traverse_bvh2.py:LEAF_BITS
constexpr int kWideStack = 96;      // ops/traverse_wide.py:STACK_SIZE

template <bool kAnyHit>
__global__ void __launch_bounds__(kWalkThreads)
wide_kernel(const float* __restrict__ origin,
            const float* __restrict__ direction,
            const uint8_t* __restrict__ active,
            const float* __restrict__ t_max, long long n_rays,
            const float4* __restrict__ nodes,
            const float4* __restrict__ tris,
            unsigned long long* __restrict__ next_ray,
            int* __restrict__ out_i, float* __restrict__ out_t,
            float* __restrict__ out_u, float* __restrict__ out_v) {
  Stack<kWideStack> st;
  st.sp = 0;

  long long r = 0;          // this lane's ray while has_ray
  bool has_ray = false;
  bool drained = false;     // warp-uniform: no ray is left to fetch
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float ix = 0.0f, iy = 0.0f, iz = 0.0f;
  float bt = 0.0f, bu = 0.0f, bv = 0.0f;
  int bs = -1, bi = -1;     // best row (slot order) and its triangle id
  int ref = kNone;          // the wide node being walked
  unsigned post = 0u;       // postponed leaf children: node << 8 | mask
  unsigned pend = 0u;       // a second set, found while one is postponed

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
      post = 0u;
      pend = 0u;
      st.sp = 0;
      has_ray = true;
    }
    if (!__any_sync(kWarp, has_ray)) {
      if (drained) return;
      continue;
    }

    // ---- walk wide nodes until no lane of the warp searches a leaf ----
    while (true) {
      if (has_ray && ref >= 0 && pend == 0u) {
        const float4* nd = nodes + 2 * kWide * (long long)ref;
        float tc[kWide];
        unsigned inner = 0u, leaves = 0u;
        int best = -1;
        float best_t = INFINITY;
#pragma unroll
        for (int c = 0; c < kWide; ++c) {
          const float4 a = __ldg(nd + 2 * c);
          const int cr = __float_as_int(a.w);
          if (cr == kNone) break;          // empty children come last
          const float4 b = __ldg(nd + 2 * c + 1);
          tc[c] = box_entry(a.x, a.y, a.z, b.x, b.y, b.z, ox, oy, oz, ix, iy,
                            iz, bt);
          if (tc[c] < INFINITY) {
            if (cr >= 0) {
              inner |= 1u << c;
              if (tc[c] < best_t) {
                best = c;
                best_t = tc[c];
              }
            } else {
              leaves |= 1u << c;
            }
          }
        }
        // the other hit inner children in child order, under the nearest
        const unsigned rest = best >= 0 ? inner & ~(1u << best) : 0u;
#pragma unroll
        for (int c = 0; c < kWide; ++c)
          if (rest >> c & 1u) st.push(__float_as_int(__ldg(nd + 2 * c).w),
                                      tc[c]);
        if (leaves) {
          const unsigned set = (unsigned)ref << 8 | leaves;
          if (post == 0u) post = set; else pend = set;
        }
        ref = best >= 0 ? __float_as_int(__ldg(nd + 2 * best).w)
                        : st.pop(bt);
      }
      if (!__any_sync(kWarp, has_ray && ref >= 0 && post == 0u)) break;
    }

    // ---- test the postponed leaf children, one row per step ----
    {
      unsigned mask = post & 0xffu;
      int row = 0, end = 0;
      while (post != 0u) {
        if (row == end) {                // on to the next leaf child
          const float4* nd = nodes + 2 * kWide * (long long)(post >> 8);
          while (mask && row == end) {
            const int c = __ffs(mask) - 1;
            mask &= mask - 1u;
            const float4 a = __ldg(nd + 2 * c);
            const float4 b = __ldg(nd + 2 * c + 1);
            if (box_entry(a.x, a.y, a.z, b.x, b.y, b.z, ox, oy, oz, ix, iy,
                          iz, bt) < INFINITY) {
              const int code = ~__float_as_int(a.w);
              row = code >> kLeafBits;
              end = row + (code & ((1 << kLeafBits) - 1));
            }
          }
          if (row == end) {              // the set is done
            if (kAnyHit && bs >= 0) {
              ref = kNone;
              pend = 0u;
            }
            post = pend;
            pend = 0u;
            mask = post & 0xffu;
            continue;
          }
        }
        const float4 p = __ldg(tris + 3 * (long long)row);
        const float4 q = __ldg(tris + 3 * (long long)row + 1);
        const float4 s = __ldg(tris + 3 * (long long)row + 2);
        float t, u, v;
        if (moller_trumbore(p.x, p.y, p.z, q.x, q.y, q.z, s.x, s.y, s.z, ox,
                            oy, oz, dx, dy, dz, t, u, v) &&
            (t < bt || (t == bt && row < bs))) {
          bt = t;
          bs = row;
          bi = (int)p.w;
          bu = u;
          bv = v;
        }
        ++row;
      }
    }

    // ---- write finished rays ----
    if (has_ray && ref == kNone && post == 0u) {
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
extern "C" int clive2_wide(const float* origin, const float* direction,
                           const uint8_t* active, const float* t_max,
                           long long n_rays, const float* nodes,
                           const float* tris, unsigned long long* next_ray,
                           int any_hit, int* out_i, float* out_t,
                           float* out_u, float* out_v, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* kernel = any_hit ? (const void*)wide_kernel<true>
                               : (const void*)wide_kernel<false>;
  unsigned blocks = 0;
  cudaError_t e = resident_grid(kernel, n_rays, &blocks);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(next_ray, 0, sizeof(*next_ray), s);
  if (e != cudaSuccess) return (int)e;
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  if (any_hit) {
    wide_kernel<true><<<blocks, kWalkThreads, 0, s>>>(
        origin, direction, active, t_max, n_rays, n4, t4, next_ray, out_i,
        out_t, out_u, out_v);
  } else {
    wide_kernel<false><<<blocks, kWalkThreads, 0, s>>>(
        origin, direction, active, t_max, n_rays, n4, t4, next_ray, out_i,
        out_t, out_u, out_v);
  }
  return (int)cudaGetLastError();
}

// What the runtime reports of the kernel (common.cuh:kernel_resources).
extern "C" int clive2_wide_info(int any_hit, int* out) {
  return (int)kernel_resources(any_hit ? (const void*)wide_kernel<true>
                                       : (const void*)wide_kernel<false>,
                               out);
}
