// The packet walk of the JAX package's traversal tools for Hopper: every ray
// of a packet shares one stack, the walk counts its work per packet, and it
// returns each ray's best t and triangle id.
//
// Replaces the TPU kernels scripts/kernel_stats.py:_count_kernel (:31,
// pallas_call in packet_stats :213), the counting walk, and
// scripts/kernel_microbench.py:make_kernel (:38, pallas_call in run_variant
// :220), the same walk in five ablated variants.  The plain PyTorch version
// and the variants' definitions are in
// clive2_tpu_torch/ops/packet_walk.py (packet_walk_plain, VARIANTS).
//
// Tables: the BVH2 kernel's (traverse_bvh2.cu's note): 64-byte node records
// with both children's boxes and references, and 48-byte triangle rows
// v0(3) id e1(3) 0 e2(3) 0, a leaf being ~(first << kLeafBits | count).
//
// Design, the simple one: a packet of kPacket rays is kPacket threads, one
// ray each.  At 1,024 rays (the TPU's packet, groups of 128) a packet is a
// block; at 32 (one warp, one group) a block holds kWarpPackets packets, one
// per warp, so that the SMs fill.  A packet's stack and the rows of the leaf
// it tests sit in shared memory.  Each step every thread reads the popped
// node record (one broadcast 64-byte record), tests both child boxes for
// its ray, and the packet reduces: "some ray hits" with __syncthreads_or or
// __any_sync, the packet's least entry distance with a shuffle min in each
// warp and a pass over the warps' minima.  Every thread then holds the same
// verdicts and keeps the same stack pointer; one thread writes the pushes.
// A leaf child some ray hits is tested at once: the packet copies its <= 8
// rows into shared memory, and each group of kGroup rays runs
// Möller-Trumbore on them when some ray of the group hit the leaf box (one
// __any_sync per warp, or one flag per warp combined over the group's
// warps), or always (nogroupskip).
//
// Its order is fixed by the packet: the pops, pushes and leaf tests are
// decided from the packet's verdicts alone, which do not depend on how the
// threads are scheduled, so each packet's counts, t and ids are a function
// of its rays, as on the TPU, and equal the plain version's.  A ray's best
// t changes only inside its own leaf tests, and the box test culls at that
// t itself (not common.cuh:cull_bound), as the TPU kernels do.
//
// What bounds it on the H100: the latency of the packet's serial steps, not
// operations or bytes.  A step is a dependent node load, a block-wide
// reduction or two and a barrier, for every ray of the packet, hit or not;
// the 1,024-ray packet pays 32 warps' barrier per step, the 32-ray packet a
// warp's shuffles.  Rays that left the packet's union keep their lanes busy
// (the packet walk's inherent cost, which the TPU paid as well).
//
// Rounding: compiled with --fmad=false; the slab test and Möller-Trumbore
// follow the plain version's expression order, so every box verdict, t and
// id match it exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kStack = 128;        // ops/packet_walk.py:STACK
constexpr int kLeafRows = 8;       // ops/traverse_bvh2.py:LEAF_SLOTS
constexpr int kLeafBits = 4;       // ops/traverse_bvh2.py:LEAF_BITS
constexpr int kWarpPackets = 8;    // 32-ray packets per block

enum LeafMode { kSkip = 0, kAlways = 1, kNoLeaf = 2 };
enum OrderMode { kNear = 0, kFixed = 1, kAnyHit = 2 };

// The scripts' slab test (kernel_stats.py:47-62): whether the ray enters the
// box before leaving it and before bt, and its entry distance.
__device__ __forceinline__ bool packet_box(float lox, float loy, float loz,
                                           float hix, float hiy, float hiz,
                                           float ox, float oy, float oz,
                                           float ix, float iy, float iz,
                                           float bt, float& entry) {
  const float t0x = (lox - ox) * ix;
  const float t1x = (hix - ox) * ix;
  const float t0y = (loy - oy) * iy;
  const float t1y = (hiy - oy) * iy;
  const float t0z = (loz - oz) * iz;
  const float t1z = (hiz - oz) * iz;
  entry = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                fmaxf(fminf(t0z, t1z), 0.0f));
  const float leave = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                            fminf(fmaxf(t0z, t1z), bt));
  return entry <= leave;
}

__device__ __forceinline__ float warp_min(float x) {
  for (int s = 16; s > 0; s >>= 1)
    x = fminf(x, __shfl_xor_sync(kWarp, x, s));
  return x;
}

// What a packet of kPacket threads shares: its stack, the rows of the leaf
// it tests, and (1,024-ray packets) the warps' minima and group flags.
template <int kPacket>
struct PacketShared {
  static constexpr int kWarps = kPacket / 32;
  int stack[kStack];
  float4 rows[kLeafRows * 3];
  float min_a[kWarps];
  float min_b[kWarps];
  int flag[kWarps];
};

template <int kPacket>
__device__ __forceinline__ void packet_sync() {
  if (kPacket == 32) __syncwarp(); else __syncthreads();
}

template <int kPacket>
__device__ __forceinline__ bool packet_any(bool x) {
  return kPacket == 32 ? __any_sync(kWarp, x) : __syncthreads_or(x) != 0;
}

// The packet's least value of a and of b.  The barriers order the reads of
// the shared minima against their next writes.
template <int kPacket>
__device__ __forceinline__ void packet_min(PacketShared<kPacket>& sh,
                                           float& a, float& b) {
  a = warp_min(a);
  b = warp_min(b);
  if (kPacket == 32) return;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sh.min_a[warp] = a;
    sh.min_b[warp] = b;
  }
  __syncthreads();
  a = sh.min_a[0];
  b = sh.min_b[0];
  for (int w = 1; w < PacketShared<kPacket>::kWarps; ++w) {
    a = fminf(a, sh.min_a[w]);
    b = fminf(b, sh.min_b[w]);
  }
  __syncthreads();
}

// One leaf (ref, a leaf code) against the packet: the rays of each group
// where some ray hit the box (kSkip) or of every group (kAlways) test its
// triangles; a ray takes the least t under its best t (hit must hold), the
// largest id among hits at exactly that t.  Returns the groups tested.
template <int kPacket, int kGroup, int kLeaf>
__device__ __forceinline__ int leaf_test(PacketShared<kPacket>& sh, int lane,
                                         int ref, bool hit,
                                         const float4* __restrict__ tris,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float& bt, int& bi) {
  const int code = ~ref;
  const int first = code >> kLeafBits;
  const int count = code & ((1 << kLeafBits) - 1);
  static_assert(kPacket == 32 ? kGroup == 32
                                : kGroup % 32 == 0 && kPacket % kGroup == 0,
                "a 32-ray packet is one group; larger groups are whole warps");
  packet_sync<kPacket>();            // the last rows and flags were read
  if (lane < 3 * count)
    sh.rows[lane] = __ldg(tris + 3 * (long long)first + lane);
  const bool warp_hit = __any_sync(kWarp, hit);
  if (kPacket > 32 && (lane & 31) == 0) sh.flag[lane >> 5] = warp_hit;
  packet_sync<kPacket>();            // the rows and flags are visible
  bool go = true;
  int tested = kPacket / kGroup;
  if (kLeaf == kSkip && kPacket == 32) {
    go = warp_hit;                   // one group: the warp
    tested = go;
  } else if (kLeaf == kSkip) {       // a group's flag: any of its warps'
    constexpr int kGroupWarps = kGroup / 32;
    tested = 0;
    for (int g = 0; g < kPacket / kGroup; ++g) {
      bool any = false;
      for (int w = 0; w < kGroupWarps; ++w)
        any = any || sh.flag[g * kGroupWarps + w];
      tested += any;
      if (g == lane / kGroup) go = any;
    }
  }
  if (go) {
    float best = INFINITY;
    int best_id = -1;
    for (int k = 0; k < count; ++k) {
      const float4 p = sh.rows[3 * k];
      const float4 q = sh.rows[3 * k + 1];
      const float4 s = sh.rows[3 * k + 2];
      float t, u, v;
      const bool geo = moller_trumbore(p.x, p.y, p.z, q.x, q.y, q.z, s.x,
                                       s.y, s.z, ox, oy, oz, dx, dy, dz, t,
                                       u, v);
      if (geo && t < bt && hit) {
        const int id = (int)p.w;
        if (t < best) {
          best = t;
          best_id = id;
        } else if (t == best && id > best_id) {
          best_id = id;
        }
      }
    }
    if (best < bt) {
      bt = best;
      bi = best_id;
    }
  }
  return tested;
}

template <int kPacket, int kGroup, int kLeaf, int kOrder, bool kCount>
__global__ void __launch_bounds__(kPacket == 32 ? 32 * kWarpPackets : kPacket)
packet_walk_kernel(const float* __restrict__ origin,
                   const float* __restrict__ direction,
                   const uint8_t* __restrict__ active,
                   const float* __restrict__ t_max, long long n_rays,
                   long long n_packets, const float4* __restrict__ nodes,
                   const float4* __restrict__ tris, float* __restrict__ out_t,
                   int* __restrict__ out_i, int* __restrict__ out_counts) {
  constexpr int kPerBlock = kPacket == 32 ? kWarpPackets : 1;
  __shared__ PacketShared<kPacket> shared[kPerBlock];
  const int lane = threadIdx.x % kPacket;
  const long long packet =
      (long long)blockIdx.x * kPerBlock + threadIdx.x / kPacket;
  if (packet >= n_packets) return;   // a whole warp (32) or block (1,024)
  PacketShared<kPacket>& sh = shared[threadIdx.x / kPacket];

  // the ray, or a padding ray past the end: inactive, at the origin, along
  // +x, capped at 0, as the scripts pad
  const long long r = packet * kPacket + lane;
  const bool in = r < n_rays;
  const float ox = in ? origin[3 * r + 0] : 0.0f;
  const float oy = in ? origin[3 * r + 1] : 0.0f;
  const float oz = in ? origin[3 * r + 2] : 0.0f;
  const float dx = in ? direction[3 * r + 0] : 1.0f;
  const float dy = in ? direction[3 * r + 1] : 0.0f;
  const float dz = in ? direction[3 * r + 2] : 0.0f;
  const bool act = in && active[r];
  const float ix = safe_inverse(dx);
  const float iy = safe_inverse(dy);
  const float iz = safe_inverse(dz);
  float bt = in ? t_max[r] : 0.0f;
  int bi = -1;

  int pops = 0, leaves = 0, groups = 0;
  int sp = 1;
  if (lane == 0) sh.stack[0] = 0;
  packet_sync<kPacket>();
  while (sp > 0) {
    const int node = sh.stack[--sp];
    packet_sync<kPacket>();          // read before the pushes overwrite it
    ++pops;
    const float4* nd = nodes + 4 * (long long)node;
    const float4 xa = __ldg(nd);
    const float4 xb = __ldg(nd + 1);
    const float4 z = __ldg(nd + 2);
    const float4 c = __ldg(nd + 3);
    float ta, tb;
    const bool ha = packet_box(xa.x, xa.z, z.x, xa.y, xa.w, z.y, ox, oy, oz,
                               ix, iy, iz, bt, ta) && act;
    const bool hb = packet_box(xb.x, xb.z, z.z, xb.y, xb.w, z.w, ox, oy, oz,
                               ix, iy, iz, bt, tb) && act;
    bool any_a, any_b, a_top = true;
    if (kOrder == kAnyHit) {
      any_a = packet_any<kPacket>(ha);
      any_b = packet_any<kPacket>(hb);
    } else {
      float near_a = ha ? ta : INFINITY;
      float near_b = hb ? tb : INFINITY;
      packet_min<kPacket>(sh, near_a, near_b);
      any_a = near_a < INFINITY;
      any_b = near_b < INFINITY;
      if (kOrder == kNear) a_top = near_a <= near_b;
    }
    const int ca = __float_as_int(c.x);
    const int cb = __float_as_int(c.y);
    const bool push_a = any_a && ca >= 0;
    const bool push_b = any_b && cb >= 0;
    if (lane == 0) {
      if (push_a && push_b) {
        sh.stack[sp] = a_top ? cb : ca;
        sh.stack[sp + 1] = a_top ? ca : cb;
      } else if (push_a || push_b) {
        sh.stack[sp] = push_a ? ca : cb;
      }
    }
    sp += (int)push_a + (int)push_b;
    if (kLeaf != kNoLeaf) {
      if (any_a && ca < 0) {
        groups += leaf_test<kPacket, kGroup, kLeaf>(sh, lane, ca, ha, tris,
                                                    ox, oy, oz, dx, dy, dz,
                                                    bt, bi);
        ++leaves;
      }
      if (any_b && cb < 0) {
        groups += leaf_test<kPacket, kGroup, kLeaf>(sh, lane, cb, hb, tris,
                                                    ox, oy, oz, dx, dy, dz,
                                                    bt, bi);
        ++leaves;
      }
    }
    packet_sync<kPacket>();          // the pushes are visible
  }
  if (in) {
    out_t[r] = bt;
    out_i[r] = bi;
  }
  if (kCount && lane == 0) {
    out_counts[3 * packet + 0] = pops;
    out_counts[3 * packet + 1] = leaves;
    out_counts[3 * packet + 2] = groups;
  }
}

template <int kPacket, int kGroup, int kLeaf, int kOrder, bool kCount>
cudaError_t launch(const float* origin, const float* direction,
                   const uint8_t* active, const float* t_max,
                   long long n_rays, const float4* nodes, const float4* tris,
                   float* out_t, int* out_i, int* out_counts,
                   cudaStream_t s) {
  constexpr int kPerBlock = kPacket == 32 ? kWarpPackets : 1;
  const long long n_packets = (n_rays + kPacket - 1) / kPacket;
  const long long blocks = (n_packets + kPerBlock - 1) / kPerBlock;
  packet_walk_kernel<kPacket, kGroup, kLeaf, kOrder, kCount>
      <<<(unsigned)blocks, kPacket * kPerBlock, 0, s>>>(
          origin, direction, active, t_max, n_rays, n_packets, nodes, tris,
          out_t, out_i, out_counts);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const float*, const float*, const uint8_t*,
                                 const float*, long long, const float4*,
                                 const float4*, float*, int*, int*,
                                 cudaStream_t);

// The instances of one packet size, by variant (ops/packet_walk.py:VARIANTS
// order: full, noleaf, nogroupskip, noorder, noreduce) and counting.
template <int kPacket, int kGroup>
LaunchFn instance(int variant, bool count) {
  static const LaunchFn table[5][2] = {
      {launch<kPacket, kGroup, kSkip, kNear, false>,
       launch<kPacket, kGroup, kSkip, kNear, true>},
      {launch<kPacket, kGroup, kNoLeaf, kNear, false>,
       launch<kPacket, kGroup, kNoLeaf, kNear, true>},
      {launch<kPacket, kGroup, kAlways, kNear, false>,
       launch<kPacket, kGroup, kAlways, kNear, true>},
      {launch<kPacket, kGroup, kSkip, kFixed, false>,
       launch<kPacket, kGroup, kSkip, kFixed, true>},
      {launch<kPacket, kGroup, kSkip, kAnyHit, false>,
       launch<kPacket, kGroup, kSkip, kAnyHit, true>}};
  return table[variant][count ? 1 : 0];
}

}  // namespace

// packet: 1024 (groups of 128) or 32 (one group); variant: the index in
// ops/packet_walk.py:VARIANTS; count: write out_counts [packets, 3] (node
// pops, leaf visits, groups tested).  Returns cudaErrorInvalidValue for
// another packet or variant.
extern "C" int clive2_packet_walk(const float* origin, const float* direction,
                                  const uint8_t* active, const float* t_max,
                                  long long n_rays, const float* nodes,
                                  const float* tris, int packet, int variant,
                                  int count, float* out_t, int* out_i,
                                  int* out_counts, void* stream) {
  if (variant < 0 || variant > 4 || (packet != 1024 && packet != 32))
    return (int)cudaErrorInvalidValue;
  const LaunchFn fn = packet == 1024 ? instance<1024, 128>(variant, count)
                                     : instance<32, 32>(variant, count);
  return (int)fn(origin, direction, active, t_max, n_rays,
                 reinterpret_cast<const float4*>(nodes),
                 reinterpret_cast<const float4*>(tris), out_t, out_i,
                 out_counts, (cudaStream_t)stream);
}
