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
// Design, for Hopper.  A packet of kPacket rays is a block of kPacket
// threads, one ray each: at 1,024 rays (the TPU's packet, groups of 128)
// 32 warps, at 32 (one warp, one group) one warp.  One packet a block lets
// an SM start a packet as soon as one ends; blocks of eight 32-ray packets
// held their slots until the longest of the eight had ended, and were
// slower in every variant (PERF.md, the packet walk's findings).  Every warp
// keeps its own copy of the packet's stack, the record of the node it pops
// next and the rows of the leaves it tests, in its slice of shared memory,
// so only __syncwarp orders them.  A step:
//
//  1. wait for the popped node's record (copied by cp.async the step
//     before) and read it (four broadcast LDS.128);
//  2. test both child boxes for the thread's ray;
//  3. the warp's verdicts: __ballot_sync of the two hits, and
//     __reduce_min_sync of the two entry distances' bits (below); a warp
//     some of whose rays hit a leaf child starts copying that leaf's <= 24
//     rows (cp.async, one 16-byte copy a lane) while the packet decides;
//  4. (1,024 rays only) the exchange: lane 0 writes the warp's record
//     {least entry bits of A, of B, any hit of A, of B} (16 bytes) into
//     record[step & 1][warp]; one __syncthreads; lane i reads warp i's
//     record (one LDS.128) and the warp reduces the 32 records with two
//     __reduce_min_sync and two __ballot_sync.  Every warp now holds the
//     packet's verdicts, and bit w of the ballots says whether warp w hit
//     a child's box, so group g's flag is nibble g (4 warps of 128 rays)
//     and the groups tested are the non-zero nibbles: the leaf test needs
//     no barrier of its own;
//  5. push and pop on the warp's own stack (lane 0 writes, __syncwarp):
//     the next node is then known, and its record's copy starts before
//     this step's leaf tests, so its latency hides under them;
//  6. the leaf tests, A then B: Möller-Trumbore on the warp's copy of the
//     rows.  In the skip variants a warp none of whose rays hit the leaf
//     box skips its tests (hit gates every update, so its rays could not
//     take a hit, and the groups tested are counted from the flags, not
//     from what ran); nogroupskip runs every warp of every group.
//
// One barrier a step suffices for the double-buffered records.  A warp
// writes record[k & 1] before the barrier of step k and every warp reads
// it after that barrier and before it arrives at the barrier of step k + 1.
// The next write to record[k & 1] is at step k + 2, after the barrier of
// step k + 1, which no warp passes before every warp has arrived at it, so
// before every read of step k is done.  The record of step k + 1 goes to
// the other buffer.  Every warp computes the same verdicts from the same
// records, so all keep the same stack and leave the loop at the same step.
//
// The bit minima.  An entry distance is >= 0 (packet_box clamps it at 0)
// and not NaN (entry <= leave fails for NaN, so a NaN entry is no hit).
// With the sign bit cleared (fmaxf may return -0.0, which must read as
// +0.0) the bits of such floats order as the floats do, as unsigned
// integers, and +inf (a ray with no hit, or an entry that overflowed to
// inf under bt = inf) keeps its bits 0x7f800000.  So the least bits are
// the least distance's, "some ray hits" is least < 0x7f800000 and "A on
// top" is least_a <= least_b, exactly as packet_walk_plain reads its
// float minima (ops/packet_walk.py: nearest < INF, near_a <= near_b).
// noreduce takes "some ray hits" from the ballots alone.
//
// Its order is fixed by the packet: the pops, pushes and leaf tests are
// decided from the packet's verdicts alone, which do not depend on how the
// threads are scheduled, so each packet's counts, t and ids are a function
// of its rays, as on the TPU, and equal the plain version's.  A ray's best
// t changes only inside its own leaf tests, and the box test culls at that
// t itself (not common.cuh:cull_bound), as the TPU kernels do.
//
// What bounds it on the H100: issuing the steps, not operations or bytes
// (PERF.md, the packet walk's findings).  A step of noleaf's 1,024-ray
// instance is about 130 SASS instructions a warp (chip_smoke.py's sass
// phase, outer_loop), about 50 of them the two slab tests (chip_smoke.py's
// OPS counts 25 a box); at 1,024 rays all 32 warps repeat the packet's
// bookkeeping (the exchange, the verdicts, the stack, the copies).  ptxas
// gives the leaf-testing instances 54-62 registers, so an SM holds one
// 1,024-ray packet and waits out each step's serial chain (the node's
// copy, the barrier) with nothing else to issue; noleaf's 32 registers fit
// two.  Copying all three candidate records (child A, child B, the
// stack's top) at the top of each step, to take the node's latency off
// the chain, cost more instructions than it saved and was slower in every
// variant.  Rays that left the packet's union keep their lanes busy (the
// packet walk's inherent cost, which the TPU paid as well).
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
constexpr unsigned kNoEntry = 0x7f800000u;   // +inf's bits

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

// An entry distance as bits that order as the distance (the note): the
// sign cleared, or +inf's bits where the box is not hit.
__device__ __forceinline__ unsigned entry_bits(bool hit, float entry) {
  return hit ? __float_as_uint(entry) & 0x7fffffffu : kNoEntry;
}

// One 16-byte asynchronous copy from global to shared memory (cp.async,
// cached in L1: the packet's warps read the same record); a group of them
// is committed, and waited for until at most kPending later groups fly.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// What one warp keeps of its packet: its copy of the stack, the record of
// the node it pops next, and the rows of child A's and B's leaves.
struct WarpShared {
  int stack[kStack];
  float4 node[4];
  float4 rows[2][3 * kLeafRows];
};

// A packet's warps and (1,024-ray packets) their records of a step, by the
// step's parity: {least entry bits of A, of B, any hit of A, of B}.
template <int kPacket>
struct PacketShared {
  static constexpr int kWarps = kPacket / 32;
  WarpShared warp[kWarps];
  int4 record[2][kWarps];
};

// Starts copying the rows of leaf ref into rows: lane k < 3 x count copies
// float4 k.
__device__ __forceinline__ void copy_rows(float4* rows,
                                          const float4* __restrict__ tris,
                                          int ref, int lane) {
  const int code = ~ref;
  if (lane < 3 * (code & ((1 << kLeafBits) - 1)))
    copy16(rows + lane, tris + 3 * (long long)(code >> kLeafBits) + lane);
}

// The groups a leaf visit tests, from the flags of the packet's warps (bit
// w: warp w hit the leaf box; a group is kGroup / 32 adjacent warps).
template <int kPacket, int kGroup, int kLeaf>
__device__ __forceinline__ int groups_tested(unsigned flags) {
  if constexpr (kLeaf == kAlways) {
    return kPacket / kGroup;
  } else if constexpr (kPacket == 32) {
    return flags != 0;
  } else {
    static_assert(kGroup == 128, "groups of 128 rays: a nibble of warps");
    flags |= flags >> 1;
    flags |= flags >> 2;             // bit 4g: some warp of group g
    return __popc(flags & 0x11111111u);
  }
}

// One leaf (ref, a leaf code) against the warp's rays, from the warp's copy
// of its rows: a ray takes the least t under its best t (hit must hold),
// the largest id among hits at exactly that t.  In the skip variants a warp
// without a hit on the leaf box returns at once.
template <int kLeaf>
__device__ __forceinline__ void leaf_test(const float4* rows, int ref,
                                          bool hit, unsigned warp_hits,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float& bt, int& bi) {
  if (kLeaf == kSkip && warp_hits == 0) return;
  const int count = ~ref & ((1 << kLeafBits) - 1);
  float best = INFINITY;
  int best_id = -1;
  for (int k = 0; k < count; ++k) {
    const float4 p = rows[3 * k];
    const float4 q = rows[3 * k + 1];
    const float4 s = rows[3 * k + 2];
    float t, u, v;
    const bool geo = moller_trumbore(p.x, p.y, p.z, q.x, q.y, q.z, s.x, s.y,
                                     s.z, ox, oy, oz, dx, dy, dz, t, u, v);
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

template <int kPacket, int kGroup, int kLeaf, int kOrder, bool kCount>
__global__ void __launch_bounds__(kPacket)
packet_walk_kernel(const float* __restrict__ origin,
                   const float* __restrict__ direction,
                   const uint8_t* __restrict__ active,
                   const float* __restrict__ t_max, long long n_rays,
                   const float4* __restrict__ nodes,
                   const float4* __restrict__ tris, float* __restrict__ out_t,
                   int* __restrict__ out_i, int* __restrict__ out_counts) {
  static_assert(kPacket == 32 ? kGroup == 32
                              : kPacket == 1024 && kGroup == 128,
                "packets of 32 rays (one group) or 1,024 (groups of 128): "
                "a 1,024-ray packet's 32 warp records are one per lane");
  __shared__ PacketShared<kPacket> sh;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long packet = blockIdx.x;
  WarpShared& ws = sh.warp[warp];

  // the ray, or a padding ray past the end: inactive, at the origin, along
  // +x, capped at 0, as the scripts pad
  const long long r = packet * kPacket + threadIdx.x;
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
  int sp = 0;                        // entries below the popped node
  int parity = 0;
  if (lane < 4) copy16(&ws.node[lane], nodes + lane);     // the root
  copy_commit();
  while (true) {
    copy_wait<0>();
    __syncwarp();                    // the popped node's record is here
    const float4 xa = ws.node[0];
    const float4 xb = ws.node[1];
    const float4 z = ws.node[2];
    const float4 c = ws.node[3];
    ++pops;
    float ta, tb;
    const bool ha = packet_box(xa.x, xa.z, z.x, xa.y, xa.w, z.y, ox, oy, oz,
                               ix, iy, iz, bt, ta) && act;
    const bool hb = packet_box(xb.x, xb.z, z.z, xb.y, xb.w, z.w, ox, oy, oz,
                               ix, iy, iz, bt, tb) && act;
    const int ca = __float_as_int(c.x);
    const int cb = __float_as_int(c.y);
    const unsigned warp_a = __ballot_sync(kWarp, ha);
    const unsigned warp_b = __ballot_sync(kWarp, hb);
    // the rows of a leaf child this warp may test fly while the packet
    // decides
    if (kLeaf != kNoLeaf) {
      if (ca < 0 && (kLeaf == kAlways || warp_a)) copy_rows(ws.rows[0], tris,
                                                            ca, lane);
      if (cb < 0 && (kLeaf == kAlways || warp_b)) copy_rows(ws.rows[1], tris,
                                                            cb, lane);
      copy_commit();
    }
    unsigned near_a = 0, near_b = 0;
    if (kOrder != kAnyHit) {
      near_a = __reduce_min_sync(kWarp, entry_bits(ha, ta));
      near_b = __reduce_min_sync(kWarp, entry_bits(hb, tb));
    }
    unsigned flags_a = warp_a, flags_b = warp_b;
    if constexpr (kPacket > 32) {    // the exchange (the note, step 4)
      if (lane == 0)
        sh.record[parity][warp] = make_int4((int)near_a, (int)near_b,
                                            warp_a != 0, warp_b != 0);
      __syncthreads();
      const int4 rec = sh.record[parity][lane];
      parity ^= 1;
      if (kOrder != kAnyHit) {
        near_a = __reduce_min_sync(kWarp, (unsigned)rec.x);
        near_b = __reduce_min_sync(kWarp, (unsigned)rec.y);
      }
      flags_a = __ballot_sync(kWarp, rec.z);
      flags_b = __ballot_sync(kWarp, rec.w);
    }
    const bool any_a = kOrder == kAnyHit ? flags_a != 0 : near_a < kNoEntry;
    const bool any_b = kOrder == kAnyHit ? flags_b != 0 : near_b < kNoEntry;
    const bool a_top = kOrder == kNear ? near_a <= near_b : true;
    const bool push_a = any_a && ca >= 0;
    const bool push_b = any_b && cb >= 0;
    int next = -1;                   // inner nodes only: -1 ends the walk
    if (push_a && push_b) {
      if (lane == 0) ws.stack[sp] = a_top ? cb : ca;
      ++sp;
      next = a_top ? ca : cb;
    } else if (push_a || push_b) {
      next = push_a ? ca : cb;
    } else if (sp > 0) {
      next = ws.stack[--sp];
    }
    __syncwarp();                    // the push is visible, the record read
    if (next >= 0 && lane < 4)
      copy16(&ws.node[lane], nodes + 4 * (long long)next + lane);
    copy_commit();
    if (kLeaf != kNoLeaf) {
      const bool leaf_a = any_a && ca < 0;
      const bool leaf_b = any_b && cb < 0;
      if (leaf_a || leaf_b) {
        copy_wait<1>();              // the rows (the next node may fly)
        __syncwarp();
      }
      if (leaf_a) {
        leaf_test<kLeaf>(ws.rows[0], ca, ha, warp_a, ox, oy, oz, dx, dy, dz,
                         bt, bi);
        ++leaves;
        groups += groups_tested<kPacket, kGroup, kLeaf>(flags_a);
      }
      if (leaf_b) {
        leaf_test<kLeaf>(ws.rows[1], cb, hb, warp_b, ox, oy, oz, dx, dy, dz,
                         bt, bi);
        ++leaves;
        groups += groups_tested<kPacket, kGroup, kLeaf>(flags_b);
      }
    }
    if (next < 0) break;
  }
  if (in) {
    out_t[r] = bt;
    out_i[r] = bi;
  }
  if (kCount && threadIdx.x == 0) {
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
  const long long n_packets = (n_rays + kPacket - 1) / kPacket;
  packet_walk_kernel<kPacket, kGroup, kLeaf, kOrder, kCount>
      <<<(unsigned)n_packets, kPacket, 0, s>>>(origin, direction, active,
                                               t_max, n_rays, nodes, tris,
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
