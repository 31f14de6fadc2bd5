// Queued fat-leaf traversal: the walk, the binning of rays by fat leaf and
// the fat-leaf test of the rays queued at each fat leaf.
//
// Replaces the TPU kernel clive2_tpu/ops/traverse_stream2.py:_kernel, with
// csrc/traverse_stream2.cu (the per-thread walk, and the tail that finishes
// a chunk).  The schedule that drives these launches, and the plain
// PyTorch version of each, are in clive2_tpu_torch/ops/traverse_stream2.py
// (queued_cast; walk_to_leaf_plain, bin_by_leaf_plain, leaf_test_plain,
// tf32_filter_plain).  Ray state layout: stream2.cuh.
//
// What bounds it on the H100: the slot tests.  A cast needs about 40 FP32
// operations per (ray, slot) pair of every fat leaf a ray enters (1-3 fat
// leaves of ~100 slots on a connection ray), against ~100 bytes of ray
// state per ray and round.  The per-thread kernel instead reads each
// slot's 80-byte feature row once per ray (up to 10 KB per ray and fat
// leaf), with the 32 lanes of a warp in 32 different fat leaves; on the
// largest scene the rows (105 MB) do not fit the 50 MB L2.
//
// Design: the cast runs in rounds.  (a) walk: one thread per ray resumes
// the top-tree walk from its saved stack and stops at its next fat leaf.
// (b) bin: a histogram of the rays by fat leaf (atomics, one per warp and
// fat leaf), an exclusive scan of the counts padded to whole tiles of 128
// entries (one block), and a scatter into that queue.  The scan also leaves
// the round's live rays and tiles in device memory (info): the leaf test's
// grid is sized for the chunk and its blocks past the tile count return,
// so no round waits for the host.
// (c) leaf test: one block per tile copies its fat leaf's feature rows
// (<= 128 x 80 B) into shared memory once with a bulk asynchronous copy
// (cp.async.bulk + mbarrier) and tests them against the tile's rays, so a
// row is read from memory once per tile, not once per ray, and the slot
// loop is a shared-memory broadcast in lockstep across the warp.  Before
// the exact FP32 test, a TF32 tensor-core product (mma.sync m16n8k8) of
// the ray features [d, m] and [o', 1] with the slot coefficients rejects
// the (ray, slot) pairs that clearly miss; only the survivors run the
// exact test (the FP32-only instance tests every slot).  Both instances
// update (bt, bc) by the (t, slot) rule, so the answer is the same
// lexicographic minimum over the same passing slots as the per-thread
// kernel's, bit for bit.
//
// The prefilter's margin.  A pair is rejected only when one of the exact
// test's conditions fails by more than eps * M, M the same product on
// absolute values (a bound on the terms' magnitudes):
//   |a| > eps * Ma fixes the sign s of a (else the pair is kept);
//   reject when s u_n < -eps Mu, s v_n < -eps Mv,
//   s (a - u_n - v_n) < -eps (Ma + Mu + Mv),
//   s t_n - DELTA |a| < -eps (Mt + DELTA Ma), or
//   s t_n - bt |a| > eps (Mt + bt Ma)   (bt: the best t at the tile's start).
// The product's error against the exact test's own FP32 sums is at most
// about 2^-10 M: each TF32 operand is rounded to nearest (cvt.rna, 2^-11
// relative each), the tensor core's sum of 8 exact products adds at most a
// few 2^-23 M, and the FP32 test's own sums add 6 * 2^-24 M.  The exact
// test's quotients (u = u_n / a rounded twice, w = 1 - u - v rounded twice,
// t = t_n / a) can pass a pair whose exact forms fail by up to about 2^-20
// relative to |a|.  So eps = 2^-8 keeps 4x headroom over 2^-10 + 2^-20:
// a rejected pair fails the exact test.  A floor of 2^-96 covers values
// the tensor core flushes below 2^-126 (8 products of operands under 2^26);
// |a| >= 2^50 keeps the pair, since there a quotient could underflow to a
// signed zero that the exact test accepts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "stream2.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 128;          // rays per tile, threads per leaf block
constexpr int kMaxSlots = 128;      // slots per fat leaf (LANES)
constexpr float kEps = 0x1p-8f;     // ops/traverse_stream2.py:FILTER_EPS
constexpr float kFloor = 0x1p-96f;  // ops/traverse_stream2.py:FILTER_FLOOR
constexpr float kHuge = 0x1p50f;    // ops/traverse_stream2.py:FILTER_HUGE
constexpr int kRf = 20;             // ray feature words per row in SMEM

// ---- (a) walk ---------------------------------------------------------------

// Pops the topmost entry of a [depth, n] stack whose entry distance is at
// most cull_bound(bt) into ref (common.cuh:pop_entry on a strided stack).
__device__ __forceinline__ bool pop_strided(const int* stack_ref,
                                            const float* stack_t,
                                            long long n, long long i, int& sp,
                                            float bt, int& ref) {
  const float bound = cull_bound(bt);
  while (sp > 0) {
    --sp;
    if (stack_t[sp * n + i] <= bound) {
      ref = stack_ref[sp * n + i];
      return true;
    }
  }
  return false;
}

template <bool kAnyHit>
__global__ void walk_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const uint8_t* __restrict__ active, const float* __restrict__ t_max,
    long long n, int first, const float* __restrict__ nodebox,
    const int* __restrict__ childs, const float* __restrict__ ctr,
    float4* __restrict__ ray, float* __restrict__ bt_s, int* __restrict__ bc_s,
    int* __restrict__ ref_s, int* __restrict__ sp_s,
    int* __restrict__ stack_ref, float* __restrict__ stack_t,
    int* __restrict__ leaf) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float4 q[kRayRow];
  float bt;
  int ref, sp;
  if (first) {
    // the chunk's first round: the ray's state from its inputs
    ray_row(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2],
            direction[3 * i], direction[3 * i + 1], direction[3 * i + 2],
            ctr, q);
    for (int k = 0; k < kRayRow; ++k) ray[kRayRow * i + k] = q[k];
    const float cap = t_max[i];
    bt = cap < kCapClamp ? cap : kCapClamp;
    bt_s[i] = bt;
    bc_s[i] = -1;
    sp = 0;
    ref = active[i] ? 0 : kDone;
  } else {
    ref = ref_s[i];
    if (ref == kDone) {
      leaf[i] = -1;
      return;
    }
    for (int k = 0; k < 3; ++k) q[k] = ray[kRayRow * i + k];
    bt = bt_s[i];
    sp = sp_s[i];
    // the ray's fat leaf was tested in the last round: an any-hit ray with
    // a hit stops, any other pops its next entry
    if ((kAnyHit && bc_s[i] >= 0) ||
        !pop_strided(stack_ref, stack_t, n, i, sp, bt, ref))
      ref = kDone;
  }
  while (ref >= 0) {
    bool push;
    int push_ref;
    float push_t;
    if (node_step(nodebox, childs, q[0].x, q[0].y, q[0].z, q[1].z, q[1].w,
                  q[2].x, bt, ref, push, push_ref, push_t)) {
      if (push) {
        stack_ref[sp * n + i] = push_ref;
        stack_t[sp * n + i] = push_t;
        ++sp;
      }
    } else if (!pop_strided(stack_ref, stack_t, n, i, sp, bt, ref)) {
      ref = kDone;
    }
  }
  ref_s[i] = ref;
  sp_s[i] = sp;
  leaf[i] = ref == kDone ? -1 : -(ref + 1);
}

// ---- (b) bin ----------------------------------------------------------------

// Connection rays converge on the same few fat leaves, so each warp adds
// once per distinct fat leaf among its lanes (match.any) instead of once
// per ray.  Every lane of the warp takes part (no early return).
__global__ void count_kernel(const int* __restrict__ leaf, long long n,
                             int* __restrict__ hist) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int f = i < n ? leaf[i] : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, f);
  if (f >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(hist + f, __popc(peers));
}

// cursor[f] starts at fat leaf f's first queue entry; the order within a
// fat leaf does not change the answer (the (t, slot) rule).
__global__ void scatter_kernel(const int* __restrict__ leaf, long long n,
                               int* __restrict__ cursor,
                               int* __restrict__ queue) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int f = i < n ? leaf[i] : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, f);
  const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
  int base = 0;
  if (f >= 0 && lane == leader) base = atomicAdd(cursor + f, __popc(peers));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (f >= 0) queue[base + __popc(peers & ((1u << lane) - 1))] = (int)i;
}

// offs[f] = cursor[f] = the exclusive sum of the counts before fat leaf f,
// each padded to whole tiles; info = (live rays, tiles).  One block: each
// thread sums a contiguous range of fat leaves, the block scans the sums.
constexpr int kPlanThreads = 1024;

__global__ void __launch_bounds__(kPlanThreads)
    plan_kernel(const int* __restrict__ hist, int n_fat,
                int* __restrict__ offs, int* __restrict__ cursor,
                int* __restrict__ info) {
  __shared__ int padded[kPlanThreads];
  __shared__ int live[kPlanThreads];
  const int t = threadIdx.x;
  const int per = (n_fat + kPlanThreads - 1) / kPlanThreads;
  const int lo = min(n_fat, t * per), hi = min(n_fat, lo + per);
  int sum = 0, count = 0;
  for (int f = lo; f < hi; ++f) {
    sum += (hist[f] + kTile - 1) / kTile * kTile;
    count += hist[f];
  }
  padded[t] = sum;
  live[t] = count;
  __syncthreads();
  for (int d = 1; d < kPlanThreads; d <<= 1) {   // inclusive scans
    const int p = t >= d ? padded[t - d] : 0;
    const int l = t >= d ? live[t - d] : 0;
    __syncthreads();
    padded[t] += p;
    live[t] += l;
    __syncthreads();
  }
  int base = padded[t] - sum;
  for (int f = lo; f < hi; ++f) {
    offs[f] = cursor[f] = base;
    base += (hist[f] + kTile - 1) / kTile * kTile;
  }
  if (t == kPlanThreads - 1) {
    info[0] = live[t];
    info[1] = padded[t] / kTile;
  }
}

// ---- (c) leaf test ----------------------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  c[0] = c[1] = c[2] = c[3] = 0.0f;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// True when the pair clearly fails the exact test (the margin rule above);
// a NaN anywhere keeps the pair.
__device__ __forceinline__ bool clearly_misses(float a, float u, float v,
                                               float t, float ma, float mu,
                                               float mv, float mt, float bt) {
  const float aa = fabsf(a);
  if (!(aa > kEps * ma + kFloor && aa < kHuge)) return false;
  const float s = a > 0.0f ? 1.0f : -1.0f;
  const float su = s * u, sv = s * v, st = s * t;
  return su < -(kEps * mu + kFloor) || sv < -(kEps * mv + kFloor) ||
         aa - su - sv < -(kEps * (ma + mu + mv) + kFloor) ||
         st - kDelta * aa < -(kEps * (mt + kDelta * ma) + kFloor) ||
         st - bt * aa > kEps * (mt + bt * ma) + kFloor;
}

// One block per tile of 128 queued rays at one fat leaf; blocks past the
// round's tile count (info[1]) return.  A tile's first entry always holds
// a ray and names the fat leaf; entries past the fat leaf's count are
// padding.  keep_out, when not null, receives each tile entry's 128-bit
// mask of the slots that survive the prefilter (kFilter only).
template <bool kFilter>
__global__ void __launch_bounds__(kTile)
    leaf_kernel(const int* __restrict__ queue, const int* __restrict__ info,
                const int* __restrict__ hist, const int* __restrict__ offs,
                const int* __restrict__ leaf,
                const float4* __restrict__ ray, float* __restrict__ bt_s,
                int* __restrict__ bc_s, const float4* __restrict__ feat,
                const int* __restrict__ fat_start,
                uint32_t* __restrict__ keep_out) {
  __shared__ __align__(128) float4 rows[kMaxSlots * kFeatRow];
  __shared__ __align__(8) uint64_t bar;
  __shared__ uint32_t rf[kFilter ? kTile : 1][kRf];
  __shared__ float rbt[kFilter ? kTile : 1];
  __shared__ uint32_t keep[kFilter ? kTile : 1][kMaxSlots / 32];

  if ((int)blockIdx.x >= info[1]) return;
  const int tid = threadIdx.x;
  const long long entry = (long long)blockIdx.x * kTile + tid;
  const int f = leaf[queue[(long long)blockIdx.x * kTile]];
  const int r = entry - offs[f] < hist[f] ? queue[entry] : -1;
  const int start = fat_start[f];
  const int cnt = fat_start[f + 1] - start;

  float4 q0 = make_float4(0.f, 0.f, 0.f, 0.f), q1 = q0, q2 = q0, q3 = q0;
  float bt = 0.0f;
  int bc = -1;
  if (r >= 0) {
    q0 = ray[kRayRow * (long long)r];
    q1 = ray[kRayRow * (long long)r + 1];
    q2 = ray[kRayRow * (long long)r + 2];
    q3 = ray[kRayRow * (long long)r + 3];
    bt = bt_s[r];
    bc = bc_s[r];
  }
  const RayFeat x = ray_feat(q0, q1, q2, q3);
  if (kFilter) {
    // A operands: [d, m, 0, 0] and [o', 1, 0, 0, 0, 0], TF32-rounded
    const float v[kRf] = {x.dx, x.dy, x.dz, x.mx, x.my, x.mz, 0.f, 0.f,
                          x.sx, x.sy, x.sz, 1.f,  0.f,  0.f,  0.f, 0.f,
                          0.f,  0.f,  0.f,  0.f};
    for (int k = 0; k < kRf; ++k) rf[tid][k] = tf32(v[k]);
    rbt[tid] = bt;
  }
  bulk_load(rows, feat + (long long)kFeatRow * start,
            (uint32_t)(cnt * kFeatRow * sizeof(float4)), &bar);
  if (kFilter) {
    __syncthreads();
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, c = lane & 3;
    if (__any_sync(0xffffffffu, r >= 0)) {
      const float* fr = reinterpret_cast<const float*>(rows);
      for (int mb = 0; mb < 2; ++mb) {
        const int lo = 32 * warp + 16 * mb + g, hi = lo + 8;
        const uint32_t a1[4] = {rf[lo][c], rf[hi][c], rf[lo][c + 4],
                                rf[hi][c + 4]};
        const uint32_t a2[4] = {rf[lo][8 + c], rf[hi][8 + c],
                                rf[lo][12 + c], rf[hi][12 + c]};
        const uint32_t m1[4] = {a1[0] & 0x7fffffffu, a1[1] & 0x7fffffffu,
                                a1[2] & 0x7fffffffu, a1[3] & 0x7fffffffu};
        const uint32_t m2[4] = {a2[0] & 0x7fffffffu, a2[1] & 0x7fffffffu,
                                a2[2] & 0x7fffffffu, a2[3] & 0x7fffffffu};
        const float bt_row[2] = {rbt[lo], rbt[hi]};
        uint32_t kept[2][kMaxSlots / 32] = {};
#pragma unroll
        for (int j = 0; j < kMaxSlots / 8; ++j) {
          if (8 * j >= cnt) break;
          // B operands of slot 8j + g: k = c and c + 4 of each form
          const int slot = 8 * j + g;
          const float* cf = fr + slot * 20;
          const bool ok = slot < cnt;
          const uint32_t ba = ok && c < 3 ? tf32(cf[c]) : 0u;
          const uint32_t bu0 = ok ? tf32(cf[3 + c]) : 0u;
          const uint32_t bu1 = ok && c < 2 ? tf32(cf[7 + c]) : 0u;
          const uint32_t bv0 = ok ? tf32(cf[9 + c]) : 0u;
          const uint32_t bv1 = ok && c < 2 ? tf32(cf[13 + c]) : 0u;
          const uint32_t bw = ok ? tf32(cf[15 + c]) : 0u;
          const uint32_t m = 0x7fffffffu;
          float ca[4], cu[4], cv[4], ct[4], ma[4], mu[4], mv[4], mt[4];
          mma_tf32(ca, a1, ba, 0u);
          mma_tf32(cu, a1, bu0, bu1);
          mma_tf32(cv, a1, bv0, bv1);
          mma_tf32(ct, a2, bw, 0u);
          mma_tf32(ma, m1, ba & m, 0u);
          mma_tf32(mu, m1, bu0 & m, bu1 & m);
          mma_tf32(mv, m1, bv0 & m, bv1 & m);
          mma_tf32(mt, m2, bw & m, 0u);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * c + (e & 1);
            if (col < cnt && !clearly_misses(ca[e], cu[e], cv[e], ct[e],
                                             ma[e], mu[e], mv[e], mt[e],
                                             bt_row[e >> 1]))
              kept[e >> 1][j >> 2] |= 1u << (col & 31);
          }
        }
#pragma unroll
        for (int w = 0; w < kMaxSlots / 32; ++w) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t k = kept[h][w];
            k |= __shfl_xor_sync(0xffffffffu, k, 1);
            k |= __shfl_xor_sync(0xffffffffu, k, 2);
            if (c == 0) keep[h ? hi : lo][w] = k;
          }
        }
      }
    }
    __syncthreads();
  }
  if (r < 0) return;

  const float bt0 = bt;
  const int bc0 = bc;
  if (kFilter) {
    for (int w = 0; w < kMaxSlots / 32; ++w) {
      uint32_t bits = keep[tid][w];
      if (keep_out) keep_out[entry * (kMaxSlots / 32) + w] = bits;
      while (bits) {
        const int k = 32 * w + __ffs(bits) - 1;
        bits &= bits - 1;
        float t;
        if (slot_test(rows + kFeatRow * k, x, t) &&
            (t < bt || (t == bt && start + k < bc))) {
          bt = t;
          bc = start + k;
        }
      }
    }
  } else {
    for (int k = 0; k < cnt; ++k) {
      float t;
      if (slot_test(rows + kFeatRow * k, x, t) &&
          (t < bt || (t == bt && start + k < bc))) {
        bt = t;
        bc = start + k;
      }
    }
  }
  if (bc != bc0 || bt != bt0) {
    bt_s[r] = bt;
    bc_s[r] = bc;
  }
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int clive2_s2q_walk(const float* origin, const float* direction,
                               const uint8_t* active, const float* t_max,
                               long long n, int first, const float* nodebox,
                               const int* childs, const float* ctr,
                               float* ray, float* bt, int* bc, int* ref,
                               int* sp, int* stack_ref, float* stack_t,
                               int* leaf, int any_hit, void* stream) {
  auto kernel = any_hit ? walk_kernel<true> : walk_kernel<false>;
  kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, active, t_max, n, first, nodebox, childs, ctr,
      reinterpret_cast<float4*>(ray), bt, bc, ref, sp, stack_ref, stack_t,
      leaf);
  return (int)cudaGetLastError();
}

extern "C" int clive2_s2q_count(const int* leaf, long long n, int* hist,
                                void* stream) {
  count_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(leaf, n,
                                                                      hist);
  return (int)cudaGetLastError();
}

extern "C" int clive2_s2q_plan(const int* hist, int n_fat, int* offs,
                               int* cursor, int* info, void* stream) {
  plan_kernel<<<1, kPlanThreads, 0, (cudaStream_t)stream>>>(hist, n_fat, offs,
                                                           cursor, info);
  return (int)cudaGetLastError();
}

extern "C" int clive2_s2q_scatter(const int* leaf, long long n, int* cursor,
                                  int* queue, void* stream) {
  scatter_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      leaf, n, cursor, queue);
  return (int)cudaGetLastError();
}

// max_tiles: the most tiles a round of the chunk can have (its grid)
template <bool kFilter>
int launch_leaf(const int* queue, const int* info, const int* hist,
                const int* offs, long long max_tiles, const int* leaf,
                const float* ray, float* bt, int* bc, const float* feat,
                const int* fat_start, uint32_t* keep_out, void* stream) {
  if (max_tiles > 0)
    leaf_kernel<kFilter><<<(unsigned)max_tiles, kTile, 0,
                           (cudaStream_t)stream>>>(
        queue, info, hist, offs, leaf, reinterpret_cast<const float4*>(ray),
        bt, bc, reinterpret_cast<const float4*>(feat), fat_start, keep_out);
  return (int)cudaGetLastError();
}

// the prefiltered leaf test (TF32 product, then the exact test)
extern "C" int clive2_s2q_leaf_tf32(const int* queue, const int* info,
                                    const int* hist, const int* offs,
                                    long long max_tiles, const int* leaf,
                                    const float* ray, float* bt, int* bc,
                                    const float* feat, const int* fat_start,
                                    uint32_t* keep_out, void* stream) {
  return launch_leaf<true>(queue, info, hist, offs, max_tiles, leaf, ray, bt,
                           bc, feat, fat_start, keep_out, stream);
}

// the FP32-only leaf test (every slot through the exact test)
extern "C" int clive2_s2q_leaf_fp32(const int* queue, const int* info,
                                    const int* hist, const int* offs,
                                    long long max_tiles, const int* leaf,
                                    const float* ray, float* bt, int* bc,
                                    const float* feat, const int* fat_start,
                                    uint32_t* keep_out, void* stream) {
  return launch_leaf<false>(queue, info, hist, offs, max_tiles, leaf, ray,
                            bt, bc, feat, fat_start, keep_out, stream);
}
